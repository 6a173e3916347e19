"""The operation and byte counts behind ``mfu.*`` and the rooflines, against
hand counts at a small shape, and the proof that they read only the
configuration and the traffic."""
import ast
import inspect

import pytest

from fedbench_tiny import ROOT  # noqa: F401  (puts the repository on the path)
from fedbench import counts
from fedbench.counts import Shape

S = Shape(layers=2, d=8, heads=2, kv_heads=1, head_dim=4, d_ff=16, vocab=10, rank=2, frontend=3)


def brute_attention(n, heads, hd, window=0):
    """Scores and weighted values, query by query over its causal keys (its
    last ``window`` keys where a window is set)."""
    ops = 0
    for _ in range(heads):
        for i in range(n):
            keys = min(i + 1, window) if window else i + 1
            ops += 2 * hd * keys         # q . k for each visible key
            ops += 2 * hd * keys         # p * v for each visible key
    return ops


def brute_linear(n, s):
    shapes = [(s.d, s.heads * s.head_dim), (s.d, s.kv_heads * s.head_dim),
              (s.d, s.kv_heads * s.head_dim), (s.heads * s.head_dim, s.d),
              (s.d, s.d_ff), (s.d, s.d_ff), (s.d_ff, s.d)]
    return sum(2 * n * a * b for a, b in shapes)


def test_layer_params_and_attention_by_hand():
    assert S.layer_params == 128 + 64 + 384
    assert counts.attention_flops(S, counts.causal_pairs(3)) == brute_attention(3, 2, 4) == 192


def test_train_row_by_hand():
    n, sup, patches = 3, 1, 1
    fwd = S.layers * (brute_linear(n, S) + brute_attention(n, 2, 4))
    # backward to the input: one product per weight product, two per attention product
    bwd = S.layers * (brute_linear(n, S) + 2 * brute_attention(n, 2, 4))
    head = 2 * (2 * S.vocab * S.d * sup)
    connector = 2 * S.frontend * S.d * patches
    adapters = n * (4 + 6) * S.d * S.rank
    assert counts.train_row_flops(S, n, sup, patches) == fwd + bwd + head + connector + adapters
    assert counts.train_row_flops(S, 3, 1, 1) == 15824


def test_serving_by_hand():
    assert counts.prefill_flops(S, 3, True) == 7296 + 160 + 192
    assert counts.decode_flops(S, 2, False) == 2656
    # a prompt's layers cost what decoding its positions one by one costs
    layers = lambda f: f - 2 * S.vocab * S.d
    assert layers(counts.prefill_flops(S, 3, False)) == sum(
        layers(counts.decode_flops(S, p, False)) for p in range(3))


def test_bytes_by_hand():
    # q (3, 2, 4) + k, v (3, 1, 4) + out (3, 2, 4) in bf16, lse (3, 2) in f32
    assert counts.flash_call(S, [3]) == (192, 48 + 24 + 24 + 48 + 24)
    # 3 rows of x in and out in bf16 with an int32 slot; 2 adapters of (8, 2) + (2, 8) in f32
    assert counts.grouped_lora_call(S, 3, 2) == (4 * 8 * 2 * 3, 3 * (32 + 4) + 2 * 128)
    assert counts.bound_s(counts.PEAK_BF16_OPS, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, counts.HBM_BYTES_PER_S) == pytest.approx(1.0)


def test_a_sliding_window_by_hand():
    import dataclasses

    w = dataclasses.replace(S, window=2)
    for n in (1, 2, 5):
        assert counts.attention_flops(w, counts.causal_pairs(n, 2)) == brute_attention(n, 2, 4, 2)
    assert counts.flash_call(w, [5])[0] == brute_attention(5, 2, 4, 2)
    assert counts.decode_flops(w, 4, False) == counts.decode_flops(S, 1, False)
    layers = lambda s, f: f - 2 * s.vocab * s.d
    assert layers(w, counts.prefill_flops(w, 5, False)) == sum(
        layers(w, counts.decode_flops(w, p, False)) for p in range(5))


def test_counts_read_only_the_configuration_and_the_traffic():
    tree = ast.parse(inspect.getsource(counts))
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
    assert imported <= {"__future__", "dataclasses", "typing"}
    cfg = {"num_attention_heads": 2, "num_key_value_heads": 1, "hidden_size": 8,
           "num_hidden_layers": 2, "intermediate_size": 16, "vocab_size": 10,
           "nano_adapter": {"rank": 2}, "frontend_stub": {"width": 3, "patches": 1}}
    assert counts.shape_of(cfg) == S


def test_readers_need_their_data():
    from fedbench import harness

    cfg = {"num_attention_heads": 2, "num_key_value_heads": 1, "hidden_size": 8,
           "num_hidden_layers": 2, "intermediate_size": 16, "vocab_size": 10,
           "nano_adapter": {"rank": 2}}
    cfg["port"] = {"family": "dense"}
    train = {"kind": "train", "cfg": cfg, "window_s": 2.0, "rounds": 1, "passes": [[(3, 1)]],
             "patches": 0, "trace": None}
    serve = {"kind": "serve", "cfg": cfg, "window_s": 2.0, "prefills": [(3, True)],
             "steps": [(1, 1, [3])], "ttft_s": [0.1, 0.2], "itl_s": [0.1], "stats": {"prefills": 1, "prefill_s": 0.5,
                                               "decode_steps": 1, "decode_s": 0.25},
             "trace": {"busy_s": 1.0, "window_s": 2.0, "device_time": {"other": 1.0}}}
    read = {m: harness.load_reader(m) for m in (
        "mfu.train", "flash_roofline.train", "idle_share.train", "mfu.serve", "mfu.prefill",
        "prefill_ms.serve", "decode_step_ms.serve", "flash_roofline.serve",
        "grouped_lora_roofline.serve", "idle_share.serve")}
    s = counts.shape_of(cfg)
    assert read["mfu.train"](train) == pytest.approx(
        100 * counts.train_row_flops(s, 3, 1) / (2.0 * counts.PEAK_BF16_OPS))
    assert read["mfu.train"](serve) is None and read["mfu.serve"](train) is None
    assert read["flash_roofline.train"](train) is None          # no trace
    assert read["flash_roofline.serve"](serve) is None          # no flash kernel in it
    assert read["grouped_lora_roofline.serve"](serve) is None
    assert read["idle_share.serve"](serve) == pytest.approx(50.0)
    assert read["prefill_ms.serve"](serve) == pytest.approx(500.0)
    assert read["decode_step_ms.serve"](serve) == pytest.approx(250.0)
    serve["trace"]["device_time"]["void cc::down_kernel<bf16>"] = 1e-3
    bound = counts.bound_s(*counts.grouped_lora_call(s, 1, 1))
    assert read["grouped_lora_roofline.serve"](serve) == pytest.approx(100 * bound / 1e-3)


def test_serving_latencies():
    from fedbench.traffic.serving import latencies, tail_mean

    assert tail_mean(list(range(1, 101))) == pytest.approx(95.5)
    assert tail_mean([3.0, 1.0]) == 3.0
    out = latencies([0.1] * 19 + [0.3], [])
    assert out["ttft_tail10_mean_ms"] == pytest.approx(200.0)
    assert out["ttft_p95_ms"] == pytest.approx(110.0)
    assert set(out) == {"ttft_p95_ms", "ttft_tail10_mean_ms"}
