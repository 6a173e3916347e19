"""The port's three examples (``repro_torch.examples``) against the JAX
package's (``examples/*.py``) on the CPU.

Each JAX example runs as its own ``main`` (loaded from ``examples/`` by path)
with its printed lines captured. The numbers it prints rounded are taken at
full precision from the calls it makes, recorded on the way: quickstart's
step losses where its loop calls ``float``, federated VQA's results where it
calls ``run_federated``. The port's ``run`` gets the JAX example's own
weights, drawn as the example draws them (``init_backbone(PRNGKey(0))``,
``init_client(fold_in(key, 1))``, the server ``run_federated`` draws from
``PRNGKey(0)``) and exported through ``repro_torch.interop``; data comes from
the two packages' own generators, which agree element for element.

Held, in f32: quickstart's per-epoch losses and federated VQA's round losses
(``--rounds 2 --clients 3 --local-steps 2``) at 1e-5 relative, its
accuracies and comm totals equal; split serving's tokens equal, or each
request's first difference a near tie of the JAX logits (top-2 gap under
NEAR_TIE of ‖logits‖∞, as the card checks hold the naive loop), and its
wire bytes equal. Each port ``main`` run with ``--device cpu`` prints the
JAX example's lines in the same order (numbers aside, since its weights are
its own draws), and the lines that hold no weight-dependent number
(parameter counts and bytes) letter for letter.
"""
import contextlib
import functools
import importlib.util
import io
import re
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import Batch as JBatch
from repro.core import adapters as jnano
from repro.core import server as jserver
from repro.data import SyntheticVQA as JSyntheticVQA
from repro.data import examples_to_batches as jax_examples_to_batches
from repro.models import model as jmodel
from repro.strategies import get_strategy as jax_get_strategy
from repro_torch import interop
from repro_torch.core import ServerState
from repro_torch.examples import federated_vqa, quickstart, split_serving
from repro_torch.utils import fmt_bytes

from test_torch_training import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
NEAR_TIE = 1e-4
VQA_ARGS = ["--rounds", "2", "--clients", "3", "--local-steps", "2"]
VALUE = re.compile(r"None|\d+(\.\d+)?")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(mod, argv=()):
    out = io.StringIO()
    with mock.patch.object(sys, "argv", [mod.__file__, *argv]), contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue().splitlines()


def _shape(lines):
    """The lines with every number (and each answer slot's None) masked."""
    return [VALUE.sub("#", ln) for ln in lines]


def _port_lines(main, argv, capsys):
    capsys.readouterr()
    assert main(["--device", "cpu", *argv]) == 0
    return capsys.readouterr().out.splitlines()


def _jax_cfg(cfg):
    """The JAX config of the same dims as a port example's."""
    fields = {k: getattr(cfg, k) for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                                          "head_dim", "d_ff", "frontend_dim", "vocab_size")}
    jcfg = jax_smoke_config(cfg.name).with_(**fields)
    assert jcfg.adapter.rank == cfg.adapter.rank and jcfg.dtype == cfg.dtype
    return jcfg


def _key_weights(jcfg, n_examples):
    """The backbone and client adapters the JAX example draws, as numpy."""
    key = jax.random.PRNGKey(0)
    backbone = jmodel.init_backbone(key, jcfg)
    client = jax_get_strategy("fednano").init_client(jax.random.fold_in(key, 1), jcfg, cid=0,
                                                     n_examples=n_examples)
    return jax.tree.map(np.asarray, backbone), jax.tree.map(np.asarray, client.adapters)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_quickstart():
    """(printed lines, per-epoch mean losses at full precision)."""
    mod = _load_example("quickstart")
    steps = []

    def recording_float(x):
        steps.append(float(x))
        return steps[-1]

    mod.float = recording_float  # the loop's float(loss), read from the module's globals
    lines = _run_main(mod)
    per_epoch = len(steps) // quickstart.EPOCHS
    return lines, [sum(steps[i:i + per_epoch]) / per_epoch
                   for i in range(0, len(steps), per_epoch)]


def test_quickstart_matches_reference():
    _, want = _jax_quickstart()
    cfg = quickstart.tiny_config()
    backbone, adapters = _key_weights(_jax_cfg(cfg), 64)
    out = quickstart.run(cfg, device="cpu",
                         backbone=interop.backbone_from_numpy(cfg, backbone, "cpu"),
                         adapters=interop.adapters_from_numpy(adapters, "cpu"))
    got = out["epoch_losses"]
    assert len(got) == len(want) == quickstart.EPOCHS
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL * abs(w), (got, want)
    assert got[-1] < got[0]
    assert len(out["step_s"]) == 8 * quickstart.EPOCHS


def test_quickstart_prints_the_reference_lines(capsys):
    want, _ = _jax_quickstart()
    got = _port_lines(quickstart.main, [], capsys)
    assert _shape(got) == _shape(want)
    assert got[0] == want[0] == "backbone frozen; trainable adapter params: 2,048"
    assert got[-1] == want[-1]


# ---------------------------------------------------------------------------
# federated VQA
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_federated_vqa():
    """(printed lines, [(cfg, result)] of each run_federated call)."""
    mod = _load_example("federated_vqa")
    runs = []
    real = mod.run_federated

    def recording_run_federated(key, cfg, *args, **kw):
        res = real(key, cfg, *args, **kw)
        runs.append((cfg, res))
        return res

    mod.run_federated = recording_run_federated
    return _run_main(mod, VQA_ARGS), runs


def test_federated_vqa_matches_reference():
    _, runs = _jax_federated_vqa()
    jcfg = runs[0][0]
    cfg = federated_vqa.scale_config("tiny")
    assert jcfg == _jax_cfg(cfg)
    jsrv = jserver.init_server(jax.random.split(jax.random.PRNGKey(0))[0], jcfg)
    # the server run_federated drew from PRNGKey(0): its frozen backbone came back
    for a, b in zip(jax.tree.leaves(jsrv.backbone), jax.tree.leaves(runs[0][1].server.backbone)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    server = ServerState(
        cfg=cfg, backbone=interop.backbone_from_numpy(
            cfg, jax.tree.map(np.asarray, jsrv.backbone), "cpu"),
        global_adapters=interop.adapters_from_numpy(
            jax.tree.map(np.asarray, jsrv.global_adapters), "cpu"))
    out = federated_vqa.run(cfg, device="cpu", rounds=2, clients=3, local_steps=2,
                            server=server, verbose=False)
    assert list(out["results"]) == list(federated_vqa.STRATEGIES) == [r.strategy for _, r in runs]
    for (_, want), got in zip(runs, out["results"].values()):
        wl = [m["mean_loss"] for m in want.round_metrics]
        gl = [m["mean_loss"] for m in got.round_metrics]
        assert len(gl) == len(wl) == 2
        for g, w in zip(gl, wl):
            assert abs(g - w) <= TOL * abs(w), (want.strategy, gl, wl)
        assert got.client_accuracy == want.client_accuracy
        assert got.avg_accuracy == pytest.approx(float(want.avg_accuracy), abs=1e-12)
        assert got.comm_totals == want.comm_totals
    want_ct = runs[-1][1].comm_totals
    assert out["ledger_name"] == "fednano"
    for k in ("param_up", "fisher_up", "param_down"):
        assert fmt_bytes(out["ledger"][k]) == fmt_bytes(want_ct[k])


def test_federated_vqa_prints_the_reference_lines(capsys):
    want, _ = _jax_federated_vqa()
    got = _port_lines(federated_vqa.main, VQA_ARGS, capsys)
    assert _shape(got) == _shape(want)
    ledger = want.index(next(ln for ln in want if "communication ledger" in ln))
    assert got[ledger:] == want[ledger:]  # the ledger's four lines: bytes only
    assert got[0] == want[0]


def test_federated_vqa_resolves_every_name_first():
    with pytest.raises(ValueError, match="unknown strategy 'fednanoo'"):
        federated_vqa.run(federated_vqa.scale_config("tiny"), device="cpu",
                          strategies=["fednano", "fednanoo"])


# ---------------------------------------------------------------------------
# split serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_split_serving():
    """(printed lines, tokens per request parsed from them)."""
    lines = _run_main(_load_example("split_serving"))
    tokens = [[int(t) for t in m.group(1).split(", ")]
              for m in (re.search(r"req \d+: tokens \[(.*?)\]", ln) for ln in lines) if m]
    return lines, tokens


def _jax_top2_gap(jcfg, backbone, adapters, i, generated, k):
    """Top-2 gap, relative to ‖logits‖∞, of the JAX logits that choose token
    ``k`` of request ``i`` after its first ``k`` (one full forward of the
    example's prompt and those tokens)."""
    gen = JSyntheticVQA(vocab_size=jcfg.vocab_size, seq_len=24, frontend_dim=jcfg.frontend_dim,
                        n_patches=8)
    batch = jax_examples_to_batches(gen.generate(8, seed=1), batch_size=8)[0]
    toks = jnp.concatenate([batch.tokens[i], jnp.asarray(generated[:k], jnp.int32)])[None]
    b = JBatch(tokens=toks, labels=jnp.zeros_like(toks), mask=jnp.zeros(toks.shape),
               patches=batch.patches[i:i + 1])
    embeds, positions, _, _, _ = jnano.nanoedge_forward(jcfg, backbone, adapters, b)
    hidden, _ = jmodel.forward(jcfg, backbone, embeds, positions)
    lg = np.asarray(jmodel.logits(jcfg, backbone, hidden[:, -1:])[0, 0], np.float64)
    top = np.sort(lg)[-2:]
    return (top[1] - top[0]) / np.abs(lg).max()


def test_split_serving_matches_reference():
    lines, want = _jax_split_serving()
    cfg = split_serving.tiny_config()
    jcfg = _jax_cfg(cfg)
    backbone, adapters = _key_weights(jcfg, 8)
    out = split_serving.run(cfg, device="cpu",
                            backbone=interop.backbone_from_numpy(cfg, backbone, "cpu"),
                            adapters=interop.adapters_from_numpy(adapters, "cpu"))
    got = out["tokens"]
    assert len(got) == len(want) == 8 and all(len(t) == 5 for t in got)
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        k = next(j for j, (x, y) in enumerate(zip(g, w)) if x != y)
        gap = _jax_top2_gap(jcfg, jax.tree.map(jnp.asarray, backbone),
                            jax.tree.map(jnp.asarray, adapters), i, w, k)
        assert gap < NEAR_TIE, f"request {i}: {g} vs {w} part at {k}, top-2 gap {gap:.3e}"
    wire = (f"wire traffic: client->server {fmt_bytes(out['wire_up'])}, "
            f"server->client {fmt_bytes(int(out['wire_down']))} "
            f"(vs shipping the backbone: {fmt_bytes(out['backbone_bytes'])})")
    assert wire == lines[-1]
    assert [len(s) for s in out["step_logits"]] == [8] * 5
    assert len(out["decode_step_s"]) == split_serving.DECODE_STEPS


def test_split_serving_prints_the_reference_lines(capsys):
    want, _ = _jax_split_serving()
    got = _port_lines(split_serving.main, [], capsys)
    assert _shape(got) == _shape(want)
    assert got[0] == want[0] and got[-1] == want[-1]
