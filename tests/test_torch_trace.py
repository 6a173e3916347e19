"""The port's spans (``repro_torch.utils.trace``) on the CPU.

* Without a profiler a span is one ``torch.autograd._profiler_enabled()``
  check that returns the shared no-op and records nothing.
* Under ``torch.profiler.profile`` a tiny FedNano run (two clients, two
  rounds, the vmap and sequential engines) and a tiny ``ServingEngine`` run
  put every named span into the profiler's events, nested as the program
  nests its phases, with their identifiers (``round``, ``rid``, ``step``)
  as keyword inputs; the table counts the rounds, steps and admissions; and
  the merged adapters and the served tokens are the same bits as without
  the profiler.
* The table is cleared at the first span of a recording after a span that
  found none.
* The benchmark's four readers of the table (``fedbench/metrics``) read a
  hand-made table, and give None for the other kind of run or a missing
  span.
"""
import importlib.util
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, init_server, run_federated
from repro_torch.core import adapters as adapters_lib
from repro_torch.data import make_federated_data
from repro_torch.launch.serve import make_requests
from repro_torch.serving import ServingEngine
from repro_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
            frontend_dim=16, remat=True)
ROUNDS, CLIENTS = 2, 2
HP = HyperParams(lr=5e-3, local_steps=2, fisher_batches=2)
TENANTS = ["tenant0", "tenant1"]
N_REQUESTS = 5


@pytest.fixture(autouse=True)
def empty_table():
    trace._table.clear()
    trace._recording = False
    yield
    trace._table.clear()
    trace._recording = False


def _profiled(fn):
    """fn() under a CPU profiler that keeps the ranges' keyword inputs ->
    (fn's result, [(name, start_ns, end_ns, kwinputs)] of the port's spans)."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.kwinputs())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("nano.")]
    return out, spans


def _inside(spans, child: str, *parents: str) -> bool:
    """Every ``child`` span lies within a span named one of ``parents``."""
    outer = [(s, e) for n, s, e, _ in spans if n in parents]
    kids = [(s, e) for n, s, e, _ in spans if n == child]
    return bool(kids) and all(any(a <= s and e <= b for a, b in outer) for s, e in kids)


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_without_a_profiler_a_span_is_one_check_and_records_nothing(monkeypatch):
    checks = []
    enabled = torch.autograd._profiler_enabled

    def counted():
        checks.append(1)
        return enabled()

    def no_range(*a, **k):
        raise AssertionError("a profiler range was opened without a profiler")

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", counted)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    for i in range(5):
        ctx = trace.span("nano.round", {"round": i}, device=True)
        assert ctx is trace._NOOP
        with ctx:
            torch.ones(2).sum()
    assert len(checks) == 5
    assert trace.snapshot() == {}


# ---------------------------------------------------------------------------
# the round engine and the model step
# ---------------------------------------------------------------------------

def _fednano(engine: str):
    cfg = get_smoke_config("llava-1.5-7b").with_(**TINY)
    data, _, _ = make_federated_data(cfg, n_clients=CLIENTS, examples_per_client=8, alpha=100.0,
                                     batch_size=2, seq_len=8, device="cpu")
    res = run_federated(0, cfg, data, {}, strategy="fednano", rounds=ROUNDS, hp=HP,
                        server=init_server(cfg, seed=3, device="cpu"), engine=engine,
                        final_eval=False, device="cpu")
    return res.server.global_adapters


# per engine: the round's spans and their calls in a run of ROUNDS rounds
ROUND_CALLS = {
    "vmap": {"nano.round": ROUNDS, "nano.round.prepare": ROUNDS, "nano.round.update": ROUNDS,
             "nano.round.collect": ROUNDS, "nano.round.upload": ROUNDS * CLIENTS,
             "nano.round.merge": ROUNDS, "nano.round.local_steps": ROUNDS,
             "nano.round.fisher": ROUNDS},
    "sequential": {"nano.round": ROUNDS, "nano.round.update": ROUNDS * CLIENTS,
                   "nano.round.upload": ROUNDS * CLIENTS, "nano.round.merge": ROUNDS,
                   "nano.round.local_steps": ROUNDS * CLIENTS,
                   "nano.round.fisher": ROUNDS * CLIENTS},
}
ROUND_NESTING = [("nano.round.update", "nano.round"), ("nano.round.upload", "nano.round"),
                 ("nano.round.merge", "nano.round"),
                 ("nano.round.local_steps", "nano.round.update"),
                 ("nano.round.fisher", "nano.round.update"),
                 ("nano.model.attention", "nano.round.update"),
                 ("nano.model.ffn", "nano.round.update"),
                 ("nano.model.head", "nano.round.update")]


@pytest.mark.parametrize("engine", sorted(ROUND_CALLS))
def test_round_spans_nest_count_and_change_nothing(engine):
    torch.manual_seed(0)
    plain = _fednano(engine)
    torch.manual_seed(0)
    traced, spans = _profiled(lambda: _fednano(engine))
    for mod in plain:
        for name in plain[mod]:
            assert torch.equal(plain[mod][name], traced[mod][name]), (mod, name)

    table = trace.snapshot()
    calls = {n: row["calls"] for n, row in table.items() if n.startswith("nano.round")}
    assert calls == ROUND_CALLS[engine]
    nesting = ROUND_NESTING + ([("nano.round.prepare", "nano.round"),
                                ("nano.round.collect", "nano.round")]
                               if engine == "vmap" else [])
    for child, parent in nesting:
        assert _inside(spans, child, parent), (child, parent)
    # two layers, four passes a round (two steps, two Fisher batches), each
    # layer's body run again by the backward under remat
    passes = ROUNDS * 4 * (CLIENTS if engine == "sequential" else 1)
    assert table["nano.model.attention"]["calls"] == 2 * TINY["n_layers"] * passes
    assert table["nano.model.ffn"]["calls"] == table["nano.model.attention"]["calls"]
    assert [kw["round"] for n, _, _, kw in spans if n == "nano.round"] == list(range(ROUNDS))
    assert all(row["host_s"] > 0 for row in table.values())
    # no card: no device seconds
    assert not any("device_s" in row for row in table.values())


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def _serve():
    cfg = get_smoke_config("llava-1.5-7b").with_(**TINY)
    server = init_server(cfg, seed=5, device="cpu")
    eng = ServingEngine(cfg, server.backbone, max_slots=3, prefill_len=8, max_new_tokens=4,
                        adapter_slots=4)
    for i, t in enumerate(TENANTS):
        adp = adapters_lib.init_nanoedge(torch.Generator().manual_seed(10 + i), cfg)
        eng.cache.put(t, {m: {k: v + 0.01 * (i + 1) for k, v in a.items()}
                          for m, a in adp.items()})
    done = eng.run(make_requests(cfg, TENANTS, N_REQUESTS, 8, 4, 0))
    return {rid: c.tokens for rid, c in done.items()}, dict(eng.stats)


SERVE_NESTING = [("nano.serve.prefill", "nano.serve.admit"),
                 ("nano.serve.first_token_read", "nano.serve.admit"),
                 ("nano.serve.page_write", "nano.serve.admit"),
                 ("nano.serve.inputs", "nano.serve.step"),
                 ("nano.serve.decode", "nano.serve.step"),
                 ("nano.serve.token_read", "nano.serve.step"),
                 ("nano.serve.bookkeeping", "nano.serve.step"),
                 ("nano.model.attention", "nano.serve.decode", "nano.serve.prefill"),
                 ("nano.model.ffn", "nano.serve.decode", "nano.serve.prefill"),
                 ("nano.model.head", "nano.serve.decode", "nano.serve.prefill")]


def test_serving_spans_nest_count_and_change_nothing():
    plain, _ = _serve()
    (tokens, stats), spans = _profiled(_serve)
    assert tokens == plain

    table = trace.snapshot()
    for child, *parents in SERVE_NESTING:
        assert _inside(spans, child, *parents), (child, parents)
    steps = stats["decode_steps"]
    for name in ("nano.serve.step", "nano.serve.inputs", "nano.serve.decode",
                 "nano.serve.token_read", "nano.serve.bookkeeping"):
        assert table[name]["calls"] == steps, name
    for name in ("nano.serve.admit", "nano.serve.prefill", "nano.serve.first_token_read"):
        assert table[name]["calls"] == stats["prefills"] == N_REQUESTS, name
    assert table["nano.model.head"]["calls"] == N_REQUESTS + steps
    assert table["nano.model.attention"]["calls"] == TINY["n_layers"] * (N_REQUESTS + steps)
    admits = [kw for n, _, _, kw in spans if n == "nano.serve.admit"]
    assert sorted(kw["rid"] for kw in admits) == list(range(N_REQUESTS))
    assert {kw["tenant"] for kw in admits} == set(TENANTS) | {"None"}
    assert [kw["step"] for n, _, _, kw in spans if n == "nano.serve.step"] == list(range(steps))
    assert table["nano.serve.step"]["host_s"] > table["nano.serve.token_read"]["host_s"]


# ---------------------------------------------------------------------------
# one recording at a time
# ---------------------------------------------------------------------------

def test_the_table_is_cleared_when_a_recording_follows_none():
    def phases(*names):
        for n in names:
            with trace.span(n):
                torch.ones(2).sum()

    _profiled(lambda: phases("nano.a", "nano.a", "nano.b"))
    first = trace.snapshot()
    assert {n: r["calls"] for n, r in first.items()} == {"nano.a": 2, "nano.b": 1}
    phases("nano.c")                        # no recording: nothing changes
    assert trace.snapshot().keys() == first.keys()
    _profiled(lambda: phases("nano.b"))
    assert {n: r["calls"] for n, r in trace.snapshot().items()} == {"nano.b": 1}


class _FakeEvent:
    """A CUDA event of a card whose every timed interval takes 2 ms."""

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        pass

    def elapsed_time(self, end):
        return 2.0


def test_snapshot_sums_device_seconds_of_timed_spans_only(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(1))

    def phases():
        for _ in range(3):
            with trace.span("nano.timed", device=True):
                with trace.span("nano.host"):
                    pass

    _profiled(phases)
    table = trace.snapshot()
    assert table["nano.timed"]["calls"] == 3
    assert table["nano.timed"]["device_s"] == pytest.approx(3 * 2e-3)
    assert "device_s" not in table["nano.host"]
    assert trace.snapshot() == table and len(synced) == 1   # the events are read once


# ---------------------------------------------------------------------------
# the benchmark's readers of the table
# ---------------------------------------------------------------------------

def _reader(metric: str):
    path = ROOT / "fedbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


TRAIN_TABLE = {"nano.round": {"calls": 4, "host_s": 40.0, "device_s": 40.4},
               "nano.round.update": {"calls": 4, "host_s": 2.0, "device_s": 40.0},
               "nano.round.fisher": {"calls": 4, "host_s": 0.5, "device_s": 13.2},
               "nano.round.merge": {"calls": 4, "host_s": 0.1, "device_s": 0.2}}
SERVE_TABLE = {"nano.serve.step": {"calls": 200, "host_s": 30.0},
               "nano.serve.token_read": {"calls": 200, "host_s": 12.0},
               "nano.serve.admit": {"calls": 100, "host_s": 11.0},
               "nano.serve.first_token_read": {"calls": 100, "host_s": 6.0}}
# metric -> (kind of run it reads, its value on its table, a span it needs)
READERS = {"fisher_pass_ms.train": ("train", 3300.0, "nano.round.fisher"),
           "round_engine_ms.train": ("train", 100.0, "nano.round.update"),
           "decode_launch_ms.serve": ("serve", 90.0, "nano.serve.token_read"),
           "admit_launch_ms.serve": ("serve", 50.0, "nano.serve.admit")}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_a_hand_made_table(metric):
    read = _reader(metric)
    kind, want, needed = READERS[metric]
    table = TRAIN_TABLE if kind == "train" else SERVE_TABLE
    assert read({"kind": kind}, table) == pytest.approx(want)
    other = "serve" if kind == "train" else "train"
    assert read({"kind": other}, {**TRAIN_TABLE, **SERVE_TABLE}) is None
    assert read({"kind": kind}, {k: v for k, v in table.items() if k != needed}) is None
    assert read({"kind": kind}, {}) is None
    if kind == "train":
        # no device seconds (a run on the CPU): nothing to read
        no_device = {k: {f: x for f, x in v.items() if f != "device_s"}
                     for k, v in table.items()}
        assert read({"kind": kind}, no_device) is None
