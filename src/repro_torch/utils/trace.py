"""Spans of the port's phases on ``torch.profiler``'s timeline, recorded only
while a profiler records in this process.

``span(name, args, device)`` is a context manager around one phase (a round,
its Fisher pass, a decode step's token read, ...). Outside a recording it
costs one ``torch.autograd._profiler_enabled()`` check and returns a shared
no-op context: nothing is recorded and nothing is allocated. Inside one it
opens a profiler range named ``name`` on the profiler's clock, the clock of
the card's kernels, with ``args`` (``{"rid": 7}``, ``{"round": 3}``) as the
range's keyword inputs (kept where the profiler records shapes), and adds the
phase to a table in memory: its calls and host seconds and, with ``device``,
its seconds on the card, from a pair of CUDA events on the current stream.
On one in-order stream the interval between a phase's two events is the
card's time for the phase, idle time inside it included. The events are
read only in ``snapshot()``, after one synchronize.

The table is cleared at the first span that finds a recording after a span
that found none, so it covers one recording: in a traced benchmark run, the
window. Nesting is the profiler's to keep; the table holds each name once.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

_NOOP = contextlib.nullcontext()
_ARG_TYPES = (bool, int, float, str)


class _Row:
    __slots__ = ("calls", "host_ns", "device_ms", "pending")

    def __init__(self):
        self.calls = 0
        self.host_ns = 0
        self.device_ms = None   # set at the first event pair
        self.pending = []       # (start, end) CUDA events not read yet


_table: Dict[str, _Row] = {}
_recording = False          # whether the latest span found a recording


class _Span:
    __slots__ = ("name", "range", "events", "t0")

    def __init__(self, name: str, args: Optional[dict], device: bool):
        self.name = name
        kw = {k: v if isinstance(v, _ARG_TYPES) else str(v) for k, v in (args or {}).items()}
        self.range = torch._C._profiler._RecordFunctionFast(name, (), kw)
        self.events = None
        if device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.range.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        row = _table.get(self.name)
        if row is None:
            row = _table[self.name] = _Row()
        row.calls += 1
        row.host_ns += host_ns
        if self.events is not None:
            row.pending.append(self.events)
            row.device_ms = row.device_ms or 0.0
        return False


def span(name: str, args: Optional[dict] = None, device: bool = False):
    """A context manager over one phase named ``name``: the shared no-op
    unless a profiler records (module docstring). ``args``: identifiers of
    the phase, as keyword inputs of its profiler range; ``device``: time the
    phase on the card as well (where CUDA is in use)."""
    global _recording
    if not torch.autograd._profiler_enabled():
        _recording = False
        return _NOOP
    if not _recording:
        _table.clear()
        _recording = True
    return _Span(name, args, device)


def snapshot() -> Dict[str, Dict[str, float]]:
    """The table of the latest recording, ``{name: {"calls", "host_s"}}``,
    with ``"device_s"`` for the names timed on the card. Reads the CUDA
    events that the spans left (one synchronize first)."""
    if any(row.pending for row in _table.values()):
        torch.cuda.synchronize()
        for row in _table.values():
            if row.pending:
                row.device_ms += sum(a.elapsed_time(b) for a, b in row.pending)
                row.pending.clear()
    out = {}
    for name, row in _table.items():
        out[name] = {"calls": row.calls, "host_s": row.host_ns * 1e-9}
        if row.device_ms is not None:
            out[name]["device_s"] = row.device_ms * 1e-3
    return out
