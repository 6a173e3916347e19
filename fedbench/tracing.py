"""The traced run's reading of ``torch.profiler``: the device's busy time,
device time by kernel name, and the idle gaps by what the host was doing.

The profiler keeps its events in memory; only this summary leaves the
process. Device activity is every event the profiler puts on the card
(kernels, copies, sets), the busy time their union inside the window. An
idle gap is named by the innermost host operation running at its middle,
under the outermost ``fedbench.*`` span there (the harness marks its phases
with ``record_function``), or "python" where no operation runs.
"""
from __future__ import annotations

import bisect
import itertools
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MIN_GAP_NS = 1_000  # shorter gaps are launch latency, not idleness worth naming


class Tracer:
    """The profiler over a window that ``open`` and ``close`` mark with spans
    of their own, so that the window is read on the profiler's clock."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()

    @staticmethod
    def mark(name: str):
        with record_function(name):
            pass

    def stop(self):
        self.prof.stop()

    def summary(self) -> Dict:
        """Busy seconds, device seconds by kernel name, and the breakdown,
        between the ``fedbench.open`` and ``fedbench.close`` marks."""
        return summarize(_events(self.prof))


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on_device, start_ns, end_ns) of every recorded event. The
    profiler mirrors each ``record_function`` span onto the device's timeline
    as an annotation; those are not device work and count as host spans."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda and not _annotation(e), e.start_ns(),
             e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()]


def _annotation(e) -> bool:
    user = getattr(e, "is_user_annotation", None)
    return e.name().startswith("fedbench.") or bool(user and user())


def summarize(events) -> Dict:
    marks = {n: s for n, d, s, _ in events if n in ("fedbench.open", "fedbench.close")}
    t0_ns, t1_ns = marks["fedbench.open"], marks["fedbench.close"]
    dev = sorted((max(s, t0_ns), min(e, t1_ns), n) for n, d, s, e in events
                 if d and e > t0_ns and s < t1_ns)
    by_name: Dict[str, float] = defaultdict(float)
    busy = 0
    reach = t0_ns
    gaps = []
    for s, e, n in dev:
        by_name[n] += (e - s) * 1e-9
        if s > reach + MIN_GAP_NS:
            gaps.append((reach, s))
        busy += max(0, e - max(s, reach))
        reach = max(reach, e)
    if t1_ns > reach + MIN_GAP_NS:
        gaps.append((reach, t1_ns))
    host = [(s, e, n) for n, d, s, e in events if not d and not n.startswith("cuda")]
    spans = sorted(h for h in host if h[2].startswith("fedbench.") and h[1] > h[0])
    span_starts = [h[0] for h in spans]
    ops = sorted(h for h in host if not h[2].startswith("fedbench."))
    starts = [h[0] for h in ops]
    reach_by = list(itertools.accumulate((h[1] for h in ops), max))
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        j = bisect.bisect_right(span_starts, mid) - 1
        span = spans[j][2] if j >= 0 and spans[j][1] >= mid else "outside spans"
        idle[f"{span} / {_innermost(ops, starts, reach_by, mid)}"] += (b - a) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy * 1e-9, "window_s": (t1_ns - t0_ns) * 1e-9,
            "device_time": dict(by_name),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}


def _innermost(ops, starts, reach_by, t: int, lookback: int = 512) -> str:
    """The latest-starting host operation still running at ``t``, else
    "python" (the host between operations). ``reach_by[i]`` is the latest
    end among ``ops[:i + 1]``; the harness's spans do not nest."""
    i = bisect.bisect_right(starts, t)
    if i == 0 or reach_by[i - 1] < t:
        return "python"
    for s, e, n in reversed(ops[max(0, i - lookback):i]):
        if e >= t:
            return n
    return "python"
