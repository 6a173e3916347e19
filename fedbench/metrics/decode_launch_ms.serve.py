"""Host milliseconds per decode step of the window before the host waits
for the card: the host's time inside the serving engine's
``nano.serve.step`` spans but outside their ``nano.serve.token_read``
spans (the input copies, the layers' launches, the per-page bookkeeping),
over the calls of ``nano.serve.step``. Near ``decode_step_ms.serve`` the
step is bound by its launches; far under it, by the card. The program's
span table, ``repro_torch.utils.trace.snapshot()``, covers the traced
window: it is cleared at the first span after the profiler starts at the
window's open."""


def read(rec, table=None):
    if rec["kind"] != "serve":
        return None
    if table is None:
        try:
            from repro_torch.utils.trace import snapshot
        except ImportError:                   # a program without spans
            return None
        table = snapshot()
    step, wait = table.get("nano.serve.step", {}), table.get("nano.serve.token_read", {})
    if not step.get("calls") or "host_s" not in wait:
        return None
    return 1e3 * (step["host_s"] - wait["host_s"]) / step["calls"]
