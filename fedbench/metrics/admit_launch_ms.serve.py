"""Host milliseconds per admission of the window before the host waits for
the first token: the host's time inside the serving engine's
``nano.serve.admit`` spans but outside their ``nano.serve.first_token_read``
spans (the adapter gather, NanoEdge, the prefill's and the logits'
launches, the page write), over the calls of ``nano.serve.admit``. The
program's span table, ``repro_torch.utils.trace.snapshot()``, covers the
traced window: it is cleared at the first span after the profiler starts at
the window's open."""


def read(rec, table=None):
    if rec["kind"] != "serve":
        return None
    if table is None:
        try:
            from repro_torch.utils.trace import snapshot
        except ImportError:                   # a program without spans
            return None
        table = snapshot()
    admit, wait = table.get("nano.serve.admit", {}), table.get("nano.serve.first_token_read", {})
    if not admit.get("calls") or "host_s" not in wait:
        return None
    return 1e3 * (admit["host_s"] - wait["host_s"]) / admit["calls"]
