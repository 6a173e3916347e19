"""Device milliseconds of the dedicated Fisher pass (paper Eq. 1) per round
of the window: the card's time inside the program's ``nano.round.fisher``
spans (the whole cohort, every Fisher batch) over the calls of its
``nano.round`` span. The program's span table,
``repro_torch.utils.trace.snapshot()``, covers the traced window: it is
cleared at the first span after the profiler starts at the window's open."""


def read(rec, table=None):
    if rec["kind"] != "train":
        return None
    if table is None:
        try:
            from repro_torch.utils.trace import snapshot
        except ImportError:                   # a program without spans
            return None
        table = snapshot()
    fisher, rounds = table.get("nano.round.fisher", {}), table.get("nano.round", {})
    if "device_s" not in fisher or not rounds.get("calls"):
        return None
    return 1e3 * fisher["device_s"] / rounds["calls"]
