"""Device milliseconds per round of the window that the round engine adds
around the cohort's update: the card's time inside the program's
``nano.round`` spans but outside their ``nano.round.update`` spans (the
download, the stacking copies, the uploads, the merge and its commit), over
the calls of ``nano.round``. The program's span table,
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
    rounds, update = table.get("nano.round", {}), table.get("nano.round.update", {})
    if "device_s" not in rounds or "device_s" not in update or not rounds.get("calls"):
        return None
    return 1e3 * (rounds["device_s"] - update["device_s"]) / rounds["calls"]
