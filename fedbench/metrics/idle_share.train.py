"""Share of the traced window of a training cell in which no operation ran
on the card."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
