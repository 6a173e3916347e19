"""Share of the traced window of a serving cell in which no operation ran
on the card."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
