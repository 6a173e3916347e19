"""Milliseconds of one decode step in the window, by the engine's own span."""


def read(rec):
    if rec["kind"] != "serve" or not rec["stats"]["decode_steps"]:
        return None
    return 1e3 * rec["stats"]["decode_s"] / rec["stats"]["decode_steps"]
