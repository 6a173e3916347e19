"""Milliseconds of one prefill in the window, by the engine's own span."""


def read(rec):
    if rec["kind"] != "serve" or not rec["stats"]["prefills"]:
        return None
    return 1e3 * rec["stats"]["prefill_s"] / rec["stats"]["prefills"]
