"""The flash-attention kernel's share of its roofline in serving: the least
time of each prefill's causal attention at its prompt's real length, every
layer (counts.py), over the device time of every flash kernel in the window
(the engine pads each prompt to ``prefill_len``)."""
from fedbench import counts, families

KERNEL = "flash_fwd"


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr:
        return None
    t = sum(v for k, v in tr["device_time"].items() if KERNEL in k)
    if t <= 0:
        return None
    fam = families.load(rec["cfg"])
    s = fam.shape_of(rec["cfg"])
    bound = s.layers * sum(counts.bound_s(*fam.flash_call(s, [n])) for n, _ in rec["prefills"])
    return 100.0 * bound / t
