"""The flash-attention kernel's share of its roofline in training: the least
time of the causal attention forward that the window's passes need (each
layer once a pass, over the rows' required positions; counts.py) over the
device time of every flash kernel in the window (the remat recompute's
included)."""
from fedbench import counts, families

KERNEL = "flash_fwd"


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or not tr:
        return None
    t = sum(v for k, v in tr["device_time"].items() if KERNEL in k)
    if t <= 0:
        return None
    fam = families.load(rec["cfg"])
    s = fam.shape_of(rec["cfg"])
    bound = s.layers * sum(counts.bound_s(*fam.flash_call(s, [n for n, _ in rows if n]))
                           for rows in rec["passes"])
    return 100.0 * bound / t
