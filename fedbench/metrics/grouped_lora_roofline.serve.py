"""The grouped-LoRA kernel's share of its roofline: the least time of each
decode step's adapted rows and distinct adapters (counts.py) over the device
time of the kernel's launches (its CUDA functions live in ``cc::``)."""
from fedbench import counts, families

KERNEL = "cc::"


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "serve" or not tr:
        return None
    t = sum(v for k, v in tr["device_time"].items() if KERNEL in k)
    if t <= 0:
        return None
    fam = families.load(rec["cfg"])
    s = fam.shape_of(rec["cfg"])
    bound = sum(counts.bound_s(*fam.grouped_lora_call(s, rows, adapters))
                for rows, adapters, _ in rec["steps"])
    return 100.0 * bound / t
