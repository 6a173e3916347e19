"""Share of the card's bf16 peak that the window's served tokens needed: each
prefill at its prompt's real length, each decode step's tokens at their
positions (counts.py), over window seconds x peak."""
from fedbench import counts, families


def read(rec):
    if rec["kind"] != "serve":
        return None
    fam = families.load(rec["cfg"])
    s = fam.shape_of(rec["cfg"])
    ops = sum(fam.prefill_flops(s, n, adapted) for n, adapted in rec["prefills"])
    for rows, _, positions in rec["steps"]:
        ops += sum(fam.decode_flops(s, p, False) for p in positions)
        ops += fam.grouped_lora_call(s, rows, 0)[0]
    return 100.0 * ops / (rec["window_s"] * counts.PEAK_BF16_OPS)
