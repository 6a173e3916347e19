"""Share of the card's bf16 peak that the window's rounds needed: the
required operations of every local step's and Fisher pass's rows of the
window's rounds (the family's counts) over window seconds x peak."""
from fedbench import counts, families


def read(rec):
    if rec["kind"] != "train":
        return None
    fam = families.load(rec["cfg"])
    s = fam.shape_of(rec["cfg"])
    ops = sum(fam.train_row_flops(s, n, sup, rec["patches"] if n else 0)
              for rows in rec["passes"] for n, sup in rows)
    return 100.0 * ops / (rec["window_s"] * counts.PEAK_BF16_OPS)
