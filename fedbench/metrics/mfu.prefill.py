"""Share of the card's bf16 peak during the engine's prefills: the required
operations of the window's prompts at their real lengths (counts.py) over
the engine's own prefill seconds (``stats["prefill_s"]``, host spans that
end in the read of the first token) x peak."""
from fedbench import counts, families


def read(rec):
    if rec["kind"] != "serve" or not rec["stats"]["prefills"]:
        return None
    fam = families.load(rec["cfg"])
    s = fam.shape_of(rec["cfg"])
    ops = sum(fam.prefill_flops(s, n, adapted) for n, adapted in rec["prefills"])
    return 100.0 * ops / (rec["stats"]["prefill_s"] * counts.PEAK_BF16_OPS)
