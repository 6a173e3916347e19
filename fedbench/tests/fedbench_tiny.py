"""Tiny CPU versions of the benchmark's cells, shared by the tests: the
cells' own code paths (generators, program, reference, readers) at widths
and traffic a test run holds."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from fedbench import harness  # noqa: E402

CELLS = ("qwen2-vl-72b-l20.fednano-vqa-cohort8", "internlm2-20b.serve-tenants16-c64",
         "internlm2-20b.fednano-longdoc-2k")
SEED = 2**31 + 12345


def tiny_cell(name: str, dtype: str = "float32", cfg_extra=None, mix_extra=None):
    cell = harness.load_cell(name)
    cfg = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
           "num_key_value_heads": 2, "intermediate_size": 128, "vocab_size": 512,
           "torch_dtype": dtype,
           "nano_adapter": dict(cell.cfg["nano_adapter"], rank=4, alpha=8.0)}
    if cell.cfg.get("frontend_stub"):
        cfg["frontend_stub"] = {"patches": 8, "width": 32}
        cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [2, 3, 3]}
    if cell.traffic["generator"] == "serving":
        mix = {"clients": 6, "max_slots": 6, "prefill_len": 48, "max_new_tokens": 16,
               "tenants": 3, "prompt": {"median": 20, "sigma": 0.7, "min": 4, "max": 48},
               "output": {"median": 6, "sigma": 0.7, "min": 2, "max": 16}, "pool": 256, "block": 8,
               "warmup_completions": 6, "reference_tokens": 30}
    else:
        mix = {"clients": 3, "rows": 2, "text_tokens": 32, "question_tokens": [4, 24],
               "examples_per_client": 8, "reference_clients": 1}
        if "longdoc" in name:
            mix.update(text_tokens=64, question_tokens=[40, 60])
    return harness.apply_overrides(cell, {**cfg, **(cfg_extra or {})},
                                   {**mix, **(mix_extra or {})})


def run_tiny(name: str, trace: bool = False, dtype: str = "float32", seconds: float = 0.5,
             control: bool = False, cfg_extra=None, mix_extra=None):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.execute(tiny_cell(name, dtype, cfg_extra, mix_extra), SEED, seconds,
                               trace, "cpu",
                               time.perf_counter(), control=control)
    finally:
        torch.set_num_threads(threads)
