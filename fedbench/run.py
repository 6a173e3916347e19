#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the CUDA card(s) of this
machine, and print its result as the last line of standard output.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled run. Every run
checks the window's work against the plain reference in ``fedbench/reference``
and prints each compared number beside its limit, last on standard error and
last in the result line. Without the cards the cell asks for, or with JAX or
the JAX package loaded, it exits non-zero and prints no result. Build and
kernel caches stay under ``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")

    from fedbench import harness

    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    torch.set_num_threads(4)
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"fedbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
