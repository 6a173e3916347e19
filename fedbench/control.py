#!/usr/bin/env python3
"""Readings that a cell's limits are set from, many seeds in one process.

    python3 fedbench/control.py --workload <cell> --seeds 1,2,3 --seconds 1 [--control]

Each seed runs the cell as ``run.py`` does (a short window) and prints one
JSON line with the numbers compared and their current limits. With
``--control`` the fp8 control takes the program's place in the comparison:
the plain reference in fp8 (e4m3) wherever the program keeps bf16, the
precision below the configuration's; a sound limit has to fail it. ``--fault <name>`` plants one of ``fedbench/faults.py``'s faults
in the program first. The benchmark's own runs never run this.
"""
import time

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None, help="a fault of fedbench/faults.py to plant")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from fedbench import faults, harness

    cell = harness.load_cell(args.workload)
    patches = faults.Patches()
    if args.fault:
        getattr(faults, args.fault)(patches)
    harness.require_cards(cell.chips)
    import torch

    torch.set_num_threads(4)
    for seed in (int(x) for x in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        res = harness.execute(cell, seed, args.seconds, False, "cuda:0", time.perf_counter(),
                              control=args.control)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": res["correct"],
                          "checks": res["checks"], "metrics": res["metrics"],
                          "memory_peak_bytes": res["device"]["memory_peak_bytes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
