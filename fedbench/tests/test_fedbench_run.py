"""Each cell's path end to end at a tiny size on the CPU: the generator, the
program, the plain reference and the readers; the reference agrees with the
port there; and without a card the benchmark fails instead of falling back."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from fedbench_tiny import CELLS, ROOT, run_tiny

# f32 at the tiny size: the port and the reference compute the same sums in
# other orders, so their gaps are rounding (measured 1e-7 to 1e-5)
AGREE = {"loss": 1e-5, "moments": 1e-4, "update": 1e-3, "fisher": 1e-4, "merge": 1e-6,
         "loss_window": 1e-5, "merge_window": 1e-6, "gap": 1e-4}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_the_reference_agrees(cell):
    res = run_tiny(cell)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == e2e
    assert all(m["value"] > 0 for m in res["metrics"].values())
    for name, (value, limit) in res["checks"].items():
        assert value <= AGREE[name], (name, value)
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    res = run_tiny(cell, trace=True, dtype="bfloat16")
    assert res["correct"] is True
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])}
    # on the CPU nothing runs on a card: the device readers find nothing
    assert set(res["metrics"]) <= per
    assert any(k.startswith("mfu.") for k in res["metrics"])
    assert not any("roofline" in k for k in res["metrics"])
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def _run_py(cwd):
    cmd = [sys.executable, "fedbench/run.py", "--workload", CELLS[0], "--seed", "2147483659",
           "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=120)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_without_a_card_it_fails_and_prints_no_result(no_card):
    res = _run_py(ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fedbench", tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_py(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
