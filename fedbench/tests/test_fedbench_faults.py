"""Drive a run with the timed path broken underneath, past the harness's
look for a card, and see ``correct`` come out false: once for each fault a
cell can have (one chip: no exchange between chips to leave out)."""
import pytest

from fedbench_tiny import CELLS, run_tiny
from fedbench import faults

TRAIN, SERVE = CELLS[0], CELLS[1]


@pytest.mark.parametrize("cell,fault", [(TRAIN, f) for f in faults.TRAIN]
                         + [(SERVE, f) for f in faults.SERVE],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    res = run_tiny(cell, dtype="bfloat16")
    assert res["correct"] is False
    failing = [k for k, (v, lim) in res["checks"].items() if v is None or v > lim]
    assert failing
    if fault is faults.later_merge_altered:
        assert failing == ["merge_window"]


def test_control_is_not_correct():
    """The fp8 control in the program's place fails the limits at the tiny
    size too, in every cell."""
    for cell in CELLS:
        assert run_tiny(cell, control=True)["correct"] is False
