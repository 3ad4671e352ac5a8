"""A run with its timed path broken underneath reports ``correct`` false;
a sound one true.  On the CPU at a tiny size (the program's plain
versions), with the cells' own limits; the look for a card is skipped."""
import pytest

from benchmark.run import run_cell
from benchmark.tests._tiny import tiny_cell

CASES = [("ffd_oasis.train16", None, True),
         ("ffd_oasis.train16", "unchanged", False),
         ("ffd_oasis.train16", "half_batch", False),
         ("svf_oasis.train4", None, True),
         ("svf_oasis.train4", "unchanged", False),
         ("svf_oasis.train4", "half_batch", False),
         ("svf_oasis.apply35", None, True),
         ("svf_oasis.apply35", "altered", False)]


@pytest.mark.parametrize("cell,fault,correct", CASES)
def test_a_planted_fault_is_not_correct(cell, fault, correct):
    out = run_cell(tiny_cell(cell), 2 ** 31 + 17, 0.3, device="cpu",
                   fault=fault)
    assert out["correct"] is correct, out["checks"]
