"""The control (the reference at float32 with TF32 matmuls, in the
program's place) fails each cell's comparison at the cell's own size.
Needs the card: skips without one."""
import pytest
import torch

from benchmark import calibrate, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the control's TF32 exists only "
                    "on the card)")
    cell = registry.cell(name)
    readings = calibrate.control(cell, 2 ** 31 + 5)
    limits = cell.own["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings
