"""The control: the reference in the solver's place in complex64 (CG on
the normal equations) comes out not correct under the run's own check, and
the same solver in complex128 comes out correct."""

import pytest
import torch

from conftest import REPO
from gpubench import control, harness


def test_the_complex64_control_fails_the_check_and_complex128_passes(tiny_root):
    cell = harness.load_cell("tiny.solve", tiny_root)
    rows, limit = control.control_readings(cell, [1, 2, 3], "cpu")
    assert all(worst > 100 * limit for _, worst, _, _ in rows)
    # the same solver one precision up meets the limit: the check tells the two apart
    rows, limit = control.control_readings(cell, [1], "cpu", dtype=torch.complex128)
    assert rows[0][1] < limit


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["rough16.solve", "rough16.props", "rough32.solve"])
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control at a cell's size runs on a CUDA card")
    rows, limit = control.control_readings(harness.load_cell(cell, REPO), [1, 2, 3], "cuda")
    assert all(not worst < limit for _, worst, _, _ in rows)
