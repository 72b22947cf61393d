"""The yardsticks of chip_smoke.py's kernel phase on the CPU: the one-call
library version of K4 / K5 (torch.einsum over stacked neighbour fields,
blocks zeroed at the other parity for a parity apply) must compute the
plain version's function, or its time beside the kernel's means nothing.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ddalphaamg_tpu_torch.operators import coarse  # noqa: E402

LAT, D = (4, 4, 2, 4), 8


def _inputs(kind, batch, seed):
    rng = np.random.default_rng(seed)
    V = math.prod(LAT)
    Pk = torch.as_tensor(rng.normal(size=(9, D, D, V)) + 1j * rng.normal(size=(9, D, D, V)),
                         dtype=torch.complex64)
    v = torch.as_tensor(rng.normal(size=(batch, D, V)) + 1j * rng.normal(size=(batch, D, V)),
                        dtype=torch.complex64)
    return (coarse.compress(Pk) if kind == "bf16" else Pk), v


@pytest.mark.parametrize("case", [((0, 9), None, None), ((1, 9), None, None),
                                  ((0, 9), (2, 2, 2, 2), None), ((0, 1), None, 1)])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_coarse_library_call_matches_plain(kind, case):
    terms, mask, parity = case
    blocks, v = _inputs(kind, 3, 1)
    got = chip_smoke.stacked_einsum(blocks, v, LAT, terms, mask, parity=parity)()
    want = coarse.coarse_apply_plain(blocks, v, LAT, terms, mask, parity)
    assert float((got.reshape(want.shape) - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_coarse_halo_library_call_matches_plain(kind):
    blocks, v = _inputs(kind, 2, 2)
    rng = np.random.default_rng(3)
    V = math.prod(LAT)
    halos = {mu: tuple(torch.as_tensor(rng.normal(size=(2, D, V // LAT[mu])), dtype=torch.complex64)
                       for _ in range(2)) for mu in (0, 1)}
    got = chip_smoke.stacked_einsum(blocks, v, LAT, (0, 9), halos=halos)()
    want = coarse.coarse_apply_halo_plain(blocks, v, LAT, halos)
    assert float((got.reshape(want.shape) - want).abs().max() / want.abs().max()) < 1e-5
