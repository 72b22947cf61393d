"""The yardsticks of chip_smoke.py's kernel phase on the CPU: the one-call
library versions of K1-K3 (torch.einsum over per-site hop matrices and
stacked neighbour fields, over the unpacked clover; zeroed at the other
parity for a parity apply) and of K4 / K5 (torch.einsum over stacked
neighbour fields, blocks zeroed at the other parity for a parity apply)
must compute the plain version's function, or their time beside the
kernel's means nothing; and the bound model counts what a parity apply
needs.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ddalphaamg_tpu_torch.operators import coarse, fast  # noqa: E402

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


def _fine_inputs(lat, batch, seed):
    rng = np.random.default_rng(seed)
    V = math.prod(lat)

    def c(*shape):
        return torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                               dtype=torch.complex64)

    cdiag = torch.as_tensor(rng.normal(size=(2, 6, V)), dtype=torch.float32)
    return c(4, 3, 3, V), cdiag, c(2, 15, V), c(batch, 12, V)


@pytest.mark.parametrize("clover, parity", [(True, None), (False, None), (False, 0), (False, 1)])
def test_dslash_library_call_matches_plain(clover, parity):
    lat = (2, 4, 2, 4)
    links, cdiag, coff, phi = _fine_inputs(lat, 3, 4)
    if clover:
        want = fast.d_plus_clover_soa(links, cdiag, coff, phi, lat)
        got = chip_smoke.dslash_library(links, phi, lat, (cdiag, coff))()
    else:
        want = fast.dslash_hopping_soa(links, phi, lat, parity)
        got = chip_smoke.dslash_library(links, phi, lat, parity=parity)()
    assert float((got.reshape(want.shape) - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("parity, offset", [(None, 0), (1, 0), (1, 1)])
def test_clover_library_call_matches_plain(parity, offset):
    lat = (2, 4, 2, 4)
    _, cdiag, coff, phi = _fine_inputs(lat, 2, 5)
    want = fast.clover_apply_soa(cdiag, coff, phi, lat, parity, offset)
    got = chip_smoke.clover_library(cdiag, coff, phi, lat, parity, offset)()
    assert float((got.reshape(want.shape) - want).abs().max() / want.abs().max()) < 1e-5


def test_dslash_bound_counts_half_for_a_parity():
    lat = (2, 4, 2, 4)
    links, cdiag, coff, phi = _fine_inputs(lat, 2, 6)
    V, spinor = math.prod(lat), phi.numel() * 8
    assert chip_smoke.dslash_work("K2", phi, links) == (links.numel() * 8 + 2 * spinor,
                                                         1320 * V * 2)
    assert chip_smoke.dslash_work("K2", phi, links, parity=1) == (
        links.numel() * 8 + spinor + spinor // 2, 1320 * V)
    clover_bytes = cdiag.numel() * 4 + coff.numel() * 8
    assert chip_smoke.dslash_work("K3", phi, clover=(cdiag, coff), parity=0) == (
        clover_bytes // 2 + spinor + spinor // 2, 576 * V)
