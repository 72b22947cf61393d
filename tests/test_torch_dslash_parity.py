"""The parity-restricted K2 and the compact odd-site clover inverse of the
fine stencil (plain versions, the path CPU tensors take; the CUDA kernels
are held to them in test_torch_kernels.py):

  * K2 with a parity is the all-sites K2 masked to that parity, and the JAX
    package's Pallas hop kernel (interpret mode) masked the same way,
    float32, atol 2e-5 as tests/test_pallas.py;
  * the compact odd-site inverse gives the full-storage inverse's result on
    the odd sites (complex128, 1e-14), for either slab offset parity;
  * SAP smoothing with block odd-even through the parity-restricted hops
    and the compact inverse equals the same smoothing through all-sites
    hops and the full-storage inverse (complex128, 1e-12).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_spinor, rel_err, rough_field, to_numpy

from ddalphaamg_tpu import cplx
from ddalphaamg_tpu.operators import fast as jfast
from ddalphaamg_tpu.operators import pallas_dslash as jpd
from ddalphaamg_tpu.operators import wilson as jwilson
from ddalphaamg_tpu_torch import convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.operators import cuda_dslash, fast, wilson
from ddalphaamg_tpu_torch.operators.stencil import EVEN, ODD, WilsonStencilSoA, herm_inv
from ddalphaamg_tpu_torch.smoothers import sap

torch.set_num_threads(1)

M0, CSW = -0.5, 1.0


def _operator(lat, seed=3, m0=M0, csw=CSW):
    return wilson.WilsonOperator.from_gauge(convert.gauge_field(rough_field(lat, seed)), m0, csw)


def _full_inverse(op):
    """The packed clover inverse of every site (the storage before the
    compact odd-site form)."""
    return cuda_dslash.pack_clover(fast.clover_to_soa(herm_inv(op.clover)))


@pytest.mark.parametrize("lat", [(4, 4, 4, 4), (2, 4, 4, 8)])
def test_parity_hop_matches_masked_hop_and_pallas(lat):
    U = rough_field(lat, seed=11)
    jop = jwilson.WilsonOperator.from_gauge(cplx.as_carray(U), m0=-0.42, csw=1.3)
    jl = jfast.links_to_soa(jop.links).astype_real(jnp.float32)
    phi = random_spinor((*lat, 4, 3), seed=5).astype(np.complex64)
    jphi = jfast.spinor_to_soa(cplx.as_carray(phi)).astype_real(jnp.float32)
    want_all = to_numpy(jpd.build_dslash(lat, interpret=True, mode="hop")(jl, jphi)).reshape(12, -1)

    op = wilson.WilsonOperator.from_gauge(convert.gauge_field(U), -0.42, 1.3)
    links = fast.links_to_soa(op.links).to(torch.complex64)
    tphi = fast.spinor_to_soa(torch.as_tensor(phi))
    all_sites = cuda_dslash.hopping(links, tphi, lat)
    for parity in (EVEN, ODD):
        for offset in (0, 1):
            mask = fast.parity_mask(lat, parity, torch.float32, offset=offset)
            got = cuda_dslash.hopping(links, tphi, lat, parity, offset)
            assert torch.equal(got, all_sites * mask)
            np.testing.assert_allclose(got.numpy(), want_all * mask.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("offset", [0, 1])
def test_compact_odd_inverse_matches_full_storage(offset):
    lat = (2, 2, 4, 4)
    op = _operator(lat)
    cd, co = _full_inverse(op)
    phi = fast.spinor_to_soa(torch.as_tensor(random_spinor((3, *lat, 4, 3), 4)))
    want = fast.clover_apply_soa(cd, co, phi, lat, ODD, offset)
    ccd, cco = (fast.compact_parity(t, lat, ODD, offset) for t in (cd, co))
    assert ccd.shape == (2, 6, 32) and cco.shape == (2, 15, 32)
    got = cuda_dslash.clover(ccd, cco, phi, lat, ODD, offset, compact=True)
    assert rel_err(got.numpy(), want.numpy()) < 1e-14
    with pytest.raises(ValueError):
        cuda_dslash.clover(ccd, cco, phi, lat, compact=True)      # compact needs a parity


def test_stencil_stores_the_inverse_on_odd_sites():
    lat = (4, 2, 4, 4)
    op = _operator(lat, seed=6)
    s = WilsonStencilSoA.build(op, Geometry(lattice=lat, block=(2, 2, 2, 2)))
    V = s.geom.num_sites
    assert s.cdiag_inv.shape == (2, 6, V // 2) and s.coff_inv.shape == (2, 15, V // 2)
    phi = fast.spinor_to_soa(torch.as_tensor(random_spinor((*lat, 4, 3), 9)))
    want = fast.clover_apply_soa(*_full_inverse(op), phi, lat, ODD)
    assert rel_err(s.self_inv(phi, ODD).numpy(), want.numpy()) < 1e-14
    with pytest.raises(ValueError):
        s.self_inv(phi, EVEN)


@dataclasses.dataclass
class _AllSitesStencil(WilsonStencilSoA):
    """The fine stencil as before the parity-restricted hops: every site of
    every hop, the clover inverse in full storage."""

    full_inv: tuple = ()

    def hop_intra(self, v, parity=None):
        return cuda_dslash.hopping(self.links_intra, v, self.lattice)

    def self_inv(self, v, parity):
        return cuda_dslash.clover(*self.full_inv, v, self.lattice, parity, self.parity_offset)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_sap_with_parity_hops_matches_all_sites(batch):
    lat = (4, 4, 4, 4)
    geom = Geometry(lattice=lat, block=(2, 2, 2, 2))
    op = _operator(lat, seed=7)
    s = WilsonStencilSoA.build(op, geom)
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    old = _AllSitesStencil(**fields, full_inv=_full_inverse(op))
    colors = tuple(torch.as_tensor(m.reshape(-1)) for m in sap.color_masks(geom))
    eta = fast.spinor_to_soa(torch.as_tensor(random_spinor((*batch, *lat, 4, 3), 12)))
    got = sap.sap_smooth(s, colors, eta, cycles=2, block_iter=4, odd_even=True)
    want = sap.sap_smooth(old, colors, eta, cycles=2, block_iter=4, odd_even=True)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-12
