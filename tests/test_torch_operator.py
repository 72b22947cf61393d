"""Port fine operator vs the JAX package: clover, logical D, the plain
versions of K1-K3 (complex128, 1e-12), the Pallas kernels in interpret mode
(float32, atol 2e-5 as tests/test_pallas.py) and gamma5-hermiticity.  The
CUDA kernels are held to these plain versions in test_torch_kernels.py."""

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
from ddalphaamg_tpu_torch.operators import cuda_dslash, fast, wilson

torch.set_num_threads(1)

M0, CSW = -0.5, 1.0


def _ops(lat):
    U = rough_field(lat)
    jop = jwilson.WilsonOperator.from_gauge(jnp.asarray(U), m0=M0, csw=CSW)
    op = wilson.WilsonOperator.from_gauge(convert.gauge_field(U), M0, CSW)
    return U, jop, op


def _soa(op):
    links = fast.links_to_soa(op.links)
    cdiag, coff = cuda_dslash.pack_clover(fast.clover_to_soa(op.clover))
    return links, cdiag, coff


def test_clover_and_logical_d_match_jax():
    lat = (4, 4, 4, 4)
    U, jop, op = _ops(lat)
    assert rel_err(op.clover.numpy(), np.asarray(jop.clover)) < 1e-12
    phi = random_spinor((*lat, 4, 3), seed=7)
    want = np.asarray(jwilson.d_plus_clover(jop, jnp.asarray(phi)))
    got = wilson.d_plus_clover(op, torch.as_tensor(phi)).numpy()
    assert rel_err(got, want) < 1e-12


def test_plain_soa_kernels_match_jax_fast():
    lat = (4, 4, 4, 4)
    _, jop, op = _ops(lat)
    jsp = jop.split()
    jl, jc = jfast.links_to_soa(jsp.links), jfast.clover_to_soa(jsp.clover)
    roll = jfast.make_rollers(lat, rdtype=jnp.float64)
    phi = random_spinor((*lat, 4, 3), seed=8)
    jphi = jfast.spinor_to_soa(cplx.as_carray(phi))
    links, cdiag, coff = _soa(op)
    tphi = fast.spinor_to_soa(torch.as_tensor(phi))
    shape = (4, 3, lat[0], lat[1], lat[2] * lat[3])
    cases = [
        (fast.d_plus_clover_soa(links, cdiag, coff, tphi, lat),
         jfast.d_plus_clover_soa(jl, jc, jphi, roll)),
        (fast.dslash_hopping_soa(links, tphi, lat),
         jfast.dslash_hopping_soa(jl, jphi, roll)),
        (fast.clover_apply_soa(cdiag, coff, tphi), jfast.clover_apply_soa(jc, jphi)),
    ]
    for got, want in cases:
        assert rel_err(got.numpy().reshape(shape), to_numpy(want)) < 1e-12


@pytest.mark.parametrize("lat", [(4, 4, 4, 4), (2, 4, 4, 8)])
def test_plain_kernels_match_pallas_interpret(lat):
    U = rough_field(lat, seed=11)
    jop = jwilson.WilsonOperator.from_gauge(cplx.as_carray(U), m0=-0.42, csw=1.3)
    jl = jfast.links_to_soa(jop.links).astype_real(jnp.float32)
    jc = jfast.clover_to_soa(jop.clover).astype_real(jnp.float32)
    jdiag, joff = jpd.pack_clover(jc)
    phi = random_spinor((*lat, 4, 3), seed=5).astype(np.complex64)
    jphi = jfast.spinor_to_soa(cplx.as_carray(phi)).astype_real(jnp.float32)

    op = wilson.WilsonOperator.from_gauge(convert.gauge_field(U), -0.42, 1.3)
    links, cdiag, coff = (t.to(torch.complex64) if t.is_complex()
                          else t.to(torch.float32) for t in _soa(op))
    tphi = fast.spinor_to_soa(torch.as_tensor(phi))
    shape = (4, 3, lat[0], lat[1], lat[2] * lat[3])
    cases = [
        (cuda_dslash.d_plus_clover(links, cdiag, coff, tphi, lat),
         jpd.build_dslash(lat, interpret=True)(jl, jdiag, joff, jphi)),
        (cuda_dslash.hopping(links, tphi, lat),
         jpd.build_dslash(lat, interpret=True, mode="hop")(jl, jphi)),
        (cuda_dslash.clover(cdiag, coff, tphi, lat),
         jpd.build_dslash(lat, interpret=True, mode="clover")(jdiag, joff, jphi)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy().reshape(shape), to_numpy(want),
                                   rtol=0, atol=2e-5)


def test_gamma5_hermiticity():
    lat = (4, 4, 4, 4)
    _, _, op = _ops(lat)
    links, cdiag, coff = _soa(op)
    chi = fast.spinor_to_soa(torch.as_tensor(random_spinor((*lat, 4, 3), 1)))
    phi = fast.spinor_to_soa(torch.as_tensor(random_spinor((*lat, 4, 3), 2)))
    g5 = torch.tensor([-1.0] * 6 + [1.0] * 6, dtype=torch.float64)[:, None]

    def D(v):
        return fast.d_plus_clover_soa(links, cdiag, coff, v, lat)

    lhs = torch.vdot(chi.reshape(-1), D(phi).reshape(-1))
    rhs = torch.vdot((g5 * D(g5 * chi)).reshape(-1), phi.reshape(-1))
    assert abs(complex(lhs - rhs)) < 1e-12 * abs(complex(lhs))


def test_odd_parity_clover_zeroes_even_sites():
    lat = (2, 2, 4, 4)
    _, _, op = _ops(lat)
    _, cdiag, coff = _soa(op)
    phi = fast.spinor_to_soa(torch.as_tensor(random_spinor((*lat, 4, 3), 4)))
    odd = fast.parity_mask(lat, 1)
    got = cuda_dslash.clover(cdiag, coff, phi, lat, parity=1)
    want = fast.clover_apply_soa(cdiag, coff, odd * phi)
    assert rel_err(got.numpy(), want.numpy()) < 1e-14
