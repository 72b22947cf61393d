"""Port coarse level vs the JAX package: the plain version of K4 against the
Pallas coarse kernel in interpret mode (float32, rtol 1e-5), interpolation
and the Galerkin operator from the same test vectors (complex128, 1e-11),
and P^H P = I.  K4 is held to its plain version in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_spinor, rel_err, rough_field, to_numpy

from ddalphaamg_tpu import cplx
from ddalphaamg_tpu.geometry import Geometry as JGeometry
from ddalphaamg_tpu.mg import galerkin as jgal
from ddalphaamg_tpu.mg import interpolation as jinterp
from ddalphaamg_tpu.operators import coarse as jcoarse
from ddalphaamg_tpu.operators import stencil as jstencil
from ddalphaamg_tpu.operators import wilson as jwilson
from ddalphaamg_tpu_torch import convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg import galerkin, interpolation
from ddalphaamg_tpu_torch.operators.stencil import ODD, CoarseStencilSoA, WilsonStencilSoA

torch.set_num_threads(1)


def _random_cop(lat, d, seed):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    A = c(*lat, d, d) * 0.1 + 2.0 * np.eye(d)
    return A, 0.1 * c(4, *lat, d, d), 0.1 * c(4, *lat, d, d)


OPS = ["full_op", "hop", "block_op", "hop_intra", "self_op", "self_inv"]


@pytest.mark.parametrize("lat", [(2, 2, 2, 2), (2, 2, 4, 4)])
def test_plain_k4_matches_pallas_interpret(lat):
    d = 8
    A, Df, Db = _random_cop(lat, d, seed=1)
    geom = JGeometry(lattice=lat, block=(2, 2, 2, 2))
    jcop = jcoarse.CoarseOperator(cplx.as_carray(A), cplx.as_carray(Df),
                                  cplx.as_carray(Db)).astype(jnp.complex64)
    js = jstencil.CoarseStencilSoA.build(jcop, geom, use_pallas=True)
    assert js.use_pallas
    ts = CoarseStencilSoA.build(convert.coarse_operator(A, Df, Db),
                                Geometry(lattice=lat, block=(2, 2, 2, 2)),
                                dtype=torch.complex64)
    v = random_spinor((d, lat[0], lat[1], lat[2] * lat[3]), seed=2).astype(np.complex64)
    jv = cplx.as_carray(v).astype_real(jnp.float32)
    tv = torch.as_tensor(v.reshape(d, -1))
    for name in OPS:
        if name == "self_inv":
            want, got = js.self_inv(jv, js.odd), ts.self_inv(tv, ODD)
        else:
            want, got = getattr(js, name)(jv), getattr(ts, name)(tv)
        np.testing.assert_allclose(got.numpy().reshape(v.shape), to_numpy(want),
                                   rtol=1e-5, atol=1e-5 * np.abs(to_numpy(want)).max(),
                                   err_msg=name)


def _fine_setup(lat=(4, 4, 4, 4), n=4, seed=3):
    U = rough_field(lat, seed=seed)
    jop = jwilson.WilsonOperator.from_gauge(jnp.asarray(U), m0=-0.5, csw=1.0)
    tvs = random_spinor((n, *lat, 4, 3), seed=seed + 1)
    jagg = jinterp.Aggregation(fine_lattice=lat, coarsening=(2, 2, 2, 2),
                               num_vectors=n, fine_dpc=6)
    agg = interpolation.Aggregation(fine_lattice=lat, coarsening=(2, 2, 2, 2),
                                    num_vectors=n, fine_dpc=6)
    st = WilsonStencilSoA.build(convert.wilson_operator(jop.links, jop.clover),
                                Geometry(lattice=lat, block=(2, 2, 2, 2)))
    return jop, tvs, jagg, agg, st


def test_interpolation_and_fine_galerkin_match_jax():
    jop, tvs, jagg, agg, st = _fine_setup()
    jP = jinterp.build_interpolation(jagg, jnp.asarray(tvs))
    P = interpolation.build_interpolation(agg, convert.fields(tvs))
    assert rel_err(P.numpy(), convert.interpolation(np.asarray(jP)).numpy()) < 1e-12
    jc = jgal.build_coarse_operator(jop, jagg, jP)
    cop = galerkin.build_coarse_operator(st, agg, P)
    want = convert.coarse_operator(jc.A, jc.Df, jc.Db)
    for got, ref in zip(cop, want):
        assert rel_err(got.numpy(), ref.numpy()) < 1e-11


def test_coarse_galerkin_matches_jax():
    lat, d, n = (4, 4, 4, 4), 8, 3
    A, Df, Db = _random_cop(lat, d, seed=5)
    tvs = random_spinor((n, *lat, d), seed=6)
    jagg = jinterp.Aggregation(fine_lattice=lat, coarsening=(2, 2, 2, 2),
                               num_vectors=n, fine_dpc=d // 2)
    agg = interpolation.Aggregation(*jagg)
    jP = jinterp.build_interpolation(jagg, jnp.asarray(tvs))
    jc = jgal.build_coarse_operator(
        jcoarse.CoarseOperator(jnp.asarray(A), jnp.asarray(Df), jnp.asarray(Db)),
        jagg, jP)
    ts = CoarseStencilSoA.build(convert.coarse_operator(A, Df, Db),
                                Geometry(lattice=lat, block=(2, 2, 2, 2)))
    P = interpolation.build_interpolation(agg, convert.fields(tvs))
    cop = galerkin.build_coarse_operator(ts, agg, P)
    for got, ref in zip(cop, convert.coarse_operator(jc.A, jc.Df, jc.Db)):
        assert rel_err(got.numpy(), ref.numpy()) < 1e-11


def test_p_orthonormal_and_restrict_interpolate():
    _, tvs, _, agg, _ = _fine_setup(n=6)
    P = interpolation.build_interpolation(agg, convert.fields(tvs))
    PPh = torch.einsum("xckm,xclm->xckl", P, P.conj())
    eye = torch.eye(agg.num_vectors, dtype=P.dtype)
    assert float((PPh - eye).abs().max()) < 1e-13
    vc = convert.fields(random_spinor((*agg.coarse_lattice, 2 * agg.num_vectors), 1))
    back = interpolation.restrict(agg, P, interpolation.interpolate(agg, P, vc))
    assert rel_err(back.numpy(), vc.numpy()) < 1e-13
