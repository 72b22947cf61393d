"""The port's accelerator options, module by module, against the JAX package
(inputs from numpy seeds, as in tests/torch_parity.py):

  (a) the plain K4-bf16 against the JAX package's compressed stencil
      (CoarseStencilSoA.compress) through the Pallas coarse kernel in
      interpret mode, which widens the bf16 blocks (pallas_coarse.py:
      114-116); both sides round the same f32 blocks, so rtol is 1e-5;
  (b) the plain K5-bf16 on slabs with faces against the plain K4-bf16 on
      the global field, and the dtype pairs the coarse wrappers refuse;
  (c) the dense inverse and the dense Schur-complement inverse of a 2^4
      coarsest level, with their solves, against the JAX functions (1e-4 in
      complex64, 1e-10 in complex128); a bf16-stored inverse solves to 5e-2
      (the JAX package's own bound, tests/test_split_mode.py:225-231);
  (d) the Schwarz block inverses of a 4^4 coarse level with 2^4 blocks,
      their application and a SAP sweep with them, against the JAX package's
      smoothers/sap.py, to the same tolerances.
K4-bf16, K5-bf16 and K6 themselves are held to these plain versions on a
card in tests/test_torch_kernels.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_coarse import OPS
from torch_parity import random_spinor, rel_err, to_numpy

from ddalphaamg_tpu import cplx
from ddalphaamg_tpu.geometry import Geometry as JGeometry
from ddalphaamg_tpu.operators import coarse as jcoarse
from ddalphaamg_tpu.operators import stencil as jstencil
from ddalphaamg_tpu.smoothers import sap as jsap
from ddalphaamg_tpu_torch import convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg.hierarchy import LevelConfig, MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators import coarse, cuda_coarse, cuda_dense
from ddalphaamg_tpu_torch.operators.stencil import (ODD, CoarseStencilSoA, dense_inverse,
                                                    dense_schur_inverse, dense_schur_solve,
                                                    dense_solve, schur_even_indices)
from ddalphaamg_tpu_torch.parallel import mesh as pmesh
from ddalphaamg_tpu_torch.parallel.comm import face
from ddalphaamg_tpu_torch.smoothers import sap

torch.set_num_threads(1)

TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10}
JDT = {torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}


def _random_cop(lat, d, seed):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    A = c(*lat, d, d) * 0.1 + 2.0 * np.eye(d)
    return A, 0.1 * c(4, *lat, d, d), 0.1 * c(4, *lat, d, d)


def _pair(lat, d, seed, dtype, block=(2, 2, 2, 2)):
    """The same coarse operator as a JAX (complex, einsum path) and a port
    stencil."""
    A, Df, Db = _random_cop(lat, d, seed)
    jcop = jcoarse.CoarseOperator(jnp.asarray(A), jnp.asarray(Df),
                                  jnp.asarray(Db)).astype(JDT[dtype])
    js = jstencil.CoarseStencilSoA.build(jcop, JGeometry(lattice=lat, block=block))
    ts = CoarseStencilSoA.build(convert.coarse_operator(A, Df, Db),
                                Geometry(lattice=lat, block=block), dtype=dtype)
    return js, ts


def _field(lat, d, seed, dtype):
    """A random coarse field as (JAX [d, T, Z, Y*X], port [d, V])."""
    v = random_spinor((d, lat[0], lat[1], lat[2] * lat[3]), seed)
    return (jnp.asarray(v, JDT[dtype]),
            torch.as_tensor(v.reshape(d, -1)).to(dtype))


# ---------------------------------------------------------------------------
# (a) plain K4-bf16 vs the Pallas kernel on compressed blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lat", [(2, 2, 2, 2), (2, 2, 4, 4)])
def test_plain_k4_bf16_matches_pallas_interpret(lat):
    d = 8
    A, Df, Db = _random_cop(lat, d, seed=1)
    geom = JGeometry(lattice=lat, block=(2, 2, 2, 2))
    jcop = jcoarse.CoarseOperator(cplx.as_carray(A), cplx.as_carray(Df),
                                  cplx.as_carray(Db)).astype(jnp.complex64)
    js = jstencil.CoarseStencilSoA.build(jcop, geom, use_pallas=True)
    jc = js.compress()
    assert jc.use_pallas and jc.Pk.re.dtype == jnp.bfloat16
    # the port's stencil on the JAX package's f32 blocks, then compressed
    ts = CoarseStencilSoA.build(convert.coarse_operator(A, Df, Db),
                                Geometry(lattice=lat, block=(2, 2, 2, 2)),
                                dtype=torch.complex64)
    ts = dataclasses.replace(ts, Pk=convert.packed_blocks(to_numpy(js.Pk), lat),
                             Pk_inv=convert.packed_blocks(to_numpy(js.Pk_inv), lat))
    tc = ts.compress()
    assert tc.Pk.dtype == torch.bfloat16 and tc.Pk.shape == (9, d, d, int(np.prod(lat)), 2)
    assert tc.dtype == torch.complex64 and tc.even.dtype == torch.float32
    # both sides rounded the same f32 values to the same bf16 values
    jpk = (np.asarray(jc.Pk.re).astype(np.float32)
           + 1j * np.asarray(jc.Pk.im).astype(np.float32))
    np.testing.assert_array_equal(coarse.widen(tc.Pk).numpy(),
                                  convert.packed_blocks(jpk, lat).numpy())
    v = random_spinor((d, lat[0], lat[1], lat[2] * lat[3]), seed=2).astype(np.complex64)
    jv = cplx.as_carray(v).astype_real(jnp.float32)
    tv = torch.as_tensor(v.reshape(d, -1))
    for name in OPS:
        if name == "self_inv":
            want, got = jc.self_inv(jv, jc.odd), tc.self_inv(tv, ODD)
        else:
            want, got = getattr(jc, name)(jv), getattr(tc, name)(tv)
        np.testing.assert_allclose(got.numpy().reshape(v.shape), to_numpy(want),
                                   rtol=1e-5, atol=1e-5 * np.abs(to_numpy(want)).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (b) plain K5-bf16 vs plain K4-bf16, and the refused dtype pairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(1, 2, 1, 1), (2, 2, 1, 1)], ids=["mesh1x2", "mesh2x2"])
def test_plain_k5_bf16_matches_k4_bf16(dims):
    lat, d = (4, 4, 2, 2), 8
    V = int(np.prod(lat))
    gen = torch.Generator().manual_seed(3)
    Pk = torch.randn((9, d, d, V), generator=gen, dtype=torch.complex64)
    v = torch.randn((2, d, V), generator=gen, dtype=torch.complex64)
    want = {terms: cuda_coarse.coarse_apply(coarse.compress(Pk), v, lat, terms)
            for terms in ((0, 9), (1, 9))}
    for rank in range(int(np.prod(dims))):
        mesh = pmesh.SolverMesh(dims, rank)
        loc = pmesh.local_lattice(mesh, lat)
        blocks = coarse.compress(pmesh.shard_field(mesh, Pk, lat).contiguous())
        halos = {}
        for mu in pmesh.active_axes(mesh, lat):
            fwd = pmesh.shard_field(mesh, coarse.neighbor(v, 1 + mu, lat), lat)
            bwd = pmesh.shard_field(mesh, coarse.neighbor(v, 5 + mu, lat), lat)
            halos[mu] = (face(fwd, loc, mu, loc[mu] - 1), face(bwd, loc, mu, 0))
        for terms, w in want.items():
            got = cuda_coarse.coarse_apply_halo(blocks, pmesh.shard_field(mesh, v, lat),
                                                loc, halos, terms)
            assert rel_err(got.numpy(), pmesh.shard_field(mesh, w, lat).numpy()) < 1e-6, \
                (rank, terms)


def test_bf16_blocks_take_complex64_fields_only():
    lat, d = (2, 2, 2, 2), 4
    Pk = torch.randn((9, d, d, 16), dtype=torch.complex64)
    v128 = torch.randn((d, 16), dtype=torch.complex128)
    with pytest.raises(TypeError):
        cuda_coarse.coarse_apply(coarse.compress(Pk), v128, lat)
    with pytest.raises(TypeError):
        coarse.compress(Pk.to(torch.complex128))
    with pytest.raises(TypeError):
        cuda_dense.matvec(coarse.compress(Pk[0, None, :, :, 0]), v128[None, :, 0])
    levels = [LevelConfig(lattice=(4, 4, 4, 4)), LevelConfig(lattice=(2, 2, 2, 2))]
    with pytest.raises(ValueError):
        Multigrid(None, MGConfig(levels=levels, dtype=torch.complex128,
                                 coarse_block_bf16=True))


# ---------------------------------------------------------------------------
# (c) coarsest dense inverses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_dense_inverses_match_jax(dtype):
    lat, d = (2, 2, 2, 2), 8
    js, ts = _pair(lat, d, seed=4, dtype=dtype, block=(1, 1, 1, 1))
    jb, b = _field(lat, d, seed=5, dtype=dtype)
    tol = TOL[dtype]

    jinv = jstencil.dense_inverse(js)
    inv = dense_inverse(ts)
    assert inv.shape == (1, 16 * d, 16 * d) and inv.dtype == dtype
    assert rel_err(inv[0].numpy(), np.asarray(jinv)) < tol
    x = dense_solve(inv, b)
    assert rel_err(x.numpy(), np.asarray(jstencil.dense_solve(jinv, jb)).reshape(d, -1)) < tol
    assert rel_err(ts.full_op(x).numpy(), b.numpy()) < tol

    jidx = jstencil.schur_even_indices(js)
    idx = schur_even_indices(ts)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    jsinv = jstencil.dense_schur_inverse(js, jnp.asarray(jidx))
    sinv = dense_schur_inverse(ts, idx)
    assert sinv.shape == (1, 8 * d, 8 * d)
    assert rel_err(sinv[0].numpy(), np.asarray(jsinv)) < tol
    xs = dense_schur_solve(ts, sinv, idx, b)
    want = np.asarray(jstencil.dense_schur_solve(js, jsinv, jnp.asarray(jidx), jb))
    assert rel_err(xs.numpy(), want.reshape(d, -1)) < tol
    assert rel_err(ts.full_op(xs).numpy(), b.numpy()) < tol

    if dtype == torch.complex64:
        # bf16 storage (coarse block bf16), applied with the compressed view
        # the cycles use: well inside the coarsest tolerance 5e-2
        inv16 = dense_inverse(ts, bf16=True)
        sinv16 = dense_schur_inverse(ts, idx, bf16=True)
        assert inv16.dtype == sinv16.dtype == torch.bfloat16
        for x16 in (dense_solve(inv16, b), dense_schur_solve(ts.compress(), sinv16, idx, b)):
            assert rel_err(ts.full_op(x16).numpy(), b.numpy()) < 5e-2


# ---------------------------------------------------------------------------
# (d) Schwarz block inverses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_block_inverses_match_jax(dtype):
    lat, d = (4, 4, 4, 4), 8
    js, ts = _pair(lat, d, seed=6, dtype=dtype)
    tol = TOL[dtype]
    jbinv = jsap.build_block_inverse(js)
    binv = sap.build_block_inverse(ts)
    assert binv.shape == (16, 16 * d, 16 * d) and binv.dtype == dtype
    assert rel_err(binv.numpy(), np.asarray(jbinv)) < tol

    jv, v = _field(lat, d, seed=7, dtype=dtype)
    assert rel_err(sap.from_blocks(sap.to_blocks(v, ts.geom), ts.geom, d).numpy(),
                   v.numpy()) == 0.0
    pre = sap.SchwarzPreconditioner(ts, block_iter=4, cycles=2, odd_even=False)
    jcolors = tuple(js.lattice_mask(m) for m in jsap.color_masks(js.geom))
    red, jred = pre.colors[0], jcolors[0]
    delta = sap.apply_block_inverse(ts, binv, red * v)
    want = np.asarray(jsap.apply_block_inverse(js, jbinv, jred * jv)).reshape(d, -1)
    assert rel_err(delta.numpy(), want) < tol
    # exact per block: the block operator maps delta back to r on its blocks
    assert rel_err(ts.block_op(delta).numpy(), (red * v).numpy()) < tol
    got = sap.sap_smooth(ts, pre.colors, v, 2, 4, False, block_inv=binv)
    want = np.asarray(jsap.sap_smooth(js, jcolors, jv, 2, 4, False, block_inv=jbinv))
    assert rel_err(got.numpy(), want.reshape(d, -1)) < tol

    if dtype == torch.complex64:
        binv16 = sap.build_block_inverse(ts, bf16=True)
        assert binv16.dtype == torch.bfloat16 and binv16.shape == (*binv.shape, 2)
        d16 = sap.apply_block_inverse(ts.compress(), binv16, red * v)
        assert rel_err(ts.block_op(d16).numpy(), (red * v).numpy()) < 5e-2
