"""K6 on one Schwarz colour's blocks, and the exact three-part split of its
tensor-core kernel, against the JAX package (inputs from numpy seeds):

  (a) for each colouring (red_black, sixteen_color, additive) and each
      colour of a 4^4 coarse level with 2^4 blocks (16 blocks, d = 8),
      sap.apply_block_inverse with the colour's block list (plain path)
      against the JAX package's apply_block_inverse on the masked input, in
      complex64 / complex128 (1e-4 / 1e-10, the tolerances of
      tests/test_torch_direct.py) and with bf16 storage (the same widened
      inverse on both sides, 1e-4; the block residual within 5e-2); the
      output is exactly zero outside the colour, and the smoother's lists
      are the colours' blocks in to_blocks order;
  (b) split3_bf16, the plain mirror of the kernel's split of x: v1 + v2 +
      v3 == v bit for bit on random f32 values of every magnitude and on
      edge values, and the split product emulated in PyTorch (three
      products of the widened real [m, 2m] matrix, summed in the kernel's
      order) agrees with matvec_plain to 1e-6;
  (c) the slice: a three-level solve with method 3 (sixteen-colour SAP),
      coarsest direct and smoother direct, complex128, the same injected
      test vectors on both sides: one preconditioner cycle to 1e-9 and
      equal outer iterations (the tolerances of
      tests/test_torch_direct_mg.py).  An 8x4x4x4 lattice at m0 = 0.5 (12
      outer iterations) keeps the test near 1 min on the CPU; its depth-1
      level (4x2x2x2, 2^4 blocks) has 2 blocks, so 14 of the 16 colours
      pass an empty block list.
The kernels themselves are held to these plain versions on a card in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_direct import TOL, _field, _pair
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu.mg.hierarchy import Multigrid as JMultigrid
from ddalphaamg_tpu.smoothers import sap as jsap
from ddalphaamg_tpu_torch import api, config, convert
from ddalphaamg_tpu_torch.operators import coarse, cuda_dense, fast
from ddalphaamg_tpu_torch.smoothers import sap

torch.set_num_threads(1)

SCHEMES = {"red_black": 2, "sixteen_color": 16, "additive": 1}


# ---------------------------------------------------------------------------
# (a) block inverses on one colour's blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[torch.complex64, torch.complex128, "bf16"],
                ids=["complex64", "complex128", "bf16"])
def inverses(request):
    dtype = torch.complex64 if request.param == "bf16" else request.param
    lat, d = (4, 4, 4, 4), 8
    js, ts = _pair(lat, d, seed=6, dtype=dtype)
    jv, v = _field(lat, d, seed=7, dtype=dtype)
    if request.param == "bf16":
        binv = sap.build_block_inverse(ts, bf16=True)
        jbinv = jnp.asarray(coarse.widen(binv).numpy())    # the same widened inverse
        ts_apply = ts.compress()
    else:
        binv = sap.build_block_inverse(ts)
        jbinv = jsap.build_block_inverse(js)
        ts_apply = ts
    return request.param, dtype, js, ts, ts_apply, binv, jbinv, jv, v


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_colour_block_inverse_matches_jax(inverses, scheme):
    kind, dtype, js, ts, ts_apply, binv, jbinv, jv, v = inverses
    d = ts.dof
    pre = sap.SchwarzPreconditioner(ts, block_iter=4, odd_even=False, scheme=scheme)
    jmasks = jsap.color_masks(js.geom, scheme)
    assert len(pre.colors) == len(jmasks) == SCHEMES[scheme]
    assert (pre.blocks is None) == (scheme == "additive")
    tol = TOL[dtype]
    seen = []
    for c, (mask, jm) in enumerate(zip(pre.colors, jmasks)):
        np.testing.assert_array_equal(mask.numpy(), jm.reshape(-1))
        blocks = sap.color_blocks(mask, ts.geom)
        assert blocks.dtype == torch.int32
        if pre.blocks is not None:
            assert torch.equal(pre.blocks[c], blocks)
        # the colour's blocks, in to_blocks order: the rows where the mask is 1
        on = sap.to_blocks(mask.reshape(1, -1), ts.geom)
        assert torch.equal(torch.nonzero(on.amax(1) > 0).reshape(-1).int(), blocks)
        assert bool((on.amin(1)[blocks.long()] == 1).all())
        seen += blocks.tolist()

        r = mask * v
        delta = sap.apply_block_inverse(ts_apply, binv, r, blocks)
        want = np.asarray(jsap.apply_block_inverse(js, jbinv, js.lattice_mask(jm) * jv))
        assert rel_err(delta.numpy(), want.reshape(d, -1)) < tol
        outside = sap.to_blocks(delta, ts.geom)
        others = torch.ones(outside.shape[0], dtype=torch.bool)
        others[blocks.long()] = False
        assert bool((outside[others] == 0).all())
        if kind == "bf16":
            assert rel_err(ts.block_op(delta).numpy(), r.numpy()) < 5e-2
    assert sorted(seen) == list(range(16))          # the colours cover every block once


def test_block_list_checks():
    A = coarse.compress(torch.randn((4, 6, 6), dtype=torch.complex64))
    x = torch.randn((4, 6), dtype=torch.complex64)
    full = cuda_dense.matvec(A, x)
    got = cuda_dense.matvec(A, x, torch.tensor([1, 3], dtype=torch.int32))
    assert torch.equal(got[[1, 3]], full[[1, 3]]) and bool((got[[0, 2]] == 0).all())
    assert bool((cuda_dense.matvec(A, x, torch.zeros(0, dtype=torch.int32)) == 0).all())
    for bad in ([3, 1], [1, 1], [0, 4], [-1, 2]):
        with pytest.raises(ValueError):
            cuda_dense.matvec(A, x, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_dense.matvec(A, x, torch.tensor([0, 1]))                 # int64
    blocks = torch.tensor([0, 2], dtype=torch.int32)
    cuda_dense.matvec(A, x, blocks)
    blocks[1] = 7                                                    # checked again once written
    with pytest.raises(ValueError):
        cuda_dense.matvec(A, x, blocks)


# ---------------------------------------------------------------------------
# (b) the exact split of x into three bf16 parts
# ---------------------------------------------------------------------------

def _sum(parts):
    v1, v2, v3 = (p.float() for p in parts)
    return (v1 + v2) + v3


def test_split3_is_exact():
    rng = np.random.default_rng(5)
    mag = 2.0 ** rng.uniform(-100, 120, size=20000)
    v = torch.as_tensor(rng.normal(size=mag.size) * mag, dtype=torch.float32)
    powers = [2.0 ** k for k in range(-109, 127)]
    edges = torch.tensor(powers + [2.0 ** 126, 1e-30, 0.0, 3.0e38, 1.0 + 2 ** -23,
                                   (1 + 2 ** -23) * 2.0 ** -100], dtype=torch.float32)
    for w in (v, edges, -edges):
        parts = cuda_dense.split3_bf16(w)
        assert all(p.dtype == torch.bfloat16 for p in parts)
        assert torch.equal(_sum(parts), w)
        assert torch.equal(parts[0].double() + parts[1].double() + parts[2].double(), w.double())
    # outside the range: near 2^-115 the last part falls below bf16's
    # subnormals, and near the largest f32 the first part rounds to infinity
    tiny = torch.tensor([(1 + 2 ** -23) * 2.0 ** -115], dtype=torch.float32)
    assert not torch.equal(_sum(cuda_dense.split3_bf16(tiny)), tiny)
    huge = torch.tensor([torch.finfo(torch.float32).max], dtype=torch.float32)
    assert torch.isinf(cuda_dense.split3_bf16(huge)[0]).all()


@pytest.mark.parametrize("nb, m, R", [(1, 96, 12), (6, 32, 5), (5, 18, 2)])
def test_split_product_matches_plain(nb, m, R):
    rng = np.random.default_rng(nb * m + R)
    A = coarse.compress(torch.as_tensor(rng.normal(size=(nb, m, m)) + 1j * rng.normal(
        size=(nb, m, m)), dtype=torch.complex64))
    x = torch.as_tensor(rng.normal(size=(R, nb, m)) + 1j * rng.normal(size=(R, nb, m)),
                        dtype=torch.complex64)
    a_int = A.float().reshape(nb, m, 2 * m)                 # [xr, xi] pairs along k
    sums = []
    for xr, xi in zip(cuda_dense.split3_bf16(x.real), cuda_dense.split3_bf16(x.imag)):
        xr, xi = xr.float(), xi.float()
        re_col = torch.stack([xr, -xi], -1).reshape(R, nb, 2 * m)   # gives Re y
        im_col = torch.stack([xi, xr], -1).reshape(R, nb, 2 * m)    # gives Im y
        sums.append(torch.complex(
            torch.einsum("bik,rbk->rbi", a_int, re_col),
            torch.einsum("bik,rbk->rbi", a_int, im_col)))
    got = (sums[2] + sums[1]) + sums[0]
    want = cuda_dense.matvec_plain(A, x)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6


# ---------------------------------------------------------------------------
# (c) the slice: method 3 with both stored inverses
# ---------------------------------------------------------------------------

INI = """configuration: none
number of levels: 3
d0 global lattice: 8 4 4 4
d0 test vectors: 4
d0 setup iter: 1
d1 test vectors: 4
d1 setup iter: 1
m0: 0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: 3
mixed precision: 0
coarsest direct: 1
smoother direct: 1
"""


def test_method3_with_stored_inverses_matches_jax():
    lat, n = (8, 4, 4, 4), 4
    U = rough_field(lat, seed=51)
    tv0 = random_spinor((n, *lat, 4, 3), seed=52)
    tv1 = random_spinor((n, 4, 2, 2, 2, 2 * n), seed=53)

    js = japi.Solver(jconfig.parse_ini(INI))
    js.set_conf(U, links_have_bc=True)
    jmg = JMultigrid(js.op, js._mg_config())
    js.mg = js.preconditioner = jmg
    jmg.set_test_vectors(tv0)
    jmg.fine.next.test_vectors = jnp.asarray(tv1)
    jmg.re_setup(jmg.fine)
    jmg.bootstrap_setup()

    p = config.parse_ini(INI)
    p.inner_tol_clip = 1e-7       # the clip of _solve_mp_device
    s = api.Solver(p, device="cpu")
    s.set_conf(U, links_have_bc=True)
    mg = s.build_hierarchy()
    mg.set_test_vectors(tv0)
    mg.set_test_vectors(tv1, depth=1)
    mg.bootstrap_setup()
    assert jmg.cfg.smoother_direct and mg.cfg.scheme == "sixteen_color"
    depth1 = mg._levels()[1]
    # block t of the 2x1x1x1 block grid has colour pattern 8 t, solved at
    # steps 0 and 15 of the reference's order
    assert [b.tolist() for b in depth1.smoother.blocks] == [[0]] + [[]] * 14 + [[1]]

    eta = random_spinor((*lat, 4, 3), seed=99)
    want = np.asarray(jmg(jnp.asarray(eta)))
    got = fast.spinor_from_soa(mg(convert.fields(eta)), lat).numpy()
    assert rel_err(got, want) < 1e-9

    rhs = np.ones((*lat, 4, 3), np.complex128)
    jres = js._solve_mp_device(rhs, 1e-10)
    x, info = s.solve(rhs)
    assert info.converged and jres.converged
    assert info.iterations == jres.iterations
    assert s.true_residual(x, rhs) < 1e-10
    assert info.coarse_matvec_average == 0 and info.coarsest_inverse_applies > 0
    assert depth1.block_inv.shape == (2, 16 * 2 * n, 16 * 2 * n)    # 2^4 blocks, 2n dof
