"""The hand-written CUDA kernels K1-K7 (K2 and K3 with a parity and the
compact odd-site clover storage; K4 and K5 with f32, f64 and bf16
blocks; K7 with its row read from the device) against their plain
PyTorch versions on a card, small solves through them, and the device
programs (the coarsest GCR, mg/coarsest.py; the inner restart and the
cycle, mg/programs.py) as CUDA graphs against the host loops.  Every test here needs a CUDA
device and skips without one.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from torch_graph_stub import traced  # noqa: F401 (a fixture)

from ddalphaamg_tpu_torch import api, config, kernels
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg.coarsest import CoarsestGraph, coarsest_gcr
from ddalphaamg_tpu_torch.mg import hierarchy
from ddalphaamg_tpu_torch.operators import (coarse, cuda_coarse, cuda_dense, cuda_dslash,
                                            cuda_gcr, fast, stencil)
from ddalphaamg_tpu_torch.operators.stencil import ODD, CoarseStencilSoA

torch.set_num_threads(1)

TOL = {torch.complex64: 1e-5, torch.complex128: 1e-13}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _unitary_links(lat, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(4, *lat, 3, 3)) + 1j * rng.normal(size=(4, *lat, 3, 3))
    q, _ = np.linalg.qr(a)
    return q


def _rel(got, want):
    torch.cuda.synchronize()
    return float((got - want).abs().max() / want.abs().max())


def _cplx(shape, gen, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_dslash_kernels_match_plain(cuda, dtype):
    lat = (4, 4, 4, 8)
    from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
    op = WilsonOperator.from_gauge(torch.as_tensor(_unitary_links(lat, 1), device=cuda),
                                   -0.5, 1.0)
    links = fast.links_to_soa(op.links).to(dtype)
    cdiag, coff = cuda_dslash.pack_clover(fast.clover_to_soa(op.clover))
    cdiag, coff = cdiag.to(links.real.dtype), coff.to(dtype)
    gen = torch.Generator(device=cuda).manual_seed(2)
    phi = _cplx((3, 12, int(np.prod(lat))), gen, dtype, cuda)
    cases = [
        (cuda_dslash.d_plus_clover(links, cdiag, coff, phi, lat),
         fast.d_plus_clover_soa(links, cdiag, coff, phi, lat)),
        (cuda_dslash.hopping(links, phi[0], lat), fast.dslash_hopping_soa(links, phi[0], lat)),
        (cuda_dslash.clover(cdiag, coff, phi, lat), fast.clover_apply_soa(cdiag, coff, phi)),
        (cuda_dslash.clover(cdiag, coff, phi, lat, ODD),
         fast.clover_apply_soa(cdiag, coff, phi, lat, ODD)),
        (cuda_dslash.clover(cdiag, coff, phi, lat, ODD, parity_offset=1),
         fast.clover_apply_soa(cdiag, coff, phi, lat, ODD, parity_offset=1)),
    ]
    for got, want in cases:
        assert _rel(got, want) < TOL[dtype]


# K1-K3 at every shape class: small lattices, one whose x rows do not tile
# the batched kernel's 128-site bricks (x = 6: linear blocks) and the
# rough16 fine level (16^4), the batches of the path (1, 28 test vectors,
# 56 Galerkin basis fields) and an odd one; every parity (K2 and K3) and
# slab offset parity, the clover inverse in full and compact storage
DSLASH_LATTICES = [(4, 4, 4, 8), (2, 4, 2, 6), (8, 4, 8, 8), (16, 16, 16, 16)]
DSLASH_BATCHES = [1, 3, 28, 56]
PARITIES = [(None, 0), (0, 0), (1, 0), (0, 1), (1, 1)]     # (parity, parity_offset)


def _wilson_soa(lat, dtype, device, seed):
    """Links, packed clover and packed clover inverse (every site) of a
    random unitary field, in the kernels' layout and dtype."""
    from ddalphaamg_tpu_torch.operators.stencil import herm_inv
    from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator

    op = WilsonOperator.from_gauge(torch.as_tensor(_unitary_links(lat, seed), device=device),
                                   -0.5, 1.0)
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    links = fast.links_to_soa(op.links).to(dtype)
    packed = [cuda_dslash.pack_clover(fast.clover_to_soa(c)) for c in (op.clover, herm_inv(op.clover))]
    return links, [(d.to(rdtype), o.to(dtype)) for d, o in packed]


def _dslash_runs(links, clov, inv, phi, lat, parity, offset):
    """(label, kernel run, plain run) of every K1-K3 entry point for one
    parity case."""
    runs = [("K2", lambda: cuda_dslash.hopping(links, phi, lat, parity, offset),
             lambda: fast.dslash_hopping_soa(links, phi, lat, parity, offset)),
            ("K3 full storage", lambda: cuda_dslash.clover(*inv, phi, lat, parity, offset),
             lambda: fast.clover_apply_soa(*inv, phi, lat, parity, offset))]
    if parity is None:
        runs.append(("K1", lambda: cuda_dslash.d_plus_clover(links, *clov, phi, lat),
                     lambda: fast.d_plus_clover_soa(links, *clov, phi, lat)))
    else:
        compact = [fast.compact_parity(t, lat, parity, offset) for t in inv]
        runs.append(("K3 compact", lambda: cuda_dslash.clover(*compact, phi, lat, parity, offset,
                                                             compact=True),
                     lambda: fast.clover_apply_soa(*compact, phi, lat, parity, offset,
                                                   compact=True)))
    return runs


@pytest.mark.gpu
@pytest.mark.parametrize("batch", DSLASH_BATCHES)
@pytest.mark.parametrize("lat", DSLASH_LATTICES)
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_dslash_kernels_every_shape(cuda, dtype, lat, batch):
    links, (clov, inv) = _wilson_soa(lat, dtype, cuda, 13)
    gen = torch.Generator(device=cuda).manual_seed(14)
    phi = _cplx((batch, 12, int(np.prod(lat))), gen, dtype, cuda)
    for parity, offset in PARITIES:
        for label, run, plain in _dslash_runs(links, clov, inv, phi, lat, parity, offset):
            assert _rel(run(), plain()) < TOL[dtype], (label, parity, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_dslash_kernels_are_deterministic(cuda, dtype):
    """Two launches of every entry point on the same inputs give the same
    bits (the four directions of a site are summed in a fixed order)."""
    lat = (8, 4, 8, 8)
    links, (clov, inv) = _wilson_soa(lat, dtype, cuda, 15)
    gen = torch.Generator(device=cuda).manual_seed(16)
    for batch in (1, 28):
        phi = _cplx((batch, 12, int(np.prod(lat))), gen, dtype, cuda)
        for parity, offset in PARITIES:
            for label, run, _ in _dslash_runs(links, clov, inv, phi, lat, parity, offset):
                assert torch.equal(run(), run()), (label, batch, parity, offset)


@pytest.mark.gpu
def test_dslash_parity_needs_even_x(cuda):
    lat = (4, 4, 4, 3)
    links, (_, inv) = _wilson_soa(lat, torch.complex64, cuda, 17)
    phi = _cplx((1, 12, int(np.prod(lat))), torch.Generator(device=cuda).manual_seed(18),
                torch.complex64, cuda)
    assert _rel(cuda_dslash.hopping(links, phi, lat), fast.dslash_hopping_soa(links, phi, lat)) < 1e-5
    with pytest.raises(ValueError):
        cuda_dslash.hopping(links, phi, lat, 1)
    with pytest.raises(ValueError):
        cuda_dslash.clover(*inv, phi, lat, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_coarse_kernel_matches_plain(cuda, dtype):
    lat, d = (4, 4, 2, 4), 24
    V = int(np.prod(lat))
    gen = torch.Generator(device=cuda).manual_seed(3)
    Pk = _cplx((9, d, d, V), gen, dtype, cuda)
    v = _cplx((5, d, V), gen, dtype, cuda)
    for terms, mask, parity in [((0, 9), None, None), ((1, 9), None, None),
                                ((0, 9), (2, 2, 2, 2), None),
                                ((1, 9), (2, 2, 2, 2), None),
                                ((0, 1), None, None), ((0, 1), None, ODD)]:
        got = cuda_coarse.coarse_apply(Pk, v, lat, terms, mask, parity)
        want = coarse.coarse_apply_plain(Pk, v, lat, terms, mask, parity)
        assert _rel(got, want) < TOL[dtype], (terms, mask, parity)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_coarse_halo_kernel_matches_plain(cuda, dtype):
    lat, d, B = (4, 2, 2, 4), 24, 5
    V = int(np.prod(lat))
    gen = torch.Generator(device=cuda).manual_seed(4)
    Pk = _cplx((9, d, d, V), gen, dtype, cuda)
    v = _cplx((B, d, V), gen, dtype, cuda)

    def faces(mu):
        return tuple(_cplx((B, d, V // lat[mu]), gen, dtype, cuda) for _ in range(2))

    for axes in [(0,), (1,), (0, 1), (2,), (3,), (2, 3), (0, 1, 2, 3)]:
        halos = {mu: faces(mu) for mu in axes}
        for terms in [(0, 9), (1, 9)]:
            got = cuda_coarse.coarse_apply_halo(Pk, v, lat, halos, terms)
            want = coarse.coarse_apply_halo_plain(Pk, v, lat, halos, terms)
            assert _rel(got, want) < TOL[dtype], (axes, terms)


@pytest.mark.gpu
def test_coarse_bf16_kernels_match_plain(cuda):
    lat, d, B = (4, 2, 2, 4), 24, 5
    V = int(np.prod(lat))
    gen = torch.Generator(device=cuda).manual_seed(6)
    Pk = coarse.compress(_cplx((9, d, d, V), gen, torch.complex64, cuda))
    v = _cplx((B, d, V), gen, torch.complex64, cuda)
    tol = TOL[torch.complex64]
    for terms, mask, parity in [((0, 9), None, None), ((1, 9), (2, 2, 2, 2), None),
                                ((0, 1), None, ODD)]:
        got = cuda_coarse.coarse_apply(Pk, v, lat, terms, mask, parity)
        want = coarse.coarse_apply_plain(Pk, v, lat, terms, mask, parity)
        assert _rel(got, want) < tol, (terms, mask, parity)
    halos = {mu: tuple(_cplx((B, d, V // lat[mu]), gen, torch.complex64, cuda)
                       for _ in range(2)) for mu in range(4)}
    got = cuda_coarse.coarse_apply_halo(Pk, v, lat, halos)
    assert _rel(got, coarse.coarse_apply_halo_plain(Pk, v, lat, halos)) < tol
    with pytest.raises(TypeError):
        cuda_coarse.coarse_apply(Pk, v.to(torch.complex128), lat)


@pytest.mark.gpu
def test_dense_bf16_matvec_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    for nb, m in [(1, 256), (6, 132)]:
        A = coarse.compress(_cplx((nb, m, m), gen, torch.complex64, cuda))
        x = _cplx((nb, m), gen, torch.complex64, cuda)
        assert _rel(cuda_dense.matvec(A, x), cuda_dense.matvec_plain(A, x)) < 1e-5
    with pytest.raises(ValueError):
        cuda_dense.matvec(coarse.compress(_cplx((1, 6, 6), gen, torch.complex64, cuda)),
                          _cplx((1, 5), gen, torch.complex64, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [18, 90])
def test_dense_bf16_matvec_unaligned_rows(cuda, m):
    """K6 on rows that are not 16-byte aligned (m not a multiple of 4)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for nb in (1, 5):
        A = coarse.compress(_cplx((nb, m, m), gen, torch.complex64, cuda))
        x = _cplx((nb, m), gen, torch.complex64, cuda)
        assert _rel(cuda_dense.matvec(A, x), cuda_dense.matvec_plain(A, x)) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("nb, m", [(1, 7168), (256, 896), (5, 90)],
                         ids=["schur-inverse", "block-inverses", "unaligned-rows"])
@pytest.mark.parametrize("R", [1, 3, 12, 28])
def test_dense_bf16_matvec_many_rhs(cuda, nb, m, R):
    """K6 over R right-hand sides x [R, nb, m] at rough16's two stored
    inverses and on rows that are not 16-byte aligned: one launch per 12
    right-hand sides; each lane within 1e-5 of a batch-1 launch on it alone
    (the tensor-core kernel sums in another order than the batch-1 kernel),
    and its bits those of the same lane in a launch of two."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    A = coarse.compress(_cplx((nb, m, m), gen, torch.complex64, cuda))
    x = _cplx((R, nb, m), gen, torch.complex64, cuda)
    kernels.reset_counts()
    got = cuda_dense.matvec(A, x)
    assert kernels.counts()["K6"] == -(-R // cuda_dense.MRHS_MAX)
    assert got.shape == x.shape
    assert _rel(got, cuda_dense.matvec_plain(A, x)) < 1e-5
    for r in (0, R - 1):
        assert _rel(got[r], cuda_dense.matvec(A, x[r])) < 1e-5
        if 1 < R <= cuda_dense.MRHS_MAX:
            other = (r + 1) % R
            assert torch.equal(got[r], cuda_dense.matvec(A, x[[r, other]])[0])


def _block_lists(nb, device):
    """Block lists of a K6 test: at 256 blocks (a 4^4 block grid) one
    red-black colour and one of sixteen; elsewhere every other block and
    one block; then all blocks and none."""
    if nb == 256:
        c = torch.arange(256, device=device)
        t, z, y, x = c // 64, c // 16 % 4, c // 4 % 4, c % 4
        red = c[(t + z + y + x) % 2 == 0]
        one16 = c[(t % 2 == 1) & (z % 2 == 0) & (y % 2 == 1) & (x % 2 == 1)]
        lists = {"red": red, "one of sixteen": one16}
    else:
        lists = {"every other": torch.arange(0, nb, 2, device=device),
                 "one": torch.tensor([nb - 1], device=device)}
    lists.update({"all": torch.arange(nb, device=device),
                  "none": torch.zeros(0, dtype=torch.int64, device=device)})
    return {k: v.to(torch.int32) for k, v in lists.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("nb, m", [(1, 7168), (256, 896), (5, 90)],
                         ids=["schur-inverse", "block-inverses", "unaligned-rows"])
@pytest.mark.parametrize("R", [1, 2, 12])
def test_dense_bf16_matvec_block_lists(cuda, nb, m, R):
    """Both K6 kernels on a list of blocks: the listed blocks within 1e-5 of
    the plain version (at batch 1 bit for bit those of an all-block launch),
    every other block exactly zero, one launch (none for an empty list),
    and two launches give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    A = coarse.compress(_cplx((nb, m, m), gen, torch.complex64, cuda))
    x = _cplx((R, nb, m), gen, torch.complex64, cuda)
    x = x[0] if R == 1 else x
    full = cuda_dense.matvec(A, x)
    for name, blocks in _block_lists(nb, cuda).items():
        kernels.reset_counts()
        got = cuda_dense.matvec(A, x, blocks)
        assert kernels.counts()["K6"] == (1 if blocks.numel() else 0), name
        listed = blocks.long()
        others = torch.ones(nb, dtype=torch.bool, device=cuda)
        others[listed] = False
        assert bool((got[..., others, :] == 0).all()), name
        if blocks.numel():
            want = cuda_dense.matvec_plain(A, x, blocks)
            assert _rel(got[..., listed, :], want[..., listed, :]) < 1e-5, name
            if R == 1:
                assert torch.equal(got[listed], full[listed]), name
        assert torch.equal(got, cuda_dense.matvec(A, x, blocks)), name
    with pytest.raises(ValueError):
        cuda_dense.matvec(A, x, torch.tensor([0, 0], dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        cuda_dense.matvec(A, x, torch.tensor([0], dtype=torch.int32))       # on the CPU


@pytest.mark.gpu
def test_coarse_parity_offset_matches_plain(cuda):
    lat, d = (2, 3, 2, 2), 8
    V = int(np.prod(lat))
    gen = torch.Generator(device=cuda).manual_seed(5)
    Pk = _cplx((1, d, d, V), gen, torch.complex64, cuda)
    v = _cplx((2, d, V), gen, torch.complex64, cuda)
    for off in (0, 1):
        got = cuda_coarse.coarse_apply(Pk, v, lat, (0, 1), parity=ODD, parity_offset=off)
        want = coarse.coarse_apply_plain(Pk, v, lat, (0, 1), parity=ODD, parity_offset=off)
        assert _rel(got, want) < TOL[torch.complex64], off


# every shape class of the two coarse kernels: V a multiple of the 16-site
# tile, V odd (entry-sized copies), V = 24 (a partial tile; bf16 rows not
# 16-byte aligned); d a multiple of neither the 28-row chunk nor the 8-value
# j stage (20), of the stage only (24), the rough16 width (56); batches
# around the 28-wide right-hand-side tile and the launcher's switch (12 on
# small lattices);
# tiny lattices also take the cluster split of the term sum
SHAPE_LATTICES = [(4, 4, 2, 4), (3, 3, 3, 3), (2, 2, 2, 3)]
SHAPE_DOFS = [20, 24, 56]
SHAPE_BATCHES = [1, 2, 3, 7, 12, 28, 29, 256]
BLOCK_KINDS = ["f32", "f64", "bf16"]
TERM_CASES = [((0, 9), None, None), ((1, 9), None, None), ((0, 9), (2, 2, 2, 2), None),
              ((1, 9), (2, 2, 2, 2), None), ((0, 1), None, None), ((0, 1), None, ODD)]
KERNELS = [None, "batch1", "multi"]     # the launcher's choice, then each kernel


def _blocks(kind, shape, gen, device):
    """Random blocks of one kind and the field dtype they apply to."""
    dtype = torch.complex128 if kind == "f64" else torch.complex64
    Pk = _cplx(shape, gen, dtype, device)
    return (coarse.compress(Pk) if kind == "bf16" else Pk), dtype


@pytest.mark.gpu
@pytest.mark.parametrize("batch", SHAPE_BATCHES)
@pytest.mark.parametrize("d", SHAPE_DOFS)
@pytest.mark.parametrize("lat", SHAPE_LATTICES)
@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_coarse_kernels_every_shape(cuda, kind, lat, d, batch):
    V = int(np.prod(lat))
    gen = torch.Generator(device=cuda).manual_seed(9)
    Pk, dtype = _blocks(kind, (9, d, d, V), gen, cuda)
    v = _cplx((batch, d, V), gen, dtype, cuda)
    for terms, mask, parity in TERM_CASES:
        if mask is not None and any(n % m for n, m in zip(lat, mask)):
            continue
        want = coarse.coarse_apply_plain(Pk, v, lat, terms, mask, parity)
        for kernel in KERNELS:
            got = cuda_coarse.coarse_apply(Pk, v, lat, terms, mask, parity, kernel=kernel)
            assert _rel(got, want) < TOL[dtype], (terms, mask, parity, kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 28])
@pytest.mark.parametrize("lat", [(8, 4, 8, 8), (5, 5, 9, 11)])
@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_coarse_kernels_wide_tiles(cuda, kind, lat, batch):
    """Lattices of 2048 sites and more, where the batch-1 kernel takes
    32-site tiles (V = 2475 is odd: entry-sized loads)."""
    d, V = 24, int(np.prod(lat))
    gen = torch.Generator(device=cuda).manual_seed(12)
    Pk, dtype = _blocks(kind, (9, d, d, V), gen, cuda)
    v = _cplx((batch, d, V), gen, dtype, cuda)
    for terms, mask, parity in [((0, 9), None, None), ((1, 9), None, None), ((0, 1), None, ODD)]:
        want = coarse.coarse_apply_plain(Pk, v, lat, terms, mask, parity)
        for kernel in KERNELS:
            got = cuda_coarse.coarse_apply(Pk, v, lat, terms, mask, parity, kernel=kernel)
            assert _rel(got, want) < TOL[dtype], (terms, parity, kernel)


def _faces(lat, axes, batch, d, gen, dtype, device):
    V = int(np.prod(lat))
    return {mu: tuple(_cplx((batch, d, V // lat[mu]), gen, dtype, device) for _ in range(2))
            for mu in axes}


@pytest.mark.gpu
@pytest.mark.parametrize("batch", SHAPE_BATCHES)
@pytest.mark.parametrize("axes", [(0,), (1,), (0, 1), (2,), (3,), (2, 3), (0, 1, 2, 3)])
@pytest.mark.parametrize("lat", [(4, 2, 2, 4), (3, 3, 3, 3)])
@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_coarse_halo_kernels_every_batch(cuda, kind, lat, axes, batch):
    d = 20
    gen = torch.Generator(device=cuda).manual_seed(10)
    Pk, dtype = _blocks(kind, (9, d, d, int(np.prod(lat))), gen, cuda)
    v = _cplx((batch, d, int(np.prod(lat))), gen, dtype, cuda)
    halos = _faces(lat, axes, batch, d, gen, dtype, cuda)
    for terms in [(0, 9), (1, 9)]:
        want = coarse.coarse_apply_halo_plain(Pk, v, lat, halos, terms)
        for kernel in KERNELS:
            got = cuda_coarse.coarse_apply_halo(Pk, v, lat, halos, terms, kernel=kernel)
            assert _rel(got, want) < TOL[dtype], (terms, kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_coarse_kernels_are_deterministic(cuda, kind, kernel):
    """Two launches on the same inputs give the same bits (no atomics; the
    4^4 lattice at batch 28 takes the cluster split of the term sum)."""
    lat, d = (4, 4, 4, 4), 56
    V = int(np.prod(lat))
    gen = torch.Generator(device=cuda).manual_seed(11)
    Pk, dtype = _blocks(kind, (9, d, d, V), gen, cuda)
    for batch in (1, 28):
        v = _cplx((batch, d, V), gen, dtype, cuda)
        halos = _faces(lat, (0, 1), batch, d, gen, dtype, cuda)
        for run in (lambda: cuda_coarse.coarse_apply(Pk, v, lat, kernel=kernel),
                    lambda: cuda_coarse.coarse_apply(Pk, v, lat, (0, 9), (2, 2, 2, 2), kernel=kernel),
                    lambda: cuda_coarse.coarse_apply_halo(Pk, v, lat, halos, kernel=kernel)):
            assert torch.equal(run(), run())


SMALL = """configuration: none
number of levels: 3
d0 global lattice: 8 8 8 8
d0 test vectors: 8
d0 setup iter: 2
d1 test vectors: 8
d1 setup iter: 1
method: 2
mixed precision: 1
"""


@pytest.mark.gpu
def test_small_solve_runs_through_the_kernels(cuda):
    # the options off explicitly: on a card they default to the JAX rule
    p = config.parse_ini(SMALL + "coarse block bf16: 0\ncoarsest direct: 0\n"
                                 "smoother direct: 0\n")
    U = _unitary_links((8, 8, 8, 8), 4)
    kernels.reset_counts()
    s = api.Solver(p, device=cuda)
    s.set_conf(U)
    s.setup()
    rhs = config.make_rhs("ones", s.lattice)
    x, info = s.solve(rhs)
    assert info.converged and s.true_residual(x, rhs) < 1e-10
    counts = kernels.counts()
    # one rank: K5 (the sharded coarse apply) has no part in the solve
    assert all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4")), counts
    assert all(counts[k] == 0 for k in ("K5", "K4-bf16", "K5-bf16", "K6")), counts


@pytest.mark.gpu
def test_small_solve_with_the_options_runs_through_the_kernels(cuda):
    p = config.parse_ini(SMALL + "coarse block bf16: 1\ncoarsest direct: 1\n"
                                 "smoother direct: 1\n")
    U = _unitary_links((8, 8, 8, 8), 4)
    kernels.reset_counts()
    s = api.Solver(p, device=cuda)
    s.set_conf(U)
    s.setup()
    rhs = config.make_rhs("ones", s.lattice)
    x, info = s.solve(rhs)
    assert info.converged and s.true_residual(x, rhs) < 1e-10
    assert info.coarse_matvec_average == 0 and info.coarsest_inverse_applies > 0
    counts = kernels.counts()
    assert all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4", "K4-bf16", "K6")), counts


@pytest.mark.gpu
def test_small_solve_with_the_cuda_defaults_runs_through_the_kernels(cuda):
    """No option keys: on a card bf16 blocks and the coarsest dense inverse
    (2^4 x 16 = 256 unknowns) are on, direct block solves off."""
    p = config.parse_ini(SMALL)
    U = _unitary_links((8, 8, 8, 8), 4)
    kernels.reset_counts()
    s = api.Solver(p, device=cuda)
    s.set_conf(U)
    s.setup()
    rhs = config.make_rhs("ones", s.lattice)
    x, info = s.solve(rhs)
    assert info.converged and s.true_residual(x, rhs) < 1e-10
    assert {k: v[0] for k, v in info.options.items()} == {
        "coarse_block_bf16": True, "coarsest_direct": True, "smoother_direct": False}
    assert info.inner_restart_cap == 50 and info.inner_tol_clip >= 1e-5
    counts = kernels.counts()
    assert all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4", "K4-bf16", "K6")), counts


def _coarsest_stencil(lat, d, gen, device, bf16=False, hop=0.023, dtype=torch.complex64):
    """A random coarse stencil on the card, made there: self blocks I plus
    complex normal noise (variance 2) of 0.05, hops of `hop` (~10 GCR
    iterations to 5e-2 at 4^4, d = 56); its bf16 view with bf16."""
    V = int(np.prod(lat))
    Pk = _cplx((9, d, d, V), gen, dtype, device) * np.sqrt(2)
    Pk[0] *= 0.05
    Pk[0] += torch.eye(d, dtype=Pk.dtype, device=device)[:, :, None]
    Pk[1:] *= hop
    s = CoarseStencilSoA.from_blocks(Pk, Geometry(lat, (2, 2, 2, 2)))
    return s.compress() if bf16 else s


@pytest.mark.gpu
@pytest.mark.parametrize("lat, batch, bf16, m", [
    ((4, 4, 4, 4), 1, False, 100), ((4, 4, 4, 4), 28, False, 100),
    ((4, 4, 4, 4), 28, False, 8), ((8, 8, 8, 8), 1, True, 100)])
def test_coarsest_graph_matches_the_host_loop(cuda, lat, batch, bf16, m):
    """rough16's coarsest shapes (4^4, d = 56, batch 1 and 28, and m = 8
    for restarts that stop early) and rough32's (8^4 with bf16 blocks): one
    replay gives the host loop's x, counters and K4 / K4-bf16 launches; the
    capture launches nothing, and a second replay on other lanes agrees
    too.  Lane 1 of a batch is zero."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    s = _coarsest_stencil(lat, 56, gen, cuda, bf16)
    key = "K4-bf16" if bf16 else "K4"
    args = (m, 5e-2, 5, True)
    graph = None
    for _ in range(2):
        b = _cplx((batch, *s.field_shape), gen, torch.complex64, cuda)
        if batch > 1:
            b[1] = 0
        kernels.reset_counts()
        x0, c0 = coarsest_gcr(s, b, *args)
        host = kernels.counts()[key]
        if graph is None:
            graph = CoarsestGraph(s, batch, *args)
            assert kernels.counts()[key] == host
        kernels.reset_counts()
        x1, c1 = graph(b)
        assert kernels.counts()[key] == host > 0
        assert torch.equal(c1, c0) and c0[:, 0].max() > 0
        assert torch.equal(x1, x0) or _rel(x1, x0) <= 1e-6


@pytest.mark.gpu
def test_coarsest_graphs_follow_the_hierarchy(cuda, traced):
    """A solve with the options off runs each inner restart as one program
    (its coarsest GCR nested in it, no coarsest graph of its own); after
    shift_update the programs are gone, the next coarsest replay uses the
    shifted stencil and agrees with the host loop; the setup leaves no
    graph behind."""
    p = config.parse_ini(SMALL + "coarse block bf16: 0\ncoarsest direct: 0\n"
                                 "smoother direct: 0\n")
    s = api.Solver(p, device=cuda)
    s.set_conf(_unitary_links((8, 8, 8, 8), 4))
    s.setup()
    mg = s.mg
    lvl = mg._levels()[-1]
    assert not lvl.graphs and not mg.programs and traced.counters["captures"] > 0
    rhs = config.make_rhs("ones", s.lattice)
    x, info = s.solve(rhs)
    assert info.converged and not lvl.graphs
    assert [k[0] for k in mg.programs] == ["InnerRestartGraph"]
    old = lvl.stencil
    s.shift_update(p.m0 + 0.01)
    assert not lvl.graphs and not mg.programs and lvl.stencil is not old
    gen = torch.Generator(device=cuda).manual_seed(6)
    b = _cplx((1, *lvl.stencil.field_shape), gen, torch.complex64, cuda)
    x1, c1 = mg._coarsest_solve(lvl, b)
    assert lvl.graphs[(1, torch.complex64, torch.complex64)].stencil is lvl.stencil
    cfg = mg.cfg
    x0, c0 = coarsest_gcr(lvl.stencil, b, cfg.coarse_iter, cfg.coarse_tol, cfg.coarse_restart,
                          mg._odd_even(lvl))
    assert torch.equal(c1, c0) and (torch.equal(x1, x0) or _rel(x1, x0) <= 1e-6)
    x2, info2 = s.solve(rhs)
    assert info2.converged and s.true_residual(x2, rhs) < 1e-10


# K4-schur: (lattice, d, blocks, batch); rough32's coarsest shape first
SCHUR_CASES = [((8, 8, 8, 8), 56, "bf16", 1), ((8, 8, 8, 8), 56, "bf16", 5),
               ((8, 8, 8, 8), 56, "f32", 1), ((4, 4, 4, 4), 56, "bf16", 1),
               ((4, 4, 4, 4), 56, "f32", 11), ((4, 4, 2, 6), 24, "f64", 3),
               ((2, 2, 2, 2), 20, "f32", 2)]


def _split_stencil(lat, d, kind, gen, device):
    """_coarsest_stencil with blocks of `kind` and its parity-split blocks."""
    dtype = torch.complex128 if kind == "f64" else torch.complex64
    s = _coarsest_stencil(lat, d, gen, device, kind == "bf16", dtype=dtype)
    s.split()
    return s


@pytest.mark.gpu
@pytest.mark.parametrize("lat, d, kind, batch", SCHUR_CASES)
def test_schur_split_kernel_matches_plain_and_the_four_launches(cuda, monkeypatch, lat, d, kind,
                                                                batch):
    """K4-schur against its plain version, and bit for bit against the
    four K4 launches of schur (its hop and self-term sums meet their terms
    in the same order); two K4-schur launches an apply and no K4."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    s = _split_stencil(lat, d, kind, gen, cuda)
    v = _cplx((batch, d, int(np.prod(lat))), gen, s.dtype, cuda)
    kernels.reset_counts()
    got = stencil.schur(s, v)
    counts = kernels.counts()
    assert counts["K4-schur"] == 2 and counts["K4"] == counts["K4-bf16"] == 0
    assert _rel(got, coarse.schur_split_plain(s.E, s.O, v, lat)) < TOL[s.dtype]
    assert not got[..., s.odd > 0].any()
    monkeypatch.setattr(stencil, "SPLIT_SCHUR_DEVICES", ())
    want = stencil.schur(s, v)
    assert kernels.counts()["K4-schur"] == 2
    assert torch.equal(got, want), _rel(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("lat, kind, batch", [((8, 8, 8, 8), "bf16", 1),
                                              ((4, 4, 4, 4), "f32", 3)])
def test_coarsest_graph_on_the_split_path(cuda, monkeypatch, lat, kind, batch):
    """rough32's coarsest GCR (8^4, d = 56, bf16) on K4-schur: one replay
    gives the host loop's x and counters bit for bit and as many K4-schur
    launches (the replays' counted through the graph's loop trips), the
    prologue's and epilogue's four K4 launches beside; both equal the
    four-launch operator's solve."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    s = _split_stencil(lat, 56, kind, gen, cuda)
    key = "K4-bf16" if kind == "bf16" else "K4"
    args = (100, 5e-2, 5, True)
    b = _cplx((batch, *s.field_shape), gen, torch.complex64, cuda)
    kernels.reset_counts()
    x0, c0 = coarsest_gcr(s, b, *args)
    host = kernels.counts()
    assert host[key] == 4 and host["K4-schur"] > 0 and host["K4-schur"] % 2 == 0
    graph = CoarsestGraph(s, batch, *args)
    kernels.reset_counts()
    x1, c1 = graph(b)
    got = kernels.counts()
    assert got[key] == host[key] and got["K4-schur"] == host["K4-schur"]
    assert torch.equal(c1, c0) and torch.equal(x1, x0)
    monkeypatch.setattr(stencil, "SPLIT_SCHUR_DEVICES", ())
    x2, c2 = coarsest_gcr(s, b, *args)
    assert torch.equal(c2, c0) and torch.equal(x2, x0)


def _gcr_state(B, n, dtype, gen, cuda, frozen=False):
    """A GCR state of B lanes: x, r, |r|, go, a stop below |r| (the lanes
    go on), iters, rz = r at B > 1; with `frozen` lanes 1 and 2 are frozen
    (go false, rz zero): lane 1 converged (its stop above its |r|), lane 2
    masked off by active."""
    x, r = _cplx((B, n), gen, dtype, cuda), _cplx((B, n), gen, dtype, cuda)
    rn = torch.linalg.vector_norm(r, dim=-1)
    go = torch.ones(B, dtype=torch.bool, device=cuda)
    stop = rn * 1e-3
    active = None
    if frozen:
        go[1:3] = False
        stop[1] = 2 * rn[1]
        active = torch.ones(B, dtype=torch.bool, device=cuda)
        active[2] = False
    rz = torch.where(go[:, None], r, 0) if B > 1 else None
    return dict(x=x, r=r, rz=rz, go=go, stop=stop, active=active, rn=rn,
                iters=torch.zeros(B, dtype=torch.long, device=cuda))


def _gcr_run(W, Q, j, w, q, state, path=None, plain=False, alias=False):
    """One K7 step (or its plain version) on copies; returns the copies.
    alias: q is the copy's residual input (r at batch 1, else rz), as in a
    GCR without a preconditioner."""
    W, Q = W.clone(), Q.clone()
    st = {k: None if v is None else v.clone() for k, v in state.items()}
    if alias:
        q = st["r"] if st["rz"] is None else st["rz"]
    args = (W, Q, j, w, q, st["x"], st["r"], st["rz"], st["go"], st["stop"], st["active"],
            st["rn"], st["iters"])
    if plain:
        cuda_gcr.gcr_step_plain(*args)
    else:
        cuda_gcr.gcr_step(*args, path=path)
    torch.cuda.synchronize()
    return dict(W=W, Q=Q, **st)


def _check_step(got, want, j, dtype):
    """K7 against its plain version: rows j, x, r, rz within the dtype's
    tolerance, |r| too, iters and go equal, every other row untouched."""
    for k in ("x", "r", "rz"):
        if want[k] is not None and want[k].abs().max() > 0:
            assert _rel(got[k], want[k]) <= TOL[dtype], k
    assert _rel(got["W"][:, j], want["W"][:, j]) <= TOL[dtype]
    assert _rel(got["Q"][:, j], want["Q"][:, j]) <= TOL[dtype]
    assert _rel(got["rn"], want["rn"]) <= TOL[dtype]
    assert torch.equal(got["iters"], want["iters"]) and torch.equal(got["go"], want["go"])
    for key in ("W", "Q"):
        assert torch.equal(got[key][:, :j], want[key][:, :j])
        assert torch.equal(got[key][:, j + 1:], want[key][:, j + 1:])


# chip_smoke.K7_CASES' shapes (n, m, batch) of the paths' GCRs and an odd n
# (single complex64 loads) in complex64; the shapes K7 was tested at as a
# Gram-Schmidt alone, in complex64 and complex128; each on the grid design
# and, where its slices fit, the cluster design
K7_SHAPES = [(786432, 50, 1), (786432, 50, 12), (229376, 5, 1), (229376, 5, 12),
             (14336, 100, 1), (14336, 100, 12), (229376, 100, 1), (229376, 100, 12),
             (2**20 + 3, 7, 2)]
K7_BOTH = [(14336, 100, 1), (14336, 100, 12), (14336, 100, 3), (229376, 5, 3),
           (786432, 50, 1), (2**20 + 3, 7, 2)]
K7_RUNS = sorted({(n, m, B, path, dtype)
                  for shapes, dtypes in ((K7_SHAPES, (torch.complex64,)),
                                         (K7_BOTH, (torch.complex64, torch.complex128)))
                  for n, m, B in shapes for dtype in dtypes
                  for path in ("grid", "cluster") if path == "grid" or n < 2**17},
                 key=str) + [(9999, 7, 3, "cluster", torch.complex64),
                             (14336, 100, 12, None, torch.complex64)]


@pytest.mark.gpu
@pytest.mark.parametrize("n, m, B, path, dtype", K7_RUNS)
def test_gram_schmidt_kernel_matches_plain(cuda, dtype, n, m, B, path):
    """K7 (the whole GCR step) against its plain version at rows j = 0, 1,
    m // 2 and m - 1 of bases whose rows from j + 1 on hold another
    restart's values (K7 reads none of them), lanes that go, a stopped and
    a masked-off lane (B >= 3); two runs give the same bits; a zero w
    keeps scale 1 (zero rows, x and r kept)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    W = _cplx((B, m, n), gen, dtype, cuda) / n ** 0.5
    Q = _cplx((B, m, n), gen, dtype, cuda) / n ** 0.5
    for j in sorted({0, 1, m // 2, m - 1}):
        w, q = _cplx((B, n), gen, dtype, cuda), _cplx((B, n), gen, dtype, cuda)
        state = _gcr_state(B, n, dtype, gen, cuda, frozen=B >= 3)
        if B >= 3:
            w[1:3] = 0                  # frozen lanes enter as zeros
            q[1:3] = 0
        jt = torch.tensor(j, device=cuda)
        got = _gcr_run(W, Q, jt, w, q, state, path)
        _check_step(got, _gcr_run(W, Q, jt, w, q, state, plain=True), j, dtype)
        again = _gcr_run(W, Q, jt, w, q, state, path)
        assert all(a is None or torch.equal(a, b) for a, b in zip(got.values(), again.values()))
        if B >= 3:                      # the frozen lanes keep their bits, rows zero
            for k in ("x", "r", "rn", "iters"):
                assert torch.equal(got[k][1:3], state[k][1:3])
            assert not got["W"][1:3, j].any() and not got["rz"][1:3].any()
        W = got["W"]
        Q = got["Q"]
    zero = torch.zeros((B, n), dtype=dtype, device=cuda)
    state = _gcr_state(B, n, dtype, gen, cuda)
    got = _gcr_run(W, Q, torch.tensor(0, device=cuda), zero, zero, state, path)
    assert not got["W"][:, 0].any() and not got["Q"][:, 0].any()
    assert torch.equal(got["x"], state["x"]) and torch.equal(got["r"], state["r"])


@pytest.mark.gpu
@pytest.mark.parametrize("n, m, B, path, dtype",
                         [(n, 100, B, path, dtype) for n in (14336, 229376) for B in (1, 3)
                          for path in ("cluster", "grid") if path == "grid" or n < 2**17
                          for dtype in (torch.complex64, torch.complex128)])
def test_gcr_step_with_q_aliasing_the_residual(cuda, n, m, B, path, dtype):
    """The coarsest GCR has no preconditioner: its q is r itself (batch 1)
    or rz (batch > 1), which K7 reads and writes in the same launch.  Each
    design reads q before it writes r or rz (module note of csrc/gcr.cu);
    the step agrees with the plain version on the same aliased state, a
    stopped and a masked-off lane (B = 3) keep their bits."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    W = _cplx((B, m, n), gen, dtype, cuda) / n ** 0.5
    Q = _cplx((B, m, n), gen, dtype, cuda) / n ** 0.5
    for j in (0, 1, m // 2, m - 1):
        w = _cplx((B, n), gen, dtype, cuda)
        state = _gcr_state(B, n, dtype, gen, cuda, frozen=B >= 3)
        if B >= 3:
            w[1:3] = 0                  # A rz of the frozen lanes
        jt = torch.tensor(j, device=cuda)
        got = _gcr_run(W, Q, jt, w, None, state, path, alias=True)
        _check_step(got, _gcr_run(W, Q, jt, w, None, state, plain=True, alias=True), j, dtype)
        if B >= 3:
            for k in ("x", "r", "rn", "iters"):
                assert torch.equal(got[k][1:3], state[k][1:3])
        W, Q = got["W"], got["Q"]


@pytest.mark.gpu
def test_gcr_step_launches_and_captures(cuda):
    """One K7 launch a step on either design (the counters), and a K7 step
    inside a captured WHILE loop (csrc/graph.cu) gives the host loop's
    bits, cluster and grid designs."""
    from ddalphaamg_tpu_torch.solvers.cuda_graph import GraphProgram
    from ddalphaamg_tpu_torch.solvers.device_gmres import HostControl, gcr_program

    gen = torch.Generator(device=cuda).manual_seed(9)
    for n, B in ((14336, 1), (14336, 3), (229376, 1), (229376, 3)):
        A = _cplx((n // 64, 64, 64), gen, torch.complex64, cuda) / 64 + torch.eye(
            64, dtype=torch.complex64, device=cuda)

        def apply_op(v):                # a block-diagonal operator on [B, n]
            return torch.einsum("kij,bkj->bki", A, v.reshape(v.shape[0], -1, 64)).reshape(
                v.shape)

        b = _cplx((B, n), gen, torch.complex64, cuda)
        kernels.reset_counts()
        want = gcr_program(HostControl(), apply_op, b, 20, 1e-6)
        assert kernels.counts()["K7"] == int(want[1].max())
        g = GraphProgram(lambda ctl, b: dict(zip("xir", gcr_program(ctl, apply_op, b, 20,
                                                                    1e-6)[:3])),
                         {"b": b.clone()}, cuda)
        got = g(b=b)
        assert all(torch.equal(got[k], v) for k, v in zip("xir", want[:3]))
        g.close()


@pytest.mark.gpu
@pytest.mark.parametrize("options", [False, True], ids=["options off", "options on"])
def test_inner_restart_and_cycle_replays_match_the_host_loops(cuda, options, monkeypatch):
    """One replay of the inner restart (batch 1 and 3, a zero lane) and of
    the cycle gives the host loops' bits, counters and launches."""
    on = "1" if options else "0"
    p = config.parse_ini(SMALL + f"coarse block bf16: {on}\ncoarsest direct: {on}\n"
                                 f"smoother direct: {on}\n")
    s = api.Solver(p, device=cuda)
    s.set_conf(_unitary_links((8, 8, 8, 8), 4))
    s.setup()
    mg = s.mg
    mg._ensure_inverses()           # built at the first solve, outside what is compared
    gen = torch.Generator(device=cuda).manual_seed(8)
    for B in (1, 3):
        r = _cplx((B, 12, 8**4), gen, torch.complex64, cuda)
        if B > 1:
            r[1] = 0
        tol = torch.full((B,), 1e-5, dtype=torch.float64, device=cuda)
        for run in (lambda: mg.inner_restart(r, tol, m=20), lambda: (mg(r),)):
            outs = []
            for devices in ((), ("cuda",), ("cuda",)):        # host loops, capture, replay
                monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", devices)
                before = dict(mg.stats)
                kernels.reset_counts()
                out = run()
                counts = kernels.counts()
                outs.append((out, counts, [mg.stats[k] - before[k] for k in before]))
            (host, hc, hs), _, (got, gc, gs) = outs
            assert all(torch.equal(a, b) for a, b in zip(got, host)) and gs == hs
            assert gc.pop("G") == 1 and hc.pop("G") == 0 and gc == hc
            assert hc["K7"] > 0 and hc["K1"] > 0
