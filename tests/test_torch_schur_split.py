"""The coarsest level's Schur complement on parity-split blocks (K4-schur,
csrc/coarse.cu) on the CPU: its plain version against the four-apply
schur, the split blocks as an exact gather of the packed blocks, the
coarsest GCR through it, and the split copy kept in step with every path
that rewrites the blocks (refresh, a setup's in-place re_setup,
shift_stencil).  The kernel itself is held to the plain version and to the
four K4 launches bit for bit in tests/test_torch_kernels.py (on a card)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_graph_stub import StubGraph
from torch_parity import random_spinor, rough_field

from ddalphaamg_tpu_torch import convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg import coarsest, hierarchy
from ddalphaamg_tpu_torch.mg.hierarchy import LevelConfig, MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators import coarse, fast, stencil
from ddalphaamg_tpu_torch.operators.stencil import CoarseStencilSoA, schur, shift_stencil
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator

torch.set_num_threads(1)

D = 8


def _gamma5_stencil(lat, seed, dtype=torch.complex128, d=D):
    """A random gamma5-compatible coarse stencil: A = 4 + 0.3 g5 H (H
    Hermitian), Df_mu of 0.2, Db_mu(x + mu) = g5 Df_mu(x)^H g5, so that
    D^H = g5 D g5 with g5 = diag(-1_N, +1_N)."""
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    g5 = np.diag([-1.0] * (d // 2) + [1.0] * (d // 2))
    H = c(*lat, d, d)
    A = 4 * np.eye(d) + 0.3 * g5 @ (H + np.swapaxes(H, -1, -2).conj())
    Df = 0.2 * c(4, *lat, d, d)
    Db = np.stack([np.roll(g5 @ np.swapaxes(Df[mu], -1, -2).conj() @ g5, 1, axis=mu)
                   for mu in range(4)])
    cop = convert.coarse_operator(A, Df, Db)
    return CoarseStencilSoA.build(cop, Geometry(lat, (2, 2, 2, 2)), dtype=dtype)


def _split(s):
    s.split()
    return s


def _fresh(s):
    """The split of the stencil's blocks as they are now."""
    return coarse.split_blocks(s.Pk, s.Pk_inv, s.lattice)


def _equal_split(s):
    return all(torch.equal(a, b) for a, b in zip((s.E, s.O), _fresh(s)))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("lat", [(4, 4, 4, 4), (4, 4, 4, 8)])
def test_split_plain_matches_schur(lat, batch):
    s = _split(_gamma5_stencil(lat, seed=1))
    g5 = torch.tensor([-1.0] * (D // 2) + [1.0] * (D // 2), dtype=s.dtype)[:, None]
    v = torch.as_tensor(random_spinor((batch, D, s.geom.num_sites), seed=2))
    u = torch.as_tensor(random_spinor((batch, D, s.geom.num_sites), seed=3))
    # gamma5-Hermitian: <u, D v> = <g5 D g5 u, v>
    assert torch.allclose(torch.vdot(u.flatten(), s.full_op(v).flatten()),
                          torch.vdot((g5 * s.full_op(g5 * u)).flatten(), v.flatten()), rtol=1e-13)
    want = schur(s, v)
    got = coarse.schur_split_plain(s.E, s.O, v, lat)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-13
    assert not got[..., s.odd > 0].any()


@pytest.mark.parametrize("kind", ["complex64", "complex128", "bf16"])
def test_split_blocks_are_an_exact_gather(kind):
    lat = (4, 4, 2, 6)
    s = _gamma5_stencil(lat, seed=3, dtype=torch.complex128 if kind == "complex128"
                        else torch.complex64)
    if kind == "bf16":
        full = _split(_gamma5_stencil(lat, seed=3, dtype=torch.complex64))
        s = full.compress()
        # the bf16 view's split is the rounded split of the full-precision blocks
        assert torch.equal(s.E, coarse.compress(full.E)) and torch.equal(s.O, coarse.compress(full.O))
    else:
        s = _split(s)
    even, odd = (fast.parity_sites(lat, p, 0, s.Pk.device) for p in (0, 1))
    for h in (0, 1, 17, len(even) - 1):
        assert torch.equal(s.E[:, :, :, h], s.Pk[:, :, :, even[h]])
        assert torch.equal(s.O[0, :, :, h], s.Pk_inv[0, :, :, odd[h]])
        assert torch.equal(s.O[1:, :, :, h], s.Pk[1:, :, :, odd[h]])
    assert s.E.dtype == s.O.dtype == s.Pk.dtype and s.E.shape[3] == s.geom.num_sites // 2


@pytest.mark.parametrize("B", [1, 3])
def test_coarsest_gcr_on_the_split_path_gives_the_old_paths_x_and_counters(monkeypatch, B):
    s = _split(_gamma5_stencil((4, 4, 4, 4), seed=4))
    b = torch.as_tensor(random_spinor((B, D, s.geom.num_sites), seed=5))
    args = (10, 1e-6, 4, True)
    want = coarsest.coarsest_gcr(s, b, *args)
    monkeypatch.setattr(stencil, "SPLIT_SCHUR_DEVICES", ("cuda", "cpu"))
    calls = []
    real = coarse.schur_split_plain
    monkeypatch.setattr(stencil.cuda_coarse, "schur_split_plain",
                        lambda *a: calls.append(1) or real(*a))
    got = coarsest.coarsest_gcr(s, b, *args)
    assert calls and torch.equal(got[1], want[1]) and want[1][:, 0].min() > 10
    assert float((got[0] - want[0]).abs().max() / want[0].abs().max()) < 1e-12


def test_schur_keeps_four_applies_above_the_batch1_crossover(monkeypatch):
    """At a batch where K4's launcher takes its multi-right-hand-side kernel
    (12 at 4^4: cuda_coarse.batch1_regime) schur keeps the four applies."""
    s = _split(_gamma5_stencil((2, 2, 2, 2), seed=6))
    monkeypatch.setattr(stencil, "SPLIT_SCHUR_DEVICES", ("cuda", "cpu"))
    calls = []
    monkeypatch.setattr(stencil.cuda_coarse, "schur_split",
                        lambda *a: calls.append(1) or coarse.schur_split_plain(*a))
    for B, split in ((11, True), (12, False)):
        calls.clear()
        schur(s, torch.as_tensor(random_spinor((B, D, 16), seed=B)))
        assert bool(calls) == split


@pytest.mark.parametrize("bf16", [False, True], ids=["complex64", "bf16 view"])
def test_split_blocks_follow_refresh_in_place(bf16):
    s = _gamma5_stencil((4, 4, 4, 4), seed=7, dtype=torch.complex64)
    view = _split(s.compress()) if bf16 else None
    if not bf16:
        s.split()
    target = view if bf16 else s
    ptrs = (target.E.data_ptr(), target.O.data_ptr())
    s.Pk.mul_(1.1).add_(0.01)
    s.refresh(view)
    assert (target.E.data_ptr(), target.O.data_ptr()) == ptrs
    assert _equal_split(target)


def test_split_blocks_follow_shift_stencil():
    s = _split(_gamma5_stencil((4, 4, 4, 4), seed=8, dtype=torch.complex64))
    E0 = s.E.clone()
    t = shift_stencil(s, 0.25)
    assert _equal_split(t) and not torch.equal(t.E, E0) and torch.equal(s.E, E0)
    assert shift_stencil(dataclasses.replace(s, E=None, O=None), 0.25).E is None


def _multigrid(bf16=False, **options):
    """A two-level complex64 Multigrid on 4^4 (coarsest 2^4, d = 8) with
    injected test vectors."""
    lats = ((4, 4, 4, 4), (2, 2, 2, 2))
    n = 4
    op = WilsonOperator.from_gauge(torch.as_tensor(rough_field(lats[0], seed=6)), -0.5, 1.0)
    levels = [LevelConfig(lattice=lat, block=blk, num_test_vectors=n, setup_iter=1)
              for lat, blk in zip(lats, ((2, 2, 2, 2), (1, 1, 1, 1)))]
    mg = Multigrid(op, MGConfig(levels=levels, dtype=torch.complex64, seed=1,
                                coarse_block_bf16=bf16, **options))
    mg.set_test_vectors(random_spinor((n, *lats[0], 4, 3), seed=7))
    return mg, op


@pytest.mark.parametrize("bf16", [False, True], ids=["complex64", "bf16 view"])
def test_split_blocks_follow_a_setup_in_place_and_shift_update(monkeypatch, bf16):
    """The coarsest view gets its split blocks; a setup whose sweeps run as
    (stand-in) device programs rewrites them in place (re_setup, the path
    of update_setup), shift_update gives the new view fresh ones."""
    monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(hierarchy, "GRAPH_CAPTURE", StubGraph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    mg, op = _multigrid(bf16)
    lvl = mg._levels()[-1]
    view = mg._cycle_view(lvl)
    assert view.E is not None and _equal_split(view)
    assert (view is lvl.stencil) != bf16 and mg.fine.stencil is mg._cycle_view(mg.fine)
    ptrs = (view.E.data_ptr(), view.O.data_ptr())
    E0 = view.E.clone()
    mg.bootstrap_setup(1)
    assert mg._cycle_view(lvl) is view and (view.E.data_ptr(), view.O.data_ptr()) == ptrs
    assert _equal_split(view) and not torch.equal(view.E, E0)
    mg.shift_update(0.1, op)
    new = mg._cycle_view(lvl)
    assert new is not view and new.E is not None and _equal_split(new)


def test_no_split_blocks_where_the_schur_gcr_does_not_run(monkeypatch):
    """None with the coarsest dense inverse, without odd-even, or on a
    sharded coarsest level."""
    for options in ({"coarsest_direct": True}, {"odd_even": False}):
        mg, _ = _multigrid(**options)
        assert mg._cycle_view(mg._levels()[-1]).E is None
    mg, _ = _multigrid()
    lvl = mg._levels()[-1]
    monkeypatch.setattr(lvl.stencil, "mesh", object())
    assert mg._cycle_view(lvl).E is None
