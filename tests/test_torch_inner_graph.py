"""The inner restart and the cycle as device programs (mg/programs.py,
solvers/cuda_graph.py, K7 in operators/cuda_gcr.py) on the CPU, where the
programs' control flow runs on the host (HostControl, the plain version)
or through a stand-in capture (tests/torch_graph_stub.StubGraph: every loop
body recorded once, host reads refused, replayed on the host):

  (a) ctl.loop under HostControl and under the stand-in capture gives the
      host loop's (device_gcr's) bits for the fine, the K-cycle and the
      coarsest GCR, at two and three levels, batch 1 and batch 2 with a
      zero lane;
  (b) the Gram-Schmidt of K7's plain version against the JAX package's
      masked einsum Gram-Schmidt (device_gmres.py:111-119) on numpy
      inputs from a seed, j = 0, 1 and m - 1, complex64 (1e-6) and
      complex128 (1e-13), rows of an earlier restart above j ignored;
  (c) the inner-restart program against the JAX Multigrid's
      _inner_restart_impl on the same hierarchy (the same field and
      injected test vectors): equal iterations and counters, z within 1e-9
      (complex128, as tests/test_torch_mg.py holds the cycle); a whole
      Solver.solve and a two-lane solve_multi through the stand-in replays
      against the JAX package's restart loop: equal outer iterations, true
      residuals below 1e-10, x within 1e-8 of the JAX package's;
  (d) launch accounting: a stand-in replay gives the host loop's counts of
      K1-K4, K6 and K7 (the wrappers counted as on a card), options off
      and on;
  (e) re_setup, set_conf, shift_update and slim_for_solve drop the
      programs, a replaced stencil is caught by identity, one program of a
      kind is kept, and no program is made on the CPU (unpatched) or for a
      level sharded over gloo.
Sizes: 4^4 -> 2^4 (-> 1^4), d = 8, a few seconds a case.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from torch_graph_stub import StubGraph
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import cplx
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu.mg.hierarchy import Multigrid as JMultigrid
from ddalphaamg_tpu_torch import api, config, kernels
from ddalphaamg_tpu_torch.mg import hierarchy
from ddalphaamg_tpu_torch.mg.coarsest import coarsest_gcr
from ddalphaamg_tpu_torch.mg.hierarchy import MGConfig, Multigrid
from ddalphaamg_tpu_torch.mg.programs import CycleGraph, InnerRestartGraph
from ddalphaamg_tpu_torch.operators import cuda_coarse, cuda_dense, cuda_dslash, cuda_gcr, fast
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.parallel import comm
from ddalphaamg_tpu_torch.solvers.cuda_graph import GraphProgram
from ddalphaamg_tpu_torch.solvers.device_gmres import HostControl, device_gcr, gcr_program

torch.set_num_threads(1)

LATS = {2: ((4, 4, 4, 4), (2, 2, 2, 2)), 3: ((4, 4, 4, 4), (2, 2, 2, 2), (1, 1, 1, 1))}
BLOCKS = ((2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1))
N_TV = 4        # d = 8 on the coarse levels


def _multigrid(levels, dtype=torch.complex64, **options):
    """A Multigrid on 4^4 with injected test vectors (no bootstrap)."""
    lats = LATS[levels]
    op = WilsonOperator.from_gauge(torch.as_tensor(rough_field(lats[0], seed=6)), -0.5, 1.0)
    mg = Multigrid(op, MGConfig(levels=ranks.level_configs(lats, BLOCKS, N_TV), dtype=dtype,
                                seed=1, **options))
    mg.set_test_vectors(random_spinor((N_TV, *lats[0], 4, 3), seed=7))
    if levels == 3:
        mg.set_test_vectors(random_spinor((N_TV, *lats[1], 2 * N_TV), seed=8), depth=1)
    return mg


def _lanes(shape, B, seed, dtype, zero=None):
    v = torch.as_tensor(random_spinor((B, *shape), seed)).to(dtype)
    if zero is not None:
        v[zero] = 0
    return v


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def graphs(monkeypatch):
    """Device programs on the CPU through the stand-in capture."""
    monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(hierarchy, "GRAPH_CAPTURE", StubGraph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    StubGraph.captures = 0
    return StubGraph


def _stub_program(program, **inputs):
    """program(ctl, **inputs) captured by the stand-in and replayed once."""
    g = GraphProgram(program, {k: v.clone() for k, v in inputs.items()}, "cpu",
                     capture=StubGraph)
    return g(**inputs)


# ---------------------------------------------------------------------------
# (a) bit for bit against the host loop
# ---------------------------------------------------------------------------

LANES = {"batch 1": (1, None), "batch 2, zero lane": (2, 1)}


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("levels", [2, 3])
def test_inner_restart_program_gives_the_host_loops_bits(graphs, levels, lanes):
    B, zero = LANES[lanes]
    mg = _multigrid(levels)
    s = mg.fine.stencil
    r = _lanes(s.field_shape, B, 11, s.dtype, zero)
    ktol = mg._kcycle_tol(0, mg.cfg.kcycle_tol)
    kw = dict(m=12, tol=1e-3)
    want = device_gcr(s.full_op, r, prec=lambda w: mg._cycle(0, w, ktol), **kw)
    z, it, counters = mg.inner_program(HostControl(), r, 1e-3, 12)
    assert _equal((z, it, counters), (want[0], want[1], want[3]))
    before = dict(mg.stats)
    z1, it1 = mg.inner_restart(r, 1e-3, m=12)          # one stand-in replay
    assert _equal((z1, it1), (want[0], want[1])) and list(mg.programs) == [
        ("InnerRestartGraph", B, 12, s.dtype)]
    total = want[3].sum(dim=0).tolist()
    assert [mg.stats[k] - before[k] for k in before] == total and total[0] > 0
    assert it.max() > 1 and (zero is None or (it[zero] == 0 and not z[zero].any()))


@pytest.mark.parametrize("lanes", LANES)
def test_kcycle_and_coarsest_programs_give_the_host_loops_bits(lanes):
    B, zero = LANES[lanes]
    mg = _multigrid(3)
    cfg = mg.cfg
    mid = mg._levels()[1]
    ns = mg._cycle_view(mid)
    b = _lanes(ns.field_shape, B, 12, ns.dtype, zero)
    ktol = 1e-4            # tight enough for both restarts to iterate

    def kprec(v):
        return mg._cycle(1, v, ktol)

    kargs = (cfg.kcycle_length, ktol)
    kw = dict(n_restarts=cfg.kcycle_restarts, prec=kprec)
    want = device_gcr(ns.full_op, b, *kargs, **kw)
    assert _equal(gcr_program(HostControl(), ns.full_op, b, *kargs, n_aux=3, **kw), want)
    got = _stub_program(lambda ctl, b: dict(zip("xirc", gcr_program(
        ctl, ns.full_op, b, *kargs, n_restarts=cfg.kcycle_restarts,
        prec=lambda v: mg._cycle(1, v, ktol, ctl=ctl), n_aux=3))), b=b)
    assert _equal(got.values(), want) and want[1].max() > 1

    mg2 = _multigrid(2)                 # a coarsest 2^4 level: the Schur GCR iterates
    low = mg2._levels()[-1]
    cs = mg2._cycle_view(low)
    bc = _lanes(cs.field_shape, B, 13, cs.dtype, zero)
    cargs = (cfg.coarse_iter, 1e-4, cfg.coarse_restart, mg2._odd_even(low))
    want = coarsest_gcr(cs, bc, *cargs)
    got = _stub_program(lambda ctl, b: dict(zip("xc", coarsest_gcr(
        cs, b, *cargs, gcr=functools.partial(gcr_program, ctl)))), b=bc)
    assert _equal(got.values(), want) and want[1][:, 0].max() > 1


def test_cycle_program_gives_the_host_cycles_bits(graphs):
    mg = _multigrid(3)
    s = mg.fine.stencil
    eta = _lanes(s.field_shape, 2, 14, s.dtype, zero=0)
    want = mg._cycle(0, eta, mg._kcycle_tol(0, mg.cfg.kcycle_tol))
    before = dict(mg.stats)
    got = mg(eta)                       # Multigrid.__call__: one stand-in replay
    assert torch.equal(got, want[0]) and list(mg.programs) == [
        ("CycleGraph", 2, 0, s.dtype)]
    assert [mg.stats[k] - before[k] for k in before] == want[1].sum(dim=0).tolist()


# ---------------------------------------------------------------------------
# (b) K7's plain version against the JAX package's Gram-Schmidt
# ---------------------------------------------------------------------------

def _jax_gram_schmidt(W, Q, w, q, j):
    """The JAX package's device_gcr body (device_gmres.py:111-119) on one
    lane: the einsums over all m rows of bases whose rows from j on are
    zero, the normalization, rows j written."""
    wf, qf = cplx.as_carray(w), cplx.as_carray(q)
    Wc, Qc = cplx.as_carray(W), cplx.as_carray(Q)
    h = cplx.einsum("in,n->i", cplx.conj(Wc), wf, karatsuba=False, precision="highest")
    wf = wf - cplx.einsum("i,in->n", h, Wc, karatsuba=False, precision="highest")
    qf = qf - cplx.einsum("i,in->n", h, Qc, karatsuba=False, precision="highest")
    wn2 = cplx.norm2(wf)
    inv = jax.lax.rsqrt(jnp.where(wn2 == 0, 1.0, wn2))
    wf, qf = wf * inv, qf * inv
    return (np.asarray(wf.re) + 1j * np.asarray(wf.im),
            np.asarray(qf.re) + 1j * np.asarray(qf.im))


@pytest.mark.parametrize("j", [0, 1, 7])
@pytest.mark.parametrize("dtype, tol", [(np.complex64, 1e-6), (np.complex128, 1e-13)],
                         ids=["complex64", "complex128"])
def test_k7_plain_matches_the_jax_gram_schmidt(dtype, tol, j):
    B, m, n = 2, 8, 96
    rng = np.random.default_rng(40 + j)

    def c(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)

    W, Q, w, q = c(B, m, n), c(B, m, n), c(B, n), c(B, n)
    W[:, j:] = Q[:, j:] = 0                 # the JAX bases start zero
    tW, tQ = torch.tensor(W), torch.tensor(Q)
    tW[:, j + 1:] = 5.0                     # rows of an earlier restart: ignored
    tQ[:, j + 1:] = -3.0
    wo, qo = cuda_gcr.orthonormalize_plain(tW, tQ, torch.tensor(j), torch.as_tensor(w),
                                           torch.as_tensor(q))
    for b in range(B):
        ww, wq = _jax_gram_schmidt(W[b], Q[b], w[b], q[b], j)
        assert rel_err(wo[b].numpy(), ww) < tol and rel_err(qo[b].numpy(), wq) < tol
        assert torch.equal(tW[b, j], wo[b]) and torch.equal(tQ[b, j], qo[b])
        assert torch.equal(tW[b, :j], torch.as_tensor(W[b, :j]))


# ---------------------------------------------------------------------------
# (c) against the JAX package
# ---------------------------------------------------------------------------

INI = """configuration: none
number of levels: 2
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
d0 test vectors: 4
d0 setup iter: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 30
maximum of restarts: 20
method: 2
mixed precision: 0
"""
LAT = (4, 4, 4, 4)


@pytest.fixture(scope="module")
def pair():
    """The JAX package's Solver and the port's on the same field and
    injected test vectors (complex128 levels, no bootstrap)."""
    U = rough_field(LAT, seed=21)
    tv = random_spinor((N_TV, *LAT, 4, 3), seed=22)
    js = japi.Solver(jconfig.parse_ini(INI))
    js.set_conf(U, links_have_bc=True)
    js.mg = js.preconditioner = JMultigrid(js.op, js._mg_config())
    js.mg.set_test_vectors(tv)
    p = config.parse_ini(INI)
    p.inner_tol_clip = 1e-7       # the clip of _solve_mp_device
    s = api.Solver(p, device="cpu")
    s.set_conf(U, links_have_bc=True)
    s.build_hierarchy().set_test_vectors(tv)
    return js, s


def test_inner_restart_program_matches_jax(graphs, pair):
    js, s = pair
    r = random_spinor((*LAT, 4, 3), seed=23)
    jz, jit, jc = js.mg.inner_restart(jnp.asarray(r), 1e-6, m=20)
    before = dict(s.mg.stats)
    z, it = s.mg.inner_restart(fast.spinor_to_soa(torch.as_tensor(r))[None], 1e-6, m=20)
    assert graphs.captures == 1 and int(it[0]) == int(jit) > 2
    assert rel_err(fast.spinor_from_soa(z[0], LAT).numpy(), np.asarray(jz)) < 1e-9
    assert [s.mg.stats[k] - before[k] for k in before] == np.asarray(jc).tolist()


def test_solve_and_solve_multi_through_the_programs_match_jax(graphs, pair):
    js, s = pair
    rhs = np.stack([np.ones((*LAT, 4, 3), np.complex128),
                    random_spinor((*LAT, 4, 3), seed=24)])
    jres = [js._solve_mp_device(b, 1e-10) for b in rhs]
    x, info = s.solve(rhs[0])
    xs, infos = s.solve_multi(rhs)
    assert s.mg.programs and all(key[0] == "InnerRestartGraph" for key in s.mg.programs)
    for lane, xi, inf in ((0, x, info), (0, xs[0], infos[0]), (1, xs[1], infos[1])):
        want = jres[lane]
        assert inf.converged and want.converged and inf.iterations == want.iterations
        assert s.true_residual(xi, rhs[lane]) < 1e-10
        assert rel_err(xi, np.asarray(want.x)) < 1e-8


# ---------------------------------------------------------------------------
# (d) launch accounting
# ---------------------------------------------------------------------------

@pytest.fixture
def counting(monkeypatch):
    """The kernel wrappers count their launches on the CPU as on a card."""
    def count(fn, key_of):
        def wrapped(*args, **kwargs):
            key = key_of(*args)
            if key:
                kernels.launched(key)
            return fn(*args, **kwargs)
        return wrapped

    for mod, name, key_of in (
            (cuda_dslash, "d_plus_clover", lambda *a: "K1"),
            (cuda_dslash, "hopping", lambda *a: "K2"),
            (cuda_dslash, "clover", lambda *a: "K3"),
            (cuda_coarse, "coarse_apply",
             lambda blocks, *a: "K4-bf16" if blocks.dtype == torch.bfloat16 else "K4"),
            (cuda_dense, "matvec", lambda A, *a: "K6" if A.dtype == torch.bfloat16 else None),
            (cuda_gcr, "gcr_step", lambda *a: "K7")):
        monkeypatch.setattr(mod, name, count(getattr(mod, name), key_of))


@pytest.mark.parametrize("options", [False, True], ids=["options off", "options on"])
def test_replay_launch_counts_equal_the_host_loops(graphs, counting, monkeypatch, options):
    opts = dict(coarse_block_bf16=options, coarsest_direct=options, smoother_direct=options)
    mg = _multigrid(3, **opts)
    s = mg.fine.stencil
    r = _lanes(s.field_shape, 2, 15, s.dtype, zero=1)
    mg._ensure_inverses()
    kernels.reset_counts()
    want = mg.inner_program(HostControl(), r, 1e-3, 10)
    host = kernels.counts()
    kernels.reset_counts()
    z, it = mg.inner_restart(r, 1e-3, m=10)
    got = kernels.counts()
    assert _equal((z, it), want[:2]) and got["G"] == 1
    keys = ("K1", "K2", "K3", "K4-bf16", "K6", "K7") if options else ("K1", "K2", "K3", "K4",
                                                                      "K7")
    assert all(host[k] > 0 for k in keys)
    assert {k: got[k] for k in kernels.KERNELS if k != "G"} == {
        k: host[k] for k in kernels.KERNELS if k != "G"}
    kernels.reset_counts()


# ---------------------------------------------------------------------------
# (e) the programs follow the hierarchy
# ---------------------------------------------------------------------------

def test_programs_are_dropped_with_what_they_captured(graphs):
    s = api.Solver(config.parse_ini(INI), device="cpu")
    s.set_conf(rough_field(LAT, seed=21), links_have_bc=True)
    mg = s.build_hierarchy()
    mg.set_test_vectors(random_spinor((N_TV, *LAT, 4, 3), seed=22))
    rt = torch.as_tensor(random_spinor((1, 12, 256), seed=25))

    def replay():
        mg.inner_restart(rt, 1e-3, m=8)
        mg(rt)
        assert {k[0] for k in mg.programs} == {"InnerRestartGraph", "CycleGraph"}

    replay()
    captures = graphs.captures
    replay()
    assert graphs.captures == captures              # reused
    for drop in (lambda: mg.re_setup(mg.fine),
                 lambda: s.set_conf(rough_field(LAT, seed=21), links_have_bc=True),
                 lambda: s.shift_update(s.p.m0 + 0.01)):
        drop()
        assert not mg.programs
        replay()
    # a stencil replaced behind the cache's back is caught by identity
    lvl = mg._levels()[-1]
    lvl.stencil = dataclasses.replace(lvl.stencil)
    mg.inner_restart(rt, 1e-3, m=8)
    assert list(mg.programs) == [("InnerRestartGraph", 1, 8, torch.complex128)]
    assert any(h is lvl.stencil for h in mg.programs[("InnerRestartGraph", 1, 8,
                                                      torch.complex128)].holds)
    # another fine operator (compat's scaled one) replaces that program only
    mg(rt)
    cycle = mg.programs[("CycleGraph", 1, 0, torch.complex128)]
    other = dataclasses.replace(mg.fine.stencil)
    mg.inner_restart(rt, 1e-3, m=8, op=other.full_op)
    assert mg.programs[("InnerRestartGraph", 1, 8, torch.complex128)].op is other
    assert mg.programs[("CycleGraph", 1, 0, torch.complex128)] is cycle
    # one program of a kind: another batch replaces it
    mg.inner_restart(torch.cat([rt, rt]), 1e-3, m=8)
    assert sorted(mg.programs) == [("CycleGraph", 1, 0, torch.complex128),
                                   ("InnerRestartGraph", 2, 8, torch.complex128)]


def test_slim_for_solve_drops_them_and_no_program_without_a_card_or_on_a_mesh(monkeypatch):
    mg = _multigrid(2, coarse_block_bf16=True)
    r = _lanes(mg.fine.stencil.field_shape, 1, 16, torch.complex64)
    mg.inner_restart(r, 1e-3, m=6)
    mg(r)
    assert not mg.programs                          # GRAPH_DEVICES: cuda only
    monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(hierarchy, "GRAPH_CAPTURE", StubGraph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    mg.inner_restart(r, 1e-3, m=6)
    mg(r)
    assert set(mg.programs) == {("InnerRestartGraph", 1, 6, torch.complex64),
                                ("CycleGraph", 1, 0, torch.complex64)}
    assert isinstance(mg.programs[("CycleGraph", 1, 0, torch.complex64)], CycleGraph)
    mg.slim_for_solve()
    assert not mg.programs
    mg.inner_restart(r, 1e-3, m=6)
    assert isinstance(mg.programs[("InnerRestartGraph", 1, 6, torch.complex64)],
                      InnerRestartGraph)
    mg.drop_graphs()
    assert not mg.programs
    # a grid: a fine level sharded over gloo keeps the host loops, over a
    # transport whose collectives a capture holds (comm.CAPTURED_TRANSPORTS)
    # it runs the programs; the replicated coarsest level runs its graph
    # on either
    fine = mg.fine.stencil
    for transport in ("gloo", "nccl"):
        monkeypatch.setattr(fine, "mesh", types.SimpleNamespace(
            comm=types.SimpleNamespace(transport=transport)))
        assert mg.uses_graphs(r) is (transport in comm.CAPTURED_TRANSPORTS)
        assert mg.uses_graphs(r, mg._levels()[-1])
