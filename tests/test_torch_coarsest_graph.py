"""The coarsest GCR as a device program (mg/coarsest.py, solvers/cuda_graph.py)
on the CPU, where the graph's control flow runs on the host (HostControl,
its plain version) and a stand-in replaces the CUDA capture:

  (a) gcr_program, the GCR a graph captures, through the stand-in capture
      gives the host loop's (device_gcr's) x, iterations and residuals bit
      for bit, alone and inside coarsest_gcr (Schur and full-operator
      branches): batch 1 and 3, per-lane tolerances, an active mask, a zero
      lane, 1 and 5 restarts;
  (b) against the JAX package's device_gcr, vmapped over the lanes, on the
      Schur operator of a small coarsest level (complex64): equal
      iterations, x within 1e-5 relative;
  (c) the passes of a restart's iteration loop are the largest lane count
      of that restart, and the launches a graph accounts from its
      recording and its loops' trips are a counting stencil's launches in
      the host loop;
  (d) the Multigrid keeps one graph per (level, batch, dtype, view), reuses
      it, drops it after re_setup, shift_update, a setup and a new Solver
      setup, and never uses one on a level sharded over gloo or, unpatched,
      on the CPU (a replicated level of a grid uses one).
The CUDA capture itself is held to the host loop on a card in
tests/test_torch_kernels.py (marked gpu).
"""

import dataclasses
import functools
import types
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_graph_stub import StubGraph, traced  # noqa: F401 (a fixture)
from torch_parity import random_spinor, rough_field, to_numpy

from ddalphaamg_tpu import cplx
from ddalphaamg_tpu.geometry import Geometry as JGeometry
from ddalphaamg_tpu.operators import coarse as jcoarse
from ddalphaamg_tpu.operators import stencil as jstencil
from ddalphaamg_tpu.solvers.device_gmres import device_gcr as jax_device_gcr
from ddalphaamg_tpu_torch import api, config, convert, kernels
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg import coarsest, hierarchy
from ddalphaamg_tpu_torch.mg.hierarchy import LevelConfig, MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators.stencil import CoarseStencilSoA, schur
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.solvers.cuda_graph import GraphProgram
from ddalphaamg_tpu_torch.solvers.device_gmres import HostControl, device_gcr, gcr_program

torch.set_num_threads(1)

LAT, D = (4, 4, 4, 4), 8


def _blocks(seed, hop=0.12):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    return c(*LAT, D, D) * 0.1 + np.eye(D), hop * c(4, *LAT, D, D), hop * c(4, *LAT, D, D)


def _stencil(seed=1, cls=CoarseStencilSoA):
    s = CoarseStencilSoA.build(convert.coarse_operator(*_blocks(seed)), Geometry(LAT, (2, 2, 2, 2)),
                               dtype=torch.complex64)
    return cls(**{f.name: getattr(s, f.name) for f in dataclasses.fields(s)})


def _lanes(B, seed):
    return torch.as_tensor(random_spinor((B, D, 256), seed).astype(np.complex64))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


def _stub_program(program, **inputs):
    """program(ctl, **inputs) captured by the stand-in and replayed once."""
    g = GraphProgram(program, {k: v.clone() for k, v in inputs.items()}, "cpu",
                     capture=StubGraph)
    return g(**inputs)


# ---------------------------------------------------------------------------
# (a) bit for bit against the host loop
# ---------------------------------------------------------------------------

GCR_CASES = {
    "batch 1, 1 restart": dict(B=1, restarts=1),
    "batch 1, 5 restarts": dict(B=1, restarts=5),
    "batch 3, per-lane tol": dict(B=3, restarts=5, tol=[1e-2, 1e-6, 1e-4]),
    "batch 3, active mask": dict(B=3, restarts=5, active=[True, False, True]),
    "batch 3, zero lane": dict(B=3, restarts=1, zero=1),
}


@pytest.mark.parametrize("case", GCR_CASES)
def test_gcr_program_gives_the_host_loops_bits(case):
    c = GCR_CASES[case]
    s = _stencil()
    b = _lanes(c["B"], 2)
    if "zero" in c:
        b[c["zero"]] = 0
    tol = torch.tensor(c["tol"], dtype=torch.float32) if "tol" in c else 1e-5
    active = torch.tensor(c["active"]) if "active" in c else None
    kw = dict(m=8, tol=tol, n_restarts=c["restarts"], active=active)
    want = device_gcr(s.full_op, b, **kw)
    # captured by the stand-in (every loop body recorded once), replayed
    got = _stub_program(lambda ctl, b: dict(enumerate(gcr_program(ctl, s.full_op, b, **kw)[:3])),
                        b=b)
    assert _equal(got.values(), want[:3])
    assert want[1].max() > 8 or c["restarts"] == 1          # restarts that iterate
    if active is not None:
        assert want[1][1] == 0 and not want[0][1].any()
    if "zero" in c:
        assert want[1][c["zero"]] == 0 and torch.isfinite(want[0]).all()


@pytest.mark.parametrize("odd_even", [True, False], ids=["schur", "full"])
@pytest.mark.parametrize("B, restarts", [(1, 5), (3, 1), (3, 5)])
def test_coarsest_program_gives_the_host_loops_bits(odd_even, B, restarts):
    s = _stencil()
    b = _lanes(B, 3)
    args = (6, 1e-4, restarts, odd_even)
    want = coarsest.coarsest_gcr(s, b, *args)
    got = _stub_program(lambda ctl, b: dict(enumerate(coarsest.coarsest_gcr(
        s, b, *args, gcr=functools.partial(gcr_program, ctl)))), b=b)
    assert _equal(got.values(), want)
    assert torch.equal(want[1][:, 1], want[1][:, 0] + restarts)


# ---------------------------------------------------------------------------
# (b) against the JAX package's device_gcr
# ---------------------------------------------------------------------------

def test_gcr_program_matches_the_jax_device_gcr_on_the_schur_operator():
    """Both run complex64 GCR on the even-site Schur complement of the same
    coarsest level; x agrees within 1e-5 relative: f32 rounding in other
    summation orders (the JAX Gram-Schmidt einsums run over all m rows, zero
    rows included, the port's products over the j written rows; XLA's
    coarse stencil against K4's plain version) compounds over ~27
    iterations and two restarts, ~3e-7 on these inputs.  Iterations are
    equal: no lane's stopping test lies within that rounding of its
    tolerance."""
    A, Df, Db = _blocks(4, hop=0.06)
    geom = JGeometry(lattice=LAT, block=(2, 2, 2, 2))
    jcop = jcoarse.CoarseOperator(cplx.as_carray(A), cplx.as_carray(Df),
                                  cplx.as_carray(Db)).astype(jnp.complex64)
    js = jstencil.CoarseStencilSoA.build(jcop, geom, use_pallas=False)
    ts = CoarseStencilSoA.build(convert.coarse_operator(A, Df, Db), Geometry(LAT, (2, 2, 2, 2)),
                                dtype=torch.complex64)
    B, m, tol, restarts = 3, 12, 1e-5, 3
    b = random_spinor((B, D, *LAT[:2], LAT[2] * LAT[3]), 5).astype(np.complex64)
    b = b * ts.even.numpy().reshape(1, 1, *LAT[:2], -1)         # the even sites

    def jschur(v):
        ve = js.even * v
        return js.even * (js.self_op(ve) - js.hop(js.self_inv(js.hop(ve), js.odd)))

    jb = cplx.as_carray(b).astype_real(jnp.float32)
    jx, jit, _, _ = jax.vmap(lambda v: jax_device_gcr(jschur, v, m=m, tol=tol,
                                                      n_restarts=restarts))(jb)
    x, it, _, _ = gcr_program(HostControl(), lambda v: schur(ts, v),
                              torch.as_tensor(b.reshape(B, D, -1)), m, tol, restarts)
    assert np.array_equal(it.numpy(), np.asarray(jit)) and it.min() > m
    want = to_numpy(jx).reshape(B, D, -1)
    for i in range(B):
        assert np.abs(x[i].numpy() - want[i]).max() / np.abs(want[i]).max() < 1e-5


# ---------------------------------------------------------------------------
# (c) trips and launch accounting
# ---------------------------------------------------------------------------

def test_trips_of_a_restart_are_its_largest_lane_count():
    s = _stencil()
    b = _lanes(3, 6)
    tol = torch.tensor([1e-2, 1e-5, 1e-3])

    def program(ctl, b, restarts):
        _, it, _, _ = gcr_program(ctl, s.full_op, b, 6, tol, restarts)
        return {"it": it}

    prev_it, prev_trips = torch.zeros(3, dtype=torch.float32), 0
    for restarts in range(1, 5):
        g = GraphProgram(functools.partial(program, restarts=restarts), {"b": b.clone()},
                         "cpu", capture=StubGraph)
        it = g(b=b)["it"]
        assert g.graph.parents == [-1, 0]        # the iterations nested in the restarts
        passes, trips = g.graph.trips[:2].tolist()
        assert passes == restarts
        assert trips - prev_trips == int((it - prev_it).max())
        prev_it, prev_trips = it, trips
    assert prev_trips > 6


class CountingStencil(CoarseStencilSoA):
    """A coarse stencil whose every apply counts one K4 launch, as K4's
    wrapper does on a card (the plain version on the CPU counts none)."""

    def _apply(self, Pk, v, terms, masked=False, parity=None):
        kernels.launched("K4")
        return super()._apply(Pk, v, terms, masked, parity)


@pytest.fixture
def stub_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(hierarchy, "GRAPH_CAPTURE", StubGraph)
    StubGraph.captures = 0
    return StubGraph


@pytest.mark.parametrize("odd_even", [True, False], ids=["schur", "full"])
def test_graph_launch_accounting_equals_the_counting_stencil(stub_graphs, odd_even):
    s = _stencil(cls=CountingStencil)
    args = (6, 1e-4, 3, odd_even)
    graph = coarsest.CoarsestGraph(s, 3, *args, capture=StubGraph)
    kernels.reset_counts()
    apply = Counter({"K4": 4 if odd_even else 1})
    assert graph.graph.loops == [apply, apply]          # a restart's and an iteration's
    assert graph.graph.call == Counter({"K4": 4} if odd_even else {})
    host = 0
    for seed in (7, 8):
        b = _lanes(3, seed)
        kernels.reset_counts()
        want = coarsest.coarsest_gcr(s, b, *args)
        host = kernels.counts()["K4"]
        got = graph(b)
        assert _equal(got, want)
        assert kernels.counts()["K4"] == 2 * host          # host loop + replay
        assert kernels.counts()["G"] == 1
    assert host > 0 and graph.launches.replays == 2
    kernels.reset_counts()


# ---------------------------------------------------------------------------
# (d) the Multigrid's cache of graphs
# ---------------------------------------------------------------------------

def _multigrid(bf16=False):
    """A two-level complex64 Multigrid on 4^4 (coarsest 2^4, d = 8) with
    injected test vectors."""
    lats = ((4, 4, 4, 4), (2, 2, 2, 2))
    n = 4
    op = WilsonOperator.from_gauge(torch.as_tensor(rough_field(lats[0], seed=6)), -0.5, 1.0)
    levels = [LevelConfig(lattice=lat, block=blk, num_test_vectors=n, setup_iter=1)
              for lat, blk in zip(lats, ((2, 2, 2, 2), (1, 1, 1, 1)))]
    mg = Multigrid(op, MGConfig(levels=levels, dtype=torch.complex64, seed=1,
                                coarse_block_bf16=bf16))
    mg.set_test_vectors(random_spinor((n, *lats[0], 4, 3), seed=7))
    return mg, op


def test_no_graph_on_the_cpu_or_on_a_mesh(stub_graphs, monkeypatch):
    mg, _ = _multigrid()
    lvl = mg._levels()[-1]
    b = torch.as_tensor(random_spinor((2, 8, 16), 9).astype(np.complex64))
    mg._coarsest_solve(lvl, b)
    assert not lvl.graphs and stub_graphs.captures == 0     # GRAPH_DEVICES: cuda only
    monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
    # a level sharded over gloo keeps its host loop (no capture holds a
    # gloo collective) ...
    gloo = types.SimpleNamespace(comm=types.SimpleNamespace(transport="gloo"))
    monkeypatch.setattr(lvl.stencil, "mesh", gloo)
    assert not mg.uses_graphs(b, lvl)
    monkeypatch.setattr(lvl.stencil, "mesh", None)
    # ... while the coarsest level, replicated on every rank of a grid,
    # solves with no collective and runs its graph on any transport
    mg.cfg.mesh = object()
    assert mg.uses_graphs(b, lvl)
    mg._coarsest_solve(lvl, b)
    assert len(lvl.graphs) == 1 and stub_graphs.captures == 1


@pytest.mark.parametrize("bf16", [False, True], ids=["complex64", "bf16 view"])
def test_one_graph_per_batch_dtype_and_view_dropped_with_the_stencil(stub_graphs,
                                                                      monkeypatch, bf16,
                                                                      traced):
    monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
    mg, op = _multigrid(bf16)
    lvl = mg._levels()[-1]
    view = torch.bfloat16 if bf16 else torch.complex64
    b2 = torch.as_tensor(random_spinor((2, 8, 16), 9).astype(np.complex64))
    b3 = torch.as_tensor(random_spinor((3, 8, 16), 10).astype(np.complex64))

    def solve(b):
        got = mg._coarsest_solve(lvl, b)
        cfg = mg.cfg
        want = coarsest.coarsest_gcr(mg._cycle_view(lvl), b, cfg.coarse_iter, cfg.coarse_tol,
                                     cfg.coarse_restart, mg._odd_even(lvl))
        assert _equal(got, want)

    solve(b2)
    solve(b2)
    solve(b3)
    assert stub_graphs.captures == 2 and traced.counters["replays"] == 3
    assert set(lvl.graphs) == {(2, torch.complex64, view), (3, torch.complex64, view)}
    assert all(g.stencil is mg._cycle_view(lvl) for g in lvl.graphs.values())
    for drop in (lambda: mg.re_setup(mg.fine), lambda: mg.shift_update(0.01, op),
                 lambda: mg.bootstrap_setup(1)):
        solve(b2)
        assert lvl.graphs
        drop()
        assert not lvl.graphs
    solve(b2)
    assert lvl.graphs[(2, torch.complex64, view)].stencil is mg._cycle_view(lvl)
    # a stencil replaced behind the cache's back is caught by identity
    lvl.stencil = dataclasses.replace(lvl.stencil)
    lvl.cycle_stencil = None
    solve(b2)
    assert lvl.graphs[(2, torch.complex64, view)].stencil is mg._cycle_view(lvl)


def test_a_setup_keeps_one_graph_and_a_new_setup_drops_them(stub_graphs, monkeypatch):
    monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
    kept = []
    real = Multigrid._program

    def watch(self, cls, B, dtype, m=0, op=None):
        g = real(self, cls, B, dtype, m, op)
        kept.append((sorted(self.programs), sum(len(lv.graphs) for lv in self._levels())))
        return g

    monkeypatch.setattr(Multigrid, "_program", watch)
    p = config.parse_ini("""configuration: none
number of levels: 2
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
d0 test vectors: 4
d0 setup iter: 2
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
method: 2
mixed precision: 1
""")
    s = api.Solver(p, device="cpu")
    s.set_conf(rough_field((4, 4, 4, 4), seed=3))
    s.setup()
    # the setup's coarsest GCRs are nested in its sweeps' one program, which
    # one capture serves for the whole setup
    assert stub_graphs.captures == 1 and kept
    assert all(k == ([("SetupCycleGraph", 4, 0, torch.complex64)], 0) for k in kept)
    lvl = s.mg._levels()[-1]
    assert not lvl.graphs and not s.mg.programs
    x, info = s.solve(config.make_rhs("ones", s.lattice))
    # the solve's coarsest GCR is nested in its inner restarts' program
    assert info.converged and not lvl.graphs and s.mg.programs
    old = s.mg
    s.setup()
    assert not old.programs and s.mg is not old
