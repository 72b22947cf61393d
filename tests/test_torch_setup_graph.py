"""The setup's sweeps as device programs (mg/programs.SetupCycleGraph and
TwoLevelUpdateGraph, Multigrid._setup_scope, the in-place re_setup) and the
setup's profiling phases, on the CPU through the stand-in capture
(tests/torch_graph_stub.StubGraph: every loop body recorded once, host
reads refused, replayed on the host):

  (a) bootstrap_setup and the interpolation-1 setup through stand-in
      replays give the host loops' test vectors, interpolations and coarse
      stencils bit for bit at two and three levels, with one chunk and
      with a padded last chunk (5 lanes, lane_chunk forced to 3), with
      bf16 coarse blocks, and the same launches of K1-K4, K4-bf16 and K7; one capture per (program, depth)
      serves the whole setup, which keeps the objects the programs hold
      (P and the stencils rewritten in place), and drops the programs at
      its end;
  (b) after such a setup the test vectors and a cycle match the JAX
      package's (complex128, 1e-9), and so do the interpolation-1 test
      vectors;
  (c) re_setup outside a setup, set_conf and shift_update still drop the
      programs and replace what they held; no program is made on the CPU
      unpatched, nor on a (1, 2, 1, 1) grid of two gloo ranks;
  (d) the six setup regions of the JAX package (its hierarchy.py:166-178)
      appear in the port's PROF table with its names, depths and counts
      for the same setup, and with PROF off they wrap nothing.
Sizes: 4^4 -> 2^4 (-> 1^4), d = 8 (10 with 5 lanes), a few seconds a case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from torch_graph_stub import StubGraph
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu import profiling as jprofiling
from ddalphaamg_tpu.mg.hierarchy import Multigrid as JMultigrid
from ddalphaamg_tpu_torch import api, config, convert, kernels, profiling
from ddalphaamg_tpu_torch.mg import hierarchy
from ddalphaamg_tpu_torch.mg.hierarchy import LevelConfig, MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators import cuda_coarse, cuda_dslash, cuda_gcr, fast
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.parallel import launch

torch.set_num_threads(1)

LATS = {2: ((4, 4, 4, 4), (2, 2, 2, 2)), 3: ((4, 4, 4, 4), (2, 2, 2, 2), (1, 1, 1, 1))}
BLOCKS = ((2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1))
N_TV = 4        # d = 8 on the coarse levels
SETUPS = {"bootstrap": "bootstrap_setup", "interpolation 1": "twolevel_extension_setup"}
PROGRAMS = {"bootstrap": "SetupCycleGraph", "interpolation 1": "TwoLevelUpdateGraph"}
KERNELS = ("K1", "K2", "K3", "K4", "K7")


def _multigrid(levels, dtype=torch.complex64, n=N_TV, **options):
    """A Multigrid on 4^4 with n injected test vectors, 2 setup iterations
    at depth 0 and 1 at depth 1."""
    lats = LATS[levels]
    op = WilsonOperator.from_gauge(torch.as_tensor(rough_field(lats[0], seed=6)), -0.5, 1.0)
    cfgs = [LevelConfig(lattice=lat, block=blk, post_smooth_iter=1, block_iter=2,
                        num_test_vectors=n, setup_iter=2 if d == 0 else 1)
            for d, (lat, blk) in enumerate(zip(lats, BLOCKS))]
    mg = Multigrid(op, MGConfig(levels=cfgs, dtype=dtype, seed=1, **options))
    mg.set_test_vectors(random_spinor((n, *lats[0], 4, 3), seed=7))
    if levels == 3:
        mg.set_test_vectors(random_spinor((n, *lats[1], 2 * n), seed=8), depth=1)
    return mg


def _state(mg):
    """Every level's test vectors, P and coarse blocks (clones)."""
    out = []
    for lvl in mg._levels():
        out += [t.clone() for t in (lvl.test_vectors, lvl.P) if t is not None]
        if lvl.depth:
            out += [lvl.stencil.Pk.clone(), lvl.stencil.Pk_inv.clone()]
    return out


@pytest.fixture
def counting(monkeypatch):
    """The kernel wrappers count their launches on the CPU as on a card."""
    def count(fn, key):
        def wrapped(*args, **kwargs):
            kernels.launched(key)
            return fn(*args, **kwargs)
        return wrapped

    for mod, name, key in ((cuda_dslash, "d_plus_clover", "K1"), (cuda_dslash, "hopping", "K2"),
                           (cuda_dslash, "clover", "K3"), (cuda_gcr, "gcr_step", "K7")):
        monkeypatch.setattr(mod, name, count(getattr(mod, name), key))
    apply = cuda_coarse.coarse_apply

    def coarse(blocks, *args, **kwargs):
        kernels.launched("K4-bf16" if blocks.dtype == torch.bfloat16 else "K4")
        return apply(blocks, *args, **kwargs)

    monkeypatch.setattr(cuda_coarse, "coarse_apply", coarse)


def _run_setup(mg, setup, monkeypatch, graphs: bool):
    """The setup with device programs through the stand-in capture (graphs)
    or with the host loops; returns (the kernels' launches, the programs
    asked for by key)."""
    asked = []
    real = Multigrid._program

    def program(self, cls, B, dtype, m=0, op=None):
        asked.append((cls.__name__, B, m, dtype))
        return real(self, cls, B, dtype, m, op)

    with monkeypatch.context() as mp:
        if graphs:
            mp.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
            mp.setattr(hierarchy, "GRAPH_CAPTURE", StubGraph)
            mp.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
        mp.setattr(Multigrid, "_program", program)
        StubGraph.captures = 0
        kernels.reset_counts()
        getattr(mg, SETUPS[setup])()
        counts = kernels.counts()
    kernels.reset_counts()
    return counts, asked


# ---------------------------------------------------------------------------
# (a) bit for bit against the host loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, most, chunk", [(28, 28, 28), (28, 5, 4), (28, 16, 14),
                                            (28, 12, 7), (29, 5, 5), (5, 3, 3), (4, 3, 2)])
def test_setup_chunk_pads_the_fewest_lanes(monkeypatch, n, most, chunk):
    mg = _multigrid(2, n=n)
    monkeypatch.setattr(hierarchy, "lane_chunk", lambda *a, **k: most)
    assert mg._setup_chunk(mg.fine, n) == chunk
    monkeypatch.setattr(hierarchy, "lane_chunk", lambda *a, **k: 1)
    with mg._setup_scope():             # fixed at the start of a setup
        monkeypatch.setattr(hierarchy, "lane_chunk", lambda *a, **k: most)
        assert mg._setup_chunk(mg.fine, n) == 1
    assert mg._setup_chunk(mg.fine, n) == chunk



CASES = {f"{levels} levels, {setup}, {'padded last chunk' if chunk else 'one chunk'}"
         f"{', bf16 blocks' if bf16 else ''}": (levels, setup, chunk, bf16)
         for levels in (2, 3) for setup in SETUPS for chunk in (None, 3)
         for bf16 in (False, True) if not bf16 or (levels == 3 and chunk)}


@pytest.mark.parametrize("case", CASES)
def test_setup_through_replays_gives_the_host_loops_bits(counting, monkeypatch, case):
    levels, setup, chunk, bf16 = CASES[case]
    n = N_TV
    if chunk is not None:       # 5 lanes in chunks of 3: the second padded with a copy
        n = 5
        real = hierarchy.lane_chunk
        monkeypatch.setattr(hierarchy, "lane_chunk",
                            lambda n, *a, **k: min(chunk, real(n, *a, **k)))
    host = _multigrid(levels, n=n, coarse_block_bf16=bf16)
    host_counts, host_asked = _run_setup(host, setup, monkeypatch, graphs=False)
    mg = _multigrid(levels, n=n, coarse_block_bf16=bf16)
    views = [mg._cycle_view(lvl) for lvl in mg._levels()]
    held = [(lvl.P, lvl.stencil) for lvl in mg._levels()]
    counts, asked = _run_setup(mg, setup, monkeypatch, graphs=True)
    assert not host_asked
    want, got = _state(host), _state(mg)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(counts[k] == host_counts[k] > 0
               for k in KERNELS + (("K4-bf16",) if bf16 else ()))
    # one capture per (program, depth) served every sweep, each chunk a replay
    keys = set(asked)
    B = chunk or n
    assert keys == {(PROGRAMS[setup], B, d, torch.complex64) for d in range(levels - 1)}
    assert StubGraph.captures == len(keys) and counts["G"] == len(asked)
    sweeps = 2 + 2 * (levels == 3) if setup == "bootstrap" else 2 * (levels - 1)
    assert len(asked) == sweeps * -(-n // B)
    # P and the stencils were rewritten where the programs read them
    assert all(lvl.P is P and lvl.stencil is s and mg._cycle_view(lvl) is v
               for lvl, (P, s), v in zip(mg._levels(), held, views))
    assert not mg.programs and not mg._levels()[-1].graphs


# ---------------------------------------------------------------------------
# (b) against the JAX package
# ---------------------------------------------------------------------------

INI = """configuration: none
number of levels: {levels}
d0 global lattice: {lattice}
d0 block lattice: 2 2 2 2
d0 test vectors: 4
d0 setup iter: 2
d1 test vectors: 4
d1 setup iter: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: 2
interpolation: {interp}
mixed precision: 0
{options}"""
LAT3 = (8, 4, 4, 4)


def _pair(lattice, levels, interp=2, options=""):
    """The JAX package's Multigrid and the port's Solver on the same field
    and injected test vectors, before the setup."""
    text = INI.format(lattice=" ".join(map(str, lattice)), levels=levels, interp=interp,
                      options=options)
    U = rough_field(lattice, seed=21)
    tv0 = random_spinor((4, *lattice, 4, 3), seed=22)
    tv1 = random_spinor((4, *(e // 2 for e in lattice), 8), seed=23)
    js = japi.Solver(jconfig.parse_ini(text))
    js.set_conf(U, links_have_bc=True)
    jmg = JMultigrid(js.op, js._mg_config())
    js.mg = js.preconditioner = jmg
    jmg.set_test_vectors(tv0)
    if levels > 2:
        jmg.fine.next.test_vectors = jnp.asarray(tv1)
        jmg.re_setup(jmg.fine)
    s = api.Solver(config.parse_ini(text), device="cpu")
    s.set_conf(U, links_have_bc=True)
    mg = s.build_hierarchy()
    mg.set_test_vectors(tv0)
    if levels > 2:
        mg.set_test_vectors(tv1, depth=1)
    return jmg, s, mg


@pytest.fixture
def graphs(monkeypatch):
    monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(hierarchy, "GRAPH_CAPTURE", StubGraph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    StubGraph.captures = 0
    return StubGraph


def test_bootstrap_through_replays_then_solve_match_jax(graphs):
    jmg, s, mg = _pair(LAT3, levels=3)
    jmg.bootstrap_setup()
    mg.bootstrap_setup()
    assert graphs.captures == 2 and not mg.programs
    got = fast.spinor_from_soa(mg.fine.test_vectors, LAT3).numpy()
    assert rel_err(got, np.asarray(jmg.fine.test_vectors)) < 1e-9
    t1 = mg.fine.next.test_vectors
    got1 = t1.movedim(-1, -2).reshape(t1.shape[0], *mg.fine.next.geom.lattice, -1)
    assert rel_err(got1.numpy(), np.asarray(jmg.fine.next.test_vectors)) < 1e-9
    eta = random_spinor((*LAT3, 4, 3), seed=99)
    want = np.asarray(jmg(jnp.asarray(eta)))
    assert rel_err(fast.spinor_from_soa(mg(convert.fields(eta)), LAT3).numpy(), want) < 1e-9
    x, info = s.solve(config.make_rhs("ones", s.lattice))
    assert info.converged and s.true_residual(x, config.make_rhs("ones", s.lattice)) < 1e-10


def test_interpolation_1_through_replays_matches_jax(graphs):
    jmg, s, mg = _pair(LAT3, levels=3, interp=1)
    jmg.twolevel_extension_setup()
    mg.twolevel_extension_setup()
    assert graphs.captures == 2 and not mg.programs
    assert rel_err(mg.get_test_vectors(), np.asarray(jmg.fine.test_vectors)) < 1e-9
    t1 = mg.fine.next.test_vectors
    got1 = t1.movedim(-1, -2).reshape(t1.shape[0], *mg.fine.next.geom.lattice, -1)
    assert rel_err(got1.numpy(), np.asarray(jmg.fine.next.test_vectors)) < 1e-9


# ---------------------------------------------------------------------------
# (c) the drops, and no program without a card or on a mesh
# ---------------------------------------------------------------------------

def test_outside_a_setup_re_setup_set_conf_and_shift_update_drop_programs(graphs):
    ini = INI.format(lattice="4 4 4 4", levels=2, interp=2, options="")
    s = api.Solver(config.parse_ini(ini), device="cpu")
    s.set_conf(rough_field((4, 4, 4, 4), seed=21), links_have_bc=True)
    mg = s.build_hierarchy()
    mg.bootstrap_setup()
    rt = torch.as_tensor(random_spinor((1, 12, 256), seed=25))
    P, coarse = mg.fine.P, mg.fine.next.stencil
    mg(rt)
    assert mg.programs
    mg.re_setup(mg.fine)            # outside a setup: replaced, not rewritten
    assert not mg.programs and mg.fine.P is not P and mg.fine.next.stencil is not coarse
    for drop in (lambda: s.set_conf(rough_field((4, 4, 4, 4), seed=21), links_have_bc=True),
                 lambda: s.shift_update(s.p.m0 + 0.01)):
        mg(rt)
        assert mg.programs
        drop()
        assert not mg.programs


def test_no_setup_program_on_the_cpu_unpatched_or_on_a_gloo_grid():
    ini = INI.format(lattice="4 4 4 4", levels=2, interp=2, options="")
    U = rough_field((4, 4, 4, 4), seed=3)
    mg = _multigrid(2)
    asked = []
    real = Multigrid._program
    Multigrid._program = lambda self, *a, **k: asked.append(a) or real(self, *a, **k)
    try:
        mg.bootstrap_setup()
        mg.twolevel_extension_setup()
    finally:
        Multigrid._program = real
    assert not asked
    res = launch.run_ranks(ranks.run, (1, 2, 1, 1), "gloo", ["cpu"] * 2,
                           {"setup": ("setup_programs", dict(ini=ini, U=U))})
    # no setup program for the gloo-sharded fine level; the replicated
    # coarsest level's GCR is a graph on the grid too, captured once for
    # each coarsest stencil the setup builds (the first, then one rebuild)
    assert all(r["setup"] == ([], 2, 0) for r in res)
    one = ranks.setup_programs(None, ini, U)     # the same on one rank makes them
    assert one[0] and set(one[0]) == {"SetupCycleGraph"} and one[1] == 1 and one[2] == 0


# ---------------------------------------------------------------------------
# (d) the setup's profiling phases
# ---------------------------------------------------------------------------

PHASES = {"setup: coarsest dense inverse", "setup: initial tv smoothing",
          "setup: block inverses", "setup: gram schmidt", "setup: tv cycles (F-cycle)",
          "setup: P/Galerkin rebuild"}


@pytest.fixture
def profilers(monkeypatch):
    for prof in (profiling.PROF, jprofiling.PROF):
        monkeypatch.setattr(prof, "enabled", True)
        prof.reset()
    monkeypatch.setattr(jprofiling.PROF, "sync", True)
    yield profiling.PROF, jprofiling.PROF
    for prof in (profiling.PROF, jprofiling.PROF):
        prof.reset()


def test_setup_regions_match_the_jax_packages(graphs, profilers):
    prof, jprof = profilers
    options = "coarsest direct: 1\nsmoother direct: 1\n"
    jmg, s, mg = _pair(LAT3, levels=3, options=options)
    jmg.bootstrap_setup()
    mg.bootstrap_setup()
    eta = random_spinor((*LAT3, 4, 3), seed=99)
    jmg(jnp.asarray(eta))               # the inverses are built at the first cycle
    mg(convert.fields(eta))
    want = {k: e.count for k, e in jprof.entries.items() if k[1].startswith("setup:")}
    got = {k: e.count for k, e in prof.entries.items()}
    assert {name for _, name in want} == PHASES
    assert got == want
    assert all(e.time > 0 for e in prof.entries.values())
    table = prof.table()
    assert all(f"depth {d}: {name}" in table for d, name in want)


def test_setup_regions_wrap_nothing_with_prof_off(monkeypatch):
    assert not profiling.PROF.enabled

    def refuse(*a, **k):
        raise AssertionError("a region ran with PROF off")

    monkeypatch.setattr(profiling.Profiler, "region", refuse)
    monkeypatch.setattr(profiling, "synchronize", refuse)
    mg = _multigrid(3)
    mg.cfg.coarsest_direct = mg.cfg.smoother_direct = True
    mg.bootstrap_setup()
    mg._ensure_inverses()
    assert mg._levels()[-1].dense_inv is not None and not profiling.PROF.entries
