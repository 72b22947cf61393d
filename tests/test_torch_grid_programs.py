"""The process-grid solve as device programs and the overlapped exchanges
(ddalphaamg_tpu_torch/parallel, mg/hierarchy.uses_graphs, solvers/fgmres.py)
on the CPU: the ranks are spawned gloo processes (parallel/launch.run_ranks)
running tests/torch_grid_program_ranks.py, which imports no JAX; programs
are captured by the stand-in (tests/torch_graph_stub.StubGraph), which
refuses every read of the device while it records.

  (a) the replicated coarsest level of a (1, 2, 1, 1) and a (1, 1, 2, 2)
      grid runs its GCR as one stand-in replay even on gloo, bit-equal to
      its host loop on every rank, and a whole cycle and an inner restart
      with it (the sharded fine level's host loops around the replays)
      give the host loops' bits; no program is made for the gloo-sharded
      level;
  (b) the sharded inner restart and cycle as stand-in programs with the
      gloo collectives inside (the stand-in holds them as a CUDA capture
      holds K8's on nccl): captured without a host read, z, iterations,
      cycle output and coarse-work counters equal to the host loops', bit
      for bit, on every rank; a three-level bootstrap setup with its
      sweeps as programs at both sharded depths and re_setup in place
      gives the host loops' test vectors bit for bit;
  (c) comm.exchange_start / finish equals the blocking exchange bit for
      bit; the overlapped fine operator (faces posted before K1 / K2, the
      corrections of all axes in one batched product) equals the blocking
      per-axis form within 1e-6 (complex64) and 1e-14 (complex128),
      summation order only, and the JAX package's sharded operators
      (dslash_shmap; soa_dslash_shmap on the t/z grid) within 1e-5 /
      1e-12; the sharded K5 apply (shard_ops.coarse_hops) equals one K5
      plain apply on the blocking exchange's faces bit for bit and the JAX
      package's coarse_sharded (Pallas in interpret mode) within 1e-5;
  (d) fgmres and fgmres_mp with single_reduce False, "fused" and
      "pythagoras" against the JAX package's fgmres / fgmres_mp on the same
      inputs, on one rank and on a (1, 2, 1, 1) grid: the JAX package's
      iterations (fgmres_mp runs "pythagoras" as False, as the JAX
      package's does), x within 1e-8 (complex128) / 1e-6 (mixed); the
      Solver's policy ("fused" under a mesh, False on one rank,
      DDAAMG_SINGLE_REDUCE);
  (e) the capture rules: a gloo collective under a CUDA capture raises,
      uses_graphs by level and transport; on a card (marked gpu), K8
      against its plain versions, also under skew.
Sizes: 4^4 fine lattices, d = 8, a few seconds a spawn.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_grid_program_ranks as granks
from torch_parity import random_spinor, rel_err, rough_field, to_numpy

from ddalphaamg_tpu import cplx
from ddalphaamg_tpu import parallel as jparallel
from ddalphaamg_tpu.geometry import Geometry as JGeometry
from ddalphaamg_tpu.operators import stencil as jstencil
from ddalphaamg_tpu.operators import wilson as jwilson
from ddalphaamg_tpu.operators.coarse import CoarseOperator as JCoarseOperator
from ddalphaamg_tpu.solvers import fgmres as jfgmres
from ddalphaamg_tpu.solvers.fgmres import fgmres_mp as jfgmres_mp
from ddalphaamg_tpu_torch import api, config, convert
from ddalphaamg_tpu_torch.parallel import comm, launch
from ddalphaamg_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

M0, CSW = -0.5, 1.0
FINE = (4, 4, 4, 4)
LATS = ((4, 4, 4, 4), (2, 2, 2, 2))
BLOCKS = ((2, 2, 2, 2), (1, 1, 1, 1))
N_TV = 4                        # d = 8 on the coarse level
COARSE = (4, 8, 8, 8)           # (c): the coarse stencil's lattice (interior sites on each slab)
GRIDS = {"mesh1x2": (1, 2, 1, 1), "mesh1x1x2x2": (1, 1, 2, 2)}
MG_LEVELS = ((4, 8, 4, 4), (2, 4, 2, 2), (1, 2, 1, 1))     # (b): depth 1 sharded too
MG_BLOCKS = ((2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1))
KINDS = (False, "fused", "pythagoras")


def _coarse_blocks(lat, d, seed):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    return c(*lat, d, d) + 5.0 * np.eye(d), c(4, *lat, d, d), c(4, *lat, d, d)


@pytest.fixture(scope="module")
def inputs():
    A, Df, Db = _coarse_blocks(COARSE, 2 * N_TV, 21)
    return dict(U=rough_field(FINE, seed=6), tv0=random_spinor((N_TV, *FINE, 4, 3), seed=7),
                b=random_spinor((2, 2 * N_TV, 16), seed=8),
                eta=random_spinor((*FINE, 4, 3), seed=9),
                r=random_spinor((2, *FINE, 4, 3), seed=10),
                phi=random_spinor((12, int(np.prod(FINE))), seed=11),
                A=A, Df=Df, Db=Db,
                v=random_spinor((2, 2 * N_TV, int(np.prod(COARSE))), seed=12),
                rhs=random_spinor((*FINE, 4, 3), seed=13),
                Umg=rough_field(MG_LEVELS[0], seed=14))


def _cases(dims, x):
    mg = dict(lattices=LATS, blocks=BLOCKS, n_tv=N_TV, U=x["U"], tvs=[x["tv0"]])
    cases = {
        "coarsest": ("replicated_coarsest", dict(mg, b=x["b"], eta=x["eta"], r=x["r"], m=10)),
        "slab": ("slab_programs", dict(mg, r=x["r"], eta=x["eta"], m=10)),
        "overlap": ("overlap_ops", dict(lattice=FINE, U=x["U"], phi=x["phi"],
                                        clattice=COARSE, A=x["A"], Df=x["Df"], Db=x["Db"],
                                        v=x["v"])),
    }
    if dims == (1, 2, 1, 1):
        cases["fgmres"] = ("fgmres_grid", dict(lattice=FINE, U=x["U"], b=x["rhs"],
                                               kinds=KINDS))
        cases["setup"] = ("setup_on_grid", dict(U=x["Umg"], lattices=MG_LEVELS,
                                                blocks=MG_BLOCKS, n_tv=N_TV, setup_iter=2))
    return cases


@pytest.fixture(scope="module")
def runs(inputs):
    """runs(dims): every rank's results of one spawned grid, which runs all
    its cases once."""
    done = {}

    def get(dims):
        if dims not in done:
            n = int(np.prod(dims))
            done[dims] = launch.run_ranks(granks.run, dims, "gloo", ["cpu"] * n,
                                          _cases(dims, inputs))
        return done[dims]
    return get


GRID = pytest.mark.parametrize("dims", list(GRIDS.values()), ids=list(GRIDS))


def _jmesh(dims):
    n = int(np.prod(dims))
    return jparallel.make_solver_mesh(dims=dims, devices=jax.devices()[:n])


# ---------------------------------------------------------------------------
# (a) the replicated coarsest level as replays on a gloo grid
# ---------------------------------------------------------------------------

@GRID
def test_replicated_coarsest_replays_equal_host_loops_on_every_rank(runs, dims):
    res = [r["coarsest"] for r in runs(dims)]
    for r in res:
        assert r["sharded"] == [True, False]
        assert r["used"] == (True, False)       # the coarsest level: yes; the gloo slab: no
        assert r["coarsest_equal"] and r["cycle_equal"] and r["inner_equal"]
        assert r["captures"] == 2 and r["programs"] == 0       # batches 2 and 1
        # one replay for the direct call and the cycle, one for each of the
        # host-driven inner restart's cycles
        assert r["replays"][:2] == [1, 2]
        assert r["replays"][2] - 2 == max(r["inner_iterations"]) > 1
        assert max(r["iterations"]) > 1
    assert len({r["bits"] for r in res}) == 1       # every rank solved the same bits


# ---------------------------------------------------------------------------
# (b) the slab inner restart and cycle with the collectives inside
# ---------------------------------------------------------------------------

@GRID
def test_slab_programs_hold_the_collectives_without_a_host_read(runs, dims):
    res = [r["slab"] for r in runs(dims)]
    for r in res:
        assert r["sharded"] == [True, False]
        assert r["programs"] == ["CycleGraph", "InnerRestartGraph"] and r["captures"] == 2
        assert r["z_equal"] and r["iters_equal"] and r["cycle_equal"] and r["stats_equal"]
        assert r["iterations"] == res[0]["iterations"]
        np.testing.assert_array_equal(r["z"], res[0]["z"])
    # the tighter lane stops earlier than the other, within the GCR length
    assert res[0]["iterations"][1] < res[0]["iterations"][0] <= 10


def test_setup_sweeps_as_programs_on_a_grid_equal_host_loops(runs):
    """Three levels on (1, 2, 1, 1), depth 1 sharded too: the bootstrap's
    sweeps as programs with re_setup writing in place (the replicated
    coarsest level's gathered blocks into their storage)."""
    for r in runs((1, 2, 1, 1)):
        res = r["setup"]
        assert res["sharded"] == [True, True, False]
        assert res["kinds"] == ["SetupCycleGraph"] and res["captures"] == 2   # one a depth
        assert res["equal"] == [True, True]


# ---------------------------------------------------------------------------
# (c) the overlapped exchange, fine operator and K5
# ---------------------------------------------------------------------------

@GRID
def test_exchange_start_finish_equals_the_blocking_exchange(runs, dims):
    assert all(r["overlap"]["exchange_equal"] for r in runs(dims))


@GRID
@pytest.mark.parametrize("dtype", ["c64", "c128"])
def test_overlapped_fine_operator_matches_blocking_and_jax(runs, inputs, dims, dtype):
    res = [r["overlap"] for r in runs(dims)]
    tol_order, tol_jax = (1e-6, 1e-5) if dtype == "c64" else (1e-14, 1e-12)
    jdt, ndt = ((jnp.complex64, np.complex64) if dtype == "c64"
                else (jnp.complex128, np.complex128))
    U = inputs["U"]
    jm = _jmesh(dims)
    jop = jwilson.WilsonOperator.from_gauge(cplx.as_carray(U), m0=M0, csw=CSW)
    phi = inputs["phi"].astype(ndt)
    # the logical layout on any grid
    jlog = jparallel.shard_operator(jm, jop.astype(jdt))
    phi_log = phi.reshape(4, 3, *FINE).transpose(2, 3, 4, 5, 0, 1)
    want = np.asarray(to_numpy(jax.jit(lambda o, v: jparallel.dslash_shmap(jm, o, v))(
        jlog, jparallel.shard_field(jm, cplx.as_carray(phi_log), FINE))))
    want = want.transpose(4, 5, 0, 1, 2, 3).reshape(12, -1)
    wants = [want]
    if dims[2] == dims[3] == 1:         # the packed layout: t / z grids only
        js = jstencil.WilsonStencilSoA.build(jop, JGeometry(lattice=FINE, block=(2, 2, 2, 2)),
                                             dtype=jdt, use_pallas=False)
        phi_soa = phi.reshape(4, 3, FINE[0], FINE[1], FINE[2] * FINE[3])
        phi_sh = jparallel.shard_field(jm, cplx.as_carray(phi_soa), FINE, soa=True)
        wants.append(to_numpy(jax.jit(lambda st, v: jparallel.soa_dslash_shmap(jm, st, v))(
            jparallel.shard_stencil(jm, js), phi_sh)).reshape(12, -1))
    for r in res:
        assert r[f"fine_err_{dtype}"] <= tol_order and r[f"hop_err_{dtype}"] <= tol_order
        for w in wants:
            assert rel_err(r[f"fine_{dtype}"], w) < tol_jax


@GRID
def test_sharded_k5_equals_the_blocking_apply_and_jax(runs, inputs, dims):
    res = [r["overlap"] for r in runs(dims)]
    d = 2 * N_TV
    for r in res:
        assert r["k5_equal"]
    # the JAX package's sharded coarse operator (its tz layout on a t / z
    # grid, Pallas in interpret mode), else its single-device stencil, a
    # lane at a time
    jcop = JCoarseOperator(cplx.as_carray(inputs["A"]), cplx.as_carray(inputs["Df"]),
                           cplx.as_carray(inputs["Db"])).astype(jnp.complex64)
    v = inputs["v"].astype(np.complex64).reshape(2, d, *COARSE[:2], COARSE[2] * COARSE[3])
    tz = dims[2] == dims[3] == 1
    js = jstencil.CoarseStencilSoA.build(jcop, JGeometry(lattice=COARSE, block=(2, 2, 2, 2)),
                                         use_pallas=tz)
    if tz:
        jm = _jmesh(dims)
        js = jparallel.shard_stencil(jm, js)
    want = []
    for lane in v:
        jv = cplx.as_carray(lane)
        if tz:
            jv = jparallel.shard_field(jm, jv, COARSE, soa=True)
        want.append(to_numpy(jax.jit(js.full_op)(jv)).reshape(d, -1))
    want = np.stack(want)
    for r in res:
        assert rel_err(r["k5"], want) < 1e-5


# ---------------------------------------------------------------------------
# (d) the single-reduce Arnoldi
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fgmres(inputs):
    """The JAX package's fgmres (complex128) and fgmres_mp (float32 inner)
    of the fine operator with each single_reduce value."""
    jop = jwilson.WilsonOperator.from_gauge(jnp.asarray(inputs["U"]), M0, CSW)
    b = jnp.asarray(inputs["rhs"])
    ops = {}

    def apply_mp(v):
        dt = v.dtype
        if dt not in ops:
            ops[dt] = jop.astype(dt)
        return jwilson.d_plus_clover(ops[dt], v)

    out = {}
    for kind in KINDS:
        res = jfgmres(lambda v: jwilson.d_plus_clover(jop, v), b, tol=1e-9,
                      restart_length=20, max_restarts=30, single_reduce=kind)
        out[("fgmres", kind)] = (res.iterations, res.converged, np.asarray(res.x))
        res = jfgmres_mp(apply_mp, b, tol=1e-9, restart_length=10, max_restarts=60,
                         single_reduce=kind)
        out[("fgmres_mp", kind)] = (res.iterations, res.converged, np.asarray(res.x))
    return out


@pytest.fixture(scope="module")
def one_rank_fgmres(inputs):
    return granks.fgmres_grid(None, FINE, inputs["U"], inputs["rhs"], KINDS)


@pytest.mark.parametrize("solver", ["fgmres", "fgmres_mp"])
@pytest.mark.parametrize("kind", KINDS, ids=["false", "fused", "pythagoras"])
def test_single_reduce_matches_jax_on_one_rank_and_a_grid(runs, inputs, jax_fgmres,
                                                          one_rank_fgmres, solver, kind):
    j_it, j_conv, jx = jax_fgmres[(solver, kind)]
    assert j_conv
    want = convert.fields(jx).numpy()
    tol = 1e-8 if solver == "fgmres" else 1e-6
    grid = [r["fgmres"][(solver, kind)] for r in runs((1, 2, 1, 1))]
    for it, conv, x in [one_rank_fgmres[(solver, kind)], *grid]:
        assert conv and it == j_it
        assert rel_err(x, want) < tol
    if solver == "fgmres_mp" and kind == "pythagoras":    # run as False, as in the JAX package
        assert one_rank_fgmres[(solver, kind)][0] == one_rank_fgmres[(solver, False)][0]


def test_solver_single_reduce_policy(monkeypatch):
    p = config.parse_ini("d0 global lattice: 4 4 4 4\nnumber of levels: 1\n")
    s = api.Solver(p, device="cpu")
    monkeypatch.delenv("DDAAMG_SINGLE_REDUCE", raising=False)
    assert s._single_reduce() is False
    s.mesh = pmesh.SolverMesh((1, 2, 1, 1), 0)
    assert s._single_reduce() == "fused"
    for env, want in (("0", False), ("1", "fused"), ("fused", "fused"),
                      ("pythagoras", "pythagoras")):
        monkeypatch.setenv("DDAAMG_SINGLE_REDUCE", env)
        assert s._single_reduce() == want


# ---------------------------------------------------------------------------
# (e) the capture rules
# ---------------------------------------------------------------------------

def test_a_gloo_collective_under_a_capture_raises(monkeypatch):
    mesh = pmesh.SolverMesh((1, 2, 1, 1), 0, comm.Comm("gloo", "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    t = torch.zeros(2)
    for call in (lambda: comm.all_reduce_sum(mesh, t),
                 lambda: comm.exchange(mesh, 1, t, t),
                 lambda: comm.all_gather_lattice(mesh, t.reshape(2, 1), (1, 1, 1, 1))):
        with pytest.raises(RuntimeError, match="cannot be captured"):
            call()


def test_uses_graphs_follows_the_level_and_the_transport(monkeypatch):
    from ddalphaamg_tpu_torch.mg import hierarchy

    lvl = types.SimpleNamespace(stencil=types.SimpleNamespace(mesh=None))
    mg = types.SimpleNamespace(fine=lvl)
    b = torch.zeros(1)
    uses = hierarchy.Multigrid.uses_graphs
    assert not uses(mg, b)                                  # the CPU
    monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cpu",))
    assert uses(mg, b)                                      # one rank / a replicated level
    for transport, want in (("gloo", False), ("nccl", "nccl" in comm.CAPTURED_TRANSPORTS)):
        lvl.stencil.mesh = types.SimpleNamespace(comm=types.SimpleNamespace(transport=transport))
        assert uses(mg, b) is want
        coarsest = types.SimpleNamespace(stencil=types.SimpleNamespace(mesh=None))
        assert uses(mg, b, coarsest)                        # replicated under any grid


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(1, 2, 1, 1), (1, 1, 2, 2)], ids=["mesh1x2", "mesh1x1x2x2"])
def test_k8_matches_its_plain_versions(dims):
    """K8's ranks as Peers of one process, each rank's kernels on a stream
    of its own (parallel/peer.Peers.local_group): copies and the sum in rank
    order, bit for bit, over repeated calls (the parity buffers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from ddalphaamg_tpu_torch.parallel import peer

    group = peer.Peers.local_group(dims, "cuda")
    P = len(group)
    streams = [torch.cuda.Stream() for _ in range(P)]
    gen = torch.Generator(device="cuda").manual_seed(8)

    def on_all(fn):
        cur = torch.cuda.current_stream()
        outs = []
        for r, st in enumerate(streams):
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                outs.append(fn(r))
        for st in streams:
            cur.wait_stream(st)
        return outs

    axes = [mu for mu in range(4) if dims[mu] > 1]
    try:
        for _ in range(3):
            sends = [[(mu, *(torch.randn((2, 6, 96), generator=gen, dtype=torch.complex64,
                                         device="cuda") for _ in range(2))) for mu in axes]
                     for _ in range(P)]
            posted = on_all(lambda r: group[r].post(sends[r]))
            got = on_all(lambda r: group[r].finish(posted[r]))
            meshes = [g.mesh for g in group]
            for r in range(P):
                want = [f for pair in peer.exchange_plain(sends, meshes, r) for f in pair]
                assert all(torch.equal(a, b) for a, b in zip(got[r], want))
            for shape, dtype in (((12, 50), torch.complex64), ((12,), torch.float64)):
                parts = [torch.randn(shape, generator=gen, dtype=dtype, device="cuda")
                         for _ in range(P)]
                sums = on_all(lambda r: group[r].allreduce(parts[r]))
                assert all(torch.equal(s, peer.allreduce_plain(parts)) for s in sums)
            parts = [torch.randn((1, 8, 32), generator=gen, dtype=torch.complex64, device="cuda")
                     for _ in range(P)]
            stacks = on_all(lambda r: group[r].allgather(parts[r]))
            assert all(torch.equal(s, peer.allgather_plain(parts)) for s in stacks)
    finally:
        torch.cuda.synchronize()
        group[0].close()


@pytest.mark.gpu
def test_k8_holds_its_buffers_under_skew():
    """K8 with one rank lagging (a sleep before each of its calls) and no
    synchronization between calls: one-way shifts along a (1, 1, 1, 4)
    ring (no traffic back to bound the sender but K8's acknowledgements),
    all-reduces and gathers, each of alternating sizes whose chunks fall
    differently, some above the buffers (successive calls); every rank's
    results bit for bit the plain versions'.  One thread launches for all
    ranks, so each collective is launched for every rank before the next,
    and the allocator holds memory for every rank's stream beforehand: a
    host call that waited for the card (a driver allocation) would wait for
    kernels that wait for ranks not yet launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from ddalphaamg_tpu_torch.parallel import peer

    group = peer.Peers.local_group((1, 1, 1, 4), "cuda")
    P, calls = len(group), 12
    streams = [torch.cuda.Stream() for _ in range(P)]
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rand(n, dtype):
        return torch.randn(n, generator=gen, dtype=dtype, device="cuda")

    c64, f32 = torch.complex64, torch.float32
    ex_sizes = [3 * peer.ROW + 5, peer.MAILBOX // 8 + 1000, 7]
    ar_sizes = [(12 * 50, c64), (peer.REDUCE // 4 + 333, f32), (5, torch.float64)]
    ag_sizes = [56 * 64, 1, peer.GATHER // 8 + 17]
    sends = [[rand(ex_sizes[c % 3], c64) for c in range(calls)] for _ in range(P)]
    parts = [[rand(ar_sizes[c % 3][0], ar_sizes[c % 3][1]) for _ in range(P)] for c in range(calls)]
    stacks = [[rand(ag_sizes[c % 3], c64) for _ in range(P)] for c in range(calls)]
    for st in streams:
        with torch.cuda.stream(st):
            held = [torch.empty(1 << 29, dtype=torch.uint8, device="cuda")]
            held += [torch.empty(1 << 19, dtype=torch.uint8, device="cuda") for _ in range(16)]
        del held
    got = [[] for _ in range(P)]
    cur = torch.cuda.current_stream()
    torch.cuda.synchronize()
    try:
        for st in streams:
            st.wait_stream(cur)
        for c in range(calls):
            posted = []
            for r, st in enumerate(streams):
                with torch.cuda.stream(st):
                    if r == 1:
                        torch.cuda._sleep(1_000_000)
                    posted.append(group[r].post([(3, None, sends[r][c])]))
            for r, st in enumerate(streams):
                with torch.cuda.stream(st):
                    got[r].append(("shift", c, group[r].finish(posted[r])[0]))
            for r, st in enumerate(streams):
                with torch.cuda.stream(st):
                    got[r].append(("sum", c, group[r].allreduce(parts[c][r])))
            for r, st in enumerate(streams):
                with torch.cuda.stream(st):
                    got[r].append(("stack", c, group[r].allgather(stacks[c][r])))
        for st in streams:
            cur.wait_stream(st)
        torch.cuda.synchronize()
        for r in range(P):
            for kind, c, out in got[r]:
                want = {"shift": lambda: sends[group[r].mesh.neighbor(3, -1)][c],
                        "sum": lambda: peer.allreduce_plain(parts[c]),
                        "stack": lambda: peer.allgather_plain(stacks[c])}[kind]()
                assert torch.equal(out, want), (r, kind, c)
    finally:
        torch.cuda.synchronize()
        group[0].close()
