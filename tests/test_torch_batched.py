"""The port's batched multigrid path on the CPU (complex128, plain versions
of the kernels): the per-lane early-exit GCR, the batched cycles, the
batched bootstrap (Multigrid._setup_cycles_batch) and Solver.solve_multi.

  (a) device_gcr over a batch against each lane alone, with per-lane
      tolerances, a preconditioner that reports counters and a lane masked
      off: equal iteration counts and counters, x to 1e-12;
  (b) the loop reads the device once per iteration (lanes_go_on);
  (c) a zero right-hand side in one lane changes no other lane and makes
      no NaN (GCR and the multigrid inner restart);
  (d) the batched two- and three-level cycle against each lane's own
      cycle, to 1e-12;
  (e) after bootstrap_setup, the test vectors of both levels and the
      preconditioner equal the JAX package's Multigrid (which runs its
      vmapped _setup_cycles_batch) on the same injected test vectors, 1e-9;
  (f) solve_multi of 3 right-hand sides against the JAX package's solve of
      each (the restart loop of its Solver._solve_mp_device over its
      Multigrid.inner_restart, the residual kept in complex128): equal
      iteration counts, true residuals below the tolerance;
  (g) solve_multi on a (1, 2, 1, 1) process grid of two gloo ranks
      (tests/torch_parallel_ranks.py) against one rank.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu.mg.hierarchy import Multigrid as JMultigrid
from ddalphaamg_tpu_torch import api, config, convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg.hierarchy import MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators import fast
from ddalphaamg_tpu_torch.operators.stencil import CoarseStencilSoA
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.parallel import launch
from ddalphaamg_tpu_torch.solvers import device_gmres

torch.set_num_threads(1)

INI = """configuration: none
number of levels: {levels}
d0 global lattice: {lattice}
d0 block lattice: 2 2 2 2
d0 test vectors: {n}
d0 setup iter: {s0}
d1 test vectors: {n}
d1 setup iter: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: 2
mixed precision: 0
"""


def _coarse_stencil(lat=(4, 4, 4, 4), d=8, seed=1):
    """A random, diagonally dominated coarse stencil (complex128)."""
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    cop = convert.coarse_operator(c(*lat, d, d) + 6.0 * np.eye(d), 0.1 * c(4, *lat, d, d),
                                  0.1 * c(4, *lat, d, d), dtype=torch.complex128)
    return CoarseStencilSoA.build(cop, Geometry(lat, (2, 2, 2, 2)))


def _lanes(s, B, seed):
    return torch.as_tensor(random_spinor((B, *s.field_shape), seed))


# ---------------------------------------------------------------------------
# (a)-(c) the GCR
# ---------------------------------------------------------------------------

def test_batched_gcr_matches_each_lane_alone():
    s = _coarse_stencil()
    b = _lanes(s, 4, 2)
    tol = torch.tensor([1e-2, 1e-6, 1e-9, 1e-4], dtype=torch.float64)
    active = torch.tensor([True, True, False, True])

    def prec(v):        # block Jacobi, one counter row per lane and iteration
        return s.self_inv(v, 0) + s.self_inv(v, 1), torch.ones((v.shape[0], 3),
                                                               dtype=torch.float64)

    x, it, rel2, aux = device_gmres.device_gcr(s.full_op, b, m=8, tol=tol, n_restarts=4,
                                               prec=prec, active=active)
    assert it[2] == 0 and not x[2].any() and aux[2].eq(0).all()
    for i in (0, 1, 3):
        x1, it1, rel1, aux1 = device_gmres.device_gcr(s.full_op, b[i:i + 1], m=8,
                                                      tol=float(tol[i]), n_restarts=4,
                                                      prec=prec)
        assert it[i] == it1[0] > 0
        assert torch.equal(aux[i], aux1[0]) and aux[i, 0] == it[i]
        assert rel_err(x[i].numpy(), x1[0].numpy()) < 1e-12
        assert float(rel2[i]) == pytest.approx(float(rel1[0]), rel=1e-9)
        r = b[i] - s.full_op(x[i])
        assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b[i])) < tol[i]
    assert len(set(it[[0, 1, 3]].tolist())) == 3      # the lanes stopped apart


@pytest.mark.parametrize("m, stops", [(60, "converged"), (5, "m iterations")])
def test_gcr_reads_the_device_once_per_iteration(monkeypatch, m, stops):
    s = _coarse_stencil()
    b = _lanes(s, 3, 3)
    reads = []
    real = device_gmres.lanes_go_on
    monkeypatch.setattr(device_gmres, "lanes_go_on", lambda go: reads.append(1) or real(go))
    _, it, _, _ = device_gmres.device_gcr(s.full_op, b, m=m, tol=1e-4)
    n = int(it.max())
    if stops == "converged":
        # one read before every iteration and the one that finds no lane left
        assert n < m and len(reads) == n + 1
    else:
        # the m-th iteration ends the restart: no read after it
        assert n == m and len(reads) == m


def test_zero_lane_changes_no_other_lane_and_makes_no_nan():
    s = _coarse_stencil()
    b = _lanes(s, 3, 4)
    bz = b.clone()
    bz[1] = 0
    x, it, rel2, _ = device_gmres.device_gcr(s.full_op, bz, m=10, tol=1e-8, n_restarts=3)
    x0, it0, _, _ = device_gmres.device_gcr(s.full_op, b[[0, 2]], m=10, tol=1e-8,
                                            n_restarts=3)
    assert torch.isfinite(x).all() and torch.isfinite(rel2).all()
    assert it[1] == 0 and not x[1].any()
    assert torch.equal(it[[0, 2]], it0)
    assert rel_err(x[[0, 2]].numpy(), x0.numpy()) < 1e-12

    mg = _multigrid(2)
    r = torch.as_tensor(random_spinor((3, 12, 256), 5))
    r[1] = 0
    z, its = mg.inner_restart(r, 1e-8, m=20)
    z0, its0 = mg.inner_restart(r[[0, 2]], 1e-8, m=20)
    assert torch.isfinite(z).all() and its[1] == 0 and not z[1].any()
    assert torch.equal(its[[0, 2]], its0)
    assert rel_err(z[[0, 2]].numpy(), z0.numpy()) < 1e-12


# ---------------------------------------------------------------------------
# (d) the batched cycle
# ---------------------------------------------------------------------------

def _multigrid(levels):
    """A complex128 Multigrid (no bootstrap) on injected test vectors:
    4^4 two-level or (4, 8, 4, 4) three-level."""
    lats = {2: ((4, 4, 4, 4), (2, 2, 2, 2)),
            3: ((4, 8, 4, 4), (2, 4, 2, 2), (1, 2, 1, 1))}[levels]
    blocks = ((2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1))
    n = 4
    op = WilsonOperator.from_gauge(torch.as_tensor(rough_field(lats[0], seed=6)), -0.5, 1.0)
    mg = Multigrid(op, MGConfig(levels=ranks.level_configs(lats, blocks, n),
                                dtype=torch.complex128, seed=1))
    mg.set_test_vectors(random_spinor((n, *lats[0], 4, 3), seed=7))
    if levels == 3:
        mg.set_test_vectors(random_spinor((n, *lats[1], 2 * n), seed=8), depth=1)
    return mg


@pytest.mark.parametrize("levels", [2, 3])
def test_batched_cycle_matches_each_lane_alone(levels):
    mg = _multigrid(levels)
    V = mg.fine.geom.num_sites
    eta = torch.as_tensor(random_spinor((3, 12, V), 9))
    got = mg(eta)
    stats = dict(mg.stats)
    for i in range(3):
        assert rel_err(got[i].numpy(), mg(eta[i]).numpy()) < 1e-12
    # the batch's counters are the sum of the lanes'
    for key, val in stats.items():
        assert mg.stats[key] == pytest.approx(2 * val)


# ---------------------------------------------------------------------------
# (e), (f) against the JAX package
# ---------------------------------------------------------------------------

def _pair(lattice, levels, n, s0, seed):
    """The JAX package's Multigrid and the port's Solver on the same field
    and injected test vectors, both after bootstrap_setup."""
    text = INI.format(lattice=" ".join(map(str, lattice)), levels=levels, n=n, s0=s0)
    U = rough_field(lattice, seed=seed)
    tv0 = random_spinor((n, *lattice, 4, 3), seed=seed + 1)
    clat = tuple(e // 2 for e in lattice)
    tv1 = random_spinor((n, *clat, 2 * n), seed=seed + 2)

    js = japi.Solver(jconfig.parse_ini(text))
    js.set_conf(U, links_have_bc=True)
    jmg = JMultigrid(js.op, js._mg_config())
    js.mg = js.preconditioner = jmg
    jmg.set_test_vectors(tv0)
    if levels > 2:
        jmg.fine.next.test_vectors = jnp.asarray(tv1)
        jmg.re_setup(jmg.fine)
    jmg.bootstrap_setup()

    p = config.parse_ini(text)
    p.inner_tol_clip = 1e-7       # the clip of _solve_mp_device
    s = api.Solver(p, device="cpu")
    s.set_conf(U, links_have_bc=True)
    mg = s.build_hierarchy()
    mg.set_test_vectors(tv0)
    if levels > 2:
        mg.set_test_vectors(tv1, depth=1)
    mg.bootstrap_setup()
    return js, jmg, s, mg


LAT3 = (8, 4, 4, 4)


@pytest.fixture(scope="module")
def pair3():
    return _pair(LAT3, levels=3, n=4, s0=1, seed=21)


def test_batched_bootstrap_matches_jax(pair3):
    lat = LAT3
    js, jmg, s, mg = pair3
    got = fast.spinor_from_soa(mg.fine.test_vectors, lat).numpy()
    assert rel_err(got, np.asarray(jmg.fine.test_vectors)) < 1e-9
    t1 = mg.fine.next.test_vectors
    got1 = t1.movedim(-1, -2).reshape(t1.shape[0], *mg.fine.next.geom.lattice, -1)
    assert rel_err(got1.numpy(), np.asarray(jmg.fine.next.test_vectors)) < 1e-9
    eta = random_spinor((*lat, 4, 3), seed=99)
    want = np.asarray(jmg(jnp.asarray(eta)))
    assert rel_err(fast.spinor_from_soa(mg(convert.fields(eta)), lat).numpy(), want) < 1e-9


def _rhs_batch(lat):
    point = np.zeros((*lat, 4, 3), np.complex128)
    point[0, 0, 0, 0, 2, 1] = 1.0
    return np.stack([np.ones((*lat, 4, 3), np.complex128),
                     random_spinor((*lat, 4, 3), seed=31), point])


def _jax_solve(js, rhs, tol, clip=1e-7):
    """The JAX package's restart loop of a multigrid solve
    (Solver._solve_mp_device, api.py:353-443, whose clip is 1e-7) with the
    residual kept in complex128: that loop rounds the residual to
    complex64 before its complex128 inner solve (api.py:432), where the
    port's complex128 inner solve takes it whole.  Returns (iterations,
    relres)."""
    p = js.p
    b = jnp.asarray(rhs)
    norm_b = float(jnp.linalg.norm(b))
    x = jnp.zeros_like(b)
    iters = 0
    for restart in range(p.max_restarts + 1):
        r = b if restart == 0 else b - js.apply_operator(x)
        nr = float(jnp.linalg.norm(r))
        if nr / norm_b < tol or restart == p.max_restarts:
            return iters, nr / norm_b
        z, it, _ = js.mg.inner_restart(r, max(tol * norm_b / nr, clip), m=p.restart_length)
        x = x + z
        iters += int(it)


def test_solve_multi_matches_jax_solve_of_each_lane(pair3):
    js, jmg, s, mg = pair3
    rhs = _rhs_batch(LAT3)
    x, infos = s.solve_multi(rhs)
    assert x.shape == rhs.shape
    for i, info in enumerate(infos):
        jit, jrel = _jax_solve(js, rhs[i], 1e-10)
        assert jrel < 1e-10 and info.converged
        assert info.iterations == jit, (i, info.iterations, jit)
        assert s.true_residual(x[i], rhs[i]) < 1e-10
        assert info.relres == pytest.approx(info.resvec[-1])
    # the batch's coarse averages and time are shared out as in the JAX package
    assert len({i.coarse_average for i in infos}) == 1 and infos[0].coarse_average > 0
    assert len({i.solve_time for i in infos}) == 1


# ---------------------------------------------------------------------------
# (g) on a process grid
# ---------------------------------------------------------------------------

GRID_INI = """number of levels: 2
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
d0 test vectors: 8
d0 setup iter: 2
method: 2
mixed precision: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1e-10
iterations between restarts: 50
maximum of restarts: 20
"""


def test_solve_multi_on_a_process_grid_matches_one_rank():
    lat = (4, 4, 4, 4)
    U = rough_field(lat, seed=3)
    rhs = _rhs_batch(lat)[1:]
    res = launch.run_ranks(ranks.run, (1, 2, 1, 1), "gloo", ["cpu"] * 2,
                           {"multi": ("solve_multi", dict(ini=GRID_INI, U=U, rhs=rhs))})
    x1, it1, exact1 = ranks.solve_multi(None, GRID_INI, U, rhs)
    x0, it0, exact0 = res[0]["multi"]
    for r in res:
        x, it, exact = r["multi"]
        assert it == it0
        np.testing.assert_array_equal(x, x0)             # every rank agrees
    assert all(e < 1e-10 for e in exact0 + exact1)
    assert all(abs(a - b) <= 1 for a, b in zip(it0, it1)), (it0, it1)
    np.testing.assert_allclose(x0, x1, atol=1e-6)
