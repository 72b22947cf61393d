"""The port's library entry points against the JAX package on the CPU, on a
4^4 rough field (numpy, from a seed) with 2^4 blocks, two levels and 6 test
vectors.  Both packages start their hierarchies from the same initial test
vectors (each package's Multigrid._initial_test_vectors is replaced by the
same numpy draw), so their setups agree and, where both outer loops run in
complex128 (mixed precision 0), so do their iterations:

  (a) compat: the JAX package's test_compat.py scenarios (a solve and the
      preconditioner; the staleness counters; the clover scaling) and a
      setup at setup_m0 != m0 followed by a mass for the next solve, call
      by call against the JAX compat on the same dd_alpha_amg_par: equal
      iterations (within 1 for the solve after the mass moved, where the
      JAX package's FGMRES ends just under the tolerance), solutions within
      1e-8, equal counters; a scaled solve
      converges against the scaled operator and moves the solution by
      > 1e-3, and the unscaled solve after it is the first again.  At the
      JAX test's default mixed precision 1 the port's outer loop restarts
      its complex64 inner GCR where the JAX CPU path runs one FGMRES, so
      there only the solutions are compared;
  (b) analysis: run_self_checks has the JAX keys with every residual below
      1e-10 in both packages (complex128 levels); test_vector_analysis's rho
      to 1e-8, smoother_reduction and coarse_reduction to 1e-6;
  (c) profiling: profile_hierarchy's (level, name) rows and flops are the
      JAX package's; Profiler.table() is the JAX text for the same entries;
      with PROF on a solve gives the same iterations and solution as with
      it off, and with it off nothing is wrapped;
  (d) evaluation: run_scan of m0 over three points (shift update) and of d0
      setup iter (a new setup a point) give the JAX rows; the CGN error of a
      one-point scan agrees to 1e-6;
  (e) cli: --benchmark, --profile, --rhs-batch and an `evaluation: 1` ini
      exit 0 and print the JAX CLI's blocks.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err, rough_field

from ddalphaamg_tpu import analysis as janalysis
from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import cli as jcli
from ddalphaamg_tpu import compat as jamg
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu import evaluation as jevaluation
from ddalphaamg_tpu import io as jio
from ddalphaamg_tpu import profiling as jprofiling
from ddalphaamg_tpu.mg import hierarchy as jhierarchy
from ddalphaamg_tpu_torch import (analysis, api, cli, compat, config, evaluation,
                                  profiling)
from ddalphaamg_tpu_torch.mg import hierarchy
from ddalphaamg_tpu_torch.operators.stencil import WilsonStencilSoA
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator, d_plus_clover, shift_diagonal

torch.set_num_threads(1)

LAT = (4, 4, 4, 4)
B = np.ones((*LAT, 4, 3), np.complex128)


def _draw(level):
    """The initial test vectors of a level, [N, T, Z, Y, X, dof] (numpy)."""
    rng = np.random.default_rng(100 + level.depth)
    dof = 12 if level.depth == 0 else 2 * level.cfg.num_test_vectors
    shape = (level.cfg.num_test_vectors, *level.geom.lattice, dof)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _port_tvs(self, level, gen):
    s = level.stencil
    return s.slab(s.from_logical(torch.as_tensor(_draw(level)))).to(s.device, s.dtype)


def _jax_tvs(self, level, key):
    v = _draw(level)
    return jnp.asarray(v.reshape(v.shape[0], *level.geom.lattice, *level.dof_shape),
                       dtype=self.cfg.dtype)


@pytest.fixture(scope="module")
def same_tvs():
    mp = pytest.MonkeyPatch()
    mp.setattr(hierarchy.Multigrid, "_initial_test_vectors", _port_tvs)
    mp.setattr(jhierarchy.Multigrid, "_initial_test_vectors", _jax_tvs)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def field():
    U = rough_field(LAT, seed=5)
    U[0, -1] *= -1.0                      # raw links, as a file holds them
    return U


@pytest.fixture(scope="module")
def files(tmp_path_factory, field):
    """The field as a binary file and inis at mixed precision 0."""
    d = tmp_path_factory.mktemp("library")
    conf = str(d / "conf4")
    jio.write_gauge_field(conf, field, plaquette=0.0, anti_periodic=False)
    ini = INI.format(conf=conf)
    paths = {"conf": conf, "ini": str(d / "solve.ini"), "scan": str(d / "scan.ini")}
    open(paths["ini"], "w").write(ini)
    open(paths["scan"], "w").write(ini + SCAN)
    return paths


INI = """configuration: {conf}
number of levels: 2
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
d0 test vectors: 6
d0 setup iter: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: 2
mixed precision: 0
"""
SCAN = """evaluation: 1
scan variable: m0
start value: -0.5
end value: -0.48
step size: 0.01
compare with CGN error: 1
"""


# ---------------------------------------------------------------------------
# (a) compat
# ---------------------------------------------------------------------------

def _par(mod, files, mp0=True, **kw):
    return mod.dd_alpha_amg_par(
        param_file_path=files["ini"] if mp0 else "", m0=-0.5, csw=1.0, bc=2,
        amg_params=mod.dd_alpha_amg_parameters(
            number_of_levels=2, global_lattice=[[4, 4, 4, 4], [2, 2, 2, 2]],
            block_lattice=[[2, 2, 2, 2], [1, 1, 1, 1]], mg_basis_vectors=[6, 6],
            setup_iterations=[2, 2], discard_setup_after=3, update_setup_after=2), **kw)


def _counters(mod):
    st = mod._status
    return st.gauge_updates_since_last_setup, st.gauge_updates_since_last_setup_update


def _both(calls, field, files, mp0=True, **kw):
    """Run calls(module) after init and set_conf on each package; returns
    {"jax": result, "port": result}, the counters equal after each."""
    out = {}
    for name, mod in (("jax", jamg), ("port", compat)):
        par = _par(mod, files, mp0, **kw)
        if mod is compat:
            compat.dd_alpha_amg_init(par, device="cpu")
        else:
            jamg.dd_alpha_amg_init(par)
        try:
            plaq = mod.dd_alpha_amg_set_conf(field)
            out[name] = (plaq, calls(mod))
        finally:
            mod.dd_alpha_amg_free()
    assert abs(out["jax"][0] - out["port"][0]) < 1e-12
    return out["jax"][1], out["port"][1]


def _solve_steps(mod):
    steps = []
    mod.dd_alpha_amg_setup()
    steps.append((None,) + _counters(mod))
    x, relres, st = mod.dd_alpha_amg_wilson_solve(B, tol=1e-10)
    steps.append((x, relres, st["iterations"]) + _counters(mod))
    z = mod.dd_alpha_amg_preconditioner(B)
    steps.append((np.asarray(z),) + _counters(mod))
    return steps


@pytest.mark.parametrize("mp0", [True, False], ids=["mixed-precision-0", "default-par"])
def test_compat_solve_matches_jax(same_tvs, field, files, mp0):
    jsteps, psteps = _both(_solve_steps, field, files, mp0)
    assert [s[-2:] for s in jsteps] == [s[-2:] for s in psteps] == [(0, 0)] * 3
    (jx, jrel, jit, *_), (px, prel, pit, *_) = jsteps[1], psteps[1]
    assert jrel < 1e-10 and prel < 1e-10
    assert rel_err(px, np.asarray(jx)) < 1e-8
    if mp0:
        assert pit == jit
        assert rel_err(psteps[2][0], jsteps[2][0]) < 1e-9
    assert psteps[2][0].shape == B.shape


def test_compat_staleness_counters_match_jax(same_tvs, field, files):
    def steps(mod):
        mod.dd_alpha_amg_setup()
        out = [_counters(mod)]
        for _ in range(2):
            mod.dd_alpha_amg_set_conf(field)
            out.append(_counters(mod))
        mod.run_dd_alpha_amg_setup_if_necessary()      # update_setup_after = 2
        out.append(_counters(mod))
        mod.dd_alpha_amg_set_conf(field)
        mod.run_dd_alpha_amg_setup_if_necessary()      # discard_setup_after = 3
        out.append(_counters(mod))
        x, relres, _ = mod.dd_alpha_amg_wilson_solve(B, tol=1e-10)
        return out, np.asarray(x), relres

    (jsteps, jx, jr), (psteps, px, pr) = _both(steps, field, files)
    assert jsteps == psteps == [(0, 0), (1, 1), (2, 2), (2, 0), (0, 0)]
    assert jr < 1e-10 and pr < 1e-10 and rel_err(px, jx) < 1e-8


def _scaling_steps(mod):
    mod.dd_alpha_amg_setup()
    res = [mod.dd_alpha_amg_wilson_solve(B, tol=1e-10),
           mod.dd_alpha_amg_wilson_solve(B, tol=1e-10, scale_even=1.1, scale_odd=0.9),
           mod.dd_alpha_amg_wilson_solve(B, tol=1e-10)]
    return [(np.asarray(x), r, st["iterations"]) for x, r, st in res]


def test_compat_clover_scaling_matches_jax(same_tvs, field, files):
    jres, pres = _both(_scaling_steps, field, files)
    for (jx, jr, jit), (px, pr, pit) in zip(jres, pres):
        assert jr < 1e-10 and pr < 1e-10 and pit == jit
        assert rel_err(px, jx) < 1e-8
    (x1, _, _), (x2, _, _), (x3, _, _) = pres
    assert np.linalg.norm(x1 - x2) / np.linalg.norm(x1) > 1e-3
    np.testing.assert_array_equal(x3, x1)
    # the scaled solution solves the scaled operator
    op = WilsonOperator.from_gauge(torch.as_tensor(rough_field(LAT, seed=5)), -0.5, 1.0)
    f = torch.as_tensor(np.where(np.indices(LAT).sum(axis=0) % 2 == 0, 1.1, 0.9))
    scaled = WilsonOperator(op.links, op.clover * f[..., None, None, None])
    r = torch.as_tensor(B) - d_plus_clover(scaled, torch.as_tensor(x2))
    assert float(r.norm()) / np.linalg.norm(B) < 1e-10


def _setup_mass_steps(mod):
    mod.dd_alpha_amg_setup()
    out = [mod.dd_alpha_amg_wilson_solve(B, tol=1e-10)]
    if mod is compat:     # the hierarchy at the setup mass, the outer loop at m0
        s = compat._solver
        built = WilsonStencilSoA.build(shift_diagonal(s.op, 0.05), s._geom())
        assert torch.equal(s.mg.fine.stencil.cdiag, built.cdiag)
        assert torch.equal(s.outer.cdiag, WilsonStencilSoA.build(s.op, s._geom()).cdiag)
    mod.dd_alpha_amg_set_mass_for_next_solve(-0.49)
    out.append(mod.dd_alpha_amg_wilson_solve(B, tol=1e-10))
    assert mod._solver.p.m0 == -0.49
    return [(np.asarray(x), r, st["iterations"]) for x, r, st in out]


def test_compat_setup_mass_matches_jax(same_tvs, field, files):
    jres, pres = _both(_setup_mass_steps, field, files, setup_m0=-0.45)
    for (jx, jr, jit), (px, pr, pit) in zip(jres, pres):
        assert jr < 1e-10 and pr < 1e-10
        assert rel_err(px, jx) < 1e-8
    assert pres[0][2] == jres[0][2]
    # after the mass moved the preconditioners still agree to 1e-15, but the
    # JAX package's FGMRES stops at 8.6e-11 one iteration before the port's
    # flexible GCR: another Krylov method, not another hierarchy
    assert abs(pres[1][2] - jres[1][2]) <= 1


def test_compat_setup_mass_without_multigrid_matches_jax(field, files, tmp_path):
    """SAP alone (interpolation 0): the preconditioner is built at the setup
    mass, the complex128 FGMRES runs at m0, in both packages."""
    ini = str(tmp_path / "sap.ini")
    open(ini, "w").write(open(files["ini"]).read() + "interpolation: 0\n")

    def steps(mod):
        mod.dd_alpha_amg_setup()
        x, relres, st = mod.dd_alpha_amg_wilson_solve(B, tol=1e-10)
        if mod is compat:
            s = compat._solver
            built = WilsonStencilSoA.build(shift_diagonal(s.op, 0.05), s._geom())
            assert torch.equal(s.preconditioner.s.cdiag, built.cdiag)
        return (np.asarray(x), relres, st["iterations"],
                np.asarray(mod.dd_alpha_amg_preconditioner(B)))

    jres, pres = _both(steps, field, dict(files, ini=ini), setup_m0=-0.45)
    assert jres[1] < 1e-10 and pres[1] < 1e-10 and pres[2] == jres[2]
    assert rel_err(pres[0], jres[0]) < 1e-8
    assert rel_err(pres[3], jres[3]) < 1e-12


# ---------------------------------------------------------------------------
# (b), (c) analysis and profiling on one pair of set-up solvers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(same_tvs, files):
    js = japi.Solver(jconfig.parse_ini(files["ini"]))
    js.read_conf()
    js.setup()
    s = api.Solver(config.parse_ini(files["ini"]), device="cpu")
    s.read_conf()
    s.setup()
    return js, s


def test_self_checks_match_jax(pair):
    js, s = pair
    got, want = analysis.run_self_checks(s.mg), janalysis.run_self_checks(js.mg)
    assert list(got) == list(want) == ["depth0: P^H P == I", "depth0: P^H D P == D_c",
                                       "depth1: g5_c D_c Hermiticity"]
    for key in got:
        assert isinstance(got[key], float)
        assert got[key] < 1e-10 and want[key] < 1e-10, (key, got[key], want[key])


def test_test_vectors_and_reductions_match_jax(pair):
    js, s = pair
    got, want = analysis.test_vector_analysis(s.mg), janalysis.test_vector_analysis(js.mg)
    assert len(got) == len(want) == 6
    for (rho, res), (jrho, jres) in zip(got, want):
        assert abs(rho - jrho) < 1e-8 * abs(jrho) and abs(res - jres) < 1e-8 * jres
    for ours, theirs, arg in ((analysis.smoother_reduction, janalysis.smoother_reduction, 0),
                              (analysis.coarse_reduction, janalysis.coarse_reduction, 1)):
        a = ours(s if arg == 0 else s.mg)
        b = theirs(js if arg == 0 else js.mg)
        assert isinstance(a, float) and abs(a - b) < 1e-6 * b, (ours.__name__, a, b)
    assert analysis.smoother_reduction(s) < 1.0
    assert analysis.coarse_reduction(s.mg) <= s.p.coarse_tol


def test_profile_hierarchy_rows_match_jax(pair):
    js, s = pair
    got = profiling.profile_hierarchy(s.mg, reps=1).entries
    want = jprofiling.profile_hierarchy(js.mg, reps=1).entries
    rename = {"FULL CYCLE (traced)": "FULL CYCLE"}
    assert sorted(got) == sorted((lvl, rename.get(n, n)) for lvl, n in want)
    for (lvl, n), e in want.items():
        g = got[(lvl, rename.get(n, n))]
        assert g.count == e.count == 1 and g.flops == e.flops and g.time > 0, n


def test_profiler_table_is_the_jax_text():
    ours, theirs = profiling.Profiler(enabled=True), jprofiling.Profiler(enabled=True)
    assert ours.table() == theirs.table()
    for p in (ours, theirs):
        p.add("fine_op (d_plus_clover)", 0, 0.25, profiling.FLOPS_FINE_FULL * 256)
        p.add("preconditioner (v-cycle)", 0, 0.5)
        p.add("op_apply", 1, 1e-3, 1e6, count=3)
    assert ours.table() == theirs.table()
    with ours.region("op_apply", 1, 1e6, device="cpu"):
        pass
    assert ours.entries[(1, "op_apply")].count == 4
    off = profiling.Profiler()
    with off.region("x", flops=1.0):
        pass
    assert not off.entries and off.wrap(len, "x", len, "cpu") is len


def test_solve_with_prof_on_is_the_same_solve(pair):
    _, s = pair
    prof = profiling.PROF
    assert not prof.enabled
    assert s._profiled(s.apply_operator, "fine_op (d_plus_clover)", True) == s.apply_operator
    x, info = s.solve(B)
    prof.enabled = True
    prof.reset()
    try:
        x2, info2 = s.solve(B)
        entries = dict(prof.entries)
    finally:
        prof.enabled = False
        prof.reset()
    assert info2.iterations == info.iterations
    np.testing.assert_array_equal(x2, x)
    assert set(entries) == {(0, "fine_op (d_plus_clover)"), (0, "preconditioner (v-cycle)")}
    vol = int(np.prod(LAT))
    fine = entries[(0, "fine_op (d_plus_clover)")]
    assert fine.flops == fine.count * profiling.FLOPS_FINE_FULL * vol
    assert entries[(0, "preconditioner (v-cycle)")].count == info.iterations
    assert info.memory_mb == pytest.approx(profiling.solver_memory_mb(s)) and info.memory_mb > 0


# ---------------------------------------------------------------------------
# (d) evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variable", ["m0", "d0 setup iter", "cgn error"])
def test_run_scan_matches_jax(same_tvs, files, variable):
    p = config.parse_ini(files["scan"])
    jp = jconfig.parse_ini(files["scan"])
    sc = evaluation.ScanConfig.from_params(p)
    assert sc.shift_update and sc.track_cgn_error and sc.scan_variable == "m0"
    if variable == "m0":
        sc.track_cgn_error = False
    elif variable == "cgn error":         # a CGN solve takes ~10 s in the JAX package
        sc.end_val = sc.start_val
    else:
        sc = evaluation.ScanConfig(scan_variable="d0 setup iter", start_val=1, end_val=2,
                                   step_size=1)
    jsc = jevaluation.ScanConfig(**vars(sc))
    printed = []
    rows = evaluation.run_scan(p, sc, printer=printed.append, device="cpu")
    jrows = jevaluation.run_scan(jp, jsc, printer=printed.append)
    assert printed[0].splitlines()[:3] == printed[1].splitlines()[:3]
    assert len(rows) == len(jrows) == {"m0": 3, "d0 setup iter": 2, "cgn error": 1}[variable]
    for r, j in zip(rows, jrows):
        assert r.value == j.value and r.solve_iters == j.solve_iters, (r, j)
        assert r.relres < 1e-10
        if variable == "cgn error":
            assert r.error < 1e-9 and abs(r.error - j.error) < 1e-6
        else:
            assert np.isnan(r.error) and np.isnan(j.error)


# ---------------------------------------------------------------------------
# (e) cli
# ---------------------------------------------------------------------------

def _blocks(text):
    """The lines of the CLI's blocks, with every number replaced by #."""
    return [re.sub(r"\s+", " ", re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line))
            for line in text.splitlines() if line.startswith(("+-", "|"))]


def test_cli_modes_print_the_jax_blocks(same_tvs, files, capsys):
    argv = ["--benchmark", "2", "--rhs-batch", "2"]
    assert cli.main([files["ini"], "--device", "cpu", "--profile", *argv]) == 0
    profiling.PROF.enabled = False
    profiling.PROF.reset()
    out = capsys.readouterr().out
    assert jcli.main([files["ini"], "--benchmark", "1", "--rhs-batch", "2"]) == 0
    jout = capsys.readouterr().out
    ours = _blocks(out)
    want = _blocks(jout)
    assert ours[:len(want)] == want
    for line in ("multi-RHS: 2 solves (batched)", "(2/2 converged)", "benchmarking: 2 solves",
                 "avg solve time:", "min solve time:", "maximal device memory/MPI process:",
                 "| depth 0: fine_op (d_plus_clover)", "| depth 1: coarsest solve (OE-GCR)",
                 "| depth 0: FULL CYCLE"):
        assert line in out, line
    assert out.count("| kernel (per level)") == 2

    scan = files["scan"] + ".nocgn"
    open(scan, "w").write(open(files["scan"]).read().replace("compare with CGN error: 1",
                                                             "compare with CGN error: 0"))
    assert cli.main([scan, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\|\s+m0 \| setup\(s\) \| iters \| solve\(s\) \| coarse avg \|"
                     r"\s+relres \|$", out, re.M)
    assert len(re.findall(r"^\|\s+-0\.(5|49|48) \|", out, re.M)) == 3
