"""The port's tracer (ddalphaamg_tpu_torch/profiling.py: PROF, its four
levels), on the CPU, driven from the host and as device programs through
the stand-in capture (tests/torch_graph_stub.py):

  (a) off: a setup, solves and preconditioner calls run no method of the
      tracer (every Profiler and marks' method refuses);
  (b) level 2: each solve_multi is one request whose spans nest as the
      call tree does, all with its id, with the counters of its replays,
      captures and host reads, and its launches; the setup is a request
      with its phases; an inner restart's replay is its row of table(),
      the host-driven one's cycles the preconditioner's;
  (c) level 3: the spans are torch.profiler ranges "ddaamg:<span>";
  (d) level 4: the marks' passes of every kernel family equal the
      request's launches (kernels.counts()), host-driven and replayed, the
      cycle's call sites are sections, a program captured at another level
      is captured again, and solutions and iterations keep their bits;
  (e) mark_split's arithmetic.

PROF.table()'s rows against the JAX package's: tests/test_torch_library.py
(the solve hooks) and tests/test_torch_setup_graph.py (the setup's phases).
"""

import numpy as np
import pytest
import torch

from torch_graph_stub import StubGraph
from torch_parity import random_spinor, rough_field

from ddalphaamg_tpu_torch import api, config, kernels, profiling
from ddalphaamg_tpu_torch.mg import hierarchy, programs
from ddalphaamg_tpu_torch.operators import cuda_coarse, cuda_dense, cuda_dslash, cuda_gcr

torch.set_num_threads(1)

INI = """configuration: none
number of levels: 3
d0 global lattice: 8 4 4 4
d0 test vectors: 4
d0 setup iter: 1
d1 test vectors: 4
d1 setup iter: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-5
iterations between restarts: 20
maximum of restarts: 20
method: 2
mixed precision: 2
"""
LAT = (8, 4, 4, 4)
PATHS = ("host", "programs")


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Every GCR driven from the host, or as device programs through the
    stand-in capture."""
    if request.param == "programs":
        monkeypatch.setattr(hierarchy, "GRAPH_DEVICES", ("cuda", "cpu"))
        monkeypatch.setattr(hierarchy, "GRAPH_CAPTURE", StubGraph)
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    return request.param


@pytest.fixture
def tracer():
    """PROF emptied; off and emptied after the test."""
    prof = profiling.PROF
    prof.reset()
    yield prof
    prof.set_level(profiling.OFF)
    prof.reset()


@pytest.fixture
def counting(monkeypatch):
    """The kernel wrappers count and close their launches on the CPU as on
    a card: kernels.launched before the plain version, kernels.check after
    it."""
    def count(fn, key_of):
        def wrapped(*args, **kwargs):
            key = key_of(*args)
            if key:
                kernels.launched(key)
            out = fn(*args, **kwargs)
            if key:
                kernels.check(0, key)
            return out
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


def _solver():
    s = api.Solver(config.parse_ini(INI), device="cpu")
    s.set_conf(rough_field(LAT, seed=41), links_have_bc=True)
    return s


def _rhs(B, seed):
    return random_spinor((B, *LAT, 4, 3), seed)


# ---------------------------------------------------------------------------
# (a) off
# ---------------------------------------------------------------------------

def test_no_tracer_method_runs_with_the_tracer_off(path, monkeypatch):
    tracer = profiling.PROF
    assert tracer.level == profiling.OFF and kernels.tracer is None
    assert not tracer.requests and not tracer.loose and not tracer.counters

    def refuse(*a, **k):
        raise AssertionError("a tracer method ran with the tracer off")

    for cls in (profiling.Profiler, profiling._Marks, profiling.Span):
        for name, val in list(vars(cls).items()):
            if name.startswith("__"):
                continue
            if isinstance(val, property):
                monkeypatch.setattr(cls, name, property(refuse, refuse))
            elif callable(val):
                monkeypatch.setattr(cls, name, refuse)
    monkeypatch.setattr(profiling, "mark_split", refuse)
    s = _solver()
    s.setup()
    xs, infos = s.solve_multi(_rhs(2, 42))
    assert all(i.converged for i in infos)
    s.mg(torch.as_tensor(_rhs(1, 43)).to(torch.complex64).reshape(1, 12, -1))
    assert (len(s.mg.programs) > 0) == (path == "programs")
    assert not tracer.requests and not tracer.loose and not tracer.counters


# ---------------------------------------------------------------------------
# (b) level 2: requests, spans, counters
# ---------------------------------------------------------------------------

def _ancestors(spans, sp):
    out = []
    while sp["parent"] >= 0:
        sp = spans[sp["parent"]]
        out.append(sp["name"])
    return out


def test_each_solve_multi_is_one_request_of_nested_spans(path, tracer):
    tracer.set_level(profiling.SPANS)
    s = _solver()
    s.setup()
    s.solve_multi(_rhs(2, 44))
    _, infos = s.solve_multi(_rhs(1, 45))
    rep = tracer.report()
    assert [r["kind"] for r in rep["requests"]] == ["setup", "solve_multi", "solve_multi"]
    assert [r["id"] for r in rep["requests"]] == [0, 1, 2] and not rep["spans"]
    assert [r["rhs"] for r in rep["requests"]][1:] == [2, 1]
    for rec in rep["requests"]:
        spans = rec["spans"]
        assert spans[0]["name"] == rec["kind"] and spans[0]["parent"] == -1
        for sp in spans:
            assert sp["request"] == rec["id"] and sp["start_ns"] <= sp["end_ns"]
            if sp["parent"] >= 0:
                up = spans[sp["parent"]]
                assert up["start_ns"] <= sp["start_ns"] and sp["end_ns"] <= up["end_ns"]
                assert up["kind"] != "read"
    setup, first, last = rep["requests"]
    assert {sp["name"] for sp in setup["spans"]} >= {
        "setup: initial tv smoothing", "setup: gram schmidt", "setup: tv cycles (F-cycle)",
        "setup: P/Galerkin rebuild"}
    names = [sp["name"] for sp in last["spans"]]
    assert {"scatter", "outer iteration", "residual", "read norms", "read counters",
            "read iterations", "gather"} <= set(names)
    assert names.count("outer iteration") == len(infos[0].resvec) > 1 and infos[0].converged
    spans = last["spans"]
    for sp in spans:
        if sp["name"] in ("residual", "read counters"):
            assert "outer iteration" in _ancestors(spans, sp)
        if sp["name"] in ("scatter", "gather", "read iterations"):
            assert _ancestors(spans, sp) == ["solve_multi"]
    reads = sum(sp["kind"] == "read" for sp in spans)
    replays = [sp for sp in spans if sp["kind"] == "replay"]
    assert last["counters"]["host reads"] == reads > 0
    if path == "programs":
        assert last["counters"]["replays"] == len(replays) == last["launches"]["G"] > 0
        assert {sp["name"] for sp in replays} == {"replay InnerRestartGraph"}
        assert all(sp["device_s"] > 0 and "outer iteration" in _ancestors(spans, sp)
                   for sp in replays)
        for rec in (first, last):           # batch 2, then 1: one capture each
            caps = [sp["name"] for sp in rec["spans"] if sp["kind"] == "capture"]
            assert caps == ["capture InnerRestartGraph"] and rec["counters"]["captures"] == 1
        assert rep["counters"]["peak pool bytes"] >= 0
    else:
        assert not replays and last["launches"]["G"] == 0
    assert rep["counters"]["host reads"] == sum(
        sum(sp["kind"] == "read" for sp in r["spans"]) for r in rep["requests"])
    rows = {key: e.count for key, e in tracer.entries.items()}
    restarts = sum(sp["name"] == "replay InnerRestartGraph"
                   for r in rep["requests"] for sp in r["spans"])
    assert rows.get((0, programs.InnerRestartGraph.row), 0) == restarts
    assert ((0, "preconditioner (v-cycle)") in rows) == (path == "host")


# ---------------------------------------------------------------------------
# (c) level 3: profiler ranges
# ---------------------------------------------------------------------------

def test_ranges_name_the_spans_for_the_profiler(tracer):
    s = _solver()
    s.setup()
    tracer.set_level(profiling.RANGES)
    # a loose tolerance: one inner iteration (the profiler records every op)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s.solve_multi(_rhs(1, 46), tol=0.9)
    ranges = {e.name for e in prof.events() if e.name.startswith(profiling.RANGE_PREFIX)}
    spans = {sp["name"] for sp in tracer.report()["requests"][0]["spans"]}
    assert ranges == {profiling.RANGE_PREFIX + n for n in spans}
    tracer.set_level(profiling.SPANS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s.solve_multi(_rhs(1, 46), tol=0.9)
    assert not any(e.name.startswith(profiling.RANGE_PREFIX) for e in prof.events())


# ---------------------------------------------------------------------------
# (d) level 4: marks
# ---------------------------------------------------------------------------

SITES = {"outer residual d0", "fine GCR d0", "restrict d0", "kcycle d1", "interpolate d0",
         "smoother d0", "kcycle d1/restrict d1", "kcycle d1/coarsest d2",
         "kcycle d1/interpolate d1", "kcycle d1/smoother d1"}


def test_marks_count_every_launch_and_keep_the_bits(path, tracer, counting):
    s = _solver()
    s.setup()
    rhs = _rhs(2, 47)
    x0, infos0 = s.solve_multi(rhs)            # off: unmarked programs
    unmarked = dict(s.mg.programs)
    tracer.set_level(profiling.MARKS, device="cpu")
    x1, infos1 = s.solve_multi(rhs)
    assert kernels.tracer is tracer
    np.testing.assert_array_equal(x1, x0)
    assert [i.iterations for i in infos1] == [i.iterations for i in infos0]
    if path == "programs":                    # captured again, with the marks
        assert set(s.mg.programs) == set(unmarked) and all(
            g.marked and g is not unmarked[k] for k, g in s.mg.programs.items())
    rep = tracer.report()
    (rec,) = rep["requests"]
    marks = rep["marks"]
    passes = {}
    for p, fam, n, ns in marks["rows"]:
        assert n > 0 and ns >= 0
        if fam != profiling.SECTION:
            passes[fam] = passes.get(fam, 0) + n
    launches = {k: n for k, n in rec["launches"].items() if n and k != "G"}
    assert passes == launches and {"K1", "K2", "K3", "K4", "K7"} <= set(passes)
    assert SITES <= set(marks["sections"]) and marks["cost_ns"] > 0
    assert marks["sections"]["kcycle d1"]["kernels"]["K4"] > 0
    tracer.set_level(profiling.OFF)
    assert kernels.tracer is None
    x2, _ = s.solve_multi(rhs)
    np.testing.assert_array_equal(x2, x0)
    assert all(not g.marked for g in s.mg.programs.values())


def test_marks_nest_and_skip_a_capture(tracer):
    """A section's rows nest by path; a kernel's row is under the sections
    open at its launch; a capture on the CPU runs no mark (as a CUDA
    capture runs nothing)."""
    tracer.set_level(profiling.MARKS, device="cpu")
    with profiling.site("outer", 0):
        kernels.launched("K1")
        kernels.check(0, "K1")
        with profiling.site("inner", 1):
            kernels.launched("K4")
            kernels.check(0, "K4")
    with tracer.span("capture X", kind="capture"):
        with profiling.site("outer", 0):
            kernels.launched("K1")
            kernels.check(0, "K1")
    rows = {(p, f): n for p, f, n, _ in tracer.report()["marks"]["rows"]}
    assert rows == {("outer d0", "section"): 1, ("outer d0", "K1"): 1,
                    ("outer d0/inner d1", "section"): 1, ("outer d0/inner d1", "K4"): 1}
    assert tracer.counters["captures"] == 1


# ---------------------------------------------------------------------------
# (e) mark_split
# ---------------------------------------------------------------------------

def test_mark_split_takes_each_bracket_and_its_transitions_out():
    """Marks m, transitions T, an empty section reads c = m + T: a kernel of
    d in a section reads m + 2T + d, the section 3m + 4T + d; the kernel is
    d + T, the section's torch time 0.  A second section with torch work t
    beside a kernel gets t."""
    m, T, d, t = 10.0, 100.0, 1000.0, 500.0
    c = m + T
    rows = [("a", "section", 1, 3 * m + 4 * T + d), ("a", "K4", 1, m + 2 * T + d),
            ("a/b", "section", 2, 2 * (3 * m + 4 * T + d + t)), ("a/b", "K2", 2, 2 * (m + 2 * T + d))]
    # a/b is inside a: a's own reading grows by a/b's brackets and their transitions
    rows[0] = ("a", "section", 1, rows[0][3] + rows[2][3] + 2 * c)
    got = profiling.mark_split(rows, c)
    assert got["families"] == {"K4": d + T, "K2": 2 * (d + T)}
    assert got["sections"]["a"]["torch_ns"] == pytest.approx(0.0)
    assert got["sections"]["a/b"]["torch_ns"] == pytest.approx(2 * t)
    assert got["sections"]["a/b"]["kernels"] == {"K2": 2 * (d + T)}
    assert got["torch_ns"] == pytest.approx(2 * t)
