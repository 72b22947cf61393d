"""The reference against the port at 4^4 on the CPU, and what the
benchmark's own modules import."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from gpubench import field, harness, reference, traffic


@pytest.fixture(scope="module")
def tiny():
    from conftest import TINY_INI

    params = harness.solver_params({"ini": TINY_INI})
    U = field.rough_su3((4, 4, 4, 4), 0, 1.7867, 0.005, "cpu")
    return params, U


def test_reference_operator_matches_the_ports(tiny):
    from ddalphaamg_tpu_torch import api
    from ddalphaamg_tpu_torch.operators import fast

    params, U = tiny
    solver = api.Solver(params, device="cpu")
    solver.set_conf(U.numpy())
    x = torch.randn(3, 4, 4, 4, 4, 4, 3, dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(5))
    got = fast.spinor_from_soa(solver.apply_operator(fast.spinor_to_soa(x)), (4, 4, 4, 4))
    op = reference.WilsonClover(U, params.m0, params.csw, antiperiodic=True)
    want = op(x)
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    op64 = reference.WilsonClover(U, params.m0, params.csw, dtype=torch.complex64)
    assert float((op64(x.to(torch.complex64)) - want).abs().max()) < 1e-5 * float(
        want.abs().max())


def test_reference_relres_of_a_cpu_solve_is_solveinfos(tiny):
    from ddalphaamg_tpu_torch import api

    params, U = tiny
    solver = api.Solver(params, device="cpu")
    solver.set_conf(U.numpy())
    solver.setup()
    b = traffic.Traffic({"support": "lattice", "entries": "z4", "batch": 1,
                         "trace_requests": 1, "check_share": 1}, (4, 4, 4, 4)).request(7, 0)
    x, infos = solver.solve_multi(b)
    rel = reference.relres(reference.WilsonClover(U, params.m0, params.csw),
                           torch.as_tensor(x), torch.as_tensor(b))
    assert infos[0].converged
    assert abs(float(rel[0]) - infos[0].relres) <= 1e-3 * infos[0].relres


def test_field_is_su3_reproducible_and_near_its_plaquette():
    U = field.rough_su3((4, 4, 4, 4), 3, 1.7867, 0.005, "cpu")
    eye = torch.eye(3, dtype=U.dtype)
    assert float((U @ U.mH - eye).abs().max()) < 1e-13
    assert float((field.det3(U) - 1).abs().max()) < 1e-13
    assert abs(field.plaquette(U) - 1.7867) < 0.005
    assert torch.equal(U, field.rough_su3((4, 4, 4, 4), 3, 1.7867, 0.005, "cpu"))


def test_requests_are_drawn_again_alike_from_a_large_seed():
    lat = (4, 4, 4, 2)
    z4 = traffic.Traffic({"support": "lattice", "entries": "z4", "batch": 2,
                          "trace_requests": 1, "check_share": 0.3}, lat)
    seed = 2**31 + 12345
    a, b = z4.request(seed, 5), z4.request(seed, 5, reuse=True)
    assert a.shape == (2, *lat, 4, 3) and np.array_equal(a, b)
    assert np.allclose(np.abs(a), 1.0) and not np.array_equal(a, z4.request(seed, 6))
    assert np.array_equal(z4.request(seed, 6, reuse=True), z4.request(seed, 6))
    assert np.allclose(np.abs(a.real), np.sqrt(0.5)) and np.allclose(np.abs(a.imag), np.sqrt(0.5))
    assert z4.checked(seed, 0)
    share = np.mean([z4.checked(seed, i) for i in range(1, 2001)])
    assert 0.25 < share < 0.35
    ps = traffic.Traffic({"support": "site", "entries": "unit", "batch": 12,
                          "trace_requests": 1, "check_share": 1}, lat)
    for i in range(3):
        pts = ps.request(seed, i)
        assert np.array_equal(ps.request(seed, i, reuse=True), pts)
        assert pts.shape == (12, *lat, 4, 3) and pts.sum() == 12
        site = np.flatnonzero(pts[0].reshape(-1, 12).any(1))
        for j in range(12):
            assert pts[j].reshape(-1, 4, 3)[site[0], j // 3, j % 3] == 1


@pytest.mark.parametrize("support,entries", [("timeslice", "unit"), ("timeslice", "z4"),
                                              ("site", "z4"), ("lattice", "unit")])
def test_each_support_holds_its_entries_and_a_reused_buffer_forgets_the_last(support,
                                                                            entries):
    lat = (4, 2, 2, 2)
    t = traffic.Traffic({"support": support, "entries": entries, "batch": 3,
                         "trace_requests": 1, "check_share": 1}, lat)
    sites = {"lattice": 32, "timeslice": 8, "site": 1}[support]
    for i in range(6):
        x = t.request(11, i)
        assert np.array_equal(t.request(11, i, reuse=True), x)
        on = x.reshape(3, -1, 12).any(2).any(0)
        assert on.sum() == sites and np.array_equal(on, x[0].reshape(-1, 12).any(1))
        if support == "timeslice":
            assert on.reshape(lat)[np.flatnonzero(on)[0] // 8].all()
        v = x.reshape(3, -1, 12)[:, on]
        if entries == "z4":
            assert np.allclose(np.abs(v), 1.0)
        else:
            assert np.array_equal(v, np.broadcast_to(np.eye(12)[:3, None], v.shape))


SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import gpubench.{mod}
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "ddalphaamg_tpu", "ddalphaamg_tpu_torch", "chip_smoke", "bench")]
print(bad)
"""


@pytest.mark.parametrize("mod", ["reference", "field", "traffic", "roofline", "trace"])
def test_the_yardstick_loads_nothing_of_the_port_or_of_jax(mod):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(REPO), mod=mod)],
                         capture_output=True, text=True, check=True, cwd="/")
    assert out.stdout.strip() == "[]"


def test_banned_names_are_compared_whole(monkeypatch):
    import types

    for name in ("jaxlike", "ddalphaamg_tpu_torch_extra", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in harness.banned_modules() if m.startswith(("jaxlike", "ddalphaamg_tpu_t",
                                                                     "flaxen"))]
    monkeypatch.setitem(sys.modules, "ddalphaamg_tpu.api", types.ModuleType("x"))
    assert "ddalphaamg_tpu.api" in harness.banned_modules()


def test_no_file_of_the_benchmark_reads_the_jax_package_bench_or_chip_smoke():
    for f in (REPO / "gpubench").rglob("*.py"):
        if "tests" in f.parts:
            continue
        text = f.read_text()
        for word in ("import jax", "from jax", "import ddalphaamg_tpu\n", "from ddalphaamg_tpu ",
                     "from ddalphaamg_tpu.", "import ddalphaamg_tpu.", "chip_smoke",
                     "bench_assets", "import bench"):
            assert word not in text, (f, word)
