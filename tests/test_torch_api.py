"""Port API end to end (Solver and cli on a 4^4 problem with the port's own
random test vectors) against the JAX package's default CPU path, plus the
port's guards: no JAX import, CPU tensors take the plain path without a
kernel launch, the solver never moves to the CPU behind a CUDA request,
TF32 is pinned off, the Krylov recurrence runs in the field's precision,
and chip_smoke.py refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_parity import rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu import io as jio
from ddalphaamg_tpu_torch import api, cli, config, kernels
from ddalphaamg_tpu_torch.operators import coarse, cuda_coarse, cuda_dense, cuda_dslash, cuda_gcr
from ddalphaamg_tpu_torch.solvers import device_gmres

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INI = """configuration: {conf}
number of levels: 2
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
d0 test vectors: 8
d0 setup iter: 2
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: 2
mixed precision: 0
"""


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    U = rough_field((4, 4, 4, 4), seed=41)
    U[0, -1] *= -1.0                      # the file holds the raw links
    conf = str(d / "conf4.bin")
    jio.write_gauge_field(conf, U, plaquette=0.0, anti_periodic=False)
    ini = d / "solve.ini"
    ini.write_text(INI.format(conf=conf))
    return str(ini)


def test_solver_end_to_end_matches_jax_default_path(problem, capsys):
    p = config.parse_ini(problem)
    s = api.Solver(p, device="cpu")
    plaq, _ = s.read_conf()
    s.setup()
    rhs = config.make_rhs("ones", s.lattice)
    x, info = s.solve(rhs)
    assert info.converged and s.true_residual(x, rhs) < 1e-10

    js = japi.Solver(jconfig.parse_ini(problem))
    jplaq, _ = js.read_conf()
    js.setup()
    _, jinfo = js.solve(rhs)
    assert abs(plaq - jplaq) < 1e-12
    assert abs(info.iterations - jinfo.iterations) <= 1, (info.iterations,
                                                          jinfo.iterations)

    assert cli.main([problem, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FGMRES iterations:" in out and "exact relative residual" in out


def test_import_leaves_jax_out():
    code = ("import sys, pkgutil, importlib, ddalphaamg_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ddalphaamg_tpu.'))\n"
            "       or m == 'ddalphaamg_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_cpu_tensors_take_the_plain_path():
    kernels.reset_counts()
    lat = (2, 2, 2, 4)
    V = 32
    links = torch.randn(4, 3, 3, V, dtype=torch.complex64)
    cdiag = torch.randn(2, 6, V)
    coff = torch.randn(2, 15, V, dtype=torch.complex64)
    phi = torch.randn(12, V, dtype=torch.complex64)
    cuda_dslash.d_plus_clover(links, cdiag, coff, phi, lat)
    cuda_dslash.hopping(links, phi, lat)
    cuda_dslash.clover(cdiag, coff, phi, lat, parity=1)
    blocks = torch.randn(9, 4, 4, V, dtype=torch.complex64)
    v = torch.randn(4, V, dtype=torch.complex64)
    cuda_coarse.coarse_apply(blocks, v, lat)
    face = torch.randn(4, V // lat[1], dtype=torch.complex64)
    cuda_coarse.coarse_apply_halo(blocks, v, lat, {1: (face, face)})
    cuda_coarse.coarse_apply(coarse.compress(blocks), v, lat)
    cuda_coarse.coarse_apply_halo(coarse.compress(blocks), v, lat, {1: (face, face)})
    cuda_coarse.schur_split(*coarse.split_blocks(blocks, blocks[:1], lat), v, lat)
    cuda_dense.matvec(coarse.compress(blocks[0, None, :, :, 0]), v[None, :, 0])
    W = torch.zeros(1, 3, 4 * V, dtype=torch.complex64)
    one = torch.ones(1)
    cuda_gcr.gcr_step(W, torch.zeros_like(W), torch.tensor(0), v.reshape(1, -1),
                      v.reshape(1, -1), torch.zeros(1, 4 * V, dtype=torch.complex64),
                      v.reshape(1, -1).clone(), None, torch.ones(1, dtype=torch.bool), one,
                      None, one.clone(), torch.zeros(1, dtype=torch.long))
    assert kernels.counts() == {k: 0 for k in kernels.KERNELS}
    assert set(kernels.KERNELS) == {"K1", "K2", "K3", "K4", "K5", "K4-bf16", "K5-bf16", "K4-schur",
                                    "K6", "K7", "K8", "G"}


def test_cuda_request_never_runs_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    s = api.Solver(config.parse_ini(INI.format(conf="none")), device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        s.set_conf(rough_field((4, 4, 4, 4)))


def test_precision_is_pinned():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    api.Solver(config.parse_ini(INI.format(conf="none")), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_gcr_recurrence_keeps_the_field_precision():
    rng = np.random.default_rng(5)
    n = 200
    A = torch.as_tensor(np.eye(n) * 3 + (rng.normal(size=(n, n))
                                         + 1j * rng.normal(size=(n, n))) / np.sqrt(n))
    b = torch.as_tensor(rng.normal(size=n) + 1j * rng.normal(size=n))
    # one lane: device_gcr takes a batch [B, n]
    x, it, rel2, _ = device_gmres.device_gcr(lambda v: v @ A.T, b[None], m=n, tol=1e-14)
    x = x[0]
    assert x.dtype == torch.complex128
    # an orthogonalization below complex128 floors the true residual near 1e-7
    assert float(torch.linalg.vector_norm(b - A @ x) / torch.linalg.vector_norm(b)) < 1e-13


def test_chip_smoke_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, cwd=tmp_path)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
