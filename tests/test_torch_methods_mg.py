"""Methods 1 (additive SAP) and 3 (sixteen-colour SAP) with a two-level
multigrid hierarchy against the JAX package, on a 4^4 rough field with the
same injected test vectors, complex128 (mixed precision 0): after one
bootstrap iteration the test vectors agree to 1e-9, and the outer loop (the
JAX package's restart loop Solver._solve_mp_device against the port's
Solver.solve) takes iterations within 1, both exact relres < tol, the
solutions within 1e-6.  Whole JAX multigrid solves stay under ~1 min per
method on the CPU with a cold XLA cache."""

import numpy as np
import pytest
import torch
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu.mg.hierarchy import Multigrid as JMultigrid
from ddalphaamg_tpu_torch import api, config
from ddalphaamg_tpu_torch.operators import fast

torch.set_num_threads(1)

LAT = (4, 4, 4, 4)
INI = """configuration: none
number of levels: 2
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
d0 test vectors: 8
d0 setup iter: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: {method}
interpolation: 2
mixed precision: 0
"""


@pytest.mark.parametrize("method", [1, 3], ids=["additive", "sixteen-colour"])
def test_multigrid_method_matches_jax(method):
    text = INI.format(method=method)
    U = rough_field(LAT, seed=11)
    tv0 = random_spinor((8, *LAT, 4, 3), seed=12)
    rhs = np.ones((*LAT, 4, 3), np.complex128)

    js = japi.Solver(jconfig.parse_ini(text))
    js.set_conf(U, links_have_bc=True)
    jmg = JMultigrid(js.op, js._mg_config())
    js.mg = js.preconditioner = jmg
    jmg.set_test_vectors(tv0)
    jmg.bootstrap_setup()
    jres = js._solve_mp_device(rhs, 1e-10)

    p = config.parse_ini(text)
    p.inner_tol_clip = 1e-7       # the clip of _solve_mp_device
    s = api.Solver(p, device="cpu")
    s.set_conf(U, links_have_bc=True)
    mg = s.build_hierarchy()
    assert mg.cfg.scheme == {1: "additive", 3: "sixteen_color"}[method]
    assert len(mg.fine.smoother.colors) == {1: 1, 3: 16}[method]
    mg.set_test_vectors(tv0)
    mg.bootstrap_setup()
    x, info = s.solve(rhs)

    tvs = fast.spinor_from_soa(mg.fine.test_vectors, LAT).numpy()
    assert rel_err(tvs, np.asarray(jmg.fine.test_vectors)) < 1e-9
    assert info.converged and jres.converged
    assert abs(info.iterations - jres.iterations) <= 1, (info.iterations, jres.iterations)
    assert s.true_residual(x, rhs) < 1e-10 and js.true_residual(jres.x, rhs) < 1e-10
    assert rel_err(x, np.asarray(jres.x)) < 1e-6
