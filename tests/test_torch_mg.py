"""Port multigrid vs the JAX package's default CPU path, both in complex128
(mixed precision 0) and with the same injected test vectors: the bootstrap
setup, one preconditioner cycle (1e-9) and the outer iteration count of the
mixed-precision restart loop (JAX Solver._solve_mp_device; equal counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu.mg.hierarchy import Multigrid as JMultigrid
from ddalphaamg_tpu_torch import api, config, convert
from ddalphaamg_tpu_torch.operators import fast

torch.set_num_threads(1)

INI = """configuration: none
number of levels: {levels}
d0 global lattice: {L} {L} {L} {L}
d0 block lattice: 2 2 2 2
d0 test vectors: {n}
d0 setup iter: {s0}
d1 test vectors: {n}
d1 setup iter: {s1}
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: 2
mixed precision: 0
"""


def _run_pair(L, levels, n, s0, s1, seed, extra=""):
    """The JAX package's Multigrid and the port's Solver on the same field
    and injected test vectors, set up from INI plus the ini lines extra."""
    text = INI.format(L=L, levels=levels, n=n, s0=s0, s1=s1) + extra
    lat = (L,) * 4
    U = rough_field(lat, seed=seed)
    tv0 = random_spinor((n, *lat, 4, 3), seed=seed + 1)
    tv1 = random_spinor((n, *(L // 2,) * 4, 2 * n), seed=seed + 2)

    jp = jconfig.parse_ini(text)
    js = japi.Solver(jp)
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
    return lat, js, jmg, s, mg


def _compare(lat, js, jmg, s, mg):
    eta = random_spinor((*lat, 4, 3), seed=99)
    want = np.asarray(jmg(jnp.asarray(eta)))
    got = fast.spinor_from_soa(mg(convert.fields(eta)), lat).numpy()
    assert rel_err(got, want) < 1e-9

    rhs = np.ones((*lat, 4, 3), np.complex128)
    jres = js._solve_mp_device(rhs, 1e-10)
    x, info = s.solve(rhs)
    assert info.converged and jres.converged
    assert info.iterations == jres.iterations
    assert s.true_residual(x, rhs) < 1e-10
    return info


def test_two_level_4x4_matches_jax():
    _compare(*_run_pair(L=4, levels=2, n=8, s0=2, s1=2, seed=21))


def test_three_level_8x8_matches_jax():
    info = _compare(*_run_pair(L=8, levels=3, n=4, s0=1, s1=1, seed=31))
    assert info.relres < 1e-10
