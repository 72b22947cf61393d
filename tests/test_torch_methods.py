"""The port's methods without multigrid against the JAX package's CPU path,
on a 4^4 rough field with the same numpy inputs:

  (a) whole solves of methods -1 (CGN), 0 (GMRES), 4 (odd-even GMRES
      preconditioner), 5 (BiCGstab preconditioner) and SAP alone (methods
      1, 2, 3 with interpolation 0): the host Krylov runs in complex128 on
      both sides, so the iterations are equal, both exact relres < tol and
      the solutions agree to 1e-8 relative; method 4 also with a
      complex64 preconditioner (mixed precision 1);
  (b) mixed precision 2 (fgmres_mp: complex64 Arnoldi): iterations within
      2 (complex64 inner products sum in another order), both < tol;
  (c) the modules: D^dagger against a dense <Dx, y> = <x, D^dagger y> and
      against the JAX package (1e-12), the odd-even pieces and their solve
      against the JAX package's oddeven.py (1e-12), fgcr, and fgmres with
      reorthogonalization and the exact residual recompute (restest),
      against the JAX package's (equal iterations, 1e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu.operators import oddeven as joddeven
from ddalphaamg_tpu.operators import wilson as jwilson
from ddalphaamg_tpu.solvers import fgmres as jfgmres     # the function
from ddalphaamg_tpu.solvers import krylov as jkrylov
from ddalphaamg_tpu_torch import api, config, convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.operators import fast, oddeven, wilson
from ddalphaamg_tpu_torch.operators.stencil import WilsonStencilSoA
from ddalphaamg_tpu_torch.solvers import fgmres, krylov

torch.set_num_threads(1)

LAT = (4, 4, 4, 4)
INI = """configuration: none
number of levels: 1
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: {method}
interpolation: 0
mixed precision: {mp}
"""


@pytest.fixture(scope="module")
def field():
    return rough_field(LAT, seed=11)


def _solve_pair(U, method, mp):
    text = INI.format(method=method, mp=mp)
    rhs = random_spinor((*LAT, 4, 3), seed=12)
    s = api.Solver(config.parse_ini(text), device="cpu")
    s.set_conf(U, links_have_bc=True)
    s.setup()
    x, info = s.solve(rhs)
    js = japi.Solver(jconfig.parse_ini(text))
    js.set_conf(U, links_have_bc=True)
    js.setup()
    jx, jinfo = js.solve(rhs)
    assert info.converged and jinfo.converged
    assert s.true_residual(x, rhs) < 1e-10 and js.true_residual(jx, rhs) < 1e-10
    assert rel_err(x, np.asarray(jx)) < 1e-8
    return info.iterations, jinfo.iterations


@pytest.mark.parametrize("method, mp", [(-1, 0), (0, 0), (4, 0), (4, 1), (5, 0),
                                        (1, 0), (2, 0), (3, 0)],
                         ids=["cgn", "gmres", "oddeven", "oddeven-c64", "bicgstab",
                              "sap-additive", "sap-red-black", "sap-16-colour"])
def test_whole_solve_matches_jax(field, method, mp):
    it, jit = _solve_pair(field, method, mp)
    assert it == jit, (it, jit)


def test_mixed_precision_2_matches_jax(field):
    it, jit = _solve_pair(field, 2, 2)
    assert abs(it - jit) <= 2, (it, jit)


def test_d_dagger_is_the_adjoint(field):
    lat = (2, 2, 2, 4)
    U = torch.as_tensor(rough_field(lat, seed=5))
    op = wilson.WilsonOperator.from_gauge(U, -0.5, 1.0)
    x, y = (torch.as_tensor(random_spinor((*lat, 4, 3), seed=k)) for k in (6, 7))
    lhs = torch.vdot(wilson.d_plus_clover(op, x).reshape(-1), y.reshape(-1))
    rhs = torch.vdot(x.reshape(-1), wilson.d_dagger(op, y).reshape(-1))
    assert abs(complex(lhs - rhs)) < 1e-12 * abs(complex(lhs))
    # the dense matrix of D^dagger is that of D, conjugated and transposed
    n = x.numel()
    eye = torch.eye(n, dtype=torch.complex128).reshape(n, *lat, 4, 3)
    D = torch.stack([wilson.d_plus_clover(op, e).reshape(-1) for e in eye], dim=1)
    Dd = torch.stack([wilson.d_dagger(op, e).reshape(-1) for e in eye], dim=1)
    assert float((Dd - D.conj().T).abs().max()) < 1e-12
    jop = jwilson.WilsonOperator.from_gauge(jnp.asarray(U.numpy()), -0.5, 1.0)
    want = np.asarray(jwilson.d_dagger(jop, jnp.asarray(y.numpy())))
    assert rel_err(wilson.d_dagger(op, y).numpy(), want) < 1e-12
    assert rel_err(wilson.g5_d_plus_clover(op, y).numpy(),
                   np.asarray(jwilson.g5_d_plus_clover(jop, jnp.asarray(y.numpy())))) < 1e-12
    # the fine stencil's dagger: K1 between two gamma5 multiplications
    s = WilsonStencilSoA.build(op, Geometry(lat, (2, 2, 2, 2)))
    got = fast.spinor_from_soa(s.dagger_op(convert.fields(y.numpy())), lat).numpy()
    assert rel_err(got, want) < 1e-12
    shifted = wilson.shift_diagonal(op, 0.25)
    assert rel_err((wilson.d_plus_clover(shifted, x) - wilson.d_plus_clover(op, x)).numpy(),
                   0.25 * x.numpy()) < 1e-14


def test_oddeven_pieces_match_jax(field):
    op = wilson.WilsonOperator.from_gauge(torch.as_tensor(field), -0.5, 1.0)
    oe = oddeven.OddEvenOperator(WilsonStencilSoA.build(op, Geometry(LAT, (2, 2, 2, 2))))
    joe = joddeven.OddEvenOperator.from_wilson(
        jwilson.WilsonOperator.from_gauge(jnp.asarray(field), -0.5, 1.0))
    v = random_spinor((*LAT, 4, 3), seed=13)
    vt = convert.fields(v)

    def log(a):
        return fast.spinor_from_soa(a, LAT).numpy()

    jv = jnp.asarray(v)
    pairs = {"schur": (oe.schur(oe.even * vt), joe.schur(joe.even * jv)),
             "hop_from_odd": (oe.hop_from_odd(vt), joe.hop_from_odd(jv)),
             "hop_from_even": (oe.hop_from_even(vt), joe.hop_from_even(jv)),
             "diag_oo_inv": (oe.diag_oo_inv(vt), joe.diag_oo_inv(jv))}
    for name, (got, want) in pairs.items():
        assert rel_err(log(got), np.asarray(want)) < 1e-12, name
    res = oddeven.solve_oddeven(oe, vt, tol=1e-11)
    jres = joddeven.solve_oddeven(joe, jv, tol=1e-11)
    assert res.iterations == jres.iterations
    r = vt - oe.full(res.x)
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(vt)) < 1e-10
    assert rel_err(log(res.x), np.asarray(jres.x)) < 1e-9


def test_fgcr_matches_jax(field):
    op = wilson.WilsonOperator.from_gauge(torch.as_tensor(field), -0.5, 1.0)
    s = WilsonStencilSoA.build(op, Geometry(LAT, (2, 2, 2, 2)))
    jop = jwilson.WilsonOperator.from_gauge(jnp.asarray(field), -0.5, 1.0)
    b = random_spinor((*LAT, 4, 3), seed=14)
    res = krylov.fgcr(s.full_op, convert.fields(b), tol=1e-10, restart_length=30)
    jres = jkrylov.fgcr(lambda v: jwilson.d_plus_clover(jop, v), jnp.asarray(b),
                        tol=1e-10, restart_length=30)
    assert res.converged and jres.converged and res.iterations == jres.iterations
    assert rel_err(fast.spinor_from_soa(res.x, LAT).numpy(), np.asarray(jres.x)) < 1e-8


def test_fgmres_options_match_jax(field):
    op = wilson.WilsonOperator.from_gauge(torch.as_tensor(field), -0.5, 1.0)
    s = WilsonStencilSoA.build(op, Geometry(LAT, (2, 2, 2, 2)))
    jop = jwilson.WilsonOperator.from_gauge(jnp.asarray(field), -0.5, 1.0)
    b = random_spinor((*LAT, 4, 3), seed=15)
    kw = dict(tol=1e-9, restart_length=20, max_restarts=30, reorthogonalize=True,
              restest=True)
    res = fgmres.fgmres(s.full_op, convert.fields(b), **kw)
    jres = jfgmres(lambda v: jwilson.d_plus_clover(jop, v), jnp.asarray(b), **kw)
    assert res.converged and jres.converged and res.iterations == jres.iterations
    assert res.relres_true == pytest.approx(jres.relres_true, rel=1e-6)
    assert res.relres_true < 1e-9
    assert rel_err(fast.spinor_from_soa(res.x, LAT).numpy(), np.asarray(jres.x)) < 1e-8
