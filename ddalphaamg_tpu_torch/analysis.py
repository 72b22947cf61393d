"""Runtime diagnostics, mirroring the reference's DEBUG-build self-checks and
analysis flags (the JAX package's analysis.py), on the port's dof-major
fields [*, d, V]:

  * run_self_checks -- the reference `test_routine` (src/solver_analysis.c:25-53):
    P^H P = I, Galerkin consistency P^H D P = D_c and coarse
    gamma5-Hermiticity at every coarsening; each a residual that should be
    near the level's machine epsilon;
  * test_vector_analysis -- TESTVECTOR_ANALYSIS (src/setup_generic.c:506-529):
    Rayleigh quotients of the fine test vectors and their residuals;
  * smoother_reduction -- SCHWARZ_RES (doc/user_doc.tex:100-102): residual
    reduction of one preconditioner application;
  * coarse_reduction -- COARSE_RES: relative residual of one coarsest GCR
    solve.

Random vectors come from numpy's default_rng(seed) in the JAX package's
draw order and logical shapes.  Every function returns plain floats; under
a mesh every rank calls it (norms and inner products are global).
"""

from __future__ import annotations

import numpy as np
import torch


def _allsum(s, t):
    return t if s.allsum is None else s.allsum(t)


def _vdot(s, a, b):
    """<a, b> over the fields of stencil s's level, one per lane."""
    return _allsum(s, torch.linalg.vecdot(a.flatten(-2), b.flatten(-2)))


def _norm2(s, a):
    return _vdot(s, a, a).real


def _rnorm(s, a) -> float:
    return float(torch.sqrt(_norm2(s, a)))


def _coarse_gamma5(v):
    """gamma5 on coarse fields [*, 2N, V]: +1 on the first chirality, -1 on
    the second."""
    n = v.shape[-2] // 2
    return torch.cat([v[..., :n, :], -v[..., n:, :]], dim=-2)


def _random(rng, lvl, dtype):
    """A random field of a level, drawn as the JAX package draws it
    (logical [T, Z, Y, X, dof], real part then imaginary part of the whole
    field), as this rank's slab on the level's device."""
    s = lvl.stencil
    shape = (*lvl.geom.lattice, s.field_shape[0])
    v = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    t = s.from_logical(torch.as_tensor(v)[None])[0]
    return s.slab(t).to(device=s.device, dtype=dtype)


def run_self_checks(mg, seed: int = 0) -> dict:
    """Hierarchy invariants on random vectors, {check: residual} (reference
    coarse operator test_routine, src/coarse_operator_generic.c:417-559)."""
    rng = np.random.default_rng(seed)
    dtype = mg.cfg.dtype
    out = {}
    lvl = mg.fine
    while lvl is not None and not lvl.is_coarsest:
        nxt = lvl.next
        d = lvl.depth
        ns = nxt.stencil
        vc = _random(rng, nxt, dtype)
        vc2 = mg._restrict(lvl, mg._interpolate(lvl, vc))
        out[f"depth{d}: P^H P == I"] = _rnorm(ns, vc2 - vc) / _rnorm(ns, vc)

        lhs = ns.full_op(vc)
        rhs = mg._restrict(lvl, lvl.stencil.full_op(mg._interpolate(lvl, vc)))
        out[f"depth{d}: P^H D P == D_c"] = _rnorm(ns, lhs - rhs) / _rnorm(ns, lhs)

        # <y, g5 D x> == <g5 D y, x>
        yc = _random(rng, nxt, dtype)
        a = complex(_vdot(ns, yc, _coarse_gamma5(ns.full_op(vc))))
        b = complex(_vdot(ns, _coarse_gamma5(ns.full_op(yc)), vc))
        out[f"depth{d + 1}: g5_c D_c Hermiticity"] = abs(a - b) / max(abs(a), 1e-30)
        lvl = nxt
    return out


def test_vector_analysis(mg) -> list:
    """Per fine test vector v: (Rayleigh quotient rho = <v, D v> / <v, v>,
    ||D v - rho v|| / ||v||), all vectors in one batched apply (reference
    TESTVECTOR_ANALYSIS)."""
    s = mg.fine.stencil
    v = mg.fine.test_vectors
    dv = s.full_op(v)
    n2 = _norm2(s, v)
    rho = _vdot(s, v, dv) / n2
    res = torch.sqrt(_norm2(s, dv - rho[:, None, None] * v) / n2)
    return [(complex(r), float(e)) for r, e in zip(rho.tolist(), res.tolist())]


def smoother_reduction(solver, seed: int = 0) -> float:
    """||eta - D M(eta)|| / ||eta|| for one application of the solver's
    preconditioner M (SCHWARZ_RES analog), D the complex128 operator."""
    rng = np.random.default_rng(seed)
    shape = (*solver.lattice, 4, 3)
    eta = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    z = solver.apply_preconditioner(eta)
    dz = solver._gather(solver.apply_operator(solver._scatter(z)))
    return float(np.linalg.norm(eta - dz) / np.linalg.norm(eta))


def coarse_reduction(mg, seed: int = 0) -> float:
    """Relative residual of one coarsest-level GCR solve to the coarse
    tolerance (COARSE_RES analog; the GCR even where a dense inverse is
    stored, as in the JAX package), against the level's full-precision
    stencil."""
    lvl = mg.fine
    while not lvl.next.is_coarsest:
        lvl = lvl.next
    nxt = lvl.next
    rng = np.random.default_rng(seed)
    b = _random(rng, nxt, mg.cfg.dtype)[None]
    saved, nxt.dense_inv = nxt.dense_inv, None
    try:
        x, _ = mg._coarsest_solve(nxt, b)
    finally:
        nxt.dense_inv = saved
    s = nxt.stencil
    return _rnorm(s, b - s.full_op(x)) / _rnorm(s, b)
