"""Restarted flexible GMRES (FGMRES), right-preconditioned, driven from the
host: the non-multigrid methods' outer solver and method 4's inner solver.

Rebuild of the JAX package's solvers/fgmres.py, which rebuilds the
reference's fgmres_PRECISION (src/linsolve_generic.c:219-413) and fgmres_MP
(src/linsolve.c:153-314):

  * classical Gram-Schmidt Arnoldi: h = V^H w, w <- w - V^T h, in one of
    the JAX package's three forms (`single_reduce`, its fgmres.py:65-106,
    :227-250):
      False         h, then the norm of the orthogonalized w: two
                    all-reduces and two reads of the device a step;
      "fused"       h, the update and the exact norm with the two
                    all-reduces chained on the device and one read of
                    [h, |w|^2] together (iterations as with False);
      True / "pythagoras"  one all-reduce of [h, |w|^2] before the update
                    (the reference's SINGLE_ALLREDUCE_ARNOLDI,
                    src/linsolve_generic.c:668-738), the norm derived on
                    the host as |w|^2 - sum |h_i|^2, recomputed exactly
                    where that leaves at most 1e-4 |w|^2;
    fgmres_mp takes "fused" and runs every other value as False, as the
    JAX package's does;
  * Givens-rotation QR update of the Hessenberg matrix on the host in
    complex128 (qr_update_PRECISION, src/linsolve_generic.c:898-941);
  * convergence on |gamma_{j+1}| / ||r_0|| < tol, divergence at 1e5, happy
    breakdown at |H[j+1, j]| <= tol / 10;
  * the solution by back substitution over the preconditioned basis Z.

Vectors are tensors of any shape on any device (the port's dof-major
fields [12, V]); the operator and the preconditioner map that shape to
itself.  Each iteration reads the device twice (h and the norm), or once
with single_reduce: correct and slow, as a host-driven loop is.  With a
mesh (parallel/mesh.SolverMesh) the vectors are this rank's slabs and
every inner product is the global sum, one all-reduce each
(parallel/comm.all_reduce_sum: the same bits on every rank, so all ranks
take the same branches), as the JAX package's inner products on sharded
arrays are global.

h = V^H w is a product and a sum per basis vector (torch.linalg.vecdot),
never a matrix product: a batched complex64 matrix product over n = 12 *
16^4 carries relative errors of 1e-5 on the card, which spoil the
recurrence (the same trap as device_gmres.py's alpha).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel import comm


@dataclass
class FGMRESResult:
    x: object
    iterations: int
    relres: float
    converged: bool
    resvec: list = field(default_factory=list)   # relres estimate per iteration
    relres_true: float = -1.0    # the exact recompute of restest (FGMRES_RESTEST)


def _allsum(t, mesh):
    """t summed over the ranks of the mesh (t itself on one rank)."""
    return t if mesh is None else comm.all_reduce_sum(mesh, t)


def _norm(v, mesh=None) -> float:
    """The 2-norm of v (of the global field under a mesh)."""
    if mesh is None:
        return float(torch.linalg.vector_norm(v))
    f = v.reshape(1, -1)
    return math.sqrt(float(_allsum(torch.linalg.vecdot(f, f).real, mesh)[0]))


def _orthogonalize(V, j: int, w, mesh=None):
    """One classical Gram-Schmidt step of w [n] against the rows 0..j of V;
    returns (w_orth, h [j + 1] as complex128 numpy)."""
    h = _allsum(torch.linalg.vecdot(V[:j + 1], w), mesh)
    return w - h @ V[:j + 1], h.cpu().numpy().astype(np.complex128)


def _orthogonalize_fused(V, j: int, w, mesh=None):
    """The step of _orthogonalize with the exact norm of the result: h,
    the update and |w_orth|^2 queued on the device with their two
    all-reduces, then one read of [h, |w_orth|^2]; returns (w_orth, h as
    complex128 numpy, |w_orth|)."""
    h = _allsum(torch.linalg.vecdot(V[:j + 1], w), mesh)
    w = w - h @ V[:j + 1]
    n2 = _allsum(torch.linalg.vecdot(w, w).real.reshape(1), mesh)
    host = torch.cat([h, n2.to(h.dtype)]).cpu().numpy().astype(np.complex128)
    return w, host[:-1], math.sqrt(max(host[-1].real, 0.0))


def _orthogonalize_pythagoras(V, j: int, w, mesh=None):
    """The step of _orthogonalize with one all-reduce of [h, |w|^2] taken
    before the update and the norm of w_orth derived on the host from
    |w|^2 - sum |h_i|^2, recomputed exactly (a second reduction) where
    that leaves at most 1e-4 |w|^2 (the JAX package's guard); returns
    (w_orth, h as complex128 numpy, |w_orth|)."""
    hw = torch.cat([torch.linalg.vecdot(V[:j + 1], w),
                    torch.linalg.vecdot(w, w).real.reshape(1).to(w.dtype)])
    hw = _allsum(hw, mesh)
    host = hw.cpu().numpy().astype(np.complex128)
    h, wn2 = host[:-1], float(host[-1].real)
    w = w - hw[:-1] @ V[:j + 1]
    hn2 = wn2 - float(np.sum(np.abs(h) ** 2))
    return w, h, math.sqrt(hn2) if hn2 > 1e-4 * wn2 else _norm(w, mesh)


def _arnoldi_step(V, j: int, w, mesh, reorthogonalize: bool, single_reduce):
    """(w_orth, h as complex128 numpy, |w_orth|) of one Arnoldi step in the
    form single_reduce names (module note); reorthogonalization runs the
    two-reduce step twice, as in the JAX package."""
    if single_reduce == "fused" and not reorthogonalize:
        return _orthogonalize_fused(V, j, w, mesh)
    if single_reduce and not reorthogonalize:
        return _orthogonalize_pythagoras(V, j, w, mesh)
    w, h = _orthogonalize(V, j, w, mesh)
    if reorthogonalize:
        w, h2 = _orthogonalize(V, j, w, mesh)
        h = h + h2
    return w, h, _norm(w, mesh)


def _givens(H, cs, sn, gamma, j: int):
    """Apply the earlier rotations to column j of H, then make and apply
    the rotation that zeroes H[j + 1, j] (qr_update_PRECISION)."""
    for i in range(j):
        beta = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
        H[i, j] = np.conj(cs[i]) * H[i, j] + np.conj(sn[i]) * H[i + 1, j]
        H[i + 1, j] = beta
    beta = np.sqrt(abs(H[j, j]) ** 2 + abs(H[j + 1, j]) ** 2)
    if beta > 0:
        sn[j] = H[j + 1, j] / beta
        cs[j] = H[j, j] / beta
        gamma[j + 1] = -sn[j] * gamma[j]
        gamma[j] = np.conj(cs[j]) * gamma[j]
        H[j, j] = beta
        H[j + 1, j] = 0.0


def _back_substitute(H, gamma, j_used: int) -> np.ndarray:
    """y [j_used + 1] of the upper-triangular system H y = gamma."""
    y = np.zeros(j_used + 1, dtype=np.complex128)
    for i in range(j_used, -1, -1):
        y[i] = gamma[i]
        for k in range(i + 1, j_used + 1):
            y[i] -= H[i, k] * y[k]
        y[i] /= H[i, i]
    return y


def _restart_cycle(op_flat: Callable, prec_flat: Optional[Callable], r, gamma0: float,
                   norm_r0: float, m: int, dtype, tol: float, reorthogonalize: bool,
                   rotate_on_breakdown: bool, mesh=None, single_reduce=False):
    """One restart cycle: up to m Arnoldi steps from the residual r, with
    the basis V and the preconditioned basis Z in dtype, the Givens QR
    update of H on the host, and the correction by back substitution.  A
    happy breakdown stops before the pending rotations (fgmres) or after
    them (rotate_on_breakdown, fgmres_mp), as in the JAX package.  Returns
    (correction in dtype, iterations, |gamma_{j+1}| of the last step (0 at
    a happy breakdown), "converged" / "diverged" / None, relres estimates)."""
    n = r.numel()
    V = torch.zeros((m + 1, n), dtype=dtype, device=r.device)
    Z = torch.zeros_like(V[:m]) if prec_flat is not None else None
    V[0] = (r / gamma0).to(dtype)
    H = np.zeros((m + 1, m), dtype=np.complex128)
    cs = np.zeros(m, dtype=np.complex128)
    sn = np.zeros(m, dtype=np.complex128)
    gamma = np.zeros(m + 1, dtype=np.complex128)
    gamma[0] = gamma0
    resvec: list[float] = []
    status, gamma_jp1, j = None, 1.0, -1
    for j in range(m):
        if prec_flat is not None:
            Z[j] = prec_flat(V[j]).to(dtype)
            w = op_flat(Z[j])
        else:
            w = op_flat(V[j])
        w, h, hnorm = _arnoldi_step(V, j, w.to(dtype), mesh, reorthogonalize, single_reduce)
        H[:j + 1, j] = h
        H[j + 1, j] = hnorm
        if hnorm > 1e-15:
            V[j + 1] = w / hnorm
        # happy breakdown (reference src/linsolve_generic.c:336-341)
        happy = abs(H[j + 1, j]) <= tol / 10
        if happy and not rotate_on_breakdown:
            status, gamma_jp1 = "converged", 0.0
            break
        _givens(H, cs, sn, gamma, j)
        if happy:
            status, gamma_jp1 = "converged", 0.0
            break
        gamma_jp1 = abs(gamma[j + 1])
        rel = gamma_jp1 / norm_r0
        resvec.append(rel)
        if rel < tol:
            status = "converged"
            break
        if rel > 1e5:
            status = "diverged"
            break
    y = torch.as_tensor(_back_substitute(H, gamma, j), dtype=dtype, device=r.device)
    basis = Z if prec_flat is not None else V
    return y @ basis[:j + 1], j + 1, gamma_jp1, status, resvec


def _flat(fn: Optional[Callable], shape):
    """fn on [n] vectors through the fields' shape."""
    if fn is None:
        return None
    return lambda v: fn(v.reshape(shape)).reshape(-1)


def fgmres(apply_op: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
           preconditioner: Optional[Callable] = None, tol: float = 1e-10,
           restart_length: int = 50, max_restarts: int = 20,
           reorthogonalize: bool = False, restest: bool = False,
           mesh=None, single_reduce=False) -> FGMRESResult:
    """Solve apply_op(x) = b to relative residual tol (relative to the
    first restart's residual ||b - A x0||), in b's dtype.  The
    preconditioner may run in another precision; its output is cast to b's
    dtype, and the Krylov basis stays in b's dtype.  mesh, single_reduce
    (False, "fused", True or "pythagoras"): the module note."""
    shape = b.shape
    bf = b.reshape(-1)
    op_flat, prec_flat = _flat(apply_op, shape), _flat(preconditioner, shape)
    x = torch.zeros_like(bf) if x0 is None else x0.reshape(-1).to(bf.dtype).clone()
    norm_r0 = None
    resvec: list[float] = []
    total_iters = 0
    status = None
    gamma_jp1 = 1.0
    for ol in range(max_restarts):
        r = bf if (ol == 0 and x0 is None) else bf - op_flat(x)
        gamma0 = _norm(r, mesh)
        if norm_r0 is None:
            norm_r0 = gamma0
            if norm_r0 == 0.0:
                return FGMRESResult(x.reshape(shape), 0, 0.0, True, [])
        if gamma0 / norm_r0 < tol:
            status, gamma_jp1 = "converged", gamma0
            break
        dx, its, gamma_jp1, status, rv = _restart_cycle(
            op_flat, prec_flat, r, gamma0, norm_r0, restart_length, bf.dtype, tol,
            reorthogonalize, rotate_on_breakdown=False, mesh=mesh,
            single_reduce=single_reduce)
        total_iters += its
        resvec += rv
        x = x + dx
        if status is not None:
            break
    relres = float(gamma_jp1) / norm_r0 if norm_r0 else 0.0
    relres_true = -1.0
    if restest and norm_r0:
        relres_true = _norm(bf - op_flat(x), mesh) / norm_r0
    return FGMRESResult(x.reshape(shape), total_iters, relres, status == "converged",
                        resvec, relres_true=relres_true)


def fgmres_mp(apply_op: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
              preconditioner: Optional[Callable] = None, tol: float = 1e-10,
              restart_length: int = 10, max_restarts: int = 100,
              inner_dtype=torch.complex64, outer_dtype=torch.complex128,
              mesh=None, single_reduce=False) -> FGMRESResult:
    """Mixed-precision restarted FGMRES (reference fgmres_MP): the true
    residual, the solution and the Givens recurrences in outer_dtype (the
    latter on the host), the Arnoldi basis V, Z, the inner operator applies
    and the preconditioner in inner_dtype.  apply_op(v) must keep v's
    precision: it is called with outer_dtype vectors for the restart
    residual and inner_dtype vectors inside the Arnoldi loop.  A
    convergence seen by the inner estimate is verified by one more true
    residual.  mesh, single_reduce (only "fused" differs from False, as in
    the JAX package's fgmres_mp): the module note."""
    shape = b.shape
    bf = b.reshape(-1).to(outer_dtype)
    op_flat, prec_flat = _flat(apply_op, shape), _flat(preconditioner, shape)
    x = torch.zeros_like(bf) if x0 is None else x0.reshape(-1).to(outer_dtype).clone()
    norm_r0 = None
    resvec: list[float] = []
    total_iters = 0
    status = None
    relres = 1.0
    for ol in range(max_restarts):
        r = bf if (ol == 0 and x0 is None) else bf - op_flat(x)
        gamma0 = _norm(r, mesh)
        if norm_r0 is None:
            norm_r0 = gamma0
            if norm_r0 == 0.0:
                return FGMRESResult(x.reshape(shape), 0, 0.0, True, [])
        relres = gamma0 / norm_r0
        if relres < tol:
            status = "converged"
            break
        dx, its, _, status, rv = _restart_cycle(
            op_flat, prec_flat, r, gamma0, norm_r0, restart_length, inner_dtype, tol,
            False, rotate_on_breakdown=True, mesh=mesh,
            single_reduce="fused" if single_reduce == "fused" else False)
        total_iters += its
        resvec += rv
        x = x + dx.to(outer_dtype)
        if status == "diverged":
            break
        status = None           # re-verified by the true residual at the top
    if status is None and norm_r0:
        relres = _norm(bf - op_flat(x), mesh) / norm_r0
        status = "converged" if relres < tol else None
    return FGMRESResult(x.reshape(shape), total_iters, relres, status == "converged",
                        resvec)
