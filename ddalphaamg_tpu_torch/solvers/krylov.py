"""Other Krylov methods of the reference's solver suite, driven from the
host like fgmres.py (the JAX package's solvers/krylov.py):

  * cgn      -- CG on the normal equations D^H D x = D^H b (reference
                cgn_PRECISION, src/linsolve_generic.c:503-646; method -1);
  * bicgstab -- BiCGstab (reference bicgstab_PRECISION,
                src/linsolve_generic.c:416-501; method 5's preconditioner);
  * fgcr     -- flexible GCR (reference fgcr_PRECISION,
                src/linsolve_generic.c:1032-1106).

Vectors are tensors of any shape; each scalar is read to the host.  Inner
products are products and sums (torch.linalg.vecdot), never a complex64
matrix product (see fgmres.py).  With a mesh the vectors are slabs and
each inner product is one global all-reduce, as in fgmres.py.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .fgmres import FGMRESResult, _allsum, _norm


def _vdot(a, b, mesh=None) -> complex:
    """<a, b> = sum conj(a) b as a Python complex (over the global field
    under a mesh)."""
    if mesh is None:
        return complex(torch.linalg.vecdot(a.reshape(-1), b.reshape(-1)))
    return complex(_allsum(torch.linalg.vecdot(a.reshape(1, -1), b.reshape(1, -1)), mesh)[0])


def cgn(apply_op: Callable, apply_op_dagger: Callable, b: torch.Tensor,
        x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
        max_iter: int = 10000, mesh=None) -> FGMRESResult:
    """CG on the normal equations; stops on the recursively updated
    ||D x - b|| / ||b|| < tol.  mesh: the module note."""
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    r = b - apply_op(x) if x0 is not None else b
    norm_b = _norm(b, mesh)
    pr = apply_op_dagger(r)           # the residual of the normal equations
    p = pr
    rho = _norm(pr, mesh) ** 2
    resvec = []
    it = 0
    for it in range(1, max_iter + 1):
        Dp = apply_op(p)
        alpha = rho / _norm(Dp, mesh) ** 2
        x = x + alpha * p
        r = r - alpha * Dp
        rel = _norm(r, mesh) / norm_b
        resvec.append(rel)
        if rel < tol:
            return FGMRESResult(x, it, rel, True, resvec)
        pr = apply_op_dagger(r)
        rho_new = _norm(pr, mesh) ** 2
        beta = rho_new / rho
        rho = rho_new
        p = pr + beta * p
    return FGMRESResult(x, it, resvec[-1] if resvec else 1.0, False, resvec)


def bicgstab(apply_op: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
             tol: float = 1e-10, max_iter: int = 10000, mesh=None) -> FGMRESResult:
    """BiCGstab with the shadow residual r0 = r (the reference's variant);
    mesh: the module note."""
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    r = b - apply_op(x) if x0 is not None else b
    norm_b = _norm(b, mesh)
    r0 = r
    rho = alpha = omega = 1.0 + 0.0j
    v = p = torch.zeros_like(b)
    resvec = []
    it = 0
    for it in range(1, max_iter + 1):
        rho_new = _vdot(r0, r, mesh)
        if rho_new == 0.0:
            break
        beta = (rho_new / rho) * (alpha / omega)
        rho = rho_new
        p = r + beta * (p - omega * v)
        v = apply_op(p)
        alpha = rho / _vdot(r0, v, mesh)
        s = r - alpha * v
        t = apply_op(s)
        omega = _vdot(t, s, mesh) / _vdot(t, t, mesh)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rel = _norm(r, mesh) / norm_b
        resvec.append(rel)
        if rel < tol:
            return FGMRESResult(x, it, rel, True, resvec)
    return FGMRESResult(x, it, resvec[-1] if resvec else 1.0, False, resvec)


def fgcr(apply_op: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
         preconditioner: Optional[Callable] = None, tol: float = 1e-10,
         restart_length: int = 50, max_restarts: int = 20, mesh=None) -> FGMRESResult:
    """Flexible GCR with restarts, stopping on the true residual of each
    restart or the recursively updated one; mesh: the module note."""
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    norm_b = _norm(b, mesh)
    resvec = []
    total = 0
    for _ in range(max_restarts):
        r = b - apply_op(x)
        rel = _norm(r, mesh) / norm_b
        if rel < tol:
            return FGMRESResult(x, total, rel, True, resvec)
        P, DP = [], []
        for _j in range(restart_length):
            total += 1
            z = preconditioner(r) if preconditioner is not None else r
            w = apply_op(z)
            for pk, dpk in zip(P, DP):
                c = _vdot(dpk, w, mesh)
                z = z - c * pk
                w = w - c * dpk
            wn = _norm(w, mesh)
            if wn < 1e-15:
                break
            z, w = z / wn, w / wn
            P.append(z)
            DP.append(w)
            a = _vdot(w, r, mesh)
            x = x + a * z
            r = r - a * w
            rel = _norm(r, mesh) / norm_b
            resvec.append(rel)
            if rel < tol:
                return FGMRESResult(x, total, rel, True, resvec)
    return FGMRESResult(x, total, resvec[-1] if resvec else 1.0, False, resvec)
