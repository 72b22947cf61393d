"""Flexible GCR (GMRES-equivalent) for the inner, K-cycle and coarsest solves.

GCR with an orthonormalized W = A Q basis produces the same minimal-residual
iterates as GMRES in exact arithmetic, is flexible (the reference's
fgcr_PRECISION, src/linsolve_generic.c:1032), and needs no Hessenberg or
Givens recurrences.  Semantics follow the JAX package's device_gcr
(ddalphaamg_tpu/solvers/device_gmres.py): each restart recomputes b - A x,
iterations stop early once ||r|| < tol ||b||, and with n_restarts > 1 every
restart still pays its initial residual apply.

The orthogonalization (the Krylov recurrence itself) runs in the field's own
dtype; TF32 must be off for it (utils.pin_full_precision), because rounded
coefficients floor the true residual an inner sweep can reach
(docs/iteration_parity.md).

On a sharded level every inner product and norm is a global sum over the
ranks (allsum, the stencil's all-reduce).  Every early-exit branch tests
an all-reduced number, which every rank receives bit for bit, so all ranks
take the same branches.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _prec_out(prec, r):
    """prec(r) -> (z, aux) with aux a float counter tensor or None."""
    if prec is None:
        return r, None
    out = prec(r)
    if isinstance(out, tuple):
        return out
    return out, None


def _dot(a, b, allsum):
    d = torch.vdot(a, b)
    return d if allsum is None else allsum(d)


def orthonormalize(W: torch.Tensor, Q: torch.Tensor, j: int, w: torch.Tensor,
                   q: torch.Tensor, allsum: Optional[Callable] = None):
    """Classical Gram-Schmidt of w against the first j rows of W, applied
    alike to q, then normalization by |w|; rows of W and Q are flattened
    fields (slabs, with allsum the sum over the ranks).  Returns (w, q)
    normalized."""
    if j:
        h = W[:j].conj() @ w
        if allsum is not None:
            h = allsum(h)
        w = w - h @ W[:j]
        q = q - h @ Q[:j]
    if allsum is None:
        wn = torch.linalg.vector_norm(w)
    else:
        wn = torch.sqrt(_dot(w, w, allsum).real)
    inv = 1.0 / torch.where(wn == 0, torch.ones_like(wn), wn)
    return w * inv, q * inv


def device_gcr(apply_op: Callable, b: torch.Tensor, m: int, tol: float,
               n_restarts: int = 1, prec: Optional[Callable] = None,
               x0: Optional[torch.Tensor] = None,
               allsum: Optional[Callable] = None):
    """Solve A x = b to ||r|| < tol ||b|| with restarted flexible GCR.

    prec(v) -> z or (z, aux): aux (a float tensor, e.g. coarse-work
    counters) is summed over the iterations and returned.  allsum sums a
    per-slab partial inner product over the ranks (None on one rank).
    Returns (x, iterations, final squared relative residual, aux sum).
    """
    shape = b.shape
    bf = b.reshape(-1)
    bnorm2 = float(_dot(bf, bf, allsum).real)
    bnorm2 = bnorm2 if bnorm2 != 0.0 else 1.0
    tol2 = float(tol) ** 2
    x = torch.zeros_like(bf) if x0 is None else x0.reshape(-1).clone()
    iters = 0
    aux_sum = None
    rn2 = bnorm2
    W = torch.empty((m, bf.numel()), dtype=b.dtype, device=b.device)
    Q = torch.empty_like(W)
    for _ in range(n_restarts):
        r = bf - apply_op(x.reshape(shape)).reshape(-1)
        rn2 = float(_dot(r, r, allsum).real)
        j = 0
        while j < m and rn2 >= tol2 * bnorm2:
            q, aux = _prec_out(prec, r.reshape(shape))
            w = apply_op(q).reshape(-1)
            w, q = orthonormalize(W, Q, j, w, q.reshape(-1), allsum)
            W[j] = w
            Q[j] = q
            alpha = _dot(w, r, allsum)
            x = x + alpha * q
            r = r - alpha * w
            rn2 = float(_dot(r, r, allsum).real)
            j += 1
            iters += 1
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
    return x.reshape(shape), iters, rn2 / bnorm2, aux_sum
