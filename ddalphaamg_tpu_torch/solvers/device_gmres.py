"""Flexible GCR (GMRES-equivalent) for the inner, K-cycle and coarsest solves,
over a batch of independent right-hand sides ("lanes").

GCR with an orthonormalized W = A Q basis produces the same minimal-residual
iterates as GMRES in exact arithmetic, is flexible (the reference's
fgcr_PRECISION, src/linsolve_generic.c:1032), and needs no Hessenberg or
Givens recurrences.  Semantics follow the JAX package's device_gcr
(ddalphaamg_tpu/solvers/device_gmres.py) under jax.vmap: each lane stops on
its own once ||r|| < tol ||b||, each restart recomputes b - A x for every
lane, and with n_restarts > 1 every restart still pays its initial residual
apply.  A single right-hand side is batch 1.

A lane that has converged, has done m iterations in this restart or is
masked off by `active` is frozen: its x, r, iteration count and aux sum no
longer change (torch.where), as the vmapped while_loop computes every lane
and selects.  A frozen lane enters the preconditioner and the operator as
zeros, so it makes no NaN, and nested solves see a zero right-hand side
there and freeze the lane at once.  All state (norms, counts, aux sums)
stays on the device; the loop reads the device once per iteration, through
lanes_go_on.

The orthogonalization (the Krylov recurrence itself) runs in the field's own
dtype; TF32 must be off for it (utils.pin_full_precision), because rounded
coefficients floor the true residual an inner sweep can reach
(docs/iteration_parity.md).

On a sharded level every inner product and norm is a global sum over the
ranks (allsum, the stencil's all-reduce), one all-reduce for the [B] or
[B, j] numbers of all lanes.  The stop flag is computed from all-reduced
numbers only, which every rank receives bit for bit, so all ranks take the
same branches.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def lanes_go_on(go: torch.Tensor) -> int:
    """How many lanes go on (0: none): the loop's one read of the device
    per iteration."""
    return int(go.sum())


def _prec_out(prec, r):
    """prec(r) -> (z, aux) with aux a [B, k] counter tensor or None."""
    if prec is None:
        return r, None
    out = prec(r)
    if isinstance(out, tuple):
        return out
    return out, None


def _norm(a, allsum):
    """|a_i| of every lane i of flattened [B, n] fields (over all ranks)."""
    if allsum is None:
        return torch.linalg.vector_norm(a, dim=-1)
    return torch.sqrt(allsum(torch.linalg.vector_norm(a, dim=-1) ** 2))


def orthonormalize(W: torch.Tensor, Q: torch.Tensor, j: int, w: torch.Tensor,
                   q: torch.Tensor, allsum: Optional[Callable] = None):
    """Classical Gram-Schmidt of each lane's w [B, n] against the first j
    rows of its W [B, m, n], applied alike to q, then normalization by |w|
    (a zero w stays zero); rows are flattened fields (slabs, with allsum
    the sum over the ranks).  The results are written to row j of W and Q;
    returns them (views)."""
    if j:
        h = W[:, :j].conj() @ w.unsqueeze(-1)                  # [B, j, 1]: <W_i, w>
        if allsum is not None:
            h = allsum(h)
        h = h.transpose(-1, -2)
        w = w - (h @ W[:, :j]).squeeze(1)
        q = q - (h @ Q[:, :j]).squeeze(1)
    wn = _norm(w, allsum)
    inv = wn.masked_fill(wn == 0, 1.0).reciprocal()[:, None]
    torch.mul(w, inv, out=W[:, j])
    torch.mul(q, inv, out=Q[:, j])
    return W[:, j], Q[:, j]


def device_gcr(apply_op: Callable, b: torch.Tensor, m: int, tol,
               n_restarts: int = 1, prec: Optional[Callable] = None,
               x0: Optional[torch.Tensor] = None,
               allsum: Optional[Callable] = None,
               active: Optional[torch.Tensor] = None):
    """Solve A x_i = b_i for every lane of b [B, *shape] to
    ||r_i|| < tol_i ||b_i|| with restarted flexible GCR.

    apply_op and prec take and return [B, *shape]; prec(v) -> z or
    (z, aux) with aux a [B, k] float tensor (e.g. coarse-work counters),
    summed over each lane's iterations.  tol is a float or a [B] tensor;
    active [B] (bool) masks off lanes that must not iterate.  allsum sums
    a per-slab partial sum over the ranks (None on one rank).  Returns
    (x [B, *shape], iterations [B], final squared relative residual [B],
    aux sum [B, k] or None), all on b's device.
    """
    shape = b.shape
    B = shape[0]
    bf = b.reshape(B, -1)
    bnorm = _norm(bf, allsum)
    bnorm = bnorm.masked_fill(bnorm == 0, 1.0)
    if isinstance(tol, torch.Tensor):
        stop = tol.to(bnorm) * bnorm
    else:
        stop = float(tol) * bnorm
    x = torch.zeros_like(bf) if x0 is None else x0.reshape(B, -1).clone()
    steps = []          # the go mask of every iteration: summed into the counts
    aux_sum = None
    rn = bnorm
    # row j of every lane is written at iteration j before any read of it
    W = torch.empty((B, m, bf.shape[1]), dtype=b.dtype, device=b.device)
    Q = torch.empty_like(W)
    for _ in range(n_restarts):
        r = bf - apply_op(x.reshape(shape)).reshape(B, -1)
        rn = _norm(r, allsum)
        go = rn >= stop
        if active is not None:
            go = go & active
        for j in range(m):
            going = lanes_go_on(go)
            if not going:
                break
            # a frozen lane enters as zeros: its alpha is 0, so its x and r
            # keep their bits, and a nested solve freezes it at once
            gcol = None if going == B else go[:, None]
            r_in = r if gcol is None else torch.where(gcol, r, 0)
            q, aux = _prec_out(prec, r_in.reshape(shape))
            w = apply_op(q).reshape(B, -1)
            w, q = orthonormalize(W, Q, j, w, q.reshape(B, -1), allsum)
            # <w, r> as a product and a sum: a batched complex64 matrix
            # product [1, n] @ [n, 1] carries relative errors of 1e-5 at
            # n = 12 * 16^4 on the card, which let the residual recurrence
            # drift from the true residual
            alpha = torch.linalg.vecdot(w, r_in)[:, None]
            if allsum is not None:
                alpha = allsum(alpha)
            x += alpha * q
            r -= alpha * w
            steps.append(go)
            if aux is not None:
                aux = aux if gcol is None else torch.where(gcol, aux, 0)
                aux_sum = aux if aux_sum is None else aux_sum + aux
            rn = _norm(r, allsum)
            go = rn >= stop         # a frozen lane keeps its |r|, hence stays frozen
            if active is not None:
                go = go & active
    iters = (torch.stack(steps).sum(dim=0) if steps else torch.zeros(B, dtype=torch.long,
                                                                         device=b.device))
    return x.reshape(shape), iters.to(bnorm.dtype), (rn / bnorm) ** 2, aux_sum
