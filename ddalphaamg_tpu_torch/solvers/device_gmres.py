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
stays on the device (GCRLanes, updated in place).

Two drivers share GCRLanes' restart and step.  device_gcr is the host loop:
it reads the device once per iteration, through lanes_go_on, and serves
every GCR with a preconditioner (the K-cycle, the fine inner restart), every
solve on the CPU and every solve on a process grid.  gcr_program (no
preconditioner) hands its loops to a control object: HostControl decides
them on the host (its plain version), a CudaGraph captures them into one
CUDA graph with WHILE and IF nodes (solvers/cuda_graph.py), which the
coarsest solve of one rank on a card replays (mg/coarsest.py).

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


class GCRLanes:
    """The state of one restarted GCR solve of a batch of lanes b [B, *shape]:
    flattened fields x, r, the bases W and Q [B, m, n], the norms, the go
    mask and the iteration counts.  Made once; every later update is in
    place (restart, step), so that a device program whose conditional
    bodies are skipped leaves the state as the host loop leaves it
    (solvers/cuda_graph.py)."""

    def __init__(self, b: torch.Tensor, m: int, tol, x0=None,
                 allsum: Optional[Callable] = None, active: Optional[torch.Tensor] = None):
        self.shape = b.shape
        B = self.B = b.shape[0]
        self.allsum, self.active = allsum, active
        self.bf = b.reshape(B, -1)
        bnorm = _norm(self.bf, allsum)
        self.bnorm = bnorm.masked_fill(bnorm == 0, 1.0)
        if isinstance(tol, torch.Tensor):
            self.stop = tol.to(self.bnorm) * self.bnorm
        else:
            self.stop = float(tol) * self.bnorm
        self.x = torch.zeros_like(self.bf) if x0 is None else x0.reshape(B, -1).clone()
        self.r = torch.empty_like(self.bf)
        self.rn = self.bnorm.clone()
        self.go = torch.zeros(B, dtype=torch.bool, device=b.device)
        self.iters = torch.zeros(B, dtype=torch.long, device=b.device)
        self.aux_sum = None
        # row j of every lane is written at iteration j before any read of it
        self.W = torch.empty((B, m, self.bf.shape[1]), dtype=b.dtype, device=b.device)
        self.Q = torch.empty_like(self.W)

    def _stop_test(self):
        """go = |r| >= tol |b| (and active): a frozen lane keeps its |r|,
        hence stays frozen."""
        torch.ge(self.rn, self.stop, out=self.go)
        if self.active is not None:
            self.go &= self.active

    def restart(self, apply_op: Callable):
        """r = b - A x for every lane, its norm and the go mask."""
        torch.sub(self.bf, apply_op(self.x.reshape(self.shape)).reshape(self.B, -1),
                  out=self.r)
        self.rn.copy_(_norm(self.r, self.allsum))
        self._stop_test()

    def step(self, j: int, apply_op: Callable, prec: Optional[Callable] = None,
             masked: bool = True):
        """Iteration j of a restart for the lanes that go; masked=False
        takes every lane as going (the host loop, when all go)."""
        B = self.B
        # a frozen lane enters as zeros: its alpha is 0, so its x and r keep
        # their bits, and a nested solve freezes it at once
        gcol = self.go[:, None] if masked else None
        r_in = self.r if gcol is None else torch.where(gcol, self.r, 0)
        q, aux = _prec_out(prec, r_in.reshape(self.shape))
        w = apply_op(q).reshape(B, -1)
        w, q = orthonormalize(self.W, self.Q, j, w, q.reshape(B, -1), self.allsum)
        # <w, r> as a product and a sum: a batched complex64 matrix
        # product [1, n] @ [n, 1] carries relative errors of 1e-5 at
        # n = 12 * 16^4 on the card, which let the residual recurrence
        # drift from the true residual
        alpha = torch.linalg.vecdot(w, r_in)[:, None]
        if self.allsum is not None:
            alpha = self.allsum(alpha)
        self.x += alpha * q
        self.r -= alpha * w
        self.iters += self.go
        if aux is not None:
            aux = aux if gcol is None else torch.where(gcol, aux, 0)
            self.aux_sum = aux if self.aux_sum is None else self.aux_sum + aux
        self.rn.copy_(_norm(self.r, self.allsum))
        self._stop_test()

    def result(self):
        """(x [B, *shape], iterations [B], final squared relative residual
        [B], aux sum [B, k] or None)."""
        return (self.x.reshape(self.shape), self.iters.to(self.bnorm.dtype),
                (self.rn / self.bnorm) ** 2, self.aux_sum)


def device_gcr(apply_op: Callable, b: torch.Tensor, m: int, tol,
               n_restarts: int = 1, prec: Optional[Callable] = None,
               x0: Optional[torch.Tensor] = None,
               allsum: Optional[Callable] = None,
               active: Optional[torch.Tensor] = None):
    """Solve A x_i = b_i for every lane of b [B, *shape] to
    ||r_i|| < tol_i ||b_i|| with restarted flexible GCR, driven by the
    host (one read of the device per iteration).

    apply_op and prec take and return [B, *shape]; prec(v) -> z or
    (z, aux) with aux a [B, k] float tensor (e.g. coarse-work counters),
    summed over each lane's iterations.  tol is a float or a [B] tensor;
    active [B] (bool) masks off lanes that must not iterate.  allsum sums
    a per-slab partial sum over the ranks (None on one rank).  Returns
    (x [B, *shape], iterations [B], final squared relative residual [B],
    aux sum [B, k] or None), all on b's device.
    """
    st = GCRLanes(b, m, tol, x0, allsum, active)
    for _ in range(n_restarts):
        st.restart(apply_op)
        for j in range(m):
            going = lanes_go_on(st.go)
            if not going:
                break
            st.step(j, apply_op, prec, masked=going != st.B)
    return st.result()


def gcr_program(ctl, apply_op: Callable, b: torch.Tensor, m: int, tol,
                n_restarts: int = 1, trips: Optional[torch.Tensor] = None,
                allsum: Optional[Callable] = None, active: Optional[torch.Tensor] = None):
    """device_gcr without a preconditioner, its control flow given to ctl
    (solvers/cuda_graph.py): the restarts a loop (ctl.repeat), each
    restart's iterations a chain that stops once no lane goes (ctl.chain),
    the same restart and step as the host loop.  Every iteration masks the
    frozen lanes (B > 1), which gives the host loop's bits: a lane that
    goes enters as itself.  trips (a device int64 scalar), if given, counts
    the iterations run.  Returns device_gcr's tuple."""
    st = GCRLanes(b, m, tol, None, allsum, active)

    def iteration(j):
        st.step(j, apply_op, masked=st.B > 1)
        if trips is not None:
            trips.add_(1)

    def restart():
        st.restart(apply_op)
        ctl.chain(m, lambda: st.go.any(), iteration)

    ctl.repeat(n_restarts, restart)
    return st.result()
