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

gcr_program hands its loops to a control object: HostControl decides them
on the host, with one read of the device per iteration (lanes_go_on;
device_gcr is gcr_program under it, the host loop), a CudaGraph captures
them into one CUDA graph, one WHILE node a loop with a device-side
iteration index (solvers/cuda_graph.py).  On a card the fine inner
restart, the cycle and the coarsest solve run as such graphs
(mg/programs.py, mg/coarsest.py; on a grid where Multigrid.uses_graphs
says so), the K-cycle's and the coarsest GCR nested in them.

The orthogonalization (the Krylov recurrence itself) runs in the field's own
dtype; TF32 must be off for it (utils.pin_full_precision), because rounded
coefficients floor the true residual an inner sweep can reach
(docs/iteration_parity.md).  On one rank K7 computes the whole iteration
after the operator apply (operators/cuda_gcr.py: the Gram-Schmidt with the
row index j on the device, reading only the rows below j, alpha, the x / r
updates, the norm and the stop test), in the same summation order for the
host loop and a replay; its plain version is the torch sequence a slab
runs.

On a sharded level every inner product and norm is a global sum over the
ranks (allsum, the stencil's all-reduce), one all-reduce for the [B] or
[B, m] numbers of all lanes (the Gram-Schmidt over all m rows, those from
j on weighted by zero, so that a device program with the collectives
inside, K8's on nccl, gives the host loop's bits).  The stop flag is computed
from all-reduced numbers only, which every rank receives bit for bit, so
all ranks take the same branches, in a host loop and in a replay.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch

from ..operators import cuda_gcr
from ..operators.cuda_gcr import lane_norm
from ..profiling import site as marked_site

COUNTER_DTYPE = torch.float64   # the cycles' [B, 3] coarse-work counters


def lanes_go_on(go: torch.Tensor) -> int:
    """How many lanes go on (0: none): the host loop's one read of the
    device per iteration."""
    return int(go.sum())


class HostControl:
    """The plain version of a device program's control flow
    (solvers/cuda_graph.py): every loop predicate is read on the host
    (lanes_go_on), j is a Python int."""

    def loop(self, m: int, pred, body):
        """body(j) for j = 0, 1, ... while j < m and (pred None or) some
        element of pred() holds."""
        for j in range(m):
            if pred is not None and not lanes_go_on(pred()):
                return
            body(j)


def _prec_out(prec, r):
    """prec(r) -> (z, aux) with aux a [B, k] counter tensor or None."""
    if prec is None:
        return r, None
    out = prec(r)
    if isinstance(out, tuple):
        return out
    return out, None


def orthonormalize(W: torch.Tensor, Q: torch.Tensor, j: torch.Tensor, w: torch.Tensor,
                   q: torch.Tensor, allsum: Callable):
    """Classical Gram-Schmidt of each lane's w [B, n] against the rows of
    its W [B, m, n] below j on a slab (allsum: the sum over the ranks),
    applied alike to q, then normalization by |w| (a zero w stays zero);
    the results are written to row j of W and Q and returned.  j is a
    device int64 scalar (a graph loop's index, or the host loop's row from
    a table): the products run over all m rows, those from j on weighted by
    zero, so that a replay and the host loop give the same bits, with one
    all-reduce of h [B, m]."""
    keep = torch.arange(W.shape[1], device=W.device) < j
    h = allsum((W.conj() @ w.unsqueeze(-1)).squeeze(-1))        # [B, m]: <W_i, w>
    h = torch.where(keep, h, 0).unsqueeze(1)
    w = w - (h @ W).squeeze(1)
    q = q - (h @ Q).squeeze(1)
    wn = lane_norm(w, allsum)
    inv = wn.masked_fill(wn == 0, 1.0).reciprocal()[:, None]
    w, q = w * inv, q * inv
    row = j.reshape(1)
    W.index_copy_(1, row, w.unsqueeze(1))
    Q.index_copy_(1, row, q.unsqueeze(1))
    return w, q


class GCRLanes:
    """The state of one restarted GCR solve of a batch of lanes b [B, *shape]:
    flattened fields x, r, the bases W and Q [B, m, n] (zeros at first),
    the norms, the go mask, the iteration counts and, with n_aux, the sum
    of the preconditioner's [B, n_aux] counters.  Made once; every later
    update is in place (restart, step), so that a device program whose
    loop bodies run again on the same memory, or not at all, leaves the
    state as the host loop leaves it (solvers/cuda_graph.py)."""

    def __init__(self, b: torch.Tensor, m: int, tol, x0=None,
                 allsum: Optional[Callable] = None, active: Optional[torch.Tensor] = None,
                 n_aux: int = 0):
        self.shape = b.shape
        B = self.B = b.shape[0]
        self.allsum, self.active = allsum, active
        self.bf = b.reshape(B, -1)
        bnorm = lane_norm(self.bf, allsum)
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
        self.aux_sum = (torch.zeros((B, n_aux), dtype=COUNTER_DTYPE, device=b.device)
                        if n_aux else None)
        # what a frozen lane's aux becomes at B > 1 (a tensor: torch.where
        # would fill a Python 0 into a device scalar at every step)
        self._no_aux = torch.zeros((), dtype=COUNTER_DTYPE, device=b.device) if B > 1 else None
        # row j of every lane is written at iteration j; K7 reads no row from
        # j on, its plain version multiplies them by a zero h (zeros here:
        # fresh memory could hold a NaN, and 0 * NaN is NaN)
        self.W = torch.zeros((B, m, self.bf.shape[1]), dtype=b.dtype, device=b.device)
        self.Q = torch.zeros_like(self.W)
        # the preconditioner's input at B > 1: r masked by go (a frozen lane
        # enters as zeros), set by the restart and by every step
        self.rz = torch.zeros_like(self.bf) if B > 1 else None
        self.work = (cuda_gcr.scratch(B, m, self.bf.shape[1], b.dtype, b.device)
                     if allsum is None else None)
        self._rows = None       # the row indices on the device, for a host j

    def _stop_test(self):
        """go = |r| >= tol |b| (and active): a frozen lane keeps its |r|,
        hence stays frozen; at B > 1 rz = go ? r : 0."""
        cuda_gcr.stop_test(self.rn, self.stop, self.active, self.go, self.r, self.rz)

    def _row(self, j):
        """Row j as the step takes it: a device index (a host j through a
        table made at the first host step)."""
        if isinstance(j, torch.Tensor):
            return j
        if self._rows is None:
            self._rows = torch.arange(self.W.shape[1], device=self.W.device)
        return self._rows[j]

    def restart(self, apply_op: Callable):
        """r = b - A x for every lane, its norm and the go mask."""
        torch.sub(self.bf, apply_op(self.x.reshape(self.shape)).reshape(self.B, -1),
                  out=self.r)
        self.rn.copy_(lane_norm(self.r, self.allsum))
        self._stop_test()

    def step(self, j, apply_op: Callable, prec: Optional[Callable] = None,
             section=contextlib.nullcontext):
        """Iteration j (a Python int, or a device int64 scalar in a graph's
        loop) of a restart for the lanes that go: on one rank the operator
        apply, then K7 (the rest of the iteration, operators/cuda_gcr.py),
        on a slab the same in torch with all-reduced products; what follows
        the preconditioner inside section()."""
        # a frozen lane enters as zeros (rz): its alpha is 0, so its x and r
        # keep their bits, and a nested solve freezes it at once (one lane
        # iterates only while it goes)
        r_in = self.r if self.rz is None else self.rz
        q, aux = _prec_out(prec, r_in.reshape(self.shape))
        with section():
            self._update(j, apply_op, q, aux)

    def _update(self, j, apply_op: Callable, q, aux):
        B = self.B
        if aux is not None:             # with this iteration's go, before the step
            aux = aux if self.rz is None else torch.where(self.go[:, None], aux, self._no_aux)
            if self.aux_sum is None:        # the host loop: sized by the first aux
                self.aux_sum = torch.zeros_like(aux)
            self.aux_sum += aux
        w = apply_op(q).reshape(B, -1)
        q = q.reshape(B, -1)
        if self.allsum is None:
            cuda_gcr.gcr_step(self.W, self.Q, self._row(j), w, q, self.x, self.r, self.rz,
                              self.go, self.stop, self.active, self.rn, self.iters, self.work)
            return
        w, q = orthonormalize(self.W, self.Q, self._row(j), w, q, self.allsum)
        cuda_gcr.update_step(w, q, self.x, self.r, self.rz, self.go, self.stop, self.active,
                             self.rn, self.iters, self.allsum)

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
    host (gcr_program under HostControl: one read of the device per
    iteration).

    apply_op and prec take and return [B, *shape]; prec(v) -> z or
    (z, aux) with aux a [B, k] float tensor (e.g. coarse-work counters),
    summed over each lane's iterations.  tol is a float or a [B] tensor;
    active [B] (bool) masks off lanes that must not iterate.  allsum sums
    a per-slab partial sum over the ranks (None on one rank).  Returns
    (x [B, *shape], iterations [B], final squared relative residual [B],
    aux sum [B, k] or None), all on b's device.
    """
    return gcr_program(HostControl(), apply_op, b, m, tol, n_restarts, prec, x0, allsum,
                       active)


def gcr_program(ctl, apply_op: Callable, b: torch.Tensor, m: int, tol,
                n_restarts: int = 1, prec: Optional[Callable] = None,
                x0: Optional[torch.Tensor] = None, allsum: Optional[Callable] = None,
                active: Optional[torch.Tensor] = None, n_aux: int = 0,
                site: Optional[str] = None):
    """Restarted flexible GCR with its control flow given to ctl
    (HostControl, or a CudaGraph being captured): the restarts a loop of
    n_restarts passes, each restart's iterations a loop that runs while
    some lane goes.  Every iteration masks the frozen lanes (B > 1): a lane
    that goes enters as itself, so a replay gives the host loop's bits.
    Arguments and result as device_gcr's; n_aux: the width of prec's aux,
    whose sum then starts as zeros before any iteration (0: sized by the
    first aux, None if no iteration runs; the host loop only).  The fine
    inner restart, the K-cycle's and the coarsest GCR are this one
    program.  site: the name of the marked section (profiling.site, at
    depth 0) of the GCR's own work, each restart's residual and each
    step's after the preconditioner."""
    st = GCRLanes(b, m, tol, x0, allsum, active, n_aux)
    section = functools.partial(marked_site, site, 0) if site else contextlib.nullcontext

    def iteration(j):
        st.step(j, apply_op, prec, section)

    def restart(_):
        with section():
            st.restart(apply_op)
        ctl.loop(m, lambda: st.go, iteration)

    ctl.loop(n_restarts, None, restart)
    return st.result()
