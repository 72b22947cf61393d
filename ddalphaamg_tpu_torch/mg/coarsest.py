"""The coarsest level's GCR solve (coarse_solve_odd_even_PRECISION,
src/coarse_oddeven_generic.c:1139; the JAX package's _coarsest_solve_traced,
ddalphaamg_tpu/mg/hierarchy.py:659-699) and its CUDA graph.

coarsest_gcr is the solve of every lane of b [B, d, V]: with odd-even, the
odd sites eliminated (b_e = even (b - hop(A_oo^-1 b))), GCR on the even-site
Schur complement, the odd sites reconstructed; else GCR on the full
operator.  It returns (x, counters [B, 3]) with counters = [iterations,
operator applications (iterations + one residual apply a restart), 0], as
the JAX package counts them.  gcr is the GCR driver: the host loop
(device_gcr) or the program of a captured graph.

CoarsestGraph runs the whole of coarsest_gcr, prologue, every restart with
its residual apply, each restart's iterations with their early exit, the
epilogue and the counters, as one replay of one CUDA graph
(solvers/cuda_graph.py): the restarts a loop, the iterations of a restart a
loop nested in it, each with one body and a device-side iteration index,
the program of the inner restart's nested coarsest solve (mg/programs.py).
The right-hand side is copied into a static buffer, x and the counters are
cloned out of static ones; no replay reads the device.  The graph holds
the stencil it was captured from (the Multigrid drops it with that
stencil).  Its launches per replay and per loop pass are recorded at
capture and its loops' device trip counters give the passes
(kernels.GraphLaunches), so the launch counts equal the host loop's.
"""

from __future__ import annotations

import functools
import math

import torch

from ..operators.stencil import ODD, schur
from ..solvers.cuda_graph import CudaGraph, GraphProgram
from ..solvers.device_gmres import COUNTER_DTYPE, device_gcr, gcr_program

# fields of one lane a graph's pool holds beside its bases W and Q (the
# state, the prologue's and epilogue's fields, one iteration's temporaries)
POOL_FIELDS = 32


def coarsest_gcr(s, b, m: int, tol: float, n_restarts: int, odd_even: bool,
                 gcr=device_gcr):
    """The coarsest GCR solve of every lane of b [B, d, V] on stencil s
    (module note); returns (x, counters [B, 3])."""
    if odd_even:
        b_e = s.even * (b - s.hop(s.self_inv(b, ODD)))
        x_e, iters, _, _ = gcr(lambda v: schur(s, v), b_e, m=m, tol=tol,
                               n_restarts=n_restarts, allsum=s.allsum)
        x_e = s.even * x_e
        x = x_e + s.self_inv(b - s.hop(x_e), ODD)
    else:
        x, iters, _, _ = gcr(s.full_op, b, m=m, tol=tol, n_restarts=n_restarts,
                             allsum=s.allsum)
    iters = iters.to(COUNTER_DTYPE)
    return x, torch.stack([iters, iters + n_restarts, torch.zeros_like(iters)], dim=1)


class CoarsestGraph(GraphProgram):
    """coarsest_gcr for B lanes on stencil s as one CUDA graph (module
    note) at multigrid depth `depth`; capture is the graph class
    (CudaGraph; tests give a stand-in).  Calling it replays the graph."""

    def __init__(self, s, B: int, m: int, tol: float, n_restarts: int, odd_even: bool,
                 capture=CudaGraph, depth: int = 0):
        self.stencil, self.depth = s, depth

        def program(ctl, b):
            x, counters = coarsest_gcr(s, b, m, tol, n_restarts, odd_even,
                                       gcr=functools.partial(gcr_program, ctl))
            return {"x": x, "counters": counters}

        b = torch.zeros((B, *s.field_shape), dtype=s.dtype, device=s.device)
        lane = math.prod(s.field_shape) * b.element_size()
        super().__init__(program, {"b": b}, s.device, need=(2 * m + POOL_FIELDS) * B * lane,
                         capture=capture)

    def __call__(self, b):
        """(x, counters [B, 3]) of the lanes b [B, d, V]: one replay."""
        out = super().__call__(b=b)
        return out["x"], out["counters"]
