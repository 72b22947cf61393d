"""The multigrid solve's device programs on a card (one rank, or every rank
of a grid over nccl, Multigrid.uses_graphs): the inner restart and the
cycle, each captured once into a CUDA graph (solvers/cuda_graph.
GraphProgram) and replayed with no read of the device.  On a grid the
sharded levels' face exchanges, all-reduces and gathers are captured
inside as K8 (parallel/peer.py), the JAX package's sharded
inner_restart_batch (its hierarchy.py:806-850).

InnerRestartGraph is the port's counterpart of the JAX package's
_inner_restart_impl / inner_restart_batch (ddalphaamg_tpu/mg/hierarchy.py:
806-860): the fine flexible GCR of m iterations with its per-lane early
exit, in every iteration the whole depth-0 cycle (restriction, the K-cycle
GCR at depth 1 with the depth-1 cycle inside, the coarsest solve: the dense
apply or the odd-even Schur GCR, interpolation, SAP at both depths) and the
[B, 3] coarse-work counters (Multigrid.inner_program).  Its inputs are
static buffers: r [B, 12, V], rel_tol [B] and active [B]; it gives z, the
iterations and the counters.  CycleGraph is one preconditioner call
(Multigrid.__call__: methods 1 and 3; the JAX package's _run_cycle): eta
in, x and the counters out.

Each GCR in them is one loop with one body and a device-side iteration
index, the loops nested (fine iterations -> K-cycle restarts -> K-cycle
iterations -> coarsest restarts -> coarsest iterations), so a capture
traces each body once.  A program holds (`holds`) what it read besides
its inputs and its fine operator (`op`): every level's cycle stencil,
interpolation, inverses and smoother; the Multigrid compares them by
identity before every replay and drops its programs when one was
replaced.  The pool holds the bases for the life of the graph: the fine
ones 2 m B fields (Multigrid.program_bytes).

The setup's sweeps (the JAX package's _setup_cycles_batch and the vmapped
_inv_iter_2lvl, hierarchy.py:927-987) are two more programs, one of each a
depth, captured at a setup's first sweep of that depth and replayed for
every chunk of lanes of every later sweep: SetupCycleGraph is one chunk of
a level's bootstrap cycles (Multigrid._cycle with its K-cycle and coarsest
GCRs, giving x and the next levels' solutions it collects),
TwoLevelUpdateGraph one chunk of the interpolation-1 update
(Multigrid._twolevel_lanes: restriction, the coarsest GCR or the
unpreconditioned coarse GCR, interpolation, SAP, normalization).  Between
the sweeps re_setup writes the rebuilt interpolations and stencils into
the storage the programs read (Multigrid.re_setup), so the holds stay the
same objects for the whole setup; a level's chunk is fixed at the setup's
start (Multigrid._setup_chunk), so the batch does too.  Their pools stay
held through the setup, the Galerkin builds included (lane_chunk's `held`).
"""

from __future__ import annotations

import torch

from ..solvers.cuda_graph import CudaGraph, GraphProgram


class InnerRestartGraph(GraphProgram):
    """Multigrid.inner_program for B lanes of dtype, GCR length m, on the
    full_op of the fine stencil op (None: the fine level's), as one CUDA
    graph (module note).  Calling it with r, rel_tol ([B] or a float) and
    active ([B] or a bool) replays it and returns {z, iters, counters}."""

    row = "inner restart (one CUDA graph replay: fine GCR and cycles)"

    def __init__(self, mg, B: int, dtype, m: int, op=None, holds=(), capture=CudaGraph):
        s = mg.fine.stencil
        self.holds, self.op = holds, op
        dev = s.device
        inputs = {"r": torch.zeros((B, *s.field_shape), dtype=dtype, device=dev),
                  "rel_tol": torch.zeros(B, dtype=torch.float64, device=dev),
                  "active": torch.ones(B, dtype=torch.bool, device=dev)}

        def program(ctl, r, rel_tol, active):
            z, iters, counters = mg.inner_program(ctl, r, rel_tol, m, active,
                                                  None if op is None else op.full_op)
            return {"z": z, "iters": iters, "counters": counters}

        super().__init__(program, inputs, dev, need=mg.program_bytes(B, m), capture=capture)


class CycleGraph(GraphProgram):
    """One depth-0 cycle (Multigrid._cycle) for B lanes of dtype as one
    CUDA graph (module note); m and op are unused (one signature with
    InnerRestartGraph).  Calling it with eta replays it and returns {x,
    counters}."""

    def __init__(self, mg, B: int, dtype, m: int = 0, op=None, holds=(), capture=CudaGraph):
        s = mg.fine.stencil
        self.holds, self.op = holds, op
        ktol = mg._kcycle_tol(0, mg.cfg.kcycle_tol)
        inputs = {"eta": torch.zeros((B, *s.field_shape), dtype=dtype, device=s.device)}

        def program(ctl, eta):
            x, counters = mg._cycle(0, eta, ktol, ctl=ctl)
            return {"x": x, "counters": counters}

        super().__init__(program, inputs, s.device, need=mg.program_bytes(B, 0),
                         capture=capture)


class SetupCycleGraph(GraphProgram):
    """One chunk of B lanes of the bootstrap cycles at depth m
    (Multigrid._cycle with collect, K-cycle tolerance as the setup's) as one
    CUDA graph (module note); op is unused.  Calling it with tvs replays it
    and returns (x, {depth: collected solutions})."""

    per_depth = True

    def __init__(self, mg, B: int, dtype, m: int = 0, op=None, holds=(), capture=CudaGraph):
        level = mg._levels()[m]
        s = level.stencil
        self.holds, self.op, self.depth = holds, op, m
        ktol = mg._kcycle_tol(m, mg.cfg.coarse_tol)
        inputs = {"tvs": torch.zeros((B, *s.field_shape), dtype=dtype, device=s.device)}

        def program(ctl, tvs):
            collect = {}
            x, _ = mg._cycle(m, tvs, ktol, collect=collect, ctl=ctl)
            return {"x": x, **{f"depth {d}": xc for d, xc in collect.items()}}

        super().__init__(program, inputs, s.device, need=B * mg._lane_bytes(level),
                         capture=capture)

    def __call__(self, tvs):
        out = super().__call__(tvs=tvs)
        x = out.pop("x")
        return x, {int(k.split()[1]): v for k, v in out.items()}


class TwoLevelUpdateGraph(GraphProgram):
    """One chunk of B lanes of the interpolation-1 update at depth m
    (Multigrid._twolevel_lanes) as one CUDA graph (module note); op is
    unused.  Calling it with tvs replays it and returns the updated,
    normalized lanes."""

    per_depth = True

    def __init__(self, mg, B: int, dtype, m: int = 0, op=None, holds=(), capture=CudaGraph):
        level = mg._levels()[m]
        s = level.stencil
        self.holds, self.op, self.depth = holds, op, m
        inputs = {"tvs": torch.zeros((B, *s.field_shape), dtype=dtype, device=s.device)}

        def program(ctl, tvs):
            return {"tvs": mg._twolevel_lanes(level, tvs, ctl)}

        super().__init__(program, inputs, s.device, need=B * mg._lane_bytes(level),
                         capture=capture)

    def __call__(self, tvs):
        return super().__call__(tvs=tvs)["tvs"]
