"""Smoke run of ddalphaamg_tpu_torch on one CUDA card (an H100 in this
repository's runs):

    python3 chip_smoke.py

Phases, one result line each (or a few), in order:
  1. device   the card's name, power limit and compute mode (nvidia-smi),
              torch and CUDA, and whether torch offers conditional graph
              nodes (the port builds its own, csrc/graph.cu)
  2. build    compile csrc/*.cu for sm_90a, one nvcc per source, all started
              together (timed)
  3. kernels  every hand-written kernel against its plain PyTorch version on
              the card at the shapes of the rough16 solve (16^4 fine level:
              K1 at batch 1, 28 and 56 (the Galerkin build), K2 on block
              links on all sites and on the odd sites (the SAP's block
              odd-even solve) at batch 1 and 28 (and on the even sites at
              batch 1), on the Galerkin build's
              face links at batch 56 and on the full links on the even and
              on the odd sites at batch 1 (method 4's D_eo / D_oe), K3 with
              the clover (also on the even sites at batch 1, method 4's
              A_ee) and with the odd-site inverse from its compact storage,
              also at an odd global offset (parity_offset 1), on the whole
              lattice and on a (1, 2, 1, 1) rank's slab shape; K2 on the
              full links on the odd sites of a (1, 1, 1, 2) rank's slab
              (16, 16, 16, 8) at parity_offset 1 (a slab whose offset is
              odd in x alone);
              8^4 and 4^4 coarse levels with d = 56; K5 on rank 0's slab
              of the 8^4 level on the (1, 2, 1, 1) mesh, (8, 4, 8, 8) with z
              faces, on the (2, 2, 1, 1) mesh, (4, 4, 8, 8) with t and z
              faces, on the (1, 1, 2, 2) mesh, (8, 8, 4, 4) with y and x
              faces, and on the (2, 2, 2, 2) mesh, (4, 4, 4, 4) with faces
              on all four axes (faces cut from a random global field by
              parallel/comm.face), batch 1 and
              28, K8 (the
              grid's collectives over peer pointers, parallel/peer.py) with
              the ranks of the (1, 2, 1, 1) and (1, 1, 2, 2) grids as Peers
              of this one process (each rank's kernels on a stream of its
              own): the exchange of the fine half-spinor faces and of the
              depth-1 coarse faces, the all-reduce of [12, 50] products and
              of [12] norms, the gather of the coarsest level's slabs, bit
              for bit against the plain versions, and under skew (a
              (1, 1, 1, 4) ring, one rank lagging: one-way shifts,
              all-reduces and gathers of alternating sizes, some above the
              buffers), and the batched applies
              of the setup (K4 at 4^4, batch 256:
              full, hop and self_inv odd, the Schur inverse's column build;
              K4 at 8^4, masked full, batch 56 for the Galerkin build and
              128 for the block inverses' columns), with the max relative
              error against 1e-5 (f32) / 1e-13 (f64) and the kernel and
              plain times from CUDA events after warm-up.  K4-bf16 and
              K5-bf16 run the same cases on the same blocks rounded to
              bf16 (tolerance 1e-5: f32 sums in another order); K4-schur
              (the coarsest Schur complement on parity-split blocks) at
              8^4 and 4^4, d = 56, bf16 and f32 blocks, batch 1, also bit
              for bit against the four K4 launches it replaces, whose time
              as graph replays is printed beside its own; K6 the
              products with the two stored inverses of
              rough16, [1, 7168, 7168] and [256, 896, 896], the latter also
              on the block lists of one red-black colour (128 blocks) and
              one of sixteen colours (16).  Each line also
              gives the least time the card could take (bytes once over
              3.35 TB/s or operations over the peak rate, whichever is
              larger) and the time of one PyTorch call that computes the
              same function on inputs laid out for it beforehand (checked
              against the plain version to the same tolerance):
              torch.einsum over per-site 12 x 12 hop matrices and stacked
              neighbour fields for K1 / K2 (the clover a ninth term for
              K1), over the unpacked 6 x 6 clover blocks for K3, over the
              stacked neighbour fields for K4 / K5 (the TPU kernel's own
              input; widened complex64 blocks for the bf16 rows, zeroed at
              the other parity's sites for self_inv odd), and torch.matmul
              on the widened complex64 listed blocks for K6, all in full
              f32 (utils.pin_full_precision); the shapes of phase rough32
              too: K1 (f32 and f64), K2 on the block links' odd sites and
              K3 at 32^4 batch 1 on the rough32 field, K4 and K4-bf16 full
              and block-masked at 16^4 with d = 56 at batch 1 and 28 (and K4
              masked at batch 56, the Galerkin build of the 8^4 level); K6
              also over 12 right-hand
              sides at every shape (the batched cycles of phase "multi":
              the tensor-core kernel, one read of the matrix, whose bound
              counts the exact split's 3 x 8 nc m^2 R operations at the
              bf16 tensor-core rate, 989 TFLOP/s), its library call
              [nc, m, m] @ [nc, m, 12]; K7, the whole GCR step after the
              operator apply (the Gram-Schmidt with its row j read from the
              device, alpha, the x / r updates, the norm and the stop test;
              K7_CASES: the fine GCR's 16^4 x 12 at m = 50, the K-cycle's
              8^4 d = 56 at m = 5, the coarsest 4^4 and 8^4 d = 56 at
              m = 100, batch 1 and 12, complex64, and one complex128 row),
              every time of its row a step as raw launches captured in a
              CUDA graph (graph_ms), its library call the sequence the port
              ran before (the j-row torch products through cuBLAS, then
              vecdot, the updates, the norm and the stop test in torch),
              its bound (2j + 8) n elements a lane; and one GCRLanes.step
              profiled at 4^4 and 8^4 d = 56, batch 1 and 2: K7's one or two
              kernels and no other than the operator's, the preconditioner's
              and the aux sum's
  3b. graph   the coarsest GCR (mg/coarsest.py) as one CUDA graph replay
              ("G": one-body WHILE loops with a device-side index,
              csrc/graph.cu) against the host loop on random coarse
              stencils at rough16's coarsest shapes (4^4, d = 56, batch 1
              and 28 with a zero lane) and rough32's (8^4, bf16 blocks,
              batch 1), rough16's coarse-solve parameters: equal counters
              and K4 / K4-bf16 launches, x bit-equal or within 1e-6; each
              way's time a call (CUDA events) beside PR 13's nested-IF
              chain, the capture's seconds and loop bodies, the graph
              pool's bytes, and the least time of the call's work (its K4
              applies and vector work)
  4. solve    the single-rank main path: Solver on bench_assets/rough16.ini
              at full parameters (the configuration read by the native
              reader, native.py, or the phase fails; plaquette
              1.7878261039088 to 1e-10; setup with its phases traced
              (profiling.PROF at level 2 for the setup and the first solve
              alone, the rest of the run untraced): the device seconds of
              each by depth and what is left outside them,
              solve of a right-hand side of ones, exact relative residual
              recomputed in complex128 from the returned x, < 1e-10 in <= 12
              outer iterations), with the launch count of each kernel in
              that run (K1-K4 must be > 0) and in its setup (the bootstrap
              runs the cycles of a level's 28 test vectors as one batch,
              each sweep one replay of a device program);
              then a second, warm solve of the same right-hand side, timed
              for phase 7; the graphs' captures (the setup's beside PR
              13's), replays and pools, the host's reads of the device and
              the empty_cache calls the captures made (the tracer's
              counters, of the setup and of the first solve: a read more
              than the outer iterations ask, or a capture that had to empty
              the allocator's cache, is a regression to look into), and the
              warm solve profiled twice
              (torch.profiler: wall time, device busy time and its share of
              the profiled and of the unprofiled warm solve, device time by
              kernel, and the graph replays' device time from CUDA events
              around them), with every GCR driven from the host (before)
              and as the device programs (after)
  4b. multi   Solver.solve_multi of the 12 spin-colour point sources at the
              origin with phase 4's setup: every lane's exact relres
              (complex128) < 1e-10 in <= 12 outer iterations; lanes 0 and
              11, each solved alone by solve, within 1 iteration of their
              lanes; the wall time of the batch and of the two single
              solves, and the batch's launch counts; a profiled solve_multi
              before and after as in phase 4
  4b2. inner-graph  on phase 4's hierarchy (and, in phases 7 and 9, on
              theirs at batch 1): from the same r (ones at batch 1, the 12
              point sources at batch 12) the inner restart
              (Multigrid.inner_restart at the solve's GCR length, rel_tol
              1e-5) and the cycle (Multigrid.__call__), each once with
              host loops and once as one replay of its device program
              (mg/programs.py: the fine GCR with the whole cycle inside,
              every GCR a one-body loop): bit-equal z / x and counters,
              every kernel's launches within 0.1 %, the ms of each, the
              capture's seconds and loop bodies, the pool's bytes
  4b3. setup-graph  rough16's bootstrap setup with its sweeps as device
              programs (mg/programs.SetupCycleGraph: one capture a depth
              serves the whole setup, re_setup rewriting what they read)
              and with host loops, in turns (host, programs, programs,
              host), and its interpolation-1 setup (TwoLevelUpdateGraph)
              both ways: every level's test vectors bit-equal, every
              kernel's launches within 0.1 %; the setups' seconds,
              captures, capture seconds and the largest pools held
  4c. methods (run after phase 4b, on phase 4's solver for the API runs)
              the other methods and setups on rough16 at full size, the
              ini otherwise, each run with its outer iterations, exact
              relres (complex128), wall time, host us an iteration and
              launch counts: methods 1 and 3 with the 3-level hierarchy
              (method 3 also with the options on, a warm solve's K6
              launches set beside phase 7's red-black ones, and K6's device
              time in one more warm solve, profiled), SAP alone
              (method 2, interpolation 0) and method 4 reach < 1e-10
              within the ini's restarts; methods -1, 0 and 5 reach it or
              stop at iterations between restarts x maximum of restarts,
              with an exact relres within 1 % of the solver's own; then
              shift_update(m0 + 0.01) and a solve with no setup run between,
              update_setup(1) and a solve, solve(x0 = that solution) in 0
              iterations, write_test_vectors and a fresh Solver with
              interpolation 4 that reads them bit for bit and solves, an
              interpolation-1 setup and solve, and rough16 with open time
              boundaries (bc 0, U_T of the last slice zeroed), each < 1e-10
  4d. library (after phase 4c, on phase 4's solver for the diagnostics)
              rough16 written as LIME, DDHMC and one file a rank of a
              (1, 2, 1, 1) grid and read back, and `tools tobin` of the LIME
              file, each bit-equal to the binary file's links; the compat
              API from rough16.ini on the LIME-read links (plaquette to
              1e-10): setup, wilson_solve (< 1e-10 in <= 12 outer
              iterations), a solve with the clover scaled 1.1 / 0.9 (exact
              relres against the scaled operator, moved by > 1e-3), the
              unscaled solve again (the first to 1e-8, <= 12 iterations),
              set_mass_for_next_solve(m0 + 0.01) and a solve, two set_conf
              calls and a solve that runs update_setup (update_setup_after
              2), each < 1e-10 within the ini's restarts; the self checks
              (< 1e-5), test-vector analysis, smoother reduction (< 1) and
              coarse reduction (<= the coarse tolerance) on phase 4's
              hierarchy; the cli with --benchmark 3 --profile --rhs-batch 2
              in process (exit 0, both profiling tables and the memory
              line printed); an m0 scan over -0.5, -0.49, -0.48 with shift
              updates (three rows < 1e-10); the launch counts of the
              compat, cli and scan runs (K1-K4 must run in each) and the
              phase's wall time
  5. sharded  the domain-decomposed main path: the same solve on a
              (1, 2, 1, 1) t/z process grid, two ranks spawned on this one
              card with the "gloo" transport (faces and sums cross the host:
              its times are no scaling numbers); every rank must agree, the
              exact relres recomputed by rank 0 from the gathered x must be
              < 1e-10 in <= 12 outer iterations, within 1 of phase 4, and
              every kernel of the path, K5 included, must have run; the
              replicated coarsest level's GCR runs as graph replays on every
              rank (their count and captures per rank; the gloo-sharded
              levels keep host loops), one coarsest call replayed and run as
              a host loop on the same right-hand side must be bit-equal
              (their ms beside), and a warm solve with the replays is timed
              beside one with host loops only (the port before)
  5b. grid4d  the domain-decomposed main path on a (1, 1, 2, 2) grid that
              splits y and x: four gloo ranks on this card, local lattice
              (16, 16, 8, 8), depth 1's slab (8, 8, 4, 4) sharded (K5 with
              y and x faces), the coarsest level replicated; the checks of
              phase 5 (ranks agree, exact relres < 1e-10 in <= 12 outer
              iterations within 1 of phase 4, K1-K5 launched) and every K5
              launch's faces are those of y and x; then, on the same ranks,
              method 4 and CGN (method -1) with the ini's restarts as phase
              4c runs them, their iterations within 2 % of phase 4c's, the
              exact relres checked as there; the phase's wall time
  6. nccl     with two or more cards, the same solve with the "nccl"
              transport on one card per rank ((1, 1, 2, 2) with four cards):
              every inner restart one replay of InnerRestartGraph with the
              slabs' exchanges, all-reduces and gathers inside as K8 (NCCL's
              work cannot live in a graph's WHILE body:
              scripts/probe_torch_nccl_graph.py), one inner restart held
              bit-equal to its host loops on every rank; with one card a
              line says it was not run
  7. direct   phase 4 with the JAX package's accelerator options on (bf16
              coarse blocks, coarsest dense Schur inverse, direct block
              solves; set on the parsed parameters): setup, the time of
              each inverse build, the first solve (which builds the
              inverses) and a second, warm solve of the same right-hand
              side beside phase 4's warm solve, peak device memory;
              relres < 1e-10 in <= 12 and <= phase 4 + 2 outer iterations,
              K4-bf16 and K6 launched, and no coarsest GCR iteration in the
              solve; then K6's device time in a third, profiled warm solve
              (torch.profiler's kernel events with host loops, their count
              held to the wrapper's launches); the warm solve profiled
              before and after as in phase 4, and phase "inner-graph" at
              batch 1
  7b. multi-direct  phase 4b with phase 7's setup (the options on: K6 over
              12 right-hand sides, K4-bf16 at batch 12), and K6's device
              time in one more, profiled solve_multi
  8. sharded-direct  phase 5 with the three options: K5-bf16 must run, and
              the iterations are within 1 of phase 7
  9. defaults rough16.ini with no option keys, so the CUDA defaults decide
              (api.accelerator_options, the JAX package's rule for an
              accelerator that is not a TPU): the options chosen must be bf16
              blocks on, the coarsest Schur inverse on (n = 14,336 <=
              16,384), direct block solves off; setup, a solve and a warm
              solve (beside phase 4's and phase 7's), the inner GCR's cap and
              the last inner clip; exact relres < 1e-10 in <= 12 and <= phase
              4 + 2 outer iterations; the warm solve profiled before and
              after as in phase 4, and phase "inner-graph" at batch 1
 10. rough32  the configuration "rough32" (rough32_params): a rough SU(3)
              field at 32^4 from tools.rough_su3(seed 0) made on the card
              (the numpy draws, the projections on the card; phase 3 made
              it), anti-periodic in time, rough16's parameters with the
              lattices doubled (32^4 -> 16^4 -> 8^4, 28 / 28 test vectors,
              setup 4 / 3), no option keys: field seconds and plaquette,
              set_conf, setup (its phases profiled as in phase 4, the
              programs' pools) and slim_for_solve with the device memory
              after each, the lanes of every setup chunk, one more depth-0
              bootstrap sweep on the final hierarchy as replays and with
              host loops at the same chunk (x and the collected solutions
              bit-equal, launches within 0.1 %), a cold and a warm solve,
              iterations, exact relres < 1e-10 (complex128), the options
              chosen (bf16 on, coarsest direct off: n = 229,376), cap and
              clip, <= 16 outer iterations, the launches by kernel, the
              graphs (the setup's captures beside an earlier run's), the warm
              solve's K4-schur launches (2 a coarsest GCR operator
              application) and the same solve with the four K4 launches
              (bit-equal x and counters), and a profiled
              warm solve (as in phase 4); then every
              other shape of
              K1-K4 that set_conf, the setup (its lane chunks follow the
              card's free memory) and the cold solve launched at 32^4 and
              16^4 (launch_shapes), held against its plain version as in
              phase 3 (check_rough32_kernels), and the rows of phase 3 that
              rough32 did not launch

The second-to-last lines are a JSON summary of the kernels (launches of
K1-K4, K7 and G (graph replays) from phase 4, K5 from phase 5 (phase 5b's
under "launches_by_path"), K4-bf16 and K6 from phase 7, K5-bf16
from phase 8, K4-schur from phase 10, and under "launches_by_path" those of every path run, phases
9 and 10 included; the
times of the first case and, under "cases", of every case of phase 3; K6's
device time in the three profiled runs under "device_ms_by_path") and
the card's nvidia-smi line; the last line is
{"ok": true, "device": {...}}.  Any failed check exits non-zero before that
line; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
INI = os.path.join(HERE, "bench_assets", "rough16.ini")
PLAQ = 1.7878261039088
TOL = {torch.complex64: 1e-5, torch.complex128: 1e-13}
BATCHES = (1, 28)
GALERKIN_BATCH = 56       # 2N basis fields of the fine-level Galerkin build
MULTI_RHS = 12            # phase "multi": the 12 spin-colour sources of a propagator
# published H100 SXM rates (NVIDIA data sheet): memory, and dense
# non-tensor-core arithmetic in f32 and f64
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.complex64: 67e12, torch.complex128: 34e12}
# dense bf16 tensor-core rate: K6's split work over several right-hand sides
PEAK_BF16_TC = 989e12
# flops per site and right-hand side: Wilson hop 1320, packed clover (two
# 6 x 6 complex blocks) 576
DSLASH_FLOPS = {"K1": 1320 + 576, "K2": 1320, "K3": 576}
OPTIONS = ("coarse_block_bf16", "coarsest_direct", "smoother_direct")
ROUGH32 = (32, 32, 32, 32)
# phase "graph": the coarsest shapes of rough16 (4^4, d = 56, one lane and
# the setup's 28) and of rough32 (8^4 with bf16 blocks, one lane)
GRAPH_CASES = (((4, 4, 4, 4), 1, False), ((4, 4, 4, 4), 28, False), ((8, 8, 8, 8), 1, True))
# PR 13's times of these calls as chains of 100 nested IF nodes (PERF.md)
CHAIN_MS = {((4, 4, 4, 4), 1): 1.9623, ((4, 4, 4, 4), 28): 5.6722, ((8, 8, 8, 8), 1): 6.7616}
# phase 3's K7 cases: (label, n, m, rows j, batches, dtype) of the GCRs of the
# paths: rough16's fine GCR (16^4 x 12, m = 50), its K-cycle (8^4, d = 56,
# m = 5), the coarsest GCRs of rough16 and rough32 (4^4 / 8^4, d = 56,
# m = 100), and the fine GCR in complex128 (mixed precision 0)
K7_CASES = (("16^4 x 12 (fine GCR)", 16**4 * 12, 50, (1, 10, 49), (1, 12), torch.complex64),
            ("8^4 d=56 (K-cycle)", 8**4 * 56, 5, (1, 4), (1, 12), torch.complex64),
            ("4^4 d=56 (coarsest)", 4**4 * 56, 100, (1, 50, 99), (1, 12), torch.complex64),
            ("8^4 d=56 (coarsest, rough32)", 8**4 * 56, 100, (1, 50, 99), (1, 12),
             torch.complex64),
            ("16^4 x 12 (fine GCR)", 16**4 * 12, 50, (10,), (1,), torch.complex128))
# K1 (csrc/dslash.cu's dslash kernels with the clover), K2 (without), K3,
# K6 (csrc/dense.cu), the coarse kernels K4 / K4-bf16 (csrc/coarse.cu), K7's
# designs (csrc/gcr.cu: the cluster kernel, the grid design's two) and the
# graphs' loop kernels (csrc/graph.cu) by the names of their instances, in
# the profiler's kernel events
KERNEL_EVENTS = {"K1": re.compile(r"dslash_(mrhs_)?kernel<(float|double), true"),
                 "K2": re.compile(r"dslash_(mrhs_)?kernel<(float|double), false"),
                 "K3": re.compile(r"clover_kernel<"),
                 "K4": re.compile(r"coarse_(b1|mrhs)_kernel"),
                 "K6": re.compile(r"dense_bf16"),
                 "K7": re.compile(r"gcr_(cluster_step|dots|update)"),
                 "G loops": re.compile(r"loop_(start|next)_kernel")}
PATH_KERNELS = {"solve": ("K1", "K2", "K3", "K4", "K7", "G"),
                "setup-graph": ("K1", "K2", "K3", "K4", "K7", "G"),
                "defaults": ("K1", "K2", "K3", "K4", "K4-bf16", "K6", "K7", "G"),
                "rough32": ("K1", "K2", "K3", "K4", "K4-bf16", "K4-schur", "K7", "G"),
                "sharded": ("K1", "K2", "K3", "K4", "K5", "K7", "G"),
                "grid4d": ("K1", "K2", "K3", "K4", "K5", "K7", "G"),
                "direct": ("K1", "K2", "K3", "K4", "K4-bf16", "K6", "K7", "G"),
                "sharded-direct": ("K1", "K2", "K3", "K4", "K4-bf16", "K5", "K5-bf16", "K6",
                                   "K7", "G"),
                "multi": ("K1", "K2", "K3", "K4", "K7", "G"),
                "multi-direct": ("K1", "K2", "K3", "K4-bf16", "K6", "K7", "G"),
                "library": ("K1", "K2", "K3", "K4", "K7", "G")}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rough16_params(options=False):
    """rough16.ini with its configuration file taken from this checkout (the
    ini names it by an absolute path), with the three accelerator options
    set on or off (None: left unset, so that the CUDA defaults decide)."""
    from ddalphaamg_tpu_torch import config

    params = config.parse_ini(INI)
    params.configuration = os.path.join(HERE, "bench_assets",
                                        os.path.basename(params.configuration))
    if options is not None:
        for key in OPTIONS:
            setattr(params, key, bool(options))
    return params


def rough32_params():
    """The configuration "rough32": rough16.ini's parameters with the
    lattices doubled (32^4 -> 16^4 -> 8^4) and no option keys, so that the
    CUDA defaults decide; the field comes from rough32_field."""
    from ddalphaamg_tpu_torch import config

    params = config.parse_ini(INI)
    params.configuration = None
    params.depth[0].global_lattice = params.depth[0].local_lattice = ROUGH32
    params.depth[1].global_lattice = tuple(e // 2 for e in ROUGH32)
    params.depth[2].global_lattice = tuple(e // 4 for e in ROUGH32)
    return params.validate()


def rough32_field():
    """rough32's links (bench.py's bench_lat32 field): tools.rough_su3 at
    32^4, seed 0, made on the card, anti-periodic sign on the last time
    slice; returns (U, seconds)."""
    from ddalphaamg_tpu_torch import tools

    t0 = time.perf_counter()
    U = tools.rough_su3(ROUGH32, seed=0, device="cuda")
    U[0, -1] *= -1.0
    return U, time.perf_counter() - t0


def phase(name, t0, text):
    print(f"[{name}] {text} ({time.perf_counter() - t0:.2f} s)", flush=True)


def cuda_ms(fn, reps=10):
    """Mean time of fn on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_graph_stream = []      # graph_ms's capture stream, made at its first use


def graph_ms(fn, reps=20):
    """ms of one fn call, as `reps` calls captured in one CUDA graph
    (torch.cuda.CUDAGraph) and replayed, timed by CUDA events after a
    warm-up call on the capture stream (cuBLAS takes its workspace for a
    stream at the first product there) and a warm-up replay: a kernel's
    device time without the host's wrapper work between launches."""
    if not _graph_stream:
        _graph_stream.append(torch.cuda.Stream())
    stream = _graph_stream[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(reps):
            fn()
    ms = cuda_ms(g.replay, reps=3) / reps
    del g
    return ms


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(results, key, label, kernel_fn, plain_fn, dtype, work, library_fn=None,
            library_ref=None):
    """One kernel-vs-plain check; keeps the worst error per kernel, the
    numbers of the first (batch 1, main-path dtype) case, and every case's
    numbers under "cases".  work = (bytes, operations) the function needs on
    these inputs, or (bytes, operations, peak rate) where the operations run
    at another rate than dtype's; library_ref(want) is the part of the plain
    result the library call computes (default: all of it).  library_fn may
    also be a list of (make, (l0, l1)): the library call over lanes l0:l1
    made by make() one chunk at a time (inputs too large to stack at once),
    its time the sum of the chunks'."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    tol = TOL[dtype]
    chunks = library_fn if isinstance(library_fn, list) else None
    if chunks is not None:
        lib_ms = 0.0
        for make, (l0, l1) in chunks:
            fn = make()
            ref = want[l0:l1]
            lib_rel = float((fn().reshape(ref.shape) - ref).abs().max() / ref.abs().max())
            if lib_rel > tol:
                fail(f"{label}: the library call on lanes {l0}-{l1 - 1} differs from the "
                     f"plain version by {lib_rel:.3e}")
            lib_ms += cuda_ms(fn, reps=3)
            del fn
            torch.cuda.empty_cache()
        library_fn = None
    elif library_fn is not None:    # the library time is only worth its name if it agrees
        ref = want if library_ref is None else library_ref(want)
        lib_rel = float((library_fn().reshape(ref.shape) - ref).abs().max() / ref.abs().max())
        if lib_rel > tol:
            fail(f"{label}: the library call differs from the plain version by {lib_rel:.3e}")
    ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn, reps=3)
    if chunks is None:
        lib_ms = cuda_ms(library_fn, reps=3) if library_fn is not None else None
    record(results, key, label, abs_err, rel, ms, plain_ms, lib_ms, dtype, work)


def record(results, key, label, abs_err, rel, ms, plain_ms, lib_ms, dtype, work):
    """Print and keep one case's numbers (compare): its bound from work =
    (bytes, operations[, peak rate]); fails above the dtype's tolerance."""
    tol = TOL[dtype]
    peak = work[2] if len(work) > 2 else PEAK_FLOPS[dtype]
    by_bytes, by_ops = work[0] / MEM_BYTES_PER_S, work[1] / peak
    bound_ms = 1e3 * max(by_bytes, by_ops)
    bound_by = "bytes" if by_bytes >= by_ops else "operations"
    ok = rel <= tol
    lib = f"{lib_ms:9.4f}" if lib_ms is not None else "     none"
    print(f"  {label:50s} rel err {rel:.3e} (tol {tol:.0e}) kernel {ms:9.4f} ms  "
          f"plain {plain_ms:9.4f}  library {lib}  bound {bound_ms:8.4f} ({bound_by}, "
          f"{100 * bound_ms / ms:5.1f} %)  {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail(f"{label}: relative error {rel:.3e} above {tol:.0e}")
    r = results.setdefault(key, {"max_abs_err": 0.0, "cases": []})
    r["max_abs_err"] = max(r["max_abs_err"], abs_err)
    case = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
    for k, val in case.items():
        r.setdefault(k, val)
    r["cases"].append(dict(case=label, max_abs_err=abs_err, **case))


def galerkin_face_links(s, mu):
    """The Galerkin build's face links of direction mu on rough16's 2^4
    aggregates (mg/galerkin.build_coarse_operator)."""
    from ddalphaamg_tpu_torch.mg.galerkin import _face_masks

    up, _ = _face_masks(s.lattice, (2, 2, 2, 2), (0, 0, 0, 0))
    face = torch.zeros_like(s.links)
    face[mu] = s.links[mu] * torch.as_tensor(up[mu], dtype=s.even.dtype, device=s.device)
    return face


def coarse_pairs(lat, terms, mask, parity):
    """(term, site) pairs a coarse apply needs: hops that cross a mask block
    face and sites of the other parity are skipped (global parity of a
    slab at offset 0); returns (pairs, sites whose field is read)."""
    import numpy as np

    c = np.indices(lat).reshape(4, -1)
    live = np.ones(c.shape[1], bool) if parity is None else (c.sum(0) % 2 == parity)
    pairs = 0
    for k in range(*terms):
        keep = live.copy()
        if k > 0 and mask is not None:
            mu = (k - 1) % 4
            r = c[mu] % mask[mu]
            keep &= (r != mask[mu] - 1) if k < 5 else (r != 0)
        pairs += int(keep.sum())
    return pairs, int(live.sum())


def coarse_work(blocks, v, lat, terms, mask=None, parity=None, faces=()):
    """(bytes, operations) of a coarse apply: the blocks of the needed
    (term, site) pairs, the field at the sites read, the faces, the output."""
    K, d = blocks.shape[0], blocks.shape[1]
    V = math.prod(lat)
    batch = v.numel() // (d * V)
    pairs, live = coarse_pairs(lat, terms, mask, parity)
    entry = nbytes(blocks) // (K * d * d * V)
    return (pairs * d * d * entry + batch * d * 8 * (live + V) + nbytes(*faces),
            8 * d * d * pairs * batch)


def schur_work(E, v, lat):
    """(bytes, operations) of one K4-schur apply: every site's 9 d x d
    block entries once (E and O), v at the even sites, the odd-site
    temporary written and read, the output written."""
    d, V = E.shape[1], math.prod(lat)
    batch = v.numel() // (d * V)
    return (2 * nbytes(E) + batch * d * 8 * (V // 2 + V + V), 8 * 9 * d * d * V * batch)


def check_schur_split(results, gen, d, L):
    """K4-schur (the coarsest Schur complement on parity-split blocks) at
    L^4 and (L/2)^4, d, bf16 and f32 blocks, batch 1 (rough32's and
    rough16's coarsest shapes) against its plain version, bit for bit
    against the four K4 launches it replaces (schur with the split path
    off), and the four launches' time beside it."""
    from ddalphaamg_tpu_torch.geometry import Geometry
    from ddalphaamg_tpu_torch.operators import coarse, cuda_coarse, stencil

    for lat in ((L,) * 4, (L // 2,) * 4):
        V = math.prod(lat)
        Pk = torch.randn((9, d, d, V), generator=gen, dtype=torch.complex64, device="cuda") * 0.1
        Pk[0] += torch.eye(d, dtype=Pk.dtype, device="cuda")[:, :, None]
        full = stencil.CoarseStencilSoA.from_blocks(Pk, Geometry(lat, (2, 2, 2, 2)))
        for s, tag in ((full.compress(), "bf16"), (full, "f32")):
            s.split()
            v = torch.randn((1, d, V), generator=gen, dtype=torch.complex64, device="cuda")
            label = f"K4-schur {tag} blocks {lat[0]}^4 d={d} batch 1"
            compare(results, "K4-schur", label,
                    lambda: cuda_coarse.schur_split(s.E, s.O, v, lat),
                    lambda: coarse.schur_split_plain(s.E, s.O, v, lat), torch.complex64,
                    schur_work(s.E, v, lat))

            def four():
                saved, stencil.SPLIT_SCHUR_DEVICES = stencil.SPLIT_SCHUR_DEVICES, ()
                try:
                    return stencil.schur(s, v)
                finally:
                    stencil.SPLIT_SCHUR_DEVICES = saved

            if not torch.equal(stencil.schur(s, v), four()):
                fail(f"{label}: not bit-equal to the four K4 launches")
            case = results["K4-schur"]["cases"][-1]
            case["four_launch_ms"], case["graph_ms"] = graph_ms(four), graph_ms(
                lambda: cuda_coarse.schur_split(s.E, s.O, v, lat))
            print(f"  {label}: bit-equal to the four K4 launches; as graph replays "
                  f"{case['graph_ms']:.4f} ms against the four launches' "
                  f"{case['four_launch_ms']:.4f} ms", flush=True)
        del Pk, full


def stacked_einsum(blocks, v, lat, terms, mask=None, halos=None, parity=None):
    """The library call for K4 / K5: one torch.einsum over the neighbour
    fields stacked beforehand (the TPU kernel's input, pallas_coarse.py:
    25-31), with the blocks zeroed at the other parity's sites for a parity
    apply; returns a function of no arguments."""
    import numpy as np

    from ddalphaamg_tpu_torch.operators import coarse, fast

    ks = range(*terms)
    fields = []
    masks = None
    if mask is not None:
        fwd, bwd = coarse.intra_block_masks(lat, mask)
        masks = torch.as_tensor(np.concatenate([fwd, bwd]).reshape(8, -1),
                                dtype=torch.float32, device=v.device)
    for k in ks:
        w = coarse.neighbor(v, k, lat, halos)
        fields.append(w * masks[k - 1] if masks is not None and k > 0 else w)
    # stored [x, j, k, i] and [x, j, k, b], so that the einsum's batched
    # product over x reads both without a copy
    B = coarse.widen(blocks[terms[0]:terms[1]])
    if parity is not None:
        B = B * fast.parity_mask(lat, parity, B.real.dtype, B.device)
    B = B.permute(3, 1, 0, 2).contiguous()
    stack = torch.stack(fields, dim=-1).permute(2, 1, 3, 0).contiguous()
    B, stack = B.permute(2, 1, 3, 0), stack.permute(3, 2, 1, 0)     # [k, j, i, x], [b, k, j, x]
    return lambda: torch.einsum("kjix,bkjx->bix", B, stack)


def spin_matrices(dtype, device):
    """[4, 2, 4, 4]: the spin matrix of the forward (0) and backward (1) hop
    of each direction in the plain K2, read off the plain version itself on
    a 3^4 lattice with unit links and unit sources at site 0."""
    from ddalphaamg_tpu_torch.operators import fast

    lat = (3,) * 4
    links = torch.eye(3, dtype=dtype, device=device)[None, :, :, None].expand(4, 3, 3, 81)
    phi = torch.zeros((12, 12, 81), dtype=dtype, device=device)
    phi[torch.arange(12), torch.arange(12), 0] = 1
    out = fast.dslash_hopping_soa(links.contiguous(), phi, lat).reshape(12, 12, *lat)
    S = torch.empty((4, 2, 4, 4), dtype=dtype, device=device)
    for mu in range(4):
        e = [0] * 4
        # the source at site 0 is phi(x + mu) at x = -mu, phi(x - mu) at x = +mu
        for side, step in ((0, -1), (1, 1)):
            e[mu] = step % 3
            # out[j, i] = H[i, j]; colour 0 of each spin
            S[mu, side] = out[:, :, e[0], e[1], e[2], e[3]].T[::3, ::3]
    return S


def dslash_work(key, phi, links=None, clover=None, parity=None):
    """(bytes, operations) of K1-K3 on these inputs: the links and the
    packed clover once (the clover's half at the sites of a parity), the
    input field (half of it for a parity apply: the clover there reads the
    sites of that parity, the hops the other's) and the output."""
    half = 1 if parity is None else 2
    V = phi.shape[-1]
    batch = phi.numel() // (12 * V)
    moved = (nbytes(links) if links is not None else 0) + nbytes(phi) + nbytes(phi) // half
    if clover is not None:
        moved += nbytes(*clover) // half
    return moved, DSLASH_FLOPS[key] * V * batch // half


def dslash_library(links, phi, lat, clover=None, parity=None, parity_offset=0):
    """The library call for K1 (with clover = (cdiag, coff)) and K2: one
    torch.einsum over per-site 12 x 12 hop matrices (spin matrix (x) link,
    the backward ones at x - mu) and the neighbour fields stacked
    beforehand, the clover as a ninth, self term, the matrices zeroed at
    the other parity's sites for a parity apply; returns a function of no
    arguments."""
    from ddalphaamg_tpu_torch.operators import fast

    S = spin_matrices(phi.dtype, phi.device)
    u = links.reshape(4, 3, 3, *lat)
    p = phi.reshape(*phi.shape[:-1], *lat)
    mats, fields = [], []
    for mu in range(4):
        ax = p.dim() - 4 + mu
        udag = torch.roll(u[mu].conj().transpose(0, 1), 1, 2 + mu)       # U^H(x - mu)
        for side, w, uu in ((0, torch.roll(p, -1, ax), u[mu]), (1, torch.roll(p, 1, ax), udag)):
            mats.append(torch.einsum("st,abx->satbx", S[mu, side],
                                     uu.reshape(3, 3, -1)).reshape(12, 12, -1))
            fields.append(w.reshape(phi.shape))
    if clover is not None:
        dense = fast.unpack_clover(*clover).to(phi.dtype)
        c12 = torch.zeros((12, 12, dense.shape[-1]), dtype=phi.dtype, device=phi.device)
        c12[:6, :6], c12[6:, 6:] = dense[0], dense[1]
        mats.append(c12)
        fields.append(phi)
    H = torch.stack(mats, dim=-1)
    if parity is not None:
        H = H * fast.parity_mask(lat, parity, H.real.dtype, H.device, parity_offset)[:, None]
    # stored [x, i, j, k] and [x, j, k, b]: no copy inside the einsum
    H = H.permute(2, 0, 1, 3).contiguous().permute(3, 1, 2, 0)
    stack = torch.stack(fields, dim=-1).permute(2, 1, 3, 0).contiguous().permute(3, 2, 1, 0)
    return lambda: torch.einsum("kijx,bkjx->bix", H, stack)


def clover_library(cdiag, coff, phi, lat, parity=None, parity_offset=0):
    """The library call for K3: one torch.einsum over the clover (full
    storage) unpacked beforehand into two dense 6 x 6 blocks per site
    (K3's plain version minus the unpacking), with a parity zero at the
    other parity's sites."""
    from ddalphaamg_tpu_torch.operators import fast

    dense = fast.unpack_clover(cdiag, coff).to(phi.dtype)
    if parity is not None:
        dense = dense * fast.parity_mask(lat, parity, dense.real.dtype, dense.device,
                                         parity_offset)
    # stored [c, x, i, j] and [c, x, j, b]: no copy inside the einsum
    dense = dense.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    ph = phi.reshape(phi.shape[0], 2, 6, phi.shape[-1]).permute(1, 3, 2, 0).contiguous()
    ph = ph.permute(3, 0, 2, 1)
    return lambda: torch.einsum("cijx,bcjx->bcix", dense, ph)


ROUGH16 = tuple(e // 2 for e in ROUGH32)      # rough32's depth-1 lattice
BLOCK = (2, 2, 2, 2)
FULL, MASKED = ((0, 9), None, None, 0), ((0, 9), BLOCK, None, 0)
# the launch shapes phase 3 holds for phase rough32, as launch_shapes notes
# them: (kernel, lattice, d, batch, dtype, variant), variant (parity,
# parity_offset[, compact]) for K2 / K3, (terms, mask, parity,
# parity_offset) for K4
ROUGH32_SHAPES = (
    [("K1", ROUGH32, 12, 1, dt, None) for dt in (torch.complex64, torch.complex128)]
    + [("K2", ROUGH32, 12, 1, torch.complex64, (1, 0)),
       ("K3", ROUGH32, 12, 1, torch.complex64, (None, 0, False))]
    + [(k, ROUGH16, 56, B, torch.complex64, v)
       for k in ("K4", "K4-bf16") for B in BATCHES for v in (FULL, MASKED)]
    + [("K4", ROUGH16, 56, GALERKIN_BATCH, torch.complex64, MASKED)])
# above this many bytes of inputs stacked for it (or a third of the card's
# free memory), a row's library call runs over chunks of lanes of at most
# LIBRARY_CHUNK_BYTES stacked, its time the sum (the nine neighbour fields of
# K1 / K2 at 32^4 beside the 12 x 12 hop matrices; the stacking holds the
# fields twice)
LIBRARY_MAX_BYTES = 12 * 2**30
LIBRARY_CHUNK_BYTES = 6 * 2**30


@contextlib.contextmanager
def launch_shapes(shapes):
    """Adds to the set `shapes` the shape of every K1-K4 launch on
    rough32's lattices (32^4 and 16^4) while the context runs, in the form
    of ROUGH32_SHAPES."""
    from ddalphaamg_tpu_torch.operators import cuda_coarse, cuda_dslash

    def dslash(key, field):
        def note(a):
            phi = a[field]
            batch = phi.numel() // (12 * phi.shape[-1])
            variant = {"K1": None, "K2": (a.get("parity"), a.get("parity_offset")),
                       "K3": (a.get("parity"), a.get("parity_offset"), a.get("compact"))}[key]
            return key, 12, batch, phi.dtype, variant
        return note

    def coarse(a):
        blocks, v = a["blocks"], a["v"]
        d = blocks.shape[1]
        mask = None if a["mask_block"] is None else tuple(a["mask_block"])
        return ("K4-bf16" if cuda_coarse._instance(blocks, v) == "bf16" else "K4", d,
                v.numel() // (d * v.shape[-1]), v.dtype,
                (tuple(a["terms"]), mask, a["parity"], a["parity_offset"]))

    wrapped = {(cuda_dslash, "d_plus_clover"): dslash("K1", "phi"),
               (cuda_dslash, "hopping"): dslash("K2", "phi"),
               (cuda_dslash, "clover"): dslash("K3", "phi"),
               (cuda_coarse, "coarse_apply"): coarse}
    saved = {key: getattr(*key) for key in wrapped}

    def recorder(fn, note):
        sig = inspect.signature(fn)

        def recording(*args, **kw):
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            lat = tuple(a.arguments["lattice"])
            if lat in (ROUGH32, ROUGH16):
                key, d, batch, dtype, variant = note(a.arguments)
                shapes.add((key, lat, d, batch, dtype, variant))
            return fn(*args, **kw)
        return recording

    for (mod, name), note in wrapped.items():
        setattr(mod, name, recorder(saved[(mod, name)], note))
    try:
        yield shapes
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def by_lanes(fn, x, lane_bytes=2**30):
    """fn over the lanes of x [B, ...] in groups of at most lane_bytes of
    x (one group for all but the largest batches), concatenated: a plain
    version's temporaries at 32^4 and batch 50 would not fit the card."""
    per = max(1, lane_bytes // (x[0].numel() * x.element_size()))
    if x.shape[0] <= per:
        return lambda: fn(x)
    return lambda: torch.cat([fn(x[i:i + per]) for i in range(0, x.shape[0], per)])


def shape_label(shape):
    key, lat, d, batch, dtype, variant = shape
    tag = {torch.complex64: "f32", torch.complex128: "f64"}[dtype]
    if key in ("K4", "K4-bf16"):
        terms, mask, parity, off = variant
        what = (f"{'block masked' if mask else 'full'} terms {terms[0]}-{terms[1] - 1}"
                + ("" if parity is None else f" parity {parity} offset {off}"))
        return f"{key} {what} {lat[0]}^4 d={d} batch {batch}"
    if key == "K1":
        what = "full"
    elif key == "K2":
        what = ("hop (Galerkin face links t, all sites)" if variant[0] is None else
                f"hop (block links, {'odd' if variant[0] else 'even'} sites)")
    else:
        parity, off, compact = variant
        what = ("clover" if not compact else f"clover inverse compact, offset {off}") + (
            "" if parity is None else f" {'odd' if parity else 'even'} sites")
    return f"{key} {what} {lat[0]}^4 {tag} batch {batch}"


def check_rough32_kernels(results, gen, U32, m0, csw, shapes):
    """Each launch shape of phase rough32 in `shapes` (ROUGH32_SHAPES, or
    those launch_shapes noted) against its plain version: K1-K3 on the
    rough32 field's stencil at 32^4 (K1 on the full links, K2 with a parity
    on the block links and without one on the Galerkin build's face links,
    K3 with the clover or the odd-site inverse's compact storage), K4 and
    K4-bf16 on random blocks at 16^4 (bf16: the same blocks rounded).  The
    plain version runs over groups of lanes (by_lanes); the library call of
    K1 / K2 over chunks of lanes where its stacked inputs would pass
    LIBRARY_MAX_BYTES or a third of the card's free memory."""
    from ddalphaamg_tpu_torch.geometry import Geometry
    from ddalphaamg_tpu_torch.operators import coarse, cuda_coarse, cuda_dslash, fast
    from ddalphaamg_tpu_torch.operators.stencil import WilsonStencilSoA, herm_inv
    from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator

    dev = torch.device("cuda")
    order = {"K1": 0, "K2": 1, "K3": 2, "K4": 3, "K4-bf16": 4}
    shapes = sorted(shapes, key=lambda t: (order[t[0]], t[1], str(t[4]), t[3], str(t[5])))
    wilson = [t for t in shapes if t[0] in ("K1", "K2", "K3")]
    if wilson:
        op = WilsonOperator.from_gauge(torch.as_tensor(U32, device=dev), m0, csw)
        inv = cuda_dslash.pack_clover(fast.clover_to_soa(herm_inv(op.clover)))
    for dtype in (torch.complex64, torch.complex128):
        rows = [t for t in wilson if t[4] == dtype]
        if not rows:
            continue
        s = WilsonStencilSoA.build(op, Geometry(lattice=ROUGH32, block=BLOCK), dtype=dtype)
        lat, V = ROUGH32, s.geom.num_sites
        for shape in rows:
            key, _, _, B, _, variant = shape
            phi = torch.randn((B, 12, V), generator=gen, dtype=dtype, device=dev)
            per = max(1, LIBRARY_CHUNK_BYTES // (9 * nbytes(phi[:1])))

            def library(*a, **k):
                """dslash_library over phi, in chunks of `per` lanes where
                its stacked inputs would pass LIBRARY_MAX_BYTES or a third
                of the card's free memory."""
                limit = min(LIBRARY_MAX_BYTES, torch.cuda.mem_get_info(dev)[0] // 3)
                if 9 * nbytes(phi) <= limit:
                    return dslash_library(*a[:1], phi, *a[1:], **k)
                return [(lambda l0=l0: dslash_library(*a[:1], phi[l0:l0 + per], *a[1:], **k),
                         (l0, min(B, l0 + per))) for l0 in range(0, B, per)]

            if key == "K1":
                kern = lambda: cuda_dslash.d_plus_clover(s.links, s.cdiag, s.coff, phi, lat)
                plain = by_lanes(lambda x: fast.d_plus_clover_soa(
                    s.links, s.cdiag, s.coff, x, lat), phi)
                work = dslash_work("K1", phi, s.links, (s.cdiag, s.coff))
                lib = library(s.links, lat, (s.cdiag, s.coff))
            elif key == "K2":
                parity, off = variant
                links = s.links_intra if parity is not None else galerkin_face_links(s, 0)
                kern = lambda: cuda_dslash.hopping(links, phi, lat, parity, off)
                plain = by_lanes(lambda x: fast.dslash_hopping_soa(links, x, lat, parity, off),
                                 phi)
                work = dslash_work("K2", phi, links, parity=parity)
                lib = library(links, lat, parity=parity, parity_offset=off)
            else:
                parity, off, compact = variant
                full = ((s.cdiag, s.coff) if not compact else
                        tuple(t.to(u.dtype) for t, u in zip(inv, (s.cdiag, s.coff))))
                cd, co = (full if not compact else
                          tuple(fast.compact_parity(t, lat, parity, off) for t in full))
                kern = lambda: cuda_dslash.clover(cd, co, phi, lat, parity, off, compact)
                plain = by_lanes(lambda x: fast.clover_apply_soa(
                    cd, co, x, lat, parity, off, compact), phi)
                work = dslash_work("K3", phi, clover=full, parity=parity)
                lib = clover_library(*full, phi, lat, parity, off)
            label = shape_label(shape) + (f" (library in {len(lib)} chunks of lanes, summed)"
                                          if isinstance(lib, list) else "")
            compare(results, key, label, kern, plain, dtype, work, lib)
            del phi, kern, plain, lib
            torch.cuda.empty_cache()
        del s
        torch.cuda.empty_cache()
    if wilson:
        del op, inv
    coarse_rows = [t for t in shapes if t[0] in ("K4", "K4-bf16")]
    if {(t[1], t[2]) for t in coarse_rows} - {(ROUGH16, 56)}:
        fail(f"rough32 launched a coarse kernel off 16^4 d = 56: {coarse_rows}")
    clat, d, V = ROUGH16, 56, math.prod(ROUGH16)
    Pk = torch.randn((9, d, d, V), generator=gen, dtype=torch.complex64, device=dev)
    for key in ("K4", "K4-bf16"):
        if key == "K4-bf16":
            Pk = coarse.compress(Pk)
        for shape in (t for t in coarse_rows if t[0] == key):
            _, _, _, B, dtype, (terms, mask, parity, off) = shape
            v = torch.randn((B, d, V), generator=gen, dtype=dtype, device=dev)
            compare(results, key, shape_label(shape),
                    lambda: cuda_coarse.coarse_apply(Pk, v, clat, terms, mask, parity, off),
                    by_lanes(lambda x: coarse.coarse_apply_plain(Pk, x, clat, terms, mask,
                                                                 parity, off), v),
                    dtype, coarse_work(Pk, v, clat, terms, mask, parity),
                    stacked_einsum(Pk, v, clat, terms, mask, parity=parity))
            del v
            torch.cuda.empty_cache()
    del Pk
    torch.cuda.empty_cache()


def check_kernels(results, U32):
    import numpy as np

    from ddalphaamg_tpu_torch import io, utils
    from ddalphaamg_tpu_torch.geometry import Geometry
    from ddalphaamg_tpu_torch.operators import coarse, cuda_coarse, cuda_dslash, fast
    from ddalphaamg_tpu_torch.operators.stencil import EVEN, ODD, WilsonStencilSoA, herm_inv
    from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    utils.pin_full_precision()        # the library calls run in full f32, as the kernels
    params = rough16_params()
    U, _ = io.read_gauge_field(params.configuration)
    lat = tuple(U.shape[1:5])
    op = WilsonOperator.from_gauge(torch.as_tensor(U, device=dev),
                                   params.m0, params.csw)
    geom = Geometry(lattice=lat, block=(2, 2, 2, 2))
    inv = cuda_dslash.pack_clover(fast.clover_to_soa(herm_inv(op.clover)))   # every site
    for dtype in (torch.complex64, torch.complex128):
        s = WilsonStencilSoA.build(op, geom, dtype=dtype)
        tag = "f32" if dtype == torch.complex64 else "f64"
        V = s.geom.num_sites
        for B in BATCHES + ((GALERKIN_BATCH,) if dtype == torch.complex64 else ()):
            phi = torch.randn((B, 12, V), generator=gen, dtype=dtype, device=dev)
            lab = f"{lat[0]}^4 {tag} batch {B}"
            compare(results, "K1", f"K1 full {lab}",
                    lambda: cuda_dslash.d_plus_clover(s.links, s.cdiag, s.coff, phi, lat),
                    lambda: fast.d_plus_clover_soa(s.links, s.cdiag, s.coff, phi, lat),
                    dtype, dslash_work("K1", phi, s.links, (s.cdiag, s.coff)),
                    dslash_library(s.links, phi, lat, (s.cdiag, s.coff)))
            if dtype != torch.complex64:
                continue
            if B == GALERKIN_BATCH:    # the Galerkin build's face hops (mg/galerkin.py)
                face = galerkin_face_links(s, 0)
                compare(results, "K2", f"K2 hop (face links t, all sites) {lab}",
                        lambda: cuda_dslash.hopping(face, phi, lat),
                        lambda: fast.dslash_hopping_soa(face, phi, lat), dtype,
                        dslash_work("K2", phi, face), dslash_library(face, phi, lat))
                continue
            blocks = ((None, "all sites"), (ODD, "odd sites"))
            if B == 1:      # the block odd-even solve's other half
                blocks += ((EVEN, "even sites"),)
            for parity, sites in blocks:
                compare(results, "K2", f"K2 hop (block links, {sites}) {lab}",
                        lambda: cuda_dslash.hopping(s.links_intra, phi, lat, parity),
                        lambda: fast.dslash_hopping_soa(s.links_intra, phi, lat, parity), dtype,
                        dslash_work("K2", phi, s.links_intra, parity=parity),
                        dslash_library(s.links_intra, phi, lat, parity=parity))
            if B == 1:      # method 4's D_eo / D_oe: the full links, one parity
                for parity, sites in ((EVEN, "even sites"), (ODD, "odd sites")):
                    compare(results, "K2", f"K2 hop (full links, {sites}) {lab}",
                            lambda: cuda_dslash.hopping(s.links, phi, lat, parity),
                            lambda: fast.dslash_hopping_soa(s.links, phi, lat, parity), dtype,
                            dslash_work("K2", phi, s.links, parity=parity),
                            dslash_library(s.links, phi, lat, parity=parity))
            compare(results, "K3", f"K3 clover {lab}",
                    lambda: cuda_dslash.clover(s.cdiag, s.coff, phi, lat),
                    lambda: fast.clover_apply_soa(s.cdiag, s.coff, phi), dtype,
                    dslash_work("K3", phi, clover=(s.cdiag, s.coff)),
                    clover_library(s.cdiag, s.coff, phi, lat))
            if B == 1:      # method 4's A_ee: the clover on the even sites
                compare(results, "K3", f"K3 clover even sites {lab}",
                        lambda: cuda_dslash.clover(s.cdiag, s.coff, phi, lat, EVEN),
                        lambda: fast.clover_apply_soa(s.cdiag, s.coff, phi, lat, EVEN), dtype,
                        dslash_work("K3", phi, clover=(s.cdiag, s.coff), parity=EVEN),
                        clover_library(s.cdiag, s.coff, phi, lat, EVEN))
            # the odd-site inverse from its compact storage (the stencil's own,
            # and at batch 1 that of a slab at an odd global offset)
            for off in (0, 1) if B == 1 else (0,):
                full = tuple(t.to(u.dtype) for t, u in zip(inv, (s.cdiag, s.coff)))
                cd, co = (fast.compact_parity(t, lat, ODD, off) for t in full)
                compare(results, "K3", f"K3 clover inverse odd (compact, offset {off}) {lab}",
                        lambda: cuda_dslash.clover(cd, co, phi, lat, ODD, off, compact=True),
                        lambda: fast.clover_apply_soa(cd, co, phi, lat, ODD, off, compact=True),
                        dtype, dslash_work("K3", phi, clover=full, parity=ODD),
                        clover_library(*full, phi, lat, ODD, off))
            if B == 1:      # a (1, 1, 1, 2) rank's slab, offset odd in x alone
                xlat = (*lat[:3], lat[3] // 2)
                xlinks, xphi = (t.reshape(*t.shape[:-1], *lat)[..., :xlat[3]].reshape(
                    *t.shape[:-1], -1).contiguous() for t in (s.links, phi))
                compare(results, "K2", f"K2 hop (full links, odd sites) slab {xlat} at "
                        f"offset 1 {tag} batch 1",
                        lambda: cuda_dslash.hopping(xlinks, xphi, xlat, ODD, 1),
                        lambda: fast.dslash_hopping_soa(xlinks, xphi, xlat, ODD, 1), dtype,
                        dslash_work("K2", xphi, xlinks, parity=ODD),
                        dslash_library(xlinks, xphi, xlat, parity=ODD, parity_offset=1))
            if B == 1:      # a (1, 2, 1, 1) rank's slab shape at an odd offset
                slat = (lat[0], lat[1] // 2, lat[2], lat[3])
                sfull = tuple(t[..., :V // 2].contiguous() for t in full)
                sphi = phi[..., :V // 2].contiguous()
                scd, sco = (fast.compact_parity(t, slat, ODD, 1) for t in sfull)
                compare(results, "K3", f"K3 clover inverse odd (compact, offset 1) slab "
                        f"{slat} {tag} batch 1",
                        lambda: cuda_dslash.clover(scd, sco, sphi, slat, ODD, 1, compact=True),
                        lambda: fast.clover_apply_soa(scd, sco, sphi, slat, ODD, 1,
                                                      compact=True),
                        dtype, dslash_work("K3", sphi, clover=sfull, parity=ODD),
                        clover_library(*sfull, sphi, slat, ODD, 1))
        del s
    d = 2 * params.depth[0].test_vectors
    cases = [("full K=9", (0, 9), None, None), ("hop K=8", (1, 9), None, None),
             ("block masked K=9", (0, 9), (2, 2, 2, 2), None),
             ("hop_intra masked K=8", (1, 9), (2, 2, 2, 2), None),
             ("self K=1", (0, 1), None, None), ("self_inv odd K=1", (0, 1), None, ODD)]
    # the batched applies of the setup at d = 2N: the coarsest level's Schur
    # inverse from 256 one-hot columns a launch (operators/stencil.py
    # _invert_columns), the Galerkin build of the coarsest operator from the
    # 2N basis fields (mg/galerkin.py), the depth-1 block inverses from 128
    # columns a launch (smoothers/sap.build_block_inverse)
    setup = {lat[0] // 4: [("full K=9", (0, 9), None, None, 256, "Schur columns"),
                           ("hop K=8", (1, 9), None, None, 256, "Schur columns"),
                           ("self_inv odd K=1", (0, 1), None, ODD, 256, "Schur columns")],
             lat[0] // 2: [("block masked K=9", (0, 9), (2, 2, 2, 2), None, d, "Galerkin"),
                           ("block masked K=9", (0, 9), (2, 2, 2, 2), None, 128,
                            "block-inverse columns")]}
    for L in (lat[0] // 2, lat[0] // 4):
        clat = (L,) * 4
        V = int(np.prod(clat))
        Pk = torch.randn((9, d, d, V), generator=gen, dtype=torch.complex64, device=dev)
        Pk16 = coarse.compress(Pk)
        runs = [(key, blocks, B, case) for key, blocks in (("K4", Pk), ("K4-bf16", Pk16))
                for B in BATCHES for case in cases]
        runs += [("K4", Pk, B, (f"{name} ({what})", terms, mask, parity))
                 for name, terms, mask, parity, B, what in setup[L]]
        for key, blocks, B, (name, terms, mask, parity) in runs:
            v = torch.randn((B, d, V), generator=gen, dtype=torch.complex64, device=dev)
            compare(results, key, f"{key} {name} {L}^4 d={d} batch {B}",
                    lambda: cuda_coarse.coarse_apply(blocks, v, clat, terms, mask, parity),
                    lambda: coarse.coarse_apply_plain(blocks, v, clat, terms, mask, parity),
                    torch.complex64, coarse_work(blocks, v, clat, terms, mask, parity),
                    stacked_einsum(blocks, v, clat, terms, mask, parity=parity))
        del Pk, Pk16
    check_schur_split(results, gen, d, lat[0] // 2)
    check_halo_kernels(results, gen, (lat[0] // 2,) * 4, d)
    check_peer_kernels(results, gen, lat, d)
    check_dense_kernel(results, gen, d, lat)
    check_gram_schmidt(results, gen)
    check_step_launches(gen)
    check_rough32_kernels(results, gen, U32, params.m0, params.csw, ROUGH32_SHAPES)


def jrow_orthonormalize(W, Q, j: int, w, q):
    """The library call's Gram-Schmidt: classical Gram-Schmidt of w [B, n]
    against the first j rows of W [B, m, n] through cuBLAS products over
    those rows, applied alike to q, normalized, written to row j of W and
    Q (the slab step before it took all m rows with a mask)."""
    if j:
        h = (W[:, :j].conj() @ w.unsqueeze(-1)).transpose(-1, -2)
        w = w - (h @ W[:, :j]).squeeze(1)
        q = q - (h @ Q[:, :j]).squeeze(1)
    wn = torch.linalg.vector_norm(w, dim=-1)
    inv = wn.masked_fill(wn == 0, 1.0).reciprocal()[:, None]
    torch.mul(w, inv, out=W[:, j])
    torch.mul(q, inv, out=Q[:, j])
    return W[:, j], Q[:, j]


def check_gram_schmidt(results, gen):
    """K7 (operators/cuda_gcr.gcr_step: the GCR step after the operator
    apply) against its plain version (gcr_step_plain) at the GCR shapes of
    the paths (K7_CASES), batch 1 and 12: random bases whose rows below j
    are filled and the rest zero, every lane going (stop 0).  The error:
    rows j, x, r and |r| after one step from the same state, the worst
    relative error of the four.  The times: a step as raw launches
    captured in a CUDA graph (graph_ms), for the kernel, the plain version
    and the library call, the sequence the port ran before K7 took the
    whole step (the j-row torch products through cuBLAS, jrow_orthonormalize,
    then vecdot, the updates, the iteration count, the norm and the stop
    test).  Bound: (2j + 8) n elements a lane (the rows below j of W and
    Q, w, q, r and x read; rows j, x and r written) over 3.35 TB/s."""
    from ddalphaamg_tpu_torch import kernels
    from ddalphaamg_tpu_torch.operators import cuda_gcr

    for label, n, m, rows, batches, dtype in K7_CASES:
        for B in batches:
            W = torch.zeros((B, m, n), dtype=dtype, device="cuda")
            Q = torch.zeros_like(W)
            real = W.real.dtype
            base = dict(x=torch.randn((B, n), generator=gen, dtype=dtype, device="cuda"),
                        r=torch.randn((B, n), generator=gen, dtype=dtype, device="cuda"),
                        go=torch.ones(B, dtype=torch.bool, device="cuda"),
                        stop=torch.zeros(B, dtype=real, device="cuda"),
                        rn=torch.ones(B, dtype=real, device="cuda"),
                        iters=torch.zeros(B, dtype=torch.long, device="cuda"))
            base["rz"] = base["r"].clone() if B > 1 else None
            work = cuda_gcr.scratch(B, m, n, dtype, "cuda")
            filled = 0
            for j in rows:
                W[:, filled:j] = torch.randn((B, j - filled, n), generator=gen, dtype=dtype,
                                             device="cuda") / math.sqrt(n)
                Q[:, filled:j] = torch.randn((B, j - filled, n), generator=gen, dtype=dtype,
                                             device="cuda") / math.sqrt(n)
                filled = j
                w = torch.randn((B, n), generator=gen, dtype=dtype, device="cuda")
                q = torch.randn((B, n), generator=gen, dtype=dtype, device="cuda")
                jt = torch.tensor(j, device="cuda")

                def args(st):
                    return (W, Q, jt, w, q, st["x"], st["r"], st["rz"], st["go"], st["stop"],
                            None, st["rn"], st["iters"])

                def kernel(st):
                    cuda_gcr.gcr_step(*args(st), work)

                def plain(st):
                    cuda_gcr.gcr_step_plain(*args(st))

                def library(st, j=j):
                    wo, qo = jrow_orthonormalize(W, Q, j, w, q)
                    cuda_gcr.update_step(wo, qo, st["x"], st["r"], st["rz"], st["go"],
                                         st["stop"], None, st["rn"], st["iters"])

                outs = {}
                for name, fn in (("kernel", kernel), ("plain", plain), ("library", library)):
                    st = {k: None if v is None else v.clone() for k, v in base.items()}
                    fn(st)
                    outs[name] = (W[:, j].clone(), Q[:, j].clone(), st["x"], st["r"], st["rn"])
                torch.cuda.synchronize()

                def worst(got, want):
                    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
                    return max(errs), max(float((a - b).abs().max()) for a, b in zip(got, want))

                rel, abs_err = worst(outs["kernel"], outs["plain"])
                lib_rel, _ = worst(outs["library"], outs["plain"])
                tag = "c64" if dtype == torch.complex64 else "c128"
                name = f"K7 {label} {tag} m={m} j={j} batch {B}"
                if lib_rel > TOL[dtype]:
                    fail(f"{name}: the library sequence differs from the plain version by "
                         f"{lib_rel:.3e}")
                live = {fn: {k: None if v is None else v.clone() for k, v in base.items()}
                        for fn in (kernel, plain, library)}
                ms = graph_ms(lambda: kernel(live[kernel]))
                plain_ms = graph_ms(lambda: plain(live[plain]), reps=5)
                lib_ms = graph_ms(lambda: library(live[library]), reps=5)
                esize = W.element_size()
                record(results, "K7", name, abs_err, rel, ms, plain_ms, lib_ms, dtype,
                       ((2 * j + 8) * n * B * esize, (24 * j + 40) * n * B))
                path = "cluster" if kernels.lib().ddaamg_gcr_path(
                    n, m, int(dtype == torch.complex128)) == 0 else "grid"
                results["K7"]["cases"][-1]["design"] = path
                print(f"    {name}: the {path} design, library rel err {lib_rel:.3e}",
                      flush=True)
            del W, Q, work
            torch.cuda.empty_cache()


def check_step_launches(gen):
    """One GCRLanes.step (solvers/device_gmres.py) profiled on the card,
    after a warm-up step: besides the operator apply (one torch
    multiplication here) and, at batch 2, the preconditioner (a
    multiplication and its counters, a fill) and the aux sum (a where and
    an add), its CUDA kernels are K7's alone, one at 4^4 d 56 (the cluster
    design) and two at 8^4 d 56 (the grid design)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ddalphaamg_tpu_torch.solvers.device_gmres import GCRLanes

    def prec(v):
        return 2 * v, torch.ones((v.shape[0], 3), dtype=torch.float64, device=v.device)

    def op(v):
        return v * 2

    for n, design, k7 in ((4**4 * 56, "cluster", 1), (8**4 * 56, "grid", 2)):
        for B in (1, 2):
            b = torch.randn((B, n), generator=gen, dtype=torch.complex64, device="cuda")
            st = GCRLanes(b, 10, 1e-12, n_aux=3 if B > 1 else 0)
            p = prec if B > 1 else None
            st.restart(op)
            st.step(0, op, p)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                st.step(1, op, p)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            ours = [x for x in names if KERNEL_EVENTS["K7"].search(x)]
            others = [x.split("(")[0][:60] for x in names if not KERNEL_EVENTS["K7"].search(x)]
            allowed = 1 + (4 if B > 1 else 0)
            print(f"  GCRLanes.step {n} elements batch {B} ({design}): K7 {len(ours)} kernel(s), "
                  f"{len(others)} other(s) (operator{', preconditioner, aux sum' if B > 1 else ''}"
                  f": {allowed} allowed): {others}", flush=True)
            if len(ours) != k7 or len(others) > allowed:
                fail(f"GCRLanes.step at n = {n}, batch {B} launched {len(ours)} K7 kernels "
                     f"(want {k7}) and {len(others)} others (at most {allowed})")


def check_halo_kernels(results, gen, glat, d):
    """K5 and K5-bf16 on rank 0's slab of the depth-1 level, on the
    (1, 2, 1, 1) mesh (z faces) and the (2, 2, 1, 1) mesh (t and z faces)
    of the sharded paths, the (1, 1, 2, 2) mesh (y and x faces) of phase
    grid4d and the (2, 2, 2, 2) mesh (faces on all four axes), with faces
    cut from a random global field."""
    from ddalphaamg_tpu_torch.operators import coarse, cuda_coarse
    from ddalphaamg_tpu_torch.parallel.comm import face
    from ddalphaamg_tpu_torch.parallel.mesh import (SolverMesh, active_axes,
                                                    local_lattice, shard_field)

    dev = torch.device("cuda")
    for dims in ((1, 2, 1, 1), (2, 2, 1, 1), (1, 1, 2, 2), (2, 2, 2, 2)):
        mesh = SolverMesh(dims, 0)
        loc = local_lattice(mesh, glat)
        Pk = torch.randn((9, d, d, math.prod(loc)), generator=gen,
                         dtype=torch.complex64, device=dev)
        Pk16 = coarse.compress(Pk)
        for B in BATCHES:
            vg = torch.randn((B, d, math.prod(glat)), generator=gen,
                             dtype=torch.complex64, device=dev)
            v = shard_field(mesh, vg, glat)
            halos = {}
            for mu in active_axes(mesh, glat):
                fwd = shard_field(mesh, coarse.neighbor(vg, 1 + mu, glat), glat)  # v(x + mu)
                bwd = shard_field(mesh, coarse.neighbor(vg, 5 + mu, glat), glat)  # v(x - mu)
                halos[mu] = (face(fwd, loc, mu, loc[mu] - 1).contiguous(),
                             face(bwd, loc, mu, 0).contiguous())
            faces = [f for pair in halos.values() for f in pair]
            for key, blocks in (("K5", Pk), ("K5-bf16", Pk16)):
                for name, terms in (("full K=9", (0, 9)), ("hop K=8", (1, 9))):
                    compare(results, key, f"{key} {name} mesh {dims} slab {loc} d={d} batch {B}",
                            lambda: cuda_coarse.coarse_apply_halo(blocks, v, loc, halos, terms),
                            lambda: coarse.coarse_apply_halo_plain(blocks, v, loc, halos, terms),
                            torch.complex64, coarse_work(blocks, v, loc, terms, faces=faces),
                            stacked_einsum(blocks, v, loc, terms, halos=halos))
        del Pk, Pk16


def check_peer_kernels(results, gen, lat, d):
    """K8 (parallel/peer.py, csrc/peer.cu) with the ranks of the (1, 2, 1, 1)
    and (1, 1, 2, 2) grids as Peers of this one process on this card
    (Peers.local_group: each rank's kernels on a stream of its own, all in
    flight together) at the shapes of the grid solve of rough16 (lat, d):
    the exchange of the fine half-spinor faces and of the depth-1 coarse
    faces (every split axis, both ways, batch 1), the all-reduce of a GCR's
    [12, 50] products and of [12] norms, the gather of the coarsest level's
    slabs; held bit for bit against the plain versions (copies, the sum in
    rank order, the stack).  Bound: every rank's inputs read and outputs
    written once over 3.35 TB/s (one card holds all the ranks here)."""
    from ddalphaamg_tpu_torch.parallel import peer
    from ddalphaamg_tpu_torch.parallel.mesh import active_axes, local_lattice

    dev = torch.device("cuda")
    c64 = torch.complex64
    for dims in ((1, 2, 1, 1), (1, 1, 2, 2)):
        group = peer.Peers.local_group(dims, dev)
        P = len(group)
        streams = [torch.cuda.Stream(dev) for _ in range(P)]

        def on_all(fn):
            """fn(rank) on every rank's stream, joined to the current one."""
            cur = torch.cuda.current_stream(dev)
            outs = []
            for r, st in enumerate(streams):
                st.wait_stream(cur)
                with torch.cuda.stream(st):
                    outs.append(fn(r))
            for st in streams:
                cur.wait_stream(st)
            return outs

        def flat(outs):
            return torch.cat([torch.view_as_real(o).reshape(-1) if o.is_complex()
                              else o.reshape(-1) for per in outs for o in per])

        meshes = [g.mesh for g in group]
        fine_loc = local_lattice(meshes[0], lat)
        coarse_loc = local_lattice(meshes[0], tuple(n // 2 for n in lat))
        axes = active_axes(meshes[0], lat)
        cases = {"fine half-spinor faces": (1, 2, 3, fine_loc),
                 f"coarse faces d={d}": (1, d, 1, coarse_loc)}
        for what, (B, a, b, loc) in cases.items():
            V = math.prod(loc)
            sends = [[(mu, *(torch.randn((B, a * b, V // loc[mu]), generator=gen, dtype=c64,
                                         device=dev) for _ in range(2))) for mu in axes]
                     for _ in range(P)]

            def kernel():
                posted = on_all(lambda r: group[r].post(sends[r]))
                return flat(on_all(lambda r: group[r].finish(posted[r])))

            def plain():
                return flat([[f for pair in peer.exchange_plain(sends, meshes, r) for f in pair]
                             for r in range(P)])

            if not torch.equal(kernel(), plain()):
                fail(f"K8 exchange of the {what} on {dims} differs from the plain copies")
            nbytes = sum(t.numel() * 8 for per in sends for _, x, y in per for t in (x, y))
            compare(results, "K8", f"K8 exchange post + finish, {what}, grid {dims}, batch {B}",
                    kernel, plain, c64, (2 * nbytes, 0))
        for what, shape, dtype in (("GCR products [12, 50]", (12, 50), c64),
                                   ("norms [12]", (12,), torch.float32)):
            parts = [torch.randn(shape, generator=gen, dtype=dtype, device=dev) for _ in range(P)]

            def kernel():
                return flat([[o] for o in on_all(lambda r: group[r].allreduce(parts[r]))])

            def plain():
                return flat([[peer.allreduce_plain(parts)] for _ in range(P)])

            if not torch.equal(kernel(), plain()):
                fail(f"K8 all-reduce of the {what} on {dims} differs from the rank-order sum")
            nbytes = 2 * P * parts[0].numel() * parts[0].element_size()
            n = parts[0].numel() * (2 if dtype == c64 else 1)
            compare(results, "K8", f"K8 all-reduce, {what}, grid {dims}", kernel, plain,
                    c64, (nbytes, P * (P - 1) * n),
                    library_fn=lambda: flat([[torch.stack(parts).sum(0)]]),
                    library_ref=lambda want, n=n: want[:n])
        Vc = math.prod(lat) // 256 // P         # a rank's slab of the coarsest level
        parts = [torch.randn((1, d, Vc), generator=gen, dtype=c64, device=dev) for _ in range(P)]

        def kernel():
            return flat([[o] for o in on_all(lambda r: group[r].allgather(parts[r]))])

        def plain():
            return flat([[peer.allgather_plain(parts)] for _ in range(P)])

        if not torch.equal(kernel(), plain()):
            fail(f"K8 gather on {dims} differs from the stack")
        nbytes = (1 + P) * P * parts[0].numel() * 8
        compare(results, "K8", f"K8 gather to the coarsest level, d={d}, grid {dims}", kernel,
                plain, c64, (nbytes, 0), library_fn=lambda: flat([[torch.stack(parts)]]),
                library_ref=lambda want: want[:P * parts[0].numel() * 2])
        torch.cuda.synchronize()
        group[0].close()
    check_peer_skew(gen)


def check_peer_skew(gen):
    """K8's double buffers and acknowledgements under skew: the ranks of a
    (1, 1, 1, 4) ring in this process, rank 1 sleeping before each of its
    calls and no synchronization between calls; one-way shifts along x
    (nothing flows back to hold the sender but K8's acknowledgements),
    all-reduces and gathers, each of alternating sizes whose chunks fall
    differently, some above the buffers (successive calls); every result
    bit for bit the plain versions'.  One thread launches for all ranks, so
    each collective is launched for every rank before the next, and the
    allocator holds memory for every rank's stream beforehand: a host call
    that waited for the card (a driver allocation) would wait for kernels
    that wait for ranks not yet launched."""
    from ddalphaamg_tpu_torch.parallel import peer

    t0 = time.perf_counter()
    group = peer.Peers.local_group((1, 1, 1, 4), torch.device("cuda"))
    P, calls = len(group), 12
    streams = [torch.cuda.Stream() for _ in range(P)]

    def rand(n, dtype):
        return torch.randn(n, generator=gen, dtype=dtype, device="cuda")

    c64, f32 = torch.complex64, torch.float32
    ex_sizes = [3 * peer.ROW + 5, peer.MAILBOX // 8 + 1000, 7]
    ar_sizes = [(12 * 50, c64), (peer.REDUCE // 4 + 333, f32), (5, torch.float64)]
    ag_sizes = [56 * 64, 1, peer.GATHER // 8 + 17]
    sends = [[rand(ex_sizes[c % 3], c64) for c in range(calls)] for _ in range(P)]
    parts = [[rand(ar_sizes[c % 3][0], ar_sizes[c % 3][1]) for _ in range(P)] for c in range(calls)]
    stacks = [[rand(ag_sizes[c % 3], c64) for _ in range(P)] for c in range(calls)]
    for st in streams:      # memory held for each rank's stream (the docstring)
        with torch.cuda.stream(st):
            held = [torch.empty(1 << 29, dtype=torch.uint8, device="cuda")]
            held += [torch.empty(1 << 19, dtype=torch.uint8, device="cuda") for _ in range(16)]
        del held
    got = [[] for _ in range(P)]
    cur = torch.cuda.current_stream()
    torch.cuda.synchronize()
    for st in streams:
        st.wait_stream(cur)

    def each_rank(fn):
        for r, st in enumerate(streams):
            with torch.cuda.stream(st):
                fn(r)

    for c in range(calls):
        posted = {}

        def post(r, c=c):
            if r == 1:
                torch.cuda._sleep(1_000_000)
            posted[r] = group[r].post([(3, None, sends[r][c])])

        each_rank(post)
        each_rank(lambda r, c=c: got[r].append(("shift", c, group[r].finish(posted[r])[0])))
        each_rank(lambda r, c=c: got[r].append(("sum", c, group[r].allreduce(parts[c][r]))))
        each_rank(lambda r, c=c: got[r].append(("stack", c, group[r].allgather(stacks[c][r]))))
    for st in streams:
        cur.wait_stream(st)
    torch.cuda.synchronize()
    for r in range(P):
        for kind, c, out in got[r]:
            if kind == "shift":
                want = sends[group[r].mesh.neighbor(3, -1)][c]
            elif kind == "sum":
                want = peer.allreduce_plain(parts[c])
            else:
                want = peer.allgather_plain(stacks[c])
            if not torch.equal(out, want):
                fail(f"K8 under skew: rank {r}'s {kind} of call {c} differs from the plain version")
    group[0].close()
    print(f"  K8 under skew on (1, 1, 1, 4), rank 1 lagging: {calls} one-way shifts, "
          f"all-reduces and gathers of alternating sizes a rank, bit-equal to the plain "
          f"versions ({time.perf_counter() - t0:.2f} s)", flush=True)
    del got, sends, parts, stacks
    torch.cuda.empty_cache()


def dense_cases(d, lat):
    """K6's shapes on rough16 with their block lists: the coarsest level's
    Schur inverse (n / 2 = d * 4^4 / 2 = 7168, one block) and the depth-1
    block inverses (8^4 / 2^4 = 256 blocks of 2^4 * d = 896) on all blocks,
    one red-black colour's and one of sixteen colours' (the SAP's colour
    steps, smoothers/sap.color_blocks); [(nb, m, {label: list or None})]."""
    from ddalphaamg_tpu_torch.geometry import Geometry
    from ddalphaamg_tpu_torch.smoothers import sap

    level1 = Geometry(lattice=tuple(e // 2 for e in lat), block=(2, 2, 2, 2))
    colour = {}
    for label, scheme in (("one red-black colour", "red_black"),
                          ("one of sixteen colours", "sixteen_color")):
        mask = torch.as_tensor(sap.color_masks(level1, scheme)[0].reshape(-1), device="cuda")
        colour[label] = sap.color_blocks(mask, level1)
    return [(1, d * math.prod(e // 4 for e in lat) // 2, {"all blocks": None}),
            (math.prod(level1.block_grid), 16 * d, {"all blocks": None, **colour})]


def dense_work(A, x, blocks, R):
    """(bytes, operations, peak) of K6 on the listed blocks: their blocks of
    A and of x once and the whole of y once; 8 nc m^2 f32 operations at
    batch 1 (CUDA cores), the split's 3 x 8 nc m^2 R bf16 ones on the tensor
    cores from two right-hand sides on."""
    nb, m = A.shape[0], A.shape[1]
    nc = nb if blocks is None else blocks.numel()
    moved = nbytes(A) * nc // nb + nbytes(x) * nc // nb + nbytes(x)
    if R == 1:
        return moved, 8 * nc * m * m, PEAK_FLOPS[torch.complex64]
    return moved, 3 * 8 * nc * m * m * R, PEAK_BF16_TC


def check_dense_kernel(results, gen, d, lat):
    """K6 at dense_cases on random matrices rounded to bf16, at batch 1 and
    12 (the batched cycles of phase "multi": the tensor-core kernel, one
    read of the matrix); library: torch.matmul on the widened listed blocks,
    gathered beforehand, [nc, m, m] @ [nc, m, R]."""
    from ddalphaamg_tpu_torch.operators import coarse, cuda_dense

    dev = torch.device("cuda")
    for nb, m, lists in dense_cases(d, lat):
        A = coarse.compress(torch.randn((nb, m, m), generator=gen, dtype=torch.complex64,
                                        device=dev))
        for R in (1, MULTI_RHS):
            x = torch.randn((R, nb, m), generator=gen, dtype=torch.complex64, device=dev)
            x = x[0] if R == 1 else x
            for label, blocks in lists.items():
                idx = torch.arange(nb, device=dev) if blocks is None else blocks.long()
                wide = coarse.widen(A[idx])
                xt = x.reshape(R, nb, m)[:, idx].permute(1, 2, 0).contiguous()   # [nc, m, R]
                compare(results, "K6", f"K6 bf16 matvec [{nb}, {m}, {m}] batch {R}, {label}",
                        lambda: cuda_dense.matvec(A, x, blocks),
                        lambda: cuda_dense.matvec_plain(A, x, blocks),
                        torch.complex64, dense_work(A, x, blocks, R),
                        lambda: torch.matmul(wide, xt).permute(2, 0, 1),
                        lambda want: want.reshape(R, nb, m)[:, idx])
                del wide, xt
        del A


def k6_device_ms(run):
    """K6's device time (ms) and kernel count while run() executes
    (device_time_by_kernel); the count must equal the wrapper's launches
    in that run.  The profiler's buffers can drop kernel records of a run
    with many thousands (it dropped 59 of 726 K6 records once in a method-3
    warm solve with host loops): a profile that lost any is taken once more,
    and a second loss fails."""
    from ddalphaamg_tpu_torch import kernels

    for attempt in (1, 2):
        before = kernels.counts()["K6"]
        _, _, table = device_time_by_kernel(run)
        events, ms = table.get("K6", (0, 0.0))
        launches = kernels.counts()["K6"] - before
        if events == launches:
            return ms, launches
        print(f"  profile {attempt}: the profiler saw {events} K6 kernels, the wrapper "
              f"launched {launches}", flush=True)
    fail(f"the profiler saw {events} K6 kernels, the wrapper launched {launches}, twice")


def exact_relres(solver, x, rhs):
    """||rhs - D x|| / ||rhs|| through the logical complex128 operator."""
    from ddalphaamg_tpu_torch.operators import wilson

    xs = torch.as_tensor(x, device=solver.device)
    b = torch.as_tensor(rhs, device=solver.device)
    r = b - wilson.d_plus_clover(solver.op, xs)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def launches_since(before):
    """The launches of each kernel since the counts `before`."""
    from ddalphaamg_tpu_torch import kernels

    return {k: n - before[k] for k, n in kernels.counts().items()}


def as_text(counts):
    return ", ".join(f"{k} {n}" for k, n in counts.items())


def check_counts(name, counts):
    missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
    if missing:
        fail(f"{name}: the path never launched {missing}")


def random_coarsest(lat, d, gen, bf16):
    """A random coarse stencil made on the card: self blocks I plus complex
    normal noise (variance 2) of 0.05, hops of 0.023 (~10 GCR iterations to
    5e-2 at 4^4, d = 56); its bf16 view with bf16."""
    from ddalphaamg_tpu_torch.geometry import Geometry
    from ddalphaamg_tpu_torch.operators.stencil import CoarseStencilSoA

    V = math.prod(lat)
    # torch's complex normals have variance 1 (1/2 a part): scaled by sqrt 2
    Pk = torch.randn((9, d, d, V), generator=gen, dtype=torch.complex64, device="cuda")
    Pk[0] *= 0.05 * math.sqrt(2)
    Pk[0] += torch.eye(d, dtype=Pk.dtype, device="cuda")[:, :, None]
    Pk[1:] *= 0.023 * math.sqrt(2)
    s = CoarseStencilSoA.from_blocks(Pk, Geometry(lat, (2, 2, 2, 2)))
    return s.compress() if bf16 else s


def coarsest_work(s, b, trips, restarts):
    """(bytes, operations) of one odd-even coarsest GCR call that runs
    `trips` iterations in its first restart: the K4 applies (prologue and
    epilogue 2 each, 4 a Schur apply: one a restart and one an iteration),
    counted as coarse_work does, and the Gram-Schmidt of iteration j
    (W[:, :j] read twice, Q[:, :j] once) with ~12 more fields of vector
    work an iteration."""
    lat, B = s.lattice, b.shape[0]
    n = b[0].numel()
    applies = {"self": coarse_work(s.Pk, b, lat, (0, 1)),
               "hop": coarse_work(s.Pk, b, lat, (1, 9)),
               "inv": coarse_work(s.Pk_inv, b, lat, (0, 1), parity=1)}
    schur = [applies[k] for k in ("self", "hop", "inv", "hop")]
    ends = [applies[k] for k in ("inv", "hop")] * 2
    k4 = ends + schur * (restarts + trips)
    vec_fields = sum(3 * j + 12 for j in range(trips))
    return (sum(w[0] for w in k4) + 8 * B * n * vec_fields,
            sum(w[1] for w in k4) + 8 * B * n * sum(3 * j for j in range(trips)))


def graph_path(results):
    """Phase "graph": the coarsest GCR as one CUDA graph replay against the
    host loop at GRAPH_CASES, rough16's coarse-solve parameters (m 100,
    tol 5e-2, 5 restarts, odd-even); lane 1 of a batch is zero."""
    from ddalphaamg_tpu_torch import kernels
    from ddalphaamg_tpu_torch.mg.coarsest import CoarsestGraph, coarsest_gcr

    params = rough16_params()
    args = (params.coarse_iter, params.coarse_tol, params.coarse_restart, True)
    gen = torch.Generator(device="cuda").manual_seed(99)
    t0 = time.perf_counter()
    for lat, B, bf16 in GRAPH_CASES:
        s = random_coarsest(lat, 56, gen, bf16)
        key = "K4-bf16" if bf16 else "K4"
        b = torch.randn((B, *s.field_shape), generator=gen, dtype=torch.complex64, device="cuda")
        if B > 1:
            b[1] = 0
        kernels.reset_counts()
        x0, c0 = coarsest_gcr(s, b, *args)
        host = kernels.counts()
        t1 = time.perf_counter()
        graph = CoarsestGraph(s, B, *args)
        torch.cuda.synchronize()
        capture = time.perf_counter() - t1
        kernels.reset_counts()
        x1, c1 = graph(b)
        got = kernels.counts()
        equal = torch.equal(x1, x0)
        rel = float((x1 - x0).abs().max() / x0.abs().max())
        trips = int(c0[:, 0].max())
        label = (f"G coarsest GCR {lat[0]}^4 d=56 batch {B}{', bf16 blocks' if bf16 else ''}, "
                 f"{trips} iterations")
        if not torch.equal(c1, c0) or got[key] != host[key] or got["G"] != 1:
            fail(f"{label}: graph counters {c1[:, 0].tolist()} / {key} {got[key]} launches, "
                 f"host loop {c0[:, 0].tolist()} / {host[key]}")
        if not (equal or rel <= 1e-6) or trips >= args[0]:
            fail(f"{label}: x differs from the host loop's by {rel:.3e} (or {trips} iterations "
                 f"leave the first restart)")
        compare(results, "G", label, lambda: graph(b)[0],
                lambda: coarsest_gcr(s, b, *args)[0], torch.complex64,
                coarsest_work(s, b, trips, args[2]))
        case = results["G"]["cases"][-1]
        phase("graph", t0, f"{label}: x {'bit-equal' if equal else f'within {rel:.2e}'}, "
              f"{key} {host[key]} launches either way; a call: host loop "
              f"{case['plain_ms']:.4f} ms, graph {case['ms']:.4f} ms (one-body loops; PR 13's "
              f"nested IF chain {CHAIN_MS[(lat, B)]} ms, H100 80GB HBM3 700 W); capture "
              f"{capture:.3f} s ({len(graph.graph.loops)} loop bodies), pool "
              f"{graph.graph.pool_bytes / 2**20:.1f} MiB")
        graph.close()


@contextlib.contextmanager
def traced():
    """The tracer (profiling.PROF) at level 2 for the block, its records
    started afresh, and off after it (the rest of the run is the untraced
    path); its records stay for traced_graphs."""
    from ddalphaamg_tpu_torch import profiling

    profiling.PROF.reset()
    profiling.PROF.set_level(profiling.SPANS)
    try:
        yield
    finally:
        profiling.PROF.set_level(profiling.OFF)


@contextlib.contextmanager
def setup_profile():
    """The block traced (traced); yields the setup phases it recorded,
    {"depth d: name": (device seconds by CUDA events, count)}, filled at the
    block's end."""
    from ddalphaamg_tpu_torch.profiling import PROF

    split = {}
    with traced():
        yield split
    PROF.report()
    split.update({f"depth {d}: {name}": (e.time, e.count)
                  for (d, name), e in sorted(PROF.entries.items())
                  if name.startswith("setup:")})


def split_text(split, total_s):
    """A setup's phases (setup_profile) and what is left of total_s."""
    rest = total_s - sum(t for t, _ in split.values())
    return "; ".join(f"{k} {t:.3f} s ({n}x)" for k, (t, n) in split.items()) + (
        f"; outside them {rest:.3f} s")


def main_path():
    import numpy as np

    from ddalphaamg_tpu_torch import api, config, kernels, native
    from ddalphaamg_tpu_torch import io as dio

    params = rough16_params()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    solver = api.Solver(params, device="cuda")
    plaq, header = solver.read_conf()
    phase("solve", t0, f"plaquette {plaq:.13f} (file {header:.13f}), read by the "
          f"{dio.last_reader} reader")
    if abs(plaq - PLAQ) > 1e-10:
        fail(f"plaquette {plaq:.13f} != {PLAQ}")
    if dio.last_reader != "native":
        fail(f"the {dio.last_reader} reader read the configuration, not the native one "
             f"({native.error})")
    with setup_profile() as split:
        status = solver.setup()
    at_setup = kernels.counts()
    phase("solve", t0, f"setup {status.setup_time:.3f} s (its phases traced, "
          f"CUDA events), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase("solve", t0, "setup phases: " + split_text(split, status.setup_time))
    graph_stats("solve", t0, solver, " of the setup", "13 captures, 1.07-1.75 s")
    phase("solve", t0, "launches in the setup (a level's test-vector cycles as one "
          "batch) " + ", ".join(f"{k} {n}" for k, n in at_setup.items()))
    rhs = config.make_rhs("ones", solver.lattice)
    with traced():
        x, info = solver.solve(rhs)
    counts = kernels.counts()
    graph_stats("solve", t0, solver, " of the first solve")
    exact = exact_relres(solver, x, rhs)
    finite = bool(np.isfinite(x).all()) and x.shape == (*solver.lattice, 4, 3)
    phase("solve", t0, f"solve {info.solve_time:.3f} s, {info.iterations} outer "
          f"iterations, exact relres {exact:.6e} (solver {info.relres:.6e}), "
          f"coarse average {info.coarse_average:.2f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase("solve", t0, "launches " + ", ".join(f"{k} {n}" for k, n in counts.items()))
    phase("solve", t0, "of which in the solve " + as_text(launches_since(at_setup)))
    if not finite:
        fail("solution is not a finite field of the lattice's shape")
    if not (info.converged and exact < 1e-10 and info.iterations <= 12):
        fail(f"solve did not meet relres < 1e-10 in <= 12 iterations "
             f"(iterations {info.iterations}, exact relres {exact:.3e})")
    check_counts("solve", counts)
    _, warm = solver.solve(rhs)      # the warm solve phase 7 is compared with
    phase("solve", t0, f"warm solve {warm.solve_time:.3f} s, {warm.iterations} outer "
          f"iterations")
    if warm.iterations != info.iterations:
        fail(f"the warm solve took {warm.iterations} iterations, the first {info.iterations}")
    before_after("solve", t0, "warm solve", lambda: solver.solve(rhs), warm.solve_time)
    return counts, info.iterations, warm.solve_time, solver


def traced_graphs():
    """The last traced block's counters (traced; profiling.PROF.report()):
    captures, their seconds, replays, the pools' peak bytes, the host's
    reads of the device and the captures' empty_cache calls."""
    from ddalphaamg_tpu_torch.profiling import PROF

    c = PROF.report()["counters"]
    return {"captures": c.get("captures", 0), "capture_seconds": c.get("capture seconds", 0.0),
            "replays": c.get("replays", 0), "peak_pool_bytes": c.get("peak pool bytes", 0),
            "host_reads": c.get("host reads", 0), "empty_cache": c.get("empty_cache", 0)}


def graph_stats(name, t0, solver, what, before=None):
    """The graphs of the last traced block (`what`, traced_graphs):
    captures, their seconds, replays, the host's reads of the device, the
    captures' empty_cache calls, and the pools of the graphs the solver's
    hierarchy holds; `before`: earlier numbers to print beside them."""
    g = traced_graphs()
    phase(name, t0, f"graphs{what}: {g['captures']} captures "
          f"({g['capture_seconds']:.3f} s, {g['empty_cache']} empty_cache calls), "
          f"{g['replays']} replays, {g['host_reads']} host reads of the device; pools held "
          f"{solver.mg.graph_pool_bytes() / 2**20:.1f} MiB"
          + (f" (PR 13: {before}, H100 80GB HBM3 700 W)" if before else ""))


@contextlib.contextmanager
def host_loops():
    """Every GCR of the hierarchies driven from the host, no graph (the
    plain version of the device programs; the port's execution model
    before them)."""
    from ddalphaamg_tpu_torch.mg import hierarchy

    saved = hierarchy.GRAPH_DEVICES
    hierarchy.GRAPH_DEVICES = ()
    try:
        yield
    finally:
        hierarchy.GRAPH_DEVICES = saved


def before_after(name, t0, what, run, unprofiled_s):
    """run() profiled with every GCR driven from the host (before) and as
    the device programs (after), each beside its own unprofiled wall time
    (the host loops' from one more run); returns both profiles."""
    with host_loops():
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t1
        before = profiled(name, t0, f"{what}, host loops (no graph)", run, host_s)
    after = profiled(name, t0, f"{what}, device programs", run, unprofiled_s)
    return before, after


def inner_graph_path(name, solver, batches=(1,)):
    """Phase "inner-graph" on a set-up solver: for each batch B, from the
    same r (ones, or the first B point sources) the inner restart
    (Multigrid.inner_restart at the solve's GCR length, rel_tol 1e-5) and
    the cycle (Multigrid.__call__), once with host loops and as one replay
    (captured first): bit-equal z / x and counters, the launches of every
    kernel within 0.1 %, the ms of each (CUDA events), the capture's
    seconds and the pool's bytes."""
    from ddalphaamg_tpu_torch import api, config, kernels
    from ddalphaamg_tpu_torch.mg.programs import CycleGraph, InnerRestartGraph

    mg = solver.mg
    t0 = time.perf_counter()
    for B in batches:
        rhs = (point_sources(solver.lattice)[:B] if B > 1
               else config.make_rhs("ones", solver.lattice)[None])
        r = solver._scatter(rhs).to(solver._inner_dtype)
        m = api.inner_restart_cap(solver.p.restart_length, r.shape[-2] * r.shape[-1], B,
                                  r.device)
        tol = torch.full((B,), 1e-5, dtype=torch.float64, device=r.device)
        on = torch.ones(B, dtype=torch.bool, device=r.device)
        runs = (("inner restart", InnerRestartGraph, m,
                 lambda: mg.inner_restart(r, tol, m=m, active=on)[0]),
                ("cycle", CycleGraph, 0, lambda: mg(r)))
        for what, cls, mm, run in runs:
            def once():
                before = dict(mg.stats)
                kernels.reset_counts()
                out = run()
                torch.cuda.synchronize()
                return out, kernels.counts(), [mg.stats[k] - before[k] for k in before]

            with host_loops():
                zh, host, ch = once()
            mg.drop_programs()
            once()                              # the capture and a first replay
            g = mg.programs[(cls.__name__, B, mm, r.dtype)]
            zg, got, cg = once()
            off = {k: (got[k], host[k]) for k in host
                   if k != "G" and abs(got[k] - host[k]) > 1e-3 * host[k]}
            label = f"{what} batch {B}" + (f" (m {mm})" if mm else "")
            if not torch.equal(zg, zh) or cg != ch or off or got["G"] != 1:
                rel = float((zg - zh).abs().max() / zh.abs().max())
                fail(f"{name}: {label}: the replay differs from the host loops (relative "
                     f"{rel:.3e}, counters {cg} / {ch}, launches {off}, replays {got['G']})")
            with host_loops():
                host_ms = cuda_ms(run, reps=3)
            ms = cuda_ms(run, reps=5)
            phase(name, t0, f"{label}: bit-equal, counters {ch} and launches "
                  f"{as_text({k: n for k, n in host.items() if n and k != 'G'})} either way; "
                  f"host loops {host_ms:.3f} ms, one replay {ms:.3f} ms; capture "
                  f"{g.graph.capture_seconds:.3f} s ({len(g.graph.loops)} loop bodies), pool "
                  f"{g.graph.pool_bytes / 2**20:.1f} MiB")


def setup_graph_path():
    """Phase "setup-graph": rough16's bootstrap setup (options off) with its
    sweeps as device programs (SetupCycleGraph) and with host loops, in
    turns (host, programs, programs, host), and its interpolation-1 setup
    (TwoLevelUpdateGraph) with host loops and as programs: every level's
    test vectors bit-equal, every kernel's launches within 0.1 %; setup
    seconds, captures, their seconds and the largest pools held, each way.
    Returns the launches of the programs' bootstrap setup."""
    from ddalphaamg_tpu_torch import api, kernels

    name = "setup-graph"
    t0 = time.perf_counter()
    solver = api.Solver(rough16_params(), device="cuda")
    solver.read_conf()

    def once(interp, loops):
        solver.p.interpolation = interp
        with host_loops() if loops else contextlib.nullcontext(), traced():
            kernels.reset_counts()
            seconds = solver.setup().setup_time
            counts = kernels.counts()
        mg = solver.mg
        tvs = [lvl.test_vectors.clone() for lvl in mg._levels() if lvl.test_vectors is not None]
        return seconds, tvs, counts, traced_graphs()

    out = None
    for interp, label, order in ((2, "bootstrap", (True, False, False, True)),
                                 (1, "interpolation 1", (True, False))):
        runs = [(loops, once(interp, loops)) for loops in order]
        (_, (_, tvh, host, _)), (_, (_, tvg, got, g)) = runs[0], runs[1]
        off = {k: (got[k], host[k]) for k in host
               if k != "G" and abs(got[k] - host[k]) > 1e-3 * host[k]}
        equal = len(tvh) == len(tvg) and all(torch.equal(a, b) for a, b in zip(tvh, tvg))
        if not equal or off or not got["G"] or host["G"]:
            fail(f"{name}: {label}: the programs' setup differs from the host loops' "
                 f"(test vectors bit-equal {equal}, launches {off}, replays {got['G']} / "
                 f"{host['G']})")
        phase(name, t0, f"{label}: test vectors of {len(tvg)} levels bit-equal, launches "
              f"{as_text({k: n for k, n in host.items() if n and k != 'G'})} either way "
              f"(replays {got['G']}); setup s in turns " + ", ".join(
                  f"{'host loops' if loops else 'programs'} {r[0]:.3f}" for loops, r in runs)
              + f"; programs: {g['captures']} captures ({g['capture_seconds']:.3f} s), "
              f"{g['replays']} replays, pools held at most {g['peak_pool_bytes'] / 2**20:.1f} MiB")
        out = got if out is None else out
    solver.p.interpolation = 2
    return out


def point_sources(lattice):
    """The 12 spin-colour point sources at the origin, [12, T, Z, Y, X, 4, 3]."""
    import numpy as np

    rhs = np.zeros((MULTI_RHS, *lattice, 4, 3), np.complex128)
    rhs[np.arange(MULTI_RHS), 0, 0, 0, 0, np.arange(MULTI_RHS) // 3, np.arange(MULTI_RHS) % 3] = 1
    return rhs


def multi_path(name, solver, k6_ms=None):
    """Solver.solve_multi of the 12 point sources with the solver's setup,
    held against solve of lanes 0 and 11 alone; with a dict k6_ms, K6's
    device time in one more, profiled solve_multi goes to k6_ms[name]."""
    import numpy as np

    from ddalphaamg_tpu_torch import kernels

    t0 = time.perf_counter()
    rhs = point_sources(solver.lattice)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    with traced():
        x, infos = solver.solve_multi(rhs)
    counts = kernels.counts()
    graph_stats(name, t0, solver, " of the batch")
    batch = infos[0].solve_time * len(infos)
    exact = [exact_relres(solver, x[i], rhs[i]) for i in range(len(infos))]
    its = [i.iterations for i in infos]
    phase(name, t0, f"solve_multi of {len(infos)} point sources: {batch:.3f} s, outer "
          f"iterations {its}, exact relres max {max(exact):.6e}, coarse average "
          f"{infos[0].coarse_average:.2f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase(name, t0, "launches " + ", ".join(f"{k} {n}" for k, n in counts.items()))
    if not (x.shape == rhs.shape and np.isfinite(x).all()):
        fail(f"{name}: the solutions are not finite fields of the batch's shape")
    if not all(i.converged and e < 1e-10 and i.iterations <= 12 for i, e in zip(infos, exact)):
        fail(f"{name}: a lane did not meet relres < 1e-10 in <= 12 iterations "
             f"(iterations {its}, exact relres {exact})")
    check_counts(name, counts)
    singles = []
    for lane in (0, len(infos) - 1):
        _, one = solver.solve(rhs[lane])
        singles.append(one.solve_time)
        phase(name, t0, f"lane {lane} alone: {one.solve_time:.3f} s, {one.iterations} outer "
              f"iterations (in the batch {its[lane]})")
        if abs(one.iterations - its[lane]) > 1:
            fail(f"{name}: lane {lane} took {its[lane]} iterations in the batch and "
                 f"{one.iterations} alone")
    phase(name, t0, f"batch of {len(infos)} {batch:.3f} s against {sum(singles) / 2:.3f} s "
          f"a single solve ({len(infos)} singles ~ {len(infos) * sum(singles) / 2:.3f} s)")
    if k6_ms is not None:
        k6_ms[name] = k6_profiled(name, t0, "solve_multi", lambda: solver.solve_multi(rhs))
    else:
        before_after(name, t0, "solve_multi", lambda: solver.solve_multi(rhs), batch)
    return counts


def k6_profiled(name, t0, what, run):
    """K6's device time in run() with host loops (the profiler misses most
    kernels inside graph replays; K6's launches are the same either way),
    printed and returned as a dict."""
    with host_loops():
        ms, launches = k6_device_ms(run)
    phase(name, t0, f"K6 device time in a profiled {what} (host loops): {ms:.4f} ms over "
          f"{launches} launches")
    return dict(ms=ms, launches=launches)


def direct_path(single_iterations, single_warm, k6_ms):
    """The single-rank solve with the three accelerator options on; K6's
    device time in a profiled warm solve goes to k6_ms."""
    import numpy as np

    from ddalphaamg_tpu_torch import api, config, kernels

    name = "direct"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    solver = api.Solver(rough16_params(options=True), device="cuda")
    solver.read_conf()
    status = solver.setup()
    phase(name, t0, f"options {', '.join(OPTIONS)} on; setup {status.setup_time:.3f} s")
    rhs = config.make_rhs("ones", solver.lattice)
    with traced():
        x, info = solver.solve(rhs)
    counts = kernels.counts()
    graph_stats(name, t0, solver, " of the first solve")
    for what, sec in solver.mg.build_times.items():
        phase(name, t0, f"{what}: built in {sec:.3f} s inside the first solve")
    exact = exact_relres(solver, x, rhs)
    before_warm = kernels.counts()
    x2, info2 = solver.solve(rhs)
    warm = launches_since(before_warm)
    exact2 = exact_relres(solver, x2, rhs)
    phase(name, t0, f"first solve {info.solve_time:.3f} s (with the builds), warm solve "
          f"{info2.solve_time:.3f} s (options off: {single_warm:.3f} s); "
          f"{info.iterations} / {info2.iterations} outer iterations "
          f"(options off: {single_iterations}), exact relres {exact:.6e} / {exact2:.6e}, "
          f"coarse average {info.coarse_average:.2f}, coarse matvec average "
          f"{info.coarse_matvec_average:.2f}, coarsest inverse applies "
          f"{info.coarsest_inverse_applies:.0f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase(name, t0, "launches (setup and first solve) "
          + ", ".join(f"{k} {n}" for k, n in counts.items()))
    phase(name, t0, "launches in the warm solve " + as_text(warm))
    finite = all(bool(np.isfinite(a).all()) and a.shape == (*solver.lattice, 4, 3)
                 for a in (x, x2))
    if not finite:
        fail(f"{name}: a solution is not a finite field of the lattice's shape")
    limit = min(12, single_iterations + 2)
    for i, e, lab in ((info, exact, "first"), (info2, exact2, "warm")):
        if not (i.converged and e < 1e-10 and i.iterations <= limit):
            fail(f"{name}: {lab} solve did not meet relres < 1e-10 in <= {limit} "
                 f"iterations (iterations {i.iterations}, exact relres {e:.3e})")
        if i.coarse_matvec_average != 0 or i.coarsest_inverse_applies == 0:
            fail(f"{name}: {lab} solve ran the coarsest GCR")
    check_counts(name, counts)
    before_after(name, t0, "warm solve", lambda: solver.solve(rhs), info2.solve_time)
    k6_ms["direct, warm solve"] = k6_profiled(name, t0, "warm solve",
                                              lambda: solver.solve(rhs))
    inner_graph_path("inner-graph (direct)", solver)
    return counts, warm, info.iterations, info2.solve_time, solver


def defaults_path(single_iterations, single_warm, direct_warm):
    """Phase "defaults": rough16 with no option keys, so that the CUDA
    defaults decide; returns the launch counts of setup and solves."""
    import numpy as np

    from ddalphaamg_tpu_torch import api, config, kernels

    name = "defaults"
    params = rough16_params(options=None)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    solver = api.Solver(params, device="cuda")
    solver.read_conf()
    status = solver.setup()
    rhs = config.make_rhs("ones", solver.lattice)
    with traced():
        x, info = solver.solve(rhs)
    graph_stats(name, t0, solver, " of the first solve")
    x2, info2 = solver.solve(rhs)
    counts = kernels.counts()
    exact, exact2 = exact_relres(solver, x, rhs), exact_relres(solver, x2, rhs)
    chosen = {k: on for k, (on, _) in info.options.items()}
    phase(name, t0, "options: " + "; ".join(f"{k} {'on' if on else 'off'} ({why})"
                                            for k, (on, why) in info.options.items()))
    phase(name, t0, f"setup {status.setup_time:.3f} s; first solve {info.solve_time:.3f} s "
          f"(with the inverse builds), warm solve {info2.solve_time:.3f} s (phase 4, options "
          f"off: {single_warm:.3f} s; phase 7, options on: {direct_warm:.3f} s); "
          f"{info.iterations} / {info2.iterations} outer iterations (phase 4: "
          f"{single_iterations}), exact relres {exact:.6e} / {exact2:.6e}; inner restart cap "
          f"{info.inner_restart_cap}, inner tol clip {info.inner_tol_clip:.3e} / "
          f"{info2.inner_tol_clip:.3e}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase(name, t0, "launches (setup and both solves) " + as_text(counts))
    want = {"coarse_block_bf16": True, "coarsest_direct": True, "smoother_direct": False}
    if chosen != want or api.coarsest_n(params) != 14336 or not api.coarsest_schur_ok(params):
        fail(f"{name}: the defaults chose {chosen} (coarsest n {api.coarsest_n(params)}), "
             f"not {want} with the Schur form at n = 14,336")
    if not isinstance(solver.mg._levels()[-1].dense_inv, tuple):
        fail(f"{name}: the coarsest inverse is not the Schur complement's")
    if not all(np.isfinite(a).all() and a.shape == rhs.shape for a in (x, x2)):
        fail(f"{name}: a solution is not a finite field of the lattice's shape")
    limit = min(12, single_iterations + 2)
    for i, e in ((info, exact), (info2, exact2)):
        if not (i.converged and e < 1e-10 and i.iterations <= limit):
            fail(f"{name}: a solve did not meet relres < 1e-10 in <= {limit} iterations "
                 f"(iterations {i.iterations}, exact relres {e:.3e})")
    check_counts(name, counts)
    before_after(name, t0, "warm solve", lambda: solver.solve(rhs), info2.solve_time)
    inner_graph_path("inner-graph (defaults)", solver)
    return counts


def device_time_by_kernel(run, lattice_of=None):
    """Device time of the card's work while run() executes, from the
    profiler's CUDA events: (wall ms, busy ms, {kind: [events, ms]}), the
    kinds KERNEL_EVENTS' and "other (torch)", graph replays' kernels among
    them; and "(within) graph replays": their count and the
    device time between CUDA events recorded around each replay.  Given
    lattice_of (the lattices of the coarse_apply wrapper calls in launch
    order, filled while run() executes) and no graph replay, the coarse
    kernels by the lattice of each launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ddalphaamg_tpu_torch.solvers import cuda_graph

    spans = []
    launch = cuda_graph.CudaGraph.launch

    def timed(graph):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        launch(graph)
        end.record()
        spans.append((start, end))

    cuda_graph.CudaGraph.launch = timed
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        cuda_graph.CudaGraph.launch = launch
    events = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == DeviceType.CUDA), key=lambda e: e[1])
    kind = {}
    if lattice_of is not None and not spans:
        coarse = [e for e in events if KERNEL_EVENTS["K4"].search(e[0])]
        if len(coarse) != len(lattice_of):
            fail(f"the profiler saw {len(coarse)} coarse kernels, the wrapper launched "
                 f"{len(lattice_of)}")
        kind = {id(e): f"K4 at {lat[0]}^4" for e, lat in zip(coarse, lattice_of)}
    table = {}
    for e in events:
        k = kind.get(id(e)) or next((key for key, pat in KERNEL_EVENTS.items()
                                     if pat.search(e[0])), "other (torch)")
        row = table.setdefault(k, [0, 0.0])
        row[0] += 1
        row[1] += (e[2] - e[1]) / 1e3
    busy, end = 0.0, -1.0
    for _, a, b in events:
        if b > end:
            busy += b - max(a, end)
            end = b
    table = dict(sorted(table.items(), key=lambda kv: -kv[1][1]))
    if spans:
        table["(within) graph replays"] = [
            len(spans), sum(a.elapsed_time(b) for a, b in spans)]
    return wall, busy / 1e3, table


def profiled(name, t0, what, run, unprofiled_s, lattice_of=None):
    """run() profiled (device_time_by_kernel): prints its wall time, the
    device busy time and its share of that wall and of unprofiled_s (the
    same run's wall time without the profiler), and the device time by
    kind; returns them as a dict."""
    from ddalphaamg_tpu_torch import kernels

    steps = kernels.counts()["K7"]
    wall, busy, table = device_time_by_kernel(run, lattice_of)
    steps = kernels.counts()["K7"] - steps      # GCR iterations on one rank
    spans = table.get("(within) graph replays", (0, 0.0))[1]
    if steps and "K7" in table and not spans:
        print(f"[{name}] K7: {table['K7'][0]} CUDA kernels for {steps} GCR iterations "
              f"({table['K7'][0] / steps:.3f} a step)", flush=True)
    replays = (f"; the graph replays span {spans:.1f} ms ({100 * spans / wall:.1f} % of the "
               f"profiled wall, {100 * spans / (1e3 * unprofiled_s):.1f} % of the unprofiled; "
               "the profiler sees only part of the kernels inside them)" if spans else "")
    phase(name, t0, f"a profiled {what}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f} % of it; {100 * busy / (1e3 * unprofiled_s):.1f} % of the "
          f"unprofiled {1e3 * unprofiled_s:.1f} ms){replays}; " + "; ".join(
              f"{k} {n} events {ms:.1f} ms" for k, (n, ms) in table.items()))
    return dict(wall_ms=wall, busy_ms=busy, unprofiled_ms=1e3 * unprofiled_s, by_kind=table,
                gcr_steps=steps)


def rough32_path(U, field_s):
    """Phase "rough32": the configuration rough32 at full width with the
    CUDA defaults; returns the launch counts of set_conf, setup and both
    solves, and the profile of a third, profiled warm solve."""
    from collections import Counter

    import numpy as np

    from ddalphaamg_tpu_torch import api, config, kernels
    from ddalphaamg_tpu_torch.mg import hierarchy
    from ddalphaamg_tpu_torch.operators import cuda_coarse

    name = "rough32"
    GiB = 2**30
    params = rough32_params()
    chunks = Counter()
    lane_chunk = hierarchy.lane_chunk

    def recording(n, lane_bytes, device, mesh=None, held=0):
        c = lane_chunk(n, lane_bytes, device, mesh, held)
        chunks[(n, lane_bytes, c)] += 1
        return c

    def mem(what):
        phase(name, t0, f"{what}: device memory {torch.cuda.memory_allocated() / GiB:.2f} GiB "
              f"allocated, peak {torch.cuda.max_memory_allocated() / GiB:.2f} GiB")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    shapes = set()      # the kernels' shapes in set_conf, the setup and the cold solve
    hierarchy.lane_chunk = recording
    try:
        with launch_shapes(shapes):
            solver = api.Solver(params, device="cuda")
            plaq = solver.set_conf(U, links_have_bc=True)
            phase(name, t0, f"field {ROUGH32} made in {field_s:.2f} s, plaquette {plaq:.13f}")
            mem("after set_conf")
            with setup_profile() as split:
                status = solver.setup()
    finally:
        hierarchy.lane_chunk = lane_chunk
    phase(name, t0, f"setup {status.setup_time:.3f} s (its phases traced, CUDA events)")
    phase(name, t0, "setup phases: " + split_text(split, status.setup_time))
    graph_stats(name, t0, solver, " of the setup", "22 captures, 3.2-3.7 s")
    phase(name, t0, f"the setup's programs held pools of at most "
          f"{traced_graphs()['peak_pool_bytes'] / GiB:.2f} GiB at once")
    mem("after the setup")
    for (n, lane, c), calls in sorted(chunks.items(), key=lambda kv: -kv[0][1]):
        phase(name, t0, f"setup chunk: {n} lanes of {lane / GiB:.3f} GiB -> {c} a chunk "
              f"({calls} calls)")
    tvs = solver.mg.fine.test_vectors.clone()     # for held_sweep, after the solves
    solver.slim_for_solve()
    mem("after slim_for_solve")
    torch.cuda.reset_peak_memory_stats()
    rhs = config.make_rhs("ones", solver.lattice)
    with launch_shapes(shapes), traced():
        x, info = solver.solve(rhs)
    graph_stats(name, t0, solver, " of the cold solve")
    before = kernels.counts()
    x2, info2 = solver.solve(rhs)
    counts = kernels.counts()
    warm = {k: n - before[k] for k, n in counts.items()}
    schur_check(name, t0, solver, rhs, x2, info2, warm, dict(solver.mg.stats))
    exact, exact2 = exact_relres(solver, x, rhs), exact_relres(solver, x2, rhs)
    chosen = {k: on for k, (on, _) in info.options.items()}
    phase(name, t0, "options: " + "; ".join(f"{k} {'on' if on else 'off'} ({why})"
                                            for k, (on, why) in info.options.items()))
    phase(name, t0, f"cold solve {info.solve_time:.3f} s, warm solve {info2.solve_time:.3f} s; "
          f"{info.iterations} / {info2.iterations} outer iterations, exact relres "
          f"{exact:.6e} / {exact2:.6e} (solver {info2.relres:.6e}); coarse average "
          f"{info2.coarse_average:.2f}; inner restart cap {info2.inner_restart_cap}, inner tol "
          f"clip {info.inner_tol_clip:.3e} / {info2.inner_tol_clip:.3e}; peak device memory "
          f"in the solves {torch.cuda.max_memory_allocated() / GiB:.2f} GiB")
    phase(name, t0, "launches (set_conf, setup, both solves) " + as_text(counts))
    want = {"coarse_block_bf16": True, "coarsest_direct": False, "smoother_direct": False}
    if chosen != want or api.coarsest_n(params) != 229376:
        fail(f"{name}: the defaults chose {chosen} (coarsest n {api.coarsest_n(params)}), "
             f"not {want} at n = 229,376")
    if not all(np.isfinite(a).all() and a.shape == rhs.shape for a in (x, x2)):
        fail(f"{name}: a solution is not a finite field of the lattice's shape")
    for i, e in ((info, exact), (info2, exact2)):
        if not (i.converged and e < 1e-10 and i.iterations <= 16):
            fail(f"{name}: a solve did not reach relres < 1e-10 in <= 16 iterations "
                 f"(iterations {i.iterations}, exact relres {e:.3e})")
    check_counts(name, counts)
    # where a warm solve's device time goes, the coarse kernels by level
    lattices = []
    apply = cuda_coarse.coarse_apply

    def by_lattice(blocks, v, lattice, *a, **k):
        lattices.append(tuple(lattice))
        return apply(blocks, v, lattice, *a, **k)

    cuda_coarse.coarse_apply = by_lattice
    try:
        profile = profiled(name, t0, "warm solve", lambda: solver.solve(rhs),
                           info2.solve_time, lattices)
    finally:
        cuda_coarse.coarse_apply = apply
    held_sweep(name, t0, solver.mg, tvs)
    return counts, profile, shapes


def schur_check(name, t0, solver, rhs, x, info, launches, stats):
    """The warm solve's K4-schur launches against its coarsest GCR's
    iterations and operator applications (stats, the solve's own counts:
    2 launches an apply, one an iteration and one a restart that ran), and
    the same solve with the four K4 launches (the split path off, the
    programs captured anew): bit-equal x and counters, and the K4-bf16
    launches the split path saved."""
    import numpy as np

    from ddalphaamg_tpu_torch import kernels
    from ddalphaamg_tpu_torch.operators import stencil

    mg = solver.mg
    saved, stencil.SPLIT_SCHUR_DEVICES = stencil.SPLIT_SCHUR_DEVICES, ()
    try:
        mg.drop_graphs()
        before = kernels.counts()
        x4, info4 = solver.solve(rhs)
        four = {k: n - before[k] for k, n in kernels.counts().items()}
    finally:
        stencil.SPLIT_SCHUR_DEVICES = saved
        mg.drop_graphs()
    same = (np.array_equal(x, x4) and info.iterations == info4.iterations
            and info.coarse_average == info4.coarse_average)
    iters, matvecs, split = stats["coarse_iterations"], stats["coarse_matvecs"], launches["K4-schur"]
    phase(name, t0, f"warm solve: K4-schur {split} launches for {iters:.0f} coarsest GCR iterations "
          f"and {matvecs:.0f} operator applications counted ({split / max(iters, 1):.3f} an "
          f"iteration), K4-bf16 {launches['K4-bf16']} (with the four launches: {four['K4-bf16']}, "
          f"K4-schur {four['K4-schur']}); the four-launch solve {'bit-equal' if same else 'DIFFERS'} "
          f"(iterations {info4.iterations}, coarse average {info4.coarse_average:.4f}, "
          f"{info4.solve_time:.3f} s against {info.solve_time:.3f} s)")
    if not same or four["K4-schur"] or not 2 * iters <= split <= 2 * matvecs:
        fail(f"{name}: the split Schur path is not the four-launch path's twin")


def held_sweep(name, t0, mg, tvs):
    """One depth-0 bootstrap sweep (Multigrid._setup_cycles_batch) of the
    test vectors tvs on a set-up hierarchy (its cycles read the bf16 views
    slim_for_solve keeps), as replays of SetupCycleGraph and with host
    loops at the same lane chunk: x and the collected next-level solutions
    bit-equal, launches within 0.1 % (counted after the path's own, which
    it leaves out), each way's seconds.  The hierarchy is left as it
    was."""
    from ddalphaamg_tpu_torch import kernels

    runs = []
    chunk = None
    for loops in (False, True):
        with host_loops() if loops else contextlib.nullcontext(), mg._setup_scope():
            if chunk is not None:
                mg._chunks[0] = chunk
            chunk = mg._setup_chunk(mg.fine, tvs.shape[0])
            kernels.reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x, coll = mg._setup_cycles_batch(mg.fine, tvs)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t1, x, coll, kernels.counts()))
    (sg, xg, cg, got), (sh, xh, ch, host) = runs
    off = {k: (got[k], host[k]) for k in host
           if k != "G" and abs(got[k] - host[k]) > 1e-3 * host[k]}
    equal = torch.equal(xg, xh) and cg.keys() == ch.keys() and all(
        torch.equal(cg[d], ch[d]) for d in cg)
    if not equal or off or not got["G"]:
        fail(f"{name}: a depth-0 sweep as programs differs from the host loops (bit-equal "
             f"{equal}, launches {off}, replays {got['G']})")
    phase(name, t0, f"a depth-0 sweep of {tvs.shape[0]} test vectors in chunks of {chunk}: "
          f"x and the collected depth {sorted(cg)} bit-equal, launches "
          f"{as_text({k: n for k, n in host.items() if n and k != 'G'})} either way "
          f"(replays {got['G']}); programs {sg:.3f} s (with the capture), host loops "
          f"{sh:.3f} s")


def method_params(method, interpolation=2, **options):
    """rough16.ini with another method and interpolation (0: SAP alone),
    and options set on the parsed parameters."""
    params = rough16_params()
    params.method, params.interpolation = method, interpolation
    for key, val in options.items():
        setattr(params, key, val)
    return params


def method_run(paths, label, solver, rhs, kind, needed, setup=True, x0=None):
    """One run of phase "methods": setup (unless setup is False) and a solve
    of rhs from x0, with the launches of each kernel in that run; kind
    "converge" asks for relres < 1e-10 within the ini's restarts, "honest"
    for relres < 1e-10 or the ini's last iteration, and either way an exact
    relres within 1 % of the solver's own.  Returns (x, SolveInfo)."""
    import numpy as np

    from ddalphaamg_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.reset_counts()
    setup_s = solver.setup().setup_time if setup else 0.0
    x, info = solver.solve(rhs, x0=x0)
    counts = kernels.counts()
    paths[label] = counts
    exact = exact_relres(solver, x, rhs)
    per_it = 1e6 * info.solve_time / max(info.iterations, 1)
    phase("methods", t0, f"{label}: setup {setup_s:.3f} s, solve {info.solve_time:.3f} s, "
          f"{info.iterations} iterations ({per_it:.0f} us each), exact relres {exact:.6e} "
          f"(solver {info.relres:.6e}); launches "
          + ", ".join(f"{k} {n}" for k, n in counts.items() if n))
    if not (np.isfinite(x).all() and x.shape == rhs.shape):
        fail(f"methods, {label}: the solution is not a finite field of the lattice's shape")
    if kind == "converge" and not (info.converged and exact < 1e-10):
        fail(f"methods, {label}: relres {exact:.3e} not < 1e-10 within the ini's restarts")
    if kind == "honest":
        p = solver.p
        if not (info.converged or info.iterations == p.restart_length * p.max_restarts):
            fail(f"methods, {label}: stopped after {info.iterations} iterations unconverged")
        if abs(exact - info.relres) > 0.01 * exact:
            fail(f"methods, {label}: exact relres {exact:.6e} and the solver's "
                 f"{info.relres:.6e} differ by more than 1 %")
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        fail(f"methods, {label}: the path never launched {missing}")
    return x, info


def methods_path(paths, solver, k6_ms):
    """Phase "methods": the other methods and the library API on rough16 at
    full size (the ini otherwise); `solver` is phase 4's, set up.  K6's
    device time in a profiled warm solve of method 3 with the options on
    goes to k6_ms.  Returns {method: (iterations, kind)} of methods 4 and
    -1 (phase grid4d runs them again on its grid)."""
    import tempfile

    import numpy as np

    from ddalphaamg_tpu_torch import api, config, io
    from ddalphaamg_tpu_torch.mg.hierarchy import Multigrid

    fine = ("K1", "K2", "K3")
    mg = fine + ("K4",)
    rhs = config.make_rhs("ones", solver.lattice)

    def run(label, params, kind, needed, **kw):
        s = api.Solver(params, device="cuda")
        s.read_conf()
        return s, method_run(paths, label, s, rhs, kind, needed, **kw)

    # methods 1 and 3 with multigrid; method 3 with the options on, its K6
    # launches in a warm solve against red-black's (phase 7)
    run("method 1 (additive SAP) + multigrid", method_params(1), "converge", mg)
    run("method 3 (16-colour SAP) + multigrid", method_params(3), "converge", mg)
    s3, _ = run("method 3 + multigrid, options on",
                method_params(3, **{k: True for k in OPTIONS}), "converge",
                fine + ("K4-bf16", "K6"))
    method_run(paths, "method 3 + multigrid, options on, warm solve", s3, rhs, "converge",
               fine + ("K4-bf16", "K6"), setup=False)
    k6_ms["method 3, options on, warm solve"] = k6_profiled(
        "methods", time.perf_counter(), "warm solve of method 3 with the options on",
        lambda: s3.solve(rhs))
    del s3
    # the methods without multigrid
    run("method 2, SAP alone", method_params(2, 0), "converge", fine)
    singles = {4: (run("method 4, odd-even", method_params(4, 0), "converge",
                       fine)[1][1].iterations, "converge")}
    for method, what in ((-1, "CGN"), (0, "GMRES"), (5, "BiCGstab preconditioner")):
        _, (_, info) = run(f"method {method}, {what}", method_params(method, 0), "honest",
                           ("K1",))
        if method == -1:
            singles[-1] = (info.iterations, "honest")

    # the library API on phase 4's solver
    m0 = solver.p.m0
    solver.shift_update(m0 + 0.01)
    if solver.mg.fine.dense_inv is not None:
        fail("methods: shift_update kept a stored inverse")
    bootstrap = Multigrid.bootstrap_setup
    Multigrid.bootstrap_setup = lambda *a, **k: fail("shift_update ran a setup")
    try:
        method_run(paths, f"shift_update(m0 + 0.01 = {m0 + 0.01:g}), no setup", solver, rhs,
                   "converge", mg, setup=False)
    finally:
        Multigrid.bootstrap_setup = bootstrap
    solver.shift_update(m0)
    t0 = time.perf_counter()
    solver.update_setup(1)
    phase("methods", t0, f"update_setup(1) {solver.status.setup_time:.3f} s (setup total)")
    x, info = method_run(paths, "update_setup(1)", solver, rhs, "converge", mg, setup=False)
    _, again = method_run(paths, "solve(x0 = converged x)", solver, rhs, "converge", (),
                          setup=False, x0=x)
    if again.iterations != 0:
        fail(f"methods: a solve from a converged x took {again.iterations} iterations")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        # three levels: only the fine test vectors come from the file, depth 1
        # keeps its initial ones (the JAX package's set_test_vectors, the
        # reference's read_tv_from_file + re_setup), so the reader's
        # iterations may exceed the writer's; its fine vectors are the writer's
        path = os.path.join(tmp, "rough16_tv")
        solver.write_test_vectors(path)
        reader = method_params(2, 4, tv_io_file_name=path, tv_io_single_file=True)
        r, (_, rinfo) = run("interpolation 4, three levels (update_setup's test vectors)",
                            reader, "converge", mg)
        if not np.array_equal(r.mg.get_test_vectors(), solver.mg.get_test_vectors()):
            fail("methods: interpolation 4 read other test vectors than were written")
        del r
        # two levels: the file fixes the whole hierarchy, so the reader
        # solves in the writer's iterations (+-1); one file a vector
        w, (_, winfo) = run("two levels, interpolation 2 (writes its test vectors)",
                            method_params(2, num_levels=2), "converge", mg)
        path = os.path.join(tmp, "rough16_2lvl_tv")
        w.write_test_vectors(path, single_file=False)
        del w
        reader = method_params(2, 4, num_levels=2, tv_io_file_name=path,
                               tv_io_single_file=False)
        _, (_, r2info) = run("two levels, interpolation 4 (reads them)", reader, "converge", mg)
        if abs(r2info.iterations - winfo.iterations) > 1:
            fail(f"methods: interpolation 4 at two levels took {r2info.iterations} "
                 f"iterations, the writer {winfo.iterations}")
    phase("methods", time.perf_counter(), f"interpolation 4: three levels {rinfo.iterations} "
          f"iterations (writer {info.iterations}), two levels {r2info.iterations} "
          f"(writer {winfo.iterations})")
    run("interpolation 1 (two-level extension setup)", method_params(2, 1), "converge", mg)
    # open boundaries: rough16 with U_T on the last slice zeroed
    params = method_params(2)
    params.bc = 0
    U, _ = io.read_gauge_field(params.configuration, anti_periodic=params.anti_pbc)
    U[0, -1] = 0
    s = api.Solver(params, device="cuda")
    s.set_conf(U, links_have_bc=True)
    method_run(paths, "bc 0 (open), U_T of the last slice zeroed", s, rhs, "converge", mg)
    T = s.op.links.shape[1]
    if s.op.links[0, [0, T - 2, T - 1]].abs().max() != 0:
        fail("methods: bc 0 kept hopping links across the time boundary")
    return singles


def library_path(paths, solver):
    """Phase "library": the gauge formats and tools, the compat embedding
    API, the diagnostics on phase 4's hierarchy (`solver`), the cli's
    --benchmark / --profile / --rhs-batch in process and an m0 scan, on
    rough16 at full size."""
    import contextlib
    import io as pyio
    import tempfile

    import numpy as np

    from ddalphaamg_tpu_torch import (analysis, cli, compat, config, evaluation, io, kernels,
                                      lime, profiling, tools)
    from ddalphaamg_tpu_torch.operators import wilson

    name = "library"
    start = time.perf_counter()
    conf = rough16_params().configuration
    U, header = io.read_gauge_field(conf, anti_periodic=False)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        def path(n):
            return os.path.join(tmp, n)

        lime.write_gauge_field(path("rough16.lime"), U, header, anti_periodic=False)
        io.write_gauge_field_ddhmc(path("rough16.ddhmc"), U, header, anti_periodic=False)
        io.split_gauge_field(conf, path("rough16"), (1, 2, 1, 1))
        read = {"LIME": lime.read_gauge_field(path("rough16.lime"), anti_periodic=False),
                "DDHMC": io.read_gauge_field_ddhmc(path("rough16.ddhmc"), anti_periodic=False),
                "multi-file (1, 2, 1, 1)": io.read_gauge_field_multi(
                    path("rough16"), (1, 2, 1, 1), anti_periodic=False)}
        with contextlib.redirect_stdout(pyio.StringIO()):
            rc = tools.main(["tobin", path("rough16.lime"), path("rough16.bin")])
        read["tools tobin of the LIME file"] = io.read_gauge_field(path("rough16.bin"),
                                                                   anti_periodic=False)
        for fmt, (links, plaq) in read.items():
            if not np.array_equal(links, U):
                fail(f"{name}: the {fmt} links differ from the binary file's")
        if rc != 0:
            fail(f"{name}: tools tobin exited {rc}")
        UL = read["LIME"][0]
    phase(name, t0, f"formats: {', '.join(read)} written and read back, links bit-equal to "
          f"the binary file's (LIME plaquette {read['LIME'][1]:.13f}, file {header:.13f})")

    # the compat embedding API from rough16.ini on the card
    t0 = time.perf_counter()
    kernels.reset_counts()
    compat.dd_alpha_amg_init(compat.dd_alpha_amg_par(
        param_file_path=INI, amg_params=compat.dd_alpha_amg_parameters(
            number_of_levels=3, update_setup_after=2)), device="cuda")
    plaq = compat.dd_alpha_amg_set_conf(UL)
    if abs(plaq - PLAQ) > 1e-10:
        fail(f"{name}: compat plaquette {plaq:.13f} != {PLAQ}")
    setup_s = compat.dd_alpha_amg_setup()["setup_time"]
    s = compat._solver
    rhs = config.make_rhs("ones", s.lattice)
    m0 = s.p.m0

    def solve(label, at_most=12, check_op=None, **scale):
        """A compat solve to 1e-10: exact relres (against check_op, else the
        solver's operator) < 1e-10 in at most at_most outer iterations."""
        t = time.perf_counter()
        x, relres, st = compat.dd_alpha_amg_wilson_solve(rhs, tol=1e-10, **scale)
        dt = time.perf_counter() - t
        op = check_op or s.op
        xs, b = torch.as_tensor(x, device=s.device), torch.as_tensor(rhs, device=s.device)
        exact = float(torch.linalg.vector_norm(b - wilson.d_plus_clover(op, xs))
                      / torch.linalg.vector_norm(b))
        phase(name, t0, f"compat {label}: {dt:.3f} s, {st['iterations']} outer iterations, "
              f"exact relres {exact:.6e} (solver {relres:.6e})")
        if not (np.isfinite(x).all() and exact < 1e-10 and st["iterations"] <= at_most):
            fail(f"{name}: compat {label} did not meet relres < 1e-10 in <= {at_most} "
                 f"iterations")
        return x

    phase(name, t0, f"compat: init, set_conf (plaquette {plaq:.13f}), setup {setup_s:.3f} s")
    x1 = solve("wilson_solve")
    par = np.indices(s.lattice).sum(axis=0) % 2
    f = torch.as_tensor(np.where(par == 0, 1.1, 0.9), device=s.device)
    scaled = wilson.WilsonOperator(s.op.links, s.op.clover * f[..., None, None, None])
    restarts = s.p.restart_length * s.p.max_restarts     # converges within the ini's
    x2 = solve("scaled solve (even 1.1, odd 0.9)", restarts, scaled, scale_even=1.1,
               scale_odd=0.9)
    moved = float(np.linalg.norm(x2 - x1) / np.linalg.norm(x1))
    x3 = solve("unscaled solve after it")
    back = float(np.linalg.norm(x3 - x1) / np.linalg.norm(x1))
    phase(name, t0, f"compat: the scaled solution moved by {moved:.3e}, the unscaled one "
          f"after it is the first to {back:.3e}")
    if not (moved > 1e-3 and back < 1e-8):
        fail(f"{name}: compat clover scaling moved the solution by {moved:.3e} and the "
             f"restored solve differs from the first by {back:.3e}")
    compat.dd_alpha_amg_set_mass_for_next_solve(m0 + 0.01)
    solve(f"set_mass_for_next_solve(m0 + 0.01 = {m0 + 0.01:g})", restarts)
    for _ in range(2):
        compat.dd_alpha_amg_set_conf(UL)
    before = s.status.setup_time
    solve("two set_conf calls later (update_setup_after = 2)", restarts)
    st = compat._status
    if (st.gauge_updates_since_last_setup_update != 0 or st.gauge_updates_since_last_setup != 2
            or s.status.setup_time <= before):
        fail(f"{name}: two set_conf calls did not run update_setup ({st})")
    paths["library: compat"] = counts = kernels.counts()
    phase(name, t0, "compat launches " + as_text(counts))
    check_counts(name, counts)
    compat.dd_alpha_amg_free()
    del s
    torch.cuda.empty_cache()

    # the diagnostics on phase 4's hierarchy (complex64 levels)
    t0 = time.perf_counter()
    checks = analysis.run_self_checks(solver.mg)
    phase(name, t0, "self checks " + ", ".join(f"{k} {v:.3e}" for k, v in checks.items()))
    if len(checks) != 6 or not all(v < 1e-5 for v in checks.values()):
        fail(f"{name}: a self check is not below 1e-5: {checks}")
    rows = analysis.test_vector_analysis(solver.mg)
    sr, cr = analysis.smoother_reduction(solver), analysis.coarse_reduction(solver.mg)
    phase(name, t0, f"test vectors: {len(rows)}, |rho| {min(abs(r) for r, _ in rows):.4f} "
          f"to {max(abs(r) for r, _ in rows):.4f}, residual {min(e for _, e in rows):.4f} "
          f"to {max(e for _, e in rows):.4f}; smoother reduction {sr:.4e}, coarse "
          f"reduction {cr:.4e} (coarse tolerance {solver.p.coarse_tol:g})")
    if not (sr < 1 and cr <= solver.p.coarse_tol):
        fail(f"{name}: smoother reduction {sr:.3e} not < 1 or coarse reduction {cr:.3e} "
             f"above the coarse tolerance")

    # the cli's benchmark, profile and multi-RHS modes in process
    t0 = time.perf_counter()
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = pyio.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([INI, "--benchmark", "3", "--profile", "--rhs-batch", "2"])
    profiling.PROF.enabled = False
    profiling.PROF.reset()
    text = out.getvalue()
    print("\n".join("  " + line for line in text.splitlines()), flush=True)
    paths["library: cli --profile"] = counts = kernels.counts()
    phase(name, t0, f"cli --benchmark 3 --profile --rhs-batch 2: exit {rc}; launches "
          + as_text(counts))
    for want in ("benchmarking: 3 solves", "multi-RHS: 2 solves", "(2/2 converged)",
                 "maximal device memory/MPI process", "| depth 0: fine_op (d_plus_clover)",
                 "| depth 2: coarsest solve (OE-GCR)", "| depth 0: FULL CYCLE"):
        if want not in text:
            fail(f"{name}: the cli printed no {want!r}")
    if rc != 0 or text.count("| kernel (per level)") != 2:
        fail(f"{name}: the cli exited {rc} or printed not both profiling tables")
    check_counts(name, counts)

    # an m0 scan with shift updates
    t0 = time.perf_counter()
    kernels.reset_counts()
    sc = evaluation.ScanConfig(scan_variable="m0", start_val=-0.5, end_val=-0.48,
                               step_size=0.01, shift_update=True)
    rows = evaluation.run_scan(rough16_params(), sc, device="cuda",
                               printer=lambda t: print("\n".join("  " + line for line in
                                                                 t.splitlines())))
    paths["library: scan"] = counts = kernels.counts()
    phase(name, t0, "m0 scan: " + "; ".join(
        f"m0 {r.value:g} setup {r.setup_time:.3f} s, solve {r.solve_time:.3f} s, "
        f"{r.solve_iters:g} iterations, relres {r.relres:.3e}" for r in rows))
    if len(rows) != 3 or not all(r.relres < 1e-10 for r in rows):
        fail(f"{name}: the m0 scan gave {len(rows)} rows, not three below 1e-10")
    check_counts(name, counts)
    phase(name, start, f"phase wall time (peak device memory since the cli "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")


def sharded_rank(mesh, device, options=False, methods=()):
    """One rank of the sharded rough16 solve (run by parallel/launch.run_ranks
    in a spawned process), then a solve of each of `methods` (without
    multigrid, interpolation 0) on the same ranks.  The faces of every K5
    launch are recorded by axes."""
    import numpy as np

    from ddalphaamg_tpu_torch import api, config, kernels
    from ddalphaamg_tpu_torch.operators import cuda_coarse

    k5_axes = {}
    halo_apply = cuda_coarse.coarse_apply_halo

    def recording(blocks, v, lattice, halos, *args, **kw):
        key = "".join("tzyx"[mu] for mu in sorted(halos))
        k5_axes[key] = k5_axes.get(key, 0) + 1
        return halo_apply(blocks, v, lattice, halos, *args, **kw)

    cuda_coarse.coarse_apply_halo = recording
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    solver = api.Solver(rough16_params(options), device=device, mesh=mesh)
    plaq, _ = solver.read_conf()
    with traced():                  # a rank's own tracer: the graphs' counters
        status = solver.setup()
    setup_graphs = traced_graphs()
    rhs = config.make_rhs("ones", solver.lattice)
    with traced():
        x, info = solver.solve(rhs)
    out = dict(rank=mesh.rank, plaq=plaq, setup=status.setup_time,
               solve=info.solve_time, iterations=info.iterations,
               relres=info.relres, converged=info.converged,
               coarse_average=info.coarse_average,
               coarse_matvec_average=info.coarse_matvec_average,
               counts=kernels.counts(), build_times=solver.mg.build_times,
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               x_sum=complex(x.sum()), k5_axes=dict(k5_axes),
               sharded=[lvl.stencil.mesh is not None for lvl in solver.mg._levels()],
               setup_graphs=setup_graphs, graphs=traced_graphs(),
               uses_graphs=[solver.mg.uses_graphs(torch.zeros(1, device=device), lvl)
                            for lvl in solver.mg._levels()])
    if mesh.rank == 0:    # exact residual from the gathered x, logical operator
        out["exact"] = exact_relres(solver, x, rhs)
        out["finite"] = bool(np.isfinite(x).all()) and x.shape == (*solver.lattice, 4, 3)
    # warm solves: the replicated level's GCR as replays (this port), then
    # every GCR of the grid a host loop (the port before)
    warm = {"replays": [], "host loops": []}
    for way in ("replays", "host loops"):
        with contextlib.nullcontext() if way == "replays" else host_loops():
            _, wi = solver.solve(rhs)
        warm[way].append(wi.solve_time)
        if wi.iterations != info.iterations:
            raise RuntimeError(f"a warm solve ({way}) took {wi.iterations} iterations, "
                               f"the first {info.iterations}")
    out["warm"] = warm
    out["coarsest_check"] = coarsest_replay_check(solver.mg, device)
    if solver.mg.uses_graphs(torch.zeros(1, device=device)):     # the sharded levels too
        out["inner_check"] = inner_replay_check(solver.mg, device, rough16_params().restart_length)
    del solver
    out["methods"] = {}
    for method in methods:
        kernels.reset_counts()
        s = api.Solver(method_params(method, 0), device=device, mesh=mesh)
        s.read_conf()
        setup_s = s.setup().setup_time
        xm, im = s.solve(rhs)
        run = dict(setup=setup_s, solve=im.solve_time, iterations=im.iterations,
                   relres=im.relres, converged=im.converged, counts=kernels.counts(),
                   x_sum=complex(xm.sum()))
        if mesh.rank == 0:
            run["exact"] = exact_relres(s, xm, rhs)
            run["finite"] = bool(np.isfinite(xm).all()) and xm.shape == rhs.shape
        out["methods"][method] = run
        del s
    return out


def coarsest_replay_check(mg, device):
    """The replicated coarsest level's GCR on a grid: one replay of its
    graph (mg/coarsest.CoarsestGraph) against the host loop (coarsest_gcr)
    on the same right-hand side, drawn alike on every rank; bit-equality
    and each one's ms (CUDA events, 10 calls)."""
    from ddalphaamg_tpu_torch.mg.coarsest import coarsest_gcr

    lvl = mg._levels()[-1]
    s, cfg = mg._cycle_view(lvl), mg.cfg
    gen = torch.Generator(device=device).manual_seed(77)
    b = torch.randn((1, *s.field_shape), generator=gen, dtype=s.dtype, device=device)
    args = (cfg.coarse_iter, cfg.coarse_tol, cfg.coarse_restart, mg._odd_even(lvl))
    g = mg._coarsest_graph(lvl, s, 1)
    xg, cg = g(b)
    xh, ch = coarsest_gcr(s, b, *args)
    return dict(equal=bool(torch.equal(xg, xh) and torch.equal(cg, ch)),
                iterations=float(cg[0, 0]), replay_ms=cuda_ms(lambda: g(b)),
                host_ms=cuda_ms(lambda: coarsest_gcr(s, b, *args)),
                replicated=lvl.stencil.mesh is None)


def inner_replay_check(mg, device, m):
    """On a grid whose sharded levels run as device programs (nccl, K8):
    one inner restart (InnerRestartGraph: the slab GCR of length m with
    the cycle, its exchanges, all-reduces and gathers inside) from r = ones
    against the host loops, bit-equality of z, the iterations and the
    counters, and each one's ms (CUDA events, 5 calls)."""
    s = mg.fine.stencil
    r = torch.ones((1, *s.field_shape), dtype=s.dtype, device=device)
    zero = dict(coarse_iterations=0.0, coarse_matvecs=0.0, coarsest_inverse_applies=0.0)
    mg.stats.update(zero)
    zg, ig = mg.inner_restart(r, 1e-5, m=m)
    stats_g = dict(mg.stats)
    mg.stats.update(zero)
    with host_loops():
        zh, ih = mg.inner_restart(r, 1e-5, m=m)
        stats_h = dict(mg.stats)
        host_ms = cuda_ms(lambda: mg.inner_restart(r, 1e-5, m=m), reps=5)
    parts = dict(z=bool(torch.equal(zg, zh)), iterations=bool(torch.equal(ig, ih)),
                 counters=stats_g == stats_h)
    return dict(equal=all(parts.values()), parts=parts, iterations=float(ig[0]),
                replay_ms=cuda_ms(lambda: mg.inner_restart(r, 1e-5, m=m), reps=5),
                host_ms=host_ms)


def sharded_path(name, dims, transport, devices, single_iterations, options=False,
                 methods=None):
    """The sharded solve on spawned ranks, then each method of `methods`
    ({method: (phase 4c's iterations on one rank, its kind in method_run)});
    returns rank 0's launch counts of the multigrid run."""
    from ddalphaamg_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    res = launch.run_ranks(sharded_rank, dims, transport, devices, options,
                           tuple(methods or ()))
    r0 = res[0]
    phase(name, t0, f"mesh {dims}, {len(res)} ranks, {transport} on "
          f"{', '.join(devices)}: plaquette {r0['plaq']:.13f}, setup "
          f"{r0['setup']:.3f} s, solve {r0['solve']:.3f} s, "
          f"{r0['iterations']} outer iterations (single rank {single_iterations}), "
          f"exact relres {r0['exact']:.6e} (solver {r0['relres']:.6e}), coarse average "
          f"{r0['coarse_average']:.2f}, coarse matvec average "
          f"{r0['coarse_matvec_average']:.2f}, peak device memory per rank "
          f"{max(r['peak_gib'] for r in res):.2f} GiB")
    for what, sec in r0["build_times"].items():
        phase(name, t0, f"rank 0 {what}: built in {sec:.3f} s inside the solve")
    phase(name, t0, "rank 0 launches " + ", ".join(
        f"{k} {n}" for k, n in r0["counts"].items()))
    keys = ("iterations", "relres", "coarse_average", "x_sum")
    if any(r[k] != r0[k] for r in res for k in keys):
        fail(f"{name}: ranks disagree: {[{k: r[k] for k in keys} for r in res]}")
    if abs(r0["plaq"] - PLAQ) > 1e-10:
        fail(f"{name}: plaquette {r0['plaq']:.13f} != {PLAQ}")
    if not r0["finite"]:
        fail(f"{name}: solution is not a finite field of the lattice's shape")
    if not (r0["converged"] and r0["exact"] < 1e-10 and r0["iterations"] <= 12
            and abs(r0["iterations"] - single_iterations) <= 1):
        fail(f"{name}: solve did not meet relres < 1e-10 in <= 12 iterations within "
             f"1 of the single-rank run (iterations {r0['iterations']}, exact relres "
             f"{r0['exact']:.3e})")
    if options and r0["coarse_matvec_average"] != 0:
        fail(f"{name}: the solve ran the coarsest GCR")
    check_counts(name if name in PATH_KERNELS else "sharded", r0["counts"])
    for r in res:
        g, c = r["graphs"], r["coarsest_check"]
        phase(name, t0, f"rank {r['rank']}: the replicated coarsest level's GCR as graph "
              f"replays: {g['replays']} replays in the first solve "
              f"({r['setup_graphs']['replays']} in the setup), {g['captures']} captures "
              f"({g['capture_seconds']:.3f} s), {g['host_reads']} host reads of the device; levels "
              f"that run graphs {r['uses_graphs']}; warm solve with the replays "
              f"{r['warm']['replays'][0]:.3f} s, with host loops only (the port before) "
              f"{r['warm']['host loops'][0]:.3f} s; "
              f"one coarsest call ({c['iterations']:.0f} iterations) "
              f"{'bit-equal' if c['equal'] else 'DIFFERS'}: replay {c['replay_ms']:.3f} ms, "
              f"host loop {c['host_ms']:.3f} ms")
    if not r0["coarsest_check"]["replicated"] or not r0["coarsest_check"]["equal"]:
        fail(f"{name}: rank 0's coarsest replay is not bit-equal to its host loop")
    if any(r["graphs"]["replays"] + r["setup_graphs"]["replays"] == 0 for r in res):
        fail(f"{name}: a rank ran its replicated coarsest level without a graph")
    if transport == "gloo" and any(r["uses_graphs"][0] for r in res):
        fail(f"{name}: a gloo-sharded level ran as a device program")
    if transport == "nccl":
        for r in res:
            c = r.get("inner_check")
            if c is None:
                fail(f"{name}: rank {r['rank']}'s sharded levels kept the host loops")
            phase(name, t0, f"rank {r['rank']}: one inner restart as one replay of "
                  f"InnerRestartGraph with its collectives inside (K8 over peer pointers: "
                  f"NCCL's work cannot live in a graph's WHILE body, "
                  f"scripts/probe_torch_nccl_graph.py), {c['iterations']:.0f} iterations, "
                  f"{'bit-equal to' if c['equal'] else 'DIFFERS from'} its host loops "
                  f"{c['parts']}: "
                  f"replay {c['replay_ms']:.3f} ms, host loops {c['host_ms']:.3f} ms")
            if not c["equal"]:
                fail(f"{name}: rank {r['rank']}'s inner restart replay differs from its host "
                     "loops")
        if r0["counts"]["K8"] == 0:
            fail(f"{name}: no collective ran as K8")
    phase(name, t0, f"levels sharded {r0['sharded']}; rank 0's K5 launches by the axes "
          f"of their faces: {r0['k5_axes']}")
    split = "".join("tzyx"[mu] for mu in range(4) if dims[mu] > 1)
    if r0["counts"]["K5"] + r0["counts"]["K5-bf16"] and set(r0["k5_axes"]) != {split}:
        fail(f"{name}: K5 ran with the faces of {r0['k5_axes']}, not of the split axes {split}")
    for method, (single, kind) in (methods or {}).items():
        m0 = r0["methods"][method]
        per_it = 1e6 * m0["solve"] / max(m0["iterations"], 1)
        phase(name, t0, f"method {method} (no multigrid) on the grid: setup {m0['setup']:.3f} s, "
              f"solve {m0['solve']:.3f} s, {m0['iterations']} iterations ({per_it:.0f} us "
              f"each; one rank, phase methods: {single}), exact relres {m0['exact']:.6e} "
              f"(solver {m0['relres']:.6e}); rank 0 launches "
              + ", ".join(f"{k} {n}" for k, n in m0["counts"].items() if n))
        keys = ("iterations", "relres", "x_sum")
        if any(r["methods"][method][k] != m0[k] for r in res for k in keys):
            fail(f"{name}: ranks disagree on method {method}")
        if not m0["finite"]:
            fail(f"{name}: method {method}'s solution is not a finite field of the lattice's "
                 f"shape")
        if abs(m0["iterations"] - single) > 0.02 * single:
            fail(f"{name}: method {method} took {m0['iterations']} iterations, one rank "
                 f"{single} (more than 2 % apart)")
        limit = rough16_params().restart_length * rough16_params().max_restarts
        if not (m0["converged"] or (kind == "honest" and m0["iterations"] == limit)):
            fail(f"{name}: method {method} stopped after {m0['iterations']} iterations "
                 f"unconverged")
        if m0["converged"] and not m0["exact"] < 1e-10:
            fail(f"{name}: method {method}'s exact relres {m0['exact']:.3e} not < 1e-10")
        if abs(m0["exact"] - m0["relres"]) > 0.01 * m0["exact"]:
            fail(f"{name}: method {method}'s exact relres {m0['exact']:.6e} and the solver's "
                 f"{m0['relres']:.6e} differ by more than 1 %")
        if m0["counts"]["K1"] == 0:
            fail(f"{name}: method {method} never launched K1")
    phase(name, t0, "phase wall time")
    return r0["counts"]


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from ddalphaamg_tpu_torch import kernels

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().replace("\n", ", ")
    conditional = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    phase("device", t0, f"{smi}; compute mode {mode}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s); torch's conditional-node API "
          f"(CUDAGraph.begin_capture_to_if_node) {'present' if conditional else 'absent'} "
          f"(the coarsest GCR's graph is built by csrc/graph.cu either way)")

    t0 = time.perf_counter()
    kernels.lib()
    phase("build", t0, f"nvcc {kernels.build_seconds:.2f} s")

    t0 = time.perf_counter()
    U32, field_s = rough32_field()
    phase("kernels", t0, f"rough32's field {ROUGH32} made on the card in {field_s:.2f} s")
    results = {}
    check_kernels(results, U32)
    phase("kernels", t0, "all kernels agree with their plain versions")
    graph_path(results)

    paths = {}        # the launch counts of every path run, by name
    k6_ms = {}        # K6's device time in the profiled runs, by path
    counts, iterations, warm, solver = main_path()
    paths["solve"] = dict(counts)
    paths["multi"] = multi_path("multi", solver)
    inner_graph_path("inner-graph", solver, (1, MULTI_RHS))
    paths["setup-graph"] = setup_graph_path()
    singles = methods_path(paths, solver, k6_ms)
    library_path(paths, solver)
    del solver
    torch.cuda.empty_cache()
    sharded = sharded_path("sharded", (1, 2, 1, 1), "gloo", ["cuda:0"] * 2, iterations)
    paths["sharded (rank 0)"] = sharded
    counts["K5"] = sharded["K5"]
    paths["grid4d (rank 0)"] = sharded_path("grid4d", (1, 1, 2, 2), "gloo", ["cuda:0"] * 4,
                                            iterations, methods=singles)
    n = torch.cuda.device_count()
    if n >= 2:
        dims = (1, 1, 2, 2) if n >= 4 else (1, 2, 1, 1)
        sharded_path("nccl", dims, "nccl", [f"cuda:{i}" for i in range(math.prod(dims))],
                     iterations)
    else:
        print(f"[nccl] not run: {n} card (the nccl transport needs a card per rank)",
              flush=True)
    direct, direct_warm, direct_iterations, direct_warm_s, solver = direct_path(iterations,
                                                                              warm, k6_ms)
    paths["direct"], paths["direct, warm solve"] = direct, direct_warm
    print(f"[methods] K6 launches in a warm solve with the options on: 16 colours "
          f"{paths['method 3 + multigrid, options on, warm solve']['K6']}, red-black "
          f"{direct_warm['K6']}", flush=True)
    paths["multi-direct"] = multi_path("multi-direct", solver, k6_ms)
    del solver
    torch.cuda.empty_cache()
    counts["K4-bf16"], counts["K6"] = direct["K4-bf16"], direct["K6"]
    sharded_direct = sharded_path("sharded-direct", (1, 2, 1, 1), "gloo", ["cuda:0"] * 2,
                                  direct_iterations, options=True)
    paths["sharded-direct (rank 0)"] = sharded_direct
    counts["K5-bf16"] = sharded_direct["K5-bf16"]
    paths["defaults"] = defaults_path(iterations, warm, direct_warm_s)
    torch.cuda.empty_cache()
    paths["rough32"], profile32, shapes = rough32_path(U32, field_s)
    counts["K4-schur"] = paths["rough32"]["K4-schur"]
    gc.collect()        # the hierarchy, with its graphs' pools, before the shape checks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unlaunched = [shape_label(t) for t in ROUGH32_SHAPES if t not in shapes]
    phase("rough32", t0, f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "allocated before the shape checks")
    phase("rough32", t0, f"{len(shapes)} kernel shapes launched; phase 3's rows rough32 did not "
          "launch: " + ("; ".join(unlaunched) or "none"))
    params32 = rough32_params()
    check_rough32_kernels(results, torch.Generator(device="cuda").manual_seed(4321), U32,
                          params32.m0, params32.csw, shapes - set(ROUGH32_SHAPES))
    phase("rough32", t0, "the kernels agree with their plain versions at every other shape "
          "rough32 launched")
    del U32
    results["K6"]["device_ms_by_path"] = k6_ms
    print("[K6] device time by path: " + ", ".join(
        f"{p} {v['ms']:.4f} ms ({v['launches']} launches)" for p, v in k6_ms.items()),
        flush=True)
    summary = [dict(name=k.name, route=k.route, source=k.source,
                    replaces=k.replaces, launches=counts[key],
                    launches_by_path={p: c[key] for p, c in paths.items() if c[key]},
                    **results[key])
               for key, k in kernels.KERNELS.items()]
    print(f"[rough32] profiled warm solve: {json.dumps(profile32)}", flush=True)
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
