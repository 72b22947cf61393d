#!/usr/bin/env python
"""Time K7, the GCR step (csrc/gcr.cu: the Gram-Schmidt, alpha, the x / r
updates, the norm and the stop test), on one CUDA card:

    python3 scripts/probe_torch_gcr.py [--parent DIR] [--out FILE] [--reps N]

For every case (the GCR shapes of chip_smoke.py's K7_CASES: the fine GCR
16^4 x 12 at m = 50, the K-cycle 8^4 d 56 at m = 5, the coarsest GCRs 4^4
and 8^4 d 56 at m = 100, batch 1 and 12, complex64, and one complex128 row)
it checks one step against the plain version, then times a step as N raw
launches captured in one CUDA graph (torch.cuda.CUDAGraph, one replay,
CUDA events; the host's wrapper work is not in the time):

  auto     the design the launcher picks (what the port runs)
  cluster  the one-launch cluster design, forced (where its slices fit)
  grid     the two-launch grid design, forced
  parent   with --parent DIR (a checkout of another commit, e.g. made with
           git archive, whose K7 is the four-pass Gram-Schmidt): that
           commit's K7 built from DIR, plus the torch operations its
           GCRLanes.step ran after it, as cuda_gcr.update_step runs them
           (alpha by vecdot, x and r updates, the iteration count, the
           norm, the stop test and, at batch > 1, the residual mask),
           timed in turns with auto (parent, auto, auto, parent)

with the bound, (2j + 8) n elements a lane over 3.35 TB/s, the time torch
takes to read the 2j rows once (two sums, a reference for the card's read
rate), and each CUDA kernel's device time a step (torch.profiler).  Then the
crossover sweep: both designs at batch 1 and 12, j = 10 and 50, m = 100,
for n from 14,336 up to the largest the cluster design takes, the cases
each design won by n, and where the launcher's threshold
(ddaamg_gcr_path) picks the cluster design.

With --solve N, end to end: rough16 (chip_smoke.rough16_params, options
off) set up once, then its warm solve of the right-hand side of ones and
the 12-source batch (solve_multi) with the launcher's K7 design (auto)
against the grid design forced at every shape (grid), in turns (auto,
grid, grid, auto): each turn drops the device programs, captures them
anew in one solve, then times N warm solves and N // 3 batches (host
clock to torch.cuda.synchronize, SolveInfo.solve_time), with the
iterations and the exact relative residual.  Prints one line per case,
the card's name and power limit, and writes all numbers as JSON to FILE
(default build/probe_torch_gcr.json).
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the shapes, the bound model and the timing helper)
from ddalphaamg_tpu_torch import kernels  # noqa: E402
from ddalphaamg_tpu_torch.operators import cuda_gcr  # noqa: E402

SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
SWEEP = (14336, 28672, 57344, 86016, 114688, 131072)


def load_parent(path):
    """The kernel library of another checkout, built from its own sources."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(path, "ddalphaamg_tpu_torch", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.lib()


class Case:
    """The state of one GCR step of B lanes at row j: bases whose rows
    below j are filled, w and q, x and r; the stop is 0, so every lane
    goes on in every replay."""

    def __init__(self, n, m, j, B, dtype, gen):
        dev = "cuda"
        self.n, self.m, self.j, self.B, self.dtype = n, m, j, B, dtype

        def c(*shape):
            return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

        self.W = torch.zeros((B, m, n), dtype=dtype, device=dev)
        self.Q = torch.zeros_like(self.W)
        self.W[:, :j] = c(B, j, n) / n ** 0.5
        self.Q[:, :j] = c(B, j, n) / n ** 0.5
        self.w, self.q, self.x, self.r = c(B, n), c(B, n), c(B, n), c(B, n)
        self.rz = self.r.clone() if B > 1 else None
        self.jt = torch.tensor(j, device=dev)
        real = self.W.real.dtype
        self.go = torch.ones(B, dtype=torch.bool, device=dev)
        self.stop = torch.zeros(B, dtype=real, device=dev)
        self.rn = torch.ones(B, dtype=real, device=dev)
        self.iters = torch.zeros(B, dtype=torch.long, device=dev)
        self.c128 = int(dtype == torch.complex128)
        self.sums = torch.zeros(2, dtype=real, device=dev)
        lib = kernels.lib()
        self.work = (torch.empty(lib.ddaamg_gcr_work_bytes(B, m, n, self.c128),
                                 dtype=torch.uint8, device=dev),
                     torch.zeros(lib.ddaamg_gcr_sync_words(B, m), dtype=torch.int32,
                                 device=dev))

    def state(self):
        return (self.W, self.Q, self.jt, self.w, self.q, self.x, self.r, self.rz, self.go,
                self.stop, None, self.rn, self.iters)

    def step(self, path):
        """One raw launch of K7 (path: -1 the launcher's choice, 0 / 1)."""
        lib = kernels.lib()
        fn = getattr(lib, f"ddaamg_gcr_step_{SUFFIX[self.dtype]}")
        rc = fn(self.W.data_ptr(), self.Q.data_ptr(), self.jt.data_ptr(), self.w.data_ptr(),
                self.q.data_ptr(), self.x.data_ptr(), self.r.data_ptr(),
                None if self.rz is None else self.rz.data_ptr(), self.go.data_ptr(),
                self.stop.data_ptr(), None, self.rn.data_ptr(), self.iters.data_ptr(),
                self.work[0].data_ptr(), self.work[1].data_ptr(), self.B, self.m, self.n, path,
                torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "GCR step")

    def parent_step(self, lib, scratch):
        """The parent's step: its four-pass K7, then the torch operations
        of its GCRLanes.step."""
        H, h, N, wo, qo = scratch
        fn = getattr(lib, f"ddaamg_gcr_orthonormalize_{SUFFIX[self.dtype]}")
        rc = fn(self.W.data_ptr(), self.Q.data_ptr(), self.w.data_ptr(), self.q.data_ptr(),
                wo.data_ptr(), qo.data_ptr(), self.jt.data_ptr(), H.data_ptr(), h.data_ptr(),
                N.data_ptr(), self.B, self.m, self.n, torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "parent Gram-Schmidt")
        cuda_gcr.update_step(wo, qo, self.x, self.r, self.rz, self.go, self.stop, None,
                             self.rn, self.iters)

    def parent_scratch(self, lib):
        chunks = lib.ddaamg_gcr_chunks(self.n)
        dev, dt = "cuda", self.dtype
        return (torch.empty((self.B, self.m, chunks), dtype=dt, device=dev),
                torch.empty((self.B, self.m), dtype=dt, device=dev),
                torch.empty((self.B, chunks), dtype=self.W.real.dtype, device=dev),
                torch.empty_like(self.w), torch.empty_like(self.q))

    def read_rows(self):
        """A reference for the card's read rate: torch sums the rows below
        j of W and Q once (one reduction each)."""
        if self.j:
            for k, rows in enumerate((self.W, self.Q)):
                torch.sum(torch.view_as_real(rows[:, :self.j]), dim=(0, 1, 2, 3),
                          out=self.sums[k])

    def bound_ms(self):
        return 1e3 * (2 * self.j + 8) * self.n * self.B * self.W.element_size() / \
            chip_smoke.MEM_BYTES_PER_S


def split_us(fn, steps=5):
    """us a step of each CUDA kernel fn launches (torch.profiler over
    `steps` calls after a warm-up), by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            hit = re.search(r"gcr_\w+|\w*(kernel|reduce|elementwise)\w*", e.name)
            name = hit.group(0)[:40] if hit else e.name[:40]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / steps
    return out


def check(case, path):
    """One step of a design against the plain version on copies."""
    saved = [None if t is None else t.clone() for t in case.state()]
    case.step(path)
    got = [None if t is None else t.clone() for t in case.state()]
    plain = [None if t is None else t.clone() for t in saved]
    cuda_gcr.gcr_step_plain(*plain)
    torch.cuda.synchronize()
    for t, s in zip(case.state(), saved):       # back to the inputs
        if t is not None:
            t.copy_(s)
    err = 0.0
    for k in (0, 1, 5, 6, 11):                  # W, Q, x, r, rn
        g, p = got[k], plain[k]
        if k < 2:
            g, p = g[:, case.j], p[:, case.j]
        err = max(err, float((g - p).abs().max() / p.abs().max()))
    if err > chip_smoke.TOL[case.dtype]:
        raise SystemExit(f"K7 design {path} differs from the plain version by {err:.3e}")
    return err


def time_solves(reps):
    """rough16's warm solve and 12-source batch with K7's designs in turns
    (module note): {design: {"solve_s": [...], "batch_s": [...],
    "iterations": [...], "relres": [...]}}."""
    from ddalphaamg_tpu_torch import api, config

    solver = api.Solver(chip_smoke.rough16_params(False), device="cuda")
    solver.read_conf()
    solver.setup()
    rhs = config.make_rhs("ones", solver.lattice)
    point = chip_smoke.point_sources(solver.lattice)
    lib = kernels.lib()
    step, scratch = cuda_gcr.gcr_step, cuda_gcr.scratch

    def grid_scratch(B, m, n, dtype, device):
        device = torch.device(device)
        if device.type != "cuda":
            return None
        return cuda_gcr._grid_scratch(lib, B, m, n, int(dtype == torch.complex128), device)

    designs = {"auto": (step, scratch),
               "grid": (functools.partial(step, path="grid"), grid_scratch)}
    out = {k: dict(solve_s=[], batch_s=[], iterations=[], relres=[]) for k in designs}
    try:
        for name in ("auto", "grid", "grid", "auto"):
            cuda_gcr.gcr_step, cuda_gcr.scratch = designs[name]
            solver.mg.drop_graphs()
            solver.solve(rhs)                   # captures the programs
            solver.solve_multi(point)
            row = out[name]
            for _ in range(reps):
                x, info = solver.solve(rhs)
                row["solve_s"].append(info.solve_time)
                row["iterations"].append(info.iterations)
            row["relres"].append(solver.true_residual(x, rhs))
            for _ in range(max(1, reps // 3)):
                _, infos = solver.solve_multi(point)
                row["batch_s"].append(infos[0].solve_time * len(infos))
            print(f"solve turn {name}: warm {statistics.median(row['solve_s'][-reps:]):.4f} s "
                  f"(median of {reps}), batch {row['batch_s'][-1]:.4f} s, iterations "
                  f"{sorted(set(row['iterations']))}, relres {row['relres'][-1]:.3e}",
                  flush=True)
    finally:
        cuda_gcr.gcr_step, cuda_gcr.scratch = step, scratch
    for name, row in out.items():
        row["solve_median_s"] = statistics.median(row["solve_s"])
        row["batch_median_s"] = statistics.median(row["batch_s"])
    gap = out["grid"]["solve_median_s"] / out["auto"]["solve_median_s"] - 1
    print(f"warm solve: auto {out['auto']['solve_median_s']:.4f} s, grid "
          f"{out['grid']['solve_median_s']:.4f} s ({100 * gap:+.2f} %); batch: auto "
          f"{out['auto']['batch_median_s']:.4f} s, grid {out['grid']['batch_median_s']:.4f} s",
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of another commit to time against")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "probe_torch_gcr.json"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--solve", type=int, default=0, metavar="N",
                    help="warm solves a turn of rough16 with K7's designs (0: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_gcr.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    lib = kernels.lib()
    parent = load_parent(args.parent) if args.parent else None
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for label, n, m, js, batches, dtype in chip_smoke.K7_CASES:
        for B in batches:
            for j in js:
                case = Case(n, m, j, B, dtype, gen)
                c128 = case.c128
                paths = {"auto": -1, "grid": 1}
                if lib.ddaamg_gcr_cluster_fits(n, m, c128):
                    paths["cluster"] = 0
                err = max(check(case, p) for p in paths.values())
                ms = {name: chip_smoke.graph_ms(lambda p=p: case.step(p), args.reps)
                      for name, p in paths.items()}
                row = dict(case=label, n=n, m=m, j=j, batch=B, dtype=SUFFIX[dtype],
                           picked="cluster" if lib.ddaamg_gcr_path(n, m, c128) == 0 else "grid",
                           max_rel_err=err, bound_ms=case.bound_ms(), ms=ms,
                           split_us=split_us(lambda: case.step(-1)),
                           read_ms=chip_smoke.graph_ms(lambda: case.read_rows(), args.reps))
                if parent is not None:
                    scratch = case.parent_scratch(parent)
                    old, new = (lambda: case.parent_step(parent, scratch)), (lambda: case.step(-1))
                    turns = [chip_smoke.graph_ms(f, args.reps) for f in (old, new, new, old)]
                    row["turns"] = dict(parent=[turns[0], turns[3]], auto=turns[1:3])
                rows.append(row)
                par = (f"  parent {sum(row['turns']['parent']) / 2:8.4f} "
                       f"(turns {row['turns']['parent'][0]:.4f}/{row['turns']['parent'][1]:.4f}, "
                       f"auto {row['turns']['auto'][0]:.4f}/{row['turns']['auto'][1]:.4f})"
                       if "turns" in row else "")
                print(f"K7 {label} {SUFFIX[dtype]} m={m} j={j} batch {B}: "
                      + "  ".join(f"{k} {v:8.4f}" for k, v in ms.items())
                      + f"  bound {row['bound_ms']:.4f} "
                      f"({100 * row['bound_ms'] / ms['auto']:.1f} %)"
                      + f"  picked {row['picked']}{par}  rel err {err:.2e}; reading the "
                      f"2j rows once {row['read_ms']:.4f} ms; by kernel (us): "
                      + ", ".join(f"{k} {v:.1f}" for k, v in row["split_us"].items()),
                      flush=True)
                del case
                torch.cuda.empty_cache()
    sweep = []
    for n in SWEEP:
        if not lib.ddaamg_gcr_cluster_fits(n, 100, 0):
            continue
        ctas, slice_, active = cuda_gcr.cluster_shape(n)
        for B in (1, 12):
            for j in (10, 50):
                case = Case(n, 100, j, B, torch.complex64, gen)
                ms = {name: chip_smoke.graph_ms(lambda p=p: case.step(p), args.reps)
                      for name, p in (("cluster", 0), ("grid", 1))}
                best = min(ms, key=ms.get)
                picked = "cluster" if lib.ddaamg_gcr_path(n, 100, 0) == 0 else "grid"
                sweep.append(dict(n=n, batch=B, j=j, ms=ms, faster=best, picked=picked,
                                  ctas=ctas, slice=slice_, active_clusters=active))
                print(f"crossover n={n} ({ctas} CTAs of {slice_}, {active} clusters at once) "
                      f"batch {B} j={j}: cluster {ms['cluster']:.4f}  grid {ms['grid']:.4f}  "
                      f"faster {best}, picked {picked}", flush=True)
                del case
                torch.cuda.empty_cache()
    wins = {}
    for s in sweep:
        wins[s["n"]] = wins.get(s["n"], 0) + (s["faster"] == "cluster")
    picked = [n for n in wins if lib.ddaamg_gcr_path(n, 100, 0) == 0]
    print(f"crossover: cases of four the cluster design won, by n: {wins}; the launcher "
          f"picks it at n = {picked} (ddaamg_gcr_path: n up to its threshold, slices that "
          "fit)", flush=True)
    solves = time_solves(args.solve) if args.solve else None
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, cases=rows, crossover=sweep, solves=solves), f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
