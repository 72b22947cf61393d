#!/usr/bin/env python
"""Probe whether NCCL's captured work can live inside a conditional (WHILE)
body of the port's CUDA graphs (solvers/cuda_graph.CudaGraph.loop,
csrc/graph.cu), on two or more cards:

    python3 scripts/probe_torch_nccl_graph.py [--ranks 2]

Each rank (one card each, torch's NCCL process group bound to its card at
init) warms its communicators (an all-reduce and a batch_isend_irecv
exchange with its ring neighbours, parallel/comm.py), then runs one step
over and over: exchange the two ends of a vector with the neighbours
(comm.exchange: dist.batch_isend_irecv), mix them in, all-reduce the
vector's squared norm (comm.all_reduce_sum: dist.all_reduce) and set a
device flag "go on" from the all-reduced value, which every rank holds bit
for bit.  Three ways, each in fresh processes:

  eager    the step from the host, the flag read on the host each pass;
  flat     FLAT steps captured one after the other into one graph (no
           conditional node), replayed once (held against the eager
           vector after FLAT passes);
  loop     one WHILE node whose one body is the step, with a trip count
           decided on the device by the flag, replayed once.

Each captured way is held bit for bit against the eager one (vector and
passes).  Prints one JSON line per way and rank, then a summary line
{"route": ...}: "nccl-in-body" where the loop way captured, replayed and
agreed, else what failed.  Also torch's, CUDA's and NCCL's versions and
the cards' names and power limits.  A capture that fails is reported, not
retried: the probe decides the design once.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

N = 1 << 16             # elements of each rank's vector
FACE = 1024             # elements sent each way
STEPS = 40              # passes at most
FLAT = 3                # steps of the flat capture
THRESHOLD = 1e-3        # go on while the global squared norm is above this


def _step(mesh, v, go, thr):
    """One pass: exchange faces, mix, all-reduce the norm, set go."""
    from ddalphaamg_tpu_torch.parallel import comm

    from_plus, from_minus = comm.exchange(mesh, 1, to_minus=v[:FACE], to_plus=v[-FACE:])
    w = 0.5 * v
    w[:FACE] += 0.125 * from_minus
    w[-FACE:] += 0.125 * from_plus
    v.copy_(w)
    s = comm.all_reduce_sum(mesh, torch.linalg.vecdot(v, v).reshape(1))
    torch.gt(s, thr, out=go)


def _rank(rank, world, way, tmp):
    from ddalphaamg_tpu_torch.parallel.comm import Comm
    from ddalphaamg_tpu_torch.parallel.mesh import make_solver_mesh
    from ddalphaamg_tpu_torch.solvers.cuda_graph import CudaGraph

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120),
                            device_id=dev)
    mesh = make_solver_mesh(dims=(1, world, 1, 1), rank=rank, comm=Comm("nccl", dev))
    out = {"way": way, "rank": rank}
    try:
        gen = torch.Generator(device=dev).manual_seed(1234 + rank)
        v0 = torch.rand(N, generator=gen, device=dev, dtype=torch.float32) / 64
        thr = torch.tensor(THRESHOLD, dtype=torch.float32, device=dev)
        # warm-up: every communicator this rank uses, before any capture
        warm_v, warm_go = v0.clone(), torch.zeros(1, dtype=torch.bool, device=dev)
        _step(mesh, warm_v, warm_go, thr)
        torch.cuda.synchronize()
        v = v0.clone()
        go = torch.ones(1, dtype=torch.bool, device=dev)
        passes = torch.zeros((), dtype=torch.long, device=dev)
        if way == "eager":
            n = 0
            while n < STEPS and bool(go):
                _step(mesh, v, go, thr)
                n += 1
                if n == FLAT:
                    torch.save(v.cpu(), os.path.join(tmp, f"flat_ref_{rank}.pt"))
            passes.fill_(n)
        else:
            g = CudaGraph(dev)
            if way == "flat":
                def program(ctl):
                    for _ in range(FLAT):
                        _step(mesh, v, go, thr)
            else:
                def program(ctl):
                    ctl.loop(STEPS, lambda: go, lambda j: _step(mesh, v, go, thr))
            g.capture(program)
            out["captured"] = True
            v.copy_(v0)
            go.fill_(True)
            g.trips.zero_()
            g.launch()
            torch.cuda.synchronize()
            out["replayed"] = True
            passes.fill_(int(g.trips[0]) if way == "loop" else FLAT)
            g.close()
        out["passes"] = int(passes)
        out["v_sum"] = float(v.double().sum())
        torch.save(v.cpu(), os.path.join(tmp, f"{way}_{rank}.pt"))
        out["ok"] = True
    except Exception as e:          # reported, not retried: the probe's output
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
        out["trace"] = traceback.format_exc()[-1500:]
    with open(os.path.join(tmp, f"{way}_{rank}.json"), "w") as f:
        json.dump(out, f)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        print(f"needs {args.ranks} CUDA cards, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        sys.exit(1)
    from ddalphaamg_tpu_torch import kernels

    kernels.build()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "driver": torch.cuda.driver_version()
                      if hasattr(torch.cuda, "driver_version") else None}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for way in ("eager", "flat", "loop"):
            sub = os.path.join(tmp, way)
            os.makedirs(sub)
            try:
                mp.start_processes(_rank, args=(args.ranks, way, sub), nprocs=args.ranks,
                                   join=True, start_method="spawn")
            except Exception as e:
                print(json.dumps({"way": way, "processes": f"{type(e).__name__}: {e}"}))
            rows = []
            for r in range(args.ranks):
                p = os.path.join(sub, f"{way}_{r}.json")
                rows.append(json.load(open(p)) if os.path.exists(p)
                            else {"way": way, "rank": r, "ok": False, "error": "no result"})
                for key, name in (("v", f"{way}_{r}.pt"), ("v_flat", f"flat_ref_{r}.pt")):
                    if os.path.exists(os.path.join(sub, name)):
                        rows[-1][key] = torch.load(os.path.join(sub, name))
            results[way] = rows
            for row in rows:
                print(json.dumps({k: v for k, v in row.items() if k not in ("v", "v_flat")}))
    ref = results["eager"]
    summary = {}
    for way in ("flat", "loop"):
        rows = results[way]
        if not all(r.get("ok") for r in rows) or not all(r.get("ok") for r in ref):
            summary[way] = "failed: " + "; ".join(r.get("error", "") for r in rows
                                                  if not r.get("ok"))
            continue
        key = "v" if way == "loop" else "v_flat"
        same = all(torch.equal(a["v"], b[key]) for a, b in zip(rows, ref))
        trips = [r["passes"] for r in rows]
        want = [r["passes"] for r in ref] if way == "loop" else [FLAT] * len(rows)
        summary[way] = ("bit-equal" if same and (way == "flat" or trips == want)
                        else f"differs (passes {trips} against {want}, bits equal {same})")
    loop_ok = summary.get("loop") == "bit-equal"
    summary["eager passes"] = [r.get("passes") for r in ref]
    summary["route"] = "nccl-in-body" if loop_ok else "peer-pointer kernels needed"
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
