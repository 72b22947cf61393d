#!/usr/bin/env python
"""Time K6 (csrc/dense.cu, the bf16-stored batched matvec) on one CUDA card,
launch by launch:

    python3 scripts/probe_torch_dense.py [--parent DIR] [--out FILE]

At every shape of chip_smoke.py's K6 rows (rough16's Schur inverse [1, 7168,
7168] and block inverses [256, 896, 896] on all blocks, one red-black
colour's and one of sixteen colours' blocks; batch 1 and 12) it checks the
listed blocks against the plain version (1e-5), then times raw ctypes
launches on preallocated outputs with CUDA events, so the wrapper's host
work is not in the time:

  warm    20 launches back to back, the mean
  cold    20 launches with 64 MiB written before each (the 50 MB L2 holds
          nothing of the inputs), each timed alone, the mean
  parent  with --parent DIR (a checkout of another commit, e.g. made with
          git archive): that commit's kernels, built from DIR, on the same
          inputs and all blocks (a kernel without block lists multiplies
          every block at a colour step), warm, in turns with this commit's
          (parent, this, this, parent)

beside the bound of chip_smoke.dense_work.  Prints one line per case and
the card's name and power limit, and writes the numbers as JSON to FILE
(default build/probe_torch_dense.json).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the shapes, the bound model and the timing helper)
from ddalphaamg_tpu_torch import kernels  # noqa: E402
from ddalphaamg_tpu_torch.operators import coarse, cuda_dense  # noqa: E402

REPS = 20


def load_parent(path):
    """The kernel library of another checkout, built from its own sources."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(path, "ddalphaamg_tpu_torch", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.lib()


def cold_ms(fn, flush):
    """Mean time of fn alone with the L2 flushed before each launch."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    for s, e in zip(starts, ends):
        flush.add_(1)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / REPS


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of another commit to time against")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "probe_torch_dense.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the probe times the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = kernels.lib()
    parent = load_parent(args.parent) if args.parent else None
    dev = torch.device("cuda")
    stream = kernels.stream_ptr(dev)
    flush = torch.zeros(16 * 2**20, dtype=torch.float32, device=dev)     # 64 MiB
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for nb, m, lists in chip_smoke.dense_cases(56, (16, 16, 16, 16)):
        A = coarse.compress(torch.randn((nb, m, m), generator=gen, dtype=torch.complex64,
                                        device=dev))
        for R in (1, chip_smoke.MULTI_RHS):
            x = torch.randn((R, nb, m), generator=gen, dtype=torch.complex64, device=dev)
            y = torch.zeros_like(x)
            for label, blocks in lists.items():
                nc = nb if blocks is None else blocks.numel()
                bl = 0 if blocks is None else blocks.data_ptr()
                if R == 1:
                    def launch():
                        return lib.ddaamg_dense_bf16(y.data_ptr(), x.data_ptr(), A.data_ptr(),
                                                     bl, nb, m, nc, stream)
                else:
                    def launch():
                        return lib.ddaamg_dense_bf16_mrhs(y.data_ptr(), x.data_ptr(),
                                                          A.data_ptr(), bl, nb, m, R, nc, stream)
                y.zero_()
                kernels.check(launch(), "K6")
                want = cuda_dense.matvec_plain(A, x, blocks)
                rel = float((y - want).abs().max() / want.abs().max())
                if rel > 1e-5:
                    sys.exit(f"K6 [{nb}, {m}, {m}] batch {R}, {label}: rel err {rel:.3e}")
                work = chip_smoke.dense_work(A, x[0] if R == 1 else x, blocks, R)
                bound = 1e3 * max(work[0] / chip_smoke.MEM_BYTES_PER_S, work[1] / work[2])
                ms = {}
                if parent is not None:
                    if R == 1:
                        def old():
                            return parent.ddaamg_dense_bf16(y.data_ptr(), x.data_ptr(),
                                                            A.data_ptr(), nb, m, stream)
                    else:
                        def old():
                            return parent.ddaamg_dense_bf16_mrhs(y.data_ptr(), x.data_ptr(),
                                                                 A.data_ptr(), nb, m, R, stream)
                    kernels.check(old(), "parent K6")
                    p1 = chip_smoke.cuda_ms(old, reps=REPS)
                    a1 = chip_smoke.cuda_ms(launch, reps=REPS)
                    a2 = chip_smoke.cuda_ms(launch, reps=REPS)
                    p2 = chip_smoke.cuda_ms(old, reps=REPS)
                    ms.update(parent=[p1, p2], warm=[a1, a2])
                else:
                    ms["warm"] = [chip_smoke.cuda_ms(launch, reps=REPS)]
                ms["cold"] = [cold_ms(launch, flush)]
                mean = {k: sum(v) / len(v) for k, v in ms.items()}
                row = dict(shape=[nb, m, m], batch=R, blocks=label, listed=nc, rel_err=rel,
                           bound_ms=bound, bound_by="bytes" if work[0] / chip_smoke.MEM_BYTES_PER_S
                           >= work[1] / work[2] else "operations", ms=ms, mean=mean)
                rows.append(row)
                par = (f"parent {mean['parent']:8.4f} ({ms['parent'][0]:.4f}/{ms['parent'][1]:.4f})  "
                       if parent is not None else "")
                print(f"K6 [{nb}, {m}, {m}] batch {R:2d}, {label:22s} warm {mean['warm']:8.4f} "
                      f"cold {mean['cold']:8.4f}  {par}bound {bound:8.4f} ({row['bound_by']}, "
                      f"{100 * bound / mean['warm']:5.1f} % warm)  rel err {rel:.2e}", flush=True)
        del A
    print(smi)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
