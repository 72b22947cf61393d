#!/usr/bin/env python
"""Time the SU(3) projection of tools.rough_su3(device=...) on one CUDA
card against torch.linalg.qr:

    python3 scripts/probe_torch_su3.py

For 4 x L^4 complex128 Ginibre matrices of 3 x 3 (L = 8, 16; seed 0) it
times, after one warm-up call each, tools._qr_q (classical Gram-Schmidt,
each projection twice) and torch.linalg.qr with the sign fix of
tools.random_su3 (R's diagonal made real and positive), and checks both
against numpy's QR with that fix on the first 20,000 matrices.  Prints one
line per size and the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddalphaamg_tpu_torch import tools  # noqa: E402


def seconds(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def householder(a):
    q, r = torch.linalg.qr(a)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    return q * (d / d.abs())[..., None, :]


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    rng = np.random.default_rng(0)
    for L in (8, 16):
        a = rng.normal(size=(4, L, L, L, L, 3, 3)) + 1j * rng.normal(size=(4, L, L, L, L, 3, 3))
        t = torch.as_tensor(a, device="cuda")
        n = 20000
        qn, rn = np.linalg.qr(a.reshape(-1, 3, 3)[:n])
        dn = np.diagonal(rn, axis1=-2, axis2=-1)
        qn = qn * (dn / np.abs(dn))[..., None, :]
        line = [f"{4 * L ** 4} matrices ({L}^4):"]
        for name, fn in (("tools._qr_q", tools._qr_q), ("torch.linalg.qr", householder)):
            s, q = seconds(lambda: fn(t))
            err = np.abs(q.reshape(-1, 3, 3)[:n].cpu().numpy() - qn).max()
            line.append(f"{name} {s:.6f} s (max error against numpy {err:.2e})")
        print(" ".join(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
