#!/usr/bin/env python
"""chip_smoke.py's phase "nccl" alone, on the cards of one machine:

    python3 scripts/nccl_grid_phase.py [--dims 1,2,1,1 --dims 1,1,2,2]

Builds the kernels once, then for each grid spawns one nccl rank per card
(cuda:0, cuda:1, ...) and runs chip_smoke.sharded_path: rough16 set up and
solved on the grid (every inner restart, cycle and setup sweep a replay
with the grid's collectives inside as K8), the replicated coarsest call
and one inner restart each held bit-equal to their host loops on every
rank, iterations within 1 of one rank (11), the warm solve with the replays
and with host loops.  A grid of n ranks needs n cards; exits non-zero on
any failed check, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", action="append",
                    help="a grid t,z,y,x (repeatable; default 1,2,1,1 and 1,1,2,2)")
    ap.add_argument("--iterations", type=int, default=11,
                    help="the one-rank solve's outer iterations (chip_smoke.py phase 4)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    from ddalphaamg_tpu_torch import kernels

    grids = [tuple(int(x) for x in d.split(",")) for d in (args.dims or ["1,2,1,1", "1,1,2,2"])]
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(map(math.prod, grids)):
        sys.exit(f"the grids {grids} need a card per rank")
    kernels.lib()
    print(f"built in {kernels.build_seconds:.2f} s", flush=True)
    for dims in grids:
        counts = chip_smoke.sharded_path("nccl", dims, "nccl",
                                         [f"cuda:{i}" for i in range(math.prod(dims))],
                                         args.iterations)
        print(f"rank 0's launches on {dims}: {counts}", flush=True)


if __name__ == "__main__":
    main()
