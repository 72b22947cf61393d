"""Run one cell of BENCHMARK.json on this machine's CUDA card:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's notes and the numbers compared with their limits on
standard error, and the result as one JSON object on the last line of
standard output.  Exits non-zero, printing no result, without a card (or
with fewer than the cell asks for), when the package under test cannot be
imported, or when the JAX package or JAX was loaded (here or in any rank).
A cell on a process grid runs its ranks one a card (grid.py); STARTED,
this process's start, is the start of every rank's set-up.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)         # this folder's modules only as gpubench.*
    import torch

    from gpubench import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    if cell.grid is None:
        torch.cuda.set_device(0)
        res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
        bad = harness.banned_modules()
    else:
        from gpubench import grid

        ranks = grid.run(cell, ROOT, args.seed, args.seconds, bool(args.trace), STARTED)
        res = ranks[0]
        bad = sorted(set(harness.banned_modules()).union(*(r["banned"] for r in ranks)))
    if bad:
        print(f"loaded modules of the JAX package or JAX: {bad}", file=sys.stderr)
        return 3
    harness.report(res)
    print(json.dumps(res["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
