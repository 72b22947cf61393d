"""solve_p95_s: the 95th percentile of the wall time of every request in
the window (one single-RHS solve_multi each), seconds.  A per-layer metric:
its tail is stalls inside the outer loop (api.Solver._solve_mp) that come
in 2-8 % of requests, so its spread from run to run differs too much from
card to card for any bound to hold on all of them."""

import numpy as np


def read(rec):
    return float(np.percentile([r["latency_s"] for r in rec["requests"]], 95))
