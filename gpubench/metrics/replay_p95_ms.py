"""replay_p95_ms.<cells>: the 95th percentile over the traced window's
requests of each request's replay device milliseconds a right-hand side
(the port's CUDA events, program_trace.py); set against solve_p95_s, it
says whether the solves' tail is the device's or the host's.  None
without the port's tracer."""

import numpy as np


def read(rec):
    w = (rec.get("program") or {}).get("window")
    if not w or not w["rhs"]:
        return None
    return float(np.percentile([1e3 * s / b for s, b in zip(w["replay_s"], w["rhs"])], 95))
