"""coarse_span_ms.<cells>: device milliseconds a right-hand side of K4 /
K4-bf16 / K5 / K5-bf16 / K4-schur on the replayed path, from the port's
device marks (profiling.PROF at level 4) in the window's first request run
again, each launch's marked time less the marks' own cost
(program_trace.py).  None without the port's tracer."""


def read(rec):
    m = (rec.get("program") or {}).get("marks")
    if not m or not m["rhs"] or m["cost_ns"] is None:
        return None
    return 1e3 * m["coarse_s"] / m["rhs"]
