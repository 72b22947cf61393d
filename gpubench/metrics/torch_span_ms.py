"""torch_span_ms.<cells>: device milliseconds a right-hand side of
PyTorch's own ops on the replayed path, from the port's device marks
(profiling.PROF at level 4) in the window's first request run again: every
marked section's time less the port kernels and sections inside it and
the marks' own cost (program_trace.py).  None without the port's tracer."""


def read(rec):
    m = (rec.get("program") or {}).get("marks")
    if not m or not m["rhs"] or m["cost_ns"] is None:
        return None
    return 1e3 * m["torch_s"] / m["rhs"]
