"""outer_idle_ms.<cells>: device idle milliseconds a right-hand side while
the outer loop's own host code (an outer iteration outside its replays,
reads, scatter and gather) was the innermost port span, from the window's
first request run again with the port's spans as profiler ranges
(profiling.PROF at level 3, program_trace.py).  None without the port's
tracer."""


def read(rec):
    r = (rec.get("program") or {}).get("ranges")
    if not r or not r["rhs"]:
        return None
    return 1e3 * r["outer_idle_s"] / r["rhs"]
