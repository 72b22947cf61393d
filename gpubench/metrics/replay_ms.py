"""replay_ms.<cells>: device milliseconds a right-hand side inside the
device programs' replays, by the port's own CUDA events around each replay
(profiling.PROF at level 2), over every request of the traced window
(program_trace.py); None without the port's tracer."""


def read(rec):
    w = (rec.get("program") or {}).get("window")
    if not w or not sum(w["rhs"]):
        return None
    return 1e3 * sum(w["replay_s"]) / sum(w["rhs"])
