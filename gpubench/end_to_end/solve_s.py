"""solve_s.<cells>: the window's wall time over the right-hand sides it
solved (single-RHS solves in the cells that report it), seconds."""


def read(rec):
    return rec["window_s"] / sum(r["batch"] for r in rec["requests"])
