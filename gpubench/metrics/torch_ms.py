"""torch_ms.<cells>: device milliseconds a right-hand side of PyTorch's own
kernels (events that match no kernel of the port, copies apart), read from
the window's first request run again after the window with host loops
(trace.py): the same port kernels at the same shapes as the replays, plus
the host loops' own loop control; the multigrid cycle's vector ops."""


def read(rec):
    tr = rec["trace"]
    if tr is None or "torch" not in tr["host_loops"]["families"]:
        return None
    hl = tr["host_loops"]
    return 1e3 * hl["families"]["torch"][1] / hl["rhs"]
