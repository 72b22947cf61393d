"""coarse_ms.<cells>: device milliseconds a right-hand side of the coarse
stencil kernels (K4, K4-bf16, K5, K5-bf16, K4-schur: operators/cuda_coarse,
csrc/coarse.cu), read from the window's first request run again after the
window with host loops (trace.py), which launch them as often and at the
same shapes as the replays do."""


def read(rec):
    tr = rec["trace"]
    if tr is None or "coarse" not in tr["host_loops"]["families"]:
        return None
    hl = tr["host_loops"]
    return 1e3 * hl["families"]["coarse"][1] / hl["rhs"]
