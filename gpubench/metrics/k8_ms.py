"""k8_ms.<cells>: device milliseconds a right-hand side of K8 (csrc/peer.cu:
the face exchanges' post and finish, the all-reduces and the gathers of a
process grid over nccl), on rank 0, read from the window's first request
run again after the window with host loops (trace.py) on every rank; None
where no K8 kernel ran (one card, or gloo).

It includes the wait for the other ranks: K8's kernels spin on the device
until every rank has arrived, and in the host-loop rerun each rank's host
drives every launch, so the reading is the exchanges' cost plus how far the
ranks' hosts drift apart; it is not the transfers' time alone."""


def read(rec):
    tr = rec["trace"]
    if tr is None or "K8" not in tr["host_loops"]["families"]:
        return None
    hl = tr["host_loops"]
    return 1e3 * hl["families"]["K8"][1] / hl["rhs"]
