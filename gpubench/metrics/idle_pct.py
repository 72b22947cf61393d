"""idle_pct.<cells>: the share of the profiled requests' window (the first
request span's start to the last one's end, on the profiler's clock) in
which no kernel, copy, set or graph replay ran on the device, percent.  A
replay's whole range counts as busy: gaps inside it are not seen."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
