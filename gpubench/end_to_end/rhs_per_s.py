"""rhs_per_s: right-hand sides solved per second over the whole window."""


def read(rec):
    return sum(r["batch"] for r in rec["requests"]) / rec["window_s"]
