"""coarse_avg.<cells>: coarsest iterations an outer iteration, the mean of
SolveInfo.coarse_average over the window's requests (one a dense-inverse
apply where the coarsest level is direct)."""


def read(rec):
    return sum(r["coarse_average"] for r in rec["requests"]) / len(rec["requests"])
