"""outer_iters.<cells>: outer iterations a right-hand side, the mean of
SolveInfo.iterations over the window's requests (api.Solver.solve_multi,
_solve_mp)."""


def read(rec):
    its = [n for r in rec["requests"] for n in r["iterations"]]
    return sum(its) / len(its)
