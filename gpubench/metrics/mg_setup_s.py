"""mg_setup_s: the multigrid setup's seconds, SetupStatus.setup_time of the
run's api.Solver.setup()."""


def read(rec):
    return rec["mg_setup_s"]
