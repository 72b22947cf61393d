"""setup_s: the process's start to the window's start (imports, the field,
set_conf, the multigrid setup, slim_for_solve, the warm-up request with its
captures), seconds."""


def read(rec):
    return rec["setup_s"]
