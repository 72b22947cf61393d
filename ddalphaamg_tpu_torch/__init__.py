"""ddalphaamg_tpu_torch: the DD-alphaAMG solver for the Wilson-clover Dirac
equation in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(csrc/).  It mirrors the module layout of the JAX package ddalphaamg_tpu,
which stays the reference it is tested against, and imports none of it.

    from ddalphaamg_tpu_torch import api, config
    params = config.parse_ini("bench_assets/rough16.ini")
    solver = api.Solver(params, device="cuda")
    plaq, header_plaq = solver.read_conf()
    solver.setup()
    x, info = solver.solve()
"""

__version__ = "0.1.0"
