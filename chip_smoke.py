"""Smoke run of ddalphaamg_tpu_torch on one CUDA card (an H100 in this
repository's runs):

    python3 chip_smoke.py

Phases, one result line each, in order:
  1. device   the card's name, power limit and compute mode (nvidia-smi),
              torch and CUDA
  2. build    compile csrc/*.cu for sm_90a (timed)
  3. kernels  every hand-written kernel against its plain PyTorch version on
              the card at the shapes of the rough16 solve (16^4 fine level;
              8^4 and 4^4 coarse levels with d = 56; K5 on rank 0's slab
              of the 8^4 level on the (1, 2, 1, 1) mesh, (8, 4, 8, 8) with z
              faces, and on the (2, 2, 1, 1) mesh, (4, 4, 8, 8) with t and
              z faces, faces cut from a random global field), batch 1 and
              28, with the max relative error against 1e-5 (f32) / 1e-13
              (f64) and the kernel and plain times from CUDA events after
              warm-up
  4. solve    the single-rank main path: Solver on bench_assets/rough16.ini
              at full parameters (plaquette 1.7878261039088 to 1e-10, setup,
              solve of a right-hand side of ones, exact relative residual
              recomputed in complex128 from the returned x, < 1e-10 in <= 12
              outer iterations), with the launch count of each kernel in
              that run (K1-K4 must be > 0)
  5. sharded  the domain-decomposed main path: the same solve on a
              (1, 2, 1, 1) t/z process grid, two ranks spawned on this one
              card with the "gloo" transport (faces and sums cross the host:
              its times are no scaling numbers); every rank must agree, the
              exact relres recomputed by rank 0 from the gathered x must be
              < 1e-10 in <= 12 outer iterations, within 1 of phase 4, and
              every kernel, K5 included, must have run
  6. nccl     with two or more cards, the same solve with the "nccl"
              transport on one card per rank ((2, 2, 1, 1) with four cards);
              with one card a line says it was not run

The second-to-last lines are a JSON summary of the kernels (launches of
K1-K4 from phase 4, of K5 from phase 5) and the card's nvidia-smi line; the
last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero before that line; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
INI = os.path.join(HERE, "bench_assets", "rough16.ini")
PLAQ = 1.7878261039088
TOL = {torch.complex64: 1e-5, torch.complex128: 1e-13}
BATCHES = (1, 28)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rough16_params():
    """rough16.ini with its configuration file taken from this checkout (the
    ini names it by an absolute path)."""
    from ddalphaamg_tpu_torch import config

    params = config.parse_ini(INI)
    params.configuration = os.path.join(HERE, "bench_assets",
                                        os.path.basename(params.configuration))
    return params


def phase(name, t0, text):
    print(f"[{name}] {text} ({time.perf_counter() - t0:.2f} s)", flush=True)


def cuda_ms(fn, reps=10):
    """Mean time of fn on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(results, key, label, kernel_fn, plain_fn, dtype):
    """One kernel-vs-plain check; keeps the worst error per kernel and the
    times of the first (batch 1, main-path dtype) case."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    tol = TOL[dtype]
    ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn, reps=3)
    ok = rel <= tol
    print(f"  {label:44s} rel err {rel:.3e} (tol {tol:.0e}) "
          f"kernel {ms:9.4f} ms  plain {plain_ms:9.4f} ms  "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail(f"{label}: relative error {rel:.3e} above {tol:.0e}")
    r = results.setdefault(key, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], abs_err)
    r.setdefault("ms", ms)
    r.setdefault("plain_ms", plain_ms)


def check_kernels(results):
    import numpy as np

    from ddalphaamg_tpu_torch import io
    from ddalphaamg_tpu_torch.geometry import Geometry
    from ddalphaamg_tpu_torch.operators import coarse, cuda_coarse, cuda_dslash, fast
    from ddalphaamg_tpu_torch.operators.stencil import ODD, WilsonStencilSoA
    from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    params = rough16_params()
    U, _ = io.read_gauge_field(params.configuration)
    lat = tuple(U.shape[1:5])
    op = WilsonOperator.from_gauge(torch.as_tensor(U, device=dev),
                                   params.m0, params.csw)
    geom = Geometry(lattice=lat, block=(2, 2, 2, 2))
    for dtype in (torch.complex64, torch.complex128):
        s = WilsonStencilSoA.build(op, geom, dtype=dtype)
        tag = "f32" if dtype == torch.complex64 else "f64"
        for B in BATCHES:
            phi = torch.randn((B, 12, s.geom.num_sites), generator=gen,
                              dtype=dtype, device=dev)
            lab = f"{lat[0]}^4 {tag} batch {B}"
            compare(results, "K1", f"K1 full {lab}",
                    lambda: cuda_dslash.d_plus_clover(s.links, s.cdiag, s.coff, phi, lat),
                    lambda: fast.d_plus_clover_soa(s.links, s.cdiag, s.coff, phi, lat),
                    dtype)
            if dtype != torch.complex64:
                continue
            compare(results, "K2", f"K2 hop (block links) {lab}",
                    lambda: cuda_dslash.hopping(s.links_intra, phi, lat),
                    lambda: fast.dslash_hopping_soa(s.links_intra, phi, lat), dtype)
            compare(results, "K3", f"K3 clover {lab}",
                    lambda: cuda_dslash.clover(s.cdiag, s.coff, phi, lat),
                    lambda: fast.clover_apply_soa(s.cdiag, s.coff, phi), dtype)
            compare(results, "K3", f"K3 clover inverse odd {lab}",
                    lambda: cuda_dslash.clover(s.cdiag_inv, s.coff_inv, phi, lat, ODD),
                    lambda: fast.clover_apply_soa(s.cdiag_inv, s.coff_inv, phi, lat, ODD),
                    dtype)
        del s
    d = 2 * params.depth[0].test_vectors
    cases = [("full K=9", (0, 9), None, None), ("hop K=8", (1, 9), None, None),
             ("block masked K=9", (0, 9), (2, 2, 2, 2), None),
             ("hop_intra masked K=8", (1, 9), (2, 2, 2, 2), None),
             ("self K=1", (0, 1), None, None), ("self_inv odd K=1", (0, 1), None, ODD)]
    for L in (lat[0] // 2, lat[0] // 4):
        clat = (L,) * 4
        V = int(np.prod(clat))
        Pk = torch.randn((9, d, d, V), generator=gen, dtype=torch.complex64, device=dev)
        for B in BATCHES:
            v = torch.randn((B, d, V), generator=gen, dtype=torch.complex64, device=dev)
            for name, terms, mask, parity in cases:
                compare(results, "K4", f"K4 {name} {L}^4 d={d} batch {B}",
                        lambda: cuda_coarse.coarse_apply(Pk, v, clat, terms, mask, parity),
                        lambda: coarse.coarse_apply_plain(Pk, v, clat, terms, mask, parity),
                        torch.complex64)
        del Pk
    check_halo_kernel(results, gen, (lat[0] // 2,) * 4, d)


def check_halo_kernel(results, gen, glat, d):
    """K5 on rank 0's slab of the depth-1 level, on the (1, 2, 1, 1) mesh
    (z faces) and the (2, 2, 1, 1) mesh (t and z faces) of the sharded
    paths, with faces cut from a random global field."""
    from ddalphaamg_tpu_torch.operators import coarse, cuda_coarse
    from ddalphaamg_tpu_torch.parallel.comm import face
    from ddalphaamg_tpu_torch.parallel.mesh import (SolverMesh, active_axes,
                                                    local_lattice, shard_field)

    dev = torch.device("cuda")
    for dims in ((1, 2, 1, 1), (2, 2, 1, 1)):
        mesh = SolverMesh(dims, 0)
        loc = local_lattice(mesh, glat)
        Pk = torch.randn((9, d, d, math.prod(loc)), generator=gen,
                         dtype=torch.complex64, device=dev)
        for B in BATCHES:
            vg = torch.randn((B, d, math.prod(glat)), generator=gen,
                             dtype=torch.complex64, device=dev)
            v = shard_field(mesh, vg, glat)
            halos = {}
            for mu in active_axes(mesh, glat):
                fwd = shard_field(mesh, coarse.neighbor(vg, 1 + mu, glat), glat)  # v(x + mu)
                bwd = shard_field(mesh, coarse.neighbor(vg, 5 + mu, glat), glat)  # v(x - mu)
                halos[mu] = (face(fwd, loc, mu, loc[mu] - 1).contiguous(),
                             face(bwd, loc, mu, 0).contiguous())
            for name, terms in (("full K=9", (0, 9)), ("hop K=8", (1, 9))):
                compare(results, "K5", f"K5 {name} mesh {dims} slab {loc} d={d} batch {B}",
                        lambda: cuda_coarse.coarse_apply_halo(Pk, v, loc, halos, terms),
                        lambda: coarse.coarse_apply_halo_plain(Pk, v, loc, halos, terms),
                        torch.complex64)
        del Pk


def main_path():
    import numpy as np

    from ddalphaamg_tpu_torch import api, config, kernels
    from ddalphaamg_tpu_torch.operators import wilson

    params = rough16_params()
    kernels.reset_counts()
    t0 = time.perf_counter()
    solver = api.Solver(params, device="cuda")
    plaq, header = solver.read_conf()
    phase("solve", t0, f"plaquette {plaq:.13f} (file {header:.13f})")
    if abs(plaq - PLAQ) > 1e-10:
        fail(f"plaquette {plaq:.13f} != {PLAQ}")
    status = solver.setup()
    phase("solve", t0, f"setup {status.setup_time:.3f} s")
    rhs = config.make_rhs("ones", solver.lattice)
    x, info = solver.solve(rhs)
    counts = kernels.counts()
    # exact residual from the returned x through the logical operator
    xs = torch.as_tensor(x, device="cuda")
    b = torch.as_tensor(rhs, device="cuda")
    r = b - wilson.d_plus_clover(solver.op, xs)
    exact = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    finite = bool(np.isfinite(x).all()) and x.shape == (*solver.lattice, 4, 3)
    phase("solve", t0, f"solve {info.solve_time:.3f} s, {info.iterations} outer "
          f"iterations, exact relres {exact:.6e} (solver {info.relres:.6e}), "
          f"coarse average {info.coarse_average:.2f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase("solve", t0, "launches " + ", ".join(f"{k} {n}" for k, n in counts.items()))
    if not finite:
        fail("solution is not a finite field of the lattice's shape")
    if not (info.converged and exact < 1e-10 and info.iterations <= 12):
        fail(f"solve did not meet relres < 1e-10 in <= 12 iterations "
             f"(iterations {info.iterations}, exact relres {exact:.3e})")
    missing = [k for k, n in counts.items() if n == 0 and k != "K5"]
    if missing:
        fail(f"the main path never launched {missing}")
    return counts, info.iterations


def sharded_rank(mesh, device):
    """One rank of the sharded rough16 solve (run by parallel/launch.run_ranks
    in a spawned process)."""
    import numpy as np

    from ddalphaamg_tpu_torch import api, config, kernels
    from ddalphaamg_tpu_torch.operators import wilson

    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    solver = api.Solver(rough16_params(), device=device, mesh=mesh)
    plaq, _ = solver.read_conf()
    status = solver.setup()
    rhs = config.make_rhs("ones", solver.lattice)
    x, info = solver.solve(rhs)
    out = dict(rank=mesh.rank, plaq=plaq, setup=status.setup_time,
               solve=info.solve_time, iterations=info.iterations,
               relres=info.relres, converged=info.converged,
               coarse_average=info.coarse_average, counts=kernels.counts(),
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               x_sum=complex(x.sum()))
    if mesh.rank == 0:    # exact residual from the gathered x, logical operator
        xs = torch.as_tensor(x, device=device)
        b = torch.as_tensor(rhs, device=device)
        r = b - wilson.d_plus_clover(solver.op, xs)
        out["exact"] = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
        out["finite"] = bool(np.isfinite(x).all()) and x.shape == (*solver.lattice, 4, 3)
    return out


def sharded_path(name, dims, transport, devices, single_iterations):
    """The sharded solve on spawned ranks; returns rank 0's launch counts."""
    from ddalphaamg_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    res = launch.run_ranks(sharded_rank, dims, transport, devices)
    r0 = res[0]
    phase(name, t0, f"mesh {dims}, {len(res)} ranks, {transport} on "
          f"{', '.join(devices)}: plaquette {r0['plaq']:.13f}, setup "
          f"{r0['setup']:.3f} s, solve {r0['solve']:.3f} s, "
          f"{r0['iterations']} outer iterations (single rank {single_iterations}), "
          f"exact relres {r0['exact']:.6e} (solver {r0['relres']:.6e}), coarse average "
          f"{r0['coarse_average']:.2f}, peak device memory per rank "
          f"{max(r['peak_gib'] for r in res):.2f} GiB")
    phase(name, t0, "rank 0 launches " + ", ".join(
        f"{k} {n}" for k, n in r0["counts"].items()))
    keys = ("iterations", "relres", "coarse_average", "x_sum")
    if any(r[k] != r0[k] for r in res for k in keys):
        fail(f"{name}: ranks disagree: {[{k: r[k] for k in keys} for r in res]}")
    if abs(r0["plaq"] - PLAQ) > 1e-10:
        fail(f"{name}: plaquette {r0['plaq']:.13f} != {PLAQ}")
    if not r0["finite"]:
        fail(f"{name}: solution is not a finite field of the lattice's shape")
    if not (r0["converged"] and r0["exact"] < 1e-10 and r0["iterations"] <= 12
            and abs(r0["iterations"] - single_iterations) <= 1):
        fail(f"{name}: solve did not meet relres < 1e-10 in <= 12 iterations within "
             f"1 of the single-rank run (iterations {r0['iterations']}, exact relres "
             f"{r0['exact']:.3e})")
    missing = [k for k, n in r0["counts"].items() if n == 0]
    if missing:
        fail(f"{name}: the sharded path never launched {missing}")
    return r0["counts"]


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from ddalphaamg_tpu_torch import kernels

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().replace("\n", ", ")
    phase("device", t0, f"{smi}; compute mode {mode}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s)")

    t0 = time.perf_counter()
    kernels.lib()
    phase("build", t0, f"nvcc {kernels.build_seconds:.2f} s")

    t0 = time.perf_counter()
    results = {}
    check_kernels(results)
    phase("kernels", t0, "all kernels agree with their plain versions")

    counts, iterations = main_path()
    sharded = sharded_path("sharded", (1, 2, 1, 1), "gloo", ["cuda:0"] * 2, iterations)
    counts["K5"] = sharded["K5"]
    n = torch.cuda.device_count()
    if n >= 2:
        dims = (2, 2, 1, 1) if n >= 4 else (1, 2, 1, 1)
        sharded_path("nccl", dims, "nccl", [f"cuda:{i}" for i in range(math.prod(dims))],
                     iterations)
    else:
        print(f"[nccl] not run: {n} card (the nccl transport needs a card per rank)",
              flush=True)
    summary = [dict(name=k.name, route=k.route, source=k.source,
                    replaces=k.replaces, launches=counts[key], **results[key])
               for key, k in kernels.KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
