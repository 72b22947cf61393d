#!/usr/bin/env python
"""Profile the port's rough16 solve with the accelerator options off on one
CUDA card (torch.profiler, CUPTI kernel events):

    python3 scripts/profile_torch_solve.py [--root DIR] [--out FILE]

In order: the setup (wall time), the first solve, a warm solve under the
profiler (CPU and CUDA activities; kernel time by kernel, the launches and
time of K1, K2, K3 and K4, the device's busy share of the solve's wall
time), a second warm
solve with the host time of every coarse_apply call taken around the
wrapper (perf_counter, no synchronisation: the host's cost of a launch),
and a second setup under the profiler (CUDA activity only) to split the
setup into K1-K4 and the rest.  The profiler's own cost is in the profiled
wall times.  --root DIR profiles the package of another checkout (e.g. the
parent commit unpacked by git archive) on the same data.  Prints a summary
and writes it as JSON to FILE (default build/profile_torch_solve.json).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COARSE = ("coarse_kernel", "coarse_b1_kernel", "coarse_mrhs_kernel")   # K4 / K5, either design
# K1 (dslash_kernel / dslash_mrhs_kernel with the clover), K2 (without)
# and K3, either design
WILSON = {"K1": re.compile(r"dslash_(mrhs_)?kernel<(float|double), true"),
          "K2": re.compile(r"dslash_(mrhs_)?kernel<(float|double), false"),
          "K3": re.compile(r"clover_kernel<")}


def device_events(prof):
    """(name, start us, end us) of every kernel, copy and fill on the card
    (not the annotations of record_function ranges)."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.name != "warm solve"]


def by_kernel(events):
    """{name: [launches, total ms]}, largest total first."""
    tot = defaultdict(lambda: [0, 0.0])
    for name, t0, t1 in events:
        tot[name][0] += 1
        tot[name][1] += (t1 - t0) / 1e3
    return dict(sorted(tot.items(), key=lambda kv: -kv[1][1]))


def busy_ms(events, lo, hi):
    """Time inside [lo, hi] (us) during which the card ran something."""
    spans = sorted((max(t0, lo), min(t1, hi)) for _, t0, t1 in events if t1 > lo and t0 < hi)
    total, end = 0.0, lo
    for t0, t1 in spans:
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total / 1e3


def wilson_ms(table):
    """{K1 / K2 / K3: [launches, device ms]}."""
    return {key: [sum(c for name, (c, _) in table.items() if pat.search(name)),
                  sum(t for name, (_, t) in table.items() if pat.search(name))]
            for key, pat in WILSON.items()}


def coarse_ms(table):
    n = sum(c for name, (c, _) in table.items() if any(k in name for k in COARSE))
    ms = sum(t for name, (_, t) in table.items() if any(k in name for k in COARSE))
    return n, ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose package is profiled")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "profile_torch_solve.json"))
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), HERE]
    import chip_smoke  # rough16's parameters
    from ddalphaamg_tpu_torch import api, config, kernels
    from ddalphaamg_tpu_torch.operators import cuda_coarse

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the profile is taken on a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels.lib()
    solver = api.Solver(chip_smoke.rough16_params(), device="cuda")
    solver.read_conf()
    setup_s = solver.setup().setup_time
    rhs = config.make_rhs("ones", solver.lattice)
    _, first = solver.solve(rhs)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("warm solve"):
            _, warm = solver.solve(rhs)
    window = next(e for e in prof.events()
                  if e.name == "warm solve" and e.device_type == DeviceType.CPU).time_range
    events = device_events(prof)
    table = by_kernel(events)
    k4_launches, k4_ms = coarse_ms(table)
    wall_ms = (window.end - window.start) / 1e3
    busy = busy_ms(events, window.start, window.end)

    calls = []
    wrapped = cuda_coarse.coarse_apply

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = wrapped(*a, **k)
        calls.append(time.perf_counter() - t0)
        return out

    cuda_coarse.coarse_apply = timed
    try:
        _, warm2 = solver.solve(rhs)
    finally:
        cuda_coarse.coarse_apply = wrapped
    host_us = 1e6 * sum(calls) / max(len(calls), 1)

    with profile(activities=[ProfilerActivity.CUDA]) as sprof:
        t0 = time.perf_counter()
        solver.setup()
        setup_prof_s = time.perf_counter() - t0
    stable = by_kernel(device_events(sprof))
    s_k4_launches, s_k4_ms = coarse_ms(stable)
    s_all_ms = sum(t for _, t in stable.values())

    result = dict(
        device=smi, setup_s=setup_s, first_solve_s=first.solve_time,
        warm_solve_s=warm.solve_time, warm_solve_unprofiled_s=warm2.solve_time,
        iterations=[first.iterations, warm.iterations, warm2.iterations],
        warm_window_ms=wall_ms, warm_busy_ms=busy, warm_busy_share=busy / wall_ms,
        warm_kernel_ms=sum(t for _, t in table.values()),
        warm_k4_launches=k4_launches, warm_k4_ms=k4_ms, warm_wilson=wilson_ms(table),
        warm_top=[(name, c, t) for name, (c, t) in list(table.items())[:15]],
        coarse_apply_calls=len(calls), coarse_apply_host_us=host_us,
        setup_profiled_s=setup_prof_s, setup_k4_launches=s_k4_launches, setup_k4_ms=s_k4_ms,
        setup_kernel_ms=s_all_ms, setup_wilson=wilson_ms(stable),
        setup_top=[(name, c, t) for name, (c, t) in list(stable.items())[:15]])
    print(f"setup {setup_s:.3f} s; first solve {first.solve_time:.3f} s; warm solve "
          f"{warm.solve_time:.3f} s profiled, {warm2.solve_time:.3f} s not; iterations "
          f"{result['iterations']}")
    print(f"warm solve: window {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f} %), kernels {result['warm_kernel_ms']:.1f} ms, K4 "
          f"{k4_ms:.1f} ms in {k4_launches} launches "
          f"({1e3 * k4_ms / max(k4_launches, 1):.1f} us each)")
    print(f"coarse_apply: {len(calls)} calls, {host_us:.1f} us host time each")
    for title in ("warm", "setup"):
        print(f"{title}: " + ", ".join(f"{k} {n} launches {ms:.2f} ms ({1e3 * ms / max(n, 1):.1f} us each)"
                                      for k, (n, ms) in result[f"{title}_wilson"].items()))
    print(f"setup under the profiler {setup_prof_s:.3f} s: kernels {s_all_ms:.1f} ms, K4 "
          f"{s_k4_ms:.1f} ms in {s_k4_launches} launches, rest of the wall time "
          f"{1e3 * setup_prof_s - s_k4_ms:.1f} ms")
    for title, top in (("warm solve", result["warm_top"]), ("setup", result["setup_top"])):
        print(f"top kernels, {title}:")
        for name, c, t in top:
            print(f"  {t:9.2f} ms {c:7d}  {name[:110]}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
