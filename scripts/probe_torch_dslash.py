#!/usr/bin/env python
"""Time the port's Wilson-clover kernels (K1 full D, K2 hopping term, K3
clover and clover inverse; csrc/dslash.cu) on one CUDA card:

    python3 scripts/probe_torch_dslash.py [--parent DIR] [--out FILE]

Every shape the rough16 path runs, on the rough16 gauge field (16^4):

  K1   f32 batch 1 (block_op), 28 (test-vector smoothing), 56 (Galerkin
       build); f64 batch 1 (the outer residual)
  K2   block links, parity-restricted (the SAP's block odd-even solve) at
       batch 1 and 28 and all sites at batch 1; face links of one direction
       at batch 56 (the Galerkin build); the full links on the even and on
       the odd sites at batch 1 (method 4's D_eo / D_oe)
  K3   the clover at batch 1 and 28, and on the even sites at batch 1
       (method 4's A_ee); the clover inverse on the odd sites
       from its compact odd-site storage at batch 1 and 28, and on a
       (16, 8, 16, 16) slab whose global offset is odd (parity_offset 1)

Each case is checked against its plain version, then timed with CUDA
events on raw ctypes launches on a preallocated output, so the wrappers'
host work is not in the time: one warm-up, then 20 launches captured in a
CUDA graph and replayed between the two events (device time: no host work
between the launches; the fields of a batch-1 case fit in the 50 MB L2 and
stay there), the same with a 64 MiB write before each launch less the
write alone ("cold": the inputs come from DRAM), and the same 20 launches
made one by one from Python ("events": at batch 1 the host's launch rate
bounds it).  --parent
DIR (a checkout of another commit, e.g. the parent unpacked by git archive
under build/) times that commit's kernels on the same inputs in turns
(parent, this, this, parent).  A library whose entry points predate the parity and
compact-storage arguments runs the form its own path ran: K2 on all sites,
K3 on the full-storage inverse with a parity.  Each line also gives the
bound (chip_smoke.dslash_work: each input once and the output over 3.35
TB/s, or the flops over the f32 / f64 peak) and the time of one PyTorch
call for the same function (chip_smoke.dslash_library / clover_library).
Prints one line per case and the card's name and power limit, and writes
all numbers as JSON to FILE (default build/probe_torch_dslash.json).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(os.path.abspath(__file__))]

import chip_smoke  # noqa: E402  (the bound model, the library calls, timing)
from probe_torch_coarse import load_parent  # noqa: E402
from ddalphaamg_tpu_torch import kernels  # noqa: E402
from ddalphaamg_tpu_torch.operators import fast  # noqa: E402

EVEN, ODD = 0, 1
SUFFIX = {torch.complex64: "f32", torch.complex128: "f64"}


def takes_parity(fn) -> bool:
    """Whether a library's entry point has the parity arguments (the
    parent's K1 / K2 take 12 arguments, K3 12; these take 14 and 13)."""
    return len(fn.argtypes) > 12


def launch_dslash(lib, out, phi, links, clover, lat, parity, offset):
    fn = getattr(lib, f"ddaamg_dslash_{SUFFIX[phi.dtype]}")
    batch = phi.numel() // (12 * math.prod(lat))
    args = [out.data_ptr(), phi.data_ptr(), links.data_ptr(),
            clover[0].data_ptr() if clover else None, clover[1].data_ptr() if clover else None,
            *lat, batch, int(clover is not None)]
    if takes_parity(fn):
        args += [-1 if parity is None else parity, offset]
    return fn(*args, kernels.stream_ptr(phi.device))


def launch_clover(lib, out, phi, compact, full, lat, parity, offset):
    """K3 from the compact odd-site storage where the library takes it,
    else from the full storage."""
    fn = getattr(lib, f"ddaamg_clover_{SUFFIX[phi.dtype]}")
    batch = phi.numel() // (12 * math.prod(lat))
    par = -1 if parity is None else parity
    if takes_parity(fn):
        cd, co = compact if compact is not None else full
        args = [cd.data_ptr(), co.data_ptr(), *lat, batch, par, offset, int(compact is not None)]
    else:
        args = [full[0].data_ptr(), full[1].data_ptr(), *lat, batch, par, offset]
    return fn(out.data_ptr(), phi.data_ptr(), *args, kernels.stream_ptr(phi.device))


def graph_ms(fn, reps=20):
    """Device time of fn per call: one warm-up, then reps calls captured in
    a CUDA graph, replayed once more and timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stencils():
    """The rough16 fine stencil in f32 and f64 (as chip_smoke.py builds it)
    and the packed clover inverse of every site in f32."""
    from ddalphaamg_tpu_torch import io
    from ddalphaamg_tpu_torch.geometry import Geometry
    from ddalphaamg_tpu_torch.operators import cuda_dslash
    from ddalphaamg_tpu_torch.operators.stencil import WilsonStencilSoA, herm_inv
    from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator

    params = chip_smoke.rough16_params()
    U, _ = io.read_gauge_field(params.configuration)
    lat = tuple(U.shape[1:5])
    op = WilsonOperator.from_gauge(torch.as_tensor(U, device="cuda"), params.m0, params.csw)
    geom = Geometry(lattice=lat, block=(2, 2, 2, 2))
    cd, co = cuda_dslash.pack_clover(fast.clover_to_soa(herm_inv(op.clover)))
    return (lat, {dt: WilsonStencilSoA.build(op, geom, dtype=dt) for dt in SUFFIX},
            (cd.to(torch.float32), co.to(torch.complex64)))


def cases(lat, st, inv, gen):
    """Yields (label, key, phi, lattice, dict of the case's operands)."""
    dev = torch.device("cuda")
    f32, f64 = st[torch.complex64], st[torch.complex128]

    def phi(B, dtype=torch.complex64, lattice=lat):
        return torch.randn((B, 12, math.prod(lattice)), generator=gen, dtype=dtype, device=dev)

    for B in (1, 28, 56):
        yield f"K1 full f32 batch {B}", "K1", phi(B), lat, dict(s=f32, clover=True)
    yield "K1 full f64 batch 1", "K1", phi(1, torch.complex128), lat, dict(s=f64, clover=True)
    for B in (1, 28):
        yield (f"K2 block links, odd sites, batch {B}", "K2", phi(B), lat,
               dict(s=f32, links=f32.links_intra, parity=ODD))
    yield ("K2 block links, even sites, batch 1", "K2", phi(1), lat,
           dict(s=f32, links=f32.links_intra, parity=EVEN))
    yield ("K2 block links, all sites, batch 1", "K2", phi(1), lat,
           dict(s=f32, links=f32.links_intra))
    yield ("K2 face links (t), all sites, batch 56", "K2", phi(56), lat,
           dict(s=f32, links=chip_smoke.galerkin_face_links(f32, 0)))
    for parity, sites in ((EVEN, "even"), (ODD, "odd")):
        yield (f"K2 full links, {sites} sites, batch 1", "K2", phi(1), lat,
               dict(s=f32, links=f32.links, parity=parity))
    for B in (1, 28):
        yield f"K3 clover batch {B}", "K3", phi(B), lat, dict(s=f32, clover=True)
    yield ("K3 clover, even sites, batch 1", "K3", phi(1), lat,
           dict(full=(f32.cdiag, f32.coff), parity=EVEN, compact=False))
    for B in (1, 28):
        yield (f"K3 inverse, odd sites (compact), batch {B}", "K3", phi(B), lat,
               dict(full=inv, parity=ODD))
    slab = (lat[0], lat[1] // 2, lat[2], lat[3])
    Vs = math.prod(slab)
    cd = torch.rand((2, 6, Vs), generator=gen, dtype=torch.float32, device=dev) + 1
    co = torch.randn((2, 15, Vs), generator=gen, dtype=torch.complex64, device=dev)
    yield (f"K3 inverse, odd sites (compact), slab {slab} offset 1, batch 1", "K3",
           phi(1, lattice=slab), slab, dict(full=(cd, co), parity=ODD, offset=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of another commit to time against")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "probe_torch_dslash.json"))
    ap.add_argument("--match", default="", help="only the cases whose label matches this regex")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the probe times kernels on a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from ddalphaamg_tpu_torch import utils

    utils.pin_full_precision()
    lib = kernels.lib()
    parent = load_parent(args.parent) if args.parent else None
    gen = torch.Generator(device="cuda").manual_seed(2468)
    lat, st, inv = stencils()
    rows, failed = [], []
    flush = torch.empty(2**24, dtype=torch.float32, device="cuda")   # 64 MiB > the 50 MB L2
    for label, key, phi, clat, c in cases(lat, st, inv, gen):
        if not re.search(args.match, label):
            continue
        parity, offset = c.get("parity"), c.get("offset", 0)
        dtype = phi.dtype
        mask = (fast.parity_mask(clat, parity, phi.real.dtype, phi.device, offset)
                if parity is not None else None)
        if key == "K3":
            full = c["full"] if "full" in c else (c["s"].cdiag, c["s"].coff)
            compact = None
            if parity is not None and c.get("compact", True):
                compact = tuple(fast.compact_parity(t, clat, parity, offset) for t in full)

            def run(library, out, phi=phi, compact=compact, full=full, clat=clat):
                return launch_clover(library, out, phi, compact, full, clat, parity, offset)

            plain = lambda phi=phi, full=full, clat=clat: fast.clover_apply_soa(  # noqa: E731
                *full, phi, clat, parity, offset)
            work = chip_smoke.dslash_work("K3", phi, clover=full, parity=parity)
            library = chip_smoke.clover_library(*full, phi, clat, parity, offset)
        else:
            s = c["s"]
            links = c.get("links", s.links)
            clover = (s.cdiag, s.coff) if c.get("clover") else None

            def run(library, out, phi=phi, links=links, clover=clover):
                return launch_dslash(library, out, phi, links, clover, lat, parity, offset)

            if clover is not None:
                plain = lambda phi=phi, links=links: fast.d_plus_clover_soa(  # noqa: E731
                    links, s.cdiag, s.coff, phi, lat)
            else:
                plain = lambda phi=phi, links=links: fast.dslash_hopping_soa(  # noqa: E731
                    links, phi, lat, parity)
            work = chip_smoke.dslash_work(key, phi, links, clover, parity)
            library = chip_smoke.dslash_library(links, phi, lat, clover, parity)
        outs = {r: torch.empty_like(phi) for r in ("this", "parent")}

        def launch(r, run=run, outs=outs):
            kernels.check(run(parent if r == "parent" else lib, outs[r]), f"{label} {r}")
            return outs[r]

        want = plain()
        rel = {}
        entry = f"ddaamg_{'clover' if key == 'K3' else 'dslash'}_{SUFFIX[dtype]}"
        for r in ["this"] + (["parent"] if parent else []):
            got = launch(r)
            torch.cuda.synchronize()
            if mask is not None and not takes_parity(getattr(parent if r == "parent" else lib, entry)):
                got = got * mask          # a library without parity computed every site
            rel[r] = float((got - want).abs().max() / want.abs().max())
        lib_rel = float((library().reshape(want.shape) - want).abs().max() / want.abs().max())
        ms = {}
        for r in ["parent", "this", "this", "parent"] if parent else ["this"]:
            ms.setdefault(r, []).append(graph_ms(lambda r=r: launch(r)))
        events = {r: chip_smoke.cuda_ms(lambda r=r: launch(r), reps=20) for r in ms}
        flush_ms = graph_ms(flush.zero_)
        cold = {r: graph_ms(lambda r=r: (flush.zero_(), launch(r))) - flush_ms for r in ms}
        lib_ms = chip_smoke.cuda_ms(library, reps=5)
        by_bytes, by_ops = work[0] / chip_smoke.MEM_BYTES_PER_S, work[1] / chip_smoke.PEAK_FLOPS[dtype]
        bound = 1e3 * max(by_bytes, by_ops)
        mean = {r: sum(t) / len(t) for r, t in ms.items()}
        rows.append(dict(case=label, kernel=key, dtype=SUFFIX[dtype], lattice=clat,
                         batch=phi.shape[0], rel_err=rel, library_rel_err=lib_rel, ms=ms,
                         events_ms=events, cold_ms=cold, library_ms=lib_ms, bound_ms=bound,
                         bound_by="bytes" if by_bytes >= by_ops else "operations"))
        print(f"{label:58s} this {mean['this']:8.4f} ({ms['this'][0]:.4f}/{ms['this'][-1]:.4f}, "
              f"cold {cold['this']:.4f}, events {events['this']:.4f})  "
              + (f"parent {mean['parent']:8.4f} ({ms['parent'][0]:.4f}/{ms['parent'][-1]:.4f}, "
                 f"cold {cold['parent']:.4f}, events {events['parent']:.4f})  " if parent else "")
              + f"library {lib_ms:8.4f}  bound {bound:7.4f} ({100 * bound / mean['this']:5.1f} %)  "
              f"rel {max(rel.values()):.1e}", flush=True)
        tol = chip_smoke.TOL[dtype]
        bad = {r: e for r, e in rel.items() if e > tol}
        if lib_rel > tol:
            bad["library"] = lib_rel
        if bad:
            failed.append(f"{label}: relative errors {bad} above {tol}")
            print(f"FAIL {failed[-1]}", flush=True)
        del phi, outs
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, rows=rows, failed=failed), f, indent=1)
    print(smi)
    if failed:
        sys.exit(f"{len(failed)} cases disagree with the plain version")


if __name__ == "__main__":
    main()
