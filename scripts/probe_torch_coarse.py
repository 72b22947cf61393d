#!/usr/bin/env python
"""Time the port's coarse-stencil kernels (K4, K5 and their bf16-block
instances, csrc/coarse.cu) on one CUDA card, kernel by kernel:

    python3 scripts/probe_torch_coarse.py [--parent DIR] [--out FILE] [--match REGEX]

For every case (the shapes of chip_smoke.py's kernel phase, the batched
applies of the setup, and a batch sweep for the choice between the two
kernels) it checks the launcher's choice against the plain version, then
times with CUDA events (one warm-up, 20 launches, raw ctypes launches on
preallocated outputs, so the host's wrapper work is not in the time):

  auto    the launcher's choice (what the port runs)
  batch1  the one-right-hand-side kernel, forced
  multi   the multi-right-hand-side kernel, forced
  parent  with --parent DIR (a checkout of another commit, e.g. made with
          git archive): that commit's kernels, built from DIR, on the same
          inputs, timed in turns with auto (parent, auto, auto, parent)

and the bound: blocks of the needed (term, site) pairs and the fields once
over 3.35 TB/s, or the flops over 67 (f32) / 34 (f64) TFLOP/s.  Prints one
line per case, the card's name and power limit, and writes all numbers as
JSON to FILE (default build/probe_torch_coarse.json).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the bound model and the timing helper)
from ddalphaamg_tpu_torch import kernels  # noqa: E402
from ddalphaamg_tpu_torch.operators import coarse  # noqa: E402

ODD = 1
REGIME = {"auto": 0, "batch1": 1, "multi": 2}


def load_parent(path):
    """The kernel library of another checkout, built from its own sources."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(path, "ddalphaamg_tpu_torch", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.lib()


def cases():
    """(label, lattice, batch, terms, mask, parity, mesh dims or None, kinds)."""
    out = []
    main = [("full", (0, 9), None, None), ("hop", (1, 9), None, None),
            ("block masked", (0, 9), (2, 2, 2, 2), None),
            ("hop_intra masked", (1, 9), (2, 2, 2, 2), None),
            ("self", (0, 1), None, None), ("self_inv odd", (0, 1), None, ODD)]
    for L in (8, 4):                                   # chip_smoke.py phase 3
        for batch in (1, 28):
            for name, terms, mask, parity in main:
                out.append((f"{name} {L}^4", (L,) * 4, batch, terms, mask, parity, None,
                            ("f32", "bf16")))
    for name, terms, mask in (("block masked", (0, 9), (2, 2, 2, 2)), ("full", (0, 9), None)):
        out.append((f"{name} 16^4 (rough32's depth 1)", (16,) * 4, 1, terms, mask, None, None,
                    ("bf16",)))
    for dims, loc in (((1, 2, 1, 1), (8, 4, 8, 8)), ((2, 2, 1, 1), (4, 4, 8, 8)),
                      ((1, 1, 2, 2), (8, 8, 4, 4)), ((2, 2, 2, 2), (4, 4, 4, 4))):
        for batch in (1, 28):
            for name, terms in (("full", (0, 9)), ("hop", (1, 9))):
                out.append((f"K5 {name} slab {loc}", loc, batch, terms, None, None, dims,
                            ("f32", "bf16")))
    for name, terms, parity in (("full", (0, 9), None), ("hop", (1, 9), None),
                                ("self_inv odd", (0, 1), ODD)):   # Schur columns
        out.append((f"{name} 4^4 (Schur columns)", (4,) * 4, 256, terms, None, parity, None,
                    ("f32",)))
    for batch, what in ((56, "Galerkin"), (128, "block-inverse columns")):
        out.append((f"block masked 8^4 ({what})", (8,) * 4, batch, (0, 9), (2, 2, 2, 2), None,
                    None, ("f32",)))
    for L in (8, 4):                                   # the batch sweep
        for batch in (2, 3, 4, 6, 8):
            out.append((f"full {L}^4 (sweep)", (L,) * 4, batch, (0, 9), None, None, None,
                        ("f32", "bf16")))
    out.append(("full 8^4 f64", (8,) * 4, 1, (0, 9), None, None, None, ("f64",)))
    out.append(("full 8^4 f64", (8,) * 4, 28, (0, 9), None, None, None, ("f64",)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of another commit to time against")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "probe_torch_coarse.json"))
    ap.add_argument("--match", default="", help="only the cases whose label matches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the probe times kernels on a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = kernels.lib()
    parent = load_parent(args.parent) if args.parent else None
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    stream = kernels.stream_ptr(dev)
    d = 56
    rows, failed = [], []
    blocks_cache = {}
    from ddalphaamg_tpu_torch.parallel.comm import face
    from ddalphaamg_tpu_torch.parallel.mesh import SolverMesh, active_axes, shard_field

    for label, lat, batch, terms, mask, parity, dims, kinds in cases():
        if not re.search(args.match, label):
            continue
        V = math.prod(lat)
        for kind in kinds:
            dtype = torch.complex128 if kind == "f64" else torch.complex64
            key = (lat, kind)
            if key not in blocks_cache:
                blocks_cache.clear()
                Pk = torch.randn((9, d, d, V), generator=gen, dtype=dtype, device=dev)
                blocks_cache[key] = coarse.compress(Pk) if kind == "bf16" else Pk
            blocks = blocks_cache[key]
            halos, faces = None, []
            if dims is None:
                v = torch.randn((batch, d, V), generator=gen, dtype=dtype, device=dev)
                mb = tuple(mask) if mask else (0, 0, 0, 0)
                par = -1 if parity is None else parity
                new = getattr(lib, f"ddaamg_coarse_{kind}")
                old = getattr(parent, f"ddaamg_coarse_{kind}") if parent else None

                def args_of(out, r, v=v, blocks=blocks, mb=mb, par=par):
                    return (out.data_ptr(), v.data_ptr(), blocks.data_ptr(), d, *terms, *lat, *mb,
                            par, 0, batch)

                plain = lambda: coarse.coarse_apply_plain(blocks, v, lat, terms, mask, parity)
            else:
                mesh = SolverMesh(dims, 0)
                glat = tuple(n * m for n, m in zip(lat, dims))
                vg = torch.randn((batch, d, math.prod(glat)), generator=gen, dtype=dtype, device=dev)
                v = shard_field(mesh, vg, glat)
                halos = {}
                for mu in active_axes(mesh, glat):
                    fwd = shard_field(mesh, coarse.neighbor(vg, 1 + mu, glat), glat)
                    bwd = shard_field(mesh, coarse.neighbor(vg, 5 + mu, glat), glat)
                    halos[mu] = (face(fwd, lat, mu, lat[mu] - 1).contiguous(),
                                 face(bwd, lat, mu, 0).contiguous())
                faces = [f for pair in halos.values() for f in pair]
                ptrs = []      # (fwd, bwd) of t, z, y, x
                for mu in range(4):
                    ptrs += [f.data_ptr() for f in halos[mu]] if mu in halos else [None, None]
                new = getattr(lib, f"ddaamg_coarse_halo_{kind}")
                # a parent whose K5 takes t and z faces only (four pointers)
                old = (getattr(parent, f"ddaamg_coarse_halo_{kind}")
                       if parent and set(halos) <= {0, 1} else None)
                before = old is not None and len(old.argtypes) == 17

                def args_of(out, r, v=v, blocks=blocks, ptrs=ptrs, before=before):
                    faces_ = ptrs[:4] if r == "parent" and before else ptrs
                    return (out.data_ptr(), v.data_ptr(), blocks.data_ptr(), *faces_, d, *terms,
                            *lat, batch)

                plain = lambda: coarse.coarse_apply_halo_plain(blocks, v, lat, halos, terms)
            outs = {r: torch.empty_like(v) for r in ("auto", "batch1", "multi", "parent")}

            def launch(r):
                if r == "parent":     # a parent with two kernels takes a regime too
                    a = args_of(outs[r], r)
                    regime = (0,) if len(old.argtypes) == len(a) + 2 else ()
                    rc = old(*a, *regime, stream)
                else:
                    rc = new(*args_of(outs[r], r), REGIME[r], stream)
                kernels.check(rc, f"{label} {r}")
                return outs[r]

            want = plain()
            rel = {}
            for r in (["auto", "batch1", "multi"] + (["parent"] if old is not None else [])):
                got = launch(r)
                torch.cuda.synchronize()
                rel[r] = float((got - want).abs().max() / want.abs().max())
            ms = {}
            if old is not None:
                p1 = chip_smoke.cuda_ms(lambda: launch("parent"), reps=20)
                a1 = chip_smoke.cuda_ms(lambda: launch("auto"), reps=20)
                a2 = chip_smoke.cuda_ms(lambda: launch("auto"), reps=20)
                p2 = chip_smoke.cuda_ms(lambda: launch("parent"), reps=20)
                ms["parent"], ms["auto"] = [p1, p2], [a1, a2]
            else:
                ms["auto"] = [chip_smoke.cuda_ms(lambda: launch("auto"), reps=20)]
            for r in ("batch1", "multi"):
                ms[r] = [chip_smoke.cuda_ms(lambda r=r: launch(r), reps=20)]
            work = chip_smoke.coarse_work(blocks, v, lat, terms, mask, parity, faces=faces)
            fdt = torch.complex64 if kind != "f64" else torch.complex128
            bound = 1e3 * max(work[0] / chip_smoke.MEM_BYTES_PER_S,
                              work[1] / chip_smoke.PEAK_FLOPS[fdt])
            row = dict(case=label, kind=kind, lattice=lat, batch=batch, d=d, rel_err=rel, ms=ms,
                       bound_ms=bound)
            rows.append(row)
            mean = {r: sum(t) / len(t) for r, t in ms.items()}
            print(f"{label:36s} {kind:4s} batch {batch:3d}  auto {mean['auto']:8.4f}  "
                  f"batch1 {mean['batch1']:8.4f}  multi {mean['multi']:8.4f}  "
                  + (f"parent {mean['parent']:8.4f} ({ms['parent'][0]:.4f}/{ms['parent'][1]:.4f}, "
                     f"auto {ms['auto'][0]:.4f}/{ms['auto'][1]:.4f})  " if old is not None else "")
                  + f"bound {bound:7.4f} ({100 * bound / mean['auto']:5.1f} %)  "
                  f"rel {max(rel.values()):.1e}", flush=True)
            tol = chip_smoke.TOL[fdt]
            bad = {r: e for r, e in rel.items() if e > tol}
            if bad:
                failed.append(f"{label} {kind} batch {batch}: relative errors {bad} above {tol}")
                print(f"FAIL {failed[-1]}", flush=True)
            del v, outs
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, rows=rows, failed=failed), f, indent=1)
    print(smi)
    if failed:
        sys.exit(f"{len(failed)} cases disagree with the plain version")


if __name__ == "__main__":
    main()
