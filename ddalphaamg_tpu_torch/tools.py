"""Configuration tools (reference conf/ directory):
  * unit / random gauge-configuration generators
    (conf/random/unit_conf.c:137, conf/random/random_conf.c:137)
  * config splitter for multi-file IO (conf/split/split_conf.c:256)
  * format converters binary <-> LIME/ILDG (lime_io.c analog)
  * DDHMC -> DDalphaAMG converter (conf/convert/DDHMC2DDalphaAMG.c:34)

CLI:  python -m ddalphaamg_tpu_torch.tools <unit|random|split|tolime|tobin|fromddhmc> ...

The fields are the JAX package's tools.py's bit for bit from the same seed
(the same numpy calls in the same order), and so are the files.
rough_su3(..., device="cuda") draws the same numbers with numpy and does the
SU(3) projections and the plaquettes in complex128 on the card (a 32^4
field takes about a minute on a CPU): the field equals the numpy one to
rounding (1e-12).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import io as dio
from . import lime as dlime


def _qr_q(a: torch.Tensor) -> torch.Tensor:
    """The unitary factor of [..., 3, 3] matrices whose R has a positive
    real diagonal: classical Gram-Schmidt of the columns, each projection
    done twice.  numpy's Householder QR (real diagonal of R) with the sign
    fixes of random_su3 and _mix_to_unit gives this same factor.
    torch.linalg.qr gives it too, but is far slower on a card for millions
    of 3 x 3 matrices (scripts/probe_torch_su3.py times both)."""
    cols = []
    for k in range(3):
        v = a[..., :, k]
        for _ in range(2 if cols else 0):
            for q in cols:
                v = v - q * (q.conj() * v).sum(-1, keepdim=True)
        cols.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    return torch.stack(cols, dim=-1)


def random_su3(rng, shape, device=None):
    """Haar-ish random SU(3): QR of a complex Ginibre matrix, phase-fixed
    to det = 1.  With a device the numpy draw is projected there in
    complex128 (a tensor on that device)."""
    a = rng.normal(size=(*shape, 3, 3)) + 1j * rng.normal(size=(*shape, 3, 3))
    if device is not None:
        q = _qr_q(torch.as_tensor(a, device=device))
        return q / (torch.linalg.det(q) ** (1.0 / 3))[..., None, None]
    q, r = np.linalg.qr(a)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]       # Haar measure on U(3)
    det = np.linalg.det(q)                       # a phase
    return q / (det ** (1.0 / 3))[..., None, None]   # project to SU(3)


def _plaquette(U) -> float:
    """Average plaquette normalized to [0,3] (reference calc_plaq,
    src/dirac.c:568), in numpy, or on a tensor's device in complex128."""
    if isinstance(U, torch.Tensor):
        from .gauge import average_plaquette
        return average_plaquette(U)
    total = 0.0
    count = 0
    for mu in range(4):
        for nu in range(mu + 1, 4):
            p = np.einsum("...ab,...bc,...dc,...ed->...ae",
                          U[mu], np.roll(U[nu], -1, axis=mu),
                          np.conj(np.roll(U[mu], -1, axis=nu)),
                          np.conj(U[nu]), optimize=True)
            total += np.einsum("...aa->...", p).real.sum()
            count += U[mu, ..., 0, 0].size
    return total / count


def make_unit_conf(path: str, lattice) -> float:
    U = np.zeros((4, *lattice, 3, 3), dtype=np.complex128)
    U[..., 0, 0] = U[..., 1, 1] = U[..., 2, 2] = 1.0
    dio.write_gauge_field(path, U, plaquette=3.0, anti_periodic=False)
    return 3.0


def _mix_to_unit(U, epsilon: float):
    """SU(3)-project eye + epsilon * (U - eye): a hot/cold interpolation
    between the unit config (epsilon=0) and Haar-random (epsilon=1); a
    tensor on its device in complex128."""
    if isinstance(U, torch.Tensor):
        eye = torch.eye(3, dtype=torch.complex128, device=U.device)
        q = _qr_q(eye + epsilon * (U - eye))
        return q * (torch.linalg.det(q) ** (1.0 / 3.0)).conj()[..., None, None]
    eye = np.eye(3, dtype=np.complex128)
    A = eye + epsilon * (U - eye)
    q, r = np.linalg.qr(A)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * np.conj(d / np.abs(d))[..., None, :]
    det = np.linalg.det(q)
    return q * np.conj(det ** (1.0 / 3.0))[..., None, None]


def make_random_conf(path: str, lattice, seed: int = 0,
                     epsilon: float = 1.0) -> float:
    """Random config; epsilon < 1 interpolates toward the unit config
    (hot/cold mix as in the reference generator)."""
    rng = np.random.default_rng(seed)
    U = random_su3(rng, (4, *lattice))
    if epsilon < 1.0:
        U = _mix_to_unit(U, epsilon)
    plaq = _plaquette(U)
    dio.write_gauge_field(path, U, plaquette=plaq, anti_periodic=False)
    return plaq


def rough_su3(lattice, seed: int = 0, target_plaq: float = 1.7867,
              tol: float = 5e-3, device=None) -> np.ndarray:
    """Random SU(3) field with the average plaquette tuned (by bisection on
    the hot/cold mixing parameter) to `target_plaq` in [0, 3] -- default
    matches the bundled beta = 6.0 reference configurations (computed
    plaquette 1.7866 on both 4^4 and 8^4, conf/4x4x4x4b6.0000id3n1), so
    benchmark solves face reference-roughness gauge disorder instead of a
    flattering near-free field.  Deterministic in (lattice, seed).  With a
    device ("cuda") the projections and plaquettes run there (module
    note); the field is returned as numpy either way."""
    # tune the mixing parameter on a cheap 8^4 proxy field (the plaquette
    # vs epsilon curve is statistically lattice-size independent), then
    # refine with a couple of bisection steps on the target lattice
    proxy_lat = tuple(min(8, e) for e in lattice)
    Up = random_su3(np.random.default_rng(seed + 1), (4, *proxy_lat), device)
    lo, hi = 0.0, 1.0
    eps = 0.5
    for _ in range(18):
        eps = 0.5 * (lo + hi)
        plaq = _plaquette(_mix_to_unit(Up, eps))
        if plaq > target_plaq:
            lo = eps
        else:
            hi = eps
    rng = np.random.default_rng(seed)
    U = random_su3(rng, (4, *lattice), device)
    lo, hi = max(0.0, eps - 0.05), min(1.0, eps + 0.05)
    for _ in range(6):
        eps = 0.5 * (lo + hi)
        plaq = _plaquette(_mix_to_unit(U, eps))
        if abs(plaq - target_plaq) < tol:
            break
        if plaq > target_plaq:
            lo = eps
        else:
            hi = eps
    U = _mix_to_unit(U, eps)
    return U.cpu().numpy() if isinstance(U, torch.Tensor) else U


def make_rough_conf(path: str, lattice, seed: int = 0,
                    target_plaq: float = 1.7867) -> float:
    """Write a plaquette-targeted rough config (see rough_su3)."""
    U = rough_su3(lattice, seed=seed, target_plaq=target_plaq)
    plaq = _plaquette(U)
    dio.write_gauge_field(path, U, plaquette=plaq, anti_periodic=False)
    return plaq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ddalphaamg_tpu_torch configuration tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("unit", help="write a unit gauge configuration")
    p.add_argument("path")
    p.add_argument("lattice", type=int, nargs=4, metavar=("T", "Z", "Y", "X"))

    p = sub.add_parser("random", help="write a random gauge configuration")
    p.add_argument("path")
    p.add_argument("lattice", type=int, nargs=4, metavar=("T", "Z", "Y", "X"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epsilon", type=float, default=1.0)

    p = sub.add_parser("split", help="split a config into per-process files")
    p.add_argument("input")
    p.add_argument("output_prefix")
    p.add_argument("procs", type=int, nargs=4, metavar=("PT", "PZ", "PY", "PX"))

    p = sub.add_parser("tolime", help="convert binary config to LIME/ILDG")
    p.add_argument("input")
    p.add_argument("output")

    p = sub.add_parser("tobin", help="convert LIME/ILDG config to binary")
    p.add_argument("input")
    p.add_argument("output")

    p = sub.add_parser("fromddhmc",
                       help="convert a DDHMC-layout config to DDalphaAMG binary")
    p.add_argument("input")
    p.add_argument("output")

    args = ap.parse_args(argv)
    if args.cmd == "unit":
        plaq = make_unit_conf(args.path, tuple(args.lattice))
        print(f"wrote unit config {args.path}, plaquette {plaq:.13f}")
    elif args.cmd == "random":
        plaq = make_random_conf(args.path, tuple(args.lattice),
                                seed=args.seed, epsilon=args.epsilon)
        print(f"wrote random config {args.path}, plaquette {plaq:.13f}")
    elif args.cmd == "split":
        names = dio.split_gauge_field(args.input, args.output_prefix,
                                      tuple(args.procs))
        print(f"wrote {len(names)} files: {names[0]} ...")
    elif args.cmd == "tolime":
        U, plaq = dio.read_gauge_field(args.input, anti_periodic=False)
        dlime.write_gauge_field(args.output, U, plaq, anti_periodic=False)
        print(f"wrote {args.output} (ILDG), plaquette {plaq:.13f}")
    elif args.cmd == "tobin":
        U, plaq = dlime.read_gauge_field(args.input, anti_periodic=False)
        dio.write_gauge_field(args.output, U, plaq, anti_periodic=False)
        print(f"wrote {args.output} (binary), plaquette {plaq:.13f}")
    elif args.cmd == "fromddhmc":
        U, plaq = dio.read_gauge_field_ddhmc(args.input, anti_periodic=False)
        dio.write_gauge_field(args.output, U, plaq, anti_periodic=False)
        print(f"wrote {args.output} (binary), plaquette {plaq:.13f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
