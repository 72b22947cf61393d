"""Runtime configuration: reference-compatible .ini parser and parameter
validation.

Parses the DDalphaAMG input-file format (reference: read_parameter,
src/init.c:448-531; lg_in :1108-1137; geometry derivation :659-815): lines of
"key: value", '//' comments, decorative '|' banners, per-depth keys
"d<i> <name>:".  Unknown keys are ignored (the reference matches substrings).

Produces a SolverParams dataclass consumable by api.Solver, with the same
defaults as the reference (src/init.c:829-961).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DepthParams:
    global_lattice: Optional[tuple] = None
    local_lattice: Optional[tuple] = None
    block_lattice: Optional[tuple] = None
    preconditioner_cycles: int = 1
    post_smooth_iter: int = 2
    block_iter: int = 4
    test_vectors: int = 20          # reference default 20/28 per level
    setup_iter: int = 4


@dataclasses.dataclass
class SolverParams:
    configuration: Optional[str] = None
    format: int = 0
    right_hand_side: str = "ones"   # ones | first | random | zero
    anti_pbc: bool = True
    # 0 dirichlet (open), 1 periodic, 2 anti-periodic; None = from anti_pbc
    # (reference dd_alpha_amg.h:34, open handling dd_alpha_amg.c:195-233)
    bc: Optional[int] = None
    num_levels: int = 2
    depth: list = dataclasses.field(default_factory=list)
    m0: float = -0.5
    csw: float = 1.0
    tol: float = 1e-10
    restart_length: int = 50        # iterations between restarts
    max_restarts: int = 20
    coarse_tol: float = 5e-2
    coarse_iter: int = 100
    coarse_restart: int = 5
    kcycle: bool = True
    kcycle_tol: float = 1e-1
    kcycle_length: int = 5
    kcycle_restarts: int = 2
    odd_even: bool = True
    method: int = 2                 # -1 CGN, 0 GMRES, 1-3 FGMRES+Schwarz, 4 FGMRES+OE-GMRES, 5 +BiCGstab
    interpolation: int = 2          # 0 off, 2 bootstrap F-cycle
    mixed_precision: int = 1
    # The JAX package's accelerator options (mg/hierarchy.MGConfig); None
    # (not in the ini) is off in the port: the reference semantics of f32
    # coarse blocks, a GCR coarsest solve and MinRes block solves.
    coarse_block_bf16: Optional[bool] = None
    coarsest_direct: Optional[bool] = None
    smoother_direct: Optional[bool] = None
    # floor on the residual reduction requested from ONE inner restart of
    # the mixed-precision outer loop: the reduction an f32 sweep can deliver
    # is floored at ~kappa(D)*eps_f32 by the f32 rounding of the operator
    # itself, and requesting more burns inner iterations with no progress.
    # None = 1e-5 for a complex64 inner solve (the reference's inner
    # threshold) and no floor for a complex128 one (api.Solver._solve_mp).
    inner_tol_clip: Optional[float] = None
    print_mode: int = 1
    randomize_test_vectors: bool = False
    seed: int = 42
    tv_io_single_file: bool = True   # "test vector io from single file"
    tv_io_file_name: Optional[str] = None
    # evaluation / parameter-scan mode (reference src/init.c:914-941)
    evaluation: bool = False
    scan_variable: str = ""
    start_val: float = 0.0
    end_val: float = 0.0
    step_size: float = 1.0
    multiplicative: bool = False
    scan_shift_update: bool = True
    scan_re_setup: bool = True
    track_error: bool = False
    track_cgn_error: bool = False
    average_over: int = 1

    def validate(self):
        """Divisibility / consistency checks (reference validate_parameters,
        src/init.c:964-1046)."""
        if self.num_levels < 1:
            raise ValueError(f"number of levels must be >= 1, got {self.num_levels}")
        self._derive_geometry()
        for i in range(self.num_levels - 1):
            d, dn = self.depth[i], self.depth[i + 1]
            for mu in range(4):
                if d.global_lattice[mu] % dn.global_lattice[mu] != 0:
                    raise ValueError(
                        f"depth {i}: lattice {d.global_lattice} not coarsenable "
                        f"to {dn.global_lattice} in dim {mu}")
                if d.global_lattice[mu] % d.block_lattice[mu] != 0:
                    raise ValueError(f"depth {i}: block does not divide lattice")
        return self

    def _derive_geometry(self):
        """Fill in missing coarse lattices/blocks (aggregates default to the
        Schwarz block size, reference src/init.c:700-780)."""
        while len(self.depth) < self.num_levels:
            self.depth.append(DepthParams())
        d0 = self.depth[0]
        if d0.global_lattice is None:
            raise ValueError("d0 global lattice is required")
        if d0.block_lattice is None:
            d0.block_lattice = tuple(2 if e % 2 == 0 else 1 for e in d0.global_lattice)
        for i in range(1, self.num_levels):
            prev, cur = self.depth[i - 1], self.depth[i]
            if cur.global_lattice is None:
                cur.global_lattice = tuple(
                    prev.global_lattice[mu] // prev.block_lattice[mu] for mu in range(4))
            if cur.block_lattice is None:
                cur.block_lattice = tuple(
                    2 if (e % 2 == 0 and e > 1) else 1 for e in cur.global_lattice)


_BOOL_KEYS = {
    "antiperiodic boundary conditions": "anti_pbc",
    "odd even preconditioning": "odd_even",
    "kcycle": "kcycle",
    "randomize test vectors": "randomize_test_vectors",
    "test vector io from single file": "tv_io_single_file",
    "evaluation": "evaluation",
    "multiplicative": "multiplicative",
    "shift update": "scan_shift_update",
    "setup update": "scan_re_setup",
    "track error": "track_error",
    "compare with CGN error": "track_cgn_error",
    "coarse block bf16": "coarse_block_bf16",
    "coarsest direct": "coarsest_direct",
    "smoother direct": "smoother_direct",
}
_INT_KEYS = {
    "format": "format",
    "number of levels": "num_levels",
    "iterations between restarts": "restart_length",
    "maximum of restarts": "max_restarts",
    "coarse grid iterations": "coarse_iter",
    "coarse grid restarts": "coarse_restart",
    "kcycle length": "kcycle_length",
    "kcycle restarts": "kcycle_restarts",
    "method": "method",
    "interpolation": "interpolation",
    "mixed precision": "mixed_precision",
    "print mode": "print_mode",
    "average over": "average_over",
}
_FLOAT_KEYS = {
    "m0": "m0",
    "csw": "csw",
    "tolerance for relative residual": "tol",
    "coarse grid tolerance": "coarse_tol",
    "kcycle tolerance": "kcycle_tol",
    "start value": "start_val",
    "end value": "end_val",
    "step size": "step_size",
}
_RHS = {0: "ones", 1: "first", 2: "random", 3: "zero"}

_DEPTH_KEYS = {
    "global lattice": ("global_lattice", "ints"),
    "local lattice": ("local_lattice", "ints"),
    "block lattice": ("block_lattice", "ints"),
    "preconditioner cycles": ("preconditioner_cycles", "int"),
    "post smooth iter": ("post_smooth_iter", "int"),
    "block iter": ("block_iter", "int"),
    "test vectors": ("test_vectors", "int"),
    "setup iter": ("setup_iter", "int"),
}


def parse_ini(path_or_text: str) -> SolverParams:
    """Parse a reference-format input file (path or raw text)."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()

    p = SolverParams()
    depth_re = re.compile(r"^d(\d+)\s+(.*)$")
    for raw in text.splitlines():
        line = raw.split("//")[0].strip()
        if not line or line.startswith("|") or line.startswith("#") or ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip(), val.strip()
        if not val:
            continue
        m = depth_re.match(key)
        if m:
            i, sub = int(m.group(1)), m.group(2).strip()
            while len(p.depth) <= i:
                p.depth.append(DepthParams())
            if sub in _DEPTH_KEYS:
                attr, kind = _DEPTH_KEYS[sub]
                if kind == "ints":
                    setattr(p.depth[i], attr, tuple(int(x) for x in val.split()))
                else:
                    setattr(p.depth[i], attr, int(val))
            continue
        if key == "configuration":
            p.configuration = val
        elif key == "test vector io file name":
            p.tv_io_file_name = val
        elif key == "scan variable":
            p.scan_variable = val
        elif key == "right hand side":
            p.right_hand_side = _RHS.get(int(val), "ones")
        elif key in _BOOL_KEYS:
            setattr(p, _BOOL_KEYS[key], bool(int(val)))
        elif key in _INT_KEYS:
            setattr(p, _INT_KEYS[key], int(val))
        elif key in _FLOAT_KEYS:
            setattr(p, _FLOAT_KEYS[key], float(val))
        # unknown keys ignored (reference substring parser is permissive)
    return p.validate()


def make_rhs(kind: str, lattice, seed: int = 0) -> np.ndarray:
    """Reference rhs_define (src/top_level.c:24-62)."""
    shape = (*lattice, 4, 3)
    if kind == "ones":
        return np.ones(shape, dtype=np.complex128)
    if kind == "first":
        b = np.zeros(shape, dtype=np.complex128)
        b[0, 0, 0, 0, 0, 0] = 1.0
        return b
    if kind == "random":
        rng = np.random.default_rng(seed)
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) / np.sqrt(2)
    if kind == "zero":
        return np.zeros(shape, dtype=np.complex128)
    raise ValueError(kind)


def resolve_configuration(params: SolverParams, ini_path: str) -> SolverParams:
    """Point a configuration path that does not exist at the file of the same
    name beside the ini file (ini files may carry absolute paths of the
    machine they were written on)."""
    import os
    conf = params.configuration
    if conf and not os.path.exists(conf):
        here = os.path.join(os.path.dirname(os.path.abspath(ini_path)),
                            os.path.basename(conf))
        if os.path.exists(here):
            params.configuration = here
    return params
