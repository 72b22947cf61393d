"""The one traffic generator.  A traffic mix is a JSON file of parameters
under gpubench/traffic/ (found by the name a cell gives):

    batch            right-hand sides a request (one solve_multi call)
    support          where a right-hand side is non-zero: "lattice" (every
                     site), "timeslice" (every site of one time slice, the
                     first lattice axis) or "site" (one site); a time slice
                     or a site is drawn a request
    entries          what it holds there: "z4", every spin-colour entry
                     drawn from (+-1 +-i)/sqrt 2; "unit", right-hand side l
                     the unit vector of spin-colour l mod 12 (spin l // 3,
                     colour l % 3) at every site of the support
    trace_requests   requests profiled at the start of a --trace 1 window
    check_share      share of the window's requests whose solutions the
                     reference checks, drawn from the seed (1: every one; the
                     first request always)

So a Z4 noise source is ("lattice", "z4"), a propagator's 12 point sources
("site", "unit") with batch 12, and a wall source ("timeslice", "unit").
Request i of seed s is drawn by numpy from its own generator, seeded from
(s, i), so the reference draws it again after the window; the warm-up
request is drawn from (s, WARM_UP), which no window reaches.  A closed loop with one client
sends request i + 1 when request i has returned.  Imports numpy only.
"""

from __future__ import annotations

import math

import numpy as np

SUPPORTS = ("lattice", "timeslice", "site")
ENTRIES = ("z4", "unit")
WARM_UP = 2**32 - 1          # the warm-up request's index
_CHECK_STREAM = 1            # the stream of the per-request check draws


def _seed(seed: int, i: int, stream: int = 0) -> int:
    return int(np.random.SeedSequence([seed % 2**64, i, stream]).generate_state(1, np.uint64)[0])


def _z4_table() -> np.ndarray:
    """[256, 8]: the four (re, im) pairs that a byte's four 2-bit fields pick
    of (+-1 +-i)/sqrt 2."""
    h = math.sqrt(0.5)
    q = np.array([[h, h], [-h, h], [-h, -h], [h, -h]])
    return np.stack([q[(np.arange(256) >> (2 * j)) & 3] for j in range(4)], 1).reshape(256, 8)


class Traffic:
    def __init__(self, params: dict, lattice):
        self.support, self.entries = params["support"], params["entries"]
        if self.support not in SUPPORTS or self.entries not in ENTRIES:
            raise ValueError(f"support {self.support!r} / entries {self.entries!r}: one of "
                             f"{SUPPORTS} / {ENTRIES}")
        self.batch = int(params["batch"])
        self.trace_requests = int(params["trace_requests"])
        self.check_share = float(params["check_share"])
        self.lattice = tuple(lattice)
        self._table = _z4_table()
        self._buf = None
        self._span = None

    def _sites(self, rng) -> tuple:
        """[lo, hi): the support's sites in the flat site order (the first
        lattice axis slowest)."""
        V = math.prod(self.lattice)
        if self.support == "lattice":
            return 0, V
        if self.support == "timeslice":
            n = V // self.lattice[0]
            t = int(rng.integers(self.lattice[0]))
            return t * n, (t + 1) * n
        s = int(rng.integers(V))
        return s, s + 1

    def request(self, seed: int, i: int, reuse: bool = False) -> np.ndarray:
        """Request i's right-hand sides, [batch, T, Z, Y, X, 4, 3] complex128
        on the host (what api.Solver.solve_multi takes), drawn with numpy
        alike on every machine.  With reuse the array is this object's
        buffer, overwritten by the next such call."""
        rng = np.random.default_rng(_seed(seed, i))
        V = math.prod(self.lattice)
        lo, hi = self._sites(rng)
        buf = self._buf if reuse and self._buf is not None else None
        if buf is None:
            buf = np.zeros((self.batch, V, 12), np.complex128)
        elif self._span != (lo, hi) and self._span != (0, V):
            buf[:, self._span[0]:self._span[1]] = 0.0      # the previous request's support
        if self.entries == "z4":
            n = self.batch * (hi - lo) * 12
            idx = np.frombuffer(rng.bytes(n // 4), np.uint8)   # a byte picks four entries
            if (lo, hi) == (0, V):
                np.take(self._table, idx, axis=0, out=buf.view(np.float64).reshape(-1, 8),
                        mode="clip")                           # unbuffered, in place
            else:
                vals = np.take(self._table, idx, axis=0).reshape(-1).view(np.complex128)
                buf[:, lo:hi] = vals.reshape(self.batch, hi - lo, 12)
        else:
            lanes = np.arange(self.batch)
            buf[lanes, lo:hi, lanes % 12] = 1.0
        if reuse:
            self._buf, self._span = buf, (lo, hi)
        return buf.reshape(self.batch, *self.lattice, 4, 3)

    def checked(self, seed: int, i: int) -> bool:
        """Whether the reference checks request i's solutions (always the
        first request's)."""
        if i == 0 or self.check_share >= 1.0:
            return True
        u = np.random.default_rng(_seed(seed, i, _CHECK_STREAM)).random()
        return bool(u < self.check_share)
