"""The wrappers of K8 (csrc/peer.cu): a process grid's collectives as
kernels over peer pointers, which a CUDA graph's loop body can hold, where
it cannot hold NCCL's (csrc/peer.cu says why).  On a grid over nccl (a
card per rank) every exchange, all-reduce, gather and broadcast goes
through them (parallel/comm.py), in the host loops and in the device
programs alike, so a replay gives the host loops' bits; NCCL itself only
shares the arenas' IPC handles and meets the ranks at barriers.  A message
larger than its buffer moves as successive calls of at most the buffer
each (the Galerkin builds' shifts and gathers at their lane chunks).

Peers(mesh) allocates this rank's arena on its card (ddaamg_peer_alloc),
shares its CUDA IPC handle through the process group once (every rank
calls it together, at the grid's setup: parallel/launch.warm_up) and opens
every other rank's arena.  The arena holds, in this order: the flag words
(8 exchange mailboxes, their 8 acknowledgement rows, then the
all-reduce's and the gather's, one per rank, each [ROW] words), the 8
mailboxes (2 x MAILBOX bytes each: 2 mu + 0 receives the +mu neighbor's
face, 2 mu + 1 the -mu neighbor's), the all-reduce's slots (one per rank,
2 x REDUCE bytes) and the gather's (one per rank, 2 x GATHER bytes).  The
acknowledgement row of mailbox k in a rank's arena is written by the rank
it sends that mailbox to.  The call counters live in a tensor of the
rank's own.

Every kernel launch counts one launch of K8 (kernels.launched; recorded
while a graph is captured), on the current stream.  The plain versions
(exchange_plain, allreduce_plain, allgather_plain) state what the kernels
compute from every rank's inputs: the copies of the sent faces, the sum in
rank order and the stack in rank order; chip_smoke.py holds the kernels
against them on one card with the ranks of one process
(Peers.local_group).
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from .. import kernels

ROW = 64                    # thread blocks of every call (csrc/peer.cu's ROW)
MAILBOX = 8 << 20           # bytes of one exchange mailbox buffer
REDUCE = 1 << 20            # bytes of one rank's all-reduce buffer
GATHER = 8 << 20            # bytes of one rank's gather buffer
_ALIGN = 4096
_ACK = 8                    # flag rows: 8 mailboxes, 8 acknowledgements, all-reduce, gather


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def _bytes(t):
    """The bytes of a contiguous tensor, flat."""
    return t.reshape(-1).view(torch.uint8)


class Peers:
    """One rank's side of K8 (module note): its arena, the other ranks'
    arenas opened through IPC (or, for Peers.local_group, in this process),
    and its call counters."""

    def __init__(self, mesh, device, bases=None, own=None):
        self.mesh, self.device = mesh, torch.device(device)
        P = self.ranks = mesh.size
        self.rank = mesh.rank
        u64 = 8
        self.flag_bytes = -(-(2 * _ACK + 2 * P) * ROW * u64 // _ALIGN) * _ALIGN
        self.ex_off = self.flag_bytes
        self.ar_off = self.ex_off + 8 * 2 * MAILBOX
        self.ag_off = self.ar_off + P * 2 * REDUCE
        self.bytes = self.ag_off + P * 2 * GATHER
        # counters: exchange posts [8][ROW], finishes [8][ROW], all-reduce, gather
        self.counts = torch.zeros((18, ROW), dtype=torch.long, device=self.device)
        self._opened = []
        if bases is not None:               # local_group: arenas of this process
            self.base, self.bases = own, bases
            return
        lib = kernels.lib()
        if lib.ddaamg_peer_row() != ROW:
            raise RuntimeError("csrc/peer.cu's ROW and parallel/peer.py's ROW differ")
        base = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.ddaamg_peer_handle_bytes())
        with torch.cuda.device(self.device):
            kernels.check(lib.ddaamg_peer_alloc(self.bytes, ctypes.byref(base), handle),
                          "peer arena")
        self.base = base.value
        handles = [None] * P
        dist.all_gather_object(handles, bytes(handle.raw))
        self.bases = []
        for p in range(P):
            if p == self.rank:
                self.bases.append(self.base)
                continue
            ptr = ctypes.c_void_p()
            with torch.cuda.device(self.device):
                kernels.check(lib.ddaamg_peer_open(ctypes.create_string_buffer(handles[p],
                                                                              len(handles[p])),
                                                   ctypes.byref(ptr)), "peer open")
            self._opened.append(ptr.value)
            self.bases.append(ptr.value)
        torch.cuda.synchronize(self.device)
        dist.barrier()

    @classmethod
    def local_group(cls, dims, device):
        """The ranks of a grid dims as Peers of this one process on one card
        (chip_smoke.py's check of K8): arenas allocated here, no IPC."""
        from .mesh import SolverMesh

        lib = kernels.lib()
        first = cls(SolverMesh(dims, 0), device, bases=[], own=None)
        arenas = []
        for _ in range(first.ranks):
            ptr = ctypes.c_void_p()
            handle = ctypes.create_string_buffer(lib.ddaamg_peer_handle_bytes())
            kernels.check(lib.ddaamg_peer_alloc(first.bytes, ctypes.byref(ptr), handle),
                          "peer arena")
            arenas.append(ptr.value)
        group = [cls(SolverMesh(dims, r), device, bases=arenas, own=arenas[r])
                 for r in range(first.ranks)]
        for g in group:         # close() of the first frees every arena
            g._local = ()
        group[0]._local = arenas
        return group

    # -- addresses ----------------------------------------------------------

    def _flag(self, base, index: int) -> int:
        """Address of flag word row `index` (8 mailboxes, their 8
        acknowledgements, then the all-reduce's ranks, then the gather's)
        of an arena."""
        return base + index * ROW * 8

    # -- the exchange -------------------------------------------------------

    def post(self, sends):
        """Post the faces sends = [(mu, to_minus, to_plus)] (module note);
        returns what finish() takes.  A face larger than MAILBOX moves in
        rounds of MAILBOX bytes: every round but the last is posted and
        finished here, the last only posted."""
        faces = []      # (mailbox, sent bytes, received tensor, its bytes, to rank, from rank)
        for mu, to_minus, to_plus in sends:
            minus, plus = self.mesh.neighbor(mu, -1), self.mesh.neighbor(mu, +1)
            for k, t, dst, src in ((0, to_minus, minus, plus), (1, to_plus, plus, minus)):
                if t is None:
                    continue
                t = t.contiguous()
                out = torch.empty_like(t)
                if t.numel() * t.element_size() % 8:
                    raise ValueError("the peer exchange moves 8-byte words")
                faces.append((2 * mu + k, _bytes(t), out, _bytes(out), dst, src))
        if not faces:
            return []
        rounds = max(1, -(-max(f[1].numel() for f in faces) // MAILBOX))
        for r in range(rounds - 1):
            self._post(faces, r)
            self._finish(faces, r)
        self._post(faces, rounds - 1)
        return faces, rounds - 1

    def finish(self, posted):
        """Wait for the faces of post and return them, one a send of post,
        in its order."""
        if not posted:
            return []
        faces, last = posted
        self._finish(faces, last)
        return [f[2] for f in faces]

    @staticmethod
    def _round(nbytes: int, r: int):
        """(offset, 8-byte words) of round r of a message of nbytes."""
        off = min(nbytes, r * MAILBOX)
        return off, (min(nbytes, off + MAILBOX) - off) // 8

    def _post(self, faces, r):
        n = len(faces)
        arr, words = ctypes.c_void_p * n, ctypes.c_longlong * n
        parts = [self._round(f[1].numel(), r) for f in faces]
        kernels.launched("K8")
        kernels.check(kernels.lib().ddaamg_peer_post(
            arr(*(f[1].data_ptr() + off for f, (off, _) in zip(faces, parts))),
            arr(*(self.bases[f[4]] + self.ex_off + f[0] * 2 * MAILBOX for f in faces)),
            arr(*(self._flag(self.bases[f[4]], f[0]) for f in faces)),
            arr(*(self._flag(self.base, _ACK + f[0]) for f in faces)),
            arr(*(self.counts[f[0]].data_ptr() for f in faces)),
            words(*(w for _, w in parts)), n, MAILBOX,
            kernels.stream_ptr(self.device)), "peer post")

    def _finish(self, faces, r):
        n = len(faces)
        arr, words = ctypes.c_void_p * n, ctypes.c_longlong * n
        parts = [self._round(f[3].numel(), r) for f in faces]
        kernels.launched("K8")
        kernels.check(kernels.lib().ddaamg_peer_finish(
            arr(*(self.base + self.ex_off + f[0] * 2 * MAILBOX for f in faces)),
            arr(*(f[3].data_ptr() + off for f, (off, _) in zip(faces, parts))),
            arr(*(self._flag(self.base, f[0]) for f in faces)),
            arr(*(self._flag(self.bases[f[5]], _ACK + f[0]) for f in faces)),
            arr(*(self.counts[8 + f[0]].data_ptr() for f in faces)),
            words(*(w for _, w in parts)), n, MAILBOX,
            kernels.stream_ptr(self.device)), "peer finish")

    # -- all-reduce and gather ------------------------------------------------

    def _ranks_args(self, off, slot_bytes, flag_row0):
        """(slot, flag, mine, myflag) of the all-reduce (off = ar_off) or
        the gather (ag_off)."""
        P = self.ranks
        arr = ctypes.c_void_p * P
        slot = arr(*(self.bases[p] + off + self.rank * 2 * slot_bytes for p in range(P)))
        flag = arr(*(self._flag(self.bases[p], flag_row0 + self.rank) for p in range(P)))
        return slot, flag, self.base + off, self._flag(self.base, flag_row0)

    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of t (complex: its real view), in rank
        order: the same bits on every rank.  More than REDUCE bytes are
        summed in successive calls of REDUCE bytes (the same order)."""
        src = _real(t.contiguous())
        if src.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the peer all-reduce sums float32 / float64, got {t.dtype}")
        src = src.reshape(-1)
        out = torch.empty_like(src)
        per = REDUCE // src.element_size()
        slot, flag, mine, myflag = self._ranks_args(self.ar_off, REDUCE, 2 * _ACK)
        for o in range(0, src.numel(), per):
            n = min(per, src.numel() - o)
            kernels.launched("K8")
            kernels.check(kernels.lib().ddaamg_peer_allreduce(
                slot, flag, mine, myflag, self.counts[16].data_ptr(), self.ranks,
                src[o:].data_ptr(), out[o:].data_ptr(), n, int(src.dtype == torch.float64),
                REDUCE, kernels.stream_ptr(self.device)), "peer all-reduce")
        out = out.view(_real(t).shape)
        return torch.view_as_complex(out) if t.is_complex() else out

    def allgather(self, t: torch.Tensor) -> torch.Tensor:
        """[ranks, *t.shape]: every rank's t in rank order (its bytes padded
        to 8-byte words; more than GATHER bytes in successive calls)."""
        src = _bytes(t.contiguous())
        nbytes = src.numel()
        pad = -nbytes % 8
        if pad:
            src = torch.cat([src, src.new_zeros(pad)])
        N = nbytes + pad
        out = torch.empty((self.ranks, N), dtype=torch.uint8, device=src.device)
        slot, flag, mine, myflag = self._ranks_args(self.ag_off, GATHER, 2 * _ACK + self.ranks)
        for o in range(0, N, GATHER):      # round: columns [o, o + n) of out
            n = min(GATHER, N - o)
            kernels.launched("K8")
            kernels.check(kernels.lib().ddaamg_peer_allgather(
                slot, flag, mine, myflag, self.counts[17].data_ptr(), self.ranks,
                src[o:].data_ptr(), out[:, o:].data_ptr(), n // 8, N // 8, GATHER,
                kernels.stream_ptr(self.device)), "peer gather")
        if pad:
            out = out[:, :nbytes].contiguous()
        return out.view(t.dtype).reshape(self.ranks, *t.shape)

    def close(self):
        """Close the other ranks' arenas, then free this one (every rank
        calls it together, once no kernel uses the arenas)."""
        lib = kernels.lib()
        for ptr in self._opened:
            lib.ddaamg_peer_close(ctypes.c_void_p(ptr))
        self._opened = []
        if not hasattr(self, "_local"):
            dist.barrier()
        for ptr in getattr(self, "_local", ()):
            lib.ddaamg_peer_free(ctypes.c_void_p(ptr))
        if not hasattr(self, "_local") and self.base:
            lib.ddaamg_peer_free(ctypes.c_void_p(self.base))
        self.base = None


def exchange_plain(sends_of, mesh_of, rank):
    """What rank `rank` receives from the exchanges sends_of[r] = [(mu,
    to_minus, to_plus)] of every rank r (mesh_of[r] its mesh): per send of
    its own, (from_plus, from_minus), the neighbors' faces."""
    out = []
    me = mesh_of[rank]
    for i, (mu, _, _) in enumerate(sends_of[rank]):
        plus, minus = me.neighbor(mu, +1), me.neighbor(mu, -1)
        out.append((sends_of[plus][i][1], sends_of[minus][i][2]))
    return out


def allreduce_plain(parts):
    """The sum of every rank's tensor in rank order (the kernel's order)."""
    acc = _real(parts[0]).clone()
    for t in parts[1:]:
        acc += _real(t)
    return torch.view_as_complex(acc) if parts[0].is_complex() else acc


def allgather_plain(parts):
    return torch.stack(parts)
