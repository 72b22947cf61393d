"""Wrapper of K7 (csrc/gcr.cu), one whole GCR iteration after the operator
apply, with its row index j read from the device.  For every lane b of
W, Q [B, m, n], x, r [B, n] and w = A q, q [B, n]:

    h_i = <W_i, w> (i < j),  w' = w - sum_{i<j} h_i W_i,  q' = q - sum_{i<j} h_i Q_i,
    W_j = w' / |w'|,  Q_j = q' / |w'|  (a zero w' keeps scale 1),
    alpha = <W_j, r_in>,  x += alpha Q_j,  r -= alpha W_j,
    iters += go,  rn = |r|,  go = (rn >= stop) & active,

with r_in = r at batch 1 and rz, the residual masked by go (a frozen lane
enters as zeros), at batch B > 1, rz then set from the new go; j is a
device int64 scalar (a loop index of a captured graph, or the row the host
loop hands over).  The kernel reads only the rows below j; a frozen lane
keeps x, r, rn and iters.

For tensors on the CPU the wrapper takes the plain version, the sequence of
torch operations GCRLanes.step ran before K7 computed the whole step:
orthonormalize_plain (the JAX package's masked products over all m rows,
ddalphaamg_tpu/solvers/device_gmres.py:111-119, the rows from j on masked
to zero: here rows of an earlier restart may remain), then alpha by
torch.linalg.vecdot, the updates, the norm and the stop test.  For CUDA
tensors it launches K7 or raises.  complex64 and complex128.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
MAX_ROWS = 2048     # rows of a basis K7 takes (csrc/gcr.cu)
PATHS = {"cluster": 0, "grid": 1}


def orthonormalize_plain(W, Q, j, w, q):
    """The Gram-Schmidt part of the plain step: the masked products over
    all m rows, row j of W and Q written, (w'', q'') returned."""
    keep = torch.arange(W.shape[1], device=W.device) < j
    h = torch.where(keep, (W @ w.conj().unsqueeze(-1)).squeeze(-1).conj(), 0)
    w = w - (h.unsqueeze(1) @ W).squeeze(1)
    q = q - (h.unsqueeze(1) @ Q).squeeze(1)
    wn = torch.linalg.vector_norm(w, dim=-1)
    inv = wn.masked_fill(wn == 0, 1.0).reciprocal()[:, None]
    w, q = w * inv, q * inv
    row = j.reshape(1)
    W.index_copy_(1, row, w.unsqueeze(1))
    Q.index_copy_(1, row, q.unsqueeze(1))
    return w, q


def lane_norm(a, allsum=None):
    """|a_b| of every lane b of flattened [B, n] fields (allsum: a slab's
    squares summed over the ranks; None on one rank)."""
    if allsum is None:
        return torch.linalg.vector_norm(a, dim=-1)
    return torch.sqrt(allsum(torch.linalg.vector_norm(a, dim=-1) ** 2))


def stop_test(rn, stop, active, go, r=None, rz=None):
    """go = rn >= stop (and active), and with rz the masked residual
    rz = go ? r : 0."""
    torch.ge(rn, stop, out=go)
    if active is not None:
        go &= active
    if rz is not None:
        rz.copy_(torch.where(go[:, None], r, 0))


def update_step(w, q, x, r, rz, go, stop, active, rn, iters, allsum=None):
    """The plain step after the Gram-Schmidt, on its normalized w, q:
    alpha = <w, r_in> (r_in = r, or rz at batch > 1), x += alpha q,
    r -= alpha w, the iteration count, |r| and the stop test, in place;
    allsum sums a slab's partial sums over the ranks (None on one rank)."""
    # <w, r> as a product and a sum: a batched complex64 matrix product
    # [1, n] @ [n, 1] carries relative errors of 1e-5 at n = 12 * 16^4 on
    # the card, which let the residual recurrence drift from the true
    # residual
    alpha = torch.linalg.vecdot(w, r if rz is None else rz)[:, None]
    if allsum is not None:
        alpha = allsum(alpha)
    x += alpha * q
    r -= alpha * w
    iters += go
    rn.copy_(lane_norm(r, allsum))
    stop_test(rn, stop, active, go, r, rz)


def gcr_step_plain(W, Q, j, w, q, x, r, rz, go, stop, active, rn, iters):
    """Plain K7: the torch sequence of the step (module note), in place."""
    w, q = orthonormalize_plain(W, Q, j, w, q)
    update_step(w, q, x, r, rz, go, stop, active, rn, iters)


def scratch(B: int, m: int, n: int, dtype, device):
    """The scratch of K7's grid design for [B, m, n] bases, made once
    before any capture (a byte buffer and zeroed counters, which the kernel
    leaves zero); None on the CPU or where the cluster design runs."""
    device = torch.device(device)
    if device.type != "cuda" or dtype not in _SUFFIX:
        return None
    lib = kernels.lib()
    c128 = int(dtype == torch.complex128)
    if lib.ddaamg_gcr_path(n, m, c128) == PATHS["cluster"]:
        return None
    return _grid_scratch(lib, B, m, n, c128, device)


def _grid_scratch(lib, B, m, n, c128, device):
    work = torch.empty(lib.ddaamg_gcr_work_bytes(B, m, n, c128), dtype=torch.uint8,
                       device=device)
    sync = torch.zeros(lib.ddaamg_gcr_sync_words(B, m), dtype=torch.int32, device=device)
    return work, sync


def _aligned(t):
    """t contiguous at a 16-byte address (K7 loads 16 bytes at once)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gcr_step(W, Q, j, w, q, x, r, rz, go, stop, active, rn, iters, work=None, path=None):
    """K7 on the state of a GCR solve (module note), updated in place: W, Q
    [B, m, n], w, q, x, r [B, n], rz [B, n] or None (batch 1), go [B] bool,
    stop, rn [B] real, active [B] bool or None, iters [B] int64, j a device
    int64.  q may be r (batch 1) or rz (batch > 1), as in a GCR without a
    preconditioner: both designs read q before they write r or rz
    (csrc/gcr.cu, Step).  work: scratch() of these shapes (made here when
    None, outside a capture only); path: "cluster" or "grid" forces a
    design (None: by n, ddaamg_gcr_path)."""
    if W.device.type == "cpu":
        return gcr_step_plain(W, Q, j, w, q, x, r, rz, go, stop, active, rn, iters)
    B, m, n = W.shape
    fields = (Q, w, q, x, r) + (() if rz is None else (rz,))
    if W.dtype not in _SUFFIX or any(t.dtype != W.dtype for t in fields):
        raise TypeError(f"K7 takes complex64 or complex128 bases and fields of one dtype, "
                        f"got {[t.dtype for t in (W,) + fields]}")
    if (Q.shape != W.shape or any(t.shape != (B, n) for t in fields[1:]) or m > MAX_ROWS):
        raise ValueError(f"K7 takes W, Q [B, m <= {MAX_ROWS}, n] and fields [B, n], got "
                         f"{[tuple(t.shape) for t in (W,) + fields]}")
    real = W.real.dtype
    if (go.dtype != torch.bool or stop.dtype != real or rn.dtype != real
            or iters.dtype != torch.long or (active is not None and active.dtype != torch.bool)
            or any(t.shape != (B,) for t in (go, stop, rn, iters))
            or (active is not None and active.shape != (B,))):
        raise ValueError("K7 takes go, active [B] bool, stop, rn [B] of the fields' real "
                         "dtype and iters [B] int64")
    if j.dtype != torch.long or j.numel() != 1:
        raise ValueError(f"K7 takes the row as one int64, got {j.dtype} {tuple(j.shape)}")
    updated = (W, Q, x, r) + (() if rz is None else (rz,))
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in updated):
        raise ValueError("K7 updates contiguous, 16-byte aligned bases and fields in place")
    flags = (go, stop, rn, iters) + (() if active is None else (active,))
    if not all(t.is_contiguous() for t in flags):
        raise ValueError("K7 takes contiguous go, stop, rn, iters and active")
    state = updated + flags
    w, q = _aligned(w), _aligned(q)
    if any(t.device != W.device for t in state + (w, q, j)):
        raise ValueError("K7's operands must share a device")
    lib = kernels.lib()
    c128 = int(W.dtype == torch.complex128)
    code = -1 if path is None else PATHS[path]
    if code == PATHS["cluster"] and not lib.ddaamg_gcr_cluster_fits(n, m, c128):
        raise ValueError(f"K7's cluster design does not take n = {n}, m = {m}")
    if work is None and (code == PATHS["grid"] or (
            code < 0 and lib.ddaamg_gcr_path(n, m, c128) == PATHS["grid"])):
        work = _grid_scratch(lib, B, m, n, c128, W.device)
    buf, sync = (None, None) if work is None else work
    kernels.launched("K7")
    rc = getattr(lib, f"ddaamg_gcr_step_{_SUFFIX[W.dtype]}")(
        W.data_ptr(), Q.data_ptr(), j.data_ptr(), w.data_ptr(), q.data_ptr(), x.data_ptr(),
        r.data_ptr(), None if rz is None else rz.data_ptr(), go.data_ptr(), stop.data_ptr(),
        None if active is None else active.data_ptr(), rn.data_ptr(), iters.data_ptr(),
        None if buf is None else buf.data_ptr(), None if sync is None else sync.data_ptr(),
        B, m, n, code, kernels.stream_ptr(W.device))
    kernels.check(rc, "GCR step")


def cluster_shape(n: int):
    """The cluster design at n elements a lane on this card: (CTAs a
    cluster, slice length, clusters the card runs at once)."""
    out = [ctypes.c_int() for _ in range(3)]
    kernels.lib().ddaamg_gcr_cluster_shape(n, *(ctypes.byref(o) for o in out))
    return tuple(o.value for o in out)
