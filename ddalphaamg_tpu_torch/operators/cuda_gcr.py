"""Wrapper of K7 (csrc/gcr.cu), the classical Gram-Schmidt of a GCR
iteration with its row count read from the device:

    h_i = <W_i, w> (i < j),  w' = w - sum_{i<j} h_i W_i,  q' = q - sum_{i<j} h_i Q_i,

then w' and q' divided by |w'| (a zero w' keeps scale 1), written to row j
of W and Q and returned, for every lane of W, Q [B, m, n] and w, q [B, n];
j is a device int64 scalar (a loop index of a captured graph, or the row
the host loop hands over).  The kernel reads only the rows below j.

For tensors on the CPU the wrapper takes the plain version, the JAX
package's formula (ddalphaamg_tpu/solvers/device_gmres.py:111-119): products
over all m rows, the rows from j on masked to zero (the JAX bases start
zero; here rows of an earlier restart may remain); for CUDA tensors it
launches K7 or raises.  complex64 and complex128.
"""

from __future__ import annotations

import torch

from .. import kernels

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
MAX_ROWS = 2048     # rows of a basis K7 takes (csrc/gcr.cu)


def orthonormalize_plain(W, Q, j, w, q):
    """Plain K7: the masked products over all m rows (module note)."""
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


def orthonormalize(W, Q, j, w, q):
    """K7 on W, Q [B, m, n], w, q [B, n] and the device int64 row j: row j
    of W and Q written, (w'', q'') [B, n] returned (module note)."""
    if W.device.type == "cpu":
        return orthonormalize_plain(W, Q, j, w, q)
    B, m, n = W.shape
    if W.dtype not in _SUFFIX or any(t.dtype != W.dtype for t in (Q, w, q)):
        raise TypeError(f"K7 takes complex64 or complex128 bases and fields of one dtype, "
                        f"got {W.dtype}, {Q.dtype}, {w.dtype}, {q.dtype}")
    if Q.shape != W.shape or w.shape != (B, n) or q.shape != (B, n) or m > MAX_ROWS:
        raise ValueError(f"K7 takes W, Q [B, m <= {MAX_ROWS}, n] and w, q [B, n], got "
                         f"{tuple(W.shape)}, {tuple(Q.shape)}, {tuple(w.shape)}, "
                         f"{tuple(q.shape)}")
    if j.dtype != torch.long or j.numel() != 1:
        raise ValueError(f"K7 takes the row as one int64, got {j.dtype} {tuple(j.shape)}")
    w, q = w.contiguous(), q.contiguous()
    if not (W.is_contiguous() and Q.is_contiguous()):
        raise ValueError("K7 takes contiguous bases")
    if any(t.device != W.device for t in (Q, w, q, j)):
        raise ValueError("K7's operands must share a device")
    lib = kernels.lib()
    chunks = lib.ddaamg_gcr_chunks(n)
    H = torch.empty((B, m, chunks), dtype=W.dtype, device=W.device)
    h = torch.empty((B, m), dtype=W.dtype, device=W.device)
    N = torch.empty((B, chunks), dtype=W.real.dtype, device=W.device)
    wo, qo = torch.empty_like(w), torch.empty_like(q)
    kernels.launched("K7")
    rc = getattr(lib, f"ddaamg_gcr_orthonormalize_{_SUFFIX[W.dtype]}")(
        W.data_ptr(), Q.data_ptr(), w.data_ptr(), q.data_ptr(), wo.data_ptr(), qo.data_ptr(),
        j.data_ptr(), H.data_ptr(), h.data_ptr(), N.data_ptr(), B, m, n,
        kernels.stream_ptr(W.device))
    kernels.check(rc, "Gram-Schmidt")
    return wo, qo
