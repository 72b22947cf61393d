"""Products with the stored inverses of the hierarchy (the coarsest level's
dense inverse and the Schwarz block inverses): y[..., b, :] = A[b]
x[..., b, :] for A [nb, m, m] and x [..., nb, m], the leading axes of x
being right-hand sides (the lanes of a batched cycle).

Complex A (complex64 or complex128) goes to torch.matmul, as the JAX
package leaves the product to XLA (operators/stencil.py:710, :727,
smoothers/sap.py:193).  A stored in bf16 as (re, im) pairs [nb, m, m, 2]
(operators/coarse.compress) takes complex64 x: for CUDA tensors the wrapper
launches K6 (csrc/dense.cu) or raises, the batch-1 kernel for one
right-hand side and the multi-right-hand-side kernel, which reads A once
for up to MRHS_MAX of them, for more; for CPU tensors it takes the plain
version, the widened matrix through torch.matmul.
"""

from __future__ import annotations

import torch

from .. import kernels
from .coarse import widen

MRHS_MAX = 12   # right-hand sides of one multi-right-hand-side launch (csrc/dense.cu)


def _product(A, x):
    """A[b] x[r, b] for every right-hand side r through one torch.matmul
    [nb, m, m] @ [nb, m, R], which reads A once."""
    xr = x.reshape(-1, *x.shape[-2:])
    return torch.matmul(A, xr.permute(1, 2, 0)).permute(2, 0, 1).reshape(x.shape)


def matvec_plain(A, x):
    """Plain K6 (and the complex product): widen, then torch.matmul."""
    return _product(widen(A), x)


def matvec(A, x):
    """y[..., b, :] = A[b] x[..., b, :]; see the module note for the
    instances."""
    if A.dtype != torch.bfloat16:
        if A.dtype != x.dtype:
            raise TypeError(f"matrix {A.dtype} and vector {x.dtype} differ")
        return _product(A, x)
    if x.dtype != torch.complex64:
        raise TypeError(f"bf16 matrices apply to complex64 vectors, got {x.dtype}")
    if x.device.type == "cpu":
        return matvec_plain(A, x)
    if x.dim() < 2 or A.shape != (*x.shape[-2:], x.shape[-1], 2):
        raise ValueError(f"K6 takes A [nb, m, m, 2] and x [..., nb, m], "
                         f"got {tuple(A.shape)} and {tuple(x.shape)}")
    if A.device != x.device or not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError("A and x must be contiguous on one device")
    nb, m = x.shape[-2:]
    y = torch.empty_like(x)
    xr, yr = x.reshape(-1, nb, m), y.reshape(-1, nb, m)
    stream = kernels.stream_ptr(x.device)
    if xr.shape[0] == 1:
        kernels.KERNELS["K6"].launches += 1
        rc = kernels.lib().ddaamg_dense_bf16(y.data_ptr(), x.data_ptr(), A.data_ptr(),
                                             nb, m, stream)
        kernels.check(rc, "dense bf16 matvec")
        return y
    for r0 in range(0, xr.shape[0], MRHS_MAX):
        xc, yc = xr[r0:r0 + MRHS_MAX], yr[r0:r0 + MRHS_MAX]
        kernels.KERNELS["K6"].launches += 1
        rc = kernels.lib().ddaamg_dense_bf16_mrhs(yc.data_ptr(), xc.data_ptr(), A.data_ptr(),
                                                  nb, m, xc.shape[0], stream)
        kernels.check(rc, "dense bf16 multi-right-hand-side matvec")
    return y
