"""Products with the stored inverses of the hierarchy (the coarsest level's
dense inverse and the Schwarz block inverses): y[b] = A[b] x[b] for
A [nb, m, m] and x [nb, m].

Complex A (complex64 or complex128) goes to torch.matmul, as the JAX
package leaves the product to XLA (operators/stencil.py:710, :727,
smoothers/sap.py:193).  A stored in bf16 as (re, im) pairs [nb, m, m, 2]
(operators/coarse.compress) takes complex64 x: for CUDA tensors the wrapper
launches K6 (csrc/dense.cu) or raises; for CPU tensors it takes the plain
version, the widened matrix through torch.matmul.
"""

from __future__ import annotations

import torch

from .. import kernels
from .coarse import widen


def matvec_plain(A, x):
    """Plain K6 (and the complex product): widen, then torch.matmul."""
    return torch.matmul(widen(A), x.unsqueeze(-1)).squeeze(-1)


def matvec(A, x):
    """y[b] = A[b] x[b]; see the module note for the instances."""
    if A.dtype != torch.bfloat16:
        if A.dtype != x.dtype:
            raise TypeError(f"matrix {A.dtype} and vector {x.dtype} differ")
        return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)
    if x.dtype != torch.complex64:
        raise TypeError(f"bf16 matrices apply to complex64 vectors, got {x.dtype}")
    if x.device.type == "cpu":
        return matvec_plain(A, x)
    nb, m = x.shape
    if A.shape != (nb, m, m, 2):
        raise ValueError(f"K6 takes A [nb, m, m, 2] and x [nb, m], "
                         f"got {tuple(A.shape)} and {tuple(x.shape)}")
    if A.device != x.device or not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError("A and x must be contiguous on one device")
    y = torch.empty_like(x)
    kernels.KERNELS["K6"].launches += 1
    rc = kernels.lib().ddaamg_dense_bf16(y.data_ptr(), x.data_ptr(), A.data_ptr(),
                                         nb, m, kernels.stream_ptr(x.device))
    kernels.check(rc, "dense bf16 matvec")
    return y
