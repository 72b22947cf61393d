"""Products with the stored inverses of the hierarchy (the coarsest level's
dense inverse and the Schwarz block inverses): y[..., b, :] = A[b]
x[..., b, :] for A [nb, m, m] and x [..., nb, m], the leading axes of x
being right-hand sides (the lanes of a batched cycle).

`blocks` (int32 [nc] on x's device, sorted, unique, in range; None: all
blocks) lists the blocks to compute: a Schwarz colour step multiplies a
field that is zero outside the colour's blocks, so only those blocks of A
and x are read, and y is zero elsewhere.

Complex A (complex64 or complex128) goes to torch.matmul, as the JAX
package leaves the product to XLA (operators/stencil.py:710, :727,
smoothers/sap.py:193).  A stored in bf16 as (re, im) pairs [nb, m, m, 2]
(operators/coarse.compress) takes complex64 x: for CUDA tensors the wrapper
launches K6 (csrc/dense.cu) or raises; for CPU tensors it takes the plain
version, the widened matrix through torch.matmul.  K6 is two kernels:

- one right-hand side: f32 multiply-adds on the CUDA cores, one warp a
  row, bound by the listed blocks' bytes of A;
- 2 to MRHS_MAX right-hand sides (the wrapper splits more): the tensor
  cores read A once for all of them.  Each f32 value of x is split exactly
  into three bf16 parts (split3_bf16, its plain mirror), each product of a
  bf16 entry and a part is exact in the f32 accumulator, and the three
  parts' sums are added in a fixed order; bound by A's bytes again, since
  the split triples only the operations (3 x 8 nb m^2 R at 989 TFLOP/s).
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


def _listed_product(A, x, blocks, plain):
    """The product on the listed blocks only (plain: widen A first), zeros
    elsewhere."""
    if blocks is None:
        return _product(widen(A) if plain else A, x)
    y = torch.zeros_like(x)
    if blocks.numel():
        Ab = A.index_select(0, blocks.long())
        y[..., blocks.long(), :] = _product(widen(Ab) if plain else Ab, x[..., blocks.long(), :])
    return y


def check_blocks(blocks, nb: int, device):
    """Raise unless blocks is None or an int32 [nc] tensor on `device`,
    sorted, unique and within [0, nb).  A list's contents are read from the
    device once and remembered on the tensor until it is written to again."""
    if blocks is None:
        return
    if blocks.dtype != torch.int32 or blocks.dim() != 1 or blocks.device != device:
        raise ValueError(f"blocks must be int32 [nc] on {device}, got {blocks.dtype} "
                         f"{tuple(blocks.shape)} on {blocks.device}")
    stamp = (blocks._version, nb)
    if getattr(blocks, "_k6_checked", None) == stamp:
        return
    if blocks.numel() and not (bool((blocks[1:] > blocks[:-1]).all())
                               and int(blocks[0]) >= 0 and int(blocks[-1]) < nb):
        raise ValueError(f"blocks must be sorted, unique and in [0, {nb})")
    blocks._k6_checked = stamp


def split3_bf16(v):
    """f32 v -> three bf16 parts (v1, v2, v3), v1 = RN(v), v2 = RN(v - v1),
    v3 = RN(v - v1 - v2), as K6's tensor-core kernel splits x.  Each rounding
    leaves at most 16, then 8 significant bits, so v3 is exact and
    v1 + v2 + v3 == v for 2^-110 < |v| < 2^127 (and v = 0): below, v3 falls
    into bf16's subnormals and loses bits; near the largest f32, v1 rounds
    to infinity.  The solver's fields lie far inside that range."""
    v1 = v.to(torch.bfloat16)
    r1 = v - v1.float()
    v2 = r1.to(torch.bfloat16)
    v3 = (r1 - v2.float()).to(torch.bfloat16)
    return v1, v2, v3


def matvec_plain(A, x, blocks=None):
    """Plain K6 (and the complex product): widen, then torch.matmul, on the
    listed blocks."""
    check_blocks(blocks, A.shape[0], x.device)
    return _listed_product(A, x, blocks, plain=True)


def matvec(A, x, blocks=None):
    """y[..., b, :] = A[b] x[..., b, :] on the listed blocks, zero on the
    others; see the module note for the instances."""
    if A.dtype != torch.bfloat16:
        if A.dtype != x.dtype:
            raise TypeError(f"matrix {A.dtype} and vector {x.dtype} differ")
        check_blocks(blocks, A.shape[0], x.device)
        return _listed_product(A, x, blocks, plain=False)
    if x.dtype != torch.complex64:
        raise TypeError(f"bf16 matrices apply to complex64 vectors, got {x.dtype}")
    if x.device.type == "cpu":
        return matvec_plain(A, x, blocks)
    if x.dim() < 2 or A.shape != (*x.shape[-2:], x.shape[-1], 2):
        raise ValueError(f"K6 takes A [nb, m, m, 2] and x [..., nb, m], "
                         f"got {tuple(A.shape)} and {tuple(x.shape)}")
    if A.device != x.device or not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError("A and x must be contiguous on one device")
    nb, m = x.shape[-2:]
    check_blocks(blocks, nb, x.device)
    nc = nb if blocks is None else blocks.numel()
    y = torch.empty_like(x) if nc == nb else torch.zeros_like(x)
    if nc == 0:
        return y
    bl = 0 if blocks is None else blocks.data_ptr()
    xr, yr = x.reshape(-1, nb, m), y.reshape(-1, nb, m)
    stream = kernels.stream_ptr(x.device)
    if xr.shape[0] == 1:
        kernels.launched("K6")
        rc = kernels.lib().ddaamg_dense_bf16(y.data_ptr(), x.data_ptr(), A.data_ptr(), bl,
                                             nb, m, nc, stream)
        kernels.check(rc, "dense bf16 matvec")
        return y
    for r0 in range(0, xr.shape[0], MRHS_MAX):
        xc, yc = xr[r0:r0 + MRHS_MAX], yr[r0:r0 + MRHS_MAX]
        kernels.launched("K6")
        if xc.shape[0] == 1:    # a last single right-hand side: the batch-1 kernel
            rc = kernels.lib().ddaamg_dense_bf16(yc.data_ptr(), xc.data_ptr(), A.data_ptr(),
                                                 bl, nb, m, nc, stream)
        else:
            rc = kernels.lib().ddaamg_dense_bf16_mrhs(yc.data_ptr(), xc.data_ptr(),
                                                      A.data_ptr(), bl, nb, m, xc.shape[0],
                                                      nc, stream)
        kernels.check(rc, "dense bf16 multi-right-hand-side matvec")
    return y
