"""Precision settings of the port."""

from __future__ import annotations

import torch


def pin_full_precision():
    """Run float32 matrix products and convolutions in true float32.

    TF32 keeps about three decimal digits; in the Krylov recurrences and the
    clover build that spoils the true residual an f32 inner sweep can reach
    (docs/iteration_parity.md describes the TPU's bf16 version of this trap).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
