"""The precisions a plain reference computes in.

``"f64"`` is the reference: every operation in float64.  ``"tf32"`` is the
control, the precision next below the configurations' IEEE float32 with
TF32 off: float32 everywhere, and every matrix product takes its inputs
rounded to TF32's 10-bit mantissa and accumulates in float32, as the
tensor cores do.  The rounding is done here, bit by bit, so the control
does not depend on which cuBLAS kernel a shape reaches (a product of one
row may run as a GEMV, which TF32 mode leaves in full float32).
"""

from __future__ import annotations

import torch

PRECISIONS = ("f64", "tf32")


def dtype_of(prec: str) -> torch.dtype:
    if prec == "f64":
        return torch.float64
    if prec == "tf32":
        return torch.float32
    raise ValueError(f"unknown precision {prec!r}: one of {PRECISIONS}")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even:
    the low 13 of float32's 23 mantissa bits cleared."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32).view(x.shape)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with both inputs rounded to TF32, and the two products of
    its backward likewise."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = to_tf32(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` in ``prec`` (``a`` and ``b`` already in its dtype)."""
    if prec == "tf32":
        return _TF32Matmul.apply(a, b)
    return a @ b


def full_float32() -> None:
    """Keep cuBLAS and cuDNN from computing float32 products in TF32, so
    a float32 product of the reference is one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
