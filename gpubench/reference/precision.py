"""Operand rounding for the references and their controls.

A reference computes every product in float32 with TF32 off.  A control
is the same reference with the operands of its products rounded to a lower
precision first: ``tf32`` (10 mantissa bits, as the tensor cores take
float32), ``bf16``, or ``fp8`` (e4m3 with one scale a tensor, its largest
magnitude mapped to 448).  ``operand(x, p)`` returns the rounded values in
float32, so the products themselves stay exact float32 arithmetic.
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32", "bf16", "fp8")


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to 10 mantissa bits, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    out = bits.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    x = x.float()
    if precision == "fp32":
        return x
    if precision == "tf32":
        return _round_tf32(x)
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}; options {PRECISIONS}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32 on operands rounded to ``precision``."""
    return operand(a, precision) @ operand(b, precision)


def no_tf32():
    """Turn TF32 off for float32 products (the references' arithmetic)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
