"""The arithmetic of the plain reference: its float type, and whether its
matrix products take their operands rounded to TF32 (the control).

TF32 is emulated, so that it means the same on every device: each operand
of a product is rounded to 10 mantissa bits (round to nearest even, as the
tensor cores' conversion does) and the product accumulates in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits, held as float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


@dataclass(frozen=True)
class Prec:
    """``dtype`` of every tensor the reference makes; ``tf32``: matrix
    products with TF32 operands (``dtype`` must then be float32)."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def __post_init__(self):
        if self.tf32 and self.dtype != torch.float32:
            raise ValueError("TF32 products take float32 operands")

    def r(self, t: torch.Tensor) -> torch.Tensor:
        return round_tf32(t) if self.tf32 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b."""
        return self.r(a) @ self.r(b)

    def mv(self, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """(..., n, k) @ (..., k) → (..., n)."""
        return (self.r(M) @ self.r(v)[..., None])[..., 0]

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.r(o) for o in ops))

    def t(self, x, device) -> torch.Tensor:
        return torch.as_tensor(x, device=device).to(self.dtype)


F64 = Prec(torch.float64)
F32 = Prec(torch.float32)
TF32 = Prec(torch.float32, tf32=True)
