"""The two precisions a reference runs in.

``f64``: float64 throughout, the reference. ``tf32``: the control, the
precision below what the configurations state (float32 with TF32 off):
float32 storage and arithmetic, with the operands of every product (a
matrix product, a contraction, a dot) rounded to TF32's 10-bit mantissa
first, as the tensor cores round them, and float32 accumulation. The
rounding is emulated, so the control reads the same on any device.
"""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties away from zero,
    as the conversion the tensor cores apply)."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x1000) & ~0x1FFF
    return r.view(torch.float32)


class Prec:
    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def t(self, x, device) -> torch.Tensor:
        return torch.as_tensor(x, device=device).to(self.dtype)

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product."""
        return tf32(x) if self.name == "tf32" else x

    def einsum(self, eq: str, *xs) -> torch.Tensor:
        return torch.einsum(eq, *(self.op(x) for x in xs))
