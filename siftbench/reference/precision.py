"""The precision the reference computes in.

The configurations state float32 with TF32 off. The reference computes in
float32 with TF32 off; the control computes the same code at the precision
just below, TF32: every stage reads its floating-point operands rounded to
TF32 (10 explicit mantissa bits, to nearest with ties away from zero, as the
card's ``cvt.rna.tf32.f32`` rounds them), and matrix products run on the
TF32 tensor cores.
"""

from __future__ import annotations

import contextlib

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 explicit mantissa bits, to
    nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """``float32`` (the reference) or ``tf32`` (the control)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A stage's floating-point operand as the stage reads it."""
        return tf32_round(x) if self.tf32 else x

    @contextlib.contextmanager
    def products(self):
        """Matrix products inside the block run in this precision."""
        before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before

    def __repr__(self) -> str:
        return "tf32" if self.tf32 else "float32"


FLOAT32 = Precision(False)
TF32 = Precision(True)
