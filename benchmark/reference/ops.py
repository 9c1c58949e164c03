"""The products of the plain references, in float32 with TF32 off, or with
their operands rounded to a lower precision (the controls).

Plain PyTorch and NumPy only: nothing of the program under test and no
JAX."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), back in float32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 mantissa rounded to TF32's 10 bits (nearest, ties
    to even), as the tensor cores read float32 operands under TF32."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


ROUNDERS = {"fp8": fp8_round, "tf32": tf32_round}


class _Round(torch.autograd.Function):
    """An operand rounded; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """A product's output unchanged; the gradient coming back into the
    product rounded, as the backward's own products read it."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Ops:
    """conv2d, conv3d, conv_transpose3d and matmul in float32; with
    ``round`` ('fp8' or 'tf32') every operand of every product is rounded
    first, in the forward and in the backward alike."""

    def __init__(self, round: str | None = None):
        self.fn = ROUNDERS[round] if round else None

    def _in(self, t):
        return t if self.fn is None else _Round.apply(t, self.fn)

    def _out(self, t):
        return t if self.fn is None else _RoundGrad.apply(t, self.fn)

    def conv2d(self, x, w, padding=0, dilation=1, groups=1):
        return self._out(F.conv2d(self._in(x), self._in(w), None, 1, padding, dilation, groups))

    def conv3d(self, x, w, b, padding=0):
        return self._out(F.conv3d(self._in(x), self._in(w), b, 1, padding))

    def conv_transpose3d(self, x, w, b, stride):
        return self._out(F.conv_transpose3d(self._in(x), self._in(w), b, stride))

    def matmul(self, a, b):
        return self._out(self._in(a) @ self._in(b))


@contextlib.contextmanager
def fp32_exact(tf32: bool = False):
    """cuDNN and cuBLAS without TF32 inside (with it where ``tf32``), both
    flags restored on leaving."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
