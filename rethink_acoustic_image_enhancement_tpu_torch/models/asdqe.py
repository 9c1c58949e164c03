"""ASDQE: pairwise (LQ vs result) acoustic image quality scorer, NCHW.

Reference: ASDQE/ASDQE_model.py:20-171. Three DoubleConv feature branches
(LQ, result, LQ - result) -> concat -> a 3-down / 3-up bilinear UNet ->
global average pool -> MLP regressor with tanh, a score in [-1, 1].
Attribute names are the reference's, so ``convert/weights.py::
asdqe_state_dict`` (and a ``.pth`` from ``torch_export.export_asdqe``) loads
with ``strict=True``.

Serving (``eval()``): BatchNorm runs on its running statistics (eps 1e-5)
and Dropout is a no-op. The parameters stay float32: like the flax module
(``dtype=None``), bfloat16 images are padded and subtracted in bfloat16,
then promoted at the convs.

Training (``train()``) follows the JAX package's flax module:
  * BatchNorm normalises with the batch's mean and *biased* variance
    (E[x^2] - E[x]^2, clipped at 0), taken in float32, and updates its
    running statistics at momentum 0.9 with that biased variance
    (``nn.BatchNorm2d`` would take the unbiased one);
  * Dropout 0.5 / 0.3 draws from the ``torch.Generator`` given to
    ``set_dropout_generator`` (the default generator where none is set);
  * ``remat=True`` recomputes each DoubleConv / Down / Up block in the
    backward pass (``torch.utils.checkpoint``): memory only, the same
    numbers; the recomputation does not update the running statistics
    a second time;
  * ``dtype`` (e.g. bfloat16) is the compute dtype of flax's ``dtype=``:
    each conv casts its input and kernel to it, BatchNorm takes its
    statistics in float32 and returns ``dtype``, the pooled features meet
    the float32 regressor in float32; the parameters stay float32.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.layout import pad_to_multiple
from ..ops.resize import global_avg_pool, max_pool_2x2, resize_bilinear_align_corners

MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch

# set while torch.utils.checkpoint recomputes a block in the backward pass
_RECOMPUTING = contextvars.ContextVar("asdqe_recomputing", default=False)


@contextlib.contextmanager
def _recomputing():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` where one is set (input,
    kernel and bias cast, as flax's ``promote_dtype(..., dtype=)``)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW (see the
    module docstring); the buffers and names of ``nn.BatchNorm2d``."""

    compute_dtype: torch.dtype | None = None

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and x.dtype == self.weight.dtype and self.compute_dtype is None:
            return super().forward(x)  # serving: running statistics
        out_dtype = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x32 = x.float()
        if self.training:
            mean = x32.mean(dim=(0, 2, 3))
            var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            if not _RECOMPUTING.get():
                with torch.no_grad():
                    self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
                    self.running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(out_dtype)


class Dropout(nn.Dropout):
    """flax ``nn.Dropout``: kept values scaled by 1 / (1 - p), the mask from
    ``generator`` (the default generator where it is None)."""

    generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


class DoubleConv(nn.Module):
    """(conv 3x3 -> BN -> ReLU) x 2 (ASDQE/ASDQE_model.py:20-34)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            Conv2d(in_channels, features, 3, padding=1),
            BatchNorm2d(features), nn.ReLU(),
            Conv2d(features, features, 3, padding=1),
            BatchNorm2d(features), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class _MaxPool2x2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2x2(x)


class Down(nn.Module):
    """MaxPool2d(2) then DoubleConv (ASDQE/ASDQE_model.py:36-46)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(_MaxPool2x2(),
                                          DoubleConv(in_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Bilinear 2x upsample (align_corners), zero pad to the skip's size
    (dy//2 above, the rest below; likewise for dx), concat [skip, x1],
    DoubleConv (ASDQE/ASDQE_model.py:48-66)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, features)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        h1, w1 = x1.shape[2], x1.shape[3]
        x1 = resize_bilinear_align_corners(x1, h1 * 2, w1 * 2)
        dy, dx = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
        if dy or dx:
            x1 = nn.functional.pad(
                x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    """1x1 conv (ASDQE/ASDQE_model.py:68-75)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _Remat(nn.Module):
    """Runs a block through ``torch.utils.checkpoint`` when ``remat`` is on
    and a gradient is being taken."""

    remat: bool = False

    def block(self, module: nn.Module, *args):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False,
                              context_fn=_remat_contexts)
        return module(*args)


class UNet(_Remat):
    """Encoder 64/128/256/256, decoder 128/64/64 (ASDQE/ASDQE_model.py:77-111)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.inc = DoubleConv(in_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 256)
        self.up1 = Up(512, 128)
        self.up2 = Up(256, 64)
        self.up3 = Up(128, 64)
        self.outc = OutConv(64, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.block(self.inc, x)
        x2 = self.block(self.down1, x1)
        x3 = self.block(self.down2, x2)
        x4 = self.block(self.down3, x3)
        y = self.block(self.up1, x4, x3)
        y = self.block(self.up2, y, x2)
        y = self.block(self.up3, y, x1)
        return self.outc(y)


class _GlobalAvgPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(x)


class DenoiseRatePredictor(_Remat):
    """``forward(lq, gt)`` on NCHW images in [0, 1]; both are zero-padded
    at the bottom and right to a multiple of ``dim`` (the global pool
    averages over that padding too). Returns (B, 1) in [-1, 1], or with
    ``return_features`` the pooled (B, 3 * dim) embedding. ``remat`` and
    ``dtype``: see the module docstring."""

    def __init__(self, in_channels: int = 3, dim: int = 16, remat: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dim = dim
        self.lq_extractor = DoubleConv(in_channels, dim)
        self.gt_extractor = DoubleConv(in_channels, dim)
        self.diff_extractor = DoubleConv(in_channels, dim)
        self.unet = UNet(dim * 3, dim * 3)
        # the reference's Sequential: pool, flatten, then Linear layers at
        # indices 2, 5 and 8
        self.regressor = nn.Sequential(
            _GlobalAvgPool(), nn.Flatten(),
            nn.Linear(dim * 3, 256), nn.ReLU(), Dropout(0.5),
            nn.Linear(256, 64), nn.ReLU(), Dropout(0.3),
            nn.Linear(64, 1), nn.Tanh())
        self.set_remat(remat)
        self.set_compute_dtype(dtype)

    def set_remat(self, remat: bool) -> "DenoiseRatePredictor":
        self.remat = self.unet.remat = remat
        return self

    def set_compute_dtype(self, dtype: torch.dtype | None) -> "DenoiseRatePredictor":
        """flax's ``dtype=``: None computes in the promoted dtype of input and
        weights (the serving contract)."""
        self.compute_dtype = dtype
        for m in self.modules():
            if isinstance(m, (Conv2d, BatchNorm2d)):
                m.compute_dtype = dtype
        return self

    def set_dropout_generator(self, generator: torch.Generator | None
                              ) -> "DenoiseRatePredictor":
        for m in self.regressor:
            if isinstance(m, Dropout):
                m.generator = generator
        return self

    def forward(self, lq: torch.Tensor, gt: torch.Tensor,
                return_features: bool = False) -> torch.Tensor:
        lq, _ = pad_to_multiple(lq, self.dim, mode="constant", axes=(2, 3))
        gt, _ = pad_to_multiple(gt, self.dim, mode="constant", axes=(2, 3))
        diff = lq - gt  # in the images' dtype, as in flax
        weight = self.unet.outc.conv.weight
        dtype = self.compute_dtype or torch.promote_types(lq.dtype, weight.dtype)
        merged = torch.cat([self.block(self.lq_extractor, lq.to(dtype)),
                            self.block(self.gt_extractor, gt.to(dtype)),
                            self.block(self.diff_extractor, diff.to(dtype))], dim=1)
        z = self.regressor[:2](self.unet(merged))
        if return_features:
            return z
        # flax's Dense (dtype None): the promoted dtype of input and kernel
        fc1 = self.regressor[2].weight
        return self.regressor[2:](z.to(torch.promote_types(z.dtype, fc1.dtype)))


def init_weights_(model: DenoiseRatePredictor,
                  generator: torch.Generator) -> DenoiseRatePredictor:
    """Seeded random weights for a scorer with no trained ones: He-normal
    convolutions (the scale holds through the ReLUs, so the score moves with
    the images), LeCun-normal linear layers, biases N(0, 0.05), BatchNorm
    weights 1 + N(0, 0.1), biases and running means N(0, 0.1), running
    variances in [0.5, 1.5)."""
    def normal(shape, scale, shift=0.0):
        return torch.randn(shape, generator=generator) * scale + shift

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                m.weight.copy_(normal(m.weight.shape, (gain / fan_in) ** 0.5))
                m.bias.copy_(normal(m.bias.shape, 0.05))
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(normal(m.weight.shape, 0.1, 1.0))
                m.bias.copy_(normal(m.bias.shape, 0.1))
                m.running_mean.copy_(normal(m.running_mean.shape, 0.1))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=generator))
    return model
