"""Pixel losses on NCHW tensors (the reference loss zoo,
Train/basicsr/models/losses/losses.py and loss_util.py:5-95).

Every loss is a function of (pred, target[, weight]) returning a scalar
(or the elementwise map for reduction='none'), differentiable through
autograd. Axes are the reference's NCHW ones: ``l1_loss_channel`` slices
axis 1, ``psnr_loss``'s Y conversion contracts axis 1, and the weighted
mean counts channels on axis 1 of the weight (loss_util.py:44-50).

Carried over from the reference, on purpose:
  * the "shadow" terms binarize pred and target at 0.1 with a hard
    ``where``: they carry no gradient and shape the loss value only.
  * L1LossForVideoFrames 'mix' draws mean-vs-max per call (p(mean) = 0.64);
    the reference overwrites its reduction on the first call
    (losses.py:443-447). Here each call draws from an explicit generator.

``l2_dice`` is the paper's L2-Dice teacher variant: the L1-Shadow term
weighting with MSE and a Dice structure term; ``soft`` relaxes the
binarization with a sigmoid so the Dice term carries gradient.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

Tensor = torch.Tensor
BINARY_THRESH = 0.1  # reference binarization threshold (losses.py:186)
MIX_P_MEAN = 0.64  # 'mix': probability of the mean reduction


# ------------------------------------------------------------- reductions --

def _weight_reduce(loss: Tensor, weight: Tensor | None, reduction: str) -> Tensor:
    """loss_util.weight_reduce_loss:25-54, with the weighted mean taken
    over the weight's region (channels counted on axis 1)."""
    if weight is not None:
        loss = loss * weight
    if weight is None or reduction == "sum":
        if reduction == "none":
            return loss
        return loss.mean() if reduction == "mean" else loss.sum()
    if reduction == "mean":
        if weight.shape[1] > 1:
            denom = weight.sum()
        else:
            denom = weight.sum() * loss.shape[1]
        return loss.sum() / denom
    return loss  # 'none'


def _spatial_max_reduce(loss: Tensor) -> Tensor:
    """'max' reduction (losses.py:482-487): mean over H, W, max over
    frames, mean over the batch."""
    return loss.mean(dim=(2, 3)).amax(dim=1).mean()


def _binarize(x: Tensor, thresh: float = BINARY_THRESH) -> Tensor:
    return (x > thresh).to(x.dtype)


# ----------------------------------------------------------- basic losses --

def l1_loss(pred: Tensor, target: Tensor, weight: Tensor | None = None,
            reduction: str = "mean", loss_weight: float = 1.0) -> Tensor:
    return loss_weight * _weight_reduce((pred - target).abs(), weight, reduction)


def mse_loss(pred: Tensor, target: Tensor, weight: Tensor | None = None,
             reduction: str = "mean", loss_weight: float = 1.0) -> Tensor:
    return loss_weight * _weight_reduce((pred - target).square(), weight,
                                        reduction)


def charbonnier_loss(pred: Tensor, target: Tensor, eps: float = 1e-3,
                     **_: Any) -> Tensor:
    """losses.py:585-596 (loss_weight and reduction are accepted and
    ignored there, and here)."""
    diff = pred - target
    return torch.sqrt(diff * diff + eps * eps).mean()


_Y_COEF = (65.481, 128.553, 24.966)


def psnr_loss(pred: Tensor, target: Tensor, loss_weight: float = 1.0,
              to_y: bool = False, **_: Any) -> Tensor:
    """losses.py:558-583: w * (10 / ln 10) * mean(log(mse + 1e-8)) over the
    batch; minimising it maximises PSNR."""
    if to_y:
        coef = torch.tensor(_Y_COEF, dtype=pred.dtype,
                            device=pred.device).reshape(1, 3, 1, 1)
        pred = ((pred * coef).sum(1, keepdim=True) + 16.0) / 255.0
        target = ((target * coef).sum(1, keepdim=True) + 16.0) / 255.0
    scale = 10.0 / math.log(10.0)
    mse = (pred - target).square().mean(dim=tuple(range(1, pred.ndim)))
    return loss_weight * scale * torch.log(mse + 1e-8).mean()


# ---------------------------------------------------------- sonar losses --

def l1_loss_sonar(pred: Tensor, target: Tensor, weight: Tensor | None = None,
                  reduction: str = "mean", loss_weight: float = 1.0,
                  binary: float = BINARY_THRESH) -> Tensor:
    """losses.py:25-65: L1 plus L1 of the maps binarized at ``binary``; the
    weight applies to the L1 term only, as in the reference."""
    shadow = _weight_reduce(
        (_binarize(pred, binary) - _binarize(target, binary)).abs(), None,
        reduction)
    main = _weight_reduce((pred - target).abs(), weight, reduction)
    return loss_weight * (shadow + main)


def l1_loss_channel(pred: Tensor, target: Tensor, weight: Tensor | None = None,
                    reduction: str = "mean", loss_weight: float = 1.0,
                    channel: int | None = None) -> Tensor:
    """losses.py:67-103: L1 on one channel (axis 1) or all."""
    if channel is not None:
        pred = pred[:, channel:channel + 1]
        target = target[:, channel:channel + 1]
        if weight is not None:
            weight = weight[:, channel:channel + 1]
    return loss_weight * _weight_reduce((pred - target).abs(), weight, reduction)


def _shadow(pred: Tensor, target: Tensor, weight: Tensor | None,
            reduction: str, loss_weight: float) -> Tensor:
    return loss_weight * _weight_reduce(
        (_binarize(pred) - _binarize(target)).abs(), weight, reduction)


def l1_loss_sr(pred: dict, target: dict, weight: Tensor | None = None,
               reduction: str = "mean", loss_weight: float = 1.0) -> Tensor:
    """The teacher's L1-Shadow loss (losses.py:135-194, KDLAET.yml):
    0.5 L1(hq) + 0.25 L1(sr) + 0.25 (shadow(hq) + shadow(sr)); a missing
    ``sr`` drops its terms. pred and target are {'hq', 'sr'} dicts."""
    hl_shadow = _shadow(pred["hq"], target["hq"], weight, reduction, loss_weight)
    hl = loss_weight * _weight_reduce((pred["hq"] - target["hq"]).abs(),
                                      weight, reduction)
    if pred.get("sr") is not None:
        sr_shadow = _shadow(pred["sr"], target["sr"], weight, reduction,
                            loss_weight)
        sr = loss_weight * _weight_reduce((pred["sr"] - target["sr"]).abs(),
                                          weight, reduction)
    else:
        sr_shadow = sr = 0.0
    return 0.5 * hl + 0.25 * sr + 0.25 * (hl_shadow + sr_shadow)


def _dice(pred_bin: Tensor, target_bin: Tensor, eps: float = 1e-6) -> Tensor:
    inter = (pred_bin * target_bin).sum()
    return 1.0 - (2.0 * inter + eps) / (pred_bin.sum() + target_bin.sum() + eps)


def l2_dice(pred: dict, target: dict, weight: Tensor | None = None,
            reduction: str = "mean", loss_weight: float = 1.0,
            soft: bool = False, sharpness: float = 50.0) -> Tensor:
    """L2-Dice: 0.5 MSE(hq) + 0.25 MSE(sr) + 0.25 (Dice(hq) + Dice(sr))."""

    def binz(x):
        if soft:
            return torch.sigmoid((x - BINARY_THRESH) * sharpness)
        return _binarize(x)

    hq_mse = loss_weight * _weight_reduce(
        (pred["hq"] - target["hq"]).square(), weight, reduction)
    hq_dice = loss_weight * _dice(binz(pred["hq"]), binz(target["hq"]))
    if pred.get("sr") is not None:
        sr_mse = loss_weight * _weight_reduce(
            (pred["sr"] - target["sr"]).square(), weight, reduction)
        sr_dice = loss_weight * _dice(binz(pred["sr"]), binz(target["sr"]))
    else:
        sr_mse = sr_dice = 0.0
    return 0.5 * hq_mse + 0.25 * sr_mse + 0.25 * (hq_dice + sr_dice)


def l1_loss_weight(pred: Tensor, target: Tensor, weight: Tensor | None = None,
                   reduction: str = "mean", loss_weight: float = 1.0,
                   sigma: float = 2.0, w_range=(1.5, 1.0),
                   invert: bool = False) -> Tensor:
    """Gaussian channel- (frame-) weighted L1 (losses.py:196-277), the
    frames on axis 1."""
    loss = (pred - target).abs()
    c = pred.shape[1]
    pos = torch.arange(c, dtype=pred.dtype, device=pred.device)
    g = torch.exp(-0.5 * ((pos - (c - 1) / 2.0) / sigma) ** 2)
    if invert:
        g = 1 - g
    max_w, min_w = w_range
    g = min_w + (max_w - min_w) * (g - g.min()) / (g.max() - g.min())
    loss = loss * g.reshape(1, c, 1, 1)
    if weight is not None:
        loss = loss * weight
    if reduction == "mean":
        return loss_weight * loss.mean()
    if reduction == "sum":
        return loss_weight * loss.sum()
    if reduction == "max":
        return loss_weight * _spatial_max_reduce(loss)
    return loss_weight * loss


def mix_reduction(u: float) -> str:
    """The reduction one uniform draw ``u`` in [0, 1) picks under 'mix'."""
    return "mean" if u < MIX_P_MEAN else "max"


def l1_loss_video_frames(pred: Tensor, target: Tensor,
                         weight: Tensor | None = None,
                         reduction: str = "mean",
                         l1loss_weight: float = 0.64,
                         temporal_weight: float = 0.36,
                         binary: float = BINARY_THRESH,
                         rng: np.random.Generator | None = None,
                         **_: Any) -> Tensor:
    """The student loss (losses.py:409-526): (N, F, H, W) frame stacks,
    per-frame |d| + |bin - bin| plus the temporal term |dpred - dtarget|
    between adjacent frames. 'mix' picks mean or max per call from one
    draw of ``rng``."""
    if reduction == "mix":
        if rng is None:
            raise ValueError("reduction='mix' needs a generator (rng=...)")
        reduction = mix_reduction(float(rng.random()))

    per_frame = (pred - target).abs() + (
        _binarize(pred, binary) - _binarize(target, binary)).abs()
    if weight is not None:
        per_frame = per_frame * weight

    def reduce(x):
        if reduction == "mean":
            return x.mean()
        if reduction == "sum":
            return x.sum()
        if reduction == "max":
            return _spatial_max_reduce(x)
        return x

    if pred.shape[1] > 1:
        d_pred = pred[:, 1:] - pred[:, :-1]
        d_target = target[:, 1:] - target[:, :-1]
        temporal = reduce((d_pred - d_target).abs())
        return l1loss_weight * reduce(per_frame) + temporal_weight * temporal
    return l1loss_weight * reduce(per_frame)
