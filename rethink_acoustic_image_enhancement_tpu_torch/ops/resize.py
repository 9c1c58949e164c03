"""Resize and pooling ops of the ASDQE scorer, on NCHW.

``resize_bilinear_align_corners`` is torch's own ``nn.Upsample(scale_factor=2,
mode='bilinear', align_corners=True)`` (ASDQE/ASDQE_model.py:54), the op the
JAX package rebuilds from two gather + lerp passes; an axis of size 1 is
tiled, as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW x to (out_h, out_w), corner-aligned
    (src = i * (in - 1) / (out - 1))."""
    if x.shape[2] == 1:
        x = x.expand(-1, -1, out_h, -1)
    if x.shape[3] == 1:
        x = x.expand(-1, -1, -1, out_w)
    if tuple(x.shape[2:]) == (out_h, out_w):
        return x.contiguous()
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(2) (ASDQE/ASDQE_model.py:41)."""
    return F.max_pool2d(x, 2)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, 1)) + Flatten: (B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))
