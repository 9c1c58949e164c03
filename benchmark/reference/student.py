"""KDLAE-S, the student, in plain PyTorch float32 from its published
description (KDLAE/KDLAE_model.py:340-430): a 3-D convolutional U-Net over
(B, F, H, W) frame stacks, 3x3x3 convolutions with ReLU in pairs, spatial
(1, 2, 2) max pooling, (1, 2, 2) transposed convolutions, additive skips, a
1x1x1 output convolution and, with ``residual``, the input added back."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import Ops


def param_shapes(net: dict) -> dict[str, tuple[int, ...]]:
    hid = list(net["hidden_channels"])
    k = net.get("kernel_size", 3)
    cin, cout = net["inp_channels"], net["out_channels"]
    levels = len(hid) - 1
    s: dict[str, tuple[int, ...]] = {}

    def block(name, i, o):
        s[f"{name}.0.weight"], s[f"{name}.0.bias"] = (o, i, k, k, k), (o,)
        s[f"{name}.2.weight"], s[f"{name}.2.bias"] = (o, o, k, k, k), (o,)

    for i in range(levels):
        block(f"encoders.{i}", cin if i == 0 else hid[i - 1], hid[i])
    block("st_fusion", hid[levels - 1], hid[-1])
    for j, i in enumerate(range(levels - 1, -1, -1)):
        s[f"upconv_layers.{j}.weight"] = (hid[i + 1], hid[i], 1, 2, 2)
        s[f"upconv_layers.{j}.bias"] = (hid[i],)
    for j, i in enumerate(range(levels - 1, -1, -1)):
        block(f"decoders.{j}", hid[i], hid[i])
    s["out_conv.weight"], s["out_conv.bias"] = (cout, hid[0], 1, 1, 1), (cout,)
    return s


def fan_in(name: str, shape: tuple[int, ...]) -> int:
    """Input channels times the kernel's volume (a transposed convolution
    holds its input channels first)."""
    ins = shape[0] if name.startswith("upconv_layers") else shape[1]
    return ins * math.prod(shape[2:])


def forward(p: dict, net: dict, x: torch.Tensor, ops: Ops | None = None) -> torch.Tensor:
    """(B, F, H, W) float32 -> (B, F, H, W); H and W multiples of
    2 ** (levels - 1)."""
    ops = ops or Ops()
    levels = len(net["hidden_channels"]) - 1
    pad = net.get("kernel_size", 3) // 2

    def block(name, t):
        t = F.relu(ops.conv3d(t, p[f"{name}.0.weight"], p[f"{name}.0.bias"], pad))
        return F.relu(ops.conv3d(t, p[f"{name}.2.weight"], p[f"{name}.2.bias"], pad))

    t_in = x[:, None]
    t, skips = t_in, []
    for i in range(levels):
        t = block(f"encoders.{i}", t)
        skips.append(t)
        t = F.max_pool3d(t, (1, 2, 2))
    t = block("st_fusion", t)
    for j, skip in enumerate(reversed(skips)):
        t = ops.conv_transpose3d(t, p[f"upconv_layers.{j}.weight"],
                                 p[f"upconv_layers.{j}.bias"], (1, 2, 2))
        t = block(f"decoders.{j}", t + skip)
    out = ops.conv3d(t, p["out_conv.weight"], p["out_conv.bias"])
    if net.get("residual", False):
        out = out + t_in
    return out[:, 0]
