"""KDLAE-S student (reference KDLAE/KDLAE_model.py:340-430): a light 3-D
conv U-Net over temporal frame stacks, NCDHW with depth = frames.

A stack (B, N, H, W) gets a channel axis and runs through 3x3x3 convs;
pooling and upsampling are spatial only (kernel (1, 2, 2)), skips are
additive, and ``residual`` adds the input to the output. The JAX package's
``ConvTranspose3dS2`` (a learned pixel shuffle) is the reference's own
``nn.ConvTranspose3d(kernel=stride=(1, 2, 2))``. Attribute names are the
reference's, so ``convert/weights.py::student_state_dict`` (and a ``.pth``
from ``torch_export.export_student``) loads with ``strict=True``.

The parameters stay float32 whatever the input: like the flax module
(``dtype=None``), a bfloat16 stack is promoted to float32 at the first conv.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class ConvTranspose3dS2(nn.ConvTranspose3d):
    """kernel = stride = (1, 2, 2): out[b, o, d, 2h+p, 2w+q] =
    sum_i x[b, i, d, h, w] * W[i, o, 0, p, q] + bias[o]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=(1, 2, 2),
                         stride=(1, 2, 2))


class ConvBlock3d(nn.Sequential):
    """[Conv3d k^3 + ReLU] x 2 (reference _create_conv_block,
    KDLAE/KDLAE_model.py:386-393); parameters at indices 0 and 2."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        p = kernel_size // 2
        super().__init__(
            nn.Conv3d(in_channels, features, kernel_size, padding=p), nn.ReLU(),
            nn.Conv3d(features, features, kernel_size, padding=p), nn.ReLU())


class KDLAEStudent(nn.Module):
    """Input (B, N, H, W), H and W multiples of 2**(len(hidden_channels)-1);
    output (B, N, H, W) in float32."""

    def __init__(self, inp_channels: int = 1, out_channels: int = 1,
                 residual: bool = False,
                 hidden_channels: Sequence[int] = (16, 32, 64),
                 kernel_size: int = 3):
        super().__init__()
        hidden = tuple(hidden_channels)
        self.num_levels = len(hidden) - 1
        self.residual = residual
        self.encoders = nn.ModuleList(
            ConvBlock3d(inp_channels if i == 0 else hidden[i - 1], hidden[i],
                        kernel_size) for i in range(self.num_levels))
        self.pool = nn.MaxPool3d((1, 2, 2))
        self.st_fusion = ConvBlock3d(hidden[self.num_levels - 1], hidden[-1],
                                     kernel_size)
        levels = range(self.num_levels - 1, -1, -1)
        self.upconv_layers = nn.ModuleList(
            ConvTranspose3dS2(hidden[i + 1], hidden[i]) for i in levels)
        self.decoders = nn.ModuleList(
            ConvBlock3d(hidden[i], hidden[i], kernel_size) for i in levels)
        self.out_conv = nn.Conv3d(hidden[0], out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, N, H, W) -> (B, 1, N, H, W), promoted to the parameters' dtype
        dtype = torch.promote_types(x.dtype, self.out_conv.weight.dtype)
        x_in = x.unsqueeze(1).to(dtype)
        current, skips = x_in, []
        for enc in self.encoders:
            current = enc(current)
            skips.append(current)
            current = self.pool(current)
        current = self.st_fusion(current)
        for up, dec, skip in zip(self.upconv_layers, self.decoders,
                                 reversed(skips)):
            current = dec(up(current) + skip)
        out = self.out_conv(current)
        if self.residual:
            out = out + x_in
        return out[:, 0]
