"""Per-frame temporal and positional embeddings
(Train/basicsr/models/archs/restormer_arch.py:167-364:
OverlapPatchTimePoseEmbed and its 'wd' variant, BasicSpy, WDSpybottle).
No shipped config uses them; they are the temporal-encoding direction the
student experiments explored.

NCHW modules with the JAX package's parameter names: each frame shares
one single-channel 5x5 ``proj`` conv and has its own learned position map
``pos_embed_<i>`` (E, h, w) and time code ``time_embed_<i>`` (E,), both
initialised with the reference's sinusoids; a 3x3 ``reconstruct`` merges
the frames.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear_align_corners


def sinusoidal_position_encoding(h: int, w: int, embed_dim: int,
                                 variant: str = "default") -> np.ndarray:
    """2-D sinusoidal position map (restormer_arch.py:189-198 / 313-321),
    (h, w, embed_dim)."""
    pos = np.zeros((h, w, embed_dim), np.float32)
    ys = np.linspace(0, h - 1, h)[:, None]
    xs = np.linspace(0, w - 1, w)[None, :]
    for i in range(embed_dim):
        if variant == "default":
            div1 = 1000 ** (2 * (i // 2) / embed_dim)
            div2 = 10 ** (2 * (i // 2 + 1) / embed_dim)
            if i % 2 == 0:
                pos[..., i] = 0.5 * (np.sin(ys / div1) + np.sin(xs / div2))
            else:
                pos[..., i] = 0.5 * (np.cos(ys / div2) + np.cos(xs / div1))
        else:  # 'wd': one divisor, no 0.5
            div = 100 ** (2 * (i // 2) / embed_dim)
            if i % 2 == 0:
                pos[..., i] = np.sin(ys / div) + np.sin(xs / div)
            else:
                pos[..., i] = np.cos(ys / div) + np.cos(xs / div)
    return pos


def sinusoidal_time_encoding(seq_pos: int, embed_dim: int,
                             scale: float = 1.0) -> np.ndarray:
    """One frame's time code (restormer_arch.py:201-210), (embed_dim,)."""
    t = np.zeros((embed_dim,), np.float32)
    for i in range(embed_dim):
        div = 100 ** (2 * (i // 2) / embed_dim)
        t[i] = (np.sin((seq_pos - 1) / div) if i % 2 == 0
                else np.cos((seq_pos - 1) / div)) * scale
    return t


class OverlapPatchTimePoseEmbed(nn.Module):
    """Frame stack (B, F, H, W) -> (B, out_dim, H, W): per frame the shared
    5x5 embed plus its position map (bilinearly resized, corners aligned,
    where (H, W) is not ``base_size``) and its time code, then a 3x3
    reconstruct over the concatenated frames."""

    def __init__(self, in_frames: int = 3, embed_dim: int = 48,
                 out_dim: int = 48, use_bias: bool = False,
                 base_size: Sequence[int] = (128, 128),
                 variant: str = "default"):
        super().__init__()
        self.in_frames = in_frames
        self.base_size = tuple(base_size)
        time_scale = 2.0 if variant == "wd" else 1.0
        pos = torch.from_numpy(sinusoidal_position_encoding(
            base_size[0], base_size[1], embed_dim, variant)).permute(2, 0, 1)
        for i in range(in_frames):
            self.register_parameter(f"pos_embed_{i}", nn.Parameter(pos.clone()))
            self.register_parameter(f"time_embed_{i}", nn.Parameter(
                torch.from_numpy(sinusoidal_time_encoding(1 + i, embed_dim,
                                                          time_scale))))
        self.proj = nn.Conv2d(1, embed_dim, 5, padding=2, bias=use_bias)
        self.reconstruct = nn.Conv2d(embed_dim * in_frames, out_dim, 3,
                                     padding=1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, f, h, w = x.shape
        if f != self.in_frames:
            raise ValueError(f"{f} frames for an embed of {self.in_frames}")
        chunks = []
        for i in range(f):
            pos = getattr(self, f"pos_embed_{i}")
            if (h, w) != self.base_size:
                pos = resize_bilinear_align_corners(pos[None], h, w)[0]
            time = getattr(self, f"time_embed_{i}")
            chunks.append(self.proj(x[:, i:i + 1]) + pos + time[:, None, None])
        return self.reconstruct(torch.cat(chunks, dim=1))


class BasicSpy(nn.Module):
    """Four 7x7 conv - BatchNorm - ReLU layers (32, 64, 32, out_c), the
    input concatenated back on, a 1x1 reconstruct (restormer_arch.py:
    247-269). BatchNorm uses batch statistics in training mode and the
    running ones in eval mode, as flax's ``train`` argument selects."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        chans = [in_c, 32, 64, 32, out_c]
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(chans[i], chans[i + 1], 7,
                                                  padding=3))
            self.add_module(f"bn{i}", nn.BatchNorm2d(chans[i + 1], eps=1e-5,
                                                     momentum=0.1))
        self.reconstruct = nn.Conv2d(in_c + out_c, out_c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(4):
            y = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y)))
        return self.reconstruct(torch.cat([x, y], dim=1))


class WDSpybottle(nn.Module):
    """Three chained BasicSpy blocks (restormer_arch.py:271-282)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.netBasic1 = BasicSpy(in_dim, in_dim)
        self.netBasic2 = BasicSpy(in_dim, in_dim)
        self.netBasic3 = BasicSpy(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.netBasic3(self.netBasic2(self.netBasic1(x)))
