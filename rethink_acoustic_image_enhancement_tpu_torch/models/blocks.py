"""KDLAE building blocks as NCHW ``nn.Module``s.

Attribute names are the reference torch names (KDLAE/KDLAE_model.py:32-200),
so a reference-layout state dict loads with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mdta_core
from ..ops.norm import channel_layernorm


class _LayerNormBody(nn.Module):
    """BiasFree_LayerNorm / WithBias_LayerNorm's parameters."""

    def __init__(self, dim: int, bias_free: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = None if bias_free else nn.Parameter(torch.zeros(dim))


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of NCHW x (KDLAE_model.py:32-83)."""

    def __init__(self, dim: int, bias_free: bool = False):
        super().__init__()
        self.body = _LayerNormBody(dim, bias_free)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_layernorm(x, self.body.weight, self.body.bias, dim=1)


class MDTA(nn.Module):
    """Multi-DConv-head transposed attention (KDLAE_model.py:112-145)."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)

        def heads(t):
            return t.reshape(b, self.num_heads, c // self.num_heads, h * w)

        out = mdta_core(heads(q), heads(k), heads(v), self.temperature)
        return self.project_out(out.reshape(b, c, h, w))


class GDFN(nn.Module):
    """Gated-Dconv feed-forward network with exact-erf GELU
    (KDLAE_model.py:89-106)."""

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.66,
                 bias: bool = False):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=bias)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                groups=hidden * 2, bias=bias)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    """Pre-norm residual LN->MDTA, LN->GDFN (KDLAE_model.py:150-163)."""

    def __init__(self, dim: int, num_heads: int,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 bias_free_ln: bool = False):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim, bias_free_ln)
        self.attn = MDTA(dim, num_heads, bias)
        self.norm2 = ChannelLayerNorm(dim, bias_free_ln)
        self.ffn = GDFN(dim, ffn_expansion_factor, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    """3x3 conv patch embed (KDLAE_model.py:169-178)."""

    def __init__(self, in_c: int = 3, embed_dim: int = 48, bias: bool = False):
        super().__init__()
        self.proj = nn.Conv2d(in_c, embed_dim, 3, padding=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Downsample(nn.Module):
    """3x3 conv C->C/2 then PixelUnshuffle(2) (KDLAE_model.py:182-190)."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False),
            nn.PixelUnshuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class Upsample(nn.Module):
    """3x3 conv C->2C then PixelShuffle(2) (KDLAE_model.py:192-200)."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False),
            nn.PixelShuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)
