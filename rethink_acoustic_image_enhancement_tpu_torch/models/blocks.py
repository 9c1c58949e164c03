"""KDLAE building blocks as NCHW ``nn.Module``s.

Attribute names are the reference torch names (KDLAE/KDLAE_model.py:32-200),
so a reference-layout state dict loads with ``strict=True``.

Every layer computes in ``torch.promote_types(input, weight)``, as the flax
modules do with ``dtype=None``: float32 weights take a bfloat16 input to
float32, and bfloat16 weights compute in bfloat16 only with a bfloat16
input. The weights' dtype is thus the model's compute dtype.

``dwconv_shift`` (the JAX package's flag of the same name, which
``train.model_shard`` sets) runs both depthwise 3x3 convs of a block as
``DepthwiseConv3x3``: nine shifted multiply-adds with the grouped conv's
parameter. ``set_dwconv_shift`` turns it on in a built model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import stage_gate
from ..ops.attention import mdta_core
from ..ops.block import fused_transformer_block
from ..ops.norm import channel_layernorm


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the promoted dtype of its input and its weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class DepthwiseConv3x3(Conv2d):
    """A 3x3 depthwise conv as nine shifted multiply-adds (the JAX
    package's ``models/blocks.py::DepthwiseConv3x3``): zero-pad 1, then
    ``sum over (di, dj) of x[.., di:di+H, dj:dj+W] * weight[:, 0, di, dj]``
    added in that order, ``di`` outer, then the bias. Its parameter is the
    grouped conv's ``weight`` (C, 1, 3, 3) (and ``bias`` (C,)), so a state
    dict and ``flax_block_tree`` read it as they read the grouped conv."""

    def __init__(self, channels: int, bias: bool = False, device=None, dtype=None):
        super().__init__(channels, channels, 3, padding=1, groups=channels, bias=bias,
                         device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        h, w = x.shape[-2:]
        xp = F.pad(x.to(dtype), (1, 1, 1, 1))
        k = self.weight.to(dtype)
        acc = None
        for di in range(3):
            for dj in range(3):
                t = xp[..., di:di + h, dj:dj + w] * k[:, 0, di, dj, None, None]
                acc = t if acc is None else acc + t
        if self.bias is not None:
            acc = acc + self.bias.to(dtype)[:, None, None]
        return acc


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
        self.qkv = Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = Conv2d(dim * 3, dim * 3, 3, padding=1,
                                 groups=dim * 3, bias=bias)
        self.project_out = Conv2d(dim, dim, 1, bias=bias)

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
        self.project_in = Conv2d(dim, hidden * 2, 1, bias=bias)
        self.dwconv = Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                             groups=hidden * 2, bias=bias)
        self.project_out = Conv2d(hidden, dim, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    """Pre-norm residual LN->MDTA, LN->GDFN (KDLAE_model.py:150-163).

    With ``fused`` set, a call the block gate admits
    (``stage_gate.mega_worthwhile``: batch 1, bias-free convs, at least
    256x256 pixels, ...) runs as one ``fused_transformer_block`` on NHWC
    with the module's own weights; any other runs the composition below."""

    def __init__(self, dim: int, num_heads: int,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 bias_free_ln: bool = False, fused: bool = False):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim, bias_free_ln)
        self.attn = MDTA(dim, num_heads, bias)
        self.norm2 = ChannelLayerNorm(dim, bias_free_ln)
        self.ffn = GDFN(dim, ffn_expansion_factor, bias)
        self.dim = dim
        self.num_heads = num_heads
        self.ffn_expansion_factor = ffn_expansion_factor
        self.use_bias = bias
        self.bias_free_ln = bias_free_ln
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        if self.fused and stage_gate.mega_worthwhile(
                b, h, w, self.dim, self.num_heads, self.bias_free_ln,
                self.use_bias, self.ffn_expansion_factor):
            p = flax_block_tree(self)
            y = fused_transformer_block(
                x.permute(0, 2, 3, 1).contiguous(),
                p["norm1"]["weight"], p["norm1"].get("bias"),
                p["attn"]["qkv"]["kernel"], p["attn"]["qkv_dwconv"]["kernel"],
                p["attn"]["temperature"], p["attn"]["project_out"]["kernel"],
                p["norm2"]["weight"], p["norm2"].get("bias"),
                p["ffn"]["project_in"]["kernel"], p["ffn"]["dwconv"]["kernel"],
                p["ffn"]["project_out"]["kernel"],
                bias_free=self.bias_free_ln, num_heads=self.num_heads)
            return y.permute(0, 3, 1, 2).contiguous()
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


def set_dwconv_shift(model: nn.Module) -> nn.Module:
    """In place: every depthwise conv of ``model``'s MDTAs and GDFNs becomes
    the shift-add form, holding the same parameters, and ``model`` sets its
    ``dwconv_shift`` flag (the counterpart of the JAX package's
    ``model.clone(dwconv_shift=True)``). Returns ``model``."""
    for m in list(model.modules()):
        name = "qkv_dwconv" if isinstance(m, MDTA) else "dwconv" if isinstance(m, GDFN) else None
        if name is not None:
            conv = getattr(m, name)
            new = DepthwiseConv3x3(conv.out_channels, conv.bias is not None,
                                   device=conv.weight.device, dtype=conv.weight.dtype)
            new.weight = conv.weight
            if conv.bias is not None:
                new.bias = conv.bias
            setattr(m, name, new)
    model.dwconv_shift = True
    return model


def flax_block_tree(blk: TransformerBlock) -> dict:
    """One block's weights in the flax layouts the block and stage kernels
    take (conv (O, I, kh, kw) -> (kh, kw, I, O)); a WithBias LayerNorm adds
    its 'bias'."""

    def hwio(conv):
        return conv.weight.permute(2, 3, 1, 0)

    def norm(ln):
        tree = {"weight": ln.body.weight}
        if ln.body.bias is not None:
            tree["bias"] = ln.body.bias
        return tree

    return {
        "norm1": norm(blk.norm1),
        "attn": {"qkv": {"kernel": hwio(blk.attn.qkv)},
                 "qkv_dwconv": {"kernel": hwio(blk.attn.qkv_dwconv)},
                 "temperature": blk.attn.temperature,
                 "project_out": {"kernel": hwio(blk.attn.project_out)}},
        "norm2": norm(blk.norm2),
        "ffn": {"project_in": {"kernel": hwio(blk.ffn.project_in)},
                "dwconv": {"kernel": hwio(blk.ffn.dwconv)},
                "project_out": {"kernel": hwio(blk.ffn.project_out)}},
    }


class OverlapPatchEmbed(nn.Module):
    """3x3 conv patch embed (KDLAE_model.py:169-178)."""

    def __init__(self, in_c: int = 3, embed_dim: int = 48, bias: bool = False):
        super().__init__()
        self.proj = Conv2d(in_c, embed_dim, 3, padding=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Downsample(nn.Module):
    """3x3 conv C->C/2 then PixelUnshuffle(2) (KDLAE_model.py:182-190).

    ``fused`` folds the unshuffle into the conv: one stride-2 4x4 conv whose
    kernel holds the 3x3 weights at the four phases (out channel f*4 + i*2
    + j takes the taps shifted by (i, j)). Same parameter, same taps."""

    def __init__(self, n_feat: int, fused: bool = False):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False),
            nn.PixelUnshuffle(2))
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return self.body(x)
        dtype = torch.promote_types(x.dtype, self.body[0].weight.dtype)
        return F.conv2d(x.to(dtype), self.folded_weight().to(dtype),
                        stride=2, padding=1)

    def folded_weight(self) -> torch.Tensor:
        """The stride-2 4x4 kernel (4F, C, 4, 4) of the ``fused`` form."""
        w3 = self.body[0].weight  # (F, C, 3, 3)
        f, c = w3.shape[:2]
        w4 = torch.stack([F.pad(w3, (j, 1 - j, i, 1 - i))
                          for i in (0, 1) for j in (0, 1)], dim=1)
        return w4.reshape(f * 4, c, 4, 4)


class Upsample(nn.Module):
    """3x3 conv C->2C then PixelShuffle(2) (KDLAE_model.py:192-200).

    ``fused`` folds the shuffle into the conv: the sub-pixel conv is one
    stride-2 transposed 6x6 conv (padding 2) whose tap (4 - 2*dy + i,
    4 - 2*dx + j) holds the 3x3 weight (dy, dx) of output phase (i, j).
    Same parameter, same taps."""

    def __init__(self, n_feat: int, fused: bool = False):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False),
            nn.PixelShuffle(2))
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return self.body(x)
        dtype = torch.promote_types(x.dtype, self.body[0].weight.dtype)
        return F.conv_transpose2d(x.to(dtype), self.folded_weight().to(dtype),
                                  stride=2, padding=2)

    def folded_weight(self) -> torch.Tensor:
        """The stride-2 transposed 6x6 kernel (C, F, 6, 6) of the ``fused``
        form."""
        w3 = self.body[0].weight  # (4F, C, 3, 3), out channel f*4 + i*2 + j
        c = w3.shape[1]
        f = w3.shape[0] // 4
        # [f, i, j, c, 2 - dy, 2 - dx] -> [c, f, (2 - dy, i), (2 - dx, j)]
        w6 = w3.reshape(f, 2, 2, c, 3, 3).flip(4, 5).permute(3, 0, 4, 1, 5, 2)
        return w6.reshape(c, f, 6, 6)
