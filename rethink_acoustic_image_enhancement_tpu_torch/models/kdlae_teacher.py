"""KDLAE-T teacher (reference KDLAE/KDLAE_model.py:204-336): a 4-level
conv-attention U-Net with denoise-rate conditioning and a 2x
super-resolution head, NCHW, with the reference torch attribute names; and
the vanilla ``Restormer`` baseline (restormer_arch.py:471-562) it grew from.

``params`` is 'cat' (denoise-rate conditioning) or 'none'; the reference
ctor advertises 'plus'/'mul' but its forward implements only 'cat'.
``fused_resample`` folds each conv + pixel-(un)shuffle resampler into one
strided or transposed conv (``models/blocks.py``), with the same weights.
The weights' dtype sets the compute dtype (``models/blocks.py``): cast the
model to bfloat16 to compute in bfloat16.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import stage_gate
from ..ops.stage import fused_transformer_stage, stack_block_params
from .blocks import (Conv2d, Downsample, OverlapPatchEmbed, TransformerBlock,
                     Upsample, flax_block_tree)


class TransformerStage(nn.Sequential):
    """A sequence of TransformerBlocks (the reference's nn.Sequential).

    With ``fused`` set, a stage the gate admits runs as one call of
    ``fused_transformer_stage`` on NHWC (one layout change in, one out).
    Its blocks are built with ``fused=False``: no model reaches the
    per-block kernel, which ``TransformerBlock(fused=True)`` alone routes
    to."""

    def __init__(self, dim: int, num_heads: int, num_blocks: int,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 bias_free_ln: bool = False, fused: bool = False):
        super().__init__(*[
            TransformerBlock(dim, num_heads, ffn_expansion_factor, bias,
                             bias_free_ln) for _ in range(num_blocks)])
        self.dim = dim
        self.num_heads = num_heads
        self.ffn_expansion_factor = ffn_expansion_factor
        self.use_bias = bias
        self.bias_free_ln = bias_free_ln
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        if self.fused and stage_gate.stage_worthwhile(
                b, h, w, self.dim, self.num_heads, self.bias_free_ln,
                self.use_bias, self.ffn_expansion_factor):
            stacked = stack_block_params([flax_block_tree(blk)
                                          for blk in self])
            y = fused_transformer_stage(x.permute(0, 2, 3, 1).contiguous(),
                                        **stacked)
            return y.permute(0, 3, 1, 2).contiguous()
        return super().forward(x)


class KDLAETeacher(nn.Module):
    """KDLAE-T. Input {'img': (B, C, H, W) in [0,1], 'denoise_rate':
    (B, 1, H, W)}; output {'hq': (B, C, H, W), 'sr': (B, C, 2H, 2W) or
    None}. H and W must be multiples of 8."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 layernorm_type: str = "WithBias",
                 dual_pixel_task: bool = False, static: str = "train",
                 params: str = "cat", fused: bool = False,
                 fused_resample: bool = False):
        super().__init__()
        if params not in ("cat", "none"):
            raise ValueError(
                f"params={params!r} unsupported: the reference only "
                "implements 'cat' (KDLAE/KDLAE_model.py:315)")
        self.dual_pixel_task = dual_pixel_task
        self.static = static
        self.params = params
        bf = layernorm_type == "BiasFree"
        d, ff, b = dim, ffn_expansion_factor, use_bias

        def stage(ch, nh, nb):
            return TransformerStage(ch, nh, nb, ff, b, bf, fused)

        _build_unet(self, inp_channels, out_channels, d, num_blocks,
                    num_refinement_blocks, heads, b, dual_pixel_task, stage,
                    fused_resample)
        if params == "cat":
            # dilated 3x3 conv over (out + denoise_rate) channels
            self.output_param = Conv2d(out_channels + 1, d * 2, 3,
                                       padding=2, dilation=2, bias=b)
            self.refinement_out = stage(d * 2, heads[0], num_refinement_blocks)
            self.output2 = Conv2d(d * 2, out_channels, 3, padding=1, bias=b)
        if static == "train":
            hc = d * 2
            self.cen = Conv2d(out_channels, hc, 3, padding=1, bias=b)
            self.upen = Upsample(hc, fused_resample)
            self.enhance = stage(hc // 2, heads[0], num_refinement_blocks)
            self.outputen = Conv2d(hc // 2, out_channels, 3, padding=1,
                                   bias=b)

    def set_fused(self, fused: bool) -> "KDLAETeacher":
        """Route gate-admitted stages through the stage kernel (or not)."""
        for m in self.modules():
            if isinstance(m, TransformerStage):
                m.fused = fused
        return self

    def set_fused_resample(self, fused: bool) -> "KDLAETeacher":
        """Fold the resamplers' pixel-(un)shuffle into their convs (or not)."""
        for m in self.modules():
            if isinstance(m, (Downsample, Upsample)):
                m.fused = fused
        return self

    def forward(self, inputs: dict) -> dict:
        inp_img = inputs["img"]
        x1, d1 = _unet(self, inp_img)

        if self.dual_pixel_task:
            out_hq = self.output(d1 + self.skip_conv(x1))
        else:
            out = self.output(d1)
            if self.params == "cat":
                out = torch.cat([out, inputs["denoise_rate"]], 1)
                out = self.output2(self.refinement_out(self.output_param(out)))
            out_hq = out + inp_img

        out_sr = None
        if self.static == "train":
            sr = self.enhance(self.upen(self.cen(out_hq)))
            out_sr = self.outputen(sr)
        return {"hq": out_hq, "sr": out_sr}


# The pre-rename reference class (restormer_arch.py:566-698) is the same
# network; expose it as an alias.
RestormerSuperResolutionParam2 = KDLAETeacher


def _build_unet(m: nn.Module, inp_channels, out_channels, d, num_blocks,
                num_refinement_blocks, heads, b, dual_pixel_task, stage,
                fused_resample) -> None:
    """The encoder / decoder / refinement / output modules that KDLAE-T and
    Restormer share, under the reference's attribute names."""
    fr = fused_resample
    m.patch_embed = OverlapPatchEmbed(inp_channels, d, b)
    m.encoder_level1 = stage(d, heads[0], num_blocks[0])
    m.down1_2 = Downsample(d, fr)
    m.encoder_level2 = stage(d * 2, heads[1], num_blocks[1])
    m.down2_3 = Downsample(d * 2, fr)
    m.encoder_level3 = stage(d * 4, heads[2], num_blocks[2])
    m.down3_4 = Downsample(d * 4, fr)
    m.latent = stage(d * 8, heads[3], num_blocks[3])

    m.up4_3 = Upsample(d * 8, fr)
    m.reduce_chan_level3 = Conv2d(d * 8, d * 4, 1, bias=b)
    m.decoder_level3 = stage(d * 4, heads[2], num_blocks[2])
    m.up3_2 = Upsample(d * 4, fr)
    m.reduce_chan_level2 = Conv2d(d * 4, d * 2, 1, bias=b)
    m.decoder_level2 = stage(d * 2, heads[1], num_blocks[1])
    m.up2_1 = Upsample(d * 2, fr)
    # level-1 decoder runs at 2*dim: skip concat, no channel reduce
    m.decoder_level1 = stage(d * 2, heads[0], num_blocks[0])
    m.refinement = stage(d * 2, heads[0], num_refinement_blocks)

    if dual_pixel_task:
        m.skip_conv = Conv2d(d, d * 2, 1, bias=b)
    m.output = Conv2d(d * 2, out_channels, 3, padding=1, bias=b)


def _unet(m: nn.Module, inp_img: torch.Tensor):
    """(patch embedding, refined level-1 features) of the shared U-Net."""
    x1 = m.patch_embed(inp_img)
    e1 = m.encoder_level1(x1)
    e2 = m.encoder_level2(m.down1_2(e1))
    e3 = m.encoder_level3(m.down2_3(e2))
    latent = m.latent(m.down3_4(e3))

    d3 = m.reduce_chan_level3(torch.cat([m.up4_3(latent), e3], 1))
    d3 = m.decoder_level3(d3)
    d2 = m.reduce_chan_level2(torch.cat([m.up3_2(d3), e2], 1))
    d2 = m.decoder_level2(d2)
    d1 = m.decoder_level1(torch.cat([m.up2_1(d2), e1], 1))
    return x1, m.refinement(d1)


class Restormer(nn.Module):
    """Vanilla Restormer (Train/.../restormer_arch.py:471-562): (B, C, H, W)
    in, (B, C, H, W) out, global residual, no conditioning and no SR head."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, use_bias: bool = False,
                 layernorm_type: str = "WithBias",
                 dual_pixel_task: bool = False, fused_resample: bool = False):
        super().__init__()
        self.dual_pixel_task = dual_pixel_task
        bf = layernorm_type == "BiasFree"

        def stage(ch, nh, nb):
            return TransformerStage(ch, nh, nb, ffn_expansion_factor, use_bias, bf)

        _build_unet(self, inp_channels, out_channels, dim, num_blocks,
                    num_refinement_blocks, heads, use_bias, dual_pixel_task,
                    stage, fused_resample)

    def forward(self, inp_img: torch.Tensor) -> torch.Tensor:
        x1, d1 = _unet(self, inp_img)
        if self.dual_pixel_task:
            return self.output(d1 + self.skip_conv(x1))
        return self.output(d1) + inp_img


_BRANCH_SCALE = 0.1


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: LeCun-normal convolutions (flax's default),
    zero biases, unit LayerNorm weights, temperatures uniform in
    [0.5, 1.5). The residual branches' output convolutions and the 'hq'
    output heads are scaled by 0.1 (the SR head by 0.5), so the
    random network is conditioned like a trained one: hq stays near the
    input and outputs lie mostly in [0, 1]. Plain LeCun weights everywhere
    make a 40-block network whose output moves by whole units when an
    intermediate value changes in its last bf16 bit."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("temperature"):
                p.copy_(0.5 + torch.rand(p.shape, generator=generator))
            elif name.endswith("body.weight") and p.ndim == 1:
                p.fill_(1.0)
            elif p.ndim == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                scale = fan_in ** -0.5
                if name.endswith(("attn.project_out.weight",
                                  "ffn.project_out.weight")) \
                        or name.split(".")[0] in ("output", "output2"):
                    scale *= _BRANCH_SCALE
                elif name.split(".")[0] == "outputen":
                    scale *= 0.5
                p.copy_(torch.randn(p.shape, generator=generator) * scale)
            else:
                p.zero_()
    return model
