"""KDLAE-T teacher (reference KDLAE/KDLAE_model.py:204-336): a 4-level
conv-attention U-Net with denoise-rate conditioning and a 2x
super-resolution head, NCHW, with the reference torch attribute names.

``params`` is 'cat' (denoise-rate conditioning) or 'none'; the reference
ctor advertises 'plus'/'mul' but its forward implements only 'cat'.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import stage_gate
from ..ops.stage import fused_transformer_stage, stack_block_params
from .blocks import Downsample, OverlapPatchEmbed, TransformerBlock, Upsample


def _flax_block_tree(blk: TransformerBlock) -> dict:
    """One block's weights in the flax layouts the stage takes
    (conv (O, I, kh, kw) -> (kh, kw, I, O))."""

    def hwio(conv):
        return conv.weight.permute(2, 3, 1, 0)

    return {
        "norm1": {"weight": blk.norm1.body.weight},
        "attn": {"qkv": {"kernel": hwio(blk.attn.qkv)},
                 "qkv_dwconv": {"kernel": hwio(blk.attn.qkv_dwconv)},
                 "temperature": blk.attn.temperature,
                 "project_out": {"kernel": hwio(blk.attn.project_out)}},
        "norm2": {"weight": blk.norm2.body.weight},
        "ffn": {"project_in": {"kernel": hwio(blk.ffn.project_in)},
                "dwconv": {"kernel": hwio(blk.ffn.dwconv)},
                "project_out": {"kernel": hwio(blk.ffn.project_out)}},
    }


class TransformerStage(nn.Sequential):
    """A sequence of TransformerBlocks (the reference's nn.Sequential).

    With ``fused`` set, a stage the gate admits runs as one call of
    ``fused_transformer_stage`` on NHWC (one layout change in, one out)."""

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
            stacked = stack_block_params([_flax_block_tree(blk)
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
                 params: str = "cat", fused: bool = False):
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

        self.patch_embed = OverlapPatchEmbed(inp_channels, d, b)
        self.encoder_level1 = stage(d, heads[0], num_blocks[0])
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stage(d * 2, heads[1], num_blocks[1])
        self.down2_3 = Downsample(d * 2)
        self.encoder_level3 = stage(d * 4, heads[2], num_blocks[2])
        self.down3_4 = Downsample(d * 4)
        self.latent = stage(d * 8, heads[3], num_blocks[3])

        self.up4_3 = Upsample(d * 8)
        self.reduce_chan_level3 = nn.Conv2d(d * 8, d * 4, 1, bias=b)
        self.decoder_level3 = stage(d * 4, heads[2], num_blocks[2])
        self.up3_2 = Upsample(d * 4)
        self.reduce_chan_level2 = nn.Conv2d(d * 4, d * 2, 1, bias=b)
        self.decoder_level2 = stage(d * 2, heads[1], num_blocks[1])
        self.up2_1 = Upsample(d * 2)
        # level-1 decoder runs at 2*dim: skip concat, no channel reduce
        self.decoder_level1 = stage(d * 2, heads[0], num_blocks[0])
        self.refinement = stage(d * 2, heads[0], num_refinement_blocks)

        if dual_pixel_task:
            self.skip_conv = nn.Conv2d(d, d * 2, 1, bias=b)
        self.output = nn.Conv2d(d * 2, out_channels, 3, padding=1, bias=b)
        if params == "cat":
            # dilated 3x3 conv over (out + denoise_rate) channels
            self.output_param = nn.Conv2d(out_channels + 1, d * 2, 3,
                                          padding=2, dilation=2, bias=b)
            self.refinement_out = stage(d * 2, heads[0], num_refinement_blocks)
            self.output2 = nn.Conv2d(d * 2, out_channels, 3, padding=1, bias=b)
        if static == "train":
            hc = d * 2
            self.cen = nn.Conv2d(out_channels, hc, 3, padding=1, bias=b)
            self.upen = Upsample(hc)
            self.enhance = stage(hc // 2, heads[0], num_refinement_blocks)
            self.outputen = nn.Conv2d(hc // 2, out_channels, 3, padding=1,
                                      bias=b)

    def set_fused(self, fused: bool) -> "KDLAETeacher":
        """Route gate-admitted stages through the stage kernel (or not)."""
        for m in self.modules():
            if isinstance(m, TransformerStage):
                m.fused = fused
        return self

    def forward(self, inputs: dict) -> dict:
        inp_img = inputs["img"]
        x1 = self.patch_embed(inp_img)
        e1 = self.encoder_level1(x1)
        e2 = self.encoder_level2(self.down1_2(e1))
        e3 = self.encoder_level3(self.down2_3(e2))
        latent = self.latent(self.down3_4(e3))

        d3 = self.reduce_chan_level3(torch.cat([self.up4_3(latent), e3], 1))
        d3 = self.decoder_level3(d3)
        d2 = self.reduce_chan_level2(torch.cat([self.up3_2(d3), e2], 1))
        d2 = self.decoder_level2(d2)
        d1 = self.decoder_level1(torch.cat([self.up2_1(d2), e1], 1))
        d1 = self.refinement(d1)

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
