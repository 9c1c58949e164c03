"""KDLAE-T, the teacher, in plain PyTorch float32 from its published
equations (Restormer's blocks: channel LayerNorm, MDTA transposed
attention, the gated-Dconv feed-forward; the KDLAE-T U-Net with its
denoise-rate conditioning and 2x super-resolution head), as functions of a
state dict in the reference torch layout (KDLAE/KDLAE_model.py's names).

Bias-free convolutions only (every published KDLAE-T config); LayerNorm
BiasFree or WithBias."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import Ops


def stages(net: dict) -> list[tuple[str, int, int, int]]:
    """(name, channels, heads, blocks) of every Transformer stage, in the
    order a forward runs them."""
    d, nb, hd, nr = (net["dim"], net["num_blocks"], net["heads"],
                     net["num_refinement_blocks"])
    out = [("encoder_level1", d, hd[0], nb[0]), ("encoder_level2", 2 * d, hd[1], nb[1]),
           ("encoder_level3", 4 * d, hd[2], nb[2]), ("latent", 8 * d, hd[3], nb[3]),
           ("decoder_level3", 4 * d, hd[2], nb[2]), ("decoder_level2", 2 * d, hd[1], nb[1]),
           ("decoder_level1", 2 * d, hd[0], nb[0]), ("refinement", 2 * d, hd[0], nr)]
    if net.get("params", "cat") == "cat":
        out.append(("refinement_out", 2 * d, hd[0], nr))
    if net.get("static", "train") == "train":
        out.append(("enhance", d, hd[0], nr))
    return out


def hidden(c: int, expansion: float) -> int:
    return int(c * expansion)


def param_shapes(net: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape."""
    if net.get("bias", False) or net.get("dual_pixel_task", False):
        raise ValueError("the reference covers bias-free KDLAE-T without the dual-pixel head")
    d, cin, cout = net["dim"], net["inp_channels"], net["out_channels"]
    with_bias_ln = net.get("LayerNorm_type", "WithBias") != "BiasFree"
    s: dict[str, tuple[int, ...]] = {"patch_embed.proj.weight": (d, cin, 3, 3)}

    def stage(name, c, heads, n):
        f = hidden(c, net["ffn_expansion_factor"])
        for i in range(n):
            p = f"{name}.{i}."
            for ln in ("norm1", "norm2"):
                s[p + ln + ".body.weight"] = (c,)
                if with_bias_ln:
                    s[p + ln + ".body.bias"] = (c,)
            s[p + "attn.temperature"] = (heads, 1, 1)
            s[p + "attn.qkv.weight"] = (3 * c, c, 1, 1)
            s[p + "attn.qkv_dwconv.weight"] = (3 * c, 1, 3, 3)
            s[p + "attn.project_out.weight"] = (c, c, 1, 1)
            s[p + "ffn.project_in.weight"] = (2 * f, c, 1, 1)
            s[p + "ffn.dwconv.weight"] = (2 * f, 1, 3, 3)
            s[p + "ffn.project_out.weight"] = (c, f, 1, 1)

    specs = {name: (c, h, n) for name, c, h, n in stages(net)}
    order = ["encoder_level1", ("down1_2", d), "encoder_level2", ("down2_3", 2 * d),
             "encoder_level3", ("down3_4", 4 * d), "latent", ("up4_3", 8 * d),
             ("reduce_chan_level3", 8 * d, 4 * d), "decoder_level3", ("up3_2", 4 * d),
             ("reduce_chan_level2", 4 * d, 2 * d), "decoder_level2", ("up2_1", 2 * d),
             "decoder_level1", "refinement"]
    for item in order:
        if isinstance(item, str):
            stage(item, *specs[item])
        elif item[0].startswith("down"):
            s[item[0] + ".body.0.weight"] = (item[1] // 2, item[1], 3, 3)
        elif item[0].startswith("up"):
            s[item[0] + ".body.0.weight"] = (item[1] * 2, item[1], 3, 3)
        else:
            s[item[0] + ".weight"] = (item[2], item[1], 1, 1)
    s["output.weight"] = (cout, 2 * d, 3, 3)
    if "refinement_out" in specs:
        s["output_param.weight"] = (2 * d, cout + 1, 3, 3)
        stage("refinement_out", *specs["refinement_out"])
        s["output2.weight"] = (cout, 2 * d, 3, 3)
    if "enhance" in specs:
        s["cen.weight"] = (2 * d, cout, 3, 3)
        s["upen.body.0.weight"] = (4 * d, 2 * d, 3, 3)
        stage("enhance", *specs["enhance"])
        s["outputen.weight"] = (cout, d, 3, 3)
    return s


def fan_in(shape: tuple[int, ...]) -> int:
    return math.prod(shape[1:])


def _layernorm(x, w, b):
    """Over the channels of NCHW x: biased variance, eps 1e-5 inside the
    root; BiasFree (b None) does not subtract the mean."""
    mu = x.mean(1, keepdim=True)
    var = (x - mu).square().mean(1, keepdim=True)
    if b is None:
        return x / torch.sqrt(var + 1e-5) * w[:, None, None]
    return (x - mu) / torch.sqrt(var + 1e-5) * w[:, None, None] + b[:, None, None]


def _block(p, pre, x, heads, ops: Ops):
    b, c, h, w = x.shape
    y = _layernorm(x, p[pre + "norm1.body.weight"], p.get(pre + "norm1.body.bias"))
    qkv = ops.conv2d(y, p[pre + "attn.qkv.weight"])
    qkv = ops.conv2d(qkv, p[pre + "attn.qkv_dwconv.weight"], padding=1, groups=3 * c)
    q, k, v = (t.reshape(b, heads, c // heads, h * w) for t in qkv.chunk(3, 1))
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    k = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    attn = ops.matmul(q, k.transpose(-2, -1)) * p[pre + "attn.temperature"]
    out = ops.matmul(attn.softmax(-1), v).reshape(b, c, h, w)
    x = x + ops.conv2d(out, p[pre + "attn.project_out.weight"])
    y = _layernorm(x, p[pre + "norm2.body.weight"], p.get(pre + "norm2.body.bias"))
    y = ops.conv2d(y, p[pre + "ffn.project_in.weight"])
    y = ops.conv2d(y, p[pre + "ffn.dwconv.weight"], padding=1, groups=y.shape[1])
    y1, y2 = y.chunk(2, 1)
    return x + ops.conv2d(F.gelu(y1) * y2, p[pre + "ffn.project_out.weight"])


def forward(p: dict, net: dict, img: torch.Tensor, rate: torch.Tensor | None,
            ops: Ops | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(hq, sr or None) of NCHW ``img`` and the (B, 1, H, W) denoise-rate
    plane ``rate``; H and W multiples of 8."""
    ops = ops or Ops()
    heads = {name: h for name, _, h, _ in stages(net)}
    blocks = {name: n for name, _, _, n in stages(net)}

    def stage(name, x):
        for i in range(blocks[name]):
            x = _block(p, f"{name}.{i}.", x, heads[name], ops)
        return x

    def conv3(name, x, **kw):
        return ops.conv2d(x, p[name], padding=kw.pop("padding", 1), **kw)

    def down(name, x):
        return F.pixel_unshuffle(conv3(name + ".body.0.weight", x), 2)

    def up(name, x):
        return F.pixel_shuffle(conv3(name + ".body.0.weight", x), 2)

    x1 = conv3("patch_embed.proj.weight", img)
    e1 = stage("encoder_level1", x1)
    e2 = stage("encoder_level2", down("down1_2", e1))
    e3 = stage("encoder_level3", down("down2_3", e2))
    lat = stage("latent", down("down3_4", e3))
    d3 = ops.conv2d(torch.cat([up("up4_3", lat), e3], 1), p["reduce_chan_level3.weight"])
    d3 = stage("decoder_level3", d3)
    d2 = ops.conv2d(torch.cat([up("up3_2", d3), e2], 1), p["reduce_chan_level2.weight"])
    d2 = stage("decoder_level2", d2)
    d1 = stage("decoder_level1", torch.cat([up("up2_1", d2), e1], 1))
    out = conv3("output.weight", stage("refinement", d1))
    if "refinement_out" in blocks:
        y = conv3("output_param.weight", torch.cat([out, rate], 1), padding=2, dilation=2)
        out = conv3("output2.weight", stage("refinement_out", y))
    hq = out + img
    sr = None
    if "enhance" in blocks:
        sr = conv3("outputen.weight", stage("enhance", up("upen", conv3("cen.weight", hq))))
    return hq, sr
