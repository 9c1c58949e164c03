"""The networks on row bands: one image split by rows over devices or
ranks, as functions over the model's own modules and weights. Serving (the
JAX package's ``TeacherPredictor(mesh=...)`` with a ``spatial`` axis,
``eval/infer.py``) runs the teacher on ``LocalBands``; training
(``train.spatial_shard``, the JAX trainer's ``spatial_axis``) runs the
teacher, the Restormer or the student on ``RankBands``, one band a rank
(``parallel/spatial.py``). Every rule is differentiable: a band's parameter
gradients, summed over the bands, are the whole image's.

``teacher_bands(models, imgs, rates, bands)`` is ``KDLAETeacher.forward``
band by band: ``models[j]`` is band j's copy of the teacher on its device
(all copies with the same weights and flags), ``imgs[j]`` and ``rates[j]``
band j of the (B, C, H, W) image and denoise-rate plane, ``bands`` the
exchange. ``restormer_bands`` and ``student_bands`` (band j of a (B, N, H,
W) frame stack) run the Restormer's and the student's own wiring the same
way; ``network_bands`` picks by the model's type. Each layer takes one of
three rules:

  * band-local: the 1x1 convs (``reduce_chan_*``, ``skip_conv``, the
    MDTA's and GDFN's, the student's ``out_conv``), the LayerNorms, the
    skip concatenations and additions, the GELU gate, pixel-(un)shuffle,
    and on an even number of rows the student's ``MaxPool3d((1, 2, 2))``
    and ``ConvTranspose3dS2``;
  * halo: a conv whose taps reach r rows reads r rows of each neighbour
    (zeros at the image's edges, where the whole-image conv zero-pads) in
    place of its row padding: the 3x3 convs (r = 1), the dilated
    ``output_param`` (r = 2), the folded resamplers' stride-2 4x4 conv and
    transposed 6x6 conv (r = 1 each), the student's 3x3x3 ``Conv3d`` (r = 1
    on H, the dim -2 of (B, C, N, H, W));
  * sum: the MDTA adds its squared q/k norms over all bands, then each
    band normalises q and k by max(||q||, 1e-12) and max(||k||, 1e-12) and
    rounds them to their dtype, the bands' per-head Grams are added, and
    each band scales by the temperature and takes the softmax and attn @ v.
    That is ``ops/attention.py::mdta_core`` step for step, rounding
    included, with its two sums over pixels in another order.

A stage that the gate admits on the whole image's shape
(``ops/stage_gate.py::stage_worthwhile`` on the global H) runs
``ops/stage.py::fused_transformer_stage_bands`` (serving only: the stage
kernel has no backward pass, and training refuses ``fused``); any other,
and every stage without ``fused``, runs its blocks by the rules above.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import stage_gate
from ..ops.attention import _L2_EPS
from ..ops.stage import fused_transformer_stage_bands, stack_block_params
from .blocks import (Conv2d, Downsample, GDFN, MDTA, OverlapPatchEmbed,
                     TransformerBlock, Upsample, flax_block_tree)
from .kdlae_student import ConvTranspose3dS2, KDLAEStudent
from .kdlae_teacher import KDLAETeacher, Restormer, TransformerStage

Bands = list[torch.Tensor]


def _conv_over_halo(conv: Conv2d, xh: torch.Tensor, rows: int) -> torch.Tensor:
    """``conv`` on a band that carries ``rows`` halo rows above and below:
    the halo takes the place of the row padding."""
    dtype = torch.promote_types(xh.dtype, conv.weight.dtype)
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(xh.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    (conv.padding[0] - rows, conv.padding[1]), conv.dilation,
                    conv.groups)


def conv_bands(convs: Sequence[Conv2d], xs: Bands, bands) -> Bands:
    """A stride-1 'same' conv on bands: band-local for a 1x1, else over a
    halo of its row padding."""
    conv = convs[0]
    rows = conv.padding[0]
    if conv.stride != (1, 1) or 2 * rows != conv.dilation[0] * (conv.kernel_size[0] - 1):
        raise ValueError(f"no band rule for {conv}")
    if rows == 0:
        return [c(x) for c, x in zip(convs, xs)]
    return [_conv_over_halo(c, x, rows)
            for c, x in zip(convs, bands.exchange_halo(xs, rows))]


def resample_bands(mods: Sequence[nn.Module], xs: Bands, bands) -> Bands:
    """Downsample / Upsample on bands: the 3x3 conv over a 1-row halo then
    the band-local pixel-(un)shuffle, or the ``fused`` form's strided conv
    over a 1-row halo (a band's rows halve or double)."""
    m = mods[0]
    if not m.fused:
        return [md.body[1](y) for md, y in
                zip(mods, conv_bands([md.body[0] for md in mods], xs, bands))]
    out = []
    for md, xh in zip(mods, bands.exchange_halo(xs, 1)):
        dtype = torch.promote_types(xh.dtype, md.body[0].weight.dtype)
        w = md.folded_weight().to(dtype)
        if isinstance(m, Downsample):
            # output row o reads halo rows 2o .. 2o + 3
            out.append(F.conv2d(xh.to(dtype), w, stride=2, padding=(0, 1)))
        else:
            # input halo row i feeds output rows 2i + k - 4 (k the tap)
            out.append(F.conv_transpose2d(xh.to(dtype), w, stride=2, padding=(4, 2)))
    return out


def mdta_bands(attns: Sequence[MDTA], xs: Bands, bands) -> Bands:
    """MDTA on bands: the qkv depthwise conv over a 1-row halo, then
    ``mdta_core``'s steps with its two sums over pixels taken across bands:
    the squared q/k norms first, then the Gram of q and k normalised and
    rounded to their dtype, as ``mdta_core`` rounds them."""
    qkv = conv_bands([a.qkv_dwconv for a in attns],
                     [a.qkv(x) for a, x in zip(attns, xs)], bands)
    heads = attns[0].num_heads
    split = []
    for t in qkv:
        b, c3, h, w = t.shape
        q, k, v = (u.reshape(b, heads, c3 // 3 // heads, h * w) for u in t.chunk(3, dim=1))
        split.append((q, k, v, (b, c3 // 3, h, w)))
    norms = bands.sum_across([torch.stack([q.float().square().sum(-1),
                                           k.float().square().sum(-1)], -1)
                              for q, k, _, _ in split])
    grams = []
    for (q, k, _, _), nrm in zip(split, norms):
        norm = nrm.sqrt().clamp_min(_L2_EPS)
        qn = (q.float() / norm[..., 0:1]).to(q.dtype).float()
        kn = (k.float() / norm[..., 1:2]).to(k.dtype).float()
        grams.append(qn @ kn.transpose(-1, -2))
    out = []
    for a, (q, _, v, shape), gram in zip(attns, split, bands.sum_across(grams)):
        attn = torch.softmax(gram * a.temperature.float().reshape(1, -1, 1, 1), dim=-1)
        o = (attn.to(q.dtype).float() @ v.float()).to(q.dtype)
        out.append(a.project_out(o.reshape(shape)))
    return out


def gdfn_bands(ffns: Sequence[GDFN], xs: Bands, bands) -> Bands:
    """GDFN on bands: its depthwise conv over a 1-row halo."""
    t = conv_bands([f.dwconv for f in ffns], [f.project_in(x) for f, x in zip(ffns, xs)],
                   bands)
    out = []
    for f, u in zip(ffns, t):
        x1, x2 = u.chunk(2, dim=1)
        out.append(f.project_out(F.gelu(x1) * x2))
    return out


def block_bands(blocks: Sequence[TransformerBlock], xs: Bands, bands) -> Bands:
    """TransformerBlock on bands (its composed form)."""
    a = mdta_bands([blk.attn for blk in blocks],
                   [blk.norm1(x) for blk, x in zip(blocks, xs)], bands)
    xs = [x + y for x, y in zip(xs, a)]
    f = gdfn_bands([blk.ffn for blk in blocks],
                   [blk.norm2(x) for blk, x in zip(blocks, xs)], bands)
    return [x + y for x, y in zip(xs, f)]


def stage_bands(stages: Sequence[TransformerStage], xs: Bands, bands) -> Bands:
    """A TransformerStage on bands: the band stage kernel where the gate
    admits the whole image's shape and the stage is ``fused``, else block
    by block."""
    st = stages[0]
    b, _, hb, w = xs[0].shape
    if st.fused and stage_gate.stage_worthwhile(
            b, bands.n * hb, w, st.dim, st.num_heads, st.bias_free_ln,
            st.use_bias, st.ffn_expansion_factor):
        weights = [stack_block_params([flax_block_tree(blk) for blk in s])
                   for s in stages]
        ys = fused_transformer_stage_bands(
            [x.permute(0, 2, 3, 1).contiguous() for x in xs], weights, bands)
        return [y.permute(0, 3, 1, 2).contiguous() for y in ys]
    for k in range(len(st)):
        xs = block_bands([s[k] for s in stages], xs, bands)
    return xs


def layer_bands(mods: Sequence[nn.Module], xs: Bands, bands) -> Bands:
    """One teacher layer on bands, by its type."""
    m = mods[0]
    if isinstance(m, TransformerStage):
        return stage_bands(mods, xs, bands)
    if isinstance(m, (Downsample, Upsample)):
        return resample_bands(mods, xs, bands)
    if isinstance(m, OverlapPatchEmbed):
        return conv_bands([md.proj for md in mods], xs, bands)
    if isinstance(m, Conv2d):
        return conv_bands(mods, xs, bands)
    raise TypeError(f"no band rule for {type(m).__name__}")


def _cat(a, b):
    return [torch.cat(parts, 1) for parts in zip(a, b)]


def _add(a, b):
    return [x + y for x, y in zip(a, b)]


def teacher_bands(models: Sequence[KDLAETeacher], imgs: Bands, rates: Bands,
                  bands) -> dict:
    """``KDLAETeacher.forward`` on row bands (the module docstring), through
    the teacher's own wiring (``KDLAETeacher.wire``): returns {'hq': bands of
    (B, C, rows, W), 'sr': bands of (B, C, 2 rows, 2 W) or None}."""

    def run(name, xs):
        return layer_bands([getattr(m, name) for m in models], xs, bands)

    return models[0].wire(run, _cat, _add, imgs, rates)


def restormer_bands(models: Sequence[Restormer], imgs: Bands, bands) -> Bands:
    """``Restormer.forward`` on row bands, through ``Restormer.wire``."""

    def run(name, xs):
        return layer_bands([getattr(m, name) for m in models], xs, bands)

    return models[0].wire(run, _cat, _add, imgs)


def _conv3d_over_halo(conv: nn.Conv3d, xh: torch.Tensor, rows: int) -> torch.Tensor:
    """``conv`` on a (B, C, N, H, W) band that carries ``rows`` halo rows
    above and below on H: the halo takes the place of H's padding."""
    pd, ph, pw = conv.padding
    return F.conv3d(xh, conv.weight, conv.bias, conv.stride, (pd, ph - rows, pw),
                    conv.dilation, conv.groups)


def conv3d_bands(convs: Sequence[nn.Conv3d], xs: Bands, bands) -> Bands:
    """A stride-1 'same' Conv3d on bands of (B, C, N, H, W): band-local for
    a kernel of one row, else over a halo of its H padding."""
    conv = convs[0]
    rows = conv.padding[1]
    if conv.stride[1] != 1 or 2 * rows != conv.dilation[1] * (conv.kernel_size[1] - 1):
        raise ValueError(f"no band rule for {conv}")
    if rows == 0:
        return [c(x) for c, x in zip(convs, xs)]
    return [_conv3d_over_halo(c, x, rows)
            for c, x in zip(convs, bands.exchange_halo(xs, rows))]


def _even_rows(xs: Bands, what: str) -> None:
    if xs[0].shape[-2] % 2:
        raise ValueError(f"{what} on bands of {xs[0].shape[-2]} rows: a band must hold "
                         "an even number of rows")


def student_layer_bands(mods: Sequence[nn.Module], xs: Bands, bands) -> Bands:
    """One student layer on bands of (B, C, N, H, W), by its type."""
    m = mods[0]
    if isinstance(m, nn.Sequential):  # ConvBlock3d: [Conv3d, ReLU] x 2
        for k in range(len(m)):
            if isinstance(m[k], nn.Conv3d):
                xs = conv3d_bands([md[k] for md in mods], xs, bands)
            else:
                xs = [md[k](x) for md, x in zip(mods, xs)]
        return xs
    if isinstance(m, nn.MaxPool3d):
        _even_rows(xs, "MaxPool3d")
        return [md(x) for md, x in zip(mods, xs)]
    if isinstance(m, ConvTranspose3dS2):
        return [md(x) for md, x in zip(mods, xs)]
    if isinstance(m, nn.Conv3d):
        return conv3d_bands(mods, xs, bands)
    raise TypeError(f"no band rule for {type(m).__name__}")


def student_bands(models: Sequence[KDLAEStudent], stacks: Bands, bands) -> Bands:
    """``KDLAEStudent.forward`` on row bands of (B, N, H, W) stacks, through
    ``KDLAEStudent.wire``: bands of the (B, N, H, W) output."""

    def run(name, xs):
        return student_layer_bands([m.get_submodule(name) for m in models], xs, bands)

    ins = [m.stack_in(x) for m, x in zip(models, stacks)]
    return [y[:, 0] for y in models[0].wire(run, _add, ins)]


BAND_NETWORKS = (KDLAETeacher, Restormer, KDLAEStudent)


def network_bands(models: Sequence[nn.Module], lqs: Sequence, bands):
    """``models[j](lqs[j])`` on row bands for every network with band rules
    (``BAND_NETWORKS``): a teacher's ``lqs`` are {'img', 'denoise_rate'}
    band dicts and it returns {'hq', 'sr'} of band lists; the others take
    and return band lists. Any other network raises NotImplementedError."""
    m = models[0]
    if isinstance(m, KDLAETeacher):
        return teacher_bands(models, [x["img"] for x in lqs],
                             [x.get("denoise_rate") for x in lqs], bands)
    if isinstance(m, Restormer):
        return restormer_bands(models, list(lqs), bands)
    if isinstance(m, KDLAEStudent):
        return student_bands(models, list(lqs), bands)
    raise NotImplementedError(
        f"{type(m).__name__} has no row-band rules: train.spatial_shard trains "
        "KDLAE_teacher, Restormer and KDLAE_student (ROADMAP.md, Queue A)")
