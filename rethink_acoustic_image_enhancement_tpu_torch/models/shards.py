"""The teacher on model shards: one model split over the devices of a mesh's
``model`` axis (tensor-parallel serving, ``TeacherPredictor(mesh=...)``),
as functions over each shard's own modules, the counterpart of
``models/bands.py`` for the ``model`` axis.

``shard_teacher(model, devices)`` gives one module per shard. The partition
rule is Megatron-style, inside every TransformerBlock; shard j of N holds:

  * MDTA split by heads, where N divides the block's heads: its heads'
    columns of each third of ``qkv`` (and of ``qkv_dwconv``), its heads'
    ``temperature``, and the matching rows (input channels) of
    ``project_out``. It computes its heads' Gram, softmax and attn @ v alone,
    and its ``project_out`` gives a partial of W_proj o;
  * MDTA whole, where N does not divide the heads (every one-head stage):
    every shard holds the whole MDTA and computes r itself, no sum;
  * GDFN always split by hidden channels: the same range of x1's and of
    x2's channels in ``project_in`` and ``dwconv``, and those rows of
    ``project_out`` (``parallel/tensor.py::shard_range``: ranges may differ
    by one channel). A mesh that leaves a shard no hidden channel in some
    block raises a ValueError that names the block;
  * every other layer whole (``patch_embed``, the resamplers,
    ``reduce_chan_*``, ``output_param``, ``output``, ``output2``, ``cen``,
    ``upen``, ``outputen``): each shard runs its own copy. (The JAX package
    shards those too; they are a small share of the weights and the work.)

A split conv's bias stays with its channels; the bias of a ``project_out``
whose input channels are split stays on shard 0 alone. Each shard's partial
of such a ``project_out`` is taken in float32 (its products exact, as the
conv's own float32 accumulation takes them), the partials summed across
shards in shard order on every shard's device (``LocalShards.sum_across``),
the residual added once, by shard 0 before the sum, and the sum rounded once
to the block's dtype: as the stage kernel sums its float32 partials. So every
shard holds the same bits after each block.

``teacher_shards(models, imgs, rates, shards)`` is ``KDLAETeacher.forward``
through the teacher's own wiring (``KDLAETeacher.wire``), ``models[j]`` shard
j's module and ``imgs[j]``, ``rates[j]`` the whole input on its device. A
stage that is ``fused`` and that ``ops/stage_gate.py::stage_worthwhile``
admits on the image's shape (its whole C and heads) runs
``ops/stage.py::fused_transformer_stage_shards``; any other runs block by
block in eager code on the shards' channel slices.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import stage_gate
from ..ops.attention import mdta_core
from ..ops.stage import fused_transformer_stage_shards, stack_block_params
from ..parallel.tensor import heads_split, shard_range
from .blocks import GDFN, MDTA, Conv2d, TransformerBlock, flax_block_tree
from .kdlae_teacher import KDLAETeacher, TransformerStage

Shards = list[torch.Tensor]


# ------------------------------------------------------------ weights ---

def _sliced_conv(conv: Conv2d, out_idx=None, in_idx=None, bias: bool = True) -> Conv2d:
    """``conv`` on some of its output channels (``out_idx``; a depthwise
    conv keeps one group a channel) or some of its input channels
    (``in_idx``), the bias kept with the output channels (dropped where
    ``bias`` is False)."""
    w = conv.weight.detach()
    b = None if conv.bias is None or not bias else conv.bias.detach()
    groups = conv.groups
    if out_idx is not None:
        w = w[out_idx]
        b = None if b is None else b[out_idx]
        if groups > 1:  # depthwise: a group per channel
            groups = len(out_idx)
    if in_idx is not None:
        w = w[:, in_idx]
    new = Conv2d(w.shape[1] * groups, w.shape[0], conv.kernel_size, stride=conv.stride,
                 padding=conv.padding, dilation=conv.dilation, groups=groups,
                 bias=b is not None, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        new.weight.copy_(w)
        if b is not None:
            new.bias.copy_(b)
    new.requires_grad_(conv.weight.requires_grad)
    return new


def _thirds(width: int, cols: range) -> torch.Tensor:
    """Indices of ``cols`` in each third of a (q | k | v) conv's outputs."""
    return torch.cat([torch.arange(t * width + cols.start, t * width + cols.stop)
                      for t in range(3)])


def _halves(width: int, cols: range) -> torch.Tensor:
    """Indices of ``cols`` in both halves of a GDFN's (x1 | x2) channels."""
    return torch.cat([torch.arange(h * width + cols.start, h * width + cols.stop)
                      for h in range(2)])


def _shard_block(blk: TransformerBlock, j: int, n: int) -> None:
    """In place: ``blk`` becomes shard j's of n (the module docstring)."""
    attn, ffn = blk.attn, blk.ffn
    c, heads = blk.dim, attn.num_heads
    if heads_split(heads, n):
        hs = heads // n
        cols = shard_range(c, n, j)  # n divides the heads, so C too: even ranges
        attn.qkv = _sliced_conv(attn.qkv, out_idx=_thirds(c, cols))
        attn.qkv_dwconv = _sliced_conv(attn.qkv_dwconv, out_idx=_thirds(c, cols))
        attn.project_out = _sliced_conv(attn.project_out, in_idx=torch.arange(cols.start,
                                                                             cols.stop),
                                        bias=j == 0)
        attn.temperature = nn.Parameter(attn.temperature.detach()[j * hs:(j + 1) * hs].clone(),
                                        requires_grad=attn.temperature.requires_grad)
        attn.num_heads = hs
    f = ffn.project_out.in_channels
    rng = shard_range(f, n, j)
    ffn.project_in = _sliced_conv(ffn.project_in, out_idx=_halves(f, rng))
    ffn.dwconv = _sliced_conv(ffn.dwconv, out_idx=_halves(f, rng))
    ffn.project_out = _sliced_conv(ffn.project_out,
                                   in_idx=torch.arange(rng.start, rng.stop), bias=j == 0)


def shard_teacher(model: KDLAETeacher, devices: Sequence[str | torch.device]
                  ) -> list[KDLAETeacher]:
    """One module per shard (the module docstring's rule), shard j on
    ``devices[j]``: a copy of ``model`` whose TransformerBlocks hold only
    shard j's slices, every other layer whole, with ``model``'s flags and
    dtype. ``model`` itself is left as it was. Raises a ValueError naming
    the first block whose hidden channels are fewer than the shards."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n < 1:
        raise ValueError("shard_teacher needs at least one device")
    for name, blk in model.named_modules():
        if isinstance(blk, TransformerBlock) and blk.ffn.project_out.in_channels < n:
            raise ValueError(
                f"{name}: {blk.ffn.project_out.in_channels} hidden channels leave some of "
                f"{n} model shards none; use at most that many shards")
    out = []
    for j, d in enumerate(devices):
        m = copy.deepcopy(model)
        for blk in m.modules():
            if isinstance(blk, TransformerBlock):
                _shard_block(blk, j, n)
        out.append(m.to(d))
    return out


def shard_stage_weights(weights: dict, n: int, j: int) -> dict:
    """Shard j's of n of a stage's stacked weights (``ops/stage.py``'s
    keyword arguments, flax layouts with a leading block dim), by the module
    docstring's rule: what ``stack_block_params`` gives of the stage's
    blocks in ``shard_teacher``'s shard j."""
    c = weights["ln1_w"].shape[-1]
    heads = weights["temperature"].shape[1]
    out = dict(weights)
    if heads_split(heads, n):
        hs = heads // n
        cols = shard_range(c, n, j)
        q = _thirds(c, cols)
        out.update(w_qkv=weights["w_qkv"][..., q], dw_qkv=weights["dw_qkv"][..., q],
                   temperature=weights["temperature"][:, j * hs:(j + 1) * hs],
                   w_proj=weights["w_proj"][..., cols.start:cols.stop, :])
    f = weights["w_out"].shape[-2]
    rng = shard_range(f, n, j)
    if not rng:
        raise ValueError(f"{f} hidden channels leave some of {n} model shards none")
    hid = _halves(f, rng)
    out.update(w_in=weights["w_in"][..., hid], w_dw=weights["w_dw"][..., hid],
               w_out=weights["w_out"][..., rng.start:rng.stop, :])
    return {k: v.contiguous() for k, v in out.items()}


def splits_heads(blk: TransformerBlock) -> bool:
    """Whether a shard's block holds some of the heads (else the whole
    MDTA)."""
    return blk.attn.qkv.out_channels < 3 * blk.dim


# ------------------------------------------------------------ forward ---

def _partial(conv: Conv2d, t: torch.Tensor) -> torch.Tensor:
    """A conv on a shard's input channels, in float32: its partial sum."""
    bias = None if conv.bias is None else conv.bias.float()
    return F.conv2d(t.float(), conv.weight.float(), bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def _mdta(attn: MDTA, x: torch.Tensor, split: bool) -> torch.Tensor:
    """``MDTA.forward`` on the heads a shard holds (all of them, or its
    share): the head width is read off ``qkv``'s outputs, not x's channels;
    where ``split``, the float32 partial of the projection."""
    b, _, h, w = x.shape
    q, k, v = attn.qkv_dwconv(attn.qkv(x)).chunk(3, dim=1)
    cq = q.shape[1]

    def heads(t):
        return t.reshape(b, attn.num_heads, cq // attn.num_heads, h * w)

    out = mdta_core(heads(q), heads(k), heads(v), attn.temperature).reshape(b, cq, h, w)
    return _partial(attn.project_out, out) if split else attn.project_out(out)


def _with_residual(skips: Shards, parts: Shards, shards, conv: Conv2d) -> Shards:
    """skip + the sum of the float32 parts of ``conv``'s output, every shard
    the same bits: shard 0 adds the skip to its part, the parts are summed
    across shards, and the sum takes the dtype the unsplit block gives."""
    dtype = torch.promote_types(skips[0].dtype, conv.weight.dtype)
    return [y.to(dtype) for y in shards.sum_across(
        [s.float() + p if j == 0 else p for j, s, p in zip(shards.held, skips, parts)])]


def mdta_shards(attns: Sequence[MDTA], xs: Shards, skips: Shards, shards,
                split: bool) -> Shards:
    """skip + MDTA(x) on every shard: where the heads are ``split``, each
    shard's partial projection summed across shards (the skip added once),
    else each shard's whole MDTA."""
    parts = [_mdta(a, x, split) for a, x in zip(attns, xs)]
    if not split:
        return [s + p for s, p in zip(skips, parts)]
    return _with_residual(skips, parts, shards, attns[0].project_out)


def _gdfn_part(ffn: GDFN, x: torch.Tensor) -> torch.Tensor:
    """``GDFN.forward`` on a shard's hidden channels, its float32 partial."""
    x1, x2 = ffn.dwconv(ffn.project_in(x)).chunk(2, dim=1)
    return _partial(ffn.project_out, F.gelu(x1) * x2)


def gdfn_shards(ffns: Sequence[GDFN], xs: Shards, skips: Shards, shards) -> Shards:
    """skip + GDFN(x) on every shard: each shard's hidden channels' part,
    summed across shards."""
    return _with_residual(skips, [_gdfn_part(f, x) for f, x in zip(ffns, xs)], shards,
                          ffns[0].project_out)


def block_shards(blocks: Sequence[TransformerBlock], xs: Shards, shards) -> Shards:
    """TransformerBlock on model shards (its composed form): LN1 whole on
    every shard, the MDTA by heads or whole, LN2 whole, the GDFN by hidden
    channels."""
    xs = mdta_shards([blk.attn for blk in blocks],
                     [blk.norm1(x) for blk, x in zip(blocks, xs)], xs, shards,
                     splits_heads(blocks[0]))
    return gdfn_shards([blk.ffn for blk in blocks],
                       [blk.norm2(x) for blk, x in zip(blocks, xs)], xs, shards)


def stage_shards(stages: Sequence[TransformerStage], xs: Shards, shards) -> Shards:
    """A TransformerStage on model shards: the shard stage kernel where the
    stage is ``fused`` and the gate admits the image's shape (the stage's
    whole C and heads), else block by block."""
    st = stages[0]
    b, _, h, w = xs[0].shape
    if st.fused and stage_gate.stage_worthwhile(
            b, h, w, st.dim, st.num_heads, st.bias_free_ln, st.use_bias,
            st.ffn_expansion_factor):
        weights = [stack_block_params([flax_block_tree(blk) for blk in s]) for s in stages]
        ys = fused_transformer_stage_shards(
            [x.permute(0, 2, 3, 1).contiguous() for x in xs], weights, shards)
        return [y.permute(0, 3, 1, 2).contiguous() for y in ys]
    for k in range(len(st)):
        xs = block_shards([s[k] for s in stages], xs, shards)
    return xs


def layer_shards(mods: Sequence[nn.Module], xs: Shards, shards) -> Shards:
    """One teacher layer on model shards: a stage split, any other layer
    whole on every shard (each its own copy)."""
    if isinstance(mods[0], TransformerStage):
        return stage_shards(mods, xs, shards)
    return [m(x) for m, x in zip(mods, xs)]


def _cat(a, b):
    return [torch.cat(parts, 1) for parts in zip(a, b)]


def _add(a, b):
    return [x + y for x, y in zip(a, b)]


def teacher_shards(models: Sequence[KDLAETeacher], imgs: Shards, rates: Shards,
                   shards) -> dict:
    """``KDLAETeacher.forward`` on model shards (the module docstring),
    through the teacher's own wiring (``KDLAETeacher.wire``): returns
    {'hq': one (B, C, H, W) a shard, 'sr': one (B, C, 2H, 2W) a shard or
    None}, the same bits on every shard."""

    def run(name, xs):
        return layer_shards([getattr(m, name) for m in models], xs, shards)

    return models[0].wire(run, _cat, _add, imgs, rates)
