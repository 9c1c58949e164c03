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
block in eager code on the shards' channel slices. ``network_shards`` picks
the teacher's, the Restormer's or (every layer whole) any other network's
forward; ``shards`` is a ``LocalShards`` (serving, every shard in one
process) or a ``parallel/tensor.py::RankShards`` (training, one shard a
rank), on which these functions run unchanged.

Training (``train.model_shard``) also needs the rule as data:
``shard_layout(model, n)`` maps each entry of the whole model's state dict
to a ``Split`` (where each shard's slice lies in the whole leaf) or None (a
whole leaf, the same on every shard; ``leaf_kinds`` names them).
``shard_module`` gives one rank its own shard, ``shard_state_dict`` slices
a whole state dict (weights, an optimizer's moments) for a shard,
``unshard`` puts the shards' state dicts back into the reference layout and
``gather_shards`` does that on ranks. The student and the scorer's
predictor have no split: every shard holds them whole (the JAX package
also shards their divisible 1-D vectors over ``model``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import stage_gate
from ..ops.attention import mdta_core
from ..ops.stage import fused_transformer_stage_shards, stack_block_params
from ..parallel.tensor import heads_split, shard_range
from .blocks import (GDFN, MDTA, Conv2d, DepthwiseConv3x3, TransformerBlock,
                     flax_block_tree)
from .kdlae_teacher import KDLAETeacher, Restormer, TransformerStage

SHARDED_NETWORKS = (KDLAETeacher, Restormer)  # the networks with split blocks

Shards = list[torch.Tensor]


# ------------------------------------------------------------ weights ---

def _sliced_conv(conv: Conv2d, out_idx=None, in_idx=None, bias: bool = True) -> Conv2d:
    """``conv`` on some of its output channels (``out_idx``; a depthwise
    conv keeps one group a channel, and the shift-add form its form) or
    some of its input channels (``in_idx``), the bias kept with the output
    channels (dropped where ``bias`` is False)."""
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
    if isinstance(conv, DepthwiseConv3x3):
        new = DepthwiseConv3x3(w.shape[0], bias=b is not None, device=w.device, dtype=w.dtype)
    else:
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


def _span(r: range) -> torch.Tensor:
    return torch.arange(r.start, r.stop)


def _block_splits(blk: TransformerBlock, n: int) -> dict[str, tuple[int, list]]:
    """The split leaves of ``blk`` over n shards (the module docstring's
    rule), by their names in the block: (dim, shard j's indices along dim,
    or None where shard j does not hold the leaf)."""
    attn, ffn = blk.attn, blk.ffn
    c, heads = blk.dim, attn.num_heads
    out = {}

    def conv(name, mod, dim, idx):
        out[f"{name}.weight"] = (dim, idx)
        if mod.bias is not None:  # a split input's bias stays on shard 0
            out[f"{name}.bias"] = (0, idx if dim == 0 else
                                   [_span(range(mod.out_channels))] + [None] * (n - 1))

    if heads_split(heads, n):
        hs = heads // n
        cols = [shard_range(c, n, j) for j in range(n)]  # n divides C: even ranges
        conv("attn.qkv", attn.qkv, 0, [_thirds(c, r) for r in cols])
        conv("attn.qkv_dwconv", attn.qkv_dwconv, 0, [_thirds(c, r) for r in cols])
        conv("attn.project_out", attn.project_out, 1, [_span(r) for r in cols])
        out["attn.temperature"] = (0, [_span(range(j * hs, (j + 1) * hs)) for j in range(n)])
    f = ffn.project_out.in_channels
    rngs = [shard_range(f, n, j) for j in range(n)]
    conv("ffn.project_in", ffn.project_in, 0, [_halves(f, r) for r in rngs])
    conv("ffn.dwconv", ffn.dwconv, 0, [_halves(f, r) for r in rngs])
    conv("ffn.project_out", ffn.project_out, 1, [_span(r) for r in rngs])
    return out


def _shard_block(blk: TransformerBlock, j: int, n: int) -> None:
    """In place: ``blk`` becomes shard j's of n (the module docstring)."""
    splits = _block_splits(blk, n)
    attn, ffn = blk.attn, blk.ffn
    if "attn.temperature" in splits:
        q = splits["attn.qkv.weight"][1][j]
        attn.qkv = _sliced_conv(attn.qkv, out_idx=q)
        attn.qkv_dwconv = _sliced_conv(attn.qkv_dwconv, out_idx=q)
        attn.project_out = _sliced_conv(attn.project_out,
                                        in_idx=splits["attn.project_out.weight"][1][j],
                                        bias=j == 0)
        heads = splits["attn.temperature"][1][j]
        attn.temperature = nn.Parameter(attn.temperature.detach()[heads].clone(),
                                        requires_grad=attn.temperature.requires_grad)
        attn.num_heads = len(heads)
    hid = splits["ffn.project_in.weight"][1][j]
    ffn.project_in = _sliced_conv(ffn.project_in, out_idx=hid)
    ffn.dwconv = _sliced_conv(ffn.dwconv, out_idx=hid)
    ffn.project_out = _sliced_conv(ffn.project_out,
                                   in_idx=splits["ffn.project_out.weight"][1][j], bias=j == 0)


def _check_hidden(model: nn.Module, n: int) -> None:
    """Raise a ValueError naming the first block whose hidden channels are
    fewer than ``n`` shards."""
    if n < 1:
        raise ValueError("model shards need at least one shard")
    for name, blk in model.named_modules():
        if isinstance(blk, TransformerBlock) and blk.ffn.project_out.in_channels < n:
            raise ValueError(
                f"{name}: {blk.ffn.project_out.in_channels} hidden channels leave some of "
                f"{n} model shards none; use at most that many shards")


def shard_module(model: nn.Module, j: int, n: int, device=None) -> nn.Module:
    """Shard j's of n of ``model`` (the module docstring's rule) on
    ``device`` (the model's own where None): a copy whose TransformerBlocks
    hold only shard j's slices, every other layer whole, with ``model``'s
    flags and dtype; a network without split blocks (``SHARDED_NETWORKS``)
    is copied whole. ``model`` itself is left as it was."""
    _check_hidden(model, n)
    m = copy.deepcopy(model)
    if isinstance(m, SHARDED_NETWORKS):
        for blk in m.modules():
            if isinstance(blk, TransformerBlock):
                _shard_block(blk, j, n)
    return m if device is None else m.to(device)


def shard_teacher(model: KDLAETeacher | Restormer, devices: Sequence[str | torch.device]
                  ) -> list[nn.Module]:
    """One module per shard (the module docstring's rule), shard j on
    ``devices[j]`` (``shard_module``): the teacher or the Restormer. Raises
    a ValueError naming the first block whose hidden channels are fewer
    than the shards."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("shard_teacher needs at least one device")
    return [shard_module(model, j, len(devices), d) for j, d in enumerate(devices)]


@dataclasses.dataclass(frozen=True)
class Split:
    """A split leaf of shape ``shape``: shard j holds ``index[j]`` of it
    along ``dim`` (None where shard j does not hold the leaf: a split
    projection's bias, which shard 0 alone holds)."""

    shape: tuple
    dtype: torch.dtype
    dim: int
    index: tuple

    def take(self, t: torch.Tensor, j: int) -> torch.Tensor:
        """Shard j's slice of the whole leaf ``t``."""
        return t.index_select(self.dim, self.index[j].to(t.device))

    def put(self, whole: torch.Tensor, t: torch.Tensor, j: int) -> None:
        """In place: shard j's slice ``t`` into the whole leaf ``whole``."""
        whole.index_copy_(self.dim, self.index[j].to(whole.device), t.to(whole.dtype))


def shard_layout(model: nn.Module, n: int) -> dict[str, Split | None]:
    """Each entry of ``model.state_dict()`` (the whole model), in its order:
    a ``Split`` where n shards split it, None where every shard holds it
    whole."""
    _check_hidden(model, n)
    splits = {}
    if isinstance(model, SHARDED_NETWORKS) and n > 1:
        for name, blk in model.named_modules():
            if isinstance(blk, TransformerBlock):
                splits.update({f"{name}.{k}": v for k, v in _block_splits(blk, n).items()})
    out = {}
    for name, t in model.state_dict().items():
        rule = splits.get(name)
        out[name] = None if rule is None else Split(tuple(t.shape), t.dtype, rule[0],
                                                    tuple(rule[1]))
    return out


def leaf_kinds(model: nn.Module, n: int) -> dict[str, str]:
    """'split' or 'whole' for each parameter of ``model`` over n shards."""
    layout = shard_layout(model, n)
    return {name: "whole" if layout[name] is None else "split"
            for name, _ in model.named_parameters()}


def held(layout: dict, j: int) -> list[str]:
    """The entries shard j holds, in the whole model's order."""
    return [k for k, r in layout.items() if r is None or r.index[j] is not None]


def shard_state_dict(state: dict, layout: dict, j: int) -> dict:
    """Shard j's entries of a whole state dict (or of any dict keyed as
    ``layout``, an optimizer's moments): split leaves sliced, whole ones as
    they are."""
    return {k: state[k] if layout[k] is None else layout[k].take(state[k], j)
            for k in held(layout, j) if k in state}


def unshard(states: Sequence[dict], layout: dict) -> dict:
    """The whole state dict from the shards' (``states[j]`` shard j's, as
    ``shard_state_dict`` gives it), in the reference layout: each split
    leaf's slices copied to their places, whole leaves from shard 0."""
    out = {}
    for k, rule in layout.items():
        if k not in states[0]:
            continue
        if rule is None:
            out[k] = states[0][k]
            continue
        whole = states[0][k].new_zeros(rule.shape, dtype=rule.dtype)
        for j, st in enumerate(states):
            if rule.index[j] is not None:
                rule.put(whole, st[k], j)
        out[k] = whole
    return out


def gather_shards(state: dict, layout: dict, j: int, reduce: Callable, device) -> dict:
    """``unshard`` on ranks, from shard j's own ``state``: each split leaf
    (of the entries of ``layout`` that ``state`` or another shard holds)
    put at shard j's place in a zeroed whole leaf on ``device``, and
    ``reduce`` (a list of tensors summed in place over the model subgroup,
    ``parallel/collectives.py::sum_over_shards_``) adds the shards' leaves:
    adding zeros is exact, so every shard gets the reference layout. Whole
    leaves are shard j's own. Every shard must call it with the same
    ``layout`` and entries."""
    out, bufs = {}, []
    for k, rule in layout.items():
        if rule is None:
            if k in state:
                out[k] = state[k]
            continue
        whole = torch.zeros(rule.shape, dtype=rule.dtype, device=device)
        if rule.index[j] is not None:
            rule.put(whole, state[k], j)
        out[k] = whole
        bufs.append(whole)
    reduce(bufs)
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


def _wire_runner(models: Sequence[nn.Module], shards):
    def run(name, xs):
        return layer_shards([getattr(m, name) for m in models], xs, shards)

    return run


def teacher_shards(models: Sequence[KDLAETeacher], imgs: Shards, rates: Shards,
                   shards) -> dict:
    """``KDLAETeacher.forward`` on model shards (the module docstring),
    through the teacher's own wiring (``KDLAETeacher.wire``): returns
    {'hq': one (B, C, H, W) a shard, 'sr': one (B, C, 2H, 2W) a shard or
    None}, the same bits on every shard."""
    return models[0].wire(_wire_runner(models, shards), _cat, _add, imgs, rates)


def restormer_shards(models: Sequence[Restormer], imgs: Shards, shards) -> Shards:
    """``Restormer.forward`` on model shards, through its own wiring: one
    (B, C, H, W) output a shard, the same bits on every shard."""
    return models[0].wire(_wire_runner(models, shards), _cat, _add, imgs)


def network_shards(models: Sequence[nn.Module], lqs: Sequence, shards):
    """``models[j](lqs[j])`` on model shards: the teacher's {'img',
    'denoise_rate'} dicts give {'hq', 'sr'} of shard lists, the Restormer
    a shard list; any other network runs whole on every shard."""
    m = models[0]
    if isinstance(m, KDLAETeacher):
        return teacher_shards(models, [x["img"] for x in lqs],
                              [x.get("denoise_rate") for x in lqs], shards)
    if isinstance(m, Restormer):
        return restormer_shards(models, list(lqs), shards)
    return [mod(x) for mod, x in zip(models, lqs)]
