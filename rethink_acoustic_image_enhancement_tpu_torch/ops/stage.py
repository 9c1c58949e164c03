"""Transformer stage: N consecutive BiasFree TransformerBlocks in one call.

``fused_transformer_stage`` keeps the JAX signature and layouts
(``ops/pallas/stage.py:234-250``): x is NHWC (float32 or bfloat16), the
weights are stacked with a leading ``n_blocks`` dim in the flax layouts
  ln1_w/ln2_w (N, C); w_qkv (N, 1, 1, C, 3C); dw_qkv (N, 3, 3, 1, 3C);
  temperature (N, heads, 1, 1) or (N, heads); w_proj (N, 1, 1, C, C);
  w_in (N, 1, 1, C, 2F); w_dw (N, 3, 3, 1, 2F); w_out (N, 1, 1, F, C).
Samples are independent (per-sample MDTA statistics).

On a CUDA tensor it runs the Hopper kernels of ``csrc/stage.cu`` (three
launches per block through ``ops/block.py::BlockRunner``, see the note
there) on x's device, whose weights must lie there too, and counts the
call in ``fused_transformer_stage.launches``; on a CPU tensor it runs
``stage_plain``, the same arithmetic in plain PyTorch: bf16 operands with
float32 accumulation for the five products, the qkv and W_in outputs
rounded to bf16 before their float32 depthwise 3x3, two-pass LayerNorm and
exact-erf GELU (the kernel's Abramowitz-Stegun erf is within 1.5e-7).
Blocks hand their output to the next in float32; only the stage's output
is cast to x's dtype (the TPU kernel stored every block's output in x's
dtype).

``fused_transformer_stage_bands`` is the same stage on an image split in row
bands over devices (spatially sharded serving, ``parallel/spatial.py``), the
same three launches per block and band; ``stage_plain_bands`` is its plain
version.

``fused_transformer_stage_shards`` is the stage on model shards
(tensor-parallel serving, ``parallel/tensor.py``): each shard holds the
whole input and its heads' and hidden channels' weights
(``models/shards.py::shard_teacher``); per block and shard kernel (A) on its
heads, (B), and (C') up to its partial of the projection, a sum across
shards, the GDFN kernel on its hidden channels, and a second sum. At C =
96, 192 and 384 with 48 channels a head (A) and (C') are Hopper kernels
(``csrc/stage_sm90_wide.cu``'s ``k_gram_wide`` on the shard's heads, or
``csrc/stage_sm90.cu``'s ``k_gram_wgmma`` at C = 96 where a shard holds
every head; ``k_proj_wide``; ``ops/block.py::apply_route``) and so is the
GDFN (``ops/gdfn.py::ffn_route``); other widths keep ``csrc/stage.cu`` and
``csrc/gdfn.cu``. ``stage_plain_shards`` is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .block import (BlockRunner, BlockWeights, block_f32, block_f32_bands,
                    block_f32_shards, pack_blocks)
from .gdfn import check_input, launch_ffn_part


def stack_block_params(params_list) -> dict[str, torch.Tensor]:
    """Stack TransformerBlock parameter trees (flax layout: norm1/attn/
    norm2/ffn) into the stage's stacked-weight arguments."""

    def stk(path):
        vals = []
        for p in params_list:
            node = p
            for key in path:
                node = node[key]
            vals.append(node if isinstance(node, torch.Tensor)
                        else torch.from_numpy(np.array(node)))
        return torch.stack(vals)

    return dict(
        ln1_w=stk(("norm1", "weight")),
        w_qkv=stk(("attn", "qkv", "kernel")),
        dw_qkv=stk(("attn", "qkv_dwconv", "kernel")),
        temperature=stk(("attn", "temperature")),
        w_proj=stk(("attn", "project_out", "kernel")),
        ln2_w=stk(("norm2", "weight")),
        w_in=stk(("ffn", "project_in", "kernel")),
        w_dw=stk(("ffn", "dwconv", "kernel")),
        w_out=stk(("ffn", "project_out", "kernel")),
    )


# ------------------------------------------------------------- plain ----

def _block_weights(i, c, ln1_w, w_qkv, dw_qkv, temperature, w_proj, ln2_w,
                   w_in, w_dw, w_out) -> BlockWeights:
    """Block i of the stacked weights as ``block_f32`` takes them (a model
    shard's: W_qkv (C, 3 cq), W_proj (cq, C), cq its heads' channels)."""
    temp = temperature.float().reshape(ln1_w.shape[0], -1)
    wqkv = w_qkv[i].reshape(c, -1)
    cq = wqkv.shape[1] // 3
    if cq % temp.shape[1]:
        raise ValueError(f"{temp.shape[1]} heads do not divide {cq} channels")
    return BlockWeights(
        ln1_w[i].float(), None, wqkv.float(),
        dw_qkv[i].reshape(3, 3, -1).float(), temp[i],
        w_proj[i].reshape(cq, c).float(), ln2_w[i].float(), None,
        w_in[i].reshape(c, -1).float(), w_dw[i].reshape(3, 3, -1).float(),
        w_out[i].reshape(-1, c).float())


def stage_plain(x, ln1_w, w_qkv, dw_qkv, temperature, w_proj, ln2_w, w_in,
                w_dw, w_out, ln_eps: float = 1e-5) -> torch.Tensor:
    """The stage in plain PyTorch (the kernel's arithmetic)."""
    weights = dict(ln1_w=ln1_w, w_qkv=w_qkv, dw_qkv=dw_qkv,
                   temperature=temperature, w_proj=w_proj, ln2_w=ln2_w,
                   w_in=w_in, w_dw=w_dw, w_out=w_out)
    y = x
    for i in range(ln1_w.shape[0]):  # blocks hand over in float32
        y = block_f32(y, *_block_weights(i, x.shape[-1], **weights), ln_eps)
    return y.to(x.dtype)


def stage_plain_bands(xs, weights, bands, ln_eps: float = 1e-5) -> list[torch.Tensor]:
    """``stage_plain`` on an image split in row bands, with the Gram and
    norms of every block summed across them (``ops/block.py::
    block_f32_bands``); one band gives ``stage_plain``'s bits."""
    ys = list(xs)
    for i in range(weights[0]["ln1_w"].shape[0]):
        ys = block_f32_bands(
            ys, [_block_weights(i, x.shape[-1], **w) for x, w in zip(xs, weights)],
            bands, ln_eps)
    return [y.to(x.dtype) for x, y in zip(xs, ys)]


def stage_plain_shards(xs, weights, shards, ln_eps: float = 1e-5) -> list[torch.Tensor]:
    """``stage_plain`` on model shards, every block through ``ops/block.py::
    block_f32_shards``; one shard gives ``stage_plain``'s bits."""
    ys = list(xs)
    for i in range(weights[0]["ln1_w"].shape[0]):
        ys = block_f32_shards(
            ys, [_block_weights(i, x.shape[-1], **w) for x, w in zip(xs, weights)],
            shards, ln_eps)
    return [y.to(x.dtype) for x, y in zip(xs, ys)]


# ------------------------------------------------------------- CUDA -----

def _stage_cuda(x, ln_eps, **weights) -> torch.Tensor:
    x = check_input(x, "stage")
    with _build.on_device(x, "stage", **weights):
        c = x.shape[-1]
        p = pack_blocks(x.device, **weights)
        n, heads = p["temp"].shape
        if c % heads or (c // heads) % 16:
            raise ValueError(f"stage kernel needs C/heads a multiple of 16 "
                             f"(C={c}, heads={heads})")
        runner = BlockRunner(x, heads, p["fp"])
        # blocks hand over in float32; only the last writes x's dtype
        out = torch.empty_like(x)
        bufs = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
                for _ in range(min(2, n - 1))]
        src = x
        for i in range(n):
            dst = out if i == n - 1 else bufs[i % 2]
            runner.run(src, dst, p, i, ln_eps)
            src = dst
    _build.count_launch(fused_transformer_stage)
    return src


def fused_transformer_stage(x, ln1_w, w_qkv, dw_qkv, temperature, w_proj,
                            ln2_w, w_in, w_dw, w_out,
                            ln_eps: float = 1e-5) -> torch.Tensor:
    """N BiasFree TransformerBlocks on NHWC x (see the module docstring).
    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    weights = dict(ln1_w=ln1_w, w_qkv=w_qkv, dw_qkv=dw_qkv,
                   temperature=temperature, w_proj=w_proj, ln2_w=ln2_w,
                   w_in=w_in, w_dw=w_dw, w_out=w_out)
    if x.device.type == "cuda":
        return _stage_cuda(x, ln_eps, **weights)
    if x.device.type == "cpu":
        return stage_plain(x, ln_eps=ln_eps, **weights)
    raise ValueError(f"no stage implementation for device {x.device}")


fused_transformer_stage.launches = 0  # CUDA stage calls (3 launches/block)


# ------------------------------------------------------------- bands ----

def _stage_bands_cuda(xs, weights, bands, ln_eps) -> list[torch.Tensor]:
    """Each block on every band: (A) per band; each band's partial Gram
    summed over its tile groups, then across bands on every band's device;
    (B) per band; v's halo rows from the neighbours; (C) per band; the
    output's halo rows for the next block. One band hands (B) its groups
    as the whole image does. The bands lie on cards of their own, or share
    one."""
    xs = [check_input(x, "stage") for x in xs]
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"stage bands differ in shape: {[tuple(x.shape) for x in xs]}")
    b, hb, w, c = xs[0].shape
    held = (b, hb + 2, w, c)  # one halo row above and below the band's own
    runners, packs, srcs, bufs, outs = [], [], [], [], []
    for j, (x, wts) in enumerate(zip(xs, weights)):
        with _build.on_device(x, "stage", **wts):
            p = pack_blocks(x.device, **wts)
            n, heads = p["temp"].shape
            if c % heads or (c // heads) % 16:
                raise ValueError(f"stage kernel needs C/heads a multiple of 16 "
                                 f"(C={c}, heads={heads})")
            src = torch.empty(held, dtype=x.dtype, device=x.device)
            src[:, 1:-1] = x
            runners.append(BlockRunner(src, heads, p["fp"],
                                       band=(bands.held[j] * hb, bands.n * hb)))
            packs.append(p)
            srcs.append(src)
            # blocks hand over in float32; only the last writes x's dtype
            bufs.append([torch.empty(held, dtype=torch.float32, device=x.device)
                         for _ in range(min(2, n - 1))])
            outs.append(torch.empty(held, dtype=x.dtype, device=x.device))
    bands.fill_halo(srcs, 1, dim=1)
    for i in range(n):
        dsts = outs if i == n - 1 else [bb[i % 2] for bb in bufs]
        for r, p, src in zip(runners, packs, srcs):
            r.gram(src, p, i, ln_eps)
        parts = ([runners[0].part] if bands.n == 1 else
                 bands.sum_across([r.part.sum(1, keepdim=True) for r in runners]))
        for r, p, part in zip(runners, packs, parts):
            r.softmax(part, p, i)
        bands.fill_halo([r.v for r in runners], 1, dim=1)
        for r, p, src, dst in zip(runners, packs, srcs, dsts):
            r.apply(src, dst, p, i, ln_eps)
        if i < n - 1:
            bands.fill_halo(dsts, 1, dim=1)
        srcs = dsts
    _build.count_launch(fused_transformer_stage_bands)
    return [out[:, 1:-1] for out in outs]


def fused_transformer_stage_bands(xs, weights, bands, ln_eps: float = 1e-5
                                  ) -> list[torch.Tensor]:
    """N BiasFree TransformerBlocks on an image split in row bands
    (``parallel/spatial.py``; ``bands`` the exchange, e.g. ``LocalBands``):
    xs[j] is band j of ``bands.held``, NHWC (B, rows, W, C), every band the
    same shape; weights[j] its stacked weights on its device (the keyword
    arguments of ``fused_transformer_stage``). Returns the bands of the
    stage's output. Every block's Gram and q/k norms are summed over all
    bands, and its depthwise convs read the neighbours' rows, so the bands
    compute the whole image's stage up to the order of those sums.

    CUDA bands run the three launches of ``csrc/stage.cu`` per band and
    block (or raise) and count the call in
    ``fused_transformer_stage_bands.launches``; CPU bands take
    ``stage_plain_bands``. A band's rows need not fill the kernel's tiles:
    its last tile is cut at the band's edge, as at an image's."""
    kinds = {x.device.type for x in xs}
    if len(xs) != len(weights) or len(xs) != len(bands.held):
        raise ValueError(f"{len(xs)} bands, {len(weights)} weight sets, "
                         f"{len(bands.held)} bands held")
    if kinds == {"cuda"}:
        return _stage_bands_cuda(xs, weights, bands, ln_eps)
    if kinds == {"cpu"}:
        return stage_plain_bands(xs, weights, bands, ln_eps)
    raise ValueError(f"no band stage implementation for devices {sorted(kinds)}")


fused_transformer_stage_bands.launches = 0  # CUDA band-stage calls


# ------------------------------------------------------------- shards ---

def _stage_shards_cuda(xs, weights, shards, ln_eps) -> list[torch.Tensor]:
    """Each block on every shard: (A) on the shard's heads (all of them
    where the shards do not divide the heads), (B), (C') to r in float32
    with x added by shard 0 alone where the heads are split (by every shard
    where it holds them all); a sum across shards where split; the GDFN
    kernel on the shard's hidden channels, r added by shard 0; a sum. The
    shards lie on cards of their own, or share one."""
    xs = [check_input(x, "stage") for x in xs]
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"stage shards differ in shape: {[tuple(x.shape) for x in xs]}")
    c = xs[0].shape[-1]
    runners, packs = [], []
    for x, wts in zip(xs, weights):
        with _build.on_device(x, "stage", **wts):
            p = pack_blocks(x.device, **wts, shard=True)
            n, heads = p["temp"].shape
            if p["cq"] % heads or (p["cq"] // heads) % 16:
                raise ValueError(f"stage kernel needs C/heads a multiple of 16 "
                                 f"(C={p['cq']} on the shard, heads={heads})")
            runners.append(BlockRunner(x, heads, p["fp"], cq=p["cq"]))
            packs.append(p)
    split = packs[0]["cq"] < c
    first = [j == 0 for j in shards.held]
    srcs = xs
    for i in range(n):
        rs = []
        for run, p, src, own in zip(runners, packs, srcs, first):
            run.gram(src, p, i, ln_eps)
            run.softmax(run.part, p, i)
            rs.append(torch.empty(src.shape, dtype=torch.float32, device=src.device))
            run.project(src if own or not split else None, rs[-1], p, i)
        if split:
            rs = shards.sum_across(rs)
        srcs = shards.sum_across([launch_ffn_part(r, p, i, own, ln_eps)
                                  for r, p, own in zip(rs, packs, first)])
    _build.count_launch(fused_transformer_stage_shards)
    return [y.to(x.dtype) for x, y in zip(xs, srcs)]


def fused_transformer_stage_shards(xs, weights, shards, ln_eps: float = 1e-5
                                   ) -> list[torch.Tensor]:
    """N BiasFree TransformerBlocks on model shards (``parallel/tensor.py``;
    ``shards`` the exchange, e.g. ``LocalShards``): xs[j] the whole NHWC
    input (B, H, W, C) on shard j's device, weights[j] its stacked weights
    there (the keyword arguments of ``fused_transformer_stage``, sliced as
    ``models/shards.py::shard_teacher`` slices them: W_qkv (N, 1, 1, C,
    3 cq) with the temperatures of its heads and W_proj (N, 1, 1, cq, C),
    cq = C where every shard holds every head; W_in, W_dw and W_out on its
    hidden channels). Returns the stage's output on every shard, the same
    bits on each. The partials of W_proj o and of the GDFN are summed across
    shards, so the shards compute the whole stage up to the order of those
    sums.

    CUDA shards run (A), (B), (C') and the GDFN kernel per shard and block
    (the kernels of the module docstring; or raise) and count the call in
    ``fused_transformer_stage_shards.launches`` (the GDFN kernel's launches
    in ``ops/gdfn.py::fused_ln_gdfn_part.launches``); CPU shards take
    ``stage_plain_shards``."""
    kinds = {x.device.type for x in xs}
    if len(xs) != len(weights) or len(xs) != len(shards.held):
        raise ValueError(f"{len(xs)} shards, {len(weights)} weight sets, "
                         f"{len(shards.held)} shards held")
    if kinds == {"cuda"}:
        return _stage_shards_cuda(xs, weights, shards, ln_eps)
    if kinds == {"cpu"}:
        return stage_plain_shards(xs, weights, shards, ln_eps)
    raise ValueError(f"no shard stage implementation for devices {sorted(kinds)}")


fused_transformer_stage_shards.launches = 0  # CUDA shard-stage calls
