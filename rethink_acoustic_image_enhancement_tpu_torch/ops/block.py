"""One whole TransformerBlock as one call:
``y = r + GDFN(LN2(r))``, ``r = x + W_p MDTA(LN1(x))``.

``fused_transformer_block`` keeps the JAX signature and layouts
(``ops/pallas/block.py:248``): x is (1, H, W, C) NHWC, float32 or bfloat16;
``w_qkv`` (1, 1, C, 3C), ``dw_qkv`` (3, 3, 1, 3C), ``temperature`` (heads, 1,
1) or (heads,), ``w_proj`` (1, 1, C, C), ``w_in`` (1, 1, C, 2F), ``w_dw``
(3, 3, 1, 2F), ``w_out`` (1, 1, F, C); ``bias_free`` picks the LayerNorm
variant of both norms (a missing bias counts as zeros); any head count that
divides C. Both depthwise convs see zeros outside the image, as torch's
``padding=1`` gives them: LN1(x) and LN2(r) are masked after the LayerNorm,
so a LayerNorm bias does not leak into the border ring.

On a CUDA tensor it runs the three launches of ``csrc/stage.cu`` (Gram,
softmax, apply; see the note there) on x's device, whose weights must lie
there too, and counts the call in ``fused_transformer_block.launches``; at
C = 96 the Gram and apply launches are ``csrc/stage_sm90.cu``'s Hopper
kernels (wgmma, TMA, one block an SM; ``apply_route``; ``wgmma_tiles``
lists the persistent apply kernel's tiles), counted in
``gram_wgmma.launches`` and ``apply_wgmma.launches``; at C = 192 and 384
(48 channels a head) ``csrc/stage_sm90_wide.cu``'s: the Gram kernel and
the apply step as two kernels, r = x + W_p MDTA in fp32 and then LN2, the
GDFN and the residual (``gram_wide``, ``proj_wide``, ``ffn_wide``; their
schedules ``wgmma_tiles`` with ``WIDE_TILE`` and ``proj_tiles``). On a CPU tensor it runs
``block_plain``, the same arithmetic in plain PyTorch: bf16 operands with
float32 accumulation for the five products, the qkv and W_in outputs
rounded to bf16 before their float32 depthwise 3x3, two-pass LayerNorm and
exact-erf GELU. ``ops/stage.py`` runs N BiasFree blocks through the same
launches.

On model shards (tensor-parallel serving, ``parallel/tensor.py``) a block
is split Megatron-style: each shard holds the columns of its heads in each
third of W_qkv (and their depthwise taps and temperatures) and those rows of
W_proj, and a range of the GDFN's hidden channels. ``qkv_hidden``,
``gram_part`` and ``attend`` take a shard's weights as they take a whole
block's; ``attend(..., residual=False)`` gives the shard's partial of
``W_proj o`` alone; ``block_f32_shards`` is the block on shards, one shard
``block_f32``'s bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .gdfn import (FFN_CHUNKS, FFN_TILES, bf16_round, check_input, dw3x3,
                   ffn_candidates, ffn_chunks, ffn_f32, ffn_hidden, ffn_out, ffn_route,
                   pack_ffn, pick_layout)
from .norm import channel_layernorm

_L2_EPS = 1e-12
_GRAM_TILES = ((8, 16), (8, 8), (4, 8), (4, 4))
# The wide layouts' chunks, for a width whose C x C weights do not fit beside
# a tile (C = 384): kernel (A)'s columns of a W_qkv third and kernel (C)'s
# rows of W_proj held at once.
_GRAM_CHUNKS = (64, 32)
_PROJ_CHUNKS = (128, 64)
# Kernels (A) and (C) at this width are csrc/stage_sm90.cu's (wgmma, TMA,
# bulk copies under mbarriers; (C) persistent): 6 x 30 output tiles on an
# 8 x 32 halo, hidden chunks of 32 channels.
WGMMA_C = 96
WGMMA_TILE = (6, 30)
WGMMA_FC = 32
WGMMA_QCH = 48  # kernel (A)'s chunk of q, k or v channels
# At these widths with 48 channels a head (the teacher's encoder_level3,
# decoder_level3 and latent) kernels (A) and (C) are csrc/stage_sm90_wide.cu's:
# output tiles of TH x 30 (on a (TH + 2) x 32 halo) for (A) and (F), PROJ_TH x
# 32 pixels for (P), hidden chunks of 32 channels, (A)'s chunks one head's q,
# k or v. On model shards they (and C = 96's instance) run (A) on the shard's
# heads and (P) on their rows of W_proj.
WIDE_TILE = {96: (6, 30), 192: (4, 30), 384: (2, 30)}
PROJ_TH = {96: 8, 192: 4, 384: 2}
WIDE_HC = 48


# ------------------------------------------------------------- plain ----

class BlockWeights(NamedTuple):
    """One block's float32 weights as ``block_f32`` takes them: 2-D/3-D
    (C, 3C), (3, 3, 3C), (heads,), (C, C), (C, 2F), (3, 3, 2F), (F, C); a
    None bias is the BiasFree LayerNorm."""
    ln1: torch.Tensor
    ln1b: torch.Tensor | None
    wqkv: torch.Tensor
    dwqkv: torch.Tensor
    temp: torch.Tensor
    wproj: torch.Tensor
    ln2: torch.Tensor
    ln2b: torch.Tensor | None
    win: torch.Tensor
    wdw: torch.Tensor
    wout: torch.Tensor


def qkv_hidden(x32, ln1, ln1b, wqkv, eps) -> torch.Tensor:
    """The qkv depthwise input: bf16(bf16(LN1(x)) @ bf16(W_qkv)), on all
    of W_qkv's columns or on a shard's (C, 3 Cq) of them."""
    return bf16_round(bf16_round(channel_layernorm(x32, ln1, ln1b, eps=eps))
                      @ bf16_round(wqkv))


def gram_part(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, heads, hc, hc + 2): the per-head Gram q^T k (bf16 operands)
    over qkv's pixels, then the squared norms of q's and of k's channels as
    two more columns; parts of row bands add up to the whole image's."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    q, k = (qkv[..., i * c:(i + 1) * c].reshape(b, h * w, heads, c // heads)
            for i in range(2))
    gram = torch.einsum("bphc,bphd->bhcd", bf16_round(q), bf16_round(k))
    return torch.cat([gram, q.square().sum(1)[..., None],
                      k.square().sum(1)[..., None]], -1)


def attend(x32, qkv, part, temp, wproj, residual: bool = True) -> torch.Tensor:
    """r = x + bf16(attn @ v) @ W_proj, attn the softmax of the Gram over
    max(||q||, 1e-12) max(||k||, 1e-12) times the temperature, from the
    summed ``gram_part``; without ``residual`` the product alone (a shard's
    partial, W_proj its (Cq, C) rows)."""
    b, h, w, c3 = qkv.shape
    c, heads = c3 // 3, temp.numel()
    hc = c // heads
    gram = part[..., :hc]
    qnorm = part[..., hc].sqrt().clamp_min(_L2_EPS)  # (b, heads, hc)
    knorm = part[..., hc + 1].sqrt().clamp_min(_L2_EPS)
    logits = (gram / qnorm[..., :, None] / knorm[..., None, :]
              * temp.reshape(1, heads, 1, 1))
    attn = torch.softmax(logits, dim=-1)
    v = qkv[..., 2 * c:].reshape(b, h * w, heads, hc)
    oa = torch.einsum("bhcd,bphd->bphc", bf16_round(attn),
                      bf16_round(v)).reshape(b, h, w, c)
    y = bf16_round(oa) @ bf16_round(wproj)
    return x32 + y if residual else y


def block_f32(x, ln1, ln1b, wqkv, dwqkv, temp, wproj, ln2, ln2b, win, wdw,
              wout, eps) -> torch.Tensor:
    """One block in float32 out, on ``BlockWeights``' float32 weights."""
    x32 = x.float()
    qkv = dw3x3(qkv_hidden(x32, ln1, ln1b, wqkv, eps), dwqkv)
    r = attend(x32, qkv, gram_part(qkv, temp.numel()), temp, wproj)
    return ffn_f32(r, ln2, ln2b, win, wdw, wout, eps)


def block_f32_bands(xs, ws, bands, eps) -> list[torch.Tensor]:
    """``block_f32`` on an image split in row bands (``parallel/spatial.py``;
    ``bands`` the exchange): xs[j] band j, ws[j] its ``BlockWeights`` on
    its device. Both depthwise convs read a halo row from each neighbour,
    and the Gram and norms are summed across bands; one band computes
    ``block_f32``'s bits."""
    x32 = [x.float() for x in xs]
    t = [qkv_hidden(x, w.ln1, w.ln1b, w.wqkv, eps) for x, w in zip(x32, ws)]
    qkv = [dw3x3(th, w.dwqkv, halo=True)
           for th, w in zip(bands.exchange_halo(t, 1, dim=1), ws)]
    parts = bands.sum_across([gram_part(q, w.temp.numel()) for q, w in zip(qkv, ws)])
    r = [attend(x, q, p, w.temp, w.wproj) for x, q, p, w in zip(x32, qkv, parts, ws)]
    u = [ffn_hidden(ri, w.ln2, w.ln2b, w.win, eps) for ri, w in zip(r, ws)]
    a = [dw3x3(uh, w.wdw, halo=True)
         for uh, w in zip(bands.exchange_halo(u, 1, dim=1), ws)]
    return [ffn_out(ri, ai, w.wout) for ri, ai, w in zip(r, a, ws)]


def block_f32_shards(xs, ws, shards, eps) -> list[torch.Tensor]:
    """``block_f32`` on model shards (``parallel/tensor.py``; ``shards``
    the exchange): xs[j] the whole input on shard j's device, ws[j] its
    ``BlockWeights`` there (its heads' or the whole MDTA, and its hidden
    channels). Where the shards split the heads, each takes its heads'
    attention and its partial of W_proj o, shard 0 adding x, and the
    partials are summed across shards; else each computes r whole. Then
    each takes LN2 of the whole r and its hidden channels' part of the GDFN,
    shard 0 adding r, summed across shards. One shard gives ``block_f32``'s
    bits."""
    split = ws[0].wqkv.shape[1] < 3 * xs[0].shape[-1]  # each holds some heads' columns
    first = [j == 0 for j in shards.held]
    r = []
    for x, w, own in zip(xs, ws, first):
        x32 = x.float()
        qkv = dw3x3(qkv_hidden(x32, w.ln1, w.ln1b, w.wqkv, eps), w.dwqkv)
        r.append(attend(x32, qkv, gram_part(qkv, w.temp.numel()), w.temp, w.wproj,
                        residual=own or not split))
    if split:
        r = shards.sum_across(r)
    return shards.sum_across([ffn_f32(ri, w.ln2, w.ln2b, w.win, w.wdw, w.wout, eps,
                                      residual=own) for ri, w, own in zip(r, ws, first)])


def _biases(ln1_w, ln1_b, ln2_w, ln2_b, bias_free: bool):
    if bias_free:
        return None, None
    return (torch.zeros_like(ln1_w) if ln1_b is None else ln1_b,
            torch.zeros_like(ln2_w) if ln2_b is None else ln2_b)


def block_plain(x, ln1_w, ln1_b, w_qkv, dw_qkv, temperature, w_proj, ln2_w,
                ln2_b, w_in, w_dw, w_out, bias_free: bool = True,
                ln_eps: float = 1e-5, num_heads: int = 1) -> torch.Tensor:
    """``fused_transformer_block`` in plain PyTorch (the kernel's
    arithmetic)."""
    c = x.shape[-1]
    temp = temperature.float().reshape(-1)
    _check_heads(c, num_heads, temp)
    ln1_b, ln2_b = _biases(ln1_w, ln1_b, ln2_w, ln2_b, bias_free)

    def opt(t):
        return None if t is None else t.float()

    y = block_f32(
        x, ln1_w.float(), opt(ln1_b), w_qkv.reshape(c, 3 * c).float(),
        dw_qkv.reshape(3, 3, 3 * c).float(), temp,
        w_proj.reshape(c, c).float(), ln2_w.float(), opt(ln2_b),
        w_in.reshape(c, -1).float(), w_dw.reshape(3, 3, -1).float(),
        w_out.reshape(-1, c).float(), ln_eps)
    return y.to(x.dtype)


def _check_heads(c: int, num_heads: int, temp: torch.Tensor) -> None:
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"{num_heads} heads do not divide {c} channels")
    if temp.numel() != num_heads:
        raise ValueError(f"temperature has {temp.numel()} entries for "
                         f"{num_heads} heads")


# ------------------------------------------------------------- CUDA -----

def pack_blocks(device, ln1_w, w_qkv, dw_qkv, temperature, w_proj, ln2_w,
                w_in, w_dw, w_out, ln1_b=None, ln2_b=None, shard: bool = False) -> dict:
    """Kernel operands of n blocks (every weight with a leading ``n`` dim):
    bf16 matrices, fp32 taps, norms and temperatures, and the GDFN's in the
    layout its kernel reads (``ops/gdfn.py::pack_ffn``'s, or on the Hopper
    route its chunks alone). ``ln1_b``/``ln2_b`` stay None for the BiasFree
    LayerNorm. ``shard``: a model shard's block, whose weights hold cq
    channels of q, k and v (W_qkv (C, 3 cq), W_proj (cq, C); ``cq`` in the
    result) and whose GDFN part ``ops/gdfn.py::ffn_route`` routes."""
    n, c = ln1_w.shape
    cq = w_qkv.reshape(n, c, -1).shape[-1] // 3
    bf, f32 = torch.bfloat16, torch.float32

    def cont(t, dtype, *shape):
        if t is None:
            return None
        return t.detach().reshape(n, *shape).to(device=device, dtype=dtype).contiguous()

    p = dict(
        ln1=cont(ln1_w, f32, c), ln1b=cont(ln1_b, f32, c),
        wqkv=cont(w_qkv, bf, c, 3 * cq), dwqkv=cont(dw_qkv, f32, 9, 3 * cq),
        temp=cont(temperature, f32, -1), wproj=cont(w_proj, bf, cq, c), cq=cq,
        ln2=cont(ln2_w, f32, c), ln2b=cont(ln2_b, f32, c))
    ffn = pack_ffn(w_in.reshape(n, c, -1), w_dw.reshape(n, 9, -1), w_out.reshape(n, -1, c), c,
                   device)
    p["fp"] = ffn["fp"]
    route = apply_route(c, shard, p["temp"].shape[1], cq)
    if route == "wgmma":
        p.update(pack_wgmma(p["wqkv"], p["dwqkv"], p["wproj"]))
    if route == "wgmma" or (shard and ffn_route(c) == "wgmma"):  # the GDFN on a Hopper kernel
        p.update(ffn_chunks(ffn["win"], ffn["wdw"], ffn["wout"], ffn["fp"]))
    else:
        p.update(ffn)
    return p


def b_operand(w: torch.Tensor) -> torch.Tensor:
    """B (..., K, N) of a wgmma product laid out as the Hopper kernel reads it
    from shared memory (``csrc/hopper.cuh``): K-major without swizzle, planes
    of 8 along K, each of N/8 core matrices of 8 n-rows by 8 k; flattened
    over the last two dims (K and N multiples of 8)."""
    *lead, k, n = w.shape
    d = len(lead)
    t = w.reshape(*lead, k // 8, 8, n // 8, 8)
    return t.permute(*range(d), d, d + 2, d + 3, d + 1).reshape(*lead, k * n)


def qkv_chunk_order(c: int, cq: int | None = None) -> list[int]:
    """The order in which the Hopper kernel (A) takes W_qkv's chunks of
    WGMMA_QCH columns (chunk i = columns 48 i..48 i + 47 of W_qkv (C, 3 cq),
    cq = C, or a model shard's heads' channels): at C = 96 with every head
    as they lie (q, then k, then v; ``csrc/stage_sm90.cu``); else head by
    head, q_h and k_h side by side (so that head h's Gram follows k_h), then
    every v_h (``csrc/stage_sm90_wide.cu``)."""
    cq = c if cq is None else cq
    nq = 3 * cq // WGMMA_QCH
    if c == WGMMA_C and cq == c:
        return list(range(nq))
    heads = cq // WIDE_HC
    return [t * heads + h for h in range(heads) for t in (0, 1)] + [2 * heads + h
                                                                      for h in range(heads)]


def _in_chunk_order(chunks: torch.Tensor, c: int, cq: int) -> torch.Tensor:
    """Chunks (n, 3 cq / 48, ...) of W_qkv (or its taps) as they lie, put in
    ``qkv_chunk_order`` by reshapes (an index list would be a host-to-device
    copy every call)."""
    if c == WGMMA_C and cq == c:
        return chunks
    n, heads, rest = chunks.shape[0], cq // WIDE_HC, chunks.shape[2:]
    qk = chunks[:, :2 * heads].reshape(n, 2, heads, *rest).transpose(1, 2)
    return torch.cat([qk.reshape(n, 2 * heads, *rest), chunks[:, 2 * heads:]], 1)


def pack_wgmma(wqkv, dwqkv, wproj) -> dict:
    """Kernels (A) and (C)'s (on a model shard (A) and (C')'s) Hopper
    operands (``csrc/stage_sm90.cu`` at C = 96, ``csrc/stage_sm90_wide.cu``
    at 192 and 384 and on model shards) from ``pack_blocks``' (n blocks
    leading), one copy each: W_qkv (n, C, 3 cq) in chunks of WGMMA_QCH
    columns in ``qkv_chunk_order``, each a B operand (N = 48, K = C), and
    their depthwise taps (n, chunks, 9, 48); W_proj (n, cq, C) as one B
    operand, whose rows 48 h..48 h + 47 (a head's) lie together. The GDFN's
    are ``ops/gdfn.py::ffn_chunks``."""
    n, c, _ = wqkv.shape
    cq, qch = wqkv.shape[-1] // 3, WGMMA_QCH
    nq = 3 * cq // qch
    # B element (k, n') at [k / 8][n' / 8][n' % 8][k % 8] of its chunk
    qkv = _in_chunk_order(wqkv.reshape(n, c // 8, 8, nq, qch // 8, 8).permute(0, 3, 1, 4, 5, 2),
                          c, cq)
    qtaps = _in_chunk_order(dwqkv.reshape(n, 9, nq, qch).transpose(1, 2), c, cq)
    return dict(wqkv_wg=qkv.contiguous(), qtaps_wg=qtaps.contiguous(),
                wproj_wg=b_operand(wproj).contiguous())


def apply_route(c: int, shard: bool = False, heads: int | None = None,
                cq: int | None = None) -> str:
    """Which kernels (A) and (C) a block launch takes, by width: ``"wgmma"``
    (Hopper: ``csrc/stage_sm90.cu`` at C = 96, ``csrc/stage_sm90_wide.cu``
    at C = 192 and 384, where the heads, if given, are 48 channels each, as
    every block of the teacher has them), else ``"mma_sync"``
    (``csrc/stage.cu``). On a model shard (``heads`` of them holding cq
    channels of q, k and v; cq = C: every head) the block runs (A) on its
    heads and ends in (C'): at C = 96, 192 and 384 with 48 channels a head
    ``"wgmma"`` (``k_gram_wide`` on the heads, or at C = 96 with every head
    ``k_gram_wgmma``; ``k_proj_wide``), else ``"mma_sync"``. The GDFN that
    follows on a shard is routed by ``ops/gdfn.py::ffn_route``."""
    if shard:
        cq = c if cq is None else cq
        hc = cq // heads if heads else WIDE_HC
        ok = c in WIDE_TILE and cq % WIDE_HC == 0 and hc == WIDE_HC
        return "wgmma" if ok else "mma_sync"
    if c == WGMMA_C or (c in WIDE_TILE and (heads is None or c == heads * WIDE_HC)):
        return "wgmma"
    return "mma_sync"


def readable_rows(h: int, halo: int = 0, y_img: int = 0,
                  h_img: int | None = None) -> tuple[int, int]:
    """Rows [lo, hi) of a band (own rows 0..h-1, ``halo`` more held above
    and below; ``y_img`` its first row in an image of ``h_img``) that lie in
    the image: the rows the Hopper kernel's tensor map of v covers, so that
    TMA's zero fill outside them is the image's zero padding."""
    h_img = h if h_img is None else h_img
    return max(-halo, -y_img), min(h + halo, h_img - y_img)


def wgmma_grid(batch: int, h: int, w: int, n_sm: int, tile=WGMMA_TILE) -> int:
    """Persistent thread blocks of a Hopper kernel over th x tw tiles (the
    C = 96 kernel (C), or the wide (F) with ``WIDE_TILE``): one an SM, no
    more than there are tiles."""
    th, tw = tile
    return min(n_sm, batch * -(-h // th) * -(-w // tw))


def wgmma_tiles(batch: int, h: int, w: int, grid: int, halo: int = 0, y_img: int = 0,
                h_img: int | None = None, tile=WGMMA_TILE) -> list[list[dict]]:
    """The persistent schedule of the Hopper kernel (C) at C = 96
    (``csrc/stage_sm90.cu``), or with ``tile=WIDE_TILE[c]`` of kernel (F)
    at the wide widths (``csrc/stage_sm90_wide.cu``; kernel (A) walks the
    same tiles in groups), as the kernel walks it: for each of ``grid``
    thread blocks its tiles in order (tile t = block, + grid, ...; sample t
    // tiles, row-major within it). A tile is a dict: sample ``b``, output
    origin ``y0``, ``x0``; the halo box it reads, ``rows`` (own rows
    y0..y0+th-1, then the ring y0-1 and y0+th) and ``cols`` (x0-1..x0+tw);
    ``read`` ((th + 2) x (tw + 2), in halo order top to bottom) where its
    input is read, elsewhere zeros; ``out`` (th x tw) the outputs it writes,
    inside the band's own rows and the image's columns."""
    th, tw = tile
    lo, hi = readable_rows(h, halo, y_img, h_img)
    ntj, nti = -(-w // tw), -(-h // th)
    per = nti * ntj
    blocks = []
    for blk in range(grid):
        tiles = []
        for t in range(blk, batch * per, grid):
            b, tt = divmod(t, per)
            y0, x0 = tt // ntj * th, tt % ntj * tw
            hy = np.arange(y0 - 1, y0 + th + 1)[:, None]
            hx = np.arange(x0 - 1, x0 + tw + 1)[None, :]
            read = (hy >= lo) & (hy < hi) & (hx >= 0) & (hx < w)
            out = ((hy >= 0) & (hy < h) & (hx >= 0) & (hx < w))[1:-1, 1:-1]
            tiles.append(dict(b=b, y0=y0, x0=x0,
                              rows=tuple(range(y0, y0 + th)) + (y0 - 1, y0 + th),
                              cols=tuple(range(x0 - 1, x0 + tw + 1)), read=read, out=out))
        blocks.append(tiles)
    return blocks


def proj_tiles(batch: int, h: int, w: int, grid: int, th: int, halo: int = 0, y_img: int = 0,
               h_img: int | None = None) -> list[list[dict]]:
    """The persistent schedule of the wide kernel (P) (``csrc/stage_sm90_wide.cu``
    ``k_proj_wide``): th x 32 pixels a tile over the band's readable rows
    ``readable_rows`` (its halo rows too, where kernel (F) reads r), for each
    of ``grid`` thread blocks its tiles in order. A tile is a dict: sample
    ``b``, origin ``y0`` (a readable row), ``x0``; ``out`` (th x 32) the
    pixels whose r it writes: readable rows, the image's columns."""
    lo, hi = readable_rows(h, halo, y_img, h_img)
    ntj, nti = -(-w // 32), -(-(hi - lo) // th)
    per = nti * ntj
    blocks = []
    for blk in range(grid):
        tiles = []
        for t in range(blk, batch * per, grid):
            b, tt = divmod(t, per)
            y0, x0 = lo + tt // ntj * th, tt % ntj * 32
            ys = np.arange(y0, y0 + th)[:, None]
            xs = np.arange(x0, x0 + 32)[None, :]
            tiles.append(dict(b=b, y0=y0, x0=x0, out=(ys < hi) & (xs < w)))
        blocks.append(tiles)
    return blocks


def proj_grid(batch: int, h: int, w: int, n_sm: int, th: int, halo: int = 0, y_img: int = 0,
              h_img: int | None = None) -> int:
    """Persistent thread blocks of kernel (P): one an SM, no more than its
    tiles."""
    lo, hi = readable_rows(h, halo, y_img, h_img)
    return min(n_sm, batch * -(-(hi - lo) // th) * -(-w // 32))


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "raie_stage_smem_bytes": [_I] * 7,
    "raie_stage_blocks_per_sm": [_I] * 7,
    "raie_stage_shard_smem_bytes": [_I] * 8,
    "raie_stage_shard_blocks_per_sm": [_I] * 8,
    "raie_stage_gram": [_P, _I] + [_P] * 6 + [_I] * 13 + [ctypes.c_float, _P],
    "raie_stage_softmax": [_P, _P, _P] + [_I] * 5 + [_P],
    "raie_stage_apply": [_P, _I, _P, _I] + [_P] * 8 + [_I] * 13
    + [ctypes.c_float, _P],
    "raie_stage_project": [_P, _I] + [_P] * 4 + [_I] * 12 + [_P],
}


_WG_SIGNATURES = {
    "raie_stage_sm90_blocks_per_sm": [],
    "raie_stage_sm90_geometry": [ctypes.POINTER(ctypes.c_int)] * 4,
    "raie_stage_apply_wgmma": [_P, _I, _P, _I, _P, _P, _I] + [_P] * 6 + [_I] * 7
    + [ctypes.c_float, _I, _P],
    "raie_stage_sm90_gram_blocks_per_sm": [],
    "raie_stage_gram_wgmma": [_P, _I] + [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P],
}


_WIDE_SIGNATURES = {
    "raie_stage_wide_blocks_per_sm": [_I, _I],
    "raie_stage_wide_geometry": [_I] + [ctypes.POINTER(ctypes.c_int)] * 4,
    "raie_stage_wide_gram": [_P, _I] + [_P] * 6 + [_I] * 9 + [ctypes.c_float, _P],
    "raie_stage_wide_project": [_P, _I, _P, _P, _P, _I, _P] + [_I] * 8 + [_P],
    "raie_stage_wide_ffn": [_P, _P, _I] + [_P] * 5 + [_I] * 8 + [ctypes.c_float, _I, _P],
}


def lib(name: str = "stage") -> ctypes.CDLL:
    """The library of ``csrc/stage.cu``, or a variant of it built with
    other flags (``_build.VARIANTS``)."""
    return _build.bind(name, _SIGNATURES)


def wg_lib(name: str = "stage_sm90") -> ctypes.CDLL:
    """The library of ``csrc/stage_sm90.cu`` (kernel (C) at C = 96), or its
    instrumented variant."""
    return _build.bind(name, _WG_SIGNATURES)


def wide_lib(name: str = "stage_sm90_wide") -> ctypes.CDLL:
    """The library of ``csrc/stage_sm90_wide.cu`` (kernels (A), (P) and (F)
    at C = 192 and 384), or its instrumented variant."""
    return _build.bind(name, _WIDE_SIGNATURES)


class TilePlan(NamedTuple):
    """Tiles of the Gram kernel (A) and of the apply kernel (C) (on a model
    shard the projection kernel (C')), (C)'s chunk of hidden channels, and
    the thread blocks of each that the device keeps resident on one SM; the
    wide layouts' chunks (0: the C x C weights held whole)."""
    gram_tile: tuple[int, int]
    gram_blocks: int
    fc: int
    apply_tile: tuple[int, int]
    apply_blocks: int
    gram_chunk: int = 0
    apply_chunk: int = 0


def _chunks(c: int, sizes) -> list[int]:
    return [k for k in sizes if k < c and c % k == 0]


def plan_tiles(library, c: int, gram_heads: int, cq: int | None = None) -> TilePlan:
    """The layouts of the Gram kernel (its tile) and of the apply kernel
    (tile and chunk) by ``ops/gdfn.py::pick_layout``: two blocks resident per
    SM where a layout allows it, else one. A kernel takes its wide layout
    (C x C weights in chunks) only where no layout holds them whole. With
    ``cq`` (a model shard's q, k and v channels) those of (A) on the shard's
    heads and of the projection kernel (C') in place of (C)."""

    shard = "" if cq is None else "shard_"
    widths = (c,) if cq is None else (c, cq)

    def pick(kind, candidates, chunks):
        def ask(f):
            return lambda *cand: f(kind, *cand[:2], *widths, gram_heads, *cand[2:])

        smem = ask(getattr(library, f"raie_stage_{shard}smem_bytes"))
        blocks = ask(getattr(library, f"raie_stage_{shard}blocks_per_sm"))
        return (pick_layout([cand + (0,) for cand in candidates], smem, blocks)
                or pick_layout([cand + (k,) for cand in candidates for k in chunks],
                               smem, blocks))

    gram = pick(0, [(th, tw, 0) for th, tw in _GRAM_TILES], _chunks(widths[-1], _GRAM_CHUNKS))
    if cq is None:
        apply = pick(1, ffn_candidates(), _chunks(c, _PROJ_CHUNKS))
    else:  # (C') has no hidden chunk: the smallest, as its layout holds it
        apply = pick(2, [(th, tw, FFN_CHUNKS[-1]) for th, tw in FFN_TILES],
                     _chunks(cq, _PROJ_CHUNKS))
    if gram is None or apply is None:
        raise ValueError(f"no block-kernel tile fits {c} channels")
    (gth, gtw, _, gk), gram_blocks = gram
    (ath, atw, fc, ak), apply_blocks = apply
    return TilePlan((gth, gtw), gram_blocks, fc, (ath, atw), apply_blocks, gk, ak)


def _wg_residency(library, device, c: int | None = None) -> tuple[int, ...]:
    """Thread blocks of the Hopper kernels resident on an SM of ``device``:
    (A) and (C) of ``csrc/stage_sm90.cu`` (``c`` None); (A), (P) and (F) of
    ``csrc/stage_sm90_wide.cu`` at C = ``c``; asked once per card and width
    and kept on the library handle."""
    known = library.__dict__.setdefault("_raie_residency", {})
    if (device, c) not in known:
        with torch.cuda.device(device):
            if c is None:
                blocks = (library.raie_stage_sm90_gram_blocks_per_sm(),
                          library.raie_stage_sm90_blocks_per_sm())
            else:
                blocks = tuple(library.raie_stage_wide_blocks_per_sm(k, c) for k in range(3))
        if min(blocks) < 1:
            raise ValueError(f"the Hopper block kernels at C = {c or WGMMA_C} cannot be "
                             "resident on an SM")
        known[(device, c)] = blocks
    return known[(device, c)]


def gram_groups(n_tiles: int, n_sm: int, batch: int, blocks_per_sm: int = 1) -> int:
    """Tile groups per sample of kernel (A): groups * batch thread blocks
    must be resident at once (one wave), with at most one group per tile."""
    return max(1, min(n_tiles, blocks_per_sm * n_sm // batch))


class BlockRunner:
    """Scratch and launch geometry of the block kernels for one checked
    input (``check_input``); ``run`` is one TransformerBlock (three
    launches) from ``src`` to ``dst``, either float32 or bfloat16.

    ``band=(first_row, image_rows)``: x is a band of rows of a taller image,
    held with one halo row above and one below its own (B, rows + 2, W, C),
    and so are ``src``, ``dst`` and ``v``; the kernels zero-pad only at the
    image's own edges and read the halo rows elsewhere. A band runs
    ``gram``, ``softmax`` and ``apply`` apart, since every band's partial
    Gram (``part``) meets between the first two
    (``ops/stage.py::fused_transformer_stage_bands``).

    ``cq``: a model shard's block (``ops/stage.py::
    fused_transformer_stage_shards``), ``heads`` of the shard holding cq
    channels of q, k and v (cq = C: the whole MDTA); it runs ``gram``,
    ``softmax`` and ``project`` (kernel (C'), r in fp32) in place of
    ``apply``, the GDFN being ``ops/gdfn.py``'s kernel on the shard's
    hidden channels. Its ``route`` ``"wgmma"`` (C = 96, 192, 384, 48
    channels a head): ``gram`` is ``csrc/stage_sm90_wide.cu``'s (A) on the
    shard's heads (``csrc/stage_sm90.cu``'s at C = 96 where it holds every
    head: ``gram_lib``), ``project`` its (P) on ``proj_grid`` blocks.

    ``route`` (``apply_route``): at C = 96, off a model shard, ``apply`` is
    ``csrc/stage_sm90.cu``'s kernel (``wg_library``, or its default) on
    ``apply_grid`` persistent blocks; ``plan`` then holds its tile. At C =
    192 and 384 (48 channels a head) ``gram`` and ``apply`` are
    ``csrc/stage_sm90_wide.cu``'s (``wg_library`` that library): ``apply``
    writes r (``self.r``, float32, the held shape) by kernel (P) on
    ``proj_grid`` blocks, then the output by kernel (F) on ``apply_grid``."""

    def __init__(self, x: torch.Tensor, heads: int, fp: int, library=None,
                 band: tuple[int, int] | None = None, cq: int | None = None,
                 wg_library=None):
        b, h, w, c = x.shape
        self.halo = 0 if band is None else 1
        h -= 2 * self.halo
        self.y_img, self.h_img = (0, h) if band is None else band
        if h < 1 or self.y_img < 0 or self.y_img + h > self.h_img:
            raise ValueError(f"block kernel: rows [{self.y_img}, {self.y_img + h}) "
                             f"are no band of an image of {self.h_img} rows")
        self.lib = lib() if library is None else library
        self.device = x.device
        self.shape = (b, h, w, c)
        self.heads, self.fp = heads, fp
        self.shard = cq is not None
        self.cq = c if cq is None else cq
        self._checked = None
        # the Gram per head where fragments of 16 channels stay inside a
        # head; else the full C x C Gram with the softmax masked per head
        self.gram_heads = heads if (self.cq // heads) % 16 == 0 else 1
        self.route = apply_route(c, self.shard, heads, self.cq)
        self.wide = self.route == "wgmma" and (c != WGMMA_C or self.shard)
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        if self.wide:
            self.wg_lib = wide_lib() if wg_library is None else wg_library
            gram_blocks, proj_blocks, blocks = _wg_residency(self.wg_lib, x.device, c)
            tile = WIDE_TILE[c]
            # a model shard holding every head at C = 96 runs stage_sm90.cu's
            # (A): k_gram_wide with both heads took 1.07x its time (PERF.md §6)
            self.wide_gram = not (self.shard and c == WGMMA_C and self.cq == c)
            self.gram_lib = self.wg_lib
            if not self.wide_gram:
                self.gram_lib = wg_lib() if wg_library is None else wg_library
                gram_blocks = _wg_residency(self.gram_lib, x.device)[0]
            self.plan = TilePlan(tile if self.wide_gram else WGMMA_TILE, gram_blocks, WGMMA_FC,
                                 tile, blocks)
            self.apply_grid = wgmma_grid(b, h, w, n_sm * blocks, tile)
            self.proj_grid = proj_grid(b, h, w, n_sm * proj_blocks, PROJ_TH[c], self.halo,
                                       self.y_img, self.h_img)
            if not self.shard:  # (P)'s r; a shard's (C') writes the r it is given
                self.r = torch.empty(*x.shape[:3], c, dtype=torch.float32, device=x.device)
        elif self.route == "wgmma":
            self.wg_lib = self.gram_lib = wg_lib() if wg_library is None else wg_library
            self.wide_gram = False
            gram_blocks, blocks = _wg_residency(self.wg_lib, x.device)
            self.plan = TilePlan(WGMMA_TILE, gram_blocks, WGMMA_FC, WGMMA_TILE, blocks)
            self.apply_grid = wgmma_grid(b, h, w, n_sm * blocks)
        else:
            with torch.cuda.device(x.device):  # occupancy of x's card
                self.plan = plan_tiles(self.lib, c, self.gram_heads, cq)
        (self.gth, self.gtw), self.fc = self.plan.gram_tile, self.plan.fc
        self.ath, self.atw = self.plan.apply_tile
        n_tiles = -(-h // self.gth) * -(-w // self.gtw)
        self.groups = gram_groups(n_tiles, n_sm, b, self.plan.gram_blocks)
        ghc = self.cq // self.gram_heads
        dev = x.device
        self.part = torch.empty(b, self.groups, self.gram_heads * ghc * ghc + 2 * self.cq,
                                dtype=torch.float32, device=dev)
        self.attn_t = torch.empty(b, self.gram_heads, ghc, ghc,
                                  dtype=torch.bfloat16, device=dev)
        self.v = torch.empty(*x.shape[:3], self.cq, dtype=torch.bfloat16, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def _guard(self, src: torch.Tensor, p: dict, **more):
        if src.device != self.device:
            raise ValueError(f"block kernel: runner made for {self.device}, "
                             f"src on {src.device}")
        if p is not self._checked:  # a packed dict's weights checked once
            tensors = {k: v for k, v in p.items() if isinstance(v, torch.Tensor)}
            _build.on_device(src, "block", **tensors)
            self._checked = p
        return _build.on_device(src, "block", **more)

    def gram(self, src: torch.Tensor, p: dict, i: int, eps: float) -> None:
        """(A): v and this input's partial Gram and norms into ``part``."""
        b, h, w, c = self.shape
        lb = self.lib
        ptr = _ptr(p, i)
        if self.route == "wgmma":
            with self._guard(src, p):
                (gram_wide if self.wide_gram else gram_wgmma)(self, src, ptr, eps)
            return
        with self._guard(src, p):
            _build.check(lb, "stage", lb.raie_stage_gram(
                src.data_ptr(), int(src.dtype == torch.bfloat16), ptr("ln1"),
                ptr("ln1b"), ptr("wqkv"), ptr("dwqkv"), self.part.data_ptr(),
                self.v.data_ptr(), b, h, w, c, self.cq, self.gram_heads, self.gth,
                self.gtw, self.groups, self.plan.gram_chunk, self.halo,
                self.y_img, self.h_img, eps, self.stream), "A (Gram)")

    def softmax(self, part: torch.Tensor, p: dict, i: int) -> None:
        """(B): attn^T from ``part`` (this runner's, or every band's side by
        side along its groups, on this device)."""
        b = self.shape[0]
        lb = self.lib
        if part.device != self.device or part.shape[0] != b or part.shape[2:] != self.part.shape[2:]:
            raise ValueError(f"block kernel: partial Grams {tuple(part.shape)} on "
                             f"{part.device} for a runner of {tuple(self.part.shape)} "
                             f"on {self.device}")
        with self._guard(part, p):
            _build.check(lb, "stage", lb.raie_stage_softmax(
                part.data_ptr(), _ptr(p, i)("temp"), self.attn_t.data_ptr(), b, self.cq,
                self.gram_heads, self.heads, part.shape[1], self.stream),
                "B (softmax)")

    def project(self, src: torch.Tensor | None, r: torch.Tensor, p: dict, i: int) -> None:
        """(C'), a shard's: r (float32, src's shape) = src + (attn @ v) @ its
        rows of W_proj; ``src`` None: the product alone."""
        b, h, w, c = self.shape
        lb = self.lib
        if not self.shard:
            raise ValueError("block kernel: project runs a model shard's block")
        if r.dtype != torch.float32 or r.shape[:3] != self.v.shape[:3] or r.shape[3] != c:
            raise ValueError(f"block kernel: r must be float32 {(*self.v.shape[:3], c)}, "
                             f"got {r.dtype} {tuple(r.shape)}")
        if self.route == "wgmma":
            with self._guard(r if src is None else src, p, r=r):
                proj_wide(self, src, _ptr(p, i), r)
            return
        with self._guard(r if src is None else src, p, r=r):
            _build.check(lb, "stage", lb.raie_stage_project(
                None if src is None else src.data_ptr(),
                int(src is not None and src.dtype == torch.bfloat16), r.data_ptr(),
                self.v.data_ptr(), self.attn_t.data_ptr(), _ptr(p, i)("wproj"), b, h, w, c,
                self.cq, self.gram_heads, self.ath, self.atw, self.plan.apply_chunk,
                self.halo, self.y_img, self.h_img, self.stream), "C' (project)")

    def apply(self, src: torch.Tensor, dst: torch.Tensor, p: dict, i: int,
              eps: float) -> None:
        """(C): dst = the block's output from src, v and attn^T."""
        b, h, w, c = self.shape
        lb = self.lib
        if self.shard:
            raise ValueError("block kernel: a model shard's block ends in project")
        ptr = _ptr(p, i)
        if self.wide:
            with self._guard(src, p, dst=dst):
                proj_wide(self, src, ptr, self.r)
                ffn_wide(self, dst, ptr, eps)
            return
        if self.route == "wgmma":
            with self._guard(src, p, dst=dst):
                apply_wgmma(self, src, dst, ptr, eps)
            return
        with self._guard(src, p, dst=dst):
            _build.check(lb, "stage", lb.raie_stage_apply(
                src.data_ptr(), int(src.dtype == torch.bfloat16), dst.data_ptr(),
                int(dst.dtype == torch.bfloat16), self.v.data_ptr(),
                self.attn_t.data_ptr(), ptr("wproj"), ptr("ln2"), ptr("ln2b"),
                ptr("win"), ptr("wdw"), ptr("wout"), b, h, w, c,
                self.gram_heads, self.fp, self.fc, self.ath, self.atw,
                self.plan.apply_chunk, self.halo, self.y_img, self.h_img, eps,
                self.stream), "C (apply)")

    def run(self, src: torch.Tensor, dst: torch.Tensor, p: dict, i: int,
            eps: float) -> None:
        """Block i of the packed weights p (``pack_blocks``) on the device
        the runner was made for, where ``src``, ``dst`` and p must lie."""
        self.gram(src, p, i, eps)
        self.softmax(self.part, p, i)
        self.apply(src, dst, p, i, eps)


def gram_wgmma(run: BlockRunner, src: torch.Tensor, ptr, eps: float) -> None:
    """Kernel (A) at C = 96 (``csrc/stage_sm90.cu::k_gram_wgmma``) for
    runner ``run`` on src, its weights at ``ptr`` (``_ptr``); counts the
    launch in ``gram_wgmma.launches``."""
    b, h, w, _ = run.shape
    lw = run.gram_lib
    _build.check(lw, "stage_sm90", lw.raie_stage_gram_wgmma(
        src.data_ptr(), int(src.dtype == torch.bfloat16), ptr("ln1"), ptr("ln1b"),
        ptr("wqkv_wg"), ptr("qtaps_wg"), run.part.data_ptr(), run.v.data_ptr(), b, h, w,
        run.gram_heads, run.groups, run.halo, run.y_img, run.h_img, eps, run.stream),
        "A (Gram, wgmma)")
    _build.count_launch(gram_wgmma)


def apply_wgmma(run: BlockRunner, src: torch.Tensor, dst: torch.Tensor, ptr,
                eps: float) -> None:
    """Kernel (C) at C = 96 (``csrc/stage_sm90.cu::k_apply_wgmma``) from src
    to dst; counts the launch in ``apply_wgmma.launches``."""
    b, h, w, _ = run.shape
    lw = run.wg_lib
    _build.check(lw, "stage_sm90", lw.raie_stage_apply_wgmma(
        src.data_ptr(), int(src.dtype == torch.bfloat16), dst.data_ptr(),
        int(dst.dtype == torch.bfloat16), run.v.data_ptr(), run.attn_t.data_ptr(),
        run.gram_heads, ptr("wproj_wg"), ptr("ln2"), ptr("ln2b"), ptr("win_wg"),
        ptr("wtaps_wg"), ptr("wout_wg"), b, h, w, run.fp, run.halo, run.y_img, run.h_img,
        eps, run.apply_grid, run.stream), "C (apply, wgmma)")
    _build.count_launch(apply_wgmma)


gram_wgmma.launches = 0  # kernel (A) launches at C = 96
apply_wgmma.launches = 0  # kernel (C) launches at C = 96


def gram_wide(run: BlockRunner, src: torch.Tensor, ptr, eps: float) -> None:
    """Kernel (A) at C = 192 or 384 (``csrc/stage_sm90_wide.cu::k_gram_wide``),
    or on a model shard's heads at C = 96, 192 or 384, for runner ``run`` on
    src; counts the launch in ``gram_wide.launches``."""
    b, h, w, c = run.shape
    lw = run.wg_lib
    _build.check(lw, "stage_sm90_wide", lw.raie_stage_wide_gram(
        src.data_ptr(), int(src.dtype == torch.bfloat16), ptr("ln1"), ptr("ln1b"),
        ptr("wqkv_wg"), ptr("qtaps_wg"), run.part.data_ptr(), run.v.data_ptr(), b, h, w, c,
        run.gram_heads, run.groups, run.halo, run.y_img, run.h_img, eps, run.stream),
        "A (Gram, wide)")
    _build.count_launch(gram_wide)


def proj_wide(run: BlockRunner, src: torch.Tensor | None, ptr,
              r: torch.Tensor | None = None) -> None:
    """Kernel (P) at C = 192 or 384 (``k_proj_wide``), or a model shard's (C')
    at C = 96, 192 or 384 on its heads: r (``run.r`` by default) = src +
    bf16(attn @ v) @ W_proj in float32 on every readable row the band holds,
    ``src`` None: the product alone; counts the launch in
    ``proj_wide.launches``."""
    b, h, w, c = run.shape
    lw = run.wg_lib
    r = run.r if r is None else r
    _build.check(lw, "stage_sm90_wide", lw.raie_stage_wide_project(
        None if src is None else src.data_ptr(),
        int(src is not None and src.dtype == torch.bfloat16), r.data_ptr(), run.v.data_ptr(),
        run.attn_t.data_ptr(), run.gram_heads, ptr("wproj_wg"), b, h, w, c, run.halo,
        run.y_img, run.h_img, run.proj_grid, run.stream), "P (projection, wide)")
    _build.count_launch(proj_wide)


def ffn_wide(run: BlockRunner, dst: torch.Tensor, ptr, eps: float) -> None:
    """Kernel (F) at C = 192 or 384 (``k_ffn_wide``): dst = r + GDFN(LN2(r))
    from ``run.r``; counts the launch in ``ffn_wide.launches``."""
    b, h, w, c = run.shape
    lw = run.wg_lib
    _build.check(lw, "stage_sm90_wide", lw.raie_stage_wide_ffn(
        run.r.data_ptr(), dst.data_ptr(), int(dst.dtype == torch.bfloat16), ptr("ln2"),
        ptr("ln2b"), ptr("win_wg"), ptr("wtaps_wg"), ptr("wout_wg"), b, h, w, c, run.fp,
        run.halo, run.y_img, run.h_img, eps, run.apply_grid, run.stream), "F (GDFN, wide)")
    _build.count_launch(ffn_wide)


gram_wide.launches = 0  # kernel (A) launches at C = 192 and 384, and on model shards
proj_wide.launches = 0  # kernel (P) launches at C = 192 and 384, and on model shards
ffn_wide.launches = 0  # kernel (F) launches at C = 192 and 384


def _ptr(p: dict, i: int):
    """Block i's pointer of a packed weight (None for an absent bias), by
    arithmetic on the stacked tensor (no view made a launch)."""

    def at(name):
        t = p[name]
        return None if t is None else t.data_ptr() + i * t.stride(0) * t.element_size()

    return at


def _block_cuda(x, ln1_w, ln1_b, w_qkv, dw_qkv, temperature, w_proj, ln2_w,
                ln2_b, w_in, w_dw, w_out, bias_free, ln_eps,
                num_heads) -> torch.Tensor:
    x = check_input(x, "block")
    if x.shape[0] != 1:
        raise ValueError(f"block kernel takes batch 1, got {x.shape[0]}")
    c = x.shape[-1]
    guard = _build.on_device(
        x, "block", ln1_w=ln1_w, ln1_b=ln1_b, w_qkv=w_qkv, dw_qkv=dw_qkv,
        temperature=temperature, w_proj=w_proj, ln2_w=ln2_w, ln2_b=ln2_b,
        w_in=w_in, w_dw=w_dw, w_out=w_out)
    with guard:
        _check_heads(c, num_heads, temperature.reshape(-1))
        ln1_b, ln2_b = _biases(ln1_w, ln1_b, ln2_w, ln2_b, bias_free)

        def one(t):
            return None if t is None else t[None]

        p = pack_blocks(x.device, one(ln1_w), one(w_qkv), one(dw_qkv),
                        one(temperature), one(w_proj), one(ln2_w), one(w_in),
                        one(w_dw), one(w_out), one(ln1_b), one(ln2_b))
        y = torch.empty_like(x)
        BlockRunner(x, num_heads, p["fp"]).run(x, y, p, 0, ln_eps)
    _build.count_launch(fused_transformer_block)
    return y


def fused_transformer_block(x, ln1_w, ln1_b, w_qkv, dw_qkv, temperature,
                            w_proj, ln2_w, ln2_b, w_in, w_dw, w_out,
                            bias_free: bool = True, ln_eps: float = 1e-5,
                            num_heads: int = 1) -> torch.Tensor:
    """One TransformerBlock on NHWC x of batch 1 (see the module docstring).
    A CUDA tensor launches the kernels (or raises); a CPU tensor takes the
    plain version."""
    args = (x, ln1_w, ln1_b, w_qkv, dw_qkv, temperature, w_proj, ln2_w,
            ln2_b, w_in, w_dw, w_out, bias_free, ln_eps, num_heads)
    if x.device.type == "cuda":
        return _block_cuda(*args)
    if x.device.type == "cpu":
        return block_plain(*args)
    raise ValueError(f"no block implementation for device {x.device}")


fused_transformer_block.launches = 0  # CUDA block calls (3 launches each)
