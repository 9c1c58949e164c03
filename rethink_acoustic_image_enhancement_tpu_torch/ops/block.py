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
there too, and counts the call in ``fused_transformer_block.launches``; on a CPU tensor it runs
``block_plain``, the same arithmetic in plain PyTorch: bf16 operands with
float32 accumulation for the five products, the qkv and W_in outputs
rounded to bf16 before their float32 depthwise 3x3, two-pass LayerNorm and
exact-erf GELU. ``ops/stage.py`` runs N BiasFree blocks through the same
launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .gdfn import (bf16_round, check_input, dw3x3, ffn_candidates,
                   ffn_f32, pack_ffn, pick_layout)
from .norm import channel_layernorm

_L2_EPS = 1e-12
_GRAM_TILES = ((8, 16), (8, 8), (4, 8), (4, 4))


# ------------------------------------------------------------- plain ----

def block_f32(x, ln1, ln1b, wqkv, dwqkv, temp, wproj, ln2, ln2b, win, wdw,
              wout, eps) -> torch.Tensor:
    """One block in float32 out, on float32 2-D/3-D weights (C, 3C),
    (3, 3, 3C), (heads,), (C, C), (C, 2F), (3, 3, 2F), (F, C); a None bias
    is the BiasFree LayerNorm."""
    b, h, w, c = x.shape
    heads = temp.numel()
    hc = c // heads
    x32 = x.float()
    t = bf16_round(bf16_round(channel_layernorm(x32, ln1, ln1b, eps=eps))
                   @ bf16_round(wqkv))
    qkv = dw3x3(t, dwqkv)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, h * w, heads, hc)
               for i in range(3))
    gram = torch.einsum("bphc,bphd->bhcd", bf16_round(q), bf16_round(k))
    qnorm = q.square().sum(1).sqrt().clamp_min(_L2_EPS)  # (b, heads, hc)
    knorm = k.square().sum(1).sqrt().clamp_min(_L2_EPS)
    logits = (gram / qnorm[..., :, None] / knorm[..., None, :]
              * temp.reshape(1, heads, 1, 1))
    attn = torch.softmax(logits, dim=-1)
    oa = torch.einsum("bhcd,bphd->bphc", bf16_round(attn),
                      bf16_round(v)).reshape(b, h, w, c)
    r = x32 + bf16_round(oa) @ bf16_round(wproj)
    return ffn_f32(r, ln2, ln2b, win, wdw, wout, eps)


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
                w_in, w_dw, w_out, ln1_b=None, ln2_b=None) -> dict:
    """Kernel operands of n blocks (every weight with a leading ``n`` dim):
    bf16 matrices, fp32 taps, norms and temperatures, and the GDFN's as
    ``ops/gdfn.py::pack_ffn`` lays them out. ``ln1_b``/``ln2_b`` stay None
    for the BiasFree LayerNorm."""
    n, c = ln1_w.shape
    bf, f32 = torch.bfloat16, torch.float32

    def cont(t, dtype, *shape):
        if t is None:
            return None
        return t.detach().reshape(n, *shape).to(device=device, dtype=dtype).contiguous()

    return dict(
        ln1=cont(ln1_w, f32, c), ln1b=cont(ln1_b, f32, c),
        wqkv=cont(w_qkv, bf, c, 3 * c), dwqkv=cont(dw_qkv, f32, 9, 3 * c),
        temp=cont(temperature, f32, -1), wproj=cont(w_proj, bf, c, c),
        ln2=cont(ln2_w, f32, c), ln2b=cont(ln2_b, f32, c),
        **pack_ffn(w_in.reshape(n, c, -1), w_dw.reshape(n, 9, -1),
                   w_out.reshape(n, -1, c), c, device))


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "raie_stage_smem_bytes": [_I] * 6,
    "raie_stage_blocks_per_sm": [_I] * 6,
    "raie_stage_gram": [_P, _I] + [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P],
    "raie_stage_softmax": [_P, _P, _P] + [_I] * 5 + [_P],
    "raie_stage_apply": [_P, _I, _P, _I] + [_P] * 8 + [_I] * 9
    + [ctypes.c_float, _P],
}


def lib(name: str = "stage") -> ctypes.CDLL:
    """The library of ``csrc/stage.cu``, or a variant of it built with
    other flags (``_build.VARIANTS``)."""
    return _build.bind(name, _SIGNATURES)


class TilePlan(NamedTuple):
    """Tiles of the Gram kernel (A) and of the apply kernel (C), (C)'s chunk
    of hidden channels, and the thread blocks of each that the device keeps
    resident on one SM."""
    gram_tile: tuple[int, int]
    gram_blocks: int
    fc: int
    apply_tile: tuple[int, int]
    apply_blocks: int


def plan_tiles(library, c: int, gram_heads: int) -> TilePlan:
    """The layouts of the Gram kernel (its tile) and of the apply kernel
    (tile and chunk) by ``ops/gdfn.py::pick_layout``: two blocks resident per
    SM where a layout allows it, else one."""
    gram = pick_layout(
        [(th, tw) for th, tw in _GRAM_TILES],
        lambda th, tw: library.raie_stage_smem_bytes(0, th, tw, c, gram_heads, 0),
        lambda th, tw: library.raie_stage_blocks_per_sm(0, th, tw, c, gram_heads, 0))
    apply = pick_layout(
        ffn_candidates(),
        lambda th, tw, fc: library.raie_stage_smem_bytes(1, th, tw, c, gram_heads, fc),
        lambda th, tw, fc: library.raie_stage_blocks_per_sm(1, th, tw, c, gram_heads, fc))
    if gram is None or apply is None:
        raise ValueError(f"no block-kernel tile fits {c} channels")
    (ath, atw, fc), apply_blocks = apply
    return TilePlan(gram[0], gram[1], fc, (ath, atw), apply_blocks)


def gram_groups(n_tiles: int, n_sm: int, batch: int, blocks_per_sm: int = 1) -> int:
    """Tile groups per sample of kernel (A): groups * batch thread blocks
    must be resident at once (one wave), with at most one group per tile."""
    return max(1, min(n_tiles, blocks_per_sm * n_sm // batch))


class BlockRunner:
    """Scratch and launch geometry of the block kernels for one checked
    input (``check_input``); ``run`` is one TransformerBlock (three
    launches) from ``src`` to ``dst``, either float32 or bfloat16."""

    def __init__(self, x: torch.Tensor, heads: int, fp: int, library=None):
        b, h, w, c = x.shape
        self.lib = lib() if library is None else library
        self.device = x.device
        self.shape = (b, h, w, c)
        self.heads, self.fp = heads, fp
        # the Gram per head where fragments of 16 channels stay inside a
        # head; else the full C x C Gram with the softmax masked per head
        self.gram_heads = heads if (c // heads) % 16 == 0 else 1
        with torch.cuda.device(x.device):  # occupancy of x's card
            self.plan = plan_tiles(self.lib, c, self.gram_heads)
        (self.gth, self.gtw), self.fc = self.plan.gram_tile, self.plan.fc
        self.ath, self.atw = self.plan.apply_tile
        n_tiles = -(-h // self.gth) * -(-w // self.gtw)
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        self.groups = gram_groups(n_tiles, n_sm, b, self.plan.gram_blocks)
        ghc = c // self.gram_heads
        dev = x.device
        self.part = torch.empty(b, self.groups, self.gram_heads * ghc * ghc + 2 * c,
                                dtype=torch.float32, device=dev)
        self.attn_t = torch.empty(b, self.gram_heads, ghc, ghc,
                                  dtype=torch.bfloat16, device=dev)
        self.v = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def run(self, src: torch.Tensor, dst: torch.Tensor, p: dict, i: int,
            eps: float) -> None:
        """Block i of the packed weights p (``pack_blocks``) on the device
        the runner was made for, where ``src``, ``dst`` and p must lie."""
        if src.device != self.device:
            raise ValueError(f"block kernel: runner made for {self.device}, "
                             f"src on {src.device}")
        b, h, w, c = self.shape
        lb = self.lib
        tensors = {k: v for k, v in p.items() if isinstance(v, torch.Tensor)}

        def ptr(name):
            return None if p[name] is None else p[name][i].data_ptr()

        src_bf16 = int(src.dtype == torch.bfloat16)
        with _build.on_device(src, "block", dst=dst, **tensors):
            _build.check(lb, "stage", lb.raie_stage_gram(
                src.data_ptr(), src_bf16, ptr("ln1"), ptr("ln1b"), ptr("wqkv"),
                ptr("dwqkv"), self.part.data_ptr(), self.v.data_ptr(), b, h, w,
                c, self.gram_heads, self.gth, self.gtw, self.groups, eps,
                self.stream), "A (Gram)")
            _build.check(lb, "stage", lb.raie_stage_softmax(
                self.part.data_ptr(), ptr("temp"), self.attn_t.data_ptr(), b, c,
                self.gram_heads, self.heads, self.groups, self.stream),
                "B (softmax)")
            _build.check(lb, "stage", lb.raie_stage_apply(
                src.data_ptr(), src_bf16, dst.data_ptr(),
                int(dst.dtype == torch.bfloat16), self.v.data_ptr(),
                self.attn_t.data_ptr(), ptr("wproj"), ptr("ln2"), ptr("ln2b"),
                ptr("win"), ptr("wdw"), ptr("wout"), b, h, w, c,
                self.gram_heads, self.fp, self.fc, self.ath, self.atw, eps,
                self.stream), "C (apply)")


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
