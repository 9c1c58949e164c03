"""Transformer stage: N consecutive BiasFree TransformerBlocks in one call.

``fused_transformer_stage`` keeps the JAX signature and layouts
(``ops/pallas/stage.py:234-250``): x is NHWC (float32 or bfloat16), the
weights are stacked with a leading ``n_blocks`` dim in the flax layouts
  ln1_w/ln2_w (N, C); w_qkv (N, 1, 1, C, 3C); dw_qkv (N, 3, 3, 1, 3C);
  temperature (N, heads, 1, 1) or (N, heads); w_proj (N, 1, 1, C, C);
  w_in (N, 1, 1, C, 2F); w_dw (N, 3, 3, 1, 2F); w_out (N, 1, 1, F, C).
Samples are independent (per-sample MDTA statistics).

On a CUDA tensor it runs the Hopper kernel ``csrc/stage.cu`` (three
launches per block, see the note there) and counts the call in
``fused_transformer_stage.launches``; on a CPU tensor it runs
``stage_plain``, the same arithmetic in plain PyTorch: bf16 operands with
float32 accumulation for the five products, the qkv and W_in outputs
rounded to bf16 before their float32 depthwise 3x3, two-pass LayerNorm and
exact-erf GELU (the kernel's Abramowitz-Stegun erf is within 1.5e-7).
Blocks hand their output to the next in float32; only the stage's output
is cast to x's dtype (the TPU kernel stored every block's output in x's
dtype).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .norm import channel_layernorm

_L2_EPS = 1e-12
_HIDDEN_CHUNK = 64  # csrc/stage.cu FC: the padded hidden width's unit
_SMEM_LIMIT = 232448
_GRAM_TILES = ((8, 16), (8, 8), (4, 8), (4, 4))
_APPLY_TILES = ((8, 8), (4, 8), (4, 4))


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

def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in float32 (a bf16 operand whose
    products accumulate in float32)."""
    return t.to(torch.bfloat16).float()


def _dw3x3(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Zero-padded depthwise 3x3 on NHWC float32, taps (3, 3, K) in the
    kernel's order."""
    h, w_ = t.shape[1], t.shape[2]
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(t)
    for di in range(3):
        for dj in range(3):
            acc = acc + tp[:, di:di + h, dj:dj + w_, :] * w[di, dj]
    return acc


def _block_plain(x, ln1, wqkv, dwqkv, temp, wproj, ln2, win, wdw, wout,
                 eps):
    b, h, w, c = x.shape
    heads = temp.numel()
    hc = c // heads
    f = wout.shape[0]
    x32 = x.float()
    t = _bf(_bf(channel_layernorm(x32, ln1, eps=eps)) @ _bf(wqkv))
    qkv = _dw3x3(t, dwqkv)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, h * w, heads, hc)
               for i in range(3))
    gram = torch.einsum("bphc,bphd->bhcd", _bf(q), _bf(k))
    qnorm = q.square().sum(1).sqrt().clamp_min(_L2_EPS)  # (b, heads, hc)
    knorm = k.square().sum(1).sqrt().clamp_min(_L2_EPS)
    logits = (gram / qnorm[..., :, None] / knorm[..., None, :]
              * temp.reshape(1, heads, 1, 1))
    attn = torch.softmax(logits, dim=-1)
    oa = torch.einsum("bhcd,bphd->bphc", _bf(attn), _bf(v)).reshape(b, h, w, c)
    r = x32 + _bf(oa) @ _bf(wproj)
    t2 = _bf(_bf(channel_layernorm(r, ln2, eps=eps)) @ _bf(win))
    a2 = _dw3x3(t2, wdw)
    x1, x2 = a2[..., :f], a2[..., f:]
    g = 0.5 * x1 * (1.0 + torch.erf(x1 * 2.0 ** -0.5)) * x2
    return _bf(g) @ _bf(wout) + r


def stage_plain(x, ln1_w, w_qkv, dw_qkv, temperature, w_proj, ln2_w, w_in,
                w_dw, w_out, ln_eps: float = 1e-5) -> torch.Tensor:
    """The stage in plain PyTorch (the kernel's arithmetic)."""
    n = ln1_w.shape[0]
    c = x.shape[-1]
    temp = temperature.float().reshape(n, -1)
    if c % temp.shape[1]:
        raise ValueError(f"{temp.shape[1]} heads do not divide {c} channels")
    y = x
    for i in range(n):  # blocks hand over in float32
        y = _block_plain(
            y, ln1_w[i].float(), w_qkv[i].reshape(c, 3 * c).float(),
            dw_qkv[i].reshape(3, 3, 3 * c).float(), temp[i],
            w_proj[i].reshape(c, c).float(), ln2_w[i].float(),
            w_in[i].reshape(c, -1).float(),
            w_dw[i].reshape(3, 3, -1).float(),
            w_out[i].reshape(-1, c).float(), ln_eps)
    return y.to(x.dtype)


# ------------------------------------------------------------- CUDA -----

def _pack(x, ln1_w, w_qkv, dw_qkv, temperature, w_proj, ln2_w, w_in, w_dw,
          w_out):
    """Kernel operands: bf16 matrices, fp32 taps and norms; the hidden
    width F padded to Fp (a multiple of 64) with x1 at [0, F) and x2 at
    [Fp, Fp + F)."""
    n, c = ln1_w.shape
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    f = w_out.reshape(n, -1, c).shape[1]
    fp = -(-f // _HIDDEN_CHUNK) * _HIDDEN_CHUNK
    w_in = w_in.reshape(n, c, 2 * f)
    w_dw = w_dw.reshape(n, 9, 2 * f)
    win = torch.zeros(n, c, 2 * fp, dtype=bf, device=dev)
    win[:, :, :f] = w_in[:, :, :f]
    win[:, :, fp:fp + f] = w_in[:, :, f:]
    wdw = torch.zeros(n, 9, 2 * fp, dtype=f32, device=dev)
    wdw[:, :, :f] = w_dw[:, :, :f]
    wdw[:, :, fp:fp + f] = w_dw[:, :, f:]
    wout = torch.zeros(n, fp, c, dtype=bf, device=dev)
    wout[:, :f] = w_out.reshape(n, f, c)

    def cont(t, dtype, *shape):
        return t.reshape(n, *shape).to(device=dev, dtype=dtype).contiguous()

    return dict(
        ln1=cont(ln1_w, f32, c), wqkv=cont(w_qkv, bf, c, 3 * c),
        dwqkv=cont(dw_qkv, f32, 9, 3 * c), temp=cont(temperature, f32, -1),
        wproj=cont(w_proj, bf, c, c), ln2=cont(ln2_w, f32, c),
        win=win, wdw=wdw, wout=wout, fp=fp)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "raie_stage_smem_bytes": [_I] * 6,
    "raie_stage_gram": [_P, _I, _P, _P, _P, _P, _P] + [_I] * 9 + [ctypes.c_float, _P],
    "raie_stage_softmax": [_P, _P, _P, _I, _I, _I, _I, _P],
    "raie_stage_apply": [_P, _I, _P, _I] + [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("stage")
    if not getattr(lib, "_raie_typed", False):
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.raie_stage_error_string.argtypes = [ctypes.c_int]
        lib.raie_stage_error_string.restype = ctypes.c_char_p
        lib._raie_typed = True
    return lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.raie_stage_error_string(code).decode()
        raise RuntimeError(f"stage kernel {what} failed ({code}): {msg}")


def plan_tiles(lib, c: int, heads: int,
               fp: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The largest (th, tw) of kernels A and C whose shared memory fits in
    its smaller layout (the kernel takes the larger one where that fits)."""

    def pick(kind, cands):
        for th, tw in cands:
            if lib.raie_stage_smem_bytes(kind, th, tw, c, heads, fp) <= _SMEM_LIMIT:
                return th, tw
        raise ValueError(f"no stage-kernel tile fits {c} channels")

    return pick(0, _GRAM_TILES), pick(1, _APPLY_TILES)


def _stage_cuda(x, ln_eps, **weights) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stage kernel takes float32 or bfloat16, not {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"stage kernel takes NHWC input, got {tuple(x.shape)}")
    x = x.contiguous()
    b, h, w, c = x.shape
    p = _pack(x, **weights)
    n, heads = p["temp"].shape
    hc = c // heads
    if c % heads or hc % 16:
        raise ValueError(f"stage kernel needs C/heads a multiple of 16 "
                         f"(C={c}, heads={heads})")
    lib = _lib()
    (gth, gtw), (ath, atw) = plan_tiles(lib, c, heads, p["fp"])
    n_gram_tiles = -(-h // gth) * -(-w // gtw)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    groups = max(1, min(n_gram_tiles, -(-n_sm // b)))  # (A) in one wave
    part = torch.empty(b, groups, heads * hc * hc + 2 * c,
                       dtype=torch.float32, device=x.device)
    attn_t = torch.empty(b, heads, hc, hc, dtype=torch.bfloat16,
                         device=x.device)
    v = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    # blocks hand over in float32; only the last writes x's dtype
    out = torch.empty_like(x)
    bufs = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for _ in range(min(2, n - 1))]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    for i in range(n):
        dst = out if i == n - 1 else bufs[i % 2]
        src_bf16 = int(src.dtype == torch.bfloat16)
        _check(lib, lib.raie_stage_gram(
            src.data_ptr(), src_bf16, p["ln1"][i].data_ptr(),
            p["wqkv"][i].data_ptr(), p["dwqkv"][i].data_ptr(),
            part.data_ptr(), v.data_ptr(), b, h, w, c, heads, p["fp"], gth,
            gtw, groups, ln_eps, stream), "A (Gram)")
        _check(lib, lib.raie_stage_softmax(
            part.data_ptr(), p["temp"][i].data_ptr(), attn_t.data_ptr(),
            b, c, heads, groups, stream), "B (softmax)")
        _check(lib, lib.raie_stage_apply(
            src.data_ptr(), src_bf16, dst.data_ptr(),
            int(dst.dtype == torch.bfloat16), v.data_ptr(), attn_t.data_ptr(),
            p["wproj"][i].data_ptr(), p["ln2"][i].data_ptr(),
            p["win"][i].data_ptr(), p["wdw"][i].data_ptr(),
            p["wout"][i].data_ptr(), b, h, w, c, heads, p["fp"], ath, atw,
            ln_eps, stream), "C (apply)")
        src = dst
    fused_transformer_stage.launches += 1
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
