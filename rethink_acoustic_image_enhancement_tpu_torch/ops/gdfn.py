"""LayerNorm -> GDFN -> residual as one kernel:
``out = x + W_out @ (gelu(t1) * t2)``, ``t = dwconv3x3(W_in @ LN(x))``.

``fused_ln_gdfn`` keeps the JAX signature and layouts
(``ops/pallas/gdfn.py:208``): x is NHWC (float32 or bfloat16, any batch),
``w_in`` (1, 1, C, 2F) or (C, 2F), ``w_dw`` (3, 3, 1, 2F) or (3, 3, 2F),
``w_out`` (1, 1, F, C) or (F, C); ``bias_free`` picks the LayerNorm variant
and ``apply_ln=False`` skips it. The depthwise conv sees zeros outside the
image, as torch's ``padding=1`` gives it: LN(x) is masked after the
LayerNorm, so a LayerNorm bias does not leak into the border ring.

On a CUDA tensor it launches ``csrc/gdfn.cu`` on x's device, whose weights
must lie there too, and counts the launch in ``fused_ln_gdfn.launches``; on a CPU tensor it runs ``gdfn_plain``, the same
arithmetic in plain PyTorch: bf16 operands with float32 accumulation for
the two products, the W_in output rounded to bf16 before its float32
depthwise 3x3, two-pass LayerNorm and exact-erf GELU (the kernel's
Abramowitz-Stegun erf is within 1.5e-7).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .norm import channel_layernorm

HIDDEN_PAD = 64  # the kernels' hidden width is padded to a multiple of this
SMEM_LIMIT = 232448
FFN_TILES = ((8, 8), (4, 8), (4, 4))
FFN_CHUNKS = (64, 32)  # hidden channels per chunk


# ------------------------------------------------------------- plain ----

def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in float32 (a bf16 operand whose
    products accumulate in float32)."""
    return t.to(torch.bfloat16).float()


def dw3x3(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Zero-padded depthwise 3x3 on NHWC float32, taps (3, 3, K) in the
    kernels' order."""
    h, w_ = t.shape[1], t.shape[2]
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(t)
    for di in range(3):
        for dj in range(3):
            acc = acc + tp[:, di:di + h, dj:dj + w_, :] * w[di, dj]
    return acc


def ffn_f32(r: torch.Tensor, ln_w, ln_b, w_in, w_dw, w_out, eps: float,
            apply_ln: bool = True) -> torch.Tensor:
    """r + GDFN(LN(r)) on float32 NHWC r with float32 (C, 2F), (3, 3, 2F)
    and (F, C) weights; ``ln_b is None`` is the BiasFree LayerNorm."""
    f = w_out.shape[0]
    rn = channel_layernorm(r, ln_w, ln_b, eps=eps) if apply_ln else r
    t = bf16_round(bf16_round(rn) @ bf16_round(w_in))
    a = dw3x3(t, w_dw)
    x1, x2 = a[..., :f], a[..., f:]
    g = 0.5 * x1 * (1.0 + torch.erf(x1 * 2.0 ** -0.5)) * x2
    return bf16_round(g) @ bf16_round(w_out) + r


def _ln_bias(ln_weight, ln_bias, bias_free: bool):
    if bias_free:
        return None
    return torch.zeros_like(ln_weight) if ln_bias is None else ln_bias


def gdfn_plain(x, ln_weight, ln_bias, w_in, w_dw, w_out,
               bias_free: bool = True, apply_ln: bool = True,
               ln_eps: float = 1e-5) -> torch.Tensor:
    """``fused_ln_gdfn`` in plain PyTorch (the kernel's arithmetic)."""
    c = x.shape[-1]
    b = _ln_bias(ln_weight, ln_bias, bias_free)
    y = ffn_f32(x.float(), ln_weight.float(),
                None if b is None else b.float(),
                w_in.reshape(c, -1).float(), w_dw.reshape(3, 3, -1).float(),
                w_out.reshape(-1, c).float(), ln_eps, apply_ln)
    return y.to(x.dtype)


# ------------------------------------------------------------- CUDA -----

def pack_ffn(w_in, w_dw, w_out, c: int, device) -> dict:
    """The kernels' GDFN operands from weights with a leading ``n`` dim:
    bf16 W_in (n, C, 2Fp) and W_out (n, Fp, C), fp32 taps (n, 9, 2Fp); the
    hidden width F is padded with zeros to Fp (a multiple of 64), the
    gate's halves at [0, F) and [Fp, Fp + F)."""
    n = w_in.shape[0]
    f = w_out.reshape(n, -1, c).shape[1]
    fp = -(-f // HIDDEN_PAD) * HIDDEN_PAD
    w_in = w_in.detach().reshape(n, c, 2 * f)
    w_dw = w_dw.detach().reshape(n, 9, 2 * f)
    win = torch.zeros(n, c, 2 * fp, dtype=torch.bfloat16, device=device)
    win[:, :, :f] = w_in[:, :, :f]
    win[:, :, fp:fp + f] = w_in[:, :, f:]
    wdw = torch.zeros(n, 9, 2 * fp, dtype=torch.float32, device=device)
    wdw[:, :, :f] = w_dw[:, :, :f]
    wdw[:, :, fp:fp + f] = w_dw[:, :, f:]
    wout = torch.zeros(n, fp, c, dtype=torch.bfloat16, device=device)
    wout[:, :f] = w_out.detach().reshape(n, f, c)
    return dict(win=win, wdw=wdw, wout=wout, fp=fp)


def pick_layout(candidates, smem_bytes, blocks_per_sm):
    """(candidate, resident blocks): of ``candidates``, in their order of
    preference, the first that fits in shared memory with at least two
    thread blocks resident on an SM (one block's barrier, load and
    LayerNorm waits are another's products); else the first that fits at
    all, one block per SM; None where none fits. ``smem_bytes(*candidate)``
    and ``blocks_per_sm(*candidate)`` ask the library."""
    fitting = [cand for cand in candidates if smem_bytes(*cand) <= SMEM_LIMIT]
    for cand in fitting:
        blocks = blocks_per_sm(*cand)
        if blocks >= 2:
            return cand, blocks
    for cand in fitting:
        blocks = blocks_per_sm(*cand)
        if blocks >= 1:
            return cand, blocks
    return None


def ffn_candidates():
    """(th, tw, fc) of a kernel that ends in the GDFN, best first: the
    largest tile (least halo), then the largest chunk of hidden channels."""
    return [(th, tw, fc) for th, tw in FFN_TILES for fc in FFN_CHUNKS]


def plan_ffn(library, c: int) -> tuple[int, tuple[int, int], int]:
    """(chunk, (th, tw), blocks resident per SM) of the GDFN kernel at C
    channels; ``library`` is its handle."""
    found = pick_layout(
        ffn_candidates(),
        lambda th, tw, fc: library.raie_gdfn_smem_bytes(th, tw, c, fc),
        lambda th, tw, fc: library.raie_gdfn_blocks_per_sm(th, tw, c, fc))
    if found is None:
        raise ValueError(f"no GDFN-kernel tile fits {c} channels")
    (th, tw, fc), blocks = found
    return fc, (th, tw), blocks


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "raie_gdfn_smem_bytes": [_I] * 4,
    "raie_gdfn_blocks_per_sm": [_I] * 4,
    "raie_gdfn": [_P, _P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 8
    + [ctypes.c_float, _P],
}


def check_input(x: torch.Tensor, what: str) -> torch.Tensor:
    """What every tile kernel takes: contiguous NHWC float32 or bfloat16
    with C a multiple of 16 up to 384."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes float32 or bfloat16, not {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"{what} kernel takes NHWC input, got {tuple(x.shape)}")
    c = x.shape[-1]
    if c % 16 or c > 384:
        raise ValueError(f"{what} kernel needs C a multiple of 16 up to 384 (C={c})")
    return x.contiguous()


def _gdfn_cuda(x, ln_weight, ln_bias, w_in, w_dw, w_out, bias_free,
               apply_ln, ln_eps) -> torch.Tensor:
    x = check_input(x, "GDFN")
    b, h, w, c = x.shape
    guard = _build.on_device(x, "GDFN", ln_weight=ln_weight, ln_bias=ln_bias,
                             w_in=w_in, w_dw=w_dw, w_out=w_out)
    with guard:
        p = pack_ffn(w_in.reshape(1, c, -1), w_dw.reshape(1, 9, -1),
                     w_out.reshape(1, -1, c), c, x.device)

        def f32(t):
            return t.detach().to(dtype=torch.float32).contiguous()

        lnw = f32(ln_weight)
        lnb = _ln_bias(ln_weight, ln_bias, bias_free)
        lnb = None if lnb is None or not apply_ln else f32(lnb)
        lib = _build.bind("gdfn", _SIGNATURES)
        fc, (th, tw), _ = plan_ffn(lib, c)
        y = torch.empty_like(x)
        _build.check(lib, "gdfn", lib.raie_gdfn(
            x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
            lnw.data_ptr(), None if lnb is None else lnb.data_ptr(),
            int(apply_ln), p["win"].data_ptr(), p["wdw"].data_ptr(),
            p["wout"].data_ptr(), b, h, w, c, p["fp"], fc, th, tw, ln_eps,
            torch.cuda.current_stream(x.device).cuda_stream), "launch")
    _build.count_launch(fused_ln_gdfn)
    return y


def fused_ln_gdfn(x, ln_weight, ln_bias, w_in, w_dw, w_out,
                  bias_free: bool = True, apply_ln: bool = True,
                  ln_eps: float = 1e-5) -> torch.Tensor:
    """out = x + GDFN(LN(x)) on NHWC x (see the module docstring). A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes the plain
    version."""
    args = (x, ln_weight, ln_bias, w_in, w_dw, w_out, bias_free, apply_ln,
            ln_eps)
    if x.device.type == "cuda":
        return _gdfn_cuda(*args)
    if x.device.type == "cpu":
        return gdfn_plain(*args)
    raise ValueError(f"no GDFN implementation for device {x.device}")


fused_ln_gdfn.launches = 0  # kernel launches
