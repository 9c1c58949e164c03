"""LayerNorm -> GDFN -> residual as one kernel:
``out = x + W_out @ (gelu(t1) * t2)``, ``t = dwconv3x3(W_in @ LN(x))``.

``fused_ln_gdfn`` keeps the JAX signature and layouts
(``ops/pallas/gdfn.py:208``): x is NHWC (float32 or bfloat16, any batch),
``w_in`` (1, 1, C, 2F) or (C, 2F), ``w_dw`` (3, 3, 1, 2F) or (3, 3, 2F),
``w_out`` (1, 1, F, C) or (F, C); ``bias_free`` picks the LayerNorm variant
and ``apply_ln=False`` skips it. The depthwise conv sees zeros outside the
image, as torch's ``padding=1`` gives it: LN(x) is masked after the
LayerNorm, so a LayerNorm bias does not leak into the border ring.

On a CUDA tensor it launches a kernel on x's device, whose weights must lie
there too, and counts the launch in ``fused_ln_gdfn.launches``: which one
``ffn_route`` says by width. At C = 96, 192 and 384 it is the Hopper LN+GDFN
kernel (``csrc/stage_sm90_wide.cu``'s ``k_ffn_wide`` through
``raie_gdfn_sm90``: wgmma, weights streamed in chunks of 32 hidden channels
by bulk copies, one persistent block an SM; its launches also counted in
``gdfn_sm90.launches``), at every other width ``csrc/gdfn.cu``. On a CPU
tensor it runs ``gdfn_plain``, the same arithmetic in plain PyTorch: bf16
operands with float32 accumulation for the two products, the W_in output
rounded to bf16 before its float32 depthwise 3x3, two-pass LayerNorm and
exact-erf GELU (the kernels' Abramowitz-Stegun erf is within 1.5e-7).

``fused_ln_gdfn_part`` is the same kernel on a model shard's range of the
hidden channels (tensor-parallel serving, ``ops/stage.py::
fused_transformer_stage_shards``): float32 r in and out, the residual added
by one shard only; ``gdfn_part_plain`` is its plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .norm import channel_layernorm

HIDDEN_PAD = 64  # the hidden width is padded to a multiple of this (both kernels)
SMEM_LIMIT = 232448
FFN_TILES = ((8, 8), (4, 8), (4, 4))
FFN_CHUNKS = (64, 32)  # hidden channels per chunk
# The Hopper LN+GDFN kernel's widths and its chunk of hidden channels.
SM90_WIDTHS = (96, 192, 384)
SM90_FC = 32


# ------------------------------------------------------------- plain ----

def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in float32 (a bf16 operand whose
    products accumulate in float32)."""
    return t.to(torch.bfloat16).float()


def dw3x3(t: torch.Tensor, w: torch.Tensor, halo: bool = False) -> torch.Tensor:
    """Zero-padded depthwise 3x3 on NHWC float32, taps (3, 3, K) in the
    kernels' order. With ``halo`` t holds one row above and one below its
    own rows (a row band's, ``parallel/spatial.py``): only the columns are
    zero-padded, and the output has t's own rows."""
    tp = F.pad(t, (0, 0, 1, 1) + ((0, 0) if halo else (1, 1)))
    h, w_ = tp.shape[1] - 2, t.shape[2]
    acc = t.new_zeros((t.shape[0], h, w_, t.shape[3]))
    for di in range(3):
        for dj in range(3):
            acc = acc + tp[:, di:di + h, dj:dj + w_, :] * w[di, dj]
    return acc


def ffn_hidden(r: torch.Tensor, ln_w, ln_b, w_in, eps: float,
               apply_ln: bool = True) -> torch.Tensor:
    """The GDFN's depthwise input: bf16(bf16(LN(r)) @ bf16(W_in))."""
    rn = channel_layernorm(r, ln_w, ln_b, eps=eps) if apply_ln else r
    return bf16_round(bf16_round(rn) @ bf16_round(w_in))


def ffn_out(r: torch.Tensor, a: torch.Tensor, w_out, residual: bool = True) -> torch.Tensor:
    """r + W_out (gelu(a1) * a2), ``a`` the depthwise output; without
    ``residual`` the product alone."""
    f = w_out.shape[0]
    x1, x2 = a[..., :f], a[..., f:]
    g = 0.5 * x1 * (1.0 + torch.erf(x1 * 2.0 ** -0.5)) * x2
    y = bf16_round(g) @ bf16_round(w_out)
    return y + r if residual else y


def ffn_f32(r: torch.Tensor, ln_w, ln_b, w_in, w_dw, w_out, eps: float,
            apply_ln: bool = True, residual: bool = True) -> torch.Tensor:
    """r + GDFN(LN(r)) on float32 NHWC r with float32 (C, 2F), (3, 3, 2F)
    and (F, C) weights; ``ln_b is None`` is the BiasFree LayerNorm. On a
    model shard's range of F hidden channels (W_in's columns of both halves,
    their taps, W_out's rows) it is that range's part of the GDFN, r added
    only with ``residual``."""
    return ffn_out(r, dw3x3(ffn_hidden(r, ln_w, ln_b, w_in, eps, apply_ln), w_dw), w_out,
                   residual)


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

def ffn_route(c: int) -> str:
    """Which kernel an LN+GDFN launch (whole, or a model shard's part) takes,
    by width, as ``ops/block.py::apply_route`` picks a block's: ``"wgmma"``
    (Hopper: ``csrc/stage_sm90_wide.cu``'s ``k_ffn_wide``) at C = 96, 192
    and 384, else ``"mma_sync"`` (``csrc/gdfn.cu``)."""
    return "wgmma" if c in SM90_WIDTHS else "mma_sync"


def _padded(t, dtype, device, dim: int, fp: int) -> torch.Tensor:
    """t (detached) in dtype on device, contiguous, with dim zero-padded to
    fp: one copy where it needs padding (the cast inside it), else a cast
    alone (t itself where it has that dtype and device already)."""
    t = t.detach()
    if t.shape[dim] == fp:
        return t.to(device=device, dtype=dtype).contiguous()
    out = torch.zeros(*t.shape[:dim], fp, *t.shape[dim + 1:], dtype=dtype, device=device)
    out.narrow(dim, 0, t.shape[dim]).copy_(t)
    return out


def pack_ffn(w_in, w_dw, w_out, c: int, device) -> dict:
    """The kernels' GDFN operands from weights with a leading ``n`` dim:
    bf16 W_in (n, C, 2Fp) and W_out (n, Fp, C), fp32 taps (n, 9, 2Fp); the
    hidden width F is padded with zeros to Fp (a multiple of HIDDEN_PAD, and
    so of SM90_FC), the gate's halves at [0, F) and [Fp, Fp + F). This is
    ``csrc/gdfn.cu``'s layout; ``ffn_chunks`` permutes it into the Hopper
    kernel's (it may share memory with weights that need no padding)."""
    n = w_in.shape[0]
    f = w_out.reshape(n, -1, c).shape[1]
    fp = -(-f // HIDDEN_PAD) * HIDDEN_PAD
    bf = torch.bfloat16
    return dict(win=_padded(w_in.reshape(n, c, 2, f), bf, device, 3, fp).reshape(n, c, 2 * fp),
                wdw=_padded(w_dw.reshape(n, 9, 2, f), torch.float32, device, 3,
                            fp).reshape(n, 9, 2 * fp),
                wout=_padded(w_out.reshape(n, f, c), bf, device, 1, fp), fp=fp)


def ffn_chunks(win, wdw, wout, fp: int) -> dict:
    """The Hopper kernel's GDFN operands from ``pack_ffn``'s (n blocks
    leading), one copy each: for each chunk of fc = SM90_FC hidden channels,
    the columns of both halves of W_in as a wgmma B operand (N = 2 fc, K =
    C; ``ops/block.py::b_operand``'s layout), each channel's GELU and gate
    columns side by side ([f][half]), and their taps (n, chunks, 9, fc, 2);
    the chunk's rows of W_out as a B operand (N = C, K = fc). A chunk's
    operand and taps are what the kernel copies into one slot."""
    n, c, _ = win.shape
    fc = SM90_FC
    nch = fp // fc
    # W_in's column half * fp + j * fc + 4 f1 + f0 is n' = 2 (4 f1 + f0) + half
    # of chunk j; B element (k, n') at [k / 8][n' / 8][n' % 8][k % 8]
    w_in = win.reshape(n, c // 8, 8, 2, nch, fc // 4, 4).permute(0, 4, 1, 5, 6, 3, 2)
    wtaps = wdw.reshape(n, 9, 2, nch, fc).permute(0, 3, 1, 4, 2)
    w_out = wout.reshape(n, nch, fc // 8, 8, c // 8, 8).permute(0, 1, 2, 4, 5, 3)
    return dict(win_wg=w_in.contiguous(), wtaps_wg=wtaps.contiguous(),
                wout_wg=w_out.contiguous())


def pack_ffn_route(w_in, w_dw, w_out, c: int, device) -> dict:
    """The GDFN operands (weights as ``pack_ffn`` takes them) of the kernel
    of ``ffn_route(c)`` alone: ``pack_ffn``'s, or only their Hopper chunks
    (``ffn_chunks``); ``fp`` in both."""
    p = pack_ffn(w_in, w_dw, w_out, c, device)
    if ffn_route(c) == "wgmma":
        return dict(fp=p["fp"], **ffn_chunks(p["win"], p["wdw"], p["wout"], p["fp"]))
    return p


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
    + [ctypes.c_float, _I, _P],
}
_SM90_SIGNATURES = {
    "raie_gdfn_sm90": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 6
    + [ctypes.c_float, _I, _P],
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
        p = pack_ffn_route(w_in.reshape(1, c, -1), w_dw.reshape(1, 9, -1),
                           w_out.reshape(1, -1, c), c, x.device)

        def f32(t):
            return t.detach().to(dtype=torch.float32).contiguous()

        lnw = f32(ln_weight)
        lnb = _ln_bias(ln_weight, ln_bias, bias_free)
        lnb = None if lnb is None or not apply_ln else f32(lnb)
        y = torch.empty_like(x)
        _launch_route(x, y, lnw, lnb, apply_ln, p, 0, ln_eps, True)
    _build.count_launch(fused_ln_gdfn)
    return y


def _launch_route(x, y, lnw, lnb, apply_ln, p, i, eps, residual) -> None:
    """Block i's GDFN of packed operands p (``pack_ffn_route``'s) on x's
    device (under its guard), by the kernel of ``ffn_route``."""
    if ffn_route(x.shape[-1]) == "wgmma":
        gdfn_sm90(x, y, lnw, lnb, apply_ln, p["win_wg"][i], p["wtaps_wg"][i], p["wout_wg"][i],
                  p["fp"], eps, residual)
    else:
        _launch(x, y, lnw, lnb, apply_ln, p["win"][i], p["wdw"][i], p["wout"][i], p["fp"], eps,
                residual)


def gdfn_sm90(x, y, lnw, lnb, apply_ln, win, wtaps, wout, fp, eps, residual,
              library: str = "stage_sm90_wide") -> None:
    """One launch of the Hopper LN+GDFN kernel (``csrc/stage_sm90_wide.cu``
    ``raie_gdfn_sm90``, from ``library``: its build, or the phase-clock
    variant) on x's device (under its guard), one persistent block an SM;
    counted in ``gdfn_sm90.launches``."""
    b, h, w, c = x.shape
    lib = _build.bind(library, _SM90_SIGNATURES)
    _build.check(lib, "stage_sm90_wide", lib.raie_gdfn_sm90(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
        int(y.dtype == torch.bfloat16), lnw.data_ptr(), None if lnb is None else lnb.data_ptr(),
        int(apply_ln), win.data_ptr(), wtaps.data_ptr(), wout.data_ptr(), b, h, w, c, fp,
        int(residual), eps, 0, torch.cuda.current_stream(x.device).cuda_stream),
        "launch (LN+GDFN, wgmma)")
    _build.count_launch(gdfn_sm90)


gdfn_sm90.launches = 0  # Hopper LN+GDFN launches (whole and parts)


def _launch(x, y, lnw, lnb, apply_ln, win, wdw, wout, fp, eps, residual) -> None:
    """One launch of csrc/gdfn.cu on x's device (under its guard)."""
    b, h, w, c = x.shape
    lib = _build.bind("gdfn", _SIGNATURES)
    fc, (th, tw), _ = plan_ffn(lib, c)
    _build.check(lib, "gdfn", lib.raie_gdfn(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
        lnw.data_ptr(), None if lnb is None else lnb.data_ptr(),
        int(apply_ln), win.data_ptr(), wdw.data_ptr(), wout.data_ptr(), b, h, w, c, fp,
        fc, th, tw, eps, int(residual), torch.cuda.current_stream(x.device).cuda_stream),
        "launch")


def launch_ffn_part(r, p: dict, i: int, residual: bool, eps: float) -> torch.Tensor:
    """The kernel of ``ffn_route`` on a model shard's packed hidden range
    (block i of ``ops/block.py::pack_blocks``' operands, or of
    ``pack_ffn_route``'s, with LN2's weight as ``ln2``, on r's device): float32
    [r +] its part of GDFN(LN(r)), BiasFree LN; counted in
    ``fused_ln_gdfn_part.launches``."""
    if r.dtype != torch.float32:
        raise TypeError(f"GDFN part kernel takes float32 r, not {r.dtype}")
    r = check_input(r, "GDFN part")
    keys = ("win_wg", "wtaps_wg", "wout_wg") if ffn_route(r.shape[-1]) == "wgmma" else (
        "win", "wdw", "wout")
    with _build.on_device(r, "GDFN part", ln_weight=p["ln2"], **{k: p[k] for k in keys}):
        y = torch.empty_like(r)
        _launch_route(r, y, p["ln2"][i], None, True, p, i, eps, residual)
    _build.count_launch(fused_ln_gdfn_part)
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


def gdfn_part_plain(r, ln_weight, w_in, w_dw, w_out, residual: bool = True,
                    ln_eps: float = 1e-5) -> torch.Tensor:
    """``fused_ln_gdfn_part`` in plain PyTorch (the kernel's arithmetic)."""
    c = r.shape[-1]
    return ffn_f32(r.float(), ln_weight.float(), None, w_in.reshape(c, -1).float(),
                   w_dw.reshape(3, 3, -1).float(), w_out.reshape(-1, c).float(), ln_eps,
                   residual=residual)


def fused_ln_gdfn_part(r, ln_weight, w_in, w_dw, w_out, residual: bool = True,
                       ln_eps: float = 1e-5) -> torch.Tensor:
    """A model shard's part of r + GDFN(LN(r)) on float32 NHWC r, the
    BiasFree LayerNorm over all C channels: ``w_in`` (C, 2Fs) holds the
    shard's Fs channels of the gate's first half, then of its second (the
    flax layouts as ``fused_ln_gdfn`` takes them), ``w_dw`` their (3, 3, 2Fs)
    taps, ``w_out`` (Fs, C) their rows; r itself is added only with
    ``residual``. Float32 out. A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain version."""
    if r.device.type == "cuda":
        c = r.shape[-1]
        with _build.on_device(r, "GDFN part", ln_weight=ln_weight, w_in=w_in, w_dw=w_dw,
                              w_out=w_out):
            p = pack_ffn_route(w_in.reshape(1, c, -1), w_dw.reshape(1, 9, -1),
                               w_out.reshape(1, -1, c), c, r.device)
            p["ln2"] = ln_weight.detach().float().reshape(1, c).contiguous()
        return launch_ffn_part(r, p, 0, residual, ln_eps)
    if r.device.type == "cpu":
        return gdfn_part_plain(r, ln_weight, w_in, w_dw, w_out, residual, ln_eps)
    raise ValueError(f"no GDFN part implementation for device {r.device}")


fused_ln_gdfn_part.launches = 0  # kernel launches (model shards)
