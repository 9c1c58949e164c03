"""Channel LayerNorm over the last axis as one kernel.

``fused_channel_layernorm`` keeps the JAX signature
(``ops/pallas/layernorm.py:34``): x is (..., C), float32 or bfloat16;
``bias_free`` selects ``x / sqrt(var + eps) * weight`` (variance about the
mean, mean not subtracted), else ``(x - mean) / sqrt(var + eps) * weight +
bias`` (a missing bias counts as zeros). Statistics are float32 and take two
passes; the result has x's dtype.

On a CUDA tensor it launches ``csrc/layernorm.cu`` and counts the launch in
``fused_channel_layernorm.launches``; on a CPU tensor it runs its plain
version, ``ops/norm.py::channel_layernorm``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .norm import channel_layernorm

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "raie_layernorm": [_P, _I, _P, _P, _P, ctypes.c_longlong, _I,
                       ctypes.c_float, _P],
}


def layernorm_plain(x, weight, bias=None, bias_free: bool = True,
                    eps: float = 1e-5) -> torch.Tensor:
    """The same function in plain PyTorch."""
    if bias_free:
        bias = None
    elif bias is None:
        bias = torch.zeros_like(weight)
    return channel_layernorm(x, weight, bias, eps=eps)


def _layernorm_cuda(x, weight, bias, bias_free, eps) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"LayerNorm kernel takes float32 or bfloat16, not {x.dtype}")
    c = x.shape[-1]
    vec = 16 // x.element_size()
    if c % vec or c // vec > 128:
        raise ValueError(f"LayerNorm kernel needs C a multiple of {vec}, at "
                         f"most {128 * vec}, for {x.dtype} (C={c})")
    if weight.numel() != c or (bias is not None and bias.numel() != c):
        raise ValueError(f"LayerNorm weight/bias must have {c} elements")
    x = x.contiguous()
    y = torch.empty_like(x)

    def f32(t):
        return t.detach().to(device=x.device, dtype=torch.float32).contiguous()

    w = f32(weight)
    b = None if bias_free else f32(torch.zeros_like(weight) if bias is None else bias)
    lib = _build.bind("layernorm", _SIGNATURES)
    _build.check(lib, "layernorm", lib.raie_layernorm(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(), x.numel() // c, c,
        eps, torch.cuda.current_stream(x.device).cuda_stream), "launch")
    fused_channel_layernorm.launches += 1
    return y


def fused_channel_layernorm(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor | None = None,
                            bias_free: bool = True,
                            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., C). A CUDA tensor launches the kernel (or raises); a CPU
    tensor takes the plain version."""
    if x.device.type == "cuda":
        return _layernorm_cuda(x, weight, bias, bias_free, eps)
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, bias_free, eps)
    raise ValueError(f"no LayerNorm implementation for device {x.device}")


fused_channel_layernorm.launches = 0  # kernel launches
