"""Channel LayerNorm (reference KDLAE/KDLAE_model.py:32-83).

Semantics:
  * biased variance (torch ``unbiased=False``), two passes
  * eps = 1e-5 added *inside* the sqrt
  * BiasFree:  x / sqrt(var + eps) * weight          (no mean subtraction!)
  * WithBias: (x - mean) / sqrt(var + eps) * weight + bias
Statistics are taken in float32 and the result is cast back to x's dtype.
"""

from __future__ import annotations

import torch


def channel_layernorm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None, eps: float = 1e-5,
                      dim: int = -1) -> torch.Tensor:
    """LayerNorm over the channel axis ``dim`` (last axis for NHWC, 1 for
    NCHW). ``bias is None`` selects the BiasFree variant."""
    xf = x.float() if x.dtype != torch.float64 else x
    mean = xf.mean(dim=dim, keepdim=True)
    var = (xf - mean).square().mean(dim=dim, keepdim=True)
    inv = torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[dim] = -1
    w = weight.to(xf.dtype).reshape(shape)
    if bias is None:
        y = xf * inv * w
    else:
        y = (xf - mean) * inv * w + bias.to(xf.dtype).reshape(shape)
    return y.to(x.dtype)
