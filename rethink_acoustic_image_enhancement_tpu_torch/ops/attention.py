"""MDTA ("transposed" channel attention) core.

Reference math (KDLAE/KDLAE_model.py:124-145): q/k/v as (b, head, c, hw);
q and k L2-normalised along the pixel axis with ``max(||x||, 1e-12)``; the
per-head (c x c) Gram matrix times a per-head temperature, softmaxed over
the key channels; out = attn @ v. Products accumulate in float32.
"""

from __future__ import annotations

import torch

_L2_EPS = 1e-12  # torch F.normalize default eps (KDLAE_model.py:134-135)


def l2_normalize_pixels(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||_2, eps) over the pixel axis ``dim``, in float32."""
    xf = x.float()
    norm = xf.square().sum(dim=dim, keepdim=True).sqrt()
    return (xf / norm.clamp_min(_L2_EPS)).to(x.dtype)


def mdta_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              temperature: torch.Tensor) -> torch.Tensor:
    """Channel attention on (b, heads, c, p) tensors; temperature (heads,
    1, 1). Returns (b, heads, c, p) in q's dtype."""
    qn = l2_normalize_pixels(q).float()
    kn = l2_normalize_pixels(k).float()
    attn = qn @ kn.transpose(-1, -2)
    attn = attn * temperature.float().reshape(1, -1, 1, 1)
    attn = torch.softmax(attn, dim=-1)
    out = attn.to(q.dtype).float() @ v.float()
    return out.to(q.dtype)


def mdta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   temperature: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Channel attention on NHWC q, k, v (channels head-major, as in the
    torch layout); the JAX package's public layout. Returns (B, H, W, C)."""
    b, h, w, c_total = q.shape
    c = c_total // num_heads

    def split(t):  # (B, H, W, C) -> (B, heads, c, P)
        return t.reshape(b, h * w, num_heads, c).permute(0, 2, 3, 1)

    out = mdta_core(split(q), split(k), split(v), temperature)
    return out.permute(0, 3, 1, 2).reshape(b, h, w, c_total)
