"""Optical-flow warping (Train/basicsr/models/archs/arch_util.py
flow_warp): bilinear sampling of an image at (x + flow), corner-aligned,
zeros (or the edge) outside.

A gather of the four neighbours and a lerp, in the JAX package's order,
rather than ``F.grid_sample``: grid_sample takes the sample position
through normalised [-1, 1] coordinates and back, which rounds it by a few
float32 ulps (at 448 pixels ~1e-4 of a pixel), differently on the CPU and
the card.
"""

from __future__ import annotations

import torch


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "zeros") -> torch.Tensor:
    """Warp NCHW ``x`` by ``flow`` (B, H, W, 2) in pixels, (dx, dy) order:
    out[b, :, i, j] = x[b, :, i + dy, j + dx], sampled bilinearly; samples
    outside are 0 ('zeros') or clamped to the edge ('border')."""
    b, c, h, w = x.shape
    if flow.shape != (b, h, w, 2):
        raise ValueError(f"flow {tuple(flow.shape)} for x {tuple(x.shape)}: "
                         f"expected {(b, h, w, 2)}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r}: 'zeros' or 'border'")
    gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    sx, sy = gx + flow[..., 0], gy + flow[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[:, None], (sy - y0)[:, None]
    flat = x.reshape(b, c, h * w)

    def gather(yi, xi):
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = flat.gather(2, idx.reshape(b, 1, h * w).expand(b, c, h * w))
        vals = vals.reshape(b, c, h, w)
        if padding_mode == "zeros":
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            vals = vals * inside[:, None].to(x.dtype)
        return vals

    top = gather(y0, x0) * (1 - fx) + gather(y0, x0 + 1) * fx
    bot = gather(y0 + 1, x0) * (1 - fx) + gather(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy
