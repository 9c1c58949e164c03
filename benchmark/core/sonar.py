"""Synthetic sonar frames: gamma(2, 40) speckle inside a fan-beam sector,
exact zeros outside it (the semantics of the program's smoke run's
``sonar_frame`` and ``sonar_stacks``), drawn on the device from a
``torch.Generator`` in a few large calls. gamma(2, theta) is theta times the
sum of two unit exponentials."""

from __future__ import annotations

import torch


def fan(h: int, w: int, device) -> torch.Tensor:
    """(h, w) bool: inside the sector of half-angle 0.75 rad whose apex is
    the top centre, out to 0.95 h."""
    yy = torch.arange(h, device=device, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float64)[None, :]
    angle = torch.atan2(xx - w / 2, yy + 1.0).abs()
    return (angle <= 0.75) & (torch.hypot(xx - w / 2, yy) <= 0.95 * h)


def _gamma2(shape, gen: torch.Generator, theta: float) -> torch.Tensor:
    u = torch.rand((2, *shape), generator=gen, device=gen.device)
    return -theta * torch.log1p(-u).sum(0)


def frames_rgb(n: int, h: int, w: int, gen: torch.Generator) -> torch.Tensor:
    """(n, h, w, 3) uint8: grey speckle in [1, 255] inside the fan, 0
    outside, on the generator's device."""
    speckle = _gamma2((n, h, w), gen, 40.0).clamp(1, 255).to(torch.uint8)
    speckle = speckle * fan(h, w, gen.device)
    return speckle[..., None].expand(n, h, w, 3).contiguous()


def stacks(b: int, f: int, h: int, w: int, gen: torch.Generator) -> torch.Tensor:
    """(b, f, h, w) uint8 frame stacks: each a fan over a slowly moving
    speckle field (0.7 of a base field shared by the stack's frames, 0.3
    of each frame's own), 0 outside the fan."""
    base = _gamma2((b, 1, h, w), gen, 40.0)
    own = _gamma2((b, f, h, w), gen, 40.0)
    out = (0.7 * base + 0.3 * own).clamp(0, 255) * fan(h, w, gen.device)
    return out.to(torch.uint8)


def smooth(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """A k x k box mean of (n, h, w) frames (reflect-padded): the clean
    targets a denoiser is trained towards."""
    p = k // 2
    y = torch.nn.functional.pad(x[:, None].float(), (p, p, p, p), mode="reflect")
    y = torch.nn.functional.avg_pool2d(y, k, stride=1)
    return y[:, 0]
