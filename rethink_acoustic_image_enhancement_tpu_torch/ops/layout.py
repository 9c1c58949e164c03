"""NHWC layout ops: pixel (un)shuffle, pad-to-multiple, cropping.

Kept in the JAX package's NHWC layout at the public functions; the
channel order of the (un)shuffle is torch's (KDLAE/KDLAE_model.py:182-200),
so they equal ``F.pixel_(un)shuffle`` applied to the NCHW view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """out[n, h, w, c*r*r + i*r + j] = in[n, h*r + i, w*r + j, c]."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {r}")
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """out[n, h*r + i, w*r + j, c] = in[n, h, w, c*r*r + i*r + j]."""
    b, h, w, crr = x.shape
    if crr % (r * r):
        raise ValueError(f"channels {crr} not divisible by {r * r}")
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def pad_to_multiple(x: torch.Tensor, multiple: int, mode: str = "reflect",
                    axes: tuple[int, int] = (1, 2)):
    """Bottom/right pad of two spatial axes up to the next multiple.
    Returns (padded, (ph, pw)); ``mode`` is 'reflect' or 'constant'."""
    h, w = x.shape[axes[0]], x.shape[axes[1]]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph == 0 and pw == 0:
        return x, (0, 0)
    # F.pad pads trailing dims: move the two axes last, pad, move back
    rest = [d for d in range(x.ndim) if d not in axes]
    perm = rest + list(axes)
    xt = x.permute(*perm)
    lead = xt.shape[:-2]
    xt = xt.reshape(1, -1, h, w)
    if mode == "constant":
        xt = F.pad(xt, (0, pw, 0, ph))
    else:
        xt = F.pad(xt, (0, pw, 0, ph), mode=mode)
    xt = xt.reshape(*lead, h + ph, w + pw)
    inv = [perm.index(d) for d in range(x.ndim)]
    return xt.permute(*inv).contiguous(), (ph, pw)


def crop_to(x: torch.Tensor, h: int, w: int,
            axes: tuple[int, int] = (1, 2)) -> torch.Tensor:
    """Crop spatial axes back to (h, w) after padded inference."""
    sl = [slice(None)] * x.ndim
    sl[axes[0]] = slice(0, h)
    sl[axes[1]] = slice(0, w)
    return x[tuple(sl)]
