"""Corruption masks and fan-beam zero-mask postprocessing.

``input_mask`` is the reference's multiplicative-Bernoulli frame corruption
(Train/basicsr/data/paired_image_dataset.py:19-36):
    out = img * keep - value + value * keep
kept pixels unchanged, dropped pixels forced to -value. ``mask_with_keep``
is its deterministic core; ``input_mask`` draws ``keep`` (a uniform per
element, kept where it is >= prob) on the host from an explicit numpy
generator, so a seed gives the same mask on every device.

``zero_mask_from_input`` / ``apply_zero_mask``: the notebooks' fan-beam
border preservation (KDLAE_T.ipynb cell 5): output pixels where the
quantised input was exactly 0 are forced back to 0.
"""

from __future__ import annotations

import numpy as np
import torch


def mask_with_keep(img: torch.Tensor, keep: torch.Tensor,
                   value: float = 0.1) -> torch.Tensor:
    """``img`` where ``keep`` is 1, -value where it is 0."""
    keep = keep.to(img.dtype)
    return img * keep - value + value * keep


def input_mask(img: torch.Tensor, rng: np.random.Generator, prob: float,
               value: float = 0.1) -> torch.Tensor:
    """Bernoulli-mask a tensor of any shape: P(drop) = clip(prob, 0, 1)."""
    prob = min(max(float(prob), 0.0), 1.0)
    u = torch.from_numpy(rng.random(tuple(img.shape), dtype=np.float32))
    return mask_with_keep(img, (u >= prob).to(img.device), value)


def input_mask_np(img: np.ndarray, rng: np.random.Generator, prob: float,
                  value: float = 0.1) -> np.ndarray:
    """The same corruption on a numpy array (host-side datasets)."""
    prob = min(float(prob), 1.0)
    keep = (rng.random(img.shape) >= prob).astype(img.dtype)
    return img * keep - value + value * keep


def zero_mask_from_input(lq_ubyte: np.ndarray) -> np.ndarray:
    """Boolean (H, W) mask of pixels that are exactly 0 in the quantised
    input (all channels zero for RGB)."""
    if lq_ubyte.ndim == 3 and lq_ubyte.shape[-1] == 3:
        return ((lq_ubyte[..., 0] == 0) & (lq_ubyte[..., 1] == 0)
                & (lq_ubyte[..., 2] == 0))
    return np.squeeze(lq_ubyte) == 0


def apply_zero_mask(img_ubyte: np.ndarray, mask: np.ndarray,
                    scale: int = 1) -> np.ndarray:
    """Zero out masked pixels; ``scale`` repeats the mask (the SR branch
    uses the 2x-repeated mask)."""
    if scale != 1:
        mask = np.repeat(np.repeat(mask, scale, axis=0), scale, axis=1)
    out = img_ubyte.copy()
    out[mask] = 0
    return out
