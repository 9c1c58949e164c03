"""Fan-beam zero-mask postprocessing (KDLAE_T.ipynb cell 5): output
pixels where the quantised input was exactly 0 are forced back to 0."""

from __future__ import annotations

import numpy as np


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
