"""MATLAB-compatible image utilities (numpy).

Port of Train/basicsr/utils/matlab_functions.py: ``imresize`` (bicubic with
antialiasing, matching MATLAB's algorithm used throughout SR literature)
and the YCbCr conversions backing ``to_y_channel`` in the metric stack
(numpy only: the port's copy of the JAX package's module).
"""

from __future__ import annotations

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB's bicubic kernel."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((1 < ax) & (ax <= 2)))


def _weights_indices(in_len: int, out_len: int, scale: float,
                     antialiasing: bool):
    """MATLAB contribution weights + symmetric-boundary source indices."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    # 1-based tap indices, window starts one before `left` (MATLAB port)
    indices1 = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - indices1
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # drop an all-zero first/last tap column (matlab_functions trimming)
    zero_cols = np.sum(np.abs(weights) < 1e-12, axis=0)
    lo = 1 if zero_cols[0] == out_len else 0
    hi = p - 1 if zero_cols[-1] == out_len else p
    weights = np.ascontiguousarray(weights[:, lo:hi])
    indices1 = indices1[:, lo:hi]
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # 0-based with symmetric (edge-duplicating) reflection
    k = indices1 - 1
    k = np.where(k < 0, -k - 1, k)
    k = np.where(k > in_len - 1, 2 * in_len - 1 - k, k)
    # double reflection for very small inputs
    k = np.clip(k, 0, in_len - 1)
    return weights, k.astype(np.int64)


def imresize(img: np.ndarray, scale: float,
             antialiasing: bool = True) -> np.ndarray:
    """MATLAB imresize (bicubic): (H, W[, C]) float array, any range."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    out_h = int(np.ceil(h * scale))
    out_w = int(np.ceil(w * scale))

    wts_h, idx_h = _weights_indices(h, out_h, scale, antialiasing)
    wts_w, idx_w = _weights_indices(w, out_w, scale, antialiasing)

    out = img.astype(np.float64)
    # rows: out[i] = sum_k wts_h[i,k] * img[idx_h[i,k]]
    out = np.einsum("ik,ikwc->iwc", wts_h, out[idx_h, :, :])
    out = np.einsum("jk,ijkc->ijc", wts_w, out[:, idx_w, :])
    out = out.astype(img.dtype if img.dtype != np.uint8 else np.float64)
    return out[:, :, 0] if squeeze else out


_YCBCR = np.asarray([[65.481, -37.797, 112.0],
                     [128.553, -74.203, -93.786],
                     [24.966, 112.0, -18.214]])
_OFFSET = np.asarray([16.0, 128.0, 128.0])


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """img float in [0, 1] RGB -> YCbCr in [0, 1] (MATLAB convention)."""
    if y_only:
        out = img @ _YCBCR[:, 0] + _OFFSET[0]
    else:
        out = img @ _YCBCR + _OFFSET
    return out / 255.0


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    return rgb2ycbcr(img[..., ::-1], y_only)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """YCbCr [0,1] -> RGB [0,1] (MATLAB ycbcr2rgb)."""
    inv = np.linalg.inv(_YCBCR / 255.0)
    return (img - _OFFSET / 255.0) @ inv


def ycbcr2bgr(img: np.ndarray) -> np.ndarray:
    """YCbCr [0,1] -> BGR [0,1] (matlab_functions.py:273 ycbcr2bgr —
    the BT.601 inverse with the channel order reversed)."""
    return ycbcr2rgb(img)[..., ::-1]


def to_y_channel(img: np.ndarray, channel_order: str = "rgb") -> np.ndarray:
    """[0,255] color image -> [0,255] Y channel (metric_util.to_y_channel)."""
    img = img.astype(np.float64) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        fn = rgb2ycbcr if channel_order == "rgb" else bgr2ycbcr
        img = fn(img, y_only=True)[..., None]
    return img * 255.0
