"""PSNR and SSIM (Train/basicsr/metrics/psnr_ssim.py), on the host in
float64 numpy.

  * PSNR with the peak picked from the first image (1.0 when its maximum is
    at most 1, else 255) and ``crop_border`` (psnr_ssim.py:9-70).
  * The reference's default SSIM is the 3D 11x11x11 Gaussian SSIM over
    (H, W, C) with replicate padding (psnr_ssim.py:146-197); its kernel is
    an outer product, so it runs as three separable 1-D filters.
  * The classic per-channel 2D SSIM on the valid region
    (psnr_ssim.py:73-114) and the Y-channel variant (psnr_ssim.py:199-237).

Each takes HWC (or CHW with ``input_order='CHW'``) arrays, float in [0, 1]
or [0, 255], and returns a Python float, as the reference metric registry
calls them (image_restoration_model.py:324-336).
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def _gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(size, sigma)."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


_G1D = _gaussian_kernel_1d()
_Y_COEF = np.array([65.481, 128.553, 24.966])


def _to_y_channel(img: np.ndarray) -> np.ndarray:
    """MATLAB rgb2ycbcr's Y of ``img / 255``, in [16, 235] for [0, 255]
    input (metric_util.to_y_channel)."""
    return (img / 255.0) @ _Y_COEF + 16.0


def _reorder(img, input_order: str) -> np.ndarray:
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 4:  # a batch of one
        img = img[0]
    if input_order == "CHW" and img.ndim == 3:
        img = img.transpose(1, 2, 0)
    if img.ndim == 2:
        img = img[..., None]
    return img


def _crop(img: np.ndarray, border: int) -> np.ndarray:
    return img[border:-border, border:-border] if border else img


def calculate_psnr(img1, img2, crop_border: int = 0, input_order: str = "HWC",
                   test_y_channel: bool = False) -> float:
    """PSNR between two images; inf when they are identical."""
    img1 = _crop(_reorder(img1, input_order), crop_border)
    img2 = _crop(_reorder(img2, input_order), crop_border)
    if test_y_channel:
        img1, img2 = _to_y_channel(img1), _to_y_channel(img2)
    mse = float(np.mean(np.square(img1 - img2)))
    if mse == 0.0:
        return float("inf")
    max_value = 1.0 if np.max(img1) <= 1.0 else 255.0
    return float(20.0 * np.log10(max_value / np.sqrt(mse)))


def _filter(x: np.ndarray, axis: int, pad: bool) -> np.ndarray:
    """The 11-tap Gaussian along ``axis``: replicate-padded to the same
    size (``pad``) or on the valid region only."""
    r = len(_G1D) // 2
    if pad:
        spec = [(0, 0)] * x.ndim
        spec[axis] = (r, r)
        x = np.pad(x, spec, mode="edge")
    return sliding_window_view(x, len(_G1D), axis=axis) @ _G1D


def _ssim_map(img1, img2, c1, c2, filt) -> np.ndarray:
    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def _replicate(axes):
    def filt(x):
        for ax in axes:
            x = _filter(x, ax, pad=True)
        return x

    return filt


def calculate_ssim(img1, img2, crop_border: int = 0, input_order: str = "HWC",
                   test_y_channel: bool = False) -> float:
    """SSIM by the reference's default 3D Gaussian (psnr_ssim.py:240-318);
    on the Y channel, 2D SSIM with replicate borders."""
    img1 = _crop(_reorder(img1, input_order), crop_border)
    img2 = _crop(_reorder(img2, input_order), crop_border)
    if test_y_channel:
        y1, y2 = _to_y_channel(img1)[..., None], _to_y_channel(img2)[..., None]
        return float(np.mean(_ssim_map(y1, y2, (0.01 * 255) ** 2,
                                       (0.03 * 255) ** 2, _replicate((0, 1)))))
    max_value = 1.0 if np.max(img1) <= 1 else 255.0
    return float(np.mean(_ssim_map(img1, img2, (0.01 * max_value) ** 2,
                                   (0.03 * max_value) ** 2,
                                   _replicate((0, 1, 2)))))


def calculate_ssim_2d(img1, img2, crop_border: int = 0,
                      input_order: str = "HWC") -> float:
    """Classic per-channel 2D SSIM on the valid region (psnr_ssim.py:73-114);
    expects [0, 255]."""
    img1 = _crop(_reorder(img1, input_order), crop_border)
    img2 = _crop(_reorder(img2, input_order), crop_border)

    def valid(x):
        return _filter(_filter(x, 0, pad=False), 1, pad=False)

    ssim_map = _ssim_map(img1, img2, (0.01 * 255) ** 2, (0.03 * 255) ** 2, valid)
    return float(ssim_map.mean(axis=(0, 1)).mean())
