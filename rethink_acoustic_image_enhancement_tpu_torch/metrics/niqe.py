"""NIQE: no-reference natural image quality, on the host in numpy.

The published algorithm (Mittal et al., "Making a 'Completely Blind' Image
Quality Analyzer"; Train/basicsr/metrics/niqe.py:9-205): MSCN normalisation
with a 7x7 Gaussian window, AGGD fits of the coefficients and of their four
adjacent products in 96-pixel blocks at two scales, then the distance
between the fitted multivariate Gaussian and the pristine corpus's.

The pristine parameters (mu / cov) are the published table, shipped in
``metrics/data/niqe_pris_params.npz``; ``RAIE_NIQE_PRIS`` or ``pris_path``
points at another ``.npz`` holding ``mu_pris_param`` / ``cov_pris_param``.
The half-scale resize is cv2's bilinear where cv2 is installed, else the
mean of each 2x2 block.
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma as gamma_fn

_BUNDLED_PRIS = os.path.join(os.path.dirname(__file__), "data",
                             "niqe_pris_params.npz")

# gamma ratios for the GGD / AGGD shape fit (Eq. 7)
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(gamma_fn(2.0 / _GAM)) / (
    gamma_fn(1.0 / _GAM) * gamma_fn(3.0 / _GAM))


def gaussian_window_7x7() -> np.ndarray:
    """MATLAB fspecial('gaussian', 7, 7/6), normalised."""
    sigma = 7.0 / 6.0
    ax = np.arange(7) - 3
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def load_pris_params(path: str | None = None):
    """(mu, cov) of the pristine model: ``path``, else ``RAIE_NIQE_PRIS``,
    else the shipped table."""
    path = path or os.environ.get("RAIE_NIQE_PRIS") or _BUNDLED_PRIS
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"NIQE pristine-model parameters not found at {path}; set "
            "RAIE_NIQE_PRIS to an .npz with mu_pris_param/cov_pris_param")
    data = np.load(path)
    return np.ravel(data["mu_pris_param"]), data["cov_pris_param"]


def _aggd_params(block: np.ndarray):
    """AGGD (alpha, beta_l, beta_r) of a sample of coefficients."""
    block = block.ravel()
    left = block[block < 0]
    right = block[block > 0]
    left_std = math.sqrt(np.mean(left ** 2)) if left.size else 0.0
    right_std = math.sqrt(np.mean(right ** 2)) if right.size else 0.0
    if right_std == 0 or np.mean(block ** 2) == 0:
        return np.nan, np.nan, np.nan
    gammahat = left_std / right_std
    rhat = np.mean(np.abs(block)) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / (
        (gammahat ** 2 + 1) ** 2)
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm) ** 2)]
    scale = math.sqrt(gamma_fn(1.0 / alpha) / gamma_fn(3.0 / alpha))
    return alpha, left_std * scale, right_std * scale


def _block_features(block: np.ndarray) -> list[float]:
    """18 features: the GGD of an MSCN block and the AGGDs of its four
    adjacent products."""
    feat = []
    alpha, bl, br = _aggd_params(block)
    feat += [alpha, (bl + br) / 2.0]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        prod = block * np.roll(block, shift, axis=(0, 1))
        alpha, bl, br = _aggd_params(prod)
        mean = (br - bl) * (gamma_fn(2.0 / alpha) / gamma_fn(1.0 / alpha))
        feat += [alpha, mean, bl, br]
    return feat


def _mscn(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    mu = convolve(img, window, mode="nearest")
    sigma = np.sqrt(np.abs(
        convolve(img * img, window, mode="nearest") - mu * mu))
    return (img - mu) / (sigma + 1.0)


def _half(img: np.ndarray) -> np.ndarray:
    """The image at half size, on [0, 255]."""
    try:
        import cv2
    except ImportError:
        return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                       + img[0::2, 1::2] + img[1::2, 1::2])
    return cv2.resize(img / 255.0, (img.shape[1] // 2, img.shape[0] // 2),
                      interpolation=cv2.INTER_LINEAR) * 255.0


def niqe(img_gray: np.ndarray, mu_pris: np.ndarray, cov_pris: np.ndarray,
         block: int = 96) -> float:
    """NIQE of an (H, W) float image on [0, 255]."""
    h, w = img_gray.shape
    nbh, nbw = h // block, w // block
    if nbh == 0 or nbw == 0:
        raise ValueError(f"image {h}x{w} smaller than NIQE block {block}")
    img = img_gray[: nbh * block, : nbw * block].astype(np.float64)
    window = gaussian_window_7x7()

    feats = []
    for scale in (1, 2):
        b = block // scale
        normalized = _mscn(img, window)
        feats.append(np.asarray([
            _block_features(normalized[i * b:(i + 1) * b, j * b:(j + 1) * b])
            for j in range(nbw) for i in range(nbh)]))
        if scale == 1:
            img = _half(img)

    distparam = np.concatenate(feats, axis=1)
    mu_dist = np.nanmean(distparam, axis=0)
    clean = distparam[~np.isnan(distparam).any(axis=1)]
    cov_dist = np.cov(clean, rowvar=False)
    inv_cov = np.linalg.pinv((cov_pris + cov_dist) / 2.0)
    d = mu_pris - mu_dist
    return float(np.sqrt(d @ inv_cov @ d))


def _rgb_to_y(img: np.ndarray) -> np.ndarray:
    """MATLAB rgb2ycbcr's Y of [0, 255] RGB, on [0, 255]."""
    coef = np.asarray([65.481, 128.553, 24.966])
    return (img / 255.0) @ coef + 16.0


def calculate_niqe(img, crop_border: int = 0, input_order: str = "HWC",
                   convert_to: str = "y", channel_order: str = "rgb",
                   pris_path: str | None = None) -> float:
    """NIQE of an image on [0, 255]: HWC RGB by default, 'CHW', or a gray
    (H, W) / (H, W, 1). A no-reference metric: it takes the output alone.
    ``channel_order='bgr'`` reads the reference's BGR arrays."""
    mu_pris, cov_pris = load_pris_params(pris_path)
    img = np.asarray(img, np.float32)
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    if img.ndim == 3 and img.shape[2] >= 3:
        rgb = img[..., :3] if channel_order == "rgb" else img[..., 2::-1]
        if convert_to == "y":
            img = _rgb_to_y(rgb)
        else:  # gray: ITU-R 601 luma on [0, 1], as cv2 takes it
            img = (rgb / 255.0) @ np.asarray([0.299, 0.587, 0.114]) * 255.0
    img = np.squeeze(img)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return niqe(img, mu_pris, cov_pris)
