"""Host-side paired transforms (numpy, explicit RNG).

Ports of Train/basicsr/data/transforms.py and the padding helpers in
utils/img_util.py:148-164, with one systematic change: every random
transform takes an explicit ``np.random.Generator`` instead of mutating
global ``random``/np.random state — reproducible and worker-safe.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """transforms.py:5-22."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def pad_to_min_size(img_lq: np.ndarray, img_gt: np.ndarray, gt_size: int):
    """Reflect-pad bottom/right up to gt_size (img_util.py:148-164;
    cv2.BORDER_REFLECT == numpy mode='symmetric', edge pixel duplicated)."""
    def pad(img):
        h, w = img.shape[:2]
        hp, wp = max(0, gt_size - h), max(0, gt_size - w)
        if hp == 0 and wp == 0:
            out = img
        else:
            pad_spec = [(0, hp), (0, wp)] + [(0, 0)] * (img.ndim - 2)
            out = np.pad(img, pad_spec, mode="symmetric")
        if out.ndim == 2:
            out = out[..., None]
        return out

    return pad(img_lq), pad(img_gt)


def paired_random_crop(img_gts, img_lqs, lq_patch_size: int, scale: int,
                       rng: np.random.Generator):
    """transforms.py:24-83: same random window on lq, scaled window on gt."""
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    gts = [img_gts] if single_gt else list(img_gts)
    lqs = [img_lqs] if single_lq else list(img_lqs)

    h_lq, w_lq = lqs[0].shape[:2]
    h_gt, w_gt = gts[0].shape[:2]
    gt_patch_size = int(lq_patch_size * scale)
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f"scale mismatch: GT {(h_gt, w_gt)} vs "
                         f"{scale}x LQ {(h_lq, w_lq)}")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f"LQ {(h_lq, w_lq)} smaller than patch "
                         f"{lq_patch_size}")

    top = int(rng.integers(0, h_lq - lq_patch_size + 1))
    left = int(rng.integers(0, w_lq - lq_patch_size + 1))
    lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...]
           for v in lqs]
    tg, lg = top * scale, left * scale
    gts = [v[tg:tg + gt_patch_size, lg:lg + gt_patch_size, ...] for v in gts]
    return (gts[0] if single_gt else gts), (lqs[0] if single_lq else lqs)


def data_augmentation(image: np.ndarray, mode: int) -> np.ndarray:
    """The 8 flip/rot90 modes (transforms.py:217-268)."""
    if mode == 0:
        out = image
    elif mode == 1:
        out = np.flipud(image)
    elif mode == 2:
        out = np.rot90(image)
    elif mode == 3:
        out = np.flipud(np.rot90(image))
    elif mode == 4:
        out = np.rot90(image, k=2)
    elif mode == 5:
        out = np.flipud(np.rot90(image, k=2))
    elif mode == 6:
        out = np.rot90(image, k=3)
    elif mode == 7:
        out = np.flipud(np.rot90(image, k=3))
    else:
        raise ValueError(f"invalid augmentation mode {mode}")
    return out


def random_augmentation(*arrays: np.ndarray, rng: np.random.Generator):
    """One shared random mode for all arrays (transforms.py:270-275)."""
    mode = int(rng.integers(0, 8))
    return [np.ascontiguousarray(data_augmentation(a, mode)) for a in arrays]


def sync_augment_multi_scale(arrays: Sequence[np.ndarray],
                             rng: np.random.Generator) -> list[np.ndarray]:
    """The teacher dataset's synchronized flip/flip/rot augmentation
    (paired_image_dataset.py:1056-1082): 50% horizontal flip, 50% vertical
    flip, then one of {none, 90cw, 180, 270cw}. Works on arrays of
    different resolutions (gt / lq / 2x sr)."""
    out = list(arrays)
    if rng.random() < 0.5:
        out = [a[:, ::-1, ...] for a in out]
    if rng.random() < 0.5:
        out = [a[::-1, :, ...] for a in out]
    rot = rng.choice([0, 90, 180, 270])
    if rot:
        k = {90: 3, 180: 2, 270: 1}[rot]  # cv2 clockwise -> np.rot90 ccw k
        out = [np.rot90(a, k=k) for a in out]
    return [np.ascontiguousarray(a) for a in out]


def pad_image_center(image: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Zero-pad centered (student frame-stack alignment,
    paired_image_dataset.py:100-107)."""
    h, w = image.shape[:2]
    top = (target_h - h) // 2
    bottom = target_h - h - top
    left = (target_w - w) // 2
    right = target_w - w - left
    spec = [(top, bottom), (left, right)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, spec, mode="constant")


def add_random_noise(stack: np.ndarray, rng: np.random.Generator,
                     mean: float = 0.3, std: float = 0.7) -> np.ndarray:
    """Degenerate-input rescue noise (paired_image_dataset.py:86-91)."""
    noisy = stack + rng.normal(mean, std, stack.shape)
    return np.clip(noisy, 0, 1).astype(np.float32)


def add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                       sigma_range=(1, 30)) -> np.ndarray:
    """Teacher LQ noise injection (paired_image_dataset.py:1087-1092)."""
    sigma = rng.uniform(*sigma_range)
    noisy = img + rng.standard_normal(img.shape) * sigma / 255.0
    return np.clip(noisy, 0, 1).astype(np.float32)
