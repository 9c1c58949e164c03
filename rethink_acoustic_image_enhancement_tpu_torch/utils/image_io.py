"""Host-side image reading for ``TeacherPredictor.denoise_file``.

cv2 first, PIL second, as in the JAX package's reader. Where neither is
installed, reading a file raises a clear ImportError.
"""

from __future__ import annotations

import numpy as np


def to_ubyte(img: np.ndarray) -> np.ndarray:
    """skimage.img_as_ubyte for float [0,1] input: round-half-to-even."""
    return np.rint(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _imread_rgb_uint8(path: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"failed to read image: {path}")
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 4:
            img = img[:, :, :3]
        if img.shape[2] == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        elif img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        return img
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            "reading image files needs cv2 or PIL; neither is installed "
            "(pass arrays to TeacherPredictor instead)") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imread_rgb_ubyte(path: str) -> np.ndarray:
    """RGB uint8 HWC, the values ``rint(imread_rgb(path) * 255)`` gives in
    the JAX package (decode /255, then back to bytes)."""
    img = _imread_rgb_uint8(path).astype(np.float32) / 255.0
    return np.rint(img * 255.0).astype(np.uint8)
