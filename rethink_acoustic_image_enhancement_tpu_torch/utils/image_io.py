"""Host-side image reading for the predictors and the ASDQE protocol.

cv2 first, PIL second, as in the JAX package's reader. Where neither is
installed, reading a file raises a clear ImportError; nothing on a path that
takes arrays needs either.
  * ``imread_rgb_ubyte``: RGB uint8 HWC (the teacher and the scorer).
  * ``imread_gray``: grayscale float32 [0,1] HW (the student's frames).
  * ``resize_area``: INTER_AREA resize (a stack's frames to frame 0's size).
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def list_images(folder: str) -> list[str]:
    """The image files of ``folder`` (by extension), sorted by path."""
    files = [f for f in glob(os.path.join(folder, "*"))
             if f.lower().endswith(IMG_EXTS)]
    return sorted(files)


def to_ubyte(img: np.ndarray) -> np.ndarray:
    """skimage.img_as_ubyte for float [0,1] input: round-half-to-even."""
    return np.rint(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image(what: str):
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"{what} needs cv2 or PIL; neither is installed "
            "(pass arrays to the predictors instead)") from None
    return Image


def _imread_rgb_uint8(path: str) -> np.ndarray:
    cv2 = _cv2()
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
    with _pil_image("reading image files").open(path) as im:
        return np.asarray(im.convert("RGB"))


def imread_rgb_ubyte(path: str) -> np.ndarray:
    """RGB uint8 HWC, the values ``rint(imread_rgb(path) * 255)`` gives in
    the JAX package (decode /255, then back to bytes)."""
    img = _imread_rgb_uint8(path).astype(np.float32) / 255.0
    return np.rint(img * 255.0).astype(np.uint8)


def imread_gray(path: str) -> np.ndarray:
    """Grayscale float32 [0,1] HW (IMREAD_UNCHANGED, BGR2GRAY on colour)."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"failed to read image: {path}")
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    else:
        with _pil_image("reading image files").open(path) as im:
            img = np.asarray(im.convert("L"))
    return img.astype(np.float32) / 255.0


def resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.INTER_AREA resize to (h, w); PIL's BOX filter without cv2."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    image = _pil_image("resizing frames")
    return np.asarray(
        image.fromarray((img * 255).astype(np.uint8)).resize((w, h), image.BOX)
    ).astype(np.float32) / 255.0
