"""Host-side image I/O for the predictors, the CLI and the ASDQE protocol.

cv2 first, PIL second, as in the JAX package's reader; where neither is
installed, PNG files go through ``utils/png.py`` (numpy and zlib only) and
anything else raises. Every route gives cv2's pixels: its BGR(A) channel
order, gray+alpha read as BGRA, and its fixed-point BGR -> gray weights.
  * ``imread_rgb``: RGB float32 [0,1] HWC (IMREAD_UNCHANGED, alpha dropped,
    gray repeated); ``imread_rgb_ubyte``: the same as uint8.
  * ``imread_gray``: grayscale float32 [0,1] HW (BGR2GRAY on colour).
  * ``imread_bgr`` / ``imfrombytes_bgr``: BGR float32 [0,1] HWC
    (IMREAD_COLOR), from a file or from encoded bytes;
    ``imfrombytes_gray``: ``imread_gray`` from encoded bytes.
  * ``imwrite``: uint8 (or [0,1] float) RGB, BGR or gray to a file.
  * ``resize_area``: INTER_AREA resize (a stack's frames to frame 0's size).
"""

from __future__ import annotations

import io
import os
from glob import glob

import numpy as np

from . import png

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


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _to_bgr_order(img: np.ndarray) -> np.ndarray:
    """File-order pixels (gray, gray+alpha, RGB, RGBA) -> cv2's
    IMREAD_UNCHANGED layout (gray, BGRA, BGR, BGRA)."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        img = np.concatenate([np.repeat(img[:, :, :1], 3, axis=2), img[:, :, 1:]], axis=2)
    return np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], axis=2)


def _decode(path: str | None, data: bytes | None, color: bool) -> np.ndarray:
    """cv2.imread / imdecode with IMREAD_COLOR (``color``) or
    IMREAD_UNCHANGED, by whichever route is installed."""
    name = path if path is not None else "<bytes>"
    cv2 = _cv2()
    if cv2 is not None:
        flag = cv2.IMREAD_COLOR if color else cv2.IMREAD_UNCHANGED
        img = (cv2.imread(path, flag) if data is None
               else cv2.imdecode(np.frombuffer(data, np.uint8), flag))
        if img is None:
            raise IOError(f"failed to read image: {name}")
        return img
    image = _pil()
    if image is not None:
        with image.open(path if data is None else io.BytesIO(data)) as im:
            if im.mode not in ("L", "LA", "RGB", "RGBA"):
                im = im.convert("RGBA" if "A" in im.getbands() else "RGB")
            img = _to_bgr_order(np.asarray(im))
    elif (path or "").lower().endswith(".png") or (data or b"").startswith(png.SIGNATURE):
        img = _to_bgr_order(png.read(path) if data is None else png.decode(data))
    else:
        raise ImportError(f"{name}: reading an image other than PNG needs cv2 or PIL")
    if color:
        img = np.repeat(img[:, :, None], 3, axis=2) if img.ndim == 2 else img[:, :, :3]
    return img


def _bgr2gray(img: np.ndarray) -> np.ndarray:
    """cv2.COLOR_BGR2GRAY on uint8 (alpha ignored): OpenCV 4's 15-bit
    fixed-point weights without cv2."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    b, g, r = (img[:, :, i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(np.uint8)


def _rgb_uint8(path: str) -> np.ndarray:
    img = _decode(path, None, color=False)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 4:
        img = img[:, :, :3]
    if img.shape[2] == 3:
        return np.ascontiguousarray(img[:, :, ::-1])
    return np.repeat(img, 3, axis=2)


def imread_rgb(path: str) -> np.ndarray:
    """RGB float32 [0,1] HWC (the teacher notebook's load path)."""
    return _rgb_uint8(path).astype(np.float32) / 255.0


def imread_rgb_ubyte(path: str) -> np.ndarray:
    """RGB uint8 HWC, the values ``rint(imread_rgb(path) * 255)`` gives in
    the JAX package (decode /255, then back to bytes)."""
    return np.rint(imread_rgb(path) * 255.0).astype(np.uint8)


def _gray(img: np.ndarray) -> np.ndarray:
    return (img if img.ndim == 2 else _bgr2gray(img)).astype(np.float32) / 255.0


def imread_gray(path: str) -> np.ndarray:
    """Grayscale float32 [0,1] HW (IMREAD_UNCHANGED, BGR2GRAY on colour)."""
    return _gray(_decode(path, None, color=False))


def imread_bgr(path: str) -> np.ndarray:
    """BGR float32 [0,1] HWC: the training datasets read BGR, then flip to
    RGB at tensor time."""
    return _decode(path, None, color=True).astype(np.float32) / 255.0


def imfrombytes_bgr(buf: bytes) -> np.ndarray:
    """Encoded image bytes -> BGR float32 [0,1] HWC, bit-identical to
    ``imread_bgr`` on the same file's bytes."""
    return _decode(None, buf, color=True).astype(np.float32) / 255.0


def imfrombytes_gray(buf: bytes) -> np.ndarray:
    """Encoded image bytes -> grayscale float32 [0,1] HW, as ``imread_gray``."""
    return _gray(_decode(None, buf, color=False))


def imwrite(path: str, img: np.ndarray, rgb: bool = True) -> None:
    """Write a uint8 (or [0,1] float) image, creating parent directories.
    A 3-channel ``img`` is RGB, or BGR with ``rgb=False``; 4 channels are
    BGRA, as cv2 takes them. Without cv2 and PIL
    only ``.png`` is written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if img.dtype != np.uint8:
        img = to_ubyte(img)
    cv2 = _cv2()
    if cv2 is not None:
        out = img
        if img.ndim == 3 and img.shape[2] == 3 and rgb:
            out = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        if not cv2.imwrite(path, out):
            raise IOError(f"failed to write image: {path}")
        return
    if img.ndim == 3 and (img.shape[2] == 4 or (img.shape[2] == 3 and not rgb)):
        img = np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], axis=2)  # to RGB(A)
    image = _pil()
    if image is not None:
        image.fromarray(img[:, :, 0] if img.ndim == 3 and img.shape[2] == 1 else img).save(path)
    elif path.lower().endswith(".png"):
        png.write(path, img)
    else:
        raise ImportError(f"{path}: writing an image other than PNG needs cv2 or PIL")


def resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.INTER_AREA resize to (h, w); PIL's BOX filter without cv2."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    image = _pil()
    if image is None:
        raise ImportError("resizing frames needs cv2 or PIL")
    return np.asarray(
        image.fromarray((img * 255).astype(np.uint8)).resize((w, h), image.BOX)
    ).astype(np.float32) / 255.0
