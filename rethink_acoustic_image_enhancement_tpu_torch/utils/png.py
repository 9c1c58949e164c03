"""8-bit PNG decode and encode with numpy and zlib only.

The image readers' last route (``utils/image_io.py``), for a machine that
has neither cv2 nor PIL. It handles non-interlaced 8-bit gray, gray+alpha,
RGB and RGBA images, reads all five row filters and writes unfiltered rows;
anything else (16-bit, palette, interlaced) raises ``ValueError`` naming the
file. Arrays are HW (gray) or HWC in the file's channel order.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> channels
_COLOR_TYPE = {c: t for t, c in CHANNELS.items()}


def _chunks(data: bytes, name: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends without IEND")


def _unfilter_diagonals(rows: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo every row filter at once. A byte depends on the bytes to its
    left, above and above-left, so the pixels of one anti-diagonal
    (y + x = d) are independent: one numpy step per anti-diagonal, the
    arrays held diagonal-major so that a step's operands are contiguous."""
    n = h + w - 1
    yy, xx = np.arange(h)[:, None], np.arange(w)[None, :]
    filt = np.zeros((n, h, bpp), np.int16)  # filt[y + x, y] = bytes of (y, x)
    filt[yy + xx, yy] = rows[:, 1:].reshape(h, w, bpp)
    rec = np.zeros((n + 2, h + 1, bpp), np.int16)  # rec[y + x + 2, y + 1], zeros around
    kinds = [np.broadcast_to((rows[:, :1] == k), (h, bpp)) for k in range(4)]
    for d in range(n):
        lo, hi = max(0, d - w + 1), min(h, d + 1)  # the rows with a pixel on d
        a, b, c = rec[d + 1, lo + 1:hi + 1], rec[d + 1, lo:hi], rec[d, lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - c - c)
        pred = np.where(pb <= pc, b, c)  # Paeth
        np.copyto(pred, a, where=(pa <= pb) & (pa <= pc))
        for kind, value in zip(kinds, (0, a, b, (a + b) >> 1)):  # None, Sub, Up, Average
            np.copyto(pred, value, where=kind[lo:hi])
        pred += filt[d, lo:hi]
        np.bitwise_and(pred, 0xFF, out=rec[d + 2, lo + 1:hi + 1])
    return rec[yy + xx + 2, yy + 1].astype(np.uint8).reshape(h, w * bpp)


def _unfilter(raw: bytes, h: int, w: int, bpp: int, name: str) -> np.ndarray:
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{name}: PNG image data too short")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{name}: unknown PNG row filter {rows[:, 0].max()}")
    if rows[:, 0].max(initial=0) > 2:  # Average or Paeth: sequential along a row
        return _unfilter_diagonals(rows, h, w, bpp)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            cur = line + prev
        out[y] = cur
        prev = out[y]
    return out


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 HW or HWC array."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace:
        raise ValueError(
            f"{name}: unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}); only 8-bit non-interlaced gray, gray+alpha, "
            "RGB and RGBA are read without cv2 or PIL")
    bpp = CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp, name)
    return img.reshape(h, w) if bpp == 1 else img.reshape(h, w, bpp)


def read(path: str) -> np.ndarray:
    """Decode the PNG file at ``path``."""
    with open(path, "rb") as fh:
        return decode(fh.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """uint8 HW or HWC (1-4 channels, the file's order) -> PNG bytes."""
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encoder takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    if bpp not in _COLOR_TYPE:
        raise ValueError(f"PNG encoder takes 1-4 channels, got {bpp}")
    rows = np.zeros((h, w * bpp + 1), np.uint8)  # filter byte 0 on each row
    rows[:, 1:] = np.ascontiguousarray(img).reshape(h, w * bpp)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[bpp], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode(img))
