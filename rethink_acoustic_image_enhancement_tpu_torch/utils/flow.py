"""Optical-flow I/O (port of Train/basicsr/utils/flow_util.py).

.flo read/write (Middlebury 'PIEH' format) and the uint8
quantize/dequantize pair the reference's REDS flow side channel uses
(numpy only: the port's copy of the JAX package's module).
"""

from __future__ import annotations

import numpy as np

_FLO_MAGIC = 202021.25  # spells "PIEH" when read as float


def flowread(path: str) -> np.ndarray:
    """(H, W, 2) float32 flow from a .flo file."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if magic != _FLO_MAGIC:
            raise IOError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, h * w * 2)
    return data.reshape(h, w, 2)


def flowwrite(flow: np.ndarray, path: str) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([_FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.tofile(f)


def quantize_flow(flow: np.ndarray, max_val: float = 0.02,
                  norm: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Flow -> two uint8 maps (flow_util.quantize_flow): optionally
    normalized by image size, clipped to [-max_val, max_val], 255 levels."""
    h, w = flow.shape[:2]
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    out = []
    for d in (dx, dy):
        d = np.clip(d, -max_val, max_val)
        q = np.minimum(
            np.floor((d - (-max_val)) / (2 * max_val) * 255), 254
        ).astype(np.uint8)
        out.append(q)
    return out[0], out[1]


def dequantize_flow(dx: np.ndarray, dy: np.ndarray, max_val: float = 0.02,
                    denorm: bool = True) -> np.ndarray:
    """Inverse of quantize_flow (used by the REDS flow branch,
    reds_dataset.py:175)."""
    dx = dx.astype(np.float32)
    dy = dy.astype(np.float32)
    out = [(d + 0.5) / 255 * 2 * max_val - max_val for d in (dx, dy)]
    if denorm:
        out[0] *= dx.shape[1]
        out[1] *= dx.shape[0]
    return np.stack(out, axis=-1)
