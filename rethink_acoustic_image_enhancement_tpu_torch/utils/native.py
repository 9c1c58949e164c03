"""The host frame masker: a ctypes binding of ``csrc/raie_native.cpp``.

The library (xoshiro256** Bernoulli masks, the 8 flip/rot90 modes and the
uint8 -> float32 boundary, multithreaded, with a plain C interface) is
built with ``g++`` on first use into ``build/`` at the checkout root, named
by the content hash of the source, and loaded once per process; its ABI
version must be 1. Every entry point keeps a numpy fallback for a machine
without a compiler. The two routes draw different random numbers from one
seed, so the route taken is logged once and ``available()`` tells it.

``python -m rethink_acoustic_image_enhancement_tpu_torch.utils.native``
builds eagerly.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "raie_native.cpp"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-march=native"]
ABI_VERSION = 1

_lock = threading.Lock()
_state: dict = {"lib": None, "tried": False}


def lib_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"libraie_native-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    where ``g++`` is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, out)  # atomic: concurrent processes each write their own tmp
    return out


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    i64, f32, u64, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_uint64, ctypes.c_int
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.raie_input_mask_f32.argtypes = [fp, i64, f32, f32, u64, i32]
    lib.raie_input_mask_f32.restype = None
    lib.raie_mask_frames_f32.argtypes = [fp, i64, i64, fp, f32, u64, i32]
    lib.raie_mask_frames_f32.restype = None
    lib.raie_geometric_f32.argtypes = [fp, fp, i64, i64, i64, i32, i32]
    lib.raie_geometric_f32.restype = None
    lib.raie_u8_to_f32_norm.argtypes = [u8p, fp, i64, i64, i32, i32]
    lib.raie_u8_to_f32_norm.restype = None
    lib.raie_native_abi_version.argtypes = []
    lib.raie_native_abi_version.restype = i32
    if lib.raie_native_abi_version() != ABI_VERSION:
        raise OSError(f"{path}: ABI version {lib.raie_native_abi_version()}, "
                      f"expected {ABI_VERSION}")
    return lib


def load():
    """The bound library, building it on first use; None where it cannot
    be built or loaded (the numpy fallback then runs). Logs the route once."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        log = logging.getLogger("raie-torch")
        try:
            _state["lib"] = _bind(build())
            log.info("frame masker: native route (%s)", lib_path().name)
        except (OSError, subprocess.SubprocessError) as exc:
            log.warning("frame masker: numpy route (the native library did "
                        "not build or load: %s)", exc)
        return _state["lib"]


def available() -> bool:
    """True where the native route runs."""
    return load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _seed(seed: int) -> int:
    return int(seed) & (2 ** 64 - 1)


def input_mask(img: np.ndarray, prob: float, value: float = 0.1,
               seed: int = 0, nthreads: int = 0) -> np.ndarray:
    """A masked copy of ``img``: kept pixels unchanged, dropped ones -value,
    P(drop) = min(prob, 1). The native route's draws depend on the thread
    count (one generator per thread)."""
    lib = load()
    out = np.ascontiguousarray(img, dtype=np.float32).copy()
    if lib is None:
        rng = np.random.default_rng(seed)
        keep = (rng.random(out.shape) >= min(prob, 1.0)).astype(np.float32)
        return out * keep - value + value * keep
    lib.raie_input_mask_f32(_fptr(out), out.size, float(prob), float(value),
                            _seed(seed), nthreads)
    return out


def mask_frames(stack: np.ndarray, probs: np.ndarray, value: float = 0.1,
                seed: int = 0, nthreads: int = 0) -> np.ndarray:
    """A masked copy of an (F, H, W) stack, frame f dropped with probs[f]
    (one generator per frame: the draws do not depend on the threads)."""
    lib = load()
    out = np.ascontiguousarray(stack, dtype=np.float32).copy()
    probs = np.ascontiguousarray(probs, dtype=np.float32)
    f = out.shape[0]
    if probs.shape != (f,):
        raise ValueError(f"probs {probs.shape} for {f} frames")
    if lib is None:
        rng = np.random.default_rng(seed)
        for i in range(f):
            keep = (rng.random(out[i].shape) >= min(float(probs[i]), 1.0)
                    ).astype(np.float32)
            out[i] = out[i] * keep - value + value * keep
        return out
    lib.raie_mask_frames_f32(_fptr(out), f, out.size // f, _fptr(probs),
                             float(value), _seed(seed), nthreads)
    return out


def geometric(img: np.ndarray, mode: int, nthreads: int = 0) -> np.ndarray:
    """The 8 flip/rot90 augmentation modes on (H, W[, C]) float32."""
    if not 0 <= int(mode) <= 7:
        raise ValueError(f"mode {mode} not in 0..7")
    lib = load()
    squeeze = img.ndim == 2
    src = np.ascontiguousarray(img[..., None] if squeeze else img, dtype=np.float32)
    h, w, c = src.shape
    if lib is None:
        from ..data.transforms import data_augmentation

        out = np.ascontiguousarray(data_augmentation(src, mode))
    else:
        shape = (w, h, c) if mode in (2, 3, 6, 7) else (h, w, c)
        out = np.empty(shape, np.float32)
        lib.raie_geometric_f32(_fptr(src), _fptr(out), h, w, c, int(mode), nthreads)
    return out[..., 0] if squeeze else out


def u8_to_f32(img: np.ndarray, bgr2rgb: bool = False,
              nthreads: int = 0) -> np.ndarray:
    """uint8 HW[C] -> float32 in [0, 1], optionally BGR -> RGB."""
    lib = load()
    src = np.ascontiguousarray(img, dtype=np.uint8)
    c = src.shape[-1] if src.ndim == 3 else 1
    if lib is None:
        out = src.astype(np.float32) / 255.0
        if bgr2rgb and c == 3:
            out = np.ascontiguousarray(out[..., ::-1])
        return out
    out = np.empty(src.shape, np.float32)
    lib.raie_u8_to_f32_norm(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            _fptr(out), src.size, c, int(bgr2rgb), nthreads)
    return out


if __name__ == "__main__":
    print(f"native build ok: {build()}")
