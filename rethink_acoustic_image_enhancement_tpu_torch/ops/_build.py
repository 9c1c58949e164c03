"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface under ``build/`` at the checkout root,
named by the content hash of the source and of every header (``csrc/*.cuh``:
an edited header must not load a stale library), and is bound with
``ctypes``. A build
happens on first use, never at import; ``build_all`` starts one ``nvcc``
for each library at once. ptxas' register and spill report is kept beside
each library as ``<lib>.log`` (``build_log``, ``kernel_resources``).

``VARIANTS`` names second libraries of a source built with extra flags:
``stage_clocks`` is ``csrc/stage.cu`` with ``-DRAIE_PHASE_CLOCKS``, whose
kernels count cycles per phase (``ops/phase_clocks.py``). No serving path
loads it.

Every wrapper launches under ``on_device`` (the tensor's card is the current
device, so the C side's launches, occupancy queries and shared-memory
opt-in land there) and counts a launch with ``count_launch`` (under one lock:
copies of a model may serve from one thread per device).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> (source stem, extra nvcc flags)
VARIANTS = {"stage_clocks": ("stage", ("-DRAIE_PHASE_CLOCKS",))}

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # one build and one load of a library per process
_launch_lock = threading.Lock()  # the wrappers' ``launches`` counts


def _source(name: str) -> tuple[str, tuple[str, ...]]:
    return VARIANTS.get(name, (name, ()))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    stem, flags = _source(name)
    digest = hashlib.sha1((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for library <name> unless it exists; returns (process or
    None, temporary output, final path)."""
    out = _lib_path(name)
    if out.exists():
        return None, None, out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    stem, flags = _source(name)
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for library {name}:\n{log}")
    os.replace(tmp, out)


def sources() -> list[str]:
    """Every library: one for each csrc/*.cu, and the variants."""
    return sorted([p.stem for p in CSRC.glob("*.cu")] + list(VARIANTS))


def build_all() -> dict[str, Path]:
    """Compile every library at once (one nvcc each); returns the paths."""
    started = {n: _start(n) for n in sources()}
    for n, (proc, tmp, out) in started.items():
        _finish(n, proc, tmp, out)
    return {n: out for n, (_, _, out) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library <name>, building it on first use (once,
    whichever thread asks first)."""
    with _load_lock:
        if name not in _loaded:
            proc, tmp, out = _start(name)
            _finish(name, proc, tmp, out)
            _loaded[name] = ctypes.CDLL(str(out))
        return _loaded[name]


def bind(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """``load(name)`` with the argument types of its int-returning entry
    points set (a pointer passed untyped would be cut to 32 bits) and its
    ``raie_<source>_error_string`` typed."""
    lib = load(name)
    with _load_lock:
        if not getattr(lib, "_raie_typed", False):
            for fn_name, args in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            err = getattr(lib, f"raie_{_source(name)[0]}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            lib._raie_typed = True
    return lib


def on_device(x, what: str, **weights):
    """The device guard of a kernel call on CUDA tensor ``x``: raises a
    ValueError naming both devices where a weight (None for an absent
    optional one) lies on another device, and returns
    ``torch.cuda.device(x.device)`` to launch under."""
    import torch

    for key, w in weights.items():
        if w is not None and w.device != x.device:
            raise ValueError(f"{what} kernel: {key} is on {w.device}, x on {x.device}")
    return torch.cuda.device(x.device)


def count_launch(fn) -> None:
    """``fn.launches += 1`` under a lock (a read-modify-write that threads
    launching at once would otherwise lose)."""
    with _launch_lock:
        fn.launches += 1


def check(lib: ctypes.CDLL, name: str, code: int, what: str) -> None:
    """Raise unless an entry point of csrc/<name>.cu returned 0."""
    if code != 0:
        msg = getattr(lib, f"raie_{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel {what} failed ({code}): {msg}")


def build_log(name: str) -> str:
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel_resources(name: str) -> dict[str, dict[str, int]]:
    """{kernel: {"registers": the most a thread of any instantiation uses,
    "spill_bytes": the most any spills (stores or loads)}} of library
    <name>, read off ptxas' report. Kernels are named ``k_<lowercase>``,
    which is how they are found in the mangled entry names."""
    out: dict[str, dict[str, int]] = {}
    row = None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '\w*?(k_[a-z_]+)", line)
        if m:
            row = out.setdefault(m.group(1), {"registers": 0, "spill_bytes": 0})
        elif row is not None:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                row["registers"] = max(row["registers"], int(m.group(1)))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                row["spill_bytes"] = max(row["spill_bytes"], int(m.group(1)),
                                         int(m.group(2)))
    return out
