"""Tracing and profiling (the JAX package's ``utils/profiling.py`` in
PyTorch's idiom).

``trace(log_dir)`` captures the work inside it with ``torch.profiler`` (the
CPU and, where there is one, the GPU) and writes a Chrome trace into
``log_dir`` (viewable in Perfetto). ``aggregate_trace`` reads the newest
trace back: device milliseconds by kernel name, and the number of kernel
events read (``torch.profiler`` can lose launches, so a reader should see
how many it got). On a CPU-only trace the split is the host's top-level
operators instead. ``h2d_copies`` lists the bytes of each host-to-device
copy in the trace; ``uploads`` counts them exactly as PyTorch's dispatcher
sees them (a trace can lose copies as it loses launches). ``annotate`` names
a region of the timeline; ``StepTimer`` times iterations for the logger.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import defaultdict
from typing import Iterator

# device work in a Kineto trace: kernels, copies and fills
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator:
    """``with trace(dir): step()`` writes ``dir/trace_<ns>.json``; yields
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def trace_events(log_dir: str) -> list[dict]:
    """The complete events of the newest trace under ``log_dir`` (none
    where there is no trace)."""
    paths = sorted(glob.glob(os.path.join(log_dir, "trace_*.json")))
    if not paths:
        return []
    with open(paths[-1]) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("dur") is not None]


def _top_level(events: list[dict]) -> list[dict]:
    """The events that no earlier event of their thread encloses."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (str(e.get("pid")), str(e.get("tid")), e["ts"])):
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(key, float("-inf")):
            out.append(e)
            ends[key] = e["ts"] + e["dur"]
    return out


def aggregate_trace(log_dir: str) -> tuple[dict[str, float], int]:
    """(ms by kernel name, largest first; the number of events summed) of
    the newest trace. Without device events, the host's top-level operators
    stand in."""
    events = trace_events(log_dir)
    read = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not read:
        read = _top_level([e for e in events if e.get("cat") == "cpu_op"])
    totals: dict[str, float] = defaultdict(float)
    for e in read:
        totals[e["name"]] += e["dur"] / 1e3  # us -> ms
    return dict(sorted(totals.items(), key=lambda kv: -kv[1])), len(read)


def h2d_copies(log_dir: str) -> list[int | None]:
    """The bytes of each host-to-device copy in the newest trace (None
    where the event does not say)."""
    return [(e.get("args") or {}).get("bytes") for e in trace_events(log_dir)
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]


@contextlib.contextmanager
def uploads() -> Iterator[list[int]]:
    """``with uploads() as copies: step()``: ``copies`` gets the bytes of
    each tensor copied from the host to a device on this thread, as the
    dispatcher sees ``.to`` and ``copy_``; not seen: the autograd engine's
    own threads, and ``torch.tensor(data, device=...)``'s copy inside the
    tensor's construction."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    copies: list[int] = []

    def host_to_device(src, dst) -> bool:
        return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.device.type == "cpu" and dst.device.type != "cpu")

    class _Uploads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten._to_copy.default and host_to_device(args[0], out):
                copies.append(args[0].numel() * args[0].element_size())
            elif func is aten.copy_.default and host_to_device(args[1], args[0]):
                copies.append(args[1].numel() * args[1].element_size())
            return out

    with _Uploads():
        yield copies


def annotate(name: str):
    """A named region of the profiler's timeline."""
    import torch

    return torch.profiler.record_function(name)


class StepTimer:
    """Tracks iter/data times and an exponential moving average."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.iter_time = 0.0
        self.data_time = 0.0
        self._avg_iter = None
        self._mark = time.perf_counter()

    def data_ready(self) -> None:
        now = time.perf_counter()
        self.data_time = now - self._mark
        self._mark = now

    def step_done(self) -> None:
        now = time.perf_counter()
        self.iter_time = now - self._mark
        self._mark = now
        if self._avg_iter is None:
            self._avg_iter = self.iter_time
        else:
            self._avg_iter = (self.momentum * self._avg_iter
                              + (1 - self.momentum) * self.iter_time)

    @property
    def avg_iter_time(self) -> float:
        return self._avg_iter or 0.0

    def eta_seconds(self, remaining_steps: int) -> float:
        return self.avg_iter_time * remaining_steps
