"""Logging: root logger + per-iteration message formatting.

Port of Train/basicsr/utils/logger.py MessageLogger (epoch/iter/lr/ETA/
losses line, logger.py:10-77) with optional TensorBoard scalars; rank != 0
processes are silenced like the reference (@master_only / logger.py:137).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable


def get_logger(name: str = "raie", log_dir: str | None = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(log_dir, f"train_{int(time.time())}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    from .tracking import _rank

    if _rank() != 0:
        logger.setLevel(logging.ERROR)
    return logger


class JsonlMetricsSink:
    """Experiment tracker with no service behind it: one JSON line per
    logged event.

    The tracker-agnostic analog of the reference's wandb/swanlab hooks
    (Train/basicsr/utils/logger.py:87-105, Train/ASDQE.py:71-84) — training
    curves persist without any tracking service.
    Lines: {"kind": "train"|"val", "iter": N, ...scalars}.
    """

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, kind: str, current_iter: int, scalars: dict,
              **extra) -> None:
        import json

        rec = {"kind": kind, "iter": int(current_iter), "ts": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        rec.update(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class MessageLogger:
    """Formats '[epoch..][iter..] lr: .. eta: .. time: .. l_pix: ..' lines
    with ETA estimation (logger.py:33-77)."""

    def __init__(self, total_iters: int, start_iter: int = 0,
                 log: Callable[[str], None] | None = None,
                 tb_log_dir: str | None = None,
                 jsonl_path: str | None = None,
                 remote=None):
        self.total_iters = total_iters
        self.start_iter = start_iter
        self.start_time = time.time()
        self.log = log or print
        self.jsonl = JsonlMetricsSink(jsonl_path) if jsonl_path else None
        # Optional utils.tracking.RemoteTracker (wandb/swanlab analog of
        # the reference's tb->wandb sync, logger.py:87-105); receives the
        # same tags TensorBoard gets.
        self.remote = remote
        self._tb = None
        if tb_log_dir:
            # torch's writer (it needs the tensorboard package); warn
            # loudly instead of silently dropping the request
            # (logger.py:80-86 analog)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(tb_log_dir)
            else:
                import warnings

                warnings.warn(
                    "use_tb_logger requested but the tensorboard package is "
                    "not installed — TensorBoard scalars will NOT be "
                    "written (JSONL metrics sink still records everything)",
                    stacklevel=2)

    def close(self) -> None:
        """Flush and close the TensorBoard writer (its writer thread)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __call__(self, epoch: int, current_iter: int, metrics: dict,
                 iter_time: float = 0.0, data_time: float = 0.0) -> None:
        lr = metrics.get("lr")
        msg = f"[epoch:{epoch:3d}, iter:{current_iter:8,d}"
        if lr is not None:
            msg += f", lr:({lr:.3e})] "
        else:
            msg += "] "
        if current_iter > self.start_iter:
            elapsed = time.time() - self.start_time
            per_iter = elapsed / (current_iter - self.start_iter)
            eta = per_iter * (self.total_iters - current_iter)
            msg += f"[eta: {_fmt_time(eta)}, time: {iter_time:.3f}, " \
                   f"data_time: {data_time:.3f}] "
        remote_scalars = {}
        for k, v in metrics.items():
            if k == "lr":
                continue
            msg += f"{k}: {v:.4e} "
            tag = k if k.startswith("m_") else f"losses/{k}"
            if self._tb is not None:
                self._tb.add_scalar(tag, v, current_iter)
            remote_scalars[tag] = v
        if self.remote is not None and remote_scalars:
            self.remote.log(remote_scalars, step=current_iter)
        if self.jsonl is not None:
            self.jsonl.write("train", current_iter, metrics, epoch=epoch,
                             iter_time=iter_time, data_time=data_time)
        self.log(msg)


def _fmt_time(seconds: float) -> str:
    s = int(seconds)
    d, s = divmod(s, 86400)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    if d:
        return f"{d}d {h}:{m:02d}:{s:02d}"
    return f"{h}:{m:02d}:{s:02d}"
