"""Remote experiment-tracker sinks (wandb / swanlab).

The reference syncs its TensorBoard stream to wandb
(Train/basicsr/utils/logger.py:87-105: resume_id -> resume='allow', else a
generated run id with resume='never', ``sync_tensorboard=True``) and the
ASDQE trainer logs batch/epoch metrics to swanlab
(Train/ASDQE.py:71-84,128-144). This module is the analog: one
backend-agnostic :class:`RemoteTracker` wrapping either client library.

The tracker is lib-gated: requesting it without the library warns loudly
and degrades to a no-op (the JSONL sink still records everything). It
takes an injectable ``module``, so the whole call protocol is testable
against an in-process fake.
"""

from __future__ import annotations

import uuid
import warnings
from typing import Any


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class RemoteTracker:
    """Rank-0-gated wandb- or swanlab-compatible metrics sink.

    Parameters mirror the reference hooks: ``backend`` selects the client
    protocol ('wandb' | 'swanlab'), ``project``/``run_name``/``config``
    feed ``init``, and ``resume_id`` reproduces the wandb resume semantics
    of logger.py:94-100. ``module`` injects a fake client for tests; when
    omitted the real library is imported and a missing install disables
    the tracker with a warning instead of crashing training.
    """

    def __init__(self, backend: str, project: str,
                 run_name: str | None = None,
                 config: dict[str, Any] | None = None,
                 resume_id: str | None = None,
                 module: Any = None):
        if backend not in ("wandb", "swanlab"):
            raise ValueError(f"unknown tracker backend {backend!r} "
                             "(expected 'wandb' or 'swanlab')")
        self.backend = backend
        self.run_id: str | None = None
        self._mod = None
        if _rank() != 0:  # @master_only analog (dist_util.py:75)
            return
        if module is None:
            try:
                module = __import__(backend)
            except ImportError:
                warnings.warn(
                    f"logger.{backend} requested but the {backend} package "
                    f"is not installed — remote tracking disabled (the "
                    f"JSONL metrics sink still records everything)",
                    stacklevel=2)
                return
        self._mod = module
        if backend == "wandb":
            # logger.py:94-104: resume an explicit id, else a fresh
            # generated id that must not resume an older run.
            if resume_id:
                self.run_id, resume = str(resume_id), "allow"
            else:
                gen = getattr(getattr(module, "util", None), "generate_id",
                              None)
                self.run_id = gen() if gen else uuid.uuid4().hex[:8]
                resume = "never"
            module.init(id=self.run_id, resume=resume, name=run_name,
                        config=config, project=project,
                        sync_tensorboard=True)
        else:
            kwargs: dict[str, Any] = {"project": project,
                                      "config": config or {}}
            if run_name:
                kwargs["experiment_name"] = run_name
            module.init(**kwargs)

    @property
    def enabled(self) -> bool:
        return self._mod is not None

    def log(self, scalars: dict[str, float],
            step: int | None = None) -> None:
        if self._mod is None:
            return
        scalars = {k: float(v) for k, v in scalars.items()}
        if self.backend == "wandb":
            self._mod.log(scalars, step=step)
        else:
            # swanlab carries the step inside the payload, the way
            # Train/ASDQE.py:128-133 logs "train_step"
            if step is not None and "step" not in scalars:
                scalars = dict(scalars, step=float(step))
            self._mod.log(scalars)

    def finish(self) -> None:
        if self._mod is not None and hasattr(self._mod, "finish"):
            self._mod.finish()


def make_tracker(logger_cfg: dict[str, Any], run_name: str,
                 config: dict[str, Any] | None = None,
                 module: Any = None) -> RemoteTracker | None:
    """Build the tracker a config's ``logger:`` block asks for, or None.

    Mirrors the reference's gating (train.py:104-108): wandb starts only
    when ``logger.wandb.project`` is set (the shipped configs carry
    ``project: ~``, i.e. off). A ``logger.swanlab.project`` key selects
    the swanlab protocol the ASDQE trainer uses.
    """
    for backend in ("wandb", "swanlab"):
        sub = (logger_cfg or {}).get(backend) or {}
        if sub.get("project"):
            return RemoteTracker(
                backend, sub["project"], run_name=run_name, config=config,
                resume_id=sub.get("resume_id"), module=module)
    return None
