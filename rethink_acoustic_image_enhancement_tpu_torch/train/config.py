"""YAML experiment configs, the reference's Options surface
(Train/basicsr/utils/options.py).

``parse(opt_path, is_train, root_path)`` returns the nested dict with phase
and scale injected per dataset, the experiment (train) or results (test)
paths laid out under ``root_path`` (the working directory by default), and
the ``debug`` name shortcut. ``validate`` checks model, dataset, loss and
scheduler names against the registries before anything runs, and refuses
what the JAX package refuses (``train.model_shard`` beside
``train.spatial_shard``) and online-distillation teacher weights that are
neither a ``.pth`` nor an orbax checkpoint directory.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any

import yaml

def parse(opt_path: str, is_train: bool = True,
          root_path: str | None = None) -> dict[str, Any]:
    with open(opt_path) as f:
        opt = yaml.safe_load(f)

    opt["is_train"] = is_train

    # datasets: inject phase + scale (options.py:48-57)
    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = dataset.get("phase", phase.split("_")[0])
        if "scale" in opt:
            dataset["scale"] = opt["scale"]
        for key in ("dataroot_gt", "dataroot_lq"):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])

    # paths (options.py:59-89)
    opt.setdefault("path", {})
    for key, val in opt["path"].items():
        if val is not None and ("resume_state" in key or "pretrain" in key):
            opt["path"][key] = osp.expanduser(val)
    root = root_path or os.getcwd()
    opt["path"]["root"] = root
    if is_train:
        exp_root = osp.join(root, "experiments", opt["name"])
        opt["path"]["experiments_root"] = exp_root
        opt["path"]["models"] = osp.join(exp_root, "models")
        opt["path"]["training_states"] = osp.join(exp_root, "training_states")
        opt["path"]["log"] = exp_root
        opt["path"]["visualization"] = osp.join(exp_root, "visualization")
        if "debug" in opt["name"]:  # debug shortcut (options.py:77-82)
            opt.setdefault("val", {})["val_freq"] = 8
            opt.setdefault("logger", {})["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(root, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = osp.join(results_root, "visualization")
    return opt


def validate(opt: dict[str, Any]) -> None:
    """Fail fast on dead component names and on options not ported yet."""
    from ..data.datasets import check_dataset_type, validate_dataset_opt
    from ..losses import _REGISTRY as LOSSES
    from ..models import REGISTRY as MODELS
    from .schedules import SCHEDULERS

    net = opt.get("network_g", {})
    if net.get("type") not in MODELS:
        raise KeyError(f"network_g.type {net.get('type')!r} not in "
                       f"{sorted(MODELS)}")
    for phase, ds in (opt.get("datasets") or {}).items():
        try:
            check_dataset_type(ds.get("type"))
        except KeyError:
            raise KeyError(f"datasets.{phase}.type {ds.get('type')!r} is "
                           "unknown") from None
        # device_resident is read from datasets.train only (the loop);
        # elsewhere it is a known key that does nothing, as in JAX
        validate_dataset_opt(ds, where=f"datasets.{phase}")
    train = opt.get("train")
    if train:
        distill = train.get("distill") or {}
        if distill.get("online"):
            validate_distill(distill)
        if int(train.get("model_shard") or 1) > 1 \
                and int(train.get("spatial_shard") or 1) > 1:  # JAX loop.py:141-144
            raise ValueError("train.model_shard and train.spatial_shard "
                             "cannot be combined (as in the JAX package, "
                             "whose SPMD partitioner mis-partitions "
                             "feature-sharded convs under halo exchange)")
        pix = train.get("pixel_opt", {})
        if pix.get("type") not in LOSSES:
            raise KeyError(f"train.pixel_opt.type {pix.get('type')!r} not in "
                           f"{sorted(LOSSES)}")
        sched = train.get("scheduler", {}).get("type")
        if sched not in SCHEDULERS:
            raise KeyError(f"train.scheduler.type {sched!r} not in "
                           f"{sorted(SCHEDULERS)}")


def validate_distill(distill: dict[str, Any]) -> None:
    """``train.distill`` with ``online: true``: a registered teacher and
    weights that are a ``.pth`` or an orbax checkpoint directory."""
    from ..convert.orbax import is_checkpoint
    from ..models import REGISTRY as MODELS

    teacher = distill.get("teacher") or {}
    if teacher.get("type") not in MODELS:
        raise KeyError(f"train.distill.teacher.type {teacher.get('type')!r} "
                       f"not in {sorted(MODELS)}")
    weights = str(distill.get("teacher_weights") or "")
    if not weights.endswith(".pth") and not is_checkpoint(weights):
        raise ValueError(
            f"train.distill.teacher_weights {weights!r} is neither a "
            "reference-layout .pth nor an orbax checkpoint directory")


def make_exp_dirs(opt: dict[str, Any]) -> None:
    for key in ("experiments_root", "models", "training_states", "log",
                "visualization", "results_root"):
        path = opt["path"].get(key)
        if path:
            os.makedirs(path, exist_ok=True)
