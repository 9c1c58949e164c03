"""Checkpoints and auto-resume, torch-native (the reference's two-file
scheme, base_model.py:213-351).

  * ``training_states/ckpt_{iter}.pth``: the whole training state (params,
    optimizer state, EMA, step, epoch and the loop's position), which
    ``restore_checkpoint`` loads back into a live ``TrainState``;
  * ``models/net_g_{iter}.pth``: weights only, in the reference layout
    ``{'params': state_dict[, 'params_ema': state_dict]}``, which
    ``convert/weights.py::load_pth`` and the CLI's ``--weights`` read.

A ``training_states`` directory may also hold the JAX package's form,
``ckpt_{iter}/`` (an orbax directory: ``_METADATA`` present; its
``train/checkpoints.py::save_checkpoint``), which ``restore_checkpoint``
loads through ``train/jax_state.py``. The port writes only the ``.pth``
form. ``latest_checkpoint`` finds the highest iteration of either form
(train.py:171-192) and says which it found. The rule: the highest
iteration wins; on a tie the port's ``.pth`` wins, because it holds the
loop's position and the host generators, which make its resume exact (a
JAX state restarts its epoch and its generators, as the JAX loop does).
``prune_checkpoints`` counts both forms, and both forms of ``net_g``.

Files are written to a temporary name and renamed, so a run cut during a
save leaves the previous checkpoint whole. In a process group only rank 0
writes, and every rank leaves a save together (a barrier); every rank
restores the same file onto its own device. ``load_pretrained``
reads a reference-layout ``.pth`` (a port ``net_g_*.pth`` or a reference
one) or an orbax checkpoint directory (the JAX package's ``net_g_*``)
strictly, or merges it non-strictly (``strict_load_g: false``,
base_model.py:246-279).
"""

from __future__ import annotations

import os
import os.path as osp
import re
import shutil
from typing import Any

import torch
from torch import nn

from ..convert.orbax import is_checkpoint, payload_keys
from ..convert.weights import arch_of, read_state_dict
from ..parallel import barrier, is_master
from .jax_state import load_jax_state

PTH, JAX = "pth", "jax"  # the two forms of a training state
_FORMS = {PTH: r"ckpt_(\d+)\.pth", JAX: r"ckpt_(\d+)"}
_WEIGHT_FORMS = {PTH: r"net_g_(\d+)\.pth", JAX: r"net_g_(\d+)"}


def _atomic_save(obj: Any, path: str) -> str:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def _host(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def _onto(device: torch.device):
    """``torch.load``'s map_location for this rank: what was saved from any
    card goes to ``device``; what was saved from the host (the parameters,
    the optimizer's step counts) stays there."""
    if device.type != "cuda":
        return "cpu"
    return {f"cuda:{i}": str(device) for i in range(torch.cuda.device_count())}


def ckpt_path(root: str, step: int) -> str:
    return osp.join(root, f"ckpt_{step}.pth")


def save_checkpoint(root: str, step: int, state, epoch: int = 0,
                    loop: dict | None = None) -> str:
    """The full training state; ``loop`` holds the loop's position (epoch
    batch, host generator states) for an exact resume. Written by rank 0;
    every rank returns once it is on disk."""
    path = ckpt_path(root, step)
    if is_master():
        payload = {
            "params": _host(state.model.state_dict()),
            "opt_state": state.optimizer.state_dict(),
            "step": int(state.step),
            "epoch": int(epoch),
            "loop": loop or {},
        }
        if state.ema is not None:
            payload["params_ema"] = _host(state.ema.state_dict())
        _atomic_save(payload, path)
    barrier()
    return path


def restore_checkpoint(root: str, step: int, state, form: str = PTH, spec=None):
    """Load the training state of iteration ``step`` under ``root`` into the
    live ``state`` (in place); returns (state, epoch, loop). ``form`` 'pth'
    is the port's ``ckpt_{step}.pth``; 'jax' the JAX package's
    ``ckpt_{step}/``, checked against ``spec`` (the config's
    ``OptimizerSpec``), whose loop position is empty: the JAX loop keeps
    none."""
    if form == JAX:
        state, epoch = load_jax_state(osp.join(root, f"ckpt_{step}"), state, spec)
        return state, epoch, {}
    payload = torch.load(ckpt_path(root, step), weights_only=True,
                         map_location=_onto(next(state.model.parameters()).device))
    state.model.load_state_dict(payload["params"], strict=True)
    state.optimizer.load_state_dict(payload["opt_state"])
    if state.ema is not None:
        state.ema.load_state_dict(payload["params_ema"], strict=True)
    state.step = int(payload["step"])
    return state, int(payload.get("epoch", 0)), payload.get("loop", {})


def save_weights(root: str, step: int | str, model: nn.Module,
                 ema: nn.Module | None = None) -> str:
    """``net_g_{step}.pth`` in the reference layout; ``step`` may be a
    label such as 'best'. Written by rank 0; every rank returns once it is
    on disk."""
    path = osp.join(root, f"net_g_{step}.pth")
    if is_master():
        payload = {"params": _host(model.state_dict())}
        if ema is not None:
            payload["params_ema"] = _host(ema.state_dict())
        _atomic_save(payload, path)
    barrier()
    return path


def _numbered(root: str | None, forms: dict[str, str]):
    """(entries, odd): the (iteration, form, name) of each numbered entry of
    ``root``, a file of the '.pth' pattern or an orbax directory of the
    other, in resume order (the highest iteration last; on a tie the .pth
    after the JAX directory); and the paths named as JAX checkpoints that
    are no orbax directory (no ``_METADATA``)."""
    if not root or not osp.isdir(root):
        return [], []
    out, odd = [], []
    for name in os.listdir(root):
        for form, pat in forms.items():
            m = re.fullmatch(pat, name)
            if m is None:
                continue
            path = osp.join(root, name)
            if form == JAX and not (osp.isdir(path) and is_checkpoint(path)):
                odd.append(path)
            else:
                out.append((int(m.group(1)), form, name))
    return sorted(out, key=lambda e: (e[0], e[1] == PTH)), odd


def latest_checkpoint(root: str) -> tuple[int, str] | None:
    """(iteration, form) of the training state to resume under ``root``:
    the highest iteration, the port's '.pth' on a tie (module docstring).
    A ``ckpt_{iter}`` that is no orbax directory raises: skipping it could
    start the run over."""
    found, odd = _numbered(root, _FORMS)
    if odd:
        raise ValueError(f"{sorted(odd)}: named as JAX training states but no orbax "
                         "directory (no _METADATA); move them away to resume")
    return found[-1][:2] if found else None


def find_latest_checkpoint(root: str) -> int | None:
    """The highest iteration of a training state of either form under
    ``root``."""
    latest = latest_checkpoint(root)
    return None if latest is None else latest[0]


def prune_checkpoints(states_dir: str | None, models_dir: str | None,
                      keep: int) -> list[str]:
    """Keep the ``keep`` newest training states (``ckpt_{iter}.pth`` and the
    JAX form's ``ckpt_{iter}/``, counted together, ordered as
    ``latest_checkpoint`` orders them) and numbered weights (``net_g_{iter}
    .pth`` and ``net_g_{iter}/``), delete the rest, a directory with
    ``shutil.rmtree`` as the JAX package's rotation does; named weights
    (net_g_best) are never touched. Opt-in through
    ``logger.keep_checkpoints`` (the reference keeps every checkpoint)."""
    removed: list[str] = []
    if keep <= 0:
        return removed
    for root, forms in ((states_dir, _FORMS), (models_dir, _WEIGHT_FORMS)):
        for _, form, name in _numbered(root, forms)[0][:-keep]:
            path = osp.join(root, name)
            if form == JAX:
                shutil.rmtree(path)
            else:
                os.remove(path)
            removed.append(path)
    return removed


def merge_params_nonstrict(target: dict, source: dict, verbose: bool = True,
                           min_matched: int = 0) -> dict:
    """Copy the entries of ``source`` whose name and shape match
    ``target``; keep (and report) the rest of ``target``. Fewer than
    ``min_matched`` matches raises: a wrong param_key or layout would
    otherwise "fine-tune" from random weights."""
    merged, skipped = {}, []
    for key, dval in target.items():
        sval = source.get(key)
        if sval is not None and tuple(sval.shape) == tuple(dval.shape):
            merged[key] = sval.to(dval.dtype)
        else:
            skipped.append(key)
            merged[key] = dval
    n_matched = len(target) - len(skipped)
    if n_matched < min_matched:
        raise ValueError(
            f"pretrain merge matched only {n_matched} of {len(target)} "
            f"entries (need >= {min_matched}): wrong param_key or "
            "checkpoint layout (strict_load_g: false skips mismatches, "
            "not everything)")
    if verbose and skipped:
        print(f"[load] kept {len(skipped)} target entries not found/matched "
              f"in source (first few: {skipped[:5]})")
    return merged


def load_pretrained(model: nn.Module, path: str, param_key: str = "params",
                    strict: bool = True) -> nn.Module:
    """Load a reference-layout ``.pth`` or an orbax checkpoint directory
    (``path.pretrain_network_g``, ``train.distill.teacher_weights``) into
    ``model``: strictly, or merged non-strictly (matching at least a tenth
    of the entries). A payload holding only the other of 'params' /
    'params_ema' is used with a note (JAX ``train/loop.py:83-90``)."""
    if osp.isdir(path):
        keys = payload_keys(path)
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        keys = list(obj) if isinstance(obj, dict) else []
    if param_key not in keys and len(keys) == 1 \
            and keys[0] in ("params", "params_ema"):
        print(f"[load] pretrain payload has only {keys[0]!r} (asked for "
              f"{param_key!r}); using it")
        param_key = keys[0]
    sd = read_state_dict(path, arch_of(model), param_key)
    if strict:
        model.load_state_dict(sd, strict=True)
        return model
    target = model.state_dict()
    model.load_state_dict(merge_params_nonstrict(
        target, sd, min_matched=max(1, len(target) // 10)), strict=True)
    return model
