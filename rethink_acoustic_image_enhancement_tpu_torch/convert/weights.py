"""Weight bridge into the port's teacher.

``teacher_state_dict`` maps a flax teacher parameter tree (nested dicts of
numpy arrays) onto the port's ``state_dict`` names and NCHW layouts:
  HWIO (kh, kw, I, O) conv kernels -> Conv2d (O, I, kh, kw)
  ``normN/weight``     -> ``normN.body.weight`` (LayerNorm wraps a body)
  ``down*/up*`` conv   -> ``body.0.weight`` (conv inside nn.Sequential)
bf16 arrays are upcast to float32. ``load_pth`` reads a reference-layout
checkpoint ``{'params': state_dict[, 'params_ema']}`` ('params').
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _float32(a: np.ndarray) -> np.ndarray:
    # a writable float32 copy (bf16 arrays upcast; read-only buffers from
    # a checkpoint stay untouched)
    return np.array(a, dtype=np.float32)


def teacher_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax teacher parameters -> the port's teacher state dict."""
    sd: dict[str, torch.Tensor] = {}
    for key, val in _flatten(params).items():
        parts = key.split(".")
        leaf = parts[-1]
        val = _float32(val)
        if leaf == "kernel" and val.ndim == 4:
            leaf = "weight"
            val = val.transpose(3, 2, 0, 1)
        parts[-1] = leaf
        if len(parts) >= 3 and parts[-2] == "conv" \
                and parts[-3].startswith(("down", "up")):
            parts = parts[:-2] + ["body", "0", leaf]
        elif leaf in ("weight", "bias") and val.ndim == 1 \
                and parts[-2].startswith("norm"):
            parts = parts[:-1] + ["body", leaf]
        sd[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def load_teacher_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load flax teacher parameters into ``model`` (strict)."""
    model.load_state_dict(teacher_state_dict(params), strict=True)
    return model


def load_pth(model: nn.Module, path: str) -> nn.Module:
    """Load the 'params' of a reference-layout ``.pth`` (as
    ``torch_export.save_pth`` writes it) into ``model`` with
    ``strict=True``; values upcast to float32."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["params"]
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in sd.items()}, strict=True)
    return model
