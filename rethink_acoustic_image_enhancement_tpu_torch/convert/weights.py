"""Weight bridge into the port's teacher.

``teacher_state_dict`` maps a flax teacher parameter tree (nested dicts of
numpy arrays) onto the port's ``state_dict`` names and NCHW layouts:
  HWIO (kh, kw, I, O) conv kernels -> Conv2d (O, I, kh, kw)
  ``normN/weight``     -> ``normN.body.weight`` (LayerNorm wraps a body)
  ``down*/up*`` conv   -> ``body.0.weight`` (conv inside nn.Sequential)
bf16 arrays are upcast to float32. The same mapping serves one flax
``TransformerBlock`` or ``GDFN`` tree (``block_state_dict``), and
``block_kernel_args`` / ``gdfn_kernel_args`` turn such a tree into the
arguments of ``ops/block.py::fused_transformer_block`` and
``ops/gdfn.py::fused_ln_gdfn`` (flax layouts, LayerNorm biases included).
``load_pth`` reads a reference-layout checkpoint ``{'params': state_dict[,
'params_ema']}`` ('params').
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested parameter dicts -> {'a.b.c': leaf}."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _float32(a: np.ndarray) -> np.ndarray:
    # a writable float32 copy (bf16 arrays upcast; read-only buffers from
    # a checkpoint stay untouched)
    return np.array(a, dtype=np.float32)


def teacher_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax teacher parameters -> the port's teacher state dict."""
    sd: dict[str, torch.Tensor] = {}
    for key, val in flatten(params).items():
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


# one TransformerBlock's or GDFN's tree maps by the same rules
block_state_dict = teacher_state_dict


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(_float32(np.asarray(a)))


def block_kernel_args(params: Mapping[str, Any]) -> tuple:
    """One flax TransformerBlock tree -> (ln1_w, ln1_b, w_qkv, dw_qkv,
    temperature, w_proj, ln2_w, ln2_b, w_in, w_dw, w_out), the biases None
    for a BiasFree LayerNorm."""
    def bias(ln):
        return _tensor(ln["bias"]) if "bias" in ln else None

    attn, ffn = params["attn"], params["ffn"]
    return (_tensor(params["norm1"]["weight"]), bias(params["norm1"]),
            _tensor(attn["qkv"]["kernel"]), _tensor(attn["qkv_dwconv"]["kernel"]),
            _tensor(attn["temperature"]), _tensor(attn["project_out"]["kernel"]),
            _tensor(params["norm2"]["weight"]), bias(params["norm2"]),
            *gdfn_kernel_args(ffn))


def gdfn_kernel_args(params: Mapping[str, Any]) -> tuple:
    """One flax GDFN tree -> (w_in, w_dw, w_out)."""
    return (_tensor(params["project_in"]["kernel"]),
            _tensor(params["dwconv"]["kernel"]),
            _tensor(params["project_out"]["kernel"]))


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
