"""Weight bridge into the port's models.

``teacher_state_dict`` maps a flax teacher (or ``Restormer``) parameter tree
(nested dicts of numpy arrays) onto the port's ``state_dict`` names and NCHW
layouts:
  HWIO (kh, kw, I, O) conv kernels -> Conv2d (O, I, kh, kw)
  ``normN/weight``     -> ``normN.body.weight`` (LayerNorm wraps a body)
  ``down*/up*`` conv   -> ``body.0.weight`` (conv inside nn.Sequential)
``student_state_dict`` and ``asdqe_state_dict`` do the same for KDLAE-S and
the ASDQE scorer (the port's own copy of ``convert/torch_export.py``'s
mapping):
  DHWIO (kd, kh, kw, I, O)  -> Conv3d (O, I, kd, kh, kw)
  learned shuffle (2, 2, I, O) -> ConvTranspose3d (I, O, 1, 2, 2)
  Dense (I, O)              -> Linear (O, I)
  BatchNorm scale / bias + batch_stats mean / var -> weight / bias /
  running_mean / running_var (and num_batches_tracked = 0)
bf16 arrays are upcast to float32. The same mapping serves one flax
``TransformerBlock`` or ``GDFN`` tree (``block_state_dict``), and
``block_kernel_args`` / ``gdfn_kernel_args`` turn such a tree into the
arguments of ``ops/block.py::fused_transformer_block`` and
``ops/gdfn.py::fused_ln_gdfn`` (flax layouts, LayerNorm biases included).
``load_pth`` reads a reference-layout checkpoint ``{'params': state_dict[,
'params_ema']}`` (or a bare state dict) of any of the three families, the
ASDQE scorer's running statistics included.
``module_state_dict`` maps the plain flax trees of ``models/arch_utils.py``
and ``models/embeds.py`` (convs, BatchNorm with its batch statistics, the
per-frame position maps HWC -> CHW).
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


def module_state_dict(params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any] | None = None
                      ) -> dict[str, torch.Tensor]:
    """A flax tree of plain convs and BatchNorms (``ResidualBlockNoBN``,
    ``make_layer``, ``OverlapPatchTimePoseEmbed``, ``BasicSpy``,
    ``WDSpybottle``) -> the port's state dict: 4-D ``kernel`` -> ``weight``
    (O, I, kh, kw), BatchNorm ``scale`` -> ``weight``, ``pos_embed_<i>``
    (h, w, E) -> (E, h, w), and each BatchNorm's ``mean`` / ``var`` ->
    ``running_mean`` / ``running_var`` (with ``num_batches_tracked`` 0)."""
    sd: dict[str, torch.Tensor] = {}
    for key, val in flatten(params).items():
        parts = key.split(".")
        val = _float32(val)
        if parts[-1] == "kernel" and val.ndim == 4:
            parts[-1], val = "weight", val.transpose(3, 2, 0, 1)
        elif parts[-1] == "scale":
            parts[-1] = "weight"
        elif parts[-1].startswith("pos_embed_"):
            val = val.transpose(2, 0, 1)
        sd[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(val))
    for key, val in flatten(batch_stats or {}).items():
        parts = key.split(".")
        parts[-1] = {"mean": "running_mean", "var": "running_var"}[parts[-1]]
        sd[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(_float32(val)))
        sd[".".join(parts[:-1] + ["num_batches_tracked"])] = torch.tensor(0)
    return sd


def load_teacher_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load flax teacher parameters into ``model`` (strict)."""
    model.load_state_dict(teacher_state_dict(params), strict=True)
    return model


# ---------------------------------------------------------------- student --

_SEQ = {"conv1": "0", "conv2": "2"}  # ConvBlock3d's convs in its Sequential


def student_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax KDLAEStudent parameters -> the port's KDLAEStudent state dict."""
    sd: dict[str, torch.Tensor] = {}
    for key, val in flatten(params).items():
        parts = key.split(".")
        mod, leaf = parts[0], parts[-1]
        if mod.startswith(("encoders_", "decoders_")):
            base, idx = mod.rsplit("_", 1)
            path = [base, idx, _SEQ[parts[1]], leaf]
        elif mod == "st_fusion":
            path = ["st_fusion", _SEQ[parts[1]], leaf]
        elif mod.startswith("upconv_"):
            path = ["upconv_layers", mod.rsplit("_", 1)[1], leaf]
        elif mod == "out_conv":
            path = ["out_conv", leaf]
        else:
            raise KeyError(f"unrecognized student param: {key}")
        val = _float32(val)
        if leaf == "kernel":
            path[-1] = "weight"
            if mod.startswith("upconv_"):
                val = val.transpose(2, 3, 0, 1)[:, :, None]
            else:
                val = val.transpose(4, 3, 0, 1, 2)
        sd[".".join(path)] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


# ------------------------------------------------------------------ asdqe --

_DOUBLE_CONV = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}


def _double_conv(sd: dict, prefix: str, p: Mapping[str, Any],
                 stats: Mapping[str, Any] | None) -> None:
    for name, idx in _DOUBLE_CONV.items():
        node = p[name]
        if name.startswith("conv"):
            sd[f"{prefix}.{idx}.weight"] = _tensor(node["kernel"]).permute(3, 2, 0, 1)
            sd[f"{prefix}.{idx}.bias"] = _tensor(node["bias"])
        else:
            st = (stats or {})[name]
            sd[f"{prefix}.{idx}.weight"] = _tensor(node["scale"])
            sd[f"{prefix}.{idx}.bias"] = _tensor(node["bias"])
            sd[f"{prefix}.{idx}.running_mean"] = _tensor(st["mean"])
            sd[f"{prefix}.{idx}.running_var"] = _tensor(st["var"])
            sd[f"{prefix}.{idx}.num_batches_tracked"] = torch.tensor(0)


def asdqe_state_dict(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax DenoiseRatePredictor parameters and batch statistics -> the
    port's DenoiseRatePredictor state dict."""
    sd: dict[str, torch.Tensor] = {}
    fc = {"fc1": "2", "fc2": "5", "fc3": "8"}
    for mod, node in params.items():
        if mod in ("lq_extractor", "gt_extractor", "diff_extractor"):
            _double_conv(sd, f"{mod}.double_conv", node, batch_stats[mod])
        elif mod == "unet":
            ubs = batch_stats["unet"]
            for sub, snode in node.items():
                if sub == "inc":
                    _double_conv(sd, "unet.inc.double_conv", snode, ubs["inc"])
                elif sub.startswith("down"):
                    _double_conv(sd, f"unet.{sub}.maxpool_conv.1.double_conv",
                                 snode["conv"], ubs[sub]["conv"])
                elif sub.startswith("up"):
                    _double_conv(sd, f"unet.{sub}.conv.double_conv",
                                 snode["conv"], ubs[sub]["conv"])
                elif sub == "outc":
                    sd["unet.outc.conv.weight"] = _tensor(
                        snode["kernel"]).permute(3, 2, 0, 1)
                    sd["unet.outc.conv.bias"] = _tensor(snode["bias"])
                else:
                    raise KeyError(f"unrecognized ASDQE unet module: {sub}")
        elif mod in fc:
            sd[f"regressor.{fc[mod]}.weight"] = _tensor(node["kernel"]).T
            sd[f"regressor.{fc[mod]}.bias"] = _tensor(node["bias"])
        else:
            raise KeyError(f"unrecognized ASDQE module: {mod}")
    return {k: v.contiguous() for k, v in sd.items()}


def load_student_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load flax KDLAEStudent parameters into ``model`` (strict)."""
    model.load_state_dict(student_state_dict(params), strict=True)
    return model


def load_asdqe_params(model: nn.Module, params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any]) -> nn.Module:
    """Load flax DenoiseRatePredictor parameters and batch statistics into
    ``model`` (strict)."""
    model.load_state_dict(asdqe_state_dict(params, batch_stats), strict=True)
    return model


def read_pth(path: str, param_key: str | None = "params") -> dict[str, torch.Tensor]:
    """The state dict of a reference-layout ``.pth``: ``obj[param_key]``
    ('params' or 'params_ema') where the file holds that key, the whole
    object for ``param_key=None`` (a bare state dict); a DDP ``module.``
    prefix is stripped (the JAX package's ``torch_import.py:30-47``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if param_key is not None and isinstance(obj, dict) and param_key in obj:
        obj = obj[param_key]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in obj.items()}


def load_pth(model: nn.Module, path: str,
             param_key: str | None = "params") -> nn.Module:
    """Load a reference-layout ``.pth`` (as ``read_pth`` reads it) into
    ``model`` with ``strict=True``; values take the model's dtype (float32
    for a fresh model, so a bfloat16 checkpoint is upcast)."""
    model.load_state_dict(read_pth(path, param_key), strict=True)
    return model
