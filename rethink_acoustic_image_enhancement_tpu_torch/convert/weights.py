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
bf16 arrays are upcast to float32, or kept with ``keep_dtype=True`` (the
reference ``.pth`` that ``raie-torch convert --reverse`` writes). The same mapping serves one flax
``TransformerBlock`` or ``GDFN`` tree (``block_state_dict``), and
``block_kernel_args`` / ``gdfn_kernel_args`` turn such a tree into the
arguments of ``ops/block.py::fused_transformer_block`` and
``ops/gdfn.py::fused_ln_gdfn`` (flax layouts, LayerNorm biases included).
``read_state_dict`` and ``load_checkpoint`` take either a ``.pth`` or an
orbax checkpoint directory (``convert/orbax.py``).
``load_pth`` reads a reference-layout checkpoint ``{'params': state_dict[,
'params_ema']}`` (or a bare state dict) of any of the three families, the
ASDQE scorer's running statistics included.
``teacher_flax_tree``, ``student_flax_tree`` and ``asdqe_flax_tree`` go the
other way, a reference state dict to the flax tree (the JAX package's
``convert/torch_import.py::CONVERTERS``), dtypes kept; ``FLAX_TREES`` and
``reference_state_dict`` name them by architecture.
``module_state_dict`` maps the plain flax trees of ``models/arch_utils.py``
and ``models/embeds.py`` (convs, BatchNorm with its batch statistics, the
per-frame position maps HWC -> CHW).
"""

from __future__ import annotations

from typing import Any, Mapping

import os
import re

import numpy as np
import torch
from torch import nn

from . import orbax
from .orbax import BF16, bf16_to_float32, from_torch, to_torch


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


def _numpy(a) -> np.ndarray:
    return from_torch(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _float32(a) -> np.ndarray:
    # a writable float32 copy (bf16 arrays upcast; read-only buffers from
    # a checkpoint stay untouched)
    a = _numpy(a)
    return bf16_to_float32(a) if a.dtype == BF16 else np.array(a, dtype=np.float32)


def _cast(a, keep_dtype: bool) -> np.ndarray:
    return _numpy(a) if keep_dtype else _float32(a)


def teacher_state_dict(params: Mapping[str, Any],
                       keep_dtype: bool = False) -> dict[str, torch.Tensor]:
    """Flax teacher parameters -> the port's teacher state dict."""
    sd: dict[str, torch.Tensor] = {}
    for key, val in flatten(params).items():
        parts = key.split(".")
        leaf = parts[-1]
        val = _cast(val, keep_dtype)
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
        sd[".".join(parts)] = to_torch(val)
    return sd


# one TransformerBlock's or GDFN's tree maps by the same rules
block_state_dict = teacher_state_dict


def _tensor(a, keep_dtype: bool = False) -> torch.Tensor:
    return to_torch(_cast(a, keep_dtype))


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


def student_state_dict(params: Mapping[str, Any],
                       keep_dtype: bool = False) -> dict[str, torch.Tensor]:
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
        val = _cast(val, keep_dtype)
        if leaf == "kernel":
            path[-1] = "weight"
            if mod.startswith("upconv_"):
                val = val.transpose(2, 3, 0, 1)[:, :, None]
            else:
                val = val.transpose(4, 3, 0, 1, 2)
        sd[".".join(path)] = to_torch(val)
    return sd


# ------------------------------------------------------------------ asdqe --

_DOUBLE_CONV = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}


def _double_conv(sd: dict, prefix: str, p: Mapping[str, Any],
                 stats: Mapping[str, Any] | None, keep: bool = False) -> None:
    for name, idx in _DOUBLE_CONV.items():
        node = p[name]
        if name.startswith("conv"):
            sd[f"{prefix}.{idx}.weight"] = _tensor(_cast(node["kernel"], keep)
                                                   .transpose(3, 2, 0, 1), keep)
            sd[f"{prefix}.{idx}.bias"] = _tensor(node["bias"], keep)
        else:
            st = (stats or {})[name]
            sd[f"{prefix}.{idx}.weight"] = _tensor(node["scale"], keep)
            sd[f"{prefix}.{idx}.bias"] = _tensor(node["bias"], keep)
            sd[f"{prefix}.{idx}.running_mean"] = _tensor(st["mean"], keep)
            sd[f"{prefix}.{idx}.running_var"] = _tensor(st["var"], keep)
            sd[f"{prefix}.{idx}.num_batches_tracked"] = torch.tensor(0)


def asdqe_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                     keep_dtype: bool = False) -> dict[str, torch.Tensor]:
    """Flax DenoiseRatePredictor parameters and batch statistics -> the
    port's DenoiseRatePredictor state dict."""
    keep = keep_dtype
    sd: dict[str, torch.Tensor] = {}
    fc = {"fc1": "2", "fc2": "5", "fc3": "8"}
    for mod, node in params.items():
        if mod in ("lq_extractor", "gt_extractor", "diff_extractor"):
            _double_conv(sd, f"{mod}.double_conv", node, batch_stats[mod], keep)
        elif mod == "unet":
            ubs = batch_stats["unet"]
            for sub, snode in node.items():
                if sub == "inc":
                    _double_conv(sd, "unet.inc.double_conv", snode, ubs["inc"], keep)
                elif sub.startswith("down"):
                    _double_conv(sd, f"unet.{sub}.maxpool_conv.1.double_conv",
                                 snode["conv"], ubs[sub]["conv"], keep)
                elif sub.startswith("up"):
                    _double_conv(sd, f"unet.{sub}.conv.double_conv",
                                 snode["conv"], ubs[sub]["conv"], keep)
                elif sub == "outc":
                    sd["unet.outc.conv.weight"] = _tensor(
                        _cast(snode["kernel"], keep).transpose(3, 2, 0, 1), keep)
                    sd["unet.outc.conv.bias"] = _tensor(snode["bias"], keep)
                else:
                    raise KeyError(f"unrecognized ASDQE unet module: {sub}")
        elif mod in fc:
            sd[f"regressor.{fc[mod]}.weight"] = _tensor(_cast(node["kernel"], keep).T,
                                                        keep)
            sd[f"regressor.{fc[mod]}.bias"] = _tensor(node["bias"], keep)
        else:
            raise KeyError(f"unrecognized ASDQE module: {mod}")
    return sd


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


# ----------------------------------------------- reference -> flax trees --

def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def teacher_flax_tree(sd: Mapping[str, torch.Tensor]) -> dict:
    """A reference teacher (or Restormer) state dict -> the flax tree,
    dtypes kept (JAX ``torch_import.py::convert_teacher``)."""
    params: dict = {}
    for key, val in sd.items():
        key = re.sub(r"\.body\.0\.weight$", ".conv.weight", key)
        key = re.sub(r"\.body\.(weight|bias)$", r".\1", key)
        parts = key.split(".")
        val = _numpy(val)
        if parts[-1] == "weight" and val.ndim == 4:
            parts[-1], val = "kernel", val.transpose(2, 3, 1, 0)
        _set(params, parts, np.ascontiguousarray(val))
    return params


def student_flax_tree(sd: Mapping[str, torch.Tensor]) -> dict:
    """A reference KDLAE_student state dict -> the flax tree
    (``convert_student``)."""
    seq = {v: k for k, v in _SEQ.items()}
    params: dict = {}
    for key, val in sd.items():
        parts = key.split(".")
        if parts[0] in ("encoders", "decoders"):
            path = [f"{parts[0]}_{parts[1]}", seq[parts[2]], parts[3]]
        elif parts[0] == "st_fusion":
            path = ["st_fusion", seq[parts[1]], parts[2]]
        elif parts[0] == "upconv_layers":
            path = [f"upconv_{parts[1]}", parts[2]]
        elif parts[0] == "out_conv":
            path = ["out_conv", parts[1]]
        else:
            raise KeyError(f"unrecognized student key: {key}")
        val = _numpy(val)
        if path[-1] == "weight":
            path[-1] = "kernel"
            if parts[0] == "upconv_layers":  # (I, O, 1, 2, 2) -> (2, 2, I, O)
                val = val[:, :, 0].transpose(2, 3, 0, 1)
            else:
                val = val.transpose(2, 3, 4, 1, 0)
        _set(params, path, np.ascontiguousarray(val))
    return params


def asdqe_flax_tree(sd: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """A reference DenoiseRatePredictor state dict -> (params, batch_stats)
    (``convert_asdqe``; ``num_batches_tracked`` dropped)."""
    params: dict = {}
    stats: dict = {}
    dc = {v: k for k, v in _DOUBLE_CONV.items()}
    fc = {"2": "fc1", "5": "fc2", "8": "fc3"}
    for key, val in sd.items():
        parts = key.split(".")
        val = _numpy(val)
        if parts[0] == "regressor":
            name = fc[parts[1]]
            if parts[2] == "weight":
                val = val.T
            _set(params, [name, "kernel" if parts[2] == "weight" else "bias"],
                 np.ascontiguousarray(val))
            continue
        if parts[0] in ("lq_extractor", "gt_extractor", "diff_extractor"):
            prefix, idx, leaf = [parts[0]], parts[2], parts[3]
        elif parts[0] == "unet" and parts[1] == "outc":
            leaf = parts[3]
            if leaf == "weight":
                val = val.transpose(2, 3, 1, 0)
            _set(params, ["unet", "outc", "kernel" if leaf == "weight" else "bias"],
                 np.ascontiguousarray(val))
            continue
        elif parts[0] == "unet" and parts[1] == "inc":
            prefix, idx, leaf = ["unet", "inc"], parts[3], parts[4]
        elif parts[0] == "unet" and parts[1].startswith("down"):
            prefix, idx, leaf = ["unet", parts[1], "conv"], parts[5], parts[6]
        elif parts[0] == "unet" and parts[1].startswith("up"):
            prefix, idx, leaf = ["unet", parts[1], "conv"], parts[4], parts[5]
        else:
            raise KeyError(f"unrecognized ASDQE key: {key}")
        name = dc[idx]
        if name.startswith("conv"):
            if leaf == "weight":
                leaf, val = "kernel", val.transpose(2, 3, 1, 0)
            _set(params, prefix + [name, leaf], np.ascontiguousarray(val))
        elif leaf in ("weight", "bias"):
            _set(params, prefix + [name, "scale" if leaf == "weight" else "bias"], val)
        elif leaf in ("running_mean", "running_var"):
            _set(stats, prefix + [name, leaf[len("running_"):]], val)
    return params, stats


FLAX_TREES = {
    "KDLAE_teacher": teacher_flax_tree,
    "RestormerSuperResolutionParam2": teacher_flax_tree,
    "Restormer": teacher_flax_tree,
    "KDLAE_student": student_flax_tree,
    "DenoiseRatePredictor": asdqe_flax_tree,
}


def reference_state_dict(params: Mapping[str, Any], arch: str,
                         batch_stats: Mapping[str, Any] | None = None
                         ) -> dict[str, torch.Tensor]:
    """A flax tree of ``arch`` -> the reference state dict, dtypes kept
    (JAX ``torch_export.py::EXPORTERS``)."""
    if arch == "DenoiseRatePredictor":
        return asdqe_state_dict(params, batch_stats or {}, keep_dtype=True)
    if arch == "KDLAE_student":
        return student_state_dict(params, keep_dtype=True)
    if arch not in FLAX_TREES:
        raise KeyError(f"arch {arch!r} not in {sorted(FLAX_TREES)}")
    return teacher_state_dict(params, keep_dtype=True)


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


# the architecture name of each of the port's model classes
_ARCHS = {"KDLAETeacher": "KDLAE_teacher",
          "RestormerSuperResolutionParam2": "RestormerSuperResolutionParam2",
          "Restormer": "Restormer", "KDLAEStudent": "KDLAE_student",
          "DenoiseRatePredictor": "DenoiseRatePredictor"}


def arch_of(model: nn.Module) -> str:
    """The reference architecture name of one of the port's models."""
    for cls in type(model).__mro__:
        if cls.__name__ in _ARCHS:
            return _ARCHS[cls.__name__]
    raise KeyError(f"{type(model).__name__} is none of {sorted(_ARCHS)}")


def read_state_dict(path: str, arch: str,
                    param_key: str | None = "params") -> dict[str, torch.Tensor]:
    """The reference-layout state dict of a ``.pth`` file (``read_pth``) or
    of an orbax checkpoint directory of ``arch``, dtypes kept: its
    ``param_key`` subtree, or the whole payload where it has none (the JAX
    package's ``load_weights``); a scorer's through ``load_asdqe_weights``."""
    if not os.path.isdir(path):
        return read_pth(path, param_key)
    if not orbax.is_checkpoint(path):
        raise orbax.CheckpointError(
            f"{path} is a directory without {orbax.METADATA}: not an orbax "
            "checkpoint (a reference-layout .pth or an orbax directory)")
    if arch == "DenoiseRatePredictor":
        params, stats = orbax.load_asdqe_weights(path)
        return reference_state_dict(params, arch, stats)
    return reference_state_dict(orbax.load_weights(path, param_key), arch)


def load_checkpoint(model: nn.Module, path: str,
                    param_key: str | None = "params") -> nn.Module:
    """Load a ``.pth`` or an orbax checkpoint directory into ``model``
    (strict; values take the model's dtype)."""
    model.load_state_dict(read_state_dict(path, arch_of(model), param_key),
                          strict=True)
    return model
