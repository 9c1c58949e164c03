"""Model registry (the reference's ``define_network`` string registry,
Train/basicsr/models/archs/__init__.py:43-46): the teacher, the vanilla
Restormer, the KDLAE-S student and the ASDQE scorer."""

from __future__ import annotations

from .asdqe import DenoiseRatePredictor
from .kdlae_student import KDLAEStudent
from .kdlae_teacher import (
    KDLAETeacher,
    Restormer,
    RestormerSuperResolutionParam2,
    TransformerStage,
    init_weights_,
)

# reference ctor kwarg -> KDLAETeacher kwarg
_KEYMAP_TEACHER = {
    "inp_channels": "inp_channels",
    "out_channels": "out_channels",
    "dim": "dim",
    "num_blocks": "num_blocks",
    "num_refinement_blocks": "num_refinement_blocks",
    "heads": "heads",
    "ffn_expansion_factor": "ffn_expansion_factor",
    "bias": "use_bias",
    "LayerNorm_type": "layernorm_type",
    "dual_pixel_task": "dual_pixel_task",
    "static": "static",
    "params": "params",
    # no reference analog: fold the conv + pixel-(un)shuffle resamplers
    # into single strided / transposed convs (models/blocks.py)
    "fused_resample": "fused_resample",
}

REGISTRY = {
    "KDLAE_teacher": (KDLAETeacher, _KEYMAP_TEACHER),
    "RestormerSuperResolutionParam2": (RestormerSuperResolutionParam2,
                                       _KEYMAP_TEACHER),
    "Restormer": (Restormer, {k: v for k, v in _KEYMAP_TEACHER.items()
                              if k not in ("static", "params")}),
    "KDLAE_student": (KDLAEStudent, {
        "inp_channels": "inp_channels",
        "out_channels": "out_channels",
        "residual": "residual",
        "hidden_channels": "hidden_channels",
        "kernel_size": "kernel_size",
    }),
    "DenoiseRatePredictor": (DenoiseRatePredictor, {
        "in_channels": "in_channels",
        "dim": "dim",
    }),
}


def build_network(cfg: dict):
    """Instantiate a model from a reference-style ``network_g`` dict."""
    cfg = dict(cfg)
    type_name = cfg.pop("type")
    if type_name not in REGISTRY:
        raise KeyError(
            f"unknown network type {type_name!r}; known: {sorted(REGISTRY)}")
    cls, keymap = REGISTRY[type_name]
    kwargs = {}
    for k, v in cfg.items():
        if k not in keymap:
            raise KeyError(f"unknown {type_name} option {k!r}")
        kwargs[keymap[k]] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def flagship_teacher(static: str = "test") -> KDLAETeacher:
    """The notebook-config KDLAE-T (KDLAE_T.ipynb cell 1: dim 48, blocks
    [4,6,6,8], heads [1,2,4,8], ffn 2.66, BiasFree, params='cat');
    ``static='train'`` adds the 2x SR head."""
    return KDLAETeacher(
        dim=48, num_blocks=(4, 6, 6, 8), num_refinement_blocks=4,
        heads=(1, 2, 4, 8), ffn_expansion_factor=2.66,
        layernorm_type="BiasFree", static=static, params="cat")


__all__ = ["KDLAETeacher", "KDLAEStudent", "DenoiseRatePredictor", "Restormer",
           "RestormerSuperResolutionParam2", "TransformerStage", "REGISTRY",
           "build_network", "flagship_teacher", "init_weights_"]
