"""Teacher model registry (the reference's ``define_network`` string
registry, Train/basicsr/models/archs/__init__.py:43-46, for the teacher
entries)."""

from __future__ import annotations

from .kdlae_teacher import (
    KDLAETeacher,
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
}

REGISTRY = {
    "KDLAE_teacher": (KDLAETeacher, _KEYMAP_TEACHER),
    "RestormerSuperResolutionParam2": (RestormerSuperResolutionParam2,
                                       _KEYMAP_TEACHER),
}


def build_network(cfg: dict) -> KDLAETeacher:
    """Instantiate a teacher from a reference-style ``network_g`` dict."""
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


__all__ = ["KDLAETeacher", "RestormerSuperResolutionParam2",
           "TransformerStage", "REGISTRY", "build_network",
           "flagship_teacher", "init_weights_"]
