"""KDLAE-T: the seeded weights both sides get, the program's model built
from them, the model FLOPs counted on the reference, and the spans the
traced window puts around each Transformer stage call."""

from __future__ import annotations

import math
import threading

import torch

from ..core import seeds
from ..core.loop import port
from ..core.work import count_flops
from ..reference import teacher as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BRANCH_SCALE = 0.1  # residual branches' output convs and the hq heads
SR_SCALE = 0.5  # the 2x head's output conv


def init_params(net: dict, seed: int, device, dtype: str) -> dict[str, torch.Tensor]:
    """The conditioned random init: LeCun-normal convolutions, the residual
    branches' output convolutions and the hq heads scaled by 0.1 and the SR
    head's by 0.5, unit LayerNorm weights, zero LayerNorm biases,
    temperatures uniform in [0.5, 1.5); so a random 40-block network's
    outputs stay near its input and mostly in [0, 1], as a trained one's
    do. Drawn on ``device`` in two calls, then cast to ``dtype``."""
    shapes = ref.param_shapes(net)
    gen = seeds.generator(device, seed, seeds.WEIGHTS)
    convs = [n for n, s in shapes.items() if len(s) == 4]
    temps = [n for n in shapes if n.endswith("temperature")]
    z = torch.randn(sum(math.prod(shapes[n]) for n in convs), generator=gen, device=device)
    u = torch.rand(sum(math.prod(shapes[n]) for n in temps), generator=gen, device=device)
    out, zo, uo = {}, 0, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        if name in temps:
            out[name] = (0.5 + u[uo:uo + k]).reshape(shape)
            uo += k
        elif len(shape) == 4:
            scale = ref.fan_in(shape) ** -0.5
            top = name.split(".")[0]
            if name.endswith(("attn.project_out.weight", "ffn.project_out.weight")) \
                    or top in ("output", "output2"):
                scale *= BRANCH_SCALE
            elif top == "outputen":
                scale *= SR_SCALE
            out[name] = (z[zo:zo + k] * scale).reshape(shape)
            zo += k
        elif name.endswith("body.weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return {k: v.to(DTYPES[dtype]) for k, v in out.items()}


def program_model(net: dict, params: dict[str, torch.Tensor]):
    """The program's KDLAE-T holding ``params`` (no copy: built on the meta
    device, the tensors assigned)."""
    with torch.device("meta"):
        model = port("models").build_network({"type": "KDLAE_teacher", **net})
    model.load_state_dict(params, strict=True, assign=True)
    return model


def flops_per_frame(net: dict, h: int, w: int) -> float:
    """Convolution and matrix-product FLOPs of one (h, w) frame through the
    reference (h, w padded to the model's multiple of 8 by the caller)."""
    p = {k: torch.empty(s, device="meta") for k, s in ref.param_shapes(net).items()}
    img = torch.empty((1, net["inp_channels"], h, w), device="meta")
    rate = torch.empty((1, 1, h, w), device="meta")
    return count_flops(lambda: ref.forward(p, net, img, rate))


def stage_spans(model) -> list:
    """Hooks that open a profiler range named
    ``stage|b|h|w|c|heads|blocks|hidden|element bytes`` around every
    TransformerStage call of ``model``; returns their handles."""
    stages = [m for m in model.modules() if type(m).__name__ == "TransformerStage"]
    local = threading.local()

    def pre(mod, args):
        x = args[0]
        b, c, h, w = x.shape
        f = int(mod.dim * mod.ffn_expansion_factor)
        name = f"stage|{b}|{h}|{w}|{c}|{mod.num_heads}|{len(mod)}|{f}|{x.element_size()}"
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        local.__dict__.setdefault("open", []).append(rf)

    def post(mod, args, out):
        local.open.pop().__exit__(None, None, None)

    handles = []
    for m in stages:
        handles.append(m.register_forward_pre_hook(pre))
        handles.append(m.register_forward_hook(post))
    return handles
