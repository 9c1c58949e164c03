"""KDLAE-S: the seeded weights both sides get, the program's model built
from them, and the model FLOPs counted on the reference."""

from __future__ import annotations

import math

import torch

from ..core import seeds
from ..core.loop import port
from ..core.work import count_flops
from ..reference import student as ref
from ..reference import train as ref_train


def init_params(net: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """LeCun-normal convolutions (fan-in: input channels times the kernel's
    volume) and zero biases, float32, drawn on ``device`` in one call."""
    shapes = ref.param_shapes(net)
    gen = seeds.generator(device, seed, seeds.WEIGHTS)
    weights = [n for n, s in shapes.items() if len(s) == 5]
    z = torch.randn(sum(math.prod(shapes[n]) for n in weights), generator=gen, device=device)
    out, zo = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        if name in weights:
            out[name] = (z[zo:zo + k] * ref.fan_in(name, shape) ** -0.5).reshape(shape)
            zo += k
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def program_model(net: dict, params: dict[str, torch.Tensor]):
    with torch.device("meta"):
        model = port("models").build_network({"type": "KDLAE_student", **net})
    model.load_state_dict(params, strict=True, assign=True)
    return model


def _meta_params(net):
    return {k: torch.empty(s, device="meta") for k, s in ref.param_shapes(net).items()}


def flops_per_stack(net: dict, frames: int, h: int, w: int) -> float:
    """Forward FLOPs of one (frames, h, w) stack."""
    p = _meta_params(net)
    x = torch.empty((1, frames, h, w), device="meta")
    return count_flops(lambda: ref.forward(p, net, x))


def flops_per_step(net: dict, batch: int, frames: int, g: int, opt: dict) -> float:
    """Forward and backward FLOPs of one training step on (batch, frames,
    g, g)."""
    p = {k: v.requires_grad_(True) for k, v in _meta_params(net).items()}
    x = torch.empty((batch, frames, g, g), device="meta")
    y = torch.empty((batch, frames, g, g), device="meta")

    def step():
        loss = ref_train.video_l1(ref.forward(p, net, x), y, opt["l1loss_weight"],
                                  opt["temporal_weight"])
        torch.autograd.grad(loss, list(p.values()))

    return count_flops(step)
