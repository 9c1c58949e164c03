"""The training step (the reference's Train/basicsr/train.py,
models/base_model.py and models/image_restoration_model.py; the JAX
package's ``train/trainer.py`` without a mesh).

One ``Trainer.step``:
  * sub-crop to the stage's patch, extra masking, mixup (their draws from
    an explicit numpy generator, the same on every device; a device-resident
    batch's extra mask from a ``torch.Generator`` on the device);
  * forward and loss in float32 with TF32 off (``highest_precision``), or
    with ``compute_dtype`` bfloat16: bfloat16 copies of the float32 master
    parameters through ``torch.func.functional_call``, so the gradients
    come back to the float32 parameters;
  * the optax chain ``clip_by_global_norm(0.01)`` (the reference's
    hard-coded, load-bearing clip, image_restoration_model.py:217-218)
    then AdamW or Adam at ``schedule(step)``, the update count starting at
    0. The clip scales by ``max_norm / norm`` only when ``norm >= max_norm``,
    with no epsilon, as optax does (``clip_grad_norm_`` adds 1e-6);
  * ``freeze`` / ``freeze_except``: frozen parameters get no update and no
    decay; the clip norm is over the trainable gradients and the logged
    ``grad_norm`` over all of them, before clipping;
  * the EMA copy (base_model.py:54-62): ``ema * d + params * (1 - d)``.

In a process group of N ranks (``parallel/``) each rank holds its rows of
the global batch and the step is the one-process step on the concatenated
batch, as the JAX package's step is one program over it: the crop offset
is one for all ranks (every rank holds the same generators), the extra mask
and mixup draw over the global batch (``progressive.py``, ``mixup.py``),
the loss is taken over the gathered global batch (``losses/__init__.py``),
and the gradients are summed over the ranks and divided by N
(``parallel/collectives.py::reduce_gradients``) before the norm, the clip,
AdamW and the EMA, which are then the same on every rank. ``init_state``
broadcasts rank 0's model. The reduction follows the backward; it does not
overlap it.

A stage or block with ``fused=True`` is refused: on the GPU the stage and
block kernels return tensors with no autograd graph, so the parameters
upstream of them would get no gradient there while the CPU's plain version
gives them one.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..data.loader import leaves, tree_map
from ..eval.infer import highest_precision, resolve_device
from ..models.blocks import TransformerBlock
from ..models.kdlae_teacher import TransformerStage
from ..parallel import world_size
from ..parallel.collectives import broadcast_module, local_rows, reduce_gradients
from .mixup import mixing_augment
from .progressive import stage_crop, stage_extra_mask
from .schedules import Schedule, build_schedule

# the reference clips at 0.01 whenever use_grad_clip
# (image_restoration_model.py:217-218)
REFERENCE_GRAD_CLIP = 0.01


@dataclasses.dataclass
class OptimizerSpec:
    """The optimizer a ``train`` config section asks for."""

    kind: str  # 'AdamW' or 'Adam'
    betas: tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    clip_norm: float | None = REFERENCE_GRAD_CLIP  # None: no clipping
    freeze_except: tuple[str, ...] | None = None
    freeze: tuple[str, ...] = ()

    def trainable(self, name: str) -> bool:
        """The JAX package's mask: top-of-path prefixes of the parameter
        name ('/'-joined there, '.'-joined here)."""
        path = name.replace(".", "/")
        if self.freeze_except is not None:
            return any(path.startswith(p) for p in self.freeze_except)
        return not any(path.startswith(p) for p in self.freeze)

    def build(self, params: list[nn.Parameter]) -> torch.optim.Optimizer:
        """The torch optimizer over ``params``; its rate is set per step."""
        if self.kind == "AdamW":
            return torch.optim.AdamW(params, lr=0.0, betas=self.betas,
                                     eps=1e-8, weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=0.0, betas=self.betas, eps=1e-8)


def build_optimizer(train_opt: dict) -> OptimizerSpec:
    """From a reference-style ``train`` section."""
    optim = dict(train_opt["optim_g"])
    kind = optim.pop("type")
    if kind not in ("AdamW", "Adam"):
        raise KeyError(f"unsupported optimizer {kind!r} (reference supports "
                       "Adam/AdamW, image_restoration_model.py:139-158)")
    fe = train_opt.get("freeze_except")
    return OptimizerSpec(
        kind=kind, betas=tuple(optim.get("betas", (0.9, 0.999))),
        weight_decay=float(optim.get("weight_decay", 0.0)) if kind == "AdamW" else 0.0,
        clip_norm=(float(train_opt.get("grad_clip_norm", REFERENCE_GRAD_CLIP))
                   if train_opt.get("use_grad_clip", True) else None),
        freeze_except=tuple(fe) if fe else None,
        freeze=tuple(train_opt.get("freeze") or ()))


@dataclasses.dataclass
class TrainState:
    """The step count, the model (float32 master parameters), its optimizer
    and the EMA copy (None without ``ema_decay``)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: nn.Module | None = None


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def refuse_fused(model: nn.Module) -> None:
    """Raise if a stage or block of ``model`` would reach a kernel."""
    for name, m in model.named_modules():
        if isinstance(m, (TransformerStage, TransformerBlock)) and m.fused:
            raise ValueError(
                f"{name or 'model'} has fused=True: the stage and block "
                "kernels have no backward pass, so on the GPU the "
                "parameters before them would get no gradient; train with "
                "fused=False (the JAX trainer's default)")


@dataclasses.dataclass
class Trainer:
    """Owns the step and the state's construction. ``device=None`` is the
    GPU, and raises where there is none."""

    model: nn.Module
    loss_fn: Callable  # (pred, gt[, rng=]) -> scalar
    optimizer: OptimizerSpec
    schedule: Schedule
    device: Any = None
    ema_decay: float = 0.0
    mixup: bool = False
    mixup_beta: float = 1.2
    mixup_identity: bool = True
    scale: int = 1  # dataset scale (gt vs lq)
    gt_size: int = 0  # dataset-level patch (0: no progressive crop)
    loss_takes_rng: bool = False
    compute_dtype: torch.dtype | None = None  # e.g. torch.bfloat16

    def __post_init__(self):
        refuse_fused(self.model)
        self.device = resolve_device(self.device)

    def init_state(self) -> TrainState:
        model = self.model.to(self.device).float().train()
        broadcast_module(model)
        trainable = [p for n, p in model.named_parameters()
                     if self.optimizer.trainable(n)]
        ema = None
        if self.ema_decay > 0:
            ema = copy.deepcopy(model).requires_grad_(False)
        return TrainState(step=0, model=model,
                          optimizer=self.optimizer.build(trainable), ema=ema)

    def _forward_loss(self, model: nn.Module, lq, gt, rng) -> torch.Tensor:
        if self.compute_dtype is None:
            pred = model(lq)
        else:
            cast = {n: p.to(self.compute_dtype)
                    for n, p in model.named_parameters()}
            lq = tree_map(lambda x: x.to(self.compute_dtype), lq, torch.Tensor)
            pred = torch.func.functional_call(model, cast, (lq,))
            pred = tree_map(lambda x: x.float(), pred, torch.Tensor)
        if self.loss_takes_rng:
            return self.loss_fn(pred, gt, rng=rng)
        return self.loss_fn(pred, gt)

    def step(self, state: TrainState, lq, gt, rng: np.random.Generator,
             extra_prob: float = 0.0, mini_gt_size: int = 0,
             gen: torch.Generator | None = None):
        """One iteration on NCHW tensors (or dicts of them) on the device,
        their batch already the stage's. Updates ``state`` in place and
        returns (state, metrics): 'l_pix' and 'grad_norm' as 0-d tensors
        on the device (no host sync), 'lr' as a float. ``gen``, a generator
        on the device, draws the extra mask there (a device-resident
        batch's route); the other draws come from ``rng``. With several
        ranks, lq and gt are this rank's rows, as many on every rank, and
        ``rng`` and ``gen`` are in the same state on every rank; the metrics
        are the global batch's."""
        rows = local_rows(leaves(lq)[0].shape[0]) if world_size() > 1 else None
        if self.gt_size and mini_gt_size and mini_gt_size < self.gt_size:
            lq, gt = stage_crop(lq, gt, rng, self.gt_size, mini_gt_size,
                                scale=self.scale)
        lq = stage_extra_mask(lq, rng if gen is None else gen, extra_prob,
                              rows=rows)
        if self.mixup:
            gt, lq = mixing_augment(rng, gt, lq, self.mixup_beta,
                                    self.mixup_identity, rows=rows)

        model, opt = state.model, state.optimizer
        params = list(model.parameters())
        model.zero_grad(set_to_none=True)
        with highest_precision():
            loss = self._forward_loss(model, lq, gt, rng)
            loss.backward()
        reduce_gradients(params)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        grad_norm = global_norm(grads)
        trainable = [p for g in opt.param_groups for p in g["params"]]
        clip = self.optimizer.clip_norm
        if clip is not None:
            tgrads = [p.grad for p in trainable if p.grad is not None]
            norm = global_norm(tgrads) if len(tgrads) < len(params) else grad_norm
            # optax: g unchanged below max_norm, else (g / norm) * max_norm
            # (no host sync: both factors are 1 below max_norm)
            below = norm < clip
            one = torch.ones_like(norm)
            torch._foreach_div_(tgrads, torch.where(below, one, norm))
            torch._foreach_mul_(tgrads, torch.where(below, one, one * clip))
        lr = float(self.schedule(state.step))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        if state.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for e, p in zip(state.ema.parameters(), params):
                    e.mul_(d).add_(p, alpha=1 - d)
        state.step += 1
        return state, {"l_pix": loss.detach(), "lr": lr,
                       "grad_norm": grad_norm.detach()}


def build_trainer_from_config(opt: dict, model: nn.Module, loss_fn: Callable,
                              device=None, **overrides) -> Trainer:
    """A Trainer from a reference-style config dict."""
    train_opt = opt["train"]
    ds_opt = opt.get("datasets", {}).get("train", {})
    schedule = build_schedule(train_opt["optim_g"]["lr"], train_opt["scheduler"],
                              train_opt.get("warmup_iter", -1))
    mix = train_opt.get("mixing_augs", {})
    kw = dict(
        model=model, loss_fn=loss_fn, optimizer=build_optimizer(train_opt),
        schedule=schedule, device=device,
        ema_decay=train_opt.get("ema_decay", 0.0),
        mixup=mix.get("mixup", False),
        mixup_beta=mix.get("mixup_beta", 1.2),
        mixup_identity=mix.get("use_identity", False),
        scale=opt.get("scale", 1),
        gt_size=ds_opt.get("gt_size", 0),
        loss_takes_rng=train_opt.get("pixel_opt", {}).get("reduction") == "mix",
        compute_dtype=compute_dtype(train_opt.get("compute_dtype", "float32")),
    )
    kw.update(overrides)
    return Trainer(**kw)


_COMPUTE_DTYPES = {"float32": None, "fp32": None, "bfloat16": torch.bfloat16,
                   "bf16": torch.bfloat16, "float16": torch.float16,
                   "fp16": torch.float16}


def compute_dtype(name) -> torch.dtype | None:
    """``train.compute_dtype`` -> the step's compute dtype (None: float32)."""
    key = str(name).lower()
    if key not in _COMPUTE_DTYPES:
        raise KeyError(f"train.compute_dtype {key!r} not one of "
                       "float32/bfloat16/float16")
    return _COMPUTE_DTYPES[key]
