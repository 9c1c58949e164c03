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

With ``bands`` (``train.spatial_shard``: a ``parallel/spatial.py::
RankBands`` on a grid of data indices and bands, ``parallel.init_grid``)
the rows above are a data index's, and the bands of one data index hold the
same rows in the same generator states. The crop, the extra mask and mixup
run on those whole images as above; then the rank takes its band of the
input's rows (each leaf, the teacher's ``img`` and ``denoise_rate`` planes
alike) and runs the network on it by its band rules
(``models/bands.py::network_bands``). Its output's bands are joined into
the whole images (``RankBands.join``, differentiable), so the target stays
whole and the loss is the whole-image loss of the global batch; the
gradients are summed over every rank, bands and data alike, and divided by
their number. The port's leaves, NCHW images or (B, F, H, W) stacks, carry
H at dim -2 either way, where the JAX package's batch carries it at 1
(NHWC) or 2 (stacks): its trainer's ``spatial_axis`` has no counterpart.

With ``shards`` (``train.model_shard``: a ``parallel/tensor.py::
RankShards`` on a grid of data indices and model shards,
``parallel.init_grid``) the rows above are a data index's, and every shard
of one data index holds them whole. ``init_state`` broadcasts rank 0's
whole model and gives each rank its own shard of it
(``models/shards.py::shard_module``: its heads and hidden channels of every
block, every other layer whole), so AdamW's moments and the EMA hold only
the shard's part of a split leaf. The forward runs the network by its
shard rules (``models/shards.py::network_shards``), the partial sums over
the model subgroup. The gradients are reduced by their leaf's kind
(``parallel/collectives.py::reduce_shard_gradients``: whole leaves over the
world, split leaves over the data subgroup, both divided by the world's
size), and the clip's global norm counts every split leaf once
(``sum_over_shards_`` of the split leaves' squares). Loss, ``grad_norm``
and ``lr`` are one process's; the whole leaves end bit-equal on every rank.
``whole_state`` gathers a state into the reference layout (checkpoints),
``whole_modules`` its model and EMA alone (validation), ``load_whole``
splits one again. (The JAX package places every
conv kernel's output channels and every divisible 1-D leaf over ``model``
and lets XLA insert the collectives; the student and the scorer's predictor
stay whole on every shard here.)

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
from ..models.bands import network_bands
from ..models.blocks import TransformerBlock
from ..models.kdlae_teacher import TransformerStage
from ..models.shards import (gather_shards, held, network_shards, shard_layout,
                             shard_module, shard_state_dict)
from ..parallel import n_data
from ..parallel.collectives import (broadcast_module, local_rows, reduce_gradients,
                                    reduce_shard_gradients, sum_over_shards_)
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
    GPU, and raises where there is none. ``bands`` (a ``RankBands``) or
    ``shards`` (a ``RankShards``), at most one, run the step on this
    rank's row band or model shard (module docstring); ``model`` stays the
    whole model either way."""

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
    bands: Any = None  # a RankBands: this rank's band of each image
    shards: Any = None  # a RankShards: this rank's model shard

    def __post_init__(self):
        refuse_fused(self.model)
        if self.bands is not None and self.shards is not None:
            raise ValueError("a Trainer takes row bands or model shards, not both")
        self.device = resolve_device(self.device)
        # each state-dict entry of the whole model: split over the shards or whole
        self.layout = (None if self.shards is None
                       else shard_layout(self.model, self.shards.n))

    def init_state(self) -> TrainState:
        model = self.model.to(self.device).float().train()
        broadcast_module(model)
        if self.shards is not None:
            model = shard_module(model, self.shards.index, self.shards.n)
        return self._state(0, model)

    def _state(self, step: int, model: nn.Module, ema: nn.Module | None = None) -> TrainState:
        """A new optimizer on ``model``; the EMA a copy of it unless given."""
        trainable = [p for n, p in model.named_parameters()
                     if self.optimizer.trainable(n)]
        if ema is None and self.ema_decay > 0:
            ema = copy.deepcopy(model).requires_grad_(False)
        return TrainState(step=step, model=model,
                          optimizer=self.optimizer.build(trainable), ema=ema)

    def is_split(self, name: str) -> bool:
        """Whether the parameter ``name`` is split over the model shards."""
        return self.layout is not None and self.layout[name] is not None

    def _norm(self, named_grads) -> torch.Tensor:
        """``global_norm`` of the gradients; on shards the split leaves'
        squares summed over the shards, so each counts once."""
        named_grads = list(named_grads)
        if self.shards is None:
            return global_norm(g for _, g in named_grads)
        sq = sum(g.float().square().sum() for n, g in named_grads if not self.is_split(n))
        if any(r is not None for r in self.layout.values()):  # the same on every rank
            split = sum((g.float().square().sum() for n, g in named_grads if self.is_split(n)),
                        torch.zeros((), device=named_grads[0][1].device))
            sum_over_shards_([split])
            sq = sq + split
        return torch.sqrt(sq)

    def whole_modules(self, state: TrainState) -> tuple[nn.Module, nn.Module | None]:
        """``state``'s model and EMA in the reference layout (validation):
        without shards the state's own; on shards new modules holding the
        split leaves gathered from every shard. A collective over the model
        subgroup: every rank calls it."""
        if self.shards is None:
            return state.model, state.ema

        def gathered(module):
            whole = copy.deepcopy(self.model).to(self.device)
            whole.load_state_dict(gather_shards(module.state_dict(), self.layout,
                                                self.shards.index, sum_over_shards_,
                                                self.device))
            return whole.train(module.training)

        return (gathered(state.model),
                None if state.ema is None else gathered(state.ema).requires_grad_(False))

    def whole_state(self, state: TrainState) -> TrainState:
        """``state`` in the reference layout: without shards ``state``
        itself; on shards a new TrainState whose model, optimizer moments
        and EMA hold the split leaves gathered from every shard. A
        collective over the model subgroup: every rank calls it."""
        if self.shards is None:
            return state
        j = self.shards.index
        out = self._state(state.step, *self.whole_modules(state))
        # AdamW's or Adam's moments, by parameter name
        names = self._trainable_names(state.model)
        opt_sd = state.optimizer.state_dict()
        per = {names[i]: st for i, st in opt_sd["state"].items()}
        whole_names = self._trainable_names(out.model)
        layout = {n: self.layout[n] for n in whole_names}
        moments = {}
        if per:
            keys = [k for k, v in next(iter(per.values())).items()
                    if torch.is_tensor(v) and v.dim() > 0]
            for key in keys:
                moments[key] = gather_shards({n: st[key] for n, st in per.items()}, layout, j,
                                             sum_over_shards_, self.device)
        # the update counts, the same for every parameter (one copy each)
        counts = {k: v for k, v in next(iter(per.values()), {}).items() if k not in moments}
        whole_sd = out.optimizer.state_dict()
        whole_sd["state"] = {i: {**{k: v.clone() if torch.is_tensor(v) else v
                                    for k, v in counts.items()},
                                 **{k: moments[k][n] for k in moments}}
                             for i, n in enumerate(whole_names) if per}
        whole_sd["param_groups"] = [{**g, "params": w["params"]} for g, w in zip(
            opt_sd["param_groups"], whole_sd["param_groups"], strict=True)]
        out.optimizer.load_state_dict(whole_sd)
        return out

    def load_whole(self, state: TrainState, whole: TrainState) -> TrainState:
        """In place: ``state`` (this rank's) takes ``whole`` (the reference
        layout, as ``whole_state`` or a checkpoint gives it), split by the
        shard rule; without shards ``whole`` is ``state`` already."""
        if self.shards is None:
            return state
        j = self.shards.index
        state.model.load_state_dict(shard_state_dict(whole.model.state_dict(), self.layout, j))
        if state.ema is not None:
            state.ema.load_state_dict(shard_state_dict(whole.ema.state_dict(), self.layout, j))
        whole_names = self._trainable_names(whole.model)
        wsd = whole.optimizer.state_dict()
        per = {whole_names[i]: st for i, st in wsd["state"].items()}
        mine = held({n: self.layout[n] for n in whole_names}, j)
        assert mine == self._trainable_names(state.model), "shard and layout disagree"
        sd = state.optimizer.state_dict()
        sd["state"] = {i: {k: self.layout[n].take(v, j)
                           if self.layout[n] is not None and torch.is_tensor(v) and v.dim() > 0
                           else v for k, v in per[n].items()}
                       for i, n in enumerate(mine) if n in per}
        state.optimizer.load_state_dict(sd)
        state.step = whole.step
        return state

    def _trainable_names(self, model: nn.Module) -> list[str]:
        return [n for n, _ in model.named_parameters() if self.optimizer.trainable(n)]

    def _forward_loss(self, model: nn.Module, lq, gt, rng) -> torch.Tensor:
        if self.bands is not None:
            model = _OnRank(model, network_bands, self.bands)
        if self.shards is not None:
            model = _OnRank(model, network_shards, self.shards)
        if self.compute_dtype is None:
            pred = model(lq)
        else:
            cast = {n: p.to(self.compute_dtype)
                    for n, p in model.named_parameters()}
            lq = tree_map(lambda x: x.to(self.compute_dtype), lq, torch.Tensor)
            pred = torch.func.functional_call(model, cast, (lq,))
            pred = tree_map(lambda x: x.float(), pred, torch.Tensor)
        if self.bands is not None:
            pred = self.bands.join(pred)
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
        are the global batch's. With ``bands``, lq and gt are this data
        index's whole images (module docstring); with ``shards`` too, and
        ``state`` holds this rank's shard (its split leaves, their moments
        and EMA), the metrics one process's."""
        rows = local_rows(leaves(lq)[0].shape[0]) if n_data() > 1 else None
        if self.gt_size and mini_gt_size and mini_gt_size < self.gt_size:
            lq, gt = stage_crop(lq, gt, rng, self.gt_size, mini_gt_size,
                                scale=self.scale)
        lq = stage_extra_mask(lq, rng if gen is None else gen, extra_prob,
                              rows=rows)
        if self.mixup:
            gt, lq = mixing_augment(rng, gt, lq, self.mixup_beta,
                                    self.mixup_identity, rows=rows)
        if self.bands is not None:
            lq = self.bands.take(lq)

        model, opt = state.model, state.optimizer
        named = list(model.named_parameters())
        params = [p for _, p in named]
        model.zero_grad(set_to_none=True)
        with highest_precision():
            loss = self._forward_loss(model, lq, gt, rng)
            loss.backward()
        if self.shards is None:
            reduce_gradients(params)
        else:
            reduce_shard_gradients([p for n, p in named if not self.is_split(n)],
                                   [p for n, p in named if self.is_split(n)])
        grad_norm = self._norm((n, torch.zeros_like(p) if p.grad is None else p.grad)
                               for n, p in named)
        trainable = [p for g in opt.param_groups for p in g["params"]]
        clip = self.optimizer.clip_norm
        if clip is not None:
            tgrads = [p.grad for p in trainable if p.grad is not None]
            norm = (self._norm((n, p.grad) for n, p in named
                               if self.optimizer.trainable(n) and p.grad is not None)
                    if len(tgrads) < len(params) else grad_norm)
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


class _OnRank(nn.Module):
    """``model`` run on this rank's band or model shard by ``network``
    (``network_bands`` or ``network_shards``, over ``split``, a
    ``RankBands`` or ``RankShards``); returns this rank's output as
    ``model`` returns its output (a tensor, or a dict of them with None
    leaves)."""

    def __init__(self, model: nn.Module, network: Callable, split):
        super().__init__()
        self.model, self.network, self.split = model, network, split

    def forward(self, lq):
        out = self.network([self.model], [lq], self.split)
        if isinstance(out, dict):
            return {k: None if v is None else v[0] for k, v in out.items()}
        return out[0]


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
