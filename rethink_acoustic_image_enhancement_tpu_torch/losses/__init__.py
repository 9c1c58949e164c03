"""Loss registry keyed on the reference's config names.

The reference resolves ``pixel_opt.type`` by class name
(Train/basicsr/models/image_restoration_model.py:127-133); here the same
names resolve to functions with the constructor kwargs bound, and unknown
names or kwargs fail when the loss is built, not mid-training.

In a process group of N ranks every loss is taken over the global batch,
as the JAX package's step takes it: the predictions (differentiably) and
the targets are gathered from the ranks' rows
(``parallel/collectives.py::gather_rows``), so weighted means, the Dice
ratio and the 'max' and 'mix' reductions see the batch one process would.
Every rank then holds the same loss; its backward hands each rank N times
the gradient of its own rows, which the step's ``reduce_gradients``
divides out. A single process calls the loss as it is.

On a grid of data indices and bands (``train.spatial_shard``) none of these
losses is a sum over pixels (``psnr_loss`` takes the log of a per-image
mean, ``l2_dice`` a global ratio, the video 'max' reduction a max over
frames of spatial means), so the trainer joins each data index's bands into
whole images first (``RankBands.join``); the gather is then over the data
indices, and each rank's gradient carries n_spatial x n_data times its
share, which ``reduce_gradients`` divides out over the world.
"""

from __future__ import annotations

import inspect
from functools import partial
from typing import Callable

from ..parallel import n_data
from ..parallel.collectives import gather_rows
from .pixel import (
    charbonnier_loss,
    l1_loss,
    l1_loss_channel,
    l1_loss_sonar,
    l1_loss_sr,
    l1_loss_video_frames,
    l1_loss_weight,
    l2_dice,
    mse_loss,
    psnr_loss,
)

# reference class name -> (fn, ctor-kwarg -> fn-kwarg renames)
_REGISTRY: dict[str, tuple[Callable, dict[str, str]]] = {
    "L1Loss": (l1_loss, {}),
    "MSELoss": (mse_loss, {}),
    "PSNRLoss": (psnr_loss, {"toY": "to_y"}),
    "CharbonnierLoss": (charbonnier_loss, {}),
    "L1LossSonar": (l1_loss_sonar, {}),
    "L1LossChannel": (l1_loss_channel, {}),
    "L1LossSr": (l1_loss_sr, {}),
    "L1Lossweight": (l1_loss_weight, {"weight": "w_range"}),
    "L1LossForVideoFrames": (l1_loss_video_frames, {}),
    "L2Dice": (l2_dice, {}),
}


def build_loss(pixel_opt: dict) -> Callable:
    """A loss function from a reference-style ``pixel_opt`` dict."""
    opt = dict(pixel_opt)
    type_name = opt.pop("type")
    if type_name not in _REGISTRY:
        raise KeyError(f"unknown loss {type_name!r}; known: {sorted(_REGISTRY)}")
    fn, renames = _REGISTRY[type_name]
    kwargs = {renames.get(k, k): v for k, v in opt.items()}
    valid = set(inspect.signature(fn).parameters)
    unknown = set(kwargs) - valid
    if unknown and "_" not in valid:
        raise KeyError(f"unknown {type_name} options {sorted(unknown)}")
    return over_global_batch(partial(fn, **kwargs))


def over_global_batch(fn: Callable) -> Callable:
    """``fn`` taken over the global batch where there are several data
    indices (module docstring); ``fn`` itself where there is one."""

    def loss(pred, target, *args, **kwargs):
        if n_data() > 1:
            pred, target = gather_rows(pred, differentiable=True), gather_rows(target)
        return fn(pred, target, *args, **kwargs)

    return loss


__all__ = ["build_loss", "charbonnier_loss", "l1_loss", "l1_loss_channel",
           "l1_loss_sonar", "l1_loss_sr", "l1_loss_video_frames",
           "l1_loss_weight", "l2_dice", "mse_loss", "psnr_loss"]
