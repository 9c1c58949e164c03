"""Progressive learning (the KD curriculum of Train/basicsr/train.py:374-448).

The config arrays ``iters / mini_batch_sizes / gt_sizes / probs`` set the
stage: the index of the first cumulative-iters boundary at or past the
current iteration. The loaded full-size batch is subsampled to the stage's
batch on the host, sub-cropped to its patch on the device, and masked
further where the stage's prob exceeds the dataset's base prob.

Each random function keeps its deterministic core apart from its draws:
``crop_at`` crops at given offsets, ``ops/mask.py::mask_with_keep`` masks by
a given ``keep``; the draws come from an explicit numpy generator, and the
extra mask of a device-resident batch from a ``torch.Generator`` on the
device. With several ranks every rank holds the same generators: the crop
offset is one for the whole batch, and the extra mask is drawn over the
global batch, each rank keeping its rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..data.loader import tree_map
from ..ops.mask import input_mask


@dataclass(frozen=True)
class ProgressiveSchedule:
    """The stage lookup (train.py:374-387)."""

    iters: Sequence[int]
    mini_batch_sizes: Sequence[int]
    gt_sizes: Sequence[int]
    probs: Sequence[float] = ()
    gt_size: int = 0  # the dataset-level (largest) patch
    base_prob: float = 0.0

    def __post_init__(self):
        n = len(self.iters)
        assert len(self.mini_batch_sizes) == n and len(self.gt_sizes) == n
        if self.probs:
            assert len(self.probs) == n
        object.__setattr__(self, "_groups", np.cumsum(self.iters))

    def stage(self, current_iter: int) -> int:
        j = np.nonzero(current_iter <= self._groups)[0]
        return int(j[0]) if len(j) else len(self._groups) - 1

    def at(self, current_iter: int) -> tuple[int, int, float]:
        """(mini_batch_size, mini_gt_size, mini_prob) at this iteration."""
        s = self.stage(current_iter)
        prob = self.probs[s] if self.probs else self.base_prob
        return self.mini_batch_sizes[s], self.gt_sizes[s], prob

    @classmethod
    def from_dataset_opt(cls, opt: dict) -> "ProgressiveSchedule | None":
        if "mini_batch_sizes" not in opt:
            return None
        return cls(iters=opt["iters"], mini_batch_sizes=opt["mini_batch_sizes"],
                   gt_sizes=opt["gt_sizes"], probs=opt.get("probs", ()),
                   gt_size=opt["gt_size"], base_prob=opt.get("prob", 0.0))


def subsample_batch(batch, indices: np.ndarray):
    """The rows ``indices`` of every array of a (nested dict) batch, numpy
    or torch (train.py:394-406)."""
    return tree_map(lambda x: x[indices], batch)


def crop_at(x: torch.Tensor | None, y0: int, x0: int, size: int,
            scale: int = 1) -> torch.Tensor | None:
    """The (size*scale)^2 window of NCHW ``x`` at (y0, x0) * scale."""
    if x is None:
        return None
    s = size * scale
    return x[..., y0 * scale:y0 * scale + s, x0 * scale:x0 * scale + s]


def stage_crop(lq, gt, rng: np.random.Generator, gt_size: int,
               mini_gt_size: int, scale: int = 1, sr_scale: int = 2):
    """Sub-crop to the stage's patch (train.py:407-429). lq is NCHW or
    {'img', 'denoise_rate'}; gt is NCHW or {'hq', 'sr'}, 'sr' at
    ``sr_scale`` times the offsets."""
    if mini_gt_size >= gt_size:
        return lq, gt
    # the reference's int((gt_size - mini) * random.random()): [0, d-1]
    d = gt_size - mini_gt_size
    y0, x0 = int(rng.integers(0, d)), int(rng.integers(0, d))
    if isinstance(lq, dict):
        lq = {k: crop_at(v, y0, x0, mini_gt_size) for k, v in lq.items()}
    else:
        lq = crop_at(lq, y0, x0, mini_gt_size)
    if isinstance(gt, dict):
        gt = {"hq": crop_at(gt.get("hq"), y0, x0, mini_gt_size, scale),
              "sr": crop_at(gt.get("sr"), y0, x0, mini_gt_size, sr_scale)}
    else:
        gt = crop_at(gt, y0, x0, mini_gt_size, scale)
    return lq, gt


def stage_extra_mask(lq, rng: np.random.Generator | torch.Generator,
                     extra_prob: float, value: float = 0.1,
                     rows: tuple[int, int] | None = None):
    """Extra Bernoulli masking where the stage's prob exceeds the base prob
    (train.py:431-448), on lq['img'] (or lq) only, every element drawn
    independently: on the host from a numpy generator, or on the device
    from a ``torch.Generator`` there (a device-resident batch's route, which
    uploads nothing); ``extra_prob <= 0`` leaves lq as it is and draws
    nothing. ``rows`` (first, total) places a rank's rows in the global
    batch: the draw is the global batch's, of which the rank keeps its
    rows (``ops/mask.py::input_mask``)."""
    if extra_prob <= 0:
        return lq
    if isinstance(lq, dict):
        return {**lq, "img": input_mask(lq["img"], rng, extra_prob, value, rows)}
    return input_mask(lq, rng, extra_prob, value, rows)
