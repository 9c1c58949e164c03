"""Teacher -> student distillation (the JAX package's ``train/distill.py``).

The reference distils offline: the teacher denoises the noisy-frame corpus
first, and the student's config points ``dataroot_gt`` at the teacher's
output folder (KDLAES.yml:16) while ``dataroot_lq`` stays at the noisy
originals. Two entry points:

  * ``generate_teacher_targets``: that offline corpus pass through a
    ``TeacherPredictor`` (fan-beam zero mask included), writing a drop-in
    ``dataroot_gt``;
  * ``make_online_target_fn``: the in-loop variant (``train.distill.online``):
    a frozen teacher turns a (B, F, H, W) grayscale stack into same-shape
    targets on the device. Gray frames go in as RGB and come back as the
    mean of the clamped RGB output. With several ranks each runs the
    teacher on its own rows, on its own card; the loss then gathers the
    targets with the predictions.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from ..eval.infer import TeacherPredictor, highest_precision
from ..utils.image_io import imread_rgb, imwrite, list_images


def generate_teacher_targets(predictor: TeacherPredictor, lq_dir: str,
                             out_dir: str, denoise_rate: float = 1.0,
                             zero_mask: bool = True,
                             log: Callable[[str], None] = print) -> int:
    """Denoise every image of ``lq_dir`` into ``out_dir`` under the same
    basenames; returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    paths = list_images(lq_dir)
    for k, path in enumerate(paths):
        out = predictor(imread_rgb(path), denoise_rate, zero_mask=zero_mask)
        imwrite(os.path.join(out_dir, os.path.basename(path)), out["hq"])
        if (k + 1) % 50 == 0:
            log(f"[distill] {k + 1}/{len(paths)}")
    log(f"[distill] wrote {len(paths)} teacher targets to {out_dir}")
    return len(paths)


def make_online_target_fn(teacher: torch.nn.Module, denoise_rate: float = 1.0,
                          dtype: torch.dtype = torch.bfloat16) -> Callable:
    """(B, F, H, W) gray stack -> float32 targets of the same shape, from
    the frozen ``teacher`` on the stack's device (H and W multiples of 8).
    The frames are cast to ``dtype`` at the input, as in the JAX package;
    each layer then computes in the promoted dtype of its input and
    weights (float32 weights: float32, with TF32 off). Only ``hq`` is a
    target, so a teacher's 2x head is not run."""
    teacher = teacher.eval().requires_grad_(False)
    if getattr(teacher, "static", None) == "train":
        teacher.static = "test"

    def target_fn(lq_stack: torch.Tensor) -> torch.Tensor:
        b, f, h, w = lq_stack.shape
        with torch.no_grad(), highest_precision():
            frames = lq_stack.reshape(b * f, 1, h, w).to(dtype)
            rate = torch.full((b * f, 1, h, w), denoise_rate, dtype=dtype,
                              device=lq_stack.device)
            out = teacher({"img": frames.repeat(1, 3, 1, 1), "denoise_rate": rate})
            hq = out["hq"].clamp(0.0, 1.0)
            return hq.float().mean(dim=1).reshape(b, f, h, w)

    return target_fn
