"""Metric registry: a name here is addressable from YAML ``val.metrics``
(image_restoration_model.py:324-336 dispatches by name); the same keys as
the JAX package's registry. ``NO_REFERENCE`` names the metrics that score
an output alone (the validation loop gives them no target). FID is not a
per-image metric: ``metrics/fid.py`` scores feature sets and folders."""

from __future__ import annotations

from .niqe import calculate_niqe
from .psnr_ssim import calculate_psnr, calculate_ssim, calculate_ssim_2d

METRICS = {
    "calculate_psnr": calculate_psnr,
    "calculate_ssim": calculate_ssim,
    "calculate_ssim_2d": calculate_ssim_2d,
    "calculate_niqe": calculate_niqe,
}
NO_REFERENCE = frozenset({"calculate_niqe"})


def get_metric(name: str):
    if name not in METRICS:
        raise KeyError(f"unknown metric {name!r}; known: {sorted(METRICS)}")
    return METRICS[name]


__all__ = ["calculate_psnr", "calculate_ssim", "calculate_ssim_2d",
           "calculate_niqe", "METRICS", "NO_REFERENCE", "get_metric"]
