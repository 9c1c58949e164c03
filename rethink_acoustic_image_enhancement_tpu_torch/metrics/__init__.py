"""Metric registry: a name here is addressable from YAML ``val.metrics``
(image_restoration_model.py:324-336 dispatches by name). NIQE and FID are
still to be ported (ROADMAP.md, Queue A: NIQE, FID and the remaining datasets)."""

from __future__ import annotations

from .psnr_ssim import calculate_psnr, calculate_ssim, calculate_ssim_2d

METRICS = {
    "calculate_psnr": calculate_psnr,
    "calculate_ssim": calculate_ssim,
    "calculate_ssim_2d": calculate_ssim_2d,
}
_NOT_PORTED = ("calculate_niqe", "calculate_fid")


def get_metric(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet (ROADMAP.md, Queue A: "
            "NIQE, FID and the remaining datasets)")
    if name not in METRICS:
        raise KeyError(f"unknown metric {name!r}; known: {sorted(METRICS)}")
    return METRICS[name]


__all__ = ["calculate_psnr", "calculate_ssim", "calculate_ssim_2d",
           "METRICS", "get_metric"]
