"""Whole-image KDLAE-T serving (KDLAE_T.ipynb cell 5 as an API).

Reflect-pad on the host to a multiple of 8 (or ``shape_bucket``), uint8 in
(divided by 255 in float32, then cast to the serving dtype), a scalar
denoise rate broadcast to a (1, 1, H, W) plane, forward, clamp and
round-half-to-even to uint8 on the device, crop, and the fan-beam zero
mask on ``hq`` and the 2x ``sr``.

Runs on ``cuda`` unless the caller asks for another device; with no GPU
and no device named it raises rather than fall back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import KDLAETeacher
from ..ops.mask import apply_zero_mask, zero_mask_from_input
from ..utils.image_io import imread_rgb_ubyte, to_ubyte


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_reflect_np(x: np.ndarray, ph: int, pw: int) -> np.ndarray:
    if ph == 0 and pw == 0:
        return x
    return np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the GPU, and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: TeacherPredictor runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _to_ubyte_device(x: torch.Tensor) -> torch.Tensor:
    """Clamp, float32, *255, round half to even, uint8 (on the device)."""
    return torch.round(x.clamp(0.0, 1.0).float() * 255.0).to(torch.uint8)


class TeacherPredictor:
    """Whole-image KDLAE-T denoiser with the notebook's pre/postprocessing.

    ``model`` carries its weights; ``fused`` routes gate-admitted stages
    through the stage kernel. ``shape_bucket`` rounds padded sizes up to a
    coarser grid (MDTA statistics are global over the padded pixels, so
    bucketed outputs deviate slightly from multiple-of-8 padding)."""

    def __init__(self, model: KDLAETeacher | None = None, multiple_of: int = 8,
                 shape_bucket: int | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 device: str | torch.device | None = None):
        if shape_bucket and shape_bucket % multiple_of:
            raise ValueError(
                f"shape_bucket={shape_bucket} must be a multiple of "
                f"multiple_of={multiple_of}")
        self.device = resolve_device(device)
        if model is None:
            model = KDLAETeacher(layernorm_type="BiasFree", static="train",
                                 params="cat")
        self.model: nn.Module = model.to(device=self.device, dtype=dtype).eval()
        self.model.set_fused(fused)
        self.multiple_of = multiple_of
        self.shape_bucket = shape_bucket
        self.dtype = dtype

    @torch.inference_mode()
    def _forward(self, x: np.ndarray, denoise_rate: float):
        img = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if img.dtype == torch.uint8:
            # divide in float32 first, then cast: the model input equals
            # the host reader's float values in every serving dtype
            img = (img.float() / 255.0).to(self.dtype)
        else:
            img = img.to(self.dtype)
        img = img.permute(0, 3, 1, 2)
        rate = torch.full((1, 1, img.shape[2], img.shape[3]), denoise_rate,
                          dtype=self.dtype, device=self.device)
        out = self.model({"img": img, "denoise_rate": rate})
        hq = _to_ubyte_device(out["hq"]).permute(0, 2, 3, 1)
        sr = (None if out["sr"] is None
              else _to_ubyte_device(out["sr"]).permute(0, 2, 3, 1))
        return hq, sr

    def __call__(self, img_rgb: np.ndarray, denoise_rate: float = 1.0,
                 zero_mask: bool = True) -> dict:
        """img_rgb: (H, W, 3) float [0,1] or uint8. Returns 'hq' (H, W, 3)
        and, with the SR head, 'sr' (2H, 2W, 3), both uint8."""
        h, w, _ = img_rgb.shape
        m = self.shape_bucket or self.multiple_of
        ph, pw = _round_up(h, m) - h, _round_up(w, m) - w
        x = _pad_reflect_np(img_rgb[None], ph, pw)
        if x.dtype != np.uint8:
            x = x.astype(np.float32)
        hq, sr = self._forward(x, denoise_rate)
        hq = hq[0, :h, :w].cpu().numpy()
        out = {}
        if zero_mask:
            mask = zero_mask_from_input(
                img_rgb if img_rgb.dtype == np.uint8 else to_ubyte(img_rgb))
            hq = apply_zero_mask(hq, mask)
        out["hq"] = hq
        if sr is not None:
            sr_img = sr[0, :2 * h, :2 * w].cpu().numpy()
            if zero_mask:
                sr_img = apply_zero_mask(sr_img, mask, scale=2)
            out["sr"] = sr_img
        return out

    def denoise_file(self, path: str, denoise_rate: float = 1.0, **kw) -> dict:
        return self(imread_rgb_ubyte(path), denoise_rate, **kw)
