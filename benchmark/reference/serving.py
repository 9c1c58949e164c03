"""The serving boundary, worked out again: uint8 in, reflect padding at the
bottom and right to the model's multiple, uint8 out (clamp to [0, 1], times
255, round half to even), cropped; for the teacher, output pixels where
the input was exactly 0 in every channel set back to 0 (the fan-beam mask;
the 2x output takes the mask repeated)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import student, teacher
from .ops import Ops, fp32_exact


def _pad(x: torch.Tensor, m: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    ph, pw = -h % m, -w % m
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="reflect")
    return x


def _ubyte(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


@torch.no_grad()
def teacher_frame(p: dict, net: dict, frame: np.ndarray, rate: float, multiple_of: int,
                  device, ops: Ops | None = None) -> tuple[np.ndarray, np.ndarray | None]:
    """(hq, sr) uint8 of one (H, W, 3) uint8 frame."""
    h, w = frame.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
    x = _pad(x.permute(2, 0, 1)[None].float() / 255.0, multiple_of)
    plane = torch.full((1, 1, *x.shape[-2:]), float(rate), device=device)
    with fp32_exact():
        hq, sr = teacher.forward(p, net, x, plane, ops)
    zero = torch.from_numpy(np.all(frame == 0, axis=-1)).to(device)
    hq = _ubyte(hq[0, :, :h, :w]).permute(1, 2, 0)
    hq[zero] = 0
    if sr is not None:
        sr = _ubyte(sr[0, :, :2 * h, :2 * w]).permute(1, 2, 0)
        sr[zero.repeat_interleave(2, 0).repeat_interleave(2, 1)] = 0
        sr = sr.cpu().numpy()
    return hq.cpu().numpy(), sr


@torch.no_grad()
def student_stacks(p: dict, net: dict, stacks: np.ndarray, multiple_of: int, device,
                   ops: Ops | None = None, tf32: bool = False) -> np.ndarray:
    """(B, F, H, W) uint8 stacks -> (B, F, H, W) uint8 (``tf32``: with
    cuDNN's TF32 on, a control)."""
    h, w = stacks.shape[-2:]
    x = torch.from_numpy(np.ascontiguousarray(stacks)).to(device).float() / 255.0
    x = _pad(x, multiple_of)
    with fp32_exact(tf32):
        y = student.forward(p, net, x, ops)
    return _ubyte(y[..., :h, :w]).cpu().numpy()


def level_gaps(got: np.ndarray, want: np.ndarray, keep: np.ndarray | None = None
               ) -> np.ndarray:
    """|got - want| in uint8 levels, at the pixels ``keep`` selects."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return d if keep is None else d[keep]
