"""The student's distillation step worked out again in plain PyTorch
float32: the device-resident batch (a crop of a group of consecutive
frames, the masked-denoising corruption, the rescue noise, the 8-way
flip and rotation; paired_image_dataset.py:109-297), the curriculum's extra
mask, mixup (image_restoration_model.py:25-73), the L1 loss for video
frames (losses.py:409-526), its gradient by autograd, the global-norm clip
at 0.01 (optax's rule: scale only at or above the norm, no epsilon) and
AdamW (decoupled weight decay).

Every draw is made from generators the caller seeds as it seeds the
program's, in the program's order, so both sides see the same batch."""

from __future__ import annotations

import numpy as np
import torch

from . import student
from .ops import Ops, fp32_exact

MASK_VALUE = 0.1
BINARY = 0.1


def _keep(x, keep):
    keep = keep.to(x.dtype)
    return x * keep - MASK_VALUE + MASK_VALUE * keep


def sample(lq: torch.Tensor, gt: torch.Tensor, ids: torch.Tensor, gen: torch.Generator,
           g: int, frames: int, base_prob: float, geometric: bool):
    """(lq, gt) (B, F, g, g) of the groups ``ids`` (group i: frames i .. i +
    F - 1) of the (N, H, W) planes."""
    b = len(ids)
    h, w = lq.shape[-2:]
    dev = gen.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    top = torch.randint(0, h - g + 1, (b,), generator=gen, device=dev)
    left = torch.randint(0, w - g + 1, (b,), generator=gen, device=dev)
    mask_mode = rand(b) < 0.64
    boost = rand(b, frames) > 0.64
    u_mask, u_even, u_odd = rand(b, frames, g, g), rand(b, frames, g, g), rand(b, frames, g, g)
    noise = torch.randn((b, frames, g, g), generator=gen, device=dev)
    aug = (torch.randint(0, 8, (b,), generator=gen, device=dev) if geometric
           else torch.zeros(b, dtype=torch.int64, device=dev))

    outs_lq, outs_gt = [], []
    p = float(np.clip(np.float32(base_prob), 0, 1))
    p_hi = float(np.clip(np.float32(base_prob) + np.float32(0.5), 0, 1))
    for j in range(b):
        i, t, l = int(ids[j]), int(top[j]), int(left[j])
        x = lq[i:i + frames, t:t + g, l:l + g]
        y = gt[i:i + frames, t:t + g, l:l + g]
        if bool(mask_mode[j]):
            probs = torch.where(boost[j], p_hi, p)[:, None, None]
            x = _keep(x, u_mask[j] >= probs)
        else:
            mid = x.clone()
            mid[1:frames - 1] = 0.5 * (x[0:frames - 2] + x[2:frames])
            odd = (torch.arange(frames, device=x.device) % 2 == 1)[:, None, None]
            x = torch.where(odd, _keep(torch.where(odd, mid, x), u_odd[j] >= p_hi),
                            _keep(torch.where(odd, mid, x), u_even[j] >= p))
        share = max(float((x == 0).float().mean()), float((x == 1).float().mean()))
        if share > 0.64:
            x = (x + 0.3 + 0.7 * noise[j]).clamp(0.0, 1.0)
        m = int(aug[j])
        x, y = (torch.rot90(t, m // 2, dims=(-2, -1)) for t in (x, y))
        if m % 2:
            x, y = torch.flip(x, dims=(-2,)), torch.flip(y, dims=(-2,))
        outs_lq.append(x)
        outs_gt.append(y)
    return torch.stack(outs_lq), torch.stack(outs_gt)


def extra_mask(lq: torch.Tensor, gen: torch.Generator, prob: float) -> torch.Tensor:
    if prob <= 0:
        return lq
    u = torch.rand(tuple(lq.shape), generator=gen, device=gen.device)
    return _keep(lq, u >= min(max(prob, 0.0), 1.0))


def mixup(rng: np.random.Generator, gt, lq, beta: float, identity: bool):
    if identity and int(rng.integers(0, 2)) != 0:
        return gt, lq
    lam = float(rng.beta(beta, beta))
    perm = torch.from_numpy(rng.permutation(gt.shape[0])).to(gt.device)
    return lam * gt + (1 - lam) * gt[perm], lam * lq + (1 - lam) * lq[perm]


def video_l1(pred, target, l1w: float, tw: float):
    """l1w * mean(|p - t| + |bin(p) - bin(t)|) + tw * mean(|dp - dt|) over
    adjacent frames; bin(x) = 1 where x > 0.1."""
    per = (pred - target).abs() + ((pred > BINARY).float() - (target > BINARY).float()).abs()
    dp, dt = pred[:, 1:] - pred[:, :-1], target[:, 1:] - target[:, :-1]
    return l1w * per.mean() + tw * (dp - dt).abs().mean()


class AdamW:
    """AdamW as published (Loshchilov and Hutter): p -= lr * wd * p, then
    the bias-corrected Adam step with eps outside the root."""

    def __init__(self, params: dict, betas, eps: float, wd: float, moments=None):
        """``moments``: (first, second, update count) to start from, or
        None for a new optimizer."""
        self.b1, self.b2 = betas
        self.eps, self.wd, self.t = eps, wd, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        if moments is not None:
            m, v, self.t = moments
            self.m = {k: m[k].detach().clone().float() for k in params}
            self.v = {k: v[k].detach().clone().float() for k in params}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def train_steps(params0: dict, net: dict, batches, lrs, opt: dict, ops: Ops | None = None,
                tf32: bool = False, moments=None):
    """Run the steps of ``batches`` ((lq, gt) each, already drawn) at the
    rates ``lrs`` from ``params0`` (and AdamW's ``moments``, see
    ``AdamW``); returns (losses, the first step's clipped gradients, the
    parameters after the last step)."""
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    adam = AdamW(params, opt["betas"], 1e-8, opt["weight_decay"], moments)
    losses, first = [], None
    for (lq, gt), lr in zip(batches, lrs):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with fp32_exact(tf32):
            pred = student.forward(leaves, net, lq, ops)
            loss = video_l1(pred, gt, opt["l1loss_weight"], opt["temporal_weight"])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if opt["clip"] is not None and float(norm) >= opt["clip"]:
            grads = {k: g / norm * opt["clip"] for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(params, grads, lr)
        losses.append(float(loss.detach()))
    return losses, first, params


def cosine_restart_lr(step: int, base_lr: float, periods, restart_weights, eta_mins,
                      warmup: int) -> float:
    """CosineAnnealingRestartCyclicLR (lr_scheduler.py:186-233) under a
    linear warmup to ``base_lr`` (base_model.py:183-205); a step on a
    period's boundary belongs to the earlier period."""
    if warmup > 0 and step < warmup:
        return base_lr * step / warmup
    ends = np.cumsum(periods)
    i = min(int(np.searchsorted(ends, step, side="left")), len(periods) - 1)
    start = 0 if i == 0 else int(ends[i - 1])
    frac = (step - start) / periods[i]
    return eta_mins[i] + restart_weights[i] * 0.5 * (base_lr - eta_mins[i]) * (
        1 + np.cos(np.pi * frac))
