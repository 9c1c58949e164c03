"""Corruption masks and fan-beam zero-mask postprocessing.

``input_mask`` is the reference's multiplicative-Bernoulli frame corruption
(Train/basicsr/data/paired_image_dataset.py:19-36):
    out = img * keep - value + value * keep
kept pixels unchanged, dropped pixels forced to -value. ``mask_with_keep``
is its deterministic core; ``input_mask`` draws ``keep`` (a uniform per
element, kept where it is >= prob) from an explicit generator: a numpy one
on the host, so that a seed gives the same mask on every device, or a
``torch.Generator`` on the tensor's device, so that nothing crosses to it.

``frame_interpolation_corrupt``: the reference's simulated frame
interpolation (paired_image_dataset.py:231-241) on a (..., F, H, W) stack;
``frame_interpolation_core`` is its deterministic core over two given
uniform fields.

``zero_mask_from_input`` / ``apply_zero_mask``: the notebooks' fan-beam
border preservation (KDLAE_T.ipynb cell 5): output pixels where the
quantised input was exactly 0 are forced back to 0.
"""

from __future__ import annotations

import numpy as np
import torch


def mask_with_keep(img: torch.Tensor, keep: torch.Tensor,
                   value: float = 0.1) -> torch.Tensor:
    """``img`` where ``keep`` is 1, -value where it is 0."""
    keep = keep.to(img.dtype)
    return img * keep - value + value * keep


def uniform(shape, gen: torch.Generator) -> torch.Tensor:
    """float32 uniforms in [0, 1) drawn from ``gen`` on its device."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device)


def same_device(a: torch.device, b: torch.device) -> bool:
    """One device, an index of None being the current one."""
    if a.type != b.type:
        return False
    cur = torch.cuda.current_device() if a.type == "cuda" else 0
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def input_mask(img: torch.Tensor, rng: np.random.Generator | torch.Generator,
               prob: float, value: float = 0.1,
               rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Bernoulli-mask a tensor of any shape: P(drop) = clip(prob, 0, 1).
    The uniforms come from ``rng``: a numpy generator draws them on the host,
    a ``torch.Generator`` on its own device, which must be the tensor's.
    ``rows`` (first, total): ``img`` holds rows [first, first + len(img))
    of a batch of ``total``; the uniforms are drawn for that whole batch
    and this rank's rows of them used, so that the ranks' masks together
    are the one a single process draws."""
    prob = min(max(float(prob), 0.0), 1.0)
    shape = tuple(img.shape) if rows is None else (rows[1], *img.shape[1:])
    first = 0 if rows is None else rows[0]
    if isinstance(rng, torch.Generator):
        if not same_device(rng.device, img.device):
            raise ValueError(f"the generator is on {rng.device}, the tensor "
                             f"on {img.device}")
        u = uniform(shape, rng)[first:first + img.shape[0]]
        return mask_with_keep(img, u >= prob, value)
    u = rng.random(shape, dtype=np.float32)[first:first + img.shape[0]]
    return mask_with_keep(img, (torch.from_numpy(u) >= prob).to(img.device), value)


def prob_thresholds(prob: float) -> tuple[float, float]:
    """(clip(prob, 0, 1), clip(prob + 0.5, 0, 1)) computed in float32, as
    the JAX package computes them on a traced float32 prob; plain floats,
    so that no tensor crosses to the device for them."""
    p = np.float32(prob)
    return (float(np.clip(p, np.float32(0), np.float32(1))),
            float(np.clip(p + np.float32(0.5), np.float32(0), np.float32(1))))


def frame_interpolation_core(stack: torch.Tensor, u_even: torch.Tensor,
                             u_odd: torch.Tensor, prob, value: float = 0.1
                             ) -> torch.Tensor:
    """Odd frames of a (..., F, H, W) stack (F odd) become the mean of their
    two neighbours and are masked where ``u_odd < prob + 0.5``; even frames
    are masked where ``u_even < prob``.
    ``u_*`` have the stack's shape."""
    f = stack.shape[-3]
    if f % 2 != 1:
        raise ValueError(f"frame interpolation needs an odd frame count, got {f}")
    mid = torch.zeros_like(stack)
    mid[..., 1:f - 1, :, :] = 0.5 * (stack[..., 0:f - 2, :, :] + stack[..., 2:f, :, :])
    is_odd = (torch.arange(f, device=stack.device) % 2 == 1)[:, None, None]
    replaced = torch.where(is_odd, mid, stack)
    even, odd = prob_thresholds(prob)
    masked_even = mask_with_keep(replaced, u_even >= even, value)
    masked_odd = mask_with_keep(replaced, u_odd >= odd, value)
    return torch.where(is_odd, masked_odd, masked_even)


def frame_interpolation_corrupt(stack: torch.Tensor, gen: torch.Generator,
                                prob, value: float = 0.1) -> torch.Tensor:
    """``frame_interpolation_core`` with its two uniform fields drawn from
    ``gen`` on the stack's device."""
    return frame_interpolation_core(stack, uniform(stack.shape, gen),
                                    uniform(stack.shape, gen), prob, value)


def input_mask_np(img: np.ndarray, rng: np.random.Generator, prob: float,
                  value: float = 0.1) -> np.ndarray:
    """The same corruption on a numpy array (host-side datasets)."""
    prob = min(float(prob), 1.0)
    keep = (rng.random(img.shape) >= prob).astype(img.dtype)
    return img * keep - value + value * keep


def zero_mask_from_input(lq_ubyte: np.ndarray) -> np.ndarray:
    """Boolean (H, W) mask of pixels that are exactly 0 in the quantised
    input (all channels zero for RGB)."""
    if lq_ubyte.ndim == 3 and lq_ubyte.shape[-1] == 3:
        return ((lq_ubyte[..., 0] == 0) & (lq_ubyte[..., 1] == 0)
                & (lq_ubyte[..., 2] == 0))
    return np.squeeze(lq_ubyte) == 0


def apply_zero_mask(img_ubyte: np.ndarray, mask: np.ndarray,
                    scale: int = 1) -> np.ndarray:
    """Zero out masked pixels; ``scale`` repeats the mask (the SR branch
    uses the 2x-repeated mask)."""
    if scale != 1:
        mask = np.repeat(np.repeat(mask, scale, axis=0), scale, axis=1)
    out = img_ubyte.copy()
    out[mask] = 0
    return out
