"""Which TransformerStages run through the stage kernel: a pure function of
shape, copied from the JAX package so that both route exactly the same
stages (``ops/pallas/gdfn.py:68-107``, ``ops/pallas/block.py:53-68``,
``ops/pallas/stage.py:217-230``).

The tiling budget below is the reference kernel's on-chip memory budget.
Here it decides routing only; the CUDA kernel picks its own tiles
(``ops/stage.py::plan_tiles``).
"""

from __future__ import annotations

_ROUTING_BUDGET = 48 * 1024 * 1024


def _pick_tile(n: int, target: int) -> int | None:
    """Largest multiple-of-8 divisor of n that is <= target; None if none."""
    t = min(n, target) // 8 * 8
    while t >= 8:
        if n % t == 0:
            return t
        t -= 8
    return None


def _tile_bytes(th: int, tw: int, c_pad: int, f_pad: int) -> int:
    halo = (th + 2) * (tw + 2)
    return 4 * (halo * c_pad + halo * 2 * f_pad + th * tw * 2 * f_pad
                + th * tw * f_pad + th * tw * c_pad
                ) + 2 * 2 * (th + 8) * (tw + 8) * c_pad


def _pick_tiles(h: int, w: int, c_pad: int, f_pad: int):
    """(th, tw) within the routing budget; None when impossible."""
    tw = _pick_tile(w, 256)
    if tw is None:
        return None
    for target_h in (32, 24, 16, 8):
        th = _pick_tile(h, target_h)
        if th is None:
            continue
        t = tw
        while t is not None and _tile_bytes(th, t, c_pad, f_pad) > _ROUTING_BUDGET:
            t = _pick_tile(w, t - 8) if t > 8 else None
        if t is not None:
            return th, t
    return None


def mega_worthwhile(batch: int, h: int, w: int, c: int, num_heads: int,
                    bias_free: bool, use_bias: bool,
                    expansion: float = 2.66) -> bool:
    """Batch 1, heads dividing C, bias-free convs, a tiling exists, at
    least 256x256 pixels and at most 1.5x channel padding to 128."""
    del bias_free
    if batch != 1 or c % num_heads != 0 or use_bias:
        return False
    c_pad = -(-c // 128) * 128
    f_pad = -(-int(c * expansion) // 128) * 128
    if _pick_tiles(h, w, c_pad, max(f_pad, 2 * c_pad)) is None:
        return False
    return h * w >= 256 * 256 and (c_pad / c) <= 1.5


def stage_worthwhile(batch: int, h: int, w: int, c: int, num_heads: int,
                     bias_free: bool, use_bias: bool,
                     expansion: float = 2.66) -> bool:
    """The stage gate: BiasFree LN only, any batch, and the block gate's
    shape policy."""
    if not bias_free:
        return False
    return mega_worthwhile(1, h, w, c, num_heads, bias_free, use_bias,
                           expansion) and batch >= 1
