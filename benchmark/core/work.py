"""The yardstick's arithmetic: the card's published peaks, the work a
Transformer stage must do, and the model FLOPs counted on the plain
reference."""

from __future__ import annotations

# NVIDIA H100 SXM, published dense rates without sparsity, at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS[dtype]


def stage_work(b, h, w, c, n_blocks, heads, f, esize):
    """(flops, bytes) a stage of ``n_blocks`` Transformer blocks must do on
    a (b, h, w, c) input: per pixel and block the five products (qkv, the
    Gram matrix, attention times v, the projection, W_in, W_out) and the two
    depthwise 3x3s; x read once, y written once, weights once (bf16
    products, f32 depthwise kernels, LayerNorm weights and temperatures)."""
    hc = c // heads
    per_px = (2 * c * 3 * c + 2 * 9 * 3 * c + 2 * c * hc + 2 * c * hc
              + 2 * c * c + 2 * c * 2 * f + 2 * 9 * 2 * f + 2 * f * c)
    flops = per_px * b * h * w * n_blocks
    weight_bytes = n_blocks * (2 * (3 * c * c + c * c + 2 * c * f + f * c)
                               + 4 * (9 * 3 * c + 9 * 2 * f + 2 * c + heads))
    return flops, 2 * b * h * w * c * esize + weight_bytes


def stage_bound_s(b, h, w, c, n_blocks, heads, f, esize) -> float:
    """The least time the card could take for the stage: the larger of its
    operations over the peak of its element type (bf16 for 2-byte
    elements, else fp32) and its bytes over the memory bandwidth."""
    flops, nbytes = stage_work(b, h, w, c, n_blocks, heads, f, esize)
    peak = PEAK_FLOPS["bfloat16"] if esize == 2 else PEAK_FLOPS["float32"]
    return max(flops / peak, nbytes / PEAK_BYTES_PER_S)


def count_flops(fn) -> float:
    """FLOPs of the convolutions and matrix products ``fn()`` runs (forward
    and, where ``fn`` calls it, backward), as ``FlopCounterMode`` counts
    them. Run it on meta tensors: nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        fn()
    return float(mode.get_total_flops())
