"""Cycles per phase inside the block kernels' tiles, from the instrumented
build of ``csrc/stage.cu``.

``_build.VARIANTS["stage_clocks"]`` is the same source compiled with
``-DRAIE_PHASE_CLOCKS``: thread 0 of every thread block reads ``clock64()``
at each phase boundary and the block writes its sums to a device buffer.
``block_phase_shares`` runs one TransformerBlock through that library and
reduces the buffers to, per kernel, the share of a tile's cycles in each
phase and the cycles per tile. The clocks cost a few percent and serialise
nothing, but the build is for measurement only: every other path loads the
normal library, which has none of it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .block import BlockRunner, lib, pack_blocks
from .gdfn import check_input

PHASE_SLOTS = 16  # int64 per thread block; the last one counts tiles
GRAM_PHASES = ("x load + LN1", "qkv product", "depthwise + norms + v store",
               "Gram product", "set-up and partials")
APPLY_PHASES = ("initial loads", "attn @ v", "W_proj", "LN2 + accumulator set-up",
                "W_in product", "depthwise + GELU gate", "W_out product",
                "final store")


def _shares(rows: torch.Tensor, names) -> dict:
    """rows: (thread blocks, PHASE_SLOTS) cycle sums."""
    total = rows[:, :len(names)].sum().item()
    tiles = rows[:, -1].sum().item()
    per_phase = rows[:, :len(names)].sum(0).tolist()
    return dict(thread_blocks=rows.shape[0], tiles=int(tiles),
                cycles_per_tile=total / tiles,
                share={n: c / total for n, c in zip(names, per_phase)})


def block_phase_shares(x: torch.Tensor, ln_eps: float = 1e-5, **weights) -> dict:
    """{"k_gram": ..., "k_apply": ...} for block 0 of stacked stage weights
    (the arguments of ``fused_transformer_stage``) on NHWC x on the card."""
    x = check_input(x, "stage")
    p = pack_blocks(x.device, **weights)
    library = lib("stage_clocks")
    set_buffers = library.raie_stage_phase_buffers
    set_buffers.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    set_buffers.restype = ctypes.c_int
    runner = BlockRunner(x, p["temp"].shape[1], p["fp"], library)
    b, h, w, _ = x.shape
    n_apply = b * -(-h // runner.ath) * -(-w // runner.atw)
    gram = torch.zeros(b * runner.groups, PHASE_SLOTS, dtype=torch.int64, device=x.device)
    apply = torch.zeros(n_apply, PHASE_SLOTS, dtype=torch.int64, device=x.device)
    y = torch.empty_like(x)
    try:
        _build.check(library, "stage", set_buffers(gram.data_ptr(), apply.data_ptr()),
                     "phase buffers")
        runner.run(x, y, p, 0, ln_eps)  # warm-up: caches, clocks
        torch.cuda.synchronize(x.device)
        gram.zero_()
        apply.zero_()
        runner.run(x, y, p, 0, ln_eps)
        torch.cuda.synchronize(x.device)
    finally:
        set_buffers(None, None)
    return dict(k_gram=_shares(gram, GRAM_PHASES), k_apply=_shares(apply, APPLY_PHASES))
