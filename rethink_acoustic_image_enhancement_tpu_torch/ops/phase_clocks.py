"""Cycles per phase inside the block kernels' tiles, from the instrumented
builds of ``csrc/stage.cu``, ``csrc/stage_sm90.cu`` and
``csrc/stage_sm90_wide.cu``.

``_build.VARIANTS["stage_clocks"]`` (and ``"stage_sm90_clocks"``,
``"stage_sm90_wide_clocks"``) is the same source compiled with
``-DRAIE_PHASE_CLOCKS``: thread 0 of every thread block reads ``clock64()``
at each phase boundary and the block writes its sums to a device buffer.
``block_phase_shares`` runs one TransformerBlock through those libraries
and reduces the buffers to, per kernel, the share of a tile's cycles in each
phase and the cycles per tile (at C = 96 kernels (A) and (C) are
``k_gram_wgmma`` and ``k_apply_wgmma``, at C = 192 and 384 (A), (P) and (F)
``k_gram_wide``, ``k_proj_wide`` and ``k_ffn_wide``, whose thread 0 sees its
own warpgroup's phases; the warpgroups run apart between barriers).
``gdfn_phase_shares`` does the same for the Hopper LN+GDFN kernel (its
``k_ffn_wide`` at C = 96, 192 and 384, ``ops/gdfn.py::gdfn_sm90``). The
clocks cost a few percent and serialise nothing, but the build is for
measurement only: every other path loads the normal library, which has none
of it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import gdfn as pgdfn
from .block import WIDE_TILE, BlockRunner, apply_route, lib, pack_blocks, wg_lib, wide_lib
from .gdfn import check_input

PHASE_SLOTS = 16  # int64 per thread block; the last one counts tiles
GRAM_PHASES = ("x load + LN1", "qkv product", "depthwise + norms + v store",
               "Gram product", "set-up and partials")
APPLY_PHASES = ("initial loads", "attn @ v", "W_proj", "LN2 + accumulator set-up",
                "W_in product", "depthwise + GELU gate", "W_out product",
                "final store")
GRAM_WG_PHASES = ("x load + LN1", "first qkv product", "depthwise + norms + v store (products "
                  "overlapped)", "Gram product", "partials")
APPLY_WG_PHASES = ("wait for v", "attn @ v + W_proj", "LN2", "W_in product",
                   "depthwise + GELU gate (W_out overlapped)", "last W_out + store")
GRAM_WIDE_PHASES = ("x load + LN1", "first qkv product", "depthwise + norms + v store (the "
                    "next chunk's product running), and the barrier after", "Gram product",
                    "partials", "wait for a W_qkv chunk", "copies issued, next chunk's barrier",
                    "wait for the next chunk's product")
PROJ_WIDE_PHASES = ("x load + wait for v", "attn @ v", "W_proj", "r store")
FFN_WIDE_PHASES = ("r load + LN2", "W_in product", "depthwise + GELU gate (W_out running), and "
                   "the barrier after", "last W_out + store", "wait for a W_in or W_out chunk",
                   "copies issued", "wait for W_out")


def _shares(rows: torch.Tensor, names) -> dict:
    """rows: (thread blocks, PHASE_SLOTS) cycle sums."""
    total = rows[:, :len(names)].sum().item()
    tiles = rows[:, -1].sum().item()
    per_phase = rows[:, :len(names)].sum(0).tolist()
    return dict(thread_blocks=rows.shape[0], tiles=int(tiles),
                cycles_per_tile=total / tiles,
                share={n: c / total for n, c in zip(names, per_phase)})


def block_phase_shares(x: torch.Tensor, ln_eps: float = 1e-5, **weights) -> dict:
    """{"k_gram": ..., "k_apply": ...} (at C = 96 {"k_gram_wgmma": ...,
    "k_apply_wgmma": ...}; at C = 192 and 384 {"k_gram_wide": ...,
    "k_proj_wide": ..., "k_ffn_wide": ...}) for block 0 of stacked stage
    weights (the arguments of ``fused_transformer_stage``) on NHWC x on the
    card."""
    x = check_input(x, "stage")
    p = pack_blocks(x.device, **weights)
    library = lib("stage_clocks")
    set_buffers = library.raie_stage_phase_buffers
    set_buffers.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    set_buffers.restype = ctypes.c_int
    b, h, w, c = x.shape
    heads = p["temp"].shape[1]
    wg = apply_route(c, heads=heads) == "wgmma"
    wide = wg and c != 96
    wg_library = (wide_lib("stage_sm90_wide_clocks") if wide else
                  wg_lib("stage_sm90_clocks") if wg else None)
    runner = BlockRunner(x, heads, p["fp"], library, wg_library=wg_library)
    n_apply = runner.apply_grid if wg else b * -(-h // runner.ath) * -(-w // runner.atw)
    gram = torch.zeros(b * runner.groups, PHASE_SLOTS, dtype=torch.int64, device=x.device)
    apply = torch.zeros(n_apply, PHASE_SLOTS, dtype=torch.int64, device=x.device)
    proj = torch.zeros(runner.proj_grid if wide else 1, PHASE_SLOTS, dtype=torch.int64,
                       device=x.device)
    y = torch.empty_like(x)

    def set_all(gram_rows, apply_rows, proj_rows):
        if wide:  # (A), (P) and (F) are stage_sm90_wide.cu's
            fn = wg_library.raie_stage_sm90_wide_phase_buffers
            fn.argtypes, fn.restype = [ctypes.c_void_p] * 3, ctypes.c_int
            _build.check(wg_library, "stage_sm90_wide", fn(gram_rows, proj_rows, apply_rows),
                         "phase buffers")
            gram_rows = apply_rows = None
        elif wg:  # both tile kernels are stage_sm90.cu's
            fn = wg_library.raie_stage_sm90_phase_buffers
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
            _build.check(wg_library, "stage_sm90", fn(gram_rows, apply_rows), "phase buffers")
            gram_rows = apply_rows = None
        _build.check(library, "stage", set_buffers(gram_rows, apply_rows), "phase buffers")

    try:
        set_all(gram.data_ptr(), apply.data_ptr(), proj.data_ptr())
        runner.run(x, y, p, 0, ln_eps)  # warm-up: caches, clocks
        torch.cuda.synchronize(x.device)
        for rows in (gram, apply, proj):
            rows.zero_()
        runner.run(x, y, p, 0, ln_eps)
        torch.cuda.synchronize(x.device)
    finally:
        set_all(None, None, None)
    if wide:
        return dict(k_gram_wide=_shares(gram, GRAM_WIDE_PHASES),
                    k_proj_wide=_shares(proj, PROJ_WIDE_PHASES),
                    k_ffn_wide=_shares(apply, FFN_WIDE_PHASES))
    if wg:
        return dict(k_gram_wgmma=_shares(gram, GRAM_WG_PHASES),
                    k_apply_wgmma=_shares(apply, APPLY_WG_PHASES))
    return dict(k_gram=_shares(gram, GRAM_PHASES), k_apply=_shares(apply, APPLY_PHASES))


def gdfn_phase_shares(x: torch.Tensor, ln_weight, ln_bias, w_in, w_dw, w_out,
                      bias_free: bool = True, apply_ln: bool = True, residual: bool = True,
                      ln_eps: float = 1e-5) -> dict:
    """{"k_ffn_wide": ...} of the Hopper LN+GDFN kernel on NHWC x on the card
    (C = 96, 192 or 384; the arguments of ``ops/gdfn.py::fused_ln_gdfn``,
    ``residual=False`` a model shard's part)."""
    x = check_input(x, "GDFN")
    b, h, w, c = x.shape
    with _build.on_device(x, "GDFN"):
        p = pgdfn.pack_ffn_route(w_in.reshape(1, c, -1), w_dw.reshape(1, 9, -1),
                                 w_out.reshape(1, -1, c), c, x.device)
        lnw = ln_weight.detach().float().contiguous()
        lnb = pgdfn._ln_bias(ln_weight, ln_bias, bias_free)
        lnb = None if lnb is None or not apply_ln else lnb.detach().float().contiguous()
        library = _build.bind("stage_sm90_wide_clocks", pgdfn._SM90_SIGNATURES)
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        th, tw = WIDE_TILE[c]
        rows = torch.zeros(min(n_sm, b * -(-h // th) * -(-w // tw)), PHASE_SLOTS,
                           dtype=torch.int64, device=x.device)
        y = torch.empty_like(x)
        fn = library.raie_stage_sm90_wide_phase_buffers
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 3, ctypes.c_int
        try:
            _build.check(library, "stage_sm90_wide", fn(None, None, rows.data_ptr()),
                         "phase buffers")
            for _ in range(2):  # a warm-up, then the one read
                rows.zero_()
                pgdfn.gdfn_sm90(x, y, lnw, lnb, apply_ln, p["win_wg"][0], p["wtaps_wg"][0],
                                p["wout_wg"][0], p["fp"], ln_eps, residual,
                                library="stage_sm90_wide_clocks")
                torch.cuda.synchronize(x.device)
        finally:
            fn(None, None, None)
    return dict(k_ffn_wide=_shares(rows, FFN_WIDE_PHASES))
