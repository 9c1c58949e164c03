#!/usr/bin/env python3
"""Probe the PyTorch/CUDA port's block tile kernels at C = 192 and 384 on one
GPU: for each of the teacher's deeper stage shapes, the stage against
``stage_plain`` (within 1e-2, the same bits twice), its time (CUDA events over
5 calls), the host's enqueue time a call, each kernel's device time a block
(``torch.profiler``) and the cycles per phase inside a tile of kernels (A),
(P) and (F) (``ops/phase_clocks.py``), with ptxas' registers and spills.

    python3 scripts/torch_wide_probe.py [--sm-fraction N]

``--sm-fraction N`` runs the phase clocks with the kernels' grids cut to
1/N of the SMs: where the cycles a tile stay the same, the kernels are not
bound by what all SMs share (L2's weight traffic). One JSON line a shape.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

SHAPES = [((1, 256, 256, 192), 6, 4), ((1, 512, 512, 192), 6, 4), ((1, 256, 256, 384), 8, 8),
          ((1, 256, 256, 384), 2, 8)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sm-fraction", type=int, default=1)
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build, block, phase_clocks, stage
    from torch_stage_ab import kernel_us, weights

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for name in ("stage", "stage_sm90_wide", "stage_sm90_wide_clocks"):
        _build.load(name)
    frac = args.sm_fraction
    if frac > 1:  # the grids of (A), (P) and (F) on 1/frac of the SMs
        grid, groups, pgrid = block.wgmma_grid, block.gram_groups, block.proj_grid
        block.wgmma_grid = lambda b, h, w, n_sm, tile=block.WGMMA_TILE: grid(b, h, w, n_sm // frac,
                                                                             tile)
        block.gram_groups = lambda t, n_sm, b, k=1: groups(t, n_sm // frac, b, k)
        block.proj_grid = lambda b, h, w, n_sm, *a: pgrid(b, h, w, n_sm // frac, *a)
    for shape, n, heads in SHAPES:
        c = shape[-1]
        wts = weights(np.random.default_rng(n), n, c, heads, int(2.66 * c), "cuda")
        x = torch.from_numpy(np.random.default_rng(n).normal(size=shape).astype(np.float32))
        x = x.cuda().bfloat16()
        got = stage.fused_transformer_stage(x, **wts)
        ref = stage.stage_plain(x, **wts)
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        assert rel <= 1e-2 and torch.equal(got, stage.fused_transformer_stage(x, **wts)), rel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            stage.fused_transformer_stage(x, **wts)
        end.record()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stage.fused_transformer_stage(x, **wts)
            torch.cuda.synchronize()
        row = dict(shape=list(shape), blocks=n, heads=heads, card=card, sm_fraction=frac,
                   rel_err=rel, ms=start.elapsed_time(end) / 5, host_enqueue_ms=host_ms,
                   kernel_ms_a_block={k: v / 1e3 / n for k, v in kernel_us(prof).items()
                                      if k.startswith("k_")})
        if n > 2:
            row["phases"] = {k: dict(cycles_per_tile=v["cycles_per_tile"], tiles=v["tiles"],
                                     share=v["share"])
                             for k, v in phase_clocks.block_phase_shares(x, **wts).items()}
        print(json.dumps(row), flush=True)
    print(json.dumps({"ptxas": _build.kernel_resources("stage_sm90_wide"), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
