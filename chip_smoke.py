#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: torch/CUDA versions, the card's name and power limit;
     build every csrc/*.cu for sm_90a, and the instrumented variant of
     stage.cu (one nvcc each, all at once).
  2. each kernel (stage, LayerNorm, LN+GDFN, whole block) against its plain
     PyTorch version on the card, at the shapes its paths give it, in bf16
     and fp32, with its time, the plain version's time, the bound for the
     same work and, where one PyTorch call computes the same function, that
     call's time; the same stage call twice gives the same bits, and one
     BiasFree block the bits of a one-block stage. A "stage_phases" JSON
     line: from the instrumented build, the share of a tile's cycles in each
     phase of the block's two tile kernels and the cycles per tile, at
     (1,512,512,96) and (8,256,256,96); the thread blocks resident per SM
     (the device's occupancy answer), the grid's tail, and registers and
     spill bytes from ptxas' report.
  3. whole-image serving: the full-width flagship KDLAE-T (seeded random
     weights) through TeacherPredictor(fused=True, bf16) on synthetic sonar
     frames, with the stage-kernel call count checked against the gate and
     the uint8 outputs against the same predictor with the plain stage.
  4. the per-block paths at full width, on the flagship decoder_level1
     geometry (4 blocks of 96 channels at 512x512, BiasFree and WithBias):
     TransformerBlock(fused=True) through the block kernel, and the blocks
     composed from the public LayerNorm and LN+GDFN functions, both against
     the eager blocks.
  5. tiled serving: the same predictor's denoise_tiled in 256x256 tiles and
     in full-width strips, 8 tiles per call, with the stage-kernel call
     count checked against the gate and the outputs against the plain stage.
Each path runs with every launch count set to 0 just before it and read just
after. Prints a "kernels" JSON line, the card line, and as its last line
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

PORT = "rethink_acoustic_image_enhancement_tpu_torch"
HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 rate outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 1e-2            # kernel vs plain, max|d| / max|ref|
TOL_PATH = 2e-2           # a 4-block bf16 kernel path vs the eager blocks in fp32
PALLAS = "rethink_acoustic_image_enhancement_tpu/ops/pallas"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps runs, by CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Mean device time of fn() over reps runs, by CUDA events around
    launches that queue up behind a device-side delay: the host has issued
    them all before the first may start, so its gaps do not count."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(40_000_000)  # some 20 ms of device time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """(ms, how): mean device time of all that fn() launches over reps runs,
    free of the host's gaps, which outlast a kernel of a few tens of
    microseconds. By torch.profiler ("profiler"); where the profiler hands
    back only a part of a window's launches three times running, by
    queued_ms ("queued_events"), which adds each launch's start-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        # every kernel of fn() must show up reps times over
        if events and all(e.count % reps == 0 for e in events):
            return sum(e.self_device_time_total for e in events) / reps / 1e3, "profiler"
        log(f"  profiler window incomplete for {reps} runs: "
            f"{[(e.key[:40], e.count) for e in events]}")
    return queued_ms(fn, reps), "queued_events"


# ------------------------------------------------------------ phase 2 ----

def stage_work(b, h, w, c, n_blocks, heads, f, esize):
    """(flops, bytes) a stage must do: the five products and two depthwise
    3x3s per pixel and block; x read once, y written once, weights once."""
    hc = c // heads
    per_px = (2 * c * 3 * c + 2 * 9 * 3 * c + 2 * c * hc + 2 * c * hc
              + 2 * c * c + 2 * c * 2 * f + 2 * 9 * 2 * f + 2 * f * c)
    flops = per_px * b * h * w * n_blocks
    weight_bytes = n_blocks * (2 * (3 * c * c + c * c + 2 * c * f + f * c)
                               + 4 * (9 * 3 * c + 9 * 2 * f + 2 * c + heads))
    return flops, 2 * b * h * w * c * esize + weight_bytes


def seeded_stage_weights(rng, n, c, heads, f, device):
    import torch

    def t(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device)

    return dict(
        ln1_w=t(n, c, scale=0.1, shift=1.0),
        w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
        dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
        temperature=torch.from_numpy(
            rng.uniform(0.5, 1.5, size=(n, heads, 1, 1)).astype(np.float32)).to(device),
        w_proj=t(n, 1, 1, c, c, scale=c ** -0.5),
        ln2_w=t(n, c, scale=0.1, shift=1.0),
        w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5),
        w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
        w_out=t(n, 1, 1, f, c, scale=f ** -0.5),
    )


def phase_kernels(results, card):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

    c, f = 96, int(96 * 2.66)
    cases = [((1, 512, 512, c), 4, 1), ((1, 256, 256, c), 6, 2),
             ((2, 256, 256, c), 2, 2), ((8, 256, 256, c), 4, 1)]  # the last: a tile batch
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape, n, heads in cases:
            rng = np.random.default_rng(len(rows))
            calls_before = pstage.fused_transformer_stage.launches
            wts = seeded_stage_weights(rng, n, c, heads, f, "cuda")
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
            got = pstage.fused_transformer_stage(x, **wts)
            torch.cuda.synchronize()
            ref = pstage.stage_plain(x, **wts)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            assert torch.isfinite(got).all().item(), "non-finite kernel output"
            assert got.shape == x.shape and got.dtype == dtype
            rel = diff / scale
            kern_ms = cuda_ms(lambda: pstage.fused_transformer_stage(x, **wts), 5)
            plain_ms = cuda_ms(lambda: pstage.stage_plain(x, **wts), 2)
            flops, nbytes = stage_work(*shape, n, heads, f, x.element_size())
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = dict(shape=list(shape), n_blocks=n, heads=heads,
                       dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=diff, max_abs_ref=scale, rel_err=rel,
                       ms=kern_ms, plain_ms=plain_ms,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flops=flops, bytes=nbytes,
                       launches=pstage.fused_transformer_stage.launches - calls_before)
            rows.append(row)
            log(f"stage {row['dtype']} {tuple(shape)} blocks={n} heads={heads}: "
                f"kernel {kern_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"max|d| {diff:.3e} rel {rel:.3e}, {row['launches']} stage calls "
                f"({3 * n} kernel launches each) [{card}]")
            assert rel <= TOL_REL, f"kernel disagrees with plain: {rel} > {TOL_REL}"
            del got, ref, x
    results["stage_cases"] = rows
    results["stage_profile_us"] = profile_stage(pstage, card)
    results["stage_phases"] = stage_phases(card)
    print(json.dumps({"stage_phases": results["stage_phases"]}), flush=True)
    return rows


def stage_phases(card):
    """Cycles per phase inside a tile of the block's kernels (the
    instrumented build, which nothing else loads), with what the device and
    ptxas say of the normal build's kernels."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build, block, phase_clocks, stage

    out = {"card": card, "ptxas": _build.kernel_resources("stage"), "shapes": {}}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in ((1, 512, 512, 96), (8, 256, 256, 96)):
        rng = np.random.default_rng(1)
        wts = seeded_stage_weights(rng, 1, 96, 1, 255, "cuda")
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().bfloat16()
        a = stage.fused_transformer_stage(x, **wts)
        b = stage.fused_transformer_stage(x, **wts)
        assert torch.equal(a, b), f"two stage calls at {shape} differ"
        row = phase_clocks.block_phase_shares(x, **wts)
        plan = block.plan_tiles(block.lib(), 96, 1)
        n_blocks = row["k_apply"]["thread_blocks"]
        row["plan"] = plan._asdict()
        # thread blocks of kernel (C) left for the last, partly filled wave
        row["k_apply_grid_tail"] = n_blocks % (n_sm * plan.apply_blocks)
        out["shapes"]["x".join(map(str, shape))] = row
        for name in ("k_gram", "k_apply"):
            shares = ", ".join(f"{k} {v:.3f}" for k, v in row[name]["share"].items())
            log(f"phases {name} {shape}: {row[name]['cycles_per_tile']:.0f} cycles a tile "
                f"({shares}) [{card}]")
        log(f"  resident blocks per SM: k_gram {plan.gram_blocks}, k_apply "
            f"{plan.apply_blocks}; k_apply grid {n_blocks}, tail {row['k_apply_grid_tail']}; "
            f"bit-identical twice: yes")
    log(f"  ptxas: {out['ptxas']}")
    assert plan.apply_blocks >= 2, "kernel (C) is not resident twice per SM at C = 96"
    return out


def profile_stage(pstage, card):
    """Device time of each kernel in one 4-block bf16 stage call at
    512x512x96, by torch.profiler (summed over the call's launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wts = seeded_stage_weights(np.random.default_rng(0), 4, 96, 1, 255, "cuda")
    x = torch.randn(1, 512, 512, 96, device="cuda").bfloat16()
    pstage.fused_transformer_stage(x, **wts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pstage.fused_transformer_stage(x, **wts)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        for name in ("k_gram", "k_softmax", "k_apply"):
            if name in e.key:
                per_kernel[name] = per_kernel.get(name, 0.0) + e.device_time_total
    log(f"profile of one stage call (1,512,512,96) x4 blocks bf16, us per call: "
        f"{per_kernel} [{card}]")
    return per_kernel


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from rethink_acoustic_image_enhancement_tpu_torch.ops import block, gdfn, layernorm, stage

    fns = dict(stage=stage.fused_transformer_stage, layernorm=layernorm.fused_channel_layernorm,
               gdfn=gdfn.fused_ln_gdfn, block=block.fused_transformer_block)
    for fn in fns.values():
        fn.launches = 0
    return fns


def read_counts(fns):
    return {name: fn.launches for name, fn in fns.items()}


def seeded(rng, *shape, scale=1.0, shift=0.0):
    import torch

    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale + shift).cuda()


def held_to_plain(name, kernel, plain, x, flops, nbytes, peak_flops, card, results_row,
                  library=None, elementwise_ulp=None, tol=TOL_REL, plain_reps=2):
    """Run kernel() and plain() on the card, compare, time both (and the
    library call), and fill the row; fails on disagreement. The kernel's
    time is the device time of its wrapper's launches; the plain version's
    and the library call's are CUDA-event times."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype, (got.shape, got.dtype)
    assert torch.isfinite(got).all().item(), f"{name}: non-finite kernel output"
    d = (got.float() - ref.float()).abs()
    diff, scale = d.max().item(), ref.float().abs().max().item()
    rel = diff / scale
    ring = torch.ones(x.shape[1:3], dtype=torch.bool, device=x.device)
    ring[1:-1, 1:-1] = False
    ring_rel = d[:, ring].max().item() / scale
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    kern_ms, timed_by = device_ms(kernel, 5)
    row = dict(results_row, shape=list(x.shape), dtype=str(x.dtype).replace("torch.", ""),
               max_abs_err=diff, max_abs_ref=scale, rel_err=rel, ring_rel_err=ring_rel,
               ms=kern_ms, ms_by=timed_by, ms_with_host_gaps=cuda_ms(kernel, 5),
               plain_ms=cuda_ms(plain, plain_reps),
               library_ms=cuda_ms(library, 5) if library else None,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops, bytes=nbytes)
    lib_txt = f", library {row['library_ms']:.4f} ms" if library else ""
    log(f"{name} {row['dtype']} {tuple(x.shape)} "
        f"{results_row}: kernel {row['ms']:.4f} ms ({timed_by}), plain "
        f"{row['plain_ms']:.4f} ms{lib_txt}, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), max|d| {diff:.3e} rel {rel:.3e} ring {ring_rel:.3e} [{card}]")
    if elementwise_ulp is not None:
        ok = (d <= ref.float().abs() * elementwise_ulp + 1e-6).all().item()
        assert ok, f"{name}: more than one ulp from plain"
    else:
        assert rel <= tol and ring_rel <= tol, f"{name} disagrees with plain: {rel}, ring {ring_rel}"
    return row


def phase_layernorm_kernel(results, card):
    import torch
    import torch.nn.functional as F

    from rethink_acoustic_image_enhancement_tpu_torch.ops import layernorm as pln

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((1, 512, 512, 96), (1, 256, 256, 192)):
            for bias_free in (True, False):
                rng = np.random.default_rng(len(rows))
                c = shape[-1]
                x = seeded(rng, *shape, scale=2.0, shift=0.5).to(dtype)
                w, b = seeded(rng, c, scale=0.2, shift=1.0), seeded(rng, c, scale=0.5)
                n = x.numel()
                library = None
                if not bias_free:  # F.layer_norm is the WithBias variant
                    wl, bl = w.to(dtype), b.to(dtype)
                    library = lambda: F.layer_norm(x, (c,), wl, bl, 1e-5)
                rows.append(held_to_plain(
                    "layernorm", lambda: pln.fused_channel_layernorm(x, w, b, bias_free),
                    lambda: pln.layernorm_plain(x, w, b, bias_free), x,
                    8 * n, 2 * n * x.element_size() + 8 * c, PEAK_FP32_FLOPS, card,
                    dict(bias_free=bias_free), library=library, plain_reps=5,
                    elementwise_ulp=2.0 ** -7 if dtype == torch.bfloat16 else None,
                    tol=1e-5))
    results["layernorm_cases"] = rows
    return rows


def gdfn_work(b, h, w, c, f, esize):
    """(flops, bytes) of LN+GDFN: the two products and the depthwise 3x3 per
    pixel; x read once, out written once, weights once."""
    per_px = 2 * c * 2 * f + 2 * 9 * 2 * f + 2 * f * c
    return (per_px * b * h * w,
            2 * b * h * w * c * esize + 2 * (2 * c * f + f * c) + 4 * (18 * f + 2 * c))


def phase_gdfn_kernel(results, card):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((1, 512, 512, 96), (2, 256, 256, 192), (1, 64, 64, 384),
                      (1, 52, 44, 96)):
            for bias_free in (True, False):
                rng = np.random.default_rng(100 + len(rows))
                c = shape[-1]
                f = int(c * 2.66)
                x = seeded(rng, *shape).to(dtype)
                args = (seeded(rng, c, scale=0.1, shift=1.0),
                        None if bias_free else seeded(rng, c, scale=0.5),
                        seeded(rng, 1, 1, c, 2 * f, scale=c ** -0.5),
                        seeded(rng, 3, 3, 1, 2 * f, scale=1 / 3),
                        seeded(rng, 1, 1, f, c, scale=f ** -0.5))
                flops, nbytes = gdfn_work(*shape, f, x.element_size())
                rows.append(held_to_plain(
                    "ln_gdfn", lambda: pgdfn.fused_ln_gdfn(x, *args, bias_free=bias_free),
                    lambda: pgdfn.gdfn_plain(x, *args, bias_free=bias_free), x,
                    flops, nbytes, PEAK_BF16_FLOPS, card, dict(bias_free=bias_free)))
    results["gdfn_cases"] = rows
    return rows


def phase_block_kernel(results, card):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

    names = ("ln1_w", "ln1_b", "w_qkv", "dw_qkv", "temperature", "w_proj", "ln2_w",
             "ln2_b", "w_in", "w_dw", "w_out")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape, heads in (((1, 512, 512, 96), 1), ((1, 256, 256, 96), 2),
                             ((1, 64, 64, 48), 2), ((1, 64, 64, 48), 4),
                             ((1, 64, 64, 48), 8)):
            for bias_free in (True, False):
                rng = np.random.default_rng(200 + len(rows))
                c = shape[-1]
                f = int(c * 2.66)
                wts = {k: v[0] for k, v in
                       seeded_stage_weights(rng, 1, c, heads, f, "cuda").items()}
                wts["ln1_b"] = None if bias_free else seeded(rng, c, scale=0.5)
                wts["ln2_b"] = None if bias_free else seeded(rng, c, scale=0.5)
                args = tuple(wts[k] for k in names)
                x = seeded(rng, *shape).to(dtype)
                flops, nbytes = stage_work(*shape, 1, heads, f, x.element_size())
                rows.append(held_to_plain(
                    "block", lambda: pblock.fused_transformer_block(
                        x, *args, bias_free=bias_free, num_heads=heads),
                    lambda: pblock.block_plain(x, *args, bias_free=bias_free, num_heads=heads),
                    x, flops, nbytes, PEAK_BF16_FLOPS, card,
                    dict(heads=heads, bias_free=bias_free)))
                if bias_free and c // heads % 16 == 0:
                    # one BiasFree block is a one-block stage
                    one = pblock.fused_transformer_block(x, *args, num_heads=heads)
                    stage = pstage.fused_transformer_stage(
                        x, **{k: wts[k][None] for k in names if wts[k] is not None})
                    d = (one.float() - stage.float()).abs().max().item()
                    assert torch.equal(one, stage), f"block and one-block stage differ by {d}"
                    rows[-1]["max_abs_diff_to_one_block_stage"] = d
    results["block_cases"] = rows
    return rows



# ------------------------------------------------------------ phase 3 ----

def profile_request(pred, img, rate, wall_ms, card):
    """Device time of one request by kernel (torch.profiler), and the share
    of the request's wall time (an unprofiled run's) the device is busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred(img, rate)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    stage_ms = sum(ms for k, ms in kernels
                   if any(n in k for n in ("k_gram", "k_softmax", "k_apply")))
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, stage_kernels_ms=stage_ms,
               idle_share=1 - busy_ms / wall_ms,
               top=[dict(kernel=k[:120], ms=ms) for k, ms in kernels[:12]])
    log(f"request profile 512x512: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"(idle share {out['idle_share']:.3f}), stage kernels {stage_ms:.2f} ms [{card}]")
    for row in out["top"][:6]:
        log(f"  {row['ms']:8.3f} ms  {row['kernel'][:100]}")
    return out


def sonar_frame(h, w, seed):
    """uint8 RGB speckle-like noise with a fan of exact zeros around it."""
    rng = np.random.default_rng(seed)
    img = (rng.gamma(2.0, 40.0, size=(h, w, 1)).clip(1, 255)
           * np.ones((1, 1, 3))).astype(np.uint8)
    img = np.maximum(img, 1)
    yy, xx = np.mgrid[0:h, 0:w]
    angle = np.abs(np.arctan2(xx - w / 2, yy + 1.0))
    img[(angle > 0.75) | (np.hypot(xx - w / 2, yy) > 0.95 * h)] = 0
    return img


def phase_slice(results, card):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import (
        TransformerStage,
        flagship_teacher,
        init_weights_,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.models import kdlae_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

    model = init_weights_(flagship_teacher(static="train"),
                          torch.Generator().manual_seed(0))
    pred = TeacherPredictor(model, fused=True, dtype=torch.bfloat16)
    frames = [(sonar_frame(512, 512, 0), 1.0), (sonar_frame(512, 512, 1), 0.6),
              (sonar_frame(500, 380, 4), 1.0)]

    # what the gate admits, read off each stage's input shape in the run
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape))) or None)
        for m in pred.model.modules() if isinstance(m, TransformerStage)]

    def predicted(entries):
        return sum(stage_gate.stage_worthwhile(
            b, h, w, m.dim, m.num_heads, m.bias_free_ln, m.use_bias,
            m.ffn_expansion_factor) for m, (b, _, h, w) in entries)

    pred(*frames[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    seen.clear()
    counts = reset_counts()
    outs, lat_ms, want = [], [], 0
    for img, rate in frames:
        n0 = len(seen)
        t0 = time.perf_counter()
        out = pred(img, rate)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        want_i = predicted(seen[n0:])
        want += want_i
        outs.append(out)
        if img.shape[:2] == (512, 512):
            assert want_i == 5, f"gate admits {want_i} stages at 512^2, not 5"
    launches = read_counts(counts)["stage"]
    for h in hooks:
        h.remove()
    log(f"whole-image path: {launches} stage-kernel calls over {len(frames)} requests "
        f"(gate predicts {want})")
    assert launches == want, (launches, want)

    # the same predictor with the plain stage on the card
    plain_model_stage = kdlae_teacher.fused_transformer_stage
    kdlae_teacher.fused_transformer_stage = pstage.stage_plain
    try:
        ref_outs = [pred(img, rate) for img, rate in frames]
    finally:
        kdlae_teacher.fused_transformer_stage = plain_model_stage

    agree = []
    for (img, rate), out, ref in zip(frames, outs, ref_outs):
        h, w = img.shape[:2]
        mask = np.all(img == 0, axis=-1)
        for key, s in (("hq", 1), ("sr", 2)):
            o = out[key]
            assert o.dtype == np.uint8 and o.shape == (h * s, w * s, 3), (key, o.shape)
            m = np.repeat(np.repeat(mask, s, 0), s, 1)
            assert not o[m].any(), f"{key}: zero-mask pixels not 0"
            d = np.abs(o.astype(np.int16) - ref[key].astype(np.int16))
            frac = float((d <= 1).mean())
            agree.append(dict(shape=[h, w], rate=rate, key=key,
                              within_1_level=frac, max_levels=int(d.max())))
            assert frac >= 0.99, f"{key}: only {frac:.4f} of pixels within 1 level"

    # finite float outputs of the fused model
    with torch.inference_mode():
        x = torch.from_numpy(frames[0][0]).cuda().permute(2, 0, 1)[None]
        x = (x.float() / 255).bfloat16()
        o = pred.model({"img": x, "denoise_rate": torch.ones_like(x[:, :1])})
        assert all(torch.isfinite(v).all().item() for v in o.values())

    results.update(main_path_launches=launches, gate_predicted=want,
                   latency_ms=lat_ms, agreement=agree,
                   request_profile=profile_request(pred, *frames[0],
                                                   min(lat_ms[:2]), card))
    for (img, rate), ms in zip(frames, lat_ms):
        log(f"request {img.shape[0]}x{img.shape[1]} rate {rate}: {ms:.2f} ms [{card}]")
    return launches, lat_ms, pred


# ------------------------------------------------------------ phase 4 ----

def level1_blocks(bias_free, fused, seed):
    """The flagship decoder_level1 geometry, 4 x TransformerBlock(96, 1 head),
    seeded like the teacher, a WithBias LayerNorm with non-zero biases."""
    import torch
    from torch import nn

    from rethink_acoustic_image_enhancement_tpu_torch.models import init_weights_
    from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import TransformerBlock

    gen = torch.Generator().manual_seed(seed)
    blocks = init_weights_(nn.Sequential(*[
        TransformerBlock(96, 1, bias_free_ln=bias_free, fused=fused) for _ in range(4)]), gen)
    with torch.no_grad():
        for name, p in blocks.named_parameters():
            if name.endswith("body.bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return blocks.to(device="cuda", dtype=torch.bfloat16).eval()


def ops_path_block(blk, x):
    """One TransformerBlock composed from the public LayerNorm and LN+GDFN
    functions (NHWC), the attention between them eager."""
    from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import flax_block_tree
    from rethink_acoustic_image_enhancement_tpu_torch.ops.gdfn import fused_ln_gdfn
    from rethink_acoustic_image_enhancement_tpu_torch.ops.layernorm import (
        fused_channel_layernorm,
    )

    p = flax_block_tree(blk)
    bias_free = blk.bias_free_ln
    xn = fused_channel_layernorm(x, p["norm1"]["weight"], p["norm1"].get("bias"), bias_free)
    r = x + blk.attn(xn.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return fused_ln_gdfn(r.contiguous(), p["norm2"]["weight"], p["norm2"].get("bias"),
                         p["ffn"]["project_in"]["kernel"], p["ffn"]["dwconv"]["kernel"],
                         p["ffn"]["project_out"]["kernel"], bias_free=bias_free)


def phase_block_paths(results, card):
    """(1, 96, 512, 512) bf16 through 4 blocks: fused=True (block kernel)
    and the LayerNorm + LN+GDFN composition, against the eager blocks
    (fused=False) in float32."""
    import torch

    paths, totals = [], dict(block=0, layernorm=0, gdfn=0)
    for bias_free in (True, False):
        fused = level1_blocks(bias_free, True, seed=3)
        eager = level1_blocks(bias_free, False, seed=3)
        x = seeded(np.random.default_rng(11), 1, 96, 512, 512, scale=0.5).bfloat16()
        with torch.inference_mode():
            # the reference: the same eager blocks in float32 (in bf16 the
            # eager blocks round after every op and are themselves a few
            # bf16 ulps off)
            ref = level1_blocks(bias_free, False, seed=3).float()(x.float())
            fused(x)  # warm-up
            torch.cuda.synchronize()

            counts = reset_counts()
            t0 = time.perf_counter()
            got = fused(x)
            torch.cuda.synchronize()
            block_ms = (time.perf_counter() - t0) * 1e3
            n_block = read_counts(counts)

            counts = reset_counts()
            y = x.permute(0, 2, 3, 1).contiguous()
            for blk in eager:
                y = ops_path_block(blk, y)
            torch.cuda.synchronize()
            n_ops = read_counts(counts)
            via_ops = y.permute(0, 3, 1, 2)
            eager_ms = cuda_ms(lambda: eager(x), 2)
        scale = ref.float().abs().max().item()
        rel_block = (got.float() - ref.float()).abs().max().item() / scale
        rel_ops = (via_ops.float() - ref.float()).abs().max().item() / scale
        row = dict(bias_free=bias_free, block_calls=n_block["block"],
                   layernorm_calls=n_ops["layernorm"], gdfn_calls=n_ops["gdfn"],
                   rel_err_block_path=rel_block, rel_err_ops_path=rel_ops,
                   fused_wall_ms=block_ms, eager_ms=eager_ms)
        paths.append(row)
        log(f"per-block paths (1,96,512,512) bf16 x4 blocks {row} [{card}]")
        assert n_block == dict(stage=0, layernorm=0, gdfn=0, block=4), n_block
        assert n_ops == dict(stage=0, layernorm=4, gdfn=4, block=0), n_ops
        assert torch.isfinite(got).all().item() and torch.isfinite(via_ops).all().item()
        assert rel_block <= TOL_PATH and rel_ops <= TOL_PATH, (rel_block, rel_ops)
        totals["block"] += n_block["block"]
        totals["layernorm"] += n_ops["layernorm"]
        totals["gdfn"] += n_ops["gdfn"]
    results["block_paths"] = paths
    return totals


# ------------------------------------------------------------ phase 5 ----

def phase_tiled(results, card, pred):
    """denoise_tiled at full width: 256x256 tiles and full-width strips, 8
    per call, against the same calls with the plain stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rethink_acoustic_image_enhancement_tpu_torch.models import TransformerStage
    from rethink_acoustic_image_enhancement_tpu_torch.models import kdlae_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

    imgs = [sonar_frame(512, 512, 5), sonar_frame(512, 512, 6), sonar_frame(500, 380, 7)]
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape))) or None)
        for m in pred.model.modules() if isinstance(m, TransformerStage)]
    modes = [dict(tile=256, halo=0, tile_batch=8),
             dict(tile=(256, 512), halo=(8, 0), tile_batch=8)]
    rows, total = [], 0
    for kw in modes:
        pred.denoise_tiled(imgs, 0.8, **kw)  # warm-up: cuDNN plans at this batch
        torch.cuda.synchronize()
        seen.clear()
        counts = reset_counts()
        t0 = time.perf_counter()
        outs = pred.denoise_tiled(imgs, 0.8, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counts(counts)["stage"]
        admitted = [(m, shp) for m, shp in seen if stage_gate.stage_worthwhile(
            shp[0], shp[2], shp[3], m.dim, m.num_heads, m.bias_free_ln, m.use_bias,
            m.ffn_expansion_factor)]
        stage_shapes = sorted({shp for _, shp in admitted})
        chunks = sum(1 for m, _ in seen if m is pred.model.encoder_level1)
        assert launches == len(admitted) > 0, (launches, len(admitted))
        assert all(shp[0] == 8 for shp in stage_shapes), stage_shapes

        plain_model_stage = kdlae_teacher.fused_transformer_stage
        kdlae_teacher.fused_transformer_stage = pstage.stage_plain
        try:
            refs = pred.denoise_tiled(imgs, 0.8, **kw)
        finally:
            kdlae_teacher.fused_transformer_stage = plain_model_stage
        agree = []
        for img, out, ref in zip(imgs, outs, refs):
            h, w = img.shape[:2]
            mask = np.all(img == 0, axis=-1)
            for key, s in (("hq", 1), ("sr", 2)):
                o = out[key]
                assert o.dtype == np.uint8 and o.shape == (h * s, w * s, 3), (key, o.shape)
                m = np.repeat(np.repeat(mask, s, 0), s, 1)
                assert not o[m].any(), f"{key}: zero-mask pixels not 0"
                d = np.abs(o.astype(np.int16) - ref[key].astype(np.int16))
                frac = float((d <= 1).mean())
                agree.append(dict(shape=[h, w], key=key, within_1_level=frac,
                                  max_levels=int(d.max())))
                assert frac >= 0.99, f"{key}: only {frac:.4f} of pixels within 1 level"

        # a call that is exactly one chunk of 8 tiles: wall time, device busy
        # time, idle share (host prep and reassembly included)
        t_h, t_w = (kw["tile"],) * 2 if isinstance(kw["tile"], int) else kw["tile"]
        one_chunk = [sonar_frame(512, 512, 20 + i)
                     for i in range(8 * t_h * t_w // (512 * 512))]
        t0 = time.perf_counter()
        pred.denoise_tiled(one_chunk, 0.8, **kw)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pred.denoise_tiled(one_chunk, 0.8, **kw)
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.self_device_time_total > 0]
        busy_ms = sum(ms for _, ms in kernels)
        stage_ms = sum(ms for k, ms in kernels
                       if any(n in k for n in ("k_gram", "k_softmax", "k_apply")))
        row = dict(kw, images=len(imgs), chunks=chunks, stage_calls=launches,
                   gate_predicted=len(admitted), stage_shapes=[list(t) for t in stage_shapes],
                   wall_s=wall_s, images_per_s=len(imgs) / wall_s, chunk_wall_ms=chunk_ms,
                   chunk_device_busy_ms=busy_ms, chunk_stage_kernels_ms=stage_ms,
                   chunk_idle_share=1 - busy_ms / chunk_ms,
                   chunk_top=[dict(kernel=k[:120], ms=ms) for k, ms in
                              sorted(kernels, key=lambda kv: -kv[1])[:8]],
                   agreement=agree)
        rows.append(row)
        total += launches
        log(f"tiled path {kw}: {len(imgs)} images in {wall_s * 1e3:.1f} ms "
            f"({row['images_per_s']:.2f} images/s), {chunks} chunks, {launches} stage calls "
            f"(gate predicts {len(admitted)}) at {stage_shapes}; one chunk: wall "
            f"{chunk_ms:.2f} ms, device busy {busy_ms:.2f} ms (idle share "
            f"{row['chunk_idle_share']:.3f}), stage kernels {stage_ms:.2f} ms; "
            f"within 1 level of the plain stage: "
            f"{min(a['within_1_level'] for a in agree):.4f} [{card}]")
        for top in row["chunk_top"][:5]:
            log(f"  {top['ms']:8.3f} ms  {top['kernel'][:100]}")
    for h in hooks:
        h.remove()
    results["tiled"] = rows
    return total


# ------------------------------------------------------------ main -------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PORT)):
        print(f"chip_smoke: {PORT}/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"card: {card}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {build_s:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    results = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s}
    stage_rows = phase_kernels(results, card)
    ln_rows = phase_layernorm_kernel(results, card)
    gdfn_rows = phase_gdfn_kernel(results, card)
    block_rows = phase_block_kernel(results, card)
    whole_launches, lat_ms, pred = phase_slice(results, card)
    path_launches = phase_block_paths(results, card)
    tiled_launches = phase_tiled(results, card, pred)
    results["path_launches"] = dict(whole_image=whole_launches, tiled=tiled_launches,
                                    **path_launches)

    def entry(name, source, replaces, launches, rows, main_row):
        assert launches > 0, f"{name}: no launch on a driven path"
        return {"name": name, "route": "cuda", "source": f"{PORT}/csrc/{source}",
                "replaces": f"{PALLAS}/{replaces}", "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row.get("library_ms")}

    # each kernel's row at (1, 512, 512, 96) bf16: decoder_level1's shape
    # (4 blocks for the stage, WithBias for the LayerNorm, which has the
    # library call)
    kernels = {"kernels": [
        entry("fused_transformer_stage", "stage.cu", "stage.py:324",
              whole_launches + tiled_launches, stage_rows, stage_rows[0]),
        entry("fused_channel_layernorm", "layernorm.cu", "layernorm.py:58",
              path_launches["layernorm"], ln_rows, ln_rows[1]),
        entry("fused_ln_gdfn", "gdfn.cu", "gdfn.py:277",
              path_launches["gdfn"], gdfn_rows, gdfn_rows[0]),
        entry("fused_transformer_block", "stage.cu", "block.py:338",
              path_launches["block"], block_rows, block_rows[0]),
    ]}
    results["kernels"] = kernels["kernels"]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)

    print(json.dumps(kernels))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
