#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: torch/CUDA versions, the card's name and power limit;
     build every csrc/*.cu for sm_90a (one nvcc each, all at once).
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, in bf16 and fp32, with its time, the
     plain version's time and the bound for the same work.
  3. the slice: the full-width flagship KDLAE-T (seeded random weights)
     served through TeacherPredictor(fused=True, bf16) on synthetic sonar
     frames, with the stage-kernel launch count checked against the gate
     and the uint8 outputs against the same predictor with the plain stage.
Prints a "kernels" JSON line, the card line, and as its last line
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
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 1e-2            # kernel vs plain, max|d| / max|ref|


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
             ((2, 256, 256, c), 2, 2)]
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
    return rows


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
    frames = [(sonar_frame(512, 512, s), r)
              for s, r in ((0, 1.0), (1, 0.6), (2, 1.0), (3, 0.6))]
    frames.append((sonar_frame(500, 380, 4), 1.0))

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
    pstage.fused_transformer_stage.launches = 0
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
    launches = pstage.fused_transformer_stage.launches
    for h in hooks:
        h.remove()
    log(f"main path: {launches} stage-kernel calls over {len(frames)} requests "
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
                                                   min(lat_ms[:4]), card))
    for (img, rate), ms in zip(frames, lat_ms):
        log(f"request {img.shape[0]}x{img.shape[1]} rate {rate}: {ms:.2f} ms [{card}]")
    return launches, lat_ms


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
    rows = phase_kernels(results, card)
    launches, lat_ms = phase_slice(results, card)

    main_row = rows[0]  # bf16, 512x512x96, 4 blocks: decoder_level1's shape
    kernels = {"kernels": [{
        "name": "fused_transformer_stage", "route": "cuda",
        "source": f"{PORT}/csrc/stage.cu",
        "replaces": "rethink_acoustic_image_enhancement_tpu/ops/pallas/stage.py:324",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]}
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
