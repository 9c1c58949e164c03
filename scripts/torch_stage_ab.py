#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's stage kernel in one or more checkouts, in
turns on one GPU.

    python3 scripts/torch_stage_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each argument is a checkout (or an unpacked ``git archive``) that holds the
port's package; "." is this one. Each runs in a process of its own, in the
order given, so two versions of the kernels are compared inside one call on
one card: it builds that checkout's ``csrc/*.cu``, checks the stage kernel
against ``stage_plain``, times ``fused_transformer_stage`` at the seven
shapes of PERF.md's stage table (bf16, CUDA events over 5 calls: the four
at C = 96 and the teacher's deeper stages, (1,256,256,192) and
(1,512,512,192) x6 with 4 heads at 1024^2 and 2048^2 frames and the
(1,256,256,384) x8 latent of a 2048^2 frame), takes the device time of each
kernel of one call at every shape with ``torch.profiler`` and, where the
checkout has ``ops/phase_clocks.py``, the cycles per phase inside a tile at
(1,512,512,96), (8,256,256,96) and the three wider shapes. The sha256 of each shape's output bytes
says whether two checkouts' kernels give the same bits. Last, one 2048^2
bf16 request of the seeded flagship teacher (``TeacherPredictor(fused=True)``
on one device): its wall time, the device time of each stage call by
width (CUDA events around the stage), and a profile (device busy, idle
share, the top kernels). One JSON line per checkout; all of them go to
``chiprun_out/stage_ab.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

PORT = "rethink_acoustic_image_enhancement_tpu_torch"
CASES = [((1, 512, 512, 96), 4, 1), ((1, 256, 256, 96), 6, 2),
         ((2, 256, 256, 96), 2, 2), ((8, 256, 256, 96), 4, 1),
         ((1, 256, 256, 192), 6, 4), ((1, 512, 512, 192), 6, 4), ((1, 256, 256, 384), 8, 8)]
REQUEST_SIDE = 2048


def weights(rng, n, c, heads, f, device):
    import numpy as np
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


def one(root: str) -> dict:
    import importlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.abspath(root))
    pstage = importlib.import_module(f"{PORT}.ops.stage")
    build = importlib.import_module(f"{PORT}.ops._build")
    build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = dict(root=root, card=card, stage_ms={}, rel_err={}, sha256={})
    for shape, n, heads in CASES:
        rng = np.random.default_rng(n)
        c = shape[-1]
        wts = weights(rng, n, c, heads, int(2.66 * c), "cuda")
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().bfloat16()
        got = pstage.fused_transformer_stage(x, **wts)
        ref = pstage.stage_plain(x, **wts)
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        assert rel <= 1e-2, (shape, rel)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            pstage.fused_transformer_stage(x, **wts)
        end.record()
        torch.cuda.synchronize()
        key = "x".join(map(str, shape)) + f" blocks={n} heads={heads}"
        out["stage_ms"][key] = start.elapsed_time(end) / 5
        out["rel_err"][key] = rel
        out["sha256"][key] = hashlib.sha256(
            got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pstage.fused_transformer_stage(x, **wts)
            torch.cuda.synchronize()
        out.setdefault("kernel_us", {})[key] = kernel_us(prof)
        if (shape[0] in (1, 8) and n == 4 or shape[-1] > 96) and os.path.exists(
                os.path.join(root, PORT, "ops", "phase_clocks.py")):
            clocks = importlib.import_module(f"{PORT}.ops.phase_clocks")
            out.setdefault("phases", {})[key] = clocks.block_phase_shares(x, **wts)
        del got, ref, x
    if hasattr(build, "kernel_resources"):
        out["ptxas"] = {name: build.kernel_resources(name) for name in build.sources()}
    out["request"] = request(root)
    return out


def kernel_us(prof) -> dict:
    """Device microseconds of each kernel (its name up to the template
    arguments) in a profile."""
    us = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"\b(k_[a-z0-9_]+)", e.key)
            name = m.group(1) if m else e.key[:60]
            us[name] = us.get(name, 0.0) + e.device_time_total
    return us


def sonar_frame(h, w, seed):
    """uint8 RGB speckle-like noise with a fan of exact zeros around it
    (chip_smoke.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = (rng.gamma(2.0, 40.0, size=(h, w, 1)).clip(1, 255)
           * np.ones((1, 1, 3))).astype(np.uint8)
    img = np.maximum(img, 1)
    yy, xx = np.mgrid[0:h, 0:w]
    angle = np.abs(np.arctan2(xx - w / 2, yy + 1.0))
    img[(angle > 0.75) | (np.hypot(xx - w / 2, yy) > 0.95 * h)] = 0
    return img


def request(root: str) -> dict:
    """One REQUEST_SIDE^2 bf16 request of the seeded flagship teacher on one
    device: wall ms (two runs after a warm-up), each stage call's device ms
    by (stage, width, blocks), and a profiled run's busy ms, idle share and
    top kernels."""
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    models = importlib.import_module(f"{PORT}.models")
    infer = importlib.import_module(f"{PORT}.eval.infer")
    teacher = importlib.import_module(f"{PORT}.models.kdlae_teacher")
    model = models.init_weights_(models.flagship_teacher(static="train"),
                                 torch.Generator().manual_seed(0))
    pred = infer.TeacherPredictor(model.to(torch.bfloat16), fused=True, dtype=torch.bfloat16)
    img = sonar_frame(REQUEST_SIDE, REQUEST_SIDE, 7)
    pred(img, 1.0)  # warm-up
    torch.cuda.synchronize()
    wall = []
    for _ in range(2):
        t0 = time.perf_counter()
        pred(img, 1.0)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    events = []
    names = {m: n for n, m in pred.model.named_modules() if isinstance(m, teacher.TransformerStage)}

    def before(mod, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append([names[mod], mod.dim, len(mod), tuple(args[0].shape[2:]), ev, None])

    def after(mod, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        next(e for e in reversed(events) if e[0] == names[mod])[5] = ev

    hooks = [m.register_forward_pre_hook(before) for m in names]
    hooks += [m.register_forward_hook(after) for m in names]
    pred(img, 1.0)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    stages = [dict(stage=n, c=c, blocks=nb, hw=list(hw), ms=s.elapsed_time(e))
              for n, c, nb, hw, s, e in events]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred(img, 1.0)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                      if e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    by_width = {}
    for s in stages:
        by_width[str(s["c"])] = by_width.get(str(s["c"]), 0.0) + s["ms"]
    return dict(side=REQUEST_SIDE, wall_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / min(wall), stage_ms_by_width=by_width, stages=stages,
                top=[dict(kernel=k[:100], ms=ms) for k, ms in kernels[:15]])


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print("RESULT " + json.dumps(one(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:] or ["."]
    rows = []
    for root in roots:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-8000:], sep="\n", flush=True)
            return done.returncode
        line = next(l for l in done.stdout.splitlines() if l.startswith("RESULT "))
        rows.append(json.loads(line[len("RESULT "):]))
        print(json.dumps(rows[-1]), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "stage_ab.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
