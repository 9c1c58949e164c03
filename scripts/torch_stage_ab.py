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
(1,256,256,384) x8 latent of a 2048^2 frame) and the host's time to issue
one call (median of 7, the card idle before each), takes the device time of each
kernel of one call at every shape with ``torch.profiler`` and, where the
checkout has ``ops/phase_clocks.py``, the cycles per phase inside a tile at
(1,512,512,96), (8,256,256,96) and the three wider shapes. The sha256 of each shape's output bytes
says whether two checkouts' kernels give the same bits. Last, one 2048^2
bf16 request of the seeded flagship teacher (``TeacherPredictor(fused=True)``
on one device): its wall time, the device time of each stage call by
width (CUDA events around the stage), and a profile (device busy, idle
share, the top kernels). Then the model-shard forms on cuda:0: the LN+GDFN
kernel (``fused_ln_gdfn``) at (1,512,512,96) bf16 and its part on 128 of 255
hidden channels (fp32 r, shard 0 of 2), each timed over 20 calls with the
kernel's own device time; the stage on 2 model shards at chip_smoke.py's
TENSOR_CASES (CUDA events over 5 calls, the kernels of one call, and the
two fp32 sums across shards a block timed apart with CUDA events around
``sum_across``); and a 512^2 request of the trained bf16 teacher on 2
shards (wall, device busy). ``--no-request`` leaves out the 2048^2 request.
One JSON line per checkout; all of them go to ``chiprun_out/stage_ab.json``.
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
SHARD_CASES = [((1, 512, 512, 96), 4, 1), ((1, 512, 512, 96), 4, 2),
               ((1, 256, 256, 384), 2, 8)]  # chip_smoke.py's TENSOR_CASES
SHARD_SIDE = 512
TEACHER_PTH = os.path.join("artifacts", "torch_zoo", "teacher.pth")


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


def one(root: str, with_request: bool = True) -> dict:
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
        out.setdefault("host_ms", {})[key] = host_ms(
            lambda: pstage.fused_transformer_stage(x, **wts), 7)
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
    if with_request:
        out["request"] = request(root)
    out["shards"] = shard_forms(root)
    return out


def host_ms(fn, reps):
    """Median host ms of a call (its launches enqueued, the card idle before
    each): the host's share of a call, apart from the card's."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2]


def events_ms(fn, reps):
    """Device ms a call of fn, CUDA events around reps calls after one."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_us(fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_us(prof)


def rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def shard_forms(root: str) -> dict:
    """The LN+GDFN kernel and its part, the stage on 2 model shards, and the
    trained teacher's 512^2 request on 2 shards (see the module docstring)."""
    import importlib

    import numpy as np
    import torch

    pstage = importlib.import_module(f"{PORT}.ops.stage")
    pgdfn = importlib.import_module(f"{PORT}.ops.gdfn")
    shards_mod = importlib.import_module(f"{PORT}.models.shards")
    tensor = importlib.import_module(f"{PORT}.parallel.tensor")
    out = {}
    rng = np.random.default_rng(18)
    c, f = 96, 255
    wts = weights(rng, 1, c, 2, f, "cuda")
    x = torch.from_numpy(rng.normal(size=(1, SHARD_SIDE, SHARD_SIDE, c)).astype(
        np.float32)).cuda()
    xb = x.bfloat16()
    args = (wts["ln2_w"][0], None, wts["w_in"][0], wts["w_dw"][0], wts["w_out"][0])
    got = pgdfn.fused_ln_gdfn(xb, *args)
    out["gdfn"] = dict(
        shape=[1, SHARD_SIDE, SHARD_SIDE, c],
        ms=events_ms(lambda: pgdfn.fused_ln_gdfn(xb, *args), 20),
        kernel_us=profiled_us(lambda: pgdfn.fused_ln_gdfn(xb, *args)),
        rel_err=rel(got, pgdfn.gdfn_plain(xb, *args)),
        sha256=hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes()).hexdigest())
    sw = shards_mod.shard_stage_weights(wts, 2, 0)
    pargs = (sw["ln2_w"][0], sw["w_in"][0], sw["w_dw"][0], sw["w_out"][0])
    got = pgdfn.fused_ln_gdfn_part(x, *pargs, residual=True)
    out["gdfn_part"] = dict(
        hidden=int(sw["w_out"].shape[-2]),
        ms=events_ms(lambda: pgdfn.fused_ln_gdfn_part(x, *pargs, residual=True), 20),
        host_ms=host_ms(lambda: pgdfn.fused_ln_gdfn_part(x, *pargs, residual=True), 7),
        kernel_us=profiled_us(lambda: pgdfn.fused_ln_gdfn_part(x, *pargs, residual=True)),
        rel_err=rel(got, pgdfn.gdfn_part_plain(x, *pargs, residual=True)))
    del x, xb, got
    out["stage"] = {}
    for shape, n, heads in SHARD_CASES:
        c = shape[-1]
        rng = np.random.default_rng(c + heads)
        wts = weights(rng, n, c, heads, int(2.66 * c), "cuda")
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().bfloat16()
        shards = tensor.LocalShards(["cuda:0"] * 2)
        sw = [shards_mod.shard_stage_weights(wts, 2, j) for j in range(2)]

        def run():
            return pstage.fused_transformer_stage_shards([x, x], sw, shards)

        got = run()
        ref = pstage.stage_plain_shards([x, x], sw, shards)
        whole = pstage.fused_transformer_stage(x, **wts)
        sums, plain_sum = [], shards.sum_across

        def timed_sum(parts):
            s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s_.record()
            res = plain_sum(parts)
            e_.record()
            sums.append((s_, e_))
            return res

        shards.sum_across = timed_sum
        run()
        torch.cuda.synchronize()
        del shards.sum_across
        key = "x".join(map(str, shape)) + f" blocks={n} heads={heads}"
        out["stage"][key] = dict(
            ms=events_ms(run, 5),
            whole_ms=events_ms(lambda: pstage.fused_transformer_stage(x, **wts), 5),
            sum_ms=sum(s_.elapsed_time(e_) for s_, e_ in sums), sums=len(sums),
            kernel_us=profiled_us(run), rel_err=rel(got[0], ref[0]),
            rel_to_whole=rel(got[0], whole), shards_equal=all(torch.equal(g, got[0]) for g in got))
        del x, got, ref, whole
    out["request"] = shard_request()
    return out


def shard_request() -> dict:
    """The trained bf16 teacher (fused) on 2 model shards of cuda:0, one
    SHARD_SIDE^2 request: wall ms of two after a warm-up, a profiled one's
    device busy ms and top kernels."""
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    models = importlib.import_module(f"{PORT}.models")
    infer = importlib.import_module(f"{PORT}.eval.infer")
    mesh = importlib.import_module(f"{PORT}.parallel.mesh")
    weights_mod = importlib.import_module(f"{PORT}.convert.weights")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = weights_mod.load_pth(models.flagship_teacher(static="train"),
                                 os.path.join(here, TEACHER_PTH)).to(torch.bfloat16)
    pred = infer.TeacherPredictor(model, fused=True, dtype=torch.bfloat16,
                                  mesh=mesh.make_mesh(n_model=2, devices=["cuda:0"] * 2))
    img = sonar_frame(SHARD_SIDE, SHARD_SIDE, 30)
    pred(img, 0.8)
    torch.cuda.synchronize()
    wall = []
    for _ in range(2):
        t0 = time.perf_counter()
        pred(img, 0.8)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred(img, 0.8)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                      if e.self_device_time_total > 0), key=lambda kv: -kv[1])
    return dict(side=SHARD_SIDE, shards=2, wall_ms=wall,
                device_busy_ms=sum(ms for _, ms in kernels),
                top=[dict(kernel=k[:100], ms=ms) for k, ms in kernels[:10]])


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
    args = sys.argv[1:]
    with_request = "--no-request" not in args
    args = [a for a in args if a != "--no-request"]
    if len(args) >= 2 and args[0] == "--one":
        print("RESULT " + json.dumps(one(args[1], with_request)), flush=True)
        return 0
    roots = args or ["."]
    rows = []
    for root in roots:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]
                              + ([] if with_request else ["--no-request"]),
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
