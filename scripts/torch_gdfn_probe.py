#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's LN+GDFN kernel in one or more checkouts, in
turns on one GPU.

    python3 scripts/torch_gdfn_probe.py DIR [DIR ...]

Each DIR is a checkout (or an unpacked ``git archive``, or a copy with an
edited kernel source) holding the port's package; "." is this one. Every
DIR's libraries are built first, all at once (one process each), then each
DIR is measured in a process of its own, one after another: the registers
and spill bytes of each instantiation of ``csrc/stage_sm90_wide.cu``'s
kernels (ptxas), ``fused_ln_gdfn`` bf16 BiasFree at (1,512,512,96),
(1,256,256,192) and (1,128,128,384) and ``fused_ln_gdfn_part`` on 128
hidden channels of fp32 r at (1,512,512,96) (the device time of each kernel,
``torch.profiler`` over 5 calls; at (1,512,512,96) also the whole call's,
CUDA events over 20 calls, and the host's time to issue one, median of 7
with the card idle before each; and, where the checkout has
``ops/phase_clocks.py::gdfn_phase_shares``, the cycles per phase of a
tile), the kernels of one whole-image stage call at (1,512,512,192) x6
and (1,256,256,384) x8 (4 and 8 heads), and those of one call of the stage
on 2 and 4 model shards of cuda:0 at (1,512,512,96) x4 with 2 heads (a head
a shard, and every head on each). One JSON line per DIR; all of them go to
``chiprun_out/gdfn_probe.json``.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys

PORT = "rethink_acoustic_image_enhancement_tpu_torch"


def kernel_us(fn, reps=5) -> dict:
    """Device microseconds a call of each kernel (by its k_ name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        m = re.search(r"\b(k_[a-z0-9_]+)", e.key)
        if m and e.device_time_total > 0:
            us[m.group(1)] = us.get(m.group(1), 0.0) + e.device_time_total / reps
    return us


def call_ms(fn) -> dict:
    """A call's ms by CUDA events over 20 calls after one, and the host's ms
    to issue one (median of 7, the card idle before each)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / 20, host_ms=sorted(host)[3])


def spills(build) -> dict:
    """{instantiation: ptxas' spill line} of the wide kernels' library."""
    out, name = {}, None
    for line in build.build_log("stage_sm90_wide").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(k_[a-z_]+)I(.{0,40})", m.group(1))
            name = k.group(1) + k.group(2) if k else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = m.group(0)
    return out


def one(root: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(root))
    build = importlib.import_module(f"{PORT}.ops._build")
    pgdfn = importlib.import_module(f"{PORT}.ops.gdfn")
    pstage = importlib.import_module(f"{PORT}.ops.stage")
    clocks = importlib.import_module(f"{PORT}.ops.phase_clocks")
    build.build_all()
    rng = np.random.default_rng(1)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale + shift).cuda()

    out = dict(root=root, spills=spills(build))
    for c, side in ((96, 512), (192, 256), (384, 128)):
        f = int(2.66 * c)
        args = (t(c, scale=0.1, shift=1.0), None, t(1, 1, c, 2 * f, scale=c ** -0.5),
                t(3, 3, 1, 2 * f, scale=1 / 3), t(1, 1, f, c, scale=f ** -0.5))
        x = t(1, side, side, c).bfloat16()
        got, ref = pgdfn.fused_ln_gdfn(x, *args), pgdfn.gdfn_plain(x, *args)
        row = dict(us=kernel_us(lambda: pgdfn.fused_ln_gdfn(x, *args)),
                   rel=((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item())
        if c == 96:
            row.update(call_ms(lambda: pgdfn.fused_ln_gdfn(x, *args)))
        if hasattr(clocks, "gdfn_phase_shares"):
            row["phases"] = clocks.gdfn_phase_shares(x, *args)
        out[f"gdfn{c}"] = row
    r = t(1, 512, 512, 96)
    part = (t(96, scale=0.1, shift=1.0), t(1, 1, 96, 256, scale=0.1), t(3, 3, 1, 256, scale=1 / 3),
            t(1, 1, 128, 96, scale=0.09))
    out["part96"] = dict(us=kernel_us(lambda: pgdfn.fused_ln_gdfn_part(r, *part)),
                         **call_ms(lambda: pgdfn.fused_ln_gdfn_part(r, *part)))
    if hasattr(clocks, "gdfn_phase_shares"):
        out["part96"]["phases"] = clocks.gdfn_phase_shares(r, part[0], None, *part[1:])
    def stage_weights(n, c, heads):
        f = int(2.66 * c)
        return dict(ln1_w=t(n, c, scale=0.1, shift=1.0),
                    w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
                    dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
                    temperature=t(n, heads, 1, 1, scale=0.2, shift=1.0),
                    w_proj=t(n, 1, 1, c, c, scale=c ** -0.5), ln2_w=t(n, c, scale=0.1, shift=1.0),
                    w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5),
                    w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
                    w_out=t(n, 1, 1, f, c, scale=f ** -0.5))

    for shape, n, heads in (((1, 512, 512, 192), 6, 4), ((1, 256, 256, 384), 8, 8)):
        wts = stage_weights(n, shape[-1], heads)
        x = t(*shape).bfloat16()
        out[f"stage{shape[-1]}"] = kernel_us(lambda: pstage.fused_transformer_stage(x, **wts))
    shards_mod = importlib.import_module(f"{PORT}.models.shards")
    tensor = importlib.import_module(f"{PORT}.parallel.tensor")
    wts = stage_weights(4, 96, 2)
    x = t(1, 512, 512, 96).bfloat16()
    for ns in (2, 4):
        sw = [shards_mod.shard_stage_weights(wts, ns, j) for j in range(ns)]
        shards = tensor.LocalShards(["cuda:0"] * ns)
        out[f"shards96x{ns}"] = kernel_us(
            lambda: pstage.fused_transformer_stage_shards([x] * ns, sw, shards))
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print("RESULT " + json.dumps(one(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:] or ["."]
    builds = [subprocess.Popen([sys.executable, "-c",
                                f"import sys; sys.path.insert(0, {os.path.abspath(r)!r}); "
                                f"from {PORT}.ops import _build; _build.build_all()"])
              for r in roots]
    for proc in builds:
        proc.wait()
    rows = []
    for root in roots:  # measured one after another on the card
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True)
        line = [l for l in done.stdout.splitlines() if l.startswith("RESULT ")]
        if done.returncode != 0 or not line:
            print(done.stdout[-2000:], done.stderr[-4000:], sep="\n", flush=True)
            return done.returncode or 1
        rows.append(json.loads(line[0][len("RESULT "):]))
        print(json.dumps(rows[-1]), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "gdfn_probe.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
