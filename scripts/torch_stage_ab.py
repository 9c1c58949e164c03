#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's stage kernel in one or more checkouts, in
turns on one GPU.

    python3 scripts/torch_stage_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each argument is a checkout (or an unpacked ``git archive``) that holds the
port's package; "." is this one. Each runs in a process of its own, in the
order given, so two versions of the kernels are compared inside one call on
one card: it builds that checkout's ``csrc/*.cu``, checks the stage kernel
against ``stage_plain``, times ``fused_transformer_stage`` at the four
shapes of PERF.md's stage table (bf16, CUDA events over 5 calls), takes the
device time of each kernel of one 4-block call at (1,512,512,96) with
``torch.profiler`` and, where the checkout has ``ops/phase_clocks.py``, the
cycles per phase inside a tile at (1,512,512,96) and (8,256,256,96). The
sha256 of each shape's output bytes says whether two checkouts' kernels give
the same bits. One JSON line per checkout; all of them go to
``chiprun_out/stage_ab.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

PORT = "rethink_acoustic_image_enhancement_tpu_torch"
CASES = [((1, 512, 512, 96), 4, 1), ((1, 256, 256, 96), 6, 2),
         ((2, 256, 256, 96), 2, 2), ((8, 256, 256, 96), 4, 1)]


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
        wts = weights(rng, n, 96, heads, 255, "cuda")
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
        if shape == CASES[0][0]:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pstage.fused_transformer_stage(x, **wts)
                torch.cuda.synchronize()
            out["kernel_us"] = {
                name: sum(e.device_time_total for e in prof.key_averages() if name in e.key)
                for name in ("k_gram", "k_softmax", "k_apply")}
        if shape[0] in (1, 8) and n == 4 and os.path.exists(
                os.path.join(root, PORT, "ops", "phase_clocks.py")):
            clocks = importlib.import_module(f"{PORT}.ops.phase_clocks")
            out.setdefault("phases", {})[key] = clocks.block_phase_shares(x, **wts)
    if hasattr(build, "kernel_resources"):
        out["ptxas"] = build.kernel_resources("stage")
    return out


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
