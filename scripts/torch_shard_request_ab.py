#!/usr/bin/env python3
"""Wall time of a tensor-parallel request in two or more checkouts, in
alternating turns on one GPU.

    python3 scripts/torch_shard_request_ab.py PARENT_DIR . PARENT_DIR . . PARENT_DIR

Each argument is a checkout (or an unpacked ``git archive``) holding the
port's package; "." is this one. Every checkout's libraries are built first,
all at once; then each argument, in the order given, is a turn in a process
of its own: the trained bf16 teacher (``artifacts/torch_zoo/teacher.pth``,
fused) on 2 model shards of cuda:0 serves a 512^2 sonar frame twice to warm
up and then REQUESTS times, each request's wall ms (host clock, synchronised)
recorded. One JSON line per turn; all of them go to
``chiprun_out/shard_request_ab.json``.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

PORT = "rethink_acoustic_image_enhancement_tpu_torch"
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUESTS = 8
SIDE = 512


def one(root: str) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    frame = importlib.import_module("torch_stage_ab").sonar_frame
    models = importlib.import_module(f"{PORT}.models")
    infer = importlib.import_module(f"{PORT}.eval.infer")
    mesh = importlib.import_module(f"{PORT}.parallel.mesh")
    weights = importlib.import_module(f"{PORT}.convert.weights")
    model = weights.load_pth(models.flagship_teacher(static="train"),
                             os.path.join(HERE, "artifacts", "torch_zoo", "teacher.pth"))
    pred = infer.TeacherPredictor(model.to(torch.bfloat16), fused=True, dtype=torch.bfloat16,
                                  mesh=mesh.make_mesh(n_model=2, devices=["cuda:0"] * 2))
    img = frame(SIDE, SIDE, 30)
    for _ in range(2):
        pred(img, 0.8)
    torch.cuda.synchronize()
    walls = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        pred(img, 0.8)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return dict(root=root, side=SIDE, shards=2, wall_ms=walls,
                median_ms=sorted(walls)[REQUESTS // 2 - 1:REQUESTS // 2 + 1])


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print("RESULT " + json.dumps(one(sys.argv[2])), flush=True)
        return 0
    turns = sys.argv[1:] or ["."]
    builds = [subprocess.Popen([sys.executable, "-c",
                                f"import sys; sys.path.insert(0, {os.path.abspath(r)!r}); "
                                f"from {PORT}.ops import _build; _build.build_all()"])
              for r in dict.fromkeys(turns)]
    for proc in builds:
        proc.wait()
    rows = []
    for root in turns:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True)
        line = [l for l in done.stdout.splitlines() if l.startswith("RESULT ")]
        if done.returncode != 0 or not line:
            print(done.stdout[-2000:], done.stderr[-4000:], sep="\n", flush=True)
            return done.returncode or 1
        rows.append(json.loads(line[0][len("RESULT "):]))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "shard_request_ab.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
