#!/usr/bin/env python3
"""What one row-band exchange costs between two gloo ranks that share one
card (the layout of ``chip_smoke.py`` phase 17), by route:

  * ``cuda``: ``all_reduce`` of the CUDA slot buffer itself, as
    ``parallel/spatial.py::RankBands`` calls it (gloo stages it through
    pinned host memory);
  * ``host``: the buffer copied to the host, reduced there, copied back;
  * ``cpu``: a host buffer alone (the collective without the card);
  * ``cuda_idle``: ``cuda`` with the other rank's card work absent (each
    rank waits for the other only at the collective).

Each rank runs ``REPS`` exchanges of a teacher block's halo slot buffer (2
bands x 2 edges x one row of (1, 48, 512) floats: 393 KB) and of a partial
Gram slot buffer (2 x (1, 1, 48, 48) floats), after a 1024^2 matmul on the
card between exchanges (some queued device work, as in a step). Prints one
JSON line: ms an exchange by route and size, the card's name and power
limit.

    python3 scripts/gloo_collectives.py          # on one card, ~30 s
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPS = 200
SHAPES = {"halo_393KB": (2, 2, 1, 48, 1, 512), "gram_18KB": (2, 1, 1, 48, 48)}


def rank_main(rank: int, port: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    dev = torch.device("cuda:0")
    a = torch.randn(1024, 1024, device=dev)
    result = {}
    for name, shape in SHAPES.items():
        buf = torch.zeros(shape, device=dev)
        for route in ("cuda", "host", "cpu", "cuda_idle"):
            host = torch.zeros(shape)
            busy = route != "cuda_idle"
            for k in range(REPS + 10):
                if k == 10:
                    torch.cuda.synchronize(dev)
                    dist.barrier()
                    t0 = time.perf_counter()
                if busy:
                    a = (a @ a).clamp_(-1, 1)
                if route in ("cuda", "cuda_idle"):
                    dist.all_reduce(buf)
                elif route == "host":
                    h = buf.cpu()
                    dist.all_reduce(h)
                    buf.copy_(h)
                else:
                    dist.all_reduce(host)
            torch.cuda.synchronize(dev)
            result[f"{route}_{name}_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    dist.barrier()
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(result, fh)
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(os.environ["GLOO_PORT"]), sys.argv[3])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("gloo_collectives: no CUDA device", file=sys.stderr)
        return 2
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chiprun_out",
                       "gloo_collectives.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    env = dict(os.environ, GLOO_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), out],
                              env=env) for r in range(2)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        print(f"gloo_collectives: ranks exited {codes}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    with open(out) as fh:
        result = json.load(fh)
    print(json.dumps({"gloo_collectives": result, "reps": REPS, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
