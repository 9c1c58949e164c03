"""The readings a cell's limits are set from, on the card, in one process:
the program's compared numbers over many seeds (short windows at the
cell's own load and sizes), the control's (the plain reference in the
configuration's lower precision in the program's place) and the planted
faults' on a few of them. One JSON line per run on standard output; each
control's line gives its numbers and its verdict against the cell's
limits (``correct``, which has to come out false).

    python3 -m benchmark.calibrate --workload <name> --seeds 11,12,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 3]

The benchmark's own runs never call this."""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmark.core import cell, harness
    from benchmark.faults import BY_LOOP, FAULTS

    def seeds(s):
        return [int(v) for v in s.split(",") if v]

    c = cell.resolve(args.workload)
    controls = ["control"] + (["control_cudnn_tf32"]
                              if hasattr(cell.loop(c), "control_cudnn_tf32") else [])
    runs = [(s, (), None) for s in seeds(args.seeds)]
    runs += [(s, tuple(controls), None) for s in seeds(args.control_seeds)]
    runs += [(s, (), f) for s in seeds(args.fault_seeds) for f in BY_LOOP[c.traffic["loop"]]]
    for seed, ctl, fault in runs:
        t0 = time.perf_counter()
        try:
            if fault is None:
                res, _ = harness.run(args.workload, seed, args.seconds, False, args.device, t0,
                                     controls=ctl)
            else:
                with FAULTS[fault]():
                    res, _ = harness.run(args.workload, seed, args.seconds, False,
                                         args.device, t0)
            line = {"seed": seed, "fault": fault, "correct": res["correct"],
                    "failed": res["failed"],
                    "checks": {k: v["value"] for k, v in res["checks"].items()},
                    "controls": {
                        name: {"correct": c["correct"],
                               **{k: v["value"] for k, v in c["checks"].items()},
                               **({"error": c["error"]} if "error" in c else {})}
                        for name, c in res.get("controls", {}).items()},
                    "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                    "s": time.perf_counter() - t0}
        except Exception as e:  # noqa: BLE001 - a crashed control or fault reads as failed
            line = {"seed": seed, "fault": fault, "error": repr(e)[:500]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
