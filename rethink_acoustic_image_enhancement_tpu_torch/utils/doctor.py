"""Deployment diagnostics (``raie-torch doctor`` and ``serve``'s preflight).

``run_doctor`` reports the host and probes the device WITHOUT risking the
calling process: every device interaction runs in a throwaway child process
under a hard timeout, so a card that does not answer yields a diagnosis
("wedged") instead of a hang. The child reports the device's name and count,
the first-call and steady dispatch time of a small matmul with a sync, and
the host -> device and device -> host rates of one pinned buffer.
``--platform cpu`` probes the CPU instead of the GPU. The host side also
reports the data-parallel launch it sees: the world size and rank of the
process group or of the launcher's env, and the backend (NCCL on cards,
gloo on the CPU) that ``parallel.init_distributed`` would take.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

#: exit code of ``doctor`` (and of ``serve``'s preflight) when the device is
#: wedged or unavailable
EXIT_BACKEND_DOWN = 2

_CHILD_FLAG = "--_doctor-child"
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _child_main(bandwidth_mb: float, platform: str = "") -> None:
    """Runs in the throwaway subprocess: the device diagnostic, one JSON
    line on stdout. Anything here may block on a card that does not
    answer; the parent enforces the timeout."""
    import time

    import torch

    cpu = platform == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --platform cpu to probe the CPU)")
    dev = torch.device("cpu" if cpu else "cuda")

    def sync():
        if not cpu:
            torch.cuda.synchronize(dev)

    out: dict = {"platform": "cpu" if cpu else "gpu",
                 "n_devices": 1 if cpu else torch.cuda.device_count()}
    if cpu:
        out["device_kind"] = "cpu"
    else:
        props = torch.cuda.get_device_properties(dev)
        out["device_kind"] = props.name
        limit = getattr(props, "power_limit", None)  # where PyTorch gives it
        if limit is not None:
            out["power_limit_w"] = limit

    x = torch.ones(128, 128, device=dev)
    t0 = time.perf_counter()
    (x @ x).sum().item()
    out["first_call_s"] = round(time.perf_counter() - t0, 3)
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        x @ x
        sync()
    out["dispatch_ms"] = round((time.perf_counter() - t0) / n * 1e3, 3)

    nbytes = int(bandwidth_mb * 1e6)
    host = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=not cpu)
    t0 = time.perf_counter()
    on_dev = host.to(dev, non_blocking=True, copy=True)
    sync()
    h2d_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host.copy_(on_dev, non_blocking=True)
    sync()
    d2h_s = time.perf_counter() - t0
    out["h2d_mbps"] = round(nbytes / 1e6 / h2d_s, 1)
    out["d2h_mbps"] = round(nbytes / 1e6 / d2h_s, 1)
    print(json.dumps(out))


def _child_argv(bandwidth_mb: float, platform: str) -> list[str]:
    return [sys.executable, "-m", f"{__package__}.doctor", _CHILD_FLAG,
            str(bandwidth_mb), platform]


def _probe_backend(probe_timeout: float, bandwidth_mb: float,
                   platform: str = "") -> dict:
    """Run the device diagnostic in a child process under a timeout."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_PACKAGE_PARENT + (
        os.pathsep + path if path else ""))
    try:
        proc = subprocess.run(_child_argv(bandwidth_mb, platform), env=env,
                              capture_output=True, text=True, timeout=probe_timeout)
    except subprocess.TimeoutExpired:
        return {"status": "wedged",
                "detail": f"no answer within {probe_timeout:.0f}s: the device "
                          "did not initialise or answer a small matmul"}
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()
        return {"status": "error",
                "detail": tail[-1] if tail else f"rc={proc.returncode}"}
    try:
        info = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"status": "error", "detail": "unparseable child output"}
    info["status"] = "ok"
    return info


def run_doctor(probe_timeout: float = 120.0, bandwidth_mb: float = 8.0,
               platform: str = "") -> dict:
    """The full report (host facts and the bounded device probe). Never
    blocks past ``probe_timeout``; the host side initialises no device."""
    import torch

    report: dict = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "host_cpus": os.cpu_count(),
        "cuda_visible_devices_env": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
    }
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    report["host_rss_mb"] = int(line.split()[1]) // 1024
    except OSError:
        pass
    report["distributed"] = distributed_report(platform)
    report["backend"] = _probe_backend(probe_timeout, bandwidth_mb, platform)
    return report


def distributed_report(platform: str = "") -> dict:
    """World size, rank and backend: the process group's where there is
    one, else the launcher's env and the backend it would get."""
    import torch

    from .. import parallel

    if parallel.is_initialized():
        return {"world_size": parallel.world_size(), "rank": parallel.rank(),
                "backend": parallel.backend_name(), "initialized": True}
    env = parallel.detect_launch_env()
    cpu = platform == "cpu" or not torch.cuda.is_available()
    return {"world_size": env.get("num_processes", 1), "rank": env.get("process_id", 0),
            "backend": "gloo" if cpu else "nccl", "initialized": False,
            "coordinator": env.get("coordinator_address")}


def format_report(report: dict) -> str:
    lines = [
        f"python {report['python']}  torch {report['torch']}  "
        f"cuda {report['cuda']}  host cpus {report['host_cpus']}"
        + (f"  rss {report['host_rss_mb']} MB" if "host_rss_mb" in report else ""),
    ]
    d = report.get("distributed")
    if d is not None:
        lines.append(f"data parallel: world size {d['world_size']}, rank {d['rank']}, "
                     f"backend {d['backend']}"
                     + ("" if d["initialized"] else " (not initialised)"))
    b = report["backend"]
    if b["status"] == "ok":
        power = (f", power limit {b['power_limit_w']} W"
                 if "power_limit_w" in b else "")
        lines.append(f"device OK: {b['n_devices']}x {b['device_kind']} "
                     f"({b['platform']}{power})")
        lines.append(
            f"  first call {b['first_call_s']} s, steady dispatch "
            f"{b['dispatch_ms']} ms, H2D {b['h2d_mbps']} MB/s, "
            f"D2H {b['d2h_mbps']} MB/s")
    else:
        lines.append(f"device {b['status'].upper()}: {b['detail']}")
    return "\n".join(lines)


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == _CHILD_FLAG:
        _child_main(float(sys.argv[2]) if len(sys.argv) > 2 else 8.0,
                    sys.argv[3] if len(sys.argv) > 3 else "")
    else:
        rep = run_doctor()
        print(format_report(rep))
        sys.exit(0 if rep["backend"]["status"] == "ok" else EXIT_BACKEND_DOWN)
