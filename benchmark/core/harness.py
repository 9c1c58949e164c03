"""One run of one cell: set-up, the measured window, with ``trace`` a traced
window after it, the check against the plain reference, and the result.

Set-up is everything from the start of the process to the window: imports,
the weights, the inputs, the program's build and warm-up (the loop warms
every shape its traffic uses). The window runs items back to back and
closes at the first item to complete after ``seconds``, once the device has
synchronized. Rates are the units of all the items over the whole window;
a tail is over every item. After the window the loop may run steps of its
own check (``after_window``). The traced window (``trace_items`` items under
the profiler, the benchmark's spans on) feeds the per-layer metrics; the
end-to-end ones come from untraced runs only."""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import cell as cells
from . import trace as trace_reader
from .work import peak_flops

FORBIDDEN = ("jax", "jaxlib", "flax", "rethink_acoustic_image_enhancement_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not load, compared
    whole (the program's own name begins with one of them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def end_to_end(kind: str, win: dict) -> float:
    """An end-to-end metric of the window by its kind: ``rate`` (units over
    the elapsed time) or ``p<q>_ms`` (the q-th percentile of the items'
    host-clock times, numpy's linear interpolation)."""
    if kind == "rate":
        return win["units"] / win["elapsed_s"]
    if kind.startswith("p") and kind.endswith("_ms"):
        return float(np.percentile(np.asarray(win["item_s"]), float(kind[1:-3])) * 1e3)
    raise ValueError(f"unknown end-to-end kind {kind!r}")


def window(mix, seconds: float) -> dict:
    item_s, units = [], 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        units += mix.item()
        b = time.perf_counter()
        item_s.append(b - a)
        if b - t0 >= seconds:
            break
    mix.finish()
    return {"elapsed_s": time.perf_counter() - t0, "units": units, "items": len(item_s),
            "item_s": item_s}


def traced_window(mix, items: int, device: torch.device) -> dict:
    """``items`` items under the profiler, every thread of the process traced
    (the program's pipelines launch from worker threads), the benchmark's
    spans on; the trace's records (core/trace.py) with the units done and
    the program's counters before and after."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    config = _ExperimentalConfig(profile_all_threads=True)
    mix.spans(True)
    try:
        mix.finish()
        before = mix.counters()
        with profile(activities=activities, acc_events=True, experimental_config=config) as prof:
            with record_function("window"):
                units = sum(mix.item() for _ in range(items))
                mix.finish()
        after = mix.counters()
    finally:
        mix.spans(False)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        rec = trace_reader.read(path)
    finally:
        os.remove(path)
    rec["units"] = units
    rec["counters"] = {"before": before, "after": after}
    return rec


def verdict(numbers: dict, limits: dict, failed: int = 0) -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether every one is
    within it (``value <= limit``; a missing or NaN number is not) with no
    item failed."""
    compared = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    correct = failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                                  for c in compared.values())
    return compared, correct


def held(control) -> dict:
    """A control's numbers, or its failure where it crashed (a control
    that gives no number has failed)."""
    try:
        return control()
    except Exception as e:  # noqa: BLE001 - a crashed control reads as not correct
        return {"error": repr(e)[:500]}


def run(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
        root=cells.ROOT, log=None, controls=()):
    """Returns (result, checks): the result's line (its fixed keys)
    and each compared number with its limit. ``controls`` names loop
    methods (``control``, ...) put in the program's place; each one's
    numbers are held to the same limits by the same rule, and go with
    their verdict under the result's ``controls`` (for setting limits; the
    benchmark's runs ask for none)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = cells.resolve(workload, root)
    mix = cells.loop(cell)(cell, seed, device)
    mix.setup()
    mix.finish()
    setup_s = time.perf_counter() - t_start
    before = mix.counters()
    win = window(mix, seconds)
    after = mix.counters()
    per = {k: (v - before.get(k, 0)) / win["units"] for k, v in after.items()
           if v != before.get(k, 0)}
    log(f"{cell.name}: window {win['elapsed_s']:.3f} s, {win['items']} items, "
        f"{win['units']} units; kernel calls per unit {per}")
    mix.after_window()
    traced = traced_window(mix, int(cell.traffic["trace_items"]), device) if trace else None
    if traced is not None:
        s = trace_reader.summary(traced)
        log(f"traced: {traced['units']} units in {traced['window_s']:.3f} s, "
            f"{s['n_device_ops']} device ops, {len(s['stage_spans'])} stage spans, "
            f"{s['unmatched']} kernels without a launch")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted, failed = mix.attempted, mix.failed
    flops = mix.flops_per_unit() if trace else None
    mix.release()
    gc.collect()
    checks = mix.check()
    control_numbers = {name: held(getattr(mix, name)) for name in controls}

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else end_to_end(
                cell.traffic["report"][m["name"]], win)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rec = {"window": win, "counters": {"before": before, "after": after},
               "flops_per_unit": flops, "trace": traced,
               "peak_flops": peak_flops(cell.config["dtype"])}
        for m in cell.per_layer:
            value = cells.reader(cell, m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that a run may not load: {found}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced is not None:
        s = trace_reader.summary(traced)
        dev["busy_s"], dev["window_s"] = s["busy_s"], traced["window_s"]
    compared, correct = verdict(checks, cell.limits, failed)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = trace_reader.summary(traced)["breakdown"]
    if controls:
        result["controls"] = {}
        for name, numbers in control_numbers.items():
            c_checks, c_correct = verdict(numbers, cell.limits)
            result["controls"][name] = {"correct": c_correct, "checks": c_checks,
                                        **({"error": numbers["error"]} if "error" in numbers
                                           else {})}
    result["checks"] = compared
    return result, compared
