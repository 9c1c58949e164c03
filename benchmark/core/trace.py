"""The traced window, read back from the profiler's Chrome trace.

``read`` gives the records a per-layer metric reads: every complete event
of the trace as the profiler wrote it (host operators and ranges, runtime
calls, kernels, copies with their ``bytes``, fills; the program's own
spans, where it has them) and the window's bounds. The window is the host
range named ``window`` that the harness opens around the traced items.
``summary`` works out, once a trace, what the harness and the readers of
``core/readers.py`` share. Within the window:
  * the device's busy time: the union of every kernel, copy and fill;
  * each kernel with the benchmark span that launched it: a kernel's
    ``correlation`` names its launch on a host thread, and the span is the
    ``stage|...`` range on that thread that holds the launch;
  * the breakdown: the device operations that took most time, and the idle
    gaps between device operations summed by what the thread that launched
    the next operation was doing (its outermost benchmark span and its
    innermost operator).
"""

from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _span_of(spans_by_tid: dict, tid, ts: float):
    """The span name on thread ``tid`` holding time ``ts`` (spans of one
    thread do not overlap)."""
    starts, spans = spans_by_tid.get(tid, ([], []))
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and ts <= spans[i]["ts"] + spans[i]["dur"]:
        return spans[i]["name"]
    return None


def _host_labels(host_by_tid: dict, queries: dict) -> dict:
    """For each thread's list of (time, key) queries, the label of what the
    thread was doing then: its outermost span (``window`` aside, cut at
    '|') and its innermost operator."""
    labels = {}
    for tid, qs in queries.items():
        events = host_by_tid.get(tid, [])
        active: list[tuple[float, int, dict]] = []  # (end, order, event)
        i = 0
        for t, key in sorted(qs, key=lambda q: q[0]):
            while i < len(events) and events[i]["ts"] <= t:
                e = events[i]
                heapq.heappush(active, (e["ts"] + e["dur"], i, e))
                i += 1
            while active and active[0][0] < t:
                heapq.heappop(active)
            live = sorted((e for _, _, e in active), key=lambda e: e["ts"])
            spans = [e["name"].split("|")[0] for e in live
                     if e.get("cat") == "user_annotation" and e["name"] != "window"]
            ops = [e["name"] for e in live if e.get("cat") == "cpu_op"]
            labels[key] = f"{spans[0] if spans else '-'}:{ops[-1] if ops else 'python'}"
    return labels


def read(path: str) -> dict:
    """{events, t0, t1, window_s}: the trace's complete events ('X', with a
    duration; times in us) and the window's start, end and length (s)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("dur") is not None]
    windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "window"]
    if not windows:
        raise ValueError(f"{path}: no 'window' range in the trace")
    win = max(windows, key=lambda e: e["dur"])
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    return {"events": events, "t0": t0, "t1": t1, "window_s": (t1 - t0) / 1e6}


def in_window(rec: dict, cats) -> list[dict]:
    """The events of the categories ``cats`` that start inside the window,
    by start time."""
    t0, t1 = rec["t0"], rec["t1"]
    return sorted((e for e in rec["events"] if e.get("cat") in cats and t0 <= e["ts"] < t1),
                  key=lambda e: e["ts"])


def summary(rec: dict) -> dict:
    """{busy_s, kernels, unmatched, n_device_ops, stage_spans, breakdown} of
    a trace's records, worked out once and kept with them."""
    if "_summary" not in rec:
        rec["_summary"] = _summarize(rec)
    return rec["_summary"]


def _summarize(rec: dict) -> dict:
    events, t0, t1 = rec["events"], rec["t0"], rec["t1"]
    device = in_window(rec, DEVICE_CATS)
    launches = {(e.get("args") or {}).get("correlation"): e for e in events
                if e.get("cat") in LAUNCH_CATS}
    spans_by_tid: dict = defaultdict(list)
    host_by_tid: dict = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("stage|"):
            spans_by_tid[e["tid"]].append(e)
        if e.get("cat") in ("cpu_op", "user_annotation"):
            host_by_tid[e["tid"]].append(e)
    for v in spans_by_tid.values():
        v.sort(key=lambda s: s["ts"])
    spans_by_tid = {t: ([s["ts"] for s in v], v) for t, v in spans_by_tid.items()}
    for v in host_by_tid.values():
        v.sort(key=lambda e: e["ts"])

    kernels, unmatched, launch_of = [], 0, {}
    for k, e in enumerate(device):
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            launch_of[k] = launch
        if e.get("cat") != "kernel":
            continue
        if launch is None:
            unmatched += 1
            span = None
        else:
            span = _span_of(spans_by_tid, launch["tid"], launch["ts"])
        kernels.append((e["name"], e["dur"] / 1e6, span))

    busy = _union([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in device])
    busy_s = sum(b - a for a, b in busy) / 1e6

    # idle gaps, each named by the host activity of the next operation's launcher
    gaps, queries = [], defaultdict(list)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    next_op = 0
    for g, (a, b) in enumerate(zip(edges[0::2], edges[1::2])):
        if b <= a:
            continue
        while next_op < len(device) and device[next_op]["ts"] < b:
            next_op += 1
        launch = launch_of.get(next_op)
        gaps.append((g, (b - a) / 1e6))
        if launch is not None:
            queries[launch["tid"]].append(((a + b) / 2, g))
    labels = _host_labels(host_by_tid, queries)
    idle = defaultdict(float)
    for g, dur in gaps:
        idle[labels.get(g, "-:no launch")] += dur

    ops = defaultdict(float)
    for e in device:
        ops[e["name"]] += e["dur"] / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "kernels": kernels,
            "unmatched": unmatched, "n_device_ops": len(device),
            "stage_spans": [s["name"] for _, v in spans_by_tid.values() for s in v
                            if t0 <= s["ts"] < t1],
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in
                                        sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}}
