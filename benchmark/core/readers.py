"""Readers the per-layer metric files bind. Each takes the records of a
traced run and returns a number, or None where it finds nothing to read
(the harness then leaves the metric out of the line).

records:
  window    the untraced window: elapsed_s, units, items, item_s (each
            item's host-clock seconds)
  counters  the program's counters (every integer ``launches`` of a
            loaded module of the program, by name) before and after the
            untraced window: {"before": {...}, "after": {...}}
  flops_per_unit, peak_flops   the reference's FLOPs per unit of work, the
            card's peak in the configuration's type
  trace     the traced window (core/trace.py): ``events`` (every complete
            event of the profiler's trace, as it wrote them), ``t0``, ``t1``
            (the window, us), ``window_s``, ``units`` done in it and
            ``counters`` before and after it. ``summary(trace)`` gives what
            the readers below share (busy time, kernels with their stage
            span, the breakdown); ``in_window(trace, cats)`` the window's
            events of some categories.
"""

from __future__ import annotations

import statistics

from .trace import in_window, summary  # noqa: F401 - helpers for metric files
from .work import stage_bound_s


def item_p50_ms(rec: dict):
    items = rec["window"]["item_s"]
    return statistics.median(items) * 1e3 if items else None


def mfu(rec: dict):
    """Percent of the card's peak: the reference's FLOPs of all the work
    done over the whole untraced window."""
    w = rec["window"]
    if not w["units"] or not rec.get("flops_per_unit"):
        return None
    return 100.0 * rec["flops_per_unit"] * w["units"] / w["elapsed_s"] / rec["peak_flops"]


def _stage_bound_s(spans) -> float:
    total = 0.0
    for name in spans:
        b, h, w, c, heads, n, f, esize = (int(v) for v in name.split("|")[1:])
        total += stage_bound_s(b, h, w, c, n, heads, f, esize)
    return total


def stages_roofline(rec: dict):
    """Percent: the stages' least time (each call's operations or bytes at
    the card's peak, the larger) over the device time of the kernels their
    spans launched."""
    t = rec.get("trace")
    s = summary(t) if t else None
    if not s or not s["stage_spans"]:
        return None
    device_s = sum(d for _, d, span in s["kernels"] if span is not None)
    if device_s <= 0:
        return None
    return 100.0 * _stage_bound_s(s["stage_spans"]) / device_s


def outside_stages_ms(rec: dict):
    """Device milliseconds per unit of work of the kernels no stage span
    launched."""
    t = rec.get("trace")
    s = summary(t) if t else None
    if not s or not t["units"] or not s["stage_spans"]:
        return None
    return 1e3 * sum(d for _, d, span in s["kernels"] if span is None) / t["units"]


def idle_share(rec: dict):
    """Percent of the traced window in which no operation ran on the
    device."""
    t = rec.get("trace")
    busy = summary(t)["busy_s"] if t else 0.0
    if not t or t["window_s"] <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / t["window_s"])
