"""Median host-clock latency of the window's requests, in ms."""

from benchmark.core.readers import item_p50_ms as read  # noqa: F401
