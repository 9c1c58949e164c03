"""Percent of the card's fp32 peak: the reference's forward and backward FLOPs of the steps over the window."""

from benchmark.core.readers import mfu as read  # noqa: F401
