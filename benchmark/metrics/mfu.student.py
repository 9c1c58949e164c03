"""Percent of the card's fp32 peak: the reference's FLOPs of the frames served over the window."""

from benchmark.core.readers import mfu as read  # noqa: F401
