"""Percent of the card's bf16 peak: the reference's FLOPs of the requests served over the window."""

from benchmark.core.readers import mfu as read  # noqa: F401
