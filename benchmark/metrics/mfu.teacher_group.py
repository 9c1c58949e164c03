"""Percent of the card's bf16 peak: the reference's FLOPs of the images served over the window."""

from benchmark.core.readers import mfu as read  # noqa: F401
