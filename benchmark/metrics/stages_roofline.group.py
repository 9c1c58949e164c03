"""Percent of their roofline: every Transformer stage call's least time over its kernels' device time, traced."""

from benchmark.core.readers import stages_roofline as read  # noqa: F401
