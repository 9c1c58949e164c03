"""Percent of the traced window in which the device ran nothing."""

from benchmark.core.readers import idle_share as read  # noqa: F401
