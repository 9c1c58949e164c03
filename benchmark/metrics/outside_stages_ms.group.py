"""Device ms per image of the kernels outside the Transformer stage calls, traced."""

from benchmark.core.readers import outside_stages_ms as read  # noqa: F401
