"""Fixtures of the benchmark's tests: a checkout-like directory with the
manifest and the benchmark's files cut to CPU sizes."""

from __future__ import annotations

import pytest

from .tiny import tiny_root


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
