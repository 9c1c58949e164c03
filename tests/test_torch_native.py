"""The port's host frame masker (``utils/native.py`` over its own copy of
``csrc/raie_native.cpp``) against the JAX package's ``utils/native.py``,
bit for bit, on both routes: the two C++ libraries (each built by its own
package with g++), and the two numpy fallbacks. Every entry point, at
several seeds, thread counts and shapes."""

import os

import numpy as np
import pytest

from rethink_acoustic_image_enhancement_tpu.utils import native as jnative
from rethink_acoustic_image_enhancement_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ["native", "numpy"]
SEEDS = [0, 7, 2**40 + 3]
THREADS = [1, 3, 0]
SHAPES = [(5, 9), (3, 17, 33), (2, 300, 260)]  # the last spans several threads


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    if request.param == "native":
        assert native.available() and jnative.available()
    else:
        monkeypatch.setattr(native, "load", lambda: None)
        monkeypatch.setattr(jnative, "load", lambda: None)
    return request.param


def _img(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def test_source_is_the_jax_packages_byte_for_byte():
    ours = os.path.join(REPO, "rethink_acoustic_image_enhancement_tpu_torch",
                        "csrc", "raie_native.cpp")
    theirs = os.path.join(REPO, "rethink_acoustic_image_enhancement_tpu",
                          "native", "raie_native.cpp")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert native.lib_path().parent == native.BUILD
    assert native.BUILD == native.SRC.parent.parent.parent / "build"
    assert native.available() and native.lib_path().exists()


def test_input_mask(route):
    for shape in SHAPES:
        for seed in SEEDS:
            for nthreads in THREADS:
                for prob in (0.0, 0.3, 1.5):
                    img = _img(shape, seed + 1)
                    got = native.input_mask(img, prob, 0.1, seed, nthreads)
                    want = jnative.input_mask(img, prob, 0.1, seed, nthreads)
                    assert got.dtype == np.float32 and got.shape == img.shape
                    np.testing.assert_array_equal(got, want)
    # prob 0 keeps everything, on both routes
    np.testing.assert_array_equal(native.input_mask(img, 0.0), img)


def test_mask_frames(route):
    for shape in SHAPES:
        f = shape[0]
        for seed in SEEDS:
            probs = np.random.default_rng(seed).random(f).astype(np.float32)
            probs[0] = 0.0
            for nthreads in THREADS:
                stack = _img(shape, seed + 2)
                got = native.mask_frames(stack, probs, 0.1, seed, nthreads)
                want = jnative.mask_frames(stack, probs, 0.1, seed, nthreads)
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got[0], stack[0])
                assert set(np.unique(got[got != stack])) <= {np.float32(-0.1)}
    with pytest.raises(ValueError, match="probs"):
        native.mask_frames(stack, probs[:-1])


def test_geometric(route):
    for shape in [(5, 9), (17, 33, 1), (30, 26, 3)]:
        img = _img(shape, 3)
        for mode in range(8):
            for nthreads in THREADS:
                got = native.geometric(img, mode, nthreads)
                want = jnative.geometric(img, mode, nthreads)
                assert got.shape == want.shape
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="mode"):
        native.geometric(img, 8)


def test_u8_to_f32(route):
    rng = np.random.default_rng(4)
    for shape in [(7, 5), (33, 17, 3), (300, 260, 3), (9, 4, 4)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for bgr2rgb in (False, True):
            for nthreads in THREADS:
                got = native.u8_to_f32(img, bgr2rgb, nthreads)
                want = jnative.u8_to_f32(img, bgr2rgb, nthreads)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
