"""The port's CLI on an NVIDIA GPU against the same CLI with ``--device cpu``:
``infer-teacher`` (per image and in groups) and ``serve --once`` with the
trained ``teacher`` zoo weights on 128x128 PNGs, and ``infer-student`` with
``student-us``, within 1 level on every pixel; group and serve outputs
bit-identical to per-image ones on the card. Without a GPU, the default
``--device`` exits with an error rather than fall back to the CPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_cli_cuda.py
The card's tests are marked ``cuda`` and skip where there is no GPU."""

import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import (
    imread_gray,
    imread_rgb_ubyte,
    imwrite,
    list_images,
)

RUNS = {  # name -> arguments
    "whole": ["infer-teacher", "--weights", "teacher", "--input", "{src}"],
    "group": ["infer-teacher", "--weights", "teacher", "--input", "{src}",
              "--group-size", "2"],
    "serve": ["serve", "--weights", "teacher", "--watch", "{src}", "--once"],
    "student": ["infer-student", "--weights", "student-us", "--input", "{gray}", "--all"],
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    img = (rng.gamma(2.0, 40.0, size=(h, w, 1)).clip(1, 255)
           * np.ones((1, 1, 3))).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.abs(np.arctan2(xx - w / 2, yy + 1.0)) > 0.75] = 0
    return img


def _inputs(root):
    for i in range(3):
        imwrite(str(root / "src" / f"f{i}.png"), _frame(128, 128, 30 + i))
    for i in range(8):
        imwrite(str(root / "gray" / f"{i:03d}.png"), _frame(128, 128, 40 + i)[:, :, 0],
                rgb=False)
    return {"src": str(root / "src"), "gray": str(root / "gray")}


def _run(name, dirs, out, device):
    args = [a.format(**dirs) for a in RUNS[name]] + ["--output", out]
    assert cli.main(args + ["--device", device]) == 0
    read = imread_gray if name == "student" else imread_rgb_ubyte
    return {os.path.basename(p): read(p) for p in list_images(out)}


@pytest.mark.cuda
def test_cli_on_the_card_matches_the_cpu(cuda, tmp_path):
    dirs = _inputs(tmp_path)
    got = {n: _run(n, dirs, str(tmp_path / f"{n}_cuda"), "cuda") for n in RUNS}
    want = {n: _run(n, dirs, str(tmp_path / f"{n}_cpu"), "cpu") for n in ("whole", "student")}
    for name in ("whole", "student"):
        assert sorted(got[name]) == sorted(want[name]) and got[name], name
        for f in want[name]:
            scale = 255 if name == "student" else 1
            d = np.abs(np.rint(got[name][f] * scale).astype(np.int16)
                       - np.rint(want[name][f] * scale).astype(np.int16))
            assert d.max() <= 1, (name, f, int(d.max()))
    for name in ("group", "serve"):
        for f, img in got["whole"].items():
            np.testing.assert_array_equal(got[name][f], img, err_msg=f"{name} {f}")


def test_default_device_without_a_gpu_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = _inputs(tmp_path)
    for name in RUNS:
        args = [a.format(**dirs) for a in RUNS[name]] + ["--output", str(tmp_path / name)]
        with pytest.raises(SystemExit) as err:
            cli.main(args)
        assert "no CUDA device" in str(err.value.code), name
        assert not (tmp_path / name).exists()
