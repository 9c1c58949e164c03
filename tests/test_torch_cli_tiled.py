"""The port's ``infer-teacher --tile`` (a 64x128 frame as 32x32 interiors
with an 8-pixel halo, one call of 8 tiles) and ``--sr`` (a 64x64 frame, the
2x output too) with ``--device cpu`` against the JAX package's CLI on the
same files, trained ``teacher`` zoo weights: every pixel within 1 level,
zero-mask pixels exactly 0."""

import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.cli import main as jax_main
from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import (
    imread_rgb_ubyte,
    imwrite,
    list_images,
)

torch.set_num_threads(2)
pytest.importorskip("cv2")
pytest.importorskip("orbax.checkpoint")

MODES = {  # mode -> (frame shape, extra arguments of both CLIs)
    "tile": ((64, 128), ["--tile", "32", "--tile-halo", "8"]),
    "sr": ((64, 64), ["--sr"]),
}


def _frame(h, w, seed):
    """uint8 RGB speckle with a fan of exact zeros around it."""
    rng = np.random.default_rng(seed)
    img = (rng.gamma(2.0, 40.0, size=(h, w, 1)).clip(1, 255)
           * np.ones((1, 1, 3))).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.abs(np.arctan2(xx - w / 2, yy + 1.0)) > 0.75] = 0
    return img


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiled")
    out = {}
    for mode, (shape, extra) in MODES.items():
        src = root / f"{mode}_in"
        imwrite(str(src / "frame.png"), _frame(*shape, seed=len(out) + 20))
        args = ["infer-teacher", "--weights", "teacher", "--input", str(src), *extra]
        assert jax_main(args + ["--output", str(root / f"{mode}_jax")]) == 0
        assert cli.main(args + ["--output", str(root / f"{mode}_port"),
                                "--device", "cpu"]) == 0
        out[mode] = {side: {os.path.basename(p): imread_rgb_ubyte(p)
                            for p in list_images(str(root / f"{mode}_{side}"))}
                     for side in ("jax", "port")}
        out[mode]["input"] = imread_rgb_ubyte(str(src / "frame.png"))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_port_cli_matches_the_jax_cli(runs, mode):
    got, want, img = runs[mode]["port"], runs[mode]["jax"], runs[mode]["input"]
    names = ["frame.png", "sr_frame.png"] if mode == "sr" else ["frame.png"]
    assert sorted(got) == sorted(want) == names
    mask = np.all(img == 0, axis=-1)
    for name in names:
        scale = 2 if name.startswith("sr_") else 1
        assert got[name].shape == (img.shape[0] * scale, img.shape[1] * scale, 3)
        d = np.abs(got[name].astype(np.int16) - want[name].astype(np.int16))
        assert d.max() <= 1, (name, int(d.max()))
        m = np.repeat(np.repeat(mask, scale, 0), scale, 1)
        assert not got[name][m].any(), name
