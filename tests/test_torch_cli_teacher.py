"""The port's CLI (``raie-torch --device cpu``) against the JAX package's
``raie`` on the same folder of 64x64 sonar frames, trained ``teacher`` zoo
weights (the port's ``artifacts/torch_zoo/teacher.pth``, the JAX CLI's orbax
directory): ``infer-teacher`` per image and with ``--group-size``, and
``serve --once``; every pixel within 1 level, zero-mask pixels exactly 0.
In the port, group and serve outputs are bit-identical to per-image ones,
and a second ``serve --once`` writes nothing. Without a GPU and without
``--device cpu`` the CLI exits with an error; an orbax directory as
``--weights`` names the export script. Each JAX mode runs once per module
(its compile dominates the time)."""

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

MODES = {  # mode -> extra arguments of both CLIs
    "whole": ["infer-teacher"],
    "group": ["infer-teacher", "--group-size", "2"],
    "serve": ["serve", "--once", "--preflight-timeout", "0"],
}


def _frame(h, w, seed):
    """uint8 RGB speckle with a fan of exact zeros around it."""
    rng = np.random.default_rng(seed)
    img = (rng.gamma(2.0, 40.0, size=(h, w, 1)).clip(1, 255)
           * np.ones((1, 1, 3))).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.abs(np.arctan2(xx - w / 2, yy + 1.0)) > 0.75] = 0
    return img


def _args(mode, src, out):
    io = (["--watch", src] if mode == "serve" else ["--input", src])
    return [*MODES[mode][:1], "--weights", "teacher", *io, "--output", out,
            *MODES[mode][1:]]


def _read(folder):
    return {os.path.basename(p): imread_rgb_ubyte(p) for p in list_images(folder)}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    for i in range(3):
        imwrite(str(root / f"f{i}.png"), _frame(64, 64, 10 + i))
    return str(root)


@pytest.fixture(scope="module")
def jax_out(frames, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax")
    for mode in MODES:
        assert jax_main(_args(mode, frames, str(root / mode))) == 0
    return {mode: _read(str(root / mode)) for mode in MODES}


@pytest.fixture(scope="module")
def port_out(frames, tmp_path_factory):
    root = tmp_path_factory.mktemp("port")
    for mode in MODES:
        assert cli.main(_args(mode, frames, str(root / mode)) + ["--device", "cpu"]) == 0
    return root, {mode: _read(str(root / mode)) for mode in MODES}


@pytest.mark.parametrize("mode", list(MODES))
def test_port_cli_matches_the_jax_cli(frames, jax_out, port_out, mode):
    got, want = port_out[1][mode], jax_out[mode]
    assert sorted(got) == sorted(want) == ["f0.png", "f1.png", "f2.png"]
    inputs = _read(frames)
    for name in want:
        assert got[name].shape == want[name].shape == inputs[name].shape
        d = np.abs(got[name].astype(np.int16) - want[name].astype(np.int16))
        assert d.max() <= 1, (name, int(d.max()))
        assert not got[name][np.all(inputs[name] == 0, axis=-1)].any(), name


@pytest.mark.parametrize("mode", ["group", "serve"])
def test_group_and_serve_are_bit_identical_to_per_image(port_out, mode):
    outs = port_out[1]
    for name, img in outs["whole"].items():
        np.testing.assert_array_equal(outs[mode][name], img, err_msg=name)


def test_second_serve_writes_nothing(frames, port_out, capsys):
    out = port_out[0] / "serve"
    before = {p: os.path.getmtime(p) for p in list_images(str(out))}
    assert cli.main(_args("serve", frames, str(out)) + ["--device", "cpu"]) == 0
    assert "served 0 image(s)" in capsys.readouterr().out
    assert {p: os.path.getmtime(p) for p in list_images(str(out))} == before
    assert sorted(os.listdir(out)) == ["f0.png", "f1.png", "f2.png"]


def test_default_device_without_a_gpu_exits(frames, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in MODES:
        with pytest.raises(SystemExit) as err:
            cli.main(_args(mode, frames, str(tmp_path / mode)))
        assert "no CUDA device" in str(err.value.code), mode
        assert not (tmp_path / mode).exists()


def test_orbax_directory_names_the_export_script(frames, tmp_path):
    """A directory without _METADATA is no orbax checkpoint: the exit names
    what --weights takes (orbax directories load: tests/test_torch_orbax.py)."""
    (tmp_path / "weights").mkdir()
    with pytest.raises(SystemExit) as err:
        cli.main(["infer-teacher", "--weights", str(tmp_path / "weights"), "--input",
                  frames, "--output", str(tmp_path / "o"), "--device", "cpu"])
    assert "not an orbax checkpoint" in str(err.value.code)
    assert "scripts/export_torch_zoo.py" in str(err.value.code)
