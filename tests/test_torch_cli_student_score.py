"""The port's ``infer-student`` and ``score`` (``--device cpu``) against the
JAX package's CLI on the same files, with the trained zoo weights (the
port's ``artifacts/torch_zoo/*.pth``, the JAX CLI's orbax directories):
student frames within 1 level, the score CSV with the same rows and columns
and values within 1e-5. A zoo alias whose ``.pth`` is not committed exits
with the export script's name."""

import csv
import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.cli import main as jax_main
from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import (
    imread_gray,
    imwrite,
    list_images,
)

torch.set_num_threads(2)
pytest.importorskip("cv2")
pytest.importorskip("orbax.checkpoint")


def _speckle(shape, seed):
    return np.random.default_rng(seed).gamma(2.0, 40.0, shape).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("alias", ["student-us", "student-fls"])
def test_infer_student_matches_the_jax_cli(tmp_path, alias):
    frames = tmp_path / "frames"
    base = _speckle((64, 64), 0).astype(np.float32)
    for i in range(9):  # two stacks of 7, the second overlapping backwards
        f = 0.7 * base + 0.3 * _speckle((64, 64), i + 1)
        imwrite(str(frames / f"{i:03d}.png"), f.astype(np.uint8), rgb=False)
    args = ["infer-student", "--weights", alias, "--input", str(frames), "--all"]
    assert jax_main(args + ["--output", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want, got = list_images(str(tmp_path / "jax")), list_images(str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 9
    for g, w in zip(got, want):
        d = np.abs(np.rint(imread_gray(g) * 255) - np.rint(imread_gray(w) * 255))
        assert d.max() <= 1, (g, d.max())


def _read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def test_score_matches_the_jax_cli(tmp_path):
    lq = tmp_path / "lq"
    methods = []
    for i in range(3):
        img = _speckle((64, 64, 3), 10 + i)
        imwrite(str(lq / f"p{i}.png"), img)
        for m, shift in (("soft", 2), ("hard", 4)):
            imwrite(str(tmp_path / m / f"p{i}.png"), img // shift + 20)
    methods = [f"{m}={tmp_path / m}" for m in ("soft", "hard")]
    args = ["score", "--lq-dir", str(lq), "--methods", *methods]
    assert jax_main(args + ["--csv", str(tmp_path / "jax.csv")]) == 0
    assert cli.main(args + ["--csv", str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
    want, got = _read_csv(tmp_path / "jax.csv"), _read_csv(tmp_path / "port.csv")
    assert len(got) == len(want) > 1
    assert got[0] == want[0]  # the header: the same columns
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0]  # the same rows
        np.testing.assert_allclose(np.float64(g[1:]), np.float64(w[1:]), rtol=0, atol=1e-5)


def test_score_without_a_checkpoint_exits_2(tmp_path, capsys):
    rc = cli.main(["score", "--weights", str(tmp_path / "none.pth"), "--lq-dir",
                   str(tmp_path), "--methods", f"a={tmp_path}", "--device", "cpu"])
    assert rc == 2
    assert "checkpoint not found" in capsys.readouterr().err


def test_uncommitted_zoo_alias_names_the_export_script(tmp_path, monkeypatch):
    """An alias whose .pth and orbax directory are both absent exits; with
    its orbax directory present it loads (tests/test_torch_orbax.py)."""
    pth, _, rate = cli._ZOO["teacher-l2dice"]
    monkeypatch.setitem(cli._ZOO, "teacher-l2dice", (pth, str(tmp_path / "none"), rate))
    with pytest.raises(SystemExit) as err:
        cli.main(["infer-teacher", "--weights", "teacher-l2dice", "--input",
                  str(tmp_path), "--output", str(tmp_path / "o"), "--device", "cpu"])
    msg = str(err.value.code)
    assert "scripts/export_torch_zoo.py --only teacher-l2dice" in msg, msg
