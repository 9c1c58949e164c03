"""`raie-torch train-asdqe` on the CPU, then `raie-torch score` on the
weights it wrote (read with strict=True); its refusals. Port only, no JAX:
the trainer itself is held to the JAX package in test_torch_asdqe_train.py."""

import csv

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch import cli
from torch_train_corpus import write_siqa_corpus

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def siqa(tmp_path_factory):
    return write_siqa_corpus(str(tmp_path_factory.mktemp("siqa")), 10, 40, 36, seed=2)


def _argv(siqa, out, *extra):
    return ["train-asdqe", "--lq", siqa["dataroot_lq"], "--gt", siqa["dataroot_gt"],
            "--param", siqa["dataroot_param"], "--out", str(out), "--epochs", "2",
            "--batch-size", "2", "--accum", "3", "--gt-size", "32", *extra]


def test_train_then_score(siqa, tmp_path, capsys, monkeypatch):
    out = tmp_path / "asdqe"
    assert cli.main(_argv(siqa, out, "--device", "cpu")) == 0
    printed = capsys.readouterr().out
    best = float(printed.split("best val MSE:")[1].split()[0])
    assert np.isfinite(best)
    assert sorted(p.name for p in out.iterdir()) == [
        "net_g_0.pth", "net_g_1.pth", "net_g_best.pth"]
    monkeypatch.chdir(tmp_path)
    assert cli.main(["score", "--weights", str(out / "net_g_best.pth"),
                     "--lq-dir", siqa["dataroot_lq"],
                     "--methods", f"mixed={siqa['dataroot_gt']}",
                     "--csv", "scores.csv", "--device", "cpu"]) == 0
    with open(tmp_path / "scores.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0][1:] == ["mixed"] and len(rows) > 2
    assert all(np.isfinite(float(r[1])) for r in rows[1:])


def test_refusals(siqa, tmp_path):
    """Without --param only --device-resident trains (it was refused,
    naming its ROADMAP.md item, before the device corpora were ported)."""
    argv = _argv(siqa, tmp_path / "b", "--device", "cpu")
    i = argv.index("--param")
    assert cli.main(argv[:i] + argv[i + 2:]) == 2
    if not torch.cuda.is_available():  # the default device needs a GPU
        for extra in ((), ("--device-resident",)):
            with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
                cli.main(_argv(siqa, tmp_path / "c", *extra))
        assert not (tmp_path / "c").exists()
