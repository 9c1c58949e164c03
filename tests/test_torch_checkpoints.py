"""The port's torch-native checkpoints: rotation, the non-strict pretrained
merge, pretrained loads from a port or reference-layout .pth, and the
weights file the CLI serves (CPU)."""

import os

import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAETeacher
from rethink_acoustic_image_enhancement_tpu_torch.train import checkpoints as ckpt

NARROW = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", params="cat")


def _teacher(seed, static="train"):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return KDLAETeacher(**NARROW, static=static)


def test_prune_keeps_the_newest_and_named_weights(tmp_path):
    states, models = tmp_path / "states", tmp_path / "models"
    states.mkdir()
    models.mkdir()
    for it in (2, 4, 6, 8):
        (states / f"ckpt_{it}.pth").write_bytes(b"x")
        (models / f"net_g_{it}.pth").write_bytes(b"x")
    (models / "net_g_best.pth").write_bytes(b"x")
    gone = ckpt.prune_checkpoints(str(states), str(models), keep=2)
    assert len(gone) == 4
    assert sorted(os.listdir(states)) == ["ckpt_6.pth", "ckpt_8.pth"]
    assert sorted(os.listdir(models)) == ["net_g_6.pth", "net_g_8.pth",
                                          "net_g_best.pth"]
    assert ckpt.find_latest_checkpoint(str(states)) == 8
    assert ckpt.prune_checkpoints(str(states), str(models), keep=0) == []
    assert ckpt.find_latest_checkpoint(str(tmp_path / "none")) is None


def test_merge_nonstrict_copies_matches_and_refuses_too_few():
    target = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    source = {"a": torch.ones(2, dtype=torch.float64), "b": torch.ones(4)}
    merged = ckpt.merge_params_nonstrict(target, source, verbose=False)
    assert torch.equal(merged["a"], torch.ones(2)) and merged["a"].dtype == torch.float32
    assert torch.equal(merged["b"], torch.zeros(3))  # shape mismatch: kept
    assert torch.equal(merged["c"], torch.zeros(1))  # absent: kept
    with pytest.raises(ValueError, match="matched only 1 of 3"):
        ckpt.merge_params_nonstrict(target, source, verbose=False, min_matched=2)


def test_pretrained_load_from_a_port_weights_file(tmp_path):
    src = _teacher(1)
    path = ckpt.save_weights(str(tmp_path), 7, src, ema=_teacher(2))
    assert os.path.basename(path) == "net_g_7.pth"
    # strict, either key; the CLI's loader reads the same file
    for key, want in (("params", src), ("params_ema", _teacher(2))):
        got = ckpt.load_pretrained(_teacher(3), path, key)
        for a, b in zip(got.state_dict().values(), want.state_dict().values()):
            assert torch.equal(a, b)
    load_pth(_teacher(3), path)
    # non-strict into a model without the 2x head: the shared entries copy
    plain = ckpt.load_pretrained(_teacher(3, static="test"), path, strict=False)
    sd = src.state_dict()
    for name, v in plain.state_dict().items():
        assert torch.equal(v, sd[name]), name
    with pytest.raises(RuntimeError):  # strict refuses the extra head
        ckpt.load_pretrained(_teacher(3, static="test"), path, strict=True)


def test_pretrained_load_of_a_reference_layout_pth(tmp_path, capsys):
    """A bare {'params_ema': sd} reference file asked for 'params' uses the
    one key it has, with a note; a directory that is no orbax checkpoint is
    refused (orbax directories load: tests/test_torch_orbax.py)."""
    src = _teacher(4)
    path = str(tmp_path / "ref.pth")
    torch.save({"params_ema": {f"module.{k}": v for k, v in
                               src.state_dict().items()}}, path)
    got = ckpt.load_pretrained(_teacher(5), path, "params")
    assert "only 'params_ema'" in capsys.readouterr().out
    for a, b in zip(got.state_dict().values(), src.state_dict().values()):
        assert torch.equal(a, b)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        ckpt.load_pretrained(_teacher(5), str(tmp_path / "orbax"))
