"""The port's video and face datasets against the JAX package's on seeded
clip fixtures (the five cases of test_video_datasets.py): frame indices
equal, every item equal for the same seed, epoch and index."""

import os

import numpy as np
import pytest

from rethink_acoustic_image_enhancement_tpu.data import datasets as jds
from rethink_acoustic_image_enhancement_tpu.data.video_datasets import (
    generate_frame_indices as jax_indices,
)
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from rethink_acoustic_image_enhancement_tpu_torch.data.video_datasets import (
    generate_frame_indices,
)
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite


def _make_clips(root, n_clips=2, n_frames=12, lq_hw=(16, 20), scale=2):
    gh, gw = lq_hw[0] * scale, lq_hw[1] * scale
    for c in range(n_clips):
        clip = f"{c:03d}"
        os.makedirs(root / "lq" / clip, exist_ok=True)
        os.makedirs(root / "gt" / clip, exist_ok=True)
        for i in range(n_frames):
            rng = np.random.default_rng(c * 100 + i)
            imwrite(str(root / "lq" / clip / f"{i:08d}.png"),
                    (rng.random((*lq_hw, 3)) * 255).astype(np.uint8))
            imwrite(str(root / "gt" / clip / f"{i:08d}.png"),
                    (rng.random((gh, gw, 3)) * 255).astype(np.uint8))


def _items_equal(opt, epochs=(0, 1)):
    port, ref = tds.create_dataset(dict(opt)), jds.create_dataset(dict(opt))
    assert len(port) == len(ref)
    for epoch in epochs:
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(port)):
            a, b = port[i], ref[i]
            assert set(a) == set(b)
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k]
    return port


@pytest.mark.parametrize("padding", ["replicate", "reflection", "reflection_circle", "circle"])
def test_generate_frame_indices_matches_jax(padding):
    for center in range(10):
        for num in (3, 5, 7):
            assert generate_frame_indices(center, 9, num, padding) == \
                jax_indices(center, 9, num, padding)
    assert generate_frame_indices(0, 9, 5, "reflection") == [2, 1, 0, 1, 2]


@pytest.mark.parametrize("reverse,intervals", [(True, [1]), (False, [1, 2])])
def test_reds_items_match_jax(tmp_path, reverse, intervals):
    _make_clips(tmp_path, n_frames=12)
    port = _items_equal({
        "type": "REDSDataset", "dataroot_gt": str(tmp_path / "gt"),
        "dataroot_lq": str(tmp_path / "lq"), "num_frame": 5,
        "interval_list": intervals, "random_reverse": reverse,
        "frames_per_clip": 12, "scale": 2, "gt_size": 16, "seed": 0})
    assert len(port) == 24
    assert port[3]["lq"].shape == (5, 8, 8, 3) and port[3]["gt"].shape == (16, 16, 3)


def test_vimeo90k_items_match_jax(tmp_path):
    for key in ["00001/0001", "00001/0002"]:
        os.makedirs(tmp_path / "lq" / key, exist_ok=True)
        os.makedirs(tmp_path / "gt" / key, exist_ok=True)
        for i in range(1, 8):
            rng = np.random.default_rng(i + 10 * int(key[-1]))
            imwrite(str(tmp_path / "lq" / key / f"im{i}.png"),
                    (rng.random((12, 16, 3)) * 255).astype(np.uint8))
            imwrite(str(tmp_path / "gt" / key / f"im{i}.png"),
                    (rng.random((24, 32, 3)) * 255).astype(np.uint8))
    meta = tmp_path / "meta.txt"
    meta.write_text("00001/0001 7 (256,448,3)\n00001/0002 7 (256,448,3)\n")
    port = _items_equal({
        "type": "Vimeo90KDataset", "dataroot_gt": str(tmp_path / "gt"),
        "dataroot_lq": str(tmp_path / "lq"), "meta_info_file": str(meta),
        "num_frame": 7, "random_reverse": True, "scale": 2, "gt_size": 16, "seed": 0})
    s = port[0]
    assert s["lq"].shape == (7, 8, 8, 3) and s["gt"].shape == (16, 16, 3)
    assert s["key"] == "00001/0001"


@pytest.mark.parametrize("padding", ["reflection", "replicate"])
def test_video_test_items_match_jax(tmp_path, padding):
    _make_clips(tmp_path, n_clips=1, n_frames=6, scale=1, lq_hw=(16, 20))
    port = _items_equal({
        "type": "VideoTestDataset", "dataroot_gt": str(tmp_path / "gt"),
        "dataroot_lq": str(tmp_path / "lq"), "num_frame": 5, "padding": padding})
    assert len(port) == 6
    assert port[0]["lq"].shape == (5, 16, 20, 3)
    assert (port[0]["border"], port[3]["border"]) == (1, 0)


@pytest.mark.parametrize("mean_std", [True, False])
def test_ffhq_items_match_jax(tmp_path, mean_std):
    os.makedirs(tmp_path / "gt")
    for i in range(3):
        imwrite(str(tmp_path / "gt" / f"{i:08d}.png"),
                (np.random.default_rng(i).random((16, 16, 3)) * 255).astype(np.uint8))
    opt = {"type": "FFHQDataset", "dataroot_gt": str(tmp_path / "gt"), "use_hflip": True}
    if mean_std:
        opt.update(mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5])
    port = _items_equal(opt)
    assert port[0]["gt"].shape == (16, 16, 3)
