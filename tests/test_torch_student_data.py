"""The port's PairedMultiImageDataset (Dataset_PairedMutiImage) against the
JAX package's, item for item and bit for bit: training items (centre
padding of mixed frame sizes, the pad to gt_size, the crop, both
corruption branches through the native masker, the degenerate-input guard,
8-way augmentation) over three epochs with per-epoch regrouping, and the
'test1' and 'interpolation' evaluation phases."""

import numpy as np
import pytest

from rethink_acoustic_image_enhancement_tpu.data import datasets as jds
from rethink_acoustic_image_enhancement_tpu.data import loader as jld
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld
from rethink_acoustic_image_enhancement_tpu_torch.utils import native
from torch_train_corpus import write_student_corpus

BLANK = range(1, 10)  # a run of black frames: some groups trip the guard


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return write_student_corpus(str(tmp_path_factory.mktemp("frames")), 20,
                                20, 24, seed=3, blank=BLANK)


def _opt(roots, **kw):
    return {"type": "Dataset_PairedMutiImage", "num_pairs": 5,
            "stride_range": [1, 3], "prob": 0.1, "geometric_augs": True,
            "gt_size": 16, "seed": 11, "phase": "train", "scale": 1, **roots,
            **kw}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("gt_size", [16, 24])
def test_train_items_over_epochs(roots, gt_size, monkeypatch):
    """gt_size 24 is larger than the 20-row frames: pad_to_min_size runs."""
    assert native.available()
    opt = _opt(roots, gt_size=gt_size)
    got, want = tds.create_dataset(opt), jds.create_dataset(opt)
    alternate = (np.arange(5) % 2 == 1) * 0.5 + 0.1
    patterns = []
    mask_frames = native.mask_frames

    def recording(stack, probs, **kw):
        patterns.append(bool(np.allclose(probs, alternate)))
        return mask_frames(stack, probs, **kw)

    monkeypatch.setattr(native, "mask_frames", recording)
    guard = 0
    for epoch in range(3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert got.paths == want.paths and len(got) == len(want)
        for i in range(len(want)):
            a, b = got[i], want[i]
            _same(a, b)
            assert a["lq"].shape == a["gt"].shape == (5, gt_size, gt_size)
            guard += int(a["lq"].min() >= 0)  # add_random_noise clips to [0, 1]
    # both corruption branches ran (interpolation gives the alternate probs)
    assert guard > 0 and any(patterns) and not all(patterns)


@pytest.mark.parametrize("phase", ["test1", "interpolation", "val"])
def test_eval_phases(roots, phase):
    opt = _opt(roots, phase=phase, stride_range=[1, 1], geometric_augs=False)
    got, want = tds.create_dataset(opt), jds.create_dataset(opt)
    assert len(got) == len(want) == 16
    for i in range(len(want)):
        _same(got[i], want[i])
        assert got[i]["lq"].shape == (5, 20, 24)


def test_batches_match_the_jax_loader(roots):
    """Through both BatchLoaders: (B, F, H, W) float32 batches."""
    opt = _opt(roots)
    got = tld.BatchLoader(tds.create_dataset(opt), 3,
                          tld.EnlargedShuffleSampler(16, seed=2), num_workers=2)
    want = jld.BatchLoader(jds.create_dataset(opt), 3,
                           jld.EnlargedShuffleSampler(16, seed=2), num_workers=2)
    for loader in (got, want):
        loader.set_epoch(1)
    n = 0
    for a, b in zip(got, want):
        _same(a, b)
        assert a["lq"].shape == (3, 5, 16, 16)
        n += 1
    assert n == len(got) == 5


def test_frame_count_must_be_odd_for_interpolation(roots):
    ds = tds.create_dataset(_opt(roots, num_pairs=4))
    with pytest.raises(ValueError, match="odd frame count"):
        for i in range(len(ds)):  # the interpolation branch is drawn 36% of items
            ds[i]
