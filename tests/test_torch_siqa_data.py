"""The port's SIQADataset (Dataset_S_IQA) against the JAX package's, item
for item and bit for bit: the score from the JSON file, the reflect101 pad
to gt_size + 2 where the images are smaller, the joint crop at offsets in
[1, h-1-size], the synchronised flip/flip/rotation, RGB out; and the
untouched items of an evaluation phase."""

import numpy as np
import pytest

from rethink_acoustic_image_enhancement_tpu.data import datasets as jds
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from torch_train_corpus import write_siqa_corpus


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return write_siqa_corpus(str(tmp_path_factory.mktemp("siqa")), 6, 40, 36,
                             seed=5)


def _same(a, b):
    assert a["lq_path"] == b["lq_path"] and a["gt_path"] == b["gt_path"]
    np.testing.assert_array_equal(a["lq"]["img"], b["lq"]["img"])
    np.testing.assert_array_equal(a["gt"]["hq"], b["gt"]["hq"])
    assert a["lq"]["score"] == b["lq"]["score"]
    assert a["lq"]["score"].dtype == np.float32


@pytest.mark.parametrize("phase,gt_size,augs", [
    ("train", 32, True),    # a crop inside the images
    ("train", 48, True),    # larger than the images: reflect101 pad first
    ("train", 32, False),
    ("val", None, False),   # whole images
])
def test_items_match_jax(roots, phase, gt_size, augs):
    opt = {"type": "Dataset_S_IQA", **roots, "phase": phase, "gt_size": gt_size,
           "geometric_augs": augs, "seed": 9}
    got, want = tds.create_dataset(opt), jds.create_dataset(opt)
    assert len(got) == len(want) == 6
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(6):
            a, b = got[i], want[i]
            _same(a, b)
            side = gt_size or 40
            assert a["lq"]["img"].shape[:2] in ((side, gt_size or 36),
                                                (gt_size or 36, side))
            assert a["lq"]["img"].shape[2] == 3
    assert 0.0 <= float(got[0]["lq"]["score"]) <= 1.0
