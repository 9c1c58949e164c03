"""The port's Gaussian-denoising, single-image and dual-pixel 16-bit
datasets, and the LMDB route of the three that read shards, against the
JAX package's on seeded corpora: every item equal for the same seed, epoch
and index (both sides are numpy), the LMDB route equal to the disk route,
and the datasets that refuse LMDB refusing it as JAX does."""

import os

import numpy as np
import pytest

from rethink_acoustic_image_enhancement_tpu.data import datasets as jds
from rethink_acoustic_image_enhancement_tpu.data.lmdb_util import (
    make_lmdb_from_folder as jax_make_lmdb,
)
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from rethink_acoustic_image_enhancement_tpu_torch.data.lmdb_util import make_lmdb_from_folder
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

cv2 = pytest.importorskip("cv2")


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _items_equal(opt, n=None, epochs=(0, 1)):
    port, ref = tds.create_dataset(dict(opt)), jds.create_dataset(dict(opt))
    assert len(port) == len(ref)
    for epoch in epochs:
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(n or len(port)):
            _equal(port[i], ref[i])
    return port


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Seeded clean RGB images (one smaller than the crop: the pad path),
    an LQ folder, their LMDB shards, and 16-bit dual-pixel triples."""
    root = tmp_path_factory.mktemp("extra")
    rng = np.random.default_rng(0)
    for sub in ("gt", "lq"):
        os.makedirs(root / sub)
    for i, (h, w) in enumerate([(40, 44), (36, 40), (20, 24), (48, 40)]):
        imwrite(str(root / "gt" / f"{i:03d}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        imwrite(str(root / "lq" / f"{i:03d}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    for sub in ("gt", "lq"):
        make_lmdb_from_folder(str(root / sub), str(root / f"{sub}.lmdb"))
    for sub in ("lqL", "lqR", "dp_gt"):
        os.makedirs(root / sub)
        for i, (h, w) in enumerate([(40, 44), (24, 28)]):
            img = rng.integers(0, 65536, (h, w, 3), dtype=np.uint16)
            assert cv2.imwrite(str(root / sub / f"{i}.png"), img)
    return root


def _gaussian(roots, lmdb=False, **kw):
    gt = str(roots / ("gt.lmdb" if lmdb else "gt"))
    return {"type": "Dataset_GaussianDenoising", "dataroot_gt": gt, "scale": 1,
            "io_backend": {"type": "lmdb" if lmdb else "disk"}, "seed": 5, **kw}


@pytest.mark.parametrize("sigma_type,sigma_range", [
    ("constant", 25), ("random", [0, 50]), ("choice", [15, 25, 50])])
@pytest.mark.parametrize("in_ch", [3, 1])
@pytest.mark.parametrize("augs", [True, False])
def test_gaussian_train_items_match_jax(roots, sigma_type, sigma_range, in_ch, augs):
    port = _items_equal(_gaussian(roots, phase="train", gt_size=32, in_ch=in_ch,
                                  sigma_type=sigma_type, sigma_range=sigma_range,
                                  geometric_augs=augs))
    item = port[0]
    assert item["lq"].shape == item["gt"].shape == (32, 32, in_ch)


@pytest.mark.parametrize("in_ch", [3, 1])
def test_gaussian_eval_items_match_jax(roots, in_ch):
    port = _items_equal(_gaussian(roots, phase="val", sigma_test=25, in_ch=in_ch))
    a, b = port[1], port[1]
    np.testing.assert_array_equal(a["lq"], b["lq"])  # eval noise: default_rng(0)
    assert a["lq"].shape == (36, 40, in_ch)


def test_gaussian_rejects_an_unknown_sigma_type(roots):
    with pytest.raises(ValueError, match="sigma_type"):
        tds.create_dataset(_gaussian(roots, phase="train", gt_size=32,
                                     sigma_type="uniform", sigma_range=[0, 5]))


def test_gaussian_meta_info_file(roots, tmp_path):
    meta = tmp_path / "meta.txt"
    meta.write_text("002.png (20,24,3) 1\n000.png (40,44,3) 1\n")
    port = _items_equal(_gaussian(roots, phase="val", sigma_test=15, in_ch=3,
                                  meta_info_file=str(meta)))
    assert [os.path.basename(p) for p in port.paths] == ["002.png", "000.png"]


def test_single_image_items_match_jax(roots):
    port = _items_equal({"type": "Dataset_SingleImage", "dataroot_lq": str(roots / "lq")})
    item = port[2]
    assert item["lq"].shape == (20, 24, 3) and item["lq_path"].endswith("002.png")
    assert set(item) == {"lq", "lq_path"}


@pytest.mark.parametrize("phase,augs", [("train", True), ("train", False), ("val", False)])
def test_dual_pixel_items_match_jax(roots, phase, augs):
    opt = {"type": "Dataset_DefocusDeblur_DualPixel_16bit",
           "dataroot_lqL": str(roots / "lqL"), "dataroot_lqR": str(roots / "lqR"),
           "dataroot_gt": str(roots / "dp_gt"), "phase": phase, "scale": 1,
           "gt_size": 32, "geometric_augs": augs, "seed": 0}
    port = _items_equal(opt)
    item = port[1]
    side = (32, 32) if phase == "train" else (24, 28)
    assert item["lq"].shape == (*side, 6) and item["gt"].shape == (*side, 3)
    # 16-bit decode: /65535, not /255
    raw = cv2.imread(str(roots / "dp_gt" / "1.png"), cv2.IMREAD_UNCHANGED)
    if phase == "val":
        np.testing.assert_array_equal(item["gt"], (raw.astype(np.float32) / 65535.0)[..., ::-1])


def _lmdb_vs_disk(opt_disk, opt_lmdb, n):
    disk, lmdb = tds.create_dataset(opt_disk), tds.create_dataset(opt_lmdb)
    assert len(disk) == len(lmdb) == n
    for epoch in (0, 1):
        disk.set_epoch(epoch)
        lmdb.set_epoch(epoch)
        for i in range(n):
            a, b = disk[i], lmdb[i]
            for k in a:
                if k.endswith("_path"):
                    assert os.path.splitext(os.path.basename(a[k]))[0] == b[k]
                else:
                    np.testing.assert_array_equal(a[k], b[k])


def test_paired_image_lmdb_matches_jax_and_disk(roots):
    base = {"type": "Dataset_PairedImage", "phase": "train", "scale": 1,
            "gt_size": 24, "geometric_augs": True, "seed": 3}
    disk = dict(base, dataroot_lq=str(roots / "lq"), dataroot_gt=str(roots / "gt"))
    lmdb = dict(base, dataroot_lq=str(roots / "lq.lmdb"), dataroot_gt=str(roots / "gt.lmdb"),
                io_backend={"type": "lmdb"})
    _items_equal(lmdb)
    _lmdb_vs_disk(disk, lmdb, 4)


@pytest.mark.parametrize("phase", ["train", "val"])
def test_gaussian_lmdb_matches_jax_and_disk(roots, phase):
    kw = (dict(phase="train", gt_size=32, sigma_type="random", sigma_range=[0, 50],
               geometric_augs=True) if phase == "train" else dict(phase="val", sigma_test=25))
    _items_equal(_gaussian(roots, lmdb=True, **kw))
    _lmdb_vs_disk(_gaussian(roots, **kw), _gaussian(roots, lmdb=True, **kw), 4)


def test_single_image_lmdb_matches_jax_and_disk(roots):
    disk = {"type": "Dataset_SingleImage", "dataroot_lq": str(roots / "lq")}
    lmdb = dict(disk, dataroot_lq=str(roots / "lq.lmdb"), io_backend={"type": "lmdb"})
    _items_equal(lmdb)
    _lmdb_vs_disk(disk, lmdb, 4)


def test_jax_shards_read_by_the_port(roots, tmp_path):
    jax_make_lmdb(str(roots / "gt"), str(tmp_path / "gt.lmdb"))
    jax_make_lmdb(str(roots / "lq"), str(tmp_path / "lq.lmdb"))
    _items_equal({"type": "Dataset_PairedImage", "phase": "val", "scale": 1,
                  "dataroot_lq": str(tmp_path / "lq.lmdb"),
                  "dataroot_gt": str(tmp_path / "gt.lmdb"), "io_backend": {"type": "lmdb"}})


@pytest.mark.parametrize("dtype,roots_of", [
    ("Dataset_SuperRestoration_param", ("lq", "gt", "sr", "param")),
    ("Dataset_SuperRestoration", ("lq", "gt", "sr")),
    ("Dataset_PairedMutiImage", ("lq", "gt")),
    ("Dataset_S_IQA", ("lq", "gt", "param")),
    ("Dataset_DefocusDeblur_DualPixel_16bit", ("lqL", "lqR", "gt")),
])
def test_multi_folder_datasets_refuse_lmdb_as_jax(dtype, roots_of):
    opt = {"type": dtype, "io_backend": {"type": "lmdb"},
           **{f"dataroot_{k}": f"{k}.lmdb" for k in roots_of}}
    with pytest.raises(NotImplementedError) as ours:
        tds.create_dataset(dict(opt))
    with pytest.raises(NotImplementedError) as theirs:
        jds.create_dataset(dict(opt))
    assert str(ours.value) == str(theirs.value)
    assert "lmdb" in str(ours.value)


def test_missing_lmdb_key_names_it(roots, tmp_path):
    ds = tds.create_dataset({"type": "Dataset_SingleImage", "dataroot_lq": str(roots / "lq.lmdb"),
                             "io_backend": {"type": "lmdb"}})
    ds.paths = ["nope"]
    with pytest.raises(IOError, match="'nope'"):
        ds[0]
