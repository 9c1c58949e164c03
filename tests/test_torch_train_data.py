"""The port's teacher data pipeline against the JAX package's on a seeded
temporary corpus: dataset items bit-identical across two epochs, the
sampler's order, BatchLoader's batches, the curriculum's stage lookup, and
the upload to NCHW."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.data import datasets as jds
from rethink_acoustic_image_enhancement_tpu.data import loader as jld
from rethink_acoustic_image_enhancement_tpu.train.progressive import (
    ProgressiveSchedule as JaxSchedule,
)
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from rethink_acoustic_image_enhancement_tpu_torch.data import file_client
from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld
from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import (
    ProgressiveSchedule,
)
from torch_train_corpus import write_paired_corpus, write_teacher_corpus


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


@pytest.fixture(scope="module")
def teacher_roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("teacher")
    roots = write_teacher_corpus(str(root / "big"), 5, 44, 52, seed=0)
    # smaller than gt_size + 2: the reflect-101 pad path
    small = write_teacher_corpus(str(root / "small"), 2, 20, 24, seed=1)
    # one image with no rate in its JSON (denoise_rate 1.0)
    with open(os.path.join(roots["dataroot_param"], "0002.json"), "w") as f:
        json.dump({}, f)
    return roots, small


@pytest.mark.parametrize("dtype", ["Dataset_SuperRestoration_param",
                                   "Dataset_SuperRestoration"])
@pytest.mark.parametrize("which,phase,augs", [
    ("big", "train", True), ("big", "train", False), ("small", "train", True),
    ("big", "val", False)])
def test_teacher_items_match_jax(teacher_roots, dtype, which, phase, augs):
    roots = teacher_roots[0] if which == "big" else teacher_roots[1]
    if dtype == "Dataset_SuperRestoration":
        roots = {k: v for k, v in roots.items() if k != "dataroot_param"}
    opt = {"type": dtype, **roots, "phase": phase, "gt_size": 32, "seed": 3,
           "geometric_augs": augs, "io_backend": {"type": "disk"}}
    j, t = jds.create_dataset(opt), tds.create_dataset(opt)
    assert len(j) == len(t)
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for i in range(len(j)):
            _equal(t[i], j[i])


@pytest.mark.parametrize("augs", [False, True])
def test_paired_items_match_jax(tmp_path, augs):
    roots = write_paired_corpus(str(tmp_path), 4, 30, 26, seed=2)
    opt = {"type": "Dataset_PairedImage", **roots, "phase": "train",
           "gt_size": 24, "scale": 1, "geometric_augs": augs,
           "cache_decoded": True}
    j, t = jds.create_dataset(opt), tds.create_dataset(opt)
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for i in range(len(j)):
            _equal(t[i], j[i])


@pytest.mark.parametrize("n,ratio,shuffle", [(7, 1, True), (5, 3, True),
                                             (6, 1, False)])
def test_sampler_order(n, ratio, shuffle):
    j = jld.EnlargedShuffleSampler(n, ratio=ratio, shuffle=shuffle, seed=9)
    t = tld.EnlargedShuffleSampler(n, ratio=ratio, shuffle=shuffle, seed=9)
    for epoch in range(3):
        np.testing.assert_array_equal(t.epoch_indices(epoch),
                                      j.epoch_indices(epoch))


def test_batches_match_jax_and_skip_resumes(teacher_roots):
    opt = {"type": "Dataset_SuperRestoration_param", **teacher_roots[0],
           "phase": "train", "gt_size": 32, "geometric_augs": True}
    j_ds, t_ds = jds.create_dataset(opt), tds.create_dataset(opt)
    j = jld.BatchLoader(j_ds, 2, jld.EnlargedShuffleSampler(5, ratio=2, seed=1),
                        num_workers=2)
    t = tld.BatchLoader(t_ds, 2, tld.EnlargedShuffleSampler(5, ratio=2, seed=1),
                        num_workers=2)
    assert len(j) == len(t) == 5
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        want = list(j)
        got = list(t)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
        t.set_epoch(epoch, skip=3)  # a resumed epoch reads its batches 3..
        rest = list(t)
        assert len(rest) == 2
        for a, b in zip(rest, want[3:]):
            _equal(a, b)


def test_collate_nested():
    items = [{"a": {"x": np.ones((2, 2)) * i}, "p": f"f{i}"} for i in range(3)]
    _equal(tld.default_collate(items), jld.default_collate(items))


def test_stage_lookup_matches_jax():
    kw = dict(iters=[3000, 2000, 1600, 1200, 1200, 800],
              mini_batch_sizes=[6, 6, 2, 1, 1, 1],
              gt_sizes=[32, 64, 96, 128, 128, 128],
              probs=[0.2, 0.1, 0.05, 0.03, 0.02, 0.02], gt_size=128,
              base_prob=0.0)
    j, t = JaxSchedule(**kw), ProgressiveSchedule(**kw)
    for it in list(range(0, 40)) + list(range(2990, 3010)) + \
            list(range(9790, 9810)) + [9800, 12000]:
        assert t.at(it) == j.at(it), it
    no_probs = {**kw, "probs": ()}
    assert ProgressiveSchedule(**no_probs).at(5) == JaxSchedule(**no_probs).at(5)
    ds = {"mini_batch_sizes": [2], "iters": [5], "gt_sizes": [8], "gt_size": 8}
    assert ProgressiveSchedule.from_dataset_opt(ds).at(1) == (2, 8, 0.0)
    assert ProgressiveSchedule.from_dataset_opt({"gt_size": 8}) is None


def test_upload_turns_batches_nchw(teacher_roots):
    opt = {"type": "Dataset_SuperRestoration_param", **teacher_roots[0],
           "phase": "train", "gt_size": 32}
    loader = tld.BatchLoader(tds.create_dataset(opt), 2,
                             tld.EnlargedShuffleSampler(5, seed=0))
    host = next(iter(loader))
    dev = tld.BatchUploader(torch.device("cpu"), loader.dataset.frame_stacks)(host)
    assert dev["lq_path"] == host["lq_path"]
    for (k, sub) in (("lq", "img"), ("lq", "denoise_rate"), ("gt", "hq"),
                     ("gt", "sr")):
        np.testing.assert_array_equal(dev[k][sub].permute(0, 2, 3, 1).numpy(),
                                      host[k][sub])
        assert dev[k][sub].is_contiguous()


@pytest.mark.parametrize("name", sorted(tds.DATASETS))
def test_every_dataset_declares_its_batch_layout(name):
    """The uploader takes its layout from the dataset, never from a
    batch's shape: every registered type says whether its 4-D batches are
    (B, F, H, W) frame stacks (the student's PairedMutiImage alone) or
    NHWC."""
    stacks = tds.DATASETS[name].frame_stacks
    assert isinstance(stacks, bool)
    assert stacks == (name == "Dataset_PairedMutiImage")
    with pytest.raises(TypeError):
        tld.BatchUploader(torch.device("cpu"))


def test_prefetcher_order_and_errors():
    got = list(tld.DevicePrefetcher(iter(range(7)), put=lambda b: b * 10))
    assert got == [b * 10 for b in range(7)]

    def bad(b):
        if b == 2:
            raise OSError("unreadable")
        return b

    with pytest.raises(OSError, match="unreadable"):
        list(tld.DevicePrefetcher(iter(range(5)), put=bad))
    pf = tld.DevicePrefetcher(iter(range(100)), put=lambda b: b, depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()


def test_unported_types_and_backends_name_the_roadmap(tmp_path, monkeypatch):
    """Every dataset type and file backend of the JAX package is ported
    (the name is the test's from before they were): the registries are
    equal, the lmdb and memcached clients build, and an unknown type or
    key is still refused."""
    assert set(tds.DATASETS) == set(jds.DATASETS)
    assert not hasattr(tds, "NOT_PORTED")
    with pytest.raises(KeyError, match="unknown dataset type"):
        tds.create_dataset({"type": "Nope"})
    from rethink_acoustic_image_enhancement_tpu_torch.data.lmdb_codec import write_lmdb

    write_lmdb(str(tmp_path / "a.lmdb"), [(b"k", b"v")])
    client = file_client.FileClient("lmdb", db_paths=[str(tmp_path / "a.lmdb")],
                                    client_keys=["gt"])
    assert client.get("k", "gt") == b"v"
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "mc.py").write_text(
        "class pyvector:\n    pass\n"
        "class MemcachedClient:\n"
        "    @staticmethod\n"
        "    def GetInstance(server_cfg, client_cfg):\n"
        "        return MemcachedClient()\n"
        "    def Get(self, path, buf):\n"
        "        buf.data = path.encode()\n"
        "def ConvertBuffer(buf):\n    return buf.data\n")
    monkeypatch.setattr(sys, "path", list(sys.path))
    # the fake ``mc`` must not outlive the test: the module that was there
    # before (if any) goes back, never the fake
    saved_mc = sys.modules.pop("mc", None)
    try:
        client = file_client.FileClient("memcached", server_list_cfg="s", client_cfg="c",
                                        sys_path=str(tmp_path / "site"))
        assert client.get("x/y.png") == b"x/y.png"
    finally:
        sys.modules.pop("mc", None)
        if saved_mc is not None:
            sys.modules["mc"] = saved_mc
    with pytest.raises(ValueError, match="not supported"):
        file_client.FileClient("ceph")
    with pytest.raises(KeyError, match="dataroot_xx"):
        tds.validate_dataset_opt({"type": "Dataset_PairedImage",
                                  "dataroot_xx": "a"})
    assert tds.KNOWN_DATASET_KEYS == jds.KNOWN_DATASET_KEYS
