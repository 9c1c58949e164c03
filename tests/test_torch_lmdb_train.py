"""Training the port from the new datasets, on the CPU: a narrowed
configs/Restormer_baseline.yml (dim 8, blocks [1,1,1,1]) for 2 steps from
LMDB shards gives the losses of the same run from the disk folders, and a
Gaussian-denoising config's first step gives the JAX loop's loss within
1e-5."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu_torch.data.lmdb_util import make_lmdb_from_folder
from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite
from torch_train_corpus import REPO, write_paired_corpus, write_yml

pytest.importorskip("cv2")
torch.set_num_threads(2)

NARROW = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1}


def _baseline(train_roots, val_roots, steps=2, **train_ds):
    """configs/Restormer_baseline.yml narrowed: dim 8, blocks [1,1,1,1],
    batch 2 at 32 px, ``steps`` steps, a validation at the end."""
    with open(os.path.join(REPO, "configs", "Restormer_baseline.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["network_g"].update(NARROW)
    cfg["datasets"]["train"].update(train_roots, batch_size_per_gpu=2, mini_batch_sizes=[2],
                                    iters=[steps], gt_size=32, gt_sizes=[32],
                                    num_worker_per_gpu=2, **train_ds)
    cfg["datasets"]["val"].update(val_roots)
    cfg["train"].update(total_iter=steps)
    cfg["train"]["scheduler"].update(periods=[1, steps])
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=steps, use_tb_logger=False)
    cfg["val"]["val_freq"] = steps
    cfg["path"]["resume_state"] = None
    return cfg


def _seeded_pth(cfg, path):
    with torch.random.fork_rng():
        torch.manual_seed(5)
        sd = build_network(cfg["network_g"]).state_dict()
    torch.save({"params": sd}, path)
    return str(path)


def _events(opt, kind):
    with open(os.path.join(opt["path"]["log"], "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("baseline")
    train = write_paired_corpus(str(root / "train"), 6, 40, 48, seed=0)
    val = write_paired_corpus(str(root / "val"), 2, 32, 40, seed=1)
    shards = {}
    for key, folder in {**{f"t_{k}": v for k, v in train.items()},
                        **{f"v_{k}": v for k, v in val.items()}}.items():
        shards[key] = folder + ".lmdb"
        make_lmdb_from_folder(folder, shards[key])
    return train, val, shards


def test_baseline_trains_from_lmdb_as_from_disk(corpus, tmp_path):
    train, val, shards = corpus
    cfg = _baseline(train, val)
    cfg["path"]["pretrain_network_g"] = _seeded_pth(cfg, tmp_path / "w.pth")
    disk = tcfg.parse(write_yml(cfg, tmp_path / "disk.yml"), True,
                      root_path=str(tmp_path / "disk"))
    lmdb_io = {"type": "lmdb"}
    cfg["datasets"]["train"].update(dataroot_lq=shards["t_dataroot_lq"],
                                    dataroot_gt=shards["t_dataroot_gt"], io_backend=lmdb_io)
    cfg["datasets"]["val"].update(dataroot_lq=shards["v_dataroot_lq"],
                                  dataroot_gt=shards["v_dataroot_gt"], io_backend=lmdb_io)
    lmdb = tcfg.parse(write_yml(cfg, tmp_path / "lmdb.yml"), True,
                      root_path=str(tmp_path / "lmdb"))
    tcfg.validate(lmdb)
    for opt in (disk, lmdb):
        tloop.train_from_config(opt, device="cpu")
    a, b = _events(disk, "train"), _events(lmdb, "train")
    assert [r["iter"] for r in a] == [r["iter"] for r in b] == [1, 2]
    assert a[0]["l_pix"] == b[0]["l_pix"]  # the same bytes and crops
    for x, y in zip(a, b):
        for k in ("l_pix", "grad_norm"):
            assert y[k] == pytest.approx(x[k], rel=1e-6), k
    va, vb = _events(disk, "val"), _events(lmdb, "val")
    assert len(va) == len(vb) == 1 and vb[0]["psnr"] == pytest.approx(va[0]["psnr"], rel=1e-6)
    assert os.path.isfile(os.path.join(lmdb["path"]["models"], "net_g_2.pth"))


def _clean_folder(root, n=4, h=40, w=44, seed=3):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        imwrite(os.path.join(root, f"{i:03d}.png"), (rng.random((h, w, 3)) * 255).astype(np.uint8))
    return root


def test_gaussian_first_step_matches_jax(tmp_path):
    """Restormer's GaussianColorDenoising setup narrowed (sigma random in
    [0, 50], in_ch 3): the first step's loss, lr and grad_norm as the JAX
    loop's, on the same pretrained weights."""
    clean = _clean_folder(str(tmp_path / "clean"))
    cfg = _baseline({"dataroot_gt": clean}, {"dataroot_gt": clean}, steps=1)
    for phase in ("train", "val"):
        ds = cfg["datasets"][phase]
        ds.pop("dataroot_lq")
        ds.update(type="Dataset_GaussianDenoising", in_ch=3)
    cfg["datasets"]["train"].update(sigma_type="random", sigma_range=[0, 50],
                                    use_shuffle=False)
    cfg["datasets"]["val"]["sigma_test"] = 25
    cfg["val"]["val_freq"] = 0
    cfg["train"]["mixing_augs"] = {"mixup": False}
    cfg["path"]["pretrain_network_g"] = _seeded_pth(cfg, tmp_path / "w.pth")
    cfg["path"]["strict_load_g"] = True
    yml = write_yml(cfg, tmp_path / "gauss.yml")
    j_opt = jcfg.parse(yml, True, root_path=str(tmp_path / "jax"))
    jloop.train_from_config(j_opt)
    t_opt = tcfg.parse(yml, True, root_path=str(tmp_path / "port"))
    tloop.train_from_config(t_opt, device="cpu")
    (a,), (b,) = _events(t_opt, "train"), _events(j_opt, "train")
    for k in ("l_pix", "lr", "grad_norm"):
        assert a[k] == pytest.approx(b[k], rel=1e-5), k
