"""A narrow dual-pixel KDLAE-T (dim 8, blocks [1,1,1,1], params 'none',
six input channels) on an item of the port's dual-pixel 16-bit dataset,
against the flax teacher with the same parameters (CPU, float32, within
1e-5 of the output's scale); and the same network as a Restormer."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.models import kdlae_teacher as jteacher
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.data.datasets import (
    DefocusDeblurDualPixel16Dataset,
    create_dataset,
)
from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAETeacher, Restormer

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

NARROW = dict(inp_channels=6, dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", dual_pixel_task=True)


@pytest.fixture(scope="module")
def item(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    for sub in ("lqL", "lqR", "gt"):
        os.makedirs(root / sub)
        for i in range(2):
            img = rng.integers(0, 65536, (44, 48, 3), dtype=np.uint16)
            assert cv2.imwrite(str(root / sub / f"{i}.png"), img)
    ds = create_dataset({"type": "Dataset_DefocusDeblur_DualPixel_16bit",
                         "dataroot_lqL": str(root / "lqL"), "dataroot_lqR": str(root / "lqR"),
                         "dataroot_gt": str(root / "gt"), "phase": "train", "scale": 1,
                         "gt_size": 32, "geometric_augs": True, "seed": 0})
    return ds[1]


def _seeded(module, x, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got, ref):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("static", ["test", "train"])
def test_dual_pixel_teacher_matches_flax(item, static):
    cfg = dict(NARROW, static=static, params="none")
    x = item["lq"][None]
    assert x.shape == (1, 32, 32, 6)
    jm = jteacher.KDLAETeacher(**cfg)
    p = _seeded(jm, {"img": jnp.asarray(x)}, seed=1)
    ref = jax.jit(jm.apply)({"params": p}, {"img": jnp.asarray(x)})
    port = weights.load_teacher_params(KDLAETeacher(**cfg), p).eval()
    with torch.no_grad():
        out = port({"img": torch.from_numpy(x).permute(0, 3, 1, 2)})
    _close(out["hq"].permute(0, 2, 3, 1).numpy(), np.asarray(ref["hq"]))
    assert out["hq"].shape == (1, 3, 32, 32)
    if static == "train":
        _close(out["sr"].permute(0, 2, 3, 1).numpy(), np.asarray(ref["sr"]))
    else:
        assert out["sr"] is None


def test_dual_pixel_restormer_matches_flax(item):
    cfg = {k: v for k, v in NARROW.items()}
    x = item["lq"][None]
    jm = jteacher.Restormer(**cfg)
    p = _seeded(jm, jnp.asarray(x), seed=2)
    ref = np.asarray(jax.jit(jm.apply)({"params": p}, jnp.asarray(x)))
    port = weights.load_teacher_params(Restormer(**cfg), p).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(out.permute(0, 2, 3, 1).numpy(), ref)


def _dp_corpus(root, n, h, w, seed):
    rng = np.random.default_rng(seed)
    roots = {}
    for sub in ("lqL", "lqR", "gt"):
        roots[f"dataroot_{sub}"] = str(root / sub)
        os.makedirs(root / sub)
        for i in range(n):
            assert cv2.imwrite(str(root / sub / f"{i}.png"),
                               rng.integers(0, 65536, (h, w, 3), dtype=np.uint16))
    return roots


def test_uploader_keeps_six_channel_batches_nhwc_to_nchw():
    """A dual-pixel batch (B, H, W, 6) is NHWC, not a frame stack: the
    dataset's frame_stacks decides the layout, not the batch's shape."""
    from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld

    batch = {"lq": np.zeros((2, 16, 24, 6), np.float32), "gt": np.zeros((2, 16, 24, 3), np.float32)}
    assert DefocusDeblurDualPixel16Dataset.frame_stacks is False
    out = tld.BatchUploader(torch.device("cpu"),
                            DefocusDeblurDualPixel16Dataset.frame_stacks)(batch)
    assert out["lq"].shape == (2, 6, 16, 24) and out["gt"].shape == (2, 3, 16, 24)
    stack = {"lq": np.zeros((2, 7, 16, 24), np.float32)}
    assert tld.BatchUploader(torch.device("cpu"), frame_stacks=True)(stack)["lq"].shape == \
        (2, 7, 16, 24)


def test_dual_pixel_training_matches_jax_and_validates(tmp_path):
    """configs/Restormer_baseline.yml's network narrowed, made dual-pixel
    (inp_channels 6), on Dataset_DefocusDeblur_DualPixel_16bit: the first
    step's loss, lr and grad_norm as the JAX loop's; then the port's own
    validation on dual-pixel frames (the JAX loop's validation reads a
    6-channel NHWC batch as a frame stack by its shape)."""
    import yaml

    from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
    from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
    from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from torch_train_corpus import REPO, write_yml

    train = _dp_corpus(tmp_path / "train", 4, 40, 44, seed=3)
    val = _dp_corpus(tmp_path / "val", 1, 24, 32, seed=4)
    with open(os.path.join(REPO, "configs", "Restormer_baseline.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["network_g"].update(dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1,
                            inp_channels=6, dual_pixel_task=True, LayerNorm_type="WithBias")
    dp = {"type": "Dataset_DefocusDeblur_DualPixel_16bit"}
    cfg["datasets"]["train"] = dict(cfg["datasets"]["train"], **dp, **train,
                                    batch_size_per_gpu=2, mini_batch_sizes=[2], iters=[1],
                                    gt_size=32, gt_sizes=[32], num_worker_per_gpu=2,
                                    use_shuffle=False)
    cfg["datasets"]["train"].pop("dataroot_lq")
    del cfg["datasets"]["val"]
    cfg["train"].update(total_iter=1, mixing_augs={"mixup": False})
    cfg["val"]["val_freq"] = 0
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=1, use_tb_logger=False)
    cfg["path"].update(resume_state=None, strict_load_g=True)
    with torch.random.fork_rng():
        torch.manual_seed(5)
        torch.save({"params": build_network(cfg["network_g"]).state_dict()}, tmp_path / "w.pth")
    cfg["path"]["pretrain_network_g"] = str(tmp_path / "w.pth")
    yml = write_yml(cfg, tmp_path / "jax.yml")
    j_opt = jcfg.parse(yml, True, root_path=str(tmp_path / "jax"))
    jloop.train_from_config(j_opt)

    cfg["datasets"]["val"] = dict(dp, name="ValSet", **val)
    cfg["val"]["val_freq"] = 1
    t_opt = tcfg.parse(write_yml(cfg, tmp_path / "port.yml"), True,
                       root_path=str(tmp_path / "port"))
    tloop.train_from_config(t_opt, device="cpu")

    def events(opt, kind):
        with open(os.path.join(opt["path"]["log"], "metrics.jsonl")) as f:
            return [r for r in map(json.loads, f) if r["kind"] == kind]

    (a,), (b,) = events(t_opt, "train"), events(j_opt, "train")
    for k in ("l_pix", "lr", "grad_norm"):
        assert a[k] == pytest.approx(b[k], rel=1e-5), k
    (v,) = events(t_opt, "val")
    assert np.isfinite(v["psnr"])
