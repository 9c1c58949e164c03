"""The port's distillation (``train/distill.py`` and the loop's
``train.distill.online``) against the JAX package's, on a narrow teacher
(dim 8, one block a level) with seeded PyTorch weights carried into flax:

  * ``make_online_target_fn``: (B, F, H, W) stacks -> targets, the frames
    cast to bfloat16 at the input (float32 weights: the teacher then
    computes in float32, as flax promotes). Within 1e-5 of JAX's bf16 targets,
    and inside JAX's own distance between its bf16 and fp32 targets where
    that is larger;
  * ``generate_teacher_targets``: the offline pass through each package's
    TeacherPredictor, the files within 1 uint8 level;
  * two loop steps with online targets against the JAX loop (narrow student,
    mixup off, one patch size): loss, lr and grad_norm within 1e-5 relative;
    the refusals.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.convert.torch_import import CONVERTERS
from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    TeacherPredictor as JaxPredictor,
)
from rethink_acoustic_image_enhancement_tpu.models import build_network as jax_net
from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
from rethink_acoustic_image_enhancement_tpu.train import distill as jdistill
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import distill
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import (
    imread_rgb_ubyte,
    imwrite,
    list_images,
)
from torch_train_corpus import REPO, write_student_corpus, write_yml

torch.set_num_threads(2)
TEACHER = {"type": "KDLAE_teacher", "inp_channels": 3, "out_channels": 3, "dim": 8,
           "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
           "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
           "LayerNorm_type": "BiasFree", "dual_pixel_task": False,
           "static": "test", "params": "cat"}


@pytest.fixture(scope="module")
def teacher_pth(tmp_path_factory):
    with torch.random.fork_rng():
        torch.manual_seed(7)
        sd = build_network(TEACHER).state_dict()
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.pth")
    torch.save({"params": sd}, path)
    return path


def _models(path):
    sd = torch.load(path, weights_only=True)["params"]
    port = build_network(TEACHER)
    port.load_state_dict(sd)
    params = CONVERTERS["KDLAE_teacher"]({k: v.numpy().copy() for k, v in sd.items()})
    return port, jax_net(TEACHER), params


def test_online_targets_match_jax(teacher_pth):
    port, jmodel, params = _models(teacher_pth)
    stack = np.random.default_rng(0).random((2, 3, 24, 32), dtype=np.float32)
    stack[:, :, :6] = 0.0  # a black band, as outside the fan
    want = np.asarray(jdistill.make_online_target_fn(jmodel, params, 0.7)(jnp.asarray(stack)))
    want32 = np.asarray(jdistill.make_online_target_fn(
        jmodel, params, 0.7, dtype=jnp.float32)(jnp.asarray(stack)))
    got = distill.make_online_target_fn(port, 0.7)(torch.from_numpy(stack))
    assert got.dtype == torch.float32 and got.shape == stack.shape
    got = got.numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    spread = np.abs(want - want32).max()
    assert np.abs(got - want).max() <= max(1e-5, spread), (np.abs(got - want).max(), spread)
    # the port's own float32 route is JAX's too
    got32 = distill.make_online_target_fn(port, 0.7, dtype=torch.float32)(
        torch.from_numpy(stack)).numpy()
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-5)
    assert not any(p.requires_grad for p in port.parameters())


def test_offline_targets_match_jax(teacher_pth, tmp_path):
    port, jmodel, params = _models(teacher_pth)
    lq = tmp_path / "noisy"
    rng = np.random.default_rng(3)
    for i in range(3):
        img = (rng.uniform(0, 1, (40, 56, 3)) * 255).astype(np.uint8)
        img[:8] = 0  # exact zeros keep their zero through the fan mask
        imwrite(str(lq / f"{i}_x.png"), img)
    n = distill.generate_teacher_targets(TeacherPredictor(port, device="cpu"), str(lq),
                                         str(tmp_path / "port"), denoise_rate=0.8,
                                         log=lambda m: None)
    jdistill.generate_teacher_targets(JaxPredictor(params=params, model=jmodel), str(lq),
                                      str(tmp_path / "jax"), denoise_rate=0.8,
                                      log=lambda m: None)
    assert n == 3
    names = [os.path.basename(p) for p in list_images(str(tmp_path / "port"))]
    assert names == [f"{i}_x.png" for i in range(3)]
    for name in names:
        a = imread_rgb_ubyte(str(tmp_path / "port" / name)).astype(np.int16)
        b = imread_rgb_ubyte(str(tmp_path / "jax" / name)).astype(np.int16)
        assert np.abs(a - b).max() <= 1, name
        assert not a[:8].any()


def _online_cfg(root, teacher_pth, steps):
    with open(os.path.join(REPO, "configs", "KDLAES.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["datasets"]["train"].update(
        root, num_pairs=3, batch_size_per_gpu=2, mini_batch_sizes=[2], gt_size=16,
        gt_sizes=[16], iters=[steps], probs=[0.0], num_worker_per_gpu=2)
    del cfg["datasets"]["val"]
    cfg["network_g"]["hidden_channels"] = [4, 8, 16]
    cfg["train"].update(total_iter=steps, warmup_iter=-1, mixing_augs={"mixup": False},
                        distill={"online": True, "teacher": TEACHER,
                                 "teacher_weights": teacher_pth, "denoise_rate": 0.9})
    cfg["val"]["val_freq"] = 0
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=steps, use_tb_logger=False)
    return cfg


def _train_metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train"]


def test_online_loop_matches_jax(teacher_pth, tmp_path, monkeypatch):
    """Two steps of KDLAES with train.distill.online through both loops (the
    same student weights from a .pth); then the port's CLI on the CPU."""
    root = write_student_corpus(str(tmp_path / "frames"), 8, 16, 16, seed=4)
    cfg = _online_cfg(root, teacher_pth, 2)
    with torch.random.fork_rng():
        torch.manual_seed(1)
        torch.save({"params": build_network(cfg["network_g"]).state_dict()},
                   tmp_path / "student.pth")
    cfg["path"].update(pretrain_network_g=str(tmp_path / "student.pth"), strict_load_g=True)
    yml = write_yml(cfg, tmp_path / "opt.yml")
    j_opt = jcfg.parse(yml, True, root_path=str(tmp_path / "jax"))
    jloop.train_from_config(j_opt)
    t_opt = tcfg.parse(yml, True, root_path=str(tmp_path / "port"))
    tloop.train_from_config(t_opt, device="cpu")
    j_m, t_m = _train_metrics(j_opt["path"]["log"]), _train_metrics(t_opt["path"]["log"])
    assert [r["iter"] for r in t_m] == [r["iter"] for r in j_m] == [1, 2]
    for a, b in zip(t_m, j_m):
        for k in ("l_pix", "lr", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (a["iter"], k)

    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "-opt", yml, "--device", "cpu", "--max-iters", "1"]) == 0
    assert (tmp_path / "experiments" / "KDLAES" / "models" / "net_g_1.pth").is_file()


def test_online_refusals(teacher_pth, tmp_path):
    port, _, _ = _models(teacher_pth)
    with pytest.raises(ValueError, match="a dict batch"):
        tloop.online_targets(distill.make_online_target_fn(port), {"img": None})
    with pytest.raises(ValueError, match="ndim=3"):
        tloop.online_targets(distill.make_online_target_fn(port), torch.zeros(2, 8, 8))
    cfg = _online_cfg({"dataroot_lq": "a", "dataroot_gt": "b"}, "artifacts/kdlaet_full50k", 1)
    opt = tcfg.parse(write_yml(cfg, tmp_path / "o.yml"), True, root_path=str(tmp_path))
    with pytest.raises(ValueError, match="neither a reference-layout .pth nor an "
                                         "orbax checkpoint directory"):
        tcfg.validate(opt)
    cfg["train"]["distill"]["teacher"] = {"type": "Nope"}
    opt = tcfg.parse(write_yml(cfg, tmp_path / "o.yml"), True, root_path=str(tmp_path))
    with pytest.raises(KeyError, match="train.distill.teacher.type"):
        tcfg.validate(opt)
