"""The port's training step and checkpoints on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.losses import build_loss
from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.train import checkpoints as ckpt
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
from torch_train_corpus import (
    NARROW,
    teacher_config,
    write_teacher_corpus,
    write_yml,
)

NET = {"type": "KDLAE_teacher", **NARROW, "LayerNorm_type": "BiasFree",
       "static": "train", "params": "cat"}
TRAIN = {"optim_g": {"type": "AdamW", "lr": 1e-3, "weight_decay": 5e-5,
                     "betas": [0.2, 0.999]},
         "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                       "periods": [4, 10], "restart_weights": [1, 1],
                       "eta_mins": [3e-4, 1e-6]},
         "mixing_augs": {"mixup": True, "mixup_beta": 1.2, "use_identity": True},
         "pixel_opt": {"type": "L1LossSr"}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _trainer(device, **kw):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_network(NET)
    return ttr.build_trainer_from_config(
        {"train": {**TRAIN, **kw}, "datasets": {"train": {"gt_size": 32}}},
        model, build_loss(TRAIN["pixel_opt"]), device=device)


def _batch(device, b=2, h=32, w=32):
    rng = np.random.default_rng(1)
    img = rng.random((b, 3, h, w)).astype(np.float32)
    hq = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ({"img": t(img), "denoise_rate": t(np.full((b, 1, h, w), 0.6, np.float32))},
            {"hq": t(hq), "sr": t(hq.repeat(2, 2).repeat(2, 3))})


def _one_step(device, **kw):
    trainer = _trainer(device, **kw)
    state = trainer.init_state()
    lq, gt = _batch(device)
    # the draws (crop, mask, mixup) are host numpy: the same on both devices
    state, m = trainer.step(state, lq, gt, np.random.default_rng(3),
                            extra_prob=0.1, mini_gt_size=24)
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
    return {k: float(v) for k, v in m.items()}, params, grads


@pytest.mark.cuda
def test_step_on_the_card_matches_the_cpu(cuda):
    """fp32 with TF32 off: loss and grad_norm within 1e-4 relative; each
    weight within 0.05 lr of the CPU's where its gradient exceeds 1e-6 of
    the largest, else within 2 lr (Adam's sign flips)."""
    m_gpu, p_gpu, g_gpu = _one_step(cuda)
    m_cpu, p_cpu, g_cpu = _one_step(torch.device("cpu"))
    assert m_gpu["l_pix"] == pytest.approx(m_cpu["l_pix"], rel=1e-4)
    assert m_gpu["grad_norm"] == pytest.approx(m_cpu["grad_norm"], rel=1e-4)
    assert m_gpu["lr"] == m_cpu["lr"]
    lr = m_cpu["lr"]
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    for n, p in p_cpu.items():
        tol = torch.where(g_cpu[n].abs() > 1e-6 * gmax, 0.05 * lr, 2 * lr)
        assert bool(((p_gpu[n] - p).abs() <= tol).all()), n


@pytest.mark.cuda
def test_bf16_step_on_the_card(cuda):
    m_bf16, _, _ = _one_step(cuda, compute_dtype="bf16")
    m_fp32, _, _ = _one_step(cuda)
    assert np.isfinite(m_bf16["l_pix"]) and np.isfinite(m_bf16["grad_norm"])
    assert m_bf16["l_pix"] == pytest.approx(m_fp32["l_pix"], rel=2e-2)


@pytest.mark.cuda
def test_checkpoint_from_the_card_restores_on_the_cpu(cuda, tmp_path):
    trainer = _trainer(cuda, ema_decay=0.9)
    state = trainer.init_state()
    lq, gt = _batch(cuda)
    for k in range(2):
        state, _ = trainer.step(state, lq, gt, np.random.default_rng(k))
    ckpt.save_checkpoint(str(tmp_path), state.step, state, epoch=1,
                         loop={"epoch_iter": 2})
    cpu = _trainer("cpu", ema_decay=0.9).init_state()
    cpu, epoch, loop = ckpt.restore_checkpoint(str(tmp_path), 2, cpu)
    assert (cpu.step, epoch, loop) == (2, 1, {"epoch_iter": 2})
    for a, b in zip(cpu.model.state_dict().values(), state.model.state_dict().values()):
        assert torch.equal(a, b.cpu())
    for a, b in zip(cpu.ema.state_dict().values(), state.ema.state_dict().values()):
        assert torch.equal(a, b.cpu())
    sa, sb = cpu.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    for k in sb:
        assert torch.equal(sa[k]["exp_avg"], sb[k]["exp_avg"].cpu())


@pytest.mark.cuda
def test_train_from_config_on_the_card(cuda, tmp_path):
    train = write_teacher_corpus(str(tmp_path / "tr"), 4, 40, 40, seed=0)
    val = write_teacher_corpus(str(tmp_path / "va"), 1, 32, 32, seed=1)
    cfg = teacher_config(train, val, batch_size_per_gpu=2,
                         mini_batch_sizes=[2, 1], iters=[1, 2], gt_size=32,
                         gt_sizes=[16, 32], probs=[0.2, 0.1], num_worker_per_gpu=2)
    cfg["train"]["total_iter"] = 3
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=3)
    cfg["val"]["val_freq"] = 3
    opt = tcfg.parse(write_yml(cfg, tmp_path / "opt.yml"), True,
                     root_path=str(tmp_path))
    state = tloop.train_from_config(opt)
    assert state.step == 3 and next(state.model.parameters()).is_cuda
    assert os.path.isfile(os.path.join(opt["path"]["models"], "net_g_3.pth"))
