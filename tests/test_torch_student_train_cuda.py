"""The student's and the scorer's training, and online distillation, on an
NVIDIA GPU against the same code on the CPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:
    python -m pytest --noconftest -m cuda tests/test_torch_student_train_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import copy

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.losses import build_loss
from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.models.asdqe import (
    DenoiseRatePredictor,
    Dropout,
    init_weights_,
)
from rethink_acoustic_image_enhancement_tpu_torch.train import asdqe_trainer as atr
from rethink_acoustic_image_enhancement_tpu_torch.train import distill
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
from rethink_acoustic_image_enhancement_tpu_torch.utils import native
from torch_train_corpus import write_siqa_corpus

STUDENT = {"type": "KDLAE_student", "inp_channels": 1, "out_channels": 1,
           "residual": True, "hidden_channels": [16, 32, 64]}
TRAIN = {"optim_g": {"type": "AdamW", "lr": 3e-4, "weight_decay": 1e-4,
                     "betas": [0.9, 0.999]},
         "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                       "periods": [40000, 60000], "restart_weights": [1, 2],
                       "eta_mins": [3e-4, 1e-6]},
         "mixing_augs": {"mixup": True, "mixup_beta": 1.2, "use_identity": True},
         "pixel_opt": {"type": "L1LossForVideoFrames", "l1loss_weight": 0.9,
                       "temporal_weight": 0.1, "reduction": "mix"}}
TEACHER = {"type": "KDLAE_teacher", "dim": 8, "num_blocks": [1, 1, 1, 1],
           "num_refinement_blocks": 1, "heads": [1, 2, 4, 8],
           "LayerNorm_type": "BiasFree", "static": "train", "params": "cat"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _student_step(device, dtype):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_network(STUDENT)
    trainer = ttr.build_trainer_from_config(
        {"train": TRAIN, "datasets": {"train": {"gt_size": 48}}}, model,
        build_loss(TRAIN["pixel_opt"]), device=device)
    state = trainer.init_state()
    state.model.to(dtype)
    state.step = 10  # past lr 0
    rng = np.random.default_rng(1)
    lq = rng.random((2, 7, 48, 48), dtype=np.float32)
    gt = np.clip(lq + rng.normal(0, 0.05, lq.shape), 0, 1).astype(np.float32)
    state, m = trainer.step(state, torch.from_numpy(lq).to(device, dtype),
                            torch.from_numpy(gt).to(device, dtype), np.random.default_rng(2),
                            extra_prob=0.1, mini_gt_size=32)
    return ({k: float(v) for k, v in m.items()},
            {n: p.detach().cpu().double() for n, p in state.model.named_parameters()})


@pytest.mark.cuda
def test_student_step_on_the_card_matches_the_cpu(cuda):
    """Stage crop, extra mask, mixup and the 'mix' loss, all drawn on the
    host; the card in float32 against the CPU in float64 (PyTorch's CPU
    conv3d sums the output bias's gradient in float32 with an error that
    grows with the batch): loss and grad_norm within 1e-4, weights within
    2 lr."""
    m_gpu, p_gpu = _student_step(cuda, torch.float32)
    m_cpu, p_cpu = _student_step(torch.device("cpu"), torch.float64)
    assert m_gpu["l_pix"] == pytest.approx(m_cpu["l_pix"], rel=1e-4)
    assert m_gpu["grad_norm"] == pytest.approx(m_cpu["grad_norm"], rel=1e-4)
    for n, p in p_cpu.items():
        assert (p_gpu[n] - p).abs().max() <= 2 * m_cpu["lr"], n


@pytest.mark.cuda
def test_online_targets_on_the_card_match_the_cpu(cuda):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        teacher = build_network(TEACHER)
    stack = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    want = distill.make_online_target_fn(copy.deepcopy(teacher), 0.8)(stack)
    got = distill.make_online_target_fn(teacher.to(cuda), 0.8)(stack.to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def _scorer_step(device, dtype):
    model = init_weights_(DenoiseRatePredictor(dim=4), torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model = model.to(device).set_remat(True).set_compute_dtype(dtype)
    opt = atr.MultiStepsAdam(model.parameters(), 1e-3, 2)
    rng = np.random.default_rng(5)
    losses = []
    for _ in range(2):
        lq = torch.from_numpy(rng.integers(0, 256, (2, 3, 32, 48), dtype=np.uint8)).to(device)
        gt = torch.from_numpy(rng.integers(0, 256, (2, 3, 32, 48), dtype=np.uint8)).to(device)
        score = torch.from_numpy(rng.uniform(-0.5, 0.9, 2).astype(np.float32)).to(device)
        losses.append(float(atr.asdqe_micro_step(model, opt, lq, gt, score, 0.5, dtype)))
    return losses, {k: v.cpu() for k, v in model.state_dict().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_scorer_micro_steps_on_the_card_match_the_cpu(cuda, dtype):
    """Two micro-steps (k = 2: one update), remat on. float32: losses and
    running statistics within 1e-4. bf16 (cuDNN and the CPU round the
    convolutions in other orders; measured 3.3% and 0.5% apart on these two
    losses, which sit close to their targets and so magnify bf16's 2^-8
    rounding): losses within 2^-4 relative, statistics within 2^-5 of their
    scale. Weights within 2 lr x the plateau scale."""
    l_gpu, s_gpu = _scorer_step(cuda, dtype)
    l_cpu, s_cpu = _scorer_step(torch.device("cpu"), dtype)
    bf16 = dtype is not None
    assert l_gpu == pytest.approx(l_cpu, rel=2 ** -4 if bf16 else 1e-4)
    for k, v in s_cpu.items():
        if "running" in k:
            tol = (2 ** -5 if bf16 else 1e-4) * float(v.abs().max())
            assert (s_gpu[k] - v).abs().max() <= tol, k
        elif v.is_floating_point():
            assert (s_gpu[k] - v).abs().max() <= 2 * 1e-3 * 0.5 + 1e-6, k


@pytest.mark.cuda
def test_train_asdqe_on_the_card(cuda, tmp_path):
    roots = write_siqa_corpus(str(tmp_path / "siqa"), 10, 64, 64, seed=3)
    out = atr.train_asdqe(roots, epochs=2, batch_size=2, accumulation_steps=3, gt_size=32,
                          out_dir=str(tmp_path / "w"), log=lambda m: None)
    assert [h["epoch"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["train_mse"]) and np.isfinite(h["val_mse"])
               for h in out["history"])
    assert next(out["model"].parameters()).device.type == "cuda"
    assert sorted(p.name for p in (tmp_path / "w").iterdir()) == [
        "net_g_0.pth", "net_g_1.pth", "net_g_best.pth"]


@pytest.mark.cuda
def test_native_masker_route_on_the_cards_machine(cuda):
    assert native.available()
