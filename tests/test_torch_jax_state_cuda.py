"""Resuming a JAX training state on an NVIDIA GPU: the committed fixture
``artifacts/kdlaes_jax_state`` (the full-width KDLAE-S student after 4 JAX
iterations, ``scripts/export_jax_training_state.py``) through
``train_from_config`` on ``cuda:0``, float32 with TF32 off, to JAX's own
resume's end: ``l_pix`` and ``grad_norm`` within 1e-4 relative of the
values JAX recorded (``jax_resumed.json``), ``lr`` within 1e-7; the
parameters and AdamW's moments on the card, its step counts on the host.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:
python -m pytest --noconftest -m cuda tests/test_torch_jax_state_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import json
import os
import shutil

import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "artifacts", "kdlaes_jax_state")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def test_the_fixture_resumes_on_the_card(cuda, tmp_path):
    with open(os.path.join(FIXTURE, "jax_resumed.json")) as f:
        want = json.load(f)
    opt = tcfg.parse(os.path.join(FIXTURE, want["config"]), True, root_path=str(tmp_path))
    for k in ("dataroot_lq", "dataroot_gt"):
        opt["datasets"]["train"][k] = os.path.join(REPO, opt["datasets"]["train"][k])
    shutil.copytree(os.path.join(FIXTURE, "training_states"), opt["path"]["training_states"])
    state = tloop.train_from_config(opt)
    assert state.step == want["resumed_to"]
    assert all(p.is_cuda for p in state.model.parameters())
    for st in state.optimizer.state.values():
        assert st["exp_avg"].is_cuda and st["exp_avg_sq"].is_cuda
        assert st["step"].device.type == "cpu" and float(st["step"]) == want["resumed_to"]
    with open(os.path.join(opt["path"]["log"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [(r["iter"], r["form"]) for r in records if r["kind"] == "resume"] == [(4, "jax")]
    got = [r for r in records if r["kind"] == "train"]
    assert [r["iter"] for r in got] == [r["iter"] for r in want["train"]]
    for a, b in zip(got, want["train"]):
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-7), a["iter"]
        for k in ("l_pix", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-4), (a["iter"], k)
