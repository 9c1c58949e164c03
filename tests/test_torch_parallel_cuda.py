"""The data-parallel step on an NVIDIA GPU: two gloo ranks sharing ``cuda:0``
(NCCL refuses two ranks on one card; gloo moves CUDA tensors for
``all_reduce`` and ``broadcast``, the only collectives the port uses)
against one process on the same card at twice the batch.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU. fp32
with TF32 off: loss and grad_norm within 1e-4 relative (the card-vs-CPU
step's tolerance: cuDNN picks its algorithms by batch), each weight within
0.05 lr steps where its gradient exceeds 1e-6 of the largest at every
step, else 2 lr steps; the ranks bit for bit equal."""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _held(results, one):
    first = results[0]
    for other in results[1:]:
        assert other["metrics"] == first["metrics"]
        for n, p in first["params"].items():
            assert torch.equal(other["params"][n], p), n
    for a, b in zip(first["metrics"], one["metrics"], strict=True):
        assert a["lr"] == b["lr"]
        assert a["l_pix"] == pytest.approx(b["l_pix"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    lr = max(m["lr"] for m in one["metrics"])
    tight, loose = 0.05 * lr * ranks.STEPS, 2 * lr * ranks.STEPS
    gmax = [max(float(v.abs().max()) for v in g.values()) for g in one["grads"]]
    for name, want in one["params"].items():
        big = torch.ones(want.shape, dtype=torch.bool)
        for g, top in zip(one["grads"], gmax):
            big &= g[name].abs() > 1e-6 * top
        diff = (first["params"][name] - want).abs()
        assert bool((diff <= torch.where(big, tight, loose)).all()), (name, float(diff.max()))


@pytest.mark.cuda
def test_two_ranks_on_one_card_equal_one_process(cuda, tmp_path):
    out = str(tmp_path / "step")
    for rc, text in ranks.launch("step", out, ["cuda"], timeout=300):
        assert rc == 0, text[-3000:]
    results = [ranks.load_rank(out, r) for r in range(ranks.WORLD)]
    _held(results, ranks.run_step_case(slice(0, 4), "cuda"))
    assert np.isfinite(results[0]["metrics"][-1]["l_pix"])


@pytest.mark.cuda
def test_two_ranks_with_draws_on_one_card(cuda, tmp_path):
    out = str(tmp_path / "losses")
    for rc, text in ranks.launch("losses", out, ["cuda"], timeout=300):
        assert rc == 0, text[-3000:]
    results = [ranks.load_rank(out, r) for r in range(ranks.WORLD)]
    for name in ("L1LossSr", "L1LossForVideoFrames"):
        _held([r[name] for r in results], ranks.run_loss_case(name, slice(0, ranks.BATCH), "cuda"))
