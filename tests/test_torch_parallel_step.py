"""The port's data-parallel training step on the CPU: two gloo ranks, each a
process started with torchrun's env, each holding its rows of the batch.

  * No draws, the narrow KDLAE-T with the L1-Shadow loss: three steps of
    the two ranks against the JAX package's Trainer.step on the
    concatenated batch of 4. Loss, lr and grad_norm within 1e-5 relative;
    the final parameters by the rule of tests/test_torch_train_step.py
    (0.05 lr steps where JAX's gradient exceeds 1e-6 of the largest at
    every step, 2 lr steps elsewhere); the ranks bit for bit equal.
  * With the curriculum's draws (a crop, an extra mask at 0.1, mixup with
    its identity branch) at one row per rank, for every loss of the
    registry: the two ranks against the port's own one-process step on the
    concatenated batch of 2, the same seeds. Loss, lr and grad_norm within
    1e-5 relative, the parameters by the same rule; the ranks bit for bit
    equal. Each rank taking its loss, masks and mixup over its own rows (a
    plain DistributedDataParallel wrapper) gives another loss.
"""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import teacher_state_dict
import torch_parallel_ranks as ranks
from test_torch_train_step import _flax_params, _run_jax

torch.set_num_threads(1)
LAUNCH_S = 150


def _launched(case, tmp_path_factory):
    out = str(tmp_path_factory.mktemp(case) / case)
    for rc, text in ranks.launch(case, out, timeout=LAUNCH_S):
        assert rc == 0, text[-3000:]
    return [ranks.load_rank(out, r) for r in range(ranks.WORLD)]


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    return _launched("step", tmp_path_factory)


@pytest.fixture(scope="module")
def loss_ranks(tmp_path_factory):
    return _launched("losses", tmp_path_factory)


def _ranks_equal(results):
    first = results[0]
    for other in results[1:]:
        assert other["metrics"] == first["metrics"]
        for n, p in first["params"].items():
            assert torch.equal(other["params"][n], p), n


def _step_rule(got: dict, want: dict, grads: list[dict], lr: float, steps: int):
    """Each weight within 0.05 lr steps where its reference gradient
    exceeds 1e-6 of the largest at every step, else within 2 lr steps."""
    tight, loose = 0.05 * lr * steps, 2 * lr * steps
    gmax = [max(np.abs(v).max() for v in g.values()) for g in grads]
    for name, w in want.items():
        big = np.ones(w.shape, bool)
        for g, top in zip(grads, gmax):
            big &= np.abs(g[name]) > 1e-6 * top
        diff = np.abs(got[name] - w)
        assert (diff <= np.where(big, tight, loose)).all(), (name, diff.max())


def _close(got: list[dict], want: list[dict]):
    for a, b in zip(got, want, strict=True):
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert a["l_pix"] == pytest.approx(b["l_pix"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)


@pytest.mark.timeout(300)
def test_two_ranks_equal_the_jax_step_on_the_global_batch(step_ranks):
    _ranks_equal(step_ranks)
    j_metrics, j_grads, j_final, _ = _run_jax({}, _flax_params(), ranks.teacher_batches())
    got = step_ranks[0]
    _close(got["metrics"], j_metrics)
    params = {n: p.numpy() for n, p in got["params"].items()}
    _step_rule(params, j_final, j_grads, max(m["lr"] for m in j_metrics), ranks.STEPS)
    init = teacher_state_dict(_flax_params())
    assert any(not np.array_equal(params[n], v.numpy()) for n, v in init.items())


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(ranks.LOSS_CASES))
def test_two_ranks_equal_one_process_with_draws(loss_ranks, name):
    results = [r[name] for r in loss_ranks]
    _ranks_equal(results)
    one = ranks.run_loss_case(name, slice(0, ranks.BATCH))
    _close(results[0]["metrics"], one["metrics"])
    grads = [{n: g.numpy() for n, g in step.items()} for step in one["grads"]]
    _step_rule({n: p.numpy() for n, p in results[0]["params"].items()},
               {n: p.numpy() for n, p in one["params"].items()}, grads,
               max(m["lr"] for m in one["metrics"]), ranks.STEPS)


@pytest.mark.parametrize("name", ["L1LossSr", "L2Dice", "L1LossForVideoFrames"])
def test_per_rank_losses_are_another_loss(loss_ranks, name):
    """Each rank stepping on its own row alone (its masks and mixup over
    its own rows, its loss over them, the ranks' gradients averaged: a
    plain DDP wrapper's semantics) starts from another loss than the
    global batch's, which the ranks match."""
    global_loss = ranks.run_loss_case(name, slice(0, ranks.BATCH))["metrics"][0]["l_pix"]
    per_rank = [ranks.run_loss_case(name, slice(r, r + 1))["metrics"][0]["l_pix"]
                for r in range(ranks.WORLD)]
    assert loss_ranks[0][name]["metrics"][0]["l_pix"] == pytest.approx(global_loss, rel=1e-5)
    assert abs(np.mean(per_rank) - global_loss) > 1e-3 * abs(global_loss), (per_rank, global_loss)
