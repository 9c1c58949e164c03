"""The JAX package's tensor-parallel step (``train.model_shard``: its Trainer
on a (data, model) mesh of the CPU's virtual devices, the teacher cloned
with ``dwconv_shift=True`` as its loop clones it) beside the port's, for
``tests/test_torch_model_train*.py``.

``jax_model_steps(name)`` runs ``torch_parallel_ranks.MODEL_STEPS[name]``'s
steps through JAX's Trainer on its mesh, from the port's seeded weights.
Two rules hold the port to it:

  * ``assert_teacher_rule``: JAX tests/test_parallel.py:225-235 (the
    model-axis step against the data-parallel one): the first step's loss
    within 1e-5 absolute and grad norm 1e-4 relative, the second's within
    5e-4 and 5e-2, every parameter within 2e-3 absolute;
  * ``assert_step_parity``: JAX tests/test_spatial_train.py:72-86 for one
    step (the student's model-axis test).

AdamW's first steps move a weight by about lr whatever the size of its
gradient, so both rules pass an update of the wrong piece or sign. The
step rule (``assert_step_rule``, tests/test_torch_train_step.py's) holds
the backward: every weight and EMA entry whose reference gradient is above
1e-6 of the largest at every step lands within 0.05 lr of the reference's
(measured on the CPU: 8e-4 lr against JAX). Against the port's one process
(``tight``) the metrics are held within 1e-5 relative (the grad norm 1e-4)
at every step and those weights within 0.01 lr (measured: 5e-4 lr).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from rethink_acoustic_image_enhancement_tpu.losses import build_loss as jax_loss
from rethink_acoustic_image_enhancement_tpu.models import build_network as jax_net
from rethink_acoustic_image_enhancement_tpu.parallel.mesh import make_mesh
from rethink_acoustic_image_enhancement_tpu.train import trainer as jtr
from rethink_acoustic_image_enhancement_tpu.train.schedules import (
    build_schedule as jax_schedule,
)
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import (
    student_state_dict,
    teacher_state_dict,
)
import torch_parallel_ranks as ranks
from test_torch_train_step import _adam_mu
from torch_spatial_jax import _flax_params, assert_step_parity


def jax_model_steps(name: str, n_data: int | None = None, n_model: int | None = None):
    """``MODEL_STEPS[name]`` through JAX on an n_data x n_model mesh (the
    case's own grid by default): (metrics per step, parameters and EMA
    under the port's names)."""
    world, case_model, kind, b, side, steps = ranks.MODEL_STEPS[name]
    n_model = case_model if n_model is None else n_model
    n_data = world // case_model if n_data is None else n_data
    net, loss = ((ranks.TEACHER, ranks.L1_SR) if kind == "teacher"
                 else (ranks.STUDENT, ranks.STUDENT_L1))
    train = ranks.MODEL_TRAIN[kind]
    params = _flax_params(net)
    schedule = jax_schedule(train["optim_g"]["lr"], train["scheduler"])
    model = jax_net(net)
    if kind == "teacher":
        model = model.clone(dwconv_shift=True)
    mesh = make_mesh(n_data=n_data, n_model=n_model,
                     devices=jax.devices()[:n_data * n_model])
    trainer = jtr.Trainer(
        apply_fn=jtr.make_teacher_apply(model), loss_fn=jax_loss(loss),
        optimizer=jtr.build_optimizer(train, schedule, params=params),
        schedule=schedule, mesh=mesh, ema_decay=ranks.MODEL_EMA[kind])
    state = trainer.init_state(params)
    # every step's state placed where init_state placed it (its uncommitted
    # leaves replicated), so that the step compiles once: XLA places some
    # of a step's outputs over ``model``
    placed = jax.tree.map(lambda x: x.sharding if x.committed
                          else NamedSharding(mesh, P()), state)
    state = jax.device_put(state, placed)
    lq, gt = ranks.model_batch(kind, b, side)
    to_port = teacher_state_dict if kind == "teacher" else student_state_dict

    def host(tree):
        return None if tree is None else {
            k: v.numpy() for k, v in to_port(jax.device_get(tree)).items()}

    b1 = train["optim_g"]["betas"][0]
    metrics, grads, prev_mu = [], [], None
    for k in range(steps):
        # copies: JAX on the CPU may write a donated step's results into numpy memory
        state, m = trainer.step(state, jax.tree.map(np.copy, lq), jax.tree.map(np.copy, gt),
                                jax.random.PRNGKey(k))
        state = jax.device_put(state, placed)
        metrics.append({key: float(v) for key, v in m.items()})
        # the step's (clipped) gradient, from Adam's first moment
        mu = host(_adam_mu(state.opt_state))
        grads.append({n: (v - (0 if prev_mu is None else b1 * prev_mu[n])) / (1 - b1)
                      for n, v in mu.items()})
        prev_mu = mu
    return metrics, host(state.params), host(state.ema_params), grads


def assert_step_rule(got: dict, want_params: dict, want_ema: dict | None,
                     want_grads: list[dict], lr: float, frac: float):
    """Every weight (and EMA entry) whose reference gradient is above 1e-6
    of the largest at every step within ``frac`` lr of the reference's; at
    least half the weights are so held."""
    held = total = 0
    for name, want in want_params.items():
        big = np.ones(want.shape, bool)
        for g in want_grads:
            gmax = max(np.abs(v).max() for v in g.values())
            big &= np.abs(g[name]) > 1e-6 * gmax
        held, total = held + int(big.sum()), total + big.size
        for key, ref in (("params", want_params), ("ema", want_ema)):
            if ref is None:
                continue
            diff = np.abs(np.asarray(got[key][name]) - ref[name])[big]
            assert (diff <= frac * lr).all(), (key, name, diff.max() / lr)
    assert held > total // 2, (held, total)


def assert_teacher_rule(got: dict, want_metrics: list[dict], want_params: dict,
                        want_ema: dict | None, want_grads: list[dict], tight: bool = False):
    """JAX test_parallel.py:225-235's rule (module docstring), the EMA by
    its parameters' bound, and the step rule; ``tight`` against the port's
    one process."""
    (m1, m2), (w1, w2) = got["metrics"], want_metrics
    for m, w in ((m1, w1), (m2, w2)):
        np.testing.assert_allclose(m["lr"], w["lr"], rtol=1e-6)
        if tight:
            np.testing.assert_allclose(m["l_pix"], w["l_pix"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(m1["l_pix"], w1["l_pix"], atol=1e-5)
    np.testing.assert_allclose(m1["grad_norm"], w1["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(m2["l_pix"], w2["l_pix"], atol=5e-4)
    np.testing.assert_allclose(m2["grad_norm"], w2["grad_norm"], rtol=5e-2)
    for key, want in (("params", want_params), ("ema", want_ema)):
        if want is None:
            continue
        assert set(got[key]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(np.asarray(got[key][name]), w, atol=2e-3,
                                       err_msg=f"{key} {name}")
    assert_step_rule(got, want_params, want_ema, want_grads, max(w1["lr"], w2["lr"]),
                     0.01 if tight else 0.05)
