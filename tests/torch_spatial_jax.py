"""The JAX package's spatially sharded step (``train.spatial_shard``: its
Trainer on a (data, spatial) mesh of the CPU's virtual devices) beside the
port's, for ``tests/test_torch_spatial_train*.py``.

``jax_step(name)`` runs ``torch_parallel_ranks.SPATIAL_STEPS[name]``'s one
step through JAX's Trainer on its mesh, from the port's seeded weights;
``assert_step_parity`` is the JAX test's rule (tests/test_spatial_train.py:
72-86): loss within 1e-5 relative, grad norm within 1e-4, every parameter
after the AdamW step within 5e-3 relative and 3 lr absolute.
"""

from __future__ import annotations

import numpy as np

import jax

from rethink_acoustic_image_enhancement_tpu.convert.torch_import import CONVERTERS
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


def _flax_params(net: dict):
    sd = ranks.seeded_model(net).state_dict()
    return CONVERTERS[net["type"]]({k: v.numpy().copy() for k, v in sd.items()})


def jax_step_on(kind: str, lq, gt, n_data: int, n_spatial: int):
    """One step of the narrow teacher (L1-Shadow) or student (L1) through
    JAX's Trainer on an n_data x n_spatial mesh, H sharded where
    ``n_spatial`` > 1: (metrics, parameters under the port's names)."""
    net, loss = ((ranks.TEACHER, ranks.L1_SR) if kind == "teacher"
                 else (ranks.STUDENT, ranks.STUDENT_L1))
    params = _flax_params(net)
    schedule = jax_schedule(ranks.TRAIN["optim_g"]["lr"], ranks.TRAIN["scheduler"])
    model = jax_net(net)
    mesh = make_mesh(n_data=n_data, n_spatial=n_spatial,
                     devices=jax.devices()[:n_data * n_spatial])
    trainer = jtr.Trainer(
        apply_fn=jtr.make_teacher_apply(model), loss_fn=jax_loss(loss),
        optimizer=jtr.build_optimizer(ranks.TRAIN, schedule, params=params),
        schedule=schedule, mesh=mesh,
        spatial_axis=(1 if kind == "teacher" else 2) if n_spatial > 1 else None)
    state, m = trainer.step(trainer.init_state(params),
                            jax.tree.map(np.copy, lq), jax.tree.map(np.copy, gt),
                            jax.random.PRNGKey(0))
    to_port = teacher_state_dict if kind == "teacher" else student_state_dict
    final = {k: v.numpy() for k, v in to_port(jax.device_get(state.params)).items()}
    return {k: float(v) for k, v in m.items()}, final


def jax_step(name: str, n_data: int | None = None):
    """``SPATIAL_STEPS[name]`` through JAX on its own grid (``n_data`` data
    indices of the case's bands)."""
    world, n_spatial, kind, b, side = ranks.SPATIAL_STEPS[name]
    (lq, gt), = ranks.spatial_batches(kind, b, side)
    return jax_step_on(kind, lq, gt, world // n_spatial if n_data is None else n_data,
                       n_spatial)


def assert_step_parity(got: dict, want_metrics: dict, want_params: dict):
    """The JAX spatial test's rule (module docstring) for one step."""
    (m,) = got["metrics"]
    lr = want_metrics["lr"]
    np.testing.assert_allclose(m["lr"], lr, rtol=1e-6)
    np.testing.assert_allclose(m["l_pix"], want_metrics["l_pix"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], want_metrics["grad_norm"], rtol=1e-4)
    assert set(got["params"]) == set(want_params)
    for name, w in want_params.items():
        np.testing.assert_allclose(np.asarray(got["params"][name]), w, rtol=5e-3,
                                   atol=3 * lr, err_msg=name)
