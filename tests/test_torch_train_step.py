"""Three steps of the port's Trainer against the JAX package's Trainer on
the same parameters (a flax tree carried into the port by
``convert/weights.py::teacher_state_dict``) and the same batches: the
narrow KDLAE-T with the L1-Shadow loss, AdamW betas (0.2, 0.999) and decay
5e-5, the 0.01 clip and the cyclic cosine schedule.

Loss, lr and grad_norm per step are held within 1e-5 relative in float32.
Adam's first steps move each weight by about lr whatever the size of its
gradient, so where rounding flips the sign of a near-zero gradient the
weight lands 2 lr away: the final parameters are held within
0.05 lr steps on every element whose JAX gradient exceeds 1e-6 of the
largest at every step, and the rest within 2 lr steps; the EMA copy is
held by the same rule. Two more cases add freeze_except and bf16 compute
(its tolerances below). The
port's step draws nothing here: no curriculum crop, mask or mixup."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from rethink_acoustic_image_enhancement_tpu.convert.torch_import import CONVERTERS
from rethink_acoustic_image_enhancement_tpu.losses import build_loss as jax_loss
from rethink_acoustic_image_enhancement_tpu.models import build_network as jax_net
from rethink_acoustic_image_enhancement_tpu.parallel.mesh import make_mesh
from rethink_acoustic_image_enhancement_tpu.train import trainer as jtr
from rethink_acoustic_image_enhancement_tpu.train.schedules import (
    build_schedule as jax_schedule,
)
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import (
    teacher_state_dict,
)
from rethink_acoustic_image_enhancement_tpu_torch.losses import build_loss
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    TransformerStage,
    build_network,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import TransformerBlock
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
from rethink_acoustic_image_enhancement_tpu_torch.train.schedules import build_schedule
from torch_train_corpus import NARROW

torch.set_num_threads(2)
STEPS = 3
NET = {"type": "KDLAE_teacher", "inp_channels": 3, "out_channels": 3,
       **NARROW, "ffn_expansion_factor": 2.66, "bias": False,
       "LayerNorm_type": "BiasFree", "dual_pixel_task": False,
       "static": "train", "params": "cat"}
TRAIN = {"optim_g": {"type": "AdamW", "lr": 1e-3, "weight_decay": 5e-5,
                     "betas": [0.2, 0.999]},
         "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                       "periods": [2, 10], "restart_weights": [1, 1],
                       "eta_mins": [3e-4, 1e-6]},
         "pixel_opt": {"type": "L1LossSr", "loss_weight": 1, "reduction": "mean"},
         "use_grad_clip": True}
FREEZE = ["patch_embed", "cen", "upen", "enhance", "outputen"]
# the EMA copy leaves the steps as they are: its case is also the plain
# float32 case (one JAX compile fewer)
CASES = {
    "fp32_ema": {"ema_decay": 0.9},
    "freeze_except": {"freeze_except": FREEZE},
    "bf16": {"compute_dtype": "bf16"},
}


def _flax_params(seed=0):
    """Seeded float32 weights (PyTorch's default initialisation) as a flax
    tree, through the JAX package's reference-.pth converter."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        sd = build_network(NET).state_dict()
    return CONVERTERS["KDLAE_teacher"]({k: v.numpy() for k, v in sd.items()})


def _batches(seed=1, b=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        img = rng.random((b, h, w, 3)).astype(np.float32) * 0.8
        img[:, : h // 4] = 0.0
        hq = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
        out.append(({"img": img, "denoise_rate": np.full((b, h, w, 1), 0.6,
                                                         np.float32)},
                    {"hq": hq, "sr": np.repeat(np.repeat(hq, 2, 1), 2, 2)}))
    return out


def _nchw(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in tree.items()}


def _adam_mu(opt_state):
    """The first-moment tree of the optax chain's Adam state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu
    if isinstance(opt_state, dict):
        items = opt_state.values()
    elif isinstance(opt_state, (tuple, list)):
        items = opt_state
    else:
        return None
    for x in items:
        found = _adam_mu(x)
        if found is not None:
            return found
    return None


def _sd(tree):
    """A flax tree (frozen leaves masked out) -> port names and layouts."""
    leaves = jax.tree_util.tree_map(
        lambda x: None if type(x).__name__ == "MaskedNode" else np.asarray(x),
        tree, is_leaf=lambda x: type(x).__name__ == "MaskedNode")
    return {k: v.numpy() for k, v in teacher_state_dict(_drop_none(leaves)).items()}


def _drop_none(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _drop_none(v)
            if sub:
                out[k] = sub
        elif v is not None:
            out[k] = v
    return out


def _run_jax(opts, params, batches):
    train_opt = {**TRAIN, **opts}
    schedule = jax_schedule(train_opt["optim_g"]["lr"], train_opt["scheduler"])
    mesh = make_mesh(n_data=1, devices=jax.devices()[:1])
    dtype = {"bf16": jax.numpy.bfloat16}.get(opts.get("compute_dtype"))
    model = jax_net(NET)
    trainer = jtr.Trainer(
        apply_fn=jtr.make_teacher_apply(model),
        loss_fn=jax_loss(train_opt["pixel_opt"]),
        optimizer=jtr.build_optimizer(train_opt, schedule, params=params),
        schedule=schedule, mesh=mesh, ema_decay=opts.get("ema_decay", 0.0),
        compute_dtype=dtype)
    # placed as the step's outputs are, so the step compiles once
    state = jax.device_put(trainer.init_state(params), NamedSharding(mesh, P()))
    metrics, grads, prev_mu = [], [], None
    for k, (lq, gt) in enumerate(batches):
        state, m = trainer.step(state, lq, gt, jax.random.PRNGKey(k))
        metrics.append({k2: float(v) for k2, v in m.items()})
        mu = _sd(_adam_mu(state.opt_state))
        b1 = train_opt["optim_g"]["betas"][0]
        # the (clipped) gradient of this step, from Adam's first moment
        grads.append({n: (v - (0 if prev_mu is None else b1 * prev_mu[n])) / (1 - b1)
                      for n, v in mu.items()})
        prev_mu = mu
    final = _sd(state.params)
    ema = None if state.ema_params is None else _sd(state.ema_params)
    return metrics, grads, final, ema


def _run_port(opts, params, batches):
    train_opt = {**TRAIN, **opts}
    model = build_network(NET)
    model.load_state_dict(teacher_state_dict(params), strict=True)
    trainer = ttr.Trainer(
        model=model, loss_fn=build_loss(train_opt["pixel_opt"]),
        optimizer=ttr.build_optimizer(train_opt),
        schedule=build_schedule(train_opt["optim_g"]["lr"], train_opt["scheduler"]),
        device="cpu", ema_decay=opts.get("ema_decay", 0.0),
        compute_dtype=ttr.compute_dtype(opts.get("compute_dtype", "float32")))
    state = trainer.init_state()
    metrics = []
    for lq, gt in batches:
        state, m = trainer.step(state, _nchw(lq), _nchw(gt),
                                np.random.default_rng(0))
        metrics.append({k: float(v) for k, v in m.items()})
    final = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ema = (None if state.ema is None
           else {k: v.numpy() for k, v in state.ema.state_dict().items()})
    return metrics, final, ema


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(case):
    opts = CASES[case]
    params = _flax_params()
    batches = _batches()
    j_metrics, j_grads, j_final, j_ema = _run_jax(opts, params, batches)
    t_metrics, t_final, t_ema = _run_port(opts, params, batches)

    bf16 = case == "bf16"
    # bf16 compute rounds to 8-bit mantissas, in another order in XLA than
    # in PyTorch: the loss within one bf16 rounding (2^-8), grad_norm
    # within 1e-2 (measured: 6e-4 and 2.3e-3), and every weight within the
    # loose bound, since bf16 gradients flip Adam's sign often
    rel_loss, rel_norm = (4e-3, 1e-2) if bf16 else (1e-5, 1e-5)
    for want, got in zip(j_metrics, t_metrics):
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        assert got["l_pix"] == pytest.approx(want["l_pix"], rel=rel_loss)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=rel_norm)

    lr = max(m["lr"] for m in j_metrics)
    tight, loose = 0.05 * lr * STEPS, 2 * lr * STEPS
    init = teacher_state_dict(params)
    moved = 0
    for name, want in j_final.items():
        got = t_final[name]
        if case == "freeze_except" and not any(
                name.startswith(p) for p in FREEZE):
            np.testing.assert_array_equal(got, init[name].numpy(), err_msg=name)
            np.testing.assert_array_equal(want, init[name].numpy(), err_msg=name)
            continue
        big = np.ones(want.shape, bool)
        for g in j_grads:
            gmax = max(np.abs(v).max() for v in g.values())
            big &= np.abs(g[name]) > 1e-6 * gmax
        tol = np.where(big, loose if bf16 else tight, loose)
        diff = np.abs(got - want)
        assert (diff <= tol).all(), (name, diff.max(), (diff > tol).sum())
        if j_ema is not None:
            assert (np.abs(t_ema[name] - j_ema[name]) <= tol).all(), name
        moved += int((np.abs(want - init[name].numpy()) > 0).sum())
    assert moved > 0


def _step_once(model, **kw):
    trainer = ttr.Trainer(model=model, loss_fn=build_loss(TRAIN["pixel_opt"]),
                          optimizer=ttr.build_optimizer(TRAIN),
                          schedule=build_schedule(1e-3, TRAIN["scheduler"]),
                          device="cpu", **kw)
    state = trainer.init_state()
    lq, gt = _batches(b=1, h=16, w=16)[0]
    return trainer.step(state, _nchw(lq), _nchw(gt), np.random.default_rng(0))


def test_every_parameter_gets_a_gradient():
    """static='train' with params='cat': the rate path and the SR head
    included, nothing held in eval mode or cut from the graph."""
    state, _ = _step_once(build_network(NET))
    missing = [n for n, p in state.model.named_parameters()
               if p.grad is None or not torch.any(p.grad != 0)]
    assert not missing, missing


@pytest.mark.parametrize("where", ["stage", "block"])
def test_trainer_refuses_fused_stages_and_blocks(where):
    model = build_network(NET)
    if where == "stage":
        model.set_fused(True)
    else:
        next(m for m in model.modules() if isinstance(m, TransformerBlock)).fused = True
    with pytest.raises(ValueError, match="no backward pass"):
        _step_once(model)
    assert any(isinstance(m, TransformerStage) for m in model.modules())


def test_clip_follows_optax():
    """Below max_norm the gradient is left as it is; at or above it, it is
    scaled to exactly max_norm (no epsilon)."""
    model = build_network(NET)
    state, m = _step_once(model)
    grads = [p.grad for p in state.model.parameters()]
    assert float(ttr.global_norm(grads)) == pytest.approx(
        min(float(m["grad_norm"]), 0.01), rel=1e-5)


def test_unsupported_optimizer_and_dtype():
    with pytest.raises(KeyError, match="unsupported optimizer"):
        ttr.build_optimizer({"optim_g": {"type": "SGD", "lr": 1}})
    with pytest.raises(KeyError, match="compute_dtype"):
        ttr.compute_dtype("int8")


def test_no_gpu_default_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.Trainer(model=build_network(NET), loss_fn=None,
                    optimizer=ttr.build_optimizer(TRAIN), schedule=None)
