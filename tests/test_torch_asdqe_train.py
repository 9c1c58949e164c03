"""The port's scorer training (``models/asdqe.py`` in training mode and
``train/asdqe_trainer.py``) against the JAX package's.

Dropout is off on both sides where results are compared: in JAX through
``flax.linen.intercept_methods`` on ``nn.Dropout`` (in this file only), in
the port by rate 0. Tolerances:
  * float32: loss and BatchNorm statistics within 1e-5 (relative);
    parameters within 0.05 lr where the sign of the gradient is decided,
    else 2 lr (Adam's first step moves a weight by about lr whatever the size
    of its gradient, so a sign that rounding flips costs 2 lr). Training-mode
    BatchNorm makes the backward pass cancel heavily at batch 2 (the conv
    biases before it have no gradient at all in exact arithmetic), so a
    sign counts as decided where the float64 gradient exceeds 4x the float32
    gradient's largest distance from it in that tensor;
  * bfloat16 compute: XLA and PyTorch round the convolutions differently,
    so the loss and each BatchNorm statistic within twice JAX's own
    distance between its bf16 and its fp32 step (+ 1e-6), every parameter
    within 2 lr.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from rethink_acoustic_image_enhancement_tpu.convert.torch_import import CONVERTERS
from rethink_acoustic_image_enhancement_tpu.models.asdqe import (
    DenoiseRatePredictor as JaxPredictor,
)
from rethink_acoustic_image_enhancement_tpu.train import asdqe_trainer as jtr
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import (
    asdqe_state_dict,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.asdqe import (
    DenoiseRatePredictor,
    Dropout,
    init_weights_,
)
from rethink_acoustic_image_enhancement_tpu_torch.train import asdqe_trainer as ttr

torch.set_num_threads(2)
LR = 1e-3
DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _seeded(dim=4, seed=0):
    """A port scorer with seeded weights and non-trivial running stats."""
    return init_weights_(DenoiseRatePredictor(dim=dim), torch.Generator().manual_seed(seed))


def _to_jax(model):
    """(params, batch_stats), copies: the port's step later writes the
    tensors in place."""
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return CONVERTERS["DenoiseRatePredictor"](sd)


def _batch(seed, b=2, h=32, w=48):
    rng = np.random.default_rng(seed)
    lq = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    gt = np.clip(lq.astype(np.int16) + rng.integers(-20, 21, lq.shape), 0, 255).astype(np.uint8)
    return lq, gt, rng.uniform(-0.5, 0.9, b).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _float64_grads(state, lq, gt, score):
    """The training-mode gradient of the loss in float64 (dropout off)."""
    model = _dropout_off(DenoiseRatePredictor(dim=4)).double().train()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    out = model(_nchw(lq).double() / 255, _nchw(gt).double() / 255)
    loss = torch.mean(torch.square(out.reshape(-1) - torch.from_numpy(score).double()))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {n: g.numpy() for (n, _), g in zip(model.named_parameters(), grads)}


def _jax_grads(params, stats, lq, gt, score):
    """JAX's float32 training-mode gradient of the same loss, port names."""
    model = JaxPredictor(dim=4)

    def loss(p):
        x, y = (jnp.asarray(a).astype(jnp.float32) / 255.0 for a in (lq, gt))
        with fnn.intercept_methods(_no_dropout):
            out, _ = model.apply({"params": p, "batch_stats": stats}, x, y, train=True,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(jnp.square(out.reshape(-1) - score))

    g = jax.jit(jax.grad(loss))(params)
    return {k: v.numpy() for k, v in asdqe_state_dict(g, stats).items()}


def _step_rule(got, want, init, decided, lr):
    """0.05 lr where ``decided``, 2 lr elsewhere (True: everywhere)."""
    for name, w in want.items():
        # 2 lr, and a float32 ulp of a weight near 1
        tol = np.where(decided is True or decided[name], 0.05 * lr, 2 * lr + 1e-6)
        diff = np.abs(got[name] - w)
        assert (diff <= tol).all(), (name, diff.max())
        assert not np.array_equal(w, init[name]) or "running" in name or \
            "num_batches" in name, name


def _jax_step(params, stats, lq, gt, score, jdt):
    """One make_asdqe_train_step micro-step (k = 1), dropout off."""
    tx = optax.MultiSteps(optax.adam(LR), every_k_schedule=1)
    step = jtr.make_asdqe_train_step(JaxPredictor(dim=4, dtype=jdt), tx, jdt)
    with fnn.intercept_methods(_no_dropout):
        jp, js, _, jloss = step(params, stats, tx.init(params), jnp.asarray(lq),
                                jnp.asarray(gt), jnp.asarray(score),
                                jax.random.PRNGKey(0), jnp.float32(1.0))
    return ({k: v.numpy() for k, v in asdqe_state_dict(jp, js).items()},
            float(jloss))


@pytest.fixture(scope="module")
def fp32_step():
    """JAX's float32 micro-step, shared by both cases (one compile)."""
    params, stats = _to_jax(_seeded())
    lq, gt, score = _batch(1)
    return _jax_step(params, stats, lq, gt, score, None)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_micro_step_matches_jax(dtype, fp32_step):
    jdt, tdt = DTYPES[dtype]
    model = _seeded()
    params, stats = _to_jax(model)
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    lq, gt, score = _batch(1)
    want32, jloss32 = fp32_step
    want, jloss = fp32_step if jdt is None else _jax_step(params, stats, lq, gt, score, jdt)

    port = _dropout_off(model).set_compute_dtype(tdt)
    opt = ttr.MultiStepsAdam(port.parameters(), LR, 1)
    grads = {}
    update = opt.update

    def recording(g, scale=1.0):
        grads.update({n: x.numpy().copy() for (n, _), x in
                      zip(port.named_parameters(), g)})
        return update(g, scale)

    opt.update = recording
    loss = float(ttr.asdqe_micro_step(port, opt, _nchw(lq), _nchw(gt),
                                      torch.from_numpy(score), 1.0, tdt))
    got = {k: v.numpy() for k, v in port.state_dict().items()}
    stat_names = [k for k in want if "running" in k]
    for name in stat_names:
        assert not np.array_equal(got[name], init[name]), name
    params_only = {k: v for k, v in want.items() if k in grads}
    if dtype == "fp32":
        assert loss == pytest.approx(jloss, rel=1e-5)
        for name in stat_names:  # the biased variance at momentum 0.9
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        g64 = _float64_grads(init, lq, gt, score)
        jgrads = _jax_grads(params, stats, lq, gt, score)
        decided = {n: np.abs(g64[n]) > 4 * max(np.abs(grads[n] - g64[n]).max(),
                                               np.abs(jgrads[n] - g64[n]).max())
                   for n in grads}
        # the tight rule is not vacuous: most signs are decided (85% here)
        assert sum(int(d.sum()) for d in decided.values()) > 0.75 * sum(
            d.size for d in decided.values())
        _step_rule(got, params_only, init, decided, LR)
        return
    # bf16: within twice JAX's own bf16-vs-fp32 spread
    assert abs(loss - jloss) <= 2 * abs(jloss - jloss32) + 1e-6, (loss, jloss, jloss32)
    for name in stat_names:
        spread = np.abs(want[name] - want32[name]).max()
        assert np.abs(got[name] - want[name]).max() <= 2 * spread + 1e-6, name
    _step_rule(got, params_only, init, {n: False for n in grads}, LR)


def test_running_variance_is_flaxs_biased_one():
    """At a 1x1 feature map of batch 2 the unbiased variance is twice the
    biased one: the running update must take the biased one."""
    bn = DenoiseRatePredictor(dim=4).lq_extractor.double_conv[1]
    x = torch.tensor([[[[1.0]], [[2.0]], [[0.0]], [[4.0]]],
                      [[[3.0]], [[2.0]], [[2.0]], [[0.0]]]])
    bn.train()(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * biased.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * x.mean(dim=(0, 2, 3)).numpy(), rtol=1e-6)


def test_remat_changes_nothing():
    lq, gt, score = _batch(2)
    results = []
    for remat in (False, True):
        model = _dropout_off(_seeded(seed=3)).set_remat(remat).train()
        out = model(_nchw(lq).float() / 255, _nchw(gt).float() / 255)
        loss = torch.mean(torch.square(out.reshape(-1) - torch.from_numpy(score)))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        stats = [b.clone() for n, b in model.named_buffers() if "running" in n]
        results.append((loss.detach(), grads, stats))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0 + tuple(s0), g1 + tuple(s1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_multisteps_adam_matches_optax_across_updates():
    """k = 3 over 7 micro-steps with a plateau scale that changes between
    updates (the scale of the emitting micro-step counts): the parameters
    after each micro-step against optax.MultiSteps + the scaled update."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.MultiSteps(optax.adam(LR), every_k_schedule=3)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ttr.MultiStepsAdam(tp, LR, 3)
    emitted = []
    for k in range(7):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        scale = 0.5 if k >= 4 else 1.0
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, [u * scale for u in upd])
        emitted.append(opt.update([torch.from_numpy(x) for x in g], scale))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert emitted == [False, False, True, False, False, True, False]
    assert opt.mini_step == int(state.mini_step) == 1


def test_plateau_sequences_match_jax():
    rng = np.random.default_rng(1)
    for patience in (0, 1, 5):
        for _ in range(5):
            seq = list(np.round(rng.uniform(0, 1, 30), 1)) + [float("nan")] * 3
            a = ttr.ReduceLROnPlateau(patience=patience, min_scale=0.1)
            b = jtr.ReduceLROnPlateau(patience=patience, min_scale=0.1)
            assert [a.step(x) for x in seq] == [b.step(x) for x in seq]


def test_dropout_keep_rates_within_three_sigma():
    model = DenoiseRatePredictor(dim=4).train()
    model.set_dropout_generator(torch.Generator().manual_seed(5))
    n = 200_000
    for layer, keep in ((model.regressor[4], 0.5), (model.regressor[7], 0.7)):
        y = layer(torch.ones(n))
        kept = float((y != 0).float().mean())
        assert abs(kept - keep) <= 3 * (keep * (1 - keep) / n) ** 0.5, (keep, kept)
        assert torch.allclose(y[y != 0], torch.tensor(1 / keep))
    a = model.set_dropout_generator(torch.Generator().manual_seed(5)).regressor[4](torch.ones(64))
    b = model.set_dropout_generator(torch.Generator().manual_seed(5)).regressor[4](torch.ones(64))
    assert torch.equal(a, b)
    assert torch.equal(model.eval().regressor[4](torch.ones(64)), torch.ones(64))
