"""The port's loss registry against the JAX package's, on the same seeded
inputs (NHWC in JAX, NCHW in the port; frame stacks (N, F, H, W) in both):
every registry loss, with and without a weight, for each reduction,
within 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu import losses as jl
from rethink_acoustic_image_enhancement_tpu_torch import losses as tl
from rethink_acoustic_image_enhancement_tpu_torch.losses import pixel

torch.set_num_threads(2)
RTOL = ATOL = 1e-6


def _img(rng, *shape):
    # values on both sides of the 0.1 shadow threshold, exact zeros too
    a = rng.random(shape).astype(np.float32) * 0.4
    a[..., :2, :] = 0.0
    return a


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


IMAGE_LOSSES = ["L1Loss", "MSELoss", "L1LossSonar", "L1LossChannel"]


@pytest.mark.parametrize("name", IMAGE_LOSSES)
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_image_losses(name, reduction, weighted):
    rng = np.random.default_rng(0)
    pred, target = _img(rng, 2, 12, 10, 3), _img(rng, 2, 12, 10, 3)
    weight = rng.random((2, 12, 10, 3)).astype(np.float32) if weighted else None
    opt = {"type": name, "reduction": reduction, "loss_weight": 0.7}
    if name == "L1LossChannel":
        opt["channel"] = 1
    want = jl.build_loss(opt)(jnp.asarray(pred), jnp.asarray(target),
                              None if weight is None else jnp.asarray(weight))
    got = tl.build_loss(opt)(_nchw(pred), _nchw(target),
                             None if weight is None else _nchw(weight))
    if reduction == "none":
        got = got.permute(0, 2, 3, 1)
    _close(got, want)


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss"])
def test_one_channel_weight_counts_channels(name):
    """A one-channel weight: the reference (NCHW) divides by sum(w) * C
    (loss_util.py:44-50). The JAX package reads axis 1 of an NHWC weight
    (H) there, so the port is held to JAX with the weight broadcast over
    the channels, which both reduce as the reference does."""
    rng = np.random.default_rng(1)
    pred, target = _img(rng, 2, 8, 8, 3), _img(rng, 2, 8, 8, 3)
    w1 = rng.random((2, 8, 8, 1)).astype(np.float32)
    opt = {"type": name, "reduction": "mean"}
    want = jl.build_loss(opt)(jnp.asarray(pred), jnp.asarray(target),
                              jnp.asarray(np.repeat(w1, 3, axis=-1)))
    got = tl.build_loss(opt)(_nchw(pred), _nchw(target), _nchw(w1))
    _close(got, want)


@pytest.mark.parametrize("name,to_y", [("PSNRLoss", False), ("PSNRLoss", True),
                                        ("CharbonnierLoss", None)])
def test_psnr_and_charbonnier(name, to_y):
    rng = np.random.default_rng(2)
    pred, target = _img(rng, 3, 9, 11, 3), _img(rng, 3, 9, 11, 3)
    opt = {"type": name, "loss_weight": 0.5}
    if to_y is not None:
        opt["toY"] = to_y
    want = jl.build_loss(opt)(jnp.asarray(pred), jnp.asarray(target))
    got = tl.build_loss(opt)(_nchw(pred), _nchw(target))
    _close(got, want)


def _pair(rng, with_sr):
    hq = _img(rng, 2, 8, 12, 3)
    sr = _img(rng, 2, 16, 24, 3) if with_sr else None
    return hq, sr


_TEACHER_CASES = [(name, extra, red, case)
                  for name, extra in (("L1LossSr", {}), ("L2Dice", {}),
                                      ("L2Dice", {"soft": True}))
                  for red in ("mean", "sum")
                  for case in ("sr", "no_sr", "no_sr_weighted")]
_TEACHER_CASES.append(("L1LossSr", {}, "none", "no_sr_weighted"))


@pytest.mark.parametrize("name,extra,reduction,case", _TEACHER_CASES)
def test_teacher_losses(name, extra, reduction, case):
    """L1-Shadow and L2-Dice on {'hq', 'sr'} dicts (a weight or 'none'
    only without 'sr': the two scales do not broadcast, in either; L2-Dice's
    Dice term is a scalar, so 'none' is L1-Shadow's only)."""
    rng = np.random.default_rng(3)
    with_sr = case == "sr"
    p_hq, p_sr = _pair(rng, with_sr)
    t_hq, t_sr = _pair(rng, with_sr)
    weight = (rng.random((2, 8, 12, 3)).astype(np.float32)
              if case == "no_sr_weighted" else None)
    opt = {"type": name, "reduction": reduction, "loss_weight": 1.3, **extra}
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else _nchw(a)
    want = jl.build_loss(opt)({"hq": j(p_hq), "sr": j(p_sr)},
                              {"hq": j(t_hq), "sr": j(t_sr)}, j(weight))
    got = tl.build_loss(opt)({"hq": t(p_hq), "sr": t(p_sr)},
                             {"hq": t(t_hq), "sr": t(t_sr)}, t(weight))
    if reduction == "none":
        got = got.permute(0, 2, 3, 1)
    _close(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "max", "none"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["L1Lossweight", "L1LossForVideoFrames"])
def test_frame_stack_losses(name, reduction, weighted):
    rng = np.random.default_rng(4)
    # 'none' of the video loss: one frame (its temporal map has F-1 frames,
    # which does not add to the per-frame map, in either)
    f = 1 if (name, reduction) == ("L1LossForVideoFrames", "none") else 5
    pred, target = _img(rng, 2, f, 8, 8), _img(rng, 2, f, 8, 8)
    weight = rng.random((2, f, 8, 8)).astype(np.float32) if weighted else None
    opt = {"type": name, "reduction": reduction}
    if name == "L1Lossweight":
        opt.update(sigma=1.5, weight=[1.5, 0.5])
    want = jl.build_loss(opt)(jnp.asarray(pred), jnp.asarray(target),
                              None if weight is None else jnp.asarray(weight))
    got = tl.build_loss(opt)(torch.from_numpy(pred), torch.from_numpy(target),
                             None if weight is None else torch.from_numpy(weight))
    _close(got, want)


class _Draw:
    """A generator stand-in that hands out a given uniform draw."""

    def __init__(self, u):
        self.u = u

    def random(self):
        return self.u


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mix_reduction_fed_the_same_draw(seed):
    """'mix': the JAX loss draws u from its key; the port, fed that u,
    takes the same branch and value."""
    rng = np.random.default_rng(5)
    pred, target = _img(rng, 2, 5, 8, 8), _img(rng, 2, 5, 8, 8)
    key = jax.random.PRNGKey(seed)
    u = float(jax.random.uniform(key))
    opt = {"type": "L1LossForVideoFrames", "reduction": "mix"}
    want = jl.build_loss(opt)(jnp.asarray(pred), jnp.asarray(target), rng=key)
    got = tl.build_loss(opt)(torch.from_numpy(pred), torch.from_numpy(target),
                             rng=_Draw(u))
    _close(got, want)
    branch = tl.build_loss({**opt, "reduction": pixel.mix_reduction(u)})
    _close(branch(torch.from_numpy(pred), torch.from_numpy(target)), want)


def test_mix_draws_both_branches_and_needs_a_generator():
    assert {pixel.mix_reduction(float(jax.random.uniform(jax.random.PRNGKey(s))))
            for s in range(4)} == {"mean", "max"}
    x = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError, match="generator"):
        tl.build_loss({"type": "L1LossForVideoFrames", "reduction": "mix"})(x, x)


def test_registry_names_and_unknown_options():
    assert set(tl._REGISTRY) == set(jl._REGISTRY)
    with pytest.raises(KeyError, match="unknown loss"):
        tl.build_loss({"type": "NoSuchLoss"})
    with pytest.raises(KeyError, match="options"):
        tl.build_loss({"type": "L1Loss", "toY": True})


def test_l1_shadow_gradient_reaches_both_heads():
    """The shadow terms carry no gradient; the L1 terms do, on hq and sr."""
    rng = np.random.default_rng(6)
    p = {"hq": _nchw(_img(rng, 1, 8, 8, 3)).requires_grad_(),
         "sr": _nchw(_img(rng, 1, 16, 16, 3)).requires_grad_()}
    t = {"hq": _nchw(_img(rng, 1, 8, 8, 3)), "sr": _nchw(_img(rng, 1, 16, 16, 3))}
    tl.build_loss({"type": "L1LossSr"})(p, t).backward()
    for k, scale in (("hq", 0.5), ("sr", 0.25)):
        g = p[k].grad
        assert torch.allclose(g.abs().max(), torch.tensor(scale / g.numel()))
