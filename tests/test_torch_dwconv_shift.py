"""The blocks' shift-add depthwise form (``dwconv_shift``, which
``train.model_shard`` sets): the port's ``DepthwiseConv3x3`` against the JAX
package's (models/blocks.py:68-99), forward and gradients; a teacher built
or switched to it against the grouped-conv teacher, with the same state
dict and the same weights for the kernels; and its model shards serving as
the grouped teacher's do."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.models.blocks import (
    DepthwiseConv3x3 as JaxDepthwiseConv3x3,
)
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAETeacher
from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import (
    Conv2d,
    DepthwiseConv3x3,
    TransformerBlock,
    flax_block_tree,
    set_dwconv_shift,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.shards import (
    shard_teacher,
    teacher_shards,
)
from rethink_acoustic_image_enhancement_tpu_torch.parallel import mesh as tmesh
from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import LocalShards
import torch_parallel_ranks as ranks

torch.set_num_threads(1)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / max(
        1.0, float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("width", [8, 21])
@pytest.mark.parametrize("bias", [False, True])
def test_shift_conv_matches_jax(bias, width):
    """Forward, and the gradients of the weight, the bias and the input
    under a seeded cotangent, within 1e-6 of the largest value."""
    rng = np.random.default_rng(width + bias)
    x = rng.random((2, 9, 11, width), dtype=np.float32)
    kernel = rng.normal(0, 0.3, (3, 3, 1, width)).astype(np.float32)
    b = rng.normal(0, 0.3, (width,)).astype(np.float32)
    ct = rng.normal(0, 1, (2, 9, 11, width)).astype(np.float32)
    params = {"kernel": kernel, **({"bias": b} if bias else {})}

    def fwd(p, xx):
        return JaxDepthwiseConv3x3(width, bias).apply({"params": p}, xx)

    y, vjp = jax.vjp(fwd, params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))

    conv = DepthwiseConv3x3(width, bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
    assert conv.weight.shape == (width, 1, 3, 3)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = conv(xt)
    (out * torch.from_numpy(ct.transpose(0, 3, 1, 2).copy())).sum().backward()
    assert _rel(out.detach().permute(0, 2, 3, 1), y) <= 1e-6
    assert _rel(xt.grad.permute(0, 2, 3, 1), gx) <= 1e-6
    assert _rel(conv.weight.grad.permute(2, 3, 1, 0), gp["kernel"]) <= 1e-6
    if bias:
        assert _rel(conv.bias.grad, gp["bias"]) <= 1e-6


def _inputs(side=32, seed=3):
    rng = np.random.default_rng(seed)
    return {"img": torch.from_numpy(rng.random((1, 3, side, side), dtype=np.float32)),
            "denoise_rate": torch.full((1, 1, side, side), 0.6)}


@pytest.mark.parametrize("how", ["built", "switched"])
def test_shift_teacher_matches_the_grouped_teacher(how):
    """A teacher switched to ``dwconv_shift`` when built (then loaded with
    the grouped one's state dict) or after it was loaded: the grouped
    teacher's state-dict keys and shapes, its weights for the kernels
    (``flax_block_tree``), 'hq' and 'sr' within 1e-5."""
    grouped = ranks.seeded_model(ranks.TEACHER)
    if how == "built":
        shift = set_dwconv_shift(KDLAETeacher(dim=8, num_blocks=(1, 1, 1, 1),
                                              num_refinement_blocks=1,
                                              layernorm_type="BiasFree", static="train"))
        shift.load_state_dict(grouped.state_dict(), strict=True)
    else:
        shift = set_dwconv_shift(copy.deepcopy(grouped))
    assert shift.dwconv_shift is True
    sd_g, sd_s = grouped.state_dict(), shift.state_dict()
    assert list(sd_g) == list(sd_s)
    assert all(sd_g[k].shape == v.shape for k, v in sd_s.items())
    blocks = [(g, s) for g, s in zip(grouped.modules(), shift.modules())
              if isinstance(g, TransformerBlock)]
    for g, s in blocks:
        assert isinstance(s.attn.qkv_dwconv, DepthwiseConv3x3)
        assert isinstance(s.ffn.dwconv, DepthwiseConv3x3)
        tg, ts = flax_block_tree(g), flax_block_tree(s)
        for part in ("attn", "ffn"):
            for k, v in tg[part].items():
                want = v["kernel"] if isinstance(v, dict) else v
                got = ts[part][k]["kernel"] if isinstance(v, dict) else ts[part][k]
                assert torch.equal(got, want), (part, k)
    x = _inputs()
    with torch.no_grad():
        want, got = grouped(x), shift(x)
    for key in ("hq", "sr"):
        assert not torch.equal(got[key], want[key])  # another order of the same sum
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5)
    assert all(type(m.attn.qkv_dwconv) is Conv2d for m in grouped.modules()
               if isinstance(m, TransformerBlock))


def test_switching_keeps_the_parameters():
    """``set_dwconv_shift`` swaps the modules around the same Parameter
    objects: an optimizer built before the switch still holds them."""
    model = ranks.seeded_model({**ranks.TEACHER, "bias": True})
    before = dict(model.named_parameters())
    set_dwconv_shift(model)
    after = dict(model.named_parameters())
    assert before.keys() == after.keys()
    assert all(after[k] is p for k, p in before.items())


@pytest.mark.parametrize("n", [2, 4])
def test_shift_model_shards_serve_as_before(n):
    """``shard_teacher`` on a shift model: each shard's depthwise convs stay
    shift-add on its slice, and ``teacher_shards`` gives the grouped
    shards' output within 1e-5; ``TeacherPredictor`` on a model mesh serves
    the shift teacher within 1 level of the grouped one on > 99%."""
    grouped = ranks.seeded_model(ranks.TEACHER)
    shift = set_dwconv_shift(copy.deepcopy(grouped))
    x = _inputs()
    outs = []
    for model in (grouped, shift):
        shards = LocalShards(["cpu"] * n)
        mods = shard_teacher(model, shards.devices)
        with torch.no_grad():
            outs.append(teacher_shards(mods, [x["img"]] * n, [x["denoise_rate"]] * n, shards))
    for blk in (m for m in mods[0].modules() if isinstance(m, TransformerBlock)):
        hidden = blk.ffn.project_out.in_channels  # the shard's range
        assert isinstance(blk.ffn.dwconv, DepthwiseConv3x3)
        assert blk.ffn.dwconv.weight.shape == (2 * hidden, 1, 3, 3)
    for key in ("hq", "sr"):
        torch.testing.assert_close(outs[1][key][0], outs[0][key][0], rtol=1e-5, atol=1e-5)
    img = np.random.default_rng(5).random((32, 24, 3)).astype(np.float32)
    mesh = tmesh.make_mesh(n_model=n, devices=["cpu"] * n)
    got = TeacherPredictor(shift, mesh=mesh)(img, 0.7, zero_mask=False)
    ref = TeacherPredictor(grouped, mesh=mesh)(img, 0.7, zero_mask=False)
    for key in ("hq", "sr"):
        diff = np.abs(got[key].astype(np.int16) - ref[key].astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99, key
