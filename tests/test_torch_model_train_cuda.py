"""The model-shard rules of training under autograd on an NVIDIA GPU: the
narrow teacher in its shift-add depthwise form (``dwconv_shift``, which
``train.model_shard`` sets) on 2 and 4 model shards of ``cuda:0``
(``LocalShards``), the loss taken on shard 0's output. Its outputs against
the whole model's, and each leaf's gradient against the whole model's: a
split leaf's slices put back in place (``models/shards.py::unshard``), a
whole leaf's shards' gradients summed (each shard's copy is used where that
shard computes). Float32 with TF32 off, within 1e-5 of each gradient's own
largest magnitude (of the whole model's largest gradient for the ones the
spatial card test names: the cancelling sums of an MDTA temperature); the
forward reaches no kernel. Also the shift-add conv against PyTorch's
grouped conv on the card.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:
python -m pytest --noconftest -m cuda tests/test_torch_model_train_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import (
    Conv2d,
    DepthwiseConv3x3,
    set_dwconv_shift,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.shards import (
    network_shards,
    shard_layout,
    shard_teacher,
    unshard,
)
from rethink_acoustic_image_enhancement_tpu_torch.ops import block, gdfn, layernorm, stage
from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import LocalShards

pytestmark = pytest.mark.cuda
TEACHER = {"type": "KDLAE_teacher", "inp_channels": 3, "out_channels": 3,
           "dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
           "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
           "LayerNorm_type": "BiasFree", "dual_pixel_task": False,
           "static": "train", "params": "cat"}
KERNELS = (stage.fused_transformer_stage, stage.fused_transformer_stage_shards,
           layernorm.fused_channel_layernorm, gdfn.fused_ln_gdfn, gdfn.fused_ln_gdfn_part,
           block.fused_transformer_block)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _loss(out):
    return out["hq"].square().mean() + (out["sr"] - 0.5).abs().mean().sqrt()


def test_shift_conv_matches_the_grouped_conv_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    grouped = Conv2d(96, 96, 3, padding=1, groups=96, bias=True).to(cuda)
    shift = DepthwiseConv3x3(96, bias=True).to(cuda)
    shift.load_state_dict(grouped.state_dict())
    x = torch.rand(1, 96, 128, 96, generator=g, device=cuda, requires_grad=True)
    outs = [m(x) for m in (grouped, shift)]
    grads = [torch.autograd.grad(o.square().sum(), [x, m.weight, m.bias])
             for o, m in zip(outs, (grouped, shift))]
    outs = [o.detach() for o in outs]
    assert float((outs[1] - outs[0]).abs().max()) <= 1e-5 * float(outs[0].abs().max())
    for a, b in zip(grads[1], grads[0]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("n", [2, 4])
def test_local_shards_gradients_on_the_card(cuda, n):
    assert_local_shards_gradients(cuda, n)


def assert_local_shards_gradients(device, n):
    """The module docstring's check on ``n`` shards of ``device`` (also
    run on the CPU by tests/test_torch_model_train.py)."""
    torch.manual_seed(0)
    model = set_dwconv_shift(build_network(TEACHER)).to(device)
    g = torch.Generator(device=device).manual_seed(1)
    x = {"img": torch.rand(2, 3, 64, 48, generator=g, device=device),
         "denoise_rate": torch.full((2, 1, 64, 48), 0.6, device=device)}
    want = model(x)
    names = [k for k, _ in model.named_parameters()]
    g_want = dict(zip(names, torch.autograd.grad(_loss(want), list(model.parameters()))))
    shards = LocalShards([device] * n)
    mods = shard_teacher(model, shards.devices)
    before = [getattr(fn, "launches", 0) for fn in KERNELS]
    out = network_shards(mods, [x] * n, shards)
    got = {k: v[0] for k, v in out.items()}
    loss = _loss(got)
    got = {k: v.detach() for k, v in got.items()}
    want = {k: v.detach() for k, v in want.items()}
    assert [getattr(fn, "launches", 0) for fn in KERNELS] == before  # no kernel
    for k in ("hq", "sr"):
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * float(want[k].abs().max())
    params = [dict(m.named_parameters()) for m in mods]
    flat = [p for ps in params for p in ps.values()]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(grads)
    per = [{k: next(it) for k in ps} for ps in params]
    layout = shard_layout(model, n)
    split = unshard(per, {k: v for k, v in layout.items() if k in g_want})
    top = max(float(v.abs().max()) for v in g_want.values())
    for name, want_g in g_want.items():
        if layout[name] is None:  # whole: the shards' gradients summed
            got_g = sum(torch.zeros_like(want_g) if p[name] is None else p[name] for p in per)
        else:
            got_g = split[name]
        scale = top if name.endswith("temperature") else float(want_g.abs().max())
        assert float((got_g - want_g).abs().max()) <= 1e-5 * max(scale, 1e-30), name
