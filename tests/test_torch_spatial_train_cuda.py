"""The band rules under autograd on an NVIDIA GPU: the narrow teacher and
the student on 2 and 4 row bands of ``cuda:0`` (``LocalBands``), their
outputs and every parameter's gradient against the whole-image forward
and backward in float32 with TF32 off, each within 1e-5 of its own largest
magnitude (the CPU twin's bound, tests/test_torch_spatial_train.py), and
the forward through ``network_bands`` reaching no kernel.

A parameter whose gradient is a sum of cancelling terms (such as an MDTA
temperature's) carries float32's rounding at that scale in the whole
image's backward itself, so float32 does not fix it to the bound. Where the
whole image's gradient on the card is more than half the bound (5e-6 of its
own largest magnitude) from the same float32 gradient on the CPU (another
order of the same sums), the bands' is held to 1e-5 of the whole model's
largest gradient instead; the test prints those parameters and that
distance. (``mdta_core`` takes its products in float32 whatever the model's
dtype, so a float64 model is no reference for these.)

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:
python -m pytest --noconftest -m cuda tests/test_torch_spatial_train_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.models.bands import network_bands
from rethink_acoustic_image_enhancement_tpu_torch.ops import block, gdfn, layernorm, stage
from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import (
    LocalBands,
    join_rows,
    split_rows,
)

pytestmark = pytest.mark.cuda
TEACHER = {"type": "KDLAE_teacher", "inp_channels": 3, "out_channels": 3,
           "dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
           "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
           "LayerNorm_type": "BiasFree", "dual_pixel_task": False,
           "static": "train", "params": "cat"}
KERNELS = (stage.fused_transformer_stage, stage.fused_transformer_stage_bands,
           layernorm.fused_channel_layernorm, gdfn.fused_ln_gdfn,
           block.fused_transformer_block)
STUDENT = {"type": "KDLAE_student", "inp_channels": 1, "out_channels": 1,
           "residual": True, "hidden_channels": [16, 32, 64]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _loss(out):
    if isinstance(out, dict):
        return out["hq"].square().mean() + (out["sr"] - 0.5).abs().mean().sqrt()
    return out.square().mean().sqrt()


def _whole(kind, device, inputs_on):
    """The seeded model on ``device``, its input (drawn on ``inputs_on``),
    output and gradients."""
    torch.manual_seed(0)
    model = build_network(TEACHER if kind == "teacher" else STUDENT).to(device)
    g = torch.Generator(device=inputs_on).manual_seed(1)
    if kind == "teacher":
        img = torch.rand(2, 3, 128, 96, generator=g, device=inputs_on).to(device)
        x = {"img": img, "denoise_rate": torch.full((2, 1, 128, 96), 0.6, device=device)}
    else:
        x = torch.rand(2, 7, 64, 48, generator=g, device=inputs_on).to(device)
    want = model(x)
    return model, x, want, torch.autograd.grad(_loss(want), list(model.parameters()))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["teacher", "student"])
def test_local_bands_gradients_on_the_card(cuda, kind, n):
    model, x, want, g_want = _whole(kind, cuda, cuda)
    params = list(model.parameters())
    bands = LocalBands([cuda] * n)
    if kind == "teacher":
        parts = zip(split_rows(x["img"], bands.devices),
                    split_rows(x["denoise_rate"], bands.devices))
        lqs = [{"img": a, "denoise_rate": b} for a, b in parts]
    else:
        lqs = split_rows(x, bands.devices)
    before = [getattr(fn, "launches", 0) for fn in KERNELS]
    out = network_bands([model] * n, lqs, bands)
    got = ({k: join_rows(v, cuda) for k, v in out.items()} if isinstance(out, dict)
           else join_rows(out, cuda))
    g_got = torch.autograd.grad(_loss(got), params)
    # training's band rules (fused=False) reach no kernel
    assert [getattr(fn, "launches", 0) for fn in KERNELS] == before
    pairs = [(got[k], want[k]) for k in want] if isinstance(want, dict) else [(got, want)]
    for a, b in pairs:
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    # each parameter within 1e-5 of its own largest magnitude, but the
    # cancelling sums (module docstring)
    scale = [float(b.abs().max()) for b in g_want]
    top = max(scale)
    g_cpu = _whole(kind, torch.device("cpu"), cuda)[3]
    for k, (name, _) in enumerate(model.named_parameters()):
        off = float((g_want[k].cpu() - g_cpu[k]).abs().max())
        if off > 5e-6 * scale[k]:
            print(f"{kind} on {n} bands: {name}'s whole-image gradient on the card is "
                  f"{off:.3g} from the CPU's, on {scale[k]:.3g}: held to 1e-5 of {top:.3g}")
            scale[k] = top
    for (name, _), a, b, s in zip(model.named_parameters(), g_got, g_want, scale):
        assert s > 0, name
        assert float((a - b).abs().max()) <= 1e-5 * s, name
