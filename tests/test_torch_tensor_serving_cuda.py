"""The stage kernel on model shards (tensor-parallel serving) against its
plain version, the whole-image and band kernels' bits, and the device
guard, on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_tensor_serving_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU. Shards
lie on the cards there are, in turn (all on one where there is one)."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAETeacher, init_weights_
from rethink_acoustic_image_enhancement_tpu_torch.models.shards import shard_stage_weights
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.parallel.mesh import make_mesh
from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import LocalBands, split_rows
from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import LocalShards


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _devices(n):
    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


def _weights(rng, n, c, heads):
    f = int(c * 2.66)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale + shift)

    return dict(
        ln1_w=t(n, c, scale=0.1, shift=1.0), w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
        dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
        temperature=t(n, heads, 1, 1, scale=0.2, shift=1.0),
        w_proj=t(n, 1, 1, c, c, scale=c ** -0.5), ln2_w=t(n, c, scale=0.1, shift=1.0),
        w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5), w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
        w_out=t(n, 1, 1, f, c, scale=f ** -0.5))


def _on(wts, device):
    return {k: v.to(device) for k, v in wts.items()}


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("shape,heads", [
    ((1, 128, 128, 96), 1), ((1, 128, 128, 96), 2), ((1, 64, 64, 384), 8)])
def test_shard_kernel_matches_plain(cuda, dtype, n_shards, shape, heads):
    """One head (every shard the whole MDTA), two heads (split on 2 shards,
    whole on 4) and the 384-channel latent's 8 heads (4 or 2 a shard, the
    wide layout): every shard's output within 1e-2 of max|ref| of the plain
    version on the same shards and of the whole-image kernel, the shards
    bit-equal to one another; the GDFN kernel launched once a block a
    shard."""
    rng = np.random.default_rng(shape[-1] + heads + n_shards)
    wts = _weights(rng, 2, shape[-1], heads)
    shards = LocalShards(_devices(n_shards))
    sw = [_on(shard_stage_weights(wts, n_shards, j), d) for j, d in enumerate(shards.devices)]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    xs = [x.to(d) for d in shards.devices]
    before = (pstage.fused_transformer_stage_shards.launches, pgdfn.fused_ln_gdfn_part.launches)
    got = pstage.fused_transformer_stage_shards(xs, sw, shards)
    torch.cuda.synchronize()
    assert pstage.fused_transformer_stage_shards.launches == before[0] + 1
    assert pgdfn.fused_ln_gdfn_part.launches == before[1] + 2 * n_shards
    plain = pstage.stage_plain_shards(xs, sw, shards)
    whole = pstage.fused_transformer_stage(x, **_on(wts, cuda))
    for g, p in zip(got, plain):
        assert g.dtype == dtype and g.shape == x.shape
        assert torch.isfinite(g).all()
        assert torch.equal(g.to(cuda), got[0])
        assert _rel(g, p) <= 1e-2
    assert _rel(got[0], whole) <= 1e-2


@pytest.mark.cuda
def test_gdfn_part_kernel_matches_plain(cuda):
    """The GDFN kernel on a hidden range (127 of 255), with and without the
    residual, within 1e-2 of its plain version."""
    rng = np.random.default_rng(3)
    wts = shard_stage_weights(_weights(rng, 1, 96, 1), 2, 1)
    r = torch.from_numpy(rng.normal(size=(1, 40, 48, 96)).astype(np.float32)).to(cuda)
    args = (wts["ln2_w"][0].to(cuda), wts["w_in"][0].to(cuda), wts["w_dw"][0].to(cuda),
            wts["w_out"][0].to(cuda))
    assert args[3].shape[-2] == 127
    for residual in (True, False):
        got = pgdfn.fused_ln_gdfn_part(r, *args, residual=residual)
        ref = pgdfn.gdfn_part_plain(r, *args, residual=residual)
        assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((1, 64, 48, 96), 2), ((1, 40, 24, 384), 8)])
def test_whole_and_band_kernels_keep_their_bits(cuda, shape, heads):
    """The whole-image kernel equals itself and one band of the band kernel
    bit for bit (the shard form shares their code), and one shard gives the
    whole-image kernel's output within 1e-2 (its GDFN runs in csrc/gdfn.cu)."""
    rng = np.random.default_rng(11)
    wts = _on(_weights(rng, 2, shape[-1], heads), cuda)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)
    whole = pstage.fused_transformer_stage(x, **wts)
    assert torch.equal(whole, pstage.fused_transformer_stage(x, **wts))
    bands = LocalBands([cuda])
    (band,) = pstage.fused_transformer_stage_bands(split_rows(x, bands.devices, dim=1), [wts],
                                                   bands)
    assert torch.equal(band, whole)
    (one,) = pstage.fused_transformer_stage_shards([x], [wts], LocalShards([cuda]))
    assert _rel(one, whole) <= 1e-2


@pytest.mark.cuda
def test_shard_weights_on_another_card_raise(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    rng = np.random.default_rng(0)
    wts = shard_stage_weights(_weights(rng, 1, 96, 2), 2, 0)
    shards = LocalShards(["cuda:0", "cuda:0"])
    x = torch.zeros(1, 16, 16, 96, device="cuda:0")
    with pytest.raises(ValueError, match="is on cuda:1, x on cuda:0"):
        pstage.fused_transformer_stage_shards([x, x], [_on(wts, "cuda:0"), _on(wts, "cuda:1")],
                                              shards)


@pytest.mark.cuda
def test_model_axis_predictor_on_the_card(cuda):
    """A seeded teacher of the flagship's width (dim 48, one block a stage)
    fused on 2 model shards against one device at 256^2, where the gate
    admits the three 96-channel one-head stages (the whole MDTA on every
    shard, the GDFN split): within 1 level on >= 99% of pixels."""
    m = init_weights_(KDLAETeacher(dim=48, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                                   layernorm_type="BiasFree", static="train"),
                      torch.Generator().manual_seed(0))
    img = np.random.default_rng(1).random((256, 256, 3)).astype(np.float32)
    before = pstage.fused_transformer_stage_shards.launches
    got = TeacherPredictor(m, fused=True, mesh=make_mesh(n_model=2, devices=_devices(2)))(
        img, 0.6, zero_mask=False)
    assert pstage.fused_transformer_stage_shards.launches > before
    ref = TeacherPredictor(m, fused=True, device=cuda)(img, 0.6, zero_mask=False)
    for key in ("hq", "sr"):
        d = np.abs(got[key].astype(np.int16) - ref[key].astype(np.int16))
        assert d.max() <= 1 and (d == 0).mean() >= 0.99, key
