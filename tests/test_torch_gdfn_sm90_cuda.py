"""The Hopper LN+GDFN kernel (``csrc/stage_sm90_wide.cu``'s ``k_ffn_wide``
through ``raie_gdfn_sm90``) and the model-shard stage on the Hopper tile
kernels (``k_gram_wide`` on a head range, ``k_gram_wgmma`` where a shard holds
every head at C = 96, ``k_proj_wide``) against their plain versions, on an
NVIDIA GPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_gdfn_sm90_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.models.shards import shard_stage_weights
from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import LocalShards

TOL = 1e-2  # of max|ref|: bf16 operands, sums in another order than the plain version's
EPS = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, *shape, scale=1.0, shift=0.0, device="cpu"):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale + shift).to(device)


def _gdfn_weights(rng, c, f, device):
    return (_t(rng, c, scale=0.1, shift=1.0, device=device), _t(rng, c, scale=0.5, device=device),
            _t(rng, 1, 1, c, 2 * f, scale=c ** -0.5, device=device),
            _t(rng, 3, 3, 1, 2 * f, scale=1 / 3, device=device),
            _t(rng, 1, 1, f, c, scale=f ** -0.5, device=device))


def _stage_weights(rng, n, c, heads):
    f = int(c * 2.66)
    return dict(
        ln1_w=_t(rng, n, c, scale=0.1, shift=1.0), w_qkv=_t(rng, n, 1, 1, c, 3 * c, scale=c ** -0.5),
        dw_qkv=_t(rng, n, 3, 3, 1, 3 * c, scale=1 / 3),
        temperature=torch.from_numpy(rng.uniform(0.5, 1.5, size=(n, heads, 1, 1)).astype(
            np.float32)),
        w_proj=_t(rng, n, 1, 1, c, c, scale=c ** -0.5), ln2_w=_t(rng, n, c, scale=0.1, shift=1.0),
        w_in=_t(rng, n, 1, 1, c, 2 * f, scale=c ** -0.5),
        w_dw=_t(rng, n, 3, 3, 1, 2 * f, scale=1 / 3), w_out=_t(rng, n, 1, 1, f, c, scale=f ** -0.5))


def _on(wts, device):
    return {k: v.to(device) for k, v in wts.items()}


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 192, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["bias_free", "with_bias", "none"])
def test_gdfn_kernel_matches_plain(cuda, c, dtype, norm):
    """Batch 2 on a 52 x 44 crop (partial tiles at the right and bottom),
    every LayerNorm variant, within 1e-2 of max|ref| of gdfn_plain, in x's
    dtype, the same bits on a second launch, through the Hopper kernel."""
    rng = np.random.default_rng(c + len(norm))
    lnw, lnb, w_in, w_dw, w_out = _gdfn_weights(rng, c, int(2.66 * c), cuda)
    x = _t(rng, 2, 52, 44, c, device=cuda).to(dtype)
    kw = dict(bias_free=norm == "bias_free", apply_ln=norm != "none")
    before = (pgdfn.fused_ln_gdfn.launches, pgdfn.gdfn_sm90.launches)
    got = pgdfn.fused_ln_gdfn(x, lnw, lnb, w_in, w_dw, w_out, **kw)
    again = pgdfn.fused_ln_gdfn(x, lnw, lnb, w_in, w_dw, w_out, **kw)
    torch.cuda.synchronize()
    assert (pgdfn.fused_ln_gdfn.launches, pgdfn.gdfn_sm90.launches) == (before[0] + 2,
                                                                        before[1] + 2)
    ref = pgdfn.gdfn_plain(x, lnw, lnb, w_in, w_dw, w_out, **kw)
    assert got.dtype == dtype and got.shape == x.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 512, 512, 96), (1, 256, 256, 192), (1, 128, 128, 384)])
def test_gdfn_kernel_at_a_request_shape(cuda, shape):
    """Batch 1 at the shapes the teacher's stages give it, bf16 BiasFree."""
    c = shape[-1]
    rng = np.random.default_rng(c)
    lnw, _, w_in, w_dw, w_out = _gdfn_weights(rng, c, int(2.66 * c), cuda)
    x = _t(rng, *shape, device=cuda).to(torch.bfloat16)
    got = pgdfn.fused_ln_gdfn(x, lnw, None, w_in, w_dw, w_out)
    ref = pgdfn.gdfn_plain(x, lnw, None, w_in, w_dw, w_out)
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 192, 384])
@pytest.mark.parametrize("shard", [0, 1])
def test_gdfn_part_on_a_hidden_range(cuda, c, shard):
    """A model shard's part on 128 (shard 0, the residual added) and 127
    (shard 1, none) of 255 hidden channels at C = 96 (at 192 and 384 the
    halves of their 510 and 1021), fp32 r in and out, within 1e-2 of
    gdfn_part_plain, the same bits twice."""
    rng = np.random.default_rng(c + shard)
    f = 255 if c == 96 else int(2.66 * c)
    wts = _stage_weights(rng, 1, c, c // 48)
    wts.update(w_in=_t(rng, 1, 1, 1, c, 2 * f, scale=c ** -0.5),
               w_dw=_t(rng, 1, 3, 3, 1, 2 * f, scale=1 / 3),
               w_out=_t(rng, 1, 1, 1, f, c, scale=f ** -0.5))
    sw = _on(shard_stage_weights(wts, 2, shard), cuda)
    args = (sw["ln2_w"][0], sw["w_in"][0], sw["w_dw"][0], sw["w_out"][0])
    if c == 96:
        assert args[3].shape[-2] == (128, 127)[shard]
    r = _t(rng, 1, 52, 44, c, device=cuda)
    before = pgdfn.fused_ln_gdfn_part.launches
    got = pgdfn.fused_ln_gdfn_part(r, *args, residual=shard == 0)
    again = pgdfn.fused_ln_gdfn_part(r, *args, residual=shard == 0)
    torch.cuda.synchronize()
    assert pgdfn.fused_ln_gdfn_part.launches == before + 2
    ref = pgdfn.gdfn_part_plain(r, *args, residual=shard == 0)
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("shape,n,heads", [
    ((1, 512, 512, 96), 4, 1), ((1, 512, 512, 96), 4, 2), ((1, 256, 256, 384), 2, 8),
    ((1, 512, 512, 192), 6, 4)])
def test_shard_stage_on_the_hopper_kernels(cuda, n_shards, shape, n, heads):
    """The shapes of chip_smoke.py's phase 18 and a 1024^2 request's
    C = 192 stage, on model shards of cuda:0: within 1e-2 of
    stage_plain_shards and of the whole-image kernel, every shard the same
    bits; 48 channels a head take the Hopper kernels (k_gram_wide on a head
    range, or k_gram_wgmma where a shard holds every head at C = 96, and
    k_proj_wide), one head of 96 keeps csrc/stage.cu's."""
    c = shape[-1]
    rng = np.random.default_rng(c + heads + n_shards)
    wts = _on(_stage_weights(rng, n, c, heads), cuda)
    shards = LocalShards([cuda] * n_shards)
    sw = [shard_stage_weights(wts, n_shards, j) for j in range(n_shards)]
    x = _t(rng, *shape, device=cuda).to(torch.bfloat16)
    xs = [x] * n_shards
    fns = (pblock.gram_wide, pblock.gram_wgmma, pblock.proj_wide, pgdfn.gdfn_sm90)
    before = [fn.launches for fn in fns]
    got = pstage.fused_transformer_stage_shards(xs, sw, shards)
    torch.cuda.synchronize()
    counted = [fn.launches - b for fn, b in zip(fns, before)]
    split = heads % n_shards == 0
    hopper = c // heads == 48
    assert counted == [n * n_shards * (hopper and (split or c != 96)),
                       n * n_shards * (hopper and not split and c == 96),
                       n * n_shards * hopper, n * n_shards]
    plain = pstage.stage_plain_shards(xs, sw, shards)
    whole = pstage.fused_transformer_stage(x, **wts)
    for g in got:
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, got[0])
    assert torch.isfinite(got[0]).all()
    assert _rel(got[0], plain[0]) <= TOL
    assert _rel(got[0], whole) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c,cq", [(96, 48), (192, 96), (384, 192)])
@pytest.mark.parametrize("own", [True, False])
def test_shard_kernels_alone(cuda, c, cq, own):
    """(A) on a head range and (P) with and without x, each against its
    plain version (the Gram's partials summed over the groups, v, r)."""
    heads = cq // 48
    rng = np.random.default_rng(c + cq + own)
    x = _t(rng, 1, 52, 44, c, device=cuda).to(torch.bfloat16)
    wts = _on(_stage_weights(rng, 1, c, c // 48), cuda)
    sw = shard_stage_weights(wts, c // cq, 0)
    p = pblock.pack_blocks(cuda, **sw, shard=True)
    run = pblock.BlockRunner(x, heads, p["fp"], cq=cq)
    assert run.route == "wgmma" and run.wide_gram
    run.gram(x, p, 0, EPS)
    run.softmax(run.part, p, 0)
    r = torch.empty(x.shape, dtype=torch.float32, device=cuda)
    run.project(x if own else None, r, p, 0)
    torch.cuda.synchronize()
    bw = pstage._block_weights(0, c, **sw)
    x32 = x.float()
    qkv = pgdfn.dw3x3(pblock.qkv_hidden(x32, bw.ln1, bw.ln1b, bw.wqkv, EPS), bw.dwqkv)
    part = pblock.gram_part(qkv, heads)  # (1, heads, 48, 48 + 2)
    got = run.part.sum(1)[0]  # Gram (heads, 48, 48), q's norms (cq), k's (cq)
    ng = heads * 48 * 48
    assert _rel(got[:ng].reshape(heads, 48, 48), part[0, ..., :48]) <= TOL
    assert _rel(got[ng:ng + cq], part[0, :, :, 48].reshape(-1)) <= TOL
    assert _rel(got[ng + cq:], part[0, :, :, 49].reshape(-1)) <= TOL
    assert _rel(run.v, qkv[..., 2 * cq:]) <= TOL
    ref = pblock.attend(x32, qkv, part, bw.temp, bw.wproj, residual=own)
    assert _rel(r, ref) <= TOL
