"""The Hopper kernels (A), (P) and (F) at C = 192 and 384
(``csrc/stage_sm90_wide.cu``) against the plain versions, on an NVIDIA GPU:
each kernel alone, the stage and one block at the shapes of a 1024^2 and a
2048^2 teacher request's deeper stages, and a band against the whole image.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_stage_sm90_wide_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import ctypes

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.ops.gdfn import dw3x3, ffn_f32
from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import LocalBands

TOL = 1e-2  # of max|ref|: bf16 operands, sums in another order than the plain version's
EPS = 1e-5


def _weights(rng, n, c, heads, device, bias=False):
    f = int(c * 2.66)

    def t(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device)

    w = dict(ln1_w=t(n, c, scale=0.1, shift=1.0), w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
             dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
             temperature=t(n, heads, 1, 1, scale=0.2, shift=1.0),
             w_proj=t(n, 1, 1, c, c, scale=c ** -0.5), ln2_w=t(n, c, scale=0.1, shift=1.0),
             w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5), w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
             w_out=t(n, 1, 1, f, c, scale=f ** -0.5))
    if bias:
        w.update(ln1_b=t(n, c, scale=0.5), ln2_b=t(n, c, scale=0.5))
    return w


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [192, 384])
def test_library_agrees_with_the_host_on_the_tile(cuda, c):
    lib = pblock.wide_lib()
    vals = [ctypes.c_int() for _ in range(4)]
    assert lib.raie_stage_wide_geometry(c, *[ctypes.byref(v) for v in vals]) == 0
    th, tw, fc, threads = (v.value for v in vals)
    assert (th, tw) == pblock.WIDE_TILE[c] and fc == pblock.WGMMA_FC and threads == 512
    assert [lib.raie_stage_wide_blocks_per_sm(k, c) for k in range(3)] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((1, 512, 512, 192), 4), ((1, 256, 256, 384), 8),
                                         ((1, 61, 77, 192), 4), ((1, 37, 45, 384), 8)])
def test_each_kernel_matches_its_plain_version(cuda, shape, heads):
    """(A)'s v, Gram and norms, (P)'s r (from the kernels' v and attn^T)
    and (F)'s output (from the kernel's r), each against its plain version
    on the same inputs; the last two shapes cut every kind of tile."""
    rng = np.random.default_rng(shape[1])
    c = shape[-1]
    wts = _weights(rng, 1, c, heads, cuda)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)
    p = pblock.pack_blocks(x.device, **wts)
    run = pblock.BlockRunner(x, heads, p["fp"])
    assert run.route == "wgmma" and run.wide
    w32 = {k: v[0].float() for k, v in wts.items()}
    f = int(c * 2.66)
    x32 = x.float()
    counts = (pblock.gram_wide.launches, pblock.proj_wide.launches, pblock.ffn_wide.launches)
    run.gram(x, p, 0, EPS)
    torch.cuda.synchronize()
    qkv = dw3x3(pblock.qkv_hidden(x32, w32["ln1_w"], None, w32["w_qkv"].reshape(c, 3 * c), EPS),
                w32["dw_qkv"].reshape(3, 3, 3 * c))
    gp = pblock.gram_part(qkv, heads)
    part = run.part.sum(1)
    hc = c // heads
    gram = part[:, :heads * hc * hc].reshape(gp[..., :hc].shape)
    norms = part[:, heads * hc * hc:].reshape(1, 2, heads, hc)
    assert _rel(run.v, qkv[..., 2 * c:]) <= TOL
    assert _rel(gram, gp[..., :hc]) <= TOL
    assert _rel(norms, torch.stack([gp[..., hc], gp[..., hc + 1]], 1)) <= TOL
    run.softmax(run.part, p, 0)
    y = torch.empty(shape, dtype=torch.float32, device=cuda)
    run.apply(x, y, p, 0, EPS)
    torch.cuda.synchronize()
    at = run.attn_t[0].float()  # [head][d][c] = attn[c][d]
    attn = torch.block_diag(*[at[h].t() for h in range(heads)])
    oa = run.v.float() @ attn.t().bfloat16().float()
    r = x32 + oa.bfloat16().float() @ w32["w_proj"].reshape(c, c).bfloat16().float()
    assert _rel(run.r, r) <= TOL
    ref = ffn_f32(run.r, w32["ln2_w"], None, w32["w_in"].reshape(c, 2 * f),
                  w32["w_dw"].reshape(3, 3, 2 * f), w32["w_out"].reshape(f, c), EPS)
    assert _rel(y, ref) <= TOL
    assert (pblock.gram_wide.launches, pblock.proj_wide.launches,
            pblock.ffn_wide.launches) == tuple(n + 1 for n in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,n,heads", [
    ((1, 256, 256, 192), 6, 4), ((1, 512, 512, 192), 6, 4), ((1, 256, 256, 384), 8, 8)])
def test_stage_matches_plain_and_repeats_its_bits(cuda, dtype, shape, n, heads):
    rng = np.random.default_rng(shape[1] + n * 10 + heads)
    wts = _weights(rng, n, shape[-1], heads, cuda)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    before = (pstage.fused_transformer_stage.launches, pblock.ffn_wide.launches)
    got = pstage.fused_transformer_stage(x, **wts)
    torch.cuda.synchronize()
    assert (pstage.fused_transformer_stage.launches, pblock.ffn_wide.launches) == (
        before[0] + 1, before[1] + n)
    assert got.dtype == dtype and got.shape == x.shape and torch.isfinite(got).all()
    assert _rel(got, pstage.stage_plain(x, **wts)) <= TOL
    assert torch.equal(got, pstage.fused_transformer_stage(x, **wts))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("shape,heads", [
    ((1, 256, 256, 192), 4), ((1, 512, 512, 192), 4), ((1, 256, 256, 384), 8),
    ((1, 44, 70, 384), 8)])
def test_block_matches_plain(cuda, dtype, bias_free, shape, heads):
    """Both LayerNorms (non-zero biases); a ragged 44 x 70 frame cuts the
    last tiles in both directions."""
    names = ("ln1_w", "ln1_b", "w_qkv", "dw_qkv", "temperature", "w_proj", "ln2_w", "ln2_b",
             "w_in", "w_dw", "w_out")
    rng = np.random.default_rng(heads * 2 + bias_free)
    wts = {k: v[0] for k, v in _weights(rng, 1, shape[-1], heads, cuda,
                                         bias=not bias_free).items()}
    args = tuple(wts.get(k) for k in names)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    got = pblock.fused_transformer_block(x, *args, bias_free=bias_free, num_heads=heads)
    ref = pblock.block_plain(x, *args, bias_free=bias_free, num_heads=heads)
    assert got.dtype == dtype and _rel(got, ref) <= TOL
    assert torch.equal(got, pblock.fused_transformer_block(x, *args, bias_free=bias_free,
                                                           num_heads=heads))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_band_is_the_whole_image_at_384(cuda, dtype):
    rng = np.random.default_rng(13)
    wts = _weights(rng, 2, 384, 8, cuda)
    x = torch.from_numpy(rng.normal(size=(1, 52, 100, 384)).astype(np.float32)).to(cuda, dtype)
    got = pstage.fused_transformer_stage_bands([x], [wts], LocalBands([cuda]))[0]
    assert torch.equal(got, pstage.fused_transformer_stage(x, **wts))


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(192, 4), (384, 8)])
@pytest.mark.parametrize("n_bands", [2, 4])
def test_bands_match_the_whole_image(cuda, c, heads, n_bands):
    """Bands of 63 and 31 rows: halo rows read from the neighbours (r on
    them from kernel (P)), zeros only at the image's edges."""
    rng = np.random.default_rng(n_bands + c)
    bands = LocalBands([cuda] * n_bands)
    wts = _weights(rng, 2, c, heads, cuda)
    x = torch.from_numpy(rng.normal(size=(1, 252, 64, c)).astype(np.float32)).to(cuda)
    whole = pstage.fused_transformer_stage(x, **wts)
    got = torch.cat(pstage.fused_transformer_stage_bands(list(x.chunk(n_bands, 1)),
                                                         [wts] * n_bands, bands), 1)
    assert _rel(got, whole) <= TOL


@pytest.mark.cuda
def test_other_head_widths_keep_the_mma_sync_kernels(cuda):
    """At C = 192 with 2 heads (96 channels a head) the route is stage.cu's,
    as before."""
    rng = np.random.default_rng(3)
    wts = _weights(rng, 1, 192, 2, cuda)
    x = torch.from_numpy(rng.normal(size=(1, 24, 40, 192)).astype(np.float32)).to(cuda)
    before = pblock.gram_wide.launches
    got = pstage.fused_transformer_stage(x, **wts)
    assert pblock.gram_wide.launches == before
    assert _rel(got, pstage.stage_plain(x, **wts)) <= TOL
