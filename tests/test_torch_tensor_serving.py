"""Tensor-parallel teacher serving in the port (a mesh's ``model`` axis: every
TransformerBlock split by heads and by hidden channels over model shards,
``parallel/tensor.py``, ``models/shards.py``) against the JAX package on the
CPU, on the JAX package's tiny teacher (dim 8, blocks (1, 1, 1, 1), heads
(1, 2, 4, 8), BiasFree, params 'cat') with seeded weights carried across by
``convert/weights.py``.

Tolerances: shard forwards within rtol/atol 1e-5 of JAX's unsharded forward
and of its ``model``-mesh forward (float32; the shards add the partial
projections and GDFN parts in another order); predictors' uint8 within 1
level on > 99% of pixels, as the JAX package holds its own model mesh to one
device; the shard block's plain version bit-equal to ``block_f32`` on one
shard; on several, each of its two sums (the MDTA's partials, the GDFN's
parts) within 1e-5 of max|ref| in float32, and the block within 1e-5 in
float32 where the heads stay whole. Where a sum feeds a bfloat16 rounding
(LN2's output and W_in's after a split MDTA, the next block's LN1 and q, k
and v after any block: the kernels' arithmetic) a last-bit difference
between the split and the whole sums can flip that rounding, as row bands
do at 384 channels; then the shards are held to 1e-2 of max|ref|, as
bfloat16 is."""

import numpy as np
import pytest
import torch

import jax

from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    TeacherPredictor as JaxTeacherPredictor,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_teacher import (
    KDLAETeacher as JaxTeacher,
)
from rethink_acoustic_image_enhancement_tpu.parallel import mesh as jmesh
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAETeacher
from rethink_acoustic_image_enhancement_tpu_torch.models import shards as mshards
from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import (
    TransformerBlock,
    flax_block_tree,
)
from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate
from rethink_acoustic_image_enhancement_tpu_torch.parallel import mesh as tmesh
from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import (
    LocalShards,
    shard_range,
)
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite
from test_torch_spatial_serving import TINY, _levels, _seeded_params, _stage_weights

torch.set_num_threads(2)

IMG_HW = (32, 24)  # the JAX model-mesh predictor test's image


@pytest.fixture(scope="module")
def teacher():
    """(flax params, the port's teacher with them), with the SR head."""
    params = _seeded_params(JaxTeacher(**TINY, static="train"), seed=9)
    return params, weights.load_teacher_params(
        KDLAETeacher(**TINY, static="train"), params).eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    img = rng.random((1, 32, 32, 3)).astype(np.float32)
    return img, np.full((1, 32, 32, 1), 0.5, np.float32)


@pytest.fixture(scope="module")
def jax_forwards(teacher, inputs):
    """JAX's unsharded forward and its forward with the parameters on
    ``model_param_specs`` over ``make_mesh(n_model=8)`` (the 8 CPU devices
    of tests/conftest.py), as tests/test_parallel.py runs it."""
    from jax.sharding import NamedSharding

    params, _ = teacher
    model = JaxTeacher(**TINY, static="train")

    def fwd(p, i, r):
        out = model.apply({"params": p}, {"img": i, "denoise_rate": r})
        return out["hq"], out["sr"]

    img, rate = inputs
    whole = jax.jit(fwd)(params, img, rate)
    mesh = jmesh.make_mesh(n_data=1, n_spatial=1, n_model=8)
    specs = jmesh.model_param_specs(mesh, params)
    assert any(s.spec != jax.sharding.PartitionSpec() for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, NamedSharding)))
    rep = jmesh.replicated(mesh)
    sharded = jax.jit(fwd)(jax.device_put(params, specs), jax.device_put(img, rep),
                           jax.device_put(rate, rep))
    return [np.asarray(a) for a in whole], [np.asarray(a) for a in sharded]


@pytest.fixture(scope="module")
def jax_mesh_predictor_out(teacher):
    """JAX's TeacherPredictor on make_mesh(n_model=8) and the image."""
    params, _ = teacher
    img = np.random.default_rng(6).random((*IMG_HW, 3)).astype(np.float32)
    pred = JaxTeacherPredictor(params=params, model=JaxTeacher(**TINY, static="train"),
                               mesh=jmesh.make_mesh(n_data=1, n_spatial=1, n_model=8))
    return img, pred(img, denoise_rate=0.7, zero_mask=False)


def _cpu_mesh(**kw):
    n = kw.get("n_data", 1) * kw.get("n_spatial", 1) * kw.get("n_model", 1)
    return tmesh.make_mesh(devices=["cpu"] * n, **kw)


def _nchw(a, n):
    return [torch.from_numpy(a).permute(0, 3, 1, 2)] * n


# ----------------------------------------------------------- forward ---

@pytest.mark.parametrize("n", [2, 4, 8])
def test_teacher_shards_match_jax(teacher, inputs, jax_forwards, n):
    """The port's teacher on ``n`` CPU shards against JAX's unsharded
    forward and JAX's model-mesh forward: 'hq' and 'sr' within rtol/atol
    1e-5, every shard with the same bits; sums and bytes counted."""
    _, model = teacher
    img, rate = inputs
    shards = LocalShards(["cpu"] * n)
    mods = mshards.shard_teacher(model, shards.devices)
    with torch.no_grad():
        out = mshards.teacher_shards(mods, _nchw(img, n), _nchw(rate, n), shards)
    assert shards.sums > 0 and shards.moved["partials"] > 0
    for key, whole, sharded in zip(("hq", "sr"), *jax_forwards):
        assert len(out[key]) == n
        assert all(torch.equal(o, out[key][0]) for o in out[key])
        got = out[key][0].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, sharded, rtol=1e-5, atol=1e-5)


def test_one_shard_gives_the_models_bits(teacher, inputs):
    """Nothing split: one shard through ``teacher_shards`` is the model's own
    forward bit for bit, with no bytes moved."""
    _, model = teacher
    img, rate = inputs
    shards = LocalShards(["cpu"])
    with torch.no_grad():
        whole = model({"img": _nchw(img, 1)[0], "denoise_rate": _nchw(rate, 1)[0]})
        out = mshards.teacher_shards(mshards.shard_teacher(model, shards.devices),
                                     _nchw(img, 1), _nchw(rate, 1), shards)
    for key in ("hq", "sr"):
        assert torch.equal(out[key][0], whole[key])
    assert shards.moved["partials"] == 0


@pytest.mark.parametrize("n", [2, 4, 8])
def test_model_axis_predictor_matches_jax_and_one_device(teacher, jax_mesh_predictor_out, n):
    """TeacherPredictor(mesh=make_mesh(n_model=n)) against JAX's predictor on
    make_mesh(n_model=8) and against the port's one-device predictor: 'hq'
    and 'sr' within 1 level on > 99% of pixels."""
    _, model = teacher
    img, jx = jax_mesh_predictor_out
    got = TeacherPredictor(model, mesh=_cpu_mesh(n_model=n))(img, denoise_rate=0.7,
                                                              zero_mask=False)
    one = TeacherPredictor(model, device="cpu")(img, denoise_rate=0.7, zero_mask=False)
    assert got["hq"].shape == img.shape and got["sr"].shape == (64, 48, 3)
    for key in ("hq", "sr"):
        for ref in (jx[key], one[key]):
            worst, equal = _levels(got[key], ref)
            assert worst <= 1 and equal > 0.99, (key, worst, equal)


@pytest.mark.parametrize("flags", [dict(fused_resample=True), dict(dtype=torch.bfloat16),
                                   dict(fused=True)])
def test_model_axis_flags_as_one_device(teacher, flags):
    """``fused_resample``, a bfloat16 input and ``fused`` (set on every
    shard; at this size the gate admits no stage, the route test below
    covers one that does) on 2 shards give the one-device predictor's
    output with the same flags within 1 level on > 99%."""
    _, model = teacher
    img = np.random.default_rng(7).random((*IMG_HW, 3)).astype(np.float32)
    got = TeacherPredictor(model, mesh=_cpu_mesh(n_model=2), **flags)(img, 0.5, zero_mask=False)
    ref = TeacherPredictor(model, device="cpu", **flags)(img, 0.5, zero_mask=False)
    for key in ("hq", "sr"):
        worst, equal = _levels(got[key], ref[key])
        assert worst <= 1 and equal > 0.99, (key, worst, equal)


def test_model_axis_of_one_serves_as_no_mesh(teacher):
    """A mesh whose model axis is 1 serves exactly as before: bit for bit
    the one-device predictor, and no shards."""
    _, model = teacher
    img = (np.random.default_rng(4).random((24, 40, 3)) * 255).astype(np.uint8)
    pred = TeacherPredictor(model, mesh=_cpu_mesh(n_model=1))
    assert pred._shards is None
    got = pred(img, 0.3)
    ref = TeacherPredictor(model, device="cpu")(img, 0.3)
    for key in ("hq", "sr"):
        np.testing.assert_array_equal(got[key], ref[key])


def test_model_axis_predictor_uint8_mask_group_and_refusals(teacher, tmp_path):
    """uint8 in: the fan-beam mask's pixels stay 0 and the output is the
    float input's within 1 level; ``denoise_file`` serves the image's PNG
    bit for bit and ``denoise_group`` image by image; ``denoise_tiled``
    raises JAX's ValueError; the caller's module is untouched; each shard
    holds a part of every block."""
    _, model = teacher
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    img = (rng.random((40, 32, 3)) * 255).astype(np.uint8)
    img[:6, :9] = 0
    pred = TeacherPredictor(model, mesh=_cpu_mesh(n_model=2))
    got = pred(img, denoise_rate=0.4)
    ref = pred(img.astype(np.float32) / 255.0, denoise_rate=0.4)
    assert not got["hq"][:6, :9].any() and not got["sr"][:12, :18].any()
    for key in ("hq", "sr"):
        assert _levels(got[key], ref[key])[0] <= 1
    path = str(tmp_path / "frame.png")
    imwrite(path, img)
    from_file = pred.denoise_file(path, denoise_rate=0.4)
    for key in ("hq", "sr"):
        np.testing.assert_array_equal(from_file[key], got[key])
    imgs = [img, img[:24], img]
    for g, im in zip(pred.denoise_group(imgs, 0.4, group_size=2), imgs):
        for key in ("hq", "sr"):
            np.testing.assert_array_equal(g[key], pred(im, 0.4)[key])
    assert not pred.scan_eligible([img, img], 2)
    with pytest.raises(ValueError, match="tiled serving shards its batch over the 'data'"):
        pred.denoise_tiled([np.zeros((64, 64, 3), np.float32)], tile=32)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert [m.latent[0].attn.num_heads for m in pred.models] == [4, 4]
    assert [m.encoder_level1[0].ffn.project_out.in_channels for m in pred.models] == [11, 10]


# ----------------------------------------------------------- weights ---

@pytest.mark.parametrize("n", [2, 4])
def test_shard_slices_concatenate_to_the_weights(teacher, n):
    """Every block's shards' slices put back together give the teacher's
    weights bit for bit (qkv and its taps by thirds, project_out by input
    channels, the GDFN by halves of the hidden channels); a project_out
    bias stays on shard 0; the other layers are whole copies; the stacked
    form (``shard_stage_weights``) is the shard modules' own."""
    _, model = teacher
    mods = mshards.shard_teacher(model, ["cpu"] * n)
    whole = dict(model.named_modules())
    for name, blk in whole.items():
        if not isinstance(blk, TransformerBlock):
            continue
        parts = [m.get_submodule(name) for m in mods]
        c, f = blk.dim, blk.ffn.project_out.in_channels
        split = blk.num_heads % n == 0
        assert all(mshards.splits_heads(p) == split for p in parts)

        def cat_thirds(ws, width):
            return torch.cat([torch.cat([w[t * width:(t + 1) * width] for w in ws])
                              for t in range(3)])

        def cat_halves(ws):
            return torch.cat([torch.cat([w[h * len(w) // 2:(h + 1) * len(w) // 2] for w in ws])
                              for h in range(2)])

        if split:
            qkv = [p.attn.qkv.weight for p in parts]
            assert torch.equal(cat_thirds(qkv, c // n), blk.attn.qkv.weight)
            assert torch.equal(cat_thirds([p.attn.qkv_dwconv.weight for p in parts], c // n),
                               blk.attn.qkv_dwconv.weight)
            assert torch.equal(torch.cat([p.attn.project_out.weight for p in parts], 1),
                               blk.attn.project_out.weight)
            assert torch.equal(torch.cat([p.attn.temperature for p in parts]),
                               blk.attn.temperature)
        else:
            for p in parts:
                for key, v in blk.attn.state_dict().items():
                    assert torch.equal(p.attn.state_dict()[key], v)
        assert torch.equal(cat_halves([p.ffn.project_in.weight for p in parts]),
                           blk.ffn.project_in.weight)
        assert torch.equal(cat_halves([p.ffn.dwconv.weight for p in parts]),
                           blk.ffn.dwconv.weight)
        assert torch.equal(torch.cat([p.ffn.project_out.weight for p in parts], 1),
                           blk.ffn.project_out.weight)
        assert sum(p.ffn.project_out.in_channels for p in parts) == f
        for key in ("norm1", "norm2"):
            assert all(torch.equal(p.get_submodule(key).body.weight,
                                   blk.get_submodule(key).body.weight) for p in parts)
    for m in mods:
        for key in ("patch_embed.proj.weight", "down1_2.body.0.weight", "output.weight",
                    "reduce_chan_level3.weight", "output_param.weight", "outputen.weight"):
            assert torch.equal(m.state_dict()[key], model.state_dict()[key])
    # a project_out bias stays on shard 0 only
    biased = KDLAETeacher(**dict(TINY, num_blocks=(1, 1, 1, 1)), use_bias=True)
    parts = mshards.shard_teacher(biased, ["cpu"] * n)
    assert parts[0].latent[0].attn.project_out.bias is not None
    assert all(p.latent[0].attn.project_out.bias is None for p in parts[1:])
    assert all(p.latent[0].ffn.project_out.bias is None for p in parts[1:])
    # the stacked form
    stacked = pstage.stack_block_params([flax_block_tree(b) for b in model.latent])
    for j, m in enumerate(mods):
        mine = pstage.stack_block_params([flax_block_tree(b) for b in m.latent])
        theirs = mshards.shard_stage_weights(stacked, n, j)
        assert all(torch.equal(mine[k], theirs[k]) for k in mine)


def test_uneven_hidden_split_and_the_refusal_that_names_a_layer(teacher):
    """Hidden ranges in order, the first ``F % n`` one channel longer (255 ->
    128 + 127, 127 -> 64 + 63, 1021 -> 511 + 510, the tiny teacher's 21 over
    8 -> 3 x 5 + 2 x 3); a mesh that leaves a shard no hidden channel
    raises, naming the first such block."""
    assert [len(shard_range(255, 2, j)) for j in range(2)] == [128, 127]
    assert [len(shard_range(127, 2, j)) for j in range(2)] == [64, 63]
    assert [len(shard_range(1021, 2, j)) for j in range(2)] == [511, 510]
    assert [shard_range(21, 8, j) for j in range(8)] == [
        range(0, 3), range(3, 6), range(6, 9), range(9, 12), range(12, 15), range(15, 17),
        range(17, 19), range(19, 21)]
    _, model = teacher
    mods = mshards.shard_teacher(model, ["cpu"] * 8)
    assert [m.encoder_level1[0].ffn.project_out.in_channels for m in mods] == [3] * 5 + [2] * 3
    with pytest.raises(ValueError, match=r"encoder_level1\.0: 21 hidden channels leave some "
                                         r"of 22 model shards none"):
        mshards.shard_teacher(model, ["cpu"] * 22)
    with pytest.raises(ValueError, match="encoder_level1.0: 21 hidden channels"):
        TeacherPredictor(model, mesh=_cpu_mesh(n_model=32))


# ------------------------------------------------------ shard stage ----

def _block_ws(wts, j, n):
    sw = mshards.shard_stage_weights(wts, n, j)
    return pstage._block_weights(0, wts["ln1_w"].shape[-1], **sw)


def _close(a, b, tol):
    return (a.float() - b.float()).abs().max() <= tol * b.float().abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("c,heads", [(96, 1), (96, 2), (384, 8)])
def test_shard_block_and_stage_plain_match_the_whole(c, heads, n, dtype):
    """``block_f32_shards`` against ``block_f32`` and ``stage_plain_shards``
    (one block) against ``stage_plain`` on 16x16 pixels, heads split where
    the shards divide them, else whole: bit-equal on one shard, every shard
    the same bits, no kernel launch on the CPU. On 2 and 4 each of the two
    sums within 1e-5 of max|ref|: r (the MDTA's partials, x added once)
    against the whole block's r, and the output against the whole GDFN
    taken on the shards' r. The output against the whole block within 1e-5
    in float32 where the heads stay whole (r is then the whole block's, bit
    for bit), and within 1e-2 where they are split or in bfloat16: the split
    sum's last bits reach LN2's bfloat16 rounding, and one flipped hidden
    value moves 9 pixels' channels (the module docstring)."""
    rng = np.random.default_rng(c + heads + n)
    wts = _stage_weights(rng, 1, c, heads)
    x = torch.from_numpy(rng.normal(size=(1, 16, 16, c)).astype(np.float32)).to(dtype)
    shards = LocalShards(["cpu"] * n)
    whole = pstage._block_weights(0, c, **wts)
    ws = [_block_ws(wts, j, n) for j in range(n)]
    split = n > 1 and heads % n == 0
    assert all(w.wqkv.shape[1] == (3 * c // n if split else 3 * c) for w in ws)
    x32 = x.float()
    rs = []
    for j, w in enumerate(ws):
        qkv = pblock.dw3x3(pblock.qkv_hidden(x32, w.ln1, None, w.wqkv, 1e-5), w.dwqkv)
        rs.append(pblock.attend(x32, qkv, pblock.gram_part(qkv, w.temp.numel()), w.temp,
                                w.wproj, residual=j == 0 or not split))
    qkv = pblock.dw3x3(pblock.qkv_hidden(x32, whole.ln1, None, whole.wqkv, 1e-5), whole.dwqkv)
    r = pblock.attend(x32, qkv, pblock.gram_part(qkv, heads), whole.temp, whole.wproj)
    r_sh = shards.sum_across(rs)[0] if split else rs[0]
    ref = pblock.block_f32(x, *whole, 1e-5)
    got = pblock.block_f32_shards([x] * n, ws, shards, 1e-5)
    before = (pstage.fused_transformer_stage_shards.launches, pgdfn.fused_ln_gdfn_part.launches)
    ys = pstage.fused_transformer_stage_shards(
        [x] * n, [mshards.shard_stage_weights(wts, n, j) for j in range(n)], shards)
    assert (pstage.fused_transformer_stage_shards.launches,
            pgdfn.fused_ln_gdfn_part.launches) == before
    stage_ref = pstage.stage_plain(x, **wts)
    assert ys[0].dtype == dtype and ys[0].shape == x.shape
    assert all(torch.equal(y, ys[0]) for y in ys) and all(torch.equal(g, got[0]) for g in got)
    assert torch.equal(ys[0], got[0].to(dtype))
    if n == 1:
        assert torch.equal(got[0], ref) and torch.equal(ys[0], stage_ref)
    assert _close(r_sh, r, 1e-5)
    gdfn_on_r = pgdfn.ffn_f32(r_sh, whole.ln2, None, whole.win, whole.wdw, whole.wout, 1e-5)
    assert _close(got[0], gdfn_on_r, 1e-5)
    tol = 1e-5 if dtype == torch.float32 and not split else 1e-2
    assert _close(got[0], ref, tol) and _close(ys[0], stage_ref, tol)


@pytest.mark.parametrize("c,heads,n", [(96, 2, 2), (384, 8, 4)])
def test_two_block_shard_stage_within_a_bf16_rounding(c, heads, n):
    """Two blocks in float32: within 1e-2 of max|ref| (the module
    docstring: the second block's bfloat16 operands turn last-bit
    differences of the sums into one rounding step)."""
    rng = np.random.default_rng(c * n)
    wts = _stage_weights(rng, 2, c, heads)
    x = torch.from_numpy(rng.normal(size=(1, 16, 16, c)).astype(np.float32))
    ys = pstage.stage_plain_shards([x] * n, [mshards.shard_stage_weights(wts, n, j)
                                             for j in range(n)], LocalShards(["cpu"] * n))
    ref = pstage.stage_plain(x, **wts)
    assert (ys[0] - ref).abs().max() <= 1e-2 * ref.abs().max()


def test_gdfn_part_plain_sums_to_the_whole():
    """The GDFN's parts on 255 = 128 + 127 hidden channels, the residual on
    the first, add up to ``gdfn_plain`` within 1e-5 of max|ref|; the wrapper
    takes the plain version on the CPU and counts no launch."""
    rng = np.random.default_rng(2)
    wts = _stage_weights(rng, 1, 96, 1)
    r = torch.from_numpy(rng.normal(size=(1, 16, 24, 96)).astype(np.float32))
    ref = pgdfn.gdfn_plain(r, wts["ln2_w"][0], None, wts["w_in"][0], wts["w_dw"][0],
                           wts["w_out"][0])
    before = pgdfn.fused_ln_gdfn_part.launches
    parts = []
    for j in range(2):
        sw = mshards.shard_stage_weights(wts, 2, j)
        parts.append(pgdfn.fused_ln_gdfn_part(r, sw["ln2_w"][0], sw["w_in"][0], sw["w_dw"][0],
                                              sw["w_out"][0], residual=j == 0))
    assert pgdfn.fused_ln_gdfn_part.launches == before
    assert (parts[0] + parts[1] - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_shard_stage_refuses_mixed_devices_and_counts():
    rng = np.random.default_rng(0)
    wts = _stage_weights(rng, 1, 16, 1)
    x = torch.zeros(1, 8, 8, 16)
    s = LocalShards(["cpu"] * 2)
    with pytest.raises(ValueError, match="2 shards, 1 weight sets"):
        pstage.fused_transformer_stage_shards([x, x], [wts], s)
    with pytest.raises(ValueError, match="no shard stage implementation"):
        pstage.fused_transformer_stage_shards([x, x.to("meta")], [wts, wts], s)


def test_sum_across_in_shard_order_on_every_device():
    """Every shard gets the parts added in shard order (the same bits), and
    each part's bytes count once for every other shard."""
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32)) for _ in range(3)]
    s = LocalShards(["cpu"] * 3)
    out = s.sum_across(parts)
    assert all(torch.equal(o, (parts[0] + parts[1]) + parts[2]) for o in out)
    assert s.sums == 1 and s.moved["partials"] == 2 * 3 * 2 * 5 * 4
    assert tmesh.make_mesh(n_data=2, n_model=3, devices=[f"cpu:{i}" for i in range(6)]
                           ).model_devices() == [torch.device("cpu", i) for i in range(3)]


def test_shard_route_follows_the_whole_image_gate(teacher, monkeypatch):
    """With ``fused`` a stage takes the shard stage exactly where the
    one-device gate admits the image's shape (the whole C and heads), and a
    gate that admits every stage of 16 or 64 channels gives the one-device
    fused predictor's output (the plain stage, on the CPU) within 1 level on
    > 99%: the level-2 stages split by heads on 2 shards, the latent too."""
    _, model = teacher
    asked = []

    def gate(b, h, w, c, heads, *rest):
        asked.append((h, w, c, heads))
        return c in (16, 64)

    monkeypatch.setattr(stage_gate, "stage_worthwhile", gate)
    shard_calls, whole_calls = [], []

    def counted(calls, fn):
        def run(x, *a, **kw):
            calls.append(tuple((x[0] if isinstance(x, list) else x).shape))
            return fn(x, *a, **kw)
        return run

    from rethink_acoustic_image_enhancement_tpu_torch.models import kdlae_teacher

    monkeypatch.setattr(mshards, "fused_transformer_stage_shards",
                        counted(shard_calls, pstage.fused_transformer_stage_shards))
    monkeypatch.setattr(kdlae_teacher, "fused_transformer_stage",
                        counted(whole_calls, pstage.fused_transformer_stage))
    img = np.random.default_rng(8).random((*IMG_HW, 3)).astype(np.float32)
    got = TeacherPredictor(model, fused=True, mesh=_cpu_mesh(n_model=2))(img, 0.6,
                                                                        zero_mask=False)
    shard_asked, asked[:] = list(asked), []
    ref = TeacherPredictor(model, fused=True, device="cpu")(img, 0.6, zero_mask=False)
    assert shard_asked == asked
    # encoder/decoder level 2, decoder_level1, both refinements (16) and the latent (64)
    assert len(whole_calls) == 6 and shard_calls == whole_calls
    for key in ("hq", "sr"):
        worst, equal = _levels(got[key], ref[key])
        assert worst <= 1 and equal > 0.99, (key, worst, equal)
