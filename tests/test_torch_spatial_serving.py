"""Spatially sharded teacher serving in the port (a mesh's ``spatial`` axis:
one image in row bands, ``parallel/{mesh,spatial}.py``, ``models/bands.py``)
against the JAX package on the CPU, on the JAX package's tiny teacher (dim
8, blocks (1, 1, 1, 1), heads (1, 2, 4, 8), BiasFree, params 'cat') with
seeded weights carried across by ``convert/weights.py``.

Tolerances: band forwards within rtol/atol 1e-5 of the JAX forward (float32;
the bands add the MDTA's Gram and norms in another order); predictors'
uint8 within 1 level on >= 99% of pixels, as the JAX package holds its own
spatial mesh to one device; the band stage's plain version bit-equal to
``stage_plain`` on one band, within 1e-5 of max|ref| in float32 (1e-2 in
bfloat16: one bf16 rounding) on several."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    ASDQEScorer as JaxScorer,
)
from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    StudentPredictor as JaxStudentPredictor,
)
from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    TeacherPredictor as JaxTeacherPredictor,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_teacher import (
    KDLAETeacher as JaxTeacher,
)
from rethink_acoustic_image_enhancement_tpu.parallel import mesh as jmesh
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import (
    ASDQEScorer,
    StudentPredictor,
    TeacherPredictor,
)
from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAETeacher
from rethink_acoustic_image_enhancement_tpu_torch.models import bands as mbands
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate
from rethink_acoustic_image_enhancement_tpu_torch.parallel import mesh as tmesh
from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import (
    LocalBands,
    join_rows,
    split_rows,
)

torch.set_num_threads(2)

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            heads=(1, 2, 4, 8), layernorm_type="BiasFree", params="cat")


def _seeded_params(module, seed):
    """Seeded weights on the flax tree's shapes (``jax.eval_shape``: no eager
    init), drawn as the port's ``models/kdlae_teacher.py::init_weights_``
    draws them so that the network is conditioned like a trained one:
    kernels normal with std fan_in^-0.5 (the residual branches' and the hq
    heads' times 0.1, the SR head's times 0.5), LayerNorm weights 1,
    temperatures uniform in [0.5, 1.5)."""
    x = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            {"img": x, "denoise_rate": x[..., :1]})["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "temperature":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if keys[-1] != "kernel":
            return np.ones(leaf.shape, np.float32)
        scale = int(np.prod(leaf.shape[:-1])) ** -0.5
        if keys[-2] == "project_out" or keys[0] in ("output", "output2"):
            scale *= 0.1
        elif keys[0] == "outputen":
            scale *= 0.5
        return rng.normal(0, scale, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def teachers():
    """static -> (flax params, the port's teacher with them)."""
    out = {}
    for static in ("train", "test"):
        cfg = dict(TINY, static=static)
        params = _seeded_params(JaxTeacher(**cfg), seed=4)
        out[static] = params, weights.load_teacher_params(KDLAETeacher(**cfg), params).eval()
    return out


def _cpu_mesh(**kw):
    n = kw.get("n_data", 1) * kw.get("n_spatial", 1) * kw.get("n_model", 1)
    return tmesh.make_mesh(devices=["cpu"] * n, **kw)


def _levels(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return int(d.max()), float((d == 0).mean())


# ------------------------------------------------------------ mesh ----

def test_make_mesh_matches_jax():
    """The grid's axes and sizes as JAX's make_mesh builds them, and its
    ValueError when the grid needs more devices than given."""
    for kw in (dict(n_data=4, n_spatial=2), dict(n_spatial=4), dict(n_data=2, n_model=2)):
        m = tmesh.make_mesh(devices=["cpu"] * 8, **kw)
        assert m.shape == dict(jmesh.make_mesh(**kw).shape)
        assert m.axis_names == (tmesh.DATA_AXIS, tmesh.SPATIAL_AXIS, tmesh.MODEL_AXIS)
    m = tmesh.make_mesh(n_data=2, n_spatial=3, devices=[f"cpu:{i}" for i in range(6)])
    assert m.spatial_devices() == [torch.device("cpu", i) for i in range(3)]
    assert m.data_devices() == [torch.device("cpu", 0), torch.device("cpu", 3)]
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        tmesh.make_mesh(n_data=3, n_spatial=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        jmesh.make_mesh(n_data=3, n_spatial=3)


def test_make_mesh_without_cuda_raises(monkeypatch):
    """No devices named and no CUDA device: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(n_spatial=2)


# ------------------------------------------------------------ bands ---

@pytest.mark.parametrize("n", [1, 2, 4])
def test_halo_exchange_sum_and_gather(n):
    """split/join are inverse; each band gets its neighbours' nearest rows
    and zeros at the image's edges; every band gets the same sum, in band
    order."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(2, 3, 16, 5)).astype(np.float32))
    b = LocalBands(["cpu"] * n)
    xs = split_rows(x, b.devices)
    assert torch.equal(join_rows(xs, "cpu"), x)
    rows = 2
    xh = b.exchange_halo(xs, rows)
    padded = torch.nn.functional.pad(x, (0, 0, rows, rows))
    hb = 16 // n
    for i, band in enumerate(xh):
        assert torch.equal(band, padded[:, :, i * hb:i * hb + hb + 2 * rows])
    parts = [torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)) for _ in range(n)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    for s in b.sum_across(parts):
        assert torch.equal(s, total)
    # bytes handed between bands: 2 (n - 1) halo slabs, n - 1 other parts a band
    assert b.moved == {"halo": 2 * (n - 1) * 2 * 3 * rows * 5 * 4,
                       "partials": n * (n - 1) * 2 * 3 * 4}
    if hb < 8:
        with pytest.raises(ValueError, match="cannot give"):
            b.exchange_halo(xs, 8)


@pytest.mark.parametrize("channels_last", [False, True])
def test_halo_buffers_keep_the_bands_layout(channels_last):
    """A band seen as NCHW over an NHWC upload gets channels-last halo
    buffers, a contiguous band contiguous ones: the convs over the halo see
    the layout the whole image's convs see."""
    x = torch.arange(2 * 3 * 8 * 5, dtype=torch.float32).reshape(2, 8, 5, 3)
    x = x.permute(0, 3, 1, 2) if channels_last else x.permute(0, 3, 1, 2).contiguous()
    b = LocalBands(["cpu"] * 2)
    for band, ref in zip(b.exchange_halo(split_rows(x, b.devices), 1),
                         torch.nn.functional.pad(x, (0, 0, 1, 1)).unfold(2, 6, 4)
                         .permute(2, 0, 1, 4, 3)):
        assert torch.equal(band, ref)
        assert band.is_contiguous(memory_format=torch.channels_last) == channels_last
        assert band.is_contiguous() != channels_last


# --------------------------------------------------- band forward -----

@pytest.mark.parametrize("channels_last", [False, True])
def test_one_band_gives_the_models_bits(teachers, channels_last):
    """Nothing split: one band through ``teacher_bands`` is the model's own
    forward bit for bit, on a contiguous input and on the predictor's NHWC
    upload seen as NCHW."""
    _, model = teachers["train"]
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.random((1, 24, 32, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    img = img if channels_last else img.contiguous()
    rate = torch.full((1, 1, 24, 32), 0.7)
    with torch.no_grad():
        whole = model({"img": img, "denoise_rate": rate})
        out = mbands.teacher_bands([model], [img], [rate], LocalBands(["cpu"]))
    for key in ("hq", "sr"):
        assert torch.equal(out[key][0], whole[key])


@pytest.mark.parametrize("n_bands,static,fused_resample", [
    (4, "test", False), (2, "test", False), (2, "train", False), (4, "train", True)])
def test_band_forward_matches_jax(teachers, n_bands, static, fused_resample):
    """The port's teacher on ``n_bands`` CPU bands against the JAX model's
    unsharded forward on (2, 32, 32, 3) (the JAX spatial test's input):
    'hq' and, with the SR head, 'sr' within rtol/atol 1e-5."""
    params, model = teachers[static]
    rng = np.random.default_rng(0)
    img = rng.random((2, 32, 32, 3)).astype(np.float32)
    rate = np.full((2, 32, 32, 1), 0.5, np.float32)
    jm = JaxTeacher(**TINY, static=static, fused_resample=fused_resample)
    ref = jax.jit(jm.apply)({"params": params}, {"img": img, "denoise_rate": rate})
    model.set_fused_resample(fused_resample)
    b = LocalBands(["cpu"] * n_bands)

    def nchw(a):
        return split_rows(torch.from_numpy(a).permute(0, 3, 1, 2), b.devices)

    try:
        with torch.no_grad():
            out = mbands.teacher_bands([model] * n_bands, nchw(img), nchw(rate), b)
    finally:
        model.set_fused_resample(False)
    assert len(out["hq"]) == n_bands and out["hq"][0].shape == (2, 3, 32 // n_bands, 32)
    for key in ("hq", "sr"):
        if ref[key] is None:
            assert out[key] is None
            continue
        got = join_rows(out[key], "cpu").permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(ref[key]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 48), (40, 40)])
def test_spatial_predictor_matches_jax_and_one_device(teachers, hw):
    """TeacherPredictor(mesh=make_mesh(n_spatial=4)) against JAX's predictor
    on make_mesh(n_data=2, n_spatial=4) and against one device, 'hq' and
    'sr' within 1 level on >= 99%. 40 rows pad to 64 (multiple_of * 4), as
    JAX pads them; one device pads to 40, so it gets the image reflect-padded
    to those 64 rows and is cropped back (the extra rows move the global MDTA
    statistics, as the JAX predictor documents)."""
    params, model = teachers["train"]
    rng = np.random.default_rng(3)
    h, w = hw
    img = rng.random((h, w, 3)).astype(np.float32)
    spatial = TeacherPredictor(model, mesh=_cpu_mesh(n_spatial=4))
    got = spatial(img, denoise_rate=0.7, zero_mask=False)
    jx = JaxTeacherPredictor(params=params, model=JaxTeacher(**TINY, static="train"),
                             mesh=jmesh.make_mesh(n_data=2, n_spatial=4))(
        img, denoise_rate=0.7, zero_mask=False)
    ph = -(-h // 32) * 32 - h
    padded = np.pad(img, ((0, ph), (0, 0), (0, 0)), mode="reflect")
    one = TeacherPredictor(model, device="cpu")(padded, denoise_rate=0.7, zero_mask=False)
    one = {"hq": one["hq"][:h], "sr": one["sr"][:2 * h]}
    assert got["hq"].shape == (h, w, 3) and got["sr"].shape == (2 * h, 2 * w, 3)
    for key in ("hq", "sr"):
        for ref in (jx[key], one[key]):
            worst, equal = _levels(got[key], ref)
            assert worst <= 1 and equal >= 0.99, (key, worst, equal)


def test_spatial_predictor_zero_mask_and_uint8(teachers):
    """uint8 in: the fan-beam mask's pixels stay 0, and the output is the
    float input's within 1 level."""
    _, model = teachers["train"]
    rng = np.random.default_rng(5)
    img = (rng.random((48, 40, 3)) * 255).astype(np.uint8)
    img[:6, :9] = 0
    pred = TeacherPredictor(model, mesh=_cpu_mesh(n_spatial=2))
    got = pred(img, denoise_rate=0.4)
    ref = pred(img.astype(np.float32) / 255.0, denoise_rate=0.4)
    assert not got["hq"][:6, :9].any() and not got["sr"][:12, :18].any()
    for key in ("hq", "sr"):
        assert _levels(got[key], ref[key])[0] <= 1


# ------------------------------------------------------ band stage ----

def _stage_weights(rng, n, c, heads):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_bands,h", [(1, 24), (2, 24), (4, 48), (4, 64)])
def test_band_stage_plain_matches_stage_plain(n_bands, h, dtype):
    """The band stage on CPU bands (its plain version) against
    ``stage_plain`` on the whole image: bit-equal on one band, within the
    stated tolerance on 2 and 4, band rows 12 and 12 (4 mod 8) and 16."""
    rng = np.random.default_rng(n_bands * 100 + h)
    wts = _stage_weights(rng, 2, 32, 2)
    x = torch.from_numpy(rng.normal(size=(2, h, 20, 32)).astype(np.float32)).to(dtype)
    ref = pstage.stage_plain(x, **wts)
    b = LocalBands(["cpu"] * n_bands)
    before = pstage.fused_transformer_stage_bands.launches
    ys = pstage.fused_transformer_stage_bands(split_rows(x, b.devices, dim=1),
                                              [wts] * n_bands, b)
    assert pstage.fused_transformer_stage_bands.launches == before  # no kernel on the CPU
    got = join_rows(ys, "cpu", dim=1)
    assert got.dtype == dtype and got.shape == x.shape
    if n_bands == 1:
        assert torch.equal(got, ref)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()


def test_band_stage_refuses_mixed_devices_and_counts():
    rng = np.random.default_rng(0)
    wts = _stage_weights(rng, 1, 16, 1)
    x = torch.zeros(1, 8, 8, 16)
    b = LocalBands(["cpu"] * 2)
    with pytest.raises(ValueError, match="2 bands, 1 weight sets"):
        pstage.fused_transformer_stage_bands([x, x], [wts], b)
    with pytest.raises(ValueError, match="no band stage implementation"):
        pstage.fused_transformer_stage_bands([x, x.to("meta")], [wts, wts], b)


def test_band_route_follows_the_whole_image_gate(teachers, monkeypatch):
    """With ``fused`` a stage takes the band stage exactly where the
    one-device gate admits the whole padded shape: the gate is asked with
    the image's H, and a gate that admits every stage of 8 or 16 channels
    gives the one-device fused predictor's output (the plain stage, on the
    CPU) within 1 level on >= 99%."""
    _, model = teachers["test"]
    asked = []

    def gate(b, h, w, c, *rest):
        asked.append((h, w, c))
        return c in (8, 16)

    monkeypatch.setattr(stage_gate, "stage_worthwhile", gate)
    band_calls, whole_calls = [], []

    def counted(calls, fn):
        def run(x, *a, **kw):
            calls.append(tuple((x[0] if isinstance(x, list) else x).shape))
            return fn(x, *a, **kw)
        return run

    from rethink_acoustic_image_enhancement_tpu_torch.models import kdlae_teacher

    monkeypatch.setattr(mbands, "fused_transformer_stage_bands",
                        counted(band_calls, pstage.fused_transformer_stage_bands))
    monkeypatch.setattr(kdlae_teacher, "fused_transformer_stage",
                        counted(whole_calls, pstage.fused_transformer_stage))
    rng = np.random.default_rng(8)
    img = rng.random((64, 40, 3)).astype(np.float32)
    got = TeacherPredictor(model, fused=True, mesh=_cpu_mesh(n_spatial=4))(img, 0.6, zero_mask=False)
    band_asked, asked[:] = list(asked), []
    ref = TeacherPredictor(model, fused=True, device="cpu")(img, 0.6, zero_mask=False)
    assert band_asked == asked  # the same (H, W, C) questions, in order
    # the same stages, each on a quarter of the rows (encoder_level1 at 8
    # channels; the level-2 stages, decoder_level1 and both refinements at 16)
    assert len(whole_calls) == 6
    assert band_calls == [(b, h // 4, w, c) for b, h, w, c in whole_calls]
    worst, equal = _levels(got["hq"], ref["hq"])
    assert worst <= 1 and equal >= 0.99


# -------------------------------------------------- refusals, routes --

@pytest.mark.parametrize("shape,jax_admits", [
    ((1, 256, 256, 384, 8), True),   # the latent of a 2048^2 request
    ((1, 512, 512, 192, 4), True),   # level 3 of a 2048^2 request
    ((1, 256, 256, 96, 2), True),    # level 2 of a 512^2 request
    ((1, 128, 128, 192, 4), False)])
def test_stage_kernel_route_takes_the_kernels_widths(shape, jax_admits):
    """The port routes a stage to its kernel exactly where the JAX gate
    admits it, the 384-channel latent of a 2048^2 frame included (the
    kernel's wide layout, ``ops/block.py::plan_tiles``)."""
    from rethink_acoustic_image_enhancement_tpu.ops.pallas import stage as jstage

    args = (*shape, True, False, 2.66)
    assert jstage.stage_worthwhile(*args) == stage_gate.stage_worthwhile(*args) == jax_admits


def test_mesh_refusals_as_jax(teachers):
    """A model axis alone builds and serves; spatial and model together,
    devices beside a mesh, and tiled / student / scorer serving on a spatial
    or model axis raise the JAX package's ValueErrors."""
    params, model = teachers["train"]
    with pytest.raises(ValueError, match="cannot be combined"):
        TeacherPredictor(model, mesh=_cpu_mesh(n_spatial=2, n_model=2))
    with pytest.raises(ValueError, match="cannot be combined"):
        JaxTeacherPredictor(params=params, model=JaxTeacher(**TINY),
                            mesh=jmesh.make_mesh(n_data=1, n_spatial=2, n_model=4))
    served = TeacherPredictor(model, mesh=_cpu_mesh(n_model=2))(
        np.zeros((16, 24, 3), np.float32), 0.5)
    assert served["hq"].shape == (16, 24, 3) and served["sr"].shape == (32, 48, 3)
    with pytest.raises(ValueError, match="mesh= alone"):
        TeacherPredictor(model, mesh=_cpu_mesh(n_model=2), device="cpu")
    for kw in (dict(devices=["cpu"]), dict(device="cpu")):
        with pytest.raises(ValueError, match="mesh= alone"):
            TeacherPredictor(model, mesh=_cpu_mesh(n_spatial=2), **kw)
        with pytest.raises(ValueError, match="mesh= alone"):
            StudentPredictor(mesh=_cpu_mesh(n_data=2), **kw)
    spatial = TeacherPredictor(model, mesh=_cpu_mesh(n_spatial=2))
    msg = "shards its batch over the 'data' mesh axis only"
    with pytest.raises(ValueError, match="tiled serving " + msg):
        spatial.denoise_tiled([np.zeros((64, 64, 3), np.float32)], tile=32)
    with pytest.raises(ValueError, match="tiled serving " + msg):
        JaxTeacherPredictor(params=params, model=JaxTeacher(**TINY),
                            mesh=jmesh.make_mesh(n_data=4, n_spatial=2)).denoise_tiled(
            [np.zeros((64, 64, 3), np.float32)], tile=32)
    jax_mesh = jmesh.make_mesh(n_data=4, n_spatial=2)
    for cls, jax_built, name in (
            (StudentPredictor, lambda: JaxStudentPredictor(params={}, mesh=jax_mesh),
             "StudentPredictor"),
            (ASDQEScorer, lambda: JaxScorer(variables={}, mesh=jax_mesh), "ASDQEScorer")):
        for axes in (dict(n_spatial=2), dict(n_model=2)):
            with pytest.raises(ValueError, match=f"{name} {msg}"):
                cls(mesh=_cpu_mesh(**axes))
        with pytest.raises(ValueError, match=f"{name} {msg}"):
            jax_built()
    assert not spatial.scan_eligible([np.zeros((8, 8, 3), np.float32)] * 2, 2)


def test_denoise_group_on_spatial_mesh_serves_per_image(teachers):
    """``denoise_group`` with a spatial mesh: per-image calls, bit for bit
    (JAX ``eval/infer.py:287-291``), mixed shapes and a short tail too."""
    _, model = teachers["train"]
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (40, 48, 3), dtype=np.uint8) for _ in range(3)]
    imgs.append(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    pred = TeacherPredictor(model, mesh=_cpu_mesh(n_spatial=2))
    for got, im in zip(pred.denoise_group(imgs, 0.5, group_size=2), imgs):
        one = pred(im, 0.5)
        for key in ("hq", "sr"):
            np.testing.assert_array_equal(got[key], one[key])


def test_data_mesh_serves_as_devices(teachers):
    """A mesh whose only axis above 1 is 'data' is ``devices=`` its data
    devices: the tiled teacher and the student give the same bits."""
    _, model = teachers["train"]
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)]
    kw = dict(denoise_rate=0.8, tile=32, tile_batch=2)
    by_mesh = TeacherPredictor(model, mesh=_cpu_mesh(n_data=2))
    by_devices = TeacherPredictor(model, devices=["cpu"] * 2)
    assert len(by_mesh.models) == 2 and by_mesh._bands is None
    for a, b in zip(by_mesh.denoise_tiled(imgs, **kw), by_devices.denoise_tiled(imgs, **kw)):
        np.testing.assert_array_equal(a["hq"], b["hq"])
    student = StudentPredictor(mesh=_cpu_mesh(n_data=2), num_frames=3, multiple_of=4)
    assert [cp.device for cp in student._copies] == [torch.device("cpu")] * 2
