"""Data-parallel serving of the port (``devices=[...]``) against one device
and against the JAX predictors on a ``data`` mesh (CPU): the tiled teacher
and the student within one uint8 level, the scorer within 1e-5; the same
ValueErrors; ``__call__`` and ``denoise_group`` bit-identical to one device;
the caller's module untouched. Also the kernels' launch counter and the
TF32 pin under threads, and the kernels' device check."""

import sys
import threading

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
from rethink_acoustic_image_enhancement_tpu.models.asdqe import (
    DenoiseRatePredictor as JaxScorerModel,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_student import (
    KDLAEStudent as JaxStudent,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_teacher import (
    KDLAETeacher as JaxTeacher,
)
from rethink_acoustic_image_enhancement_tpu.parallel.mesh import make_mesh
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.eval.asdqe_eval import score_pairs
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import (
    ASDQEScorer,
    StudentPredictor,
    TeacherPredictor,
    highest_precision,
)
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    DenoiseRatePredictor,
    KDLAEStudent,
    KDLAETeacher,
)
from rethink_acoustic_image_enhancement_tpu_torch.ops import _build
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

torch.set_num_threads(2)

NARROW = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", static="train",
              params="cat")
STUDENT = dict(residual=True, hidden_channels=(16, 32, 64))


def _levels(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    return int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())


@pytest.fixture(scope="module")
def teacher():
    img = jnp.zeros((1, 16, 16, 3))
    p = JaxTeacher(**NARROW).init(jax.random.PRNGKey(1),
                                  {"img": img, "denoise_rate": img[..., :1]})
    params = jax.tree_util.tree_map(np.asarray, p["params"])
    model = weights.load_teacher_params(KDLAETeacher(**NARROW), params)
    return params, model


def _frames():
    """The JAX data-mesh test's images: 9 + 4 tiles of 32 and one image
    smaller than a tile (the whole-image path)."""
    rng = np.random.default_rng(11)
    return [(rng.uniform(0, 1, (70, 90, 3)) * 255).astype(np.uint8),
            (rng.uniform(0, 1, (40, 40, 3)) * 255).astype(np.uint8),
            (rng.uniform(0, 1, (16, 16, 3)) * 255).astype(np.uint8)]


@pytest.mark.parametrize("n_copies,tile_batch,halo", [(2, 4, 0), (2, 2, 8), (4, 4, 0)])
def test_tiled_teacher_on_copies(teacher, n_copies, tile_batch, halo):
    """13 tiles in chunks of ``tile_batch`` (a padded last chunk), split over
    the copies: within 1 level of one device and of the JAX predictor on a
    ``data`` mesh of the same size."""
    params, model = teacher
    imgs = _frames()
    kw = dict(denoise_rate=0.8, tile=32, halo=halo, tile_batch=tile_batch)
    one = TeacherPredictor(model, device="cpu").denoise_tiled(imgs, **kw)
    dp = TeacherPredictor(model, devices=["cpu"] * n_copies).denoise_tiled(imgs, **kw)
    jx = JaxTeacherPredictor(params=params, model=JaxTeacher(**NARROW),
                             mesh=make_mesh(n_data=n_copies)).denoise_tiled(imgs, **kw)
    for d, o, j, im in zip(dp, one, jx, imgs):
        for key in ("hq", "sr"):
            assert _levels(d[key], o[key]) <= 1
            assert _levels(d[key], j[key]) <= 1
        mask = np.all(im == 0, axis=-1)
        assert not d["hq"][mask].any()


def test_tiled_teacher_refusals(teacher):
    _, model = teacher
    im = _frames()[0]
    two = TeacherPredictor(model, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match=r"tile_batch \(6\).*number of devices \(4\)"):
        TeacherPredictor(model, devices=["cpu"] * 4).denoise_tiled(
            [im], tile=32, tile_batch=6)
    with pytest.raises(ValueError, match=r"tile_batch \(3\).*\(2\)"):
        two.denoise_tiled([im], tile=32, tile_batch=3)
    with pytest.raises(ValueError, match="at least one device"):
        TeacherPredictor(model, devices=[])
    with pytest.raises(ValueError, match="not both"):
        TeacherPredictor(model, device="cpu", devices=["cpu"])


def test_whole_image_and_groups_on_copies_equal_one_device(teacher):
    """``__call__`` and ``denoise_group`` run devices[0]'s copy: the bits of
    one device (groups per image, as the JAX package serves a mesh)."""
    _, model = teacher
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (40, 48, 3), dtype=np.uint8) for _ in range(3)]
    one = TeacherPredictor(model, device="cpu")
    dp = TeacherPredictor(model, devices=["cpu", "cpu"])
    assert dp.device == torch.device("cpu")
    for key in ("hq", "sr"):
        np.testing.assert_array_equal(dp(imgs[0], 0.7)[key], one(imgs[0], 0.7)[key])
    for a, b in zip(dp.denoise_group(imgs, 0.7, group_size=2),
                    one.denoise_group(imgs, 0.7, group_size=2)):
        for key in ("hq", "sr"):
            np.testing.assert_array_equal(a[key], b[key])


def test_copies_are_their_own_and_the_callers_module_is_untouched(teacher):
    _, model = teacher
    before = {k: v.clone() for k, v in model.state_dict().items()}
    dp = TeacherPredictor(model, fused=True, devices=["cpu", "cpu", "cpu"])
    models = dp.models
    assert models[0] is dp.model
    single = TeacherPredictor(model, device="cpu")
    assert len(single.models) == 1 and single.models[0] is single.model
    assert len({id(m) for m in models + [model]}) == 4
    assert len({next(m.parameters()).data_ptr() for m in models + [model]}) == 4
    assert all(not m.training for m in models) and model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for key, pred in (("student", StudentPredictor(KDLAEStudent(**STUDENT),
                                                   devices=["cpu", "cpu"])),
                      ("scorer", ASDQEScorer(DenoiseRatePredictor(dim=4),
                                             devices=["cpu", "cpu"]))):
        assert len({id(cp.model) for cp in pred._copies}) == 2, key
        assert len({id(cp.transfers) for cp in pred._copies}) == 2, key


@pytest.fixture(scope="module")
def student():
    params = JaxStudent(**STUDENT).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 3, 16, 16)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, weights.load_student_params(KDLAEStudent(**STUDENT), params)


@pytest.mark.parametrize("batch,n_copies", [(6, 4), (5, 2), (2, 2)])
def test_student_batch_on_copies(student, batch, n_copies):
    """The JAX test's stacks: padded to an even split and sliced back,
    within 1 level of one device and of JAX on ``n_data`` devices."""
    params, model = student
    rng = np.random.default_rng(3)
    stacks = (rng.uniform(0, 1, (batch, 3, 40, 48)) * 255).astype(np.uint8)
    kw = dict(num_frames=3, multiple_of=4)
    one = StudentPredictor(model, device="cpu", **kw).denoise_batch(stacks)
    dp = StudentPredictor(model, devices=["cpu"] * n_copies, **kw).denoise_batch(stacks)
    jx = JaxStudentPredictor(params=params, model=JaxStudent(**STUDENT),
                             mesh=make_mesh(n_data=n_copies), **kw).denoise_batch(stacks)
    assert dp.shape == stacks.shape
    assert _levels(dp, one) <= 1
    assert _levels(dp, jx) <= 1


@pytest.fixture(scope="module")
def scorer():
    model = JaxScorerModel()
    x0 = jnp.zeros((1, 32, 32, 3))
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), x0, x0))
    port = weights.load_asdqe_params(DenoiseRatePredictor(), variables["params"],
                                     variables["batch_stats"])
    return variables, port


def test_scorer_batch_on_copies(scorer):
    """Batch 5 on 2 copies (padded to 6): the scores of one device and of
    JAX on a 2-way ``data`` mesh within 1e-5."""
    variables, model = scorer
    rng = np.random.default_rng(7)
    lq = rng.uniform(0, 1, (5, 48, 48, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (5, 48, 48, 3)).astype(np.float32)
    dp = ASDQEScorer(model, devices=["cpu", "cpu"])
    got = dp(lq, gt)
    assert got.shape == (5,)
    one = ASDQEScorer(model, device="cpu")(lq, gt)
    jx = np.asarray(JaxScorer(variables=variables, model=JaxScorerModel(),
                              mesh=make_mesh(n_data=2))(lq, gt))
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jx, rtol=1e-5, atol=1e-6)
    # dispatch keeps the padded split, the real scores first
    handle = dp.dispatch(dp.upload(lq, gt))
    assert handle.shape == (6,) and handle.device == torch.device("cpu")
    np.testing.assert_array_equal(handle[:5].numpy(), got)


def test_scorer_batch1_pipeline_on_copies(scorer):
    """``score_pairs`` reads element 0 of each batch-1 handle (each pair
    padded to one per copy): one device's and JAX's scores within 1e-5."""
    variables, model = scorer
    rng = np.random.default_rng(9)
    pairs = [(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8),
              rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)) for _ in range(4)]
    got = score_pairs(ASDQEScorer(model, devices=["cpu", "cpu"]), pairs)
    one = score_pairs(ASDQEScorer(model, device="cpu"), pairs)
    jscorer = JaxScorer(variables=variables, model=JaxScorerModel(),
                        mesh=make_mesh(n_data=2))
    jx = np.asarray([np.asarray(jscorer(a, b))[0] for a, b in pairs])
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jx, rtol=1e-5, atol=1e-6)


def test_launch_count_is_exact_under_threads():
    """32 threads (more than the cores) counting at once with a short switch
    interval: no increment is lost."""
    fn = pstage.fused_transformer_stage
    saved_count, saved_interval = fn.launches, sys.getswitchinterval()
    fn.launches = 0
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _build.count_launch(fn)

        threads = [threading.Thread(target=work) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert fn.launches == 32 * 2000
    finally:
        sys.setswitchinterval(saved_interval)
        fn.launches = saved_count


def test_tf32_stays_off_while_any_thread_is_inside():
    """Threads inside ``highest_precision`` at once: the flags are off for
    all of them until the last leaves, then back as they were."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    inside = threading.Barrier(8)
    seen = []

    def work(k):
        with highest_precision():
            inside.wait(timeout=30)
            for _ in range(50 + 10 * k):
                seen.append((torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32))

    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert seen and all(flags == (False, False) for flags in seen)
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("key", ["w_qkv", "ln_bias"])
def test_kernel_device_check_names_both_devices(key):
    """A weight on another device than x raises before anything launches
    (``meta`` stands in for a second device here)."""
    x = torch.empty(1, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match=f"{key} is on cpu, x on meta"):
        _build.on_device(x, "stage", **{key: torch.zeros(16), "absent": None})
