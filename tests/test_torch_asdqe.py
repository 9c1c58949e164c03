"""Port ASDQE scorer against the JAX package (CPU): the model against flax
with non-trivial BatchNorm statistics, the scorer in float32 and bfloat16,
the trained zoo scorer, the weight bridges, the evaluation protocol and the
resize / pool ops."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.convert.torch_export import (
    export_asdqe,
    save_pth,
)
from rethink_acoustic_image_enhancement_tpu.eval import asdqe_eval as jax_eval
from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    ASDQEScorer as JaxScorer,
)
from rethink_acoustic_image_enhancement_tpu.models.asdqe import (
    DenoiseRatePredictor as JaxPredictor,
)
from rethink_acoustic_image_enhancement_tpu.models.asdqe import Up as JaxUp
from rethink_acoustic_image_enhancement_tpu.ops import resize as jax_resize
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.eval import asdqe_eval
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import ASDQEScorer
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    DenoiseRatePredictor,
    build_network,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.asdqe import Up
from rethink_acoustic_image_enhancement_tpu_torch.ops import resize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _double_conv(rng, cin, f):
    def conv(k, ci, co):
        return {"kernel": (rng.normal(size=(k, k, ci, co))
                           * (k * k * ci) ** -0.5).astype(np.float32),
                "bias": (rng.normal(size=co) * 0.05).astype(np.float32)}

    def bn():
        return ({"scale": (1 + rng.normal(size=f) * 0.1).astype(np.float32),
                 "bias": (rng.normal(size=f) * 0.1).astype(np.float32)},
                {"mean": (rng.normal(size=f) * 0.1).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, size=f).astype(np.float32)})

    (bn1, st1), (bn2, st2) = bn(), bn()
    return ({"conv1": conv(3, cin, f), "bn1": bn1, "conv2": conv(3, f, f),
             "bn2": bn2}, {"bn1": st1, "bn2": st2})


def _variables(seed=0, dim=16):
    """A seeded flax DenoiseRatePredictor tree (numpy): LeCun-normal
    kernels, and BatchNorm scales, biases and running statistics off their
    defaults."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name in ("lq_extractor", "gt_extractor", "diff_extractor"):
        params[name], stats[name] = _double_conv(rng, 3, dim)
    up, us = {}, {}
    up["inc"], us["inc"] = _double_conv(rng, 3 * dim, 64)
    for name, cin, f in (("down1", 64, 128), ("down2", 128, 256),
                         ("down3", 256, 256), ("up1", 512, 128),
                         ("up2", 256, 64), ("up3", 128, 64)):
        p, s = _double_conv(rng, cin, f)
        up[name], us[name] = {"conv": p}, {"conv": s}
    up["outc"] = {"kernel": (rng.normal(size=(1, 1, 64, 3 * dim)) / 8).astype(np.float32),
                  "bias": np.zeros(3 * dim, np.float32)}
    params["unet"], stats["unet"] = up, us
    for name, i, o in (("fc1", 3 * dim, 256), ("fc2", 256, 64), ("fc3", 64, 1)):
        params[name] = {"kernel": (rng.normal(size=(i, o)) * i ** -0.5).astype(np.float32),
                        "bias": (rng.normal(size=o) * 0.05).astype(np.float32)}
    return {"params": params, "batch_stats": stats}


def _pairs(b, h, w, seed):
    rng = np.random.default_rng(seed)
    lq = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    noise = rng.integers(-40, 41, (b, h, w, 3))
    return lq, np.clip(lq.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def _port(variables, dtype=torch.float32):
    model = weights.load_asdqe_params(DenoiseRatePredictor(), variables["params"],
                                      variables["batch_stats"])
    return ASDQEScorer(model, dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def variables():
    return _variables()


def test_model_matches_flax_with_running_stats(variables):
    lq, gt = _pairs(2, 40, 56, seed=1)  # zero-padded to 48x64 inside
    gt[1] = lq[1] // 2  # a second pair unlike the first
    lq, gt = lq.astype(np.float32) / 255.0, gt.astype(np.float32) / 255.0
    apply = JaxPredictor().apply
    ref, ref_z = (np.asarray(a) for a in jax.jit(lambda v, a, b: (
        apply(v, a, b), apply(v, a, b, return_features=True)))(variables, lq, gt))
    model = _port(variables).model
    with torch.no_grad():
        t = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (lq, gt)]
        got, got_z = model(*t).numpy(), model(*t, return_features=True).numpy()
    assert got.shape == ref.shape == (2, 1)
    assert np.ptp(ref) > 1e-3 and np.abs(ref).max() < 0.99, ref  # not saturated
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got_z.shape == (2, 48)
    assert np.abs(got_z - ref_z).max() / np.abs(ref_z).max() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scorer_matches_jax(variables, dtype):
    lq, gt = _pairs(2, 40, 56, seed=2)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jscorer = JaxScorer(variables=variables, dtype=jdtype)
    scorer = _port(variables, dtype)
    tol = 1e-4 if dtype == torch.bfloat16 else 1e-5
    got = scorer(lq, gt)
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jscorer(lq, gt)), rtol=0, atol=tol)
    if dtype == torch.bfloat16:  # one (H, W, 3) float pair, rounded to bf16
        f_lq, f_gt = lq[0].astype(np.float32) / 255.0, gt[0].astype(np.float32) / 255.0
        np.testing.assert_allclose(scorer(f_lq, f_gt), np.asarray(jscorer(f_lq, f_gt)),
                                   rtol=0, atol=tol)
    assert all(v.dtype != torch.bfloat16 for v in scorer.model.state_dict().values())


def test_trained_zoo_scorer_matches_jax():
    pytest.importorskip("orbax.checkpoint")
    from rethink_acoustic_image_enhancement_tpu.train.checkpoints import (
        load_asdqe_weights,
    )

    params, stats = load_asdqe_weights(
        os.path.join(REPO, "artifacts/asdqe_full50ep/weights/net_g_best"))
    v = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})
    lq, gt = _pairs(2, 64, 64, seed=3)
    np.testing.assert_allclose(_port(v)(lq, gt), np.asarray(JaxScorer(variables=v)(lq, gt)),
                               rtol=0, atol=1e-5)


def test_export_asdqe_loads_strictly_with_the_same_scores(variables, tmp_path):
    lq, gt = _pairs(1, 32, 32, seed=4)
    want = _port(variables)(lq, gt)
    exported = DenoiseRatePredictor()
    exported.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
         for k, v in export_asdqe(variables["params"], variables["batch_stats"]).items()},
        strict=True)
    np.testing.assert_array_equal(ASDQEScorer(exported, device="cpu")(lq, gt), want)
    path = str(tmp_path / "asdqe.pth")
    save_pth(path, variables["params"], "DenoiseRatePredictor",
             batch_stats=variables["batch_stats"])
    from_pth = weights.load_pth(DenoiseRatePredictor(), path)
    np.testing.assert_array_equal(ASDQEScorer(from_pth, device="cpu")(lq, gt), want)


def _write_pairs(root, names, shape, seed):
    cv2 = pytest.importorskip("cv2")
    lq_dir, dn_dir = root / "origin", root / "method"
    lq_dir.mkdir()
    dn_dir.mkdir()
    lq, gt = _pairs(len(names), *shape, seed=seed)
    for i, name in enumerate(names):
        cv2.imwrite(str(lq_dir / f"{name}.png"), lq[i][..., ::-1])
        cv2.imwrite(str(dn_dir / f"{name}.png"), gt[i][..., ::-1])
    return str(lq_dir), str(dn_dir)


def test_score_method_and_run_asdqe_eval_match_jax(variables, tmp_path):
    lq_dir, dn_dir = _write_pairs(tmp_path, ["a", "b", "c"], (32, 48), seed=5)
    scorer, jscorer = _port(variables), JaxScorer(variables=variables)
    got = asdqe_eval.score_method(scorer, lq_dir, dn_dir)
    ref = jax_eval.score_method(jscorer, lq_dir, dn_dir)
    assert got.dtype == np.float64 and got.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    methods = {"origin": lq_dir, "method": dn_dir}
    stats = asdqe_eval.run_asdqe_eval(scorer, lq_dir, methods,
                                      csv_path=str(tmp_path / "port.csv"),
                                      verbose=False)
    jstats = jax_eval.run_asdqe_eval(jscorer, lq_dir, methods, csv_path=None,
                                     verbose=False)
    for m in methods:
        for k in asdqe_eval.STAT_KEYS:
            assert abs(stats[m][k] - jstats[m][k]) <= 1e-5, (m, k)
    jax_eval.write_stats_csv(stats, str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert asdqe_eval.format_stats_table(stats) == jax_eval.format_stats_table(stats)
    assert asdqe_eval.default_methods("/s") == jax_eval.default_methods("/s")


def test_paired_files_raises_where_jax_raises(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    for name in ("x.png", "y.png"):
        (tmp_path / "a" / name).write_bytes(b"")
    (tmp_path / "b" / "x.jpg").write_bytes(b"")
    for fn in (asdqe_eval.paired_files, jax_eval.paired_files):
        with pytest.raises(ValueError, match="count mismatch"):
            fn(str(tmp_path / "a"), str(tmp_path / "b"))
    (tmp_path / "b" / "z.jpg").write_bytes(b"")
    for fn in (asdqe_eval.paired_files, jax_eval.paired_files):
        with pytest.raises(ValueError, match="do not match"):
            fn(str(tmp_path / "a"), str(tmp_path / "b"))
    (tmp_path / "b" / "z.jpg").unlink()
    (tmp_path / "b" / "y.bmp").write_bytes(b"")
    assert asdqe_eval.paired_files(str(tmp_path / "a"), str(tmp_path / "b")) == \
        jax_eval.paired_files(str(tmp_path / "a"), str(tmp_path / "b"))


@pytest.mark.parametrize("hw,out", [((1, 1), (2, 2)), ((1, 5), (2, 10)),
                                    ((3, 1), (6, 2)), ((3, 5), (6, 10)),
                                    ((7, 4), (14, 8)), ((5, 7), (5, 14))])
def test_resize_bilinear_align_corners_matches_jax(hw, out):
    x = np.random.default_rng(hw[0] * 10 + hw[1]).normal(size=(2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_resize.resize_bilinear_align_corners(jnp.asarray(x), *out))
    got = resize.resize_bilinear_align_corners(
        torch.from_numpy(x).permute(0, 3, 1, 2), *out).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_pools_match_jax():
    x = np.random.default_rng(7).normal(size=(2, 6, 10, 4)).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(resize.max_pool_2x2(t).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_resize.max_pool_2x2(jnp.asarray(x))))
    np.testing.assert_allclose(resize.global_avg_pool(t).numpy(),
                               np.asarray(jax_resize.global_avg_pool(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


def test_up_pads_to_the_skip_like_flax():
    """x1 (3, 5) doubles to (6, 10); the skip is (7, 11): one row and one
    column of zeros, dy // 2 = 0 above and 1 below."""
    rng = np.random.default_rng(8)
    p, s = _double_conv(rng, 12, 6)
    x1 = rng.normal(size=(1, 3, 5, 4)).astype(np.float32)
    x2 = rng.normal(size=(1, 7, 11, 8)).astype(np.float32)
    ref = np.asarray(JaxUp(6).apply({"params": {"conv": p},
                                     "batch_stats": {"conv": s}}, x1, x2))
    up = Up(12, 6)
    sd = {}
    weights._double_conv(sd, "conv.double_conv", p, s)
    up.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = up.eval()(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x1, x2)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5)


def test_registry_builds_the_scorer_and_default_device_raises(monkeypatch, variables):
    net = build_network({"type": "DenoiseRatePredictor", "in_channels": 3, "dim": 16})
    assert isinstance(net, DenoiseRatePredictor)
    sd = weights.asdqe_state_dict(variables["params"], variables["batch_stats"])
    assert set(net.state_dict()) == set(sd)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ASDQEScorer()
