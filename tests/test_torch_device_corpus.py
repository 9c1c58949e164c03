"""The port's device-resident corpora (``train/device_corpus.py``) and
``ops/mask.py::frame_interpolation_corrupt`` against the JAX package's, on
the CPU, on corpora of <= 64 px frames written with the port's imwrite:

  * frame interpolation: the port's core fed the uniforms JAX's
    ``input_mask`` draws from ``jax.random.split(key)`` equals JAX's output
    exactly;
  * each corpus's tensors (lq, gt, sr, dn, rates, eff_h / eff_w, the
    student's group table before and after ``set_epoch``) are bit-identical
    to the JAX corpus's on the same folder, NHWC turned NCHW;
  * each sampler's ``apply`` fed the draws JAX's ``_sample_one`` makes from
    a key (rebuilt here by the same ``jax.random`` calls) equals JAX's
    ``sample_batch`` exactly, and within 1e-6 where Gaussian noise is added;
  * the port's own draws: corruption rate, noise-gate rate and aug coverage
    within the bounds of tests/test_device_corpus.py; a seed gives the same
    batch twice.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.ops import mask as jmask
from rethink_acoustic_image_enhancement_tpu.train import device_corpus as jdc
from rethink_acoustic_image_enhancement_tpu_torch.data.transforms import data_augmentation
from rethink_acoustic_image_enhancement_tpu_torch.ops import mask as tmask
from rethink_acoustic_image_enhancement_tpu_torch.train import device_corpus as tdc
from rethink_acoustic_image_enhancement_tpu_torch.train import progressive as tprog
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def student_root(tmp_path_factory):
    """12 numbered gray frame pairs of 48x56; lq frames 0-5 all zero, so
    that the rescue noise runs."""
    root = tmp_path_factory.mktemp("student")
    rng = np.random.default_rng(0)
    for sub in ("lq", "gt"):
        os.makedirs(root / sub)
    for i in range(12):
        img = rng.integers(30, 220, (48, 56), dtype=np.uint8)
        noisy = np.clip(img + rng.normal(0, 15, img.shape), 0, 255).astype(np.uint8)
        imwrite(str(root / "gt" / f"{i}_f.png"), img, rgb=False)
        imwrite(str(root / "lq" / f"{i}_f.png"), noisy * (i >= 6), rgb=False)
    return root


def _student_opt(root, **kw):
    return {"type": "Dataset_PairedMutiImage", "phase": "train", "scale": 1,
            "dataroot_lq": str(root / "lq"), "dataroot_gt": str(root / "gt"),
            "num_pairs": 5, "stride_range": [1, 1], "prob": 0.1, "gt_size": 32,
            "geometric_augs": True, "seed": 3, **kw}


@pytest.fixture(scope="module")
def teacher_root(tmp_path_factory):
    """6 lq / gt / 2x sr / JSON-rate images of mixed sizes; image 0's lq a
    third black, so that the epsilon guard runs."""
    root = tmp_path_factory.mktemp("teacher")
    rng = np.random.default_rng(1)
    for sub in ("lq", "gt", "sr", "params"):
        os.makedirs(root / sub)
    for i in range(6):
        h, w = 40 + 2 * i, 44 + 2 * i
        gt = rng.integers(20, 230, (h, w, 3), dtype=np.uint8)
        lq = np.clip(gt + rng.normal(0, 10, gt.shape), 0, 255).astype(np.uint8)
        if i == 0:
            lq[:, : w // 3] = 0
        imwrite(str(root / "gt" / f"img{i:03d}.png"), gt)
        imwrite(str(root / "lq" / f"img{i:03d}.png"), lq)
        imwrite(str(root / "sr" / f"img{i:03d}.png"),
                rng.integers(20, 230, (2 * h, 2 * w, 3), dtype=np.uint8))
        (root / "params" / f"img{i:03d}.json").write_text(json.dumps({"denoise_rate": 0.1 * i}))
    return root


def _teacher_opt(root, **kw):
    return {"type": "Dataset_SuperRestoration_param", "phase": "train", "scale": 1,
            "dataroot_lq": str(root / "lq"), "dataroot_gt": str(root / "gt"),
            "dataroot_sr": str(root / "sr"), "dataroot_param": str(root / "params"),
            "gt_size": 24, "geometric_augs": True, "seed": 5, **kw}


@pytest.fixture(scope="module")
def siqa_root(tmp_path_factory):
    """3 (origin, denoised) source pairs of mixed sizes."""
    root = tmp_path_factory.mktemp("siqa")
    for sub in ("origin", "denoised"):
        os.makedirs(root / sub)
    for i, hw in enumerate([(40, 52), (48, 40), (56, 56)]):
        rng = np.random.default_rng(i)
        lq = (rng.uniform(0, 1, hw + (3,)) * 255).astype(np.uint8)
        dn = np.clip(lq.astype(np.int32) + 40, 0, 255).astype(np.uint8)
        imwrite(str(root / "origin" / f"{i:03d}.png"), lq)
        imwrite(str(root / "denoised" / f"{i:03d}.png"), dn)
    return root


def _siqa_opt(root, **kw):
    return {"dataroot_lq": str(root / "origin"), "dataroot_gt": str(root / "denoised"),
            "gt_size": 32, "geometric_augs": True, **kw}


def _np(x):
    return np.asarray(x)


def _nchw(x):
    return np.moveaxis(_np(x), -1, -3)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


# ------------------------------------------------------------ the mask ---

@pytest.mark.parametrize("prob", [0.1, 0.7])
def test_frame_interpolation_core_matches_jax(prob):
    rng = np.random.default_rng(2)
    stack = rng.random((2, 7, 12, 16), dtype=np.float32)
    key = jax.random.PRNGKey(4)
    want = jmask.frame_interpolation_corrupt(jnp.asarray(stack), key, prob)
    r_even, r_odd = jax.random.split(key)
    u_even = jax.random.uniform(r_even, stack.shape, jnp.float32)
    u_odd = jax.random.uniform(r_odd, stack.shape, jnp.float32)
    got = tmask.frame_interpolation_core(_t(stack), _t(u_even), _t(u_odd), prob)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_frame_interpolation_corrupt_draws_from_its_generator():
    stack = torch.rand((5, 20, 20), generator=torch.Generator().manual_seed(0))
    a = tmask.frame_interpolation_corrupt(stack, torch.Generator().manual_seed(1), 0.2)
    b = tmask.frame_interpolation_corrupt(stack, torch.Generator().manual_seed(1), 0.2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    dropped = (a <= -0.0999).float().mean((1, 2))
    # even frames at 0.2, odd frames at 0.7
    assert dropped[0::2].mean() == pytest.approx(0.2, abs=0.08), dropped
    assert dropped[1::2].mean() == pytest.approx(0.7, abs=0.08), dropped
    with pytest.raises(ValueError, match="odd frame count"):
        tmask.frame_interpolation_core(stack[:4], stack[:4], stack[:4], 0.2)


def test_input_mask_refuses_a_generator_on_another_device():
    with pytest.raises(ValueError, match="the generator is on cpu"):
        tmask.input_mask(torch.zeros(3, 4, device="meta"), torch.Generator(), 0.5)


def test_stage_extra_mask_draws_from_the_step_generator():
    """The repair: a device-resident step's extra mask draws its uniforms
    from the step's torch.Generator on the batch's device (it drew them on
    the host, one float32 per element, and uploaded them); the host route
    and its generator are untouched."""
    lq = {"img": torch.rand((2, 3, 8, 8)), "denoise_rate": torch.full((2, 1, 8, 8), 0.5)}
    rng = np.random.default_rng(0)
    before = rng.bit_generator.state
    out = tprog.stage_extra_mask(lq, torch.Generator().manual_seed(9), 0.3)
    want = tmask.mask_with_keep(lq["img"], torch.rand(
        (2, 3, 8, 8), generator=torch.Generator().manual_seed(9)) >= 0.3)
    torch.testing.assert_close(out["img"], want, rtol=0, atol=0)
    assert out["denoise_rate"] is lq["denoise_rate"]
    assert rng.bit_generator.state == before
    host = tprog.stage_extra_mask(lq, np.random.default_rng(1), 0.3)
    u = np.random.default_rng(1).random((2, 3, 8, 8), dtype=np.float32)
    torch.testing.assert_close(host["img"], tmask.mask_with_keep(
        lq["img"], torch.from_numpy(u) >= 0.3), rtol=0, atol=0)


# ------------------------------------------------------- corpus tensors ---

def test_student_corpus_tensors_match_jax(student_root):
    opt = _student_opt(student_root, stride_range=[1, 2])
    want, got = jdc.StudentDeviceCorpus(opt), tdc.StudentDeviceCorpus(opt, device="cpu")
    assert got.frame_hw == want.frame_hw and len(got) == len(want)
    np.testing.assert_array_equal(got.lq.numpy(), _np(want.lq))
    np.testing.assert_array_equal(got.gt.numpy(), _np(want.gt))
    np.testing.assert_array_equal(got.groups.numpy(), _np(want.groups))
    before = got.groups.clone()
    for c in (want, got):
        c.set_epoch(1)
    np.testing.assert_array_equal(got.groups.numpy(), _np(want.groups))
    assert not torch.equal(before, got.groups)  # the strides were re-rolled


@pytest.mark.parametrize("dstype", ["Dataset_SuperRestoration_param",
                                    "Dataset_SuperRestoration"])
def test_teacher_corpus_tensors_match_jax(teacher_root, dstype):
    opt = _teacher_opt(teacher_root, type=dstype)
    want, got = jdc.TeacherDeviceCorpus(opt), tdc.TeacherDeviceCorpus(opt, device="cpu")
    assert got.frame_hw == want.frame_hw and len(got) == len(want) == 6
    n, (h, w) = len(got), got.frame_hw
    for name, scale in (("lq", 1), ("gt", 1), ("sr", 2)):
        planes = getattr(got, name).reshape(n, 3, h * scale, w * scale)
        np.testing.assert_array_equal(planes.numpy(), _nchw(getattr(want, name)), err_msg=name)
    for name in ("rates", "eff_h", "eff_w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), _np(getattr(want, name)),
                                      err_msg=name)


def test_siqa_corpus_tensors_match_jax(siqa_root):
    want = jdc.SIQADeviceCorpus(_siqa_opt(siqa_root))
    got = tdc.SIQADeviceCorpus(_siqa_opt(siqa_root), device="cpu")
    n, (h, w) = len(got), got.frame_hw
    assert (h, w) == want.frame_hw and n == len(want) == 3
    for name in ("lq", "dn"):
        t = getattr(got, name)
        assert t.dtype == torch.uint8
        np.testing.assert_array_equal(t.reshape(n, 3, h, w).numpy(), _nchw(getattr(want, name)))
    for name in ("eff_h", "eff_w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), _np(getattr(want, name)))


# ----------------------------------------------- samplers on JAX's draws ---

def _stack(rows):
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def jax_student_draws(corpus, key, batch, g):
    """``StudentDeviceCorpus._sample_one``'s draws for each item's key."""
    f = corpus.num_pairs
    h, w = corpus.frame_hw
    rows = []
    for k in jax.random.split(key, batch):
        k_top, k_left, k_mode, k_boost, k_mask, k_noise, k_aug = jax.random.split(k, 7)
        r_even, r_odd = jax.random.split(k_mask)
        rows.append({
            "top": int(jax.random.randint(k_top, (), 0, h - g + 1)),
            "left": int(jax.random.randint(k_left, (), 0, w - g + 1)),
            "mask_mode": bool(jax.random.uniform(k_mode) < 0.64),
            "boost": _np(jax.random.uniform(k_boost, (f,)) > 0.64),
            "u_mask": np.stack([_np(jax.random.uniform(kk, (g, g)))
                                for kk in jax.random.split(k_mask, f)]),
            "u_even": _np(jax.random.uniform(r_even, (f, g, g))),
            "u_odd": _np(jax.random.uniform(r_odd, (f, g, g))),
            "noise": _np(jax.random.normal(k_noise, (f, g, g))),
            "aug": int(jax.random.randint(k_aug, (), 0, 8)),
        })
    return {k: _t(v) for k, v in _stack(rows).items()}


def _sync_draws(k_hf, k_vf, k_rot):
    return {"hflip": bool(jax.random.uniform(k_hf) < 0.5),
            "vflip": bool(jax.random.uniform(k_vf) < 0.5),
            "rot": int(jax.random.randint(k_rot, (), 0, 4))}


def _window(k_top, k_left, eff_h, eff_w, g):
    hi_t, hi_l = max(eff_h - 1 - g, 1), max(eff_w - 1 - g, 1)
    return {"top": int(jax.random.randint(k_top, (), 1, hi_t + 1)),
            "left": int(jax.random.randint(k_left, (), 1, hi_l + 1))}


def jax_teacher_draws(corpus, key, ids, g):
    """``TeacherDeviceCorpus._sample_one``'s draws, the noise NCHW."""
    rows = []
    for k, i in zip(jax.random.split(key, len(ids)), ids):
        k_top, k_left, k_gate, k_sigma, k_noise, k_hf, k_vf, k_rot = jax.random.split(k, 8)
        rows.append({
            **_window(k_top, k_left, int(corpus.eff_h[i]), int(corpus.eff_w[i]), g),
            "gate": bool(jax.random.uniform(k_gate) < 0.1),
            "sigma": np.float32(jax.random.uniform(k_sigma, (), minval=1.0, maxval=30.0)),
            "noise": _nchw(jax.random.normal(k_noise, (g, g, 3))),
            **_sync_draws(k_hf, k_vf, k_rot),
        })
    return {k: _t(v) for k, v in _stack(rows).items()}


def jax_siqa_draws(corpus, key, ids, g):
    """``SIQADeviceCorpus._sample_one``'s draws."""
    rows = []
    for k, i in zip(jax.random.split(key, len(ids)), ids):
        k_top, k_left, k_lam, k_hf, k_vf, k_rot = jax.random.split(k, 6)
        rows.append({**_window(k_top, k_left, int(corpus.eff_h[i]), int(corpus.eff_w[i]), g),
                     "lam": np.float32(jax.random.uniform(k_lam, ())),
                     **_sync_draws(k_hf, k_vf, k_rot)})
    return {"size": g, **{k: _t(v) for k, v in _stack(rows).items()}}


def test_student_sampler_on_jax_draws(student_root):
    """Three keys of four items: both corruption modes, the rescue noise
    (the blank frames) and several aug modes occur."""
    opt = _student_opt(student_root)
    want_c, got_c = jdc.StudentDeviceCorpus(opt), tdc.StudentDeviceCorpus(opt, device="cpu")
    ids, g = [0, 1, 5, 7], 32
    modes, noisy_items, augs = set(), 0, set()
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want_lq, want_gt = want_c.sample_batch(key, ids, gt_size=g)
        draws = jax_student_draws(want_c, key, len(ids), g)
        lq, gt = got_c.apply(got_c.ids(ids), draws)
        np.testing.assert_array_equal(gt.numpy(), _np(want_gt))
        np.testing.assert_allclose(lq.numpy(), _np(want_lq), rtol=0, atol=1e-6)
        clean = lq.numpy().min(axis=(1, 2, 3)) <= -0.0999  # no noise where masks show
        np.testing.assert_array_equal(lq.numpy()[clean], _np(want_lq)[clean])
        modes |= set(draws["mask_mode"].tolist())
        noisy_items += int((~clean).sum())
        augs |= set(draws["aug"].tolist())
    assert modes == {True, False} and noisy_items > 0 and len(augs) >= 4


def test_teacher_sampler_on_jax_draws(teacher_root):
    opt = _teacher_opt(teacher_root)
    want_c, got_c = jdc.TeacherDeviceCorpus(opt), tdc.TeacherDeviceCorpus(opt, device="cpu")
    ids, g = [0, 3, 5, 1, 0, 2, 4, 0], 24
    gates = guards = 0
    for seed in range(3):
        key = jax.random.PRNGKey(10 + seed)
        want_lq, want_gt = want_c.sample_batch(key, ids, gt_size=g)
        draws = jax_teacher_draws(want_c, key, ids, g)
        lq, gt = got_c.apply(got_c.ids(ids), draws)
        np.testing.assert_array_equal(gt["hq"].numpy(), _nchw(want_gt["hq"]))
        np.testing.assert_array_equal(gt["sr"].numpy(), _nchw(want_gt["sr"]))
        np.testing.assert_array_equal(lq["denoise_rate"].numpy(), _nchw(want_lq["denoise_rate"]))
        gate = draws["gate"].numpy()
        np.testing.assert_allclose(lq["img"].numpy(), _nchw(want_lq["img"]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(lq["img"].numpy()[~gate], _nchw(want_lq["img"])[~gate])
        gates += int(gate.sum())
        guards += int((lq["img"].numpy() == 1e-14).any(axis=(1, 2, 3)).sum())
    assert gates > 0 and guards > 0, (gates, guards)


def test_siqa_sampler_on_jax_draws(siqa_root):
    want_c = jdc.SIQADeviceCorpus(_siqa_opt(siqa_root))
    got_c = tdc.SIQADeviceCorpus(_siqa_opt(siqa_root), device="cpu")
    ids, g = [0, 1, 2, 0, 2, 1], 32
    for seed in range(2):
        key = jax.random.PRNGKey(20 + seed)
        want = want_c.sample_batch(key, ids, gt_size=g)
        lq, cand, lam = got_c.apply(got_c.ids(ids), jax_siqa_draws(want_c, key, ids, g))
        assert lq.dtype == cand.dtype == torch.uint8
        np.testing.assert_array_equal(lq.numpy(), _nchw(want[0]))
        np.testing.assert_array_equal(cand.numpy(), _nchw(want[1]))
        np.testing.assert_array_equal(lam.numpy(), _np(want[2]))


@pytest.mark.parametrize("mode", range(8))
def test_augment8_is_the_host_mode(mode):
    img = np.arange(20.0, dtype=np.float32).reshape(4, 5)
    np.testing.assert_array_equal(tdc.augment8(torch.from_numpy(img), mode).numpy(),
                                  data_augmentation(img, mode))
    table = tdc._aug8_table(4, CPU)
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    got = tdc._permute(x, table, torch.tensor([mode]))[0, 0]
    torch.testing.assert_close(got, tdc.augment8(x[0, 0], mode), rtol=0, atol=0)


# ------------------------------------------------------ the port's draws ---

def test_student_draws_rates_and_determinism(student_root):
    c = tdc.StudentDeviceCorpus(_student_opt(student_root, prob=0.2, geometric_augs=False),
                                device="cpu")
    ids = list(range(6, len(c)))  # the groups without a blank frame
    gen = tdc.seeded_generator(CPU, 0, 1)
    lq, gt = c.sample_batch(gen, ids, gt_size=32)
    assert lq.shape == gt.shape == (len(ids), 5, 32, 32)
    drops = [float((lq <= -0.0999).float().mean())]
    for s in range(2, 6):
        drops.append(float((c.sample_batch(tdc.seeded_generator(CPU, 0, s), ids)[0]
                            <= -0.0999).float().mean()))
    assert 0.25 <= np.mean(drops) <= 0.55, drops
    again = c.sample_batch(tdc.seeded_generator(CPU, 0, 1), ids, gt_size=32)
    torch.testing.assert_close(again[0], lq, rtol=0, atol=0)
    other = c.sample_batch(tdc.seeded_generator(CPU, 0, 2), ids, gt_size=32)
    assert not torch.equal(other[0], lq)


def test_teacher_draws_gate_rate_and_aug_coverage(teacher_root):
    c = tdc.TeacherDeviceCorpus(_teacher_opt(teacher_root), device="cpu")
    ids = [1, 2, 3, 4, 5] * 12
    draws = c.draw(tdc.seeded_generator(CPU, 7), c.ids(ids), 24)
    assert 1 <= int(draws["gate"].sum()) <= 16
    modes = set(tdc._sync_mode(draws).tolist())
    assert len({(m // 8, (m // 4) % 2, m % 4) for m in modes}) >= 4
    top, left = draws["top"].numpy(), draws["left"].numpy()
    eff_h, eff_w = c.eff_h[c.ids(ids)].numpy(), c.eff_w[c.ids(ids)].numpy()
    assert (top >= 1).all() and (top <= np.maximum(eff_h - 1 - 24, 1)).all()
    assert (left >= 1).all() and (left <= np.maximum(eff_w - 1 - 24, 1)).all()
    lq, gt = c.apply(c.ids(ids), draws)
    assert lq["img"].shape == (60, 3, 24, 24) and gt["sr"].shape == (60, 3, 48, 48)
    again = c.sample_batch(tdc.seeded_generator(CPU, 7), ids, 24)
    torch.testing.assert_close(again[0]["img"], lq["img"], rtol=0, atol=0)


def test_siqa_draws_mix_and_determinism(siqa_root):
    c = tdc.SIQADeviceCorpus(_siqa_opt(siqa_root), device="cpu")
    lq, cand, lam = c.sample_batch(tdc.seeded_generator(CPU, 3), [0, 1, 2] * 4, 32)
    assert lq.shape == cand.shape == (12, 3, 32, 32) and lam.shape == (12,)
    assert ((lam >= 0) & (lam < 1)).all()
    delta = cand.float() - lq.float()
    for b in range(12):  # candidate - origin = lam * (denoised - origin) = lam * 40
        inter = delta[b][lq[b] < 215]
        assert torch.allclose(inter, lam[b] * 40.0, atol=0.51)
    again = c.sample_batch(tdc.seeded_generator(CPU, 3), [0, 1, 2] * 4, 32)
    assert torch.equal(again[1], cand)


def test_build_device_corpus_refuses_other_types(student_root):
    with pytest.raises(NotImplementedError, match="got 'Dataset_PairedImage'"):
        tdc.build_device_corpus({"type": "Dataset_PairedImage"}, device="cpu")
    assert isinstance(tdc.build_device_corpus(_student_opt(student_root), device="cpu"),
                      tdc.StudentDeviceCorpus)
