"""The port's NIQE against the JAX package's (CPU, numpy and scipy on the
host): every input layout within 1e-9 relative, the shipped pristine table
byte for byte, its overrides, and NIQE under ``val.metrics`` in the
validation loop (the JAX loop hands the target to ``crop_border`` and
raises; the port scores the output alone)."""

import sys

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.convert.torch_import import CONVERTERS
from rethink_acoustic_image_enhancement_tpu.data import datasets as jds
from rethink_acoustic_image_enhancement_tpu.data import loader as jld
from rethink_acoustic_image_enhancement_tpu.metrics import niqe as jniqe
from rethink_acoustic_image_enhancement_tpu.models import build_network as jax_net
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import read_pth
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld
from rethink_acoustic_image_enhancement_tpu_torch.metrics import niqe as tniqe
from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from torch_train_corpus import teacher_config, write_teacher_corpus, write_yml

torch.set_num_threads(2)
REL = 1e-9


def _sonar(h, w, seed, channels=3):
    """A speckled fan on [0, 255] with a smooth structure under it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 96 + 60 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    img = base[..., None] * rng.gamma(4.0, 0.25, size=(h, w, channels))
    fan = np.abs(xx - w / 2) < (yy + 1) * 0.8
    return (img * fan[..., None]).clip(0, 255).astype(np.float32)


@pytest.mark.parametrize("layout,kw", [
    ("rgb", {}),
    ("rgb", {"convert_to": "gray"}),
    ("rgb", {"channel_order": "bgr"}),
    ("chw", {"input_order": "CHW"}),
    ("rgb", {"crop_border": 4}),
    ("gray", {"input_order": "HW"}),
    ("gray1", {}),
    ("rgb_uint8", {}),
])
def test_niqe_matches_jax(layout, kw):
    img = _sonar(200, 296, seed=len(layout) + len(kw), channels=1 if "gray" in layout else 3)
    if layout == "gray":
        img = img[..., 0]
    elif layout == "chw":
        img = img.transpose(2, 0, 1)
    elif layout == "rgb_uint8":
        img = img.astype(np.uint8)
    want = jniqe.calculate_niqe(img, **kw)
    got = tniqe.calculate_niqe(img, **kw)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=REL, abs=0)


def test_niqe_without_cv2_takes_the_block_mean(monkeypatch):
    """Where cv2 is missing the half scale is the mean of each 2x2 block."""
    img = _sonar(192, 192, seed=5)[..., 0]
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises
    assert np.isfinite(tniqe.calculate_niqe(img, input_order="HW"))
    x = img.astype(np.float64)
    half = 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])
    np.testing.assert_array_equal(tniqe._half(x), half)


def test_shipped_table_is_byte_equal():
    with open(jniqe._BUNDLED_PRIS, "rb") as a, open(tniqe._BUNDLED_PRIS, "rb") as b:
        assert a.read() == b.read()
    mu, cov = tniqe.load_pris_params()
    assert mu.shape == (36,) and cov.shape == (36, 36)


def test_overrides_and_refusals(tmp_path, monkeypatch):
    """``pris_path`` and ``RAIE_NIQE_PRIS`` take another table, as in the
    JAX package; a missing table and an image under one block raise."""
    mu, cov = tniqe.load_pris_params()
    other = str(tmp_path / "pris.npz")
    np.savez(other, mu_pris_param=mu[None] * 1.1, cov_pris_param=cov * 0.9)
    img = _sonar(192, 192, seed=9)
    base = tniqe.calculate_niqe(img)
    by_arg = tniqe.calculate_niqe(img, pris_path=other)
    assert by_arg != pytest.approx(base)
    assert by_arg == pytest.approx(jniqe.calculate_niqe(img, pris_path=other), rel=REL)
    monkeypatch.setenv("RAIE_NIQE_PRIS", other)
    assert tniqe.calculate_niqe(img) == by_arg
    monkeypatch.setenv("RAIE_NIQE_PRIS", str(tmp_path / "absent.npz"))
    with pytest.raises(FileNotFoundError, match="RAIE_NIQE_PRIS"):
        tniqe.calculate_niqe(img)
    monkeypatch.delenv("RAIE_NIQE_PRIS")
    with pytest.raises(ValueError, match="smaller than NIQE block"):
        tniqe.calculate_niqe(_sonar(90, 200, seed=1))


def test_validation_loop_scores_niqe_on_the_output(tmp_path, monkeypatch):
    """``val.metrics`` with calculate_niqe: the port's loop gives the mean
    of JAX's calculate_niqe over the outputs it scored (and their 2x SR
    twins), while the JAX loop raises (it passes the target as
    ``crop_border``)."""
    val = write_teacher_corpus(str(tmp_path / "val"), 2, 96, 104, seed=1)
    train = write_teacher_corpus(str(tmp_path / "train"), 2, 40, 40, seed=0)
    cfg = teacher_config(train, val)
    cfg["val"]["metrics"] = {"niqe": {"type": "calculate_niqe"}}
    torch.manual_seed(5)
    path = str(tmp_path / "w.pth")
    torch.save({"params": build_network(cfg["network_g"]).state_dict()}, path)
    opt = tcfg.parse(write_yml(cfg, tmp_path / "opt.yml"), False, root_path=str(tmp_path))
    sd = read_pth(path)
    model = build_network(opt["network_g"])
    model.load_state_dict(sd)

    scored = []
    real = tloop.get_metric

    def recording(name):
        fn = real(name)

        def wrapped(img, *args, **kw):
            assert not args, "a no-reference metric was given a target"
            scored.append(np.array(img))
            return fn(img, **kw)

        return wrapped

    monkeypatch.setattr(tloop, "get_metric", recording)
    loader = tld.BatchLoader(tds.create_dataset(opt["datasets"]["val"]), 1,
                             tld.EnlargedShuffleSampler(2, shuffle=False))
    got = tloop.validate_model(model, loader, opt)
    assert set(got) == {"niqe", "niqe_sr"}
    assert [im.shape[:2] for im in scored] == [(96, 104), (192, 208)] * 2
    want = [jniqe.calculate_niqe(im) for im in scored]
    assert got["niqe"] == pytest.approx(np.mean(want[0::2]), rel=REL)
    assert got["niqe_sr"] == pytest.approx(np.mean(want[1::2]), rel=REL)

    params = CONVERTERS["KDLAE_teacher"]({k: v.numpy() for k, v in sd.items()})
    j_loader = jld.BatchLoader(jds.create_dataset(opt["datasets"]["val"]), 1,
                               jld.EnlargedShuffleSampler(2, shuffle=False))
    with pytest.raises(ValueError, match="ambiguous"):
        jloop.validate_model(jax_net(opt["network_g"]), params, j_loader, opt)
