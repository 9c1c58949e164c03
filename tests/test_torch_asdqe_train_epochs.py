"""The port's ASDQE trainer (``train/asdqe_trainer.py::train_asdqe``)
against the JAX package's over two epochs, dropout off on both sides (in JAX
through ``flax.linen.intercept_methods`` on ``nn.Dropout``, in this file
only; in the port by rate 0); its device-resident route (ported with the
device corpora: it trains on the CPU when asked, and without a GPU the
default device names device='cpu')."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from rethink_acoustic_image_enhancement_tpu.models.asdqe import (
    DenoiseRatePredictor as JaxPredictor,
)
from rethink_acoustic_image_enhancement_tpu.train import asdqe_trainer as jtr
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import (
    asdqe_state_dict,
    load_pth,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.asdqe import (
    DenoiseRatePredictor,
    Dropout,
)
from rethink_acoustic_image_enhancement_tpu_torch.train import asdqe_trainer as ttr
from torch_train_corpus import write_siqa_corpus

torch.set_num_threads(2)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


@pytest.fixture(scope="module")
def siqa(tmp_path_factory):
    return write_siqa_corpus(str(tmp_path_factory.mktemp("siqa")), 10, 40, 36, seed=8)


def test_two_epochs_match_jax(siqa, tmp_path):
    """train_asdqe on 10 triples (8 train, 2 val), batch 2, k = 3 (one
    update lands mid-epoch 0, the partial accumulation carries into epoch
    1), float32, the same initial weights; history within 1e-4 relative
    (the two forward passes already part by ~3e-5 on the micro-steps before
    the first update). At lr 1e-5: Adam's first steps move every weight by
    about lr, also the ~15% whose gradient sign is rounding noise (see the
    micro-step test), and at the reference's 1e-3 those moves alone part
    the validation MSE by ~4e-4 relative."""
    kw = dict(epochs=2, batch_size=2, accumulation_steps=3, gt_size=32,
              seed=4, compute_dtype=None, log=lambda m: None, lr=1e-5)
    jmodel = JaxPredictor(remat=True)
    params_rng, _ = jax.random.split(jax.random.PRNGKey(4))
    v = jmodel.init(params_rng, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3)))
    with fnn.intercept_methods(_no_dropout):
        want = jtr.train_asdqe(siqa, **kw)["history"]
    model = DenoiseRatePredictor()
    model.load_state_dict(asdqe_state_dict(v["params"], v["batch_stats"]))
    out = ttr.train_asdqe(siqa, **kw, device="cpu", model=_dropout_off(model),
                          out_dir=str(tmp_path))
    got = out["history"]
    assert [h["epoch"] for h in got] == [0, 1]
    for a, b in zip(got, want):
        assert a["lr_scale"] == b["lr_scale"]
        for key in ("train_mse", "val_mse"):
            assert a[key] == pytest.approx(b[key], rel=1e-4), (a, b)
    # the weights it wrote load strictly into a fresh scorer and serve
    for name in ("net_g_0.pth", "net_g_1.pth", "net_g_best.pth"):
        load_pth(DenoiseRatePredictor(), str(tmp_path / name))


def test_device_resident_names_the_roadmap(siqa):
    """Once refused, naming its ROADMAP.md item; now it trains from the
    device corpus (the JSON scores unused), on the GPU by default."""
    out = ttr.train_asdqe(siqa, device_resident=True, device="cpu", epochs=1,
                          batch_size=2, accumulation_steps=2, gt_size=32,
                          compute_dtype=None, log=lambda m: None)
    assert np.isfinite(out["history"][0]["train_mse"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttr.train_asdqe(siqa, device_resident=True)


def test_corpus_scores_are_the_mix_rates(siqa):
    with open(siqa["dataroot_param"] + "/0003.json") as f:
        assert 0.0 <= json.load(f)["score"] <= 1.0
