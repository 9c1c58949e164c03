"""The band rules under autograd, and ``train.spatial_shard``'s config
rules, on the CPU in one process.

  * ``LocalBands`` on 2 and 4 bands of one process (``models/bands.py::
    network_bands``): the narrow teacher (its ``hq`` and ``sr``), the
    Restormer and the student (hidden (4, 8)), their outputs and every
    parameter's gradient against the whole-image forward and backward in
    float32, within 1e-5 of each tensor's largest magnitude: the halo
    copies into views of empty buffers and the sum across bands carry
    gradients as the whole image's padding and pixel sums do.
  * The config key through ``train/loop.py::build_everything``: the JAX
    package's over-shard refusal and message (teacher 8x, student 4x;
    JAX tests/test_spatial_train.py:164), ``model_shard`` beside it (JAX's
    ValueError), ``model_shard`` alone (not ported: Queue A item 5c), a
    network without band rules, N > 1 without a launcher, and
    ``spatial_shard: 1``, which builds the trainer without bands.
  * A crop that passes JAX's rule but whose bands are no multiple of the
    network's downsampling (40 px on 2 bands: 20 rows, the teacher halves
    them three times): the JAX package's step on a 1 x 2 mesh pads the
    uneven shards and equals the port's one-process step; the port refuses
    the crop, naming it.
"""

import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.models.bands import network_bands
from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import (
    LocalBands,
    join_rows,
    split_rows,
)
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
import torch_parallel_ranks as ranks
from torch_spatial_jax import assert_step_parity, jax_step_on

torch.set_num_threads(2)
RESTORMER = {"type": "Restormer", "inp_channels": 3, "out_channels": 3, "dim": 8,
             "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
             "heads": [1, 2, 4, 8], "LayerNorm_type": "BiasFree"}
NETS = {"teacher": ranks.TEACHER, "restormer": RESTORMER, "student": ranks.STUDENT}


def _inputs(kind, seed=5):
    g = torch.Generator().manual_seed(seed)
    if kind == "student":
        return torch.rand(2, 3, 32, 24, generator=g)
    img = torch.rand(2, 3, 64, 40, generator=g)
    return {"img": img, "denoise_rate": torch.full((2, 1, 64, 40), 0.6)} \
        if kind == "teacher" else img


def _loss(out):
    """Every output reaches the loss, none as a plain sum over pixels."""
    if isinstance(out, dict):
        return out["hq"].square().mean() + (out["sr"] - 0.5).abs().mean().sqrt()
    return out.square().mean().sqrt()


def _split(x, devices):
    if isinstance(x, dict):
        parts = zip(*(split_rows(x[k], devices) for k in x))
        return [dict(zip(x, p)) for p in parts]
    return split_rows(x, devices)


def _join(bands_out):
    if isinstance(bands_out, dict):
        return {k: join_rows(v, "cpu") for k, v in bands_out.items()}
    return join_rows(bands_out, "cpu")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", list(NETS))
def test_local_bands_match_the_whole_image_with_gradients(kind, n):
    model = ranks.seeded_model(NETS[kind])
    x = _inputs(kind)
    params = list(model.parameters())
    want = model(x)
    g_want = torch.autograd.grad(_loss(want), params)
    bands = LocalBands(["cpu"] * n)
    got = _join(network_bands([model] * n, _split(x, bands.devices), bands))
    g_got = torch.autograd.grad(_loss(got), params)
    outs = [(got, want)] if not isinstance(want, dict) else \
        [(got[k], want[k]) for k in want]
    for a, b in outs:
        a, b = a.detach(), b.detach()
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for (name, _), a, b in zip(model.named_parameters(), g_got, g_want):
        assert float(b.abs().max()) > 0, name
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


def _opt(tmp_path, net=None, **train):
    """JAX test_spatial_train.py:164's config (the narrow teacher, gt 32,
    batch 4)."""
    return {
        "name": "spatial_smoke", "model_type": "ImageCleanModel", "scale": 1,
        "manual_seed": 0, "is_train": True,
        "datasets": {"train": {
            "name": "t", "type": "Dataset_PairedImage",
            "dataroot_gt": str(tmp_path), "dataroot_lq": str(tmp_path),
            "io_backend": {"type": "disk"}, "gt_size": 32,
            "batch_size_per_gpu": 4, "phase": "train"}},
        "network_g": dict(net or ranks.TEACHER), "path": {},
        "train": {"total_iter": 10, "warmup_iter": -1, "use_grad_clip": True,
                  "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                                "periods": [10], "restart_weights": [1],
                                "eta_mins": [1e-6]},
                  "optim_g": {"type": "AdamW", "lr": 1e-4, "weight_decay": 1e-4,
                              "betas": [0.9, 0.999]},
                  "pixel_opt": {"type": "L1LossSr", "loss_weight": 1,
                                "reduction": "mean"},
                  **train},
    }


def test_spatial_shard_one_builds_no_bands(tmp_path):
    for train in ({}, {"spatial_shard": 1}):
        _, trainer = tloop.build_everything(_opt(tmp_path, **train), device="cpu")
        assert trainer.bands is None


@pytest.mark.parametrize("net,n,gt,error,match", [
    # JAX's rule and message: the teacher halves 3 times (32 / 8 = 4 rows)
    (ranks.TEACHER, 8, 32, ValueError,
     r"spatial_shard=8 over-shards the deepest feature map \(4 rows at the "
     r"smallest curriculum crop\): need spatial_shard <= 4"),
    # ... the student twice, whatever its levels (JAX's fixed 4)
    (ranks.STUDENT, 8, 16, ValueError, r"\(4 rows at the smallest curriculum crop\)"),
    # JAX's rule passes; a band of 20 rows cannot halve three times
    (ranks.TEACHER, 2, 40, ValueError, r"crop of 40 rows does not split into 2 bands "
                                       r"of a multiple of 8 rows"),
    # the student (4, 8) halves once: bands of 5 rows
    (ranks.STUDENT, 2, 10, ValueError, r"crop of 10 rows does not split into 2 bands "
                                       r"of a multiple of 2 rows"),
    # every rule passes: one process cannot hold two bands
    (ranks.TEACHER, 2, 32, ValueError, r"spatial_shard=2 needs 2 ranks a data index.*"
                                       r"--launcher"),
    (RESTORMER, 4, 64, ValueError, r"--launcher"),
    ({"type": "DenoiseRatePredictor"}, 2, 32, NotImplementedError,
     r"DenoiseRatePredictor has no row-band rules.*ROADMAP.md, Queue A"),
])
def test_spatial_shard_refusals(tmp_path, net, n, gt, error, match):
    opt = _opt(tmp_path, net, spatial_shard=n)
    opt["datasets"]["train"]["gt_size"] = gt
    if net["type"] == "DenoiseRatePredictor":
        with pytest.raises(error, match=match):
            tloop.spatial_bands(opt, build_network(net))
        return
    with pytest.raises(error, match=match):
        tloop.build_everything(opt, device="cpu")


def test_model_shard_refusals(tmp_path):
    with pytest.raises(ValueError, match="cannot be combined"):
        tloop.build_everything(_opt(tmp_path, spatial_shard=2, model_shard=2), device="cpu")
    # ported (tests/test_torch_model_train*.py): one process without a
    # launcher cannot hold 4 model shards
    with pytest.raises(ValueError, match=r"model_shard=4 needs 4 ranks.*--launcher"):
        tloop.build_everything(_opt(tmp_path, model_shard=4), device="cpu")


def test_jax_pads_a_crop_the_port_refuses(tmp_path):
    """40 px on 2 bands: JAX's spatial step equals one process (XLA pads the
    uneven latent shards); the port refuses the crop before any step."""
    (lq, gt), = ranks.teacher_batches(seed=3, b=2, h=40, w=40, steps=1)
    one = ranks.run_step_case(slice(0, 2), batches=[(lq, gt)])
    assert_step_parity(one, *jax_step_on("teacher", lq, gt, 1, 2))
    opt = _opt(tmp_path, spatial_shard=2)
    opt["datasets"]["train"]["gt_size"] = 40
    with pytest.raises(ValueError, match="crop of 40 rows"):
        tloop.spatial_bands(opt, build_network(ranks.TEACHER))
