"""``train.model_shard`` in one process: the config key and its refusals
(the counterpart of JAX tests/test_spatial_train.py:217), the split / whole
classification of the leaves, and ``unshard`` of ``shard_teacher``'s shards
(weights, AdamW's moments, the EMA) giving the whole model back bit for
bit."""

import copy

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch import parallel
from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import DepthwiseConv3x3
from rethink_acoustic_image_enhancement_tpu_torch.models.shards import (
    leaf_kinds,
    shard_layout,
    shard_module,
    shard_state_dict,
    shard_teacher,
    unshard,
)
from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import RankShards
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
from rethink_acoustic_image_enhancement_tpu_torch.train.schedules import build_schedule
import torch_parallel_ranks as ranks
from test_torch_model_train_cuda import assert_local_shards_gradients
from test_torch_spatial_train import _opt

torch.set_num_threads(1)
RESTORMER = {"type": "Restormer", **{k: v for k, v in ranks.TEACHER.items()
                                     if k not in ("type", "static", "params")}}


def test_model_shard_config_key(tmp_path, monkeypatch):
    """JAX test_spatial_train.py:217's config through ``build_everything``
    under a launcher of 4 ranks (its world and grid stood in for here): the
    model takes the shift-add depthwise form and the trainer a
    ``RankShards`` of 4; combining with ``spatial_shard`` fails fast."""
    grids = []
    monkeypatch.setattr(tloop, "world_size", lambda: 4)
    monkeypatch.setattr(tloop, "init_grid", lambda **kw: (
        grids.append(kw), parallel._GRID.update(n_model=kw["n_model"])))
    try:
        model, trainer = tloop.build_everything(_opt(tmp_path, model_shard=4), device="cpu")
    finally:
        parallel._reset_grid()
    assert grids == [{"n_model": 4}]
    assert model.dwconv_shift is True
    assert all(isinstance(m.attn.qkv_dwconv, DepthwiseConv3x3)
               and isinstance(m.ffn.dwconv, DepthwiseConv3x3)
               for m in model.modules() if hasattr(m, "ffn"))
    assert isinstance(trainer.shards, RankShards) and trainer.shards.n == 4
    assert trainer.bands is None and trainer.model is model
    with pytest.raises(ValueError, match="cannot be combined"):
        tloop.build_everything(_opt(tmp_path, spatial_shard=2, model_shard=2), device="cpu")


@pytest.mark.parametrize("n,match", [
    (4, r"train.model_shard=4 needs 4 ranks a data index: run under torchrun or "
        r"SLURM with --launcher"),
    # the narrow teacher's blocks hold int(8 * 2.66) = 21 hidden channels
    (32, r"21 hidden channels leave some of 32 model shards none"),
])
def test_model_shard_refusals(tmp_path, n, match):
    model = ranks.seeded_model(ranks.TEACHER)
    with pytest.raises(ValueError, match=match):
        tloop.model_shards(_opt(tmp_path, model_shard=n), model)
    assert not model.dwconv_shift  # refused before the model is touched


def test_model_shard_one_builds_no_shards(tmp_path):
    for train in ({}, {"model_shard": 1}):
        model, trainer = tloop.build_everything(_opt(tmp_path, **train), device="cpu")
        assert trainer.shards is None and trainer.layout is None
        assert model.dwconv_shift is False


def test_leaf_kinds():
    """Split: the MDTA where 2 shards divide its heads (levels 2, 3, the
    latent), every GDFN; whole: the LayerNorms, the one-head MDTAs and every
    layer outside the blocks. The student and the scorer's predictor: every
    leaf whole."""
    kinds = leaf_kinds(ranks.seeded_model(ranks.TEACHER), 2)
    assert kinds["encoder_level2.0.attn.qkv.weight"] == "split"
    assert kinds["latent.0.attn.temperature"] == "split"
    assert kinds["encoder_level1.0.attn.qkv.weight"] == "whole"  # one head
    assert kinds["refinement.0.attn.project_out.weight"] == "whole"
    assert kinds["encoder_level1.0.ffn.dwconv.weight"] == "split"
    assert kinds["enhance.0.ffn.project_out.weight"] == "split"
    for name in ("patch_embed.proj.weight", "encoder_level2.0.norm1.body.weight",
                 "down1_2.body.0.weight", "output_param.weight", "outputen.weight"):
        assert kinds[name] == "whole", name
    heads4 = leaf_kinds(ranks.seeded_model(ranks.TEACHER), 4)
    assert heads4["encoder_level2.0.attn.qkv.weight"] == "whole"  # 2 heads over 4
    assert heads4["encoder_level3.0.attn.qkv.weight"] == "split"
    for net in (ranks.STUDENT, {"type": "DenoiseRatePredictor"}):
        assert set(leaf_kinds(ranks.seeded_model(net), 2).values()) == {"whole"}


def _moments(model, seed):
    """AdamW's state after one step on seeded gradients, by parameter name."""
    gen = torch.Generator().manual_seed(seed)
    params = dict(model.named_parameters())
    opt = torch.optim.AdamW(params.values(), lr=1e-3)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    names = list(params)
    return {names[i]: st for i, st in opt.state_dict()["state"].items()}


@pytest.mark.parametrize("net", [ranks.TEACHER, RESTORMER], ids=["teacher", "restormer"])
@pytest.mark.parametrize("n", [2, 4])
def test_unshard_gives_the_whole_model_back(net, n):
    """``shard_teacher``'s shards of the weights, the EMA (another copy) and
    AdamW's moments (sliced by ``shard_state_dict``) put back by
    ``unshard``: the whole model's, bit for bit; each shard's slices are
    ``shard_module``'s."""
    model = ranks.seeded_model(net)
    ema = copy.deepcopy(model)
    with torch.no_grad():
        for p in ema.parameters():
            p.mul_(0.5)
    layout = shard_layout(model, n)
    assert list(layout) == list(model.state_dict())
    for whole in (model, ema):
        parts = [m.state_dict() for m in shard_teacher(whole, ["cpu"] * n)]
        for j, part in enumerate(parts):
            mine = shard_module(whole, j, n).state_dict()
            assert part.keys() == mine.keys()
            assert all(torch.equal(part[k], v) for k, v in mine.items())
        back = unshard(parts, layout)
        assert back.keys() == whole.state_dict().keys()
        for k, v in whole.state_dict().items():
            assert torch.equal(back[k], v), k
    moments = _moments(copy.deepcopy(model), 3)
    for key in ("exp_avg", "exp_avg_sq"):
        by_name = {name: st[key] for name, st in moments.items()}
        back = unshard([shard_state_dict(by_name, layout, j) for j in range(n)], layout)
        assert back.keys() == by_name.keys()
        for k, v in by_name.items():
            assert torch.equal(back[k], v), (key, k)


def test_a_biased_projection_stays_on_shard_0():
    """With ``bias: True`` a split projection's bias is a split leaf that
    shard 0 alone holds: ``shard_state_dict`` gives it to shard 0 only and
    ``unshard`` takes it back from there."""
    net = {**ranks.TEACHER, "bias": True}
    model = ranks.seeded_model(net)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.normal_()
    layout = shard_layout(model, 2)
    key = "encoder_level2.0.attn.project_out.bias"
    assert layout[key] is not None and layout[key].index[1] is None
    parts = [shard_state_dict(model.state_dict(), layout, j) for j in range(2)]
    assert key in parts[0] and key not in parts[1]
    back = unshard(parts, layout)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_a_trainer_takes_bands_or_shards_not_both():
    with pytest.raises(ValueError, match="row bands or model shards, not both"):
        ttr.Trainer(model=ranks.seeded_model(ranks.TEACHER), loss_fn=None,
                    optimizer=ttr.build_optimizer(ranks.TRAIN),
                    schedule=build_schedule(1e-3, ranks.TRAIN["scheduler"]), device="cpu",
                    bands=object(), shards=object())


def test_init_grid_refuses_two_split_axes():
    with pytest.raises(ValueError, match="either bands or model shards"):
        parallel.init_grid(n_spatial=2, n_model=2)
    assert (parallel.n_data(), parallel.n_model(), parallel.shard_index(),
            parallel.model_group()) == (1, 1, 0, None)
    np.testing.assert_equal(parallel.n_spatial(), 1)


@pytest.mark.parametrize("n", [2, 4])
def test_local_shards_gradients_on_the_cpu(n):
    """tests/test_torch_model_train_cuda.py's per-leaf check on the CPU:
    the shift teacher's outputs on n ``LocalShards`` and every leaf's
    gradient (split leaves unsharded, whole leaves' shards summed) within
    1e-5 of the whole model's."""
    assert_local_shards_gradients(torch.device("cpu"), n)
