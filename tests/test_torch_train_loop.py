"""The port's training loop: against the JAX package's train_from_config
on the same corpus, parameters and config; an interrupted run that
auto-resumes against one that was not interrupted; validation's PSNR
against JAX's; and the train and test subcommands on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.models import build_network as jax_net
from rethink_acoustic_image_enhancement_tpu.train import checkpoints as jckpt
from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu.data import datasets as jds
from rethink_acoustic_image_enhancement_tpu.data import loader as jld
from rethink_acoustic_image_enhancement_tpu.convert.torch_import import CONVERTERS
from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import (
    read_pth,
    teacher_state_dict,
)
from rethink_acoustic_image_enhancement_tpu_torch.data import datasets as tds
from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld
from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
from torch_train_corpus import (
    teacher_config,
    write_teacher_corpus,
    write_yml,
)

torch.set_num_threads(2)
LR = 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return (write_teacher_corpus(str(root / "train"), 8, 40, 40, seed=0),
            write_teacher_corpus(str(root / "val"), 2, 32, 40, seed=1))


def _seeded_pth(cfg, path):
    with torch.random.fork_rng():
        torch.manual_seed(5)
        sd = build_network(cfg["network_g"]).state_dict()
    torch.save({"params": sd}, path)
    return str(path)


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train"]


def test_loop_matches_jax(corpus, tmp_path):
    """Mixup off and one patch size (no draws on the device), the stage
    subsample of the prefetch thread every step; the same pretrained
    .pth into both. Per-step loss, lr and grad_norm within 1e-5 relative;
    final weights by the step test's rule, its near-zero gradients being
    the port's (equal to JAX's within 1e-5)."""
    cfg = teacher_config(corpus[0], None, batch_size_per_gpu=2,
                         mini_batch_sizes=[1], iters=[5], gt_size=16,
                         gt_sizes=[16], probs=[0.0], num_worker_per_gpu=2)
    steps = 5
    cfg["train"].update(total_iter=steps, mixing_augs={"mixup": False})
    cfg["train"]["optim_g"]["lr"] = LR
    cfg["train"]["scheduler"].update(periods=[3, 10])
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=steps)
    cfg["val"]["val_freq"] = 0
    cfg["path"].update(pretrain_network_g=_seeded_pth(cfg, tmp_path / "w.pth"),
                       strict_load_g=True)
    yml = write_yml(cfg, tmp_path / "opt.yml")

    j_opt = jcfg.parse(yml, True, root_path=str(tmp_path / "jax"))
    jloop.train_from_config(j_opt)

    grads = []
    step = ttr.Trainer.step

    def recording_step(self, state, *a, **kw):
        out = step(self, state, *a, **kw)
        grads.append({n: p.grad.numpy().copy()
                      for n, p in state.model.named_parameters()})
        return out

    t_opt = tcfg.parse(yml, True, root_path=str(tmp_path / "port"))
    ttr.Trainer.step = recording_step
    try:
        tloop.train_from_config(t_opt, device="cpu")
    finally:
        ttr.Trainer.step = step

    j_m, t_m = _metrics(j_opt["path"]["log"]), _metrics(t_opt["path"]["log"])
    assert [r["iter"] for r in t_m] == [r["iter"] for r in j_m] == \
        list(range(1, steps + 1))
    for a, b in zip(t_m, j_m):
        for k in ("l_pix", "lr", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (a["iter"], k)

    want = {k: v.numpy() for k, v in teacher_state_dict(jckpt.load_weights(
        os.path.join(j_opt["path"]["models"], f"net_g_{steps}"))).items()}
    got = read_pth(os.path.join(t_opt["path"]["models"], f"net_g_{steps}.pth"))
    init = read_pth(cfg["path"]["pretrain_network_g"])
    tight, loose = 0.05 * LR * steps, 2 * LR * steps
    for name, w in want.items():
        big = np.ones(w.shape, bool)
        for g in grads:
            gmax = max(np.abs(v).max() for v in g.values())
            big &= np.abs(g[name]) > 1e-6 * gmax
        diff = np.abs(got[name].numpy() - w)
        assert (diff <= np.where(big, tight, loose)).all(), (name, diff.max())
        assert not np.array_equal(w, init[name].numpy()) or name.endswith(
            "temperature"), name


def _curriculum_cfg(corpus, tmp_path, total):
    """KDLAET's curriculum at a narrow width: crops, extra masks, mixup
    with its identity branch, subsamples, EMA, validation."""
    cfg = teacher_config(corpus[0], corpus[1], batch_size_per_gpu=4,
                         mini_batch_sizes=[4, 2, 1], iters=[2, 2, 2],
                         gt_size=32, gt_sizes=[16, 24, 32],
                         probs=[0.2, 0.1, 0.05], num_worker_per_gpu=2)
    cfg["train"].update(total_iter=total, ema_decay=0.9)
    cfg["train"]["optim_g"]["lr"] = LR
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=3)
    cfg["val"]["val_freq"] = 3
    return write_yml(cfg, tmp_path / "opt.yml")


def test_resumed_run_equals_uninterrupted(corpus, tmp_path):
    """Cut at iteration 3 (mid-epoch: 2 batches an epoch) and resumed, the
    run reads, draws and computes what the uninterrupted one did."""
    yml = _curriculum_cfg(corpus, tmp_path, total=7)
    whole = tcfg.parse(yml, True, root_path=str(tmp_path / "whole"))
    tloop.train_from_config(whole, device="cpu")
    cut = tcfg.parse(yml, True, root_path=str(tmp_path / "cut"))
    tloop.train_from_config(cut, device="cpu", max_iters=3)
    assert sorted(os.listdir(cut["path"]["models"])) == ["net_g_3.pth"]
    state = tloop.train_from_config(tcfg.parse(yml, True, root_path=str(
        tmp_path / "cut")), device="cpu")
    assert state.step == 7

    a = torch.load(os.path.join(whole["path"]["models"], "net_g_7.pth"))
    b = torch.load(os.path.join(cut["path"]["models"], "net_g_7.pth"))
    for key in ("params", "params_ema"):
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    ma, mb = _metrics(whole["path"]["log"]), _metrics(cut["path"]["log"])
    assert [r["l_pix"] for r in ma] == [r["l_pix"] for r in mb]
    assert all(np.isfinite(r["l_pix"]) for r in ma)
    with open(os.path.join(whole["path"]["log"], "metrics.jsonl")) as f:
        vals = [r for r in map(json.loads, f) if r["kind"] == "val"]
    assert [r["iter"] for r in vals] == [3, 6]
    assert all(np.isfinite(r["psnr"]) and np.isfinite(r["psnr_sr"]) for r in vals)


def test_validation_psnr_matches_jax(corpus, tmp_path):
    """The same weights and val set through both validate_model (pad to
    the window, dict-aware, the SR head scored at 2x)."""
    cfg = teacher_config(corpus[0], corpus[1])
    cfg["val"]["metrics"]["ssim"] = {"type": "calculate_ssim"}
    path = _seeded_pth(cfg, tmp_path / "w.pth")
    opt = tcfg.parse(write_yml(cfg, tmp_path / "opt.yml"), False,
                     root_path=str(tmp_path))
    sd = read_pth(path)
    params = CONVERTERS["KDLAE_teacher"]({k: v.numpy() for k, v in sd.items()})
    j_ds = jds.create_dataset(opt["datasets"]["val"])
    want = jloop.validate_model(
        jax_net(opt["network_g"]), params,
        jld.BatchLoader(j_ds, 1, jld.EnlargedShuffleSampler(2, shuffle=False)),
        opt)
    model = build_network(opt["network_g"])
    model.load_state_dict(sd)
    t_ds = tds.create_dataset(opt["datasets"]["val"])
    got = tloop.validate_model(
        model, tld.BatchLoader(t_ds, 1, tld.EnlargedShuffleSampler(2, shuffle=False)),
        opt)
    assert set(got) == set(want) == {"psnr", "psnr_sr", "ssim", "ssim_sr"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k


def test_cli_train_and_test_on_cpu(corpus, tmp_path, monkeypatch, capsys):
    yml = _curriculum_cfg(corpus, tmp_path, total=3)
    monkeypatch.chdir(tmp_path)  # experiments/ and results/ land here
    assert cli.main(["train", "-opt", yml, "--device", "cpu"]) == 0
    weights = tmp_path / "experiments" / "KDLAET" / "models" / "net_g_3.pth"
    assert weights.is_file()
    capsys.readouterr()
    assert cli.main(["test", "-opt", yml, "--weights", str(weights),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[ValSet]")]
    assert lines and "psnr=" in lines[0] and "psnr_sr=" in lines[0]
    psnr = float(lines[0].split("psnr=")[1].split(",")[0])
    assert np.isfinite(psnr)
    assert (tmp_path / "results" / "KDLAET").is_dir()


def test_cli_default_device_needs_a_gpu(corpus, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    yml = _curriculum_cfg(corpus, tmp_path, total=1)
    monkeypatch.chdir(tmp_path)
    for argv in (["train", "-opt", yml], ["test", "-opt", yml, "--weights", yml]):
        with pytest.raises(SystemExit) as err:
            cli.main(argv)
        assert "no CUDA device" in str(err.value.code)
    assert not (tmp_path / "experiments").exists()


@pytest.mark.parametrize("key,value,item", [
    # online distillation is ported, its orbax teacher weights too:
    # validate accepts them
    ("distill", {"online": True, "teacher": {"type": "KDLAE_teacher"},
                 "teacher_weights": os.path.join(
                     os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "artifacts", "kdlaet_full50k", "weights", "net_g_50000_bf16")},
     "online distillation"),
    # ported with the spatial training (train.loop.spatial_bands holds
    # its rules): validate accepts it
    ("spatial_shard", 2, "spatial and tensor-parallel"),
    # ported with the tensor-parallel training (train.loop.model_shards):
    # validate accepts it, and one process without a launcher cannot hold 4
    # shards; the id keeps its name
    pytest.param("model_shard", 4, r"train.model_shard=4 needs 4 ranks a data index.*"
                                   r"--launcher",
                 id="model_shard-4-spatial and tensor-parallel"),
    # ported with the device corpora: accepted on every phase, as in JAX
    ("device_resident", True, "device-resident corpora"),
])
def test_unported_options_name_the_roadmap(corpus, tmp_path, key, value, item):
    cfg = teacher_config(corpus[0], corpus[1])
    if key == "device_resident":
        cfg["datasets"]["train"][key] = cfg["datasets"]["val"][key] = value
    else:
        cfg["train"][key] = value
    opt = tcfg.parse(write_yml(cfg, tmp_path / "opt.yml"), True,
                     root_path=str(tmp_path))
    if key in ("device_resident", "spatial_shard", "distill"):
        tcfg.validate(opt)
        return
    if key == "model_shard":
        tcfg.validate(opt)
        with pytest.raises(ValueError, match=item):
            tloop.build_everything(opt, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, Queue A: {item}"):
        tcfg.validate(opt)


def test_parse_matches_jax(tmp_path):
    """The same dict from both parsers, debug shortcut included."""
    for name in ("KDLAET", "debug_KDLAET"):
        cfg = teacher_config({}, {})
        cfg["name"] = name
        yml = write_yml(cfg, tmp_path / f"{name}.yml")
        for is_train in (True, False):
            assert tcfg.parse(yml, is_train, root_path=str(tmp_path)) == \
                jcfg.parse(yml, is_train, root_path=str(tmp_path))
