"""Training from the port's device-resident corpora, on the CPU:

  * the loop's schedule: over two epochs, the (ids, gt_size) the loop hands
    the sampler and the extra_prob it hands the step equal the JAX loop's
    (both recorded by patching ``sample_batch`` and ``Trainer.step``);
  * ``train_from_config`` with ``device_resident: true`` for the student
    (also with online distillation, and configs/KDLAES_FLS_ft.yml from the
    zoo student) and the teacher: steps, a checkpoint mid-epoch, and a
    resume whose losses and weights equal the uncut run's exactly;
  * ``train_asdqe(device_resident=True)``: its source split and held-out
    ids equal the JAX trainer's; it writes ``net_g_best.pth``; the CLI's
    ``train-asdqe --device-resident`` needs no ``--param``;
  * ``device_resident`` on a phase other than ``train`` is accepted and
    does nothing, as in JAX (it was refused on every phase).
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.train import asdqe_trainer as jatr
from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
from rethink_acoustic_image_enhancement_tpu.train import device_corpus as jdc
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu.train import trainer as jtr
from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth, read_pth
from rethink_acoustic_image_enhancement_tpu_torch.models import DenoiseRatePredictor, build_network
from rethink_acoustic_image_enhancement_tpu_torch.train import asdqe_trainer as tatr
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import device_corpus as tdc
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
from torch_train_corpus import (REPO, device_student_config as student_config, teacher_config,
                                write_siqa_corpus, write_student_corpus, write_teacher_corpus,
                                write_yml)

torch.set_num_threads(2)
TEACHER = {"type": "KDLAE_teacher", "inp_channels": 3, "out_channels": 3, "dim": 8,
           "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
           "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
           "LayerNorm_type": "BiasFree", "dual_pixel_task": False,
           "static": "test", "params": "cat"}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return write_student_corpus(str(tmp_path_factory.mktemp("frames")), 12, 20, 20, seed=6)


def _train_rows(log_dir, kind="train"):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


# ---------------------------------------------------------- the schedule ---

def test_loop_schedule_matches_jax(frames, tmp_path, monkeypatch):
    """Eleven iterations (two epochs and more) through both loops, with the
    sampler and the step patched to record their arguments."""
    cfg = student_config(frames, 11, iters=(4, 7), stride_range=[1, 2])
    yml = write_yml(cfg, tmp_path / "opt.yml")
    calls = {"jax": [], "port": []}

    def j_sample(self, key, ids, gt_size=None, prob=None):
        calls["jax"].append(("sample", [int(i) for i in ids], int(gt_size)))
        z = jnp.zeros((len(ids), self.num_pairs, gt_size, gt_size))
        return z, z

    def j_step(self, state, lq, gt, rng, extra_prob=0.0, mini_gt_size=0):
        calls["jax"].append(("step", round(float(extra_prob), 6), int(mini_gt_size)))
        return state.replace(step=state.step + 1), {"l_pix": jnp.zeros(())}

    def t_sample(self, gen, ids, gt_size=None, **kw):
        calls["port"].append(("sample", [int(i) for i in ids], int(gt_size)))
        z = torch.zeros((len(ids), self.num_pairs, gt_size, gt_size))
        return z, z

    def t_step(self, state, lq, gt, rng, extra_prob=0.0, mini_gt_size=0, gen=None):
        calls["port"].append(("step", round(float(extra_prob), 6), int(mini_gt_size)))
        assert gen is not None and gen.device == torch.device("cpu")
        state.step += 1
        return state, {"l_pix": torch.zeros(()), "lr": 0.0, "grad_norm": torch.zeros(())}

    monkeypatch.setattr(jdc.StudentDeviceCorpus, "sample_batch", j_sample)
    monkeypatch.setattr(jtr.Trainer, "step", j_step)
    monkeypatch.setattr(tdc.StudentDeviceCorpus, "sample_batch", t_sample)
    monkeypatch.setattr(ttr.Trainer, "step", t_step)
    for pkg, parse, train, kw in (("jax", jcfg.parse, jloop.train_from_config, {}),
                                  ("port", tcfg.parse, tloop.train_from_config,
                                   {"device": "cpu"})):
        opt = parse(yml, True, root_path=str(tmp_path / pkg))
        opt["path"]["training_states"] = None  # a stubbed state saves nothing
        train(opt, **kw)
    assert calls["port"] == calls["jax"]
    samples = [c for c in calls["port"] if c[0] == "sample"]
    assert len(samples) == 11 and {c[2] for c in samples} == {12, 16}
    assert {c[1] for c in calls["port"] if c[0] == "step"} == {0.1, 0.3}


# ------------------------------------------------- training and resuming ---

def _resume_matches_uncut(cfg, tmp_path, cut, total):
    """An uncut run to ``total`` and a run cut at ``cut`` (a checkpoint),
    resumed to ``total``: the resumed steps' losses and the final weights
    are the uncut run's."""
    runs = {}
    for name, stops in (("uncut", [total]), ("cut", [cut, total])):
        for stop in stops:
            cfg["train"]["total_iter"] = stop
            cfg["logger"]["save_checkpoint_freq"] = cut
            yml = write_yml(cfg, tmp_path / f"{name}.yml")
            opt = tcfg.parse(yml, True, root_path=str(tmp_path / name))
            state = tloop.train_from_config(opt, device="cpu")
            assert state.step == stop
        runs[name] = opt
    uncut = _train_rows(runs["uncut"]["path"]["log"])
    cut_rows = _train_rows(runs["cut"]["path"]["log"])
    assert [r["iter"] for r in uncut] == list(range(1, total + 1))
    assert [r["iter"] for r in cut_rows] == list(range(1, total + 1))
    assert all(np.isfinite(r["l_pix"]) for r in uncut)
    for a, b in zip(uncut, cut_rows):
        assert (a["l_pix"], a["grad_norm"]) == (b["l_pix"], b["grad_norm"]), a["iter"]
    final = [read_pth(os.path.join(runs[n]["path"]["models"], f"net_g_{total}.pth"))
             for n in ("uncut", "cut")]
    for k in final[0]:
        assert torch.equal(final[0][k], final[1][k]), k
    return runs


def test_student_device_resident_resumes_exactly(frames, tmp_path):
    """Ten groups, five batches an epoch: cut at 3 (mid-epoch 0), resume to
    7 (into epoch 1); the extra mask drawn on the device in stage 2."""
    cfg = student_config(frames, 7)
    runs = _resume_matches_uncut(cfg, tmp_path, cut=3, total=7)
    with open(os.path.join(runs["cut"]["path"]["log"], "metrics.jsonl")) as f:
        assert '"kind": "resume"' in f.read()


def test_teacher_device_resident_resumes_exactly(tmp_path):
    roots = write_teacher_corpus(str(tmp_path / "t"), 5, 28, 32, seed=2)
    cfg = teacher_config(roots, None, batch_size_per_gpu=2, mini_batch_sizes=[2, 1],
                         iters=[2, 3], gt_size=24, gt_sizes=[16, 24], probs=[0.2, 0.1],
                         device_resident=True, num_worker_per_gpu=1)
    cfg["val"]["val_freq"] = 0
    cfg["logger"]["print_freq"] = 1
    _resume_matches_uncut(cfg, tmp_path, cut=3, total=5)


def test_online_distillation_on_device_resident_batches(frames, tmp_path):
    with torch.random.fork_rng():
        torch.manual_seed(7)
        sd = build_network(TEACHER).state_dict()
    torch.save({"params": sd}, tmp_path / "teacher.pth")
    cfg = student_config(frames, 2, iters=(1, 1))
    cfg["datasets"]["train"]["gt_sizes"] = [16, 16]  # the teacher halves it 3 times
    cfg["train"].update(mixing_augs={"mixup": False},
                        distill={"online": True, "teacher": TEACHER,
                                 "teacher_weights": str(tmp_path / "teacher.pth")})
    opt = tcfg.parse(write_yml(cfg, tmp_path / "opt.yml"), True, root_path=str(tmp_path))
    assert tloop.train_from_config(opt, device="cpu").step == 2
    rows = _train_rows(opt["path"]["log"])
    assert [r["iter"] for r in rows] == [1, 2] and all(np.isfinite(r["l_pix"]) for r in rows)


def test_fls_finetune_device_resident_from_the_zoo_student(frames, tmp_path):
    """configs/KDLAES_FLS_ft.yml as it stands (device-resident, full width)
    from artifacts/torch_zoo/student-us.pth: two steps at 16 px."""
    with open(os.path.join(REPO, "configs", "KDLAES_FLS_ft.yml")) as f:
        cfg = yaml.safe_load(f)
    ds = cfg["datasets"]["train"]
    assert ds["device_resident"] is True
    ds.update(frames, num_pairs=5, batch_size_per_gpu=2, gt_size=16, gt_sizes=[16, 16],
              iters=[1, 1])
    del cfg["datasets"]["val"]
    cfg["train"].update(total_iter=2, warmup_iter=-1)
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=2)
    cfg["path"]["pretrain_network_g"] = os.path.join(REPO, "artifacts", "torch_zoo",
                                                     "student-us.pth")
    opt = tcfg.parse(write_yml(cfg, tmp_path / "fls.yml"), True, root_path=str(tmp_path))
    assert tloop.train_from_config(opt, device="cpu").step == 2
    start = read_pth(cfg["path"]["pretrain_network_g"])
    end = read_pth(os.path.join(opt["path"]["models"], "net_g_2.pth"))
    assert set(start) == set(end) and any(not torch.equal(start[k], end[k]) for k in start)


def test_device_resident_is_ignored_off_the_train_phase(frames, tmp_path):
    cfg = student_config(frames, 2)
    cfg["datasets"]["val"] = {**cfg["datasets"]["train"], "name": "ValSet",
                              "device_resident": True}
    opt = tcfg.parse(write_yml(cfg, tmp_path / "opt.yml"), True, root_path=str(tmp_path))
    tcfg.validate(opt)
    jcfg.validate(jcfg.parse(write_yml(cfg, tmp_path / "j.yml"), True,
                             root_path=str(tmp_path)))


# ------------------------------------------------------------ the scorer ---

@pytest.fixture(scope="module")
def siqa(tmp_path_factory):
    return write_siqa_corpus(str(tmp_path_factory.mktemp("siqa")), 6, 40, 36, seed=9)


def test_asdqe_device_resident_ids_match_jax(siqa, tmp_path, monkeypatch):
    """Two epochs of two micro-steps at batch 2: the sequence of train and
    held-out ids each trainer hands its corpus, and the split."""
    src = {"dataroot_lq": siqa["dataroot_lq"], "dataroot_gt": siqa["dataroot_gt"],
           "geometric_augs": True}
    calls = {"jax": [], "port": []}

    def j_sample(self, key, ids, gt_size=None):
        calls["jax"].append([int(i) for i in ids])
        b = len(ids)
        return (jnp.zeros((b, gt_size, gt_size, 3), jnp.uint8),
                jnp.zeros((b, gt_size, gt_size, 3), jnp.uint8), jnp.zeros((b,)))

    def j_step_fn(model, tx, compute_dtype):
        return lambda p, bs, o, lq, gt, score, rng, scale: (p, bs, o, jnp.zeros(()))

    apply = tdc.SIQADeviceCorpus.apply

    def t_apply(self, ids, draws):
        calls["port"].append(ids.tolist())
        return apply(self, ids, draws)

    monkeypatch.setattr(jdc.SIQADeviceCorpus, "sample_batch", j_sample)
    monkeypatch.setattr(jatr, "make_asdqe_train_step", j_step_fn)
    monkeypatch.setattr(tdc.SIQADeviceCorpus, "apply", t_apply)
    kw = dict(epochs=2, batch_size=2, accumulation_steps=2, gt_size=32,
              log=lambda m: None, device_resident=True, steps_per_epoch=2)
    jatr.train_asdqe(src, compute_dtype=None, **kw)
    out = tatr.train_asdqe(src, compute_dtype=None, device="cpu",
                           out_dir=str(tmp_path / "w"), **kw)
    # 6 sources: 4 train, 2 held out, 13 batches of 2 held-out ids
    assert len(calls["port"]) == 2 * (2 + 13)
    assert calls["port"] == calls["jax"]
    train_src, val_src, val_ids = tatr.device_resident_split(6, 0, 2, log=lambda m: None)
    assert len(train_src) == 4 and set(np.concatenate(val_ids)) <= set(val_src)
    hist = out["history"]
    assert len(hist) == 2 and all(np.isfinite(h["train_mse"]) for h in hist)
    assert hist[0]["val_mse"] != hist[1]["val_mse"]
    assert sorted(os.listdir(tmp_path / "w")) == ["net_g_0.pth", "net_g_1.pth",
                                                  "net_g_best.pth"]
    load_pth(DenoiseRatePredictor(), str(tmp_path / "w" / "net_g_best.pth"))


def test_asdqe_one_source_warns(tmp_path):
    msgs = []
    train_src, val_src, _ = tatr.device_resident_split(1, 0, 1, log=msgs.append)
    assert list(train_src) == list(val_src) == [0] and "OVERLAPS" in msgs[0]


def test_cli_train_asdqe_device_resident(siqa, tmp_path, capsys):
    out = tmp_path / "w"
    argv = ["train-asdqe", "--lq", siqa["dataroot_lq"], "--gt", siqa["dataroot_gt"],
            "--out", str(out), "--epochs", "1", "--batch-size", "2", "--accum", "2",
            "--gt-size", "32", "--device-resident", "--steps-per-epoch", "2",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    assert np.isfinite(float(capsys.readouterr().out.split("best val MSE:")[1].split()[0]))
    assert sorted(os.listdir(out)) == ["net_g_0.pth", "net_g_best.pth"]
