"""The JAX and port runs that ``tests/test_torch_jax_state*.py`` compare:
the JAX loop writes a training state at ``SAVED`` and resumes it to
``END``; the port resumes a copy of the same directory to ``END`` (JAX on
the CPU, narrow networks).

The teacher case trains with ``L2Dice`` and ``soft: true`` (a configs/
KDLAET.yml variant): the L1-Shadow loss's binarized term flips with a pixel
that crosses its threshold, so two runs whose parameters agree within a
rounding can log ``l_pix`` values 3e-4 apart (measured at the second
resumed step, the parameters within 1.6e-7 of JAX's); the sigmoid keeps the
loss continuous in the parameters.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import jax
import orbax.checkpoint as ocp

from rethink_acoustic_image_enhancement_tpu.convert.torch_export import (
    export_student,
    export_teacher,
)
from rethink_acoustic_image_enhancement_tpu.train import checkpoints as jckpt
from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import (
    read_pth,
    student_state_dict,
    teacher_state_dict,
)
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import jax_state
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
from torch_train_corpus import (
    REPO,
    teacher_config,
    write_student_corpus,
    write_teacher_corpus,
    write_yml,
)

LR = 1e-3
SAVED, END = 3, 5
FREEZE_EXCEPT = ["st_fusion", "out_conv"]  # the student's, named alike in flax and torch
SOFT_L2DICE = {"type": "L2Dice", "soft": True, "loss_weight": 1, "reduction": "mean"}


def _teacher(roots, **train):
    cfg = teacher_config(roots, None, batch_size_per_gpu=2, mini_batch_sizes=[1],
                         iters=[END], gt_size=16, gt_sizes=[16], probs=[0.0],
                         num_worker_per_gpu=2)
    cfg["train"].update(mixing_augs={"mixup": False}, pixel_opt=dict(SOFT_L2DICE), **train)
    cfg["train"]["optim_g"]["lr"] = LR
    cfg["train"]["scheduler"].update(periods=[4, 10])
    return cfg


def _student(roots, **train):
    with open(os.path.join(REPO, "configs", "KDLAES.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["datasets"]["train"].update(roots, num_pairs=5, batch_size_per_gpu=2, gt_size=16,
                                    gt_sizes=[16], iters=[END], mini_batch_sizes=[2],
                                    probs=[0.0], num_worker_per_gpu=2, stride_range=[1, 2])
    del cfg["datasets"]["val"]
    cfg["network_g"]["hidden_channels"] = [4, 8, 16]
    cfg["train"].update(warmup_iter=-1, mixing_augs={"mixup": False}, **train)
    cfg["train"]["optim_g"]["lr"] = LR
    cfg["train"]["scheduler"].update(periods=[4, 10], restart_weights=[1, 1])
    cfg["logger"]["use_tb_logger"] = False
    return cfg


# two live cases cover the four layouts' parts: clip + adamw with EMA leaves
# on the teacher's map; multi_transform over adamw alone (no clip) on the
# student's (its compiles take a fraction of the teacher's). The full-width
# student's clip + adamw is the committed fixture's; tests/
# test_torch_orbax_states.py finds Adam's state in each layout alone.
CASES = {
    "teacher_ema": lambda c: _teacher(c["teacher"], ema_decay=0.9),
    "student_freeze_except_no_clip": lambda c: _student(
        c["student"], freeze_except=FREEZE_EXCEPT, use_grad_clip=False),
}


def with_total(cfg, total, name):
    cfg = copy.deepcopy(cfg)
    cfg["name"] = name
    cfg["train"]["total_iter"] = total
    cfg["val"]["val_freq"] = 0
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=SAVED)
    return cfg


def train_records(log_dir, after=0):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train" and r["iter"] > after]


def events(log_dir, kind):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def write_corpora(root):
    return {"teacher": write_teacher_corpus(str(root / "teacher"), 8, 40, 40, seed=0),
            "student": write_student_corpus(str(root / "student"), 14, 24, 24, seed=1)}


def module_runs(tmp_path_factory):
    """fn(case) -> its run, the corpora and runs under this module's
    temporary directories, each case run once."""
    corpora = write_corpora(tmp_path_factory.mktemp("corpora"))
    root, cache = tmp_path_factory.mktemp("runs"), {}
    return lambda case: run(case, corpora, root, cache)


def run(case, corpora, root, cache):
    """The JAX loop to SAVED (a JAX state), the port's copy of its
    training_states, then JAX's and the port's resumes to END; cached in
    ``cache`` by case."""
    if case in cache:
        return cache[case]
    root = root / case
    root.mkdir()
    base = CASES[case](corpora)
    saved_yml = write_yml(with_total(base, SAVED, case), root / "saved.yml")
    end_cfg = with_total(base, END, case)
    end_yml = write_yml(end_cfg, root / "end.yml")
    j_saved = jcfg.parse(saved_yml, True, root_path=str(root / "jax"))
    jloop.train_from_config(j_saved)
    states = j_saved["path"]["training_states"]
    assert sorted(os.listdir(states)) == [f"ckpt_{SAVED}"]
    # the port's run and the other checks read copies taken before JAX resumes
    t_opt = tcfg.parse(end_yml, True, root_path=str(root / "port"))
    shutil.copytree(states, t_opt["path"]["training_states"])
    state_dir = str(root / f"ckpt_{SAVED}")
    shutil.copytree(os.path.join(states, f"ckpt_{SAVED}"), state_dir)
    j_end = jcfg.parse(end_yml, True, root_path=str(root / "jax"))
    jloop.train_from_config(j_end)

    grads, step = [], ttr.Trainer.step

    def recording_step(self, state, *a, **kw):
        out = step(self, state, *a, **kw)
        grads.append({n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
                      for n, p in state.model.named_parameters()})
        return out

    ttr.Trainer.step = recording_step
    try:
        tloop.train_from_config(t_opt, device="cpu")
    finally:
        ttr.Trainer.step = step
    cache[case] = dict(case=case, cfg=end_cfg, yml=end_yml, jax=j_end, port=t_opt,
                       grads=grads, state_dir=state_dir, root=root,
                       student=case.startswith("student"))
    return cache[case]


def check_iterations(r):
    """Per resumed iteration l_pix, lr and grad_norm within 1e-5 relative;
    the resume event names the JAX form; the port's own state written."""
    j_m = train_records(r["jax"]["path"]["log"], after=SAVED)
    t_m = train_records(r["port"]["path"]["log"])
    assert [x["iter"] for x in t_m] == [x["iter"] for x in j_m] == list(range(SAVED + 1, END + 1))
    for a, b in zip(t_m, j_m):
        for k in ("l_pix", "lr", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (a["iter"], k)
    resume = events(r["port"]["path"]["log"], "resume")
    assert [(x["iter"], x["form"]) for x in resume] == [(SAVED, "jax")]
    assert os.path.isfile(os.path.join(r["port"]["path"]["training_states"], f"ckpt_{END}.pth"))


def check_step_rule(r):
    """test_loop_matches_jax's rule over the resumed steps, for the
    parameters and, with ``ema_decay``, the EMA (a convex mix of them)."""
    to_sd = student_state_dict if r["student"] else teacher_state_dict
    path = os.path.join(r["jax"]["path"]["models"], f"net_g_{END}")
    port = os.path.join(r["port"]["path"]["models"], f"net_g_{END}.pth")
    init = to_sd(jckpt.load_weights(r["state_dir"], "params"))
    keys = ["params"] + (["params_ema"] if r["cfg"]["train"].get("ema_decay") else [])
    steps = END - SAVED
    tight, loose = 0.05 * LR * steps, 2 * LR * steps
    moved = 0
    for key in keys:
        want = {k: v.numpy() for k, v in to_sd(jckpt.load_weights(path, key)).items()}
        got = read_pth(port, key)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            big = np.ones(w.shape, bool)
            for g in r["grads"]:
                gmax = max(np.abs(v).max() for v in g.values())
                big &= np.abs(g[name]) > 1e-6 * gmax
            diff = np.abs(got[name].numpy() - w)
            assert (diff <= np.where(big, tight, loose)).all(), (key, name, diff.max())
            moved += int((w != init[name].numpy()).sum())
    assert moved > 0


def check_moments(r):
    """The loaded AdamW state against orbax's restore of the same directory
    through the JAX package's exporter: exp_avg = mu and exp_avg_sq = nu bit
    for bit, step = count, as float32 on the CPU; frozen parameters (mu None)
    carry no state."""
    opt = tcfg.parse(r["yml"], True, root_path=str(r["root"] / "moments"))
    _, trainer = tloop.build_everything(opt, device="cpu")
    state = trainer.init_state()
    state, epoch = jax_state.load_jax_state(r["state_dir"], state, trainer.optimizer)
    restored = ocp.StandardCheckpointer().restore(os.path.abspath(r["state_dir"]))
    assert state.step == SAVED == int(restored["step"]) and epoch == restored["epoch"]
    layout = jax_state.optax_layout(jax.device_get(restored["opt_state"]))
    export = export_student if r["student"] else export_teacher
    flat, nest = jax_state._flat, jax_state._nest
    params = flat(jax.device_get(restored["params"]))
    frozen = {k for k, v in flat(layout.adam["mu"]).items() if v is None}
    mu, nu = (export(nest({k: np.zeros_like(params[k]) if v is None else np.asarray(v)
                           for k, v in flat(layout.adam[m]).items()}))
              for m in ("mu", "nu"))
    names = [n for n, _ in state.model.named_parameters()]
    trainable = [n for n in names if trainer.optimizer.trainable(n)]
    assert (len(trainable) < len(names)) == bool(frozen) == bool(
        r["cfg"]["train"].get("freeze_except"))
    sd = state.optimizer.state_dict()["state"]
    assert len(sd) == len(trainable)
    for i, name in enumerate(trainable):
        st = sd[i]
        assert st["step"].dtype == torch.float32 and st["step"].device.type == "cpu"
        assert float(st["step"]) == int(layout.adam["count"]) == SAVED
        assert np.array_equal(st["exp_avg"].numpy(), mu[name]), name
        assert np.array_equal(st["exp_avg_sq"].numpy(), nu[name]), name


def fresh(r, root, **train):
    """A parsed config of run ``r`` with ``train`` changed, its trainer and
    a fresh state."""
    cfg = copy.deepcopy(r["cfg"])
    cfg["train"].update(train)
    opt = tcfg.parse(write_yml(cfg, root / "opt.yml"), True, root_path=str(root))
    _, trainer = tloop.build_everything(opt, device="cpu")
    return opt, trainer, trainer.init_state()


def refused_by_the_loop(r, root, match, **train):
    """The loop on a copy of run ``r``'s JAX state, with ``train`` changed,
    raises ``match`` and writes nothing: it never starts at step 0."""
    opt, _, _ = fresh(r, root, **train)
    shutil.copytree(r["state_dir"], os.path.join(opt["path"]["training_states"],
                                                 f"ckpt_{SAVED}"))
    with pytest.raises(jax_state.JaxStateError, match=match):
        tloop.train_from_config(opt, device="cpu")
    assert not os.listdir(opt["path"]["models"])
    assert os.listdir(opt["path"]["training_states"]) == [f"ckpt_{SAVED}"]
