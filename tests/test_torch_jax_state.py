"""Resuming a JAX training state (``training_states/ckpt_<iter>``, an orbax
directory) in the port: ``train/jax_state.py``, ``train/checkpoints.py``'s
two forms and ``train/loop.py``'s resume, on the CPU.

  * live parity (``torch_jax_state_runs.py``): the JAX loop writes
    ``ckpt_3`` and resumes it to 5; the port resumes the same directory to
    5. Per iteration ``l_pix``, ``lr`` and ``grad_norm`` within 1e-5
    relative, the final weights (and EMA) by ``test_loop_matches_jax``'s
    rule, and AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step`` equal to
    optax's ``mu``, ``nu`` and ``count`` through the JAX package's own
    exporter, bit for bit. Here the narrow teacher with ``ema_decay``;
    ``test_torch_jax_state_student.py`` holds the narrow student and
    ``test_torch_jax_state_layouts.py`` the student under ``freeze_except``
    and with ``use_grad_clip: false``;
  * the committed fixture ``artifacts/kdlaes_jax_state`` (the full-width
    student; ``scripts/export_jax_training_state.py``): the port's resume
    reproduces JAX's ``jax_resumed.json``. ``l_pix`` and ``lr`` within 1e-5
    relative; ``grad_norm`` within 1e-4, the card's gate: at this size the
    L1 terms' gradient flips sign wherever prediction and target meet within
    a rounding, and JAX's and the port's float32 values lie on either side
    of the float64 value, each within 5e-5 of it (checked here);
  * the errors: a count that is not the step, a missing moment, a config
    whose clip or freeze disagrees with the tree, each naming the leaf or
    the layout, and the loop raising rather than starting at step 0;
  * the tie rule and ``keep_checkpoints`` rotating both forms; a
    ``training_states`` holding only a JAX state resumes (before this the
    port saw no ``.pth`` and started over);
  * model shards: two gloo ranks resume the teacher's JAX state under
    ``train.model_shard: 2``; their first resumed step equals one process's.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import orbax.checkpoint as ocp

from rethink_acoustic_image_enhancement_tpu_torch.train import checkpoints as ckpt
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import jax_state
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
import torch_parallel_ranks as ranks
from torch_jax_state_runs import (
    SAVED,
    check_iterations,
    check_moments,
    check_step_rule,
    events,
    fresh,
    module_runs,
    refused_by_the_loop,
    train_records,
    with_total,
)
from torch_train_corpus import REPO, write_yml

torch.set_num_threads(2)
FIXTURE = os.path.join(REPO, "artifacts", "kdlaes_jax_state")
HERE_CASES = ["teacher_ema"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return module_runs(tmp_path_factory)


@pytest.mark.parametrize("case", HERE_CASES)
def test_resumed_iterations_match_jax(case, runs):
    check_iterations(runs(case))


@pytest.mark.parametrize("case", HERE_CASES)
def test_resumed_weights_follow_the_step_rule(case, runs):
    check_step_rule(runs(case))


@pytest.mark.parametrize("case", HERE_CASES)
def test_adamw_state_is_optax_state(case, runs):
    check_moments(runs(case))


# ------------------------------------------------------------ fixture --

@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    """The port resuming the committed full-width student state to
    jax_resumed.json's end, on the CPU, with the first resumed step's
    float64 grad_norm on the same batch."""
    with open(os.path.join(FIXTURE, "jax_resumed.json")) as f:
        want = json.load(f)
    root = tmp_path_factory.mktemp("fixture")
    opt = tcfg.parse(os.path.join(FIXTURE, want["config"]), True, root_path=str(root))
    for k in ("dataroot_lq", "dataroot_gt"):
        opt["datasets"]["train"][k] = os.path.join(REPO, opt["datasets"]["train"][k])
    shutil.copytree(os.path.join(FIXTURE, "training_states"), opt["path"]["training_states"])
    f64, step = [], ttr.Trainer.step

    def first_in_float64(self, state, lq, gt, *a, **kw):
        if not f64:
            model = copy.deepcopy(state.model).double()
            self.loss_fn(model(lq.double()), gt.double()).backward()
            f64.append(float(torch.sqrt(sum(p.grad.square().sum()
                                            for p in model.parameters()))))
        return step(self, state, lq, gt, *a, **kw)

    torch.set_num_threads(4)
    ttr.Trainer.step = first_in_float64
    try:
        state = tloop.train_from_config(opt, device="cpu")
    finally:
        ttr.Trainer.step = step
        torch.set_num_threads(2)
    return opt, state, want, f64[0]


def test_fixture_resume_reproduces_jax(fixture_run):
    opt, state, want, f64 = fixture_run
    assert state.step == want["resumed_to"]
    got = train_records(opt["path"]["log"])
    assert [r["iter"] for r in got] == [r["iter"] for r in want["train"]] == [5, 6]
    for a, b in zip(got, want["train"]):
        assert a["l_pix"] == pytest.approx(b["l_pix"], rel=1e-5), a["iter"]
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-5), a["iter"]
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4), a["iter"]
    # the first resumed step's grad_norm: both float32 values beside float64's
    assert got[0]["grad_norm"] == pytest.approx(f64, rel=5e-5)
    assert want["train"][0]["grad_norm"] == pytest.approx(f64, rel=5e-5)
    assert sorted(want["final_sha256"]) == sorted(
        n for n, _ in state.model.named_parameters())


def test_a_lone_jax_state_resumes(fixture_run):
    """Regression: a training_states holding only a JAX ckpt_<iter> resumed
    nothing and started at step 0; it resumes at its iteration, the log
    line and the jsonl event naming the form."""
    opt, _, _, _ = fixture_run
    states = os.path.join(FIXTURE, "training_states")
    assert os.listdir(states) == ["ckpt_4"]
    assert ckpt.latest_checkpoint(states) == (4, "jax")
    assert ckpt.find_latest_checkpoint(states) == 4
    resume = events(opt["path"]["log"], "resume")
    assert [(r["iter"], r["form"]) for r in resume] == [(4, "jax")]
    log = next(f for f in os.listdir(opt["path"]["log"]) if f.startswith("train_"))
    with open(os.path.join(opt["path"]["log"], log)) as f:
        assert "auto-resumed from iteration 4 (JAX orbax state, " in f.read()


# -------------------------------------------------------------- errors --

def _rewritten(src, dst, edit):
    """A copy of the JAX state ``src`` at ``dst`` with ``edit`` applied to
    orbax's restore of it."""
    tree = jax.device_get(ocp.StandardCheckpointer().restore(os.path.abspath(src)))
    edit(tree)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(dst), tree, force=True)
    ckptr.wait_until_finished()
    return str(dst)


def test_a_count_that_is_not_the_step_raises(runs, tmp_path):
    r = runs("teacher_ema")

    def bump(tree):
        tree["opt_state"][1][0]["count"] = np.asarray(SAVED + 1, np.int32)

    bad = _rewritten(r["state_dir"], tmp_path / "bad", bump)
    _, trainer, state = fresh(r, tmp_path)
    with pytest.raises(jax_state.JaxStateError, match=f"adam's count is {SAVED + 1}"):
        jax_state.load_jax_state(bad, state, trainer.optimizer)


def test_a_missing_moment_raises_naming_the_leaf(runs, tmp_path):
    r = runs("teacher_ema")

    def drop(tree):
        tree["opt_state"][1][0]["nu"]["patch_embed"]["proj"]["kernel"] = None

    bad = _rewritten(r["state_dir"], tmp_path / "bad", drop)
    _, trainer, state = fresh(r, tmp_path)
    with pytest.raises(jax_state.JaxStateError,
                       match=r"nu/patch_embed/proj/kernel \(patch_embed.proj.weight\) is "
                             "missing"):
        jax_state.load_jax_state(bad, state, trainer.optimizer)


@pytest.mark.parametrize("train,tree_says", [
    ({"use_grad_clip": False}, "optimizer is clip_by_global_norm \\+ adamw, the config's .* "
                               "is adamw$"),
    ({"freeze_except": ["patch_embed", "cen"]}, "optimizer is clip_by_global_norm \\+ adamw, "
                                                "the config's .* is multi_transform"),
    ({"ema_decay": 0.0}, "params_ema is in the state but train.ema_decay is 0"),
])
def test_a_config_that_disagrees_with_the_tree_raises(train, tree_says, runs, tmp_path):
    """Through the loop: the run raises and never starts at step 0."""
    refused_by_the_loop(runs("teacher_ema"), tmp_path, tree_says, **train)


# --------------------------------------------------- forms and rotation --

def test_the_highest_iteration_wins_and_the_pth_on_a_tie(runs, tmp_path):
    run = runs("teacher_ema")
    states = tmp_path / "states"
    shutil.copytree(run["state_dir"], states / f"ckpt_{SAVED}")
    assert ckpt.latest_checkpoint(str(states)) == (SAVED, "jax")
    (states / f"ckpt_{SAVED}.pth").write_bytes(b"x")
    assert ckpt.latest_checkpoint(str(states)) == (SAVED, "pth")
    (states / f"ckpt_{SAVED - 1}.pth").write_bytes(b"x")
    shutil.copytree(run["state_dir"], states / f"ckpt_{SAVED + 1}")
    assert ckpt.latest_checkpoint(str(states)) == (SAVED + 1, "jax")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    (states / "ckpt_9").mkdir()  # no _METADATA: refused, not skipped
    with pytest.raises(ValueError, match="no orbax directory"):
        ckpt.latest_checkpoint(str(states))


def test_keep_checkpoints_rotates_both_forms(runs, tmp_path):
    run = runs("teacher_ema")
    states, models = tmp_path / "states", tmp_path / "models"
    models.mkdir()
    for it in (2, 4):
        shutil.copytree(run["state_dir"], states / f"ckpt_{it}")
        shutil.copytree(run["state_dir"], models / f"net_g_{it}")
    for it in (4, 6):
        (states / f"ckpt_{it}.pth").write_bytes(b"x")
        (models / f"net_g_{it}.pth").write_bytes(b"x")
    (models / "net_g_best.pth").write_bytes(b"x")
    shutil.copytree(run["state_dir"], models / "net_g_best")
    gone = ckpt.prune_checkpoints(str(states), str(models), keep=2)
    assert sorted(os.path.basename(p) for p in gone) == [
        "ckpt_2", "ckpt_4", "net_g_2", "net_g_4"]
    assert sorted(os.listdir(states)) == ["ckpt_4.pth", "ckpt_6.pth"]
    assert sorted(os.listdir(models)) == ["net_g_4.pth", "net_g_6.pth", "net_g_best",
                                          "net_g_best.pth"]


# -------------------------------------------------------- model shards --

def test_model_shards_resume_a_jax_state(runs, tmp_path):
    """Two gloo ranks, one model shard each, resume the teacher's JAX state
    (EMA included) through the CLI to SAVED + 1; the whole leaves they
    reach equal one process's resume, within tests/test_torch_model_train_
    ranks.py's bound (2e-5 relative, 2e-6 absolute)."""
    run = runs("teacher_ema")
    cfg = with_total(run["cfg"], SAVED + 1, "shards")
    cfg["train"]["model_shard"] = 2
    cfg["datasets"]["train"]["num_worker_per_gpu"] = 1
    yml = write_yml(cfg, tmp_path / "shards.yml")
    states = tmp_path / "experiments" / "shards" / "training_states"
    shutil.copytree(run["state_dir"], states / f"ckpt_{SAVED}")
    out = str(tmp_path / "loop")
    ports = [ranks.free_port() for _ in range(2)]
    for rc, text in ranks.launch("loop", out, [yml, *ports], cwd=str(tmp_path), timeout=150):
        assert rc == 0, text[-4000:]
    two = torch.load(tmp_path / "experiments" / "shards" / "models" / f"net_g_{SAVED + 1}.pth",
                     weights_only=True)
    one_cfg = {**cfg, "train": {**cfg["train"], "model_shard": 1}}
    opt = tcfg.parse(write_yml(one_cfg, tmp_path / "one.yml"), True,
                     root_path=str(tmp_path / "one"))
    shutil.copytree(run["state_dir"], os.path.join(opt["path"]["training_states"],
                                                   f"ckpt_{SAVED}"))
    state = tloop.train_from_config(opt, device="cpu")
    assert state.step == SAVED + 1
    for key, module in (("params", state.model), ("params_ema", state.ema)):
        for n, p in module.state_dict().items():
            np.testing.assert_allclose(two[key][n].numpy(), p.numpy(), rtol=2e-5, atol=2e-6,
                                       err_msg=f"{key} {n}")
    log = tmp_path / "experiments" / "shards" / "metrics.jsonl"
    with open(log) as f:
        resume = [r for r in map(json.loads, f) if r["kind"] == "resume"]
    assert [(r["iter"], r["form"]) for r in resume] == [(SAVED, "jax")]
