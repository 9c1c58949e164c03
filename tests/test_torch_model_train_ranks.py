"""``train.model_shard: 2`` on the CPU: two gloo ranks, each a process of
``tests/torch_parallel_ranks.py`` started with torchrun's env, each one model
shard (``parallel/tensor.py::RankShards``).

  * Two steps of the narrow KDLAE-T with EMA (L1-Shadow, a batch of 4 at
    16 px, JAX tests/test_parallel.py:155's case) and one of the student
    (hidden (4, 8), L1, (4, 7, 32, 32) stacks, JAX
    tests/test_spatial_train.py:274's case): against the JAX package's
    Trainer on a 1x2 (data x model) mesh, the teacher by JAX
    test_parallel.py:225-235's rule and the student by
    ``_assert_step_parity``, each with the step rule on every weight
    (``torch_model_jax``); against the port's one process by the same
    rules held tighter;
  * the ranks' whole leaves bit-equal after every step, and their gathered
    parameters and EMA bit-equal; ``RankShards`` counts the sums and bytes
    that ``LocalShards`` counts for the same forwards;
  * the loop, ``raie-torch train --launcher pytorch`` with
    ``train.model_shard: 2`` on the narrow teacher's curriculum: the model
    built in its shift-add form on a ``RankShards``; rank 0 alone writes;
    its checkpoint, in the reference layout, loads strictly into one
    process, and resuming it under N = 1 and N = 2 gives the same next
    step.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.models.shards import (
    leaf_kinds,
    network_shards,
    shard_teacher,
)
from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import LocalShards
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.train.checkpoints import load_pretrained
import torch_parallel_ranks as ranks
from torch_model_jax import (assert_step_parity, assert_step_rule, assert_teacher_rule,
                             jax_model_steps)
from torch_train_corpus import teacher_config, write_teacher_corpus, write_yml

torch.set_num_threads(1)
LAUNCH_S = 150
CASES = [n for n, c in ranks.MODEL_STEPS.items() if c[0] == 2]


@pytest.fixture(scope="module")
def model_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("model2") / "model")
    for rc, text in ranks.launch("model", out, timeout=LAUNCH_S):
        assert rc == 0, text[-3000:]
    return [ranks.load_rank(out, r) for r in range(2)]


def assert_shards_agree(results):
    """The ranks' metrics equal, their whole leaves bit-equal after every
    step, their gathered parameters and EMA bit-equal."""
    first = results[0]
    for other in results[1:]:
        assert other["metrics"] == first["metrics"]
        for mine, theirs in zip(first["whole_leaves"], other["whole_leaves"], strict=True):
            assert mine.keys() == theirs.keys()
            for n, p in mine.items():
                assert torch.equal(theirs[n], p), n
        for key in ("params", "ema"):
            for n, p in (first[key] or {}).items():
                assert torch.equal(other[key][n], p), (key, n)


def assert_held(got: dict, kind: str, metrics, params, ema, grads, tight: bool = False):
    """The teacher's rule or the student's, each with the step rule
    (``torch_model_jax``); ``tight`` against the port's one process."""
    if kind == "teacher":
        assert_teacher_rule(got, metrics, params, ema, grads, tight)
        return
    assert_step_parity(got, metrics[0], params)
    assert_step_rule(got, params, ema, grads, metrics[0]["lr"], 0.01 if tight else 0.05)


def _host(result):
    return {**result, "params": {n: p.numpy() for n, p in result["params"].items()},
            "ema": None if result["ema"] is None else {
                n: p.numpy() for n, p in result["ema"].items()}}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", CASES)
def test_two_shards_agree_bit_for_bit(model_ranks, name):
    assert_shards_agree([r[name] for r in model_ranks])
    assert [r[name]["grid"] for r in model_ranks] == [(0, 0), (0, 1)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", CASES)
def test_two_shards_equal_the_jax_model_axis_step(model_ranks, name):
    kind = ranks.MODEL_STEPS[name][2]
    assert_held(_host(model_ranks[0][name]), kind, *jax_model_steps(name))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", CASES)
def test_two_shards_equal_one_process(model_ranks, name):
    kind = ranks.MODEL_STEPS[name][2]
    one = _host(ranks.run_model_case(name, slice(0, ranks.MODEL_STEPS[name][3])))
    assert_held(_host(model_ranks[0][name]), kind, one["metrics"], one["params"], one["ema"],
                one["grads"], tight=True)


def test_rank_shards_count_what_local_shards_count(model_ranks):
    """A teacher step's forward on 2 ranks sums and moves, by
    ``RankShards``' count, what ``LocalShards`` counts for the same forward
    on 2 shards; the teacher's shards split their leaves, the student's
    hold every leaf whole."""
    _, _, _, b, side, steps = ranks.MODEL_STEPS["teacher_1x2"]
    lq, _ = ranks.model_batch("teacher", b, side)
    local = LocalShards(["cpu"] * 2)
    mods = shard_teacher(ranks.seeded_model(ranks.TEACHER), local.devices)
    with torch.no_grad():
        network_shards(mods, [ranks.nchw(lq, "cpu")] * 2, local)
    assert local.sums > 0
    for r in model_ranks:
        got = r["teacher_1x2"]
        assert got["sums"] == steps * local.sums
        assert got["moved"] == {k: steps * v for k, v in local.moved.items()}
        whole = ranks.seeded_model(ranks.TEACHER).state_dict()
        assert any(got["shard_params"][n] != tuple(p.shape) for n, p in whole.items()
                   if n in got["shard_params"])
        student = ranks.seeded_model(ranks.STUDENT).state_dict()
        assert r["student_1x2"]["shard_params"] == {n: tuple(p.shape) for n, p in student.items()}
        assert r["student_1x2"]["sums"] == 0


# --------------------------------------------------------------- the loop --

def _loop_config(roots, val_roots, total):
    """KDLAET's curriculum at a narrow width on 2 model shards: two stages
    (2@16, then 1@32), crops, extra masks, mixup, EMA, a checkpoint and a
    validation at 2."""
    cfg = teacher_config(roots, val_roots, batch_size_per_gpu=2, mini_batch_sizes=[2, 1],
                         iters=[1, 2], gt_size=32, gt_sizes=[16, 32], probs=[0.2, 0.1],
                         num_worker_per_gpu=1)
    cfg["name"] = "model_shard_loop"
    cfg["train"].update(total_iter=total, ema_decay=0.9, model_shard=2)
    cfg["train"]["optim_g"]["lr"] = 1e-3
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=2)
    cfg["val"]["val_freq"] = 2
    return cfg


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """Two ranks train the config to 2 (a checkpoint and a validation), then
    resume it to 3."""
    root = tmp_path_factory.mktemp("model_loop")
    roots = write_teacher_corpus(str(root / "train"), 4, 32, 32, seed=21)
    val_roots = write_teacher_corpus(str(root / "val"), 1, 32, 32, seed=22)
    cfgs = [_loop_config(roots, val_roots, total) for total in (2, 3)]
    ymls = [write_yml(cfg, root / f"to{cfg['train']['total_iter']}.yml") for cfg in cfgs]
    out = str(root / "loop")
    ports = [ranks.free_port() for _ in range(len(ymls) + 1)]
    results = ranks.launch("loop", out, [*ymls, *ports], cwd=str(root), timeout=LAUNCH_S)
    for rc, text in results:
        assert rc == 0, text[-4000:]
    return root, cfgs, [ranks.load_rank(out, r) for r in range(2)]


def test_loop_builds_the_shift_form_on_rank_shards(loop_runs):
    _, _, results = loop_runs
    kinds = leaf_kinds(ranks.seeded_model(ranks.TEACHER), 2)
    for r in results:
        assert r["built"] == [{"dwconv_shift": True, "shards": "RankShards"}] * 2
        # each run's last whole leaves bit-equal on both ranks
        for mine, theirs in zip(results[0]["finals"], r["finals"], strict=True):
            for n, p in mine.items():
                if kinds[n] == "whole":
                    assert torch.equal(theirs[n], p), n
    writes = [set(r["writes"]) for r in results]
    assert writes[0] and not writes[1], writes
    assert {"ckpt_2.pth", "net_g_2.pth", "ckpt_3.pth", "net_g_3.pth"} <= writes[0]


def test_checkpoint_loads_into_one_process_and_resumes_under_one_and_two(loop_runs):
    """Rank 0's ``net_g_2.pth`` and ``ckpt_2.pth`` are in the reference
    layout: they load strictly into the grouped-conv teacher, and the
    resume from 2 to 3 under N = 1 (this process) and N = 2 (the ranks)
    reaches the same parameters and EMA (2e-5 relative and 2e-6 absolute,
    the bound of tests/test_torch_parallel_loop.py)."""
    root, cfgs, _ = loop_runs
    exp = root / "experiments" / "model_shard_loop"
    net = ranks.seeded_model(ranks.TEACHER)
    load_pretrained(net, str(exp / "models" / "net_g_2.pth"))  # strict
    ckpt = torch.load(exp / "training_states" / "ckpt_2.pth", weights_only=True)
    assert ckpt["params"].keys() == net.state_dict().keys()
    assert ckpt["params_ema"].keys() == net.state_dict().keys()
    assert len(ckpt["opt_state"]["state"]) == len(list(net.parameters()))
    # N = 1 from a copy of the experiment cut back to its checkpoint at 2
    one_root = root / "one"
    one_exp = one_root / "experiments" / "model_shard_loop_one"
    shutil.copytree(exp, one_exp)
    for sub, name in (("training_states", "ckpt_3.pth"), ("models", "net_g_3.pth")):
        os.remove(one_exp / sub / name)
    cfg = {**cfgs[1], "name": "model_shard_loop_one",
           "train": {**cfgs[1]["train"], "model_shard": 1}}
    opt = tcfg.parse(write_yml(cfg, one_root / "one.yml"), True, root_path=str(one_root))
    state = tloop.train_from_config(opt, device="cpu")
    assert state.step == 3
    two = torch.load(exp / "models" / "net_g_3.pth", weights_only=True)
    for key, module in (("params", state.model), ("params_ema", state.ema)):
        for n, p in module.state_dict().items():
            np.testing.assert_allclose(two[key][n].numpy(), p.numpy(), rtol=2e-5, atol=2e-6,
                                       err_msg=f"{key} {n}")
