"""The port's data-parallel training loop on the CPU: two gloo ranks, each a
process running ``raie-torch train -opt YML --launcher pytorch --device
cpu`` with torchrun's env, in one working directory.

  * The JAX package's two-process launch config (tests/
    test_multiprocess_launch.py: the narrow student, ``batch_size_per_gpu:
    2`` per process, enlarge ratio 2, L1 loss, no curriculum, no mixup):
    the ranks end bit for bit equal, and their parameters equal JAX's
    one-process ``train_from_config`` at batch 4 within 2e-5 relative and
    2e-6 absolute, the bound of JAX's own equivalence test
    (test_multihost.py::test_two_process_feed_matches_single_process);
  * rank 1 writes no checkpoint, weights or metrics.jsonl, logs no step
    and its remote tracker never starts its client; rank 0 does all of it;
  * a two-rank run cut at step 2 and resumed to 3 equals the uncut one;
  * a device-resident corpus (a narrowed configs/KDLAES.yml: curriculum,
    extra masks, mixup) on two ranks equals the port's one process at
    twice ``batch_size_per_gpu`` and twice the stage's mini-batch.
"""

import json
import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.train import checkpoints as jckpt
from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import (
    read_pth,
    student_state_dict,
)
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite
import torch_parallel_ranks as ranks
from torch_train_corpus import device_student_config, write_student_corpus, write_yml

torch.set_num_threads(1)
TOTAL, CUT = 3, 2
NET = {"type": "KDLAE_student", "inp_channels": 1, "out_channels": 1,
       "residual": True, "hidden_channels": [4, 8]}


def _frames(root):
    """test_multiprocess_launch.py's 16 gray 40x48 frame pairs."""
    rng = np.random.default_rng(0)
    for sub in ("lq", "gt"):
        os.makedirs(root / sub, exist_ok=True)
    for i in range(16):
        img = rng.integers(0, 256, (40, 48), dtype=np.uint8)
        imwrite(str(root / "gt" / f"{i}_f.png"), img.astype(np.float32) / 255.0)
        noisy = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
        imwrite(str(root / "lq" / f"{i}_f.png"), noisy.astype(np.float32) / 255.0)


def _launch_config(root, name, total, bspg=2):
    """test_multiprocess_launch.py's config (``batch_size_per_gpu`` per
    process), from seeded weights that both packages read."""
    pth = root / "seeded.pth"
    if not pth.exists():
        torch.save({"params": ranks.seeded_model(NET).state_dict()}, pth)
    return {
        "name": name, "model_type": "ImageCleanModel",
        "scale": 1, "manual_seed": 0, "is_train": True,
        "datasets": {"train": {
            "name": "TrainSet", "type": "Dataset_PairedMutiImage",
            "dataroot_lq": str(root / "lq"), "dataroot_gt": str(root / "gt"),
            "io_backend": {"type": "disk"}, "gt_size": 16,
            "num_pairs": 3, "stride_range": [1, 1], "prob": 0.0,
            "geometric_augs": False, "use_shuffle": True,
            "num_worker_per_gpu": 1, "batch_size_per_gpu": bspg,
            "dataset_enlarge_ratio": 2,
        }},
        "network_g": NET,
        "path": {"pretrain_network_g": str(pth), "strict_load_g": True,
                 "resume_state": "auto"},
        "train": {"total_iter": total, "warmup_iter": -1, "use_grad_clip": True,
                  "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                                "periods": [3], "restart_weights": [1],
                                "eta_mins": [1e-4]},
                  "optim_g": {"type": "AdamW", "lr": 1e-3,
                              "weight_decay": 0.0, "betas": [0.9, 0.999]},
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1,
                                "reduction": "mean"}},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 0},
    }


def _device_config(roots, bspg, mini):
    cfg = device_student_config(roots, 5, iters=(2, 3))
    cfg["name"] = f"dp_device_{bspg}"
    cfg["network_g"]["hidden_channels"] = [4, 8]
    cfg["datasets"]["train"].update(batch_size_per_gpu=bspg, mini_batch_sizes=mini)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    _frames(root)
    dev_roots = write_student_corpus(str(root / "device"), 12, 20, 20, seed=3)
    cfgs = {"uncut": _launch_config(root, "dp_uncut", TOTAL),
            "cut": _launch_config(root, "dp_cut", CUT),
            "resumed": _launch_config(root, "dp_cut", TOTAL),
            "device": _device_config(dev_roots, 2, [2, 1])}
    ymls = [write_yml(c, root / f"{k}.yml") for k, c in cfgs.items()]
    out = str(root / "loop")
    ports = [ranks.free_port() for _ in range(len(ymls) + 1)]
    results = ranks.launch("loop", out, [*ymls, *ports], cwd=str(root), timeout=240)
    for rc, text in results:
        assert rc == 0, text[-4000:]
    assert "multi-process: rank 0/2, device cpu, backend gloo" in results[0][1]
    # rank 1's logger is silenced (utils/logging.py), rank 0 logs every step
    assert "l_pix" in results[0][1] and "l_pix" not in results[1][1], results[1][1][-2000:]
    return root, cfgs, [ranks.load_rank(out, r) for r in range(ranks.WORLD)]


def _final(result, run):
    return result["finals"][["uncut", "cut", "resumed", "device"].index(run)]


def test_ranks_end_bit_for_bit_equal(runs):
    _, cfgs, (r0, r1) = runs
    for run in cfgs:
        for n, p in _final(r0, run).items():
            assert torch.equal(_final(r1, run)[n], p), (run, n)


@pytest.mark.timeout(300)
def test_two_ranks_equal_the_jax_loop_at_batch_4(runs):
    root, _, (r0, _) = runs
    cfg = _launch_config(root, "jax_batch_4", TOTAL, bspg=4)
    j_opt = jcfg.parse(write_yml(cfg, root / "jax.yml"), True, root_path=str(root / "jax"))
    jloop.train_from_config(j_opt)
    want = student_state_dict(jckpt.load_weights(
        os.path.join(j_opt["path"]["models"], f"net_g_{TOTAL}")))
    got = _final(r0, "uncut")
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=2e-5, atol=2e-6,
                                   err_msg=n)
    written = read_pth(os.path.join(root, "experiments", "dp_uncut", "models",
                                    f"net_g_{TOTAL}.pth"))
    for n, p in got.items():
        assert torch.equal(written[n], p), n


def test_only_rank_0_writes(runs):
    root, _, (r0, r1) = runs
    assert r1["writes"] == [] and r1["tracker_calls"] == []
    assert r0["tracker_calls"] == ["init"]
    assert {"metrics.jsonl", f"ckpt_{TOTAL}.pth", f"net_g_{TOTAL}.pth",
            f"ckpt_{CUT}.pth"} <= set(r0["writes"])
    with open(root / "experiments" / "dp_uncut" / "metrics.jsonl") as f:
        rows = [r for r in map(json.loads, f) if r["kind"] == "train"]
    assert [r["iter"] for r in rows] == list(range(1, TOTAL + 1))


def test_resumed_two_rank_run_equals_the_uncut_one(runs):
    root, _, (r0, _) = runs
    for n, p in _final(r0, "uncut").items():
        assert torch.equal(_final(r0, "resumed")[n], p), n
    with open(root / "experiments" / "dp_cut" / "metrics.jsonl") as f:
        kinds = [(r["kind"], r["iter"]) for r in map(json.loads, f)]
    assert ("resume", CUT) in kinds


def test_device_resident_ranks_equal_one_process_at_twice_the_batch(runs, tmp_path):
    root, cfgs, (r0, _) = runs
    roots = {k: cfgs["device"]["datasets"]["train"][k] for k in ("dataroot_lq", "dataroot_gt")}
    cfg = _device_config(roots, 4, [4, 2])
    opt = tcfg.parse(write_yml(cfg, tmp_path / "one.yml"), True, root_path=str(tmp_path))
    state = tloop.train_from_config(opt, device="cpu")
    got = _final(r0, "device")
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(got[n].numpy(), p.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)

    def losses(log):
        with open(os.path.join(log, "metrics.jsonl")) as f:
            return [r["l_pix"] for r in map(json.loads, f) if r["kind"] == "train"]

    two = losses(os.path.join(root, "experiments", "dp_device_2"))
    np.testing.assert_allclose(two, losses(opt["path"]["log"]), rtol=1e-5)
    assert len(two) == 5
