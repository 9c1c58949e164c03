"""The port's remote experiment trackers (wandb / swanlab protocols) and
MessageLogger's remote sink, held to tests/test_tracking.py through fake
client modules: each case drives the port's and the JAX package's
tracker with its own fake and expects the same recorded calls; the gating
of make_tracker; the sink's tag space (losses/*, m_*, and the loop's
metrics/*), in the port's training loop against the JAX loop's; and the
scorer trainer's per-epoch swanlab payloads."""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
from rethink_acoustic_image_enhancement_tpu.train import loop as jloop
from rethink_acoustic_image_enhancement_tpu.utils import logging as jlogging
from rethink_acoustic_image_enhancement_tpu.utils import tracking as jtracking
from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
from rethink_acoustic_image_enhancement_tpu_torch.utils import logging as tlogging
from rethink_acoustic_image_enhancement_tpu_torch.utils import tracking as ttracking
from torch_train_corpus import teacher_config, write_teacher_corpus, write_yml

torch.set_num_threads(2)


class FakeWandb:
    """Records the wandb protocol: init kwargs, log(payload, step), finish."""

    class util:
        @staticmethod
        def generate_id():
            return "genid123"

    def __init__(self):
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, payload, step=None):
        self.calls.append(("log", dict(payload), step))

    def finish(self):
        self.calls.append(("finish",))


class FakeSwanlab:
    def __init__(self):
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, payload):
        self.calls.append(("log", dict(payload)))


def _both(drive, fake_cls):
    """``drive(tracking_module, fake)`` for the port and JAX; their fakes'
    calls, which must be equal."""
    out = []
    for mod in (ttracking, jtracking):
        fake = fake_cls()
        drive(mod, fake)
        out.append(fake.calls)
    assert out[0] == out[1]
    return out[0]


def test_wandb_fresh_run_and_log():
    def drive(mod, fake):
        t = mod.RemoteTracker("wandb", "proj", run_name="exp1",
                              config={"total_iter": 5}, module=fake)
        assert t.enabled and t.run_id == "genid123"
        t.log({"losses/l_pix": np.float32(0.5)}, step=100)
        t.finish()

    calls = _both(drive, FakeWandb)
    init = calls[0][1]
    assert (init["id"], init["resume"], init["sync_tensorboard"]) == ("genid123", "never", True)
    assert calls[1] == ("log", {"losses/l_pix": 0.5}, 100)
    assert isinstance(calls[1][1]["losses/l_pix"], float)
    assert calls[2] == ("finish",)


def test_wandb_resume():
    calls = _both(lambda mod, fake: mod.RemoteTracker("wandb", "p", resume_id="old",
                                                      module=fake), FakeWandb)
    assert (calls[0][1]["id"], calls[0][1]["resume"]) == ("old", "allow")


def test_swanlab_carries_the_step_in_the_payload():
    def drive(mod, fake):
        t = mod.RemoteTracker("swanlab", "DenoiseRatePrediction", run_name="r",
                              config={"optimizer": "Adam"}, module=fake)
        t.log({"train_epoch_mse": 0.1}, step=3)
        t.log({"step": 7.0, "x": 1}, step=3)  # an explicit step wins
        t.finish()  # the fake has no finish: a no-op

    calls = _both(drive, FakeSwanlab)
    assert calls[0] == ("init", {"project": "DenoiseRatePrediction",
                                 "config": {"optimizer": "Adam"}, "experiment_name": "r"})
    assert calls[1:] == [("log", {"train_epoch_mse": 0.1, "step": 3.0}),
                         ("log", {"step": 7.0, "x": 1.0})]


def test_missing_library_warns_and_disables(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # an import that fails
    for mod in (ttracking, jtracking):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            t = mod.RemoteTracker("wandb", "proj")
        assert not t.enabled and any("wandb" in str(x.message) for x in w)
        t.log({"a": 1.0}, step=0)
        t.finish()


def test_unknown_backend_rejected():
    for mod in (ttracking, jtracking):
        with pytest.raises(ValueError, match="backend"):
            mod.RemoteTracker("mlflow", "p")


def test_make_tracker_gating():
    for mod in (ttracking, jtracking):
        assert mod.make_tracker({}, "run") is None
        assert mod.make_tracker({"wandb": {"project": None}}, "run") is None
    calls = _both(lambda mod, fake: mod.make_tracker(
        {"wandb": {"project": "p", "resume_id": "r1"}}, "run", module=fake), FakeWandb)
    assert calls[0][1]["id"] == "r1" and calls[0][1]["name"] == "run"
    calls = _both(lambda mod, fake: mod.make_tracker(
        {"swanlab": {"project": "sp"}}, "run", module=fake), FakeSwanlab)
    assert calls[0][1]["project"] == "sp"


def test_message_logger_feeds_the_remote_tb_tags():
    out = []
    for track, logging_mod in ((ttracking, tlogging), (jtracking, jlogging)):
        fake = FakeWandb()
        remote = track.RemoteTracker("wandb", "p", module=fake)
        ml = logging_mod.MessageLogger(total_iters=10, log=lambda m: None, remote=remote)
        ml(epoch=0, current_iter=2, metrics={"lr": 1e-4, "l_pix": 0.25, "m_psnr": 30.0})
        ml(epoch=0, current_iter=3, metrics={"lr": 1e-4})  # nothing but lr: no remote call
        out.append(fake.calls[1:])
    assert out[0] == out[1] == [("log", {"losses/l_pix": 0.25, "m_psnr": 30.0}, 2)]


def test_loop_sends_the_jax_loops_tags(tmp_path, monkeypatch):
    """A narrow teacher config with logger.wandb.project set: the port's
    loop and the JAX loop, each with a fake wandb module, log the same
    tags at the same steps (losses every step, validation metrics)."""
    roots = write_teacher_corpus(str(tmp_path / "c"), 4, 24, 24, seed=0)
    val = write_teacher_corpus(str(tmp_path / "v"), 1, 16, 24, seed=1)
    cfg = teacher_config(roots, val, batch_size_per_gpu=2, mini_batch_sizes=[2], iters=[1],
                         gt_size=16, gt_sizes=[16], probs=[0.0], num_worker_per_gpu=1)
    cfg["train"].update(total_iter=1, mixing_augs={"mixup": False})
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=1,
                         wandb={"project": "proj", "resume_id": None})
    cfg["val"]["val_freq"] = 1
    yml = write_yml(cfg, tmp_path / "opt.yml")
    seen = {}
    for name, cfg_mod, loop_mod, kw in (("port", tcfg, tloop, {"device": "cpu"}),
                                        ("jax", jcfg, jloop, {})):
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        loop_mod.train_from_config(cfg_mod.parse(yml, True, root_path=str(tmp_path / name)),
                                   **kw)
        seen[name] = fake.calls
    assert [c[0] for c in seen["port"]] == [c[0] for c in seen["jax"]]
    assert seen["port"][0][1]["project"] == "proj"
    logs = {k: [(sorted(c[1]), c[2]) for c in v if c[0] == "log"] for k, v in seen.items()}
    assert logs["port"] == logs["jax"]
    assert logs["port"] == [(["losses/grad_norm", "losses/l_pix"], 1),
                            (["metrics/psnr", "metrics/psnr_sr"], 1)]


def test_train_asdqe_logs_epochs_through_swanlab(tmp_path):
    from rethink_acoustic_image_enhancement_tpu_torch.train.asdqe_trainer import train_asdqe
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    root = tmp_path / "data"
    for sub in ("lq", "gt", "params"):
        os.makedirs(root / sub)
    for i in range(6):
        rng = np.random.default_rng(i)
        img = (rng.uniform(0, 1, (40, 40, 3)) * 255).astype(np.uint8)
        imwrite(str(root / "lq" / f"{i}.png"), img)
        imwrite(str(root / "gt" / f"{i}.png"), np.clip(img + 10, 0, 255).astype(np.uint8))
        (root / "params" / f"{i}.json").write_text(json.dumps({"score": 0.2 * i - 0.5}))
    fake = FakeSwanlab()
    tracker = ttracking.RemoteTracker("swanlab", "DenoiseRatePrediction", module=fake)
    result = train_asdqe(
        {"dataroot_lq": str(root / "lq"), "dataroot_gt": str(root / "gt"),
         "dataroot_param": str(root / "params")},
        epochs=2, batch_size=2, accumulation_steps=2, gt_size=40, compute_dtype=None,
        log=lambda m: None, max_steps_per_epoch=2, tracker=tracker, device="cpu")
    logged = [c[1] for c in fake.calls if c[0] == "log"]
    assert [p["epoch"] for p in logged] == [0.0, 1.0] == [p["step"] for p in logged]
    for payload, hist in zip(logged, result["history"]):
        assert payload["train_epoch_mse"] == pytest.approx(hist["train_mse"], rel=1e-6)
        assert payload["val_epoch_mse"] == pytest.approx(hist["val_mse"], rel=1e-6)
