"""The port's stall watchdog, held to tests/test_watchdog.py: beats keep
the process alive, a stall calls the handler, a process blocked in a call
exits with code 17; the same outcomes from the JAX package's watchdog.
And `train --stall-timeout`: the loop runs a watchdog of that timeout,
beats it every step and stops it, and a training process whose step
blocks exits 17."""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from rethink_acoustic_image_enhancement_tpu.utils import watchdog as jwatchdog
from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.utils import watchdog
from torch_train_corpus import REPO, teacher_config, write_teacher_corpus, write_yml

MODULES = pytest.mark.parametrize("mod", [watchdog, jwatchdog], ids=["port", "jax"])


@MODULES
def test_beating_keeps_process_alive(mod):
    fired = []
    wd = mod.StallWatchdog(0.3, on_stall=fired.append, poll_s=0.05).start()
    for _ in range(10):
        time.sleep(0.05)
        wd.beat()
    wd.stop()
    time.sleep(0.2)
    assert not fired


@MODULES
def test_stall_invokes_handler(mod):
    fired = []
    wd = mod.StallWatchdog(0.2, on_stall=fired.append, poll_s=0.05).start()
    time.sleep(0.6)
    wd.stop()
    assert len(fired) == 1 and fired[0] >= 0.2


def test_exit_code_and_poll_match_jax():
    assert watchdog.STALL_EXIT_CODE == jwatchdog.STALL_EXIT_CODE == 17
    for t in (0.2, 5.0, 1000.0):
        assert watchdog.StallWatchdog(t)._poll_s == jwatchdog.StallWatchdog(t)._poll_s


@pytest.mark.parametrize("package", ["rethink_acoustic_image_enhancement_tpu_torch",
                                     "rethink_acoustic_image_enhancement_tpu"])
def test_stall_hard_exits_blocked_process(package):
    code = (f"from {package}.utils.watchdog import StallWatchdog\n"
            "import time\n"
            "StallWatchdog(0.3, poll_s=0.05).start()\n"
            "time.sleep(30)\n")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=20, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 17
    assert time.time() - t0 < 10
    assert "stall watchdog" in proc.stderr


@pytest.fixture(scope="module")
def narrow_yml(tmp_path_factory):
    root = tmp_path_factory.mktemp("wd")
    cfg = teacher_config(write_teacher_corpus(str(root / "train"), 4, 24, 24, seed=0), None,
                         batch_size_per_gpu=2, mini_batch_sizes=[2], iters=[3], gt_size=16,
                         gt_sizes=[16], probs=[0.0], num_worker_per_gpu=1)
    cfg["train"]["total_iter"] = 3
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=3)
    cfg["val"]["val_freq"] = 0
    return write_yml(cfg, root / "wd.yml")


def test_train_stall_timeout_runs_a_watchdog(narrow_yml, tmp_path, monkeypatch):
    made = []

    class Recorder(watchdog.StallWatchdog):
        def __init__(self, timeout_s, **kw):
            super().__init__(timeout_s, on_stall=lambda q: None, **kw)
            self.beats, self.stopped = 0, False
            made.append(self)

        def beat(self):
            self.beats += 1
            super().beat()

        def stop(self):
            self.stopped = True
            super().stop()

    monkeypatch.setattr(watchdog, "StallWatchdog", Recorder)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "-opt", narrow_yml, "--device", "cpu"]) == 0
    assert not made  # no --stall-timeout, no watchdog
    monkeypatch.chdir(tmp_path / "experiments")  # a fresh run directory
    assert cli.main(["train", "-opt", narrow_yml, "--device", "cpu",
                     "--stall-timeout", "45"]) == 0
    (wd,) = made
    assert wd.timeout_s == 45.0 and wd.stopped
    assert wd.beats >= 1 + 3  # started, then every step


def test_train_blocked_in_a_step_exits_17(narrow_yml, tmp_path):
    script = textwrap.dedent(f"""
        import time
        from rethink_acoustic_image_enhancement_tpu_torch import cli
        from rethink_acoustic_image_enhancement_tpu_torch.train import trainer
        trainer.Trainer.step = lambda *a, **k: time.sleep(60)
        cli.main(["train", "-opt", {narrow_yml!r}, "--device", "cpu",
                  "--stall-timeout", "2"])
        """)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=50, cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                                   + os.path.join(REPO, "tests")))
    assert proc.returncode == 17, proc.stderr[-2000:]
    assert "stall watchdog" in proc.stderr
    assert time.time() - t0 < 45
