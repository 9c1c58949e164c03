"""The port's process groups (``parallel/``) on the CPU.

  * ``detect_launch_env`` equals the JAX package's on torchrun's, SLURM's
    (a plain and a bracketed nodelist, with and without MASTER_ADDR) and no
    launcher's env; a single process stays one: no group, rank 0 of 1, the
    collectives the identity;
  * ``raie-torch train``'s launcher flags start two gloo ranks from
    torchrun's env, SLURM's env and the explicit --coordinator /
    --num-processes / --process-id; a launcher asked for without its env
    exits with an error;
  * no fallback to one process: a rank whose peer never comes, and a rank
    whose peer dies, exit non-zero within the rendezvous timeout;
  * ``doctor`` reports the world size and the backend.
"""

import time

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu import parallel as jpar
from rethink_acoustic_image_enhancement_tpu_torch import cli, parallel
from rethink_acoustic_image_enhancement_tpu_torch.parallel import collectives
from rethink_acoustic_image_enhancement_tpu_torch.utils import doctor
import torch_parallel_ranks as ranks

ENVS = {
    "none": {},
    "torchrun": {"RANK": "3", "WORLD_SIZE": "8", "MASTER_ADDR": "host0",
                 "MASTER_PORT": "12345"},
    "torchrun_defaults": {"RANK": "1", "WORLD_SIZE": "2"},
    "slurm_master_addr": {"SLURM_PROCID": "1", "SLURM_NTASKS": "4",
                          "MASTER_ADDR": "host1", "MASTER_PORT": "2222"},
    "slurm_plain_nodelist": {"SLURM_PROCID": "2", "SLURM_NTASKS": "4",
                             "SLURM_STEP_NODELIST": "node7"},
    "slurm_bracketed_nodelist": {"SLURM_PROCID": "2", "SLURM_NTASKS": "4",
                                 "SLURM_STEP_NODELIST": "node[0-3]"},
}


@pytest.fixture
def clean_env(monkeypatch):
    for var in ranks.LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("case", list(ENVS))
def test_detect_launch_env_matches_jax(clean_env, case):
    for k, v in ENVS[case].items():
        clean_env.setenv(k, v)
    want = jpar.detect_launch_env()
    assert parallel.detect_launch_env() == want
    assert bool(want) == (case not in ("none", "slurm_bracketed_nodelist"))


def test_a_single_process_stays_one(clean_env):
    assert parallel.init_distributed() is False
    assert parallel.init_distributed(num_processes=1) is False
    assert not parallel.is_initialized()
    assert (parallel.rank(), parallel.world_size(), parallel.backend_name()) == (0, 1, None)
    parallel.barrier()
    x = {"hq": torch.ones(2, 3, requires_grad=True), "sr": None}
    assert collectives.gather_rows(x, differentiable=True) is x
    assert collectives.local_rows(3) == (0, 3)
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    collectives.reduce_gradients([p])
    assert torch.equal(p.grad, torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="missing"):
        parallel.init_distributed(num_processes=2)


def test_a_launcher_without_its_env_exits(clean_env, tmp_path):
    with pytest.raises(SystemExit) as err:
        cli.main(["train", "-opt", str(tmp_path / "none.yml"), "--launcher", "pytorch",
                  "--device", "cpu"])
    assert "no launcher env" in str(err.value.code)
    assert not parallel.is_initialized()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("style", ["torchrun", "slurm", "flags"])
def test_launchers_start_two_ranks(tmp_path, style):
    port = ranks.free_port()
    args = {"torchrun": ["pytorch"], "slurm": ["slurm"],
            "flags": ["none", f"127.0.0.1:{port}", 2, "{rank}"]}[style]
    out = str(tmp_path / "hello")
    for rc, text in ranks.launch("hello", out, args, style=style, port=port, timeout=90):
        assert rc == 0, text[-3000:]
    for r in range(ranks.WORLD):
        got = ranks.load_rank(out, r)
        assert got == {"rank": r, "world": 2, "backend": "gloo", "sum": 3.0}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("alone", [0, 1])
def test_a_rank_whose_peer_never_comes_fails(tmp_path, alone):
    t0 = time.monotonic()
    [(rc, text)] = ranks.launch("rendezvous", str(tmp_path / "r"), ranks=[alone],
                                env={parallel.TIMEOUT_ENV: "2"}, timeout=90)
    assert rc not in (0, None), text[-2000:]
    assert time.monotonic() - t0 < 60


@pytest.mark.timeout(120)
def test_a_dead_rank_ends_the_run(tmp_path):
    t0 = time.monotonic()
    (rc0, text0), (rc1, _) = ranks.launch("dead", str(tmp_path / "d"),
                                          env={parallel.TIMEOUT_ENV: "20"}, timeout=90)
    assert rc1 == 3
    assert rc0 not in (0, None), text0[-2000:]
    assert time.monotonic() - t0 < 60


def test_doctor_reports_world_size_and_backend(clean_env):
    assert doctor.distributed_report("cpu") == {
        "world_size": 1, "rank": 0, "backend": "gloo", "initialized": False,
        "coordinator": None}
    for k, v in ENVS["torchrun"].items():
        clean_env.setenv(k, v)
    report = doctor.distributed_report("cpu")
    assert (report["world_size"], report["rank"], report["coordinator"]) == (8, 3, "host0:12345")
    text = doctor.format_report({"python": "3", "torch": torch.__version__, "cuda": None,
                                 "host_cpus": 1, "distributed": report,
                                 "backend": {"status": "error", "detail": "x"}})
    assert "world size 8, rank 3, backend gloo (not initialised)" in text
    assert np.isfinite(parallel.timeout_s())
