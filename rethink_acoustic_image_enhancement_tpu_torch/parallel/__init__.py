"""Data parallelism across processes (the JAX package's ``parallel/``; the
reference's DDP over NCCL, basicsr/utils/dist_util.py:10-83).

One process per rank, each on its own card (``cuda:LOCAL_RANK`` modulo the
cards it sees), joined by ``torch.distributed``: NCCL between cards, gloo on
the CPU, or gloo between ranks that share one card (NCCL refuses two ranks
on one device; gloo moves CUDA tensors for ``broadcast`` and ``all_reduce``,
the only collectives the port uses). ``collectives.py`` holds what the
training step needs of them.

  * ``detect_launch_env``: the launcher's env handshake, torchrun's
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT or SLURM's
    SLURM_PROCID / SLURM_NTASKS (the coordinator from MASTER_ADDR, else a
    plain SLURM_STEP_NODELIST), with the JAX package's rules;
  * ``init_distributed``: ``init_process_group`` over TCP, explicit
    arguments first, else the launcher's env. Every wait (the rendezvous
    and each collective) has a timeout, ``RAIE_DIST_TIMEOUT_S`` seconds
    (600 by default), so a rank that is missing or dead ends the run with
    an error; nothing falls back to one process;
  * ``is_master``, ``rank``, ``world_size``, ``backend_name``,
    ``local_device``, ``barrier`` and ``shutdown``; a single process
    answers 0, 1, None, its one device, and ``barrier`` does nothing.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_PORT = "29500"
TIMEOUT_ENV = "RAIE_DIST_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 600.0


def detect_launch_env(env: dict | None = None) -> dict:
    """``init_distributed``'s keyword arguments from a launcher's env
    (``os.environ`` by default), or {} where there is none. A bracketed
    SLURM nodelist needs MASTER_ADDR (no scontrol is run)."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        port = env.get("MASTER_PORT", DEFAULT_PORT)
        return {"coordinator_address": f"{addr}:{port}",
                "num_processes": int(env["WORLD_SIZE"]),
                "process_id": int(env["RANK"])}
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        addr = env.get("MASTER_ADDR")
        if addr is None:
            nodelist = env.get("SLURM_STEP_NODELIST", "")
            addr = nodelist if nodelist and "[" not in nodelist else None
        if addr is not None:
            port = env.get("MASTER_PORT", DEFAULT_PORT)
            return {"coordinator_address": f"{addr}:{port}",
                    "num_processes": int(env["SLURM_NTASKS"]),
                    "process_id": int(env["SLURM_PROCID"])}
    return {}


def timeout_s() -> float:
    """Seconds any rendezvous or collective may wait."""
    return float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))


def local_rank() -> int:
    """The rank among the processes of this host: torchrun's LOCAL_RANK,
    SLURM's SLURM_LOCALID, else 0."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in os.environ:
            return int(os.environ[key])
    return 0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_master() -> bool:
    """The @master_only predicate (dist_util.py:75-83)."""
    return rank() == 0


def backend_name() -> str | None:
    """The process group's backend, or None in a single process."""
    return str(dist.get_backend()) if is_initialized() else None


def local_device() -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK`` modulo the visible cards in a
    process group, plain ``cuda`` in a single process. Raises without a
    GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    if not is_initialized():
        return torch.device("cuda")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join the process group (the init_dist('pytorch'/'slurm') handshake,
    dist_util.py:10-58). Explicit arguments win, else the launcher's env;
    call before any device use. ``backend`` None is NCCL where CUDA is
    available and gloo elsewhere. Returns True when a process group was
    made; ``num_processes == 1`` is a no-op, as is a call with neither
    arguments nor a launcher's env. A rank that cannot reach the others
    within ``timeout_s()`` raises."""
    if num_processes == 1:
        return False
    if coordinator_address or num_processes or process_id is not None:
        kwargs = {"coordinator_address": coordinator_address,
                  "num_processes": num_processes, "process_id": process_id}
        missing = [k for k, v in kwargs.items() if v is None]
        if missing:
            raise ValueError(f"init_distributed needs all of coordinator_address, "
                             f"num_processes and process_id; missing {missing}")
    else:
        kwargs = detect_launch_env()
        if not kwargs:
            return False
    if is_initialized():
        raise RuntimeError("init_distributed: a process group already exists")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    device = None
    if backend == "nccl":  # bound to its card, so that NCCL need not guess it
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{kwargs['coordinator_address']}",
        world_size=int(kwargs["num_processes"]), rank=int(kwargs["process_id"]),
        timeout=datetime.timedelta(seconds=timeout_s()), device_id=device)
    return True


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_initialized():
        dist.destroy_process_group()
