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
    answers 0, 1, None, its one device, and ``barrier`` does nothing;
  * ``init_grid``: the ranks as an ``n_data x n_spatial`` grid
    (``train.spatial_shard``) or an ``n_data x n_model`` grid
    (``train.model_shard``), never both (as in the JAX package): rank r is
    data index ``r // n_inner`` and band or model shard ``r % n_inner`` of
    its data index, ``n_inner`` being ``n_spatial`` or ``n_model``. Each
    data index's ranks form a spatial or a model subgroup (the halos,
    partial sums and joins of its bands; the partial sums of its shards),
    and each band or shard index across the data indices a data subgroup
    (the global batch's rows). ``data_index``, ``n_data``, ``band_index``,
    ``n_spatial``, ``spatial_group``, ``shard_index``, ``n_model``,
    ``model_group`` and ``data_group`` read it; without a grid every rank
    is a data index of its own and the data group is the world. On model
    shards a gradient is reduced by the kind of its leaf
    (``collectives.py::reduce_shard_gradients``): a leaf every shard holds
    whole over the world, a split leaf over its data subgroup, both divided
    by the world's size.
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


_GRID = {"n_spatial": 1, "n_model": 1, "inner": None, "data": None}


def _reset_grid() -> None:
    _GRID.update(n_spatial=1, n_model=1, inner=None, data=None)


def init_grid(n_spatial: int = 1, n_model: int = 1) -> None:
    """Lay the ranks out as ``world_size() // n`` data indices of ``n``
    bands (``n_spatial``) or model shards (``n_model``) each (module
    docstring). Every rank calls it with the same sizes; a second call with
    the grid's own sizes keeps its groups. Raises where both axes are
    split or where ``n`` does not divide the world."""
    n_spatial, n_model = int(n_spatial), int(n_model)
    if n_spatial > 1 and n_model > 1:
        raise ValueError("a grid splits either bands or model shards, not both")
    n = max(n_spatial, n_model)
    world = world_size()
    if min(n_spatial, n_model) < 1 or world % n:
        what = "model shards" if n_model > 1 else "bands"
        raise ValueError(f"{n} {what} do not divide a world of {world} rank(s)")
    if (n_spatial, n_model) == (_GRID["n_spatial"], _GRID["n_model"]) and (
            n == 1 or _GRID["inner"] is not None):
        return
    _reset_grid()
    if n == 1:
        return
    n_data, r = world // n, rank()
    inner = data = None
    # new_group is entered by every rank for every group, in the same order
    for d in range(n_data):
        g = dist.new_group(list(range(d * n, (d + 1) * n)))
        if d == r // n:
            inner = g
    for s in range(n):
        g = dist.new_group(list(range(s, world, n)))
        if s == r % n:
            data = g
    _GRID.update(n_spatial=n_spatial, n_model=n_model, inner=inner,
                 data=None if n_data == 1 else data)


def _n_inner() -> int:
    return _GRID["n_spatial"] * _GRID["n_model"]


def n_spatial() -> int:
    """Bands of an image: the grid's ``n_spatial`` (1 without a grid)."""
    return _GRID["n_spatial"]


def band_index() -> int:
    """This rank's band of its data index's images."""
    return rank() % n_spatial()


def n_model() -> int:
    """Model shards of the network: the grid's ``n_model`` (1 without a
    grid)."""
    return _GRID["n_model"]


def shard_index() -> int:
    """This rank's model shard."""
    return rank() % n_model()


def n_data() -> int:
    """Data indices of the grid: the ranks that hold different rows."""
    return world_size() // _n_inner()


def data_index() -> int:
    """This rank's data index: which rows of the global batch it holds."""
    return rank() // _n_inner()


def spatial_group():
    """The process group of this data index's bands (None without bands)."""
    return _GRID["inner"] if _GRID["n_spatial"] > 1 else None


def model_group():
    """The process group of this data index's model shards (None without
    shards)."""
    return _GRID["inner"] if _GRID["n_model"] > 1 else None


def data_group():
    """The process group of this band or shard index across the data
    indices (None: the world, as without a grid)."""
    return _GRID["data"]


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    _reset_grid()
    if is_initialized():
        dist.destroy_process_group()
