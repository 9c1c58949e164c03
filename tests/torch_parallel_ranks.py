"""Ranks of the port's data-parallel tests, and the launcher that starts them
(no JAX here: the card's tests use this too).

``launch(case, out, args)`` starts ``world`` processes of this file with
torchrun's env (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a
free port), each ``python tests/torch_parallel_ranks.py CASE OUT ARGS...``,
and waits for them under a hard timeout. Each rank writes what it computed
to ``OUT_rank{r}.pt``; the tests compare the ranks with each other, with one
process on the concatenated batch and with the JAX package.

The step cases share their models, batches and draws with the one-process
runs of the tests (``run_step_case``, ``run_loss_case``): a rank runs them
on its rows of the batch, a single process on all of them.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rethink_acoustic_image_enhancement_tpu_torch import parallel  # noqa: E402
from rethink_acoustic_image_enhancement_tpu_torch.losses import build_loss  # noqa: E402
from rethink_acoustic_image_enhancement_tpu_torch.models import build_network  # noqa: E402
from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr  # noqa: E402
from rethink_acoustic_image_enhancement_tpu_torch.train.schedules import (  # noqa: E402
    build_schedule,
)

HERE = os.path.abspath(__file__)
WORLD = 2
STEPS = 3
# the narrow teacher of the training tests (full width: dim 48, [4,6,6,8], 4)
TEACHER = {"type": "KDLAE_teacher", "inp_channels": 3, "out_channels": 3,
           "dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
           "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
           "LayerNorm_type": "BiasFree", "dual_pixel_task": False,
           "static": "train", "params": "cat"}
STUDENT = {"type": "KDLAE_student", "inp_channels": 1, "out_channels": 1,
           "residual": True, "hidden_channels": [4, 8]}
TRAIN = {"optim_g": {"type": "AdamW", "lr": 1e-3, "weight_decay": 5e-5,
                     "betas": [0.2, 0.999]},
         "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                       "periods": [2, 10], "restart_weights": [1, 1],
                       "eta_mins": [3e-4, 1e-6]},
         "use_grad_clip": True}
L1_SR = {"type": "L1LossSr", "loss_weight": 1, "reduction": "mean"}
# every loss of the registry: (network, pixel_opt); frame-stack losses on
# the student, {'hq', 'sr'} losses on the teacher
LOSS_CASES = {
    "L1Loss": ("student", {"type": "L1Loss", "reduction": "mean"}),
    "MSELoss": ("student", {"type": "MSELoss", "reduction": "mean"}),
    "PSNRLoss": ("student", {"type": "PSNRLoss", "loss_weight": 0.5}),
    "CharbonnierLoss": ("student", {"type": "CharbonnierLoss", "eps": 1e-3}),
    "L1LossSonar": ("student", {"type": "L1LossSonar", "reduction": "mean"}),
    "L1LossChannel": ("student", {"type": "L1LossChannel", "channel": 1}),
    "L1Lossweight": ("student", {"type": "L1Lossweight", "reduction": "max"}),
    "L1LossForVideoFrames": ("student", {"type": "L1LossForVideoFrames",
                                         "reduction": "mix"}),
    "L1LossSr": ("teacher", L1_SR),
    "L2Dice": ("teacher", {"type": "L2Dice", "soft": True}),
}
BATCH = 2  # the global batch of the draw cases: mini-batch 1 per rank


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(style: str, r: int, world: int, port: int) -> dict:
    """A launcher's env for rank r: torchrun's, SLURM's (the coordinator
    from a single-host SLURM_STEP_NODELIST) or none (the flags carry it)."""
    if style == "torchrun":
        return {"RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    if style == "slurm":
        return {"SLURM_PROCID": str(r), "SLURM_NTASKS": str(world),
                "SLURM_LOCALID": str(r), "SLURM_STEP_NODELIST": "127.0.0.1",
                "MASTER_PORT": str(port)}
    return {}


LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "SLURM_STEP_NODELIST")


def launch(case: str, out: str, args=(), world: int = WORLD, ranks=None,
           timeout: float = 240.0, cwd: str | None = None, env=None,
           style: str = "torchrun", port: int | None = None):
    """Start the ranks ``ranks`` (all of ``world`` by default) of ``case``
    with ``style``'s env (``rank_env``), "{rank}" in ``args`` replaced by
    the rank, and wait at most ``timeout`` seconds; returns [(returncode, output)] per rank. A rank still running
    at the timeout is killed and reported with returncode None."""
    port = port or free_port()
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    procs = []
    for r in (range(world) if ranks is None else ranks):
        penv = dict(base, **rank_env(style, r, world, port), OMP_NUM_THREADS="1",
                    PYTHONPATH=REPO, **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, HERE, case, out, *(str(a).format(rank=r) for a in args)],
            env=penv,
            cwd=cwd or REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    results = []
    for p in procs:
        try:
            text = p.communicate(timeout=timeout)[0].decode(errors="replace")
            results.append((p.returncode, text))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            text = p.communicate()[0].decode(errors="replace")
            results.append((None, text))
    return results


def load_rank(out: str, r: int) -> dict:
    return torch.load(f"{out}_rank{r}.pt", weights_only=False)


# ------------------------------------------------------------- the steps --

def teacher_batches(seed=1, b=4, h=32, w=32, steps=STEPS):
    """Seeded NHWC teacher batches: ({'img', 'denoise_rate'}, {'hq', 'sr'})
    with a black band, as the JAX trainer takes them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        img = rng.random((b, h, w, 3)).astype(np.float32) * 0.8
        img[:, : h // 4] = 0.0
        hq = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
        out.append(({"img": img, "denoise_rate": np.full((b, h, w, 1), 0.6, np.float32)},
                    {"hq": hq, "sr": np.repeat(np.repeat(hq, 2, 1), 2, 2)}))
    return out


def student_batches(seed=2, b=BATCH, f=3, h=24, w=24, steps=STEPS):
    """Seeded (B, F, H, W) frame stacks (lq, gt)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        gt = (rng.random((b, f, h, w)) * 0.9).astype(np.float32)
        gt[:, :, : h // 4] = 0.0
        lq = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1).astype(np.float32)
        out.append((lq, gt))
    return out


def nchw(tree, device):
    """An NHWC dict (or a frame stack, as it is) to the device."""
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2))).to(device)
                for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def rows_of(tree, rows: slice):
    if isinstance(tree, dict):
        return {k: v[rows] for k, v in tree.items()}
    return tree[rows]


def seeded_model(net: dict, seed=0):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return build_network(net)


def _trainer(net, pixel_opt, device, **kw):
    return ttr.Trainer(
        model=seeded_model(net), loss_fn=build_loss(pixel_opt),
        optimizer=ttr.build_optimizer(TRAIN),
        schedule=build_schedule(TRAIN["optim_g"]["lr"], TRAIN["scheduler"]),
        device=device, **kw)


def _grads(state) -> dict:
    return {n: p.grad.detach().cpu().clone() for n, p in state.model.named_parameters()}


def _result(state, metrics, grads):
    """The metrics and (clipped) gradients of each step, the final
    parameters."""
    return {"metrics": metrics, "grads": grads,
            "params": {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}}


def run_step_case(rows: slice, device="cpu", batches=None, net=None, pixel_opt=None,
                  **kw) -> dict:
    """Three steps of the narrow KDLAE-T with L1-Shadow (or ``net`` with
    ``pixel_opt``) on ``rows`` of ``teacher_batches()`` (or ``batches``);
    no draws (no crop, mask or mixup). ``kw`` goes to the Trainer (its
    ``bands``)."""
    trainer = _trainer(net or TEACHER, pixel_opt or L1_SR, device, **kw)
    state = trainer.init_state()
    metrics, grads = [], []
    for lq, gt in batches or teacher_batches():
        state, m = trainer.step(state, nchw(rows_of(lq, rows), device),
                                nchw(rows_of(gt, rows), device), np.random.default_rng(0))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(_grads(state))
    return _result(state, metrics, grads)


def run_loss_case(name: str, rows: slice, device="cpu", **kw) -> dict:
    """Three steps of ``LOSS_CASES[name]`` on ``rows`` of a batch of
    ``BATCH``, with the curriculum's draws: a crop from 24 to 16 px, an
    extra mask at 0.1 and mixup with its identity branch, all from a
    generator seeded by the step. ``kw`` goes to the Trainer."""
    kind, pixel_opt = LOSS_CASES[name]
    net = TEACHER if kind == "teacher" else STUDENT
    batches = teacher_batches(b=BATCH, h=24, w=24) if kind == "teacher" \
        else student_batches()
    trainer = _trainer(net, pixel_opt, device, mixup=True, mixup_identity=True,
                       gt_size=24, loss_takes_rng=pixel_opt.get("reduction") == "mix",
                       **kw)
    state = trainer.init_state()
    metrics, grads = [], []
    for k, (lq, gt) in enumerate(batches):
        state, m = trainer.step(state, nchw(rows_of(lq, rows), device),
                                nchw(rows_of(gt, rows), device),
                                np.random.default_rng([7, k]), extra_prob=0.1,
                                mini_gt_size=16)
        metrics.append({k2: float(v) for k2, v in m.items()})
        grads.append(_grads(state))
    return _result(state, metrics, grads)


def my_rows(b_global: int) -> slice:
    """This data index's rows of a global batch of ``b_global``."""
    k = b_global // parallel.n_data()
    return slice(parallel.data_index() * k, (parallel.data_index() + 1) * k)


# ------------------------------------------------------ spatial training --

# the spatial cases: (world, the grid's n_spatial, kind, global batch,
# side) of one step each, no draws; the draw cases: the losses that are no
# sums over pixels, on 2 bands of a world of 2
SPATIAL_STEPS = {
    "teacher_1x2": (2, 2, "teacher", 2, 32),
    "student_1x2": (2, 2, "student", 2, 32),
    "teacher_1x4_batch1": (4, 4, "teacher", 1, 64),
    "teacher_2x2": (4, 2, "teacher", 4, 32),
}
SPATIAL_DRAWS = ("L1LossSr", "L2Dice", "PSNRLoss", "L1LossForVideoFrames")
STUDENT_L1 = {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}


def spatial_batches(kind: str, b: int, side: int):
    """One seeded batch of the case: NHWC teacher dicts or (B, 3, H, W)
    stacks."""
    if kind == "teacher":
        return teacher_batches(seed=3, b=b, h=side, w=side, steps=1)
    return student_batches(seed=4, b=b, h=side, w=side, steps=1)


def run_spatial_case(name: str, rows: slice, device="cpu", bands=None) -> dict:
    """``SPATIAL_STEPS[name]``'s step on ``rows`` of its batch, on this
    rank's band where ``bands`` is given; the bytes the bands moved."""
    _, _, kind, b, side = SPATIAL_STEPS[name]
    kw = {} if bands is None else {"bands": bands}
    net, loss = (TEACHER, L1_SR) if kind == "teacher" else (STUDENT, STUDENT_L1)
    out = run_step_case(rows, device, spatial_batches(kind, b, side), net, loss, **kw)
    out["moved"] = None if bands is None else dict(bands.moved)
    return out


def run_spatial() -> dict:
    """This rank's results of each case of its world on the case's grid
    (``init_grid``), then the draw cases where the world is 2."""
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import RankBands

    out = {}
    for name, (world, n_spatial, _, b, _) in SPATIAL_STEPS.items():
        if world == parallel.world_size():
            parallel.init_grid(n_spatial)
            out[name] = run_spatial_case(name, my_rows(b), bands=RankBands())
    if parallel.world_size() == 2:
        parallel.init_grid(2)
        for name in SPATIAL_DRAWS:
            out[name] = run_loss_case(name, my_rows(BATCH), bands=RankBands())
        out["halo"] = halo_case(RankBands())
        out["teacher_1x2_bf16"] = run_step_case(
            my_rows(2), "cpu", spatial_batches("teacher", 2, 32), bands=RankBands(),
            compute_dtype=torch.bfloat16)
    return out


def halo_case(bands) -> dict:
    """This rank's band of a seeded (2, 3, 8, 5) image with 2 halo rows by
    ``exchange_halo``, the bytes it counted, and its backward: the gradient
    on the band of the sum over the bands of each exchanged band times a
    seeded weight of its shape."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((2, 3, 8, 5), dtype=np.float32))
    weights = torch.from_numpy(rng.random((bands.n, 2, 3, 8 // bands.n + 4, 5),
                                          dtype=np.float32))
    band = bands.take(x).requires_grad_(True)
    (exchanged,) = bands.exchange_halo([band], 2)
    (exchanged * weights[bands.index]).sum().backward()
    return {"image": x, "weights": weights, "exchanged": exchanged.detach(),
            "grad": band.grad, "moved": dict(bands.moved)}


# -------------------------------------------------------- model shards --

# the model-shard cases (JAX tests/test_parallel.py:155 for the teacher,
# tests/test_spatial_train.py:274 for the student): (world, the grid's
# n_model, kind, global batch, side, steps) on the same batch every step
MODEL_STEPS = {
    "teacher_1x2": (2, 2, "teacher", 4, 16, 2),
    "student_1x2": (2, 2, "student", 4, 32, 1),
    "teacher_1x4": (4, 4, "teacher", 4, 16, 2),
    "teacher_2x2": (4, 2, "teacher", 4, 16, 2),
}
# JAX test_parallel.py:181's optimizer and EMA for the teacher, JAX
# test_spatial_train.py:29's for the student
MODEL_TRAIN = {"teacher": {"optim_g": {"type": "AdamW", "lr": 3e-4, "weight_decay": 1e-4,
                                       "betas": [0.9, 0.999]},
                           "use_grad_clip": True,
                           "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                                         "periods": [100], "restart_weights": [1],
                                         "eta_mins": [1e-6]}},
               "student": {"optim_g": {"type": "AdamW", "lr": 1e-4, "weight_decay": 1e-4,
                                       "betas": [0.9, 0.999]},
                           "use_grad_clip": True,
                           "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                                         "periods": [100], "restart_weights": [1],
                                         "eta_mins": [1e-6]}}}
MODEL_EMA = {"teacher": 0.999, "student": 0.0}


def model_batch(kind: str, b: int, side: int):
    """The case's seeded batch: NHWC teacher dicts or (B, 7, H, W) stacks
    (JAX test_spatial_train.py:302's clean and noisy frames)."""
    if kind == "teacher":
        return teacher_batches(seed=5, b=b, h=side, w=side, steps=1)[0]
    rng = np.random.default_rng(0)
    clean = rng.uniform(0.2, 0.8, size=(b, 7, side, side)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(scale=0.1, size=clean.shape), 0, 1).astype(np.float32)
    return noisy, clean


def run_model_case(name: str, rows: slice, device="cpu", shards=None) -> dict:
    """``MODEL_STEPS[name]``'s steps on ``rows`` of its batch, on this
    rank's model shard where ``shards`` is given (the teacher then in its
    shift-add form, as ``train.model_shard`` builds it): per step the
    metrics and the whole leaves this rank holds (and, in one process, the
    clipped gradients), the final parameters and EMA in the reference
    layout, the sums and bytes the shards moved."""
    from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import set_dwconv_shift

    _, _, kind, b, side, steps = MODEL_STEPS[name]
    net, loss = (TEACHER, L1_SR) if kind == "teacher" else (STUDENT, STUDENT_L1)
    model = seeded_model(net)
    if shards is not None and kind == "teacher":
        set_dwconv_shift(model)
    train = MODEL_TRAIN[kind]
    trainer = ttr.Trainer(model=model, loss_fn=build_loss(loss),
                          optimizer=ttr.build_optimizer(train),
                          schedule=build_schedule(train["optim_g"]["lr"], train["scheduler"]),
                          device=device, ema_decay=MODEL_EMA[kind], shards=shards)
    state = trainer.init_state()
    lq, gt = model_batch(kind, b, side)
    metrics, whole_leaves, grads = [], [], []
    for _ in range(steps):
        state, m = trainer.step(state, nchw(rows_of(lq, rows), device),
                                nchw(rows_of(gt, rows), device), np.random.default_rng(0))
        metrics.append({k: float(v) for k, v in m.items()})
        whole_leaves.append({n: p.detach().cpu().clone() for n, p in state.model.named_parameters()
                             if not trainer.is_split(n)})
        if shards is None:
            grads.append({n: p.grad.cpu().numpy().copy()
                          for n, p in state.model.named_parameters()})
    whole = trainer.whole_state(state)

    def host(module):
        return None if module is None else {
            n: p.detach().cpu().clone() for n, p in module.named_parameters()}

    return {"metrics": metrics, "whole_leaves": whole_leaves, "params": host(whole.model),
            "ema": host(whole.ema), "grads": grads or None,
            "shard_params": {n: tuple(p.shape) for n, p in state.model.named_parameters()},
            "moved": None if shards is None else dict(shards.moved),
            "sums": None if shards is None else shards.sums}


def run_model_shards() -> dict:
    """This rank's results of each model-shard case of its world on the
    case's grid (``init_grid``)."""
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import RankShards

    out = {}
    for name, (world, n_model, _, b, _, _) in MODEL_STEPS.items():
        if world == parallel.world_size():
            parallel.init_grid(n_model=n_model)
            out[name] = run_model_case(name, my_rows(b), shards=RankShards())
            out[name]["grid"] = (parallel.data_index(), parallel.shard_index())
    return out


# --------------------------------------------------------------- the loop --

class _Recorder:
    """Records this rank's checkpoint, weights and metrics writes."""

    def __init__(self):
        from rethink_acoustic_image_enhancement_tpu_torch.train import checkpoints
        from rethink_acoustic_image_enhancement_tpu_torch.utils import logging as tlog

        self.writes = []
        atomic, write = checkpoints._atomic_save, tlog.JsonlMetricsSink.write

        def atomic_save(obj, path):
            self.writes.append(os.path.basename(path))
            return atomic(obj, path)

        def sink_write(sink, *a, **kw):
            self.writes.append(os.path.basename(sink.path))
            return write(sink, *a, **kw)

        checkpoints._atomic_save = atomic_save
        tlog.JsonlMetricsSink.write = sink_write


def run_loop(ymls: list[str], ports: list[str]) -> dict:
    """``raie-torch train -opt YML --launcher pytorch --device cpu`` for
    each of ``ymls`` in turn, each on its own port of ``ports`` (one more
    port than runs: a remote tracker is made on the last); the final
    parameters of each run, this rank's writes and its tracker's calls."""
    from rethink_acoustic_image_enhancement_tpu_torch import cli
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.utils.tracking import RemoteTracker

    recorder = _Recorder()
    finals, built = [], []
    train, build = tloop.train_from_config, tloop.build_everything

    def keep_state(opt, **kw):
        state = train(opt, **kw)
        finals.append({n: p.detach().cpu().clone()
                       for n, p in state.model.named_parameters()})
        return state

    def keep_built(opt, device=None):
        model, trainer = build(opt, device)
        built.append({"dwconv_shift": getattr(model, "dwconv_shift", None),
                      "shards": type(trainer.shards).__name__})
        return model, trainer

    tloop.train_from_config, tloop.build_everything = keep_state, keep_built
    for yml, port in zip(ymls, ports):
        os.environ["MASTER_PORT"] = port
        assert cli.main(["train", "-opt", yml, "--launcher", "pytorch",
                         "--device", "cpu"]) == 0
    # a remote tracker's client starts on rank 0 only
    os.environ["MASTER_PORT"] = ports[len(ymls)]
    parallel.init_distributed(backend="gloo")
    calls = []

    class Fake:
        def init(self, **kw):
            calls.append("init")

    RemoteTracker("wandb", "p", module=Fake())
    parallel.shutdown()
    return {"finals": finals, "writes": recorder.writes, "tracker_calls": calls,
            "built": built}


# ------------------------------------------------------------------ main --

def main(argv) -> int:
    torch.set_num_threads(1)
    case, out, args = argv[1], argv[2], argv[3:]
    if case == "loop":
        n = (len(args) - 1) // 2
        ymls, ports = args[:n], args[n:]
        result = run_loop(ymls, ports)
    elif case == "hello":  # join through the CLI's launcher flags, one sum
        import argparse

        from rethink_acoustic_image_enhancement_tpu_torch import cli

        launcher, coordinator, n, pid = (args + [None] * 4)[:4]
        cli._init_ranks(argparse.Namespace(
            launcher=launcher, coordinator=coordinator or None, device="cpu",
            num_processes=int(n) if n else None,
            process_id=int(pid) if pid else None))
        t = torch.tensor([parallel.rank() + 1.0])
        torch.distributed.all_reduce(t)
        result = {"rank": parallel.rank(), "world": parallel.world_size(),
                  "backend": parallel.backend_name(), "sum": float(t)}
        parallel.shutdown()
    elif case == "dead":  # rank 1 dies; rank 0 must not wait for ever
        parallel.init_distributed(backend="gloo")
        if parallel.rank() == 1:
            os._exit(3)
        parallel.barrier()
        return 0
    elif case == "rendezvous":  # a rank whose peers never come
        parallel.init_distributed(backend="gloo")
        return 0
    else:
        device = args[0] if args else "cpu"
        parallel.init_distributed(backend="gloo")
        if case == "step":
            result = run_step_case(my_rows(4), device)
        elif case == "losses":
            result = {name: run_loss_case(name, my_rows(BATCH), device)
                      for name in LOSS_CASES}
        elif case == "spatial":
            result = run_spatial()
        elif case == "model":
            result = run_model_shards()
        else:
            raise SystemExit(f"unknown case {case!r}")
        result["rank"], result["world"] = parallel.rank(), parallel.world_size()
        parallel.shutdown()
    torch.save(result, f"{out}_rank{result.get('rank', os.environ.get('RANK'))}.pt")
    print(json.dumps({"case": case, "ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
