"""The training loop: config in, checkpoints out (the reference's
Train/basicsr/train.py main(); the JAX package's ``train/loop.py``).

Data loading on worker threads, the stage subsample and the upload on a
prefetch thread, the progressive curriculum, logging, checkpoints and
validation on their cadence, and auto-resume from ``training_states``.
Resuming is exact: the checkpoint holds the loop's position in its epoch
and the states of its two host generators, so a run cut and resumed
reads, draws and computes what an uninterrupted run would.

Validation is dict-aware (``pred['hq']`` and, with an SR target,
``pred['sr']``): the reference's teacher validation crashed on dict outputs
and was in effect switched off with val_freq >> total_iter. A (B, F, H, W)
frame stack (the student's) is scored frame by frame, the mean over its
frames being the item's score.

``train.distill: {online: true, teacher: <network_g>, teacher_weights:
<.pth>, denoise_rate: 1.0}`` makes the student's targets in the loop with a
frozen teacher (``train/distill.py``), after the stage's subsample.

``datasets.train.device_resident: true`` holds the corpus in device memory
(``train/device_corpus.py``): each epoch's permutation of its groups or
images comes from the host generator in chunks of ``batch_size_per_gpu``,
cut to the stage's batch; the batch is cut at the stage's patch on the
device, and the step's extra mask drawn there, from a ``torch.Generator``
seeded by (manual_seed, iteration). A step uploads its ids only. The
checkpoint keeps the host generator's state at the start of the epoch, so
that a resumed run draws the same permutation.

``profile_steps`` N > 0 traces N steps, 3 iterations after the first, into
``<log>/profile`` (``utils/profiling.py``) and logs and records the device
time by kernel.

In a process group of N ranks (``parallel/``; ``raie-torch train
--launcher``) each rank reads its stride of every epoch
(``EnlargedShuffleSampler``'s rank and world size), cut per rank to the
stage's mini-batch, and the step is the one-process step on the ranks'
rows concatenated (``trainer.py``). A device-resident corpus hands every
rank the same ``batch_size_per_gpu`` x N global ids from the shared
permutation, the stage's batch being N times its mini-batch; each rank
samples its own rows of that one global sample. Rank 0 alone validates,
profiles, logs metrics and writes checkpoints and weights while the others
wait; a resume restores the same checkpoint on every rank.

``train.spatial_shard: N`` (under ``--launcher``, N dividing the world)
lays the ranks out as data indices of N bands each (``spatial_bands``,
``parallel.init_grid``): every stride above is by data index, so the N
bands of one data index read, cut and draw the same items, and the step
takes each rank's band of them (``trainer.py``). Rank 0 still validates
and writes whole-image checkpoints with the whole model.

``train.model_shard: N`` (under ``--launcher``, N dividing the world; not
beside ``spatial_shard``) lays the ranks out as data indices of N model
shards each (``model_shards``): the teacher or the Restormer takes the
shift-add depthwise form (``dwconv_shift``, as the JAX loop clones it) and
each rank trains its shard of it (``trainer.py``); the N shards of one
data index read the same items. Every checkpoint first gathers the
shards' split leaves on every rank (``Trainer.whole_state``, a
collective), and every validation the model and EMA alone
(``Trainer.whole_modules``; a checkpoint's on the same iteration); rank 0
then writes the reference layout and validates the whole model. A resume
under any N, 1 included, splits it again.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable

import numpy as np
import torch

from ..data.datasets import create_dataset
from ..data.loader import (BatchLoader, BatchUploader, DevicePrefetcher,
                           EnlargedShuffleSampler, leaves)
from ..eval.infer import highest_precision
from ..losses import build_loss
from ..metrics import NO_REFERENCE, get_metric
from ..models import build_network
from ..models.bands import BAND_NETWORKS
from ..models.blocks import set_dwconv_shift
from ..models.kdlae_student import KDLAEStudent
from ..models.shards import SHARDED_NETWORKS, shard_layout
from ..ops.layout import crop_to, pad_to_multiple
from ..parallel import (barrier, data_index, init_grid, is_master, n_data,
                        world_size)
from ..parallel.collectives import agree, broadcast_module
from ..parallel.spatial import RankBands
from ..parallel.tensor import RankShards
from ..utils.image_io import imwrite, to_ubyte
from ..utils.logging import MessageLogger, get_logger
from ..utils.profiling import aggregate_trace, trace
from ..utils.tracking import make_tracker
from .checkpoints import (find_latest_checkpoint, load_pretrained,
                          prune_checkpoints, restore_checkpoint,
                          save_checkpoint, save_weights)
from .config import make_exp_dirs, validate
from .device_corpus import build_device_corpus, seeded_generator
from .distill import make_online_target_fn
from .progressive import ProgressiveSchedule, subsample_batch
from .trainer import TrainState, build_trainer_from_config

PREFETCH_SEED_OFFSET = 7919  # the prefetch thread's generator: seed + this
PROFILE_AFTER = 3  # profiled steps start this many iterations after the first
PROFILE_TOP = 8  # kernels in the profile's log line


def build_everything(opt: dict, device=None):
    """(model, trainer) from a parsed config. The model is built under
    ``manual_seed`` with the reference's (PyTorch's) default initialisation,
    then takes ``path.pretrain_network_g`` where one is given. With
    ``train.spatial_shard`` N > 1 the ranks form a grid of N bands a data
    index and the trainer gets this rank's band (``spatial_bands``); with
    ``train.model_shard`` N > 1, of N model shards, and the trainer gets
    this rank's shard (``model_shards``)."""
    validate(opt)
    train_opt = opt["train"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(opt.get("manual_seed", 0))
        model = build_network(opt["network_g"])
    load_path = opt.get("path", {}).get("pretrain_network_g")
    if load_path:
        load_pretrained(model, load_path, opt["path"].get("param_key", "params"),
                        strict=opt["path"].get("strict_load_g", True))
    trainer = build_trainer_from_config(opt, model,
                                        build_loss(train_opt["pixel_opt"]),
                                        device=device, bands=spatial_bands(opt, model),
                                        shards=model_shards(opt, model))
    return model, trainer


def model_shards(opt: dict, model: torch.nn.Module):
    """This rank's ``RankShards`` for ``train.model_shard`` N > 1, else
    None. Refuses, before any group is made: a block with fewer hidden
    channels than N (``models/shards.py``); N > 1 without a launcher (one
    process drives one shard; the JAX package's one controller drives every
    device of its mesh). Then sets ``dwconv_shift`` on a model that has the
    flag (the JAX loop's ``model.clone(dwconv_shift=True)``) and lays out
    the rank grid (``parallel.init_grid``). ``validate`` has refused
    ``spatial_shard`` beside it."""
    n = int(opt["train"].get("model_shard") or 1)
    if n <= 1:
        return None
    shard_layout(model, n)  # raises where a block's hidden channels are too few
    if world_size() == 1:
        raise ValueError(
            f"train.model_shard={n} needs {n} ranks a data index: run under "
            "torchrun or SLURM with --launcher (one process drives one model shard)")
    if isinstance(model, SHARDED_NETWORKS):
        set_dwconv_shift(model)
    init_grid(n_model=n)
    return RankShards()


def spatial_bands(opt: dict, model: torch.nn.Module):
    """This rank's ``RankBands`` for ``train.spatial_shard`` N > 1, else
    None. Refuses, before any
    group is made: a network without band rules; over-sharding the deepest
    feature map (the JAX package's rule and message, its ``down`` 8 for
    the teacher and 4 for the student, JAX loop.py:155-169); a curriculum
    crop whose bands are not a multiple of the network's downsampling (JAX
    pads such shards; here a band runs the network on its own rows); N > 1
    without a launcher (one process drives one card; the JAX package's one
    controller drives every device of its mesh); a world that N does not
    divide. Then lays out the rank grid (``parallel.init_grid``)."""
    n = int(opt["train"].get("spatial_shard") or 1)
    if n <= 1:
        return None
    if not isinstance(model, BAND_NETWORKS):
        raise NotImplementedError(
            f"train.spatial_shard: {opt['network_g']['type']} has no row-band "
            "rules (models/bands.py trains KDLAE_teacher, Restormer and "
            "KDLAE_student; ROADMAP.md, Queue A)")
    student = isinstance(model, KDLAEStudent)
    ds_opt = opt.get("datasets", {}).get("train", {})
    sizes = [int(s) for s in (ds_opt.get("gt_sizes") or [ds_opt.get("gt_size", 0)]) if s]
    down = 4 if student else 8
    min_h = min(sizes) // down if sizes else 0
    if min_h and min_h < n:
        raise ValueError(
            f"train.spatial_shard={n} over-shards the deepest "
            f"feature map ({min_h} rows at the smallest curriculum "
            f"crop): need spatial_shard <= {min_h}")
    multiple = 2 ** model.num_levels if student else 8
    for size in sorted(set(sizes + [int(ds_opt.get("gt_size") or 0)]) - {0}):
        if size % (n * multiple):
            raise ValueError(
                f"train.spatial_shard={n}: the crop of {size} rows does not split into "
                f"{n} bands of a multiple of {multiple} rows (the network halves a "
                f"band's rows {multiple.bit_length() - 1} times)")
    if world_size() == 1:
        raise ValueError(
            f"train.spatial_shard={n} needs {n} ranks a data index: run under "
            "torchrun or SLURM with --launcher (one process drives one band)")
    init_grid(n)
    return RankBands()


def _forward_clamped(model, x):
    out = model(x)
    if isinstance(out, dict):
        return {k: None if v is None else v.clamp(0.0, 1.0)
                for k, v in out.items()}
    return out.clamp(0.0, 1.0)


def _host_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().cpu().numpy()


def _metric(cfg: dict):
    """The ``val.metrics`` entry ``cfg`` as fn(output, target) -> float; a
    no-reference metric (NIQE) is given the output alone (the JAX loop
    hands it the target as ``crop_border``, which raises)."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    fn = get_metric(kind)
    if kind in NO_REFERENCE:
        return lambda p, t: float(fn(p, **cfg))
    return lambda p, t: float(fn(p, t, **cfg))


def _score(fn, p_img: np.ndarray, t_img: np.ndarray) -> float:
    """A metric of one item; an (F, H, W) stack's is the mean over frames."""
    if p_img.ndim == 3 and p_img.shape[-1] not in (1, 3):
        return float(np.mean([fn(p[..., None], t[..., None])
                              for p, t in zip(p_img, t_img)]))
    return fn(p_img, t_img)


def validate_model(model: torch.nn.Module, val_loader, opt: dict,
                   max_items: int | None = None,
                   save_dir: str | None = None) -> dict[str, float]:
    """Pad to ``val.window_size``, forward, clamp, crop, score on the host.

    Honours the reference's val options (image_restoration_model.py:
    264-348): ``use_image`` scores uint8-quantised images, ``save_dir``
    writes the predictions, ``max_minibatch`` caps the items. Runs on the
    model's device, in float32 with TF32 off."""
    val_opt = opt.get("val", {})
    window = val_opt.get("window_size", 8)
    use_image = val_opt.get("use_image", False)
    if max_items is None and val_opt.get("max_minibatch"):
        max_items = int(val_opt["max_minibatch"])
    metric_cfgs = val_opt.get("metrics", {"psnr": {
        "type": "calculate_psnr", "crop_border": 0, "test_y_channel": False}})
    device = next(model.parameters()).device
    frames = val_loader.dataset.frame_stacks
    upload = BatchUploader(device, frames)
    quantise = (lambda a: to_ubyte(a).astype(np.float32)) if use_image \
        else (lambda a: a)

    was_training = model.training
    model.eval()
    sums = {name: 0.0 for name in metric_cfgs}
    # the *_sr metrics count only the items that carry an SR target
    sr_count = count = 0
    try:
        for batch in val_loader:
            dev = upload({"lq": batch["lq"], "gt": batch["gt"]})
            lq, gt = dev["lq"], dev["gt"]
            pred_sr = target_sr = None
            with torch.no_grad(), highest_precision():
                if isinstance(lq, dict):
                    h, w = lq["img"].shape[2:]
                    img, _ = pad_to_multiple(lq["img"], window, axes=(2, 3))
                    rate, _ = pad_to_multiple(lq["denoise_rate"], window,
                                              axes=(2, 3))
                    out = _forward_clamped(model, {"img": img,
                                                   "denoise_rate": rate})
                    if not isinstance(out, dict):
                        out = {"hq": out, "sr": None}
                    pred = crop_to(out["hq"], h, w, axes=(2, 3))
                    # the SR branch (train.py:420-426 scores sr at scale 2)
                    if out.get("sr") is not None and isinstance(gt, dict) \
                            and gt.get("sr") is not None:
                        pred_sr = _host_nhwc(crop_to(out["sr"], 2 * h, 2 * w,
                                                     axes=(2, 3)))
                        target_sr = _host_nhwc(gt["sr"])
                    target = gt["hq"] if isinstance(gt, dict) else gt
                else:
                    h, w = lq.shape[2:]
                    x, _ = pad_to_multiple(lq, window, axes=(2, 3))
                    pred = crop_to(_forward_clamped(model, x), h, w, axes=(2, 3))
                    target = gt
            if frames:  # (B, F, H, W) stays as it is
                pred, target = pred.float().cpu().numpy(), target.float().cpu().numpy()
            else:
                pred, target = _host_nhwc(pred), _host_nhwc(target)
            for b in range(pred.shape[0]):
                p_img, t_img = quantise(pred[b]), quantise(target[b])
                if save_dir is not None:
                    name0 = os.path.basename(str(batch.get(
                        "lq_path", [f"item{count}"])[b]))
                    # a stack writes its middle frame
                    out_img = p_img[p_img.shape[0] // 2][..., None] if frames else p_img
                    imwrite(os.path.join(save_dir, name0),
                            out_img / 255.0 if use_image else out_img)
                ps_img = ts_img = None
                if pred_sr is not None:
                    sr_count += 1
                    ps_img, ts_img = quantise(pred_sr[b]), quantise(target_sr[b])
                for name, cfg in metric_cfgs.items():
                    fn = _metric(cfg)
                    sums[name] += _score(fn, p_img, t_img)
                    if ps_img is not None:
                        sums[f"{name}_sr"] = sums.get(f"{name}_sr", 0.0) + fn(
                            ps_img, ts_img)
                count += 1
            if max_items is not None and count >= max_items:
                break
    finally:
        model.train(was_training)
    if count == 0:
        import warnings

        warnings.warn("validation loader yielded 0 items — no metrics "
                      "computed (check the val dataset's pairing options)")
        return {}
    return {k: v / max(sr_count if k.endswith("_sr") else count, 1)
            for k, v in sums.items()}


def _val_loader_factory(opt: dict, log) -> Callable | None:
    if "val" not in opt.get("datasets", {}):
        return None
    val_ds = create_dataset(opt["datasets"]["val"])
    if len(val_ds) == 0:
        log("WARNING: validation dataset is EMPTY — every validation will "
            "be skipped")
    return lambda: BatchLoader(val_ds, 1, EnlargedShuffleSampler(
        len(val_ds), shuffle=False), num_workers=1, drop_last=False)


def train_from_config(opt: dict, device=None, max_iters: int | None = None,
                      profile_steps: int = 0) -> TrainState:
    """A whole training run; ``max_iters`` overrides total_iter. ``device``
    None is the GPU (this rank's card in a process group), and raises where
    there is none. ``profile_steps`` > 0 traces that many steps (module
    docstring)."""
    if is_master():
        make_exp_dirs(opt)
    logger = get_logger("raie-torch")
    log_dir = opt["path"].get("log")
    handler = None
    if log_dir and is_master():
        handler = logging.FileHandler(
            os.path.join(log_dir, f"train_{int(time.time())}.log"))
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s: %(message)s"))
        logger.addHandler(handler)
    try:
        return _train(opt, device, max_iters, logger.info, profile_steps)
    finally:
        if handler is not None:
            logger.removeHandler(handler)
            handler.close()


def build_online_targets(opt: dict, device) -> Callable | None:
    """The frozen teacher's target function of ``train.distill`` on
    ``device``, or None where online distillation is off."""
    cfg = opt["train"].get("distill") or {}
    if not cfg.get("online"):
        return None
    with torch.random.fork_rng(devices=[]):  # its weights come from the file
        teacher = build_network(cfg["teacher"])
    load_pretrained(teacher, cfg["teacher_weights"], cfg.get("param_key", "params"))
    return make_online_target_fn(teacher.to(device),
                                 denoise_rate=cfg.get("denoise_rate", 1.0))


def online_targets(target_fn: Callable, lq) -> torch.Tensor:
    """The teacher's targets of a (B, F, H, W) stack batch; other batches
    raise."""
    if isinstance(lq, dict) or lq.ndim != 4:
        raise ValueError(
            "train.distill.online expects a (B, F, H, W) frame-stack dataset "
            "(Dataset_PairedMutiImage); got " + (
                "a dict batch" if isinstance(lq, dict) else f"ndim={lq.ndim}"))
    return target_fn(lq)


def _log_profile(log_dir: str, steps: int, at_iter: int, msg_logger, log) -> None:
    ms, events = aggregate_trace(os.path.join(log_dir, "profile"))
    top = list(ms.items())[:PROFILE_TOP]
    log(f"profile (ms by kernel over {steps} steps): " + ", ".join(
        f"{k}={v:.1f}" for k, v in top) + f" [{events} events]")
    if msg_logger.jsonl is not None:
        msg_logger.jsonl.write("profile", at_iter, {}, steps=steps, events=events,
                               ms_by_kernel=dict(top))


def _train(opt: dict, device, max_iters: int | None, log,
           profile_steps: int = 0) -> TrainState:
    _, trainer = build_everything(opt, device)
    state = trainer.init_state()
    device = trainer.device
    seed = opt.get("manual_seed", 0)
    target_fn = build_online_targets(opt, device)
    if target_fn is not None:
        log("online distillation: frozen teacher targets in the loop")
    ds_opt = opt["datasets"]["train"]
    bspg = int(ds_opt["batch_size_per_gpu"])
    # the loader strides by data index: the bands of one data index read
    # the same items (their rows of the global batch)
    n_dp, dp_index = n_data(), data_index()
    corpus = loader = None
    if ds_opt.get("device_resident"):
        corpus = build_device_corpus(ds_opt, device)
        log(f"device-resident corpus: {corpus.describe()}, uploaded in "
            f"{corpus.upload_s:.3f} s")
        n_items, n_batches = len(corpus), len(corpus) // (bspg * n_dp)
    else:
        dataset = create_dataset(ds_opt)
        loader = BatchLoader(
            dataset, bspg,
            EnlargedShuffleSampler(len(dataset),
                                   ratio=ds_opt.get("dataset_enlarge_ratio", 1),
                                   rank=dp_index, world_size=n_dp,
                                   shuffle=ds_opt.get("use_shuffle", True),
                                   seed=seed),
            num_workers=ds_opt.get("num_worker_per_gpu", 4),
            drop_last=ds_opt.get("drop_last", True))
        n_items, n_batches = len(dataset), len(loader)
    if n_batches == 0:
        raise ValueError(f"the training set ({n_items} items) makes no "
                         f"batch of {bspg} on each of {n_dp} data index(es)")
    prog = ProgressiveSchedule.from_dataset_opt(ds_opt)

    total_iters = int(max_iters or opt["train"]["total_iter"])
    logger_cfg = opt.get("logger", {})
    print_freq = int(logger_cfg.get("print_freq", 200))
    ckpt_freq = int(logger_cfg.get("save_checkpoint_freq", 2000))
    val_freq = int(opt.get("val", {}).get("val_freq", 0) or 0)
    states_dir = opt["path"].get("training_states")
    models_dir = opt["path"].get("models")
    log_dir = opt["path"].get("log")

    # host generators: the main thread's subsample at stage changes (with a
    # device-resident corpus: the epoch's permutation), and the prefetch
    # thread's stage subsample (the JAX loop's two)
    host_rng = np.random.default_rng(seed)
    prefetch_rng = np.random.default_rng(seed + PREFETCH_SEED_OFFSET)
    epoch, epoch_iter = 0, 0
    restore_s = None
    if states_dir and opt["path"].get("resume_state", "auto") is not None:
        latest = find_latest_checkpoint(states_dir)
        agree(-1 if latest is None else latest, device, "the checkpoint to resume")
        if latest is not None:
            t0 = time.perf_counter()
            # on shards: into the reference layout, then split again
            whole, epoch, pos = restore_checkpoint(states_dir, latest,
                                                   trainer.whole_state(state))
            state = trainer.load_whole(state, whole)
            if trainer.shards is None:
                broadcast_module(state.model, state.ema)
            restore_s = time.perf_counter() - t0
            epoch_iter = int(pos.get("epoch_iter", 0))
            if "host_rng" in pos:
                host_rng.bit_generator.state = pos["host_rng"]
                prefetch_rng.bit_generator.state = pos["prefetch_rng"]
            log(f"auto-resumed from iteration {latest} ({restore_s:.3f} s)")
    prefetch_state = prefetch_rng.bit_generator.state
    epoch_state = host_rng.bit_generator.state  # the device route's epoch start

    remote = make_tracker(logger_cfg, opt.get("name", "raie"), config=opt)
    msg_logger = MessageLogger(
        total_iters, start_iter=state.step, log=log,
        tb_log_dir=(os.path.join(log_dir, "tb") if log_dir and is_master()
                    and logger_cfg.get("use_tb_logger") else None),
        jsonl_path=(os.path.join(log_dir, "metrics.jsonl")
                    if log_dir and is_master() else None),
        remote=remote)
    if restore_s is not None and msg_logger.jsonl is not None:
        msg_logger.jsonl.write("resume", state.step, {"seconds": restore_s})
    if corpus is not None and msg_logger.jsonl is not None:
        msg_logger.jsonl.write("corpus", state.step, {"upload_s": corpus.upload_s,
                                                      "mib": corpus.nbytes / 2 ** 20})
    val_loader = (_val_loader_factory(opt, log) if val_freq and is_master()
                  else None)
    uploader = (None if loader is None
                else BatchUploader(device, loader.dataset.frame_stacks))
    prefetch_iter = [0]

    def put(b):
        """In the prefetch thread: the stage's subsample of the host batch
        (only its rows cross to the device), then the upload. With online
        distillation the dataset's targets stay on the host."""
        prefetch_iter[0] += 1
        if target_fn is not None:
            b = {k: v for k, v in b.items() if k != "gt"}
        if prog is not None:
            mb, _, _ = prog.at(prefetch_iter[0])
            bsz = leaves(b["lq"])[0].shape[0]
            if mb < bsz:
                idx = prefetch_rng.choice(bsz, size=mb, replace=False)
                b = {**b, "lq": subsample_batch(b["lq"], idx),
                     "gt": subsample_batch(b.get("gt"), idx)}
        arrays = {k: v for k, v in b.items() if isinstance(v, (np.ndarray, dict))}
        rest = {k: v for k, v in b.items() if k not in arrays}
        return uploader.upload(arrays), rest, prefetch_rng.bit_generator.state

    watchdog = None
    stall_s = opt["train"].get("stall_timeout_s")
    if stall_s:
        from ..utils.watchdog import StallWatchdog

        watchdog = StallWatchdog(float(stall_s)).start()

    current_iter = state.step
    last_saved = None

    def save():
        t0 = time.perf_counter()
        host_state = host_rng.bit_generator.state if corpus is None else epoch_state
        whole = trainer.whole_state(state)  # on shards: gathered on every rank
        save_checkpoint(states_dir, current_iter, whole, epoch, loop={
            "epoch_iter": epoch_iter, "host_rng": host_state,
            "prefetch_rng": prefetch_state})
        save_weights(models_dir, current_iter, whole.model, whole.ema)
        if msg_logger.jsonl is not None:
            msg_logger.jsonl.write("ckpt", current_iter,
                                   {"seconds": time.perf_counter() - t0})
        return whole

    def host_batch(item):
        """The loader's batch, cut to the stage's on the host."""
        nonlocal prefetch_state
        pending, rest, prefetch_state = item
        batch = {**uploader.ready(pending), **rest}
        lq, gt = batch["lq"], batch.get("gt")
        extra_prob, mini_gt = 0.0, 0
        if prog is not None:
            mb, mini_gt, mini_prob = prog.at(current_iter)
            bsz = leaves(lq)[0].shape[0]
            if mb < bsz:
                idx = host_rng.choice(bsz, size=mb, replace=False)
                lq = subsample_batch(lq, idx)
                gt = subsample_batch(gt, idx)
            extra_prob = max(mini_prob - prog.base_prob, 0.0)
        return lq, gt, extra_prob, mini_gt, None

    def device_batch(ids):
        """The corpus's batch at the stage's size, cut on the device (a
        crop of a crop is a crop: no stage crop follows)."""
        gen = seeded_generator(device, seed, current_iter)
        extra_prob, patch = 0.0, corpus.gt_size
        if prog is not None:
            mb, patch, mini_prob = prog.at(current_iter)
            ids = ids[:min(mb * n_dp, len(ids))]
            extra_prob = max(mini_prob - prog.base_prob, 0.0)
        k = len(ids) // n_dp  # this rank's rows of the global sample
        rows = slice(dp_index * k, (dp_index + 1) * k) if n_dp > 1 else None
        lq, gt = corpus.sample_batch(gen, ids, gt_size=patch, rows=rows)
        return lq, gt, extra_prob, 0, gen

    def epoch_batches():
        nonlocal epoch_state
        if corpus is None:
            loader.set_epoch(epoch, skip=epoch_iter)
            prefetch_iter[0] = current_iter  # re-sync the stage counter
            return DevicePrefetcher(iter(loader), put=put), host_batch
        corpus.set_epoch(epoch)
        epoch_state = host_rng.bit_generator.state
        perm = host_rng.permutation(len(corpus))  # in batches, the remainder dropped
        chunk = bspg * n_dp  # the global batch's ids, the same on every rank
        starts = range(epoch_iter * chunk, len(perm) - chunk + 1, chunk)
        return (perm[s:s + chunk] for s in starts), device_batch

    profile_dir = (os.path.join(log_dir, "profile")
                   if profile_steps and log_dir and is_master() else None)
    profile_from = current_iter + PROFILE_AFTER
    profiling = contextlib.ExitStack()

    t_data = time.time()
    try:
        while current_iter < total_iters:
            batches, prepare = epoch_batches()
            try:
                for item in batches:
                    current_iter += 1
                    epoch_iter += 1
                    if profile_dir and current_iter == profile_from + 1:
                        profiling.enter_context(trace(profile_dir))
                    lq, gt, extra_prob, mini_gt, gen = prepare(item)
                    data_time = time.time() - t_data
                    if target_fn is not None:  # after the subsample
                        gt = online_targets(target_fn, lq)
                    state, metrics = trainer.step(
                        state, lq, gt, np.random.default_rng([seed, current_iter]),
                        extra_prob=extra_prob, mini_gt_size=mini_gt, gen=gen)
                    if profile_dir and current_iter == profile_from + profile_steps:
                        float(metrics["l_pix"])  # the device's queue drains first
                        profiling.close()
                        _log_profile(log_dir, profile_steps, current_iter, msg_logger, log)
                        profile_dir = None

                    scalars = None
                    if current_iter % print_freq == 0:
                        # reading the loss waits for the step: iter_time
                        # then holds its device time
                        scalars = {k: float(v) for k, v in metrics.items()}
                    iter_time = time.time() - t_data
                    if watchdog is not None:
                        watchdog.beat()
                    if scalars is not None:
                        msg_logger(epoch, current_iter, scalars, iter_time,
                                   data_time)
                    saved = None
                    if ckpt_freq and current_iter % ckpt_freq == 0 and states_dir:
                        saved = save()
                        last_saved = current_iter
                        log(f"saved checkpoint @ {current_iter}")
                        keep = int(logger_cfg.get("keep_checkpoints", 0) or 0)
                        gone = keep and is_master() and prune_checkpoints(
                            states_dir, models_dir, keep)
                        if gone:
                            log(f"rotated {len(gone)} old checkpoints")
                    validating = val_freq and current_iter % val_freq == 0
                    if validating:  # on shards every rank gathers the whole model, once
                        net, ema = ((saved.model, saved.ema) if saved is not None
                                    else trainer.whole_modules(state))
                    if val_loader is not None and validating:
                        # rank 0 alone; the reference validates the EMA net
                        # when there is one (image_restoration_model.py:242-245)
                        t0 = time.perf_counter()
                        scores = validate_model(ema or net,
                                                val_loader(), opt)
                        val_s = time.perf_counter() - t0
                        if not scores:
                            log(f"validation @ {current_iter}: SKIPPED "
                                "(val loader yielded 0 items)")
                        else:
                            if msg_logger.jsonl is not None:
                                msg_logger.jsonl.write("val", current_iter, scores,
                                                       seconds=val_s)
                            if remote is not None:
                                remote.log({f"metrics/{k}": v
                                            for k, v in scores.items()},
                                           step=current_iter)
                            log(f"validation @ {current_iter}: " + ", ".join(
                                f"{k}={v:.4f}" for k, v in scores.items()))
                    if validating:
                        del net, ema, saved
                        barrier()  # the other ranks wait for the validation
                        if watchdog is not None:  # validation is a legitimate gap
                            watchdog.beat()
                    if current_iter >= total_iters:
                        break
                    # data_time counts the wait for the next batch only,
                    # not this iteration's checkpoint or validation
                    t_data = time.time()
            finally:
                batches.close()
            if epoch_iter >= n_batches:  # the epoch ran to its end
                epoch += 1
                epoch_iter = 0
    finally:
        profiling.close()  # a run that ends inside the profile's window
        if watchdog is not None:
            watchdog.stop()
        msg_logger.close()

    if states_dir and last_saved != current_iter:
        save()
    log(f"training done @ {current_iter}")
    if remote is not None:
        remote.finish()
    return state
