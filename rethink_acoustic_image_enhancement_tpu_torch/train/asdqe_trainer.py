"""The ASDQE scorer's trainer (the JAX package's ``train/asdqe_trainer.py``;
the reference's Train/ASDQE.py, which ships broken: it imports a missing
``S_IQA_model`` module).

Kept from the reference: Dataset_S_IQA triples, the 80/20 split, Adam at lr
1e-3, MSE on the score, ReduceLROnPlateau, gradient accumulation over 32
micro-steps, best and per-epoch weights. As in the JAX package:
  * ``compute_dtype=bfloat16`` plays autocast's part with float32
    parameters and optimizer state (no GradScaler: bf16 has fp32's range),
    and the model rematerialises its blocks in the backward pass;
  * ``MultiStepsAdam`` is ``optax.MultiSteps(optax.adam(lr), k)``: the
    gradients' running mean over k micro-steps, one Adam step on the k-th;
    the BatchNorm statistics update on every micro-step, and a partial
    accumulation carries across epochs;
  * the plateau scale multiplies the Adam update;
  * images cross to the device as uint8 and are divided in float32 before
    any cast to the compute dtype;
  * dropout draws from a ``torch.Generator`` seeded by ``seed``.

``device_resident=True`` trains from ``SIQADeviceCorpus`` (graded
candidates mixed on the device from (origin, denoised) source pairs; a
micro-step uploads its source ids only), with the JAX package's 80/20 split
of the sources, ``steps_per_epoch`` micro-steps an epoch (by default
``accumulation_steps``: one update), and a held-out set whose ids and draws
are fixed, so that every epoch scores the same candidates.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..data.datasets import SIQADataset
from ..data.loader import BatchLoader, BatchUploader, EnlargedShuffleSampler
from ..eval.infer import highest_precision, resolve_device
from ..models import DenoiseRatePredictor
from .checkpoints import save_weights
from .device_corpus import SIQADeviceCorpus, seeded_generator

EPOCH_SEED_STRIDE = 7919  # an epoch's train ids: default_rng(seed + this * (epoch + 1))
VAL_CANDIDATES_PER_SOURCE = 13  # the held-out batches: this many per source


class ReduceLROnPlateau:
    """Host-side plateau rate controller (torch's semantics: factor,
    patience, a floor); ``scale`` multiplies the optimizer's update."""

    def __init__(self, factor: float = 0.5, patience: int = 5,
                 min_scale: float = 1e-3):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_scale
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-8:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale


class MultiStepsAdam:
    """``optax.MultiSteps(optax.adam(lr), every_k_schedule=k)`` over
    ``params``: each micro-step folds its gradients into their running mean
    (Welford, as optax); the k-th runs Adam on the mean, scaled by the
    plateau's ``lr_scale``, and clears it. Between updates the parameters
    do not change."""

    def __init__(self, params, lr: float, every_k: int):
        self.params = list(params)
        self.lr = lr
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def update(self, grads, lr_scale: float = 1.0) -> bool:
        """Fold in one micro-step's gradients; True where Adam stepped."""
        n = self.mini_step
        delta = torch._foreach_sub(list(grads), self.acc)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(self.acc, delta)
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step != 0:
            return False
        for p, g in zip(self.params, self.acc):
            p.grad = g
        self.adam.param_groups[0]["lr"] = self.lr * lr_scale
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.acc = [torch.zeros_like(p) for p in self.params]
        return True


def to_model_input(t: torch.Tensor, compute_dtype: torch.dtype | None) -> torch.Tensor:
    """The uint8 boundary: divide in float32 first, then cast (a direct
    bf16 divide would move inputs by an ulp)."""
    if t.dtype == torch.uint8:
        t = t.float() / 255.0
    return t if compute_dtype is None else t.to(compute_dtype)


def asdqe_micro_step(model: DenoiseRatePredictor, opt: MultiStepsAdam,
                     lq: torch.Tensor, gt: torch.Tensor, score: torch.Tensor,
                     lr_scale: float = 1.0,
                     compute_dtype: torch.dtype | None = torch.bfloat16) -> torch.Tensor:
    """One accumulation micro-step (the JAX package's
    ``make_asdqe_train_step``): MSE of the score with BatchNorm in training
    mode (its statistics updated) and dropout on; returns the loss, a 0-d
    tensor on the device."""
    model.train()
    with highest_precision():
        out = model(to_model_input(lq, compute_dtype), to_model_input(gt, compute_dtype))
        loss = torch.mean(torch.square(out.reshape(-1).float() - score))
        grads = torch.autograd.grad(loss, opt.params)
    opt.update(grads, lr_scale)
    return loss.detach()


def asdqe_predict(model: DenoiseRatePredictor, lq: torch.Tensor,
                  gt: torch.Tensor) -> torch.Tensor:
    """Eval-mode scores (running statistics, no dropout), (B,)."""
    model.eval()
    with torch.no_grad(), highest_precision():
        return model(to_model_input(lq, None), to_model_input(gt, None)).reshape(-1)


def _host_mean(values: list[torch.Tensor]) -> float:
    """The float64 mean of float32 losses (one host sync an epoch); NaN for
    none."""
    if not values:
        return float("nan")
    return float(np.mean(torch.stack(values).cpu().numpy().astype(np.float64)))


class _Subset:
    def __init__(self, base, idx):
        self.base, self.idx = base, idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.base[int(self.idx[i])]

    def set_epoch(self, e):
        self.base.set_epoch(e)


def _device_batches(loader: BatchLoader, uploader: BatchUploader,
                    h2d_uint8: bool) -> Iterator[tuple]:
    """One-slot upload prefetch: batch k+1 is packed and copied on the
    uploader's stream while batch k computes. Yields (lq, gt, score) on the
    device, NCHW."""
    def ship(a):
        a = np.asarray(a)
        return np.rint(a * 255.0).astype(np.uint8) if h2d_uint8 else a

    def up(b):
        return uploader.upload({"lq": ship(b["lq"]["img"]), "gt": ship(b["gt"]["hq"]),
                                "score": np.asarray(b["lq"]["score"], np.float32)})

    with ThreadPoolExecutor(max_workers=1) as ex:
        it = iter(loader)
        nxt = next(it, None)
        fut = None if nxt is None else ex.submit(up, nxt)
        while fut is not None:
            cur = uploader.ready(fut.result())
            nxt = next(it, None)
            fut = None if nxt is None else ex.submit(up, nxt)
            yield cur["lq"], cur["gt"], cur["score"]


def train_asdqe(
    dataset_opt: dict,
    lr: float = 1e-3,
    epochs: int = 10,
    batch_size: int = 1,
    accumulation_steps: int = 32,
    gt_size: int | None = 256,
    seed: int = 0,
    out_dir: str | None = None,
    compute_dtype: torch.dtype | None = torch.bfloat16,
    log: Callable[[str], None] = print,
    max_steps_per_epoch: int | None = None,
    h2d_uint8: bool = True,
    device_resident: bool = False,
    steps_per_epoch: int | None = None,
    tracker=None,
    device=None,
    model: DenoiseRatePredictor | None = None,
) -> dict[str, Any]:
    """Train the scorer; returns {'model', 'history'}. ``model`` gives the
    starting weights (a scorer with PyTorch's default initialisation under
    ``seed`` where None); ``device`` None is the GPU, and raises where there
    is none. ``device_resident`` trains from the device corpus (module
    docstring), ``steps_per_epoch`` sizing its epoch; ``tracker`` receives
    per-epoch metrics (the reference's swanlab logging)."""
    device = resolve_device(device)
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = DenoiseRatePredictor()
    model = model.to(device).float().set_remat(True).set_compute_dtype(compute_dtype)
    model.set_dropout_generator(torch.Generator(device=device).manual_seed(seed))
    if device_resident:
        return _train_asdqe_device_resident(
            model, dataset_opt, lr=lr, epochs=epochs, batch_size=batch_size,
            accumulation_steps=accumulation_steps, gt_size=gt_size, seed=seed,
            out_dir=out_dir, compute_dtype=compute_dtype, log=log,
            steps_per_epoch=steps_per_epoch, tracker=tracker)

    dataset = SIQADataset(dict(dataset_opt, phase="train", gt_size=gt_size, seed=seed))
    n = len(dataset)
    perm = np.random.default_rng(seed).permutation(n)
    train_idx, val_idx = perm[: int(0.8 * n)], perm[int(0.8 * n):]
    opt = MultiStepsAdam(model.parameters(), lr, accumulation_steps)
    plateau = ReduceLROnPlateau()
    uploader = BatchUploader(device, dataset.frame_stacks)

    history = []
    best_val = float("inf")
    for epoch in range(epochs):
        train_loader = BatchLoader(
            _Subset(dataset, train_idx), batch_size,
            EnlargedShuffleSampler(len(train_idx), seed=seed + epoch),
            num_workers=2, drop_last=True)
        train_loader.set_epoch(epoch)
        losses = []
        for k, (lq, gt, score) in enumerate(_device_batches(train_loader, uploader,
                                                            h2d_uint8)):
            if max_steps_per_epoch and k >= max_steps_per_epoch:
                break
            losses.append(asdqe_micro_step(model, opt, lq, gt, score,
                                           plateau.scale, compute_dtype))

        val_losses = []
        val_loader = BatchLoader(
            _Subset(dataset, val_idx), batch_size,
            EnlargedShuffleSampler(len(val_idx), shuffle=False),
            num_workers=2, drop_last=False)
        for k, (lq, gt, score) in enumerate(_device_batches(val_loader, uploader,
                                                            h2d_uint8)):
            if max_steps_per_epoch and k >= max_steps_per_epoch:
                break
            pred = asdqe_predict(model, lq, gt)
            val_losses.append(torch.mean(torch.square(pred.float() - score)))
        best_val = _end_epoch(epoch, losses, val_losses, plateau, history, best_val,
                              model, out_dir, log, tracker)

    if tracker is not None:
        tracker.finish()
    return {"model": model, "history": history}


def _end_epoch(epoch: int, losses, val_losses, plateau: ReduceLROnPlateau,
               history: list, best_val: float, model, out_dir, log, tracker) -> float:
    """The epoch's means, the plateau step, the log and tracker lines and
    the weights (per epoch, and the best); returns the best val MSE."""
    train_l, val_l = _host_mean(losses), _host_mean(val_losses)
    plateau.step(val_l)
    history.append({"epoch": epoch, "train_mse": train_l,
                    "val_mse": val_l, "lr_scale": plateau.scale})
    log(f"[asdqe] epoch {epoch}: train_mse={train_l:.5f} "
        f"val_mse={val_l:.5f} lr_scale={plateau.scale:.3f}")
    if tracker is not None:
        tracker.log({"train_epoch_mse": train_l, "val_epoch_mse": val_l,
                     "lr_scale": plateau.scale, "epoch": epoch}, step=epoch)
    if out_dir:
        save_weights(out_dir, epoch, model)
        if val_l < best_val:
            best_val = val_l
            save_weights(out_dir, "best", model)
    return best_val


def device_resident_split(n_src: int, seed: int, batch_size: int,
                          log: Callable[[str], None] = print):
    """(train sources, held-out sources, the held-out batches' ids): the
    JAX package's source-level 80/20 split, at least one source on each
    side (with one source the two overlap, and a warning says so), and
    ``max(1, 13 * held-out // batch_size)`` batches of ids from
    ``default_rng(seed + 1 + b)``."""
    split = np.random.default_rng(seed).permutation(n_src)
    n_train = max(1, int(0.8 * n_src))
    train_src = split[:n_train]
    val_src = split[n_train:] if n_train < n_src else split[-1:]
    if n_train >= n_src:
        log(f"[asdqe] WARNING: corpus has only {n_src} source pair(s); the val "
            "source OVERLAPS train: val_mse measures training fit, not "
            "generalization")
    n_val = max(1, (len(val_src) * VAL_CANDIDATES_PER_SOURCE) // batch_size)
    val_ids = [np.random.default_rng(seed + 1 + b).choice(val_src, size=batch_size)
               for b in range(n_val)]
    return train_src, val_src, val_ids


def _train_asdqe_device_resident(model: DenoiseRatePredictor, dataset_opt: dict, lr: float,
                                 epochs: int, batch_size: int, accumulation_steps: int,
                                 gt_size: int | None, seed: int, out_dir: str | None,
                                 compute_dtype, log, steps_per_epoch: int | None,
                                 tracker) -> dict[str, Any]:
    """The JAX package's ``_train_asdqe_device_resident`` on the scorer's
    device: an epoch's ids from ``default_rng(seed + 7919 (epoch + 1))``,
    its candidates' draws from a generator seeded by (seed, 1, epoch), the
    held-out draws once from one seeded by (seed, 2)."""
    device = next(model.parameters()).device
    corpus = SIQADeviceCorpus(dict(dataset_opt, gt_size=gt_size, phase="train"), device)
    log(f"[asdqe] device-resident corpus: {corpus.describe()}")
    train_src, _, val_ids = device_resident_split(len(corpus), seed, batch_size, log)
    spe = int(steps_per_epoch or accumulation_steps)
    opt = MultiStepsAdam(model.parameters(), lr, accumulation_steps)
    plateau = ReduceLROnPlateau()
    val_gen = seeded_generator(device, seed, 2)
    held_out = []
    for ids in val_ids:
        ids = corpus.ids(ids)
        held_out.append((ids, corpus.draw(val_gen, ids, gt_size)))

    history = []
    best_val = float("inf")
    for epoch in range(epochs):
        host_rng = np.random.default_rng(seed + EPOCH_SEED_STRIDE * (epoch + 1))
        gen = seeded_generator(device, seed, 1, epoch)
        losses = []
        for _ in range(spe):
            lq, cand, score = corpus.sample_batch(
                gen, host_rng.choice(train_src, size=batch_size), gt_size)
            losses.append(asdqe_micro_step(model, opt, lq, cand, score,
                                           plateau.scale, compute_dtype))
        val_losses = []
        for ids, draws in held_out:
            lq, cand, score = corpus.apply(ids, draws)
            pred = asdqe_predict(model, lq, cand)
            val_losses.append(torch.mean(torch.square(pred.float() - score)))
        best_val = _end_epoch(epoch, losses, val_losses, plateau, history, best_val,
                              model, out_dir, log, tracker)

    if tracker is not None:
        tracker.finish()
    return {"model": model, "history": history}
