"""Seeded sonar-like training corpora and narrow configs for the port's
training tests (no JAX here: the card's tests import this too)."""

import json
import os

import numpy as np
import yaml

from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KDLAET_YML = os.path.join(REPO, "configs", "KDLAET.yml")

# the narrow teacher of the training tests (full width: dim 48, [4,6,6,8], 4)
NARROW = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
          "heads": [1, 2, 4, 8]}


def _frame(rng, h, w):
    """A fan of speckled returns over a black border, in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w]
    fan = (np.abs(xx - w / 2) < (yy + 1) * 0.7).astype(np.float32)
    img = fan[..., None] * (0.3 + 0.5 * rng.random((h, w, 3)))
    return img.astype(np.float32)


def write_teacher_corpus(root, n, h, w, seed, rates=True):
    """n noisy / clear / 2x SR triples (and per-image JSON rates) under
    ``root``; returns the four dataroots."""
    rng = np.random.default_rng(seed)
    roots = {k: os.path.join(root, k) for k in ("lq", "gt", "sr", "param")}
    for d in roots.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        clear = _frame(rng, h, w)
        noisy = np.clip(clear + rng.normal(0, 0.08, clear.shape), 0, 1)
        sr = np.repeat(np.repeat(clear, 2, 0), 2, 1)
        name = f"{i:04d}.png"
        imwrite(os.path.join(roots["lq"], name), noisy)
        imwrite(os.path.join(roots["gt"], name), clear)
        imwrite(os.path.join(roots["sr"], name), sr)
        with open(os.path.join(roots["param"], f"{i:04d}.json"), "w") as f:
            json.dump({"denoise_rate": round(float(rng.uniform(0.3, 1.0)), 3)
                       if rates else None}, f)
    return {f"dataroot_{k}": v for k, v in roots.items()}


def write_paired_corpus(root, n, h, w, seed):
    """n lq / gt pairs for Dataset_PairedImage; returns the two dataroots."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in ("lq", "gt"):
        out[f"dataroot_{k}"] = os.path.join(root, k)
        os.makedirs(out[f"dataroot_{k}"], exist_ok=True)
    for i in range(n):
        gt = _frame(rng, h, w)
        lq = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1)
        if i == 0:
            lq[:] = 0  # a degenerate input: the dataset adds rescue noise
        imwrite(os.path.join(out["dataroot_lq"], f"{i:04d}.png"), lq)
        imwrite(os.path.join(out["dataroot_gt"], f"{i:04d}.png"), gt)
    return out


def teacher_config(train_roots, val_roots, network=NARROW, **train_ds):
    """configs/KDLAET.yml with the dataroots replaced, a narrower network
    and the given training-set options; no TensorBoard writer."""
    with open(KDLAET_YML) as f:
        cfg = yaml.safe_load(f)
    cfg["datasets"]["train"].update(train_roots, **train_ds)
    if val_roots is None:
        del cfg["datasets"]["val"]
    else:
        cfg["datasets"]["val"].update(val_roots)
    cfg["network_g"].update(network)
    cfg["logger"]["use_tb_logger"] = False
    return cfg


def write_yml(cfg, path):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _gray_frame(rng, h, w, blank=False):
    """A grayscale fan of speckle in [0, 1]; all zeros when ``blank``."""
    if blank:
        return np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    fan = (np.abs(xx - w / 2) < (yy + 1) * 0.7).astype(np.float32)
    return (fan * (0.2 + 0.6 * rng.random((h, w)))).astype(np.float32)


def write_student_corpus(root, n, h, w, seed, blank=()):
    """n numbered gray frames (noisy lq, teacher-like gt) for
    Dataset_PairedMutiImage; every fourth frame 2 x 4 pixels smaller, so
    that groups are centre-padded; the frames in ``blank`` all zeros.
    Returns the two dataroots."""
    rng = np.random.default_rng(seed)
    roots = {k: os.path.join(root, k) for k in ("lq", "gt")}
    for d in roots.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        hh, ww = (h - 2, w - 4) if i % 4 == 3 else (h, w)
        clear = _gray_frame(rng, hh, ww, blank=i in blank)
        noisy = np.clip(clear + rng.normal(0, 0.08, clear.shape), 0, 1)
        if i in blank:
            noisy[:] = 0
        imwrite(os.path.join(roots["lq"], f"{i}_frame.png"), noisy)
        imwrite(os.path.join(roots["gt"], f"{i}_frame.png"), clear)
    return {f"dataroot_{k}": v for k, v in roots.items()}


def write_siqa_corpus(root, n, h, w, seed):
    """n lq / candidate / JSON-score triples for Dataset_S_IQA: the
    candidate mixes the noisy image with its clear version at a known rate,
    and the score is that rate. Returns the three dataroots."""
    rng = np.random.default_rng(seed)
    roots = {k: os.path.join(root, k) for k in ("lq", "gt", "param")}
    for d in roots.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        clear = _frame(rng, h, w)
        noisy = np.clip(clear + rng.normal(0, 0.15, clear.shape), 0, 1)
        rate = round(float(rng.uniform(0, 1)), 3)
        imwrite(os.path.join(roots["lq"], f"{i:04d}.png"), noisy)
        imwrite(os.path.join(roots["gt"], f"{i:04d}.png"),
                (1 - rate) * noisy + rate * clear)
        with open(os.path.join(roots["param"], f"{i:04d}.json"), "w") as f:
            json.dump({"score": rate}, f)
    return {f"dataroot_{k}": v for k, v in roots.items()}


def device_student_config(roots, total, iters=(2, 3), **train_ds):
    """configs/KDLAES.yml, device-resident, narrowed: hidden [4, 8, 16],
    3-frame stacks, batch 2 at 12 then 16 px, no validation."""
    with open(os.path.join(REPO, "configs", "KDLAES.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["datasets"]["train"].update(
        roots, num_pairs=3, batch_size_per_gpu=2, mini_batch_sizes=[2, 1],
        iters=list(iters), gt_size=16, gt_sizes=[12, 16], probs=[0.1, 0.3],
        num_worker_per_gpu=2, device_resident=True, **train_ds)
    del cfg["datasets"]["val"]
    cfg["network_g"]["hidden_channels"] = [4, 8, 16]
    cfg["train"].update(total_iter=total, warmup_iter=-1)
    cfg["val"]["val_freq"] = 0
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=total, use_tb_logger=False)
    return cfg
