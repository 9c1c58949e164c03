"""Write the JAX training state that the PyTorch port resumes without JAX:
``artifacts/kdlaes_jax_state/``.

    python scripts/export_jax_training_state.py [--out DIR]

Runs on the CPU and imports the JAX package (its training loop and its
orbax checkpoints). Writes into ``DIR`` (``artifacts/kdlaes_jax_state`` by
default):

  frames/{lq,gt}/<i>_frame.png   a seeded synthetic sonar corpus: 14
                                 numbered 128x128 uint8 gray frames (8
                                 groups of 7), noisy and clear
  KDLAES_jax_state.yml           configs/KDLAES.yml at full width with the
                                 dataroots above (repo-relative), one
                                 patch size (128, the frame), batches of 4,
                                 mixup off, no extra mask, no warm-up (its
                                 1000 steps would hold the rate near 0 over
                                 these steps), no validation
  training_states/ckpt_4/        the JAX loop's state after 4 iterations
                                 from its own seeded init: params,
                                 opt_state (clip_by_global_norm(0.01) +
                                 adamw, KDLAES.yml's), step, epoch
  jax_resumed.json               the JAX loop resumed from that directory
                                 to iteration 6: l_pix, lr and grad_norm
                                 per iteration, and the sha256 of each
                                 final parameter (float32, reference
                                 layout)

Under these settings the JAX step key draws nothing (mixup off, one patch
size, extra-mask probability 0), so the port's resume of the same directory
is comparable step for step. ``tests/test_torch_jax_state.py`` and
``chip_smoke.py`` phase 21 read the directory.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT = os.path.join("artifacts", "kdlaes_jax_state")
YML = "KDLAES_jax_state.yml"
FRAMES, SIDE, SEED = 14, 128, 21
SAVED, RESUMED = 4, 6  # the committed state's iteration; the resume's end


def write_frames(root: str) -> None:
    """FRAMES numbered gray frames: a fan of speckle over a black border
    (clear) and the same with noise (noisy), uint8."""
    from rethink_acoustic_image_enhancement_tpu.utils.image_io import imwrite

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:SIDE, 0:SIDE]
    fan = (np.abs(xx - SIDE / 2) < (yy + 1) * 0.7).astype(np.float32)
    for i in range(FRAMES):
        clear = fan * (0.2 + 0.6 * rng.random((SIDE, SIDE)))
        noisy = np.clip(clear + rng.normal(0, 0.08, clear.shape), 0, 1)
        imwrite(os.path.join(root, "lq", f"{i}_frame.png"), noisy)
        imwrite(os.path.join(root, "gt", f"{i}_frame.png"), clear)


def config(frames: str) -> dict:
    """configs/KDLAES.yml cut as the module docstring says; ``frames`` is
    the corpus root as the yml names it."""
    with open(os.path.join(REPO, "configs", "KDLAES.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["name"] = "KDLAES_jax_state"
    ds = cfg["datasets"]["train"]
    ds.update(dataroot_lq=f"{frames}/lq", dataroot_gt=f"{frames}/gt",
              batch_size_per_gpu=4, mini_batch_sizes=[4], iters=[RESUMED],
              gt_size=SIDE, gt_sizes=[SIDE], prob=0, probs=[0.0], num_worker_per_gpu=2)
    del cfg["datasets"]["val"]
    cfg["train"].update(total_iter=RESUMED, warmup_iter=-1, mixing_augs={"mixup": False})
    cfg["val"]["val_freq"] = 0
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=SAVED, use_tb_logger=False)
    return cfg


def run_jax(cfg: dict, root: str, total: int, states: str | None = None) -> dict:
    """The JAX loop on ``cfg`` to ``total`` in ``root`` (its training_states
    seeded with a copy of ``states`` where given); returns its parsed opt."""
    from rethink_acoustic_image_enhancement_tpu.train import config as jcfg
    from rethink_acoustic_image_enhancement_tpu.train import loop as jloop

    cfg = {**cfg, "train": {**cfg["train"], "total_iter": total}}
    os.makedirs(root, exist_ok=True)
    yml = os.path.join(root, "opt.yml")
    with open(yml, "w") as fh:
        yaml.safe_dump(cfg, fh)
    opt = jcfg.parse(yml, True, root_path=root)
    if states is not None:
        shutil.copytree(states, os.path.join(opt["path"]["training_states"],
                                             os.path.basename(states)))
    jloop.train_from_config(opt)
    return opt


def train_records(opt: dict) -> list[dict]:
    with open(os.path.join(opt["path"]["log"], "metrics.jsonl")) as fh:
        return [{k: r[k] for k in ("iter", "l_pix", "lr", "grad_norm")}
                for r in map(json.loads, fh) if r["kind"] == "train"]


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from rethink_acoustic_image_enhancement_tpu.convert.torch_export import export_student
    from rethink_acoustic_image_enhancement_tpu.train.checkpoints import load_weights

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, OUT))
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    shutil.rmtree(out, ignore_errors=True)
    write_frames(os.path.join(out, "frames"))
    rel = os.path.relpath(os.path.join(out, "frames"), REPO)
    with open(os.path.join(out, YML), "w") as fh:
        yaml.safe_dump(config(rel), fh)

    cfg = config(os.path.join(out, "frames"))
    with tempfile.TemporaryDirectory(prefix="raie_jax_state_") as work:
        saved = run_jax(cfg, os.path.join(work, "saved"), SAVED)
        state = os.path.join(saved["path"]["training_states"], f"ckpt_{SAVED}")
        shutil.copytree(state, os.path.join(out, "training_states", f"ckpt_{SAVED}"))
        resumed = run_jax(cfg, os.path.join(work, "resumed"), RESUMED,
                          states=os.path.join(out, "training_states", f"ckpt_{SAVED}"))
        records = train_records(resumed)
        assert [r["iter"] for r in records] == list(range(SAVED + 1, RESUMED + 1)), records
        final = export_student(jax.tree_util.tree_map(np.asarray, load_weights(
            os.path.join(resumed["path"]["models"], f"net_g_{RESUMED}"))))
    digest = {k: hashlib.sha256(np.ascontiguousarray(v, np.float32).tobytes()).hexdigest()
              for k, v in sorted(final.items())}
    with open(os.path.join(out, "jax_resumed.json"), "w") as fh:
        json.dump({"config": YML, "state": f"training_states/ckpt_{SAVED}",
                   "resumed_to": RESUMED, "train": records, "final_sha256": digest},
                  fh, indent=1, sort_keys=True)
        fh.write("\n")
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"{out}: {size / 1e6:.2f} MB; resumed {SAVED} -> {RESUMED}: {records}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
