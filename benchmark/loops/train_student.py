"""Distilling the student: each item is one ``Trainer.step`` on a batch the
device-resident corpus (``train/device_corpus.py``) cuts, as
``train/loop.py`` drives it. A unit is a step.

Set-up writes the seeded corpus (noisy sonar frames and their smoothed
targets, uint8 PNGs in a temporary folder that the run removes), builds
the trainer from the configuration's ``train`` section and its state from
the seeded weights, and runs the first three steps through ``item``; the
window goes on with the same state. Once the window has closed, the state
it left (parameters, AdamW's moments and count) is copied and two more
steps run through ``item``. The check follows the first three steps with
the reference from the seeded weights, and the two late ones from the
copied state (the program's own: the reference can only follow the window's
tens of steps from there), on the same frames with the same draws:
  loss     the largest relative gap of a first step's loss;
  grad     the first step's gradient as AdamW got it (its first moment over
           1 - beta1), worst leaf: the gap between the program's norm and
           the reference's, over the reference's norm or the median leaf's,
           whichever is larger;
  change   the same of each leaf's change over the three steps;
  late_loss, late_grad, late_change   the same of the two late steps (the
           gradient AdamW got at the first of them: its first moment's
           change over 1 - beta1).
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of a change (round-off alone moves them under Adam); which
they are, with their gradient's norm, goes to standard error.

Traffic keys: ``frame`` [h, w], ``corpus_frames``, ``batch_size_per_gpu``,
``first_iteration`` (the curriculum stage, read off the configuration's
``datasets_train``), ``warmup`` (the first steps checked), ``late`` (the
steps checked after the window), ``trace_items``."""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import tempfile

import numpy as np
import torch

from ..core import seeds, sonar
from ..core.loop import Loop as Base
from ..core.loop import port
from ..families import kdlae_student as family
from ..reference import train as ref_train
from ..reference.ops import Ops


def _stage(ds: dict, iteration: int) -> tuple[int, int, float]:
    """(mini batch, patch, extra mask prob) of the curriculum at
    ``iteration`` (train.py:374-448)."""
    ends = np.cumsum(ds["iters"])
    j = np.nonzero(iteration <= ends)[0]
    s = int(j[0]) if len(j) else len(ends) - 1
    return (int(ds["mini_batch_sizes"][s]), int(ds["gt_sizes"][s]),
            max(float(ds["probs"][s]) - float(ds["prob"]), 0.0))


def leaf_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf's |norm(got) - norm(want)| over max(norm(want), the
    median leaf's norm(want)), over the leaves ``keep`` names."""
    wn = {k: float(want[k].norm()) for k in keep}
    floor = statistics.median(wn.values())
    return max(abs(float(got[k].norm()) - wn[k]) / max(wn[k], floor, 1e-30) for k in keep)


class Loop(Base):
    def setup(self) -> None:
        cfg, tr = self.config, self.traffic
        if cfg["family"] != "kdlae_student":
            raise ValueError(f"train_student trains kdlae_student, not {cfg['family']}")
        import cv2

        self.net, ds = cfg["network"], cfg["datasets_train"]
        self.first = int(tr["first_iteration"])
        self.bspg = int(tr["batch_size_per_gpu"])
        self.mb, self.patch, self.extra = _stage(ds, self.first)
        h, w = tr["frame"]
        gen = seeds.generator(self.device, self.seed, seeds.INPUTS)
        lq = sonar.stacks(1, int(tr["corpus_frames"]), h, w, gen)[0]
        gt = torch.round(sonar.smooth(lq).clamp(0, 255)).to(torch.uint8)
        self.lq_u8, self.gt_u8 = lq.cpu().numpy(), gt.cpu().numpy()
        self.tmp = tempfile.mkdtemp(prefix="kdlaes_corpus_")
        for sub, planes in (("lq", self.lq_u8), ("gt", self.gt_u8)):
            os.makedirs(os.path.join(self.tmp, sub))
            for i, plane in enumerate(planes):
                cv2.imwrite(os.path.join(self.tmp, sub, f"{i}_frame.png"), plane)
        ds_opt = {"type": "Dataset_PairedMutiImage", "phase": "train",
                  "dataroot_lq": os.path.join(self.tmp, "lq"),
                  "dataroot_gt": os.path.join(self.tmp, "gt"),
                  "num_pairs": ds["num_pairs"], "stride_range": ds["stride_range"],
                  "filename_tmpl": "{}", "io_backend": {"type": "disk"},
                  "gt_size": self.patch, "prob": ds["prob"],
                  "geometric_augs": ds["geometric_augs"], "batch_size_per_gpu": self.bspg}
        self.corpus = port("train.device_corpus").build_device_corpus(ds_opt, self.device)
        self.params0 = family.init_params(self.net, self.seed, self.device)
        trainer_mod = port("train.trainer")
        opt = {"train": cfg["train"], "datasets": {"train": ds_opt}, "scale": 1}
        self.trainer = trainer_mod.build_trainer_from_config(
            opt, family.program_model(self.net, {k: v.clone() for k, v in self.params0.items()}),
            port("losses").build_loss(cfg["train"]["pixel_opt"]), device=self.device)
        self.state = self.trainer.init_state()
        self.state.step = self.first - 1
        self.iteration = self.first - 1
        self.host_rng = seeds.np_rng(self.seed, seeds.ORDER)
        self._ids: list = []
        self.start = self._checked(int(tr["warmup"]))
        self.start["from"] = {"params": self.params0, "m": None, "v": None, "t": 0}
        self.finish()
        self.attempted = self.failed = 0

    def _moments(self):
        """AdamW's first and second moments by parameter name (zeros where
        no update ran) and its update count."""
        state = self.state.optimizer.state
        m, v, t = {}, {}, 0
        for n, p in self.state.model.named_parameters():
            st = state.get(p, {})
            m[n] = st["exp_avg"].detach().clone() if "exp_avg" in st else torch.zeros_like(p)
            v[n] = st["exp_avg_sq"].detach().clone() if "exp_avg_sq" in st else torch.zeros_like(p)
            t = max(t, int(st["step"])) if "step" in st else t
        return m, v, t

    def _checked(self, n: int) -> dict:
        """Run ``n`` steps through ``item`` and keep what the check reads:
        each step's iteration, groups and loss, the gradient AdamW got at
        the first (its first moment's change over 1 - beta1), and the
        parameters after the last."""
        b1 = self.trainer.optimizer.betas[0]
        m0 = self._moments()[0]
        steps, losses, grad = [], [], None
        for k in range(n):
            self.item()
            steps.append(self._last[:2])
            losses.append(self._last[2])
            if k == 0:
                m1 = self._moments()[0]
                grad = {k2: (m1[k2] - b1 * m0[k2]) / (1 - b1) for k2 in m1}
        params = {k2: p.detach().clone() for k2, p in self.state.model.named_parameters()}
        return {"steps": steps, "losses": losses, "grad": grad, "params": params}

    def after_window(self) -> None:
        self.finish()
        attempted = self.attempted
        m, v, t = self._moments()
        params = {k: p.detach().clone() for k, p in self.state.model.named_parameters()}
        self.late = self._checked(int(self.traffic["late"]))
        self.late["from"] = {"params": params, "m": m, "v": v, "t": t}
        self.finish()
        self.attempted = attempted

    def _next_ids(self) -> np.ndarray:
        """The loop's route: each epoch a permutation of the groups, in
        chunks of ``batch_size_per_gpu``, the remainder dropped, cut to the
        stage's mini batch."""
        if not self._ids:
            perm = self.host_rng.permutation(len(self.corpus))
            self._ids = [perm[s:s + self.bspg]
                         for s in range(0, len(perm) - self.bspg + 1, self.bspg)]
        return self._ids.pop(0)[:self.mb]

    def item(self) -> int:
        self.iteration += 1
        ids = self._next_ids()
        gen = seeds.generator(self.device, self.seed, seeds.STEP, self.iteration)
        lq, gt = self.corpus.sample_batch(gen, ids, gt_size=self.patch)
        self.state, metrics = self.trainer.step(
            self.state, lq, gt, seeds.np_rng(self.seed, seeds.STEP, self.iteration),
            extra_prob=self.extra, mini_gt_size=0, gen=gen)
        self._last = (self.iteration, ids, metrics["l_pix"])
        self.attempted += 1
        return 1

    def flops_per_unit(self) -> float:
        return family.flops_per_step(self.net, min(self.mb, self.bspg),
                                     int(self.config["datasets_train"]["num_pairs"]), self.patch,
                                     self.config["train"]["pixel_opt"])

    def release(self) -> None:
        del self.trainer, self.state, self.corpus
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, run: dict, ops: Ops | None = None, tf32: bool = False):
        """The reference's (losses, first gradient, parameters after) over
        the steps of ``run`` (the first or the late), from its start."""
        cfg, ds = self.config, self.config["datasets_train"]
        tcfg = cfg["train"]
        lq = torch.from_numpy(self.lq_u8).to(self.device).float() / 255.0
        gt = torch.from_numpy(self.gt_u8).to(self.device).float() / 255.0
        mix = tcfg["mixing_augs"]
        batches, lrs = [], []
        for it, ids in run["steps"]:
            gen = seeds.generator(self.device, self.seed, seeds.STEP, it)
            x, y = ref_train.sample(lq, gt, torch.as_tensor(ids), gen, self.patch,
                                    int(ds["num_pairs"]), float(ds["prob"]),
                                    bool(ds["geometric_augs"]))
            x = ref_train.extra_mask(x, gen, self.extra)
            if mix["mixup"]:
                y, x = ref_train.mixup(seeds.np_rng(self.seed, seeds.STEP, it), y, x,
                                       float(mix["mixup_beta"]), bool(mix["use_identity"]))
            batches.append((x, y))
            sch = tcfg["scheduler"]
            lrs.append(ref_train.cosine_restart_lr(
                it - 1, float(tcfg["optim_g"]["lr"]), sch["periods"], sch["restart_weights"],
                sch["eta_mins"], int(tcfg["warmup_iter"])))
        po = tcfg["pixel_opt"]
        opt = {"betas": tuple(tcfg["optim_g"]["betas"]),
               "weight_decay": float(tcfg["optim_g"]["weight_decay"]),
               "clip": 0.01 if tcfg["use_grad_clip"] else None,
               "l1loss_weight": float(po["l1loss_weight"]),
               "temporal_weight": float(po["temporal_weight"])}
        start = run["from"]
        moments = None if start["m"] is None else (start["m"], start["v"], start["t"])
        return ref_train.train_steps(start["params"], self.net, batches, lrs, opt, ops, tf32,
                                     moments)

    def _compare(self, run: dict, got, ref, prefix: str = "") -> dict[str, float]:
        """The numbers of the module docstring for ``run`` from ``got``'s
        (losses, first gradient, parameters after) against ``ref``'s."""
        (losses, first_grad, params), (r_losses, r_grad, r_params) = got, ref
        p0 = run["from"]["params"]
        loss = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        names = list(r_grad)
        grad = leaf_gap(first_grad, r_grad, names)
        gnorm = {k: float(r_grad[k].norm()) for k in names}
        floor = 1e-3 * statistics.median(gnorm.values())
        moved = [k for k in names if gnorm[k] >= floor]
        for k in names:
            if k not in moved:
                print(f"{prefix}change leaves out {k}: reference gradient norm {gnorm[k]!r} "
                      f"under {floor!r}", file=sys.stderr)
        change = leaf_gap({k: params[k] - p0[k] for k in moved},
                          {k: r_params[k] - p0[k] for k in moved}, moved)
        return {f"{prefix}loss": loss, f"{prefix}grad": grad, f"{prefix}change": change}

    def _program(self, run: dict):
        return [float(v) for v in run["losses"]], run["grad"], run["params"]

    def check(self) -> dict[str, float]:
        return {**self._compare(self.start, self._program(self.start),
                                self._reference(self.start)),
                **self._compare(self.late, self._program(self.late),
                                self._reference(self.late), "late_")}

    def _lower(self, **kw) -> dict[str, float]:
        """A lower-precision reference in the program's place, against the
        float32 reference."""
        return {**self._compare(self.start, self._reference(self.start, **kw),
                                self._reference(self.start)),
                **self._compare(self.late, self._reference(self.late, **kw),
                                self._reference(self.late), "late_")}

    def control(self) -> dict[str, float]:
        """The reference with TF32 (emulated: 'tf32' operand rounding), put
        in the program's place, against the float32 reference."""
        return self._lower(ops=Ops(self.config["control"]))

    def control_cudnn_tf32(self) -> dict[str, float]:
        """The reference with cuDNN's and cuBLAS's own TF32 on."""
        return self._lower(tf32=True)
