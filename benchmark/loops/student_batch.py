"""Temporal denoising of frame stacks: each item is one
``StudentPredictor.denoise_batch`` call on ``batch`` stacks of ``frames``
uint8 frames (the pool's batches, in a seeded order drawn anew each pass).
A unit is a frame.

Traffic keys: ``frame`` [h, w], ``frames``, ``batch``, ``pool_batches``,
``check_stacks``, ``warmup``, ``trace_items``. The check compares each
sampled output stack with the reference's:
  differ   the largest share, over the sampled stacks, of pixels that
           differ from the reference at all.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import seeds, sonar
from ..core.loop import Loop as Base
from ..core.loop import port
from ..core.seeds import Reservoir
from ..families import kdlae_student as family
from ..reference import serving
from ..reference.ops import Ops


class Loop(Base):
    def setup(self) -> None:
        cfg, tr = self.config, self.traffic
        if cfg["family"] != "kdlae_student":
            raise ValueError(f"student_batch serves kdlae_student, not {cfg['family']}")
        self.net = cfg["network"]
        self.frames_n, self.multiple_of = int(tr["frames"]), int(cfg["serving"]["multiple_of"])
        self.params = family.init_params(self.net, self.seed, self.device)
        infer = port("eval.infer")
        self.pred = infer.StudentPredictor(
            family.program_model(self.net, self.params), multiple_of=self.multiple_of,
            num_frames=self.frames_n, dtype=torch.float32, device=self.device)
        h, w = tr["frame"]
        b, nb = int(tr["batch"]), int(tr["pool_batches"])
        gen = seeds.generator(self.device, self.seed, seeds.INPUTS)
        pool = sonar.stacks(b * nb, self.frames_n, h, w, gen).cpu().numpy()
        self.batches = [np.ascontiguousarray(pool[i * b:(i + 1) * b]) for i in range(nb)]
        self.order = seeds.np_rng(self.seed, seeds.ORDER)
        self.sample = Reservoir(int(tr["check_stacks"]), seeds.np_rng(self.seed, seeds.SAMPLE))
        self._queue: list[int] = []
        self._offering = False
        for _ in range(int(tr["warmup"])):
            self.item()
        self.finish()
        self.attempted = self.failed = 0
        self._offering = True

    def item(self) -> int:
        if not self._queue:
            self._queue = [int(i) for i in self.order.permutation(len(self.batches))]
        k = self._queue.pop()
        stacks = self.batches[k]
        out = self.pred.denoise_batch(stacks)
        n = stacks.shape[0] * stacks.shape[1]
        self.attempted += n
        if out.shape != stacks.shape:
            self.failed += n
        elif self._offering:
            for j in range(stacks.shape[0]):
                slot = self.sample.slot()
                if slot is not None:
                    self.sample.put(slot, ((k, j), out[j].copy()))
        return n

    def flops_per_unit(self) -> float:
        h, w = self.traffic["frame"]
        m = self.multiple_of
        return family.flops_per_stack(self.net, self.frames_n, -(-h // m) * m,
                                      -(-w // m) * m) / self.frames_n

    def release(self) -> None:
        del self.pred
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _compare(self, outputs) -> dict[str, float]:
        differ = 0.0
        for _, got, want in outputs:
            if got.shape != want.shape:
                return {"differ": 1.0}
            differ = max(differ, float((serving.level_gaps(got, want) > 0).mean()))
        return {"differ": differ}

    def _reference(self, ops: Ops | None, tf32: bool = False):
        items = sorted(self.sample.items, key=lambda it: it[0])
        keys = [key for key, _ in items]
        stacks = np.stack([self.batches[k][j] for k, j in keys])
        ref = []
        for s in range(0, len(stacks), 6):
            ref.extend(serving.student_stacks(self.params, self.net, stacks[s:s + 6],
                                              self.multiple_of, self.device, ops, tf32))
        return items, ref

    def check(self) -> dict[str, float]:
        if not self.sample.items:
            return {"differ": 1.0}
        items, ref = self._reference(None)
        return self._compare([(key, got, want) for (key, got), want in zip(items, ref)])

    def control(self) -> dict[str, float]:
        """The reference in the configuration's control precision in the
        program's place, against the float32 reference."""
        items, ref = self._reference(None)
        _, low = self._reference(Ops(self.config["control"]))
        return self._compare([(key, got, want) for (key, _), got, want in zip(items, low, ref)])

    def control_cudnn_tf32(self) -> dict[str, float]:
        """The reference with cuDNN's and cuBLAS's own TF32 on."""
        items, ref = self._reference(None)
        _, low = self._reference(None, tf32=True)
        return self._compare([(key, got, want) for (key, _), got, want in zip(items, low, ref)])
