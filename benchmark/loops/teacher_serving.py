"""What the teacher's serving mixes share: the predictor built from the
seeded weights, a pool of synthetic sonar frames drawn from the seed, a
sample of the outputs the window wrote, and their check against the plain
reference.

Traffic keys: ``frame`` [h, w], ``pool`` (distinct frames), ``check_frames``
(outputs sampled for the check), ``warmup`` (items before the window),
``trace_items``. The check compares each sampled output, hq and the 2x sr,
with the reference's output for the same frame:
  off1     the largest share, over the sampled outputs, of pixels inside
           the fan (where the input is not 0) more than 1 level from the
           reference;
  outside  the pixels outside the fan that are not 0 (the zero mask).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import seeds, sonar
from ..core.loop import Loop, port
from ..core.seeds import Reservoir
from ..families import kdlae_teacher as family
from ..reference import serving
from ..reference.ops import Ops


class TeacherServing(Loop):
    def setup(self) -> None:
        cfg, tr = self.config, self.traffic
        if cfg["family"] != "kdlae_teacher":
            raise ValueError(f"{tr['loop']} serves kdlae_teacher, not {cfg['family']}")
        self.net, srv = cfg["network"], cfg["serving"]
        self.rate = float(srv["denoise_rate"])
        self.multiple_of = int(srv["multiple_of"])
        self.params = family.init_params(self.net, self.seed, self.device, cfg["dtype"])
        infer = port("eval.infer")
        self.pred = infer.TeacherPredictor(
            family.program_model(self.net, self.params), multiple_of=self.multiple_of,
            dtype=family.DTYPES[cfg["dtype"]], fused=bool(srv["fused"]),
            fused_resample=bool(srv["fused_resample"]), device=self.device)
        h, w = tr["frame"]
        gen = seeds.generator(self.device, self.seed, seeds.INPUTS)
        self.frames = sonar.frames_rgb(int(tr["pool"]), h, w, gen).cpu().numpy()
        self.order = seeds.np_rng(self.seed, seeds.ORDER)
        self.sample = Reservoir(int(tr["check_frames"]), seeds.np_rng(self.seed, seeds.SAMPLE))
        self._offering = False
        for _ in range(int(tr["warmup"])):
            self.item()
        self.finish()
        self.attempted = self.failed = 0
        self._offering = True

    def offer(self, frame_index: int, out: dict) -> None:
        """An output the program wrote for pool frame ``frame_index``."""
        if self._offering:
            self.sample.offer((frame_index, out))

    def flops_per_unit(self) -> float:
        h, w = self.traffic["frame"]
        m = self.multiple_of
        return family.flops_per_frame(self.net, -(-h // m) * m, -(-w // m) * m)

    def span_hooks(self) -> list:
        return family.stage_spans(self.pred.model)

    def release(self) -> None:
        del self.pred
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _compare(self, outputs) -> dict[str, float]:
        """The numbers of the module docstring for (frame index, {'hq', 'sr'})
        pairs."""
        p = {k: v.float() for k, v in self.params.items()}
        refs, off1, outside = {}, 0.0, 0
        for idx, out in outputs:
            frame = self.frames[idx]
            if idx not in refs:
                refs[idx] = serving.teacher_frame(p, self.net, frame, self.rate,
                                                  self.multiple_of, self.device)
            zero = np.all(frame == 0, axis=-1)
            for key, s in (("hq", 1), ("sr", 2)):
                want = refs[idx][0 if key == "hq" else 1]
                got = out.get(key)
                if want is None and got is None:
                    continue
                if got is None or want is None or got.shape != want.shape:
                    off1 = 1.0
                    continue
                z = np.repeat(np.repeat(zero, s, 0), s, 1)
                off1 = max(off1, float((serving.level_gaps(got, want, ~z) > 1).mean()))
                outside += int(np.count_nonzero(got[z]))
        return {"off1": off1, "outside": outside}

    def check(self) -> dict[str, float]:
        if not self.sample.items:
            return {"off1": 1.0, "outside": 0}
        return self._compare(self.sample.items)

    def control(self) -> dict[str, float]:
        """The reference in the configuration's control precision, put in
        the program's place on the same sampled frames."""
        p = {k: v.float() for k, v in self.params.items()}
        ops = Ops(self.config["control"])
        outs = []
        for idx in sorted({i for i, _ in self.sample.items}):
            hq, sr = serving.teacher_frame(p, self.net, self.frames[idx], self.rate,
                                           self.multiple_of, self.device, ops)
            outs.append((idx, {"hq": hq, "sr": sr}))
        return self._compare(outs)
