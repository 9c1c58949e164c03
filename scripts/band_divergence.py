#!/usr/bin/env python3
"""Where the trained bf16 KDLAE-T teacher on row bands departs from one
device, layer by layer, on one NVIDIA GPU (every band on cuda:0).

    python3 scripts/band_divergence.py

The teacher of ``artifacts/torch_zoo/teacher.pth`` in bfloat16 with fused
stages (the serving configuration of ``chip_smoke.py`` phase 16 (b)) takes
one seeded 512^2 sonar frame (``chip_smoke.sonar_frame``, seed 30, denoise
rate 0.8). Four measurements:

1. end to end: ``TeacherPredictor`` on one device against itself called
   again, and its model on the predictor's own input (an NHWC upload seen
   as NCHW) and on a contiguous copy of it, whole and through
   ``models/bands.py::teacher_bands`` on 1, 2 and 4 bands: the share of
   'hq' and 'sr' pixels within 1 level and the share equal (uint8, as the
   predictor rounds and masks);
2. layer by layer: every layer ``KDLAETeacher.wire`` runs, each fed one
   device's own input, through ``models/bands.py::layer_bands`` on 1, 2 and
   4 bands, and through the layer itself again, against one device's
   output: the share of elements that differ and the largest difference;
3. inside the first eager stage (blocks the gate refuses) that differs on 2
   bands and not on 1: every step of its first block (LayerNorms, the five convs, the
   MDTA and the GDFN), each fed one device's input, on 2 bands;
4. for every step of 3 that differs: the same comparison with cuDNN off
   (PyTorch's own convolution, both sides), and in float32 with TF32 off.

One JSON object to ``chiprun_out/band_divergence.json``; a summary on
stdout with the card's name and power limit.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
TEACHER_PTH = os.path.join(HERE, "artifacts", "torch_zoo", "teacher.pth")
DEVICE = "cuda:0"
SIZE, SEED, RATE = 512, 30, 0.8


def sonar_frame(h, w, seed):
    """chip_smoke.py's frame: uint8 speckle with a fan of exact zeros."""
    rng = np.random.default_rng(seed)
    img = (rng.gamma(2.0, 40.0, size=(h, w, 1)).clip(1, 255)
           * np.ones((1, 1, 3))).astype(np.uint8)
    img = np.maximum(img, 1)
    yy, xx = np.mgrid[0:h, 0:w]
    angle = np.abs(np.arctan2(xx - w / 2, yy + 1.0))
    img[(angle > 0.75) | (np.hypot(xx - w / 2, yy) > 0.95 * h)] = 0
    return img


def differ(got, ref) -> dict:
    """Share of elements that differ, and the largest difference over
    max|ref|."""
    d = (got.float() - ref.float()).abs()
    return dict(share_differing=(d > 0).float().mean().item(),
                max_rel=(d.max() / ref.float().abs().max().clamp_min(1e-30)).item())


def levels(got, ref) -> dict:
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return dict(within_1_level=float((d <= 1).mean()), equal=float((d == 0).mean()),
                max_levels=int(d.max()))


def main() -> int:
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import flagship_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.models.bands import (
        conv_bands,
        gdfn_bands,
        layer_bands,
        mdta_bands,
        teacher_bands,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.models.kdlae_teacher import (
        TransformerStage,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.mesh import make_mesh
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import (
        LocalBands,
        join_rows,
        split_rows,
    )

    if not torch.cuda.is_available():
        print("band_divergence: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    teacher = load_pth(flagship_teacher(static="train"), TEACHER_PTH).to(torch.bfloat16)
    img = sonar_frame(SIZE, SIZE, SEED)
    one = TeacherPredictor(teacher, fused=True, dtype=torch.bfloat16, device=DEVICE)
    out = {"card": card, "size": SIZE, "seed": SEED, "rate": RATE}

    # 1. end to end
    ref = one(img, RATE)
    again = one(img, RATE)
    e2e = out["end_to_end"] = {"one_device_again": {k: levels(again[k], ref[k])
                                                    for k in ("hq", "sr")}}
    split = TeacherPredictor(teacher, fused=True, dtype=torch.bfloat16,
                             mesh=make_mesh(n_spatial=2, devices=[DEVICE] * 2))
    got = split(img, RATE)
    e2e["predictor_2_bands"] = {k: levels(got[k], ref[k]) for k in ("hq", "sr")}
    del split
    model = one.model
    x = (torch.from_numpy(img).to(DEVICE)[None].float() / 255.0).to(torch.bfloat16)
    x = x.permute(0, 3, 1, 2)  # the predictor's input: an NHWC upload seen as NCHW
    plane = torch.full((1, 1, SIZE, SIZE), RATE, dtype=torch.bfloat16, device=DEVICE)

    zero = torch.from_numpy(np.all(img == 0, axis=-1)).to(DEVICE)

    def ubyte(t):
        """uint8 as the predictor rounds, 0 where the input is 0 (its mask)."""
        t = torch.round(t.clamp(0.0, 1.0).float() * 255.0).to(torch.uint8)
        f = t.shape[-1] // SIZE
        return t.masked_fill(zero.repeat_interleave(f, 0).repeat_interleave(f, 1), 0).cpu().numpy()

    with torch.inference_mode():
        whole = {}
        for layout, xin in (("nhwc_view", x), ("contiguous", x.contiguous())):
            whole[layout] = model({"img": xin, "denoise_rate": plane})
            for n in (1, 2, 4):
                bands = LocalBands([DEVICE] * n)
                got = teacher_bands([model] * n, split_rows(xin, bands.devices, dim=2),
                                    split_rows(plane, bands.devices, dim=2), bands)
                e2e[f"{layout}_{n}_bands"] = {
                    k: levels(ubyte(join_rows(got[k], DEVICE, dim=2)), ubyte(whole[layout][k]))
                    for k in ("hq", "sr")}
        e2e["model_is_the_predictor"] = {k: levels(ubyte(whole["nhwc_view"][k])[0].transpose(
            1, 2, 0), ref[k]) for k in ("hq", "sr")}
        e2e["contiguous_against_nhwc_view"] = {
            k: levels(ubyte(whole["contiguous"][k]), ubyte(whole["nhwc_view"][k]))
            for k in ("hq", "sr")}
    for key, val in e2e.items():
        print(f"end to end, {key}: hq {val['hq']}, sr {val['sr']} [{card}]")

    # 2. layer by layer, each layer fed one device's input
    model = one.model
    seen = {}

    def hook(name):
        def fn(mod, inputs, output):
            seen[name] = (inputs[0].clone(), output.clone())
        return fn

    names = [n for n, _ in model.named_children()]
    handles = [getattr(model, n).register_forward_hook(hook(n)) for n in names]
    one(img, RATE)
    for h in handles:
        h.remove()
    order = [n for n in seen]  # the order forward ran them
    out["layers"] = []
    first_eager = None  # the first eager stage that differs on 2 bands, not on 1
    with torch.inference_mode():
        for name in order:
            x, y = seen[name]
            mod = getattr(model, name)
            row = {"layer": name, "shape": list(x.shape), "type": type(mod).__name__}
            if isinstance(mod, TransformerStage):
                b, _, h, w = x.shape
                row["stage_kernel"] = bool(mod.fused and stage_gate.stage_worthwhile(
                    b, h, w, mod.dim, mod.num_heads, mod.bias_free_ln, mod.use_bias,
                    mod.ffn_expansion_factor))
            row["again"] = differ(mod(x), y)
            for n in (1, 2, 4):
                bands = LocalBands([DEVICE] * n)
                got = join_rows(layer_bands([mod] * n, split_rows(x, bands.devices, dim=2),
                                            bands), DEVICE, dim=2)
                row[f"bands_{n}"] = differ(got, y)
            out["layers"].append(row)
            if (first_eager is None and row.get("stage_kernel") is False
                    and row["bands_2"]["max_rel"] > 0 and row["bands_1"]["max_rel"] == 0):
                first_eager = name
            print(f"layer {name} {row['type']} {tuple(x.shape)}"
                  + (f" kernel={row['stage_kernel']}" if "stage_kernel" in row else "")
                  + f"; again: {row['again']['share_differing']:.4f} differ"
                  + "".join(f"; {n} bands: {row[f'bands_{n}']['share_differing']:.4f} "
                            f"differ, max rel {row[f'bands_{n}']['max_rel']:.2e}"
                            for n in (1, 2, 4)) + f" [{card}]")

        # 3./4. the steps of that stage's first block, on 2 bands
        out["block_steps"] = {"stage": first_eager, "steps": []}
        if first_eager is not None:
            blk = getattr(model, first_eager)[0]
            steps = {"norm1": blk.norm1, "attn.qkv": blk.attn.qkv,
                     "attn.qkv_dwconv": blk.attn.qkv_dwconv, "attn": blk.attn,
                     "attn.project_out": blk.attn.project_out, "norm2": blk.norm2,
                     "ffn.project_in": blk.ffn.project_in, "ffn.dwconv": blk.ffn.dwconv,
                     "ffn": blk.ffn, "ffn.project_out": blk.ffn.project_out}
            x0 = _stage_input(model, first_eager, one, img)
            seen.clear()
            handles = [m.register_forward_hook(hook(k)) for k, m in steps.items()]
            blk(x0)
            for h in handles:
                h.remove()

            def band_step(key, mod, x, bands):
                xs = split_rows(x, bands.devices, dim=2)
                if key == "attn":
                    ys = mdta_bands([mod] * bands.n, xs, bands)
                elif key == "ffn":
                    ys = gdfn_bands([mod] * bands.n, xs, bands)
                elif key.startswith("norm"):
                    ys = [mod(xb) for xb in xs]
                else:
                    ys = conv_bands([mod] * bands.n, xs, bands)
                return join_rows(ys, DEVICE, dim=2)

            bands = LocalBands([DEVICE] * 2)
            for key, mod in steps.items():
                x, y = seen[key]
                row = {"step": key, "shape": list(x.shape), "bf16": differ(
                    band_step(key, mod, x, bands), y)}
                if row["bf16"]["share_differing"] > 0:
                    torch.backends.cudnn.enabled = False
                    try:
                        row["bf16_cudnn_off"] = differ(band_step(key, mod, x, bands), mod(x))
                    finally:
                        torch.backends.cudnn.enabled = True
                    m32 = copy.deepcopy(mod).float()
                    tf32 = (torch.backends.cudnn.allow_tf32,
                            torch.backends.cuda.matmul.allow_tf32)
                    torch.backends.cudnn.allow_tf32 = False
                    torch.backends.cuda.matmul.allow_tf32 = False
                    try:
                        row["fp32"] = differ(band_step(key, m32, x.float(), bands),
                                             m32(x.float()))
                    finally:
                        (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32) = tf32
                out["block_steps"]["steps"].append(row)
                print(f"{first_eager}[0].{key} {tuple(x.shape)} on 2 bands: "
                      + ", ".join(f"{k} {v['share_differing']:.4f} differ (max rel "
                                  f"{v['max_rel']:.2e})" for k, v in row.items()
                                  if isinstance(v, dict)) + f" [{card}]")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "band_divergence.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"card: {card}")
    return 0


def _stage_input(model, name, pred, img):
    """One device's input of stage ``name`` (a forward hook's capture)."""
    got = {}
    h = getattr(model, name).register_forward_hook(
        lambda m, inputs, output: got.setdefault("x", inputs[0].clone()))
    pred(img, RATE)
    h.remove()
    return got["x"]


if __name__ == "__main__":
    sys.exit(main())
