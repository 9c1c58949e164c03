"""The trained bf16 teacher through the stage, in the JAX package and in the
port, on the CPU: where the two bf16 paths (whole stages that hand over in
float32, and eager bf16 blocks) part from each other and from float32.

    python scripts/trained_stage_witness.py [--size 256] [--out FILE]

Loads ``kdlaet_full50k`` twice: the JAX package's orbax copy (bf16 as
stored) and the port's ``artifacts/torch_zoo/teacher.pth``. On two sonar
frames of ``chip_smoke.py`` (``sonar_frame(size, size, 81)`` at rate 1.0,
seed 82 at rate 0.6) it runs, each with bf16 weights and ``dtype=bf16``:

  * the JAX predictor with ``fused=True`` (the Pallas stage in interpret
    mode) and with ``fused=False`` (eager bf16 blocks), against the JAX
    predictor in float32: the share of ``hq`` / ``sr`` values more than one
    level apart;
  * the port's ``TeacherPredictor(fused=True)`` on the CPU (the stage's
    plain version), against the same.

At ``size`` = 256 the stages run at half the side they have in a 512^2
request, so both stage gates are relaxed to admit the stages that a 512^2
request sends through the stage kernel (96 channels, at least 128^2
pixels); that is the only change, made by patching the gate functions in
this process.

It also captures ``encoder_level2``'s input (6 blocks, 96 channels, 2
heads) and runs that stage four ways: the JAX Pallas stage, the JAX eager
blocks in bf16 and in float32, and the port's plain stage. Differences are
reported as max |a - b| / max |b|, apart for the stage pixels whose input
pixels all lie in the frame's zero mask (outside the fan, where the
predictor writes 0) and for the rest.

Prints one JSON object; imports the JAX package, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FRAMES = [(81, 1.0), (82, 0.6)]


def _over_1_level(a, b):
    return float((np.abs(a.astype(np.int16) - b.astype(np.int16)) > 1).mean())


def _rel(a, b, where):
    d = np.abs(a.astype(np.float32) - b.astype(np.float32))
    return float(d[where].max() / np.abs(b.astype(np.float32)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax
    import jax.numpy as jnp
    import torch
    import yaml

    from chip_smoke import sonar_frame
    from rethink_acoustic_image_enhancement_tpu.eval.infer import (
        TeacherPredictor as JaxPredictor,
    )
    from rethink_acoustic_image_enhancement_tpu.models import (
        build_network as jax_build_network,
    )
    from rethink_acoustic_image_enhancement_tpu.models.blocks import (
        TransformerBlock as JaxBlock,
    )
    from rethink_acoustic_image_enhancement_tpu.ops.pallas import stage as jstage
    from rethink_acoustic_image_enhancement_tpu.train.checkpoints import load_weights
    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import build_network
    from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import flax_block_tree
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

    torch.set_num_threads(4)
    zoo = os.path.join(REPO, "artifacts", "kdlaet_full50k")
    with open(os.path.join(zoo, "config.yml")) as f:
        cfg = yaml.safe_load(f)["network_g"]
    p16 = jax.tree_util.tree_map(
        np.asarray, load_weights(os.path.join(zoo, "weights", "net_g_50000_bf16")))
    p32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p16)

    if args.size != 512:  # admit the stages of a 512^2 request at this size
        min_px = (args.size // 4) ** 2

        def gate(batch, h, w, c, num_heads, bias_free, use_bias, expansion=2.66):
            return bias_free and not use_bias and c == 96 and h * w >= min_px

        jstage.stage_worthwhile = gate
        stage_gate.stage_worthwhile = gate

    model = build_network(cfg)
    load_pth(model, os.path.join(REPO, "artifacts", "torch_zoo", "teacher.pth"))
    model16 = model.to(torch.bfloat16)
    jpreds = {
        "jax_fp32": JaxPredictor(params=p32, model=jax_build_network(cfg)),
        "jax_fused": JaxPredictor(params=p16, model=jax_build_network(cfg),
                                  dtype=jnp.bfloat16, fused=True),
        "jax_unfused": JaxPredictor(params=p16, model=jax_build_network(cfg),
                                    dtype=jnp.bfloat16),
    }
    port = TeacherPredictor(model16, fused=True, dtype=torch.bfloat16, device="cpu")

    captured = []
    hook = dict(port.model.named_modules())["encoder_level2"].register_forward_pre_hook(
        lambda mod, a: captured.append(a[0]) or None)
    outputs = []
    for seed, rate in FRAMES:
        img = sonar_frame(args.size, args.size, seed)
        outs = {k: p(img, rate) for k, p in jpreds.items()}
        outs["port_fused"] = port(img, rate)
        hook.remove()
        row = dict(seed=seed, rate=rate)
        for key in ("hq", "sr"):
            ref = outs["jax_fp32"][key]
            row[key] = dict(
                jax_fused_vs_unfused_within_1_level=1 - _over_1_level(
                    outs["jax_fused"][key], outs["jax_unfused"][key]),
                jax_fused_vs_fp32_over_1_level=_over_1_level(outs["jax_fused"][key], ref),
                jax_unfused_vs_fp32_over_1_level=_over_1_level(outs["jax_unfused"][key], ref),
                port_fused_vs_fp32_over_1_level=_over_1_level(outs["port_fused"][key], ref),
                port_fused_vs_jax_fused_within_1_level=1 - _over_1_level(
                    outs["port_fused"][key], outs["jax_fused"][key]))
        outputs.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)

    # encoder_level2 on the first frame's captured input, four ways
    x = captured[0]  # (1, 96, S/2, S/2) bf16
    mod = dict(port.model.named_modules())["encoder_level2"]
    x16 = x.permute(0, 2, 3, 1).contiguous()
    xj16 = jnp.asarray(x16.float().numpy(), jnp.bfloat16)
    xj32 = jnp.asarray(x16.float().numpy())
    blocks16 = [p16["encoder_level2"][str(i)] for i in range(len(mod))]
    blocks32 = [p32["encoder_level2"][str(i)] for i in range(len(mod))]
    blk = JaxBlock(dim=mod.dim, num_heads=mod.num_heads,
                   ffn_expansion_factor=mod.ffn_expansion_factor,
                   use_bias=mod.use_bias, bias_free_ln=mod.bias_free_ln)

    def eager(y, params):
        for p in params:
            y = blk.apply({"params": p}, y)
        return np.asarray(y.astype(jnp.float32))

    with torch.no_grad():
        port_plain = pstage.stage_plain(
            x16, **pstage.stack_block_params([flax_block_tree(b) for b in mod]))
    stage = {
        "jax_pallas": np.asarray(jstage.fused_transformer_stage(
            xj16, **jstage.stack_block_params(blocks16), interpret=True).astype(jnp.float32)),
        "jax_eager_bf16": eager(xj16, blocks16),
        "jax_eager_fp32": eager(xj32, blocks32),
        "port_plain": port_plain.float().numpy(),
    }
    img = sonar_frame(args.size, args.size, FRAMES[0][0])
    f = args.size // x.shape[2]
    zero = np.all(img == 0, axis=-1).reshape(x.shape[2], f, x.shape[3], f).all(axis=(1, 3))
    outside = np.broadcast_to(zero[None, :, :, None], stage["jax_pallas"].shape)
    pairs = [("jax_pallas", "jax_eager_fp32"), ("jax_eager_bf16", "jax_eager_fp32"),
             ("port_plain", "jax_eager_fp32"), ("port_plain", "jax_pallas")]
    enc2 = dict(shape=list(x16.shape), outside_fan_share=float(zero.mean()))
    for a, b in pairs:
        enc2[f"{a}_vs_{b}"] = dict(inside_fan_rel=_rel(stage[a], stage[b], ~outside),
                                   outside_fan_rel=_rel(stage[a], stage[b], outside))

    result = dict(script="scripts/trained_stage_witness.py", size=args.size,
                  frames=outputs, encoder_level2=enc2)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
