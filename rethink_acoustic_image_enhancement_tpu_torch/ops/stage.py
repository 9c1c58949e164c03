"""Transformer stage: N consecutive BiasFree TransformerBlocks in one call.

``fused_transformer_stage`` keeps the JAX signature and layouts
(``ops/pallas/stage.py:234-250``): x is NHWC (float32 or bfloat16), the
weights are stacked with a leading ``n_blocks`` dim in the flax layouts
  ln1_w/ln2_w (N, C); w_qkv (N, 1, 1, C, 3C); dw_qkv (N, 3, 3, 1, 3C);
  temperature (N, heads, 1, 1) or (N, heads); w_proj (N, 1, 1, C, C);
  w_in (N, 1, 1, C, 2F); w_dw (N, 3, 3, 1, 2F); w_out (N, 1, 1, F, C).
Samples are independent (per-sample MDTA statistics).

On a CUDA tensor it runs the Hopper kernels of ``csrc/stage.cu`` (three
launches per block through ``ops/block.py::BlockRunner``, see the note
there) on x's device, whose weights must lie there too, and counts the
call in ``fused_transformer_stage.launches``; on a CPU tensor it runs
``stage_plain``, the same arithmetic in plain PyTorch: bf16 operands with
float32 accumulation for the five products, the qkv and W_in outputs
rounded to bf16 before their float32 depthwise 3x3, two-pass LayerNorm and
exact-erf GELU (the kernel's Abramowitz-Stegun erf is within 1.5e-7).
Blocks hand their output to the next in float32; only the stage's output
is cast to x's dtype (the TPU kernel stored every block's output in x's
dtype).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .block import BlockRunner, block_f32, pack_blocks
from .gdfn import check_input


def stack_block_params(params_list) -> dict[str, torch.Tensor]:
    """Stack TransformerBlock parameter trees (flax layout: norm1/attn/
    norm2/ffn) into the stage's stacked-weight arguments."""

    def stk(path):
        vals = []
        for p in params_list:
            node = p
            for key in path:
                node = node[key]
            vals.append(node if isinstance(node, torch.Tensor)
                        else torch.from_numpy(np.array(node)))
        return torch.stack(vals)

    return dict(
        ln1_w=stk(("norm1", "weight")),
        w_qkv=stk(("attn", "qkv", "kernel")),
        dw_qkv=stk(("attn", "qkv_dwconv", "kernel")),
        temperature=stk(("attn", "temperature")),
        w_proj=stk(("attn", "project_out", "kernel")),
        ln2_w=stk(("norm2", "weight")),
        w_in=stk(("ffn", "project_in", "kernel")),
        w_dw=stk(("ffn", "dwconv", "kernel")),
        w_out=stk(("ffn", "project_out", "kernel")),
    )


# ------------------------------------------------------------- plain ----

def stage_plain(x, ln1_w, w_qkv, dw_qkv, temperature, w_proj, ln2_w, w_in,
                w_dw, w_out, ln_eps: float = 1e-5) -> torch.Tensor:
    """The stage in plain PyTorch (the kernel's arithmetic)."""
    n = ln1_w.shape[0]
    c = x.shape[-1]
    temp = temperature.float().reshape(n, -1)
    if c % temp.shape[1]:
        raise ValueError(f"{temp.shape[1]} heads do not divide {c} channels")
    y = x
    for i in range(n):  # blocks hand over in float32
        y = block_f32(
            y, ln1_w[i].float(), None, w_qkv[i].reshape(c, 3 * c).float(),
            dw_qkv[i].reshape(3, 3, 3 * c).float(), temp[i],
            w_proj[i].reshape(c, c).float(), ln2_w[i].float(), None,
            w_in[i].reshape(c, -1).float(),
            w_dw[i].reshape(3, 3, -1).float(),
            w_out[i].reshape(-1, c).float(), ln_eps)
    return y.to(x.dtype)


# ------------------------------------------------------------- CUDA -----

def _stage_cuda(x, ln_eps, **weights) -> torch.Tensor:
    x = check_input(x, "stage")
    with _build.on_device(x, "stage", **weights):
        c = x.shape[-1]
        p = pack_blocks(x.device, **weights)
        n, heads = p["temp"].shape
        if c % heads or (c // heads) % 16:
            raise ValueError(f"stage kernel needs C/heads a multiple of 16 "
                             f"(C={c}, heads={heads})")
        runner = BlockRunner(x, heads, p["fp"])
        # blocks hand over in float32; only the last writes x's dtype
        out = torch.empty_like(x)
        bufs = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
                for _ in range(min(2, n - 1))]
        src = x
        for i in range(n):
            dst = out if i == n - 1 else bufs[i % 2]
            runner.run(src, dst, p, i, ln_eps)
            src = dst
    _build.count_launch(fused_transformer_stage)
    return src


def fused_transformer_stage(x, ln1_w, w_qkv, dw_qkv, temperature, w_proj,
                            ln2_w, w_in, w_dw, w_out,
                            ln_eps: float = 1e-5) -> torch.Tensor:
    """N BiasFree TransformerBlocks on NHWC x (see the module docstring).
    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    weights = dict(ln1_w=ln1_w, w_qkv=w_qkv, dw_qkv=dw_qkv,
                   temperature=temperature, w_proj=w_proj, ln2_w=ln2_w,
                   w_in=w_in, w_dw=w_dw, w_out=w_out)
    if x.device.type == "cuda":
        return _stage_cuda(x, ln_eps, **weights)
    if x.device.type == "cpu":
        return stage_plain(x, ln_eps=ln_eps, **weights)
    raise ValueError(f"no stage implementation for device {x.device}")


fused_transformer_stage.launches = 0  # CUDA stage calls (3 launches/block)
