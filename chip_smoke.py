#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: torch/CUDA versions, the card's name and power limit;
     build every csrc/*.cu for sm_90a, and the instrumented variant of
     stage.cu (one nvcc each, all at once).
  2. each kernel (stage, LayerNorm, LN+GDFN, whole block) against its plain
     PyTorch version on the card, at the shapes its paths give it, in bf16
     and fp32, with its time, the plain version's time, the bound for the
     same work and, where one PyTorch call computes the same function, that
     call's time (the stage also at (1,256,256,384), 8 heads: the latent of
     a 2048^2 frame, through csrc/stage_sm90_wide.cu); the same stage call
     twice gives the same bits, and one
     BiasFree block the bits of a one-block stage. At C = 96 the block's
     tile kernels (A) and (C) are csrc/stage_sm90.cu's Hopper kernels
     (k_gram_wgmma, k_apply_wgmma): each alone against its plain version at
     both stage shapes of a 512^2 request, (1,512,512,96) one head and
     (1,256,256,96) two, with its time and bound. A "stage_phases" JSON
     line: from the instrumented builds, the share of a tile's cycles in
     each phase of the block's two tile kernels and the cycles per tile, at
     (1,512,512,96) and (8,256,256,96); the thread blocks resident per SM
     (the device's occupancy answer), the grid's tail, registers and spill
     bytes from ptxas' report, and the HGMMA (wgmma), HMMA (mma.sync) and
     TMA instructions in each kernel's SASS (cuobjdump), the C = 96 kernels
     required to hold HGMMA. At C = 192 and 384 (48 channels a head) the
     tile kernels are csrc/stage_sm90_wide.cu's (k_gram_wide, and kernel (C)
     as k_proj_wide and k_ffn_wide): the stage at the deeper stages of
     1024^2 and 2048^2 frames, (1,256,256,192) x6 and (1,256,256,384) x8 in
     bf16 and fp32 and (1,512,512,192) x6 in bf16, each kernel alone against
     its plain version at (1,512,512,192) and (1,256,256,384), their phase
     clocks, registers and SASS (HGMMA required in all three). The LN+GDFN
     rows (C = 96, 192, 384: the Hopper kernel k_ffn_wide; C =
     48: csrc/gdfn.cu) name the kernel each launched and hold a second
     launch to the first one's bits; k_ffn_wide's registers, spills and
     HGMMA (required).
  3. whole-image serving: the full-width flagship KDLAE-T (seeded random
     weights) through TeacherPredictor(fused=True, bf16) on synthetic sonar
     frames, with the stage-kernel call count checked against the gate and
     the uint8 outputs against the same predictor with the plain stage; then
     one 1024^2 and one 2048^2 request, the wide kernels' launches checked
     against the gate-admitted C = 192 and 384 blocks, the 2048^2 one timed
     and profiled (wall, device busy, idle share, stage ms by width, top
     kernels).
  4. the per-block paths at full width, on the flagship decoder_level1
     geometry (4 blocks of 96 channels at 512x512, BiasFree and WithBias):
     TransformerBlock(fused=True) through the block kernel, and the blocks
     composed from the public LayerNorm and LN+GDFN functions, both against
     the eager blocks.
  5. tiled serving: the same predictor's denoise_tiled in 256x256 tiles and
     in full-width strips, 8 tiles per call, with the stage-kernel call
     count checked against the gate and the outputs against the plain stage.
Phases 1-5 run with TF32 off process-wide (the plain versions' products must
be float32); phases 6-8 put PyTorch's TF32 defaults back first, so that the
fp32 predictors' own pinning is what runs:
  6. student: a seeded full-width KDLAE-S (hidden 16/32/64, residual) through
     StudentPredictor.denoise_batch on (18, 7, 512, 512) uint8 synthetic sonar
     stacks (denoise_all_frames' batch of 126 frames, no files), fp32 and
     bf16 input: frames/s and peak memory; held to the same predictor on the
     CPU on a 7x128x128 crop (uint8 within 1 level on >= 99.9% of pixels).
  7. ASDQE: a seeded DenoiseRatePredictor (models/asdqe.py::init_weights_,
     non-trivial running statistics) scores 16 uint8 512x512 pairs batch-1 through the
     upload/dispatch pipeline of eval/asdqe_eval.py (arrays, no files) and as
     two (8, 512, 512, 3) batches: pairs/s; held to the CPU scorer on a
     128x128 pair within 1e-4.
  8. grouped teacher: the phase-3 predictor's denoise_group(group_size=8) on
     16 synthetic 512x512 frames against 16 per-image calls (bit-identical;
     images/s both ways; the stage-kernel count checked, 5 per image), the
     device idle share of one group from a profile, and one request with
     fused_resample=True within 1 level of the unfused one on >= 99% of
     pixels.
  9. zoo and CLI: the trained zoo (artifacts/torch_zoo/*.pth) through the
     port's CLI on the card, on 16 synthetic 512x512 sonar PNGs and 14 gray
     frames written with the port's imwrite into a temporary directory:
     infer-teacher per image, --group-size 8 and --tile 256, --sr on one
     image, serve --once twice, infer-student --all, score over 16 pairs
     (images, frames and pairs per second of each call, model load
     included); grouped and served outputs bit-identical to per-image ones,
     the second serve writing nothing, a 96x96 crop within 1 level of the
     same CLI with --device cpu; and the trained teacher in bf16 through
     TeacherPredictor(fused=True) within 1 level of fused=False on >= 99% of
     pixels of two 512x512 frames (5 stage calls per request).
 10. training: the full-width KDLAE-T of configs/KDLAET.yml as it stands
     (seeded initialisation, its AdamW, clip, schedule, mixup, curriculum
     and L1-Shadow loss), with iters [3, 3, 2, 2, 2, 2] so that all six
     curriculum stages run in total_iter 14, a checkpoint and a validation
     every 7 and every step logged, through `cli.main(["train", ...])` on a
     seeded synthetic corpus (24 training triples: a 256x256 input, its
     clear target, a 512x512 SR target and a JSON rate; 2 validation
     triples); gates: every logged loss finite, every parameter moved,
     checkpoints at 7 and 14, a second call with total_iter 16 resumes at
     14 and runs 2 steps, net_g_14.pth loads strictly and serves one
     512x512 frame through infer-teacher, `test` prints a finite PSNR, and
     one seeded step on the card equals the same step on the CPU (fp32, TF32
     off; loss and grad_norm within 1e-4 relative, each weight within 0.05
     lr, or 2 lr where its gradient is under 1e-6 of the largest); then one
     steady step at 6@64 and at 1@128 timed (synchronised wall, host
     enqueue) and profiled (device busy ms, idle share, kernel count).
     Training reaches no kernel of csrc/ (fused=False, the JAX trainer's
     default).
 11. the student and the scorer trained: (a) offline distillation, the
     trained teacher (artifacts/torch_zoo/teacher.pth) in bf16 through
     TeacherPredictor(fused=True) writing the student's targets for 24
     synthetic 512x512 gray sonar frames (3 sequences of 8; 5 stage calls a
     frame), held on two frames to the plain-stage predictor's distance from
     fp32 (share more than 1 level off at most 1.1x + 0.002 of it);
     (b) configs/KDLAES.yml at full width (hidden 16/32/64, num_pairs 7,
     batch 4, gt_sizes 128-384, its AdamW, clip, cosine restarts, mixup and
     L1-video loss) through `cli.main(["train", ...])`, iters [2]*6 in
     total_iter 12, a checkpoint and a frame-stack validation every 6, a
     resume to 14, net_g_12.pth served by infer-student, the frame masker's
     route native, one float32 card step against the same step on the CPU
     in float64 (loss and grad_norm within 1e-4, weights by the step rule),
     and steps at 4x7@128 and @384 profiled; (c) three steps of the same
     config with train.distill.online (the flagship teacher, teacher.pth),
     the teacher's share of each step, targets finite in [0, 1]; (d)
     train-asdqe at its defaults (batch 1, accum 32, gt 256, bf16) for 2
     epochs on 40 seeded lq/candidate/score triples of 512x512, `score` on
     net_g_best.pth (strict), and the reference's shape (batch 32 @ 512,
     remat) for 3 updates: pairs/s, peak memory, finite losses, moved
     running statistics; micro-steps at 1@256 and 32@512 profiled.
 12. device-resident corpora and the training profiler: (a)
     configs/KDLAES_FLS_ft.yml (full width, device_resident: true) through
     `cli.main(["train", ...])` on 64 synthetic numbered gray 512x512 frames,
     its pretrained weights the zoo student (artifacts/torch_zoo/
     student-us.pth; the config's own are an orbax directory), iters [4, 4]
     in 8 steps (4x7@192, 4x7@256), a checkpoint every 4, resumed to 10;
     the same 8 steps from the host loader (device_resident: false): ms per
     step, data ms, the corpus's upload s and MiB, peak memory; (b)
     configs/KDLAET.yml at full width, device-resident, on 24 of phase 10's
     synthetic triples, one step per curriculum stage; (c) `train-asdqe
     --device-resident` at its defaults for 2 epochs on 40 source pairs of
     512x512, and 3 updates at 32@512 from the device corpus, pairs/s beside
     phase 11 (d)'s host route; (d) `train --profile-steps 3` on (a)'s
     config (3 steps at 192): its log line and metrics record, its
     host-to-device copies (none larger than 4 KiB), its top kernel the
     same as `profile_step`'s on one device-resident step; the corpus's
     crop and flip as gathers against a per-item loop of slices.
 13. data-parallel training: (a) two ranks sharing the one card over gloo
     (child processes of this script, `--dp-rank`, started with torchrun's
     env): configs/KDLAET.yml at full width from the host loader, one step
     per curriculum stage, to 4 (a checkpoint, a validation on rank 0) and
     resumed to 6; the ranks' parameters bit for bit equal (sha256); two
     seeded steps on each rank's 6 rows of a batch of 12 at 64 (mask,
     mixup) against one process on the card at 12 (loss and grad_norm
     within 1e-4 relative, weights by the step rule); ms a step, the
     gradient reduction's ms a step, peak memory per rank; (b)
     configs/KDLAES_FLS_ft.yml device-resident on 64 frames, 4 steps of 4
     rows per rank; the ranks' rows of one global batch (8 x 7 @ 192) equal
     the one-process batch bit for bit, a step's uploads within 4 KiB; (c)
     `python -m torch.distributed.run --nproc_per_node=1 -m ...cli train
     --launcher pytorch` over NCCL: its checkpoint and metrics.jsonl; (d)
     two NCCL ranks where there are two cards, else a line saying why not.
     Training reaches no kernel: every count stays 0, the ranks' too.
 14. data-parallel serving (`devices=[...]`: every card, or two copies on
     cuda:0 where there is one, a line saying why): (a) the phase-3 teacher
     tiled as in phase 5 (256x256 tiles and full-width strips, 8 a call,
     each chunk split over the copies), the stage-kernel count 3 a chunk a
     copy and checked against the gate, uint8 within 1 level of the same
     copies with the plain stage and of one device, each on >= 99% of
     pixels, and zero-mask pixels 0; images/s beside one
     device's, one chunk's wall ms and idle share (the union of the device
     activity's intervals); (b) phase 6's 18 stacks through denoise_batch,
     and 17 (the even split pads): within 1 level of one device on
     >= 99.9%, frames/s, peak memory per device; (c) phase 7's 16 pairs
     batch-1 through score_pairs and as (8, 512, 512, 3) batches: within
     1e-4 of one device, pairs/s; (d) NIQE of 16 frames (host, s an
     image), FID between two seeded sets of 16 frames in the zoo scorer's
     feature space on the card against the CPU (features within 1e-4
     relative, FID within 1e-3), and InceptionV3 pool3 through
     make_inception_feature_fn from a saved .pth of seeded random weights
     on 32 frames (512 resized to 299, fp32, TF32 off), images/s, 2 of them
     within 1e-3 relative of the same function on the CPU.
 15. the remaining datasets, in a temporary directory of seeded corpora:
     (a) configs/Restormer_baseline.yml at full width (dim 48, [4,6,6,8],
     refinement 4, BiasFree) through `cli.main(["train", ...])` for 4 steps
     at 8@128 and a validation, from LMDB shards that
     data/lmdb_util.py::make_lmdb_from_folder wrote from 24 + 2 seeded
     512x512 colour pairs, and again from the folders: the first loss equal
     bit for bit, every loss within 1e-4 relative; each route's data ms,
     the shards' open and record-lookup MB/s with their bytes, and the route
     (the codec or the lmdb package);
     (b) the same network on Dataset_GaussianDenoising as the Restormer
     project's GaussianColorDenoising config (in_ch 3, sigma random in
     [0, 50], sigma_test 25), 3 steps and a validation: finite losses and
     PSNR, one batch of BatchLoader and BatchUploader on the card equal to
     the dataset's items; (c) the dual-pixel Restormer (inp_channels 6,
     WithBias) on Dataset_DefocusDeblur_DualPixel_16bit, 8 seeded 16-bit
     triples at DPDD's 1680x1120, 3 steps; then the flagship-width KDLAE-T
     with dual_pixel_task, params 'none', seeded, bf16, fused, on one whole
     frame of that dataset: its stage-kernel calls counted (they join the
     stage's launches), >= 99% of hq values within 1/255 of the same model
     with the plain stage; (d) Vimeo90K septuplets (448x256), a REDS clip
     (1280x720), FFHQ (1024^2) and VideoTest through BatchLoader and the
     uploader onto the card, one epoch of 64 items each (the sampler
     enlarged): each batch equal to the items, items/s after a warm batch;
     (e) flow_warp, OverlapPatchTimePoseEmbed, WDSpybottle and two
     ResidualBlockNoBN on the card against the CPU at 7x256x448, float32,
     TF32 off, max|d| within 1e-5 of max|ref|.
 16. spatially sharded serving, every band on cuda:0 (one card: the split's
     overhead, not scaling): (a) the stage kernel on 1, 2 and 4 row bands
     (fused_transformer_stage_bands) at the 512^2 request's gate-admitted
     stage shapes, (1,512,512,96) x4 blocks and (1,256,256,96) x6 blocks,
     at (1,264,256,96) on 2 bands of 132 rows (4 mod 8), and at the 2048^2
     latent's (1,256,256,384) x2 blocks on 1 and 2 bands, bf16 and one
     fp32 case, against the whole-image kernel (one band bit-identical, else
     within 1e-2) and the band plain version (within 1e-2), with its time,
     the whole-image kernel's, the plain version's, and the halo and partial
     bytes one band hands another; (b) the trained bf16 teacher
     (artifacts/torch_zoo/teacher.pth, fused) through
     TeacherPredictor(mesh=make_mesh(n_spatial=N)) on 2 and 4 bands of a
     seeded 512^2 frame and 2 bands of a 2048^2 frame, the band stage called
     exactly where one device's gate admits the stage, on 1 band bit-identical
     to one device, on more held to one device's
     distance from fp32 (share more than 1 level off at most 1.1x + 0.002
     of it, phase 9's rule: this network moves by whole levels where a bf16
     rounding changes, and the split adds the MDTA's pixel sums in another
     order) with the agreement with one device recorded, ms a
     request against one device, bytes moved a request, the idle share at
     512^2; the seeded flagship of phase 3 on 2 bands within 1 level of one
     device on >= 99%; (c) the trained fp32 teacher, fused=False, on 2
     bands at 512^2 within 1 level of one device on >= 99%.
 17. spatially sharded training (train.spatial_shard: 2), two gloo ranks
     sharing cuda:0, one row band each (child processes of this script,
     `--sp-rank`, torchrun's env; one card: the split's overhead, not
     scaling): (a) configs/KDLAET.yml at full width through the loop, two
     steps in each curriculum stage (12), a checkpoint and a validation on
     rank 0 at 12; (b) one teacher step and a second at batch 1 on a 512^2
     crop, the width kept and the depth halved (blocks [2,3,3,4],
     refinement 2: at full depth each band's fp32 step holds ~39 GiB, and
     two bands do not fit one 80 GB card); (c) configs/KDLAES.yml's
     student at 4x7@384, two steps. Gates:
     the first step of (b) and (c) against one process on the card on the
     same batch and draws (loss within 1e-5 relative, grad norm 1e-4, every
     weight within 5e-3 relative and 3 lr absolute: the JAX spatial test's
     rule), every loss finite, the ranks' parameters bit-equal after every
     step (sha256), rank 0's checkpoint loading strictly into the
     whole-image teacher and serving one 512^2 frame, no kernel launch in
     the ranks. Per step: ms against one process's, halo and partial bytes,
     peak memory per rank.
 18. tensor-parallel serving (a mesh's model axis), every shard on cuda:0
     (one card: the split's overhead, not scaling): which stages split their
     heads over 2 and 4 shards at 512^2 and 2048^2 and the share of a
     request's operations every shard repeats (the meta device); (a) the
     stage kernel on 2 and 4 model shards (fused_transformer_stage_shards:
     (A) on a shard's heads or whole, (B), (C') to the partial projection,
     a sum, the GDFN kernel on the shard's hidden channels, a sum) at
     (1,512,512,96) x4 blocks with 1 and 2 heads and (1,256,256,384) x2 with
     8 heads (the wide layout), bf16, against its plain version and the
     whole-image kernel (within 1e-2), every shard the same bits, with its
     time, the whole-image kernel's, the plain version's, sums and partial
     bytes, the route (48 channels a head at C = 96, 192 and 384: the
     Hopper kernels k_gram_wide / k_gram_wgmma and k_proj_wide, else
     csrc/stage.cu's) and the launches of each kernel; the GDFN kernel on
     128 and 127 of 255 hidden channels (fp32 r, with and without the
     residual) against its plain version, the same bits twice; k_gram_wide
     on a shard's head and k_proj_wide with and without x alone at
     (1,512,512,96) (Cq = 48) against their plain versions; (b) the
     trained bf16 teacher (fused) on 2 and 4 shards of a 512^2 frame, the
     shard stage called exactly where one device's gate admits the stage,
     held to phase 9's fp32 rule, and the seeded flagship of phase 3 on 2
     and 4 shards within 1 level of one device on >= 99%; (c) the seeded
     flagship on 2 shards of a 2048^2 frame (the latent's 8 heads split in
     the wide layout), within 1 level of one device. Each case: ms a
     request against one device, the idle share at 512^2, sums and partial
     bytes a request, shard-stage and GDFN-part launches and the Hopper
     kernels' (every GDFN part on k_ffn_wide, (C') on k_proj_wide), weight
     bytes a shard.
 19. tensor-parallel training (train.model_shard: 2), two gloo ranks
     sharing cuda:0, one model shard each (child processes of this script,
     `--tp-rank`, torchrun's env; one card: the split's overhead, not
     scaling), the teacher in its shift-add depthwise form (dwconv_shift):
     (a) configs/KDLAET.yml at full width through the loop, two steps in
     each curriculum stage (12), a checkpoint and a validation of the
     gathered model on rank 0 at 12; (b) one teacher step and a second at
     batch 1 on a 512^2 crop, phase 17's depth cut (blocks [2,3,3,4],
     refinement 2: a shard keeps the whole residual stream, and two
     full-depth shards do not fit one 80 GB card); (c) configs/KDLAES.yml's
     student (whole on every shard) at 4x7@384, two steps. Gates: the
     first step of (a), (b) and (c) against one process on the card on the
     same batch and draws by phase 17's rule, every loss finite, the
     ranks' whole leaves bit-equal after every step (sha256), rank 0's
     checkpoint loading strictly into the whole-image teacher and serving
     one 512^2 frame, no kernel launch in the ranks. Per step: ms against
     one process's, sums and partial bytes, peak memory per rank, weight
     bytes a shard.
Each path runs with every launch count set to 0 just before it and read just
after. Prints one JSON line per phase 6-19, a "kernels" JSON line, the card
line, and as its last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.
`chip_smoke.py --dp-rank SPEC`, `--sp-rank SPEC` and `--tp-rank SPEC` are
ranks of phases 13, 17 and 19, not for use alone; `chip_smoke.py --phase 14`
(or 15-19) builds and runs that phase alone (its JSON line, no "kernels" or
"ok" line).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PORT = "rethink_acoustic_image_enhancement_tpu_torch"
HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 rate outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 1e-2            # kernel vs plain, max|d| / max|ref|
TOL_PATH = 2e-2           # a 4-block bf16 kernel path vs the eager blocks in fp32
PALLAS = "rethink_acoustic_image_enhancement_tpu/ops/pallas"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps runs, by CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Mean device time of fn() over reps runs, by CUDA events around
    launches that queue up behind a device-side delay: the host has issued
    them all before the first may start, so its gaps do not count."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(40_000_000)  # some 20 ms of device time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """(ms, how): mean device time of all that fn() launches over reps runs,
    free of the host's gaps, which outlast a kernel of a few tens of
    microseconds. By torch.profiler ("profiler"); where the profiler hands
    back only a part of a window's launches three times running, by
    queued_ms ("queued_events"), which adds each launch's start-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        # every kernel of fn() must show up reps times over
        if events and all(e.count % reps == 0 for e in events):
            return sum(e.self_device_time_total for e in events) / reps / 1e3, "profiler"
        log(f"  profiler window incomplete for {reps} runs: "
            f"{[(e.key[:40], e.count) for e in events]}")
    return queued_ms(fn, reps), "queued_events"


# ------------------------------------------------------------ phase 2 ----

def stage_work(b, h, w, c, n_blocks, heads, f, esize):
    """(flops, bytes) a stage must do: the five products and two depthwise
    3x3s per pixel and block; x read once, y written once, weights once."""
    hc = c // heads
    per_px = (2 * c * 3 * c + 2 * 9 * 3 * c + 2 * c * hc + 2 * c * hc
              + 2 * c * c + 2 * c * 2 * f + 2 * 9 * 2 * f + 2 * f * c)
    flops = per_px * b * h * w * n_blocks
    weight_bytes = n_blocks * (2 * (3 * c * c + c * c + 2 * c * f + f * c)
                               + 4 * (9 * 3 * c + 9 * 2 * f + 2 * c + heads))
    return flops, 2 * b * h * w * c * esize + weight_bytes


def seeded_stage_weights(rng, n, c, heads, f, device):
    import torch

    def t(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device)

    return dict(
        ln1_w=t(n, c, scale=0.1, shift=1.0),
        w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
        dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
        temperature=torch.from_numpy(
            rng.uniform(0.5, 1.5, size=(n, heads, 1, 1)).astype(np.float32)).to(device),
        w_proj=t(n, 1, 1, c, c, scale=c ** -0.5),
        ln2_w=t(n, c, scale=0.1, shift=1.0),
        w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5),
        w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
        w_out=t(n, 1, 1, f, c, scale=f ** -0.5),
    )


def phase_kernels(results, card):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

    # then a tile batch, and the deeper stages of 1024^2 and 2048^2 requests
    # (encoder_level3 and decoder_level3 at C = 192, the latent at 384, also
    # at 2 of its 8 blocks): csrc/stage_sm90_wide.cu's kernels
    cases = [((1, 512, 512, 96), 4, 1), ((1, 256, 256, 96), 6, 2),
             ((2, 256, 256, 96), 2, 2), ((8, 256, 256, 96), 4, 1), ((1, 256, 256, 384), 2, 8),
             ((1, 256, 256, 192), 6, 4), ((1, 512, 512, 192), 6, 4), ((1, 256, 256, 384), 8, 8)]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape, n, heads in cases:
            if dtype == torch.float32 and shape == (1, 512, 512, 192):
                continue  # bf16 only: the 2048^2 request's shape
            c = shape[-1]
            f = int(c * 2.66)
            rng = np.random.default_rng(len(rows))
            calls_before = pstage.fused_transformer_stage.launches
            wts = seeded_stage_weights(rng, n, c, heads, f, "cuda")
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
            got = pstage.fused_transformer_stage(x, **wts)
            torch.cuda.synchronize()
            ref = pstage.stage_plain(x, **wts)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            assert torch.isfinite(got).all().item(), "non-finite kernel output"
            assert got.shape == x.shape and got.dtype == dtype
            rel = diff / scale
            kern_ms = cuda_ms(lambda: pstage.fused_transformer_stage(x, **wts), 5)
            plain_ms = cuda_ms(lambda: pstage.stage_plain(x, **wts), 2)
            flops, nbytes = stage_work(*shape, n, heads, f, x.element_size())
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = dict(shape=list(shape), n_blocks=n, heads=heads,
                       dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=diff, max_abs_ref=scale, rel_err=rel,
                       ms=kern_ms, plain_ms=plain_ms,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flops=flops, bytes=nbytes,
                       launches=pstage.fused_transformer_stage.launches - calls_before)
            rows.append(row)
            per_block = 4 if c in (192, 384) else 3  # (C) is two kernels at the wide widths
            log(f"stage {row['dtype']} {tuple(shape)} blocks={n} heads={heads}: "
                f"kernel {kern_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"max|d| {diff:.3e} rel {rel:.3e}, {row['launches']} stage calls "
                f"({per_block * n} kernel launches each) [{card}]")
            assert rel <= TOL_REL, f"kernel disagrees with plain: {rel} > {TOL_REL}"
            del got, ref, x
    results["stage_cases"] = rows
    results["stage_profile_us"] = profile_stage(pstage, card)
    results["stage_phases"] = stage_phases(card)
    print(json.dumps({"stage_phases": results["stage_phases"]}), flush=True)
    return rows


def sass_counts(name):
    """{kernel: {"HGMMA": n, "HMMA": n, "UTMALDG": n, "UBLKCP": n}} of
    library <name>'s SASS (cuobjdump -sass, most over a kernel's
    instantiations); None where the toolkit has no cuobjdump."""
    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build

    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        head = fn.split("\n", 1)[0]
        kernel = next((k for k in ("k_gram_wgmma", "k_apply_wgmma", "k_gram_wide",
                                   "k_proj_wide", "k_ffn_wide", "k_gram", "k_softmax",
                                   "k_apply", "k_project") if k in head), head[:60])
        row = out.setdefault(kernel, {})
        for op in ("HGMMA", "HMMA", "UTMALDG", "UBLKCP"):
            row[op] = max(row.get(op, 0), fn.count(op))
    return out


def stage_phases(card):
    """Cycles per phase inside a tile of the block's kernels (the
    instrumented builds, which nothing else loads), with what the device,
    ptxas and the SASS say of the normal build's kernels."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build, block, phase_clocks, stage

    out = {"card": card, "ptxas": {**_build.kernel_resources("stage"),
                                   **_build.kernel_resources("stage_sm90"),
                                   **_build.kernel_resources("stage_sm90_wide")},
           "sass": sass_counts("stage_sm90"), "sass_wide": sass_counts("stage_sm90_wide"),
           "shapes": {}}
    for shape in ((1, 512, 512, 96), (8, 256, 256, 96)):
        rng = np.random.default_rng(1)
        wts = seeded_stage_weights(rng, 1, 96, 1, 255, "cuda")
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().bfloat16()
        a = stage.fused_transformer_stage(x, **wts)
        b = stage.fused_transformer_stage(x, **wts)
        assert torch.equal(a, b), f"two stage calls at {shape} differ"
        row = phase_clocks.block_phase_shares(x, **wts)
        run = block.BlockRunner(x, 1, 256)
        n_tiles = row["k_apply_wgmma"]["tiles"]
        row["plan"] = run.plan._asdict()
        row["k_gram_wgmma_grid"] = run.groups * shape[0]
        row["k_apply_wgmma_grid"] = run.apply_grid
        # tiles of the persistent kernel (C)'s last, partly filled round
        row["k_apply_wgmma_grid_tail"] = n_tiles % run.apply_grid
        out["shapes"]["x".join(map(str, shape))] = row
        for name in ("k_gram_wgmma", "k_apply_wgmma"):
            shares = ", ".join(f"{k} {v:.3f}" for k, v in row[name]["share"].items())
            log(f"phases {name} {shape}: {row[name]['cycles_per_tile']:.0f} cycles a tile "
                f"({shares}) [{card}]")
        log(f"  resident blocks per SM: k_gram_wgmma {run.plan.gram_blocks}, k_apply_wgmma "
            f"{run.plan.apply_blocks} (512 threads); k_apply_wgmma grid {run.apply_grid} over "
            f"{n_tiles} tiles, tail {row['k_apply_wgmma_grid_tail']}; bit-identical twice: yes")
        assert run.route == "wgmma" and min(run.plan.gram_blocks, run.plan.apply_blocks) >= 1
    # the wide kernels at the 2048^2 request's C = 192 and 384 stage shapes
    for shape, heads in (((1, 512, 512, 192), 4), ((1, 256, 256, 384), 8)):
        rng = np.random.default_rng(2)
        c = shape[-1]
        wts = seeded_stage_weights(rng, 1, c, heads, int(2.66 * c), "cuda")
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().bfloat16()
        row = phase_clocks.block_phase_shares(x, **wts)
        run = block.BlockRunner(x, heads, -(-int(2.66 * c) // 64) * 64)
        assert run.wide and min(block._wg_residency(run.wg_lib, x.device, c)) >= 1
        row["plan"] = run.plan._asdict()
        row["grids"] = dict(k_gram_wide=run.groups * shape[0], k_proj_wide=run.proj_grid,
                            k_ffn_wide=run.apply_grid)
        out["shapes"]["x".join(map(str, shape))] = row
        for name in ("k_gram_wide", "k_proj_wide", "k_ffn_wide"):
            shares = ", ".join(f"{k} {v:.3f}" for k, v in row[name]["share"].items())
            log(f"phases {name} {shape} heads={heads}: {row[name]['cycles_per_tile']:.0f} cycles "
                f"a tile of {row[name]['tiles']} ({shares}) [{card}]")
        log(f"  grids {row['grids']}, tile {run.plan.gram_tile}, one block of 512 threads an SM")
    log(f"  ptxas: {out['ptxas']}")
    log(f"  SASS of stage_sm90: {out['sass']}; of stage_sm90_wide: {out['sass_wide']}")
    if out["sass"] is not None:
        for name in ("k_gram_wgmma", "k_apply_wgmma"):
            assert out["sass"][name]["HGMMA"] > 0, f"{name} holds no HGMMA"
        assert out["sass"]["k_apply_wgmma"]["HMMA"] == 0, "k_apply_wgmma holds mma.sync"
        for name in ("k_gram_wide", "k_proj_wide", "k_ffn_wide"):
            assert out["sass_wide"][name]["HGMMA"] > 0, f"{name} holds no HGMMA"
        for name in ("k_proj_wide", "k_ffn_wide"):
            assert out["sass_wide"][name]["HMMA"] == 0, f"{name} holds mma.sync"
    return out


def profile_stage(pstage, card):
    """Device time of each kernel in one 4-block bf16 stage call at
    512x512x96, by torch.profiler (summed over the call's launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wts = seeded_stage_weights(np.random.default_rng(0), 4, 96, 1, 255, "cuda")
    x = torch.randn(1, 512, 512, 96, device="cuda").bfloat16()
    pstage.fused_transformer_stage(x, **wts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pstage.fused_transformer_stage(x, **wts)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        for name in ("k_gram_wgmma", "k_softmax", "k_apply_wgmma"):
            if name in e.key:
                per_kernel[name] = per_kernel.get(name, 0.0) + e.device_time_total
    log(f"profile of one stage call (1,512,512,96) x4 blocks bf16, us per call: "
        f"{per_kernel} [{card}]")
    return per_kernel


def hopper_work(b, h, w, c, heads, f, esize):
    """(flops, bytes) of kernels (A) and (C) of one block: (A) the qkv
    product, its depthwise 3x3 and the Gram per pixel, x read and v written;
    (C) attn @ v, W_proj, W_in, W_out and the GDFN depthwise 3x3 per pixel,
    x and v read and y written; weights once."""
    hc, px = c // heads, b * h * w
    a = (2 * c * 3 * c + 2 * 9 * 3 * c + 2 * c * hc) * px
    a_bytes = px * c * (esize + 2) + 2 * 3 * c * c + 4 * 9 * 3 * c
    cc = (2 * c * hc + 2 * c * c + 2 * c * 2 * f + 2 * f * c + 2 * 9 * 2 * f) * px
    c_bytes = px * c * (2 * esize + 2) + 2 * (c * c + 3 * c * f) + 4 * 9 * 2 * f
    return (a, a_bytes), (cc, c_bytes)


def phase_hopper_kernels(results, card):
    """Kernels (A) and (C) at C = 96 each alone against its plain version
    on the same inputs (the plain (C) takes the kernels' v and attn^T), at
    the two stage shapes of a 512^2 request, bf16: time, plain time, bound.
    (A)'s error is v's; its Gram and norms are held within TOL_REL too."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
    from rethink_acoustic_image_enhancement_tpu_torch.ops.gdfn import dw3x3, ffn_f32

    rows = {"k_gram_wgmma": [], "k_apply_wgmma": []}
    eps = 1e-5
    for shape, heads in (((1, 512, 512, 96), 1), ((1, 256, 256, 96), 2)):
        rng = np.random.default_rng(300 + heads)
        c, f = shape[-1], 255
        wts = seeded_stage_weights(rng, 1, c, heads, f, "cuda")
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().bfloat16()
        p = pblock.pack_blocks(x.device, **wts)
        run = pblock.BlockRunner(x, heads, p["fp"])
        assert run.route == "wgmma"
        w32 = {k: v[0].float() for k, v in wts.items()}
        wqkv, wproj = w32["w_qkv"].reshape(c, 3 * c), w32["w_proj"].reshape(c, c)
        win, wout = w32["w_in"].reshape(c, 2 * f), w32["w_out"].reshape(f, c)
        dwqkv, wdw = w32["dw_qkv"].reshape(3, 3, 3 * c), w32["w_dw"].reshape(3, 3, 2 * f)
        x32 = x.float()

        def gram_plain():
            qkv = dw3x3(pblock.qkv_hidden(x32, w32["ln1_w"], None, wqkv, eps), dwqkv)
            return qkv, pblock.gram_part(qkv, run.gram_heads)

        run.gram(x, p, 0, eps)
        torch.cuda.synchronize()
        qkv, gp = gram_plain()
        hc = c // run.gram_heads
        part = run.part.sum(1)
        gram = part[:, :run.gram_heads * hc * hc].reshape(gp[..., :hc].shape)
        norms = part[:, run.gram_heads * hc * hc:].reshape(shape[0], 2, run.gram_heads, hc)
        v_ref = qkv[..., 2 * c:].bfloat16().float()
        dv = (run.v.float() - v_ref).abs().max().item()
        rel = {"v": dv / v_ref.abs().max().item(),
               "gram": ((gram - gp[..., :hc]).abs().max() / gp[..., :hc].abs().max()).item(),
               "norms": ((norms - torch.stack([gp[..., hc], gp[..., hc + 1]], 1)).abs().max()
                         / gp[..., hc:].abs().max()).item()}
        assert max(rel.values()) <= TOL_REL, f"k_gram_wgmma disagrees with plain: {rel}"
        run.softmax(run.part, p, 0)
        y = torch.empty(shape, dtype=torch.float32, device="cuda")

        def apply_plain():
            # attn (C x C, block-diagonal over the Gram's heads) from (B)'s attn^T
            at = run.attn_t[0].float()  # [head][d][c] = attn[c][d]
            attn = torch.block_diag(*[at[h].t() for h in range(at.shape[0])])
            oa = run.v.float() @ attn.t().bfloat16().float()
            r = x32 + oa.bfloat16().float() @ wproj.bfloat16().float()
            return ffn_f32(r, w32["ln2_w"], None, win, wdw, wout, eps)

        run.apply(x, y, p, 0, eps)
        torch.cuda.synchronize()
        ref = apply_plain()
        dy = (y - ref).abs().max().item()
        rel["y"] = dy / ref.abs().max().item()
        assert rel["y"] <= TOL_REL, f"k_apply_wgmma disagrees with plain: {rel['y']}"
        (fa, ba), (fc_, bc) = hopper_work(*shape, heads, f, x.element_size())
        for name, kern, plain, flops, nbytes, err in (
                ("k_gram_wgmma", lambda: run.gram(x, p, 0, eps), gram_plain, fa, ba, dv),
                ("k_apply_wgmma", lambda: run.apply(x, y, p, 0, eps), apply_plain, fc_, bc, dy)):
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            ms, timed_by = device_ms(kern, 5)
            row = dict(shape=list(shape), heads=heads, dtype="bfloat16", max_abs_err=err,
                       rel_err=rel, ms=ms, ms_by=timed_by, plain_ms=cuda_ms(plain, 2),
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       library_ms=None, flops=flops, bytes=nbytes)
            rows[name].append(row)
            log(f"{name} bf16 {tuple(shape)} heads={heads}: kernel {ms:.4f} ms ({timed_by}), "
                f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), max|d| {err:.3e}, rel {rel} [{card}]")
        del qkv, gp, ref, y, x
    results["hopper_cases"] = rows
    return rows


def wide_work(b, h, w, c, heads, f, esize):
    """(flops, bytes) of the wide kernels (P) and (F) of one block: (P) attn
    @ v and W_proj per pixel, x and v read, r (fp32) written; (F) W_in, W_out
    and the GDFN depthwise 3x3 per pixel, r read and y written; weights once.
    (A)'s are hopper_work's."""
    hc, px = c // heads, b * h * w
    p = (2 * c * hc + 2 * c * c) * px
    p_bytes = px * c * (esize + 2 + 4) + 2 * c * c
    ff = (2 * c * 2 * f + 2 * f * c + 2 * 9 * 2 * f) * px
    f_bytes = px * c * (4 + esize) + 2 * 3 * c * f + 4 * 9 * 2 * f
    return (p, p_bytes), (ff, f_bytes)


def phase_hopper_wide(results, card):
    """Kernels (A), (P) and (F) at C = 192 and 384 (csrc/stage_sm90_wide.cu)
    each alone against its plain version on the same inputs ((P)'s plain
    takes the kernels' v and attn^T, (F)'s the kernel's r), at the C = 192
    stage shape of a 2048^2 request, (1,512,512,192) 4 heads, and its
    latent's, (1,256,256,384) 8 heads, bf16: time, plain time, bound. (A)'s
    error is v's; its Gram and norms are held within TOL_REL too."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
    from rethink_acoustic_image_enhancement_tpu_torch.ops.gdfn import dw3x3, ffn_f32

    rows = {"k_gram_wide": [], "k_proj_wide": [], "k_ffn_wide": []}
    eps = 1e-5
    for shape, heads in (((1, 512, 512, 192), 4), ((1, 256, 256, 384), 8)):
        rng = np.random.default_rng(400 + heads)
        c = shape[-1]
        f = int(2.66 * c)
        wts = seeded_stage_weights(rng, 1, c, heads, f, "cuda")
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().bfloat16()
        p = pblock.pack_blocks(x.device, **wts)
        run = pblock.BlockRunner(x, heads, p["fp"])
        assert run.route == "wgmma" and run.wide
        w32 = {k: v[0].float() for k, v in wts.items()}
        wqkv, wproj = w32["w_qkv"].reshape(c, 3 * c), w32["w_proj"].reshape(c, c)
        win, wout = w32["w_in"].reshape(c, 2 * f), w32["w_out"].reshape(f, c)
        dwqkv, wdw = w32["dw_qkv"].reshape(3, 3, 3 * c), w32["w_dw"].reshape(3, 3, 2 * f)
        x32 = x.float()

        def gram_plain():
            qkv = dw3x3(pblock.qkv_hidden(x32, w32["ln1_w"], None, wqkv, eps), dwqkv)
            return qkv, pblock.gram_part(qkv, heads)

        run.gram(x, p, 0, eps)
        torch.cuda.synchronize()
        qkv, gp = gram_plain()
        hc = c // heads
        part = run.part.sum(1)
        gram = part[:, :heads * hc * hc].reshape(gp[..., :hc].shape)
        norms = part[:, heads * hc * hc:].reshape(shape[0], 2, heads, hc)
        v_ref = qkv[..., 2 * c:].bfloat16().float()
        dv = (run.v.float() - v_ref).abs().max().item()
        rel = {"v": dv / v_ref.abs().max().item(),
               "gram": ((gram - gp[..., :hc]).abs().max() / gp[..., :hc].abs().max()).item(),
               "norms": ((norms - torch.stack([gp[..., hc], gp[..., hc + 1]], 1)).abs().max()
                         / gp[..., hc:].abs().max()).item()}
        assert max(rel.values()) <= TOL_REL, f"k_gram_wide disagrees with plain: {rel}"
        run.softmax(run.part, p, 0)
        y = torch.empty(shape, dtype=torch.float32, device="cuda")

        def proj_plain():
            at = run.attn_t[0].float()  # [head][d][c] = attn[c][d]
            attn = torch.block_diag(*[at[h].t() for h in range(heads)])
            oa = run.v.float() @ attn.t().bfloat16().float()
            return x32 + oa.bfloat16().float() @ wproj.bfloat16().float()

        def ffn_plain():
            return ffn_f32(run.r, w32["ln2_w"], None, win, wdw, wout, eps)

        run.apply(x, y, p, 0, eps)
        torch.cuda.synchronize()
        r_ref = proj_plain()
        dr = (run.r - r_ref).abs().max().item()
        rel["r"] = dr / r_ref.abs().max().item()
        y_ref = ffn_plain()
        dy = (y - y_ref).abs().max().item()
        rel["y"] = dy / y_ref.abs().max().item()
        assert rel["r"] <= TOL_REL, f"k_proj_wide disagrees with plain: {rel['r']}"
        assert rel["y"] <= TOL_REL, f"k_ffn_wide disagrees with plain: {rel['y']}"
        again = torch.empty_like(y)
        run.apply(x, again, p, 0, eps)
        assert torch.equal(again, y), "two launches of (P) and (F) differ"
        (fa, ba), _ = hopper_work(*shape, heads, f, x.element_size())
        (fp_, bp), (ff, bf) = wide_work(*shape, heads, f, x.element_size())
        ptr = pblock._ptr(p, 0)
        for name, kern, plain, flops, nbytes, err in (
                ("k_gram_wide", lambda: run.gram(x, p, 0, eps), gram_plain, fa, ba, dv),
                ("k_proj_wide", lambda: pblock.proj_wide(run, x, ptr), proj_plain, fp_, bp, dr),
                ("k_ffn_wide", lambda: pblock.ffn_wide(run, y, ptr, eps), ffn_plain, ff, bf, dy)):
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            ms, timed_by = device_ms(kern, 5)
            row = dict(shape=list(shape), heads=heads, dtype="bfloat16", max_abs_err=err,
                       rel_err=rel, ms=ms, ms_by=timed_by, plain_ms=cuda_ms(plain, 2),
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       library_ms=None, flops=flops, bytes=nbytes)
            rows[name].append(row)
            log(f"{name} bf16 {tuple(shape)} heads={heads}: kernel {ms:.4f} ms ({timed_by}), "
                f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), max|d| {err:.3e}, rel {rel} [{card}]")
        del qkv, gp, r_ref, y_ref, y, again, x
    results["hopper_wide_cases"] = rows
    return rows


def hopper_counts(zero=False):
    """The launches of the Hopper tile kernels: (A) and (C) at C = 96, (A),
    (P) and (F) at C = 192 and 384 (their wrappers' counts), read or set to
    0."""
    from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock

    fns = {"k_gram_wgmma": pblock.gram_wgmma, "k_apply_wgmma": pblock.apply_wgmma,
           "k_gram_wide": pblock.gram_wide, "k_proj_wide": pblock.proj_wide,
           "k_ffn_wide": pblock.ffn_wide}
    if zero:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from rethink_acoustic_image_enhancement_tpu_torch.ops import block, gdfn, layernorm, stage

    fns = dict(stage=stage.fused_transformer_stage, layernorm=layernorm.fused_channel_layernorm,
               gdfn=gdfn.fused_ln_gdfn, block=block.fused_transformer_block,
               stage_bands=stage.fused_transformer_stage_bands,
               stage_shards=stage.fused_transformer_stage_shards,
               gdfn_part=gdfn.fused_ln_gdfn_part)
    for fn in fns.values():
        fn.launches = 0
    return fns


def read_counts(fns):
    return {name: fn.launches for name, fn in fns.items()}


def seeded(rng, *shape, scale=1.0, shift=0.0):
    import torch

    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale + shift).cuda()


def held_to_plain(name, kernel, plain, x, flops, nbytes, peak_flops, card, results_row,
                  library=None, elementwise_ulp=None, tol=TOL_REL, plain_reps=2):
    """Run kernel() and plain() on the card, compare, time both (and the
    library call), and fill the row; fails on disagreement. The kernel's
    time is the device time of its wrapper's launches; the plain version's
    and the library call's are CUDA-event times."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype, (got.shape, got.dtype)
    assert torch.isfinite(got).all().item(), f"{name}: non-finite kernel output"
    d = (got.float() - ref.float()).abs()
    diff, scale = d.max().item(), ref.float().abs().max().item()
    rel = diff / scale
    ring = torch.ones(x.shape[1:3], dtype=torch.bool, device=x.device)
    ring[1:-1, 1:-1] = False
    ring_rel = d[:, ring].max().item() / scale
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    kern_ms, timed_by = device_ms(kernel, 5)
    row = dict(results_row, shape=list(x.shape), dtype=str(x.dtype).replace("torch.", ""),
               max_abs_err=diff, max_abs_ref=scale, rel_err=rel, ring_rel_err=ring_rel,
               ms=kern_ms, ms_by=timed_by, ms_with_host_gaps=cuda_ms(kernel, 5),
               plain_ms=cuda_ms(plain, plain_reps),
               library_ms=cuda_ms(library, 5) if library else None,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops, bytes=nbytes)
    lib_txt = f", library {row['library_ms']:.4f} ms" if library else ""
    log(f"{name} {row['dtype']} {tuple(x.shape)} "
        f"{results_row}: kernel {row['ms']:.4f} ms ({timed_by}), plain "
        f"{row['plain_ms']:.4f} ms{lib_txt}, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), max|d| {diff:.3e} rel {rel:.3e} ring {ring_rel:.3e} [{card}]")
    if elementwise_ulp is not None:
        ok = (d <= ref.float().abs() * elementwise_ulp + 1e-6).all().item()
        assert ok, f"{name}: more than one ulp from plain"
    else:
        assert rel <= tol and ring_rel <= tol, f"{name} disagrees with plain: {rel}, ring {ring_rel}"
    return row


def phase_layernorm_kernel(results, card):
    import torch
    import torch.nn.functional as F

    from rethink_acoustic_image_enhancement_tpu_torch.ops import layernorm as pln

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((1, 512, 512, 96), (1, 256, 256, 192)):
            for bias_free in (True, False):
                rng = np.random.default_rng(len(rows))
                c = shape[-1]
                x = seeded(rng, *shape, scale=2.0, shift=0.5).to(dtype)
                w, b = seeded(rng, c, scale=0.2, shift=1.0), seeded(rng, c, scale=0.5)
                n = x.numel()
                library = None
                if not bias_free:  # F.layer_norm is the WithBias variant
                    wl, bl = w.to(dtype), b.to(dtype)
                    library = lambda: F.layer_norm(x, (c,), wl, bl, 1e-5)
                rows.append(held_to_plain(
                    "layernorm", lambda: pln.fused_channel_layernorm(x, w, b, bias_free),
                    lambda: pln.layernorm_plain(x, w, b, bias_free), x,
                    8 * n, 2 * n * x.element_size() + 8 * c, PEAK_FP32_FLOPS, card,
                    dict(bias_free=bias_free), library=library, plain_reps=5,
                    elementwise_ulp=2.0 ** -7 if dtype == torch.bfloat16 else None,
                    tol=1e-5))
    results["layernorm_cases"] = rows
    return rows


def gdfn_work(b, h, w, c, f, esize):
    """(flops, bytes) of LN+GDFN: the two products and the depthwise 3x3 per
    pixel; x read once, out written once, weights once."""
    per_px = 2 * c * 2 * f + 2 * 9 * 2 * f + 2 * f * c
    return (per_px * b * h * w,
            2 * b * h * w * c * esize + 2 * (2 * c * f + f * c) + 4 * (18 * f + 2 * c))


def gdfn_kernel_of(fn):
    """Which LN+GDFN kernel the call fn() launched (``ops/gdfn.py::
    ffn_route``), read off the Hopper kernel's launch count."""
    from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn

    before = pgdfn.gdfn_sm90.launches
    out = fn()
    sm90 = pgdfn.gdfn_sm90.launches > before
    return out, ("k_ffn_wide (stage_sm90_wide.cu)" if sm90 else "k_gdfn (gdfn.cu)")


def phase_gdfn_kernel(results, card):
    """The LN+GDFN kernel against gdfn_plain: at C = 96, 192 and 384 the
    Hopper kernel, at C = 48 csrc/gdfn.cu (the widths it keeps);
    each row names the kernel it launched and holds a second launch to the
    first one's bits. The Hopper kernel's ptxas registers and spills and its
    HGMMA count (required) go to ``gdfn_kernel_build``."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build, phase_clocks
    from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((1, 512, 512, 96), (2, 256, 256, 192), (1, 64, 64, 384),
                      (1, 52, 44, 96), (1, 256, 256, 48)):
            for bias_free in (True, False):
                rng = np.random.default_rng(100 + len(rows))
                c = shape[-1]
                f = int(c * 2.66)
                x = seeded(rng, *shape).to(dtype)
                args = (seeded(rng, c, scale=0.1, shift=1.0),
                        None if bias_free else seeded(rng, c, scale=0.5),
                        seeded(rng, 1, 1, c, 2 * f, scale=c ** -0.5),
                        seeded(rng, 3, 3, 1, 2 * f, scale=1 / 3),
                        seeded(rng, 1, 1, f, c, scale=f ** -0.5))
                flops, nbytes = gdfn_work(*shape, f, x.element_size())
                first, kernel = gdfn_kernel_of(
                    lambda: pgdfn.fused_ln_gdfn(x, *args, bias_free=bias_free))
                assert torch.equal(first, pgdfn.fused_ln_gdfn(x, *args, bias_free=bias_free)), \
                    f"LN+GDFN {shape}: a second launch gave other bits"
                assert (kernel.startswith("k_ffn_wide")) == (pgdfn.ffn_route(c) == "wgmma")
                rows.append(held_to_plain(
                    "ln_gdfn", lambda: pgdfn.fused_ln_gdfn(x, *args, bias_free=bias_free),
                    lambda: pgdfn.gdfn_plain(x, *args, bias_free=bias_free), x,
                    flops, nbytes, PEAK_BF16_FLOPS, card,
                    dict(bias_free=bias_free, kernel=kernel, same_bits_twice=True)))
    results["gdfn_cases"] = rows
    # cycles per phase of the Hopper tile at (1, 512, 512, 96): bf16 BiasFree,
    # and a model shard's part (fp32, 128 of 255 hidden channels)
    rng, f = np.random.default_rng(19), 255
    x = seeded(rng, 1, 512, 512, 96)
    lnw = seeded(rng, 96, scale=0.1, shift=1.0)
    w = [seeded(rng, 1, 1, 96, 2 * f, scale=96 ** -0.5), seeded(rng, 3, 3, 1, 2 * f, scale=1 / 3),
         seeded(rng, 1, 1, f, 96, scale=f ** -0.5)]
    keep = list(range(128)) + list(range(f, f + 128))  # shard 0's channels in both halves
    part = [w[0][..., keep], w[1][..., keep], w[2][:, :, :128]]
    build = dict(ptxas=_build.kernel_resources("stage_sm90_wide").get("k_ffn_wide"),
                 sass=(sass_counts("stage_sm90_wide") or {}).get("k_ffn_wide"),
                 phases={"bf16 (1,512,512,96)": phase_clocks.gdfn_phase_shares(
                             x.bfloat16(), lnw, None, *w)["k_ffn_wide"],
                         "fp32 part, 128 hidden": phase_clocks.gdfn_phase_shares(
                             x, lnw, None, *part, residual=False)["k_ffn_wide"]})
    results["gdfn_kernel_build"] = build
    log(f"LN+GDFN Hopper kernel (k_ffn_wide): ptxas {build['ptxas']}, SASS {build['sass']}, "
        f"cycles a tile {[round(v['cycles_per_tile']) for v in build['phases'].values()]}, "
        f"shares {[{k: round(c, 3) for k, c in v['share'].items()} for v in build['phases'].values()]} "
        f"[{card}]")
    assert build["sass"] is None or build["sass"]["HGMMA"] > 0, "no HGMMA in k_ffn_wide"
    return rows


def phase_block_kernel(results, card):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

    names = ("ln1_w", "ln1_b", "w_qkv", "dw_qkv", "temperature", "w_proj", "ln2_w",
             "ln2_b", "w_in", "w_dw", "w_out")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape, heads in (((1, 512, 512, 96), 1), ((1, 256, 256, 96), 2),
                             ((1, 64, 64, 48), 2), ((1, 64, 64, 48), 4),
                             ((1, 64, 64, 48), 8)):
            for bias_free in (True, False):
                rng = np.random.default_rng(200 + len(rows))
                c = shape[-1]
                f = int(c * 2.66)
                wts = {k: v[0] for k, v in
                       seeded_stage_weights(rng, 1, c, heads, f, "cuda").items()}
                wts["ln1_b"] = None if bias_free else seeded(rng, c, scale=0.5)
                wts["ln2_b"] = None if bias_free else seeded(rng, c, scale=0.5)
                args = tuple(wts[k] for k in names)
                x = seeded(rng, *shape).to(dtype)
                flops, nbytes = stage_work(*shape, 1, heads, f, x.element_size())
                rows.append(held_to_plain(
                    "block", lambda: pblock.fused_transformer_block(
                        x, *args, bias_free=bias_free, num_heads=heads),
                    lambda: pblock.block_plain(x, *args, bias_free=bias_free, num_heads=heads),
                    x, flops, nbytes, PEAK_BF16_FLOPS, card,
                    dict(heads=heads, bias_free=bias_free)))
                if bias_free and c // heads % 16 == 0:
                    # one BiasFree block is a one-block stage
                    one = pblock.fused_transformer_block(x, *args, num_heads=heads)
                    stage = pstage.fused_transformer_stage(
                        x, **{k: wts[k][None] for k in names if wts[k] is not None})
                    d = (one.float() - stage.float()).abs().max().item()
                    assert torch.equal(one, stage), f"block and one-block stage differ by {d}"
                    rows[-1]["max_abs_diff_to_one_block_stage"] = d
    results["block_cases"] = rows
    return rows



# ------------------------------------------------------------ phase 3 ----

def profile_request(pred, img, rate, wall_ms, card):
    """Device time of one request by kernel (torch.profiler), and the share
    of the request's wall time (an unprofiled run's) the device is busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred(img, rate)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    stage_ms = sum(ms for k, ms in kernels
                   if any(n in k for n in ("k_gram", "k_softmax", "k_apply", "k_proj", "k_ffn")))
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, stage_kernels_ms=stage_ms,
               idle_share=1 - busy_ms / wall_ms,
               top=[dict(kernel=k[:120], ms=ms) for k, ms in kernels[:12]])
    log(f"request profile {img.shape[0]}x{img.shape[1]}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle share {out['idle_share']:.3f}), stage kernels {stage_ms:.2f} ms "
        f"[{card}]")
    for row in out["top"][:6]:
        log(f"  {row['ms']:8.3f} ms  {row['kernel'][:100]}")
    return out


def stage_calls(pred, img, rate):
    """One request with CUDA events around each TransformerStage: [(stage
    module, input NCHW shape, device ms)] in call order."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.models import TransformerStage

    calls = []

    def before(mod, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        calls.append([mod, tuple(args[0].shape), ev, None])

    def after(mod, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        next(c for c in reversed(calls) if c[0] is mod)[3] = ev

    stages = [m for m in pred.model.modules() if isinstance(m, TransformerStage)]
    hooks = [m.register_forward_pre_hook(before) for m in stages]
    hooks += [m.register_forward_hook(after) for m in stages]
    try:
        pred(img, rate)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return [(m, shape, s.elapsed_time(e)) for m, shape, s, e in calls]


LARGE_SIDES = (1024, 2048)  # phase 3's requests that reach the C = 192 and 384 stages


def phase_large_requests(results, card, pred):
    """One 1024^2 and one 2048^2 bf16 request of the phase-3 predictor: the
    wide kernels (A), (P) and (F) launched once for every block of a
    gate-admitted stage at C = 192 and 384 (encoder_level3, decoder_level3,
    the latent), and none elsewhere; the 2048^2 one timed (wall of two
    requests), its stages' device ms by width (CUDA events around each
    stage) and profiled (busy, idle share, top kernels)."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

    out = {}
    for side in LARGE_SIDES:
        img = sonar_frame(side, side, side)
        pred(img, 1.0)  # warm-up: the allocator at this size
        torch.cuda.synchronize()
        before = hopper_counts()
        calls = stage_calls(pred, img, 1.0)
        after = hopper_counts()
        want = sum(len(m) for m, (b, _, h, w), _ in calls
                   if m.dim in (192, 384) and stage_gate.stage_worthwhile(
                       b, h, w, m.dim, m.num_heads, m.bias_free_ln, m.use_bias,
                       m.ffn_expansion_factor))
        got = {k: after[k] - before[k] for k in ("k_gram_wide", "k_proj_wide", "k_ffn_wide")}
        log(f"{side}^2 request: wide kernels {got} for {want} gate-admitted blocks at C = 192 "
            f"and 384 [{card}]")
        assert want > 0 and set(got.values()) == {want}, (got, want)
        by_width = {}
        for m, _, ms in calls:
            by_width[str(m.dim)] = by_width.get(str(m.dim), 0.0) + ms
        row = dict(wide_launches=got, wide_blocks=want, stage_ms_by_width=by_width,
                   stages=[dict(dim=m.dim, blocks=len(m), hw=list(shape[2:]), ms=ms)
                           for m, shape, ms in calls])
        if side == LARGE_SIDES[-1]:
            wall = []
            for _ in range(2):
                t0 = time.perf_counter()
                pred(img, 1.0)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            row.update(wall_ms=wall, profile=profile_request(pred, img, 1.0, min(wall), card))
            log(f"  stage ms by width {by_width}; wall {wall} ms [{card}]")
        out[str(side)] = row
    results["large_requests"] = out
    return out


def sonar_frame(h, w, seed):
    """uint8 RGB speckle-like noise with a fan of exact zeros around it."""
    rng = np.random.default_rng(seed)
    img = (rng.gamma(2.0, 40.0, size=(h, w, 1)).clip(1, 255)
           * np.ones((1, 1, 3))).astype(np.uint8)
    img = np.maximum(img, 1)
    yy, xx = np.mgrid[0:h, 0:w]
    angle = np.abs(np.arctan2(xx - w / 2, yy + 1.0))
    img[(angle > 0.75) | (np.hypot(xx - w / 2, yy) > 0.95 * h)] = 0
    return img


def phase_slice(results, card):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import (
        TeacherPredictor,
        highest_precision,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.models import (
        TransformerStage,
        flagship_teacher,
        init_weights_,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.models import kdlae_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

    model = init_weights_(flagship_teacher(static="train"),
                          torch.Generator().manual_seed(0))
    # the weights' dtype is the compute dtype: cast the model for bf16 serving
    pred = TeacherPredictor(model.to(torch.bfloat16), fused=True, dtype=torch.bfloat16)
    frames = [(sonar_frame(512, 512, 0), 1.0), (sonar_frame(512, 512, 1), 0.6),
              (sonar_frame(500, 380, 4), 1.0)]

    # what the gate admits, read off each stage's input shape in the run
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape))) or None)
        for m in pred.model.modules() if isinstance(m, TransformerStage)]

    def predicted(entries):
        return sum(stage_gate.stage_worthwhile(
            b, h, w, m.dim, m.num_heads, m.bias_free_ln, m.use_bias,
            m.ffn_expansion_factor) for m, (b, _, h, w) in entries)

    pred(*frames[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    seen.clear()
    counts = reset_counts()
    outs, lat_ms, want = [], [], 0
    for img, rate in frames:
        n0 = len(seen)
        t0 = time.perf_counter()
        out = pred(img, rate)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        want_i = predicted(seen[n0:])
        want += want_i
        outs.append(out)
        if img.shape[:2] == (512, 512):
            assert want_i == 5, f"gate admits {want_i} stages at 512^2, not 5"
    launches = read_counts(counts)["stage"]
    for h in hooks:
        h.remove()
    log(f"whole-image path: {launches} stage-kernel calls over {len(frames)} requests "
        f"(gate predicts {want})")
    assert launches == want, (launches, want)

    # the same predictor with the plain stage on the card
    plain_model_stage = kdlae_teacher.fused_transformer_stage
    kdlae_teacher.fused_transformer_stage = pstage.stage_plain
    try:
        ref_outs = [pred(img, rate) for img, rate in frames]
    finally:
        kdlae_teacher.fused_transformer_stage = plain_model_stage

    agree = []
    for (img, rate), out, ref in zip(frames, outs, ref_outs):
        h, w = img.shape[:2]
        mask = np.all(img == 0, axis=-1)
        for key, s in (("hq", 1), ("sr", 2)):
            o = out[key]
            assert o.dtype == np.uint8 and o.shape == (h * s, w * s, 3), (key, o.shape)
            m = np.repeat(np.repeat(mask, s, 0), s, 1)
            assert not o[m].any(), f"{key}: zero-mask pixels not 0"
            d = np.abs(o.astype(np.int16) - ref[key].astype(np.int16))
            frac = float((d <= 1).mean())
            agree.append(dict(shape=[h, w], rate=rate, key=key,
                              within_1_level=frac, max_levels=int(d.max())))
            assert frac >= 0.99, f"{key}: only {frac:.4f} of pixels within 1 level"

    # finite float outputs of the fused model
    with torch.inference_mode():
        x = torch.from_numpy(frames[0][0]).cuda().permute(2, 0, 1)[None]
        x = (x.float() / 255).bfloat16()
        o = pred.model({"img": x, "denoise_rate": torch.ones_like(x[:, :1])})
        assert all(torch.isfinite(v).all().item() for v in o.values())

    results.update(main_path_launches=launches, gate_predicted=want,
                   latency_ms=lat_ms, agreement=agree,
                   request_profile=profile_request(pred, *frames[0],
                                                   min(lat_ms[:2]), card))
    for (img, rate), ms in zip(frames, lat_ms):
        log(f"request {img.shape[0]}x{img.shape[1]} rate {rate}: {ms:.2f} ms [{card}]")
    counts = reset_counts()
    phase_large_requests(results, card, pred)
    return launches + read_counts(counts)["stage"], lat_ms, pred


# ------------------------------------------------------------ phase 4 ----

def level1_blocks(bias_free, fused, seed):
    """The flagship decoder_level1 geometry, 4 x TransformerBlock(96, 1 head),
    seeded like the teacher, a WithBias LayerNorm with non-zero biases."""
    import torch
    from torch import nn

    from rethink_acoustic_image_enhancement_tpu_torch.models import init_weights_
    from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import TransformerBlock

    gen = torch.Generator().manual_seed(seed)
    blocks = init_weights_(nn.Sequential(*[
        TransformerBlock(96, 1, bias_free_ln=bias_free, fused=fused) for _ in range(4)]), gen)
    with torch.no_grad():
        for name, p in blocks.named_parameters():
            if name.endswith("body.bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return blocks.to(device="cuda", dtype=torch.bfloat16).eval()


def ops_path_block(blk, x):
    """One TransformerBlock composed from the public LayerNorm and LN+GDFN
    functions (NHWC), the attention between them eager."""
    from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import flax_block_tree
    from rethink_acoustic_image_enhancement_tpu_torch.ops.gdfn import fused_ln_gdfn
    from rethink_acoustic_image_enhancement_tpu_torch.ops.layernorm import (
        fused_channel_layernorm,
    )

    p = flax_block_tree(blk)
    bias_free = blk.bias_free_ln
    xn = fused_channel_layernorm(x, p["norm1"]["weight"], p["norm1"].get("bias"), bias_free)
    r = x + blk.attn(xn.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return fused_ln_gdfn(r.contiguous(), p["norm2"]["weight"], p["norm2"].get("bias"),
                         p["ffn"]["project_in"]["kernel"], p["ffn"]["dwconv"]["kernel"],
                         p["ffn"]["project_out"]["kernel"], bias_free=bias_free)


def phase_block_paths(results, card):
    """(1, 96, 512, 512) bf16 through 4 blocks: fused=True (block kernel)
    and the LayerNorm + LN+GDFN composition, against the eager blocks
    (fused=False) in float32."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn

    paths, totals = [], dict(block=0, layernorm=0, gdfn=0)
    for bias_free in (True, False):
        fused = level1_blocks(bias_free, True, seed=3)
        eager = level1_blocks(bias_free, False, seed=3)
        x = seeded(np.random.default_rng(11), 1, 96, 512, 512, scale=0.5).bfloat16()
        with torch.inference_mode():
            # the reference: the same eager blocks in float32 (in bf16 the
            # eager blocks round after every op and are themselves a few
            # bf16 ulps off)
            ref = level1_blocks(bias_free, False, seed=3).float()(x.float())
            fused(x)  # warm-up
            torch.cuda.synchronize()

            counts = reset_counts()
            t0 = time.perf_counter()
            got = fused(x)
            torch.cuda.synchronize()
            block_ms = (time.perf_counter() - t0) * 1e3
            n_block = read_counts(counts)

            counts = reset_counts()
            sm90_before = pgdfn.gdfn_sm90.launches
            y = x.permute(0, 2, 3, 1).contiguous()
            for blk in eager:
                y = ops_path_block(blk, y)
            torch.cuda.synchronize()
            n_ops = read_counts(counts)
            n_sm90 = pgdfn.gdfn_sm90.launches - sm90_before
            via_ops = y.permute(0, 3, 1, 2)
            eager_ms = cuda_ms(lambda: eager(x), 2)
        scale = ref.float().abs().max().item()
        rel_block = (got.float() - ref.float()).abs().max().item() / scale
        rel_ops = (via_ops.float() - ref.float()).abs().max().item() / scale
        row = dict(bias_free=bias_free, block_calls=n_block["block"],
                   layernorm_calls=n_ops["layernorm"], gdfn_calls=n_ops["gdfn"],
                   rel_err_block_path=rel_block, rel_err_ops_path=rel_ops,
                   fused_wall_ms=block_ms, eager_ms=eager_ms)
        paths.append(row)
        log(f"per-block paths (1,96,512,512) bf16 x4 blocks {row} [{card}]")
        none = dict(stage_bands=0, stage_shards=0, gdfn_part=0)
        assert n_block == dict(stage=0, layernorm=0, gdfn=0, block=4, **none), n_block
        assert n_ops == dict(stage=0, layernorm=4, gdfn=4, block=0, **none), n_ops
        assert n_sm90 == n_ops["gdfn"], ("the LN+GDFN launches at C = 96 are the Hopper "
                                         f"kernel's: {n_sm90} of {n_ops['gdfn']}")
        assert torch.isfinite(got).all().item() and torch.isfinite(via_ops).all().item()
        assert rel_block <= TOL_PATH and rel_ops <= TOL_PATH, (rel_block, rel_ops)
        totals["block"] += n_block["block"]
        totals["layernorm"] += n_ops["layernorm"]
        totals["gdfn"] += n_ops["gdfn"]
    results["block_paths"] = paths
    return totals


# ------------------------------------------------------------ phase 5 ----

def phase_tiled(results, card, pred):
    """denoise_tiled at full width: 256x256 tiles and full-width strips, 8
    per call, against the same calls with the plain stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rethink_acoustic_image_enhancement_tpu_torch.models import TransformerStage
    from rethink_acoustic_image_enhancement_tpu_torch.models import kdlae_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

    imgs = [sonar_frame(512, 512, 5), sonar_frame(512, 512, 6), sonar_frame(500, 380, 7)]
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape))) or None)
        for m in pred.model.modules() if isinstance(m, TransformerStage)]
    modes = [dict(tile=256, halo=0, tile_batch=8),
             dict(tile=(256, 512), halo=(8, 0), tile_batch=8)]
    rows, total = [], 0
    for kw in modes:
        pred.denoise_tiled(imgs, 0.8, **kw)  # warm-up: cuDNN plans at this batch
        torch.cuda.synchronize()
        seen.clear()
        counts = reset_counts()
        t0 = time.perf_counter()
        outs = pred.denoise_tiled(imgs, 0.8, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counts(counts)["stage"]
        admitted = [(m, shp) for m, shp in seen if stage_gate.stage_worthwhile(
            shp[0], shp[2], shp[3], m.dim, m.num_heads, m.bias_free_ln, m.use_bias,
            m.ffn_expansion_factor)]
        stage_shapes = sorted({shp for _, shp in admitted})
        chunks = sum(1 for m, _ in seen if m is pred.model.encoder_level1)
        assert launches == len(admitted) > 0, (launches, len(admitted))
        assert all(shp[0] == 8 for shp in stage_shapes), stage_shapes

        plain_model_stage = kdlae_teacher.fused_transformer_stage
        kdlae_teacher.fused_transformer_stage = pstage.stage_plain
        try:
            refs = pred.denoise_tiled(imgs, 0.8, **kw)
        finally:
            kdlae_teacher.fused_transformer_stage = plain_model_stage
        agree = []
        for img, out, ref in zip(imgs, outs, refs):
            h, w = img.shape[:2]
            mask = np.all(img == 0, axis=-1)
            for key, s in (("hq", 1), ("sr", 2)):
                o = out[key]
                assert o.dtype == np.uint8 and o.shape == (h * s, w * s, 3), (key, o.shape)
                m = np.repeat(np.repeat(mask, s, 0), s, 1)
                assert not o[m].any(), f"{key}: zero-mask pixels not 0"
                d = np.abs(o.astype(np.int16) - ref[key].astype(np.int16))
                frac = float((d <= 1).mean())
                agree.append(dict(shape=[h, w], key=key, within_1_level=frac,
                                  max_levels=int(d.max())))
                assert frac >= 0.99, f"{key}: only {frac:.4f} of pixels within 1 level"

        # a call that is exactly one chunk of 8 tiles: wall time, device busy
        # time, idle share (host prep and reassembly included)
        t_h, t_w = (kw["tile"],) * 2 if isinstance(kw["tile"], int) else kw["tile"]
        one_chunk = [sonar_frame(512, 512, 20 + i)
                     for i in range(8 * t_h * t_w // (512 * 512))]
        t0 = time.perf_counter()
        pred.denoise_tiled(one_chunk, 0.8, **kw)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pred.denoise_tiled(one_chunk, 0.8, **kw)
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.self_device_time_total > 0]
        busy_ms = sum(ms for _, ms in kernels)
        stage_ms = sum(ms for k, ms in kernels
                       if any(n in k for n in ("k_gram", "k_softmax", "k_apply")))
        row = dict(kw, images=len(imgs), chunks=chunks, stage_calls=launches,
                   gate_predicted=len(admitted), stage_shapes=[list(t) for t in stage_shapes],
                   wall_s=wall_s, images_per_s=len(imgs) / wall_s, chunk_wall_ms=chunk_ms,
                   chunk_device_busy_ms=busy_ms, chunk_stage_kernels_ms=stage_ms,
                   chunk_idle_share=1 - busy_ms / chunk_ms,
                   chunk_top=[dict(kernel=k[:120], ms=ms) for k, ms in
                              sorted(kernels, key=lambda kv: -kv[1])[:8]],
                   agreement=agree)
        rows.append(row)
        total += launches
        log(f"tiled path {kw}: {len(imgs)} images in {wall_s * 1e3:.1f} ms "
            f"({row['images_per_s']:.2f} images/s), {chunks} chunks, {launches} stage calls "
            f"(gate predicts {len(admitted)}) at {stage_shapes}; one chunk: wall "
            f"{chunk_ms:.2f} ms, device busy {busy_ms:.2f} ms (idle share "
            f"{row['chunk_idle_share']:.3f}), stage kernels {stage_ms:.2f} ms; "
            f"within 1 level of the plain stage: "
            f"{min(a['within_1_level'] for a in agree):.4f} [{card}]")
        for top in row["chunk_top"][:5]:
            log(f"  {top['ms']:8.3f} ms  {top['kernel'][:100]}")
    for h in hooks:
        h.remove()
    results["tiled"] = rows
    return total



# ------------------------------------------------------------ phase 6 ----

def sonar_stacks(b, f, h, w, seed):
    """(b, f, h, w) uint8 grayscale speckle frames, each stack a fan over a
    slowly moving speckle field, exact zeros outside the fan."""
    rng = np.random.default_rng(seed)
    base = rng.gamma(2.0, 40.0, size=(b, 1, h, w)).astype(np.float32)
    frames = 0.7 * base + 0.3 * rng.gamma(2.0, 40.0, size=(b, f, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    fan = (np.abs(np.arctan2(xx - w / 2, yy + 1.0)) <= 0.75) & (np.hypot(xx - w / 2, yy) <= 0.95 * h)
    return (frames.clip(0, 255) * fan).astype(np.uint8)


def within_levels(got, ref):
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return float((d <= 1).mean()), int(d.max())


def phase_student(results, card):
    import copy

    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import StudentPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAEStudent

    torch.manual_seed(0)
    model = KDLAEStudent(residual=True, hidden_channels=(16, 32, 64))
    stacks = sonar_stacks(18, 7, 512, 512, seed=30)
    crop = stacks[0, :, 192:320, 192:320]
    row = dict(card=card, stacks=list(stacks.shape), params=sum(p.numel() for p in model.parameters()))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        pred = StudentPredictor(copy.deepcopy(model), dtype=dtype)
        pred.denoise_batch(stacks)  # warm-up: cuDNN plans at this shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = pred.denoise_batch(stacks)
            walls.append(time.perf_counter() - t0)
        assert out.shape == stacks.shape and out.dtype == np.uint8, (out.shape, out.dtype)
        assert out.any(), "student output is all zero"
        frames = stacks.shape[0] * stacks.shape[1]
        cpu = StudentPredictor(copy.deepcopy(model), dtype=dtype, device="cpu")(crop)
        share, worst = within_levels(pred(crop), cpu)
        row[name] = dict(wall_s=walls, frames_per_s=frames / min(walls),
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                         cpu_crop_within_1_level=share, cpu_crop_max_levels=worst)
        log(f"student {name}: {frames} frames of 512x512 in {min(walls) * 1e3:.1f} ms "
            f"({row[name]['frames_per_s']:.1f} frames/s), peak {row[name]['peak_mem_gb']:.2f} "
            f"GiB; 7x128x128 crop vs the CPU: {share:.5f} within 1 level, max {worst} [{card}]")
        assert share >= 0.999, f"student {name}: {share} of pixels within 1 level of the CPU"
        del pred
        torch.cuda.empty_cache()
    results["student"] = row
    print(json.dumps({"student": row}), flush=True)


# ------------------------------------------------------------ phase 7 ----

def seeded_scorer_model(seed):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.models.asdqe import (
        DenoiseRatePredictor,
        init_weights_,
    )

    return init_weights_(DenoiseRatePredictor(), torch.Generator().manual_seed(seed))


def phase_asdqe(results, card):
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.eval.asdqe_eval import score_pairs
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import ASDQEScorer

    scorer = ASDQEScorer(seeded_scorer_model(7))
    rng = np.random.default_rng(40)
    pairs = []
    for i in range(16):
        lq = sonar_frame(512, 512, 40 + i)
        noise = rng.integers(-30, 31, size=lq.shape)
        pairs.append((lq, np.clip(lq.astype(np.int16) // 2 + noise, 0, 255).astype(np.uint8)))
    score_pairs(scorer, pairs[:2])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = score_pairs(scorer, pairs)
    batch1_s = time.perf_counter() - t0
    lq8 = [np.stack([p[0] for p in pairs[k:k + 8]]) for k in (0, 8)]
    gt8 = [np.stack([p[1] for p in pairs[k:k + 8]]) for k in (0, 8)]
    scorer(lq8[0], gt8[0])  # warm-up at batch 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = np.concatenate([scorer(a, b) for a, b in zip(lq8, gt8)])
    batch8_s = time.perf_counter() - t0
    assert one.shape == batched.shape == (16,) and np.isfinite(batched).all()
    lq, gt = (a[192:320, 192:320] for a in pairs[3])
    cpu = ASDQEScorer(seeded_scorer_model(7), device="cpu")(lq, gt)
    card_score = scorer(lq, gt)
    row = dict(card=card, pairs=16, size=[512, 512],
               batch1_pairs_per_s=16 / batch1_s, batch8_pairs_per_s=16 / batch8_s,
               score_range=[float(one.min()), float(one.max())],
               batch1_vs_batch8_max_abs=float(np.abs(one - batched).max()),
               cpu_128_abs_err=float(np.abs(card_score - cpu).max()))
    log(f"asdqe: 16 pairs of 512x512 batch-1 {row['batch1_pairs_per_s']:.1f} pairs/s, "
        f"batch 8 {row['batch8_pairs_per_s']:.1f} pairs/s, scores {row['score_range']}, "
        f"batch-1 vs batch-8 {row['batch1_vs_batch8_max_abs']:.2e}, 128x128 vs the CPU "
        f"{row['cpu_128_abs_err']:.2e} [{card}]")
    assert row["cpu_128_abs_err"] <= 1e-4, row
    results["asdqe"] = row
    print(json.dumps({"asdqe": row}), flush=True)


# ------------------------------------------------------------ phase 8 ----

def phase_group(results, card, pred):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor

    frames = [sonar_frame(512, 512, 60 + i) for i in range(16)]
    pred.denoise_group(frames[:8], 0.8, group_size=8)  # warm-up
    torch.cuda.synchronize()
    counts = reset_counts()
    t0 = time.perf_counter()
    grouped = pred.denoise_group(frames, 0.8, group_size=8)
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    launches = read_counts(counts)["stage"]
    t0 = time.perf_counter()
    single = [pred(f, 0.8) for f in frames]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    assert launches == 5 * len(frames), f"{launches} stage calls for {len(frames)} images"
    for g, s_ in zip(grouped, single):
        for key in ("hq", "sr"):
            assert np.array_equal(g[key], s_[key]), f"group and per-image {key} differ"

    # one group: wall time unprofiled, device time by the profiler
    t0 = time.perf_counter()
    pred.denoise_group(frames[:8], 0.8, group_size=8)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred.denoise_group(frames[:8], 0.8, group_size=8)
        torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
              if e.self_device_time_total > 0]
    copy_ms = sum(ms for k, ms in events if "memcpy" in k.lower())
    busy_ms = sum(ms for k, ms in events if "memcpy" not in k.lower())

    folded = TeacherPredictor(pred.model, fused=True, dtype=pred.dtype, fused_resample=True)
    resampled = folded(frames[0], 0.8)
    agree = {key: within_levels(resampled[key], single[0][key]) for key in ("hq", "sr")}
    row = dict(card=card, images=len(frames), group_size=8, stage_calls=launches,
               group_images_per_s=len(frames) / group_s,
               per_image_images_per_s=len(frames) / single_s,
               bit_identical=True, one_group_wall_ms=one_ms,
               one_group_kernels_ms=busy_ms, one_group_memcpy_ms=copy_ms,
               one_group_idle_share=1 - busy_ms / one_ms,
               one_group_top=[dict(kernel=k[:120], ms=ms) for k, ms in
                              sorted(events, key=lambda kv: -kv[1])[:8]],
               fused_resample_within_1_level={k: v[0] for k, v in agree.items()},
               fused_resample_max_levels={k: v[1] for k, v in agree.items()})
    log(f"group: 16 x 512x512 bf16 in groups of 8 {row['group_images_per_s']:.2f} images/s, "
        f"per image {row['per_image_images_per_s']:.2f} images/s, bit-identical, "
        f"{launches} stage calls; one group: wall {one_ms:.1f} ms, kernels {busy_ms:.1f} ms, "
        f"copies {copy_ms:.1f} ms (idle share {row['one_group_idle_share']:.3f}); "
        f"fused_resample within 1 level {row['fused_resample_within_1_level']} [{card}]")
    for top in row["one_group_top"][:5]:
        log(f"  {top['ms']:8.3f} ms  {top['kernel'][:100]}")
    assert all(v[0] >= 0.99 for v in agree.values()), agree
    results["group"] = row
    print(json.dumps({"group": row}), flush=True)
    return launches

# ------------------------------------------------------------ phase 9 ----

def run_cli(argv):
    """cli.main(argv) on the card: (its stdout, wall seconds); fails on a
    non-zero exit."""
    import contextlib
    import io

    import torch

    from rethink_acoustic_image_enhancement_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rc == 0, (argv, rc, buf.getvalue()[-2000:])
    log(f"  cli {' '.join(a for a in argv if '/' not in a)}: {wall:.2f} s")
    return buf.getvalue(), wall


def decoded(folder, gray=False):
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import (
        imread_gray,
        imread_rgb_ubyte,
        list_images,
    )

    read = imread_gray if gray else imread_rgb_ubyte
    return {os.path.basename(p): read(p) for p in list_images(folder)}


def png_filtered(img, kinds):
    """PNG bytes of uint8 HWC ``img`` whose row y uses row filter
    ``kinds[y % len(kinds)]``, as libpng's adaptive encoder mixes them."""
    import struct
    import zlib

    from rethink_acoustic_image_enhancement_tpu_torch.utils import png

    h, w, bpp = img.shape
    x = img.astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :w]  # left
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:h]  # up
    c = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:h, :w]  # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kind = np.array([kinds[y % len(kinds)] for y in range(h)], np.uint8)
    pred = np.stack([0 * x, a, b, (a + b) >> 1, paeth])[kind, np.arange(h)]
    rows = np.concatenate([kind[:, None], ((x - pred) % 256).astype(np.uint8).reshape(h, -1)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, png._COLOR_TYPE[bpp], 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + png._chunk(b"IEND", b""))


def phase_zoo_cli(results, card, work):
    """The trained zoo (artifacts/torch_zoo/) through the port's CLI on the
    card, files in and out under ``work``; the trained bf16 teacher through
    the stage kernel."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import (
        TeacherPredictor,
        highest_precision,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.models import (
        TransformerStage,
        flagship_teacher,
        kdlae_teacher,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import flax_block_tree
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate
    from rethink_acoustic_image_enhancement_tpu_torch.ops.stage import stack_block_params
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    zoo = os.path.join(HERE, "artifacts", "torch_zoo")
    teacher = flagship_teacher(static="train")
    t0 = time.perf_counter()
    load_pth(teacher, os.path.join(zoo, "teacher.pth"))
    load_ms = (time.perf_counter() - t0) * 1e3

    src, gray, crop = (os.path.join(work, d) for d in ("in", "gray", "crop"))
    frames = [sonar_frame(512, 512, 80 + i) for i in range(16)]
    for i, f in enumerate(frames):
        imwrite(os.path.join(src, f"f{i:02d}.png"), f)
    for i, f in enumerate(sonar_stacks(1, 14, 512, 512, seed=90)[0]):
        imwrite(os.path.join(gray, f"g{i:02d}.png"), f, rgb=False)
    h, w = frames[0].shape[:2]
    imwrite(os.path.join(crop, "crop.png"),
            frames[0][h // 2 - 48:h // 2 + 48, w // 2 - 48:w // 2 + 48])

    def out(name):
        return os.path.join(work, name)

    row = dict(card=card, zoo_load_ms=load_ms, images=16, size=[h, w])
    modes = {"per_image": [], "group8": ["--group-size", "8"], "tile256": ["--tile", "256"]}
    got = {}
    for mode, extra in modes.items():
        _, wall = run_cli(["infer-teacher", "--weights", "teacher", "--input", src,
                           "--output", out(mode), *extra])
        got[mode] = decoded(out(mode))
        assert len(got[mode]) == 16, (mode, len(got[mode]))
        row[f"infer_teacher_{mode}"] = dict(wall_s=wall, images_per_s=16 / wall)
    _, wall = run_cli(["infer-teacher", "--weights", "teacher", "--sr", "--output", out("sr"),
                       "--input", os.path.join(src, "f00.png")])
    sr = decoded(out("sr"))
    assert sr["sr_f00.png"].shape == (2 * h, 2 * w, 3) and sr["f00.png"].shape == (h, w, 3)
    row["infer_teacher_sr_one_image_s"] = wall

    stdout, wall = run_cli(["serve", "--weights", "teacher", "--watch", src,
                            "--output", out("serve"), "--once"])
    preflight = json.loads(stdout.split("[serve] preflight: ", 1)[1].splitlines()[0])
    assert preflight["status"] == "ok" and preflight["platform"] == "gpu", preflight
    served = decoded(out("serve"))
    mtimes = {f: os.path.getmtime(os.path.join(out("serve"), f)) for f in served}
    stdout2, wall2 = run_cli(["serve", "--weights", "teacher", "--watch", src,
                              "--output", out("serve"), "--once", "--preflight-timeout", "0"])
    assert "served 0 image(s)" in stdout2, stdout2[-500:]
    assert {f: os.path.getmtime(os.path.join(out("serve"), f))
            for f in os.listdir(out("serve"))} == mtimes, "the second serve wrote files"
    row["serve"] = dict(wall_s=wall, images_per_s=16 / wall, second_wall_s=wall2,
                        second_served=0)
    row["preflight"] = preflight
    for name, outs in (("group8", got["group8"]), ("serve", served)):
        for f, img in got["per_image"].items():
            assert np.array_equal(outs[f], img), f"{name} {f} differs from per-image"
    mask = np.all(frames[0] == 0, axis=-1)
    assert not got["per_image"]["f00.png"][mask].any(), "zero-mask pixels not 0"

    # a 96x96 crop through the CLI on the card and on the CPU
    run_cli(["infer-teacher", "--weights", "teacher", "--input", crop, "--output", out("crop_gpu")])
    run_cli(["infer-teacher", "--weights", "teacher", "--input", crop, "--output", out("crop_cpu"),
             "--device", "cpu"])
    share, crop_worst = within_levels(decoded(out("crop_gpu"))["crop.png"],
                                      decoded(out("crop_cpu"))["crop.png"])
    row["crop96_vs_cpu"] = dict(within_1_level=share, max_levels=crop_worst)
    assert crop_worst <= 1, f"96x96 crop: {crop_worst} levels from the CPU"

    _, wall = run_cli(["infer-student", "--weights", "student-us", "--input", gray,
                       "--output", out("student"), "--all"])
    stu = decoded(out("student"), gray=True)
    assert len(stu) == 14 and all(np.isfinite(v).all() for v in stu.values())
    row["infer_student"] = dict(frames=14, wall_s=wall, frames_per_s=14 / wall)
    csv_path = out("scores.csv")
    _, wall = run_cli(["score", "--lq-dir", src, "--methods", f"teacher={out('per_image')}",
                       "--csv", csv_path])
    with open(csv_path) as fh:
        assert len(fh.read().splitlines()) >= 2, "empty score CSV"
    row["score"] = dict(pairs=16, wall_s=wall, pairs_per_s=16 / wall)

    # reading one 512x512 RGB PNG, written unfiltered (as imwrite writes) and
    # with the row filters libpng mixes (Paeth and Average rows are the slow
    # ones for the numpy decoder): through the CLI's reader (cv2, PIL or the
    # numpy decoder, whichever this machine has) and through the numpy
    # decoder itself
    from rethink_acoustic_image_enhancement_tpu_torch.utils import image_io, png

    route = "cv2" if image_io._cv2() else "PIL" if image_io._pil() else "numpy"
    row["png_read_ms"] = dict(cli_route=route)
    for label, kinds in (("unfiltered", (0,)), ("paeth", (4,)), ("all_five", (0, 1, 2, 3, 4))):
        path = os.path.join(work, f"filtered_{label}.png")
        with open(path, "wb") as fh:
            fh.write(png_filtered(frames[0], kinds))
        for reader, read in (("cli", image_io.imread_rgb_ubyte), ("numpy", png.read)):
            t0 = time.perf_counter()
            got_img = read(path)
            row["png_read_ms"][f"{reader}_{label}"] = (time.perf_counter() - t0) * 1e3
            assert np.array_equal(got_img, frames[0]), f"{label} PNG: {reader} read it wrong"

    # the trained teacher in bf16 through the stage kernel, on the stage
    # inputs of a trained request: the kernel held to its plain version block
    # by block, and whole stages inside the fan (stage pixels with a non-zero
    # input pixel; outside it the stage input is 0, each block grows features
    # there from the fan's edge, and the rounding of those near-zero features
    # gets amplified; the predictor writes 0 there). The outputs: the fused
    # path as far from the fp32 teacher as the same predictor with the plain
    # stage. Recorded, not held: the agreement with fused=False, the eager
    # bf16 blocks, which round every op and sit further from fp32
    fp32 = TeacherPredictor(teacher)
    model = teacher.to(torch.bfloat16)
    fused = TeacherPredictor(model, fused=True, dtype=torch.bfloat16)
    eager = TeacherPredictor(model, dtype=torch.bfloat16)
    reqs = [(frames[1], 1.0), (frames[2], 0.6)]
    stage_inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: stage_inputs.append((name, mod, args[0])) or None)
        for name, m in fused.model.named_modules() if isinstance(m, TransformerStage)]
    fused(*reqs[0])  # warm-up, and the stage inputs of a trained request
    for hk in hooks:
        hk.remove()
    torch.cuda.synchronize()
    counts = reset_counts()
    outs = [fused(img, rate) for img, rate in reqs]
    torch.cuda.synchronize()
    launches = read_counts(counts)
    assert launches == dict(stage=5 * len(reqs), layernorm=0, gdfn=0, block=0,
                            stage_bands=0, stage_shards=0, gdfn_part=0), launches
    def rel(got, ref, where=None):
        d = (got.float() - ref.float()).abs()
        d = d if where is None else d * where
        return (d.max() / ref.float().abs().max()).item()

    def fan_split(got, ref, outside):
        return dict(inside_fan=rel(got, ref, ~outside), outside_fan=rel(got, ref, outside))

    zero = np.all(reqs[0][0] == 0, axis=-1)
    fp32_stages = dict(fp32.model.named_modules())
    kernel_rel, stage_rel, plain_vs_fp32 = [], [], []
    for name, mod, x in stage_inputs:
        b, _, hh, ww = x.shape
        if not stage_gate.stage_worthwhile(b, hh, ww, mod.dim, mod.num_heads,
                                           mod.bias_free_ln, mod.use_bias,
                                           mod.ffn_expansion_factor):
            continue
        f = h // hh  # stage pixels whose input pixels are all 0
        outside = torch.from_numpy(zero.reshape(hh, f, ww, f).all(axis=(1, 3))).to(x.device)
        outside = outside[None, :, :, None]
        xin = x.permute(0, 2, 3, 1).contiguous()
        stacked = stack_block_params([flax_block_tree(blk) for blk in mod])
        plain = pstage.stage_plain(xin, **stacked)
        stage_rel.append(dict(stage=name, **fan_split(
            pstage.fused_transformer_stage(xin, **stacked), plain, outside)))
        with torch.inference_mode(), highest_precision():  # the eager fp32 stage
            ref32 = fp32_stages[name](x.float()).permute(0, 2, 3, 1)
        plain_vs_fp32.append(dict(stage=name, **fan_split(plain, ref32, outside)))
        y, worst = xin, 0.0
        for i in range(len(mod)):  # each block on the plain chain's input
            one = {k: v[i:i + 1] for k, v in stacked.items()}
            ref = pstage.stage_plain(y, **one)
            worst = max(worst, rel(pstage.fused_transformer_stage(y, **one), ref))
            y = ref.float()
        kernel_rel.append(worst)
    plain_model_stage = kdlae_teacher.fused_transformer_stage
    kdlae_teacher.fused_transformer_stage = pstage.stage_plain
    try:
        plain_outs = [fused(img, rate) for img, rate in reqs]
    finally:
        kdlae_teacher.fused_transformer_stage = plain_model_stage
    agree = []
    for (img, rate), o, plain in zip(reqs, outs, plain_outs):
        ref32, ref_eager = fp32(img, rate), eager(img, rate)
        mask = np.all(img == 0, axis=-1)
        for key, s_ in (("hq", 1), ("sr", 2)):
            assert o[key].shape == (h * s_, w * s_, 3), (key, o[key].shape)
            assert not o[key][np.repeat(np.repeat(mask, s_, 0), s_, 1)].any(), key
            share, worst = within_levels(o[key], plain[key])
            agree.append(dict(
                rate=rate, key=key, vs_plain_stage_within_1_level=share,
                vs_plain_stage_max_levels=worst,
                vs_unfused_within_1_level=within_levels(o[key], ref_eager[key])[0],
                fused_vs_fp32_over_1_level=1 - within_levels(o[key], ref32[key])[0],
                plain_stage_vs_fp32_over_1_level=1 - within_levels(plain[key], ref32[key])[0],
                unfused_vs_fp32_over_1_level=1 - within_levels(ref_eager[key], ref32[key])[0]))
    log(f"trained bf16 teacher, stage kernel vs plain on its {len(kernel_rel)} stage inputs: "
        f"worst block rel {['%.2e' % r for r in kernel_rel]}, whole stage rel "
        f"{stage_rel} (plain vs the fp32 stage {plain_vs_fp32}); {agree} [{card}]")
    assert len(kernel_rel) == 5 and max(kernel_rel) <= TOL_REL, kernel_rel
    assert max(r["inside_fan"] for r in stage_rel) <= TOL_REL, stage_rel
    for a in agree:
        assert (a["fused_vs_fp32_over_1_level"]
                <= 1.1 * a["plain_stage_vs_fp32_over_1_level"] + 0.002), a
    row["trained_fused_bf16"] = dict(stage_calls=launches["stage"],
                                     block_kernel_vs_plain_rel=kernel_rel,
                                     stage_kernel_vs_plain_rel=stage_rel,
                                     stage_plain_vs_fp32_rel=plain_vs_fp32, agreement=agree)
    log(f"zoo + CLI: teacher.pth load {load_ms:.1f} ms; infer-teacher images/s "
        + ", ".join(f"{m} {row[f'infer_teacher_{m}']['images_per_s']:.2f}" for m in modes)
        + f"; serve {row['serve']['images_per_s']:.2f} (second run served 0); student "
        f"{row['infer_student']['frames_per_s']:.2f} frames/s; score "
        f"{row['score']['pairs_per_s']:.2f} pairs/s; crop vs CPU max {crop_worst} levels; "
        f"512^2 PNG read ms {row['png_read_ms']}; "
        f"trained bf16 teacher: {launches['stage']} stage calls, block kernel vs plain rel <= "
        f"{max(kernel_rel):.2e}, whole stage inside the fan <= "
        f"{max(r['inside_fan'] for r in stage_rel):.2e}, more than 1 level from fp32: fused "
        f"{max(a['fused_vs_fp32_over_1_level'] for a in agree):.4f}, plain stage "
        f"{max(a['plain_stage_vs_fp32_over_1_level'] for a in agree):.4f}, unfused "
        f"{max(a['unfused_vs_fp32_over_1_level'] for a in agree):.4f} [{card}]")
    results["zoo_cli"] = row
    print(json.dumps({"zoo_cli": row}), flush=True)
    return launches["stage"]


# ------------------------------------------------------------ phase 10 ---

TRAIN_ITERS = [3, 3, 2, 2, 2, 2]  # all six curriculum stages in 14 steps


def write_train_corpus(root, n, seed):
    """n seeded sonar triples under ``root``: a speckled 256x256 input, its
    clear target (a 5x5 box mean inside the fan), the 512x512 SR target and
    a JSON denoise rate. Returns the four dataroots."""
    import json as _json

    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("lq", "gt", "sr", "param")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        noisy = sonar_frame(256, 256, seed * 1000 + i)
        fan = noisy[..., :1] > 0
        pad = np.pad(noisy.astype(np.float32), ((2, 2), (2, 2), (0, 0)), mode="edge")
        box = sum(pad[dy:dy + 256, dx:dx + 256] for dy in range(5) for dx in range(5)) / 25
        clear = np.where(fan, box, 0).round().astype(np.uint8)
        name = f"s{i:03d}"
        imwrite(os.path.join(dirs["lq"], name + ".png"), noisy)
        imwrite(os.path.join(dirs["gt"], name + ".png"), clear)
        imwrite(os.path.join(dirs["sr"], name + ".png"),
                np.repeat(np.repeat(clear, 2, 0), 2, 1))
        with open(os.path.join(dirs["param"], name + ".json"), "w") as fh:
            _json.dump({"denoise_rate": round(float(rng.uniform(0.3, 1.0)), 3)}, fh)
    return {f"dataroot_{k}": d for k, d in dirs.items()}


def jsonl_events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def train_step_on(device, opt, seed):
    """One seeded step of the full-width teacher at KDLAET.yml's settings
    on ``device``: a (2, 3, 128, 128) batch cut to 64, extra mask 0.1,
    mixup; every draw on the host, so the same on both devices."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop

    _, trainer = tloop.build_everything(opt, device=device)
    state = trainer.init_state()
    rng = np.random.default_rng(seed)
    img = rng.random((2, 3, 128, 128), dtype=np.float32)
    hq = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lq = {"img": t(img), "denoise_rate": t(np.full((2, 1, 128, 128), 0.7, np.float32))}
    gt = {"hq": t(hq), "sr": t(hq.repeat(2, 2).repeat(2, 3))}
    state, m = trainer.step(state, lq, gt, np.random.default_rng(seed + 1),
                            extra_prob=0.1, mini_gt_size=64)
    return ({k: float(v) for k, v in m.items()},
            {n: p.detach().cpu() for n, p in state.model.named_parameters()},
            {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()})


def profile_step(step, label, card):
    """``step(k)`` in its steady state on the card: wall ms (synchronised)
    and the host's enqueue ms of three unprofiled calls, then one traced
    call (``utils/profiling.py``: the trace's device ms by kernel, the same
    reader as ``train --profile-steps``): its device busy ms, idle share,
    kernel events and host-to-device copies; and one more call's
    host-to-device copies as the dispatcher sees them (``uploads``: a trace
    can lose copies)."""
    import shutil

    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.utils import profiling

    for k in range(3):  # shapes, plans and the allocator settle
        step(k)
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for k in range(3):
        t0 = time.perf_counter()
        step(10 + k)
        enqueues.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    trace_dir = tempfile.mkdtemp(prefix="raie_profile_")
    try:
        with profiling.trace(trace_dir):
            step(20)
            torch.cuda.synchronize()
        ms_by_kernel, events = profiling.aggregate_trace(trace_dir)
        traced_h2d = profiling.h2d_copies(trace_dir)
    finally:
        shutil.rmtree(trace_dir)
    with profiling.uploads() as h2d:
        step(21)
        torch.cuda.synchronize()
    busy = sum(ms_by_kernel.values())
    wall = float(np.median(walls))
    out = dict(wall_ms=walls, enqueue_ms=enqueues, device_busy_ms=busy,
               idle_share=1 - busy / wall, kernel_launches=events, h2d_copy_bytes=h2d,
               traced_h2d_copy_bytes=traced_h2d,
               top=[dict(kernel=k[:120], ms=ms) for k, ms in list(ms_by_kernel.items())[:8]])
    log(f"{label}: wall {wall:.1f} ms, host enqueue {np.median(enqueues):.1f} ms, device busy "
        f"{busy:.1f} ms (idle share {out['idle_share']:.3f}), {events} kernel events, "
        f"{len(h2d)} host-to-device copies of {sum(h2d)} bytes ({len(traced_h2d)} in the "
        f"trace) [{card}]")
    for row in out["top"][:5]:
        log(f"  {row['ms']:8.3f} ms  {row['kernel'][:90]}")
    return out


def profile_train_step(opt, batch, patch, card):
    """One steady-state training step of the full-width teacher at
    (batch, patch) on the card (``profile_step``)."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop

    _, trainer = tloop.build_everything(opt, device="cuda")
    state = trainer.init_state()
    rng = np.random.default_rng(11)
    img = torch.from_numpy(rng.random((batch, 3, patch, patch), dtype=np.float32)).cuda()
    lq = {"img": img, "denoise_rate": torch.full((batch, 1, patch, patch), 0.7).cuda()}
    gt = {"hq": img.clamp(0.05, 0.95), "sr": img.repeat_interleave(2, 2).repeat_interleave(2, 3)}

    def step(k):
        return trainer.step(state, lq, gt, np.random.default_rng(k), extra_prob=0.1)

    out = dict(batch=batch, patch=patch,
               **profile_step(step, f"train step {batch}@{patch}", card))
    del state, trainer
    torch.cuda.empty_cache()
    return out


def phase_train(results, card, work):
    """Phase 10: train the full-width KDLAE-T of configs/KDLAET.yml through
    the port's CLI on a synthetic corpus, resume it, serve and test what it
    wrote, and hold one step on the card to the same step on the CPU."""
    import torch
    import yaml

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth, read_pth
    from rethink_acoustic_image_enhancement_tpu_torch.models import flagship_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import ProgressiveSchedule
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    t_phase = time.perf_counter()
    train_roots = write_train_corpus(os.path.join(work, "train"), 24, seed=200)
    val_roots = write_train_corpus(os.path.join(work, "val"), 2, seed=300)
    corpus_s = time.perf_counter() - t_phase
    with open(os.path.join(HERE, "configs", "KDLAET.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["datasets"]["train"].update(train_roots, iters=TRAIN_ITERS)
    cfg["datasets"]["val"].update(val_roots)
    cfg["train"]["total_iter"] = sum(TRAIN_ITERS)
    cfg["logger"].update(save_checkpoint_freq=7, print_freq=1)
    cfg["val"]["val_freq"] = 7
    yml = os.path.join(work, "KDLAET.yml")
    with open(yml, "w") as fh:
        yaml.safe_dump(cfg, fh)
    opt = tcfg.parse(yml, is_train=True, root_path=work)
    exp = opt["path"]["experiments_root"]

    fns = reset_counts()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    os.chdir(work)  # the CLI roots experiments/ and results/ in its cwd
    try:
        _, train_wall = run_cli(["train", "-opt", yml])
        peak = torch.cuda.max_memory_allocated()
        launches = read_counts(fns)
        events = jsonl_events(os.path.join(exp, "metrics.jsonl"))
        steps = [e for e in events if e["kind"] == "train"]
        assert [e["iter"] for e in steps] == list(range(1, 15)), [e["iter"] for e in steps]
        assert all(np.isfinite(e["l_pix"]) and np.isfinite(e["grad_norm"]) for e in steps)
        for it in (7, 14):
            assert os.path.isfile(os.path.join(opt["path"]["training_states"], f"ckpt_{it}.pth"))
            assert os.path.isfile(os.path.join(opt["path"]["models"], f"net_g_{it}.pth"))
        vals = [e for e in events if e["kind"] == "val"]
        assert [e["iter"] for e in vals] == [7, 14], vals
        assert all(np.isfinite(e["psnr"]) and np.isfinite(e["psnr_sr"]) for e in vals), vals
        saves = [e for e in events if e["kind"] == "ckpt"]
        assert [e["iter"] for e in saves] == [7, 14], saves

        net14 = os.path.join(opt["path"]["models"], "net_g_14.pth")
        init, _ = tloop.build_everything(opt, device="cpu")
        trained = read_pth(net14)
        still = [n for n, v in init.state_dict().items() if torch.equal(v, trained[n])]
        assert not still, f"parameters that did not move: {still[:5]}"

        # resume: total_iter 16 continues from ckpt_14 and runs 2 steps
        cfg["train"]["total_iter"] = 16
        with open(yml, "w") as fh:
            yaml.safe_dump(cfg, fh)
        _, resume_wall = run_cli(["train", "-opt", yml])
        events = jsonl_events(os.path.join(exp, "metrics.jsonl"))
        resumed = [e for e in events if e["kind"] == "resume"]
        assert [e["iter"] for e in resumed] == [14], resumed
        more = [e["iter"] for e in events if e["kind"] == "train"][14:]
        assert more == [15, 16], more
        assert os.path.isfile(os.path.join(opt["path"]["training_states"], "ckpt_16.pth"))

        # what training wrote loads strictly and serves through the CLI
        load_pth(flagship_teacher(static="train"), net14)
        frame = os.path.join(work, "serve_in", "frame.png")
        imwrite(frame, sonar_frame(512, 512, 400))
        _, serve_wall = run_cli(["infer-teacher", "--weights", net14, "--input", frame,
                                 "--output", os.path.join(work, "serve_out")])
        served = decoded(os.path.join(work, "serve_out"))
        assert served["frame.png"].shape == (512, 512, 3), {k: v.shape for k, v in served.items()}
        stdout, test_wall = run_cli(["test", "-opt", yml, "--weights", net14])
        psnr = {ln.split("]")[0][1:]: float(ln.split("psnr=")[1].split(",")[0])
                for ln in stdout.splitlines() if ln.startswith("[") and "psnr=" in ln}
        assert psnr and all(np.isfinite(v) for v in psnr.values()), stdout[-1000:]
    finally:
        os.chdir(cwd)

    # one seeded step on the card against the same step on the CPU
    t0 = time.perf_counter()
    m_gpu, p_gpu, _ = train_step_on(torch.device("cuda"), opt, seed=7)
    m_cpu, p_cpu, g_cpu = train_step_on(torch.device("cpu"), opt, seed=7)
    step_check_s = time.perf_counter() - t0
    lr = m_cpu["lr"]
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    over = 0
    for n, p in p_cpu.items():
        tol = torch.where(g_cpu[n].abs() > 1e-6 * gmax, 0.05 * lr, 2 * lr)
        over += int(((p_gpu[n] - p).abs() > tol).sum())
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("l_pix", "grad_norm")}
    assert max(rel.values()) <= 1e-4 and m_gpu["lr"] == lr and over == 0, (rel, over)

    profiles = [profile_train_step(opt, b, p, card) for b, p in ((6, 64), (1, 128))]

    prog = ProgressiveSchedule.from_dataset_opt(opt["datasets"]["train"])
    stages = []
    for s_idx in range(len(TRAIN_ITERS)):
        rows = [e for e in steps if prog.stage(e["iter"]) == s_idx]
        mb, patch, _ = prog.at(rows[0]["iter"])
        iter_ms = [1e3 * e["iter_time"] for e in rows]
        stages.append(dict(stage=s_idx + 1, batch=mb, patch=patch, steps=len(rows),
                           iters=[e["iter"] for e in rows], ms_per_step=iter_ms,
                           data_ms=[1e3 * e["data_time"] for e in rows],
                           median_ms=float(np.median(iter_ms)),
                           images_per_s=mb * len(rows) / (sum(iter_ms) / 1e3)))
    total_images = sum(r["batch"] * r["steps"] for r in stages)
    row = dict(
        card=card, model="KDLAE-T full width (dim 48, [4,6,6,8], refinement 4, SR head)",
        config="configs/KDLAET.yml: iters [3,3,2,2,2,2], total_iter 14 then 16, "
               "checkpoint and validation every 7, print_freq 1",
        corpus="24 training and 2 validation triples, 256x256 input, 512x512 SR",
        corpus_write_s=corpus_s, stages=stages,
        images_per_s=total_images / sum(sum(r["ms_per_step"]) / 1e3 for r in stages),
        train_call_s=train_wall, resume_call_s=resume_wall,
        peak_memory_gib=peak / 2 ** 30, peak_above_start_gib=(peak - base_mem) / 2 ** 30,
        checkpoint_save_s=[e["seconds"] for e in saves],
        checkpoint_restore_s=resumed[0]["seconds"],
        validation_s=[e["seconds"] for e in vals],
        val_psnr=[e["psnr"] for e in vals], val_psnr_sr=[e["psnr_sr"] for e in vals],
        losses=[e["l_pix"] for e in steps], kernel_launches=launches,
        serve_one_512_frame_s=serve_wall, test_call_s=test_wall, test_psnr=psnr,
        card_vs_cpu_step=dict(rel=rel, lr=lr, weights_over_rule=over,
                              loss_gpu=m_gpu["l_pix"], loss_cpu=m_cpu["l_pix"]),
        step_check_s=step_check_s, step_profiles=profiles,
        phase_s=time.perf_counter() - t_phase)
    log("training: " + ", ".join(f"{r['batch']}@{r['patch']} {r['median_ms']:.1f} ms"
                                 for r in stages)
        + f"; {row['images_per_s']:.1f} images/s; peak {row['peak_memory_gib']:.2f} GiB; "
        f"save {row['checkpoint_save_s']} s, restore {row['checkpoint_restore_s']:.3f} s, "
        f"validation {row['validation_s']} s; card vs CPU step {rel} [{card}]")
    results["train"] = row
    print(json.dumps({"train": row}), flush=True)


# ------------------------------------------------------------ phase 11 ---

STUDENT_ITERS = [2, 2, 2, 2, 2, 2]  # all six curriculum stages in 12 steps
TEACHER_PTH = os.path.join("artifacts", "torch_zoo", "teacher.pth")


def write_frames(folder, stacks):
    """(S, F, H, W) uint8 stacks as gray PNGs numbered in order (the
    student dataset groups frames by their leading number)."""
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    os.makedirs(folder, exist_ok=True)
    s, f = stacks.shape[:2]
    for k in range(s * f):
        imwrite(os.path.join(folder, f"{k}_s{k // f}.png"), stacks[k // f, k % f], rgb=False)
    return folder


def phase_distill_offline(row, card, work, n_seq=3, seq_len=8, size=512):
    """(a) The trained bf16 teacher through the stage kernel writes the
    student's targets for n_seq x seq_len frames; held on two frames to
    the plain-stage predictor's distance from fp32. Returns its launches."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import flagship_teacher, kdlae_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.train import distill
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imread_rgb, list_images

    lq_dir = write_frames(os.path.join(work, "frames"), sonar_stacks(n_seq, seq_len, size, size, 50))
    gt_dir = os.path.join(work, "teacher")
    teacher = load_pth(flagship_teacher(static="train"), os.path.join(HERE, TEACHER_PTH))
    teacher.static = "test"  # the targets are hq only
    fp32 = TeacherPredictor(teacher)
    fused = TeacherPredictor(teacher.to(torch.bfloat16), fused=True, dtype=torch.bfloat16)
    frames = [imread_rgb(p) for p in list_images(lq_dir)[:2]]
    fused(frames[0])  # warm-up: plans at this shape
    plain_stage = kdlae_teacher.fused_transformer_stage
    kdlae_teacher.fused_transformer_stage = pstage.stage_plain
    try:
        plain = [fused(f)["hq"] for f in frames]
    finally:
        kdlae_teacher.fused_transformer_stage = plain_stage
    gate = []
    for f, p in zip(frames, plain):
        ref = fp32(f)["hq"]
        gate.append(dict(fused_vs_fp32_over_1_level=1 - within_levels(fused(f)["hq"], ref)[0],
                         plain_stage_vs_fp32_over_1_level=1 - within_levels(p, ref)[0]))
    for g in gate:
        assert (g["fused_vs_fp32_over_1_level"]
                <= 1.1 * g["plain_stage_vs_fp32_over_1_level"] + 0.002), gate
    torch.cuda.synchronize()
    counts = reset_counts()
    t0 = time.perf_counter()
    n = distill.generate_teacher_targets(fused, lq_dir, gt_dir, log=lambda m: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    assert n == n_seq * seq_len and launches == dict(
        stage=5 * n, layernorm=0, gdfn=0, block=0, stage_bands=0, stage_shards=0,
        gdfn_part=0), (n, launches)
    targets = decoded(gt_dir, gray=True)
    assert len(targets) == n and all(t.shape == (size, size) for t in targets.values())
    row["offline_distillation"] = dict(frames=n, size=size, wall_s=wall, frames_per_s=n / wall,
                                       stage_calls=launches["stage"], gate=gate)
    log(f"offline distillation: {n} frames of {size}^2 through the trained bf16 teacher "
        f"(fused) in {wall:.2f} s ({n / wall:.2f} frames/s), {launches['stage']} stage calls; "
        f"more than 1 level from fp32 on 2 frames: {gate} [{card}]")
    del fp32, fused, teacher
    torch.cuda.empty_cache()
    return lq_dir, gt_dir, launches["stage"]


def student_step_on(device, opt, seed, dtype):
    """One seeded step of the full-width student at KDLAES.yml's settings on
    ``device`` in ``dtype``, past the warm-up (step 2000): (2, 7, 128, 128)
    stacks, extra mask 0.1, mixup; every draw on the host."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop

    _, trainer = tloop.build_everything(opt, device=device)
    state = trainer.init_state()
    state.model.to(dtype)  # the same Parameter objects: the optimizer keeps them
    state.step = 2000
    rng = np.random.default_rng(seed)
    lq = rng.random((2, 7, 128, 128), dtype=np.float32)
    gt = np.clip(lq + rng.normal(0, 0.05, lq.shape), 0, 1).astype(np.float32)
    state, m = trainer.step(state, torch.from_numpy(lq).to(device, dtype),
                            torch.from_numpy(gt).to(device, dtype),
                            np.random.default_rng(seed + 1), extra_prob=0.1)
    return ({k: float(v) for k, v in m.items()},
            {n: p.detach().cpu().double() for n, p in state.model.named_parameters()},
            {n: p.grad.detach().cpu().double() for n, p in state.model.named_parameters()})


def card_equals_cpu(step_on, opt, seed):
    """A float32 step on the card against the same step on the CPU in
    float64: loss and grad_norm within 1e-4 relative, each weight within
    0.05 lr (2 lr where its gradient is under 1e-6 of the largest). The
    CPU's own float32 step is reported beside it: PyTorch's CPU conv3d sums
    the student's output-bias gradient (229,376 same-sign terms at this
    shape) with ~1e-3 relative error, so float32 on the CPU is no
    reference here."""
    import torch

    cpu = torch.device("cpu")
    m_gpu, p_gpu, _ = step_on(torch.device("cuda"), opt, seed, torch.float32)
    m_ref, p_ref, g_ref = step_on(cpu, opt, seed, torch.float64)
    m_cpu, _, _ = step_on(cpu, opt, seed, torch.float32)
    lr = m_ref["lr"]
    gmax = max(float(g.abs().max()) for g in g_ref.values())
    over = 0
    for n, p in p_ref.items():
        tol = torch.where(g_ref[n].abs() > 1e-6 * gmax, 0.05 * lr, 2 * lr)
        over += int(((p_gpu[n] - p).abs() > tol).sum())
    rel = {k: abs(m_gpu[k] - m_ref[k]) / abs(m_ref[k]) for k in ("l_pix", "grad_norm")}
    cpu_rel = {k: abs(m_cpu[k] - m_ref[k]) / abs(m_ref[k]) for k in ("l_pix", "grad_norm")}
    assert max(rel.values()) <= 1e-4 and m_gpu["lr"] == lr and lr > 0 and over == 0, (rel, over)
    return dict(rel=rel, cpu_fp32_rel=cpu_rel, lr=lr, weights_over_rule=over,
                loss_gpu=m_gpu["l_pix"], loss_cpu_fp64=m_ref["l_pix"])


def profile_student_step(opt, patch, card):
    """One steady-state step of the full-width student at 4 x 7 @ patch,
    extra mask 0.1, mixup (``profile_step``)."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop

    _, trainer = tloop.build_everything(opt, device="cuda")
    state = trainer.init_state()
    state.step = 2000
    g = torch.Generator(device="cuda").manual_seed(3)
    lq = torch.rand((4, 7, patch, patch), generator=g, device="cuda")
    gt = lq.clamp(0.05, 0.95)

    def step(k):
        return trainer.step(state, lq, gt, np.random.default_rng(k), extra_prob=0.1)

    out = dict(batch=4, frames=7, patch=patch,
               **profile_step(step, f"student step 4x7@{patch}", card))
    del state, trainer
    torch.cuda.empty_cache()
    return out


def profile_scorer_step(batch, size, card):
    """One steady-state micro-step of the scorer (bf16, remat, uint8 in,
    k = 32) at batch @ size (``profile_step``)."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.models import DenoiseRatePredictor
    from rethink_acoustic_image_enhancement_tpu_torch.train import asdqe_trainer as atr

    torch.manual_seed(0)
    model = DenoiseRatePredictor().cuda().set_remat(True).set_compute_dtype(torch.bfloat16)
    model.set_dropout_generator(torch.Generator(device="cuda").manual_seed(0))
    opt = atr.MultiStepsAdam(model.parameters(), 1e-3, 32)
    g = torch.Generator(device="cuda").manual_seed(1)
    lq = torch.randint(0, 256, (batch, 3, size, size), generator=g, device="cuda",
                       dtype=torch.uint8)
    gt = (lq.float() * 0.7).to(torch.uint8)
    score = torch.rand(batch, generator=g, device="cuda")

    def step(k):
        return atr.asdqe_micro_step(model, opt, lq, gt, score, 1.0, torch.bfloat16)

    out = dict(batch=batch, size=size,
               **profile_step(step, f"scorer micro-step {batch}@{size}", card))
    del model, opt
    torch.cuda.empty_cache()
    return out


def stage_rows(events, prog, frames, batch):
    """Per curriculum stage: its steps' ms, frames/s and data ms (the
    stage's mini-batch capped by the loader's ``batch``)."""
    rows = []
    for s_idx in sorted({prog.stage(e["iter"]) for e in events}):
        steps = [e for e in events if prog.stage(e["iter"]) == s_idx]
        mb, patch, _ = prog.at(steps[0]["iter"])
        mb = min(mb, batch)
        ms = [1e3 * e["iter_time"] for e in steps]
        rows.append(dict(stage=s_idx + 1, batch=mb, patch=patch, iters=[e["iter"] for e in steps],
                         ms_per_step=ms, data_ms=[1e3 * e["data_time"] for e in steps],
                         frames_per_s=mb * frames * len(steps) / (sum(ms) / 1e3)))
    return rows


def phase_student_train(row, card, work, lq_dir, gt_dir):
    """(b) configs/KDLAES.yml at full width through the CLI on the teacher's
    targets: six stages in 12 steps, checkpoints and frame-stack validation
    at 6 and 12, a resume to 14, net_g_12.pth served by infer-student, and
    one card step against the CPU's."""
    import torch
    import yaml

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth, read_pth
    from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAEStudent
    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import ProgressiveSchedule
    from rethink_acoustic_image_enhancement_tpu_torch.utils import native

    with open(os.path.join(HERE, "configs", "KDLAES.yml")) as fh:
        cfg = yaml.safe_load(fh)
    roots = dict(dataroot_lq=lq_dir, dataroot_gt=gt_dir)
    cfg["datasets"]["train"].update(roots, iters=STUDENT_ITERS)
    cfg["datasets"]["val"].update(roots, stride_range=[1, 1])
    cfg["train"]["total_iter"] = sum(STUDENT_ITERS)
    cfg["logger"].update(save_checkpoint_freq=6, print_freq=1)
    cfg["val"]["val_freq"] = 6
    yml = os.path.join(work, "KDLAES.yml")
    with open(yml, "w") as fh:
        yaml.safe_dump(cfg, fh)
    opt = tcfg.parse(yml, is_train=True, root_path=work)
    exp, models = opt["path"]["experiments_root"], opt["path"]["models"]

    counts = reset_counts()
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        _, train_wall = run_cli(["train", "-opt", yml])
        peak = torch.cuda.max_memory_allocated()
        assert native.available(), "the frame masker fell back to numpy"
        events = jsonl_events(os.path.join(exp, "metrics.jsonl"))
        steps = [e for e in events if e["kind"] == "train"]
        assert [e["iter"] for e in steps] == list(range(1, 13)), [e["iter"] for e in steps]
        assert all(np.isfinite(e["l_pix"]) and np.isfinite(e["grad_norm"]) for e in steps)
        vals = [e for e in events if e["kind"] == "val"]
        assert [e["iter"] for e in vals] == [6, 12] and all(
            np.isfinite(e["psnr"]) for e in vals), vals
        saves = [e for e in events if e["kind"] == "ckpt"]
        assert [e["iter"] for e in saves] == [6, 12], saves
        net12 = os.path.join(models, "net_g_12.pth")
        init, _ = tloop.build_everything(opt, device="cpu")
        trained = read_pth(net12)
        # the warm-up keeps lr near 0 (3e-4 * step / 1000): a weight whose
        # gradient is exactly 0 (a dead channel) may not move
        moved = [n for n, v in init.state_dict().items() if not torch.equal(v, trained[n])]
        assert len(moved) >= 0.9 * len(trained), "parameters that did not move: " + str(
            sorted(set(trained) - set(moved)))

        cfg["train"]["total_iter"] = 14
        with open(yml, "w") as fh:
            yaml.safe_dump(cfg, fh)
        _, resume_wall = run_cli(["train", "-opt", yml])
        events = jsonl_events(os.path.join(exp, "metrics.jsonl"))
        resumed = [e for e in events if e["kind"] == "resume"]
        assert [e["iter"] for e in resumed] == [12], resumed
        assert [e["iter"] for e in events if e["kind"] == "train"][12:] == [13, 14]

        load_pth(KDLAEStudent(residual=True, hidden_channels=(16, 32, 64)), net12)
        _, serve_wall = run_cli(["infer-student", "--weights", net12, "--input", lq_dir,
                                 "--output", os.path.join(work, "student_out")])
        served = decoded(os.path.join(work, "student_out"), gray=True)
        size = next(iter(decoded(gt_dir, gray=True).values())).shape
        assert len(served) == 7 and all(v.shape == size for v in served.values()), size
    finally:
        os.chdir(cwd)
    launches = read_counts(counts)
    assert not any(launches.values()), launches  # training reaches no kernel

    t0 = time.perf_counter()
    step_check = card_equals_cpu(student_step_on, opt, seed=7)
    step_check_s = time.perf_counter() - t0
    profiles = [profile_student_step(opt, p, card) for p in (128, 384)]
    prog = ProgressiveSchedule.from_dataset_opt(opt["datasets"]["train"])
    stages = stage_rows(steps, prog, 7, opt["datasets"]["train"]["batch_size_per_gpu"])
    row["student_train"] = dict(
        config="configs/KDLAES.yml at full width: iters [2]*6, total_iter 12 then 14, "
               "checkpoint and validation every 6, print_freq 1",
        masker_route="native" if native.available() else "numpy", stages=stages, train_call_s=train_wall,
        resume_call_s=resume_wall, peak_memory_gib=peak / 2 ** 30,
        checkpoint_save_s=[e["seconds"] for e in saves],
        checkpoint_restore_s=resumed[0]["seconds"],
        validation_s=[e["seconds"] for e in vals], val_psnr=[e["psnr"] for e in vals],
        losses=[e["l_pix"] for e in steps], serve_s=serve_wall,
        moved_tensors=f"{len(moved)}/{len(trained)}",
        card_vs_cpu_step=step_check, step_check_s=step_check_s, step_profiles=profiles)
    log("student training: " + ", ".join(
        f"{r['batch']}x7@{r['patch']} {np.median(r['ms_per_step']):.1f} ms "
        f"({r['frames_per_s']:.0f} frames/s, data {np.median(r['data_ms']):.1f} ms)"
        for r in stages)
        + f"; peak {peak / 2 ** 30:.2f} GiB; save {row['student_train']['checkpoint_save_s']} s, "
        f"restore {resumed[0]['seconds']:.3f} s, validation "
        f"{row['student_train']['validation_s']} s, PSNR {row['student_train']['val_psnr']}; "
        f"card step vs the CPU's in float64 {step_check['rel']} (the CPU's float32 step "
        f"{step_check['cpu_fp32_rel']}); masker {row['student_train']['masker_route']} [{card}]")
    return yml, cfg


def phase_distill_online(row, card, work, yml, cfg, steps=3):
    """(c) The same config with train.distill.online: the trained teacher
    makes the targets in the loop, for ``steps`` steps of the first stage."""
    import torch
    import yaml

    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop

    with open(os.path.join(HERE, "configs", "KDLAET.yml")) as fh:
        teacher_net = yaml.safe_load(fh)["network_g"]
    cfg = dict(cfg, name="KDLAES_online")
    cfg["train"] = dict(cfg["train"], total_iter=steps, distill=dict(
        online=True, teacher=teacher_net,
        teacher_weights=os.path.join(HERE, TEACHER_PTH)))
    cfg["val"] = dict(cfg["val"], val_freq=0)
    online_yml = os.path.join(work, "KDLAES_online.yml")
    with open(online_yml, "w") as fh:
        yaml.safe_dump(cfg, fh)
    opt = tcfg.parse(online_yml, is_train=True, root_path=work)

    timed = []
    targets = tloop.online_targets

    def timed_targets(fn, lq):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = targets(fn, lq)
        torch.cuda.synchronize()
        timed.append(dict(ms=(time.perf_counter() - t0) * 1e3, shape=list(out.shape),
                          finite=bool(torch.isfinite(out).all()), min=float(out.min()),
                          max=float(out.max())))
        return out

    torch.cuda.reset_peak_memory_stats()
    tloop.online_targets = timed_targets
    cwd = os.getcwd()
    os.chdir(work)
    try:
        _, wall = run_cli(["train", "-opt", online_yml])
    finally:
        os.chdir(cwd)
        tloop.online_targets = targets
    events = [e for e in jsonl_events(os.path.join(opt["path"]["log"], "metrics.jsonl"))
              if e["kind"] == "train"]
    assert [e["iter"] for e in events] == list(range(1, steps + 1)), events
    assert len(timed) == steps and all(t["finite"] and 0.0 <= t["min"] and t["max"] <= 1.0
                                       for t in timed), timed
    step_ms = [1e3 * e["iter_time"] for e in events]
    share = [t["ms"] / s for t, s in zip(timed, step_ms)]
    row["online_distillation"] = dict(
        steps=steps, ms_per_step=step_ms, teacher_ms=[t["ms"] for t in timed],
        teacher_share=share, target_shape=timed[0]["shape"], targets=timed,
        losses=[e["l_pix"] for e in events], call_s=wall,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"online distillation: {steps} steps at {timed[0]['shape']} targets, ms per step "
        f"{['%.1f' % s for s in step_ms]}, the teacher's share {['%.2f' % s for s in share]}; "
        f"targets in [{min(t['min'] for t in timed):.3f}, {max(t['max'] for t in timed):.3f}] [{card}]")


def write_siqa_corpus(root, n, size, seed):
    """n lq / candidate / JSON-score triples: a speckled sonar frame, the
    candidate mixing it with its 5x5 box mean inside the fan at a known rate
    that is the score."""
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("lq", "gt", "param")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        noisy = sonar_frame(size, size, seed * 1000 + i).astype(np.float32)
        pad = np.pad(noisy, ((2, 2), (2, 2), (0, 0)), mode="edge")
        box = sum(pad[dy:dy + size, dx:dx + size] for dy in range(5) for dx in range(5)) / 25
        rate = round(float(rng.uniform(0, 1)), 3)
        cand = np.where(noisy[..., :1] > 0, (1 - rate) * noisy + rate * box, 0)
        imwrite(os.path.join(dirs["lq"], f"{i:04d}.png"), noisy.astype(np.uint8))
        imwrite(os.path.join(dirs["gt"], f"{i:04d}.png"), cand.round().astype(np.uint8))
        with open(os.path.join(dirs["param"], f"{i:04d}.json"), "w") as fh:
            json.dump({"score": rate}, fh)
    return dirs


def scorer_big_steps(batch=32, size=512, updates=3, device="cuda", sample=None):
    """The reference's training shape: batch 32 at 512^2, bf16 compute,
    remat on, one Adam update a micro-step; a warm-up step, then
    ``updates`` timed ones, on one seeded random batch or on
    ``sample(k)``'s (lq, gt, score) batches. Returns pairs/s, peak memory,
    the losses and whether the running statistics moved."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.models import DenoiseRatePredictor
    from rethink_acoustic_image_enhancement_tpu_torch.train import asdqe_trainer as atr

    torch.manual_seed(0)
    model = DenoiseRatePredictor().to(device).set_remat(True).set_compute_dtype(torch.bfloat16)
    model.set_dropout_generator(torch.Generator(device=device).manual_seed(0))
    opt = atr.MultiStepsAdam(model.parameters(), 1e-3, 1)
    g = torch.Generator(device=device).manual_seed(1)
    lq = torch.randint(0, 256, (batch, 3, size, size), generator=g, device=device,
                       dtype=torch.uint8)
    gt = (lq.float() * 0.7).to(torch.uint8)
    score = torch.rand(batch, generator=g, device=device)
    sample = sample or (lambda k: (lq, gt, score))
    bn = model.unet.inc.double_conv[1]
    before = bn.running_mean.clone()
    atr.asdqe_micro_step(model, opt, *sample(0), 1.0, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    losses = [atr.asdqe_micro_step(model, opt, *sample(1 + k), 1.0, torch.bfloat16)
              for k in range(updates)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    moved = not torch.equal(before, bn.running_mean)
    assert all(np.isfinite(losses)) and moved, (losses, moved)
    out = dict(batch=batch, size=size, updates=updates, wall_s=wall,
               pairs_per_s=batch * updates / wall, ms_per_step=wall / updates * 1e3,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               peak_above_start_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               losses=losses, running_stats_moved=moved)
    del model, opt, lq, gt
    torch.cuda.empty_cache()
    return out


def phase_scorer_train(row, card, work, n=40, size=512):
    """(d) train-asdqe at the CLI defaults for 2 epochs on a seeded SIQA
    corpus, score with what it wrote (strict), and the reference's shape."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.models import DenoiseRatePredictor
    from rethink_acoustic_image_enhancement_tpu_torch.train import asdqe_trainer as atr

    dirs = write_siqa_corpus(os.path.join(work, "siqa"), n, size, seed=60)
    out = os.path.join(work, "asdqe")
    step_ms = []
    micro_step = atr.asdqe_micro_step

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = micro_step(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return loss

    torch.cuda.reset_peak_memory_stats()
    atr.asdqe_micro_step = timed_step
    try:
        stdout, train_wall = run_cli(["train-asdqe", "--lq", dirs["lq"], "--gt", dirs["gt"],
                                      "--param", dirs["param"], "--out", out, "--epochs", "2"])
    finally:
        atr.asdqe_micro_step = micro_step
    peak = torch.cuda.max_memory_allocated()
    assert len(step_ms) == 2 * int(0.8 * n), len(step_ms)
    best = float(stdout.split("best val MSE:")[1].split()[0])
    assert np.isfinite(best) and sorted(os.listdir(out)) == [
        "net_g_0.pth", "net_g_1.pth", "net_g_best.pth"], (stdout[-500:], os.listdir(out))
    load_pth(DenoiseRatePredictor(), os.path.join(out, "net_g_best.pth"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        score_out, score_wall = run_cli(["score", "--weights", os.path.join(out, "net_g_best.pth"),
                                         "--lq-dir", dirs["lq"], "--methods",
                                         f"mixed={dirs['gt']}", "--csv", "scores.csv"])
    finally:
        os.chdir(cwd)
    assert os.path.isfile(os.path.join(work, "scores.csv")), score_out[-500:]
    steady = float(np.median(step_ms[2:]))
    big = scorer_big_steps()
    profiles = [profile_scorer_step(b, sz, card) for b, sz in ((1, 256), (32, 512))]
    row["scorer_train"] = dict(
        triples=n, size=size, cli="train-asdqe defaults (batch 1, accum 32, gt 256, bf16), 2 epochs",
        train_call_s=train_wall, micro_steps=len(step_ms), micro_step_ms=step_ms,
        pairs_per_s_batch1=1e3 / steady, pairs_per_s_call=len(step_ms) / train_wall,
        peak_memory_gib=peak / 2 ** 30, best_val_mse=best, score_call_s=score_wall,
        batch32_512=big, step_profiles=profiles)
    log(f"scorer training: 2 epochs of {len(step_ms) // 2} pairs at batch 1 @ 256, a micro-step "
        f"{steady:.1f} ms ({1e3 / steady:.1f} pairs/s; the call {train_wall:.2f} s with "
        f"loading, validation and saves), peak "
        f"{peak / 2 ** 30:.2f} GiB, best val MSE {best:.5f}; score {score_wall:.2f} s; "
        f"batch 32 @ 512: {big['ms_per_step']:.1f} ms an update ({big['pairs_per_s']:.1f} pairs/s), "
        f"peak {big['peak_memory_gib']:.2f} GiB [{card}]")


def phase_student_and_scorer(results, card, work):
    """Phase 11: offline distillation through the stage kernel, the
    student's training, online distillation, the scorer's training."""
    t0 = time.perf_counter()
    row = dict(card=card)
    lq_dir, gt_dir, launches = phase_distill_offline(row, card, work)
    yml, cfg = phase_student_train(row, card, work, lq_dir, gt_dir)
    phase_distill_online(row, card, work, yml, cfg)
    phase_scorer_train(row, card, work)
    row["phase_s"] = time.perf_counter() - t0
    results["student_scorer_train"] = row
    print(json.dumps({"student_scorer_train": row}), flush=True)
    return launches


# ------------------------------------------------------------ phase 12 ---

FLS_ITERS = [4, 4]  # both stages of KDLAES_FLS_ft.yml (4x7@192, 4x7@256) in 8 steps
ZOO_STUDENT = os.path.join("artifacts", "torch_zoo", "student-us.pth")
MAX_STEP_UPLOAD = 4096  # bytes: the largest host-to-device copy a device-resident step may make


def write_fls_frames(root, n=64, size=512, seed=90):
    """n numbered gray sonar frames: the noisy input, and as target its 5x5
    box mean inside the fan. Returns the two folders."""
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    dirs = [os.path.join(root, k) for k in ("origin", "teacher")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        noisy = sonar_frame(size, size, seed * 1000 + i)[..., 0].astype(np.float32)
        pad = np.pad(noisy, 2, mode="edge")
        box = sum(pad[dy:dy + size, dx:dx + size] for dy in range(5) for dx in range(5)) / 25
        imwrite(os.path.join(dirs[0], f"{i}_f.png"), noisy.astype(np.uint8), rgb=False)
        imwrite(os.path.join(dirs[1], f"{i}_f.png"),
                np.where(noisy > 0, box, 0).round().astype(np.uint8), rgb=False)
    return dirs


def fls_config(work, lq_dir, gt_dir, name, total, iters=FLS_ITERS, device_resident=True):
    """configs/KDLAES_FLS_ft.yml as it stands but for its dataroots, its
    depth (``iters``, ``total``, a checkpoint every 4, every step logged)
    and its pretrained weights: the zoo student, a .pth (the config's own
    is an orbax directory, which the port refuses)."""
    import yaml

    with open(os.path.join(HERE, "configs", "KDLAES_FLS_ft.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["name"] = name
    roots = dict(dataroot_lq=lq_dir, dataroot_gt=gt_dir)
    cfg["datasets"]["train"].update(roots, iters=list(iters), device_resident=device_resident)
    cfg["datasets"]["val"].update(roots)
    cfg["train"]["total_iter"] = total
    cfg["logger"].update(save_checkpoint_freq=4, print_freq=1)
    cfg["path"]["pretrain_network_g"] = os.path.join(HERE, ZOO_STUDENT)
    yml = os.path.join(work, f"{name}.yml")
    with open(yml, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return yml, cfg


def train_events(work, name):
    exp = os.path.join(work, "experiments", name)
    events = jsonl_events(os.path.join(exp, "metrics.jsonl"))
    steps = [e for e in events if e["kind"] == "train"]
    assert all(np.isfinite(e["l_pix"]) and np.isfinite(e["grad_norm"]) for e in steps), steps
    return exp, events, steps


def phase_fls_routes(row, card, work, lq_dir, gt_dir):
    """(a) the FLS fine-tune through the CLI: device-resident for 8 steps, a
    checkpoint at 4 and 8, resumed to 10; then the same 8 steps from the
    host loader."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import ProgressiveSchedule

    out = {}
    for route, resident in (("device", True), ("host", False)):
        name = f"fls_{route}"
        yml, cfg = fls_config(work, lq_dir, gt_dir, name, total=8, device_resident=resident)
        torch.cuda.reset_peak_memory_stats()
        _, wall = run_cli(["train", "-opt", yml])
        peak = torch.cuda.max_memory_allocated()
        exp, events, steps = train_events(work, name)
        assert [e["iter"] for e in steps] == list(range(1, 9)), [e["iter"] for e in steps]
        assert [e["iter"] for e in events if e["kind"] == "ckpt"] == [4, 8]
        prog = ProgressiveSchedule.from_dataset_opt(cfg["datasets"]["train"])
        out[route] = dict(call_s=wall, peak_memory_gib=peak / 2 ** 30,
                          stages=stage_rows(steps, prog, 7, 4), losses=[e["l_pix"] for e in steps])
        if resident:
            (corpus,) = [e for e in events if e["kind"] == "corpus"]
            out[route].update(corpus_upload_s=corpus["upload_s"], corpus_mib=corpus["mib"])
            fls_config(work, lq_dir, gt_dir, name, total=10)
            _, out[route]["resume_call_s"] = run_cli(["train", "-opt", yml])
            _, events, steps = train_events(work, name)
            assert [e["iter"] for e in events if e["kind"] == "resume"] == [8]
            assert [e["iter"] for e in steps][8:] == [9, 10], [e["iter"] for e in steps]
    row["fls"] = out
    for route, r in out.items():
        log(f"FLS fine-tune, {route} route: " + ", ".join(
            f"4x7@{s['patch']} {np.median(s['ms_per_step']):.1f} ms a step (data "
            f"{np.median(s['data_ms']):.2f} ms; {s['ms_per_step']})" for s in r["stages"])
            + f", peak {r['peak_memory_gib']:.2f} GiB" + (
                f", corpus {r['corpus_mib']:.1f} MiB uploaded in {r['corpus_upload_s']:.3f} s"
                if route == "device" else "") + f" [{card}]")


def device_student_step(opt, patch, ids=(3, 17, 29, 41)):
    """``step(k)``: one device-resident step of the config's student at
    ``patch`` (the corpus's sampler, then ``Trainer.step`` with the extra
    mask drawn on the card), seeded by k."""
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.train.device_corpus import (
        build_device_corpus,
        seeded_generator,
    )

    _, trainer = tloop.build_everything(opt, device="cuda")
    state = trainer.init_state()
    state.step = 300  # past the warm-up
    corpus = build_device_corpus(opt["datasets"]["train"], "cuda")

    def step(k):
        gen = seeded_generator("cuda", 0, k)
        lq, gt = corpus.sample_batch(gen, np.asarray(ids), gt_size=patch)
        return trainer.step(state, lq, gt, np.random.default_rng(k), extra_prob=0.05, gen=gen)

    return step, corpus


def crop_routes(corpus, ids, patch, reps=20):
    """The student corpus's crop and flip as gathers over index grids (the
    port's route) against a per-item loop of slices, whose offsets and modes
    must first come to the host: the same batch, ms of each (synchronised
    host clock, ``reps`` runs)."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import device_corpus as tdc
    from rethink_acoustic_image_enhancement_tpu_torch.train.device_corpus import seeded_generator

    ids_t = corpus.ids(ids)
    d = corpus.draw(seeded_generator("cuda", 0, 1), ids_t, patch)
    fids = corpus.groups[ids_t]
    table = tdc._aug8_table(patch, corpus.device)

    def gather():
        return tdc._permute(tdc._crop(corpus.lq, fids, d["top"], d["left"], patch),
                            table, d["aug"])

    def per_item():
        rows = zip(fids.tolist(), d["top"].tolist(), d["left"].tolist(), d["aug"].tolist())
        return torch.stack([tdc.augment8(corpus.lq[f, t:t + patch, l:l + patch], m)
                            for f, t, l, m in rows])

    assert torch.equal(gather(), per_item())
    out = {}
    for name, fn in (("gather", gather), ("per_item", per_item), ("gather2", gather),
                     ("per_item2", per_item)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    return dict(batch=len(ids), frames=int(fids.shape[1]), patch=patch,
                gather_ms=[out["gather"], out["gather2"]],
                per_item_ms=[out["per_item"], out["per_item2"]])


def phase_profile_steps(row, card, work, lq_dir, gt_dir):
    """(d) ``train --profile-steps 3`` on the FLS fine-tune (3 steps at
    192): its log line and record, its host-to-device copies (none over 4
    KiB), its top kernel against ``profile_step``'s on the same step; and
    the crop routes."""
    import glob

    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.utils import profiling

    name = "fls_profile"
    yml, _ = fls_config(work, lq_dir, gt_dir, name, total=6, iters=[8, 4])
    _, wall = run_cli(["train", "-opt", yml, "--profile-steps", "3"])
    exp, events, _ = train_events(work, name)
    (rec,) = [e for e in events if e["kind"] == "profile"]
    lines = []
    for path in glob.glob(os.path.join(exp, "train_*.log")):
        with open(path) as fh:
            lines += [ln.strip() for ln in fh if "profile (ms by kernel over 3 steps): " in ln]
    assert len(lines) == 1 and rec["steps"] == 3 and rec["ms_by_kernel"], (lines, rec)
    copies = profiling.h2d_copies(os.path.join(exp, "profile"))  # a trace may lose some
    assert all(b is not None and b <= MAX_STEP_UPLOAD for b in copies), copies
    cli_top = next(iter(rec["ms_by_kernel"]))

    opt = tcfg.parse(yml, is_train=True, root_path=work)
    step, corpus = device_student_step(opt, 192)
    ref = profile_step(step, "device-resident student step 4x7@192", card)
    assert ref["top"][0]["kernel"] == cli_top[:120], (ref["top"][0], cli_top)
    # the dispatcher's count of one step: its ids, nothing larger
    assert ref["h2d_copy_bytes"] and max(ref["h2d_copy_bytes"]) <= MAX_STEP_UPLOAD, ref
    routes = [crop_routes(corpus, [3, 17, 29, 41], p) for p in (192, 256)]
    del step, corpus
    torch.cuda.empty_cache()
    row["profile_steps"] = dict(
        call_s=wall, log_line=lines[0][-400:], record=rec, cli_top_kernel=cli_top,
        traced_h2d_copies=len(copies), traced_h2d_bytes=copies,
        step_h2d_bytes=ref["h2d_copy_bytes"], profile_step_192=ref, crop_routes=routes)
    log(f"--profile-steps 3: {lines[0][-300:]}")
    log(f"  the trace of 3 steps: {len(copies)} host-to-device copies, {copies} bytes; one "
        f"step, as the dispatcher sees it: {len(ref['h2d_copy_bytes'])} copies, "
        f"{ref['h2d_copy_bytes']} bytes; top kernel {cli_top[:80]} (profile_step's the same) "
        f"[{card}]")
    for r in routes:
        log(f"  crop + flip of {r['batch']}x{r['frames']}@{r['patch']}: gathers "
            f"{r['gather_ms']} ms, per-item slices {r['per_item_ms']} ms [{card}]")


def phase_teacher_device(row, card, work):
    """(b) configs/KDLAET.yml at full width, device-resident, on phase 10's
    synthetic triples: one step per curriculum stage."""
    import torch
    import yaml

    from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import ProgressiveSchedule

    roots = write_train_corpus(os.path.join(work, "triples"), 24, seed=12)
    with open(os.path.join(HERE, "configs", "KDLAET.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["name"] = "kdlaet_device"
    cfg["datasets"]["train"].update(roots, iters=[1] * 6, device_resident=True)
    del cfg["datasets"]["val"]
    cfg["val"]["val_freq"] = 0
    cfg["train"]["total_iter"] = 6
    cfg["logger"].update(save_checkpoint_freq=6, print_freq=1, use_tb_logger=False)
    yml = os.path.join(work, "kdlaet_device.yml")
    with open(yml, "w") as fh:
        yaml.safe_dump(cfg, fh)
    torch.cuda.reset_peak_memory_stats()
    _, wall = run_cli(["train", "-opt", yml])
    _, events, steps = train_events(work, "kdlaet_device")
    assert [e["iter"] for e in steps] == list(range(1, 7))
    (corpus,) = [e for e in events if e["kind"] == "corpus"]
    prog = ProgressiveSchedule.from_dataset_opt(cfg["datasets"]["train"])
    stages = stage_rows(steps, prog, 1, cfg["datasets"]["train"]["batch_size_per_gpu"])
    row["teacher"] = dict(call_s=wall, stages=stages, corpus_mib=corpus["mib"],
                          corpus_upload_s=corpus["upload_s"],
                          peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("teacher, device-resident: " + ", ".join(
        f"{s['batch']}@{s['patch']} {s['ms_per_step'][0]:.1f} ms (data {s['data_ms'][0]:.2f} ms)"
        for s in stages) + f"; corpus {corpus['mib']:.1f} MiB in {corpus['upload_s']:.3f} s [{card}]")


def phase_scorer_device(row, card, work, results, n=40, size=512, big_batch=32):
    """(c) train-asdqe --device-resident at the CLI defaults for 2 epochs
    on n source pairs, then 3 updates at 32@512 from the device corpus."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import asdqe_trainer as atr
    from rethink_acoustic_image_enhancement_tpu_torch.train.device_corpus import (
        SIQADeviceCorpus,
        seeded_generator,
    )

    dirs = write_siqa_corpus(os.path.join(work, "siqa_src"), n, size, seed=61)
    out = os.path.join(work, "asdqe_device")
    step_ms = []
    micro_step = atr.asdqe_micro_step

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = micro_step(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return loss

    torch.cuda.reset_peak_memory_stats()
    atr.asdqe_micro_step = timed_step
    try:
        stdout, wall = run_cli(["train-asdqe", "--lq", dirs["lq"], "--gt", dirs["gt"],
                                "--out", out, "--epochs", "2", "--device-resident"])
    finally:
        atr.asdqe_micro_step = micro_step
    peak = torch.cuda.max_memory_allocated()
    assert len(step_ms) == 2 * 32, len(step_ms)  # steps_per_epoch = accum
    best = float(stdout.split("best val MSE:")[1].split()[0])
    assert np.isfinite(best) and sorted(os.listdir(out)) == [
        "net_g_0.pth", "net_g_1.pth", "net_g_best.pth"], os.listdir(out)
    corpus = SIQADeviceCorpus({"dataroot_lq": dirs["lq"], "dataroot_gt": dirs["gt"],
                               "gt_size": size, "geometric_augs": True}, "cuda")
    rng = np.random.default_rng(3)

    def sample(k):
        return corpus.sample_batch(seeded_generator("cuda", 3, k), rng.choice(n, big_batch),
                                   size)

    big = scorer_big_steps(batch=big_batch, size=size, sample=sample)
    del corpus
    torch.cuda.empty_cache()
    steady = float(np.median(step_ms[2:]))
    host = results.get("student_scorer_train", {}).get("scorer_train", {})
    row["scorer"] = dict(call_s=wall, micro_steps=len(step_ms), micro_step_ms=step_ms,
                         pairs_per_s_batch1=1e3 / steady, pairs_per_s_call=len(step_ms) / wall,
                         peak_memory_gib=peak / 2 ** 30, best_val_mse=best, batch32_512=big,
                         host_route_pairs_per_s_batch1=host.get("pairs_per_s_batch1"),
                         host_route_pairs_per_s_32_512=host.get("batch32_512", {}).get(
                             "pairs_per_s"))
    log(f"scorer, device-resident: a micro-step at 1@256 {steady:.1f} ms ({1e3 / steady:.1f} "
        f"pairs/s; host route {row['scorer']['host_route_pairs_per_s_batch1']}), the call "
        f"{wall:.2f} s; 32@512 {big['ms_per_step']:.1f} ms an update ({big['pairs_per_s']:.1f} "
        f"pairs/s; host route {row['scorer']['host_route_pairs_per_s_32_512']}), peak "
        f"{big['peak_memory_gib']:.2f} GiB [{card}]")


def phase_device_resident(results, card, work):
    """Phase 12: the device-resident corpora and the training profiler."""
    t0 = time.perf_counter()
    row = dict(card=card)
    counts = reset_counts()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t_frames = time.perf_counter()
        lq_dir, gt_dir = write_fls_frames(os.path.join(work, "fls_frames"))
        row["frames_write_s"] = time.perf_counter() - t_frames
        phase_fls_routes(row, card, work, lq_dir, gt_dir)
        phase_teacher_device(row, card, work)
        phase_scorer_device(row, card, work, results)
        phase_profile_steps(row, card, work, lq_dir, gt_dir)
    finally:
        os.chdir(cwd)
    launches = read_counts(counts)
    assert not any(launches.values()), launches  # training reaches no kernel
    row["kernel_launches"] = launches
    row["phase_s"] = time.perf_counter() - t0
    results["device_resident"] = row
    print(json.dumps({"device_resident": row}), flush=True)
    log(f"phase 12: {row['phase_s']:.1f} s")


# ------------------------------------------------------------ phase 13 ---

DP_WORLD = 2  # ranks sharing the one card over gloo
DP_ROWS = 6  # configs/KDLAET.yml's batch_size_per_gpu: the step check's rows per rank
DP_FLS_IDS = (3, 17, 29, 41, 5, 11, 23, 37)  # one global device-resident batch: 2 ranks x 4
DP_TIMEOUT_S = 600  # a rank or launcher still running then fails the phase
DP_DEVICE = "cuda"  # the one-process references' device


def dp_digest(named):
    """sha256 of the parameters' bytes in name order: equal digests, equal
    bits."""
    import hashlib

    h = hashlib.sha256()
    for _, p in sorted(named, key=lambda kv: kv[0]):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_teacher_steps(opt, device, rows, steps=2):
    """``steps`` seeded steps of the config's full-width teacher on ``rows``
    of one (12, 3, 128, 128) batch cut to 64, extra mask 0.1, mixup (every
    draw from host generators keyed by the step, the same on every rank):
    the metrics, the parameters and each step's gradients, on the host."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop

    _, trainer = tloop.build_everything(opt, device=device)
    state = trainer.init_state()
    rng = np.random.default_rng(21)
    b = DP_WORLD * DP_ROWS
    img = rng.random((b, 3, 128, 128), dtype=np.float32)
    hq = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)

    lq = {"img": t(img), "denoise_rate": t(np.full((b, 1, 128, 128), 0.7, np.float32))}
    gt = {"hq": t(hq), "sr": t(hq.repeat(2, 2).repeat(2, 3))}
    metrics, grads = [], []
    for k in range(steps):
        state, m = trainer.step(state, lq, gt, np.random.default_rng([7, k]), extra_prob=0.1,
                                mini_gt_size=64)
        metrics.append({key: float(v) for key, v in m.items()})
        grads.append({n: p.grad.detach().cpu() for n, p in state.model.named_parameters()})
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    del state, trainer
    torch.cuda.empty_cache()
    return metrics, params, grads


def dp_child(spec_path):
    """One rank of phase 13 (``chip_smoke.py --dp-rank SPEC``, started with
    torchrun's env): joins the gloo group on the card, then (a) trains the
    teacher to 4 and resumes it to 6, and runs the seeded steps on its
    rows; (b) trains the device-resident student, samples its rows of one
    global batch and records one step's uploads. Writes what it saw to
    ``<out>_rank{r}.json`` (rank 0 also its step parameters)."""
    import torch

    sys.path.insert(0, HERE)
    from rethink_acoustic_image_enhancement_tpu_torch import parallel
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import resolve_device
    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
    from rethink_acoustic_image_enhancement_tpu_torch.train.device_corpus import (
        build_device_corpus,
        seeded_generator,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.utils import profiling

    with open(spec_path) as fh:
        spec = json.load(fh)
    assert parallel.init_distributed(backend="gloo")
    rank, world = parallel.rank(), parallel.world_size()
    device = resolve_device(None)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)  # the allocator's statistics exist from the first allocation
    fns = reset_counts()
    out = dict(rank=rank, world=world, device=str(device), backend=parallel.backend_name())
    reduce_ms = []
    reduce = ttr.reduce_gradients

    def timed_reduce(params):
        torch.cuda.synchronize(device)
        parallel.barrier()  # the reduction's own time, not the wait for the other rank
        t0 = time.perf_counter()
        reduce(params)
        torch.cuda.synchronize(device)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    ttr.reduce_gradients = timed_reduce

    def parse(yml):
        return tcfg.parse(yml, is_train=True, root_path=spec["work"])

    # (a) the teacher through the loop: to 4 (a checkpoint, a validation), resumed to 6
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for yml in spec["teacher_ymls"]:
        state = tloop.train_from_config(parse(yml), device=device)
    out["teacher"] = dict(digest=dp_digest(state.model.named_parameters()), step=state.step,
                          reduce_ms=list(reduce_ms), train_s=time.perf_counter() - t0,
                          peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    del state
    reduce_ms.clear()
    rows = slice(rank * DP_ROWS, (rank + 1) * DP_ROWS)
    metrics, params, _ = dp_teacher_steps(parse(spec["teacher_ymls"][0]), device, rows)
    out["teacher_steps"] = dict(metrics=metrics, digest=dp_digest(params.items()),
                                reduce_ms=list(reduce_ms))
    if rank == 0:
        torch.save(params, spec["out"] + "_step_params.pt")
    del params
    torch.cuda.empty_cache()

    # (b) the device-resident student through the loop
    reduce_ms.clear()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = tloop.train_from_config(parse(spec["student_yml"]), device=device)
    out["student"] = dict(digest=dp_digest(state.model.named_parameters()), step=state.step,
                          reduce_ms=list(reduce_ms), train_s=time.perf_counter() - t0,
                          peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    del state
    opt = parse(spec["student_yml"])
    corpus = build_device_corpus(opt["datasets"]["train"], device)
    ids = np.asarray(DP_FLS_IDS)
    k = len(ids) // world
    mine = slice(rank * k, (rank + 1) * k)
    lq, gt = corpus.sample_batch(seeded_generator(device, 0, 5), ids, gt_size=192, rows=mine)
    torch.save({"lq": lq.cpu(), "gt": gt.cpu()}, spec["out"] + f"_batch{rank}.pt")
    _, trainer = tloop.build_everything(opt, device=device)
    state = trainer.init_state()
    state.step = 300  # past the warm-up

    def step(j):
        gen = seeded_generator(device, 0, j)
        lq, gt = corpus.sample_batch(gen, ids, gt_size=192, rows=mine)
        return trainer.step(state, lq, gt, np.random.default_rng(j), extra_prob=0.05, gen=gen)

    step(0)
    torch.cuda.synchronize(device)
    with profiling.uploads() as h2d:
        _, m = step(1)
        float(m["l_pix"])
    out["student_step_h2d_bytes"] = h2d
    out["launches"] = read_counts(fns)
    with open(spec["out"] + f"_rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    parallel.shutdown()
    return 0


def dp_launch(argv, work, world, name, env_extra=None):
    """Start ``world`` processes of ``argv`` with torchrun's env on a free
    port (or one launcher process when ``world`` is 0) and wait for them
    under ``DP_TIMEOUT_S``; every process is killed on the way out. Returns
    (stdout of each, wall s); fails on a non-zero exit."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    base["PYTHONPATH"] = HERE + (os.pathsep + base["PYTHONPATH"] if base.get("PYTHONPATH") else "")
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(max(world, 1)):
            env = dict(base, **(env_extra or {}))
            if world:
                env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            cmd = [a.replace("{port}", str(port)) for a in argv]
            log_path = os.path.join(work, f"{name}_{r}.log")
            logs.append(log_path)
            with open(log_path, "w") as fh:
                procs.append(subprocess.Popen(cmd, cwd=work, env=env, stdout=fh,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DP_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for path in logs:
        with open(path) as fh:
            texts.append(fh.read())
    failed = [(r, p.returncode, t[-4000:]) for r, (p, t) in enumerate(zip(procs, texts))
              if p.returncode != 0]
    assert not failed, (name, failed)  # every failing process's tail: the first cause may be any
    return texts, wall


def dp_teacher_ymls(work, roots, val_roots):
    """configs/KDLAET.yml at full width but for its dataroots and depth: one
    step per curriculum stage, to 4 (a checkpoint and a validation at 4),
    then resumed to 6."""
    import yaml

    with open(os.path.join(HERE, "configs", "KDLAET.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["name"] = "dp_teacher"
    cfg["datasets"]["train"].update(roots, iters=[1] * 6)
    cfg["datasets"]["val"].update(val_roots)
    cfg["val"]["val_freq"] = 4
    cfg["logger"].update(save_checkpoint_freq=4, print_freq=1, use_tb_logger=False)
    ymls = []
    for total in (4, 6):
        cfg["train"]["total_iter"] = total
        ymls.append(os.path.join(work, f"dp_teacher_{total}.yml"))
        with open(ymls[-1], "w") as fh:
            yaml.safe_dump(cfg, fh)
    return ymls, cfg


def phase_data_parallel(results, card, work):
    """Phase 13: data-parallel training. (a) and (b) two gloo ranks on the
    one card (child processes of this script, torchrun's env); (c) the real
    launcher, ``python -m torch.distributed.run`` over NCCL with one rank;
    (d) two NCCL ranks where there are two cards."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train.device_corpus import (
        build_device_corpus,
        seeded_generator,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import ProgressiveSchedule

    t_phase = time.perf_counter()
    counts = reset_counts()
    row = dict(card=card, world=DP_WORLD, backend="gloo, two ranks on cuda:0")
    roots = write_train_corpus(os.path.join(work, "triples"), 24, seed=200)
    val_roots = write_train_corpus(os.path.join(work, "val"), 2, seed=300)
    lq_dir, gt_dir = write_fls_frames(os.path.join(work, "fls_frames"))
    row["corpora_write_s"] = time.perf_counter() - t_phase
    teacher_ymls, tcfg_dict = dp_teacher_ymls(work, roots, val_roots)
    student_yml, scfg = fls_config(work, lq_dir, gt_dir, "dp_fls", total=4, iters=[2, 2])
    spec = dict(work=work, out=os.path.join(work, "dp"), teacher_ymls=teacher_ymls,
                student_yml=student_yml)
    spec_path = os.path.join(work, "dp_spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)

    # (a) and (b): the ranks
    _, ranks_wall = dp_launch([sys.executable, os.path.abspath(__file__), "--dp-rank", spec_path],
                              work, DP_WORLD, "dp_rank")
    ranks = []
    for r in range(DP_WORLD):
        with open(f"{spec['out']}_rank{r}.json") as fh:
            ranks.append(json.load(fh))
    assert [(x["rank"], x["world"], x["backend"]) for x in ranks] == [
        (r, DP_WORLD, "gloo") for r in range(DP_WORLD)], ranks
    for key in ("teacher", "teacher_steps", "student"):
        assert len({x[key]["digest"] for x in ranks}) == 1, (key, [x[key]["digest"] for x in ranks])
    assert ranks[0]["teacher_steps"]["metrics"] == ranks[1]["teacher_steps"]["metrics"]
    assert not any(v for x in ranks for v in x["launches"].values()), [x["launches"] for x in ranks]

    # (a) the loop's record (rank 0's), then the step against one process at twice the rows
    exp, events, steps = train_events(work, "dp_teacher")
    assert [e["iter"] for e in steps] == list(range(1, 7)), [e["iter"] for e in steps]
    assert [e["iter"] for e in events if e["kind"] == "resume"] == [4]
    assert [e["iter"] for e in events if e["kind"] == "ckpt"] == [4, 6]
    vals = [e for e in events if e["kind"] == "val"]
    assert [e["iter"] for e in vals] == [4] and np.isfinite(vals[0]["psnr"]), vals
    assert ranks[0]["teacher"]["step"] == 6
    opt = tcfg.parse(teacher_ymls[0], is_train=True, root_path=work)
    t0 = time.perf_counter()
    m_one, p_one, g_one = dp_teacher_steps(opt, torch.device(DP_DEVICE),
                                           slice(0, DP_WORLD * DP_ROWS))
    one_s = time.perf_counter() - t0
    p_dp = torch.load(spec["out"] + "_step_params.pt")
    m_dp = ranks[0]["teacher_steps"]["metrics"]
    rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(m_dp, m_one))
           for k in ("l_pix", "grad_norm")}
    lr = max(m["lr"] for m in m_one)
    gmax = [max(float(v.abs().max()) for v in g.values()) for g in g_one]
    over, rel_p = 0, 0.0
    for n, want in p_one.items():
        big = torch.ones(want.shape, dtype=torch.bool)
        for g, top in zip(g_one, gmax):
            big &= g[n].abs() > 1e-6 * top
        diff = (p_dp[n] - want).abs()
        over += int((diff > torch.where(big, 0.05 * lr * 2, 2 * lr * 2)).sum())
        rel_p = max(rel_p, float(diff.max()) / max(float(want.abs().max()), 1e-30))
    assert max(rel.values()) <= 1e-4 and over == 0, (rel, over)
    assert all(a["lr"] == b["lr"] for a, b in zip(m_dp, m_one))
    n_params = sum(v.numel() for v in p_one.values())
    del p_dp, p_one, g_one
    prog = ProgressiveSchedule.from_dataset_opt(tcfg_dict["datasets"]["train"])
    row["teacher"] = dict(
        config="configs/KDLAET.yml full width (26.88 M parameters), host loader, iters [1]*6: "
               "to 4 (checkpoint, validation), resumed to 6; batch_size_per_gpu 6 per rank",
        steps=[dict(iter=e["iter"], stage=prog.stage(e["iter"]) + 1,
                    rows_per_rank=prog.at(e["iter"])[0], patch=prog.at(e["iter"])[1],
                    ms=1e3 * e["iter_time"], data_ms=1e3 * e["data_time"], l_pix=e["l_pix"])
               for e in steps],
        reduce_ms_per_step=ranks[0]["teacher"]["reduce_ms"],
        parameters=n_params, reduce_mb=4 * n_params / 1e6,
        peak_gib_per_rank=[x["teacher"]["peak_gib"] for x in ranks],
        train_s=ranks[0]["teacher"]["train_s"],
        ranks_bitwise_equal=True,
        step_vs_one_process=dict(rows_per_rank=DP_ROWS, one_process_batch=DP_WORLD * DP_ROWS,
                                 patch=64, rel=rel, weights_over_rule=over,
                                 max_weight_rel=rel_p, loss_dp=[m["l_pix"] for m in m_dp],
                                 loss_one=[m["l_pix"] for m in m_one],
                                 reduce_ms=ranks[0]["teacher_steps"]["reduce_ms"],
                                 one_process_s=one_s))

    # (b) the device-resident student: the ranks' rows of one global batch are
    # the one-process batch, bit for bit; a step's uploads
    corpus = build_device_corpus(scfg["datasets"]["train"], DP_DEVICE)
    lq, gt = corpus.sample_batch(seeded_generator(DP_DEVICE, 0, 5), np.asarray(DP_FLS_IDS),
                                 gt_size=192)
    parts = [torch.load(f"{spec['out']}_batch{r}.pt") for r in range(DP_WORLD)]
    assert torch.equal(torch.cat([p["lq"] for p in parts]), lq.cpu())
    assert torch.equal(torch.cat([p["gt"] for p in parts]), gt.cpu())
    assert tuple(lq.shape) == (len(DP_FLS_IDS), 7, 192, 192), lq.shape
    del corpus, lq, gt
    torch.cuda.empty_cache()
    for x in ranks:
        assert x["student_step_h2d_bytes"] and max(x["student_step_h2d_bytes"]) <= MAX_STEP_UPLOAD, x
    _, events, s_steps = train_events(work, "dp_fls")
    assert [e["iter"] for e in s_steps] == [1, 2, 3, 4], s_steps
    sprog = ProgressiveSchedule.from_dataset_opt(scfg["datasets"]["train"])
    row["student"] = dict(
        config="configs/KDLAES_FLS_ft.yml full width, device-resident, 64 frames, iters [2, 2]: "
               "global 8 x 7 (4 per rank) at 192 then 256, from the zoo student",
        stages=stage_rows(s_steps, sprog, 7, 4),
        reduce_ms_per_step=ranks[0]["student"]["reduce_ms"],
        peak_gib_per_rank=[x["student"]["peak_gib"] for x in ranks],
        global_batch_equals_one_process=True,
        step_h2d_bytes=[x["student_step_h2d_bytes"] for x in ranks])
    row["ranks_wall_s"] = ranks_wall

    # (c) the real launcher over NCCL, one rank
    nccl_yml, _ = fls_config(work, lq_dir, gt_dir, "dp_nccl", total=2, iters=[2, 2])
    launcher = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node={n}",
                "--master_addr=127.0.0.1", "--master_port={port}", "-m", f"{PORT}.cli",
                "train", "-opt", "{yml}", "--launcher", "pytorch"]

    def torchrun(n, yml, name):
        argv = [a.replace("{n}", str(n)).replace("{yml}", yml) for a in launcher]
        (text,), wall = dp_launch(argv, work, 0, name, env_extra={"LOGLEVEL": "INFO"})
        exp = os.path.join(work, "experiments", os.path.basename(yml)[:-4])
        assert os.path.isfile(os.path.join(exp, "training_states", "ckpt_2.pth")), text[-3000:]
        assert os.path.isfile(os.path.join(exp, "metrics.jsonl")), text[-3000:]
        for r in range(n):
            assert f"multi-process: rank {r}/{n}, device cuda:{r}, backend nccl" in text, \
                text[-3000:]
        _, _, st = train_events(work, os.path.basename(yml)[:-4])
        assert [e["iter"] for e in st] == [1, 2], st
        return dict(call_s=wall, ms_per_step=[1e3 * e["iter_time"] for e in st],
                    l_pix=[e["l_pix"] for e in st])

    row["nccl_one_rank"] = torchrun(1, nccl_yml, "dp_nccl")
    # (d) two NCCL ranks, one card each, where there are two
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        yml2, _ = fls_config(work, lq_dir, gt_dir, "dp_nccl2", total=2, iters=[2, 2])
        row["nccl_two_ranks"] = torchrun(2, yml2, "dp_nccl2")
    else:
        row["nccl_two_ranks"] = (f"not run: {n_cards} card visible; two NCCL ranks need a "
                                 "card each (NCCL refuses two ranks on one device)")
    launches = read_counts(counts)
    assert not any(launches.values()), launches  # training reaches no kernel
    row["kernel_launches"] = dict(parent=launches, ranks=[x["launches"] for x in ranks])
    row["phase_s"] = time.perf_counter() - t_phase
    results["data_parallel"] = row
    print(json.dumps({"data_parallel": row}), flush=True)
    t = row["teacher"]
    log("data parallel, teacher, 2 gloo ranks on one card: " + ", ".join(
        f"{s['rows_per_rank']}x2@{s['patch']} {s['ms']:.1f} ms" for s in t["steps"])
        + f"; gradient reduction ({t['reduce_mb']:.1f} MB) "
        f"{np.median(t['reduce_ms_per_step']):.1f} ms a step; peak "
        f"{t['peak_gib_per_rank']} GiB per rank; step vs one process at 12: {rel}, "
        f"max weight rel {rel_p:.2e} [{card}]")
    log("data parallel, student device-resident: " + ", ".join(
        f"{s['batch']}x7@{s['patch']} per rank {np.median(s['ms_per_step']):.1f} ms a step"
        for s in row["student"]["stages"]) + f"; step uploads {row['student']['step_h2d_bytes']} "
        f"bytes; NCCL one rank through torchrun {row['nccl_one_rank']['call_s']:.1f} s; "
        f"two NCCL ranks: {row['nccl_two_ranks'] if isinstance(row['nccl_two_ranks'], str) else 'ran'}"
        f" [{card}]")
    log(f"phase 13: {row['phase_s']:.1f} s")


# ------------------------------------------------------------ phase 14 ---

STAGES_PER_CHUNK = 3  # the gate admits 3 of the flagship's stages at 256^2 tiles


def serving_devices():
    """(devices, why): every card, or two copies on cuda:0 where there is
    one card, and the line that says so."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return [f"cuda:{i}" for i in range(n)], f"{n} cards: one copy on each"
    return ["cuda:0", "cuda:0"], ("one card visible: two copies share cuda:0 (scaling "
                                  "across cards is not measured)")


def sync_all(devices):
    import torch

    for d in sorted(set(devices)):
        torch.cuda.synchronize(d)


def device_busy(prof):
    """(summed ms, busy ms) of every device activity in a profile: the sum
    of the kernels' and copies' times, and the union of their intervals
    (where streams overlap on a card the sum outgrows the wall); (None,
    None) where the profile holds none."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, None
    union, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            union += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    union += cur_e - cur_s
    return sum(e_ - s_ for s_, e_ in spans) / 1e3, union / 1e3


def phase_dp_teacher(row, card, devices):
    """(a) the phase-3 flagship teacher (bf16, fused) tiled on every copy,
    against the same copies with the plain stage and against one device;
    returns the counted stage-kernel calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import (
        TransformerStage,
        flagship_teacher,
        init_weights_,
        kdlae_teacher,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

    model = init_weights_(flagship_teacher(static="train"),
                          torch.Generator().manual_seed(0)).to(torch.bfloat16)
    one = TeacherPredictor(model, fused=True, dtype=torch.bfloat16)
    dp = TeacherPredictor(model, fused=True, dtype=torch.bfloat16, devices=devices)
    del model
    n_copies = len(dp.models)
    imgs = [sonar_frame(512, 512, 5), sonar_frame(512, 512, 6), sonar_frame(500, 380, 7)]
    seen = []  # the hooks fire on every copy
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape))) or None)
        for model in dp.models for m in model.modules() if isinstance(m, TransformerStage)]
    modes = [dict(tile=256, halo=0, tile_batch=8),
             dict(tile=(256, 512), halo=(8, 0), tile_batch=8)]
    rows, total = [], 0
    for kw in modes:
        one.denoise_tiled(imgs, 0.8, **kw)  # warm-ups: cuDNN plans at these batches
        dp.denoise_tiled(imgs, 0.8, **kw)
        sync_all(devices)
        t0 = time.perf_counter()
        refs = one.denoise_tiled(imgs, 0.8, **kw)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        seen.clear()
        counts = reset_counts()
        t0 = time.perf_counter()
        outs = dp.denoise_tiled(imgs, 0.8, **kw)
        sync_all(devices)
        dp_s = time.perf_counter() - t0
        launches = read_counts(counts)["stage"]
        admitted = [(m, shp) for m, shp in seen if stage_gate.stage_worthwhile(
            shp[0], shp[2], shp[3], m.dim, m.num_heads, m.bias_free_ln, m.use_bias,
            m.ffn_expansion_factor)]
        chunks = sum(1 for m, _ in seen if m is dp.model.encoder_level1)
        per_copy = kw["tile_batch"] // n_copies
        assert launches == len(admitted) == STAGES_PER_CHUNK * chunks * n_copies > 0, (
            launches, len(admitted), chunks)
        assert all(shp[0] == per_copy for _, shp in admitted), sorted({s for _, s in admitted})

        # the same copies at the same batch with the plain stage
        fused_stage = kdlae_teacher.fused_transformer_stage
        kdlae_teacher.fused_transformer_stage = pstage.stage_plain
        try:
            plains = dp.denoise_tiled(imgs, 0.8, **kw)
        finally:
            kdlae_teacher.fused_transformer_stage = fused_stage
        agree = []
        for img, out, plain, ref in zip(imgs, outs, plains, refs):
            h, w = img.shape[:2]
            mask = np.all(img == 0, axis=-1)
            for key, s in (("hq", 1), ("sr", 2)):
                o = out[key]
                assert o.dtype == np.uint8 and o.shape == (h * s, w * s, 3), (key, o.shape)
                assert not o[np.repeat(np.repeat(mask, s, 0), s, 1)].any(), \
                    f"{key}: zero-mask pixels not 0"
                frac_plain, worst_plain = within_levels(o, plain[key])
                frac, worst = within_levels(o, ref[key])
                agree.append(dict(shape=[h, w], key=key, within_1_level_of_plain=frac_plain,
                                  max_levels_from_plain=worst_plain, within_1_level=frac,
                                  max_levels=worst))
                assert frac_plain >= 0.99, \
                    f"{key}: only {frac_plain:.4f} of pixels within 1 level of the plain stage"
                assert frac >= 0.99, f"{key}: only {frac:.4f} of pixels within 1 level"

        # one call that is one chunk of 8 tiles: wall, device busy, idle share
        t_h, t_w = (kw["tile"],) * 2 if isinstance(kw["tile"], int) else kw["tile"]
        one_chunk = [sonar_frame(512, 512, 20 + i) for i in range(8 * t_h * t_w // (512 * 512))]
        walls = {}
        for name, pred in (("one_device", one), ("copies", dp)):
            t0 = time.perf_counter()
            pred.denoise_tiled(one_chunk, 0.8, **kw)
            sync_all(devices)
            walls[name] = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dp.denoise_tiled(one_chunk, 0.8, **kw)
            sync_all(devices)
        summed_ms, busy_ms = device_busy(prof)
        mode = dict(kw, images=len(imgs), chunks=chunks, copies=n_copies,
                    tiles_per_copy_call=per_copy, stage_calls=launches,
                    gate_predicted=len(admitted), wall_s=dp_s, one_device_wall_s=one_s,
                    images_per_s=len(imgs) / dp_s, one_device_images_per_s=len(imgs) / one_s,
                    chunk_wall_ms=walls["copies"], one_device_chunk_wall_ms=walls["one_device"],
                    chunk_device_summed_ms=summed_ms, chunk_device_busy_ms=busy_ms,
                    chunk_idle_share=None if busy_ms is None else 1 - busy_ms / walls["copies"],
                    agreement=agree)
        rows.append(mode)
        total += launches
        log(f"data-parallel tiled {kw} on {devices}: {mode['images_per_s']:.2f} images/s "
            f"(one device {mode['one_device_images_per_s']:.2f}); {chunks} chunks, {launches} "
            f"stage calls ({STAGES_PER_CHUNK} a chunk a copy, gate {len(admitted)}); one "
            f"chunk: wall "
            f"{walls['copies']:.2f} ms (one device {walls['one_device']:.2f}), device busy "
            + ("not measured (the profile saw no device activity)" if busy_ms is None else
               f"{busy_ms:.2f} ms of {summed_ms:.2f} summed (idle share "
               f"{mode['chunk_idle_share']:.3f})") + "; within 1 level of the plain stage: "
            f"{min(a['within_1_level_of_plain'] for a in agree):.4f}, of one device: "
            f"{min(a['within_1_level'] for a in agree):.4f} [{card}]")
    for h in hooks:
        h.remove()
    row["teacher_tiled"] = rows
    return total


def phase_dp_student(row, card, devices):
    """(b) phase 6's stacks through denoise_batch on every copy, at 18 and
    at 17 (the even split pads), against one device."""
    import copy

    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import StudentPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAEStudent

    torch.manual_seed(0)
    model = KDLAEStudent(residual=True, hidden_channels=(16, 32, 64))
    one = StudentPredictor(copy.deepcopy(model))
    dp = StudentPredictor(model, devices=devices)
    stacks = sonar_stacks(18, 7, 512, 512, seed=30)
    rows = []
    for b in (18, 17):
        x = stacks[:b]
        one.denoise_batch(x)  # warm-ups: cuDNN plans at these shapes
        dp.denoise_batch(x)
        sync_all(devices)
        for d in sorted(set(devices)):
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        out = dp.denoise_batch(x)
        dp_s = time.perf_counter() - t0
        peaks = {d: torch.cuda.max_memory_allocated(d) / 2**30 for d in sorted(set(devices))}
        t0 = time.perf_counter()
        ref = one.denoise_batch(x)
        one_s = time.perf_counter() - t0
        assert out.shape == x.shape and out.dtype == np.uint8, (out.shape, out.dtype)
        share, worst = within_levels(out, ref)
        frames = x.shape[0] * x.shape[1]
        rows.append(dict(batch=b, frames_per_s=frames / dp_s,
                         one_device_frames_per_s=frames / one_s, peak_gib=peaks,
                         within_1_level=share, max_levels=worst))
        log(f"data-parallel student {b}x7x512x512 on {devices}: {frames / dp_s:.1f} frames/s "
            f"(one device {frames / one_s:.1f}), peak {peaks} GiB; within 1 level of one "
            f"device {share:.5f}, max {worst} [{card}]")
        assert share >= 0.999, f"student batch {b}: {share} within 1 level of one device"
    row["student"] = rows


def phase_dp_scorer(row, card, devices):
    """(c) phase 7's pairs batch-1 through score_pairs and as batches of 8
    on every copy, against one device."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.eval.asdqe_eval import score_pairs
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import ASDQEScorer

    one = ASDQEScorer(seeded_scorer_model(7))
    dp = ASDQEScorer(seeded_scorer_model(7), devices=devices)
    rng = np.random.default_rng(40)
    pairs = []
    for i in range(16):
        lq = sonar_frame(512, 512, 40 + i)
        noise = rng.integers(-30, 31, size=lq.shape)
        pairs.append((lq, np.clip(lq.astype(np.int16) // 2 + noise, 0, 255).astype(np.uint8)))
    lq8 = [np.stack([p[0] for p in pairs[k:k + 8]]) for k in (0, 8)]
    gt8 = [np.stack([p[1] for p in pairs[k:k + 8]]) for k in (0, 8)]
    scores, secs = {}, {}
    for name, scorer in (("one_device", one), ("copies", dp)):
        score_pairs(scorer, pairs[:2])  # warm-ups, batch 1 and batch 8
        scorer(lq8[0], gt8[0])
        sync_all(devices)
        t0 = time.perf_counter()
        scores[name, 1] = score_pairs(scorer, pairs)
        secs[name, 1] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scores[name, 8] = np.concatenate([scorer(a, b) for a, b in zip(lq8, gt8)])
        secs[name, 8] = time.perf_counter() - t0
    got1, got8 = scores["copies", 1], scores["copies", 8]
    err = max(float(np.abs(got1 - scores["one_device", 1]).max()),
              float(np.abs(got8 - scores["one_device", 8]).max()))
    row["scorer"] = dict(pairs=16, max_abs_vs_one_device=err, **{
        f"{'' if name == 'copies' else 'one_device_'}batch{b}_pairs_per_s": 16 / sec
        for (name, b), sec in secs.items()})
    log(f"data-parallel scorer on {devices}: batch-1 {16 / secs['copies', 1]:.1f} pairs/s "
        f"(one device {16 / secs['one_device', 1]:.1f}), batch 8 {16 / secs['copies', 8]:.1f} "
        f"(one device {16 / secs['one_device', 8]:.1f}); scores within {err:.2e} of one "
        f"device [{card}]")
    assert np.isfinite(got8).all() and got1.shape == got8.shape == (16,)
    assert err <= 1e-4, f"scores {err} from one device"
    torch.cuda.empty_cache()


def phase_metrics(row, card):
    """(d) NIQE on the host; FID in the zoo scorer's feature space on the
    card against the CPU; InceptionV3 pool3 from a saved .pth of seeded
    random weights through ``make_inception_feature_fn``, on the card
    against the CPU."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.metrics import fid, inception
    from rethink_acoustic_image_enhancement_tpu_torch.metrics.niqe import calculate_niqe

    frames = [sonar_frame(512, 512, 300 + i) for i in range(16)]
    t0 = time.perf_counter()
    niqe = [calculate_niqe(f) for f in frames]
    niqe_s = (time.perf_counter() - t0) / len(frames)
    assert all(np.isfinite(v) and v > 0 for v in niqe), niqe

    set_a = np.stack([sonar_frame(512, 512, 400 + i) for i in range(16)]).astype(np.float32) / 255
    set_b = np.stack([sonar_frame(512, 512, 500 + i) // 2 + 40 for i in range(16)]
                     ).astype(np.float32) / 255

    def batches(x, n):
        return [x[i:i + n] for i in range(0, len(x), n)]

    card_fn = fid.make_asdqe_feature_fn()
    assert card_fn.feature_space.startswith("asdqe-trained("), card_fn.feature_space
    card_fn(set_a[:2])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa, fb = (fid.extract_features(batches(x, 8), card_fn) for x in (set_a, set_b))
    feat_s = time.perf_counter() - t0
    cpu_fn = fid.make_asdqe_feature_fn(device="cpu")
    ca, cb = (fid.extract_features(batches(x, 4), cpu_fn) for x in (set_a, set_b))
    feat_rel = max(float(np.abs(f - c).max() / np.abs(c).max())
                   for f, c in ((fa, ca), (fb, cb)))
    fid_card = fid.fid_between_feature_sets(fa, fb)
    fid_cpu = fid.fid_between_feature_sets(ca, cb)
    fid_rel = abs(fid_card - fid_cpu) / abs(fid_cpu)

    # a user's .pth (seeded random weights) through the entry point, on the
    # card and on the CPU
    model = inception.init_weights_(inception.InceptionV3(), torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory(prefix="raie_inception_") as tmp:
        path = os.path.join(tmp, "inception.pth")
        torch.save(model.state_dict(), path)
        card_inc = inception.make_inception_feature_fn(path)
        cpu_inc = inception.make_inception_feature_fn(path, device="cpu")
    del model
    assert card_inc.feature_space == f"inception-pool3(fid:{path})", card_inc.feature_space
    frames32 = np.stack([sonar_frame(512, 512, 600 + i) for i in range(32)]).astype(np.float32) / 255
    card_inc(frames32[:8])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = card_inc(frames32)
    inc_s = time.perf_counter() - t0
    cpu = cpu_inc(frames32[:2])
    inc_rel = float(np.abs(feats[:2] - cpu).max() / np.abs(cpu).max())
    row["metrics"] = dict(
        niqe_s_per_image=niqe_s, niqe_range=[float(min(niqe)), float(max(niqe))],
        fid_feature_space=card_fn.feature_space, fid_features_per_s=32 / feat_s,
        fid_card=fid_card, fid_cpu=fid_cpu, fid_rel_err=fid_rel, fid_feature_rel_err=feat_rel,
        inception_images_per_s=32 / inc_s, inception_rel_err=inc_rel,
        inception_feature_absmax=float(np.abs(feats).max()))
    log(f"metrics: NIQE {niqe_s * 1e3:.1f} ms an image (host), values "
        f"{row['metrics']['niqe_range']}; FID (zoo ASDQE space) {fid_card:.6f} on the card, "
        f"{fid_cpu:.6f} on the CPU (rel {fid_rel:.2e}; features rel {feat_rel:.2e}), "
        f"{32 / feat_s:.1f} features/s; InceptionV3 pool3 {32 / inc_s:.1f} images/s at "
        f"512->299, rel {inc_rel:.2e} of the CPU [{card}]")
    assert feat_rel <= 1e-4, f"ASDQE features {feat_rel} from the CPU's"
    assert fid_rel <= 1e-3, f"FID {fid_card} against {fid_cpu} on the CPU"
    assert np.isfinite(feats).all() and feats.shape == (32, 2048)
    assert inc_rel <= 1e-3, f"pool3 features {inc_rel} from the CPU's"


def phase_dp_serving(results, card):
    """Phase 14: data-parallel serving on a list of devices, and the
    metrics; returns the stage-kernel calls of the copies' tiled runs."""
    import torch

    t0 = time.perf_counter()
    devices, why = serving_devices()
    log(f"phase 14 devices {devices}: {why}")
    row = dict(card=card, devices=devices, why=why)
    launches = phase_dp_teacher(row, card, devices)
    torch.cuda.empty_cache()
    phase_dp_student(row, card, devices)
    torch.cuda.empty_cache()
    phase_dp_scorer(row, card, devices)
    phase_metrics(row, card)
    row["stage_launches"] = launches
    row["phase_s"] = time.perf_counter() - t0
    results["dp_serving"] = row
    print(json.dumps({"dp_serving": row}), flush=True)
    log(f"phase 14: {row['phase_s']:.1f} s")
    return launches


# ------------------------------------------------------------ phase 15 ---

P15_SIZE = 512  # (a) and (b): the seeded images' side
P15_TRAIN, P15_VAL = 24, 2  # pairs written for training and for validation
P15_STEPS = 4  # (a): steps per route; (b) and (c) take 3
DPDD_HW = (1120, 1680)  # DPDD's frame size (h, w)
DPDD_TRIPLES = 8  # (c): one batch of 8 at the config's first stage
VIDEO_SIZES = dict(vimeo_gt=(256, 448), reds_gt=(720, 1280), ffhq=(1024, 1024), scale=4,
                   gt_size=256, reds_frames=10, vimeo_clips=8, ffhq_images=8)
VIDEO_EPOCH_ITEMS = 64  # (d): each set's sampler enlarged to at least this many items
CODEC_PASSES = 10  # (a): passes over every record when timing the codec's lookups
WARP_SHAPE = (7, 256, 448)  # (e): a Vimeo90K septuplet


def colour_frame(h, w, seed, depth=8):
    """A seeded smooth colour image (two random sinusoid gratings per
    channel) as uint8, or uint16 with ``depth=16``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.empty((h, w, 3), np.float64)
    for c in range(3):
        f1, f2, p1, p2 = rng.uniform(1, 6), rng.uniform(2, 9), *rng.uniform(0, 6.3, 2)
        img[..., c] = 0.5 + 0.25 * np.sin(2 * np.pi * f1 * xx + p1) \
            + 0.2 * np.sin(2 * np.pi * f2 * (xx + yy) + p2)
    top = 65535 if depth == 16 else 255
    return np.rint(np.clip(img, 0, 1) * top).astype(np.uint16 if depth == 16 else np.uint8)


def write_pair_folders(root, n, seed, noise=20.0):
    """n seeded colour images (gt) and noisy versions (lq) at P15_SIZE;
    returns the two dataroots."""
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("lq", "gt")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        gt = colour_frame(P15_SIZE, P15_SIZE, seed * 1000 + i)
        lq = np.clip(gt + rng.normal(0, noise, gt.shape), 0, 255).astype(np.uint8)
        imwrite(os.path.join(dirs["gt"], f"{i:04d}.png"), gt)
        imwrite(os.path.join(dirs["lq"], f"{i:04d}.png"), lq)
    return {f"dataroot_{k}": d for k, d in dirs.items()}


def baseline_config(name, train, val, steps):
    """configs/Restormer_baseline.yml at full width, cut to ``steps`` steps
    at its own batch and patch (8 @ 128), a checkpoint and a validation at
    the end, every step logged."""
    import yaml

    with open(os.path.join(HERE, "configs", "Restormer_baseline.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["name"] = name
    cfg["datasets"]["train"].update(train, iters=[steps])
    cfg["datasets"]["val"].update(val)
    cfg["train"]["total_iter"] = steps
    cfg["logger"].update(print_freq=1, save_checkpoint_freq=steps)
    cfg["val"]["val_freq"] = steps
    return cfg


def cli_train(work, cfg):
    """`train -opt` on ``cfg`` from ``work`` on the card: (train events,
    val events, wall s)."""
    import yaml

    yml = os.path.join(work, cfg["name"] + ".yml")
    with open(yml, "w") as fh:
        yaml.safe_dump(cfg, fh)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        _, wall = run_cli(["train", "-opt", yml])
    finally:
        os.chdir(cwd)
    events = jsonl_events(os.path.join(work, "experiments", cfg["name"], "metrics.jsonl"))
    return ([e for e in events if e["kind"] == "train"],
            [e for e in events if e["kind"] == "val"], wall)


def codec_read_rate(shards):
    """The route the lmdb backend takes (data/lmdb_codec.py here) on
    ``shards``, timed in two parts: opening them (the codec reads each whole
    file), over the files' bytes, and ``CODEC_PASSES`` passes of ``get``
    over every record, over the records' bytes."""
    from rethink_acoustic_image_enhancement_tpu_torch.data.file_client import FileClient
    from rethink_acoustic_image_enhancement_tpu_torch.data.lmdb_util import paths_from_lmdb

    keys = {s: paths_from_lmdb(s) for s in shards}
    file_bytes = sum(os.path.getsize(os.path.join(s, "data.mdb")) for s in shards)
    t0 = time.perf_counter()
    client = FileClient("lmdb", db_paths=list(shards), client_keys=list(shards))
    open_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(CODEC_PASSES):
        record_bytes = sum(len(client.get(k, s)) for s in shards for k in keys[s])
    get_s = time.perf_counter() - t0
    return dict(shard_file_bytes=file_bytes, record_bytes=record_bytes,
                records=sum(map(len, keys.values())), open_s=open_s,
                open_mb_s=file_bytes / 1e6 / open_s, get_passes=CODEC_PASSES, get_s=get_s,
                get_mb_s=CODEC_PASSES * record_bytes / 1e6 / get_s)


def phase15_lmdb(row, card, work):
    """(a) the full-width Restormer trained from LMDB shards and from the
    same folders on disk: the same first loss bit for bit."""
    from rethink_acoustic_image_enhancement_tpu_torch.data.lmdb_util import (
        lmdb_route,
        make_lmdb_from_folder,
    )

    t0 = time.perf_counter()
    train = write_pair_folders(os.path.join(work, "train"), P15_TRAIN, seed=500)
    val = write_pair_folders(os.path.join(work, "val"), P15_VAL, seed=501)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = {}
    for split, roots in (("train", train), ("val", val)):
        for key, folder in roots.items():
            shards[(split, key)] = folder + ".lmdb"
            make_lmdb_from_folder(folder, shards[(split, key)])
    shard_s = time.perf_counter() - t0
    codec = codec_read_rate(list(shards.values()))
    lmdb = {"type": "lmdb"}
    routes = {}
    for name, tr, va in (
            ("disk", train, val),
            ("lmdb", {**{k: shards[("train", k)] for k in train}, "io_backend": lmdb},
             {**{k: shards[("val", k)] for k in val}, "io_backend": lmdb})):
        fns = reset_counts()
        steps, vals, wall = cli_train(work, baseline_config(f"restormer_{name}", tr, va,
                                                            P15_STEPS))
        assert [e["iter"] for e in steps] == list(range(1, P15_STEPS + 1)), steps
        assert all(np.isfinite(e["l_pix"]) for e in steps) and len(vals) == 1, vals
        routes[name] = dict(losses=[e["l_pix"] for e in steps],
                            grad_norms=[e["grad_norm"] for e in steps],
                            data_ms=[1e3 * e["data_time"] for e in steps],
                            iter_ms=[1e3 * e["iter_time"] for e in steps],
                            val_psnr=vals[0]["psnr"], train_call_s=wall,
                            kernel_launches=read_counts(fns))
    a, b = routes["disk"], routes["lmdb"]
    assert a["losses"][0] == b["losses"][0], (a["losses"], b["losses"])
    rel = max(abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"]))
    assert rel <= 1e-4, (a["losses"], b["losses"])
    row["lmdb"] = dict(
        config="configs/Restormer_baseline.yml at full width (dim 48, [4,6,6,8], refinement 4, "
               f"BiasFree): iters [{P15_STEPS}] at 8@128, a validation at the end",
        corpus=f"{P15_TRAIN} + {P15_VAL} seeded {P15_SIZE}^2 colour pairs, PNG",
        route=lmdb_route(), write_s=write_s, shard_write_s=shard_s, codec=codec,
        losses_rel_diff=rel, **{
            f"{k}_route": v for k, v in routes.items()})
    log(f"(a) LMDB ({lmdb_route()} route; {codec['shard_file_bytes']} B of shards opened at "
        f"{codec['open_mb_s']:.0f} MB/s, records got at {codec['get_mb_s']:.0f} MB/s): losses {b['losses']} vs disk "
        f"{a['losses']} (rel {rel:.2e}); data ms lmdb {np.median(b['data_ms']):.1f} disk "
        f"{np.median(a['data_ms']):.1f} [{card}]")
    return train, val


def phase15_gaussian(row, card, work, train, val):
    """(b) Gaussian colour denoising from the clean images, and one batch
    the loader put on the card against the CPU dataset's items."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld
    from rethink_acoustic_image_enhancement_tpu_torch.data.datasets import create_dataset

    cfg = baseline_config("restormer_gaussian", {}, {}, 3)
    for phase, roots in (("train", train), ("val", val)):
        ds = cfg["datasets"][phase]
        ds.pop("dataroot_lq")
        ds.update(type="Dataset_GaussianDenoising", dataroot_gt=roots["dataroot_gt"], in_ch=3)
    cfg["datasets"]["train"].update(sigma_type="random", sigma_range=[0, 50])
    cfg["datasets"]["val"]["sigma_test"] = 25
    fns = reset_counts()
    steps, vals, wall = cli_train(work, cfg)
    assert len(steps) == 3 and all(np.isfinite(e["l_pix"]) for e in steps), steps
    assert len(vals) == 1 and np.isfinite(vals[0]["psnr"]), vals

    opt = dict(cfg["datasets"]["train"], phase="train", scale=1)
    ds = create_dataset(opt)
    sampler = tld.EnlargedShuffleSampler(len(ds), 1, shuffle=True, seed=opt.get("seed", 0))
    loader = tld.BatchLoader(ds, 8, sampler, num_workers=4)
    uploader = tld.BatchUploader(torch.device("cuda"), ds.frame_stacks)
    batch = uploader(next(iter(loader)))
    torch.cuda.synchronize()
    idx = sampler.epoch_indices(0)[:8]
    for key in ("lq", "gt"):
        on_card = batch[key].permute(0, 2, 3, 1).cpu().numpy()
        want = np.stack([ds[int(i)][key] for i in idx])
        assert on_card.dtype == want.dtype and np.array_equal(on_card, want), key
    row["gaussian"] = dict(
        config="Restormer_baseline.yml's network on Dataset_GaussianDenoising as "
               "GaussianColorDenoising_Restormer.yml: in_ch 3, sigma random in [0, 50], "
               "sigma_test 25, 3 steps at 8@128",
        losses=[e["l_pix"] for e in steps], val_psnr=vals[0]["psnr"],
        iter_ms=[1e3 * e["iter_time"] for e in steps], train_call_s=wall,
        kernel_launches=read_counts(fns), batch_on_card_equals_items=True)
    log(f"(b) gaussian: losses {row['gaussian']['losses']}, val PSNR {vals[0]['psnr']:.2f} "
        f"at sigma 25 [{card}]")


def write_dpdd(root, n, seed):
    """n seeded 16-bit lqL / lqR / gt triples at DPDD_HW: the gt a smooth
    colour image, each view it shifted by 3 px and noised."""
    import cv2

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("lqL", "lqR", "gt")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        gt = colour_frame(*DPDD_HW, seed * 1000 + i, depth=16)
        views = {"gt": gt}
        for key, shift in (("lqL", -3), ("lqR", 3)):
            v = np.roll(gt, shift, axis=1).astype(np.float64) + rng.normal(0, 300, gt.shape)
            views[key] = np.clip(v, 0, 65535).astype(np.uint16)
        for key, img in views.items():
            assert cv2.imwrite(os.path.join(dirs[key], f"{i:03d}.png"), img[..., ::-1])
    return {f"dataroot_{k}": d for k, d in dirs.items()}


def phase15_dual_pixel(row, card, work):
    """(c) the dual-pixel Restormer trained on 16-bit triples, then the
    flagship-width dual-pixel KDLAE-T through the stage kernel on one whole
    frame against the same model with the plain stage; returns the
    stage-kernel calls."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.data.datasets import create_dataset
    from rethink_acoustic_image_enhancement_tpu_torch.models import (
        KDLAETeacher,
        TransformerStage,
        init_weights_,
        kdlae_teacher,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

    t0 = time.perf_counter()
    roots = write_dpdd(os.path.join(work, "dpdd"), DPDD_TRIPLES, seed=600)
    write_s = time.perf_counter() - t0
    cfg = baseline_config("restormer_dpdd", {}, {}, 3)
    ds_opt = dict(type="Dataset_DefocusDeblur_DualPixel_16bit", geometric_augs=True, **roots)
    cfg["datasets"]["train"] = dict(cfg["datasets"]["train"], **ds_opt)
    cfg["datasets"]["train"].pop("dataroot_lq")
    del cfg["datasets"]["val"]
    cfg["val"]["val_freq"] = 0
    cfg["network_g"].update(inp_channels=6, dual_pixel_task=True, LayerNorm_type="WithBias")
    fns = reset_counts()
    steps, _, wall = cli_train(work, cfg)
    assert len(steps) == 3 and all(np.isfinite(e["l_pix"]) for e in steps), steps
    train_launches = read_counts(fns)

    item = create_dataset(dict(ds_opt, phase="val", scale=1))[0]
    h, w = DPDD_HW
    assert item["lq"].shape == (h, w, 6) and item["gt"].shape == (h, w, 3)
    model = KDLAETeacher(inp_channels=6, dual_pixel_task=True, params="none", static="test",
                         layernorm_type="BiasFree")
    init_weights_(model, torch.Generator().manual_seed(15))
    model = model.to(torch.bfloat16).cuda().eval().set_fused(True)
    x = torch.from_numpy(item["lq"]).cuda().permute(2, 0, 1)[None].bfloat16()
    seen = []  # what the gate admits, read off each stage's input in the run
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape))) or None)
        for m in model.modules() if isinstance(m, TransformerStage)]
    with torch.inference_mode():
        model({"img": x})  # warm-up
        torch.cuda.synchronize()
        for hk in hooks:
            hk.remove()
        want = sum(stage_gate.stage_worthwhile(
            b, hh, ww, m.dim, m.num_heads, m.bias_free_ln, m.use_bias,
            m.ffn_expansion_factor) for m, (b, _, hh, ww) in seen)
        fns = reset_counts()
        t0 = time.perf_counter()
        hq = model({"img": x})["hq"].float()
        torch.cuda.synchronize()
        fused_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(fns)["stage"]
        plain_stage = kdlae_teacher.fused_transformer_stage
        kdlae_teacher.fused_transformer_stage = pstage.stage_plain
        try:
            ref = model({"img": x})["hq"].float()
        finally:
            kdlae_teacher.fused_transformer_stage = plain_stage
    assert hq.shape == (1, 3, h, w) and torch.isfinite(hq).all().item()
    d = (hq - ref).abs()
    within = float((d <= 1 / 255).float().mean())
    assert launches == want >= 1, (launches, want)
    assert within >= 0.99, f"only {within:.4f} of hq values within 1/255 of the plain stage"
    row["dual_pixel"] = dict(
        config="DefocusDeblur_DualPixel_16bit_Restormer.yml's network (inp_channels 6, "
               "dual_pixel_task, WithBias) on Dataset_DefocusDeblur_DualPixel_16bit, 3 steps "
               "at 8@128",
        triples=DPDD_TRIPLES, frame=list(DPDD_HW), write_s=write_s,
        losses=[e["l_pix"] for e in steps], iter_ms=[1e3 * e["iter_time"] for e in steps],
        data_ms=[1e3 * e["data_time"] for e in steps], train_call_s=wall,
        train_kernel_launches=train_launches,
        teacher="KDLAE-T flagship width, dual_pixel_task, params none, inp_channels 6, "
                "seeded init_weights_, bf16, fused",
        stage_launches=launches, fused_ms=fused_ms, hq_within_1_255=within,
        hq_max_abs_diff=float(d.max()))
    log(f"(c) dual pixel: losses {row['dual_pixel']['losses']}; teacher {h}x{w} fused "
        f"{fused_ms:.1f} ms, {launches} stage calls, {within:.5f} of hq within 1/255 of the "
        f"plain stage [{card}]")
    del model, x, hq, ref
    torch.cuda.empty_cache()
    return launches


def write_video_sets(root):
    """Vimeo90K septuplets, one REDS clip, FFHQ faces and (the REDS clip
    again) a VideoTest folder at their published frame sizes, seeded."""
    from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

    v = VIDEO_SIZES
    s = v["scale"]

    def put(path, hw, seed):
        rng = np.random.default_rng(seed)
        imwrite(path, rng.integers(0, 256, (*hw, 3), dtype=np.uint8))

    keys = [f"00001/{k:04d}" for k in range(1, v["vimeo_clips"] + 1)]
    for j, key in enumerate(keys):
        for i in range(1, 8):
            gh, gw = v["vimeo_gt"]
            put(os.path.join(root, "vimeo", "gt", key, f"im{i}.png"), (gh, gw), 700 + 10 * j + i)
            put(os.path.join(root, "vimeo", "lq", key, f"im{i}.png"), (gh // s, gw // s),
                800 + 10 * j + i)
    with open(os.path.join(root, "vimeo", "meta.txt"), "w") as fh:
        fh.write("".join(f"{k} 7 ({v['vimeo_gt'][0]},{v['vimeo_gt'][1]},3)\n" for k in keys))
    for i in range(v["reds_frames"]):
        gh, gw = v["reds_gt"]
        put(os.path.join(root, "reds", "gt", "000", f"{i:08d}.png"), (gh, gw), 900 + i)
        put(os.path.join(root, "reds", "lq", "000", f"{i:08d}.png"), (gh // s, gw // s), 950 + i)
    for i in range(v["ffhq_images"]):
        put(os.path.join(root, "ffhq", f"{i:08d}.png"), v["ffhq"], 990 + i)
    r = os.path.join(root, "reds")
    return {
        "Vimeo90KDataset": dict(dataroot_gt=os.path.join(root, "vimeo", "gt"),
                                dataroot_lq=os.path.join(root, "vimeo", "lq"),
                                meta_info_file=os.path.join(root, "vimeo", "meta.txt"),
                                num_frame=7, random_reverse=True, scale=s, gt_size=v["gt_size"]),
        "REDSDataset": dict(dataroot_gt=os.path.join(r, "gt"), dataroot_lq=os.path.join(r, "lq"),
                            num_frame=5, interval_list=[1], random_reverse=False,
                            frames_per_clip=v["reds_frames"], scale=s, gt_size=v["gt_size"]),
        "FFHQDataset": dict(dataroot_gt=os.path.join(root, "ffhq"), use_hflip=True,
                            mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]),
        "VideoTestDataset": dict(dataroot_gt=os.path.join(r, "gt"),
                                 dataroot_lq=os.path.join(r, "lq"), num_frame=5,
                                 padding="reflection"),
    }


def phase15_video(row, card, work):
    """(d) the video and face sets through BatchLoader and the uploader onto
    the card, one epoch of batches of 4 with the sampler enlarged to
    ``VIDEO_EPOCH_ITEMS`` items: each batch equal to the CPU items, and
    items/s over the epoch after its first (warm) batch."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.data import loader as tld
    from rethink_acoustic_image_enhancement_tpu_torch.data.datasets import create_dataset

    t0 = time.perf_counter()
    opts = write_video_sets(os.path.join(work, "video"))
    write_s = time.perf_counter() - t0
    out = {}
    for name, opt in opts.items():
        ds = create_dataset(dict(opt, type=name, seed=5))
        uploader = tld.BatchUploader(torch.device("cuda"), ds.frame_stacks)
        bs = 4
        ratio = -(-VIDEO_EPOCH_ITEMS // len(ds))
        sampler = tld.EnlargedShuffleSampler(len(ds), ratio, shuffle=True, seed=5)
        loader = tld.BatchLoader(ds, bs, sampler, num_workers=4)
        got = []
        for host in loader:
            got.append(uploader(host))
            if len(got) == 1:  # the warm batch: threads, pinned buffers, copy stream
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        idx = sampler.epoch_indices(0)
        with ThreadPoolExecutor(8) as pool:
            items = list(pool.map(lambda i: ds[int(i)], idx[:bs * len(got)]))
        shapes = {}
        for b, dev in enumerate(got):
            for key, t in dev.items():
                if not isinstance(t, torch.Tensor):
                    continue  # paths and keys stay on the host
                want = np.stack([it[key] for it in items[b * bs:(b + 1) * bs]])
                host = t.cpu()
                if want.ndim == 4 and not ds.frame_stacks:
                    host = host.permute(0, 2, 3, 1)  # the uploader's NCHW back to NHWC
                host = host.numpy()
                assert host.dtype == want.dtype and np.array_equal(host, want), (name, key, b)
                shapes[key] = list(want.shape)
        timed = bs * (len(got) - 1)
        out[name] = dict(files=len(ds), batch=bs, batches=len(got), timed_items=timed,
                         timed_s=secs, items_per_s=timed / secs, shapes=shapes)
        log(f"(d) {name}: {out[name]['items_per_s']:.1f} items/s through the loader onto the "
            f"card ({timed} items after a warm batch, {secs:.2f} s), batch shapes {shapes}")
        del got, items
        torch.cuda.empty_cache()
    row["video"] = dict(write_s=write_s, sets=out)


def phase15_parts(row, card):
    """(e) flow_warp, the embeds and a stack of arch_utils' residual blocks
    on the card against the CPU at a Vimeo90K septuplet's size, float32,
    TF32 off."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.models import arch_utils, embeds
    from rethink_acoustic_image_enhancement_tpu_torch.ops.warp import flow_warp

    f, h, w = WARP_SHAPE
    rng = np.random.default_rng(16)
    frames = torch.from_numpy(rng.random((1, f, h, w), dtype=np.float32))
    x = torch.from_numpy(rng.random((f, 3, h, w), dtype=np.float32))
    flow = torch.from_numpy((rng.random((f, h, w, 2)) * 8 - 4).astype(np.float32))
    torch.manual_seed(16)
    embed = embeds.OverlapPatchTimePoseEmbed(in_frames=f, embed_dim=48, out_dim=48,
                                             base_size=(128, 128)).eval()
    spy = embeds.WDSpybottle(f, f).eval()
    res = arch_utils.make_layer(arch_utils.ResidualBlockNoBN, 2, num_feat=48)
    feats = torch.from_numpy(rng.random((f, 48, h, w), dtype=np.float32))
    cases = {"flow_warp": (lambda a, b: flow_warp(a, b), (x, flow)),
             "flow_warp_border": (lambda a, b: flow_warp(a, b, "border"), (x, flow)),
             "time_pose_embed": (embed, (frames,)),
             "wd_spybottle": (spy, (frames,)),
             "residual_blocks": (res, (feats,))}
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        with torch.no_grad():
            for name, (fn, args) in cases.items():
                ref = fn(*args)
                if isinstance(fn, torch.nn.Module):
                    fn.cuda()
                got = fn(*[a.cuda() for a in args])
                if isinstance(fn, torch.nn.Module):
                    fn.cpu()
                assert got.is_cuda and torch.isfinite(got).all().item(), name
                rel = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
                out[name] = dict(shape=list(ref.shape), rel_err=rel)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    row["parts"] = out
    log("(e) card vs CPU, max|d| / max|ref|: "
        + ", ".join(f"{k} {v['rel_err']:.2e}" for k, v in out.items()) + f" [{card}]")
    over = {k: v["rel_err"] for k, v in out.items() if v["rel_err"] > 1e-5}
    assert not over, f"card vs CPU beyond 1e-5: {over}"


def phase_remaining_datasets(results, card):
    """Phase 15: the remaining datasets and storage backends, the
    dual-pixel teacher and the parts no shipped model calls; returns the
    stage-kernel calls of (c)."""
    import torch

    t0 = time.perf_counter()
    row = dict(card=card)
    with tempfile.TemporaryDirectory(prefix="raie_datasets_") as work:
        train, val = phase15_lmdb(row, card, work)
        phase15_gaussian(row, card, work, train, val)
        torch.cuda.empty_cache()
        launches = phase15_dual_pixel(row, card, work)
        phase15_video(row, card, work)
    phase15_parts(row, card)
    row["stage_launches"] = launches
    row["phase_s"] = time.perf_counter() - t0
    results["remaining_datasets"] = row
    print(json.dumps({"remaining_datasets": row}), flush=True)
    log(f"phase 15: {row['phase_s']:.1f} s")
    return launches


# ------------------------------------------------------------ main -------

# ------------------------------------------------------------ phase 16 ---

# (a): the 512^2 request's gate-admitted stage shapes (decoder_level1 and the
# two refinements; encoder_level2 and decoder_level2), level 2 of a
# 528x512 request on 2 bands (132 rows a band, 4 mod 8: a band's last
# tile cut at its edge), and the latent of a 2048^2 frame (csrc/
# stage_sm90_wide.cu's kernels; 2 of its 8 blocks) on 1 and 2 bands
SPATIAL_CASES = [((1, 512, 512, 96), 4, 1, (1, 2, 4)), ((1, 256, 256, 96), 6, 2, (1, 2, 4)),
                 ((1, 264, 256, 96), 6, 2, (2,)), ((1, 256, 256, 384), 2, 8, (1, 2))]
SPATIAL_SIZE = 512  # (b), (c): the request's side
SPATIAL_FRAME = 2048  # (b): the frame size the axis exists for, on 2 bands
SPATIAL_DEVICE = "cuda:0"  # every band's device (the one card)


def phase16_band_kernel(row, card):
    """(a) the band stage against the whole-image kernel and its plain
    version, the bands on cuda:0; returns the rows."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import (
        LocalBands,
        join_rows,
        split_rows,
    )

    rows = []
    for (shape, n, heads, band_counts), dtype in (
            [(case, torch.bfloat16) for case in SPATIAL_CASES]
            + [((SPATIAL_CASES[0][0], 4, 1, (1, 2)), torch.float32)]):
        rng = np.random.default_rng(shape[1] + n)
        f = int(shape[-1] * 2.66)
        wts = seeded_stage_weights(rng, n, shape[-1], heads, f, SPATIAL_DEVICE)
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(SPATIAL_DEVICE, dtype)
        whole = pstage.fused_transformer_stage(x, **wts)
        whole_ms = cuda_ms(lambda: pstage.fused_transformer_stage(x, **wts), 5)
        flops, nbytes = stage_work(*shape, n, heads, f, x.element_size())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        for nb in band_counts:
            bands = LocalBands([SPATIAL_DEVICE] * nb)
            xs = split_rows(x, bands.devices, dim=1)

            def run():
                return pstage.fused_transformer_stage_bands(xs, [wts] * nb, bands)

            wide_before = pblock.ffn_wide.launches
            got = join_rows(run(), SPATIAL_DEVICE, dim=1)
            torch.cuda.synchronize()
            wide = pblock.ffn_wide.launches - wide_before
            # C = 384 bands take csrc/stage_sm90_wide.cu's kernels: one (F) a block and band
            assert wide == (n * nb if shape[-1] == 384 else 0), (shape, nb, wide)
            moved = dict(bands.moved)
            plain = join_rows(pstage.stage_plain_bands(xs, [wts] * nb, bands), SPATIAL_DEVICE,
                              dim=1)
            torch.cuda.synchronize()
            assert got.shape == x.shape and got.dtype == dtype
            assert torch.isfinite(got).all().item(), "non-finite band-kernel output"
            scale = whole.float().abs().max().item()
            d_whole = (got.float() - whole.float()).abs().max().item()
            d_plain = (got.float() - plain.float()).abs().max().item()
            r = dict(shape=list(shape), n_blocks=n, heads=heads, bands=nb,
                     band_rows=shape[1] // nb, dtype=str(dtype).replace("torch.", ""),
                     max_abs_err=d_plain, rel_err=d_plain / plain.float().abs().max().item(),
                     rel_to_whole=d_whole / scale, bit_identical_to_whole=torch.equal(got, whole),
                     ms=cuda_ms(run, 5), whole_ms=whole_ms,
                     plain_ms=cuda_ms(lambda: pstage.stage_plain_bands(xs, [wts] * nb, bands), 1),
                     bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     halo_bytes=moved["halo"], partial_bytes=moved["partials"],
                     wide_ffn_launches=wide)
            rows.append(r)
            log(f"band stage {r['dtype']} {tuple(shape)} blocks={n} heads={heads} on {nb} bands "
                f"of {r['band_rows']} rows: {r['ms']:.3f} ms (whole-image kernel "
                f"{whole_ms:.3f} ms), plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); rel to whole {r['rel_to_whole']:.3e}, to plain "
                f"{r['rel_err']:.3e}, bit-identical {r['bit_identical_to_whole']}; moved halo "
                f"{moved['halo']} B, partials {moved['partials']} B [{card}]")
            if nb == 1:
                assert r["bit_identical_to_whole"], "one band differs from the whole-image kernel"
            assert r["rel_to_whole"] <= TOL_REL and r["rel_err"] <= TOL_REL, r
            del got, plain
        del x, whole
    row["band_kernel"] = rows
    return rows


def spatial_request(pred, img, rate, reps):
    """(outputs, wall ms of each of reps requests, kernel calls a request),
    after one warm-up; the counts set to 0 just before the timed requests
    and read just after."""
    import torch

    pred(img, rate)
    torch.cuda.synchronize()
    walls = []
    counts = reset_counts()
    for _ in range(reps):
        t0 = time.perf_counter()
        out = pred(img, rate)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, walls, {k: v // reps for k, v in read_counts(counts).items()}


def band_outputs_ok(img, got, what):
    """uint8 'hq' and 'sr' of the image's shape, zero-mask pixels 0."""
    mask = np.all(img == 0, axis=-1)
    h, w = img.shape[:2]
    for key, s in (("hq", 1), ("sr", 2)):
        o = got[key]
        assert o.dtype == np.uint8 and o.shape == (h * s, w * s, 3), (what, key, o.shape)
        assert not o[np.repeat(np.repeat(mask, s, 0), s, 1)].any(), \
            f"{what} {key}: zero-mask pixels not 0"


def held_to_one_device(img, got, ref, what):
    """``band_outputs_ok`` and 'hq' and 'sr' within 1 level of one device on
    >= 99%; returns the agreement rows."""
    band_outputs_ok(img, got, what)
    agree = []
    for key in ("hq", "sr"):
        frac, worst = within_levels(got[key], ref[key])
        agree.append(dict(key=key, within_1_level=frac, max_levels=worst))
        assert frac >= 0.99, f"{what} {key}: only {frac:.4f} of pixels within 1 level"
    return agree


def held_to_fp32(img, got, one, fp32, what):
    """The trained bf16 teacher moves by whole levels where any bf16 rounding
    changes (78-87% of hq within 1 level of fp32). On one band every
    band rule gives one device's bits (checked in phase16_teacher); on more,
    every conv and resampler still does, and the first step that differs is
    the MDTA with its pixel sums added in another order, 5.6e-7 apart in
    fp32; one device moves as far (0.971 of hq within 1 level) when its own
    input is merely a contiguous copy (scripts/band_divergence.py, PERF.md).
    So a split is held as phase 9 holds the stage kernel: its share of
    pixels more than 1 level from one device's fp32 output at most 1.1x +
    0.002 of one device's bf16 share. Also records the agreement with one
    device's bf16 output."""
    band_outputs_ok(img, got, what)
    agree = []
    for key in ("hq", "sr"):
        frac, worst = within_levels(got[key], one[key])
        off = 1 - within_levels(got[key], fp32[key])[0]
        off_one = 1 - within_levels(one[key], fp32[key])[0]
        agree.append(dict(key=key, within_1_level_of_one_device=frac, max_levels=worst,
                          over_1_level_from_fp32=off, one_device_over_1_level_from_fp32=off_one))
        assert off <= 1.1 * off_one + 0.002, \
            f"{what} {key}: {off:.4f} of pixels over 1 level from fp32 (one device {off_one:.4f})"
    return agree


def phase16_teacher(row, card):
    """(b) the trained bf16 teacher (fused) on 2 and 4 bands of cuda:0 at
    512^2 and on 2 bands of a 2048^2 frame, held to one device's distance
    from fp32; the seeded flagship (phase 3's) on 2 bands at 512^2 within 1
    level of one device; (c) the trained fp32 teacher (fused=False) on 2
    bands at 512^2 within 1 level of one device. Returns the band-kernel
    calls of (b)'s timed requests."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import (
        flagship_teacher,
        init_weights_,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.models.bands import teacher_bands
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.mesh import make_mesh
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import LocalBands

    def on_bands(model, nb, **kw):
        return TeacherPredictor(model, **kw,
                                mesh=make_mesh(n_spatial=nb, devices=[SPATIAL_DEVICE] * nb))

    teacher = load_pth(flagship_teacher(static="train"), os.path.join(HERE, TEACHER_PTH))
    img, rate = sonar_frame(SPATIAL_SIZE, SPATIAL_SIZE, 30), 0.8
    frame = sonar_frame(SPATIAL_FRAME, SPATIAL_FRAME, 31)
    # one device in fp32: (c)'s reference and (b)'s yardstick
    one32 = TeacherPredictor(teacher, dtype=torch.float32)
    ref32, one32_ms, _ = spatial_request(one32, img, rate, 2)
    frame32 = one32(frame, rate)
    bf16 = copy.deepcopy(teacher).to(torch.bfloat16)  # teacher stays fp32 for (c)
    one = TeacherPredictor(bf16, fused=True, dtype=torch.bfloat16)
    ref, one_ms, one_calls = spatial_request(one, img, rate, 3)
    assert one_calls["stage"] == 5, one_calls
    # one band through the band path (a mesh of one spatial device serves as
    # one device): nothing split, every band rule exact, one device's bits
    model = one.model
    x = (torch.from_numpy(img).to(SPATIAL_DEVICE)[None].float() / 255.0).to(torch.bfloat16)
    x = x.permute(0, 3, 1, 2)  # the predictor's input: the NHWC upload seen as NCHW
    plane = torch.full((1, 1, *img.shape[:2]), rate, dtype=torch.bfloat16, device=SPATIAL_DEVICE)
    with torch.inference_mode():
        whole = model({"img": x, "denoise_rate": plane})
        counts = reset_counts()
        got1 = teacher_bands([model], [x], [plane], LocalBands([SPATIAL_DEVICE]))
        calls1 = read_counts(counts)
    assert calls1["stage_bands"] == 5 and calls1["stage"] == 0, calls1
    for key in ("hq", "sr"):
        assert torch.equal(got1[key][0], whole[key]), f"1 band: {key} is not one device's"
    row["teacher_bf16_one_band"] = dict(size=SPATIAL_SIZE, bit_identical_to_one_device=True)
    log(f"spatial teacher bf16 1 band at {SPATIAL_SIZE}^2 (teacher_bands): hq and sr "
        f"bit-identical to one device [{card}]")
    del whole, got1
    cases, band_calls = [], calls1["stage_bands"]
    for nb, size in ((2, SPATIAL_SIZE), (4, SPATIAL_SIZE), (2, SPATIAL_FRAME)):
        split = on_bands(bf16, nb, fused=True, dtype=torch.bfloat16)
        if size == SPATIAL_SIZE:
            x, x_ref, x_one_ms, x_calls, x_fp32 = img, ref, one_ms, one_calls, ref32
        else:
            x, x_fp32 = frame, frame32
            x_ref, x_one_ms, x_calls = spatial_request(one, frame, rate, 2)
        reps = 3 if size == SPATIAL_SIZE else 2
        split._bands.moved.update(halo=0, partials=0)
        out, walls, launches = spatial_request(split, x, rate, reps)
        moved = {k: v // (reps + 1) for k, v in split._bands.moved.items()}  # warm-up too
        # the band stage exactly where one device's gate admits the whole image
        assert launches["stage_bands"] == x_calls["stage"] > 0, (launches, x_calls)
        assert launches["stage"] == 0, launches
        band_calls += launches["stage_bands"] * reps
        what = f"{nb} bands at {size}^2"
        case = dict(bands=nb, size=size, requests=reps, ms=walls, one_device_ms=x_one_ms,
                    band_stage_calls_per_request=launches["stage_bands"],
                    halo_bytes_per_request=moved["halo"],
                    partial_bytes_per_request=moved["partials"],
                    agreement=held_to_fp32(x, out, x_ref, x_fp32, what))
        if size == SPATIAL_SIZE:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                split(x, rate)
                torch.cuda.synchronize()
            summed, busy = device_busy(prof)
            case.update(device_busy_ms=busy, device_summed_ms=summed,
                        idle_share=None if busy is None else 1 - busy / min(walls))
        cases.append(case)
        agree = {a["key"]: a for a in case["agreement"]}
        log(f"spatial teacher bf16 {what}: {min(walls):.2f} ms a request (one device "
            f"{min(x_one_ms):.2f}), {case['band_stage_calls_per_request']} band-stage calls, "
            f"moved halo {moved['halo']} B and partials {moved['partials']} B a request"
            + ("" if case.get("idle_share") is None else
               f", device busy {case['device_busy_ms']:.2f} ms (idle share "
               f"{case['idle_share']:.3f})")
            + "; hq within 1 level of one device: "
            f"{agree['hq']['within_1_level_of_one_device']:.4f}, over 1 level from fp32: "
            f"{agree['hq']['over_1_level_from_fp32']:.4f} (one device "
            f"{agree['hq']['one_device_over_1_level_from_fp32']:.4f}) [{card}]")
        del split
        torch.cuda.empty_cache()
    row["teacher_bf16"] = cases
    del one, bf16, frame32

    # the seeded flagship of phase 3 (conditioned like a trained network, no
    # amplification of bf16 roundings) on 2 bands, against one device
    seeded = init_weights_(flagship_teacher(static="train"),
                           torch.Generator().manual_seed(0)).to(torch.bfloat16)
    s_ref, s_one_ms, _ = spatial_request(
        TeacherPredictor(seeded, fused=True, dtype=torch.bfloat16), img, rate, 1)
    s_got, s_ms, s_calls = spatial_request(on_bands(seeded, 2, fused=True, dtype=torch.bfloat16),
                                           img, rate, 1)
    assert s_calls["stage_bands"] == 5, s_calls
    band_calls += s_calls["stage_bands"]
    row["seeded_bf16"] = dict(bands=2, size=SPATIAL_SIZE, ms=s_ms, one_device_ms=s_one_ms,
                              agreement=held_to_one_device(img, s_got, s_ref,
                                                           "seeded bf16 on 2 bands"))
    log(f"seeded teacher bf16 2 bands at {SPATIAL_SIZE}^2: {min(s_ms):.2f} ms (one device "
        f"{min(s_one_ms):.2f}); within 1 level of one device: "
        f"{min(a['within_1_level'] for a in row['seeded_bf16']['agreement']):.4f} [{card}]")
    del seeded

    # (c) the fp32 teacher, fused=False: every stage on the plain band path
    got, split_ms, launches = spatial_request(on_bands(teacher, 2, dtype=torch.float32),
                                              img, rate, 2)
    assert not any(launches.values()), f"the fp32 unfused teacher reached a kernel: {launches}"
    row["teacher_fp32"] = dict(bands=2, size=SPATIAL_SIZE, ms=split_ms, one_device_ms=one32_ms,
                               agreement=held_to_one_device(img, got, ref32, "fp32 on 2 bands"))
    log(f"spatial teacher fp32 unfused 2 bands at {SPATIAL_SIZE}^2: {min(split_ms):.2f} ms a "
        f"request (one device {min(one32_ms):.2f}); within 1 level of one device: "
        f"{min(a['within_1_level'] for a in row['teacher_fp32']['agreement']):.4f} [{card}]")
    return band_calls


def phase_spatial(results, card):
    """Phase 16: spatially sharded teacher serving (row bands on cuda:0);
    returns (the band-stage rows of (a), the band-stage calls of (b))."""
    import torch

    t0 = time.perf_counter()
    row = dict(card=card, devices="cuda:0 for every band (one card: the split's overhead, "
                                  "not scaling)")
    rows = phase16_band_kernel(row, card)
    torch.cuda.empty_cache()
    launches = phase16_teacher(row, card)
    row["band_stage_launches"] = launches
    row["phase_s"] = time.perf_counter() - t0
    results["spatial"] = row
    print(json.dumps({"spatial": row}), flush=True)
    log(f"phase 16: {row['phase_s']:.1f} s")
    return rows, launches


# ------------------------------------------------------------ phase 17 ---

SP_WORLD = 2  # ranks sharing the one card over gloo, one band each
SP_ITERS = [2] * 6  # (a): two steps in each curriculum stage of KDLAET.yml
SP_SIZE = 512  # (b): the batch-1 crop the spatial axis exists for
# (b)'s depth: the full-depth teacher's fp32 step at 512^2 held 38.36 GiB of
# activations on each of two bands when they ran out of an 80 GB H100's
# memory together (the 1024^2 SR head's blocks the most), so the width stays
# and the blocks are halved
SP_DEPTH = dict(num_blocks=[2, 3, 3, 4], num_refinement_blocks=2)
SP_STUDENT = (4, 7, 384)  # (c): KDLAES.yml's batch_size_per_gpu, num_pairs, gt_size
SP_DEVICE = "cuda"  # the one-process references' device


def sp_batch(kind, device):
    """(b)'s (1, 3, 512, 512) teacher batch or (c)'s (4, 7, 384, 384) student
    stacks, seeded, on ``device``."""
    import torch

    rng = np.random.default_rng(31 if kind == "teacher" else 32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if kind == "teacher":
        img = rng.random((1, 3, SP_SIZE, SP_SIZE), dtype=np.float32)
        hq = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
        return ({"img": t(img), "denoise_rate": t(np.full((1, 1, SP_SIZE, SP_SIZE), 0.7,
                                                           np.float32))},
                {"hq": t(hq), "sr": t(hq.repeat(2, 2).repeat(2, 3))})
    b, f, side = SP_STUDENT
    gt = rng.random((b, f, side, side), dtype=np.float32) * 0.9
    lq = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1).astype(np.float32)
    return t(lq), t(gt)


def sp_steps(opt, kind, device, steps=2, digest=False):
    """``steps`` seeded steps of the config's full-width network on
    ``sp_batch(kind)`` (mixup and the extra mask from host generators keyed
    by the step, the same on every rank): per step the metrics, the
    synchronised wall ms, the bytes the bands moved and (``digest``) the
    parameters' sha256; the parameters after the first step and its
    (clipped) gradients on the host."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch import parallel
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop

    _, trainer = tloop.build_everything(opt, device=device)
    state = trainer.init_state()
    state.step = max(int(opt["train"].get("warmup_iter", -1)), 0)  # past the warm-up
    lq, gt = sp_batch(kind, device)
    rows, first, grads = [], None, None
    split = trainer.bands or trainer.shards  # the exchange that counts its bytes
    for k in range(steps):
        before = dict(split.moved) if split is not None else None
        sums = getattr(split, "sums", None)
        torch.cuda.synchronize(device)
        parallel.barrier()
        t0 = time.perf_counter()
        state, m = trainer.step(state, lq, gt, np.random.default_rng([17, k]),
                                extra_prob=0.02)
        torch.cuda.synchronize(device)
        row = dict(ms=(time.perf_counter() - t0) * 1e3,
                   **{key: float(v) for key, v in m.items()})
        if before is not None:
            row.update({f"{key}_bytes": split.moved[key] - before[key]
                        for key in before})
        if sums is not None:
            row["sums"] = split.sums - sums
        if digest:
            row["digest"] = dp_digest(whole_leaves(trainer, state.model))
        rows.append(row)
        if k == 0:  # on model shards the gathered model (a collective)
            first, grads = first_step(trainer.whole_state(state).model)
    del state, trainer, lq, gt
    torch.cuda.empty_cache()
    return rows, first, grads


def whole_leaves(trainer, model):
    """``model``'s (name, parameter) pairs that every model shard holds
    whole: all of them without shards."""
    return [(n, p) for n, p in model.named_parameters() if not trainer.is_split(n)]


def first_step(model):
    """Copies of the (parameters, gradients) of ``model`` on the host (a
    copy also where ``model`` lies there already), zeros for a parameter
    without a gradient."""
    import torch

    return ({n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().to("cpu", copy=True)
             for n, p in model.named_parameters()})


def sp_loop_step(record, out=None):
    """``Trainer.step`` that also digests the parameters after every step
    into ``record["digests"]`` (on model shards the whole leaves) and keeps
    the first step's metrics, and its parameters (on model shards gathered)
    and gradients (saved to ``out`` where given, else kept)."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr

    step = ttr.Trainer.step

    def digested_step(self, state, *a, **kw):
        state, m = step(self, state, *a, **kw)
        record["digests"].append(dp_digest(whole_leaves(self, state.model)))
        if len(record["digests"]) == 1:
            record["first_metrics"] = {k: float(v) for k, v in m.items()}
            first = first_step(self.whole_state(state).model)
            if out is None:
                record["first"] = first
            else:
                torch.save(first, out)
        return state, m

    return step, digested_step


def sp_child(spec_path):
    """One rank of phase 17 (``chip_smoke.py --sp-rank SPEC``, started with
    torchrun's env): joins the gloo group on the card, then (a) trains the
    teacher through the loop on its band, every step's parameters digested,
    (b) and (c) the seeded steps on its band. Writes what it saw to
    ``<out>_rank{r}.json`` (rank 0 also its first steps' parameters)."""
    import torch

    sys.path.insert(0, HERE)
    from rethink_acoustic_image_enhancement_tpu_torch import parallel
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import resolve_device
    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr

    with open(spec_path) as fh:
        spec = json.load(fh)
    assert parallel.init_distributed(backend="gloo")
    rank = parallel.rank()
    device = resolve_device(None)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    fns = reset_counts()
    out = dict(rank=rank, world=parallel.world_size(), backend=parallel.backend_name())

    # (a) the teacher through the loop; each step's parameters digested,
    # rank 0's first step saved
    made, record = [], dict(digests=[])
    bands_of = tloop.spatial_bands

    def keep_bands(opt, model):
        made.append(bands_of(opt, model))
        return made[-1]

    step, digested_step = sp_loop_step(
        record, f"{spec['out']}_loop_first.pt" if rank == 0 else None)
    tloop.spatial_bands, ttr.Trainer.step = keep_bands, digested_step
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    opt = tcfg.parse(spec["teacher_yml"], is_train=True, root_path=spec["work"])
    state = tloop.train_from_config(opt, device=device)
    out["loop"] = dict(step=state.step, digests=record["digests"],
                       first_metrics=record["first_metrics"], moved=dict(made[0].moved),
                       train_s=time.perf_counter() - t0, n_spatial=made[0].n,
                       band=made[0].index,
                       peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    tloop.spatial_bands, ttr.Trainer.step = bands_of, step
    del state
    torch.cuda.empty_cache()

    # (b) batch 1 at 512^2; (c) the student at 4x7@384: two seeded steps each
    for kind, yml in (("teacher", spec["teacher512_yml"]), ("student", spec["student_yml"])):
        torch.cuda.reset_peak_memory_stats(device)
        rows, first, _ = sp_steps(tcfg.parse(yml, is_train=True, root_path=spec["work"]),
                                  kind, device, digest=True)
        out[kind] = dict(steps=rows,
                         peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
        if rank == 0:
            torch.save(first, f"{spec['out']}_{kind}_first.pt")
        del first
    out["launches"] = read_counts(fns)
    with open(spec["out"] + f"_rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    parallel.shutdown()
    return 0


def sp_ymls(work, roots, val_roots):
    """configs/KDLAET.yml and configs/KDLAES.yml at full width with
    ``train.spatial_shard: 2``: (a) the teacher's dataroots replaced and two
    steps a curriculum stage (12), a checkpoint and a validation at 12; (b)
    the same teacher at ``SP_DEPTH``; (c) the student as it stands (the
    steps of (b) and (c) are fed here, not read); (a) with
    ``spatial_shard: 1``, its one-process reference."""
    import yaml

    with open(os.path.join(HERE, "configs", "KDLAET.yml")) as fh:
        teacher = yaml.safe_load(fh)
    teacher["name"] = "sp_teacher"
    teacher["datasets"]["train"].update(roots, iters=SP_ITERS)
    teacher["datasets"]["val"].update(val_roots)
    teacher["val"]["val_freq"] = sum(SP_ITERS)
    teacher["train"].update(total_iter=sum(SP_ITERS), spatial_shard=SP_WORLD)
    teacher["logger"].update(save_checkpoint_freq=sum(SP_ITERS), print_freq=1,
                             use_tb_logger=False)
    cut = {**teacher, "name": "sp_teacher512",
           "network_g": {**teacher["network_g"], **SP_DEPTH}}
    with open(os.path.join(HERE, "configs", "KDLAES.yml")) as fh:
        student = yaml.safe_load(fh)
    student["name"] = "sp_student"
    student["train"]["spatial_shard"] = SP_WORLD
    one = {**teacher, "name": "sp_teacher_one", "train": {**teacher["train"], "spatial_shard": 1}}
    out = []
    for cfg in (teacher, cut, student, one):
        out.append(os.path.join(work, f"{cfg['name']}.yml"))
        with open(out[-1], "w") as fh:
            yaml.safe_dump(cfg, fh)
    return out


def sp_parity(first_rank, first_one, grads_one, m_rank, m_one):
    """One step held to one process's: the JAX spatial test's rule (loss
    1e-5 relative, grad norm 1e-4, every weight within 5e-3 relative and 3
    lr absolute), and phase 13's step rule: a weight whose one-process
    gradient is above 1e-6 of the largest within 0.05 lr. AdamW's first
    update moves a weight by about lr sign(g), so the JAX rule alone passes
    a gradient of the opposite sign; the step rule holds the backward.
    Returns the worst of each."""
    lr = m_one["lr"]
    rel = {k: abs(m_rank[k] - m_one[k]) / abs(m_one[k]) for k in ("l_pix", "grad_norm")}
    gmax = max(float(g.abs().max()) for g in grads_one.values())
    over = over_step = held = 0
    worst = worst_held = 0.0
    for n, want in first_one.items():
        diff = (first_rank[n] - want).abs()
        over += int((diff > 5e-3 * want.abs() + 3 * lr).sum())
        big = grads_one[n].abs() > 1e-6 * gmax
        over_step += int((diff[big] > 0.05 * lr).sum())
        held += int(big.sum())
        worst = max(worst, float(diff.max()))
        if big.any():
            worst_held = max(worst_held, float(diff[big].max()))
    assert rel["l_pix"] <= 1e-5 and rel["grad_norm"] <= 1e-4 and over == 0 \
        and over_step == 0 and m_rank["lr"] == lr, (rel, over, over_step)
    return dict(rel=rel, weights_over_rule=over, weights_over_step_rule=over_step,
                weights_under_step_rule=held, max_weight_diff=worst,
                max_weight_diff_under_step_rule=worst_held, lr=lr)


def phase_spatial_train(results, card, work):
    """Phase 17: spatially sharded training, two gloo ranks sharing the one
    card, one row band each (child processes of this script, torchrun's
    env): (a) the flagship teacher through the loop, (b) one teacher step at
    batch 1 on 512^2, (c) the student at 4x7@384; each against one process
    on the card ((a) through the same loop with ``spatial_shard: 1``). Every
    band on one card: the split's overhead, not scaling."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import flagship_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
    from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import ProgressiveSchedule

    t_phase = time.perf_counter()
    counts = reset_counts()
    row = dict(card=card, world=SP_WORLD,
               backend="gloo, two ranks on cuda:0, one band each (one card: the split's "
                       "overhead, not scaling)")
    roots = write_train_corpus(os.path.join(work, "triples"), 12, seed=210)
    val_roots = write_train_corpus(os.path.join(work, "val"), 2, seed=310)
    teacher_yml, teacher512_yml, student_yml, teacher_one_yml = sp_ymls(work, roots, val_roots)
    spec = dict(work=work, out=os.path.join(work, "sp"), teacher_yml=teacher_yml,
                teacher512_yml=teacher512_yml, student_yml=student_yml)
    spec_path = os.path.join(work, "sp_spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    torch.cuda.empty_cache()
    _, ranks_wall = dp_launch([sys.executable, os.path.abspath(__file__), "--sp-rank", spec_path],
                              work, SP_WORLD, "sp_rank")
    ranks = []
    for r in range(SP_WORLD):
        with open(f"{spec['out']}_rank{r}.json") as fh:
            ranks.append(json.load(fh))
    assert [(x["rank"], x["backend"]) for x in ranks] == [(r, "gloo") for r in range(SP_WORLD)]
    assert [(x["loop"]["n_spatial"], x["loop"]["band"]) for x in ranks] == [
        (SP_WORLD, r) for r in range(SP_WORLD)], [x["loop"] for x in ranks]
    assert not any(v for x in ranks for v in x["launches"].values()), [x["launches"] for x in ranks]
    # the ranks' parameters bit-equal after every step
    assert len({tuple(x["loop"]["digests"]) for x in ranks}) == 1
    for kind in ("teacher", "student"):
        assert len({tuple(s["digest"] for s in x[kind]["steps"]) for x in ranks}) == 1, kind
        assert ranks[0][kind]["steps"][0]["l_pix"] == ranks[1][kind]["steps"][0]["l_pix"]

    # (a) rank 0's record: every step logged and finite, the checkpoint, a
    # validation on whole images; the weights load strictly and serve 512^2
    exp, events, steps = train_events(work, "sp_teacher")
    total = sum(SP_ITERS)
    assert [e["iter"] for e in steps] == list(range(1, total + 1)), [e["iter"] for e in steps]
    assert len(ranks[0]["loop"]["digests"]) == total
    assert all(np.isfinite(e["l_pix"]) and np.isfinite(e["grad_norm"]) for e in steps), steps
    vals = [e for e in events if e["kind"] == "val"]
    assert [e["iter"] for e in vals] == [total] and np.isfinite(vals[0]["psnr"]), vals
    net = os.path.join(exp, "models", f"net_g_{total}.pth")
    model = load_pth(flagship_teacher(static="train"), net)  # strict
    frame = sonar_frame(SP_SIZE, SP_SIZE, 410)
    t0 = time.perf_counter()
    served = TeacherPredictor(model)(frame, 0.7)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    band_outputs_ok(frame, served, "phase 17 served checkpoint")
    del model

    # (a)'s one process: the same config with spatial_shard 1 through the
    # same loop in this process, its parameters digested every step as the
    # ranks' are; its first step held to rank 0's
    one = dict(digests=[])
    step, digested_step = sp_loop_step(one)
    ttr.Trainer.step = digested_step
    torch.cuda.reset_peak_memory_stats()
    try:
        state = tloop.train_from_config(tcfg.parse(teacher_one_yml, is_train=True,
                                                   root_path=work),
                                        device=torch.device(SP_DEVICE))
        del state
    finally:
        ttr.Trainer.step = step
    peak_one = torch.cuda.max_memory_allocated() / 2 ** 30
    _, _, one_steps = train_events(work, "sp_teacher_one")
    assert [e["iter"] for e in one_steps] == [e["iter"] for e in steps]
    first = torch.load(f"{spec['out']}_loop_first.pt")
    loop_parity = sp_parity(first[0], *one.pop("first"), ranks[0]["loop"]["first_metrics"],
                            one["first_metrics"])
    del first
    torch.cuda.empty_cache()
    opt = tcfg.parse(teacher_yml, is_train=True, root_path=work)
    prog = ProgressiveSchedule.from_dataset_opt(opt["datasets"]["train"])
    row["loop"] = dict(
        config="configs/KDLAET.yml full width (dim 48, [4,6,6,8], refinement 4, SR head), "
               "train.spatial_shard 2, iters [2]*6: 12 steps, a checkpoint and a validation "
               "at 12; 12 training triples of 256^2 from the host loader",
        steps=[dict(iter=e["iter"], stage=prog.stage(e["iter"]) + 1,
                    batch=prog.at(e["iter"])[0], patch=prog.at(e["iter"])[1],
                    ms=1e3 * e["iter_time"], one_process_ms=1e3 * o["iter_time"],
                    data_ms=1e3 * e["data_time"], l_pix=e["l_pix"],
                    one_process_l_pix=o["l_pix"]) for e, o in zip(steps, one_steps)],
        parity=loop_parity,
        halo_bytes_per_step=ranks[0]["loop"]["moved"]["halo"] / total,
        partial_bytes_per_step=ranks[0]["loop"]["moved"]["partials"] / total,
        peak_gib_per_rank=[x["loop"]["peak_gib"] for x in ranks],
        one_process_peak_gib=peak_one,
        train_s=ranks[0]["loop"]["train_s"], val_psnr=vals[0]["psnr"],
        serve_512_ms=serve_ms, ranks_bitwise_equal_every_step=True)

    # (b), (c): one process on the card, the same batches and draws
    for kind, yml, label in (("teacher", teacher512_yml,
                              f"batch 1 at 512^2, dim 48, blocks {SP_DEPTH['num_blocks']}, "
                              f"refinement {SP_DEPTH['num_refinement_blocks']}"),
                             ("student", student_yml, "4x7@384")):
        one_opt = tcfg.parse(yml, is_train=True, root_path=work)
        one_opt["train"]["spatial_shard"] = 1
        torch.cuda.reset_peak_memory_stats()
        one_rows, one_first, one_grads = sp_steps(one_opt, kind, torch.device(SP_DEVICE))
        peak_one = torch.cuda.max_memory_allocated() / 2 ** 30
        first = torch.load(f"{spec['out']}_{kind}_first.pt")
        rank_rows = ranks[0][kind]["steps"]
        parity = sp_parity(first, one_first, one_grads, rank_rows[0], one_rows[0])
        assert all(np.isfinite(s["l_pix"]) for s in rank_rows), rank_rows
        del first, one_first, one_grads
        torch.cuda.empty_cache()
        row[kind] = dict(
            shape=label, parity=parity,
            steps=[dict(ms=a["ms"], one_process_ms=b["ms"], l_pix=a["l_pix"],
                        one_process_l_pix=b["l_pix"], halo_bytes=a["halo_bytes"],
                        partial_bytes=a["partials_bytes"]) for a, b in zip(rank_rows, one_rows)],
            peak_gib_per_rank=[x[kind]["peak_gib"] for x in ranks],
            one_process_peak_gib=peak_one)
    launches = read_counts(counts)
    assert not any(launches.values()), launches  # training and the fp32 serve reach no kernel
    row["kernel_launches"] = dict(parent=launches, ranks=[x["launches"] for x in ranks])
    row["ranks_wall_s"] = ranks_wall
    row["phase_s"] = time.perf_counter() - t_phase
    results["spatial_train"] = row
    print(json.dumps({"spatial_train": row}), flush=True)
    lp = row["loop"]
    log("spatial training, 2 gloo ranks (one band each) on one card: loop " + ", ".join(
        f"{s['batch']}@{s['patch']} {s['ms']:.1f} ms (one process {s['one_process_ms']:.1f})"
        for s in lp["steps"])
        + f"; halo {lp['halo_bytes_per_step'] / 1e6:.2f} MB, partials "
        f"{lp['partial_bytes_per_step'] / 1e6:.2f} MB a step; parity {lp['parity']['rel']}; peak "
        f"{lp['peak_gib_per_rank']} GiB, one process {lp['one_process_peak_gib']:.2f} [{card}]")
    for kind in ("teacher", "student"):
        r = row[kind]
        log(f"spatial training, {kind} {r['shape']}: " + ", ".join(
            f"{s['ms']:.1f} ms (one process {s['one_process_ms']:.1f}), halo "
            f"{s['halo_bytes'] / 1e6:.2f} MB, partials {s['partial_bytes'] / 1e6:.2f} MB"
            for s in r["steps"]) + f"; parity {r['parity']['rel']}; peak per rank "
            f"{r['peak_gib_per_rank']} GiB, one process {r['one_process_peak_gib']:.2f} [{card}]")
    log(f"phase 17: {row['phase_s']:.1f} s")


# ------------------------------------------------------------ phase 18 ---

TENSOR_CASES = [((1, 512, 512, 96), 4, 1), ((1, 512, 512, 96), 4, 2),
                ((1, 256, 256, 384), 2, 8)]
TENSOR_SHARDS = (2, 4)  # (a), (b): model shards
TENSOR_SIZE = 512  # (a), (b): the request's side
TENSOR_FRAME = 2048  # (c): the 384-channel latent's stage admitted, 8 heads split
TENSOR_DEVICE = "cuda:0"  # every shard's device (the one card)


def split_report(h, w, n):
    """Which of the flagship's stages split their heads over n model shards
    at h x w and which hold the whole MDTA on every shard (and whether the
    gate sends each to the stage kernel), and the operations every shard
    repeats: all but the blocks' split parts (each layer outside the blocks,
    the LayerNorms aside, and a whole MDTA), counted from the convs' shapes
    and the MDTA's two products on the meta device."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.models import flagship_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import MDTA, Conv2d
    from rethink_acoustic_image_enhancement_tpu_torch.models.kdlae_teacher import (
        TransformerStage,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import heads_split

    m = flagship_teacher(static="train").to("meta")
    ops = {"other": 0}
    stages = {}

    def count(name, part):
        def hook(mod, inp, out):
            if isinstance(mod, MDTA):  # the Gram and attn @ v
                b, c, hh, ww = inp[0].shape
                n_ops = 4 * b * c * (c // mod.num_heads) * hh * ww
            else:
                n_ops = 2 * out.numel() * mod.in_channels // mod.groups * (
                    mod.kernel_size[0] * mod.kernel_size[1])
            key = (name, part) if part else "other"
            ops[key] = ops.get(key, 0) + n_ops
        return hook

    def shape_hook(name):
        def hook(mod, inp, out):
            b, c, hh, ww = inp[0].shape
            stages[name] = dict(channels=c, heads=mod.num_heads, pixels=[hh, ww],
                                kernel=stage_gate.stage_worthwhile(
                                    b, hh, ww, c, mod.num_heads, mod.bias_free_ln,
                                    mod.use_bias, mod.ffn_expansion_factor),
                                split=heads_split(mod.num_heads, n))
        return hook

    for name, mod in m.named_modules():
        top = name.split(".")[0]
        part = "mdta" if ".attn" in name else "gdfn" if ".ffn" in name else None
        if isinstance(mod, TransformerStage):
            mod.register_forward_hook(shape_hook(name))
        if isinstance(mod, (Conv2d, MDTA)):
            mod.register_forward_hook(count(top, part))
    with torch.no_grad():
        m({"img": torch.empty(1, 3, h, w, device="meta"),
           "denoise_rate": torch.empty(1, 1, h, w, device="meta")})
    total = sum(ops.values())
    whole_mdta = sum(v for k, v in ops.items()
                     if k != "other" and k[1] == "mdta" and not stages[k[0]]["split"])
    repeated = (n - 1) * (ops["other"] + whole_mdta)
    return dict(size=[h, w], shards=n, stages=stages, request_ops=total,
                outside_blocks_ops=ops["other"], whole_mdta_ops=whole_mdta,
                repeated_ops=repeated, repeated_share_of_one_device=repeated / total)


def phase18_shard_kernel(row, card):
    """(a) the shard stage on 2 and 4 model shards of cuda:0 against its
    plain version and the whole-image kernel, and the GDFN kernel on a
    hidden range against its plain version; returns (the stage rows, the
    GDFN part rows)."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.models.shards import shard_stage_weights
    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build, block
    from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.tensor import LocalShards

    row["ptxas"] = {k: v for k, v in _build.kernel_resources("stage").items()
                    if k in ("k_gram", "k_project")}
    # the Hopper forms a shard takes at C = 96, 192 and 384 with 48 channels a head
    wide_sass = sass_counts("stage_sm90_wide") or {}
    row["ptxas"].update({k: dict(v, sass=wide_sass.get(k))
                         for k, v in _build.kernel_resources("stage_sm90_wide").items()})
    rows = []
    for shape, n, heads in TENSOR_CASES:
        c = shape[-1]
        f = int(c * 2.66)
        rng = np.random.default_rng(c + heads)
        wts = seeded_stage_weights(rng, n, c, heads, f, TENSOR_DEVICE)
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(TENSOR_DEVICE,
                                                                             torch.bfloat16)
        whole = pstage.fused_transformer_stage(x, **wts)
        whole_ms = cuda_ms(lambda: pstage.fused_transformer_stage(x, **wts), 5)
        flops, nbytes = stage_work(*shape, n, heads, f, x.element_size())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        for ns in TENSOR_SHARDS:
            shards = LocalShards([TENSOR_DEVICE] * ns)
            sw = [shard_stage_weights(wts, ns, j) for j in range(ns)]
            xs = [x] * ns

            def run():
                return pstage.fused_transformer_stage_shards(xs, sw, shards)

            counts = reset_counts()
            hopper = hopper_counts()
            sm90 = pgdfn.gdfn_sm90.launches
            got = run()
            torch.cuda.synchronize()
            launches = read_counts(counts)
            kernels = {k: v - hopper[k] for k, v in hopper_counts().items() if v > hopper[k]}
            kernels["gdfn_sm90"] = pgdfn.gdfn_sm90.launches - sm90
            hs = heads // ns if heads % ns == 0 else heads
            route = block.apply_route(c, True, hs, sw[0]["w_proj"].shape[-2])
            moved, sums = shards.moved["partials"], shards.sums
            plain = pstage.stage_plain_shards(xs, sw, shards)
            torch.cuda.synchronize()
            for g in got:
                assert g.shape == x.shape and g.dtype == x.dtype
                assert torch.equal(g, got[0]), "shards differ"
            assert torch.isfinite(got[0]).all().item(), "non-finite shard-kernel output"
            d_plain = (got[0].float() - plain[0].float()).abs().max().item()
            r = dict(shape=list(shape), n_blocks=n, heads=heads, shards=ns,
                     heads_split=heads % ns == 0, dtype="bfloat16", max_abs_err=d_plain,
                     rel_err=d_plain / plain[0].float().abs().max().item(),
                     rel_to_whole=(got[0].float() - whole.float()).abs().max().item()
                     / whole.float().abs().max().item(),
                     ms=cuda_ms(run, 5), whole_ms=whole_ms,
                     plain_ms=cuda_ms(lambda: pstage.stage_plain_shards(xs, sw, shards), 1),
                     bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     sums=sums, partial_bytes=moved, launches=launches, route=route,
                     kernels=kernels,
                     # csrc/stage.cu's (A) and (C') layouts and resident blocks per SM
                     # on a shard (the other head widths' route)
                     plan=(block.plan_tiles(block.lib(), c, hs, sw[0]["w_proj"].shape[-2])
                           ._asdict() if route == "mma_sync" else None),
                     weight_bytes_per_shard=[sum(t.numel() * t.element_size()
                                                 for t in w.values()) for w in sw])
            rows.append(r)
            log(f"shard stage bf16 {tuple(shape)} blocks={n} heads={heads} on {ns} shards "
                f"({'heads split' if r['heads_split'] else 'MDTA whole on each'}; route "
                f"{route}, kernels {kernels}, plan {r['plan']}): "
                f"{r['ms']:.3f} ms (whole-image kernel {whole_ms:.3f} ms), plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); rel "
                f"to plain {r['rel_err']:.3e}, to whole {r['rel_to_whole']:.3e}; {sums} sums, "
                f"{moved} B of partials; launches {launches} [{card}]")
            assert launches["stage_shards"] == 1 and launches["gdfn_part"] == n * ns, launches
            assert kernels["gdfn_sm90"] == n * ns, kernels
            if route == "wgmma":  # the Hopper shard kernels, every block on every shard
                assert (kernels.get("k_gram_wide", 0) + kernels.get("k_gram_wgmma", 0)
                        == kernels.get("k_proj_wide", 0) == n * ns), kernels
            assert r["rel_err"] <= TOL_REL and r["rel_to_whole"] <= TOL_REL, r
            del got, plain
        del x, whole
    row["shard_kernel"] = rows

    # the GDFN kernel on shard 0's and shard 1's hidden range of 255 (128, 127)
    part_rows = []
    c, f = 96, 255
    rng = np.random.default_rng(18)
    wts = seeded_stage_weights(rng, 1, c, 1, f, TENSOR_DEVICE)
    r_in = torch.from_numpy(rng.normal(size=(1, TENSOR_SIZE, TENSOR_SIZE, c)).astype(
        np.float32)).to(TENSOR_DEVICE)
    for j in range(2):
        sw = shard_stage_weights(wts, 2, j)
        args = (sw["ln2_w"][0], sw["w_in"][0], sw["w_dw"][0], sw["w_out"][0])
        fs = sw["w_out"].shape[-2]
        flops, nbytes = gdfn_work(1, TENSOR_SIZE, TENSOR_SIZE, c, fs, 4)
        first, kernel = gdfn_kernel_of(
            lambda: pgdfn.fused_ln_gdfn_part(r_in, *args, residual=j == 0))
        assert torch.equal(first, pgdfn.fused_ln_gdfn_part(r_in, *args, residual=j == 0)), \
            "GDFN part: a second launch gave other bits"
        part_rows.append(held_to_plain(
            "gdfn_part", lambda: pgdfn.fused_ln_gdfn_part(r_in, *args, residual=j == 0),
            lambda: pgdfn.gdfn_part_plain(r_in, *args, residual=j == 0), r_in, flops, nbytes,
            PEAK_BF16_FLOPS, card, dict(hidden=fs, residual=j == 0, kernel=kernel,
                                        same_bits_twice=True)))
    row["gdfn_part_kernel"] = part_rows
    row["shard_kernels_alone"] = shard_kernels_alone(card)
    return rows, part_rows


def shard_kernels_alone(card):
    """The Hopper shard kernels alone at (1, 512, 512, 96) bf16, 2 heads of 48
    split over 2 shards (shard 0: Cq = 48): k_gram_wide on the shard's head
    (its Gram and norms summed over the groups, and v, against the plain
    version's), then k_proj_wide with and without x (r against ``attend``'s).
    Returns {kernel: [rows]}."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.models.shards import shard_stage_weights
    from rethink_acoustic_image_enhancement_tpu_torch.ops import block, gdfn
    from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

    shape, heads, ns, eps = (1, TENSOR_SIZE, TENSOR_SIZE, 96), 2, 2, 1e-5
    c, cq, px = shape[-1], shape[-1] // ns, shape[1] * shape[2]
    rng = np.random.default_rng(19)
    wts = seeded_stage_weights(rng, 1, c, heads, int(c * 2.66), TENSOR_DEVICE)
    sw = shard_stage_weights(wts, ns, 0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(TENSOR_DEVICE,
                                                                         torch.bfloat16)
    p = block.pack_blocks(x.device, **sw, shard=True)
    run = block.BlockRunner(x, heads // ns, p["fp"], cq=cq)
    assert run.route == "wgmma" and run.wide_gram, (run.route, run.wide_gram)
    bw = pstage._block_weights(0, c, **sw)
    x32 = x.float()
    qkv = gdfn.dw3x3(block.qkv_hidden(x32, bw.ln1, bw.ln1b, bw.wqkv, eps), bw.dwqkv)
    part = block.gram_part(qkv, heads // ns)
    r = torch.empty(shape, dtype=torch.float32, device=x.device)

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    def row(name, fn, errs, flops, nbytes, plain):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, by = device_ms(fn, 5)
        out = dict(kernel=name, shape=list(shape), cq=cq, rel_err=errs,
                   max_abs_err=max(errs.values()), ms=ms, ms_by=by, plain_ms=cuda_ms(plain, 2),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"shard kernel {name} {tuple(shape)} on a head range (Cq = {cq}): {ms:.4f} ms "
            f"({by}), plain {out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']}); rel {errs} [{card}]")
        assert max(errs.values()) <= TOL_REL, (name, errs)
        return out

    run.gram(x, p, 0, eps)
    torch.cuda.synchronize()
    got = run.part.sum(1)[0]
    ng = cq * 48
    errs = dict(gram=rel(got[:ng].reshape(-1, 48, 48), part[0, ..., :48]),
                q_norms=rel(got[ng:ng + cq], part[0, :, :, 48].reshape(-1)),
                k_norms=rel(got[ng + cq:], part[0, :, :, 49].reshape(-1)),
                v=rel(run.v, qkv[..., 2 * cq:]))
    rows = {"k_gram_wide": [row(
        "k_gram_wide", lambda: run.gram(x, p, 0, eps), errs,
        px * (2 * c * 3 * cq + 2 * 9 * 3 * cq + 2 * cq * 48),
        px * (c + cq) * 2,
        lambda: block.gram_part(gdfn.dw3x3(block.qkv_hidden(
            x32, bw.ln1, bw.ln1b, bw.wqkv, eps), bw.dwqkv), heads // ns))]}
    run.softmax(run.part, p, 0)
    rows["k_proj_wide"] = []
    for own in (True, False):
        run.project(x if own else None, r, p, 0)
        torch.cuda.synchronize()
        ref = block.attend(x32, qkv, part, bw.temp, bw.wproj, residual=own)
        rows["k_proj_wide"].append(dict(row(
            "k_proj_wide", lambda: run.project(x if own else None, r, p, 0), dict(r=rel(r, ref)),
            px * (2 * cq * 48 + 2 * cq * c), px * (cq * 2 + c * 4 + (c * 2 if own else 0)),
            lambda: block.attend(x32, qkv, part, bw.temp, bw.wproj, residual=own)),
            residual=own))
    return rows


def request_profile(pred, img, rate, top=8):
    """One request under torch.profiler: (summed device ms, busy ms, the top
    kernels by device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred(img, rate)
        torch.cuda.synchronize()
    summed, busy = device_busy(prof)
    kernels = sorted(((e.key[:60], e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    return summed, busy, kernels[:top]


def weight_bytes(models):
    return [sum(p.numel() * p.element_size() for p in m.parameters()) for m in models]


def shard_request(pred, img, rate, reps):
    """``spatial_request`` on a model-axis predictor, with its sums and
    partial bytes a request (the warm-up counted too)."""
    pred._shards.moved["partials"], pred._shards.sums = 0, 0
    out, walls, launches = spatial_request(pred, img, rate, reps)
    per = dict(sums=pred._shards.sums // (reps + 1),
               partial_bytes=pred._shards.moved["partials"] // (reps + 1))
    return out, walls, launches, per


def phase18_teacher(row, card):
    """(b) the trained bf16 teacher (fused) on 2 and 4 model shards of
    cuda:0 at 512^2, held to one device's distance from fp32, and the seeded
    flagship of phase 3 on 2 and 4 shards within 1 level of one device; (c)
    the seeded flagship on 2 shards of a 2048^2 frame within 1 level of one
    device. Returns the shard-stage and GDFN-part launches of the timed
    requests."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import (
        flagship_teacher,
        init_weights_,
    )
    from rethink_acoustic_image_enhancement_tpu_torch.parallel.mesh import make_mesh

    def on_shards(model, ns):
        return TeacherPredictor(model, fused=True, dtype=torch.bfloat16,
                                mesh=make_mesh(n_model=ns, devices=[TENSOR_DEVICE] * ns))

    teacher = load_pth(flagship_teacher(static="train"), os.path.join(HERE, TEACHER_PTH))
    img, rate = sonar_frame(TENSOR_SIZE, TENSOR_SIZE, 30), 0.8
    ref32, _, _ = spatial_request(TeacherPredictor(teacher, dtype=torch.float32), img, rate, 1)
    bf16 = teacher.to(torch.bfloat16)
    one = TeacherPredictor(bf16, fused=True, dtype=torch.bfloat16)
    ref, one_ms, one_calls = spatial_request(one, img, rate, 3)
    assert one_calls["stage"] == 5, one_calls
    summed, busy, top = request_profile(one, img, rate)
    row["one_device"] = dict(size=TENSOR_SIZE, ms=one_ms, device_busy_ms=busy,
                             device_summed_ms=summed, top_kernels_ms=top,
                             idle_share=None if busy is None else 1 - busy / min(one_ms))
    log(f"one device trained bf16 at {TENSOR_SIZE}^2: {min(one_ms):.2f} ms, device busy "
        f"{busy} ms; top kernels {top} [{card}]")
    from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn

    totals = {"stage_shards": 0, "gdfn_part": 0, "k_gram_wide": 0, "k_gram_wgmma": 0,
              "k_proj_wide": 0, "gdfn_sm90": 0}
    cases, seeded, s_refs = [], None, {}
    for what, ns, size in (("trained", 2, TENSOR_SIZE), ("trained", 4, TENSOR_SIZE),
                           ("seeded", 2, TENSOR_SIZE), ("seeded", 4, TENSOR_SIZE),
                           ("seeded", 2, TENSOR_FRAME)):
        x = img if size == TENSOR_SIZE else sonar_frame(size, size, 31)
        reps = 3 if size == TENSOR_SIZE else 1
        if what == "trained":
            model, (x_ref, x_one_ms, x_calls) = bf16, (ref, one_ms, one_calls)
        else:
            if seeded is None:  # phase 3's flagship
                seeded = init_weights_(flagship_teacher(static="train"),
                                       torch.Generator().manual_seed(0)).to(torch.bfloat16)
                s_one = TeacherPredictor(seeded, fused=True, dtype=torch.bfloat16)
            if size not in s_refs:
                s_refs[size] = spatial_request(s_one, x, rate, reps)
            model, (x_ref, x_one_ms, x_calls) = seeded, s_refs[size]
        pred = on_shards(model, ns)
        hopper, sm90 = hopper_counts(), pgdfn.gdfn_sm90.launches
        out, walls, launches, per = shard_request(pred, x, rate, reps)
        # the Hopper shard kernels a request (the warm-up request counted too)
        hopper = {k: (v - hopper[k]) // (reps + 1) for k, v in hopper_counts().items()
                  if k in ("k_gram_wide", "k_gram_wgmma", "k_proj_wide")}
        hopper["gdfn_sm90"] = (pgdfn.gdfn_sm90.launches - sm90) // (reps + 1)
        launches = dict(launches, **hopper)
        # the shard stage exactly where one device's gate admits the image
        assert launches["stage_shards"] == x_calls["stage"] > 0, (launches, x_calls)
        assert launches["stage"] == 0 and launches["gdfn_part"] > 0, launches
        # every admitted stage of the teacher has 48 channels a head at C = 96,
        # 192 and 384: its GDFN parts and (A) and (C') are the Hopper kernels
        assert launches["gdfn_sm90"] == launches["gdfn_part"], launches
        assert launches["k_proj_wide"] > 0, launches
        for k in totals:
            totals[k] += launches[k] * reps
        label = f"{what} bf16 on {ns} shards at {size}^2"
        case = dict(model=what, shards=ns, size=size, requests=reps, ms=walls,
                    one_device_ms=x_one_ms, per_request=dict(per, **launches),
                    weight_bytes_per_shard=weight_bytes(pred.models),
                    one_device_weight_bytes=weight_bytes([model])[0],
                    agreement=(held_to_fp32(x, out, x_ref, ref32, label) if what == "trained"
                               else held_to_one_device(x, out, x_ref, label)))
        if size == TENSOR_SIZE:
            summed, busy, top = request_profile(pred, x, rate)
            case.update(device_busy_ms=busy, device_summed_ms=summed, top_kernels_ms=top,
                        idle_share=None if busy is None else 1 - busy / min(walls))
        cases.append(case)
        log(f"tensor-parallel teacher {label}: {min(walls):.2f} ms a request (one device "
            f"{min(x_one_ms):.2f}), per request {case['per_request']}, weight bytes a shard "
            f"{case['weight_bytes_per_shard']} (one device {case['one_device_weight_bytes']})"
            + ("" if case.get("idle_share") is None else
               f", device busy {case['device_busy_ms']:.2f} ms (idle share "
               f"{case['idle_share']:.3f}); top kernels {case['top_kernels_ms']}")
            + f"; agreement {case['agreement']} [{card}]")
        del pred, out
        torch.cuda.empty_cache()
    row["teacher"] = cases
    return totals


def phase_tensor(results, card):
    """Phase 18: tensor-parallel teacher serving (model shards on cuda:0);
    returns ((a)'s stage rows, (a)'s GDFN part rows, (b)'s and (c)'s
    launches)."""
    import torch

    t0 = time.perf_counter()
    row = dict(card=card, devices="cuda:0 for every shard (one card: the split's overhead, "
                                  "not scaling)")
    row["splits"] = [split_report(s, s, n) for s in (TENSOR_SIZE, TENSOR_FRAME)
                     for n in TENSOR_SHARDS]
    for rep in row["splits"]:
        whole = [k for k, v in rep["stages"].items() if not v["split"]]
        log(f"model shards {rep['shards']} at {rep['size'][0]}^2: MDTA whole on every shard "
            f"in {whole}; repeated ops {rep['repeated_ops']:.4g} = "
            f"{rep['repeated_share_of_one_device']:.4f} of one device's "
            f"{rep['request_ops']:.4g}")
    rows, part_rows = phase18_shard_kernel(row, card)
    torch.cuda.empty_cache()
    launches = phase18_teacher(row, card)
    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t0
    results["tensor"] = row
    print(json.dumps({"tensor": row}), flush=True)
    log(f"phase 18: {row['phase_s']:.1f} s")
    return rows, part_rows, launches


# ------------------------------------------------------------ phase 19 ---

TP_WORLD = 2  # ranks sharing the one card over gloo, one model shard each
TP_ITERS = [2] * 6  # (a): two steps in each curriculum stage of KDLAET.yml
# (b)'s depth: phase 17's cut. A shard holds the whole residual stream and,
# at 512^2, the whole MDTA of every one-head stage (the largest activations:
# level 1 and the 1024^2 SR head); only its GDFN hidden channels and the
# split heads are halved. The full-depth fp32 step of one process holds
# about twice the 38.36 GiB of a 2-band rank, so two full-depth shards do not
# fit one 80 GB H100; the width stays and the blocks are halved
TP_DEPTH = SP_DEPTH
TP_DEVICE = "cuda"  # the one-process references' device


def tp_child(spec_path):
    """One rank of phase 19 (``chip_smoke.py --tp-rank SPEC``, started with
    torchrun's env): joins the gloo group on the card, then (a) trains the
    teacher through the loop on its model shard, the whole leaves digested
    after every step, (b) and (c) the seeded steps on its shard. Writes what
    it saw to ``<out>_rank{r}.json`` (rank 0 also the gathered parameters of
    its first steps)."""
    import torch

    sys.path.insert(0, HERE)
    from rethink_acoustic_image_enhancement_tpu_torch import parallel
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import resolve_device
    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr

    with open(spec_path) as fh:
        spec = json.load(fh)
    assert parallel.init_distributed(backend="gloo")
    rank = parallel.rank()
    device = resolve_device(None)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    fns = reset_counts()
    out = dict(rank=rank, world=parallel.world_size(), backend=parallel.backend_name())

    # (a) the teacher through the loop; each step's whole leaves digested,
    # rank 0's first step (gathered) saved
    made, built, record = [], [], dict(digests=[])
    shards_of, build = tloop.model_shards, tloop.build_everything

    def keep_shards(opt, model):
        made.append(shards_of(opt, model))
        return made[-1]

    def keep_built(opt, device=None):
        model, trainer = build(opt, device)
        built.append(dict(dwconv_shift=model.dwconv_shift, shards=type(trainer.shards).__name__,
                          split_leaves=sum(map(trainer.is_split, dict(model.named_parameters())))))
        return model, trainer

    step, digested_step = sp_loop_step(
        record, f"{spec['out']}_loop_first.pt" if rank == 0 else None)
    tloop.model_shards, tloop.build_everything, ttr.Trainer.step = (
        keep_shards, keep_built, digested_step)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    opt = tcfg.parse(spec["teacher_yml"], is_train=True, root_path=spec["work"])
    state = tloop.train_from_config(opt, device=device)
    out["loop"] = dict(step=state.step, digests=record["digests"],
                       first_metrics=record["first_metrics"], moved=dict(made[0].moved),
                       sums=made[0].sums, train_s=time.perf_counter() - t0,
                       n_model=made[0].n, shard=made[0].index, built=built[0],
                       shard_bytes=sum(p.numel() * p.element_size()
                                       for p in state.model.parameters()),
                       peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    tloop.model_shards, tloop.build_everything, ttr.Trainer.step = shards_of, build, step
    del state
    torch.cuda.empty_cache()

    # (b) batch 1 at 512^2; (c) the student at 4x7@384: two seeded steps each
    for kind, yml in (("teacher", spec["teacher512_yml"]), ("student", spec["student_yml"])):
        torch.cuda.reset_peak_memory_stats(device)
        rows, first, _ = sp_steps(tcfg.parse(yml, is_train=True, root_path=spec["work"]),
                                  kind, device, digest=True)
        out[kind] = dict(steps=rows,
                         peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
        if rank == 0:
            torch.save(first, f"{spec['out']}_{kind}_first.pt")
        del first
    out["launches"] = read_counts(fns)
    with open(spec["out"] + f"_rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    parallel.shutdown()
    return 0


def tp_ymls(work, roots, val_roots):
    """phase 17's configs (``sp_ymls``) with ``train.model_shard`` in place
    of ``spatial_shard``: (a) the teacher, (b) the teacher at ``TP_DEPTH``
    (phase 17's cut), (c) the student, and (a) with ``model_shard: 1``."""
    import yaml

    out = []
    for path in sp_ymls(work, roots, val_roots):
        with open(path) as fh:
            cfg = yaml.safe_load(fh)
        shard = cfg["train"].pop("spatial_shard")
        cfg["train"]["model_shard"] = shard
        cfg["name"] = cfg["name"].replace("sp_", "tp_")
        out.append(os.path.join(work, f"{cfg['name']}.yml"))
        with open(out[-1], "w") as fh:
            yaml.safe_dump(cfg, fh)
    return out


def phase_tensor_train(results, card, work):
    """Phase 19: tensor-parallel training (``train.model_shard: 2``), two
    gloo ranks sharing the one card, one model shard each (child processes
    of this script, torchrun's env): (a) the flagship teacher through the
    loop, (b) one teacher step at batch 1 on 512^2, (c) the student at
    4x7@384; each against one process on the card ((a) through the same loop
    with ``model_shard: 1``). Every shard on one card: the split's overhead,
    not scaling."""
    import torch

    from rethink_acoustic_image_enhancement_tpu_torch.convert.weights import load_pth
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
    from rethink_acoustic_image_enhancement_tpu_torch.models import flagship_teacher
    from rethink_acoustic_image_enhancement_tpu_torch.train import config as tcfg
    from rethink_acoustic_image_enhancement_tpu_torch.train import loop as tloop
    from rethink_acoustic_image_enhancement_tpu_torch.train import trainer as ttr
    from rethink_acoustic_image_enhancement_tpu_torch.train.progressive import ProgressiveSchedule

    t_phase = time.perf_counter()
    counts = reset_counts()
    row = dict(card=card, world=TP_WORLD,
               backend="gloo, two ranks on cuda:0, one model shard each (one card: the "
                       "split's overhead, not scaling)")
    roots = write_train_corpus(os.path.join(work, "triples"), 12, seed=220)
    val_roots = write_train_corpus(os.path.join(work, "val"), 2, seed=320)
    teacher_yml, teacher512_yml, student_yml, teacher_one_yml = tp_ymls(work, roots, val_roots)
    spec = dict(work=work, out=os.path.join(work, "tp"), teacher_yml=teacher_yml,
                teacher512_yml=teacher512_yml, student_yml=student_yml)
    spec_path = os.path.join(work, "tp_spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    torch.cuda.empty_cache()
    _, ranks_wall = dp_launch([sys.executable, os.path.abspath(__file__), "--tp-rank", spec_path],
                              work, TP_WORLD, "tp_rank")
    ranks = []
    for r in range(TP_WORLD):
        with open(f"{spec['out']}_rank{r}.json") as fh:
            ranks.append(json.load(fh))
    assert [(x["rank"], x["backend"]) for x in ranks] == [(r, "gloo") for r in range(TP_WORLD)]
    assert [(x["loop"]["n_model"], x["loop"]["shard"]) for x in ranks] == [
        (TP_WORLD, r) for r in range(TP_WORLD)], [x["loop"] for x in ranks]
    assert all(x["loop"]["built"]["dwconv_shift"] is True
               and x["loop"]["built"]["shards"] == "RankShards" for x in ranks), ranks
    assert not any(v for x in ranks for v in x["launches"].values()), [x["launches"] for x in ranks]
    # the ranks' whole leaves bit-equal after every step
    assert len({tuple(x["loop"]["digests"]) for x in ranks}) == 1
    for kind in ("teacher", "student"):
        assert len({tuple(s["digest"] for s in x[kind]["steps"]) for x in ranks}) == 1, kind
        assert ranks[0][kind]["steps"][0]["l_pix"] == ranks[1][kind]["steps"][0]["l_pix"]

    # (a) rank 0's record: every step logged and finite, the checkpoint, a
    # validation of the gathered model; the weights load strictly into the
    # whole-image teacher and serve 512^2
    exp, events, steps = train_events(work, "tp_teacher")
    total = sum(TP_ITERS)
    assert [e["iter"] for e in steps] == list(range(1, total + 1)), [e["iter"] for e in steps]
    assert len(ranks[0]["loop"]["digests"]) == total
    vals = [e for e in events if e["kind"] == "val"]
    assert [e["iter"] for e in vals] == [total] and np.isfinite(vals[0]["psnr"]), vals
    net = os.path.join(exp, "models", f"net_g_{total}.pth")
    model = load_pth(flagship_teacher(static="train"), net)  # strict
    whole_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    frame = sonar_frame(SP_SIZE, SP_SIZE, 420)
    t0 = time.perf_counter()
    served = TeacherPredictor(model)(frame, 0.7)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    band_outputs_ok(frame, served, "phase 19 served checkpoint")
    del model

    # (a)'s one process: the same config with model_shard 1 through the same
    # loop in this process, digested every step; its first step held to
    # rank 0's gathered one
    one = dict(digests=[])
    step, digested_step = sp_loop_step(one)
    ttr.Trainer.step = digested_step
    torch.cuda.reset_peak_memory_stats()
    try:
        state = tloop.train_from_config(tcfg.parse(teacher_one_yml, is_train=True,
                                                   root_path=work),
                                        device=torch.device(TP_DEVICE))
        del state
    finally:
        ttr.Trainer.step = step
    peak_one = torch.cuda.max_memory_allocated() / 2 ** 30
    _, _, one_steps = train_events(work, "tp_teacher_one")
    assert [e["iter"] for e in one_steps] == [e["iter"] for e in steps]
    first = torch.load(f"{spec['out']}_loop_first.pt")
    loop_parity = sp_parity(first[0], *one.pop("first"), ranks[0]["loop"]["first_metrics"],
                            one["first_metrics"])
    del first
    torch.cuda.empty_cache()
    opt = tcfg.parse(teacher_yml, is_train=True, root_path=work)
    prog = ProgressiveSchedule.from_dataset_opt(opt["datasets"]["train"])
    rank0 = ranks[0]["loop"]
    row["loop"] = dict(
        config="configs/KDLAET.yml full width (dim 48, [4,6,6,8], refinement 4, SR head), "
               "train.model_shard 2 (dwconv_shift), iters [2]*6: 12 steps, a checkpoint and "
               "a validation at 12; 12 training triples of 256^2 from the host loader",
        steps=[dict(iter=e["iter"], stage=prog.stage(e["iter"]) + 1,
                    batch=prog.at(e["iter"])[0], patch=prog.at(e["iter"])[1],
                    ms=1e3 * e["iter_time"], one_process_ms=1e3 * o["iter_time"],
                    data_ms=1e3 * e["data_time"], l_pix=e["l_pix"],
                    one_process_l_pix=o["l_pix"]) for e, o in zip(steps, one_steps)],
        parity=loop_parity, sums_per_step=rank0["sums"] / total,
        partial_bytes_per_step=rank0["moved"]["partials"] / total,
        shard_weight_bytes=[x["loop"]["shard_bytes"] for x in ranks],
        whole_weight_bytes=whole_bytes,
        peak_gib_per_rank=[x["loop"]["peak_gib"] for x in ranks],
        one_process_peak_gib=peak_one,
        train_s=rank0["train_s"], val_psnr=vals[0]["psnr"],
        serve_512_ms=serve_ms, ranks_whole_leaves_bitwise_equal_every_step=True)

    # (b), (c): one process on the card, the same batches and draws
    for kind, yml, label in (("teacher", teacher512_yml,
                              f"batch 1 at 512^2, dim 48, blocks {TP_DEPTH['num_blocks']}, "
                              f"refinement {TP_DEPTH['num_refinement_blocks']}"),
                             ("student", student_yml, "4x7@384")):
        one_opt = tcfg.parse(yml, is_train=True, root_path=work)
        one_opt["train"]["model_shard"] = 1
        torch.cuda.reset_peak_memory_stats()
        one_rows, one_first, one_grads = sp_steps(one_opt, kind, torch.device(TP_DEVICE))
        peak_one = torch.cuda.max_memory_allocated() / 2 ** 30
        first = torch.load(f"{spec['out']}_{kind}_first.pt")
        rank_rows = ranks[0][kind]["steps"]
        parity = sp_parity(first, one_first, one_grads, rank_rows[0], one_rows[0])
        assert all(np.isfinite(s["l_pix"]) for s in rank_rows), rank_rows
        del first, one_first, one_grads
        torch.cuda.empty_cache()
        row[kind] = dict(
            shape=label, parity=parity,
            steps=[dict(ms=a["ms"], one_process_ms=b["ms"], l_pix=a["l_pix"],
                        one_process_l_pix=b["l_pix"], sums=a["sums"],
                        partial_bytes=a["partials_bytes"]) for a, b in zip(rank_rows, one_rows)],
            peak_gib_per_rank=[x[kind]["peak_gib"] for x in ranks],
            one_process_peak_gib=peak_one)
    launches = read_counts(counts)
    assert not any(launches.values()), launches  # training and the fp32 serve reach no kernel
    row["kernel_launches"] = dict(parent=launches, ranks=[x["launches"] for x in ranks])
    row["ranks_wall_s"] = ranks_wall
    row["phase_s"] = time.perf_counter() - t_phase
    results["tensor_train"] = row
    print(json.dumps({"tensor_train": row}), flush=True)
    lp = row["loop"]
    log("tensor-parallel training, 2 gloo ranks (one model shard each) on one card: loop "
        + ", ".join(f"{s['batch']}@{s['patch']} {s['ms']:.1f} ms (one process "
                    f"{s['one_process_ms']:.1f})" for s in lp["steps"])
        + f"; {lp['sums_per_step']:.0f} sums, partials {lp['partial_bytes_per_step'] / 1e6:.2f} "
        f"MB a step; parity {lp['parity']['rel']}; peak {lp['peak_gib_per_rank']} GiB, one "
        f"process {lp['one_process_peak_gib']:.2f}; weights a shard {lp['shard_weight_bytes']} "
        f"B of {lp['whole_weight_bytes']} [{card}]")
    for kind in ("teacher", "student"):
        r = row[kind]
        log(f"tensor-parallel training, {kind} {r['shape']}: " + ", ".join(
            f"{s['ms']:.1f} ms (one process {s['one_process_ms']:.1f}), {s['sums']} sums, "
            f"partials {s['partial_bytes'] / 1e6:.2f} MB" for s in r["steps"])
            + f"; parity {r['parity']['rel']}; peak per rank {r['peak_gib_per_rank']} GiB, one "
            f"process {r['one_process_peak_gib']:.2f} [{card}]")
    log(f"phase 19: {row['phase_s']:.1f} s")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":  # a rank of phase 13
        return dp_child(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--sp-rank":  # a rank of phase 17
        return sp_child(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-rank":  # a rank of phase 19
        return tp_child(sys.argv[2])
    only = sys.argv[2] if sys.argv[1:2] == ["--phase"] and len(sys.argv) == 3 else None
    if sys.argv[1:] and only not in ("14", "15", "16", "17", "18", "19"):  # one phase alone
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PORT)):
        print(f"chip_smoke: {PORT}/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    tf32_defaults = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"card: {card}")

    t_start = t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {build_s:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    results = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s}
    if only:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
        if only in ("17", "19"):
            with tempfile.TemporaryDirectory(prefix=f"raie_{only}_") as work:
                (phase_spatial_train if only == "17" else phase_tensor_train)(results, card, work)
            return 0
        {"14": phase_dp_serving, "15": phase_remaining_datasets,
         "16": phase_spatial, "18": phase_tensor}[only](results, card)
        return 0
    stage_rows = phase_kernels(results, card)
    hopper_rows = phase_hopper_kernels(results, card)
    hopper_rows.update(phase_hopper_wide(results, card))
    ln_rows = phase_layernorm_kernel(results, card)
    gdfn_rows = phase_gdfn_kernel(results, card)
    block_rows = phase_block_kernel(results, card)
    # the Hopper tile kernels on the driven paths: phases 3 to 15
    hopper_counts(zero=True)
    whole_launches, lat_ms, pred = phase_slice(results, card)
    path_launches = phase_block_paths(results, card)
    tiled_launches = phase_tiled(results, card, pred)
    # the serving phases: PyTorch's TF32 defaults, the predictors pin their own
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    phase_student(results, card)
    phase_asdqe(results, card)
    group_launches = phase_group(results, card, pred)
    del pred
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="raie_zoo_cli_") as work:
        zoo_launches = phase_zoo_cli(results, card, work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="raie_train_") as work:
        phase_train(results, card, work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="raie_student_") as work:
        distill_launches = phase_student_and_scorer(results, card, work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="raie_device_") as work:
        phase_device_resident(results, card, work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="raie_dp_") as work:
        phase_data_parallel(results, card, work)
    torch.cuda.empty_cache()
    dp_launches = phase_dp_serving(results, card)
    torch.cuda.empty_cache()
    dual_pixel_launches = phase_remaining_datasets(results, card)
    hopper_launches = hopper_counts()
    torch.cuda.empty_cache()
    band_rows, band_launches = phase_spatial(results, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="raie_sp_") as work:
        phase_spatial_train(results, card, work)
    torch.cuda.empty_cache()
    shard_rows, part_rows, shard_launches = phase_tensor(results, card)
    alone_rows = results["tensor"]["shard_kernels_alone"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="raie_tp_") as work:
        phase_tensor_train(results, card, work)
    results["hopper_launches"] = hopper_launches
    results["path_launches"] = dict(whole_image=whole_launches, tiled=tiled_launches,
                                    group=group_launches, zoo_cli=zoo_launches,
                                    distill=distill_launches, dp_serving=dp_launches,
                                    dual_pixel=dual_pixel_launches, **path_launches)

    def entry(name, source, replaces, launches, rows, main_row):
        assert launches > 0, f"{name}: no launch on a driven path"
        return {"name": name, "route": "cuda", "source": f"{PORT}/csrc/{source}",
                "replaces": f"{PALLAS}/{replaces}", "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row.get("library_ms")}

    # each kernel's row at (1, 512, 512, 96) bf16: decoder_level1's shape
    # (4 blocks for the stage, WithBias for the LayerNorm, which has the
    # library call)
    kernels = {"kernels": [
        entry("fused_transformer_stage", "stage.cu", "stage.py:324",
              whole_launches + tiled_launches + group_launches + zoo_launches
              + distill_launches + dp_launches + dual_pixel_launches,
              stage_rows, stage_rows[0]),
        entry("fused_channel_layernorm", "layernorm.cu", "layernorm.py:58",
              path_launches["layernorm"], ln_rows, ln_rows[1]),
        # at C = 96, 192 and 384 the Hopper LN+GDFN kernel (csrc/gdfn.cu
        # keeps the other widths, held to its plain version in phase 2 at
        # C = 48 and on no driven path)
        entry("fused_ln_gdfn", "stage_sm90_wide.cu", "gdfn.py:277",
              path_launches["gdfn"], gdfn_rows, gdfn_rows[0]),
        entry("fused_transformer_block", "stage.cu", "block.py:338",
              path_launches["block"], block_rows, block_rows[0]),
        # the stage on row bands: (1, 512, 512, 96) bf16, 4 blocks, 2 bands
        entry("fused_transformer_stage_bands", "stage.cu", "stage.py:324",
              band_launches, band_rows, band_rows[1]),
        # the stage on model shards: (1, 512, 512, 96) bf16, 4 blocks, 2 heads
        # split over 2 shards; the GDFN kernel on shard 0's 128 of 255 hidden
        # channels, the residual added. At C = 96, 192 and 384 with 48
        # channels a head both take the Hopper kernels (csrc/stage.cu's
        # (A) and (C') keep the other head widths: phase 18 (a)'s one-head
        # case, on no request's path)
        entry("fused_transformer_stage_shards", "stage_sm90_wide.cu", "stage.py:324",
              shard_launches["stage_shards"], shard_rows, shard_rows[2]),
        entry("fused_ln_gdfn_part", "stage_sm90_wide.cu", "gdfn.py:277",
              shard_launches["gdfn_part"], part_rows, part_rows[0]),
        # the Hopper kernels (A) and (C) of every C = 96 block launch of the
        # stage and block paths (phases 3-15), each at (1, 512, 512, 96), one head
        entry("k_gram_wgmma", "stage_sm90.cu", "stage.py:324",
              hopper_launches["k_gram_wgmma"], hopper_rows["k_gram_wgmma"],
              hopper_rows["k_gram_wgmma"][0]),
        entry("k_apply_wgmma", "stage_sm90.cu", "stage.py:324",
              hopper_launches["k_apply_wgmma"], hopper_rows["k_apply_wgmma"],
              hopper_rows["k_apply_wgmma"][0]),
        # the Hopper kernels (A), (P) and (F) of every C = 192 and 384 block
        # launch of the stage and block paths (phases 3-15: the 1024^2 and
        # 2048^2 requests of phase 3), each at (1, 512, 512, 192), 4 heads
        *[entry(name, "stage_sm90_wide.cu", "stage.py:324", hopper_launches[name],
                hopper_rows[name], hopper_rows[name][0])
          for name in ("k_gram_wide", "k_proj_wide", "k_ffn_wide")],
        # the Hopper kernels (A) and (C') on a model shard's heads: their
        # launches on phase 18's requests, each alone at (1, 512, 512, 96), a
        # head of 48 channels (Cq = 48), (C') with x
        *[entry(f"{name}_shards", "stage_sm90_wide.cu", "stage.py:324", shard_launches[name],
                alone_rows[name], alone_rows[name][0])
          for name in ("k_gram_wide", "k_proj_wide")],
    ]}
    results["kernels"] = kernels["kernels"]
    results["total_s"] = time.perf_counter() - t_start
    log(f"all phases, build included: {results['total_s']:.1f} s")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)

    print(json.dumps(kernels))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
