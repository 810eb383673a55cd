#!/usr/bin/env python3
"""Drive the PyTorch port's click-to-video sampler, trainer and flow stack on
one card.

    python3 chip_smoke.py [--steps 4] [--seed 0]

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. the card's name and power limit (``nvidia-smi``), then the build of the
   hand-written kernels from ``followyourclick_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version at every shape the
   16-frame 512² CFG step gives it (the frame-axis attention kernels also at
   the halved rows of a cond-only step; flash attention at the 2-clip
   level-0 shape and at small ragged, cross-attention, wide-head and fp32
   shapes), in bf16 and in both GEGLU gate forms, with the error against a
   stated tolerance, both times, the least time the card could take
   (bound) and, where one PyTorch call computes the same function, that
   call's time; the bf16 motion block also launch by launch (LN + PE,
   q/k/v, attention, out-projection, feed-forward) and, at C < 1280, beside
   the modular kernels on the same block (two ``fused_temporal_block`` and
   one LN-GEGLU); the bf16 ``fused_temporal_block`` launch by launch (q/k/v,
   attention, out-projection) with the host's time to enqueue a call; the
   frame attention also at the motion block's stage (c) shapes; the motion
   block also at one frame (F = 1), in bf16 and fp32, at the positions and
   widths of the ``video_scale`` per-frame pass. The three
   kernels no path routes (as in the JAX package) run at the shapes their
   sites would give them: ``fused_geglu`` at the
   LN-GEGLU rows, ``fused_group_norm`` at each of the 81 GroupNorm sites of
   one exact evaluation (listed from the module tree by hooks on a UNet on
   the meta device; each site's line names its path, one cluster launch
   or two passes, and the times are summed per path with the host's
   enqueue time), ``fused_ln_cross_attention`` at the four attn2 shapes
   over 77 keys, launch by launch with the host's enqueue time and beside
   the stock composition of the attn2 path's own ops (a yardstick), plus a
   ragged row count and fp32;
3. tiny-config requests on the card (kernels, fp32) against the same
   requests through the port on the CPU (plain versions), at 64², where
   spatial self-attention of ≤ 32 tokens takes the tiny-sequence kernel:
   one on the exact sampler, one under ``pab244_deep4_cfg4_ex``, and with
   an IP-Adapter image prompt (a tiny CLIP vision tower): vanilla and Plus
   on the exact sampler, vanilla under ``pab244_deep4_cfg4_ex``; a
   camera-conditioned UNet with a merged motion LoRA; DPM-Solver++;
   Euler-A with the same injected step noise on both devices; and
   ``video_scale = 1.5``; then one tiny request per remaining UNet and
   motion-module option (``TINY_OPTIONS``: PseudoConv3d, temporal convs,
   the first-frame concat, ``center_input_sample``, linear projections,
   ``upcast_attention``, decoder-only motion modules, ``_Cross`` blocks,
   ``temporal_attention_dim_div = 2``, RoPE at 24 frames) and a tiny UNet
   evaluation with class embeddings and with the first-frame zero
   timestep, card vs CPU, zero and dirac inits perturbed;
4. two UNet evaluations at full width (the default ``InferenceConfig``,
   1.28 B UNet parameters, seeded random weights) in bf16 at 16 frames,
   512², on the CFG batch: one on the exact sampler's path (the
   whole-block motion kernel), one on the modular motion path
   (``PabMode(record_temporal=True)``, as a serving schedule's full step:
   ``fused_temporal_block`` and ``temporal_attention``), each through the
   kernels and again with every routed wrapper replaced by its plain
   version in the model modules, in bf16 and in fp32: the kernels' noise
   prediction must agree with the plain bf16 one within ``EVAL_NORM_MAX``
   (normalised max error) and ``EVAL_REL_L2`` (relative L2), lie no
   farther from the fp32 one than ``EVAL_FP32_RATIO`` times the plain
   bf16 one does, and launch what ``expected_launches`` gives;
5. two requests of one clip at full width on that pipeline at 16 frames,
   512², CFG 8, on the exact sampler (``--steps``);
6. two such requests under the serving schedule ``pab488_deep4_cfg4_ex``
   at 10 steps (one period of 8 and the 2 final exact steps);
7. batched serving: two requests of two clips each (different prompts,
   first frames, clicks, fps and motion scores per clip), on the exact
   sampler and under ``pab488_deep4_cfg4_ex``; level-0 spatial
   self-attention of the doubled CFG batch (16 GiB of bf16 scores) takes the
   flash-attention kernel;
8. sampler options, one one-clip request each on that pipeline: every
   solver but DDIM at ``SOLVER_STEPS``, DDIM at ``eta = 1``, no CFG, the
   unshared CFG prefix (held to the shared-prefix request with the same
   noise), ``video_scale = 1.5`` (the per-frame pass: 20 more motion-block
   calls a step at F = 1), the init image with residual noise and a
   partial mask; then the chunked decode (``frame_chunk = 4``) against the
   one-batch decode;
9. camera LoRA (BASELINE config 4), built after the earlier pipeline is
   freed: the default widths with the camera-motion embedding, one bf16
   evaluation (which builds the motion modules' ``[Wq; Wk; Wv]`` caches),
   a merged synthetic motion LoRA in the reference key format, the caches
   checked rebuilt, phase 4's check of the merged UNet, then two one-clip
   requests on the exact sampler that differ only in the camera type
   (``pan_left``, ``zoom_in``) and must give different videos;
10. IP-Adapter Plus (BASELINE config 3), built after the earlier pipeline
   is freed: the default widths with ``use_ip_cross_attention`` and 16 ip
   tokens, the CLIP ViT-H/14 tower (32 layers, 1280 wide) and the
   Resampler (depth 4, 12 heads, 16 queries); two one-clip requests with
   different images on the exact sampler (``--steps``), and the ip encode
   alone (tower and Resampler, condition and black image) by CUDA events;
11. the T5 second text tower, built after the earlier pipeline is freed:
   the default widths with the T5 cross-attention and a T5-v1.1-XXL
   encoder (4.76 B parameters, T5's own initial scales); the encode alone
   by CUDA events and on the device, and against fp32; phase 4's check of
   an evaluation with the T5 states; an exact request cold and warm; a
   ``pab488_deep4_cfg4_ex`` request, whose recording steps cache
   ``attn_t5_out`` beside ``attn2_out``; then a text request
   at full width (the pipeline given the tiny T5 ``tokenizer.json`` and a
   CLIP ``merges.txt``) and again from files (:func:`phase_t5_text`): a
   tiny SD directory and a tiny T5 directory with a ``tokenizer.json``
   through ``assemble_pipeline_from_pretrained``; in both a prompt's T5
   ids equal ``T5_TEXT_IDS`` and the request through ``__call__`` equals
   the same ids through ``sample``;
12. the routes: one full-width bf16 evaluation with cross-frame and
   in-block temporal attention and RoPE / LoRA motion modules, phase 4's
   check, its launches equal to ``ROUTES_LAUNCHES``;
13. the click-to-video CLI from checkpoint files (:func:`phase_cli`): a
   synthetic SD-1.5 directory at the default widths (seeded random fp16
   ``.safetensors`` in the reference's names, written through the inverse
   of the converters, ``merges.txt``) and a DDP-prefixed motion-module
   ``.ckpt``; the loader alone (a sample of its tensors against what was
   written); then ``cli.inference`` on a two-row manifest without images,
   one clip a request on the exact sampler and two clips a request under
   ``pab488_deep4_cfg4_ex`` (``--steps``): each row's first frame by the
   T2I pipeline (50 steps, CFG 8, on the video UNet's own tensors: its
   construction may allocate ``T2I_MAX_NEW_BYTES`` at most), launches
   equal to the video requests' ``expected_launches`` plus the T2I's
   (LN-GEGLU only), load / T2I / request seconds and peak memory; GIFs
   and ``config_snapshot.yaml`` (without PyYAML the phase drives
   ``cli.inference.run`` with the configs built in Python and says so;
   without PIL it writes no GIF, checks the videos the CLI hands to its
   writer (``captured_videos``) and says so).

15. the click front-end (:func:`phase_click`): SAM ``vit_h`` (1280 wide,
   32 deep, 1024², fp32) with seeded weights on a seeded 768x1024 image:
   ``set_image`` by CUDA events, one click → 3 masks and IoU, a
   ``predict_batch`` of 64 points, the automatic mask generator at its
   defaults and with both thresholds at 0, the ``torch.export`` decoder
   against the eager one, ``vit_t`` card vs CPU; no hand-written kernel
   launches. Then ``cli.click_mask`` on the image, and its ``mask_0.png``
   as the ``mask`` column of a one-row manifest of phase 13's CLI (exact,
   ``--steps``): click → video, launches equal to ``expected_launches``;
16. fill and replace (:func:`phase_fill`): ``cli.inpaint fill`` and
   ``replace`` on phase 13's SD-1.5 directory and the ``vit_h`` SAM, 512²
   crops, 25 steps, CFG 7.5, bf16: exactly 16 ``fused_ln_geglu`` a step and
   no other hand-written kernel; a tiny fp32 inpaint card vs CPU;
17. training (:func:`phase_train`), after the earlier pipeline is freed:
   the default ``UNet3DConfig()`` with ``remat_blocks``, the VAE and CLIP
   with seeded random weights (zero-initialised layers given small ones),
   the partitioned state (bf16 frozen leaves, fp32 masters of the 421 M
   trainable ones), a synthetic seeded clip of ``TRAIN_CLIP`` (16 frames,
   448x256, batch 1) encoded by ``encode_batch``; one step's loss and
   gradients through the kernels against the same step with every routed
   wrapper replaced by its plain version (``TRAIN_LOSS_REL``, each motion
   module's gradient cosine ``TRAIN_GRAD_COS``); then ``train_loop`` for
   ``TRAIN_STEPS`` steps saving at ``TRAIN_SAVE_AT`` (loss and
   ``grad_norm`` a step, step ms by CUDA events, peak memory, launches
   against ``TRAIN_LAUNCHES``), and a fresh state resumed from that
   checkpoint to the same step, which must equal the uninterrupted state
   bit for bit; every trainable leaf must have moved and every frozen one
   be bit-identical to its start;
18. LaMa removal (:func:`phase_remove`): seeded big-LaMa (51 M, fp32),
   its BN statistics calibrated on one seeded input, written as a
   Lightning-shaped ``best.ckpt``; ``cli.inpaint remove --lama_ckpt`` with
   the ``vit_h`` SAM on phase 15's image (3 masks and removals read back,
   each equal to the image outside its mask); one generator call at
   768x1024 and 512² by CUDA events, its operations counted, one under
   the profiler (FFT share, idle share); 512² card vs CPU
   (``LAMA_CARD_CPU_ATOL``); ``cli.app.ClickSession`` upload, click,
   remove; no hand-written kernel launches;
19. LaMa's GAN training (:func:`phase_lama_train`): big-LaMa,
   ``NLayerDiscriminator()`` and ResNet-PL on a seeded dilated ResNet-50,
   three alternations at batch 4 of 256² by CUDA events: every loss term
   finite, every parameter moved, the generator's BN statistics changed
   and the discriminator's bit-identical; no launches; one tiny
   alternation card vs CPU (``LAMA_TINY_REL``);
20. the motion score (:func:`phase_motion_score`): seeded RAFT at the
   widths of ``configs/flow/raft_flyingchairs.yaml`` (5.26 M, fp32), BN
   calibrated, ``flow.api.compute_motion_score`` on a seeded 16-frame 512²
   clip (15 pairs in one batch, 12 iterations) by CUDA events, peak memory,
   one call under the profiler (idle share, device time by kernel); card
   vs CPU on 2 pairs of 256² at 32 iterations (``FLOW_CARD_CPU_ATOL``, and
   against the CPU's fp64, ``FLOW_FP64_RATIO``); one GMA call card vs CPU;
   a synthetic mmflow-named ``.pth`` loaded strictly; no launches;
21. flow training through ``cli.flow_tools`` (:func:`phase_flow_train`) on
   synthetic FlyingChairs: ``train`` at the published 368x496 crop, batch
   2, 12 iterations, 3 steps (loss finite, warm ms a step, peak, every
   tensor moved), a second ``train`` resumed from the first run's
   checkpoint (the same loss, the update within ``FLOW_RESUME_REL``),
   ``test`` on a synthetic Sintel pair at 436x1024 (32 iterations),
   ``benchmark`` at 448x1024, ``flops``; no launches;
22. the other flow estimators (:func:`phase_flow_estimators`): each
   config of ``FLOW_ESTIMATOR_CONFIGS`` (PWC-Net, FlowNetS / C / CSS,
   FlowNet2, MaskFlowNetS, MaskFlowNet, IRR-PWC, both LiteFlowNets) with
   seeded weights at its published widths, fp32: every training-mode
   output (IRR-PWC's backward flows and occlusions, MaskFlowNetS's mask)
   and the ``inference=True`` flow on a seeded 256x384 pair, card vs CPU
   (``FLOW_EST_REL``) and against the CPU's fp64 (``FLOW_FP64_RATIO``);
   ``multi_level_epe_loss`` (and IRR-PWC's ``multi_level_bce``) card vs
   CPU; ``flow_tools benchmark`` at 448x1024 (pairs/s of the median warm
   call, peak memory) and ``flops`` (GFLOP a pair, parameters, the share
   of the fp32 peak); one ``CameraMotionAugmentation`` clip card vs CPU
   (``CAMERA_MAX_DIFF``, ``CAMERA_DIFF_SHARE``); no launches.

The numerics contract: the script leaves the process's precision flags at
PyTorch's defaults. The phases that call modules directly (2-12, the
training kernels, phase 17's step comparison, phase 18's generator calls
and the calibration passes) run under ``utils/backend_flags
.checked_precision``; the phases that go through the port's entry points
(the text request, 13, 15-21) do not, and after each the flags must be
the process's again; phase 22 calls the estimators directly and through
``flow_tools.main``, all under the contract.

Phase 2 is followed by the training kernels' checks
(:func:`phase_train_kernels`): the motion block and LN-GEGLU at the
training forward's shapes (``TRAIN_MOTION_SHAPES``, ``TRAIN_GEGLU_SHAPES``:
row and position counts that are no powers of two) against their plain
versions, and every autograd Function's backward (the unrouted
GroupNorm's and LN-cross-attention's included) against autograd through
the plain version.

Phase 1 also prints which optional packages import (``OPTIONAL_PACKAGES``).

Phase 2 also holds flash attention at the level-0 cross-frame shape of one
clip (``CROSS_FRAME_FLASH``, 8192 keys) and the frame attention at the
``temporal_attention_dim_div = 2`` widths.

Phases 5 to 22 are the main paths: each sets every kernel's launch count to
0 before each request (phases 13, 15 and 16: before each CLI run and
before the click phase; phase 17: before the training loop; phases 18-22:
at their start) and checks the
request's counts against those its :func:`expected_launches` gives at its
batch (from ``request_plan``: the solver's calls, CFG or not, the
per-frame pass) and, where given, against the counts worked out by hand
(the three unrouted kernels: 0), and prints time, video statistics per
clip and peak memory. The second-to-last line is the JSON kernel table,
the last line ``{"ok": true, "device": {...}}``. The script needs torch with CUDA, numpy
and the CUDA toolkit; it imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 kernel vs plain: max |kernel - plain| / max |plain| <= 1.6e-2, two
# bf16 ulps of the largest output (the plain version rounds each product to
# bf16 before its fp32 bias, and sums run in another order; flash attention
# rounds p at a running max, the plain version at the row's max), as
# tests/test_torch_cuda.py
BF16_REL = 1.6e-2
# fp32 kernel vs plain: only the order of the sums differs
FP32_REL = 1e-4
# tiny fp32 request, card vs CPU, on a video in [0, 1]: the two sides differ
# only in summation order (TF32 off) through 2-6 steps of ~60 layers and the
# VAE
TINY_VIDEO_ATOL = 2e-3
# one full-width bf16 UNet evaluation through the kernels against the same
# evaluation through their plain versions (phase 4), on the noise
# prediction: max |kernels - plain| / max |plain| and ||kernels - plain|| /
# ||plain||. Two bf16 evaluations that round in different places lie about
# 1.4e-2 apart in relative L2 at random weights, whichever wrapper differs
# (the phase prints what each wrapper alone moves), while each lies about
# 1.25e-2 from the same evaluation in fp32 (NVIDIA H100 80GB HBM3, 700.00
# W): so the relative L2 limit is 2e-2, and the sharper test is against
# fp32. There the kernels' relative L2 must be within EVAL_FP32_RATIO of the
# plain bf16 evaluation's: the kernels add no error beyond bf16's own
# rounding.
EVAL_NORM_MAX = 5e-2
EVAL_REL_L2 = 2e-2
EVAL_FP32_RATIO = 1.25
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16
# tensor-core operations per second and device-memory bytes per second
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
# fp32 operations per second outside the tensor cores (same data sheet)
PEAK_FP32_OPS = 67e12

# (rows, C) per LN-GEGLU call and its count per UNet evaluation, and
# (positions, F, C) per motion block and its count, at 16 f / 512² with CFG
GEGLU_SHAPES = [((131072, 320), 5), ((32768, 640), 5), ((8192, 1280), 5),
                ((2048, 1280), 1)]
# (rows, C) per LN-GEGLU call of the T2I first frame (1 frame at 512², CFG
# batch 2): compared with the plain version, not timed
T2I_GEGLU_SHAPES = [(8192, 320), (2048, 640), (512, 1280), (128, 1280)]
MOTION_SHAPES = [((8192, 16, 320), 5), ((2048, 16, 640), 5),
                 ((512, 16, 1280), 5), ((128, 16, 1280), 5)]
# the video_scale per-frame pass of one clip: the 16 frames folded into the
# batch, one frame per position, 20 motion-block calls a step (positions, C)
FRAME_PASS_MOTION_SHAPES = [((65536, 320), 5), ((16384, 640), 5),
                            ((4096, 1280), 5), ((1024, 1280), 5)]
# the modular path's frame-axis attention, per UNet evaluation that runs
# the temporal sites on the full CFG batch (10 calls per shape; 0 on the
# cond-only rows, which a schedule refreshing temporal attention on a
# cond-only step, e.g. pab222_cfg4, gives): (B, F, C) per
# fused_temporal_block, (B, F, heads, D) per temporal_attention
TEMPORAL_BLOCK_SHAPES = [((8192, 16, 320), 10), ((2048, 16, 640), 10),
                         ((4096, 16, 320), 0), ((1024, 16, 640), 0)]
TEMPORAL_ATTN_SHAPES = [((512, 16, 8, 160), 10), ((128, 16, 8, 160), 10),
                        ((256, 16, 8, 160), 0), ((64, 16, 8, 160), 0),
                        # stage (c) of the bf16 motion block and of
                        # fused_temporal_block at C = 320 and 640 (its time
                        # counts under those wrappers); also the in-block
                        # temporal attention and the RoPE / LoRA motion
                        # attention at levels 0 and 1
                        ((8192, 16, 8, 40), 0), ((2048, 16, 8, 80), 0),
                        # temporal_attention_dim_div = 2: D = C / 8 / 2 at
                        # C = 320, 640 and 1280
                        ((8192, 16, 8, 20), 0), ((2048, 16, 8, 40), 0),
                        ((512, 16, 8, 80), 0), ((128, 16, 8, 80), 0)]
# flash attention: (B, Sq, Sk, H, D), dtype and count per UNet evaluation.
# The path shape is level-0 spatial self-attention of a 2-clip CFG batch
# (2 clips x 2 x 16 frames, 64² tokens, 8 heads of 40), 4 calls in an exact
# evaluation; the others check a ragged key count, cross-attention over 77
# keys, the widest head and fp32
FLASH_SHAPES = [((64, 4096, 4096, 8, 40), torch.bfloat16, 4),
                ((2, 300, 300, 4, 64), torch.bfloat16, 0),
                ((2, 256, 77, 4, 40), torch.bfloat16, 0),
                ((1, 512, 512, 2, 160), torch.bfloat16, 0),
                ((2, 1024, 1024, 8, 40), torch.float32, 0)]
# cross-frame self-attention at level 0 of one clip: after the CFG
# duplication 32 rows of 4096 queries over [frame 0; the frame before] =
# 8192 keys, 16 GiB of bf16 scores, 4 calls an evaluation (the stem's, at 16
# rows and 8 GiB, stays plain); timed apart from the 2-clip path's sum
CROSS_FRAME_FLASH = (32, 4096, 8192, 8, 40)
KERNELS = {
    "fused_motion_block": ("followyourclick_tpu_torch/csrc/motion_block.cu",
                           "followyourclick_tpu/ops/motion_block.py:179"),
    "fused_ln_geglu": ("followyourclick_tpu_torch/csrc/geglu.cu",
                       "followyourclick_tpu/ops/geglu.py:224"),
    "fused_temporal_block": (
        "followyourclick_tpu_torch/csrc/temporal_attention.cu",
        "followyourclick_tpu/ops/temporal_attention.py:289"),
    "temporal_attention": (
        "followyourclick_tpu_torch/csrc/temporal_attention.cu",
        "followyourclick_tpu/ops/temporal_attention.py:161"),
    "flash_attention": ("followyourclick_tpu_torch/csrc/flash_attention.cu",
                        "followyourclick_tpu/ops/flash_attention.py:154"),
}
# the kernels no path routes, as in the JAX package: each is held against
# its plain version at the shapes its sites would give it
UNROUTED = {
    "fused_geglu": ("followyourclick_tpu_torch/csrc/geglu.cu",
                    "followyourclick_tpu/ops/geglu.py:295"),
    "fused_group_norm": ("followyourclick_tpu_torch/csrc/groupnorm.cu",
                         "followyourclick_tpu/ops/groupnorm.py:149"),
    "fused_ln_cross_attention": (
        "followyourclick_tpu_torch/csrc/cross_attention.cu",
        "followyourclick_tpu/ops/cross_attention.py:194"),
}
# the text cross-attention (attn2) of one exact evaluation at 16 f / 512²
# with CFG: (B, S, C) query rows per site and the sites per shape, 8 heads,
# 77 keys of 768 channels; then a ragged row count and fp32, untimed
CROSS_SHAPES = [((32, 4096, 320), torch.bfloat16, 5),
                ((32, 1024, 640), torch.bfloat16, 5),
                ((32, 256, 1280), torch.bfloat16, 5),
                ((32, 64, 1280), torch.bfloat16, 1),
                ((3, 333, 320), torch.bfloat16, 0),
                ((2, 1024, 320), torch.float32, 0)]
TEXT_KEYS, TEXT_DIM = 77, 768
# the tiny IP requests' CLIP vision tower (tests/test_pipeline_wiring.py
# TINY_VISION): 2 layers of 32, 32² images in 16² patches
TINY_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=4, image_size=32, patch_size=16,
                   projection_dim=1024)
IP_TOKENS = 16  # the Plus configuration's Resampler queries
# the synthetic camera-motion LoRA (BASELINE config 4): rank, and the scale
# of its up factor, which makes each merged delta about half as large as
# the weight it lands on, so a kernel reading unmerged weights would fail
# the evaluation bounds
CAMERA_LORA_RANK = 8
CAMERA_LORA_SCALE = 0.3
# camera types of the two config-4 requests: pan_left and zoom_in
CAMERA_TYPES = (0, 4)
# steps of each solver's request in the sampler-options phase
SOLVER_STEPS = 4
# a full-width bf16 video against the same request through another batch
# layout, on the [0, 1] video. The unshared CFG prefix rounds its stem at
# another batch and 4 steps of CFG 8 amplify that: it must lie within
# UNSHARED_SPREAD_RATIO times the relative L2 between the shared-prefix
# request through the kernels and through their plain versions (two bf16
# requests that round in different places, measured in the same run); a
# wrong CFG layout would move it by order 1. The chunked decode (no
# denoise) within EVAL_REL_L2, the phase-4 bound of two bf16 evaluations
# that round in different places.
UNSHARED_SPREAD_RATIO = 2.0
SERVING_SCHEDULE = "pab488_deep4_cfg4_ex"
SERVING_STEPS = 10
# launches per serving request, worked out by hand from the schedule: the
# temporal sites run on the 3 full non-reusing steps (3 × 20 of each frame
# kernel); LN-GEGLU 36 times on each of the 4 full steps and 10 times on
# each of the 6 level-0 steps; the temporal sites keep every block off the
# whole-block kernel; one clip never crosses the flash line
SERVING_LAUNCHES = {"fused_motion_block": 0, "fused_ln_geglu": 204,
                    "fused_temporal_block": 60, "temporal_attention": 60,
                    "flash_attention": 0}
# clips per batched request, and its flash launches worked out by hand:
# on the exact sampler 4 per step (of the five level-0 self-attentions, the
# first runs before the CFG duplication at 32 rows, 8 GiB of scores, and
# takes the plain route; the other four run at 64 rows, 16 GiB); under the
# serving schedule 20 (its 4 full steps feed the pre-duplicated 64 rows to
# all 5 sites, and positions 0 and 4 never reuse spatial attention; the 6
# cond-only steps run 32 rows). The other kernels launch as at one clip.
BATCH = 2
BATCHED_FLASH_PER_EXACT_STEP = 4
BATCHED_SERVING_LAUNCHES = {**SERVING_LAUNCHES, "flash_attention": 20}
# the routes phase: the default widths with cross-frame and in-block
# temporal attention and motion modules with RoPE and temporal LoRA, and its
# launches in one exact CFG evaluation of one clip, worked out by hand: every
# motion block on the modular path (20 FFs, 40 attentions on the
# tiny-sequence kernel), 16 in-block temporal attentions, 16 spatial FFs, and
# flash for the 4 level-0 cross-frame self-attentions after the CFG
# duplication (8192 keys, 16 GiB of scores; the stem's 8 GiB stays plain)
ROUTES_UNET = dict(unet_use_cross_frame_attention=True,
                   unet_use_temporal_attention=True)
ROUTES_MOTION = dict(use_rope_position_encoding=True, add_temporal_lora=True)
ROUTES_LAUNCHES = {"fused_motion_block": 0, "fused_ln_geglu": 36,
                   "fused_temporal_block": 0, "temporal_attention": 56,
                   "flash_attention": 4}
# the T5 encode in bf16 against the same encode in fp32 at full width,
# relative L2. At T5's own init scales it reads about 1.7e-2 on an H100; the
# control, the same encoder refilled N(0, 1/fan_in) (:func:`fan_in_init_`:
# one-hot unscaled attention whose choices bf16 flips), about 0.47, and the
# phase fails unless the check rejects it
T5_BF16_REL_L2 = 5e-2
# each RMSNorm's bf16 output against its formula in fp64 on the same input,
# relative L2, largest over the encoder's 49 norms. Computed in fp32 and
# rounded once, the norm differs only where fp32 and fp64 round apart; the
# control, the norm computed in bf16 (:func:`rmsnorm_in_input_dtype`), must
# fail. The encode's own relative L2 cannot tell the two apart: the control
# moves it by about a seventh
T5_NORM_REL_L2 = 5e-4
# the T5 phase's prompts: T5 token ids at the tokenizer's padded length,
# the cond prompt's first T5_PROMPT_TOKENS real, the uncond prompt's first
T5_TOKENS, T5_PROMPT_TOKENS = 77, 20


def routes_unet(unet_config):
    """``unet_config`` with the routes phase's options."""
    return dataclasses.replace(
        unet_config, **ROUTES_UNET, motion_module=dataclasses.replace(
            unet_config.motion_module, **ROUTES_MOTION))


# the card's name and power limit (nvidia-smi), set by phase_build
CARD = "card not queried"


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=5):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, reps=20):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph and replayed (median of 5 replays), so the host's time to
    enqueue each call drops out."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def host_ms(fn, calls=10):
    """Host milliseconds per call of ``fn`` to enqueue its work (the card
    still busy with earlier calls: no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return dt


def randn(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        dtype)


# packages the card's machine need not have; the CLI path needs none of
# safetensors, transformers, cv2 and imageio, and PyYAML and PIL only for
# the files it reads and writes
OPTIONAL_PACKAGES = ("yaml", "safetensors", "imageio", "PIL", "cv2",
                     "pandas", "transformers")


def phase_build():
    from followyourclick_tpu_torch.ops import _build

    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
    import importlib.util

    log("[build] optional packages: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
        for m in OPTIONAL_PACKAGES))
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    report = path.with_suffix(".log").read_text().splitlines()
    for line in report:
        if "registers" in line or "spill" in line:
            log("[build]", line.strip())


def compare(name, got, ref, failures, tol=BF16_REL):
    """Log the error of ``got`` against ``ref``; note a failure."""
    diff = (got.float() - ref.float()).abs()
    max_abs, scale = float(diff.max()), float(ref.float().abs().max())
    ok = max_abs <= tol * scale
    log(f"  {name}: max_abs_err {max_abs:.3e}, max |plain| {scale:.3e}, "
        f"normalised {max_abs / scale:.3e} (tol {tol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return max_abs


def bound_times(ops, tensors, peak_ops=PEAK_BF16_OPS):
    """(ms by operations, ms by bytes) of the least time the card could take:
    ``ops`` operations over ``peak_ops`` (bf16 tensor cores unless given),
    and each of ``tensors`` (inputs and the output) moved once over the
    memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3


def sfu_ms(exps):
    """Milliseconds the card's special-function units take for ``exps``
    exponentials: 16 per SM per clock, at the maximum SM clock that
    ``nvidia-smi`` reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (16 * sms * mhz * 1e6) * 1e3


def geglu_stages_ms(args, fast):
    """Milliseconds of each of the three device launches of one bf16
    LN-GEGLU call -- (a) the LN pass, (b) the up-projection with the gate,
    (c) the down-projection with the residual -- and of its two products
    alone, each one ``torch.matmul`` on the stage inputs the kernels see:
    an informative yardstick, used nowhere in the port."""
    from followyourclick_tpu_torch.ops.geglu import (
        down_bf16,
        ln_rows_bf16,
        up_bf16,
    )

    x, ls, lb, w1, b1, w2, b2 = args
    rows, c = x.shape
    inner = w2.shape[1]
    xn, out = torch.empty_like(x), torch.empty_like(x)
    y = torch.empty(rows, inner, dtype=x.dtype, device=x.device)
    stages = {
        "(a)": lambda: ln_rows_bf16(x, ls, lb, xn, 1e-5),
        "(b)": lambda: up_bf16(xn, w1, b1, y, fast),
        "(c)": lambda: down_bf16(y, w2, b2, x, out),
    }
    times = {name: time_ms(run) for name, run in stages.items()}
    w1t, w2t = w1.t(), w2.t()
    times["matmul (b)"] = time_ms(lambda: torch.matmul(xn, w1t))
    times["matmul (c)"] = time_ms(lambda: torch.matmul(y, w2t))
    return times


def motion_stages_ms(x, pe, params, qkv, scale, heads, fast):
    """Milliseconds of each device launch of one bf16 motion-block call, one
    by one: per attention sublayer (a) LN + PE, (b) the q/k/v product, (c)
    the frame attention, (d) the out-projection with the residual (each run
    twice a call), then the feed-forward's three launches together."""
    from followyourclick_tpu_torch.ops.geglu import (
        down_bf16,
        ln_rows_bf16,
        up_bf16,
    )
    from followyourclick_tpu_torch.ops.motion_block import (
        attention_bf16,
        qkv_bf16,
    )

    p, f, c = x.shape
    rows = p * f
    h = x.view(rows, c)
    t, o, h1, out = (torch.empty_like(h) for _ in range(4))
    y = torch.empty(rows, 4 * c, dtype=x.dtype, device=x.device)
    q, k, v = y.view(-1)[:3 * rows * c].view(3, rows, c)
    ls, lb, _, _, _, wo, bo = params[:7]
    lfs, lfb, w1, b1, w2, b2 = params[14:20]

    def ff():
        ln_rows_bf16(h1, lfs, lfb, t, 1e-5)
        up_bf16(t, w1, b1, y, fast)
        down_bf16(y, w2, b2, h1, out)

    # in launch order: each stage reads what the one before it wrote, and
    # the FF's gated rows overwrite q, k, v last
    stages = {
        "(a) LN + PE": lambda: ln_rows_bf16(h, ls, lb, t, 1e-5, pe),
        "(b) q/k/v": lambda: qkv_bf16(t, qkv[0], q, k, v),
        "(c) attention": lambda: attention_bf16(q, k, v, o, f, heads, scale),
        "(d) out + residual": lambda: down_bf16(o, wo, bo, h, h1),
        "FF": ff,
    }
    return {name: time_ms(run) for name, run in stages.items()}


def temporal_block_stages_ms(x, qkv, wo, bo, scale, heads):
    """Milliseconds of each device launch of one bf16
    ``fused_temporal_block`` call, one by one: (b) the q/k/v product, (c)
    the frame attention, (d) the out-projection with the bias."""
    from followyourclick_tpu_torch.ops.geglu import down_bf16
    from followyourclick_tpu_torch.ops.motion_block import (
        attention_bf16,
        qkv_bf16,
    )

    b, f, c = x.shape
    rows = b * f
    q, k, v = torch.empty(3, rows, c, dtype=x.dtype, device=x.device)
    o, out = (torch.empty(rows, c, dtype=x.dtype, device=x.device)
              for _ in range(2))
    stages = {
        "(b) q/k/v": lambda: qkv_bf16(x.view(rows, c), qkv, q, k, v),
        "(c) attention": lambda: attention_bf16(q, k, v, o, f, heads, scale),
        "(d) out": lambda: down_bf16(o, wo, bo, None, out),
    }
    return {name: time_ms(run) for name, run in stages.items()}


def cross_stages_ms(x, ctx, params, heads):
    """Milliseconds of each device launch of one bf16
    ``fused_ln_cross_attention`` call, one by one -- (a) the LN pass, (b) the
    q product, (c) the short-kv attention, (d) the out-projection with the
    bias -- and of the stock composition of the routed attn2 path's own ops
    (``F.layer_norm``, the q/k/v ``F.linear``, ``F.scaled_dot_product_
    attention``, the out ``F.linear``): four kinds of call, so a yardstick
    and not ``library_ms``, used nowhere in the port."""
    import torch.nn.functional as F

    from followyourclick_tpu_torch.ops import cross_attention as ca
    from followyourclick_tpu_torch.ops.geglu import down_bf16, ln_rows_bf16

    ls, lb, wq, wk, wv, wo, bo = params
    b, s, c = x.shape
    rows, d = b * s, c // heads
    scale = d ** -0.5
    k, v = ca.project_kv(ctx, wk, wv)
    xn, q, o, out = (torch.empty_like(x) for _ in range(4))

    def stock():
        t = F.layer_norm(x, (c,), ls, lb, 1e-5)
        qh, kh, vh = (F.linear(u, w).view(b, -1, heads, d).transpose(1, 2)
                      for u, w in ((t, wq), (ctx, wk), (ctx, wv)))
        a = F.scaled_dot_product_attention(qh, kh, vh)
        return F.linear(a.transpose(1, 2).reshape(b, s, c), wo, bo)

    stages = {
        "(a) LN": lambda: ln_rows_bf16(x.view(rows, c), ls, lb,
                                       xn.view(rows, c), 1e-5),
        "(b) q": lambda: ca.linear_bf16(xn.view(rows, c), wq,
                                        q.view(rows, c)),
        "(c) attention": lambda: ca.attention_bf16(q, k, v, o, heads, scale),
        "(d) out": lambda: down_bf16(o.view(rows, c), wo, bo, None,
                                     out.view(rows, c)),
        "stock": stock,
    }
    return {name: time_ms(run) for name, run in stages.items()}


def kernel_wrappers():
    """The wrappers of every routed kernel, by name; each counts its
    launches."""
    from followyourclick_tpu_torch.ops.flash_attention import flash_attention
    from followyourclick_tpu_torch.ops.geglu import fused_ln_geglu
    from followyourclick_tpu_torch.ops.motion_block import fused_motion_block
    from followyourclick_tpu_torch.ops.temporal_attention import (
        fused_temporal_block,
        temporal_attention,
    )

    fns = (fused_motion_block, fused_ln_geglu, fused_temporal_block,
           temporal_attention, flash_attention)
    return {fn.__name__: fn for fn in fns}


def unrouted_wrappers():
    """The wrappers of the kernels no path routes, by name."""
    from followyourclick_tpu_torch.ops.cross_attention import (
        fused_ln_cross_attention,
    )
    from followyourclick_tpu_torch.ops.geglu import fused_geglu
    from followyourclick_tpu_torch.ops.groupnorm import fused_group_norm

    fns = (fused_geglu, fused_group_norm, fused_ln_cross_attention)
    return {fn.__name__: fn for fn in fns}


def plain_versions():
    """Each routed wrapper's plain PyTorch version, called as the wrapper
    is called."""
    from followyourclick_tpu_torch.ops.flash_attention import (
        flash_attention_ref,
    )
    from followyourclick_tpu_torch.ops.geglu import (
        default_fast_gating,
        ln_geglu_ref,
    )
    from followyourclick_tpu_torch.ops.motion_block import motion_block_ref
    from followyourclick_tpu_torch.ops.temporal_attention import (
        temporal_attention_ref,
        temporal_block_ref,
    )

    def motion_block(x, pe, params, scale, heads, eps=1e-5,
                     fast_gating=None, qkv=None):
        if fast_gating is None:
            fast_gating = default_fast_gating(x)
        return motion_block_ref(x, pe, tuple(params), scale, heads, eps,
                                fast_gating)

    def ln_geglu(x, *params, eps=1e-5, residual=True, fast_gating=None):
        if fast_gating is None:
            fast_gating = default_fast_gating(x)
        return ln_geglu_ref(x, *params, eps=eps, residual=residual,
                            fast_gating=fast_gating)

    def temporal_block(x, *weights, scale=None, heads=8, qkv=None):
        return temporal_block_ref(x, *weights, scale=scale, heads=heads)

    return {"fused_motion_block": motion_block, "fused_ln_geglu": ln_geglu,
            "fused_temporal_block": temporal_block,
            "temporal_attention": temporal_attention_ref,
            "flash_attention": flash_attention_ref}


@contextlib.contextmanager
def wrappers_replaced(make):
    """Within the block, every name in the port's modules that refers to a
    routed wrapper refers to ``make(name, wrapper)`` instead; the wrappers'
    own modules keep theirs, and so their launch counts."""
    # the UNet's modules hold every call site
    from followyourclick_tpu_torch.models import unet3d  # noqa: F401

    wrappers = kernel_wrappers()
    undo = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith(
                "followyourclick_tpu_torch."):
            continue
        for attr, value in list(vars(mod).items()):
            for name, fn in wrappers.items():
                if value is fn and mod.__name__ != fn.__module__:
                    undo.append((mod, attr, value))
                    setattr(mod, attr, make(name, fn))
    try:
        yield
    finally:
        for mod, attr, value in undo:
            setattr(mod, attr, value)


def group_norm_sites(unet_config, spec):
    """Counter of the ``(B, N, C, groups, eps, act)`` that every GroupNorm
    of one exact CFG evaluation at ``spec``'s clip shape hands its norm,
    ``(B, N, C)`` being the module's input with the axes between the first
    and the channels folded into N: read by forward hooks from a UNet built
    and run on the meta device (no memory, no arithmetic)."""
    from followyourclick_tpu_torch.models.layers import GroupNorm
    from followyourclick_tpu_torch.models.unet3d import (
        UNet3DConditionModel,
        UNetConditioning,
    )

    sites = collections.Counter()

    def hook(module, inputs, _):
        x = inputs[0]
        n = 1
        for d in x.shape[1:-1]:
            n *= d
        sites[(x.shape[0], n, x.shape[-1], module.num_groups, module.eps,
               module.act)] += 1

    with torch.device("meta"), torch.no_grad():
        unet = UNet3DConditionModel(unet_config)
        for m in unet.modules():
            if isinstance(m, GroupNorm):
                m.register_forward_hook(hook)
        h, w = spec.height // 8, spec.width // 8
        unet(torch.empty(1, spec.video_length, h, w,
                         unet_config.conv_in_channels),
             torch.zeros(1), UNetConditioning(
                 torch.empty(2, TEXT_KEYS, unet_config.cross_attention_dim),
                 torch.empty(1), torch.empty(1)))
    return sites


def sdpa(q, k, v):
    """The one PyTorch call that computes attention over (B, S, H, D): the
    library yardstick, timed here and used nowhere in the port."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def phase_kernels(seed):
    from followyourclick_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )
    from followyourclick_tpu_torch.ops.geglu import (
        fused_ln_geglu,
        ln_geglu_ref,
    )
    from followyourclick_tpu_torch.ops.motion_block import (
        fits,
        fused_motion_block,
        motion_block_ref,
        qkv_weights,
    )
    from followyourclick_tpu_torch.ops.temporal_attention import (
        fused_temporal_block,
        temporal_attention,
        temporal_attention_ref,
        temporal_block_ref,
    )

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stats = {name: dict(err=0.0, ms=0.0, plain_ms=0.0, ops_ms=0.0,
                        bytes_ms=0.0, bound_ms=0.0, library_ms=None)
             for name in {**KERNELS, **UNROUTED}}
    failures = []

    def vec(c, s=0.05, base=0.0):
        return base + randn(gen, (c,), s, bf)

    def check(kernel, name, run_kernel, run_plain, count, ops, inputs,
              run_library=None, tol=BF16_REL, timed=True,
              peak_ops=PEAK_BF16_OPS, into=None):
        """Compare, time and bound one call; add ``count`` calls of it to
        the kernel's per-evaluation sums; ``into``: a dict that takes the
        call's error, times and bound."""
        got = run_kernel()
        st = stats[kernel]
        err = compare(name, got, run_plain(), failures, tol)
        st["err"] = max(st["err"], err)
        if not timed:
            return
        ms, plain = time_ms(run_kernel), time_ms(run_plain)
        ops_ms, bytes_ms = bound_times(ops, [*inputs, got], peak_ops)
        line = (f"    kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
                f"{max(ops_ms, bytes_ms):.3f} ms (operations {ops_ms:.3f}, "
                f"bytes {bytes_ms:.3f})")
        lib = None
        if run_library is not None:
            lib = time_ms(run_library)
            line += f", library {lib:.3f} ms"
            st["library_ms"] = (st["library_ms"] or 0.0) + count * lib
            st["ms_library_sites"] = st.get("ms_library_sites", 0.0) \
                + count * ms
        log(line)
        if into is not None:
            into.update(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=max(ops_ms, bytes_ms),
                        bound_by=("operations" if ops_ms >= bytes_ms
                                  else "bytes"), library_ms=lib)
        st["ms"] += count * ms
        st["plain_ms"] += count * plain
        st["ops_ms"] += count * ops_ms
        st["bytes_ms"] += count * bytes_ms
        st["bound_ms"] += count * max(ops_ms, bytes_ms)
        return ms, max(ops_ms, bytes_ms)

    for (rows, c), count in GEGLU_SHAPES:
        inner = 4 * c
        args = (randn(gen, (rows, c), 1.0, bf), vec(c, base=1.0), vec(c),
                randn(gen, (2 * inner, c), c ** -0.5, bf), vec(2 * inner),
                randn(gen, (c, inner), inner ** -0.5, bf), vec(c))
        default = c <= 640
        for fast in (default, not default):
            check("fused_ln_geglu",
                  f"fused_ln_geglu R={rows} C={c} "
                  f"{'tanh' if fast else 'erf'}",
                  lambda: fused_ln_geglu(*args, fast_gating=fast),
                  lambda: ln_geglu_ref(*args, fast_gating=fast),
                  count if fast == default else 0, 24 * rows * c * c, args)
        t = geglu_stages_ms(args, default)
        log(f"    stages (a) LN {t['(a)']:.3f} ms, (b) up + gate "
            f"{t['(b)']:.3f} ms, (c) down + residual {t['(c)']:.3f} ms; the "
            f"two products alone by torch.matmul {t['matmul (b)']:.3f} + "
            f"{t['matmul (c)']:.3f} ms (a yardstick, not library_ms: no one "
            "call computes LN-GEGLU)")

    for rows, c in T2I_GEGLU_SHAPES:
        inner = 4 * c
        args = (randn(gen, (rows, c), 1.0, bf), vec(c, base=1.0), vec(c),
                randn(gen, (2 * inner, c), c ** -0.5, bf), vec(2 * inner),
                randn(gen, (c, inner), inner ** -0.5, bf), vec(c))
        for fast in (c <= 640, c > 640):
            check("fused_ln_geglu",
                  f"fused_ln_geglu T2I R={rows} C={c} "
                  f"{'tanh' if fast else 'erf'}",
                  lambda: fused_ln_geglu(*args, fast_gating=fast),
                  lambda: ln_geglu_ref(*args, fast_gating=fast),
                  0, 0, args, timed=False)

    def motion_params(c, dtype=bf):
        params = []
        for _ in range(2):
            params += [vec(c, base=1.0), vec(c)] + [
                randn(gen, (c, c), c ** -0.5, bf) for _ in range(4)] + [
                vec(c, 0.02)]
        params += [vec(c, base=1.0), vec(c),
                   randn(gen, (8 * c, c), c ** -0.5, bf), vec(8 * c, 0.02),
                   randn(gen, (c, 4 * c), (4 * c) ** -0.5, bf), vec(c, 0.02)]
        return [t.to(dtype) for t in params]

    for (p, f, c), count in MOTION_SHAPES:
        heads = 8
        params = motion_params(c)
        x = randn(gen, (p, f, c), 1.0, bf)
        pe = randn(gen, (f, c), 0.5, bf)
        scale = (c // heads) ** -0.5
        default = c <= 640
        rows = p * f
        # built once per module on the path (TemporalTransformerBlock)
        qkv = qkv_weights(params)
        for fast in (default, not default):
            check("fused_motion_block",
                  f"fused_motion_block P={p} F={f} C={c} "
                  f"{'tanh' if fast else 'erf'}",
                  lambda: fused_motion_block(x, pe, params, scale, heads,
                                             fast_gating=fast, qkv=qkv),
                  lambda: motion_block_ref(x, pe, params, scale, heads,
                                           fast_gating=fast),
                  count if fast == default else 0,
                  40 * rows * c * c + 8 * rows * f * c, [x, pe, *params])
        t = motion_stages_ms(x, pe, params, qkv, scale, heads, default)
        host = host_ms(lambda: fused_motion_block(
            x, pe, params, scale, heads, fast_gating=default, qkv=qkv))
        log("    stages: " + ", ".join(f"{k} {v:.3f} ms"
                                       for k, v in t.items())
            + f"; 2 x (a..d) + FF = "
            f"{2 * sum(list(t.values())[:4]) + t['FF']:.3f} ms; the host "
            f"takes {host:.3f} ms a call to enqueue its 11 launches")
        if c < 1280:
            # the modular kernels on the same block: two attention
            # sublayers without their LN, PE and residual, and the FF
            tb = time_ms(lambda: fused_temporal_block(
                x, *params[2:7], scale=scale, heads=heads, qkv=qkv[0]))
            ff = time_ms(lambda: fused_ln_geglu(
                x.view(rows, c), *params[14:20], fast_gating=default))
            ms = time_ms(lambda: fused_motion_block(
                x, pe, params, scale, heads, fast_gating=default, qkv=qkv))
            log(f"    modular yardstick: 2 x fused_temporal_block {tb:.3f} "
                f"+ fused_ln_geglu {ff:.3f} = {2 * tb + ff:.3f} ms against "
                f"the block's {ms:.3f} ms")
    # the per-frame pass at F = 1, bf16 (its path) and fp32 where the
    # all-on-chip kernel takes the width (C = 320; at 640 and 1280 one
    # position's block overflows its shared memory even at one frame, and
    # the model routes fp32 there to the modular path); timed, not summed
    # into the exact evaluation's calls
    frame_pass = {bf: 0.0, torch.float32: 0.0}
    for (p, c), count in FRAME_PASS_MOTION_SHAPES:
        heads, rows = 8, p
        for dtype in (bf, torch.float32):
            if not fits(1, c, heads, dtype):
                log(f"  fused_motion_block P={p} F=1 C={c} "
                    f"{str(dtype).split('.')[-1]}: not taken (fits() says "
                    "no; the modular path's route)")
                continue
            params = motion_params(c, dtype)
            x = randn(gen, (p, 1, c), 1.0, dtype)
            pe = randn(gen, (1, c), 0.5, dtype)
            fast = dtype == bf and c <= 640
            qkv = qkv_weights(params) if dtype == bf else None
            scale = (c // heads) ** -0.5
            ms, _ = check(
                "fused_motion_block",
                f"fused_motion_block P={p} F=1 C={c} "
                f"{str(dtype).split('.')[-1]} {'tanh' if fast else 'erf'} "
                "(video_scale per-frame pass)",
                lambda: fused_motion_block(x, pe, params, scale, heads,
                                           fast_gating=fast, qkv=qkv),
                lambda: motion_block_ref(x, pe, params, scale, heads,
                                         fast_gating=fast),
                0, 40 * rows * c * c + 8 * rows * c, [x, pe, *params],
                tol=BF16_REL if dtype == bf else FP32_REL,
                peak_ops=PEAK_BF16_OPS if dtype == bf else PEAK_FP32_OPS)
            frame_pass[dtype] += count * ms
    log(f"[kernels] fused_motion_block at F = 1: the 20 calls of one "
        f"per-frame pass take {frame_pass[bf]:.1f} ms in bf16 (fp32: "
        f"{frame_pass[torch.float32]:.1f} ms for the 5 calls at C = 320)")

    heads = 8
    for (b, f, c), count in TEMPORAL_BLOCK_SHAPES:
        args = (randn(gen, (b, f, c), 1.0, bf),
                *[randn(gen, (c, c), c ** -0.5, bf) for _ in range(4)],
                vec(c, 0.02))
        # built once per module on the path (TemporalAttention.qkv_weight)
        wqkv = torch.cat(args[1:4])
        rows, scale = b * f, (c // heads) ** -0.5
        check("fused_temporal_block",
              f"fused_temporal_block B={b} F={f} C={c}",
              lambda: fused_temporal_block(*args, heads=heads, qkv=wqkv),
              lambda: temporal_block_ref(*args, heads=heads), count,
              8 * rows * c * c + 4 * rows * f * c, args)
        t = temporal_block_stages_ms(args[0], wqkv, args[4], args[5], scale,
                                     heads)
        ms = time_ms(lambda: fused_temporal_block(*args, heads=heads,
                                                  qkv=wqkv))
        host = host_ms(lambda: fused_temporal_block(*args, heads=heads,
                                                    qkv=wqkv))
        log("    stages: " + ", ".join(f"{k} {v:.3f} ms"
                                       for k, v in t.items())
            + f"; sum {sum(t.values()):.3f} ms against the call's "
            f"{ms:.3f} ms; the host takes {host:.3f} ms a call to enqueue "
            "its 3 launches")
    for (b, s, h, d), count in TEMPORAL_ATTN_SHAPES:
        qkv = [randn(gen, (b, s, h, d), 1.0, bf) for _ in range(3)]
        check("temporal_attention",
              f"temporal_attention B={b} S={s} H={h} D={d}",
              lambda: temporal_attention(*qkv),
              lambda: temporal_attention_ref(*qkv), count,
              4 * b * h * s * s * d, qkv, run_library=lambda: sdpa(*qkv))
    for (b, sq, sk, h, d), dtype, count in FLASH_SHAPES:
        q = randn(gen, (b, sq, h, d), 1.0, dtype)
        kv = [randn(gen, (b, sk, h, d), 1.0, dtype) for _ in range(2)]
        path = count > 0
        check("flash_attention",
              f"flash_attention B={b} Sq={sq} Sk={sk} H={h} D={d} "
              f"{str(dtype).split('.')[-1]}",
              lambda: flash_attention(q, *kv),
              lambda: flash_attention_ref(q, *kv), count,
              4 * b * h * sq * sk * d, [q, *kv],
              run_library=(lambda: sdpa(q, *kv)) if path else None,
              tol=BF16_REL if dtype == bf else FP32_REL, timed=path)
        if path:
            exps = b * h * sq * sk
            log(f"    {exps:.3e} exponentials: {sfu_ms(exps):.3f} ms at the "
                "special-function units' rate (16 per SM per clock at the "
                "card's maximum SM clock)")
    # the cross-frame path's shape: one call, kept apart from the sums
    b, sq, sk, h, d = CROSS_FRAME_FLASH
    q = randn(gen, (b, sq, h, d), 1.0, bf)
    kv = [randn(gen, (b, sk, h, d), 1.0, bf) for _ in range(2)]
    cross_frame = stats["flash_attention"]["cross_frame"] = {}
    check("flash_attention",
          f"flash_attention B={b} Sq={sq} Sk={sk} H={h} D={d} bfloat16 "
          "(cross-frame self-attention, one call)",
          lambda: flash_attention(q, *kv),
          lambda: flash_attention_ref(q, *kv), 0, 4 * b * h * sq * sk * d,
          [q, *kv], run_library=lambda: sdpa(q, *kv), into=cross_frame)
    del q, kv
    phase_unrouted_kernels(gen, check, vec)
    for name, st in stats.items():
        st["bound_by"] = ("operations" if st["ops_ms"] >= st["bytes_ms"]
                          else "bytes")
        lib = st["library_ms"]
        log(f"[kernels] {name}: one UNet evaluation's calls take "
            f"{st['ms']:.1f} ms in the kernel, {st['plain_ms']:.1f} ms plain, "
            f"bound {st['bound_ms']:.2f} ms by {st['bound_by']}"
            + ("" if lib is None else
               f", library {lib:.2f} ms (against {st['ms_library_sites']:.2f}"
               " ms of the kernel at the same calls)"))
    if failures:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failures}")
    return stats


def phase_unrouted_kernels(gen, check, vec):
    """The three kernels no path routes, at the shapes their sites would
    give them in one exact evaluation at 16 f / 512² with CFG."""
    import torch.nn.functional as F

    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.ops.cross_attention import (
        fused_ln_cross_attention,
        ln_cross_attention_ref,
    )
    from followyourclick_tpu_torch.ops.geglu import fused_geglu, geglu_ref
    from followyourclick_tpu_torch.ops import _build
    from followyourclick_tpu_torch.ops.groupnorm import (
        cluster_smem,
        fused_group_norm,
        group_norm_path,
        group_norm_ref,
    )
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec

    bf = torch.bfloat16
    yardstick = {}
    for (rows, c), count in GEGLU_SHAPES:
        inner = 4 * c
        args = (randn(gen, (rows, c), 1.0, bf),
                randn(gen, (2 * inner, c), c ** -0.5, bf), vec(2 * inner),
                randn(gen, (c, inner), inner ** -0.5, bf), vec(c))
        default = c <= 640
        for fast in (default, not default):
            check("fused_geglu",
                  f"fused_geglu R={rows} C={c} {'tanh' if fast else 'erf'}",
                  lambda: fused_geglu(*args, fast_gating=fast),
                  lambda: geglu_ref(*args, fast_gating=fast),
                  count if fast == default else 0, 24 * rows * c * c, args)

    sites = group_norm_sites(InferenceConfig().unet, SampleSpec())
    log(f"[kernels] {sum(sites.values())} GroupNorm sites in one exact "
        f"evaluation, {len(sites)} shapes")
    lib = _build.load_library()
    big = randn(gen, (32, 4096, 320), 1.0, bf)
    copy = torch.empty_like(big)
    copy_ms = graph_ms(lambda: copy.copy_(big))
    log(f"[kernels] a PyTorch copy of {big.numel() * 2 / 1e6:.1f} MB of bf16 "
        f"takes {copy_ms:.4f} ms on the device "
        f"({2 * big.numel() * 2 / copy_ms / 1e9:.2f} TB/s read + write): the "
        "streaming rate the GroupNorm sites' bound is read against")
    del big, copy
    paths = collections.defaultdict(lambda: dict(sites=0, ms=0.0, bound=0.0,
                                                 device=0.0, host=[]))
    for (b, n, c, groups, eps, act), count in sorted(
            sites.items(), key=lambda kv: str(kv[0])):
        x = randn(gen, (b, n, c), 1.0, bf) + 0.5
        params = (vec(c, base=1.0), vec(c))
        path, blocks, rows = group_norm_path(b, n, c, bf)
        where = (f"cluster of {blocks} x {rows} rows, "
                 f"{cluster_smem(rows, c, bf)} B a block, "
                 f"{lib.fyc_group_norm_max_clusters(c, blocks, rows, 1)} "
                 "clusters at once" if path == "cluster" else
                 f"two passes, {blocks} chunks of {rows} rows")
        ms, bound = check(
            "fused_group_norm",
            f"fused_group_norm B={b} N={n} C={c} G={groups} act={act} "
            f"x{count} [{where}]",
            lambda: fused_group_norm(x, *params, groups, eps, act),
            lambda: group_norm_ref(x, *params, groups, eps, act), count,
            10 * x.numel(), [x, *params],
            run_library=(None if act else lambda: F.group_norm(
                x.transpose(1, 2), groups, *params, eps)),
            peak_ops=PEAK_FP32_OPS)
        device = graph_ms(lambda: fused_group_norm(x, *params, groups, eps,
                                                   act))
        log(f"    device {device:.4f} ms a call (CUDA graph of 20 calls)")
        st = paths[path]
        st["sites"] += count
        st["ms"] += count * ms
        st["bound"] += count * bound
        st["device"] += count * device
        st["host"].append(host_ms(
            lambda: fused_group_norm(x, *params, groups, eps, act)))
    for path, st in sorted(paths.items()):
        log(f"[kernels] fused_group_norm, {path}: {st['sites']} sites take "
            f"{st['ms']:.3f} ms ({st['device']:.3f} ms on the device), bound "
            f"{st['bound']:.3f} ms; the host takes {min(st['host']):.3f}-"
            f"{max(st['host']):.3f} ms a call to enqueue")

    heads = 8
    for (b, sq, c), dtype, count in CROSS_SHAPES:
        x = randn(gen, (b, sq, c), 1.0, dtype)
        ctx = randn(gen, (b, TEXT_KEYS, TEXT_DIM), 1.0, dtype)
        params = (vec(c, base=1.0).to(dtype), vec(c).to(dtype),
                  randn(gen, (c, c), c ** -0.5, dtype),
                  randn(gen, (c, TEXT_DIM), TEXT_DIM ** -0.5, dtype),
                  randn(gen, (c, TEXT_DIM), TEXT_DIM ** -0.5, dtype),
                  randn(gen, (c, c), c ** -0.5, dtype), vec(c, 0.02).to(dtype))
        rows = b * sq
        ops = 4 * rows * c * c + 4 * rows * TEXT_KEYS * c \
            + 4 * b * TEXT_KEYS * TEXT_DIM * c
        check("fused_ln_cross_attention",
              f"fused_ln_cross_attention B={b} S={sq} C={c} Skv={TEXT_KEYS} "
              f"{str(dtype).split('.')[-1]}",
              lambda: fused_ln_cross_attention(x, ctx, *params, heads=heads),
              lambda: ln_cross_attention_ref(x, ctx, *params, heads=heads),
              count, ops, [x, ctx, *params],
              tol=BF16_REL if dtype == bf else FP32_REL, timed=count > 0)
        if count == 0:
            continue
        t = cross_stages_ms(x, ctx, params, heads)
        stock = t.pop("stock")
        def call():
            return fused_ln_cross_attention(x, ctx, *params, heads=heads)

        ms, device, host = time_ms(call), graph_ms(call), host_ms(call)
        log("    stages: " + ", ".join(f"{k} {v:.3f} ms"
                                       for k, v in t.items())
            + f"; sum {sum(t.values()):.3f} ms against the call's {ms:.3f} "
            f"ms (k/v F.linear included; {device:.3f} ms on the device); "
            f"the host takes {host:.3f} ms a call to enqueue its launches; "
            f"stock composition (F.layer_norm, F.linear, SDPA, F.linear) "
            f"{stock:.3f} ms (a yardstick, not library_ms: four kinds of "
            "call)")
        yardstick["fused_ln_cross_attention"] = \
            yardstick.get("fused_ln_cross_attention", 0.0) + count * stock
    for name, ms in yardstick.items():
        log(f"[kernels] {name}: the stock composition of one evaluation's "
            f"calls takes {ms:.2f} ms")


def unzero_(module, gen, std=0.02):
    """Give the layers that start at zero (motion-module proj_out, the fps,
    motion-score and camera-motion embedding outputs, the T5 projection, the
    temporal LoRA ``up``, the last conv of a temporal conv block) small
    random weights, and add as much noise to the identity (dirac) temporal
    conv of each ``PseudoConv3d``, so each of them reaches the video."""
    from followyourclick_tpu_torch.models.layers import TimestepEmbedding
    from followyourclick_tpu_torch.models.motion_module import (
        LoRADense,
        MotionModule,
    )
    from followyourclick_tpu_torch.models.resnet import (
        PseudoConv3d,
        TemporalConvBlock,
    )
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel

    def noise(shape):
        return torch.randn(shape, generator=gen, device=gen.device) * std

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, PseudoConv3d):
                w = m.temporal_conv.weight
                w.add_(noise(w.shape).to(w))
                continue
            layer = (m.proj_out if isinstance(m, MotionModule) else
                     m.linear_2 if isinstance(m, TimestepEmbedding) else
                     m.up if isinstance(m, LoRADense) else
                     m.conv4 if isinstance(m, TemporalConvBlock) else
                     getattr(m, "text_encoder_proj_model_t5", None)
                     if isinstance(m, UNet3DConditionModel) else None)
            if layer is not None and not layer.weight.any():
                layer.weight.copy_(noise(layer.weight.shape))


def tiny_config():
    """The CPU tests' tiny config (UNet widths 32-64, 4 motion heads; at 64²
    the inner levels' spatial self-attention has ≤ 32 tokens, the
    tiny-sequence kernel's route)."""
    from followyourclick_tpu_torch.config import (
        CLIPTextConfig,
        InferenceConfig,
        MotionModuleConfig,
        UNet3DConfig,
        VAEConfig,
    )

    return InferenceConfig(
        unet=UNet3DConfig(
            block_out_channels=(32, 64, 64, 64), layers_per_block=1,
            norm_num_groups=8,
            motion_module=MotionModuleConfig(num_attention_heads=4)),
        vae=VAEConfig(block_out_channels=(32, 64, 64, 64),
                      layers_per_block=1, norm_num_groups=8),
        clip_text=CLIPTextConfig(vocab_size=1000, intermediate_size=512,
                                 num_hidden_layers=2, num_attention_heads=4))


def make_request(pipe, spec, seed, vocab, batch=1):
    """``batch`` clips, each with its own token ids, click mask, fps, motion
    score and first-frame image (encoded by the pipeline's VAE), and, when
    the pipeline has an IP-Adapter, its own image prompt (unit normal, as
    CLIP-normalised pixels), when it has a T5 encoder its own T5 token ids
    and padding masks (``T5_PROMPT_TOKENS`` real tokens of ``T5_TOKENS``
    cond, one uncond), all from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    b, h, w = batch, spec.height // 8, spec.width // 8
    image = torch.rand(b, spec.height, spec.width, 3, generator=g) * 2 - 1
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    masks = []
    for _ in range(b):
        cy, cx = torch.randint(0, h, (2,), generator=g).tolist()
        masks.append((((yy - cy) ** 2 + (xx - cx) ** 2)
                      <= (h // 4) ** 2).float())
    req = dict(
        input_ids=torch.randint(0, vocab, (b, 77), generator=g),
        neg_input_ids=torch.randint(0, vocab, (b, 77), generator=g),
        first_image_latents=pipe.encode_image(image),
        mask=torch.stack(masks)[..., None],
        fps=torch.tensor([8.0 + 4 * i for i in range(b)]),
        motion_score=torch.tensor([float(10 + (seed + 7 * i) % 20)
                                   for i in range(b)]),
        noise=torch.randn(b, spec.video_length, h, w, 4, generator=g))
    if pipe.ip_adapter is not None:
        size = pipe.ip_adapter.image_encoder.config.image_size
        req["ip_pixel_values"] = torch.randn(b, size, size, 3, generator=g)
    if pipe.t5 is not None:
        vocab = pipe.t5.config.vocab_size
        masks = torch.zeros(2, b, T5_TOKENS, dtype=torch.long)
        masks[0, :, :T5_PROMPT_TOKENS] = 1
        masks[1, :, :1] = 1
        req.update(
            t5_input_ids=torch.randint(0, vocab, (b, T5_TOKENS), generator=g),
            t5_attention_mask=masks[0],
            t5_neg_input_ids=torch.randint(0, vocab, (b, T5_TOKENS),
                                           generator=g),
            t5_neg_attention_mask=masks[1])
    return req


def motion_lora(unet, rank, gen):
    """A camera-motion LoRA in the reference key format
    (``...motion_modules.N.temporal_transformer.transformer_blocks.0.
    attention_blocks.M.processor.to_{q,k,v,out}_lora.{down,up}.weight``)
    over every motion module's attention projections: down N(0, 1/C), up
    N(0, CAMERA_LORA_SCALE²/rank), from the CPU generator ``gen``."""
    import re

    from followyourclick_tpu_torch.models.motion_module import (
        TemporalAttention,
    )

    lora = {}
    for name, m in unet.named_modules():
        if not isinstance(m, TemporalAttention):
            continue
        base = re.sub(r"(motion_modules\.\d+\.)", r"\1temporal_transformer.",
                      name)
        c = m.to_q.in_features
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            key = f"{base}.processor.{proj}_lora"
            lora[f"{key}.down.weight"] = torch.randn(
                rank, c, generator=gen) / c ** 0.5
            lora[f"{key}.up.weight"] = torch.randn(
                c, rank, generator=gen) * CAMERA_LORA_SCALE / rank ** 0.5
    return lora


def tiny_pipelines(cfg, seed, ip_plus=None, camera_lora=False):
    """The tiny config's pipeline on the CPU (plain versions) and a copy of
    it on the card; with ``ip_plus`` set, an IP-Adapter over
    ``TINY_VISION`` (vanilla or Plus) and ip tokens in the UNet; with
    ``camera_lora``, the camera-motion embedding and a merged
    :func:`motion_lora`."""
    from followyourclick_tpu_torch.utils.lora import merge_motion_lora

    from followyourclick_tpu_torch.models.ip_adapter import (
        CLIPVisionConfig,
        IPAdapter,
    )
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )

    torch.manual_seed(seed)
    ip = None
    if ip_plus is not None:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, use_ip_cross_attention=True, ip_num_tokens=4))
        ip = IPAdapter(CLIPVisionConfig(**TINY_VISION),
                       cfg.unet.cross_attention_dim, 4, ip_plus)
    if camera_lora:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, use_camera_motion_condition=True))
    cpu = AnimationPipeline(cfg, device="cpu", ip_adapter=ip)
    unzero_(cpu.unet, torch.Generator().manual_seed(seed))
    if camera_lora:
        merge_motion_lora(cpu.unet, motion_lora(
            cpu.unet, 4, torch.Generator().manual_seed(seed + 1)))
    card = AnimationPipeline(cfg, copy.deepcopy(cpu.unet),
                             copy.deepcopy(cpu.vae),
                             copy.deepcopy(cpu.text_encoder), device="cuda",
                             ip_adapter=copy.deepcopy(cpu.ip_adapter))
    return cpu, card


def phase_tiny(seed):
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.pipelines.serving_schedules import (
        apply_schedule,
    )

    cfg = tiny_config()
    exact = SampleSpec(video_length=4, height=64, width=64,
                       num_inference_steps=2)
    # one period of 4 and the 2 final exact steps
    serving = apply_schedule(SampleSpec(video_length=4, height=64, width=64,
                                        num_inference_steps=6),
                             "pab244_deep4_cfg4_ex")
    plain, vanilla, plus = (tiny_pipelines(cfg, seed, ip)
                            for ip in (None, False, True))
    camera = tiny_pipelines(cfg, seed, camera_lora=True)
    dpm = dataclasses.replace(exact, scheduler="dpm++", num_inference_steps=4)
    euler_a = dataclasses.replace(exact, scheduler="euler_a")
    # Euler-A's fresh noise, the same on both devices
    step_noise = torch.randn(
        (euler_a.num_inference_steps, 1, euler_a.video_length,
         euler_a.height // 8, euler_a.width // 8, 4),
        generator=torch.Generator().manual_seed(seed + 2))
    runs = [("exact", plain, exact, {}),
            ("pab244_deep4_cfg4_ex", plain, serving, {}),
            ("exact, IP-Adapter", vanilla, exact, {}),
            ("exact, IP-Adapter Plus", plus, exact, {}),
            ("pab244_deep4_cfg4_ex, IP-Adapter", vanilla, serving, {}),
            ("exact, camera + motion LoRA", camera, exact,
             dict(camera_motion_type=torch.tensor([4.0]))),
            ("dpm++", plain, dpm, {}),
            ("euler_a", plain, euler_a, dict(step_noise=step_noise)),
            ("exact, video_scale 1.5", plain,
             dataclasses.replace(exact, video_scale=1.5), {})]
    for label, (cpu, card), spec, extra in runs:
        tiny_request(label, cpu, card, spec, extra, seed)


def tiny_request(label, cpu, card, spec, extra, seed):
    """One tiny request on the CPU (plain versions) and on the card
    (kernels): the videos must agree within ``TINY_VIDEO_ATOL``, and
    spatial self-attention of <= 32 tokens must take the tiny-sequence
    kernel. Returns the card's launches by kernel."""
    wrappers = kernel_wrappers()
    with torch.inference_mode():
        req = {**make_request(cpu, spec, seed + 1, 1000), **extra}
    t0 = time.perf_counter()
    want = cpu.sample(spec=spec, **req)
    t_cpu = time.perf_counter() - t0
    before = {n: fn.launches for n, fn in wrappers.items()}
    t0 = time.perf_counter()
    got = card.sample(spec=spec, **req)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launched = {n: fn.launches - before[n] for n, fn in wrappers.items()}
    err = float((got.cpu() - want).abs().max())
    ok = err <= TINY_VIDEO_ATOL and bool(torch.isfinite(got).all()) \
        and float(want.std()) > 1e-3
    log(f"[tiny] {label}: video {tuple(got.shape)} card (kernels) vs "
        f"CPU (plain): max_abs_err {err:.3e} (tol {TINY_VIDEO_ATOL}); "
        f"card {t_card:.2f} s, CPU {t_cpu:.2f} s; launches {launched} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"tiny {label} request: the card disagrees "
                         "with the CPU")
    if not launched["temporal_attention"]:
        raise SystemExit("tiny request: spatial self-attention of <= 32 "
                         "tokens did not take the temporal_attention "
                         "kernel")
    return launched


# the remaining UNet and motion-module options, one tiny request each:
# (label, UNet3DConfig fields, MotionModuleConfig fields, frames)
TINY_OPTIONS = [
    ("use_pseudo_conv3d", dict(use_pseudo_conv3d=True), {}, 4),
    ("use_temporal_conv", dict(use_temporal_conv=True), {}, 4),
    ("use_first_frame_condition_concat",
     dict(use_first_frame_condition_concat=True,
          use_first_frame_mask_condition_concat=False), {}, 4),
    ("center_input_sample", dict(center_input_sample=True), {}, 4),
    ("use_linear_projection", dict(use_linear_projection=True), {}, 4),
    ("upcast_attention", dict(upcast_attention=True), {}, 4),
    ("motion_module_decoder_only", dict(motion_module_decoder_only=True), {},
     4),
    ("Temporal_Cross", {},
     dict(attention_block_types=("Temporal_Self", "Temporal_Cross")), 4),
    ("temporal_attention_dim_div 2", {}, dict(temporal_attention_dim_div=2),
     4),
    ("RoPE at F = 24 > train_video_length", {},
     dict(use_rope_position_encoding=True), 24),
]


def phase_tiny_options(seed):
    """Each remaining UNet and motion-module option as a tiny fp32 request,
    card against CPU (:func:`tiny_request`), its zero and dirac inits
    perturbed (:func:`unzero_`); then the two options no request reaches
    (the JAX sampler sets neither), class embeddings and the first-frame
    zero-timestep embedding, as one tiny UNet evaluation each, card
    against CPU within the same limit."""
    from followyourclick_tpu_torch.models.unet3d import (
        UNet3DConditionModel,
        UNetConditioning,
    )
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec

    base = tiny_config()
    for label, unet_kw, motion_kw, frames in TINY_OPTIONS:
        cfg = dataclasses.replace(base, unet=dataclasses.replace(
            base.unet, **unet_kw, motion_module=dataclasses.replace(
                base.unet.motion_module, **motion_kw)))
        spec = SampleSpec(video_length=frames, height=64, width=64,
                          num_inference_steps=2)
        tiny_request(f"option {label}", *tiny_pipelines(cfg, seed), spec, {},
                     seed)
    g = torch.Generator().manual_seed(seed + 3)
    for label, unet_kw, extra in (
            ("num_class_embeds", dict(num_class_embeds=4),
             dict(class_labels=torch.tensor([2]))),
            ("first_frame_zero_timestep", {},
             dict(first_frame_zero_timestep=True))):
        torch.manual_seed(seed)
        cfg = dataclasses.replace(base.unet, **unet_kw)
        cpu = UNet3DConditionModel(cfg).eval()
        unzero_(cpu, torch.Generator().manual_seed(seed))
        card = copy.deepcopy(cpu).cuda()
        x = torch.randn(1, 4, 8, 8, cfg.conv_in_channels, generator=g)
        cond = dict(context=torch.randn(2, TEXT_KEYS, 768, generator=g),
                    fps=torch.tensor([8.0]), motion_score=torch.tensor([20.0]),
                    **extra)
        t = torch.tensor([501])
        with torch.inference_mode():
            want = cpu(x, t, UNetConditioning(**cond))
            got = card(x.cuda(), t.cuda(), UNetConditioning(**{
                k: v.cuda() if torch.is_tensor(v) else v
                for k, v in cond.items()}))
        err = float((got.cpu() - want).abs().max())
        log(f"[tiny] option {label}: UNet evaluation {tuple(got.shape)} card "
            f"vs CPU: max_abs_err {err:.3e} (tol {TINY_VIDEO_ATOL})")
        if err > TINY_VIDEO_ATOL or not bool(torch.isfinite(got).all()):
            raise SystemExit(f"tiny option {label}: the card disagrees with "
                             "the CPU")


def whole_block_fits(c, dtype, frames=16):
    """The whole-block motion kernel's route rule, written out from its
    shared-memory size rather than asked of the model: bf16 at every width
    to 1280 and up to 32 frames; fp32 at 16 frames only below 640 (other
    frame counts in fp32 are not counted here)."""
    if dtype == torch.bfloat16:
        return c <= 1280 and frames <= 32
    if frames != 16:
        raise ValueError("fp32 route counted at 16 frames only")
    return c < 640


def flash_line(rows, tokens, heads, keys=None):
    """The flash route's rule for self-attention of ``tokens`` queries over
    ``keys`` keys (``tokens`` unless given), written out from the JAX
    routing rule rather than asked of the port: at least 1024 keys and more
    than 12 GiB of bf16 scores."""
    keys = tokens if keys is None else keys
    return keys >= 1024 and rows * heads * tokens * keys * 2 > 12 * 2 ** 30


def tiny_line(frames, heads):
    """The tiny-sequence route's rule for attention over the frames: at
    most 32 frames and frames x heads at most 256."""
    return frames <= 32 and frames * heads <= 256


def expected_launches(unet, spec, dtype, batch=1, plan=None):
    """Each kernel's launches in one request of ``batch`` clips that follows
    ``plan`` (default the request's :func:`request_plan`: ``step_plan`` on
    DDIM, the solver's ``n_calls`` full steps otherwise), from the plan, the
    clip shape and the UNet's module structure alone. A trunk-reuse step
    runs only level 0 (down block 0 and the last up block).

    A motion block takes the whole-block kernel when it is standard (two
    ``Temporal_Self`` attentions, no RoPE, no LoRA, inner width = C), the
    step's mode neither records nor reuses temporal sites and
    :func:`whole_block_fits` says yes; else the modular path: the FF is one
    LN-GEGLU launch and each attention that is not reused one launch of
    fused_temporal_block (no RoPE or LoRA, inner width = C < 1280) or of
    temporal_attention (where :func:`tiny_line` holds). Every spatial
    transformer block runs one LN-GEGLU; with in-block temporal attention,
    one temporal_attention launch unless reused (where :func:`tiny_line`
    holds). A spatial self-attention that is not reused launches flash
    attention when :func:`flash_line` holds for its rows (clips × frames,
    doubled for CFG after the duplication: with a shared CFG prefix on an
    exact step only from the second transformer block on, since the first
    duplicates at its cross-attention; with an unshared prefix or on a full
    serving step everywhere, the input being pre-duplicated; never on a
    cond-only step or without CFG) and its keys (twice its tokens under
    cross-frame attention). Under ``video_scale`` (with CFG) every full step
    adds the per-frame pass, the exact UNet at clips × frames rows of one
    frame. Spatial self-attention is assumed above 32 tokens (no
    tiny-sequence launches), as at 512²."""
    from followyourclick_tpu_torch.config import NoiseScheduleConfig
    from followyourclick_tpu_torch.models.attention import (
        BasicTransformerBlock,
    )
    from followyourclick_tpu_torch.models.motion_module import (
        TemporalTransformerBlock,
    )
    from followyourclick_tpu_torch.pipelines.animation import request_plan
    from followyourclick_tpu_torch.schedulers.dispatch import make_solver

    if plan is None:  # a solver's calls depend on its name and steps only
        plan = request_plan(spec, make_solver(
            spec.scheduler, NoiseScheduleConfig(),
            spec.num_inference_steps).n_calls)
    levels = len(unet.down_blocks)
    last_up = f"up_blocks.{levels - 1}."

    def level(name):
        part, i = name.split(".")[:2]
        if part == "down_blocks":
            return int(i)
        return levels - 1 - int(i) if part == "up_blocks" else levels - 1

    def level0(name):
        return name.startswith("down_blocks.0.") or name.startswith(last_up)

    counts = dict.fromkeys(KERNELS, 0)

    def evaluation(mode, full, rows, doubled, frames):
        trunk = (mode is None or not mode.reuse_deep
                 or len(unet.down_blocks) < 2)
        temporal_sites = mode is not None and (mode.record_temporal
                                               or mode.reuse_temporal)
        temporal_run = mode is None or not mode.reuse_temporal
        for name, m in unet.named_modules():
            if not (trunk or level0(name)):
                continue
            if isinstance(m, BasicTransformerBlock):
                counts["fused_ln_geglu"] += 1
                r = rows * (2 if doubled else 1)
                doubled = doubled or (spec.do_cfg and full)
                tokens = ((spec.height // 8 >> level(name))
                          * (spec.width // 8 >> level(name)))
                keys = 2 * tokens if m.cross_frame else tokens
                if (mode is None or not mode.reuse_spatial) and flash_line(
                        r, tokens, m.attn1.heads, keys):
                    counts["flash_attention"] += 1
                if m.temporal and temporal_run and tiny_line(
                        frames, m.attn_temp.heads):
                    counts["temporal_attention"] += 1
            elif isinstance(m, TemporalTransformerBlock):
                standard = (m.block_types == ("Temporal_Self",) * 2
                            and not m.use_rope and not m.lora
                            and m.heads * m.head_dim == m.dim)
                if standard and not temporal_sites and whole_block_fits(
                        m.dim, dtype, frames):
                    counts["fused_motion_block"] += 1
                    continue
                counts["fused_ln_geglu"] += 1
                if not temporal_run:
                    continue
                for a in m.attention_blocks:
                    if not a.lora and not a.use_rope and m.dim < 1280 \
                            and a.heads * a.dim_head == m.dim:
                        counts["fused_temporal_block"] += 1
                    elif tiny_line(frames, a.heads):
                        counts["temporal_attention"] += 1

    for step in plan:
        rows = batch * spec.video_length
        evaluation(step.mode, step.full, rows, spec.do_cfg and step.full and (
            step.mode is not None or not spec.share_cfg_prefix),
            spec.video_length)
        if spec.do_cfg and spec.video_scale > 0 and step.full:
            evaluation(None, False, rows, False, 1)
    return counts


def full_pipeline(seed, ip_plus=False, camera=False, t5=False,
                  routes=False):
    """The default InferenceConfig's models with seeded random weights, in
    bf16 on the card. ``ip_plus``: the IP-Adapter Plus configuration, ip
    tokens in the UNet (``IP_TOKENS``), the CLIP ViT-H/14 tower and the
    Resampler (depth 4, 12 heads). ``camera``: the UNet with the
    camera-motion embedding (BASELINE config 4). ``t5``: the UNet with the
    T5 cross-attention and a T5-v1.1-XXL encoder at ``T5Config()`` widths
    (:func:`t5_encoder`). ``routes``: the UNet with :func:`routes_unet`'s
    options. Every zero-initialised layer gets small weights
    (:func:`unzero_`)."""
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.ip_adapter import (
        CLIPVisionConfig,
        IPAdapter,
    )
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL
    from followyourclick_tpu_torch.pipelines.animation import (
        AnimationPipeline,
    )

    cfg = InferenceConfig()
    if ip_plus:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, use_ip_cross_attention=True, ip_num_tokens=IP_TOKENS))
    if camera:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, use_camera_motion_condition=True))
    if t5:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, use_text_encoder_2=True))
    if routes:
        cfg = dataclasses.replace(cfg, unet=routes_unet(cfg.unet))
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    ip = None
    with torch.device("cuda"):
        unet = UNet3DConditionModel(cfg.unet)
        vae = AutoencoderKL(cfg.vae)
        text = CLIPTextModel(cfg.clip_text)
        if ip_plus:
            ip = IPAdapter(CLIPVisionConfig(), cfg.unet.cross_attention_dim,
                           IP_TOKENS, plus=True)
    unzero_(unet, torch.Generator(device="cuda").manual_seed(seed))
    pipe = AnimationPipeline(cfg, unet, vae, text, device="cuda",
                             dtype=torch.bfloat16, ip_adapter=ip,
                             t5=t5_encoder(seed) if t5 else None)
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    log(f"[full] built in {time.perf_counter() - t0:.1f} s; UNet "
        f"{n_params / 1e9:.3f} B parameters, bf16"
        + ("" if ip is None else
           f"; IP-Adapter Plus {sum(p.numel() for p in ip.parameters()) / 1e9:.3f}"
           " B parameters")
        + ("" if pipe.t5 is None else
           f"; T5 {sum(p.numel() for p in pipe.t5.parameters()) / 1e9:.3f}"
           " B parameters"))
    return pipe


def t5_encoder(seed):
    """A T5-v1.1-XXL encoder at ``T5Config()`` widths, built in bf16 on the
    card (4.76 B parameters, 9.5 GB) and filled from a generator on the
    card at T5's own initial scales (its attention is unscaled, so the
    query carries the 1/√(d_model·d_kv)): q N(0, 1/(d_model·d_kv)), k, v
    and the feed-forward inputs N(0, 1/d_model), o N(0, 1/(heads·d_kv)),
    wo N(0, 1/d_ff), the relative-position bias N(0, 1/d_model), the token
    embedding N(0, 1), RMSNorm scales 1 + N(0, 0.05²)."""
    from followyourclick_tpu_torch.models.t5_text import (
        T5Config,
        T5EncoderModel,
    )

    cfg = T5Config()
    inner = cfg.num_heads * cfg.d_kv
    std = {"q": (cfg.d_model * cfg.d_kv) ** -0.5, "k": cfg.d_model ** -0.5,
           "v": cfg.d_model ** -0.5, "o": inner ** -0.5,
           "wi_0": cfg.d_model ** -0.5, "wi_1": cfg.d_model ** -0.5,
           "wo": cfg.d_ff ** -0.5,
           "relative_attention_bias": cfg.d_model ** -0.5, "shared": 1.0}
    with torch.device("meta"):
        model = T5EncoderModel(cfg).to(torch.bfloat16)
    model = model.to_empty(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    with torch.no_grad():
        for name, p in model.named_parameters():
            layer = name.split(".")[-2]
            if layer in std:
                p.normal_(0.0, std[layer], generator=gen)
            else:  # ln1, ln2, final_layer_norm
                p.normal_(1.0, 0.05, generator=gen)
    return model


def phase_evaluation(pipe, seed):
    """Two bf16 UNet evaluations at 16 f / 512² on the full CFG batch,
    each held by :func:`evaluation`: on the exact sampler's path (the
    whole-block motion kernel) and on the modular motion path that a
    serving schedule's full step takes when it records temporal attention
    (``fused_temporal_block`` at C < 1280, ``temporal_attention`` at
    1280)."""
    from followyourclick_tpu_torch.models.pab import PabMode

    evaluation(pipe, seed, "exact", None)
    evaluation(pipe, seed, "modular", PabMode(record_temporal=True))


def evaluation(pipe, seed, label, mode, camera=None, t5_states=None,
               want_launches=None):
    """One bf16 UNet evaluation at 16 f / 512² under the PAB ``mode`` (the
    latents and their 5 condition channels, the doubled context; with a
    mode the latents are doubled first, as the sampler's full steps do),
    through the kernels, then with every routed wrapper replaced by its
    plain version in the model modules, then that again with the UNet in
    fp32 (cast there and back, which bf16 weights survive exactly). The
    kernels' noise prediction must lie within ``EVAL_NORM_MAX`` and
    ``EVAL_REL_L2`` of the plain bf16 one, and no farther from the fp32 one
    than ``EVAL_FP32_RATIO`` times the plain bf16 one's distance; the
    kernels' launches must be those :func:`expected_launches` gives for
    one full step under ``mode``. Prints the bf16 evaluations' times (CUDA
    events). ``camera``: the camera-motion type of a UNet with that
    embedding; ``t5_states``: the T5 states ``[uncond; cond]`` of a UNet
    with the T5 cross-attention; ``want_launches``: launch counts worked
    out by hand, which ``expected_launches`` must give too. Returns the
    kernels' launches."""
    from followyourclick_tpu_torch.models.unet3d import UNetConditioning
    from followyourclick_tpu_torch.pipelines.animation import (
        PlanStep,
        SampleSpec,
    )

    spec = SampleSpec(num_inference_steps=1)
    cfg = pipe.config.unet
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    x = randn(gen, (1, spec.video_length, spec.height // 8, spec.width // 8,
                    cfg.conv_in_channels), 1.0, pipe.dtype)
    context = randn(gen, (2, TEXT_KEYS, cfg.cross_attention_dim), 1.0,
                    pipe.dtype)
    if mode is not None:
        x = torch.cat([x, x])
    t = torch.tensor([501], device="cuda").expand(x.shape[0])
    wrappers = {**kernel_wrappers(), **unrouted_wrappers()}
    tag = f"[evaluation, {label}]"

    def evaluate(dtype=pipe.dtype):
        cond = UNetConditioning(
            context=context.to(dtype),
            fps=torch.tensor([8.0], device="cuda"),
            motion_score=torch.tensor([20.0], device="cuda"),
            camera_motion_type=(None if camera is None else
                                torch.tensor([float(camera)], device="cuda")),
            context_t5=None if t5_states is None else t5_states.to(dtype))
        with torch.inference_mode():
            return pipe.unet(x.to(dtype), t, cond, mode, {})

    def launched(run):
        for fn in wrappers.values():
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out.float(), {name: fn.launches
                             for name, fn in wrappers.items()}

    def rel(a, b):
        d = a - b
        return (float(d.abs().max() / b.abs().max()),
                float(d.norm() / b.norm()))

    expected = expected_launches(pipe.unet, spec, pipe.dtype,
                                 plan=[PlanStep(0, 0, True, mode)])
    if want_launches is not None and expected != want_launches:
        raise SystemExit(f"evaluation, {label}: step_plan gives {expected} "
                         f"launches, the hand count {want_launches}")
    want_launches = {**dict.fromkeys(wrappers, 0), **expected}
    got, counts = launched(evaluate)
    kernel_ms = time_ms(evaluate, reps=3)
    plain = plain_versions()
    with wrappers_replaced(lambda name, _: plain[name]):
        want, plain_counts = launched(evaluate)
        plain_ms = time_ms(evaluate, reps=3)
        pipe.unet.float()
        try:
            fp32, fp32_counts = launched(lambda: evaluate(torch.float32))
        finally:
            pipe.unet.to(pipe.dtype)
    norm_max, rel_l2 = rel(got, want)
    got_32, want_32 = rel(got, fp32)[1], rel(want, fp32)[1]
    # what each wrapper alone moves: the kernels with only it swapped
    for only in [n for n, c in counts.items() if c and n in plain]:
        with wrappers_replaced(lambda name, fn: plain[name]
                               if name == only else fn):
            moved = rel(evaluate().float(), got)[1]
        log(f"{tag} {only} alone on its plain version moves the "
            f"noise prediction by relative L2 {moved:.3e}")
    log(f"{tag} one UNet evaluation, noise prediction "
        f"{tuple(got.shape)}: kernels {kernel_ms:.1f} ms (launches "
        f"{counts}), plain versions {plain_ms:.1f} ms; kernels vs plain: "
        f"normalised max error {norm_max:.3e} (limit {EVAL_NORM_MAX}), "
        f"relative L2 {rel_l2:.3e} (limit {EVAL_REL_L2}); relative L2 to "
        f"the fp32 evaluation: kernels {got_32:.3e}, plain bf16 "
        f"{want_32:.3e} (limit {EVAL_FP32_RATIO} x the plain's)")
    shape = (2, spec.video_length, spec.height // 8, spec.width // 8, 4)
    if counts != want_launches or any(plain_counts.values()) \
            or any(fp32_counts.values()):
        raise SystemExit(f"evaluation, {label}: launches {counts} (want "
                         f"{want_launches}), with the plain versions "
                         f"{plain_counts} and {fp32_counts} (want none)")
    if got.shape != shape or not bool(torch.isfinite(got).all()) \
            or float(want.std()) <= 0.0:
        raise SystemExit(f"evaluation, {label}: the noise prediction is "
                         "not finite and non-constant of the expected shape")
    if norm_max > EVAL_NORM_MAX or rel_l2 > EVAL_REL_L2 \
            or got_32 > EVAL_FP32_RATIO * want_32:
        raise SystemExit(f"evaluation, {label}: the kernels' noise "
                         "prediction disagrees with the plain versions'")
    return counts


def run_request(pipe, spec, label, seed, by_hand=None, batch=1,
                generator=None, kernels=True, **extra):
    """One full-width request of ``batch`` clips (``make_request`` from
    ``seed``, then ``extra`` keyword arguments of ``sample``) with every
    launch count set to 0 before and read after: each routed kernel's must
    equal what :func:`expected_launches` gives for the request, and that
    must equal ``by_hand`` where it is given; the unrouted kernels' must be
    0. With ``kernels=False`` every routed wrapper is replaced by its plain
    version (:func:`wrappers_replaced`) and no kernel may launch. Every clip must be finite and non-constant, and the clips of a
    request must differ. Logs time, launches, video statistics per clip
    and peak memory. Returns the launches by kernel, the video and the
    seconds."""
    wrappers = kernel_wrappers()
    unrouted = unrouted_wrappers()
    want = expected_launches(pipe.unet, spec, pipe.dtype, batch)
    if by_hand is not None and want != by_hand:
        raise SystemExit(f"{label}: step_plan gives {want} launches, the "
                         f"hand count {by_hand}")
    plain = plain_versions()
    if not kernels:
        want = dict.fromkeys(want, 0)
    torch.cuda.reset_peak_memory_stats()
    for fn in (*wrappers.values(), *unrouted.values()):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode(), (
            contextlib.nullcontext() if kernels else
            wrappers_replaced(lambda name, _: plain[name])):
        req = {**make_request(pipe, spec, seed,
                              pipe.config.clip_text.vocab_size, batch),
               **extra}
        video = pipe.sample(spec=spec, generator=generator, **req)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {name: fn.launches for name, fn in wrappers.items()}
    off_path = {name: fn.launches for name, fn in unrouted.items()}
    v = video.float()
    log(f"[{label}] {dt:.2f} s for {batch} clip(s), video {tuple(v.shape)}; "
        f"launches {got} (want {want}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for i, clip in enumerate(v):
        log(f"[{label}]   clip {i}: min {float(clip.min()):.4f} max "
            f"{float(clip.max()):.4f} mean {float(clip.mean()):.4f} std "
            f"{float(clip.std()):.4f}")
    if got != want or any(off_path.values()):
        raise SystemExit(f"{label}: the kernels were not launched the "
                         "number of times the step plan gives (the "
                         f"unrouted ones: {off_path})")
    shape = (batch, spec.video_length, spec.height, spec.width, 3)
    if v.shape != shape or not bool(torch.isfinite(v).all()) \
            or min(float(clip.std()) for clip in v) <= 0.0:
        raise SystemExit(f"{label}: a clip is not finite and non-constant")
    for i in range(1, batch):
        if float((v[i] - v[0]).abs().mean()) <= 0.0:
            raise SystemExit(f"{label}: two clips of one request are the "
                             "same video")
    return {**got, **off_path}, v, dt


def phase_requests(pipe, spec, label, seed, by_hand=None, batch=1):
    """Two full-width requests of ``batch`` clips on one path, each held by
    :func:`run_request`; the two must differ. Returns the path's launches
    by kernel and the seconds per request."""
    total = dict.fromkeys({**KERNELS, **UNROUTED}, 0)
    videos, seconds = [], []
    for r in range(2):
        got, v, dt = run_request(pipe, spec, f"{label}, request {r}",
                                 seed + 100 + r, by_hand, batch)
        for name, n in got.items():
            total[name] += n
        videos.append(v)
        seconds.append(dt)
    diff = float((videos[0] - videos[1]).abs().mean())
    log(f"[{label}] mean |request 0 - request 1| = {diff:.4f}")
    if diff <= 0.0:
        raise SystemExit(f"{label}: two different requests gave the same "
                         "video")
    return total, seconds


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_sampler_options(pipe, seed):
    """One-clip full-width requests for every other option of the sampler,
    each run twice (cold, then warm) and held by :func:`run_request`: every
    solver but DDIM at ``SOLVER_STEPS`` (Euler-A drawing its noise from a
    seeded generator), DDIM at ``eta = 1``, no CFG, the unshared CFG prefix,
    ``video_scale = 1.5`` (20 motion-block calls a step at F = 1 on top of
    the 20 at 16 frames), and the init image with residual noise and a
    partial mask. The unshared prefix is held to the shared-prefix request
    with the same noise (``UNSHARED_SPREAD_RATIO``); then the chunked decode
    (``frame_chunk = 4``) of seeded latents against their one-batch decode.
    Returns the launches by path."""
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.schedulers.dispatch import SCHEDULERS

    base = SampleSpec(num_inference_steps=SOLVER_STEPS)
    n = SOLVER_STEPS
    per_call = {"fused_motion_block": 20, "fused_ln_geglu": 16,
                "fused_temporal_block": 0, "temporal_attention": 0,
                "flash_attention": 0}
    calls = {"pndm": n + 1, "pndm_prk": n + 9}
    h, w = base.height // 8, base.width // 8
    partial = (torch.rand(1, h, w, 1, generator=torch.Generator()
                          .manual_seed(seed + 9)) > 0.3).float()
    options = [(f"solver_{name}", dataclasses.replace(base, scheduler=name),
                {kk: v * calls.get(name, n) for kk, v in per_call.items()})
               for name in SCHEDULERS[1:]]
    options += [
        ("ddim_eta1", dataclasses.replace(base, eta=1.0), None),
        ("no_cfg", dataclasses.replace(base, guidance_scale=1.0), None),
        ("unshared_prefix", dataclasses.replace(base, share_cfg_prefix=False),
         None),
        ("video_scale", dataclasses.replace(base, video_scale=1.5),
         {kk: 2 * v * n for kk, v in per_call.items()}),
        ("init_residual_partial", dataclasses.replace(
            base, use_first_image_as_init_latents=True,
            use_residual_noise=True), None)]
    paths = {}
    for name, spec, by_hand in options:
        extra = ({"partial_mask": partial}
                 if name == "init_residual_partial" else {})
        # twice: the first request of a new batch layout warms it up
        for r in ("cold", "warm"):
            gen = torch.Generator(device="cuda").manual_seed(seed + 7)
            got, video, _ = run_request(
                pipe, spec, f"{name}, {r}", seed + 200, by_hand,
                generator=gen, **extra)
            paths[name] = {k: paths.get(name, {}).get(k, 0) + v
                           for k, v in got.items()}
        if name == "unshared_prefix":
            unshared = video
        del video
    _, shared, _ = run_request(pipe, base, "shared prefix", seed + 200)
    _, shared_plain, _ = run_request(pipe, base,
                                     "shared prefix, plain versions",
                                     seed + 200, kernels=False)
    spread = rel_l2(shared, shared_plain)
    err = rel_l2(unshared, shared)
    log(f"[unshared prefix] against the shared-prefix request: relative L2 "
        f"{err:.3e}, max abs {float((unshared - shared).abs().max()):.3e}; "
        f"the shared request through the kernels against their plain "
        f"versions: {spread:.3e} (limit {UNSHARED_SPREAD_RATIO} x that)")
    if err > UNSHARED_SPREAD_RATIO * spread:
        raise SystemExit("the unshared CFG prefix disagrees with the shared")
    latents = randn(torch.Generator(device="cuda").manual_seed(seed + 11),
                    (1, base.video_length, h, w, 4), 1.0, pipe.dtype)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        whole = pipe.decode_latents(latents)
        chunked = pipe.decode_latents(latents, frame_chunk=4)
        whole_ms = time_ms(lambda: pipe.decode_latents(latents), reps=3)
        chunked_ms = time_ms(lambda: pipe.decode_latents(
            latents, frame_chunk=4), reps=3)
    err = rel_l2(chunked, whole)
    log(f"[decode] frame_chunk=4: {chunked_ms:.1f} ms against one batch "
        f"{whole_ms:.1f} ms (16 frames, 512², bf16); relative L2 {err:.3e}, "
        f"max abs {float((chunked - whole).abs().max()):.3e} (limit "
        f"{EVAL_REL_L2}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if chunked.shape != whole.shape or err > EVAL_REL_L2:
        raise SystemExit("the chunked decode disagrees with the one-batch "
                         "decode")
    return paths


def phase_camera(seed, spec, by_hand):
    """BASELINE config 4 at full width: the default widths with the
    camera-motion embedding (unzeroed), one bf16 UNet evaluation that
    builds the motion modules' ``[Wq; Wk; Wv]`` caches, then a merged
    synthetic motion LoRA (:func:`motion_lora`) and phase 4's check of the
    merged UNet (a kernel reading a stale cache fails it), then two
    one-clip requests on ``spec`` that differ only in the camera type.
    Returns the path's launches."""
    from followyourclick_tpu_torch.data.camera_motion import MOTION_TYPES
    from followyourclick_tpu_torch.models.motion_module import (
        TemporalAttention,
    )
    from followyourclick_tpu_torch.models.unet3d import UNetConditioning
    from followyourclick_tpu_torch.utils.lora import merge_motion_lora

    pipe = full_pipeline(seed, camera=True)
    cfg = pipe.config.unet
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    x = randn(gen, (1, spec.video_length, spec.height // 8, spec.width // 8,
                    cfg.conv_in_channels), 1.0, pipe.dtype)
    context = randn(gen, (2, TEXT_KEYS, cfg.cross_attention_dim), 1.0,
                    pipe.dtype)
    cond = UNetConditioning(context, torch.tensor([8.0], device="cuda"),
                            torch.tensor([20.0], device="cuda"),
                            torch.tensor([4.0], device="cuda"))
    t = torch.tensor([501], device="cuda")
    with torch.inference_mode():
        pipe.unet(x, t, cond)
    attns = [m for m in pipe.unet.modules()
             if isinstance(m, TemporalAttention)]
    stale = [a.qkv_weight() for a in attns]
    lora = motion_lora(pipe.unet, CAMERA_LORA_RANK,
                       torch.Generator().manual_seed(seed + 4))
    t0 = time.perf_counter()
    merge_motion_lora(pipe.unet, lora)
    torch.cuda.synchronize()
    log(f"[camera lora] merged a rank-{CAMERA_LORA_RANK} motion LoRA ("
        f"{len(lora) // 2} pairs over {len(attns)} temporal attentions) in "
        f"{time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        rebuilt = [a.qkv_weight() for a in attns]
        stale_left = sum(
            new is old or not torch.equal(new, torch.cat(
                [a.to_q.weight, a.to_k.weight, a.to_v.weight]))
            for a, new, old in zip(attns, rebuilt, stale))
    log(f"[camera lora] [Wq; Wk; Wv] caches rebuilt after the merge: "
        f"{len(attns) - stale_left} of {len(attns)}")
    if stale_left:
        raise SystemExit("camera lora: a [Wq; Wk; Wv] cache kept the "
                         "unmerged weights")
    evaluation(pipe, seed, "camera LoRA", None, camera=4)
    total = dict.fromkeys({**KERNELS, **UNROUTED}, 0)
    videos = []
    for cam in CAMERA_TYPES:
        got, v, _ = run_request(
            pipe, spec, f"camera lora, {MOTION_TYPES[cam]}", seed + 300,
            by_hand, camera_motion_type=torch.tensor([float(cam)]))
        for name, n in got.items():
            total[name] += n
        videos.append(v)
    diff = float((videos[0] - videos[1]).abs().mean())
    log(f"[camera lora] mean |{MOTION_TYPES[CAMERA_TYPES[0]]} - "
        f"{MOTION_TYPES[CAMERA_TYPES[1]]}| = {diff:.4f}")
    if diff <= 0.0:
        raise SystemExit("camera lora: two camera types gave the same video")
    return total


def phase_ip(seed, spec, by_hand):
    """IP-Adapter Plus at full width: the ip encode alone (tower and
    Resampler over the condition image and the black one) by CUDA events,
    then two one-clip requests on ``spec``. Returns the path's launches."""
    pipe = full_pipeline(seed, ip_plus=True)
    size = pipe.ip_adapter.image_encoder.config.image_size
    pixels = torch.randn(1, size, size, 3,
                         generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        tokens = pipe.encode_image_prompt(pixels)
        encode_ms = time_ms(lambda: pipe.encode_image_prompt(pixels))
    if tokens.shape != (2, IP_TOKENS, pipe.config.unet.cross_attention_dim) \
            or not bool(torch.isfinite(tokens).all()):
        raise SystemExit(f"ip encode: tokens {tuple(tokens.shape)} not "
                         "finite of the expected shape")
    log(f"[ip plus] encode (ViT-H/14 tower and Resampler, condition and "
        f"black image): {encode_ms:.3f} ms; tokens {tuple(tokens.shape)}")
    launches, _ = phase_requests(pipe, spec, "ip plus", seed, by_hand)
    return launches


def phase_t5(seed, spec, by_hand, serving, root):
    """The T5 second text tower at full width: the default widths with the
    T5 cross-attention (its zero-initialised projection given weights) and
    a T5-v1.1-XXL encoder, bf16. The T5 encode alone (two passes, cond and
    uncond) by CUDA events beside its bound (each weight read once a pass),
    and against the same encode in fp32 (the encoder cast there and back),
    each RMSNorm against its formula in fp64, and both checks against their
    controls (:func:`rmsnorm_in_input_dtype` before the requests,
    :func:`fan_in_init_` after them), which must fail; phase 4's evaluation
    check with the T5 states; one exact request cold and warm; one request
    under ``serving`` (its cross sites counted in a recording evaluation:
    ``attn_t5_out`` beside ``attn2_out``). The encode is also timed on the
    device alone (:func:`graph_ms`). Then the pipeline takes the tiny T5
    ``tokenizer.json`` (:func:`write_t5_tokenizer`) and a CLIP tokenizer
    from ``merges.txt``, both written under ``root``, and one exact request
    with ``T5_TEXT_PROMPT`` as text through ``__call__`` must equal the same
    ids through ``sample`` (:func:`text_request`). Returns the launches by
    path."""
    from followyourclick_tpu_torch.models.pab import PabMode
    from followyourclick_tpu_torch.models.unet3d import UNetConditioning

    pipe = full_pipeline(seed, t5=True)
    t5 = pipe.t5
    n_params = sum(p.numel() for p in t5.parameters())
    with torch.inference_mode():
        req = make_request(pipe, spec, seed + 400, 1000)
        args = [req[k].cuda() for k in ("t5_input_ids", "t5_attention_mask",
                                        "t5_neg_input_ids",
                                        "t5_neg_attention_mask")]
        torch.cuda.reset_peak_memory_stats()
        states = pipe.encode_prompt_t5(*args)
        encode_ms = time_ms(lambda: pipe.encode_prompt_t5(*args))
        device_ms = graph_ms(lambda: pipe.encode_prompt_t5(*args), reps=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fp32 = t5_fp32(pipe, args)
    norm_max, rel = t5_drift(states, fp32)
    shape = (2, T5_TOKENS, t5.config.d_model)
    norm_err = t5_norm_error(t5, lambda: pipe.encode_prompt_t5(*args))
    with rmsnorm_in_input_dtype():
        norm_control = t5_norm_error(t5, lambda: pipe.encode_prompt_t5(*args))
        with torch.inference_mode():
            rel_control = t5_drift(pipe.encode_prompt_t5(*args), fp32)[1]
    tokens = args[0].numel()
    ops_ms, bytes_ms = bound_times(2 * 2 * n_params * tokens,
                                   list(t5.parameters()) * 2)
    log(f"[t5] encode [uncond; cond] {tuple(states.shape)}: {encode_ms:.3f} "
        f"ms for two passes, {device_ms:.3f} ms of it on the device (CUDA "
        f"graph of 3 encodes) (bound {max(ops_ms, bytes_ms):.3f} ms: bytes "
        f"{bytes_ms:.3f}, operations {ops_ms:.3f}; {n_params / 1e9:.3f} B "
        f"parameters); peak device memory {peak:.2f} GiB; bf16 against fp32: "
        f"normalised max error {norm_max:.3e}, relative L2 {rel:.3e} (limit "
        f"{T5_BF16_REL_L2}); RMSNorm against fp64: relative L2 {norm_err:.3e}"
        f", control (RMSNorm in bf16) {norm_control:.3e} (limit "
        f"{T5_NORM_REL_L2}); the encode under that control against fp32: "
        f"relative L2 {rel_control:.3e}")
    if not t5_encode_ok(states, fp32, shape):
        raise SystemExit("t5: the bf16 encode is not finite of the expected "
                         "shape, or strays from fp32")
    if norm_err > T5_NORM_REL_L2:
        raise SystemExit("t5: an RMSNorm strays from its fp32 formula")
    if norm_control <= T5_NORM_REL_L2:
        raise SystemExit("t5: the norm check passes RMSNorm in bf16")
    paths = {"t5_evaluation": evaluation(pipe, seed, "T5", None,
                                         t5_states=states)}
    for r in ("cold", "warm"):
        got, _, _ = run_request(pipe, spec, f"t5 exact, {r}", seed + 401,
                                by_hand)
        paths["exact_t5"] = {k: paths.get("exact_t5", {}).get(k, 0) + v
                             for k, v in got.items()}
    paths["t5_text"] = t5_text_full(pipe, spec, seed + 403, root, by_hand)
    cache = {}
    x = torch.zeros(2, spec.video_length, spec.height // 8, spec.width // 8,
                    pipe.config.unet.conv_in_channels, device="cuda",
                    dtype=pipe.dtype)
    ctx = torch.zeros(2, TEXT_KEYS, 768, device="cuda", dtype=pipe.dtype)
    with torch.inference_mode():
        pipe.unet(x, torch.tensor([501, 501], device="cuda"),
                  UNetConditioning(ctx, torch.tensor([8.0], device="cuda"),
                                   torch.tensor([20.0], device="cuda"),
                                   context_t5=states),
                  PabMode(record_cross=True), cache)
    del x, ctx
    sites = collections.Counter(k.rsplit(".", 1)[-1] for k in cache)
    log(f"[t5] cross sites a recording step caches: {dict(sites)}")
    if sites != {"attn2_out": 16, "attn_t5_out": 16}:
        raise SystemExit("t5: the serving schedule's cross sites miss the "
                         "T5 cross-attention")
    del cache
    paths[f"{SERVING_SCHEDULE}_t5"], _, _ = run_request(
        pipe, serving, "t5 serving", seed + 402, SERVING_LAUNCHES)
    fan_in_init_(t5, torch.Generator(device="cuda").manual_seed(seed + 22))
    with torch.inference_mode():
        states = pipe.encode_prompt_t5(*args)
    fp32 = t5_fp32(pipe, args)
    norm_max, rel = t5_drift(states, fp32)
    log(f"[t5] control (weights N(0, 1/fan_in)): bf16 against fp32: "
        f"normalised max error {norm_max:.3e}, relative L2 {rel:.3e} (limit "
        f"{T5_BF16_REL_L2})")
    if t5_encode_ok(states, fp32, shape):
        raise SystemExit("t5: the encode check passes the fan-in control")
    return paths


def t5_text_full(pipe, spec, seed, root, by_hand):
    """Phase 11's text request at full width: ``pipe`` given the tokenizers
    a user's directories would hold (the tiny T5 ``tokenizer.json``, a CLIP
    ``merges.txt``), then :func:`text_request` on one exact request of
    :func:`make_request`'s first image, click and noise; its launches must
    be ``by_hand``. Returns them."""
    from followyourclick_tpu_torch.utils.native_tokenizer import (
        NativeCLIPTokenizer,
    )
    from followyourclick_tpu_torch.utils.t5_tokenizer import T5Tokenizer

    t5_dir = os.path.join(root, "t5_tokenizer")
    write_t5_tokenizer(t5_dir)
    merges = os.path.join(root, "merges.txt")
    with open(merges, "w") as f:
        f.write(synthetic_merges())
    pipe.tokenizer = NativeCLIPTokenizer(merges)
    pipe.tokenizer_2 = T5Tokenizer.from_pretrained(t5_dir)
    with torch.inference_mode():
        req = make_request(pipe, spec, seed,
                           pipe.config.clip_text.vocab_size)
    return text_request(pipe, spec, req["first_image_latents"], req["mask"],
                        req["noise"], "t5 text, full width", by_hand)


def t5_drift(states, fp32):
    """A T5 encode against the same encode in fp32: (normalised max error,
    relative L2)."""
    d = states.float() - fp32
    return (float(d.abs().max() / fp32.abs().max()),
            float(d.norm() / fp32.norm()))


def t5_encode_ok(states, fp32, shape):
    """Whether a bf16 T5 encode is finite, of ``shape`` and within
    ``T5_BF16_REL_L2`` of fp32."""
    return (tuple(states.shape) == tuple(shape)
            and bool(torch.isfinite(states).all())
            and t5_drift(states, fp32)[1] <= T5_BF16_REL_L2)


def t5_fp32(pipe, args):
    """The pipeline's T5 encode ``[uncond; cond]`` in fp32 (the encoder
    cast there and back)."""
    pipe.t5.float()
    try:
        with torch.inference_mode():
            return pipe.encode_prompt_t5(*args)
    finally:
        pipe.t5.to(pipe.dtype)


def t5_norm_error(t5, encode):
    """The largest relative L2, over ``t5``'s RMSNorms during one call of
    ``encode``, of a norm's output against its formula computed in fp64 on
    the same input and rounded to the output's dtype."""
    from followyourclick_tpu_torch.models.t5_text import RMSNorm

    errs = []

    def hook(module, inputs, out):
        x = inputs[0].double()
        want = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                + module.eps)
                * module.weight.double()).to(out.dtype).double()
        errs.append(float((out.double() - want).norm() / want.norm()))

    hooks = [m.register_forward_hook(hook) for m in t5.modules()
             if isinstance(m, RMSNorm)]
    try:
        with torch.inference_mode():
            encode()
    finally:
        for h in hooks:
            h.remove()
    return max(errs)


@contextlib.contextmanager
def rmsnorm_in_input_dtype():
    """The T5 phase's control for :func:`t5_norm_error`: the port's RMSNorm
    computed in its input's dtype, the drift from the fp32 design that the
    check must reject."""
    from followyourclick_tpu_torch.models.t5_text import RMSNorm

    forward = RMSNorm.forward

    def in_input_dtype(self, x):
        var = x.pow(2).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)

    RMSNorm.forward = in_input_dtype
    try:
        yield
    finally:
        RMSNorm.forward = forward


def fan_in_init_(t5, gen):
    """The T5 phase's control for :func:`t5_encode_ok`: every projection of
    ``t5`` refilled N(0, 1/fan_in) from ``gen``, which leaves the unscaled
    attention one-hot."""
    with torch.no_grad():
        for name, p in t5.named_parameters():
            if p.dim() == 2 and not name.endswith(
                    ("shared.weight", "relative_attention_bias.weight")):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)


# a tiny T5 SentencePiece vocabulary (Unigram pieces and log-probabilities):
# the special tokens at T5's ids (pad 0, eos 1, unk 2), whole words, then
# single characters, so every ASCII letter of a prompt has a piece
T5_TINY_PIECES = (
    [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    + [(w, -2.0 - 0.25 * i) for i, w in enumerate(
        ["▁a", "▁the", "▁car", "▁cat", "▁drives", "▁on", "▁road", "▁red",
         "▁sun", "▁garden", "▁blue", "▁dog", "▁runs", "▁in", "▁é"])]
    + [(c, -6.0 - 0.05 * i) for i, c in enumerate(
        ["▁", *"abcdefghijklmnopqrstuvwxyz", "é", "ü"])])
# the T5 encoder of the text request: HF config.json fields (vocab at least
# the tokenizer's)
T5_TINY_HF = {"vocab_size": 64, "d_model": 16, "d_kv": 4, "d_ff": 24,
              "num_layers": 2, "num_heads": 2,
              "feed_forward_proj": "gated-gelu"}
# the text request's prompt and the ids T5TokenizerFast (and the JAX
# package's tokenize_2) give it over T5_TINY_PIECES: held on the CPU by
# tests/test_torch_t5_tokenizer.py, on the card by text_request
T5_TEXT_PROMPT = "a red car drives on the road"
T5_TEXT_IDS = [3, 10, 5, 7, 8, 4, 9, 1]


def write_t5_tokenizer(root, pieces=T5_TINY_PIECES):
    """``tokenizer.json`` (and the ``tokenizer_config.json`` transformers
    reads) of a T5 Unigram tokenizer over ``pieces``, in the layout
    ``T5TokenizerFast.save_pretrained`` writes: NFKC, right strip and runs
    of spaces to one ``▁``, the Metaspace pre-tokenizer, the ``$A </s>``
    template."""
    os.makedirs(root, exist_ok=True)
    special = ["<pad>", "</s>", "<unk>"]
    meta = {"type": "Metaspace", "replacement": "▁",
            "prepend_scheme": "always", "split": True}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, t in enumerate(special)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFKC"},
            {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": "▁"}]},
        "pre_tokenizer": meta,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                        "tokens": ["</s>"]}}},
        "decoder": meta,
        "model": {"type": "Unigram", "unk_id": 2,
                  "vocab": [[p, s] for p, s in pieces],
                  "byte_fallback": False}}
    with open(os.path.join(root, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(root, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "T5TokenizerFast", "eos_token": "</s>",
                   "unk_token": "<unk>", "pad_token": "<pad>",
                   "extra_ids": 0, "model_max_length": 512}, f)


def write_t5_directory(root, seed, device="cuda"):
    """A tiny T5 encoder directory as a user would download one:
    ``config.json`` (``T5_TINY_HF``), ``model.safetensors`` (seeded weights
    in the HF names) and the tokenizer of :func:`write_t5_tokenizer`."""
    hf = T5_TINY_HF
    d, kv, ff, heads = hf["d_model"], hf["d_kv"], hf["d_ff"], hf["num_heads"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)
                ).cpu()

    state = {"shared.weight": w(hf["vocab_size"], d),
             "encoder.final_layer_norm.weight": 1 + w(d, scale=0.05),
             "encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
             "weight": w(32, heads)}
    state["encoder.embed_tokens.weight"] = state["shared.weight"]
    for i in range(hf["num_layers"]):
        p = f"encoder.block.{i}.layer"
        for n in "qkv":
            state[f"{p}.0.SelfAttention.{n}.weight"] = w(heads * kv, d,
                                                         scale=d ** -0.5)
        state[f"{p}.0.SelfAttention.o.weight"] = w(d, heads * kv,
                                                   scale=(heads * kv) ** -0.5)
        state[f"{p}.0.layer_norm.weight"] = 1 + w(d, scale=0.05)
        for n in ("wi_0", "wi_1"):
            state[f"{p}.1.DenseReluDense.{n}.weight"] = w(ff, d,
                                                          scale=d ** -0.5)
        state[f"{p}.1.DenseReluDense.wo.weight"] = w(d, ff, scale=ff ** -0.5)
        state[f"{p}.1.layer_norm.weight"] = 1 + w(d, scale=0.05)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(hf, f)
    write_safetensors(os.path.join(root, "model.safetensors"),
                      {k: v.contiguous() for k, v in state.items()})
    write_t5_tokenizer(root)


def phase_t5_text(seed, root, device="cuda"):
    """Phase 11's text request: a tiny SD-1.5 directory
    (:func:`tiny_config` with the T5 cross-attention,
    :func:`write_sd_directory`) and a tiny T5 directory with its
    ``tokenizer.json`` (:func:`write_t5_directory`) through
    ``assemble_pipeline_from_pretrained(t5_path=...)`` in fp32 on
    ``device``; ``tokenize_2`` of ``T5_TEXT_PROMPT`` must give
    ``T5_TEXT_IDS`` and a request with the prompt as text through
    ``__call__`` must equal the same ids through ``sample``
    (:func:`text_request`). Returns the text request's launches."""
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.utils.loaders import (
        assemble_pipeline_from_pretrained,
    )
    from followyourclick_tpu_torch.utils.t5_tokenizer import T5Tokenizer

    base = tiny_config()
    cfg = dataclasses.replace(base, unet=dataclasses.replace(
        base.unet, use_text_encoder_2=True,
        text_encoder_2_dim=T5_TINY_HF["d_model"]))
    sd, t5_dir = os.path.join(root, "sd_tiny"), os.path.join(root, "t5_tiny")
    _, mm = write_sd_directory(sd, base, seed, device, torch.float32)
    write_t5_directory(t5_dir, seed, device)
    pipe = assemble_pipeline_from_pretrained(
        sd, cfg, motion_module_path=mm, t5_path=t5_dir,
        dtype=torch.float32, device=device)
    if not isinstance(pipe.tokenizer_2, T5Tokenizer):
        raise SystemExit("t5 text: the loader built no T5 tokenizer")
    unzero_(pipe.unet, torch.Generator(device=device).manual_seed(seed))
    spec = SampleSpec(video_length=4, height=64, width=64,
                      num_inference_steps=2)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    latents = torch.randn(1, 8, 8, 4, generator=gen, device=device)
    click = (torch.rand(1, 8, 8, 1, generator=gen, device=device) > 0.5
             ).float()
    noise = torch.randn(1, 4, 8, 8, 4, generator=gen, device=device)
    return text_request(pipe, spec, latents, click, noise, "t5 text, tiny")


def text_request(pipe, spec, latents, click, noise, label, want=None):
    """``T5_TEXT_PROMPT`` (negative ``""``) as text through ``pipe``'s
    ``__call__`` against the same request through ``sample`` with the ids
    its tokenizers give (the same noise, fps and motion score): the T5 ids
    must be ``T5_TEXT_IDS``, the two videos equal, finite and of ``spec``'s
    shape, and a request whose T5 ids alone differ must differ. With
    ``want``, the text request's launches must equal it. Returns the text
    request's launches by kernel."""
    ids, mask, neg, neg_mask = pipe.tokenize_2([T5_TEXT_PROMPT], [""])
    n = len(T5_TEXT_IDS)
    if ids[0, :n].tolist() != T5_TEXT_IDS or ids[0, n:].any() \
            or mask[0].sum() != n or neg[0, 0] != 1 or neg_mask[0].sum() != 1:
        raise SystemExit(f"{label}: tokenize_2 gave {ids[0, :n + 2]}")
    wrappers = launches_zeroed()
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = pipe(T5_TEXT_PROMPT, "", spec, latents, click, noise=noise)
    dt = time.perf_counter() - t0
    got = {name: fn.launches for name, fn in wrappers.items()}
    clip_ids, clip_neg = pipe.tokenize([T5_TEXT_PROMPT], [""])
    ucfg = pipe.config.unet

    def by_ids(t5_ids):
        cond = (lambda v: torch.tensor([v]) if ucfg.use_fps_condition
                else None)
        return pipe.sample(
            torch.from_numpy(clip_ids), torch.from_numpy(clip_neg), latents,
            click, cond(8.0), cond(20.0), spec, noise=noise,
            t5_input_ids=torch.from_numpy(t5_ids),
            t5_attention_mask=torch.from_numpy(mask),
            t5_neg_input_ids=torch.from_numpy(neg),
            t5_neg_attention_mask=torch.from_numpy(neg_mask)).cpu().numpy()

    same = float(np.abs(text - by_ids(ids)).max())
    other = ids.copy()
    other[0, :n - 1] = other[0, 1:n][::-1]
    moved = float(np.abs(text - by_ids(other)).max())
    shape = (1, spec.video_length, spec.height, spec.width, 3)
    log(f"[{label}] text request through the T5 tokenizer "
        f"({T5_TEXT_PROMPT!r} → {T5_TEXT_IDS}): video "
        f"{tuple(text.shape)} in {dt:.2f} s, max |text − ids| {same:.3e}, "
        f"with other T5 ids {moved:.3e}; launches {got}"
        + ("" if want is None else f" (want {want})"))
    if text.shape != shape or not np.isfinite(text).all() \
            or same > 0 or moved == 0:
        raise SystemExit(f"{label}: the text request differs from the ids "
                         "request, or the T5 ids do not reach the video")
    if want is not None and {k: got[k] for k in want} != want:
        raise SystemExit(f"{label}: launches {got}, want {want}")
    return got


def phase_routes(seed):
    """One full-width bf16 UNet evaluation with the options that change
    routes (:func:`routes_unet`: cross-frame and in-block temporal
    attention, motion modules with RoPE and temporal LoRA, the LoRA ``up``
    given weights), held by :func:`evaluation` to its plain versions and
    fp32 and to ``ROUTES_LAUNCHES``. Returns its launches."""
    pipe = full_pipeline(seed, routes=True)
    return evaluation(pipe, seed, "routes", None,
                      want_launches=ROUTES_LAUNCHES)


# ---------------------------------------------------------------------------
# Phase 13: the click-to-video CLI from checkpoint files
# ---------------------------------------------------------------------------

# the reference's list modules, whose flax name folds the index in
_LIST_SEGMENT = re.compile(
    r"^(down_blocks|up_blocks|resnets|attentions|motion_modules|"
    r"transformer_blocks|attention_blocks|norms|downsamplers|upsamplers)"
    r"_(\d+)$")
# reference convs the JAX package wraps with an inner "conv"
_INFLATED = ("conv_in", "conv_out", "conv1", "conv2", "conv_shortcut")
# the CLI phase's manifest (two rows, no images: the T2I makes each first
# frame) and the T2I's fixed request (the JAX CLI's: 50 steps, CFG 8)
CLI_PROMPTS = ("a red car drives along a coastal road",
               "a cat sleeps in a sunny garden")
T2I_STEPS = 50
# a T2I step's launches by hand: the 16 spatial transformer blocks' LN-GEGLU
# (no motion module, no flash at one frame)
T2I_LAUNCHES_PER_STEP = {"fused_ln_geglu": 16}
# a loaded tensor is sampled every CLI_SAMPLE_EVERY-th parameter
CLI_SAMPLE_EVERY = 97
# the T2I pipeline shares the video UNet's tensors: its construction may
# allocate no more than this (a copy of the 2D UNet is 1.6 GiB in bf16)
T2I_MAX_NEW_BYTES = 64 * 2 ** 20


def _flat(tree):
    """A nested tree → ``{path tuple: leaf}``."""
    from followyourclick_tpu_torch.utils.convert import _flatten

    return _flatten(tree)


def _reference_leaf(leaf, value):
    """A flax leaf → (reference leaf name, reference layout): kernels back
    to ``(out, in)``, conv1d ``(out, in, k)`` and conv2d ``OIHW``; a norm's
    ``scale`` and an embedding are ``weight``."""
    if leaf == "kernel":
        perm = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[value.ndim]
        return "weight", value.permute(*perm) if hasattr(value, "permute") \
            else value.transpose(*perm)
    if leaf in ("scale", "embedding"):
        return "weight", value
    return leaf, value


def unet_state_from_tree(tree):
    """The inverse of ``convert_unet3d_state_dict``: a UNet flax tree → the
    reference's (diffusers / AnimateDiff) state dict, names and layouts:
    list indices unfolded, an inflated conv's inner ``conv`` dropped, the
    motion module's ``temporal_transformer`` level put back, ``to_out.0``,
    ``ff.net.0.proj`` and ``ff.net.2``."""
    out = {}
    for path, value in _flat(tree).items():
        segs = list(path[:-1])
        if len(segs) >= 2 and segs[-1] == "conv" and segs[-2] in _INFLATED:
            segs.pop()
        names = []
        for seg in segs:
            m = _LIST_SEGMENT.match(seg)
            names += [m.group(1), m.group(2)] if m else [seg]
            if m and m.group(1) == "motion_modules":
                names.append("temporal_transformer")
        name = ".".join(names)
        name = re.sub(r"\.to_out$", ".to_out.0", name)
        name = re.sub(r"\.ff\.proj$", ".ff.net.0.proj", name)
        name = re.sub(r"\.ff\.out$", ".ff.net.2", name)
        leaf, ref = _reference_leaf(path[-1], value)
        out[f"{name}.{leaf}"] = ref
    return out


def vae_state_from_tree(tree):
    """The inverse of ``convert_vae_state_dict``: a VAE flax tree → the
    diffusers ``AutoencoderKL`` state dict (attention q/k/v/out as linear
    ``query`` / ``key`` / ``value`` / ``proj_attn``)."""
    out = {}
    for path, value in _flat(tree).items():
        name = ".".join(path[:-1])
        name = re.sub(r"down_(\d+)_resnet_(\d+)", r"down_blocks.\1.resnets.\2",
                      name)
        name = re.sub(r"down_(\d+)_downsample",
                      r"down_blocks.\1.downsamplers.0.conv", name)
        name = re.sub(r"up_(\d+)_resnet_(\d+)", r"up_blocks.\1.resnets.\2",
                      name)
        name = re.sub(r"up_(\d+)_upsample", r"up_blocks.\1.upsamplers.0.conv",
                      name)
        name = re.sub(r"mid_resnet_(\d+)",
                      lambda m: f"mid_block.resnets.{int(m.group(1)) - 1}",
                      name)
        name = name.replace("mid_attn_1", "mid_block.attentions.0")
        leaf, ref = _reference_leaf(path[-1], value)
        out[f"{name}.{leaf}"] = ref
    return out


def clip_state_from_tree(tree):
    """The inverse of ``convert_clip_text_state_dict``: a CLIP text flax
    tree → the HF ``CLIPTextModel`` state dict."""
    out = {}
    for path, value in _flat(tree).items():
        name = ".".join(path[:-1])
        name = re.sub(r"^layers_(\d+)", r"encoder.layers.\1", name)
        name = re.sub(r"^(token|position)_embedding$",
                      r"embeddings.\1_embedding", name)
        name = name.replace("mlp_fc1", "mlp.fc1").replace("mlp_fc2",
                                                          "mlp.fc2")
        leaf, ref = _reference_leaf(path[-1], value)
        out[f"text_model.{name}.{leaf}"] = ref
    return out


_SAFETENSORS_NAMES = {torch.float32: "F32", torch.float16: "F16",
                      torch.bfloat16: "BF16", torch.int64: "I64",
                      torch.int32: "I32", torch.uint8: "U8"}


def write_safetensors(path, tensors):
    """``{name: CPU tensor}`` → a ``.safetensors`` file: the 8-byte
    little-endian header length, the JSON header (padded with spaces to 8
    bytes), then each tensor's bytes in header order."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            raw = t.contiguous()
            if raw.dtype == torch.bfloat16:
                raw = raw.view(torch.int16)
            f.write(memoryview(raw.numpy()).cast("B"))


def synthetic_merges(words=("car", "cat", "road", "garden", "the", "sun")):
    """BPE merges that compose each of ``words`` from its characters (a
    ``merges.txt`` body; the repository ships no CLIP vocabulary)."""
    merges = []
    for w in words:
        cur = w[0]
        for i, ch in enumerate(w[1:], 1):
            nxt = ch + ("</w>" if i == len(w) - 1 else "")
            pair = f"{cur} {nxt}"
            if pair not in merges:
                merges.append(pair)
            cur += nxt
    return "#version: 0.2\n" + "\n".join(merges) + "\n"


def random_flax_tree(module, gen):
    """Seeded random values for ``module``'s flax tree (its
    ``module_tree`` shapes), on the generator's device: kernels N(0,
    1/fan_in), norm scales 1 + N(0, 0.05²), biases and embeddings N(0,
    0.02²). The spatial transformers' ``proj_in`` / ``proj_out`` get the
    JAX ``Conv1x1`` kernel ``(1, 1, in, out)``, as an SD-1.5 file holds
    them (1×1 convs)."""
    from followyourclick_tpu_torch.utils.convert import _set, module_tree

    tree = {}
    for path, slot in _flat(module_tree(module)).items():
        shape = slot.shape
        z = torch.randn(shape, generator=gen, device=gen.device)
        if path[-1] == "kernel":
            z = z / float(np.prod(shape[:-1])) ** 0.5
            if (len(path) >= 3 and path[-2] in ("proj_in", "proj_out")
                    and path[-3].startswith("attentions_")
                    and len(shape) == 2):
                z = z.reshape(1, 1, *shape)
        elif path[-1] == "scale":
            z = 1.0 + 0.05 * z
        else:
            z = 0.02 * z
        _set(tree, path, z)
    return tree


def write_sd_directory(root, cfg, seed, device="cuda", dtype=torch.float16):
    """An SD-1.5 directory at ``cfg``'s widths with seeded random weights,
    as a user would download it, and the click-to-video motion module:
    ``unet/``, ``vae/``, ``text_encoder/`` (``.safetensors`` in ``dtype``,
    fp16 by default, in the reference's names, the UNet's 2D part with a
    4-channel ``conv_in``),
    ``tokenizer/merges.txt`` and ``motion_module.ckpt`` (the rest of the
    3D UNet, ``conv_in`` at full width, ``module.``-prefixed in a
    ``{"state_dict": ...}`` wrapper). The values are drawn on ``device``.
    Returns the UNet's, VAE's and CLIP's written flax trees (``dtype``, CPU)
    and the motion module's path."""
    import os

    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL
    from followyourclick_tpu_torch.utils.convert import _set

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        modules = {"unet": UNet3DConditionModel(cfg.unet),
                   "vae": AutoencoderKL(cfg.vae),
                   "text_encoder": CLIPTextModel(cfg.clip_text)}
    inverse = {"unet": unet_state_from_tree, "vae": vae_state_from_tree,
               "text_encoder": clip_state_from_tree}
    trees, motion = {}, {}
    for sub, module in modules.items():
        trees[sub] = {}
        for path, v in _flat(random_flax_tree(module, gen)).items():
            _set(trees[sub], path, v.to(dtype).cpu())
        state = inverse[sub](trees[sub])
        if sub == "unet":
            motion = {k: v for k, v in state.items()
                      if ".motion_modules." in k or k.startswith(
                          ("fps_embedding.", "motion_embedding.",
                           "conv_in."))}
            state = {k: v for k, v in state.items()
                     if k not in motion or k.startswith("conv_in.")}
            state["conv_in.weight"] = state["conv_in.weight"][:, :4]
        os.makedirs(os.path.join(root, sub))
        name = ("diffusion_pytorch_model.safetensors" if sub != "text_encoder"
                else "model.safetensors")
        write_safetensors(os.path.join(root, sub, name),
                          {k: v.contiguous() for k, v in state.items()})
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "merges.txt"), "w") as f:
        f.write(synthetic_merges())
    mm_path = os.path.join(root, "motion_module.ckpt")
    torch.save({"state_dict": {"module." + k: v.contiguous()
                               for k, v in motion.items()}}, mm_path)
    return trees, mm_path


def loaded_sample_check(pipe, trees):
    """Every ``CLI_SAMPLE_EVERY``-th parameter of the loaded UNet, VAE and
    CLIP text encoder against what was written (fp16, through the flax →
    torch layout, in the pipeline's dtype): bit for bit. Returns the number
    checked."""
    from followyourclick_tpu_torch.utils.convert import (
        _flax_path,
        _leaf_name,
        _torch_layout,
    )

    checked = 0
    for sub, module in (("unet", pipe.unet), ("vae", pipe.vae),
                        ("text_encoder", pipe.text_encoder)):
        flat = _flat(trees[sub])
        params = [(mname, mod, pname, p) for mname, mod in
                  module.named_modules()
                  for pname, p in mod.named_parameters(recurse=False)]
        for i, (mname, mod, pname, p) in enumerate(params):
            if i % CLI_SAMPLE_EVERY and "conv_in" not in mname:
                continue
            key = _flax_path(mname) + (_leaf_name(mod, pname),)
            want = torch.from_numpy(np.ascontiguousarray(_torch_layout(
                mod, pname, flat[key].numpy()))).to(p.dtype)
            if not torch.equal(p.detach().cpu(), want):
                raise SystemExit(f"[cli] loaded {sub}.{mname}.{pname} is not "
                                 "what was written")
            checked += 1
    return checked


@contextlib.contextmanager
def t2i_observed(log_rows):
    """Watch the T2I pipeline inside the CLI: the device memory its
    construction adds (it must share the video UNet's tensors) and the
    launches of each of its requests, read from the wrappers' counts
    before and after (nothing is reset)."""
    from followyourclick_tpu_torch.pipelines import text_to_image as t2i_mod

    cls = t2i_mod.TextToImagePipeline
    init, sample = cls.__init__, cls.sample
    wrappers = {**kernel_wrappers(), **unrouted_wrappers()}

    def observed_init(self, config, unet, *a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        init(self, config, unet, *a, **kw)
        torch.cuda.synchronize()
        shared = (self.unet.conv_in.conv.weight.data_ptr()
                  == unet.conv_in.conv.weight.data_ptr())
        log_rows.append(("init", torch.cuda.memory_allocated() - before,
                         shared))

    def observed_sample(self, *a, **kw):
        before = {n: fn.launches for n, fn in wrappers.items()}
        out = sample(self, *a, **kw)
        log_rows.append(("sample", {n: fn.launches - before[n]
                                    for n, fn in wrappers.items()}))
        return out

    cls.__init__, cls.sample = observed_init, observed_sample
    try:
        yield
    finally:
        cls.__init__, cls.sample = init, sample


@contextlib.contextmanager
def captured_videos(write=True):
    """Record each clip the port's CLIs write: while the block runs, the
    port's ``video_io.save_videos_grid`` also files the video it is given
    under the GIF's name in the dict it yields (``write=False``: and writes
    no file, where PIL is missing)."""
    from followyourclick_tpu_torch.utils import video_io

    real = video_io.save_videos_grid
    videos = {}

    def record(clips, path, *args, **kwargs):
        videos[os.path.basename(path)] = clips
        if write:
            real(clips, path, *args, **kwargs)

    video_io.save_videos_grid = record
    try:
        yield videos
    finally:
        video_io.save_videos_grid = real


def cli_run(label, argv, main_reads_files, write_gifs, expect_clips,
            cfg):
    """One CLI run with every launch count set to 0 before and read after:
    through ``cli.inference.main``, which reads the files (``cfg`` must be
    what its ``--inference_config`` file holds), or else through ``run``
    with ``cfg`` and the prompt config read as JSON; ``write_gifs`` false
    (no PIL) keeps the GIFs unwritten. Returns (launches by kernel, the
    run's result, its videos by GIF name, the T2I rows, seconds)."""
    from followyourclick_tpu_torch.cli import inference as cli

    wrappers = {**kernel_wrappers(), **unrouted_wrappers()}
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with t2i_observed(rows), captured_videos(write_gifs) as videos:
        if main_reads_files:
            result = cli.main(argv)
        else:
            args = cli.build_arg_parser().parse_args(argv)
            with open(args.config) as f:
                model_config = json.load(f)
            result = cli.run(args, cfg, model_config,
                             cli.load_prompt_manifest(args.file))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {name: fn.launches for name, fn in wrappers.items()}
    st = result["stats"]
    log(f"[cli {label}] {dt:.2f} s in all; load {st['load'][0]:.2f} s, "
        f"T2I {' / '.join(f'{t:.2f}' for t in st['t2i'])} s, request "
        f"{' / '.join(f'{t:.2f}' for t in st['request'])} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"launches {got}")
    if len(result["files"]) != expect_clips:
        raise SystemExit(f"[cli {label}] {len(result['files'])} clips, "
                         f"expected {expect_clips}")
    return got, result, videos, rows, dt


def phase_cli(seed, steps, cfg=None, device="cuda", clip=(16, 512, 512),
              root=None):
    """Phase 13: the click-to-video CLI from checkpoint files at the default
    widths. A synthetic SD-1.5 directory (:func:`write_sd_directory`) and a
    two-row manifest without images; ``cli.inference`` runs (a) one clip a
    request on the exact sampler, (b) two clips a request under
    ``SERVING_SCHEDULE``, at ``steps`` (the prompt YAML's ``steps``). Each
    row's first frame comes from the T2I pipeline (``T2I_STEPS`` steps, CFG
    8, the motion-free UNet on the video UNet's tensors). Checks: a sample
    of loaded tensors equals what was written; the T2I construction adds
    no weights and shares ``conv_in``; each T2I request launches what
    ``expected_launches`` gives for the motion-free UNet (LN-GEGLU only);
    the run's launches equal the T2I's plus ``expected_launches`` of the
    video requests; the videos are finite, in [0, 1], of the expected
    shape; the GIFs exist (when PIL is installed). ``cfg``,
    ``device`` and ``clip`` (frames, height, width) default to the
    full-width run on the card. The SD directory is written under
    ``root`` (a temporary directory when None), where phases 15 and 16
    read it (``<root>/sd15``). Returns the two runs' launches."""
    import importlib.util
    import os
    import tempfile
    from pathlib import Path

    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.pipelines.serving_schedules import (
        apply_schedule,
    )
    from followyourclick_tpu_torch.utils import loaders

    have_yaml = importlib.util.find_spec("yaml") is not None
    have_gif = importlib.util.find_spec("PIL") is not None
    if not have_yaml:
        log("[cli] PyYAML is not installed: cli.inference.main cannot read "
            "the inference config or the prompt YAML; the phase drives "
            "cli.inference.run with the default InferenceConfig (what "
            "configs/inference/inference.yaml holds) and the prompt config "
            "read as JSON")
    if not have_gif:
        log("[cli] PIL is not installed: the GIFs are not written (the "
            "capture hook writes no file); the videos are checked as the "
            "CLI hands them to save_videos_grid")
    cfg = cfg or InferenceConfig()
    frames, height, width = clip
    with torch.device("meta"):
        meta_unet = UNet3DConditionModel(cfg.unet)
        t2i_unet = UNet3DConditionModel(dataclasses.replace(
            cfg.unet, use_motion_module=False,
            use_first_frame_mask_condition_concat=False,
            use_fps_condition=False))
    t2i_spec = SampleSpec(video_length=1, height=height, width=width,
                          num_inference_steps=T2I_STEPS,
                          share_cfg_prefix=False)
    t2i_want = expected_launches(t2i_unet, t2i_spec, torch.bfloat16)
    t2i_by_hand = {name: T2I_LAUNCHES_PER_STEP.get(name, 0) * T2I_STEPS
                   for name in KERNELS}
    if t2i_want != t2i_by_hand:
        raise SystemExit(f"[cli] T2I: step_plan gives {t2i_want}, the hand "
                         f"count {t2i_by_hand}")
    repo = Path(__file__).resolve().parent
    paths = {}
    with (tempfile.TemporaryDirectory() if root is None
          else contextlib.nullcontext(root)) as root:
        t0 = time.perf_counter()
        sd = os.path.join(root, "sd15")
        trees, mm_path = write_sd_directory(sd, cfg, seed, device)
        size = sum(f.stat().st_size for f in Path(sd).rglob("*")
                   if f.is_file())
        log(f"[cli] wrote the synthetic SD-1.5 directory and motion module "
            f"({size / 2 ** 30:.2f} GiB) in {time.perf_counter() - t0:.1f} s")
        # the loader alone, once: the tensors it fills are the written ones
        t0 = time.perf_counter()
        pipe = loaders.assemble_pipeline_from_pretrained(
            sd, cfg, motion_module_path=mm_path, device=device)
        torch.cuda.synchronize()
        log(f"[cli] assembled in {time.perf_counter() - t0:.2f} s "
            f"(tokenizer built at first use); "
            f"{loaded_sample_check(pipe, trees)} loaded tensors equal the "
            "written ones")
        del pipe, trees
        gc.collect()
        torch.cuda.empty_cache()
        model_config = {"smoke": {
            "motion_module": [mm_path], "steps": steps,
            "guidance_scale": 8.0, "seed": [seed],
            "n_prompt": ["low resolution, low quality"]}}
        prompt_file = os.path.join(root, "smoke.yaml")
        with open(prompt_file, "w") as f:
            json.dump(model_config, f)  # JSON is YAML
        manifest = os.path.join(root, "prompts.txt")
        with open(manifest, "w") as f:
            f.write("\n".join(CLI_PROMPTS) + "\n")
        base = ["--pretrained_model_path", sd, "--inference_config",
                str(repo / "configs" / "inference" / "inference.yaml"),
                "--config", prompt_file, "--file", manifest,
                "--seed", str(seed), "--device", device, "--L", str(frames),
                "--H", str(height), "--W", str(width)]
        size = dict(video_length=frames, height=height, width=width,
                    num_inference_steps=steps)
        exact = SampleSpec(**size)
        serving = apply_schedule(SampleSpec(**size), SERVING_SCHEDULE)
        for label, extra, spec, batch in (
                ("exact", ["--batch_size", "1"], exact, 1),
                (f"{SERVING_SCHEDULE} {BATCH} clips",
                 ["--batch_size", str(BATCH), "--serving_schedule",
                  SERVING_SCHEDULE], serving, BATCH)):
            out = os.path.join(root, "out_" + label.split()[0])
            requests = len(CLI_PROMPTS) // batch
            video_want = expected_launches(meta_unet, spec, torch.bfloat16,
                                           batch)
            want = {name: requests * video_want.get(name, 0)
                    + len(CLI_PROMPTS) * t2i_want.get(name, 0)
                    for name in {**KERNELS, **UNROUTED}}
            got, result, videos, rows, _ = cli_run(
                label, base + extra + ["--output_path", out],
                have_yaml and have_gif and cfg == InferenceConfig(),
                have_gif, len(CLI_PROMPTS), cfg)
            inits = [r for r in rows if r[0] == "init"]
            samples = [r[1] for r in rows if r[0] == "sample"]
            log(f"[cli {label}] T2I construction added "
                f"{inits[0][1] / 2 ** 20:.1f} MiB, conv_in shared: "
                f"{inits[0][2]}; T2I requests launched {samples}")
            if len(inits) != 1 or inits[0][1] > T2I_MAX_NEW_BYTES \
                    or not inits[0][2]:
                raise SystemExit(f"[cli {label}] the T2I pipeline does not "
                                 f"share the video UNet's tensors: {inits}")
            t2i_full = {**dict.fromkeys(UNROUTED, 0), **t2i_want}
            if len(samples) != len(CLI_PROMPTS) or any(
                    s != t2i_full for s in samples):
                raise SystemExit(f"[cli {label}] T2I launches {samples}, "
                                 f"want {t2i_full} each")
            if got != want:
                raise SystemExit(f"[cli {label}] launches {got}, want {want} "
                                 "(the video requests' step plan plus the "
                                 "T2I's)")
            if sorted(videos) != sorted(result["files"]):
                raise SystemExit(f"[cli {label}] clips handed to the writer "
                                 f"{sorted(videos)}, files "
                                 f"{result['files']}")
            for name, video in videos.items():
                shape = (1, frames, height, width, 3)
                if video.shape != shape or not np.isfinite(video).all() \
                        or video.min() < 0 or video.max() > 1 \
                        or video.std() <= 0:
                    raise SystemExit(f"[cli {label}] {name}: not a finite "
                                     f"non-constant video in [0, 1] of "
                                     f"shape {shape}")
                log(f"[cli {label}]   {name}: min {video.min():.4f} max "
                    f"{video.max():.4f} mean {video.mean():.4f} std "
                    f"{video.std():.4f}")
            written = sorted(os.listdir(result["savedir"]))
            gifs = [n for n in result["files"] if n in written]
            if have_gif and len(gifs) != len(result["files"]):
                raise SystemExit(f"[cli {label}] GIFs missing: {written}")
            if "config_snapshot.yaml" not in written:
                raise SystemExit(f"[cli {label}] no config_snapshot.yaml")
            log(f"[cli {label}] wrote {len(gifs)} GIF(s) "
                f"{'' if have_gif else '(no PIL) '}and "
                "config_snapshot.yaml")
            paths[f"cli_{label.split()[0]}"] = got
            gc.collect()
            torch.cuda.empty_cache()
    return paths


# the click front-end (phases 15 and 16): SAM at 1024², fp32 (SamConfig's
# default), on a seeded RGB image that is not square (the pad to 1024² and
# the crop before the last resize)
CLICK_IMAGE = (768, 1024)  # height, width
CLICK_POINT = (612.0, 300.0)  # x, y
CLICK_BATCH = 64  # point prompts in one predict_batch call
CLICK_DILATE = 15
# the exported decoder against the eager one, normalised max error
EXPORT_REL = 1e-5
# vit_t, fp32, card vs CPU: mask logits, normalised max error (summation
# order only, TF32 off)
SAM_TINY_REL = 1e-4
FILL_STEPS = 25
FILL_GUIDANCE = 7.5
FILL_PROMPT = "a red car on the road"
# a fill / replace step's launches by hand: the motion-free UNet's 16
# spatial transformer blocks' LN-GEGLU on the CFG batch
FILL_LAUNCHES_PER_STEP = {"fused_ln_geglu": 16}
# tiny fp32 inpaint sample, card vs CPU, on the [0, 1] image
FILL_TINY_ATOL = 2e-3


def click_image(seed, height, width):
    """A seeded (H, W, 3) uint8 RGB picture: a vertical gradient, three
    filled ellipses and a little noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:height, :width].astype(np.float32)
    img = np.stack([40 + 120 * yy / height, 80 + 60 * xx / width,
                    160 - 100 * yy / height], axis=-1)
    for _ in range(3):
        cy, cx = rs.uniform(0.2, 0.8) * height, rs.uniform(0.2, 0.8) * width
        ry = rs.uniform(0.08, 0.25) * height
        rx = rs.uniform(0.08, 0.25) * width
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        img[inside] = rs.uniform(0, 255, 3)
    img += rs.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def event_ms(fn, reps=1):
    """Device milliseconds of each of ``reps`` calls by CUDA events (with
    the host's enqueue time); returns (times, last result)."""
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def launches_zeroed():
    """Set every kernel's launch count to 0; return the wrappers."""
    wrappers = {**kernel_wrappers(), **unrouted_wrappers()}
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def check_records(label, records, shape):
    """AMG records: the keys, a box inside the image, the area its mask's,
    sorted by area."""
    h, w = shape
    for r in records:
        seg = r["segmentation"]
        x, y, bw, bh = r["bbox"]
        if seg.shape != (h, w) or int(seg.sum()) != r["area"] or not (
                0 <= x <= x + bw <= w and 0 <= y <= y + bh <= h) or not (
                np.isfinite(r["predicted_iou"])
                and 0 <= r["stability_score"] <= 1):
            raise SystemExit(f"[click] {label}: a malformed record {r['bbox']}"
                             f" area {r['area']}")
    areas = [r["area"] for r in records]
    if areas != sorted(areas, reverse=True):
        raise SystemExit(f"[click] {label}: records not sorted by area")


def phase_click(seed, root, steps, cfg=None, device="cuda",
                sam_type="vit_h", image_size=CLICK_IMAGE,
                clip=(16, 512, 512)):
    """Phase 15: the click front-end. SAM ``sam_type`` (fp32, seeded weights
    drawn on the card) on :func:`click_image`: ``set_image`` (cold, then
    warm, by CUDA events), one click → 3 masks and IoU, ``predict_batch``
    of ``CLICK_BATCH`` points, the automatic mask generator at its
    defaults and with both thresholds at 0 (so the boxes and the NMS run on
    what random weights give), the ``torch.export`` decoder reloaded
    against the eager one (``EXPORT_REL``), ``vit_t`` card vs CPU
    (``SAM_TINY_REL``); no hand-written kernel may launch. Then the whole
    journey: ``cli.click_mask`` on the image as a PNG (its ``mask_0.png``
    must equal the dilated first mask of the click above), and that mask
    as the ``mask`` column of a one-row manifest of ``cli.inference`` on
    phase 13's SD-1.5 directory under ``root`` (exact, ``steps``), whose
    launches must equal ``expected_launches``. Returns the launches by
    path."""
    from pathlib import Path

    from PIL import Image

    from followyourclick_tpu_torch.cli import click_mask
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.sam import (
        SamAutomaticMaskGenerator,
        SamPredictor,
        build_sam,
        sam_model_registry,
    )
    from followyourclick_tpu_torch.sam.export import (
        build_decoder_fn,
        export_decoder,
        load_decoder,
    )
    from followyourclick_tpu_torch.utils.image_ops import dilate

    cfg = cfg or InferenceConfig()
    height, width = image_size
    wrappers = launches_zeroed()
    torch.cuda.reset_peak_memory_stats()
    sam_cfg = sam_model_registry[sam_type]
    t0 = time.perf_counter()
    model = build_sam(sam_cfg, device, torch.Generator(
        device=device).manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"[click] {sam_type}: {n / 1e6:.1f} M parameters, fp32, seeded "
        f"weights on the card in {time.perf_counter() - t0:.2f} s")
    predictor = SamPredictor(model, device)
    img = click_image(seed, height, width)
    enc, _ = event_ms(lambda: predictor.set_image(img), reps=3)
    emb = predictor.get_image_embedding()
    g = sam_cfg.image_embedding_size
    if tuple(emb.shape) != (1, sam_cfg.prompt_embed_dim, *g) \
            or not bool(torch.isfinite(emb).all()):
        raise SystemExit(f"[click] embedding {tuple(emb.shape)} not finite "
                         "or of the wrong shape")
    dec, (masks, iou, low) = event_ms(lambda: predictor.predict(
        np.array([CLICK_POINT]), np.array([1])), reps=3)
    if masks.shape != (3, height, width) or masks.dtype != bool \
            or iou.shape != (3,) or not np.isfinite(iou).all() \
            or low.shape != (3, 4 * g[0], 4 * g[1]):
        raise SystemExit(f"[click] predict: masks {masks.shape} iou "
                         f"{iou} low-res {low.shape}")
    rs = np.random.RandomState(seed)
    pts = rs.uniform(0, 1, (CLICK_BATCH, 1, 2)) * [width, height]
    batch_ms, (bm, biou) = event_ms(lambda: predictor.predict_batch(
        pts, np.ones((CLICK_BATCH, 1), np.int32)), reps=2)
    if bm.shape != (CLICK_BATCH, 3, height, width) \
            or not np.isfinite(biou).all():
        raise SystemExit(f"[click] predict_batch: {bm.shape}")
    log(f"[click] {sam_type} {height}x{width}: set_image (encode) "
        f"{' / '.join(f'{t:.2f}' for t in enc)} ms (cold / warm), one click "
        f"(decode + postprocess, to the host) "
        f"{' / '.join(f'{t:.2f}' for t in dec)} ms, predict_batch of "
        f"{CLICK_BATCH} {' / '.join(f'{t:.2f}' for t in batch_ms)} ms; "
        f"IoU {np.round(iou, 4).tolist()}, mask areas "
        f"{masks.sum(axis=(1, 2)).tolist()} ({CARD})")
    for label, kw in (("defaults", {}),
                      ("thresholds 0", dict(pred_iou_thresh=0.0,
                                            stability_score_thresh=0.0))):
        amg = SamAutomaticMaskGenerator(predictor, **kw)
        times, records = event_ms(lambda: amg.generate(img))
        check_records(label, records, (height, width))
        if kw and not records:
            raise SystemExit("[click] AMG with thresholds 0 kept nothing")
        log(f"[click] AMG {label} (32x32 points, batches of 64): "
            f"{len(records)} records in {times[0]:.1f} ms; largest areas "
            f"{[r['area'] for r in records[:5]]} ({CARD})")
    blob = export_decoder(model, (height, width))
    exported = load_decoder(blob)
    eager = build_decoder_fn(model, (height, width))
    coords = predictor.transform.apply_coords(
        np.array([[CLICK_POINT, (0.0, 0.0)]]), (height, width))
    args = (emb, torch.from_numpy(coords).to(device),
            torch.tensor([[1.0, -1.0]], device=device),
            torch.zeros(1, 1, 4 * g[0], 4 * g[1], device=device),
            torch.zeros(1, 1, 1, 1, device=device))
    with torch.inference_mode():
        want = eager(*args)
        got = exported(*args)
    errs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(got, want)]
    log(f"[click] torch.export decoder: {len(blob) / 2 ** 20:.2f} MiB, "
        f"reloaded vs eager (masks, IoU, low-res) "
        f"{['%.3e' % e for e in errs]} (tol {EXPORT_REL:g})")
    if max(errs) > EXPORT_REL or got[0].shape != (1, 1, height, width):
        raise SystemExit("[click] the exported decoder disagrees")
    tiny = sam_model_registry["vit_t"]
    small = click_image(seed + 1, 96, 80)
    logits = []
    for dev in ("cpu", device):
        p = SamPredictor(build_sam(tiny, dev, torch.Generator().manual_seed(
            seed)), dev)
        p.set_image(small)
        logits.append(p.predict(np.array([[40.0, 50.0]]), np.array([1]),
                                return_logits=True)[0])
    err = float(np.abs(logits[1] - logits[0]).max()
                / np.abs(logits[0]).max())
    log(f"[click] vit_t fp32 card vs CPU: logits {err:.3e} of their max "
        f"(tol {SAM_TINY_REL:g})")
    if err > SAM_TINY_REL:
        raise SystemExit("[click] vit_t card and CPU disagree")
    got = {name: fn.launches for name, fn in wrappers.items()}
    log(f"[click] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{got} ({CARD})")
    if any(got.values()):
        raise SystemExit(f"[click] a hand-written kernel launched: {got}")
    paths = {"click": got}
    want_mask = dilate(masks[0].astype(np.uint8) * 255, CLICK_DILATE)
    del predictor, model, eager, exported, emb, args
    gc.collect()
    torch.cuda.empty_cache()

    # the journey: click → mask file → click-to-video
    frames, vh, vw = clip
    sd = os.path.join(root, "sd15")
    png = os.path.join(root, "click.png")
    Image.fromarray(img).save(png)
    t0 = time.perf_counter()
    out = click_mask.main([
        "--input_img", png, "--point_coords", *map(str, CLICK_POINT),
        "--output_dir", os.path.join(root, "masks"), "--sam_model_type",
        sam_type, "--dilate_kernel_size", str(CLICK_DILATE), "--seed",
        str(seed), "--device", device])
    torch.cuda.synchronize()
    mask_png = os.path.join(out["out_dir"], "mask_0.png")
    mask = np.asarray(Image.open(mask_png))
    log(f"[click] cli.click_mask: {out['files']} in "
        f"{time.perf_counter() - t0:.2f} s (build included); mask_0.png "
        f"equals the click's dilated mask: {np.array_equal(mask, want_mask)}")
    if not np.array_equal(mask, want_mask):
        raise SystemExit("[click] cli.click_mask's mask_0.png is not the "
                         "predictor's dilated mask")
    manifest = os.path.join(root, "click.csv")
    with open(manifest, "w") as f:
        f.write(f"prompt,image,mask\n{CLI_PROMPTS[0]},{png},{mask_png}\n")
    prompt_file = os.path.join(root, "click.yaml")
    with open(prompt_file, "w") as f:
        json.dump({"click": {"motion_module": [os.path.join(
            sd, "motion_module.ckpt")], "steps": steps,
            "guidance_scale": 8.0, "seed": [seed]}}, f)
    repo = Path(__file__).resolve().parent
    import importlib.util

    reads = all(importlib.util.find_spec(m) for m in ("yaml", "PIL")) \
        and cfg == InferenceConfig()
    argv = ["--pretrained_model_path", sd, "--inference_config",
            str(repo / "configs" / "inference" / "inference.yaml"),
            "--config", prompt_file, "--file", manifest, "--seed", str(seed),
            "--device", device, "--L", str(frames), "--H", str(vh), "--W",
            str(vw), "--batch_size", "1", "--output_path",
            os.path.join(root, "out_click")]
    got, result, videos, rows, _ = cli_run("click row", argv, reads, True, 1,
                                           cfg)
    with torch.device("meta"):
        meta_unet = UNet3DConditionModel(cfg.unet)
    spec = SampleSpec(video_length=frames, height=vh, width=vw,
                      num_inference_steps=steps)
    want = {**dict.fromkeys({**KERNELS, **UNROUTED}, 0),
            **expected_launches(meta_unet, spec, torch.bfloat16, 1)}
    t2i_requests = [r for r in rows if r[0] == "sample"]
    if got != want or t2i_requests:
        raise SystemExit(f"[click row] launches {got}, want {want}; T2I "
                         f"requests {t2i_requests} (the row has an image)")
    (video,) = videos.values()
    if video.shape != (1, frames, vh, vw, 3) or not np.isfinite(video).all() \
            or video.min() < 0 or video.max() > 1:
        raise SystemExit(f"[click row] video {video.shape}")
    log(f"[click row] click → mask_0.png → {result['files']}: min "
        f"{video.min():.4f} max {video.max():.4f} std {video.std():.4f}")
    paths["click_to_video"] = got
    return paths


def phase_fill(seed, root, cfg=None, device="cuda", sam_type="vit_h",
               image_size=CLICK_IMAGE, steps=FILL_STEPS, tiny_size=64):
    """Phase 16: ``cli.inpaint fill`` and ``replace`` on phase 13's SD-1.5
    directory under ``root`` and SAM ``sam_type`` (seeded), the image of
    phase 15, ``steps`` steps at CFG 7.5 on 512² crops: each candidate's
    pipeline call timed, the launches exactly ``FILL_LAUNCHES_PER_STEP`` a
    step, outputs of the image's shape, a fill unchanged outside its mask;
    then a tiny fp32 inpaint ``sample`` card vs CPU (``FILL_TINY_ATOL``).
    Returns the launches by path."""
    from PIL import Image

    from followyourclick_tpu_torch.cli import inpaint as cli_inpaint
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.pipelines.inpaint import InpaintPipeline

    cfg = cfg or InferenceConfig()
    height, width = image_size
    png = os.path.join(root, "click.png")
    if not os.path.exists(png):
        Image.fromarray(click_image(seed, height, width)).save(png)
    img = np.asarray(Image.open(png).convert("RGB"))
    calls = []
    real_call = InpaintPipeline.__call__

    def timed_call(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_call(self, *a, **kw)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
        return out

    paths = {}
    for command, key in (("fill", "filled"), ("replace", "replaced")):
        argv = [command, "--input_img", png, "--point_coords",
                *map(str, CLICK_POINT), "--output_dir",
                os.path.join(root, "out_" + command), "--sam_model_type",
                sam_type, "--seed", str(seed), "--device", device,
                "--sd_model_path", os.path.join(root, "sd15"),
                "--text_prompt", FILL_PROMPT, "--steps", str(steps)]
        wrappers = launches_zeroed()
        calls.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        InpaintPipeline.__call__ = timed_call
        try:
            result = cli_inpaint.main(argv, inference_config=cfg)
        finally:
            InpaintPipeline.__call__ = real_call
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in wrappers.items()}
        n = len(result["scores"])
        want = {name: n * steps * FILL_LAUNCHES_PER_STEP.get(name, 0)
                for name in wrappers}
        log(f"[{command}] {dt:.2f} s in all (SAM and SD load included); "
            f"{n} candidates, pipeline calls "
            f"{' / '.join(f'{t:.2f}' for t in calls)} s ({steps} steps, CFG "
            f"{FILL_GUIDANCE}, 512² crops, bf16 on the card); peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"launches {got} ({CARD})")
        if got != want:
            raise SystemExit(f"[{command}] launches {got}, want {want}")
        for i in range(n):
            out = np.asarray(Image.open(os.path.join(
                result["out_dir"], f"{key}_with_mask_{i}.png")))
            mask = np.asarray(Image.open(os.path.join(
                result["out_dir"], f"mask_{i}.png")))
            if out.shape != img.shape or mask.shape != img.shape[:2]:
                raise SystemExit(f"[{command}] output {i}: {out.shape}")
            if command == "fill" and not np.array_equal(out[mask == 0],
                                                         img[mask == 0]):
                raise SystemExit(f"[fill] output {i} changed outside its "
                                 "mask")
            log(f"[{command}]   {key}_with_mask_{i}.png: mask area "
                f"{int((mask > 0).sum())}, mean |out - in| "
                f"{np.abs(out.astype(int) - img).mean():.2f}")
        paths[command] = got
    # the tiny configuration in fp32, card vs CPU, the same noise
    tiny = cli_inpaint.tiny_inference_config()
    args = cli_inpaint.build_parser().parse_args(
        ["fill", "--input_img", png, "--point_coords", "0", "0",
         "--output_dir", root, "--text_prompt", FILL_PROMPT,
         "--device", "cpu", "--seed", str(seed)])
    cpu = cli_inpaint.build_sd_pipeline(args)
    card = InpaintPipeline(tiny, copy.deepcopy(cpu.unet),
                           copy.deepcopy(cpu.vae),
                           copy.deepcopy(cpu.text_encoder), device=device)
    gen = torch.Generator().manual_seed(seed)
    image = torch.rand(1, tiny_size, tiny_size, 3, generator=gen)
    mask = (torch.rand(1, tiny_size // 8, tiny_size // 8, 1, generator=gen)
            > 0.5).float()
    noise = torch.randn(1, tiny_size // 8, tiny_size // 8, 4, generator=gen)
    ids = torch.from_numpy(cli_inpaint.HashTokenizer()(
        [FILL_PROMPT, ""]).input_ids)
    outs = [p.sample(image, mask, ids[:1], ids[1:], 3, FILL_GUIDANCE,
                     noise=noise).cpu() for p in (cpu, card)]
    err = float((outs[1] - outs[0]).abs().max())
    log(f"[fill] tiny fp32 inpaint, card vs CPU: {err:.3e} on [0, 1] (tol "
        f"{FILL_TINY_ATOL:g})")
    if err > FILL_TINY_ATOL or not bool(torch.isfinite(outs[1]).all()):
        raise SystemExit("[fill] the tiny inpaint disagrees card vs CPU")
    return paths


# the training phases: the reference recipe's clip (448x256, 16 frames,
# batch 1), per-block checkpointing, bf16 frozen leaves and fp32 masters
TRAIN_CLIP = (16, 448, 256)  # frames, height, width
TRAIN_STEPS = 3
TRAIN_SAVE_AT = 2
# kernel route vs plain route, one step on the same draws: the loss, and
# the cosine of each motion module's gradient (its leaves concatenated)
TRAIN_LOSS_REL = 2e-2
TRAIN_GRAD_COS = 0.99
# launches a step by hand: 20 motion blocks, 16 LN-GEGLU and the mid
# block's spatial self-attention over its 7x4 = 28 tokens (sq = sk <= 32,
# sq x 8 heads <= 256: the tiny-sequence route) a UNet forward, each block's
# forward run again in the backward (remat_blocks)
TRAIN_LAUNCHES = {"fused_motion_block": 40, "fused_ln_geglu": 32,
                  "fused_temporal_block": 0, "temporal_attention": 2,
                  "flash_attention": 0}
# the training forward's kernel shapes: motion blocks (P, F, C) and LN-GEGLU
# rows (R, C) at latents 56x32, 16 frames (none a power of two)
TRAIN_MOTION_SHAPES = [(1792, 16, 320), (448, 16, 640), (112, 16, 1280),
                       (28, 16, 1280)]
TRAIN_GEGLU_SHAPES = [(28672, 320), (7168, 640), (1792, 1280), (448, 1280)]


def grad_check(name, route, reference, leaves, cot, failures):
    """``route`` (a wrapper on bf16 ``leaves``, through its autograd
    Function) against autograd through ``reference`` on fp32 copies of the
    same values: each gradient within ``BF16_REL`` of its largest (the
    Function's backward is that fp32 math, its gradients rounded to bf16).
    Returns the largest normalised error."""
    got = torch.autograd.grad(route(*leaves), leaves, cot)
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    want = torch.autograd.grad(reference(*ref_leaves), ref_leaves,
                               cot.float())
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        err = float((g.float() - w).abs().max()) / max(scale, 1e-30)
        worst = max(worst, err)
    ok = worst <= BF16_REL
    log(f"  {name} backward: gradients' normalised error {worst:.3e} "
        f"(tol {BF16_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name + " backward")
    return worst


def phase_train_kernels(seed):
    """The two kernels of the training forward at its shapes (bf16, both
    gate forms) against their plain versions, and every autograd Function's
    backward against autograd through the plain version: the motion block
    and LN-GEGLU at the training shapes, the other six at one shape
    each."""
    from followyourclick_tpu_torch.ops.cross_attention import (
        fused_ln_cross_attention,
        ln_cross_attention_ref,
    )
    from followyourclick_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from followyourclick_tpu_torch.ops.geglu import (
        fused_geglu,
        fused_ln_geglu,
        geglu_ref,
        ln_geglu_ref,
    )
    from followyourclick_tpu_torch.ops.groupnorm import (
        fused_group_norm,
        group_norm_ref,
    )
    from followyourclick_tpu_torch.ops.motion_block import (
        fused_motion_block,
        motion_block_ref,
    )
    from followyourclick_tpu_torch.ops.temporal_attention import (
        fused_temporal_block,
        temporal_attention,
        temporal_attention_ref,
        temporal_block_ref,
    )

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    failures = []

    def leaf(shape, s, base=0.0):
        return (base + randn(gen, shape, s, bf)).requires_grad_()

    def motion_leaves(p, f, c):
        params = []
        for _ in range(2):
            params += [leaf((c,), 0.05, 1.0), leaf((c,), 0.05)] + [
                leaf((c, c), c ** -0.5) for _ in range(4)] + [
                leaf((c,), 0.02)]
        params += [leaf((c,), 0.05, 1.0), leaf((c,), 0.05),
                   leaf((8 * c, c), c ** -0.5), leaf((8 * c,), 0.02),
                   leaf((c, 4 * c), (4 * c) ** -0.5), leaf((c,), 0.02)]
        return [leaf((p, f, c), 1.0), leaf((f, c), 0.5)] + params

    log("[train kernels] forward at the training shapes, and backward")
    for p, f, c in TRAIN_MOTION_SHAPES:
        heads, scale = 8, (c // 8) ** -0.5
        ls = motion_leaves(p, f, c)
        x, pe, params = ls[0], ls[1], ls[2:]
        with torch.no_grad():
            for fast in (c <= 640, c > 640):
                compare(f"fused_motion_block P={p} F={f} C={c} "
                        f"{'tanh' if fast else 'erf'}",
                        fused_motion_block(x, pe, params, scale, heads,
                                           fast_gating=fast),
                        motion_block_ref(x, pe, params, scale, heads,
                                         fast_gating=fast), failures)
        grad_check(f"fused_motion_block P={p} F={f} C={c}",
                   lambda x, pe, *ps: fused_motion_block(x, pe, ps, scale,
                                                         heads),
                   lambda x, pe, *ps: motion_block_ref(x, pe, ps, scale,
                                                       heads),
                   ls, randn(gen, (p, f, c), 1.0, bf), failures)
    for rows, c in TRAIN_GEGLU_SHAPES:
        inner = 4 * c
        ls = [leaf((rows, c), 1.0), leaf((c,), 0.05, 1.0), leaf((c,), 0.05),
              leaf((2 * inner, c), c ** -0.5), leaf((2 * inner,), 0.05),
              leaf((c, inner), inner ** -0.5), leaf((c,), 0.05)]
        with torch.no_grad():
            for fast in (c <= 640, c > 640):
                compare(f"fused_ln_geglu R={rows} C={c} "
                        f"{'tanh' if fast else 'erf'}",
                        fused_ln_geglu(*ls, fast_gating=fast),
                        ln_geglu_ref(*ls, fast_gating=fast), failures)
        grad_check(f"fused_ln_geglu R={rows} C={c}", fused_ln_geglu,
                   ln_geglu_ref, ls, randn(gen, (rows, c), 1.0, bf),
                   failures)
    rows, c = TRAIN_GEGLU_SHAPES[1]
    ls = [leaf((rows, c), 1.0), leaf((8 * c, c), c ** -0.5),
          leaf((8 * c,), 0.05), leaf((c, 4 * c), (4 * c) ** -0.5),
          leaf((c,), 0.05)]
    grad_check(f"fused_geglu R={rows} C={c}", fused_geglu, geglu_ref, ls,
               randn(gen, (rows, c), 1.0, bf), failures)
    p, f, c = TRAIN_MOTION_SHAPES[1]
    ls = [leaf((p, f, c), 1.0)] + [leaf((c, c), c ** -0.5)
                                   for _ in range(4)] + [leaf((c,), 0.02)]
    grad_check(f"fused_temporal_block B={p} S={f} C={c}",
               fused_temporal_block, temporal_block_ref, ls,
               randn(gen, (p, f, c), 1.0, bf), failures)
    # the frame kernel's plain version is softmax attention over any S
    q = [leaf((112, 16, 8, 160), 1.0) for _ in range(3)]
    grad_check("temporal_attention (112, 16, 8, 160)", temporal_attention,
               temporal_attention_ref, q,
               randn(gen, (112, 16, 8, 160), 1.0, bf), failures)
    q = [leaf((4, 1792, 8, 40), 1.0) for _ in range(3)]
    grad_check("flash_attention (4, 1792, 8, 40)", flash_attention,
               temporal_attention_ref, q,
               randn(gen, (4, 1792, 8, 40), 1.0, bf), failures)
    # the unrouted GroupNorm (+SiLU) and LN-cross-attention at a 320-wide
    # UNet site (77 text keys)
    c, n = 320, 4096
    ls = [leaf((2, n, c), 1.0, 2.0), leaf((c,), 0.05, 1.0),
          leaf((c,), 0.05)]
    grad_check(f"fused_group_norm (2, {n}, {c}) silu",
               lambda *a: fused_group_norm(*a, 32, 1e-5, "silu"),
               lambda *a: group_norm_ref(*a, 32, 1e-5, "silu"), ls,
               randn(gen, (2, n, c), 1.0, bf), failures)
    ls = [leaf((2, n, c), 1.0), leaf((2, 77, 768), 1.0),
          leaf((c,), 0.05, 1.0), leaf((c,), 0.05), leaf((c, c), c ** -0.5),
          leaf((c, 768), 768 ** -0.5), leaf((c, 768), 768 ** -0.5),
          leaf((c, c), c ** -0.5), leaf((c,), 0.02)]
    grad_check(f"fused_ln_cross_attention (2, {n}, {c}) 77 keys",
               lambda *a: fused_ln_cross_attention(*a, heads=8),
               lambda *a: ln_cross_attention_ref(*a, heads=8), ls,
               randn(gen, (2, n, c), 1.0, bf), failures)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"training kernel checks failed: {failures}")


def train_models(seed, remat_blocks=True, device="cuda", cfg=None):
    """The UNet (fp32, ``remat_blocks``), VAE and CLIP (bf16 on the card,
    frozen) of ``cfg`` (the default InferenceConfig) with seeded random
    weights, every zero-initialised layer given small weights
    (:func:`unzero_`), so every trainable leaf has a gradient from the
    first step."""
    from followyourclick_tpu_torch.config import InferenceConfig
    from followyourclick_tpu_torch.models.clip_text import CLIPTextModel
    from followyourclick_tpu_torch.models.unet3d import UNet3DConditionModel
    from followyourclick_tpu_torch.models.vae import AutoencoderKL

    cfg = cfg or InferenceConfig()
    torch.manual_seed(seed)
    with torch.device(device):
        unet = UNet3DConditionModel(cfg.unet, remat_blocks=remat_blocks)
        vae = AutoencoderKL(cfg.vae)
        text = CLIPTextModel(cfg.clip_text)
    unzero_(unet, torch.Generator(device=device).manual_seed(seed))
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    return cfg, unet, vae.to(dtype).eval(), text.to(dtype).eval()


def train_batch(vae, cfg, seed, clip, batch=1, device="cuda"):
    """A synthetic seeded batch: random clips in [-1, 1] encoded by
    ``encode_batch`` (the VAE's posterior sample), a centred click mask,
    random token ids, fps 8 and motion score 20."""
    from followyourclick_tpu_torch.training.step import (
        TrainBatch,
        encode_batch,
    )

    frames, height, width = clip
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    dtype = next(vae.parameters()).dtype
    video = (torch.rand((batch, frames, height, width, 3), generator=gen,
                        device=device) * 2 - 1).to(dtype)
    latents = encode_batch(vae, video, gen).float()
    h, w = height // 8, width // 8
    mask = torch.zeros(batch, h, w, 1, device=device)
    mask[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = 1.0
    ids = torch.randint(0, cfg.clip_text.vocab_size, (batch, 77),
                        generator=gen, device=device)
    full = torch.full((batch,), 1.0, device=device)
    return TrainBatch(latents, ids, mask, 8.0 * full, 20.0 * full)


def motion_modules(unet):
    """The number of motion modules in ``unet``."""
    from followyourclick_tpu_torch.models.motion_module import MotionModule

    return sum(isinstance(m, MotionModule) for m in unet.modules())


def motion_module_cosines(got, want):
    """Cosine of each motion module's gradient (its leaves concatenated),
    by module name, and the least cosine of any one leaf of them."""
    groups = collections.defaultdict(lambda: [0.0, 0.0, 0.0])
    worst_leaf = 1.0
    for name, g in got.items():
        m = re.match(r"(.*motion_modules\.\d+)\.", name)
        if m is None:
            continue
        a, b = g.double().flatten(), want[name].double().flatten()
        dot, na, nb = float(a @ b), float(a @ a), float(b @ b)
        acc = groups[m.group(1)]
        acc[0] += dot
        acc[1] += na
        acc[2] += nb
        if na and nb:
            worst_leaf = min(worst_leaf, dot / (na * nb) ** 0.5)
    return {k: d / max(na * nb, 1e-300) ** 0.5
            for k, (d, na, nb) in groups.items()}, worst_leaf


def phase_train(seed, cfg=None, device="cuda", clip=TRAIN_CLIP):
    """The trainer at full width (see the module docstring, phase 17);
    returns the kernels' launch counts over the uninterrupted run. ``cfg``,
    ``device``, ``clip``: a tiny rehearsal on the CPU (with ``torch.cuda``'s
    events stubbed)."""
    import itertools
    import tempfile

    from followyourclick_tpu_torch.config import NoiseScheduleConfig
    from followyourclick_tpu_torch.schedulers.ddim import DDIMSchedule
    from followyourclick_tpu_torch.training import loop
    from followyourclick_tpu_torch.training import step as ts

    t0 = time.perf_counter()
    cfg, unet, vae, text = train_models(seed, device=device, cfg=cfg)
    tcfg = ts.TrainConfig(gradient_checkpointing=False)
    sched = DDIMSchedule.create(NoiseScheduleConfig(), 25)

    def fresh():
        return ts.create_partitioned_train_state(unet, tcfg)

    state = fresh()
    n_train = sum(t.numel() for t in state.trainable.values())
    n_frozen = sum(t.numel() for t in state.frozen.values())
    log(f"[train] the UNet with remat_blocks: trainable "
        f"{n_train / 1e6:.3f} M parameters (fp32 masters), frozen "
        f"{n_frozen / 1e6:.3f} M (bf16); built in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = train_batch(vae, cfg, seed, clip, device=device)
    log(f"[train] latents {tuple(batch.latents.shape)} from {clip[0]} "
        f"frames {clip[1]}x{clip[2]} by encode_batch")
    kw = dict(unet=unet, text_encoder=text, sched=sched, cfg=tcfg)

    # step 1, kernel route against plain route, on the same draws (the
    # step functions alone, under the flags train_loop sets)
    draws = ts.draw_step(batch.latents, sched, tcfg,
                         torch.Generator(device=device).manual_seed(seed))
    plain = plain_versions()
    with checked_precision():
        loss_k, grads_k = ts.partitioned_loss_and_grads(state, batch, draws,
                                                        **kw)
        with wrappers_replaced(lambda name, fn: plain[name]):
            loss_p, grads_p = ts.partitioned_loss_and_grads(
                state, batch, draws, **kw)
    loss_k, loss_p = float(loss_k), float(loss_p)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos, worst_leaf = motion_module_cosines(grads_k, grads_p)
    least = min(cos, key=cos.get)
    zero = [n for n, g in grads_k.items()
            if "motion_modules" in n and not bool(g.any())]
    log(f"[train] step 1, kernel vs plain route: loss {loss_k:.6f} vs "
        f"{loss_p:.6f} (relative {rel:.3e}, tol {TRAIN_LOSS_REL}); "
        f"motion-module gradient cosine: least {cos[least]:.6f} "
        f"({least}), mean {np.mean(list(cos.values())):.6f} over "
        f"{len(cos)} modules (tol {TRAIN_GRAD_COS}); least of one leaf "
        f"{worst_leaf:.6f}; motion-module leaves with a zero gradient "
        f"{len(zero)}")
    if not (rel <= TRAIN_LOSS_REL and cos[least] >= TRAIN_GRAD_COS
            and len(cos) == motion_modules(unet) and not zero):
        raise SystemExit("[train] the kernel route's step disagrees with "
                         "the plain route's")
    del grads_k, grads_p

    # the loop: TRAIN_STEPS steps saving at TRAIN_SAVE_AT, then a fresh
    # state resumed from that checkpoint to the same step
    step_ms = []

    def step_fn(state, batch, generator):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ts.train_step_partitioned(state, batch, generator, **kw)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        return out

    def on_log(step, metrics):
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        log(f"[train] step {step}: loss {loss:.6f}, grad_norm {norm:.6f}, "
            f"{step_ms[-1]:.1f} ms")
        if not (np.isfinite(loss) and np.isfinite(norm)):
            raise SystemExit(f"[train] step {step}: loss or grad_norm not "
                             "finite")

    # deterministic algorithms (cuDNN attention's backward is not by
    # default), so that the resumed step can equal the uninterrupted one;
    # cuBLAS asks for a fixed workspace configuration in that mode
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            loop_cfg = loop.LoopConfig(
                output_dir=out_dir, max_train_steps=TRAIN_STEPS,
                checkpointing_steps=TRAIN_SAVE_AT, log_every=1,
                temporal_multi_scale=False)
            wrappers = {**kernel_wrappers(), **unrouted_wrappers()}
            for wrapper in wrappers.values():
                wrapper.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = loop.train_loop(state, itertools.repeat(batch), step_fn,
                                    loop_cfg, seed=seed, on_log=on_log)
            wall = time.perf_counter() - t0
            counts = {name: fn.launches for name, fn in wrappers.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            warm = sorted(step_ms[1:])
            log(f"[train] {TRAIN_STEPS} steps in {wall:.2f} s (one "
                f"checkpoint save); step ms {[round(t, 1) for t in step_ms]}"
                f", median of the warm steps {np.median(warm):.1f} ms; peak "
                f"device memory {peak:.2f} GiB")
            by_hand = {k: TRAIN_LAUNCHES.get(k, 0) * TRAIN_STEPS
                       for k in wrappers}
            log("[train] launches by hand / counted: " + ", ".join(
                f"{k} {by_hand[k]} / {counts[k]}" for k in counts))
            if counts != by_hand:
                raise SystemExit("[train] launch counts differ from the "
                                 "hand count")
            t0 = time.perf_counter()
            resumed = loop.train_loop(fresh(), itertools.repeat(batch),
                                      step_fn, loop_cfg, seed=seed,
                                      on_log=on_log)
            log(f"[train] resumed from step {TRAIN_SAVE_AT} to "
                f"{resumed.step} in {time.perf_counter() - t0:.2f} s")
    finally:
        torch.backends.cudnn.deterministic = deterministic[0]
        torch.use_deterministic_algorithms(deterministic[1],
                                           warn_only=deterministic[2])
        if deterministic[3] is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = deterministic[3]

    same = (resumed.step == state.step == TRAIN_STEPS
            and resumed.opt_state["count"] == state.opt_state["count"]
            and all(torch.equal(t, resumed.trainable[n])
                    for n, t in state.trainable.items())
            and all(torch.equal(t, resumed.frozen[n])
                    for n, t in state.frozen.items())
            and all(torch.equal(t, resumed.opt_state[m][n])
                    for m in ("mu", "nu")
                    for n, t in state.opt_state[m].items()))
    diff = max(float((t - resumed.trainable[n]).abs().max())
               for n, t in state.trainable.items())
    start = dict(unet.named_parameters())
    unchanged = [n for n, t in state.trainable.items()
                 if torch.equal(t, start[n])]
    moved = [n for n, t in state.frozen.items()
             if not torch.equal(t, start[n].detach().to(t.dtype))]
    log(f"[train] resumed step-{TRAIN_STEPS} state equals the "
        f"uninterrupted one bit for bit: {same} (largest trainable "
        f"difference {diff:.3e}); trainable leaves unchanged "
        f"{len(unchanged)} of {len(state.trainable)}; frozen leaves changed "
        f"{len(moved)} of {len(state.frozen)}")
    if not same or unchanged or moved:
        raise SystemExit("[train] resume, trainable or frozen check failed")
    return counts


# phase 18: LaMa removal. The big-LaMa generator's times at two sizes, its
# card-vs-CPU check at 512² (fp32, TF32 off: max |Δ| of the sigmoid output)
REMOVE_SIZES = ((768, 1024), (512, 512))
REMOVE_REPS = 5
LAMA_CARD_CPU_ATOL = 1e-3
# with the seeded BN statistics the card's distance from the CPU's fp64 may
# be at most this many times the CPU fp32's own
LAMA_FP64_RATIO = 2.0
# phase 19: LaMa's GAN training at the LaMa paper's 256² crops; the batch is
# a choice (the paper's is larger and spread over cards)
LAMA_TRAIN_SIZE = 256
LAMA_TRAIN_BATCH = 4
LAMA_TRAIN_STEPS = 3
# one alternation of a tiny config, card vs CPU: losses relative, each
# gradient and BN statistic against the largest of its network
LAMA_TINY_REL = 1e-4
LAMA_TINY = dict(ngf=8, n_downsampling=2, n_blocks=2)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(prof):
    """The events of the profiler's Chrome trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_intervals(events):
    """(start µs, end µs, name) of every device activity in the trace."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def busy_us(intervals):
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profiled(acts, fn):
    """``fn()`` once under the profiler with activities ``acts``: (wall s,
    peak GiB, trace events, device intervals, busy s)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = trace_events(prof)
    iv = device_intervals(events)
    if not iv:
        raise SystemExit("the trace holds no device activity")
    return wall, peak, events, iv, busy_us(iv) / 1e6


def calibrate_bn_(generator, *inputs):
    """Set every BN's running statistics to those of one train-mode pass
    on ``inputs``, as a trained network's are its data's. Seeded statistics
    (mean ≈ 0, variance ≈ 1) do not normalise what seeded convs give them:
    big-LaMa's residual stream then grows block by block, to logits in the
    thousands, where fp32 itself is far from fp64 on the sigmoid output
    (:func:`phase_remove` prints both, before and after)."""
    bns = [m for m in generator.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    generator.train()
    with torch.no_grad():
        generator(*inputs)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    return generator.eval()


def lama_checkpoint(path, generator):
    """``generator`` as a Lightning-shaped big-LaMa ``best.ckpt``: its
    state under ``generator.``, a few discriminator and loss keys beside it
    (which the loader drops) and plain metadata."""
    state = {"generator." + k: v.cpu() for k, v in
             generator.state_dict().items()}
    state["discriminator.model0.0.weight"] = torch.zeros(64, 3, 4, 4)
    state["discriminator.model0.0.bias"] = torch.zeros(64)
    state["loss_resnet_pl.impl.conv1.weight"] = torch.zeros(64, 3, 3, 3)
    torch.save({"epoch": 40, "global_step": 1000000,
                "pytorch-lightning_version": "1.2.9", "state_dict": state},
               path)


def phase_remove(seed, root, device="cuda", sam_type="vit_h",
                 image_size=CLICK_IMAGE, config=None, sizes=REMOVE_SIZES,
                 cpu_size=512):
    """Phase 18: LaMa removal. The seeded big-LaMa generator (``config``,
    default ``LamaConfig()``), its BN statistics calibrated on a seeded
    input (:func:`calibrate_bn_`), written as a Lightning-shaped
    ``best.ckpt``; ``cli.inpaint remove --lama_ckpt`` on
    :func:`click_image` with SAM ``sam_type``: three masks and three
    removals, read back, each removal equal to the image outside its mask;
    one generator call timed warm by CUDA events at ``sizes`` (median of
    ``REMOVE_REPS``), its operations counted, one under the profiler (the
    FFT kernels' share of the device time, the device's idle share); the
    sigmoid output at ``cpu_size``² on the card against the port on the
    CPU, same weights (``LAMA_CARD_CPU_ATOL``; beside it both against the
    CPU's fp64, the error fp32 itself makes; before the calibration the
    card's distance from fp64 at most ``LAMA_FP64_RATIO`` times the CPU
    fp32's); ``LamaInpainter`` on the card with a box hole at a size that
    pads, equal to the input outside the hole and to the CPU's uint8 within
    1; then ``cli.app.ClickSession`` (upload, click, remove) on the image.
    No hand-written kernel may launch. Returns the launches."""
    from PIL import Image

    from torch.utils.flop_counter import FlopCounterMode

    from followyourclick_tpu_torch.cli import inpaint as cli_inpaint
    from followyourclick_tpu_torch.cli.app import ClickSession
    from followyourclick_tpu_torch.cli.click_mask import build_predictor
    from followyourclick_tpu_torch.inpaint.lama import (
        LamaConfig,
        LamaInpainter,
        build_generator,
    )

    config = config or LamaConfig()
    height, width = image_size
    wrappers = launches_zeroed()
    torch.cuda.reset_peak_memory_stats()
    png = os.path.join(root, "click.png")
    if not os.path.exists(png):
        Image.fromarray(click_image(seed, height, width)).save(png)
    img = np.asarray(Image.open(png).convert("RGB"))

    def box(h, w, dev):
        mask = torch.zeros(1, 1, h, w, device=dev)
        mask[..., h // 4:h // 2, w // 3:2 * w // 3] = 1.0
        return mask

    def inputs(h, w, dev, g=None):
        g = g or torch.Generator(device=dev).manual_seed(seed)
        image = torch.rand(1, 3, h, w, generator=g, device=dev)
        mask = box(h, w, dev)
        return torch.cat([image * (1 - mask), mask], dim=1)

    def card_vs_cpu(label):
        """The sigmoid output at ``cpu_size``² on the card and on the CPU
        (fp32, and fp64 as the exact answer): (card vs CPU, card vs fp64,
        CPU fp32 vs fp64, the CPU generator)."""
        cpu = build_generator(config, "cpu", state_dict={
            k: v.cpu() for k, v in gen.state_dict().items()})
        x = inputs(cpu_size, cpu_size, "cpu", torch.Generator().manual_seed(
            seed))
        logits = []
        hook = cpu.model[-1].register_forward_hook(
            lambda m, i, o: logits.append(i[0]))
        with torch.inference_mode(), checked_precision():
            t0 = time.perf_counter()
            want = cpu(x)
            cpu_s = time.perf_counter() - t0
            got = gen(x.to(device)).cpu()
            exact = copy.deepcopy(cpu).double()(x.double())
        hook.remove()
        err = float((got - want).abs().max())
        card64 = float((got.double() - exact).abs().max())
        cpu64 = float((want.double() - exact).abs().max())
        log(f"[remove] generator {cpu_size}² fp32, {label}: logits in "
            f"[{float(logits[0].min()):.1f}, {float(logits[0].max()):.1f}]; "
            f"card vs CPU (TF32 off) max |Δ| of the sigmoid output "
            f"{err:.3e}; against the CPU's fp64: card {card64:.3e}, CPU "
            f"fp32 {cpu64:.3e} (ratio {card64 / cpu64:.3f}); the CPU fp32 "
            f"call took {cpu_s:.2f} s")
        return err, card64, cpu64, cpu

    gen = build_generator(config, device, torch.Generator(
        device=device).manual_seed(seed))
    _, card64, cpu64, _ = card_vs_cpu(
        f"seeded BN statistics (card vs fp64 at most {LAMA_FP64_RATIO:g}× "
        "the CPU fp32's)")
    if card64 > LAMA_FP64_RATIO * cpu64:
        raise SystemExit("[remove] with seeded BN statistics the card is "
                         f"{card64 / cpu64:.3f}× as far from fp64 as the "
                         "CPU's fp32")
    with checked_precision():
        calibrate_bn_(gen, inputs(cpu_size, cpu_size, device,
                                  torch.Generator(device=device).manual_seed(
                                      seed + 1)))
    n = sum(p.numel() for p in gen.parameters())
    ckpt = os.path.join(root, "best.ckpt")
    t0 = time.perf_counter()
    lama_checkpoint(ckpt, gen)
    log(f"[remove] big-LaMa ({config.n_blocks} FFC blocks, ngf "
        f"{config.ngf}): {n / 1e6:.1f} M parameters, fp32; best.ckpt of "
        f"{os.path.getsize(ckpt) / 2 ** 20:.1f} MiB written in "
        f"{time.perf_counter() - t0:.2f} s")
    argv = ["remove", "--input_img", png, "--point_coords",
            *map(str, CLICK_POINT), "--output_dir",
            os.path.join(root, "out_remove"), "--sam_model_type", sam_type,
            "--seed", str(seed), "--device", device, "--lama_ckpt", ckpt,
            "--dilate_kernel_size", str(CLICK_DILATE)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = cli_inpaint.main(argv, lama_config=config)
    torch.cuda.synchronize()
    log(f"[remove] cli.inpaint remove: {result['files']} in "
        f"{time.perf_counter() - t0:.2f} s (SAM build and LaMa load "
        "included)")
    if len(result["scores"]) != 3:
        raise SystemExit(f"[remove] {len(result['scores'])} results")
    for i in range(3):
        out = np.asarray(Image.open(os.path.join(
            result["out_dir"], f"inpainted_with_mask_{i}.png")))
        mask = np.asarray(Image.open(os.path.join(
            result["out_dir"], f"mask_{i}.png")))
        keep = mask == 0
        if out.shape != img.shape or mask.shape != img.shape[:2] \
                or not np.array_equal(out[keep], img[keep]):
            raise SystemExit(f"[remove] output {i}: {out.shape}, or it "
                             "changed outside its mask")
        log(f"[remove]   inpainted_with_mask_{i}.png: mask area "
            f"{int((~keep).sum())}, mean |out - in| in the mask "
            f"{np.abs(out.astype(int) - img)[~keep].mean():.2f}")

    times = {}
    with torch.inference_mode(), checked_precision():
        for h, w in sizes:
            x = inputs(h, w, device)
            gen(x)
            ms, out = event_ms(lambda: gen(x), reps=REMOVE_REPS)
            if out.shape != (1, 3, h, w) or not bool(
                    torch.isfinite(out).all()):
                raise SystemExit(f"[remove] generator output {out.shape}")
            times[(h, w)] = ms
            log(f"[remove] generator {h}x{w}, fp32: "
                f"{' / '.join(f'{t:.2f}' for t in ms)} ms, median "
                f"{float(np.median(ms)):.2f} ms ({CARD})")
        x = inputs(*sizes[0], device)
        with FlopCounterMode(display=False) as flops:
            gen(x)
        # the profile resets the peak: the phase's peak is the larger
        peak = torch.cuda.max_memory_allocated()
        wall, _, _, spans, busy = profiled(
            [torch.profiler.ProfilerActivity.CPU,
             torch.profiler.ProfilerActivity.CUDA], lambda: gen(x))
    by_name = collections.Counter()
    for start, end, name in spans:
        by_name[name] += (end - start) / 1e6
    tflop = flops.get_total_flops() / 1e12
    median = float(np.median(times[sizes[0]])) / 1e3
    log(f"[remove] generator {sizes[0][0]}x{sizes[0][1]}: {tflop:.3f} TFLOP "
        f"(torch.utils.flop_counter: convolutions, no FFT), "
        f"{tflop / median:.1f} TFLOP/s at the median, "
        f"{tflop * 1e12 / median / PEAK_FP32_OPS:.3f} of the fp32 peak; "
        f"bound {tflop * 1e15 / PEAK_FP32_OPS:.2f} ms ({CARD})")
    fft = sum(t for name, t in by_name.items() if "fft" in name.lower())
    log(f"[remove] profiled generator call {sizes[0][0]}x{sizes[0][1]}: wall "
        f"{wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, idle share "
        f"{1 - busy / wall:.3f}; FFT kernels {fft * 1e3:.2f} ms, "
        f"{fft / busy:.3f} of the device time ({CARD})")
    for name, t in by_name.most_common(6):
        log(f"[remove]   {t * 1e3:9.3f} ms  {name[:110]}")
    err, _, _, cpu = card_vs_cpu(f"calibrated (bound {LAMA_CARD_CPU_ATOL:g})")
    if err > LAMA_CARD_CPU_ATOL:
        raise SystemExit("[remove] the generator disagrees card vs CPU")
    # LamaInpainter on the card with a partial mask, at a size that pads to
    # a multiple of 8: the pixels outside the hole are the input's, bit for
    # bit, and the uint8 output is the CPU's within one (the truncation)
    h, w = cpu_size - 3, cpu_size - 2
    crop = np.ascontiguousarray(img[:h, :w])
    hole = box(h, w, "cpu")[0, 0].numpy().astype(np.uint8)
    on_card = LamaInpainter(gen, device)(crop, hole)
    on_cpu = LamaInpainter(cpu, "cpu")(crop, hole)
    keep = hole == 0
    same = bool(np.array_equal(on_card[keep], crop[keep]))
    diff = np.abs(on_card.astype(int) - on_cpu)
    log(f"[remove] LamaInpainter {h}x{w} on the card, a box hole of "
        f"{int(hole.sum())} pixels: the other {int(keep.sum())} equal to "
        f"the input bit for bit: {same}; card vs CPU uint8 max |Δ| "
        f"{int(diff.max())} (bound 1), {int((diff > 0).sum())} values "
        "differ")
    if on_card.shape != crop.shape or not same or diff.max() > 1:
        raise SystemExit("[remove] LamaInpainter with a box mask")
    args = cli_inpaint.build_parser().parse_args(argv)
    session = ClickSession(build_predictor(args), LamaInpainter(gen, device),
                           CLICK_DILATE)
    steps = {}
    for label, fn in (("upload", lambda: session.upload(img)),
                      ("click", lambda: session.click(*CLICK_POINT)),
                      ("remove", session.remove)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[label] = (time.perf_counter() - t0) * 1e3
        if label != "upload" and (len(out) != 3 or any(
                o.shape != img.shape for o in out)):
            raise SystemExit(f"[remove] ClickSession.{label}")
    got = {name: fn.launches for name, fn in wrappers.items()}
    log(f"[remove] ClickSession upload / click / remove (3 masks): "
        f"{' / '.join(f'{steps[k]:.1f}' for k in steps)} ms; peak device "
        f"memory {max(peak, torch.cuda.max_memory_allocated()) / 2 ** 30:.2f}"
        " GiB; "
        f"launches {got} ({CARD})")
    if any(got.values()):
        raise SystemExit(f"[remove] a hand-written kernel launched: {got}")
    return got


def phase_lama_train(seed, device="cuda", config=None,
                     size=LAMA_TRAIN_SIZE, batch=LAMA_TRAIN_BATCH,
                     steps=LAMA_TRAIN_STEPS, pl_layers=(3, 4, 6, 3)):
    """Phase 19: LaMa's GAN training. The seeded big-LaMa generator
    (``config``, default ``LamaConfig()``), ``NLayerDiscriminator()`` (ndf
    64, 3 layers) and ResNet-PL on a seeded ``DilatedResNet50Encoder``;
    ``steps`` generator + discriminator alternations of
    ``LamaTrainConfig()`` on one seeded batch of ``batch`` ``size``² crops
    with box masks, each timed by CUDA events. Every loss term finite,
    every parameter of both networks moved, the generator's BN running
    statistics changed and the discriminator's bit-identical to their
    start, no hand-written kernel launched. Then one alternation of a tiny
    configuration on the card against the same on the CPU
    (``LAMA_TINY_REL``). Returns the launches."""
    from followyourclick_tpu_torch.inpaint import train
    from followyourclick_tpu_torch.inpaint.lama import (
        BN_STATS,
        LamaConfig,
    )
    from followyourclick_tpu_torch.inpaint.perceptual import (
        DilatedResNet50Encoder,
    )
    from followyourclick_tpu_torch.utils.seeded_init import seeded_init_

    config = config or LamaConfig()
    cfg = train.LamaTrainConfig()
    wrappers = launches_zeroed()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=device).manual_seed(seed)
    gen, disc, gen_opt, discr_opt = train.init_training(
        cfg, config, device=device, generator=g)
    with torch.device("meta"):
        enc = DilatedResNet50Encoder(pl_layers)
    enc = seeded_init_(enc.to_empty(device=device), g, buffers=BN_STATS)
    enc.eval().requires_grad_(False)
    image = torch.rand(batch, 3, size, size, generator=g, device=device)
    mask = torch.zeros(batch, 1, size, size, device=device)
    corners = torch.randint(0, size // 2, (batch, 2), generator=g,
                            device=device).tolist()
    for i, (y, x) in enumerate(corners):
        mask[i, :, y:y + size // 3, x:x + size // 2] = 1.0
    data = {"image": image, "mask": mask}
    g_start = {k: v.clone() for k, v in gen.state_dict().items()}
    d_start = {k: v.clone() for k, v in disc.state_dict().items()}
    ms, terms = [], {}
    for _ in range(steps):
        def alternation():
            gm, inpainted = train.generator_step(gen, disc, cfg, gen_opt,
                                                 data, enc)
            return {**gm, **train.discriminator_step(disc, cfg, discr_opt,
                                                     data, inpainted)}
        t, terms = event_ms(alternation)
        ms += t
        bad = [k for k, v in terms.items() if not bool(torch.isfinite(v))]
        if bad:
            raise SystemExit(f"[lama train] loss terms not finite: {bad}")
    got = {name: fn.launches for name, fn in wrappers.items()}
    still = [k for k, p in list(gen.named_parameters())
             + [("disc." + k, p) for k, p in disc.named_parameters()]
             if torch.equal(p, (g_start if not k.startswith("disc.")
                                else d_start)[k.removeprefix("disc.")])]
    g_stats = [k for k in g_start if k.endswith(("running_mean",
                                                 "running_var"))]
    g_unmoved = [k for k in g_stats
                 if torch.equal(gen.state_dict()[k], g_start[k])]
    d_moved = [k for k, v in disc.named_buffers()
               if not torch.equal(v, d_start[k])]
    n_g = sum(p.numel() for p in gen.parameters())
    n_d = sum(p.numel() for p in disc.parameters())
    log(f"[lama train] {steps} alternations at batch {batch} of {size}² "
        f"(generator {n_g / 1e6:.1f} M, discriminator {n_d / 1e6:.1f} M "
        f"parameters, ResNet-PL on a {sum(pl_layers)}-block dilated "
        f"ResNet-50, fp32): {' / '.join(f'{t:.1f}' for t in ms)} ms per "
        f"alternation; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; last "
        f"terms " + ", ".join(f"{k} {float(v):.4g}" for k, v in
                              sorted(terms.items())) + f" ({CARD})")
    n_leaves = len(list(gen.parameters())) + len(list(disc.parameters()))
    log(f"[lama train] parameters unmoved {len(still)} of {n_leaves}; "
        f"generator BN statistics unchanged {len(g_unmoved)} of "
        f"{len(g_stats)}; discriminator BN buffers changed {len(d_moved)}; "
        f"launches {got}")
    if still or g_unmoved or d_moved or any(got.values()):
        raise SystemExit("[lama train] a parameter did not move, a "
                         "statistic moved wrongly, or a kernel launched")
    del gen, disc, gen_opt, discr_opt, enc
    gc.collect()
    torch.cuda.empty_cache()

    # a tiny configuration, one alternation, card vs CPU on the same weights
    sides = {}
    tiny = LamaConfig(**LAMA_TINY)
    for dev in ("cpu", device):
        gen, disc, gen_opt, discr_opt = train.init_training(
            cfg, tiny, ndf=8, n_layers=2, device="cpu",
            generator=torch.Generator().manual_seed(seed))
        gen, disc = gen.to(dev), disc.to(dev)
        gen_opt, discr_opt = train.make_optimizers(cfg, gen, disc)
        small = {k: torch.nn.functional.interpolate(
            v[:2].cpu(), size=(64, 64)).to(dev) for k, v in data.items()}
        gm, inpainted = train.generator_step(gen, disc, cfg, gen_opt, small)
        dm = train.discriminator_step(disc, cfg, discr_opt, small, inpainted)
        sides[dev] = ({k: float(v) for k, v in {**gm, **dm}.items()},
                      [p.grad.cpu() for p in gen.parameters()],
                      [p.grad.cpu() for p in disc.parameters()],
                      [v.cpu() for k, v in gen.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))])
    (loss_c, g_c, d_c, s_c), (loss_g, g_g, d_g, s_g) = (sides["cpu"],
                                                        sides[device])
    loss_err = max(abs(loss_g[k] - loss_c[k]) / max(abs(loss_c[k]), 1e-30)
                   for k in loss_c)

    def worst(a, b):
        scale = max(float(t.abs().max()) for t in a)
        return max(float((x - y).abs().max()) for x, y in zip(a, b)) / scale

    errs = {"losses": loss_err, "generator gradients": worst(g_c, g_g),
            "discriminator gradients": worst(d_c, d_g),
            "generator BN statistics": worst(s_c, s_g)}
    log("[lama train] tiny fp32 alternation, card vs CPU: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {LAMA_TINY_REL:g})")
    if max(errs.values()) > LAMA_TINY_REL:
        raise SystemExit("[lama train] the tiny alternation disagrees card "
                         "vs CPU")
    return got


# phase 20: the motion score of a seeded 16-frame 512² clip (15 pairs, 12
# GRU iterations) at the widths of configs/flow/raft_flyingchairs.yaml
# (mmflow raft_8x2_100k_flyingchairs_368x496), median of FLOW_REPS warm
# calls; card vs CPU on FLOW_CPU_PAIRS pairs of FLOW_CPU_SIZE² at 32
# iterations (the test configuration's), fp32 with the flags of
# utils/backend_flags. Seeded weights with calibrated BN give flows of
# ~110 px there, and the CPU's own fp32 lies 5e-4 to 1e-3 px from its fp64
# and from itself at another thread count: the card's flow must lie within
# FLOW_CARD_CPU_ATOL px of the CPU's and no farther from the CPU's fp64
# than FLOW_FP64_RATIO times the CPU's fp32
FLOW_CLIP = (16, 512, 512)
FLOW_ITERS = 12
FLOW_REPS = 5
FLOW_CPU_PAIRS, FLOW_CPU_SIZE, FLOW_CPU_ITERS = 2, 256, 32
FLOW_CARD_CPU_ATOL = 5e-3
FLOW_FP64_RATIO = 2.0
FLOW_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "flow", "raft_flyingchairs.yaml")
# phase 21: flow training through cli.flow_tools on synthetic FlyingChairs
# (384x512 .ppm pairs and .flo flows): the published crop and mmflow's
# per-card batch (8 cards x 2), FLOW_TRAIN_STEPS steps with a checkpoint
# after each; `test` on one synthetic Sintel pair at Sintel's 436x1024 (32
# iterations), `benchmark` at its 448x1024 default, `flops`
FLOW_CHAIRS = (4, 384, 512)   # samples, height, width
FLOW_CROP = (368, 496)
FLOW_BATCH = 2
FLOW_TRAIN_STEPS = 3
FLOW_SINTEL = (436, 1024)
# a resumed step against the uninterrupted one: the same state and batch
# give the same loss; the card's backward is nondeterministic (atomic adds
# in the gathers' and cuDNN's backward), and Adam's update divides each
# gradient by its own size, so a few of the smallest gradients flip: the
# whole update may move by this much, relative L2
FLOW_RESUME_REL = 1e-2


def flow_clip(seed, frames, height, width):
    """A seeded clip of a smooth random texture sliding a few pixels a
    frame, as uint8 (F, H, W, 3)."""
    rs = np.random.RandomState(seed)
    big = rs.rand(height // 8 + 8, width // 8 + 8, 3).astype(np.float32)
    big = np.kron(big, np.ones((8, 8, 1), np.float32))
    out = []
    for f in range(frames):
        dy, dx = 2 * f, 3 * f
        out.append(big[dy % 64:dy % 64 + height, dx % 64:dx % 64 + width])
    return (np.stack(out) * 255).astype(np.uint8)


def flow_model(seed, frames, device, gma=False):
    """A seeded RAFT (or GMA) on ``device`` with its context BN statistics
    calibrated on the first pairs of ``frames``."""
    from followyourclick_tpu_torch.flow.api import init_model
    from followyourclick_tpu_torch.flow.raft import RAFTConfig
    from followyourclick_tpu_torch.utils.backend_flags import (
        checked_precision,
    )

    model = init_model(RAFTConfig(use_gma=gma), seed=seed, device=device)
    x = torch.from_numpy((frames[:3].astype(np.float32) - 127.5) / 127.5)
    x = x.permute(0, 3, 1, 2).contiguous().to(device)
    with checked_precision():
        calibrate_bn_(model, x[:-1], x[1:], 1)
    return model


def phase_motion_score(seed, root, device="cuda", clip=FLOW_CLIP,
                       cpu_size=FLOW_CPU_SIZE):
    """Phase 20: ``flow.api.compute_motion_score`` on a seeded
    ``FLOW_CLIP`` clip (all 15 pairs in one batch, ``FLOW_ITERS``
    iterations) with seeded RAFT at the published widths, BN calibrated:
    median of ``FLOW_REPS`` warm calls by CUDA events, peak memory, one call
    under the profiler (idle share, device time by kernel); card vs CPU
    through ``inference_model`` (``FLOW_CPU_*``, against the CPU's fp32 and
    fp64); one GMA call card vs CPU; a synthetic mmflow-named state dict
    written to a ``.pth`` and loaded through
    ``load_mmflow_raft_checkpoint`` and ``init_model``, which must give the
    same flow bit for bit. No hand-written kernel may launch. ``device``,
    ``clip`` (frames, height, width) and ``cpu_size``: a rehearsal on the
    CPU. Returns the launches."""
    from followyourclick_tpu_torch.flow.api import (
        compute_motion_score,
        inference_model,
        init_model,
    )
    from followyourclick_tpu_torch.flow.convert import (
        load_mmflow_raft_checkpoint,
    )
    from followyourclick_tpu_torch.flow.raft import RAFT

    frames = flow_clip(seed, *clip)
    model = flow_model(seed, frames, device)
    n = sum(p.numel() for p in model.parameters())
    wrappers = launches_zeroed()
    t0 = time.perf_counter()
    score = compute_motion_score(model, frames, FLOW_ITERS)
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ms, scores = event_ms(lambda: compute_motion_score(model, frames,
                                                       FLOW_ITERS),
                          reps=FLOW_REPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pairs = clip[0] - 1
    corr0 = pairs * (clip[1] // 8 * clip[2] // 8) ** 2 * 4 / 2 ** 30
    log(f"[flow] RAFT ({n / 1e6:.2f} M parameters, fp32) motion score of a "
        f"{clip[0]}-frame {clip[1]}x{clip[2]} clip ({pairs} "
        f"pairs, {FLOW_ITERS} iterations): {score:.4f}; cold {cold:.2f} s, "
        f"warm {' / '.join(f'{t:.2f}' for t in ms)} ms, median "
        f"{float(np.median(ms)):.2f} ms; peak device memory {peak:.2f} GiB "
        f"(level-0 correlation {corr0:.2f} GiB) ({CARD})")
    if not np.isfinite(score) or score <= 0 \
            or abs(scores - score) > 1e-6 * score:
        raise SystemExit("[flow] the motion score is not finite and "
                         "positive, or changes between calls")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    wall, _, _, spans, busy = profiled(
        acts, lambda: compute_motion_score(model, frames, FLOW_ITERS))
    by_name = collections.Counter()
    for start, end, name in spans:
        by_name[name] += (end - start) / 1e6
    log(f"[flow] profiled motion score: wall {wall * 1e3:.2f} ms, device "
        f"busy {busy * 1e3:.2f} ms, idle share {1 - busy / wall:.3f}; "
        f"{len(spans)} device intervals ({CARD})")
    for name, t in by_name.most_common(8):
        log(f"[flow]   {t * 1e3:9.3f} ms  {name[:110]}")

    # card vs CPU, and both against the CPU's fp64
    small = flow_clip(seed + 1, FLOW_CPU_PAIRS + 1, cpu_size, cpu_size)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu = init_model(checkpoint=state, device="cpu")
    got = inference_model(model, small[:-1], small[1:], FLOW_CPU_ITERS)
    t0 = time.perf_counter()
    want = inference_model(cpu, small[:-1], small[1:], FLOW_CPU_ITERS)
    cpu_s = time.perf_counter() - t0
    exact = inference_model(copy.deepcopy(cpu).double(), small[:-1],
                            small[1:], FLOW_CPU_ITERS)
    err = float(np.abs(got - want).max())
    card64 = float(np.abs(got.astype(np.float64) - exact).max())
    cpu64 = float(np.abs(want.astype(np.float64) - exact).max())
    log(f"[flow] RAFT {FLOW_CPU_PAIRS} pairs {cpu_size}², "
        f"{FLOW_CPU_ITERS} iterations, max |flow| {np.abs(want).max():.2f} "
        f"px: card vs CPU {err:.3e} px (bound {FLOW_CARD_CPU_ATOL:g}); "
        f"against the CPU's fp64: card {card64:.3e}, CPU fp32 {cpu64:.3e} "
        f"(ratio {card64 / cpu64:.3f}, bound {FLOW_FP64_RATIO:g}); the CPU "
        f"fp32 call took {cpu_s:.2f} s")
    if got.shape != want.shape or err > FLOW_CARD_CPU_ATOL \
            or card64 > FLOW_FP64_RATIO * cpu64:
        raise SystemExit("[flow] RAFT disagrees card vs CPU")
    gma = flow_model(seed + 2, small, device, gma=True)
    gma_cpu = init_model(gma.config, checkpoint={
        k: v.cpu() for k, v in gma.state_dict().items()}, device="cpu")
    g_got = inference_model(gma, small[:-1], small[1:], FLOW_ITERS)
    g_want = inference_model(gma_cpu, small[:-1], small[1:], FLOW_ITERS)
    g_err = float(np.abs(g_got - g_want).max())
    log(f"[flow] GMA ({sum(p.numel() for p in gma.parameters()) / 1e6:.2f} "
        f"M parameters) {FLOW_CPU_PAIRS} pairs {cpu_size}², "
        f"{FLOW_ITERS} iterations: max |flow| {np.abs(g_want).max():.2f} "
        f"px, card vs CPU {g_err:.3e} px (bound {FLOW_CARD_CPU_ATOL:g})")
    if not np.isfinite(g_got).all() or g_err > FLOW_CARD_CPU_ATOL:
        raise SystemExit("[flow] GMA disagrees card vs CPU")

    # an mmflow-named checkpoint file
    path = os.path.join(root, "raft_8x2_100k_flyingchairs_368x496.pth")
    torch.save({"meta": {"iter": 100000}, "state_dict": state}, path)
    loaded = load_mmflow_raft_checkpoint(path, RAFT().to(device).eval())
    again = init_model(checkpoint=path, device=device)
    flows = [inference_model(m, small[:-1], small[1:], FLOW_ITERS)
             for m in (model, loaded, again)]
    log(f"[flow] mmflow checkpoint {os.path.getsize(path) / 2 ** 20:.1f} "
        f"MiB loaded strictly; flow of the loaded models minus the "
        f"original's: {float(np.abs(flows[1] - flows[0]).max()):.1e} / "
        f"{float(np.abs(flows[2] - flows[0]).max()):.1e}")
    if not (np.array_equal(flows[0], flows[1])
            and np.array_equal(flows[0], flows[2])):
        raise SystemExit("[flow] the loaded checkpoint gives another flow")
    got = {name: fn.launches for name, fn in wrappers.items()}
    if any(got.values()):
        raise SystemExit(f"[flow] a hand-written kernel launched: {got}")
    return got


def write_flying_chairs(root, seed, chairs=FLOW_CHAIRS):
    """``chairs`` (samples, height, width) synthetic FlyingChairs samples
    under ``root``: ``NNNNN_img1.ppm`` / ``_img2.ppm`` (binary P6) and
    ``_flow.flo``."""
    from followyourclick_tpu_torch.flow.flow_io import write_flow

    n, h, w = chairs
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        clip = flow_clip(seed + i, 2, h, w)
        for k in (0, 1):
            with open(os.path.join(root, f"{i:05d}_img{k + 1}.ppm"),
                      "wb") as f:
                f.write(f"P6\n{w} {h}\n255\n".encode() + clip[k].tobytes())
        write_flow((3 * rs.randn(h, w, 2)).astype(np.float32),
                   os.path.join(root, f"{i:05d}_flow.flo"))


def cli_lines(argv):
    """``cli.flow_tools.main(argv)`` with its standard output captured:
    (seconds, the lines it printed)."""
    import io

    from followyourclick_tpu_torch.cli import flow_tools

    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        flow_tools.main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out.getvalue().splitlines()


def phase_flow_train(seed, root, device="cuda", chairs=FLOW_CHAIRS,
                     crop=FLOW_CROP, sintel_size=FLOW_SINTEL,
                     bench_size=None):
    """Phase 21: ``cli.flow_tools`` on synthetic data. ``train`` from the
    published config (``FLOW_CONFIG``, a checkpoint after every step) on
    :func:`write_flying_chairs` at ``FLOW_CROP`` x ``FLOW_BATCH`` for
    ``FLOW_TRAIN_STEPS`` steps: each step's loss finite, warm ms per step
    (the loop's host clock, which the loss read waits for), peak memory,
    every parameter and BN statistic moved from the seeded start; a second
    ``train`` in another work dir resumed from the first run's
    second-to-last checkpoint takes the last step on the same batch (its
    loss equal within 1e-6, its update within ``FLOW_RESUME_REL``);
    ``test`` of the last checkpoint on one synthetic Sintel pair at
    ``FLOW_SINTEL`` (32 iterations), ``benchmark`` at its
    448x1024 default, ``flops``. No hand-written kernel may launch.
    ``device``, ``chairs``, ``crop``, ``sintel_size`` and ``bench_size``:
    a rehearsal on the CPU. Returns the launches."""
    import ast
    import shutil

    import yaml

    from followyourclick_tpu_torch.flow.api import init_model
    from followyourclick_tpu_torch.flow.flow_io import write_flow
    from followyourclick_tpu_torch.flow.raft import RAFT

    data = os.path.join(root, "chairs")
    write_flying_chairs(data, seed, chairs)
    with open(FLOW_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["train"]["checkpoint_every"] = 1
    config = os.path.join(root, "raft.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    wrappers = launches_zeroed()
    common = ["--device", device, "--seed", str(seed)]

    def train(work, steps):
        s, lines = cli_lines(common + [
            "train", "--config", config, "--data-root", data,
            "--work-dir", work, "--max-steps", str(steps), "--batch-size",
            str(FLOW_BATCH), "--crop", *map(str, crop)])
        logs = {}
        for line in lines:
            if line.startswith("iter "):
                step, metrics = line[5:].split(": ", 1)
                logs[int(step)] = ast.literal_eval(metrics)
        return s, logs

    torch.cuda.reset_peak_memory_stats()
    first = os.path.join(root, "work_a")
    secs, logs = train(first, FLOW_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    warm = [logs[s]["time"] * 1e3 for s in sorted(logs)[1:]]
    log(f"[flow train] cli.flow_tools train, RAFT, crop {crop[0]}x"
        f"{crop[1]} x {FLOW_BATCH}, {cfg['train']['iters']} "
        f"iterations: {FLOW_TRAIN_STEPS} steps in {secs:.2f} s (model "
        f"build, data, checkpoints included); step ms cold "
        f"{logs[0]['time'] * 1e3:.1f}, warm "
        f"{' / '.join(f'{t:.1f}' for t in warm)}; peak device memory "
        f"{peak:.2f} GiB ({CARD})")
    for step in sorted(logs):
        log(f"[flow train]   iter {step}: loss {logs[step]['loss']:.4f}, "
            f"EPE {logs[step]['epe']:.4f}, grad norm "
            f"{logs[step]['grad_norm']:.3f}")
    if sorted(logs) != list(range(FLOW_TRAIN_STEPS)) or not all(
            np.isfinite(m["loss"]) for m in logs.values()):
        raise SystemExit("[flow train] a step is missing or its loss is "
                         "not finite")
    last = torch.load(os.path.join(first, f"iter_{FLOW_TRAIN_STEPS}.pth"),
                      map_location="cpu", weights_only=True)["state_dict"]
    start = init_model(seed=seed, device=device).state_dict()
    still = [k for k, v in last.items() if not k.endswith(
        "num_batches_tracked") and torch.equal(v, start[k].cpu())]
    if still:
        raise SystemExit(f"[flow train] {len(still)} tensors never moved, "
                         f"e.g. {still[:3]}")

    second = os.path.join(root, "work_b")
    os.makedirs(second)
    step = FLOW_TRAIN_STEPS - 1
    shutil.copy(os.path.join(first, f"iter_{step}.pth"), second)
    _, resumed = train(second, FLOW_TRAIN_STEPS)
    before = torch.load(os.path.join(first, f"iter_{step}.pth"),
                        map_location="cpu", weights_only=True)["state_dict"]
    again = torch.load(os.path.join(second, f"iter_{FLOW_TRAIN_STEPS}.pth"),
                       map_location="cpu", weights_only=True)["state_dict"]
    with torch.device("meta"):
        params = dict(RAFT().named_parameters())
    names = [k for k in last if k in params]
    upd_a = torch.cat([(last[k] - before[k]).double().flatten()
                       for k in names])
    upd_b = torch.cat([(again[k] - before[k]).double().flatten()
                       for k in names])
    upd_rel = float((upd_a - upd_b).norm() / upd_a.norm())
    loss_rel = abs(resumed[step]["loss"] - logs[step]["loss"]) / abs(
        logs[step]["loss"])
    log(f"[flow train] resumed from iter_{step}.pth: logged steps "
        f"{sorted(resumed)}, step {step} loss {resumed[step]['loss']:.6f} "
        f"vs {logs[step]['loss']:.6f} uninterrupted (relative "
        f"{loss_rel:.2e}); its update against the uninterrupted one: "
        f"relative L2 {upd_rel:.3e} (bound {FLOW_RESUME_REL:g}), max |Δ| "
        f"{float((upd_a - upd_b).abs().max()):.3e}")
    if sorted(resumed) != [step] or loss_rel > 1e-6 \
            or upd_rel > FLOW_RESUME_REL:
        raise SystemExit("[flow train] the resumed step differs from the "
                         "uninterrupted one")

    sintel = os.path.join(root, "sintel")
    h, w = sintel_size
    clip = flow_clip(seed + 9, 2, h, w)
    from PIL import Image

    os.makedirs(os.path.join(sintel, "clean", "alley_1"))
    os.makedirs(os.path.join(sintel, "flow", "alley_1"))
    for k in (0, 1):
        Image.fromarray(clip[k]).save(os.path.join(
            sintel, "clean", "alley_1", f"frame_{k + 1:04d}.png"))
    write_flow(np.zeros((h, w, 2), np.float32),
               os.path.join(sintel, "flow", "alley_1", "frame_0001.flo"))
    secs, lines = cli_lines(common + [
        "test", "--config", config, "--checkpoint",
        os.path.join(first, f"iter_{FLOW_TRAIN_STEPS}.pth"),
        "--data-root", sintel, "--dataset", "Sintel", "--iters", "32"])
    epe = json.loads(lines[-1])["EPE"]
    log(f"[flow train] cli.flow_tools test, Sintel {h}x{w}, 32 iterations: "
        f"EPE against a zero flow {epe:.3f} in {secs:.2f} s")
    secs, lines = cli_lines(common + [
        "benchmark", "--config", config, "--warmup", "2", "--max-iter", "5",
        *(["--size", *map(str, bench_size)] if bench_size else [])])
    bench = json.loads(lines[-1])
    log(f"[flow train] cli.flow_tools benchmark, RAFT {bench['size']}: "
        f"{bench['fps']} pairs/s ({CARD}; {secs:.2f} s)")
    _, lines = cli_lines(["flops", "--config", config])
    flops = json.loads(lines[-1])
    log(f"[flow train] cli.flow_tools flops: {flops}")
    if not np.isfinite(epe) or bench["fps"] <= 0 or flops["gflops"] <= 0:
        raise SystemExit("[flow train] test, benchmark or flops failed")
    got = {name: fn.launches for name, fn in wrappers.items()}
    if any(got.values()):
        raise SystemExit(f"[flow train] a hand-written kernel launched: "
                         f"{got}")
    return got


# phase 22: the other estimators, at the published widths of their configs
FLOW_ESTIMATOR_CONFIGS = (
    "pwcnet_slong_flyingchairs", "flownets_slong_flyingchairs",
    "flownetc_slong_flyingchairs", "flownet_css_sfine_flyingthings3d",
    "flownet2_sfine_flyingthings3d", "maskflownets_slong_flyingchairs",
    "maskflownet_flyingthings3d", "irrpwc_sshort_flyingchairsocc",
    "liteflownet_pre_flyingchairs", "liteflownet2_pre_flyingchairs")
FLOW_EST_SIZE = (256, 384)
# every output card vs CPU (relative L2), and each output's distance from
# the CPU's fp64 at most FLOW_FP64_RATIO times the CPU fp32's
FLOW_EST_REL = 1e-3
FLOW_EST_BENCH = ("--warmup", "3", "--max-iter", "10")
# one camera-motion clip, card vs CPU uint8: the bound the CPU tests hold
# the port to against OpenCV's warpAffine
CAMERA_CLIP = (16, 512)        # frames, side
CAMERA_IMAGE = (768, 1024)
CAMERA_MAX_DIFF = 1
CAMERA_DIFF_SHARE = 1e-4


def rel_l2_64(a, b):
    """Relative L2 in float64 (an fp32 result against an fp64 one)."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def flow_pair(seed, height, width, device, dtype=torch.float32):
    """A seeded normalised pair ``(1, 3, H, W)`` each: a smooth texture and
    the same shifted by a few pixels."""
    clip = flow_clip(seed, 2, height, width).astype(np.float64)
    x = torch.from_numpy((clip - 127.5) / 127.5).permute(0, 3, 1, 2)
    x = x.to(device, dtype).contiguous()
    return x[:1], x[1:]


def named_outputs(model, img1, img2):
    """Every output of the training-mode forward and the inference flow,
    flat by name (``level2``, ``flow_bw.level4.1``, ``mask``,
    ``inference``)."""
    from followyourclick_tpu_torch.flow.maskflownet import MaskFlowNetS

    kw = {"return_mask": True} if isinstance(model, MaskFlowNetS) else {}
    with torch.no_grad():
        out = model(img1, img2, **kw)
        inf = model(img1, img2, inference=True)
    flat = {}
    if kw:
        out, flat["mask"] = out
    if isinstance(out, tuple):
        for part in out:
            for d, levels in part.items():
                for level, ts in levels.items():
                    for i, t in enumerate(ts):
                        flat[f"{d}.{level}.{i}"] = t
    else:
        flat.update(out)
    flat["inference"] = inf
    return flat


def flow_losses(model, outputs, img1, seed):
    """``multi_level_epe_loss`` over the levels (IRR-PWC: the refined
    forward flows of levels 6-2) against a seeded flow, and IRR-PWC's
    ``multi_level_bce`` over its forward occlusions, as floats."""
    from followyourclick_tpu_torch.flow.irrpwc import IRRPWC
    from followyourclick_tpu_torch.flow.losses import multi_level_epe_loss
    from followyourclick_tpu_torch.flow.unsup_losses import multi_level_bce

    B, _, H, W = img1.shape
    gen = torch.Generator().manual_seed(seed)
    gt = (4 * torch.randn(B, 2, H, W, generator=gen)).to(img1)
    if isinstance(model, IRRPWC):
        levels = {f"level{k}": outputs[f"flow_fw.level{k}.1"]
                  for k in range(6, 1, -1)}
        occ = {f"level{k}": [outputs[f"occ_fw.level{k}.{i}"]
                             for i in (0, 1)] for k in range(6, 1, -1)}
        target = (torch.rand(B, 1, H, W, generator=gen) > 0.8).to(img1)
        bce = float(multi_level_bce(occ, target, balance=True))
    else:
        levels = {k: v for k, v in outputs.items() if k.startswith("level")}
        bce = None
    weights = {k: 0.005 * 4 ** i for i, k in enumerate(sorted(levels))}
    return float(multi_level_epe_loss(levels, gt, weights)), bce


def camera_check(seed, device):
    """One ``CameraMotionAugmentation`` clip (``rotate_cw``) on ``device``
    against the CPU's: (ms on the device, bytes that differ, max diff)."""
    from followyourclick_tpu_torch.data.camera_motion import (
        CameraMotionAugmentation,
    )

    rs = np.random.RandomState(seed)
    h, w = CAMERA_IMAGE
    image = (np.kron(rs.rand(h // 8, w // 8, 3), np.ones((8, 8, 1)))
             * 255).astype(np.uint8)
    frames, side = CAMERA_CLIP
    aug = CameraMotionAugmentation(frames, side, device=device)
    aug(image, "rotate_cw")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, idx = aug(image, "rotate_cw")
    ms = (time.perf_counter() - t0) * 1e3
    want, _ = CameraMotionAugmentation(frames, side, device="cpu")(
        image, "rotate_cw")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return ms, int((diff > 0).sum()), int(diff.max()), got.shape, idx


def phase_flow_estimators(seed, device="cuda", size=FLOW_EST_SIZE,
                          bench_size=None, configs=FLOW_ESTIMATOR_CONFIGS):
    """Phase 22: the estimators of ``configs`` (``configs/flow/<name>.yaml``)
    at their published widths, seeded, fp32 (the caller sets the numerics
    contract; ``flow_tools.main`` sets it again): (a) every output of the
    training-mode forward and the inference flow on a seeded ``size`` pair,
    card vs CPU within ``FLOW_EST_REL`` (relative L2) and each against the
    CPU's fp64 within ``FLOW_FP64_RATIO`` times the CPU fp32's distance;
    (b) the multi-level losses card vs CPU; (c) ``flow_tools benchmark``
    (448x1024 unless ``bench_size``) and ``flops``; (d) no launches; and
    one camera-motion clip card vs CPU. ``device``, ``size``,
    ``bench_size``: a rehearsal on the CPU. Returns the launches."""
    import yaml

    from followyourclick_tpu_torch.flow.api import init_model
    from followyourclick_tpu_torch.flow.registry import flow_estimator

    here = os.path.dirname(os.path.abspath(__file__))
    wrappers = launches_zeroed()
    rows, failures = [], []
    for i, name in enumerate(configs):
        config = os.path.join(here, "configs", "flow", f"{name}.yaml")
        with open(config) as f:
            spec = flow_estimator(yaml.safe_load(f)["model"])
        model = init_model(spec, seed=seed + i, device=device)
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        cpu = init_model(spec, checkpoint=state, device="cpu")
        img1, img2 = flow_pair(seed + i, *size, device)
        t0 = time.perf_counter()
        got = named_outputs(model, img1, img2)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        want = named_outputs(cpu, img1.cpu(), img2.cpu())
        exact = named_outputs(copy.deepcopy(cpu).double(),
                              img1.cpu().double(), img2.cpu().double())
        worst = (0.0, 0.0, "")
        for k in want:
            err = rel_l2_64(got[k], want[k])
            card64 = rel_l2_64(got[k], exact[k])
            cpu64 = rel_l2_64(want[k], exact[k])
            if not torch.isfinite(got[k]).all() or err > FLOW_EST_REL \
                    or card64 > FLOW_FP64_RATIO * cpu64:
                failures.append(f"{name} {k}: card vs CPU {err:.2e}, "
                                f"against fp64 card {card64:.2e} CPU "
                                f"{cpu64:.2e}")
            worst = max(worst, (err, card64 / max(cpu64, 1e-30), k))
        epe, bce = flow_losses(model, got, img1, seed)
        epe_cpu, bce_cpu = flow_losses(cpu, want, img1.cpu(), seed)
        loss_err = abs(epe - epe_cpu) / abs(epe_cpu)
        if bce is not None:
            loss_err = max(loss_err, abs(bce - bce_cpu) / abs(bce_cpu))
        if not np.isfinite(epe) or loss_err > FLOW_EST_REL:
            failures.append(f"{name} losses: EPE {epe} vs {epe_cpu}, BCE "
                            f"{bce} vs {bce_cpu}")
        del model, cpu
        gc.collect()
        torch.cuda.empty_cache()
        _, lines = cli_lines([
            "--device", device, "--seed", str(seed), "benchmark",
            "--config", config, *FLOW_EST_BENCH,
            *(["--size", *map(str, bench_size)] if bench_size else [])])
        bench = json.loads(lines[-1])
        _, lines = cli_lines(["flops", "--config", config,
                              *(["--size", *map(str, bench_size)]
                                if bench_size else [])])
        flops = json.loads(lines[-1])
        rate = flops["gflops"] * 1e9 / (bench["median_ms"] / 1e3)
        rows.append((name, flops, bench, rate))
        log(f"[flow est] {spec.cls.__name__} ({name}, "
            f"{flops['params_m']} M): {len(want)} outputs at "
            f"{size[0]}x{size[1]}, worst card vs CPU {worst[0]:.2e} "
            f"({worst[2]}), worst card/CPU distance from fp64 "
            f"{worst[1]:.3f} (bounds {FLOW_EST_REL:g}, "
            f"{FLOW_FP64_RATIO:g}); EPE loss {epe:.6f} vs {epe_cpu:.6f}"
            + (f", BCE {bce:.6f} vs {bce_cpu:.6f}" if bce is not None
               else "") + f"; first card call {card_s:.2f} s")
        log(f"[flow est]   benchmark {bench['size'][0]}x{bench['size'][1]}:"
            f" {1e3 / bench['median_ms']:.2f} pairs/s (median "
            f"{bench['median_ms']:.3f} ms; mean {bench['fps']} pairs/s), "
            f"peak {bench['peak_gib']} GiB; {flops['gflops']} GFLOP a "
            f"pair, {rate / 1e12:.2f} TFLOP/s = "
            f"{rate / PEAK_FP32_OPS:.3f} of the fp32 peak ({CARD})")
    ms, differ, worst, shape, idx = camera_check(seed, device)
    log(f"[flow est] CameraMotionAugmentation rotate_cw (type {idx}), "
        f"{shape} from {CAMERA_IMAGE[0]}x{CAMERA_IMAGE[1]}: {ms:.2f} ms "
        f"warm on the card; card vs CPU {differ} bytes differ, max "
        f"{worst} (bounds {CAMERA_MAX_DIFF}, share "
        f"{CAMERA_DIFF_SHARE:g})")
    if worst > CAMERA_MAX_DIFF or differ > CAMERA_DIFF_SHARE * np.prod(
            shape):
        failures.append(f"camera clip: {differ} bytes differ, max {worst}")
    got = {name: fn.launches for name, fn in wrappers.items()}
    if any(got.values()):
        failures.append(f"a hand-written kernel launched: {got}")
    if failures:
        raise SystemExit("[flow est] " + "; ".join(failures))
    return got


def timed(fn):
    """``fn`` with a log line of the seconds it took."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log(f"[smoke] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out
    run.__name__ = fn.__name__
    return run


def checked_precision():
    """The port's numerics contract (``utils/backend_flags``): TF32 and
    bf16 reduced-precision reduction off inside the block."""
    from followyourclick_tpu_torch.utils.backend_flags import (
        checked_precision as contract,
    )

    return contract()


def direct(fn):
    """A phase that calls modules directly: run under the contract the
    entry points set for themselves."""
    def run(*args, **kwargs):
        with checked_precision():
            return fn(*args, **kwargs)
    run.__name__ = fn.__name__
    return run


def via_entry_points(fn, defaults):
    """A phase that goes through the port's entry points, under the
    process's flags: afterwards they must be ``defaults`` again (each entry
    point sets the contract and gives the caller's values back)."""
    from followyourclick_tpu_torch.utils.backend_flags import precision_flags

    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        if precision_flags() != defaults:
            raise SystemExit(f"{fn.__name__}: the precision flags are "
                             f"{precision_flags()} after it, not the "
                             f"process's {defaults}")
        return out
    run.__name__ = fn.__name__
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="DDIM steps per exact full-width request (4)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1

    from followyourclick_tpu_torch.pipelines.animation import SampleSpec
    from followyourclick_tpu_torch.pipelines.serving_schedules import (
        apply_schedule,
    )
    from followyourclick_tpu_torch.utils.backend_flags import precision_flags

    # PyTorch's defaults (cuDNN TF32 and bf16 reduced-precision reduction
    # on): the phases that call modules directly run under the port's
    # contract (direct), the others through entry points that set it
    defaults = precision_flags()
    log(f"[smoke] precision flags (matmul TF32, cuDNN TF32, bf16 reduced "
        f"reduction) of the process: {defaults}")

    def entry(fn):
        return timed(via_entry_points(fn, defaults))

    timed(phase_build)()
    stats = timed(direct(phase_kernels))(args.seed)
    timed(direct(phase_train_kernels))(args.seed)
    timed(direct(phase_tiny))(args.seed)
    timed(direct(phase_tiny_options))(args.seed)
    pipe = full_pipeline(args.seed)
    timed(direct(phase_evaluation))(pipe, args.seed)
    exact = SampleSpec(num_inference_steps=args.steps)
    serving = apply_schedule(SampleSpec(num_inference_steps=SERVING_STEPS),
                             SERVING_SCHEDULE)
    exact_by_hand = {"fused_motion_block": 20 * args.steps,
                     "fused_ln_geglu": 16 * args.steps,
                     "fused_temporal_block": 0, "temporal_attention": 0,
                     "flash_attention": 0}
    batched_by_hand = {**exact_by_hand, "flash_attention":
                       BATCHED_FLASH_PER_EXACT_STEP * args.steps}
    requests = timed(direct(phase_requests))
    paths = {
        "exact": requests(pipe, exact, "full", args.seed, exact_by_hand)[0],
        SERVING_SCHEDULE: requests(pipe, serving, "serving", args.seed,
                                   SERVING_LAUNCHES)[0],
        f"exact_{BATCH}clips": requests(pipe, exact, "batched exact",
                                        args.seed, batched_by_hand,
                                        BATCH)[0],
        f"{SERVING_SCHEDULE}_{BATCH}clips": requests(
            pipe, serving, "batched serving", args.seed,
            BATCHED_SERVING_LAUNCHES, BATCH)[0],
    }
    paths.update(timed(direct(phase_sampler_options))(pipe, args.seed))
    # one full-width pipeline at a time
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    paths["camera_lora_exact"] = timed(direct(phase_camera))(
        args.seed, exact, exact_by_hand)
    gc.collect()
    torch.cuda.empty_cache()
    paths["exact_ip_plus"] = timed(direct(phase_ip))(args.seed, exact,
                                                     exact_by_hand)
    gc.collect()
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        paths.update(timed(direct(phase_t5))(args.seed, exact, exact_by_hand,
                                             serving, root))
        gc.collect()
        torch.cuda.empty_cache()
        paths["t5_text_tiny"] = entry(phase_t5_text)(args.seed, root)
    gc.collect()
    torch.cuda.empty_cache()
    paths["routes_evaluation"] = timed(direct(phase_routes))(args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        paths.update(entry(phase_cli)(args.seed, args.steps, root=root))
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(entry(phase_click)(args.seed, root, args.steps))
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(entry(phase_fill)(args.seed, root))
    gc.collect()
    torch.cuda.empty_cache()
    paths["train"] = entry(phase_train)(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        paths["remove"] = entry(phase_remove)(args.seed, root)
    gc.collect()
    torch.cuda.empty_cache()
    paths["lama_train"] = entry(phase_lama_train)(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        paths["motion_score"] = entry(phase_motion_score)(args.seed, root)
        gc.collect()
        torch.cuda.empty_cache()
        paths["flow_train"] = entry(phase_flow_train)(args.seed, root)
    gc.collect()
    torch.cuda.empty_cache()
    paths["flow_estimators"] = timed(direct(phase_flow_estimators))(args.seed)
    for name in KERNELS:
        if not sum(launches[name] for launches in paths.values()):
            raise SystemExit(f"{name} was never launched on a main path")

    covers = {
        "fused_motion_block": "the calls of one exact UNet evaluation",
        "fused_ln_geglu": "the calls of one exact UNet evaluation",
        "fused_temporal_block": "the calls of one full-batch UNet "
                                "evaluation on the modular path",
        "temporal_attention": "the calls of one full-batch UNet evaluation "
                              "on the modular path",
        "flash_attention": f"the calls of one exact UNet evaluation of "
                           f"{BATCH} clips",
        "fused_geglu": "unrouted, as in the JAX package; the 16 "
                       "feed-forward sites of one exact UNet evaluation "
                       "(the LN-GEGLU rows), without LN and residual",
        "fused_group_norm": "unrouted, as in the JAX package; the 81 "
                            "GroupNorm sites of one exact UNet evaluation "
                            "(library_ms: F.group_norm at the 36 sites "
                            "without SiLU only)",
        "fused_ln_cross_attention": "unrouted, as in the JAX package; the "
                                    "16 text cross-attention sites of one "
                                    "exact UNet evaluation, 77 keys",
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "routed": name in KERNELS,
                "launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {path: p[name]
                                     for path, p in paths.items()},
                "max_abs_err": stats[name]["err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
                "bound_ms": stats[name]["bound_ms"],
                "bound_by": stats[name]["bound_by"],
                "library_ms": stats[name]["library_ms"],
                "ms_covers": covers[name] + " at 16 f / 512^2 CFG, bf16",
                **({"cross_frame": stats[name]["cross_frame"]}
                   if "cross_frame" in stats[name] else {})}
               for name, (src, rep) in {**KERNELS, **UNROUTED}.items()]
    log(f"[smoke] {time.perf_counter() - t_start:.1f} s in all ({CARD})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
