#!/usr/bin/env python3
"""Drive the PyTorch port (``semivl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # one card: phases 1-18
    python3 chip_smoke.py --cards N   # N cards: phase 14 across them

Phases, each of which fails the run (non-zero exit, no result line):

1. identify the card (torch/CUDA versions, name and power limit);
2. build the CUDA kernels from ``semivl_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) into the ignored ``semivl_tpu_torch/_build``, and
   read the SASS (``cuobjdump``): wgmma and TMA loads in every instance of
   the attention forwards, of the attention backward's dK/dV and dQ
   kernels and of the decoder's igemm conv and wgrad kernels (the
   forward with the fused Up stage, the whole-plane backward, the banded
   passes A, B and C), no mma.sync;
3. packed attention kernels, forward and backward, against their plain
   versions and their rounded references at the flagship shapes (encoder
   and semantic transformer, and a ``valid_len`` case), the Cityscapes
   ones (the 801^2 encoder at L = 2602 and an edge crop at L = 869), the
   SemanticTransformer along COCO's 81 and ADE20K's 150 classes (192
   sequences; L = 150 spans two key tiles) and the timm ViT's encoder on
   2 + 2 crops, with
   SDPA's times beside (device-only too, from the profiler: windows whose
   records are whole), and
   planted faults (the last key tile skipped, forward and backward, at
   the Cityscapes encoder and each of the new shapes) that must fail;
4. fused VLG decoder kernels, forward and backward (tail and input), against
   their plain versions and their rounded references at the flagship
   decoder shapes (the forward at P = 42, at the VOC step's P = 126 and
   ADE20K's P = 3 x 150 = 450, at the Cityscapes 51^2 and edge-crop grids,
   timed by events and
   device-only beside cuDNN's chain, with two planted faults that must
   fail: conv1's skip half left out inside the kernel's sequence, stage 2
   reading its input without GN+ReLU; the whole-plane backward, at P = 126
   and at ADE20K's P = 450, against the
   reference with its bf16 gradient roundings, float64 sums at the
   forward's stored stage-1 conv2, and, forward and backward composed,
   against that reference recomputing stage 1), with planted faults that
   the backward's limit must catch (one inside the igemm wgrad reduction)
   and forward faults of stage 1 that the composed limit must catch,
   the tail, input and whole backward timed by events and device-only
   beside cuDNN's backward; the
   banded backward (passes A, B and C) at the Cityscapes stage shapes: each
   pass against its plain pass on its own inputs, the composed backward
   against the rounded references the whole-plane backward is held to
   (the float32-sum reference's distance logged as data) and against the
   whole-plane kernels, planted faults that must fail (one
   inside pass A's tensor-core product; pass B's wgrad reduction without
   its last plane, inside the kernel, must fail the per-pass limit too),
   and the times of each pass (with
   the library's convolutions for the same work beside), the whole-plane
   pair and cuDNN's chain;
5. evaluation: the full-width flagship model (ViT-B/16 + VLG, VOC-21, bf16
   compute, seeded random weights) evaluated with ``zegclip_sliding_window``
   over synthetic uint8 images at VOC val geometry, with the launch counts
   of the forward kernels read around that run; then one crop batch through
   the kernels and through the plain versions; the wall time and the
   device's idle share of ``evaluate`` pipelined (the prefetch thread and
   the device histograms, the defaults) and serial, in turns, with equal
   histograms;
6. training: the full-width flagship training bundle (student + frozen
   MaskCLIP guidance encoder + VLG) takes SemiVL steps (exp 40: 2 labeled +
   2 unlabeled 512^2 crops, AdamW) on a synthetic batch, with every
   kernel's launches read around the timed steps; one step with the
   kernels against one with the rounded references from the same state,
   batch and feature-perturbation masks, and a step with a planted fault
   that must fail; a profile of one step;
7. Cityscapes evaluation: the full-width exp-44 model (ViT-B/16 + ResNetV1c
   skip encoder + VLG, 19 classes, seeded random weights) evaluated with
   ``sliding_window`` over one synthetic 1024x2048 image (8 windows of 4
   shapes), launch counts read around it, one crop batch through the
   kernels and the plain versions, a profile of the image, ``evaluate``
   pipelined and serial as in phase 5;
8. Cityscapes training: exp 44's step (1 labeled + 1 unlabeled 801^2 crop,
   the decoder backward on the banded route): one step with every kernel
   call held to its rounded reference on that call's own inputs, then
   timed steps with launch counts asserted (banded passes 4 each, the
   whole-plane backward 0), BatchNorm running statistics changed and
   frozen leaves unchanged, a profile of one step;
9. head-split attention kernels (#1/#2), forward and backward, against
   their plain versions (which round where they do) at encoder widths
   (12 heads of 64 forced through them at L = 2602 and held against the
   packed kernels on the same input, 11 heads of 64, 24 heads of 32 with
   and without ``valid_len``, 12 heads of 128), the tiny VLM's shapes,
   the widths whose products are split (48, 80, 96, 112) and two above 128
   (136 and 256, on the CUDA-core kernels), planted faults that must fail,
   the dispatcher's routes on the card (JAX's table; heads of 24 and 72
   zero-padded to 32 and 80 under 'auto', heads of 136 and 256 under
   'auto' and 'pallas', forward and backward), with SDPA's times beside
   (also device-only);
10. the fused Up stage (#11): its bench entry point
   (``tools.fused_up_bench``, the flagship's two stages at 14 x 21
   planes) with launches counted around it, then each stage with and
   without the head against its plain version, its rounded reference and
   cuDNN's chain (times by events and device-only), two planted faults
   (conv1 without its top-left tap; conv1's skip half left out inside the
   kernel's sequence), and two stages at widths it zero-pads (Cu 80 and
   Cs 24; Cu 144 in two column groups and Cs 8);
11. the tiny VLM (``tiny-vlm-test`` + ``tiny-mcvit-test``, every attention
   on the head-split kernels under ``attention_impl = 'pallas'``):
   ``zegclip_sliding_window`` evaluation of 64-px-scale images and SemiVL
   steps, every kernel call of one step held to its reference, launch
   counts derived from the configs; phases 5-8 assert that the flagship
   and Cityscapes paths launch no head-split kernel;
12. decoder widths beyond the shipped models' (run right after phase 10):
   Cout 48 and 96, Cin 24 (padded), 48 and 224, Cu and Cs 112 (column
   groups), Cout 8, 24, 40 (GroupNorm groups zero-padded to whole chunks
   of 16 channels), 112, 128 and 160 (column groups), forward and both
   backward routes on the kernels (launches counted), against the rounded
   references with the limits of phase 4;
13. the trainer entry point (the CLI ``python -m
   semivl_tpu_torch.tools.train``, called in this process): a synthetic
   dataset at VOC geometry (500x375 JPEG images and palette PNG label
   maps: 2 labeled, 4 unlabeled, 2 val) written to a temporary directory,
   exp 40's generated split-92 config pointed at it, trained at full width
   for one epoch (2 steps of 2 + 2 crops) with one evaluation, from phase
   6's seeded weights (``init_param_overrides``); every kernel's launches
   read around it must be twice phase 6's per step plus the evaluation's;
   the run dir's files, finite losses and parameters; then a run
   preempted after its first step (``preempt_at_step=0``) and resumed
   (``--resume-from``) to the same iteration, its distance from the
   uninterrupted run logged; whether the native decode built;
14. data-parallel training: ranks are processes of this script
   (``--rank-worker``) started with torchrun's environment, each killed
   if it outlives its timeout; a rank that fails fails the phase. (a)
   The trainer CLI at ``WORLD_SIZE=1``: a real NCCL group, gradients and
   metrics through NCCL (one rank's histograms need no sum); its
   parameters ``torch.equal``
   to phase 13's uninterrupted run and its launches equal to phase 13's.
   (b) Two gloo ranks sharing card 0 (NCCL takes one rank a card; each
   rank makes its gloo group, which the trainer joins), on
   phase 13's dataset with 8 unlabeled images (2 steps of 2 + 2 crops a
   rank) and 2 val images (one a rank): a straight run, a run whose rank
   0 alone is preempted after step 0, and its resume; the ranks'
   trainable parameters and buffers ``torch.equal`` after every run,
   both ranks stopped after step 0, the resume ``torch.equal`` to the
   straight run, each rank's launches 2 x phase 6's per step plus its
   share of the evaluation, the global histograms integer-equal to one
   process's evaluation of the same weights, and step 0 bit-equal to
   one process that averages the two halves' gradients ((g0 + g1) / 2,
   as the all-reduce sums and divides) and takes the same AdamW step.
   (c) Exp 44's step on two gloo ranks (1 + 1 801^2 crops each, the
   banded backward): each rank's launches those of phase 8's step,
   trainable parameters and BatchNorm running statistics bit-equal on
   both ranks, the statistics within
   ``MULTI_RANK_STATS_TOL`` of one process's train-mode BatchNorm over
   both ranks' images batched together (and 10x farther from rank 0's
   images alone); each rank's ms per step and rank 0's idle share (the
   two ranks share the card: this measures the code path, not
   multi-card scaling);
15. the paper's other benchmarks and exp 41's ablation models, at full
   width, launch counts derived from each run config
   (``launches_per_step``, ``launches_per_call``) and asserted: (a) exp
   43's step (ADE20K: ViT-B/16 + VLG over 150 class planes a crop, the
   guidance encoder with ``ade_single``, 1 + 1 512^2 crops, the
   whole-plane backward): timed steps, peak memory, a profile, then one
   step with every kernel call held to its rounded reference on its own
   inputs and each decoder-backward call rerun with a planted fault that
   must fail; (b) exp 43's ``zegclip_sliding_window`` evaluation of one
   synthetic 512x2048 image (5 crops in batches of 4 + 1: 600 and 150
   planes), one crop batch through the kernels and the plain versions, a
   profile; (c) the CLI on exp 42's and exp 43's generated split configs
   over synthetic datasets of each geometry (COCO: 640x480 JPEGs, masks
   0-80 and 255, the val image shorter than the crop; ADE: short side
   512, masks 0-150), 2 steps and an evaluation each from phase 6's
   weights; (d) each of exp 41's three DeepLabV3+ models (MaskCLIP ViT
   ``ftap`` and ``ft``, timm ViT ``ft``): one step of 2 + 2 crops with
   every packed-attention call held to its rounded reference (no decoder
   or head-split kernel called), a step with its launches, the head's
   BatchNorm statistics changed, frozen leaves unchanged (``ftap``) or
   every backbone leaf changed (``ft``), an evaluation of one
   VOC-geometry image, and the CLI on the timm row's generated config for
   2 steps; phase 15's seconds and the whole run's are logged;
16. exp 41's ZegCLIP row (``vlm-zegclip-rd-pt-vitb``: the VPT CLIP
   ViT-B/16 with 10 prompt tokens, so #3/#4 at L = 1 + 10 + 1024 = 1035,
   the ATM head, SegLossPlus for both criteria) at full width and concept
   aggregation, launch counts derived from each run config: (a) the step
   of 2 + 2 512^2 crops, one step with every packed call held to its
   rounded reference on its own inputs and rerun with the last key tile
   skipped (which must fail), timed steps with #3 x 36 and #4 x 24 and
   nothing else, peak memory, a profile, frozen leaves bit-identical and
   every prompt and head leaf changed (but the leaves of the head's last
   layer that no loss reaches and no weight decay moves: its LayerNorms,
   whose decay the ``norm`` key turns off, and its zero biases); the
   checked step runs at ``conf_thresh`` 0, so its unlabeled
   SegLossPlus terms must be non-zero and finite (at the config's 0.95
   the random model keeps no pseudo-label); (b) the evaluation of one 512x683
   image, its crop batch through the kernels and the plain versions, a
   profile; (c) the CLI on exp 41's generated ZegCLIP split-92 config over
   phase 13's dataset, 2 steps and an evaluation from (a)'s weights; (d)
   exp 40's config with ``text_embedding_variant = pl_text =
   'concept4_single'``: every decoder call of one step over 98 planes a
   crop and within phase 15's limits, a step with its launches and a
   profile, the evaluation of one image; (e) #3 and #4 at (4, 1035, 768)/12 run with
   phase 3's cases (timed by events and device-only beside SDPA, the
   planted fault), before any profile;
17. the baselines SemiVL is compared with, launch counts derived from
   each run config: (a) exp 40's model as the supervised baseline (one
   train pass over 2 labeled 512^2 crops: #3 x 14, #4 x 13, #5 x 2, #6 and
   #7 x 2) and as UniMatch (the SemiVL step without the guidance encoder,
   2 + 2 crops: #3 x 42, #4 x 26, #5 x 6, #6 and #7 x 4), each with one
   step whose every kernel call is held to its rounded reference (planted
   faults in the decoder backward and the last key tile skipped must
   fail), timed steps, peak memory and a profile; (b) the UniMatch
   DeepLabV3+ on the dilated ResNet-101 (``dlv3p-r101``, the ``original``
   SGD): a step of 2 + 2 512^2 VOC crops and one of 1 + 1 801^2 Cityscapes
   crops with OHEM, BatchNorm in train mode in the student passes and on
   the running statistics in the teacher pass, no kernel launched; (c)
   ``dlv3p-xc65``'s step on VOC; (d) (a)'s UniMatch step with
   ``strong_aug_on_device`` and ``labeled_photometric_distortion`` on
   uint8 transport, and the card's augmented views against the same apply
   functions on the CPU on the same draws (``AUG_TOL``); (e) (b)'s model
   on one 512x683 image in ``original``, ``center_crop`` and
   ``padded_sliding_window`` (crop 512, stride 426), with ``predict(...,
   return_logits=True)``; (f) the CLI over phase 13's dataset for 2 steps
   and an evaluation: ``dlv3p-r101`` supervised with ``eval_mode =
   'original'``, and exp 40's config as UniMatch with
   ``strong_aug_on_device``, preempted after step 0 and resumed, which
   must end bit-equal to the straight run;
18. a ``kernels`` JSON line (all eleven kernels, with the launches of
   phase 14's, 15's, 16's and 17's runs by path), and last ``{"ok": true,
   "device": ...}``.

``--cards N`` runs phase 14's full-width paths on N cards, one NCCL rank a
card, and nothing else: the kernels' build, then (i) exp 40's trainer CLI
on a dataset as phase 13's (4N unlabeled images: 2 steps of 2 + 2 crops a
rank; N + 1 val images) from seeded weights, every rank's parameters and
buffers ``torch.equal`` after it, each rank's launches 2 x the step's plus
its share of the evaluation, the global histograms equal on every rank
and to one process's evaluation of the same weights; (ii) exp 44's step
(1 + 1 801^2 crops a rank, the banded backward, cross-rank BatchNorm):
each rank's launches those of phase 8's step, parameters and BatchNorm
statistics bit-equal to rank 0's, the statistics within
``MULTI_RANK_STATS_TOL`` of one process's train-mode BatchNorm over every
rank's images, each rank's ms per step and gradient mean, rank 0's idle
share. It ends with the card's line and the ``ok`` line as the one-card
run does.

Phase 9 runs right after phase 3 and phase 10 right after phase 4: once
the step and image profiles of phases 5-8 have run, the profiler on the
card's machine keeps no whole window of the kernel calls that they time
device-only (and once phase 10 has run, none of phase 4's).

Comparisons run with TF32 off. Times are CUDA-event means after warm-up
over a stream of calls; "device-only" times are the profiler's kernel
durations per call, which leave out the host's launch overhead that the
event time of a short call reads.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
# Two references per kernel. The plain version (the JAX package's math in
# bf16) rounds at other points than the kernel, so it is held to loose
# absolute limits. The rounded reference (``*_rounded``: float32 sums, bf16
# rounding where the kernel stores bf16) differs from the kernel only in the
# order of float32 sums, which flips rare bf16 roundings; it is held to
# tight relative-L2 limits, and planted faults must fail them. The decoder
# backward's reference sums in float64 at the point the kernels' forward
# reached (``raw2_1``): GroupNorm amplifies each flipped rounding of the
# stored conv2, and the reference's own float32 sums lie as far from its
# float64 ones as the limit.
ATTN_TOL = 2e-2             # vs plain, absolute: bf16 logits in the plain
ATTN_REL_TOL = 2e-3         # vs rounded, relative L2
DEC_TOL = 5e-2              # vs plain, relative to the logit scale
DEC_REL_TOL = 1e-2          # vs rounded, relative L2 (GroupNorm amplifies a
                            # flipped rounding of a raw conv output)
ATTN_BWD_TOL = 2e-2         # vs plain (same rounding points), of the scale
ATTN_BWD_REL_TOL = 5e-3     # relative L2
DEC_BWD_TOL = 2e-2          # per gradient leaf vs rounded (float64 sums at
                            # the forward's stored stage-1 conv2), relative
                            # L2 (H100: worst leaf 4.1e-3 at P = 126; a 3%
                            # fault must fail, 3.0e-2)
DEC_BWD_COMPOSED_TOL = 6e-2  # per leaf, forward and backward composed vs
                            # rounded with float64 sums recomputing stage 1
                            # (independent of what the forward stored):
                            # GroupNorm amplifies every flipped rounding of
                            # stage 1's raw conv2 (PERF.md: the readings
                            # behind it, tools/decoder_precision.py)
STEP_DEC_BWD_TOL = 5e-2     # per leaf, the decoder backward on a step's own
                            # inputs, as DEC_BWD_TOL's reference: the loss
                            # gradient sums to ~0 over each pixel's class
                            # planes, so the parameter gradients cancel
                            # (H100: 6.9e-3 VOC, 1.1e-2 to 2.4e-2
                            # Cityscapes)
TINY_DEC_BWD_TOL = 1.5e-2   # per leaf, the tiny step's decoder backward on
                            # each call's own inputs, as DEC_BWD_TOL's
                            # reference (H100: worst leaf 3.1e-3; planted
                            # faults 3.0e-2 and 0.58-0.62 must fail)
STEP_LOSS_TOL = 1e-3        # kernels vs rounded step: loss terms, relative
STEP_GRAD_TOL = 0.15        # median over the trainable leaves of the
                            # gradient's relative L2 (bf16 noise: 6.6e-2)
STEP_NORM_TOL = 1e-2        # global gradient norm ratio
STEP_AGREE_MIN = 0.995      # pseudo-label agreement (teacher and MaskCLIP)
VANISHING = 1e-6            # leaves whose gradient is below this share of
                            # the largest leaf's carry only rounding
TOTAL_ITERS = 1000          # schedule length of the training slice
# attention forward: teacher 14 + guidance encoder 12 + two student passes
# of 14 (12 encoder blocks + 2 semantic layers); backward: 13 per student
# pass, since the last encoder block's attention output feeds only the
# cls-token embedding, which the decoder does not read, so autograd never
# reaches its backward. Decoder: 2 stage launches per pass; its backward 2
# tail + 2 input per student pass.
# Every attention has heads of 64 in an even count: no head-split launch.
EXPECTED_PER_STEP = dict(attention_fwd=54, attention_bwd=26, heads_fwd=0,
                         heads_bwd=0, decoder_fwd=6, decoder_bwd_tail=4,
                         decoder_bwd_input=4, banded_pass_a=0,
                         banded_pass_b=0, banded_pass_c=0)
# exp 44 (1 + 1 crops): the same attention and forward counts (a launch
# serves a whole batch), the decoder backward on the banded route: passes
# A, B, C once per stage and student pass, no whole-plane launch
EXPECTED_CITYSCAPES = dict(EXPECTED_PER_STEP, decoder_bwd_tail=0,
                           decoder_bwd_input=0, banded_pass_a=4,
                           banded_pass_b=4, banded_pass_c=4)
# per kernel call of a training step, on the call's own inputs
PER_CALL_TOLS = dict(attention_fwd=ATTN_REL_TOL,
                     attention_bwd=ATTN_BWD_REL_TOL, heads_fwd=ATTN_REL_TOL,
                     heads_bwd=ATTN_BWD_REL_TOL, decoder_fwd=DEC_REL_TOL)
AUG_TOL = 1e-4             # the card's augmented views vs the CPU's on the
                           # same draws, of the output scale (float32 both;
                           # exp, division and remainder round apart)
PASS_TOL = 5e-3             # each banded pass vs its plain pass on the same
                            # inputs, relative L2 of every output (the same
                            # bf16 rounding points: float32 sum order only)
ATTN_CASES = (('encoder', 2, 1025, 12, None), ('semantic', 128, 21, 4, None),
              ('encoder valid_len', 2, 1025, 12, 1000),
              ('cityscapes encoder', 2, 2602, 12, None),
              ('cityscapes edge crop', 1, 869, 12, None),
              # exps 42/43: the SemanticTransformer along 81 and 150
              # classes at 3 x 64 pooled locations (1 + 1 crops, pass 1);
              # exp 41: the timm ViT's encoder on 2 + 2 crops
              ('semantic L=81', 192, 81, 4, None),
              ('semantic L=150', 192, 150, 4, None),
              ('timm encoder', 4, 1025, 12, None),
              # phase 16 (e): exp 41's ZegCLIP ViT on 2 + 2 crops, the cls
              # token, 10 prompts and 32 x 32 patches: 8 key tiles and 11
              ('zegclip encoder', 4, 1035, 12, None))
# the head-split kernels (#1/#2): (name, B, L, heads, head_dim, valid_len);
# the tiny VLM's shapes are those of its 1 + 1 step and its 2-crop batches;
# then the widths whose products over D are split (48, 80, 96, 112) and
# two above 128 (the CUDA-core kernels), which no model of the repo has
HEADS_CASES = (('encoder 12x64 (forced head-split)', 2, 2602, 12, 64, None),
               ('odd heads 11x64', 2, 2602, 11, 64, None),
               ('24x32', 2, 1025, 24, 32, None),
               ('24x32 valid_len', 2, 1025, 24, 32, 1000),
               ('12x128', 1, 1025, 12, 128, None),
               ('tiny ViT 4x16', 2, 17, 4, 16, None),
               ('tiny semantic 2x32', 8, 21, 2, 32, None),
               ('16x48', 2, 1536, 16, 48, None),
               ('12x80 valid_len', 1, 1025, 12, 80, 1000),
               ('8x96 edge crop', 1, 869, 8, 96, None),
               ('4x112', 2, 300, 4, 112, 250),
               ('2x136 (padded to 144, CUDA cores)', 1, 1536, 2, 136, None),
               ('2x256 valid_len (CUDA cores)', 1, 1536, 2, 256, 1400))
# widths that are not a multiple of 16, zero-padded to the next one by the
# head-split wrappers: (L, heads, head_dim), under 'auto' (L >= 1536)
PADDED_HEADS_CASES = ((1536, 8, 24), (1600, 6, 72))
HEADS_VS_PACKED_TOL = 5e-3  # head-split against packed kernels, relative L2:
                            # p rounded after vs before normalising
ATTN_BWD_CASES = (('encoder', 4, 1025, 12, None),
                  ('semantic', 384, 21, 4, None),
                  ('encoder valid_len', 4, 1025, 12, 1000),
                  ('cityscapes encoder', 2, 2602, 12, None),
                  ('semantic L=81', 192, 81, 4, None),
                  ('semantic L=150', 192, 150, 4, None),
                  ('zegclip encoder', 4, 1035, 12, None))
# phase 3's planted fault, "the last key tile skipped", by case: the keys
# it keeps (valid_len). L = 150 spans two 128-key tiles, the second
# holding 22 keys; L = 81 has one tile, so its second half goes; L = 1035
# keeps its 8 full tiles and loses the 11-key tail; the backward's
# 'encoder' case is the timm ViT's (and the flagship's) shape.
ATTN_FAULT_KEYS = {'cityscapes encoder': 2602 - 128, 'semantic L=81': 40,
                   'semantic L=150': 128, 'timm encoder': 1025 - 128,
                   'zegclip encoder': 1024}
ATTN_BWD_FAULT_KEYS = dict(ATTN_FAULT_KEYS, encoder=1025 - 128)
del ATTN_BWD_FAULT_KEYS['timm encoder']


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3, windows=6):
    """Mean device time of the kernels that one call of ``fn`` launches,
    from the profiler: no host time, where events over a stream of short
    calls read the host's launch overhead. The profiler on the card's
    machine at times keeps the records of only some calls of a window, or
    of none. So a window counts only if every kernel's records are a whole
    multiple of the calls and another such window shows the same kernels
    as many times; else it is taken again. None ("not measured") if no two
    of ``windows`` windows agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = {e.key: (e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count
                   and not e.key.startswith(('Memcpy', 'Memset'))}
        counts = {k: c for k, (c, _) in kernels.items()}
        if not counts or any(c % iters for c in counts.values()):
            continue
        if counts in seen:
            return sum(t for _, t in kernels.values()) / iters / 1e3
        seen.append(counts)
    log(f'device_ms: no two of {windows} profiler windows agree '
        f'({len(seen)} whole): not measured')
    return None


def fmt_ms(ms):
    """A time for the log: 4 decimals, or "not measured" (None)."""
    return 'not measured' if ms is None else f'{ms:.4f}'


def tflops(flops, ms):
    return 'not measured' if ms is None else f'{flops / ms / 1e9:.1f}'


def _rel_l2(a, ref):
    return ((a.float() - ref.float()).norm()
            / ref.float().norm().clamp(min=1e-30)).item()


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


# ------------------------------------------------------------ phase 2

def _sass_counts(build, lib, keep):
    """{function: {op: lines}} of HGMMA, UTMALDG and HMMA in the SASS of
    ``csrc/<lib>.cu``'s library, for the functions ``keep`` selects."""
    tool = os.path.join(os.path.dirname(build._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', build.library_path(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if 'Function : ' in line:
            func = line.split('Function : ')[1].strip()
            if keep(func):
                counts[func] = dict.fromkeys(('HGMMA', 'UTMALDG', 'HMMA'), 0)
            else:
                func = None
        elif func:
            for op in counts[func]:
                counts[func][op] += bool(re.search(rf'\b{op}\b', line))
    return counts


# instances of the decoder's tensor-core products in each library that
# includes csrc/decoder_stage_bwd.cuh (the decoder forward #5 with the
# fused Up stage #11, the whole-plane backward #6/#7, the banded passes
# #8-#10; its conv_n and wgrad_n): conv_kernel<N, 9> at 5 widths and
# <N, 1> at 6, wgrad_kernel<N, 9> at 3 and <N, 1> at 4
DECODER_IGEMM_INSTANCES = (11, 7)
DECODER_IGEMM_LIBS = ('fused_decoder', 'fused_decoder_bwd',
                      'fused_decoder_banded')


def check_sass(build):
    """Every instance of the attention forward core (the packed one and the
    head-split one per head width), of the backward's dK/dV and dQ kernels
    (per head width) and of the igemm conv and wgrad kernels of the
    decoder's libraries (``DECODER_IGEMM_LIBS``: the forward with the
    fused Up stage, the whole-plane backward, the banded passes) compiled
    to Hopper's own
    instructions: wgmma (HGMMA) and TMA loads (UTMALDG), and no mma.sync
    (HMMA)."""
    from semivl_tpu_torch.ops import flash_attention as fa
    counts = {}
    for name in ('flash_attention', 'flash_attention_heads'):
        counts.update(_sass_counts(build, name, lambda f: 'attention_fwd' in f
                                   or re.search('attention_bwd.*(dkdv|dq)'
                                                '_kernel', f)))
    log(f'sass: attention kernels {json.dumps(counts)}')
    n_bwd = sum('attention_bwd' in f for f in counts)
    # forward: packed + each head width; backward: dK/dV and dQ at each
    n_dims = len(fa.HEAD_DIMS)
    assert (len(counts) - n_bwd, n_bwd) == (1 + n_dims, 2 * n_dims), \
        list(counts)
    dec = {}
    for lib in DECODER_IGEMM_LIBS:
        got = _sass_counts(build, lib, lambda f: 'igemm' in f and (
            'conv_kernel' in f or 'wgrad_kernel' in f))
        log(f'sass: {lib} igemm kernels {json.dumps(got)}')
        assert (sum('conv_kernel' in f for f in got),
                sum('wgrad_kernel' in f for f in got)) == \
            DECODER_IGEMM_INSTANCES, (lib, list(got))
        dec.update({f'{lib}:{f}': c for f, c in got.items()})
    for func, c in {**counts, **dec}.items():
        assert c['HGMMA'] and c['UTMALDG'] and not c['HMMA'], (func, c)


# ------------------------------------------------------------ phase 3

def _sdpa_ms(qkv, heads, valid, g=None, timer=cuda_ms):
    """SDPA's time on the same (B, H, L, D) inputs: the forward, or with
    ``g`` its backward through autograd (the library yardstick)."""
    import torch.nn.functional as F
    length = qkv.shape[1]
    d = qkv.shape[-1] // 3 // heads
    qh, kh, vh = (t.unflatten(-1, (heads, d)).transpose(1, 2).detach()
                  .requires_grad_(g is not None)
                  for t in qkv.chunk(3, dim=-1))
    mask = None
    if valid is not None:
        mask = (torch.arange(length, device='cuda') < valid).view(
            1, 1, 1, length)
    if g is None:
        return timer(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
    o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    gh = g.unflatten(-1, (heads, d)).transpose(1, 2)
    return timer(lambda: torch.autograd.grad(o, (qh, kh, vh), gh,
                                             retain_graph=True))


def check_attention(gen):
    from semivl_tpu_torch.ops import flash_attention as fa
    rows = []
    for name, b, length, heads, valid in ATTN_CASES:
        c = 64 * heads
        qkv = torch.randn(b, length, 3 * c, generator=gen, device='cuda',
                          dtype=torch.bfloat16)
        got = fa.packed_attention(qkv, heads, valid)
        want = fa.packed_attention_plain(qkv, heads, valid)
        rounded = fa.packed_attention_rounded(qkv, heads, valid)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), name
        err = (got.float() - want.float()).abs().max().item()
        rel = _rel_l2(got, rounded)
        ms = cuda_ms(lambda: fa.packed_attention(qkv, heads, valid))
        dev_ms = device_ms(lambda: fa.packed_attention(qkv, heads, valid))
        plain_ms = cuda_ms(lambda: fa.packed_attention_plain(qkv, heads,
                                                             valid))
        lib_ms = _sdpa_ms(qkv, heads, valid)
        lib_dev_ms = _sdpa_ms(qkv, heads, valid, timer=device_ms)
        keys = valid or length
        flops = 4 * b * heads * length * keys * 64
        nbytes = 4 * b * length * c * 2
        bound_ms, by = bound(flops, nbytes)
        log(f'attention {name} ({b}, {length}, {c})/{heads}: max_abs_err '
            f'vs plain {err:.3e} (tol {ATTN_TOL}), rel-L2 vs rounded '
            f'{rel:.3e} (tol {ATTN_REL_TOL}) kernel_ms {ms:.4f} plain_ms '
            f'{plain_ms:.4f} sdpa_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} '
            f'({by}) TFLOP/s {flops / ms / 1e9:.1f}; device-only kernel_ms '
            f'{fmt_ms(dev_ms)} sdpa_ms {fmt_ms(lib_dev_ms)}')
        assert err <= ATTN_TOL, (name, err)
        assert rel <= ATTN_REL_TOL, (name, rel)
        rows.append(dict(case=name, max_abs_err=err, rel_err=rel,
                         tol=ATTN_REL_TOL, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms))
        if name in ATTN_FAULT_KEYS:
            # planted fault: the last key tile skipped
            bad = _rel_l2(fa._fwd_kernel(*qkv.split(c, dim=-1), heads,
                                         ATTN_FAULT_KEYS[name], False)[0],
                          rounded)
            log(f'attention planted fault ({name}): last key tile skipped '
                f'rel-L2 {bad:.3e} (must exceed {ATTN_REL_TOL})')
            assert bad > ATTN_REL_TOL, bad
            rows[-1]['planted_faults'] = dict(skipped_key_tile=bad)
    return rows


def check_attention_bwd(gen):
    from semivl_tpu_torch.ops import flash_attention as fa
    rows = []
    for name, b, length, heads, valid in ATTN_BWD_CASES:
        c = 64 * heads
        qkv = torch.randn(b, length, 3 * c, generator=gen, device='cuda',
                          dtype=torch.bfloat16)
        g = torch.randn(b, length, c, generator=gen, device='cuda',
                        dtype=torch.bfloat16)
        q, k, v = qkv.split(c, dim=-1)
        keys = valid or length
        out, lse = fa._fwd_kernel(q, k, v, heads, keys, True)
        got = fa.flash_mha_bwd(qkv, out, lse, g, heads, valid)
        want = fa.flash_mha_bwd_plain(qkv, out, g, heads, valid)
        again = fa.flash_mha_bwd(qkv, out, lse, g, heads, valid)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), name
        assert torch.equal(got, again), name     # deterministic
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        rel = _rel_l2(got, want)
        ms = cuda_ms(lambda: fa.flash_mha_bwd(qkv, out, lse, g, heads, valid))
        dev_ms = device_ms(
            lambda: fa.flash_mha_bwd(qkv, out, lse, g, heads, valid))
        plain_ms = cuda_ms(
            lambda: fa.flash_mha_bwd_plain(qkv, out, g, heads, valid), 5)
        lib_ms = _sdpa_ms(qkv, heads, valid, g)
        lib_dev_ms = _sdpa_ms(qkv, heads, valid, g, timer=device_ms)
        flops = 8 * b * heads * length * keys * 64   # dp, dv, dk, dq
        nbytes = 2 * 8 * b * length * c + 4 * b * heads * length
        bound_ms, by = bound(flops, nbytes)
        log(f'attention bwd {name} ({b}, {length}, {c})/{heads}: '
            f'max_abs_err {err:.3e} grad scale {scale:.3f} (tol '
            f'{ATTN_BWD_TOL} x scale), rel-L2 {rel:.3e} (tol '
            f'{ATTN_BWD_REL_TOL}) kernel_ms {ms:.4f} plain_ms '
            f'{plain_ms:.4f} sdpa_bwd_ms {lib_ms:.4f} bound_ms '
            f'{bound_ms:.4f} ({by}); device-only kernel_ms '
            f'{fmt_ms(dev_ms)} sdpa_bwd_ms {fmt_ms(lib_dev_ms)} TFLOP/s '
            f'{tflops(flops, dev_ms)}')
        assert err <= ATTN_BWD_TOL * scale, (name, err, scale)
        assert rel <= ATTN_BWD_REL_TOL, (name, rel)
        rows.append(dict(case=name, max_abs_err=err, rel_err=rel,
                         tol=ATTN_BWD_REL_TOL, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms))
        if name in ATTN_BWD_FAULT_KEYS:
            # planted fault: the last key tile skipped through valid_len
            bad = _rel_l2(fa._bwd_kernel(qkv, out, lse, g, heads,
                                         ATTN_BWD_FAULT_KEYS[name]), want)
            log(f'attention bwd planted fault ({name}): last key tile '
                f'skipped rel-L2 {bad:.3e} (must exceed {ATTN_BWD_REL_TOL})')
            assert bad > ATTN_BWD_REL_TOL, bad
            rows[-1]['planted_faults'] = dict(skipped_key_tile=bad)
    return rows


# ------------------------------------------------------------ phase 4

def _random_decoder(gen, channels=128, ups=(64, 32), skips=(32, 16)):
    from semivl_tpu_torch.models.vlg_head import Up
    up1 = Up(channels, ups[0], skips[0])
    up2 = Up(ups[0], ups[1], skips[1])
    head = torch.nn.Conv2d(ups[1], 1, 3, padding=1)
    with torch.no_grad():
        for m in (up1, up2, head):
            for name, p in m.named_parameters():
                if p.ndim >= 2:
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                            / p[0].numel() ** 0.5)
                elif name.endswith('bias'):
                    p.copy_(0.2 * torch.randn(p.shape, generator=gen))
                else:   # GroupNorm scales
                    p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
    return up1.cuda(), up2.cuda(), head.cuda()


def _cudnn_chain(up1, up2, head, y, s1, s2):
    """The decoder as cuDNN convolutions in y's dtype: the library time."""
    import torch.nn.functional as F
    from semivl_tpu_torch.tools.fused_up_bench import cudnn_stage
    for up, skip in ((up1, s1), (up2, s2)):
        y = cudnn_stage(y, skip, up.stage_params())
    return F.conv2d(y, head.weight.to(y.dtype), head.bias.to(y.dtype),
                    padding=1)


def _decoder_flops(p, c, h, w, cs, cu, c1, c2, b):
    hw2, hw4 = 4 * h * w, 16 * h * w
    s1 = 2 * p * hw2 * (cu[0] * c + 9 * c1 * (cu[0] + c1)) \
        + 2 * b * hw2 * 9 * c1 * cs[0]
    s2 = 2 * p * hw4 * (cu[1] * c1 + 9 * c2 * (cu[1] + c2) + 9 * c2) \
        + 2 * b * hw4 * 9 * c2 * cs[1]
    return s1 + s2


def _stage_launches(fd, x, s1, s2, p1, p2, head, skip_half=True,
                    gn_in2=True):
    """The decoder forward as its two stage launches, with two plantable
    faults: ``skip_half=False`` leaves conv1's skip half out inside the
    kernel's sequence, ``gn_in2=False`` has stage 2 read stage 1's raw
    conv2 without its GN+ReLU."""
    c2, part2 = fd._stage(x, s1, p1, skip_half=skip_half)
    gn_in = (part2, p1['gn2_weight'].float().contiguous(),
             p1['gn2_bias'].float().contiguous()) if gn_in2 else None
    return fd._stage(c2, s2, p2, gn_in=gn_in, head=head, skip_half=skip_half)


def check_decoder(gen, b=2, n=21, h=32, w=32, skips=(32, 16)):
    """The forward kernel (#5, two launches of ``decoder_stage_fwd``) at P
    = b n planes on an h x w base grid: flagship (2 x 21 at 32^2, skips
    32/16) by default. Against the plain chain (DEC_TOL of the logit
    scale) and the rounded reference (DEC_REL_TOL), with two planted faults
    that must fail the second (conv1's skip half left out inside the
    kernel's sequence; stage 2 reading its input without GN+ReLU); times by
    events and device-only beside cuDNN's chain."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    c = 128
    p = b * n
    up1, up2, head = _random_decoder(gen, skips=skips)
    x = torch.randn(p, c, h, w, generator=gen).cuda().bfloat16()
    s1 = torch.randn(b, skips[0], 2 * h, 2 * w, generator=gen).cuda().bfloat16()
    s2 = torch.randn(b, skips[1], 4 * h, 4 * w, generator=gen).cuda().bfloat16()
    p1, p2 = up1.stage_params(), up2.stage_params()
    hp = dict(weight=head.weight, bias=head.bias)
    with torch.no_grad():
        before = fd.launches
        got = fd.fused_vlg_decoder(x, s1, s2, p1, p2, hp)
        assert fd.launches == before + 2
        want = fd.fused_vlg_decoder_plain(x, s1, s2, p1, p2, hp)
        ref = fd.fused_vlg_decoder_rounded(x, s1, s2, p1, p2, hp)
        rel = _rel_l2(got, ref)
        faults = {what: _rel_l2(_stage_launches(fd, x, s1, s2, p1, p2, hp,
                                                **kw), ref)
                  for what, kw in (
                      ('conv1 skip half left out in the kernel',
                       dict(skip_half=False)),
                      ('stage 2 input without GN+ReLU',
                       dict(gn_in2=False)))}

        def kernel():
            return fd.fused_vlg_decoder(x, s1, s2, p1, p2, hp)

        def lib():
            return _cudnn_chain(up1, up2, head, x, s1, s2)

        ms, dev_ms = cuda_ms(kernel, 10), device_ms(kernel, 5)
        plain_ms = cuda_ms(
            lambda: fd.fused_vlg_decoder_plain(x, s1, s2, p1, p2, hp), 10)
        lib_ms, lib_dev = cuda_ms(lib, 10), device_ms(lib, 5)
        lib_rel = _rel_l2(lib(), want)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (p, 1, 4 * h, 4 * w)
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    err = diff.max().item()
    flops = _decoder_flops(p, c, h, w, skips, (c - skips[0], 64 - skips[1]),
                           64, 32, b)
    nbytes = 2 * (x.numel() + s1.numel() + s2.numel() + got.numel())
    bound_ms, by = bound(flops, nbytes)
    log(f'decoder x {tuple(x.shape)} skips {tuple(s1.shape)} '
        f'{tuple(s2.shape)}: max_abs_err vs plain {err:.3e} mean_abs_err '
        f'{diff.mean().item():.3e} logit scale {scale:.3f} (tol {DEC_TOL} x '
        f'scale), rel-L2 vs rounded {rel:.3e} (tol {DEC_REL_TOL}); planted '
        f'faults rel-L2 '
        f'{json.dumps({k: float(f"{v:.3e}") for k, v in faults.items()})}'
        f'; cuDNN chain vs plain rel-L2 {lib_rel:.3e}; kernel_ms {ms:.4f} '
        f'device_ms {fmt_ms(dev_ms)} plain_ms {plain_ms:.4f} cudnn_ms '
        f'{lib_ms:.4f} cudnn device_ms {fmt_ms(lib_dev)} bound_ms '
        f'{bound_ms:.4f} ({by}) GFLOP {flops / 1e9:.2f} '
        f'({tflops(flops, dev_ms)} TFLOP/s device-only)')
    assert err <= DEC_TOL * max(scale, 1.0), (err, scale)
    assert rel <= DEC_REL_TOL, rel
    assert all(v > DEC_REL_TOL for v in faults.values()), faults
    return dict(max_abs_err=err, rel_err=rel, tol=DEC_REL_TOL, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=bound_ms, bound_by=by,
                planted_faults=faults, shape=f'P={p} at {h}x{w}')


# decoder widths beyond the shipped models' (phase 12): (name, Cin,
# (Cout1, Cout2), (Cs1, Cs2)); each stage's Cu is its Cin - Cs
WIDE_CASES = (
    ('Cout 48; stage 2 Cin 48', 64, (48, 16), (16, 16)),
    ('Cin 224, Cu 112, Cs 112, Cout 96; stage 2 Cu 72, Cs 24', 224,
     (96, 32), (112, 24)),
    ('Cin 24 (padded to 32), Cs 8', 24, (32, 16), (8, 16)),
    ('Cout 8 (one group of 8); stage 2 Cout 40 (two groups of 20), Cs 4',
     64, (8, 40), (16, 4)),
    ('Cout 112 (96 + 16); stage 2 Cout 128 (96 + 32)', 64, (112, 128),
     (16, 16)),
    ('Cout 160 (96 + 64); stage 2 Cout 24 (one group of 24)', 64,
     (160, 24), (32, 16)))


def check_wide_widths():
    """Decoder widths beyond the shipped models' (``WIDE_CASES``: Cout 48
    and 96, any Cin, Cu and Cs above the backward's widest product, run in
    column groups; Cout 8, 24, 40, 112, 128 and 160, in GroupNorm's kernel
    layout, ``fused_decoder.pad_decoder``) at P = 3 on a ragged 13 x 11
    base: the forward against
    the plain chain (DEC_TOL) and the rounded reference (DEC_REL_TOL), both
    backward routes against the rounded references phase 4 holds the
    backward to (DEC_BWD_TOL at the stored stage-1 conv2, and forward and
    backward composed, DEC_BWD_COMPOSED_TOL), with every launch on the
    kernels."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    gen = torch.Generator().manual_seed(12)
    b, n, h, w = 1, 3, 13, 11
    names = decoder_leaves()
    rows = {}
    for name, cin, ups, skips in WIDE_CASES:
        up1, up2, head = _random_decoder(gen, channels=cin, ups=ups,
                                         skips=skips)
        params = [up1.stage_params(), up2.stage_params(),
                  dict(weight=head.weight, bias=head.bias)]
        acts = [torch.randn(b * n, cin, h, w, generator=gen),
                torch.randn(b, skips[0], 2 * h, 2 * w, generator=gen),
                torch.randn(b, skips[1], 4 * h, 4 * w, generator=gen)]
        acts = [t.cuda().bfloat16() for t in acts]
        g = torch.randn(b * n, 1, 4 * h, 4 * w, generator=gen).cuda() \
            .bfloat16()
        before = _counters()
        with torch.no_grad():
            got = fd.fused_vlg_decoder(*acts, *params)
        moved = _moved(before)
        with torch.no_grad():
            ref = fd.fused_vlg_decoder_rounded(*acts, *params)
            want = fd.fused_vlg_decoder_plain(*acts, *params)
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        row = dict(fwd_launches=moved, fwd_rel_err=_rel_l2(got, ref),
                   fwd_max_abs_err=err, logit_scale=scale)
        refs = _held_refs(acts, params, g)
        for route in ('whole', 'banded'):
            before = _counters()
            grads = decoder_grads(
                lambda *a, r=route: fd.fused_vlg_decoder(*a, bwd=r), acts,
                params, g)
            row[route] = dict(launches=_moved(before), **_gates(grads, refs,
                                                                names))
        torch.cuda.synchronize()
        log(f'wide widths "{name}" at P={b * n} on {h}x{w}: '
            + json.dumps(row))
        assert moved == {'decoder_fwd': 2}, moved
        assert err <= DEC_TOL * max(scale, 1.0), (err, scale)
        assert row['fwd_rel_err'] <= DEC_REL_TOL, row
        for route, kinds in (('whole', ('decoder_bwd_tail',
                                        'decoder_bwd_input')),
                             ('banded', ('banded_pass_a', 'banded_pass_b',
                                         'banded_pass_c'))):
            r = row[route]
            assert r['launches'] == dict({k: 2 for k in kinds},
                                         decoder_fwd=2), r
            assert r['at_stored'] <= DEC_BWD_TOL, (name, route, r)
            assert r['composed'] <= DEC_BWD_COMPOSED_TOL, (name, route, r)
        rows[name] = row
    return rows


def _moved(before):
    """The launch counters that moved since ``before``, by how much."""
    return {k: v - before[k] for k, v in _counters().items()
            if v != before[k]}


def _held_refs(acts, params, g):
    """The gradients of the two references a decoder backward is held to:
    autograd through ``fused_vlg_decoder_rounded`` with float64 sums at the
    point the kernels' forward reached (stage 1's raw conv2 as ``_stage``
    stores it, ``raw2_1``: DEC_BWD_TOL), and with float64 sums recomputing
    stage 1 itself (the composed gate, independent of what the forward
    stored: DEC_BWD_COMPOSED_TOL)."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    with torch.no_grad():
        raw2_1 = fd.stored_raw2(*acts[:2], params[0])
    return (decoder_grads(_rounded(float64=True, raw2_1=raw2_1), acts,
                          params, g),
            decoder_grads(_rounded(float64=True), acts, params, g))


def _gates(got, refs, names):
    """dict(at_stored=, composed=): the worst leaf's relative L2 of
    gradients ``got`` against each of ``_held_refs``, and the leaf."""
    out = {}
    for key, ref in zip(('at_stored', 'composed'), refs):
        errs = {nm: _rel_l2(a, r) for nm, a, r in zip(names, got, ref)}
        worst = max(errs, key=errs.get)
        out[key], out[key + '_leaf'] = errs[worst], worst
    return out


@contextlib.contextmanager
def stage1_forward_fault(skip_half=True, conv2_tap=True):
    """Planted fault in the forward's stage 1 (``_stage`` without
    ``gn_in``), whose raw conv2 and GroupNorm partials the backward reads:
    ``skip_half=False`` leaves conv1's skip half out inside the kernel's
    sequence; ``conv2_tap=False`` runs conv2 without its top-left tap."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    real = fd._stage

    def faulty(x, skip, p, gn_in=None, **kw):
        if gn_in is None:
            kw['skip_half'] = skip_half
            if not conv2_tap:
                w2 = p['conv2_weight'].detach().clone()
                w2[:, :, 0, 0] = 0
                p = dict(p, conv2_weight=w2)
        return real(x, skip, p, gn_in=gn_in, **kw)

    with mock.patch.object(fd, '_stage', faulty):
        yield


# forward faults the composed gate (DEC_BWD_COMPOSED_TOL) must catch
FORWARD_FAULTS = {
    'stage 1 forward without conv1\'s skip half (in the kernel)':
    lambda: stage1_forward_fault(skip_half=False),
    'stage 1 forward conv2 without its top-left tap':
    lambda: stage1_forward_fault(conv2_tap=False)}


def _stage_bwd_flops(p, b, cin, cs, cout, h, w, head):
    """(tail, input) flops of one stage's backward: dgrad + wgrad of each
    conv (twice its forward), the recompute not counted."""
    hw = 4 * h * w
    cu = cin - cs
    tail = 2 * 2 * p * hw * 9 * cout * cout + (
        2 * 2 * p * hw * 9 * cout if head else 0)
    inp = (2 * 2 * p * hw * 9 * cout * cu + 2 * 2 * b * hw * 9 * cout * cs
           + 2 * 2 * p * hw * cin * cu)
    return tail, inp


@contextlib.contextmanager
def conv1_dgrad_without_a_tap():
    """Planted fault: the decoder backward's conv1 dgrad misses its
    top-left tap (a halo or tap-index bug of the input kernel)."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    real = fd._stage_bwd_input

    def faulty(g_c1, up, xin, skip, p):
        w = p['conv1_weight'].detach().clone()
        w[:, :, 0, 0] = 0
        return real(g_c1, up, xin, skip, dict(p, conv1_weight=w))

    with mock.patch.object(fd, '_stage_bwd_input', faulty):
        yield


@contextlib.contextmanager
def conv2_wgrad_off_by(factor):
    """Planted fault: both stages' conv2 weight gradients scaled by
    ``factor`` (a lost or doubled share of the tail kernel's reduction)."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    real = fd._stage_bwd_tail

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        return dict(out, conv2_weight=out['conv2_weight'] * factor)

    with mock.patch.object(fd, '_stage_bwd_tail', faulty):
        yield


@contextlib.contextmanager
def conv2_wgrad_without_last_plane():
    """Planted fault inside the igemm wgrad reduction: conv2's weight
    gradient (both stages' tails) reduces over every plane but the last."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    real = fd._stage_bwd_tail

    def faulty(x, *args, **kwargs):
        return real(x, *args, wgrad_planes=x.shape[0] - 1, **kwargs)

    with mock.patch.object(fd, '_stage_bwd_tail', faulty):
        yield


def _route_blind(fn):
    """A decoder reference in the place of ``fused_vlg_decoder``: it takes
    and ignores the backward route argument."""
    def call(*args, bwd='whole'):
        return fn(*args)
    return call


def _rounded(float64=False, raw2_1=None):
    """The rounded reference both decoder backward routes are held to (its
    bf16 gradient roundings are where both store gradients in bf16), with
    float64 sums with ``float64``; ``raw2_1``: stage 1's raw conv2 as the
    kernels stored it (``fused_vlg_decoder_rounded``)."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    dtype = torch.float64 if float64 else torch.float32

    def ref(*args):
        return fd.fused_vlg_decoder_rounded(*args, dtype=dtype, raw2_1=raw2_1)
    return ref


def decoder_leaves():
    from semivl_tpu_torch.ops import fused_decoder as fd
    return ['x', 'skip1', 'skip2'] + [
        f'up{i}.{k}' for i in (1, 2) for k in fd.STAGE_KEYS] + [
        'head.weight', 'head.bias']


def decoder_grads(fn, acts, params, g):
    """Gradients of the decoder chain ``fn`` w.r.t. copies of its inputs
    ``acts`` (x, skip1, skip2) and of the parameter dicts ``params`` (up1,
    up2, head), in ``decoder_leaves()`` order."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    xs = [t.detach().clone().requires_grad_(True) for t in acts]
    ps = [{k: v.detach().clone().requires_grad_(True) for k, v in d.items()}
          for d in params]
    flat = ([ps[0][k] for k in fd.STAGE_KEYS]
            + [ps[1][k] for k in fd.STAGE_KEYS] + [ps[2]['weight'],
                                                   ps[2]['bias']])
    return torch.autograd.grad(fn(*xs, *ps), xs + flat, g)


DECODER_FAULTS = {'conv1 dgrad without its top-left tap':
                  conv1_dgrad_without_a_tap,
                  'conv2 weight gradients 3% off':
                  lambda: conv2_wgrad_off_by(1.03)}
# phase 4 also plants a fault inside the igemm wgrad reduction
WHOLE_BWD_FAULTS = dict(DECODER_FAULTS, **{
    'conv2 wgrad reduction without the last plane':
    conv2_wgrad_without_last_plane})


def check_decoder_bwd(gen, b=6, n=21):
    """The decoder backward at a student pass-1 shape, P = b n planes (VOC's
    6 x 21 = 126 by default; ADE's 3 x 150 = 450):
    gradients of every input and parameter through the kernels against
    autograd through ``fused_vlg_decoder_rounded`` with float64 sums at the
    point the kernels' forward reached (stage 1's raw conv2 as they stored
    it, ``raw2_1``), each within DEC_BWD_TOL, and, forward and backward
    composed, against it with float64 sums recomputing stage 1, each within
    DEC_BWD_COMPOSED_TOL (``_held_refs``). Each planted backward fault
    must fail the first limit, each forward fault of stage 1 the second.
    The float32-sum reference's distance to the float64 one (a sound
    computation at lower precision: the control of the composed limit) is
    logged as data."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    c, h = 128, 32
    p = b * n
    up1, up2, head = _random_decoder(gen)
    params = [up1.stage_params(), up2.stage_params(),
              dict(weight=head.weight, bias=head.bias)]
    acts = [torch.randn(p, c, h, h, generator=gen),
            torch.randn(b, 32, 2 * h, 2 * h, generator=gen),
            torch.randn(b, 16, 4 * h, 4 * h, generator=gen)]
    acts = [t.cuda().bfloat16() for t in acts]
    g = torch.randn(p, 1, 4 * h, 4 * h, generator=gen).cuda().bfloat16()
    names = decoder_leaves()
    tail = [nm for nm in names if 'conv2' in nm or 'gn' in nm
            or nm.startswith('head')]

    def grads(fn):
        return decoder_grads(fn, acts, params, g)

    got = grads(fd.fused_vlg_decoder)
    ref, own64 = _held_refs(acts, params, g)
    ref32 = grads(_rounded())
    again = grads(fd.fused_vlg_decoder)
    torch.cuda.synchronize()
    noise = max(_rel_l2(a, r) for a, r in zip(ref32, own64))
    composed = _gates(got, (ref, own64), names)
    rel, abs_err = {}, {}
    for name, a, r, a2 in zip(names, got, ref, again):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert torch.isfinite(a.float()).all(), name
        assert torch.equal(a, a2), name          # deterministic
        rel[name] = _rel_l2(a, r)
        abs_err[name] = (a.float() - r.float()).abs().max().item()
    worst = max(rel, key=rel.get)
    vs32 = max(_rel_l2(a, r) for a, r in zip(got, ref32))
    log(f'decoder bwd P={p}: per-leaf rel-L2 vs rounded (float64 sums, '
        f'the stored stage-1 conv2): worst {worst} {rel[worst]:.3e} (tol '
        f'{DEC_BWD_TOL}); composed, vs rounded with float64 sums recomputing '
        f'stage 1: worst {composed["composed_leaf"]} '
        f'{composed["composed"]:.3e} (tol {DEC_BWD_COMPOSED_TOL}; the '
        f'float32-sum reference, the control: worst leaf {noise:.3e}); '
        f'kernels vs the float32-sum reference (data): {vs32:.3e}; '
        f'{json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()})}')
    faults = {}
    for what, planted in WHOLE_BWD_FAULTS.items():
        with planted():
            bad = grads(fd.fused_vlg_decoder)
        errs = {nm: _rel_l2(a, r) for nm, a, r in zip(names, bad, ref)}
        faults[what] = max(errs.values())
        log(f'decoder bwd planted fault "{what}": worst rel-L2 '
            f'{faults[what]:.3e} ({max(errs, key=errs.get)}), '
            f'{sum(e > DEC_BWD_TOL for e in errs.values())} of {len(errs)} '
            f'leaves past the tol')
    fwd_faults = {}
    for what, planted in FORWARD_FAULTS.items():
        with planted():
            bad = grads(fd.fused_vlg_decoder)
        fwd_faults[what] = _gates(bad, (ref, own64), names)['composed']
        log(f'decoder bwd planted forward fault "{what}": composed worst '
            f'rel-L2 {fwd_faults[what]:.3e} (must exceed '
            f'{DEC_BWD_COMPOSED_TOL})')
    assert rel[worst] <= DEC_BWD_TOL, (worst, rel[worst])
    assert composed['composed'] <= DEC_BWD_COMPOSED_TOL, composed
    assert all(e > DEC_BWD_TOL for e in faults.values()), faults
    assert all(e > DEC_BWD_COMPOSED_TOL for e in fwd_faults.values()), \
        fwd_faults

    # times: both stages' tail calls, both input calls, the whole backward
    # through autograd; events and device-only
    from semivl_tpu_torch.tools import decoder_bench
    fns, _ = decoder_bench.calls(fd, acts, params, g)
    tail_ms, input_ms, ms = (cuda_ms(fns[k], 5)
                             for k in ('tail', 'input', 'whole'))
    tail_dev, input_dev, whole_dev = (device_ms(fns[k], 5)
                                      for k in ('tail', 'input', 'whole'))
    del fns

    prms = ([params[0][k] for k in fd.STAGE_KEYS]
            + [params[1][k] for k in fd.STAGE_KEYS] + [head.weight, head.bias])

    def bwd_call(fn):
        xs = [t.detach().requires_grad_(True) for t in acts]
        out = fn(*xs, *params)
        return lambda: torch.autograd.grad(out, xs + prms, g,
                                           retain_graph=True)

    plain_ms = cuda_ms(bwd_call(fd.fused_vlg_decoder_plain), 5)
    cudnn = bwd_call(lambda *a: _cudnn_chain(up1, up2, head, *a[:3]))
    lib_ms, lib_dev = cuda_ms(cudnn, 5), device_ms(cudnn, 5)
    del cudnn
    f1 = _stage_bwd_flops(p, b, c, 32, 64, h, h, False)
    f2 = _stage_bwd_flops(p, b, 64, 16, 32, 2 * h, 2 * h, True)
    nbytes = 2 * 2 * sum(t.numel() for t in acts + [g])
    tail_bound, tail_by = bound(f1[0] + f2[0], nbytes)
    input_bound, input_by = bound(f1[1] + f2[1], nbytes)
    log(f'decoder bwd P={p} x {tuple(acts[0].shape)}: whole backward '
        f'kernel_ms {ms:.3f} device_ms {fmt_ms(whole_dev)} plain_ms '
        f'{plain_ms:.3f} cudnn_ms {lib_ms:.3f} cudnn device_ms '
        f'{fmt_ms(lib_dev)}; tail_ms {tail_ms:.3f} device_ms '
        f'{fmt_ms(tail_dev)} bound {tail_bound:.4f} ({tail_by}) GFLOP '
        f'{(f1[0] + f2[0]) / 1e9:.1f}; input_ms {input_ms:.3f} device_ms '
        f'{fmt_ms(input_dev)} bound {input_bound:.4f} ({input_by}) GFLOP '
        f'{(f1[1] + f2[1]) / 1e9:.1f}')
    common = dict(tol=DEC_BWD_TOL, plain_ms=plain_ms, library_ms=lib_ms,
                  library_device_ms=lib_dev, whole_bwd_ms=ms,
                  whole_bwd_device_ms=whole_dev, planted_faults=faults,
                  composed_rel_err=composed['composed'],
                  composed_tol=DEC_BWD_COMPOSED_TOL,
                  composed_control=noise,
                  planted_forward_faults=fwd_faults)
    rows = []
    for names_, t_ms, t_dev, t_bound, t_by in (
            (tail, tail_ms, tail_dev, tail_bound, tail_by),
            ([nm for nm in names if nm not in tail], input_ms, input_dev,
             input_bound, input_by)):
        rows.append(dict(max_abs_err=max(abs_err[nm] for nm in names_),
                         rel_err=max(rel[nm] for nm in names_), ms=t_ms,
                         device_ms=t_dev, bound_ms=t_bound, bound_by=t_by,
                         **common))
    return rows


def _banded_pass_work(p, b, cin, cs, cout, h, w, head, gn):
    """(flops, bytes) of passes A, B and C of one stage: A recomputes the
    stage's convolutions (and the head's two gradients), B is conv2's two
    gradients, C conv1's and the transpose conv's; bytes are each pass's
    tensor inputs read once and outputs written once, at the dtypes the
    passes store: bf16 but for g_skip (float32)."""
    hw, cu = 4 * h * w, cin - cs
    macs = (p * hw * cin * cu + p * hw * 9 * cu * cout + b * hw * 9 * cs * cout
            + p * hw * 9 * cout * cout + (2 * p * hw * 9 * cout if head else 0),
            2 * p * hw * 9 * cout * cout,
            2 * p * hw * 9 * cu * cout + 2 * b * hw * 9 * cs * cout
            + 2 * p * hw * cin * cu)
    x2, raw2 = p * cin * h * w * 2, p * cout * hw * 2
    nbytes = (x2 + b * cs * hw * 2 + (p * hw * 2 if head else raw2)
              + (x2 if gn else 0) + p * cu * hw * 2 + 3 * raw2,
              4 * raw2,
              x2 + p * cu * hw * 2 + b * cs * hw * 2 + 2 * raw2 + x2
              + b * cs * hw * 4)
    return [(2 * m, n) for m, n in zip(macs, nbytes)]


def _cudnn_pass_calls(up1, up2, head, acts):
    """One call per banded pass of the library's convolutions for the same
    work at both stages, on bf16 operands of the pass's shapes (a library
    time does not depend on the values): A the decoder chain's forward
    (what pass A recomputes), B conv2's dgrad and wgrad, C conv1's dgrad
    and wgrad (the up half per plane, the skip half per image) and the
    transpose conv's (input, weight and bias)."""
    conv_bwd = torch.ops.aten.convolution_backward
    x, s1, s2 = acts
    gen = torch.Generator(device='cuda').manual_seed(6)
    b, p = s1.shape[0], x.shape[0]
    stages = []
    xin = x
    for up, skip in ((up1, s1), (up2, s2)):
        prm = {k: v.detach().bfloat16() for k, v in up.stage_params().items()}
        cu = prm['up_weight'].shape[1]
        cout = prm['conv2_weight'].shape[0]
        hh, ww = skip.shape[2:]

        def rand(*shape):
            return torch.randn(shape, generator=gen, device='cuda',
                               dtype=torch.bfloat16)

        stages.append(dict(
            prm=prm, cu=cu, xin=xin, skip=skip, up=rand(p, cu, hh, ww),
            act=rand(p, cout, hh, ww), g=rand(p, cout, hh, ww),
            g_img=rand(b, cout, hh, ww)))
        xin = rand(p, cout, hh, ww)

    def conv3(g, inp, w):
        return conv_bwd(g, inp, w, None, [1, 1], [1, 1], [1, 1], False,
                        [0, 0], 1, [True, True, False])

    def pass_b():
        for st in stages:
            conv3(st['g'], st['act'], st['prm']['conv2_weight'])

    def pass_c():
        for st in stages:
            w1, cu = st['prm']['conv1_weight'], st['cu']
            conv3(st['g'], st['up'], w1[:, :cu])
            conv3(st['g_img'], st['skip'], w1[:, cu:])
            conv_bwd(st['up'], st['xin'], st['prm']['up_weight'], [cu],
                     [2, 2], [0, 0], [1, 1], True, [0, 0], 1,
                     [True, True, True])

    return dict(A=lambda: _cudnn_chain(up1, up2, head, x, s1, s2), B=pass_b,
                C=pass_c)


@contextlib.contextmanager
def pass_b_band_twice():
    """Planted fault: pass B's conv2 weight gradient reads its first 16-row
    band twice (a band-loop bound off by one band)."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    real = fdb.pass_b

    def faulty(raw1, raw2, gy2, p, stats, mg2):
        out = real(raw1, raw2, gy2, p, stats, mg2)
        extra = fdb.pass_b_plain(raw1[:, :, :16], raw2[:, :, :16],
                                 gy2[:, :, :16], p, stats, mg2)
        return dict(out, conv2_weight=out['conv2_weight']
                    + extra['conv2_weight'])

    with mock.patch.object(fdb, 'pass_b', faulty):
        yield


def pass_b_wgrad_without_last_plane(pass_b):
    """Planted fault inside pass B's igemm wgrad reduction
    (``D_WG_PLANES``): conv2's weight gradient reduces over every plane
    but the last."""
    def faulty(raw1, *args):
        return pass_b(raw1, *args, wgrad_planes=raw1.shape[0] - 1)
    return faulty


@contextlib.contextmanager
def pass_b_kernel_without_last_plane():
    """``pass_b_wgrad_without_last_plane`` in the place of pass B."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    with mock.patch.object(fdb, 'pass_b',
                           pass_b_wgrad_without_last_plane(fdb.pass_b)):
        yield


@contextlib.contextmanager
def pass_a_sums_without_last_band():
    """Planted fault: pass A's GN2 reduction sums miss the plane's last
    16-row band (a ragged last band dropped)."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    real = fdb.pass_a

    def faulty(x, skip, p, stats, g, gn_x=None, head=None):
        out = real(x, skip, p, stats, g, gn_x, head)
        m2, r2 = (t[..., None, None] for t in stats[2:])
        gy = out['gy2'][:, :, -16:].double()
        xhat = ((out['raw2'][:, :, -16:].float() - m2) * r2).double()
        return dict(out, sgy2=out['sgy2'] - gy.sum((2, 3)).float(),
                    sgyx2=out['sgyx2'] - (gy * xhat).sum((2, 3)).float())

    with mock.patch.object(fdb, 'pass_a', faulty):
        yield


@contextlib.contextmanager
def pass_c_dgrad_without_a_tap():
    """Planted fault: pass C's conv1 dgrad misses its top-left tap."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    real = fdb.pass_c

    def faulty(xin, up, skip, raw1, gy1, p, stats, mg1):
        w = p['conv1_weight'].detach().clone()
        w[:, :, 0, 0] = 0
        return real(xin, up, skip, raw1, gy1, dict(p, conv1_weight=w),
                    stats, mg1)

    with mock.patch.object(fdb, 'pass_c', faulty):
        yield


@contextlib.contextmanager
def pass_a_without_skip_half():
    """Planted fault inside pass A's tensor-core product: the recompute of
    raw1 leaves conv1's skip half out (its addend in the up half's
    epilogue)."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    real = fdb.pass_a

    def faulty(*args):
        return real(*args, skip_half=False)

    with mock.patch.object(fdb, 'pass_a', faulty):
        yield


# what each banded pass's library time (``_cudnn_pass_calls``) computes
CUDNN_PASS_WORK = dict(
    A='cuDNN forward of the decoder chain (the recompute)',
    B='cuDNN dgrad + wgrad of conv2, both stages',
    C='cuDNN dgrad + wgrad of conv1 (both halves) and of the transpose '
      'conv, both stages')

BANDED_FAULTS = {
    'pass B conv2 wgrad reads its first 16-row band twice': pass_b_band_twice,
    'pass A recompute without conv1\'s skip half (igemm epilogue)':
        pass_a_without_skip_half,
    'pass A GN2 sums miss the last 16-row band':
        pass_a_sums_without_last_band,
    'pass B conv2 wgrad reduction without the last plane (in the kernel)':
        pass_b_kernel_without_last_plane,
    'pass C conv1 dgrad without its top-left tap': pass_c_dgrad_without_a_tap}


def check_banded_bwd(gen):
    """The banded backward at the Cityscapes student pass-1 shape (P = 3 x
    19 = 57 planes, 51^2 base grid: stages of 102^2 and 204^2): each pass
    of each stage against its plain pass on the same inputs (the kernels'
    outputs of the pass before), the composed backward against autograd
    through ``fused_vlg_decoder_rounded`` (float64 distance logged) and
    against the whole-plane kernels #6/#7, planted faults that must fail,
    and times."""
    from semivl_tpu_torch.ops import fused_decoder as fd
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    b, n, c, h = 3, 19, 128, 51
    p = b * n
    up1, up2, head = _random_decoder(gen, skips=(32, 32))
    params = [up1.stage_params(), up2.stage_params(),
              dict(weight=head.weight, bias=head.bias)]
    acts = [torch.randn(p, c, h, h, generator=gen),
            torch.randn(b, 32, 2 * h, 2 * h, generator=gen),
            torch.randn(b, 32, 4 * h, 4 * h, generator=gen)]
    acts = [t.cuda().bfloat16() for t in acts]
    g = torch.randn(p, 1, 4 * h, 4 * h, generator=gen).cuda().bfloat16()
    p1, p2, hp = params

    # each pass on its own inputs, against its plain pass; the library's
    # convolutions for each pass's work beside
    cudnn = _cudnn_pass_calls(up1, up2, head, acts)
    calls = {k: [] for k in 'ABC'}
    with torch.no_grad():
        _, c2, st1, st2 = fdb.decoder_fwd_stats(*acts, p1, p2, hp)
        gn_x = (st1[2], st1[3], p1['gn2_weight'], p1['gn2_bias'])
        g_in = g
        for xin, skip, prm, st, gx, hd in ((c2, acts[2], p2, st2, gn_x, hp),
                                           (acts[0], acts[1], p1, st1, None,
                                            None)):
            ins = (xin, skip, prm, st, g_in, gx, hd)
            a = fdb.pass_a(*ins)
            calls['A'].append((fdb.pass_a, fdb.pass_a_plain, ins, a))
            hw = a['raw2'].shape[2] * a['raw2'].shape[3]
            mg2 = fdb.close_gn(a['sgy2'], a['sgyx2'], prm['gn2_weight'],
                               hw)[2:]
            ins = (a['raw1'], a['raw2'], a['gy2'], prm, st, mg2)
            bb = fdb.pass_b(*ins)
            calls['B'].append((fdb.pass_b, fdb.pass_b_plain, ins, bb))
            mg1 = fdb.close_gn(bb['sgy1'], bb['sgyx1'], prm['gn1_weight'],
                               hw)[2:]
            ins = (a['xin'], a['up'], skip, a['raw1'], bb['gy1'], prm, st,
                   mg1)
            cc = fdb.pass_c(*ins)
            calls['C'].append((fdb.pass_c, fdb.pass_c_plain, ins, cc))
            g_in = cc['g_x']
        passes = {}
        for k, lst in calls.items():
            rel, err = {}, 0.0
            for stage, (fn, plain, ins, got) in zip((2, 1), lst):
                want = plain(*ins)
                again = fn(*ins)
                for name, t in want.items():
                    assert torch.isfinite(got[name].float()).all(), (k, name)
                    assert torch.equal(got[name], again[name]), (k, name)
                    rel[f'{name}{stage}'] = _rel_l2(got[name], t)
                    err = max(err, (got[name].float() - t.float()).abs()
                              .max().item())
            run = [(fn, ins) for fn, _, ins, _ in lst]
            ms = cuda_ms(lambda: [fn(*ins) for fn, ins in run], 5)
            dev_ms = device_ms(lambda: [fn(*ins) for fn, ins in run], 5)
            plain_ms = cuda_ms(lambda: [pl(*ins) for _, pl, ins, _ in lst],
                               3, 1)
            lib = cudnn[k]
            lib_ms, lib_dev = cuda_ms(lib, 5), device_ms(lib, 5)
            passes[k] = dict(rel=rel, max_abs_err=err, ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, library_device_ms=lib_dev)
            worst = max(rel, key=rel.get)
            log(f'banded pass {k} (both stages, P={p}, 51^2 base): '
                f'vs plain worst rel-L2 {rel[worst]:.3e} ({worst}, tol '
                f'{PASS_TOL}), max_abs_err {err:.3e}, kernel_ms {ms:.3f} '
                f'device_ms {fmt_ms(dev_ms)} plain_ms {plain_ms:.3f} '
                f'cudnn_ms {lib_ms:.3f} cudnn device_ms {fmt_ms(lib_dev)} '
                f'({CUDNN_PASS_WORK[k]}); ' + json.dumps(
                    {n_: float(f'{v:.2e}') for n_, v in rel.items()}))
            assert rel[worst] <= PASS_TOL, (k, worst, rel[worst])
        # the planted fault inside pass B's wgrad reduction must fail the
        # per-pass limit
        faulty = pass_b_wgrad_without_last_plane(fdb.pass_b)
        bad = max(_rel_l2(faulty(*ins)['conv2_weight'],
                          plain(*ins)['conv2_weight'])
                  for _, plain, ins, _ in calls['B'])
        log(f'banded pass B planted fault "conv2 wgrad reduction without '
            f'the last plane (in the kernel)": conv2_weight rel-L2 '
            f'{bad:.3e} (tol {PASS_TOL})')
        assert bad > PASS_TOL, bad
        passes['B']['planted_fault_rel_err'] = bad

    # the composed backward
    names = decoder_leaves()

    def banded(*a):
        return fd.fused_vlg_decoder(*a, bwd='banded')

    def grads(fn):
        return decoder_grads(fn, acts, params, g)

    ref, ref64 = _held_refs(acts, params, g)
    ref32 = grads(_rounded())
    noise = {nm: _rel_l2(a, r) for nm, a, r in zip(names, ref64, ref32)}
    log(f'banded bwd P={p}: the float32-sum reference against the float64 '
        f'one (the control of the composed limit): worst leaf '
        f'{max(noise.values()):.3e} ({max(noise, key=noise.get)})')
    got = grads(banded)
    whole = grads(fd.fused_vlg_decoder)
    torch.cuda.synchronize()
    rel = {nm: _rel_l2(a, r) for nm, a, r in zip(names, got, ref)}
    composed = _gates(got, (ref, ref64), names)
    vs_whole = {nm: _rel_l2(a, r) for nm, a, r in zip(names, got, whole)}
    whole_rel = {nm: _rel_l2(a, r) for nm, a, r in zip(names, whole, ref)}
    vs32 = max(_rel_l2(a, r) for a, r in zip(got, ref32))
    worst = max(rel, key=rel.get)
    log(f'banded bwd P={p}: per-leaf rel-L2 vs rounded (float64 sums, the '
        f'stored stage-1 conv2): worst {worst} {rel[worst]:.3e} (tol '
        f'{DEC_BWD_TOL}); composed, vs rounded with float64 sums '
        f'recomputing stage 1: worst {composed["composed_leaf"]} '
        f'{composed["composed"]:.3e} (tol {DEC_BWD_COMPOSED_TOL}); vs the '
        f'float32-sum reference (data): {vs32:.3e}; whole-plane kernels vs '
        f'rounded: worst {max(whole_rel.values()):.3e}; banded vs '
        f'whole-plane: worst {max(vs_whole.values()):.3e} '
        f'({max(vs_whole, key=vs_whole.get)}); ' + json.dumps(
            {k: float(f'{v:.2e}') for k, v in rel.items()}))
    faults = {}
    for what, planted in BANDED_FAULTS.items():
        with planted():
            bad = grads(banded)
        errs = {nm: _rel_l2(a, r) for nm, a, r in zip(names, bad, ref)}
        faults[what] = max(errs.values())
        log(f'banded bwd planted fault "{what}": worst rel-L2 '
            f'{faults[what]:.3e} ({max(errs, key=errs.get)}), '
            f'{sum(e > DEC_BWD_TOL for e in errs.values())} of {len(errs)} '
            f'leaves past the tol')
    fwd_faults = {}
    for what, planted in FORWARD_FAULTS.items():
        with planted():
            bad = grads(banded)
        fwd_faults[what] = _gates(bad, (ref, ref64), names)['composed']
        log(f'banded bwd planted forward fault "{what}": composed worst '
            f'rel-L2 {fwd_faults[what]:.3e} (must exceed '
            f'{DEC_BWD_COMPOSED_TOL})')
    assert rel[worst] <= DEC_BWD_TOL, (worst, rel[worst])
    assert composed['composed'] <= DEC_BWD_COMPOSED_TOL, composed
    assert max(vs_whole.values()) <= DEC_BWD_TOL, vs_whole
    assert all(e > DEC_BWD_TOL for e in faults.values()), faults
    assert all(e > DEC_BWD_COMPOSED_TOL for e in fwd_faults.values()), \
        fwd_faults

    prms = ([p1[k] for k in fd.STAGE_KEYS] + [p2[k] for k in fd.STAGE_KEYS]
            + [head.weight, head.bias])

    def bwd_ms(fn):
        xs = [t.detach().requires_grad_(True) for t in acts]
        out = fn(*xs, *params)
        return cuda_ms(lambda: torch.autograd.grad(out, xs + prms, g,
                                                   retain_graph=True), 3)

    banded_ms = bwd_ms(banded)
    whole_ms = bwd_ms(fd.fused_vlg_decoder)
    plain_ms = bwd_ms(fd.fused_vlg_decoder_plain)
    lib_ms = bwd_ms(lambda *a: _cudnn_chain(up1, up2, head, *a[:3]))
    work = [_banded_pass_work(p, b, 128, 32, 64, h, h, False, False),
            _banded_pass_work(p, b, 64, 32, 32, 2 * h, 2 * h, True, True)]
    log(f'banded bwd P={p} x {tuple(acts[0].shape)}: whole backward banded '
        f'kernels_ms {banded_ms:.3f}, whole-plane kernels (#6/#7) ms '
        f'{whole_ms:.3f}, plain_ms {plain_ms:.3f}, cudnn_ms {lib_ms:.3f}')
    rows = {}
    for i, k in enumerate('ABC'):
        flops = work[0][i][0] + work[1][i][0]
        nbytes = work[0][i][1] + work[1][i][1]
        bound_ms, by = bound(flops, nbytes)
        q = passes[k]
        log(f'banded pass {k}: bound {bound_ms:.4f} ms ({by}), GFLOP '
            f'{flops / 1e9:.1f}, MB {nbytes / 1e6:.1f}')
        rows[k] = dict(max_abs_err=q['max_abs_err'],
                       rel_err=max(q['rel'].values()), tol=PASS_TOL,
                       ms=q['ms'], device_ms=q['device_ms'],
                       plain_ms=q['plain_ms'], bound_ms=bound_ms, bound_by=by,
                       library_ms=q['library_ms'],
                       library_device_ms=q['library_device_ms'],
                       library_is=CUDNN_PASS_WORK[k],
                       chain_library_bwd_ms=lib_ms,
                       composed_rel_err_vs_rounded=rel[worst],
                       composed_rel_err=composed['composed'],
                       composed_tol=DEC_BWD_COMPOSED_TOL,
                       planted_forward_faults=fwd_faults,
                       banded_bwd_ms=banded_ms, whole_plane_bwd_ms=whole_ms,
                       plain_bwd_ms=plain_ms, planted_faults=faults)
    return rows


# ------------------------------------------------------------ phase 5

class SynthImages:
    """uint8 images with label maps, by default at VOC val geometry (short
    side 512)."""

    def __init__(self, seed, sizes=((512, 683), (683, 512), (512, 512),
                                    (512, 768)), nclass=21):
        rs = np.random.RandomState(seed)
        self.items = []
        for h, w in sizes:
            img = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
            mask = rs.randint(0, nclass, (h, w)).astype(np.uint8)
            mask[:8] = 255
            self.items.append({'img': img, 'mask': mask})

    def __len__(self):
        return len(self.items)

    def get(self, i):
        return self.items[i]


def run_slice():
    from semivl_tpu_torch.configs import flagship_cfg
    from semivl_tpu_torch.evaluation.predict import (
        Evaluator, _chunk_sizes, evaluate)
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd

    cfg = flagship_cfg(512)
    t0 = time.perf_counter()
    bundle = build_model(cfg, dtype=torch.bfloat16, device='cuda', seed=0)
    model = bundle.model
    with torch.no_grad():   # weight scales that keep 12 layers finite
        for mod, s in ((model.backbone, 0.05), (model.decode_head, 0.2)):
            for prm in mod.parameters():
                if prm.ndim >= 2:
                    prm.mul_(s)
    evaluator = Evaluator(model, bundle.text_feats, cfg, device='cuda')
    ds = SynthImages(seed=0)
    log(f'slice: built flagship model in {time.perf_counter() - t0:.1f} s, '
        f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params')

    # warm-up pass, which also checks every prediction
    for i in range(len(ds)):
        s = ds.get(i)
        pred = evaluator.predict(s['img'][None], s['mask'].shape,
                                 cfg['eval_mode'])
        assert pred.shape == (1,) + s['mask'].shape, pred.shape
        assert 0 <= pred.min() and pred.max() < cfg['nclass']
    n_crops = n_batches = 0
    for i in range(len(ds)):
        coords = evaluator._zegclip_coords(*ds.get(i)['img'].shape[:2])
        n_crops += len(coords)
        n_batches += len(_chunk_sizes(len(coords)))

    # the main path: counts to 0, evaluate, counts read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.heads_launches = fd.launches = 0
    t0 = time.perf_counter()
    miou, iou = evaluate(evaluator, ds, cfg['eval_mode'], cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {'attention': fa.launches, 'heads': fa.heads_launches,
                'decoder': fd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f'slice: evaluate over {len(ds)} images, {n_crops} crops in '
        f'{n_batches} crop batches: mIoU {miou:.4f} in {dt * 1e3:.1f} ms -> '
        f'{dt * 1e3 / n_crops:.2f} ms per 512^2 crop, '
        f'{len(ds) / dt:.3f} images/s, peak memory {peak / 2**20:.1f} MiB')
    log(f'slice: launches {launches} (expected {14 * n_batches} and '
        f'{2 * n_batches})')
    assert np.isfinite(miou) and 0 <= miou <= 100 and iou.shape == (21,)
    assert launches['attention'] == 14 * n_batches, launches
    assert launches['decoder'] == 2 * n_batches, launches
    assert launches['heads'] == 0, launches

    # one crop batch through the kernels and through the plain versions
    s = ds.get(0)
    img = torch.from_numpy(s['img']).cuda()
    crops = torch.stack([img[y:y + 512, x:x + 512] for y, x in
                         evaluator._zegclip_coords(*s['img'].shape[:2])])
    with torch.no_grad():
        inp = evaluator._to_model_input(crops)
        k_logits = model(inp, evaluator.text)
        with mock.patch.object(fa, 'packed_attention',
                               fa.packed_attention_plain), \
                mock.patch.object(fd, 'fused_vlg_decoder',
                                  _route_blind(fd.fused_vlg_decoder_plain)):
            p_logits = model(inp, evaluator.text)
    torch.cuda.synchronize()
    assert k_logits.shape == (crops.shape[0], 21, 512, 512)
    assert torch.isfinite(k_logits).all()
    diff = (k_logits - p_logits).abs()
    scale = p_logits.abs().max().item()
    agree = (k_logits.argmax(1) == p_logits.argmax(1)).float().mean().item()
    log(f'slice: crop batch {tuple(crops.shape)} kernels vs plain: '
        f'max_abs_err {diff.max().item():.3e} mean_abs_err '
        f'{diff.mean().item():.3e} logit scale {scale:.3f} argmax agreement '
        f'{agree:.5f}')
    assert diff.max().item() <= DEC_TOL * scale
    profile_image(evaluator, ds.get(0), cfg)
    profile_evaluate(evaluator, ds, cfg, 'slice')
    return launches


# ------------------------------------------------------------ phase 6

def _counters():
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    return dict(attention_fwd=fa.launches, attention_bwd=fa.bwd_launches,
                heads_fwd=fa.heads_launches, heads_bwd=fa.heads_bwd_launches,
                decoder_fwd=fd.launches,
                decoder_bwd_tail=fd.bwd_tail_launches,
                decoder_bwd_input=fd.bwd_input_launches,
                banded_pass_a=fdb.pass_a_launches,
                banded_pass_b=fdb.pass_b_launches,
                banded_pass_c=fdb.pass_c_launches)


def _reset_counters():
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    fa.launches = fa.bwd_launches = 0
    fa.heads_launches = fa.heads_bwd_launches = 0
    fd.launches = fd.bwd_tail_launches = fd.bwd_input_launches = 0
    fdb.pass_a_launches = fdb.pass_b_launches = fdb.pass_c_launches = 0


def train_batch(gen, b=2, size=512, nclass=21):
    """A synthetic training batch on the card (exp 40 by default):
    normalised-scale images, label maps with ignored (255) borders, CutMix
    boxes as (y, x, h, w)."""
    def img():
        return torch.randn(b, size, size, 3, generator=gen, device='cuda')

    mask = torch.randint(0, nclass, (b, size, size), generator=gen,
                         device='cuda')
    mask[:, :16] = 255
    ign = torch.zeros(b, size, size, dtype=torch.long, device='cuda')
    ign[:, :, -24:] = 255
    ign_o = ign.clone()
    ign_o[:, -24:] = 255

    def boxes():
        hw = torch.randint(size // 4, size // 2 + 1, (b, 2), generator=gen,
                           device='cuda')
        yx = torch.randint(0, size // 2, (b, 2), generator=gen, device='cuda')
        return torch.cat([yx, hw], dim=1).int()

    return dict(img_x=img(), mask_x=mask, img_w=img(), img_s1=img(),
                img_s2=img(), ignore_mask=ign, img_w_other=img(),
                img_s1_other=img(), img_s2_other=img(),
                ignore_mask_other=ign_o, cutmix_box1=boxes(),
                cutmix_box2=boxes())


def scaled_bundle(cfg):
    """The run config's model with seeded random weights, every matrix of
    the ViTs x0.05 and of a VLG decoder x0.2 (12 layers stay finite); a
    conv encoder and a DeepLabV3+ head keep their init (BatchNorm
    normalises them)."""
    from semivl_tpu_torch.models.builder import build_model
    bundle = build_model(cfg, dtype=torch.bfloat16, device='cuda', seed=0)
    m = bundle.model
    vlg = hasattr(m.decode_head, 'up1')
    with torch.no_grad():
        for mod, s in ((m.backbone, 0.05), (m.clip_encoder, 0.05),
                       (m.decode_head if vlg else None, 0.2)):
            for prm in (mod.parameters() if mod is not None else ()):
                if prm.ndim >= 2:
                    prm.mul_(s)
    return bundle


def make_step(cfg):
    """The step factory of the run config's method."""
    from semivl_tpu_torch.train import step
    return (step.make_supervised_train_step
            if cfg.get('method') == 'supervised'
            else step.make_semivl_train_step)


def run_train(cfg, bundle, batch, steps=3, expected=EXPECTED_PER_STEP,
              unmoved=()):
    """A training main path: a warm-up step, then ``steps`` timed steps
    with every kernel's launch count read around them (``expected`` per
    step); trainable leaves and BatchNorm running statistics must change,
    frozen leaves must not, nor the trainable leaves ``unmoved`` (which no
    loss reaches and no weight decay moves)."""
    from semivl_tpu_torch.train.optim import build_optimizer
    model = bundle.model
    opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
    step = make_step(cfg)(bundle, cfg, opt, TOTAL_ITERS)
    gen = torch.Generator(device='cuda').manual_seed(3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: t.clone() for n, t in model.named_buffers()}
    t0 = time.perf_counter()
    step(batch, gen)
    torch.cuda.synchronize()
    log(f'train: warm-up step {time.perf_counter() - t0:.2f} s')

    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(batch, gen)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in metrics.items()}
    semi = 'mask_x' in batch
    b, size = batch['mask_x' if semi else 'mask'].shape[:2]
    imgs = (2 if semi else 1) * b    # labeled + unlabeled (bench.py)
    log(f'train: {steps} steps at {size}^2, batch {b} labeled'
        + (f' + {b} unlabeled' if semi else '') + f': {dt * 1e3:.1f} '
        f'ms/step, {imgs / dt:.2f} images/s, peak memory '
        f'{peak / 2**20:.1f} MiB')
    log(f'train: metrics {json.dumps(metrics)}')
    log(f'train: launches over {steps} steps {launches} (expected per step '
        f'{expected})')
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    for k, v in expected.items():
        assert launches[k] == v * steps, (k, launches[k], v)
    for n, t in model.named_buffers():
        assert not torch.equal(t, buffers[n]), f'{n} unchanged'
    if buffers:
        log(f'train: {len(buffers)} BatchNorm running statistics all changed')
    n_train = n_frozen = 0
    for n, p in model.named_parameters():
        if p.requires_grad and n not in unmoved:
            n_train += 1
            assert not torch.equal(p.detach(), before[n]), f'{n} unchanged'
        else:
            n_frozen += 1
            assert torch.equal(p.detach(), before[n]), f'{n} changed'
    log(f'train: {n_train} trainable leaves all changed, {n_frozen} frozen '
        f'leaves bit-identical ({len(unmoved)} of them trainable leaves '
        f'that no loss reaches and no weight decay moves)')
    return step, {k: v // steps for k, v in launches.items()}, dict(
        ms_per_step=dt * 1e3, images_per_s=imgs / dt, peak_mib=peak / 2**20)


# ---------------------------------------------------------- phases 7-8

def run_cityscapes_eval():
    """exp 44's evaluation: ``sliding_window`` over one synthetic 1024x2048
    image, launch counts read around ``evaluate``."""
    from semivl_tpu_torch.configs import cityscapes_cfg
    from semivl_tpu_torch.evaluation.predict import (
        Evaluator, _chunk_sizes, evaluate)
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    cfg = cityscapes_cfg()
    t0 = time.perf_counter()
    bundle = scaled_bundle(cfg)
    model = bundle.model
    evaluator = Evaluator(model, bundle.text_feats, cfg, device='cuda')
    ds = SynthImages(seed=0, sizes=((1024, 2048),), nclass=19)
    windows = evaluator.sliding_windows(1024, 2048)
    calls = sum(len(_chunk_sizes(len(v))) for v in windows.values())
    log(f'cityscapes eval: built exp-44 model in {time.perf_counter() - t0:.1f}'
        f' s, {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M '
        f'params; windows {json.dumps({str(k): len(v) for k, v in windows.items()})}'
        f' -> {calls} model calls per image')
    assert sum(len(v) for v in windows.values()) == 8 and len(windows) == 4
    s = ds.get(0)
    pred = evaluator.predict(s['img'][None], s['mask'].shape, cfg['eval_mode'])
    assert pred.shape == (1, 1024, 2048) and 0 <= pred.min() \
        and pred.max() < 19
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.heads_launches = fd.launches = 0
    t0 = time.perf_counter()
    miou, iou = evaluate(evaluator, ds, cfg['eval_mode'], cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {'attention': fa.launches, 'heads': fa.heads_launches,
                'decoder': fd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f'cityscapes eval: 1 image 1024x2048, 8 windows: mIoU {miou:.4f} in '
        f'{dt * 1e3:.1f} ms per image, peak memory {peak / 2**20:.1f} MiB; '
        f'launches {launches} (expected {14 * calls} and {2 * calls})')
    assert np.isfinite(miou) and iou.shape == (19,)
    assert launches == {'attention': 14 * calls, 'heads': 0,
                        'decoder': 2 * calls}

    # one crop batch (the two 801^2 windows) through the kernels and plain
    img = torch.from_numpy(s['img']).cuda()
    crops = torch.stack([img[y:y + 801, x:x + 801]
                         for y, x in windows[(801, 801)][:2]])
    text = evaluator.text
    with torch.no_grad():
        inp = evaluator._to_model_input(crops)
        k_logits = model(inp, text)
        with mock.patch.object(fa, 'packed_attention',
                               fa.packed_attention_plain), \
                mock.patch.object(fd, 'fused_vlg_decoder',
                                  _route_blind(fd.fused_vlg_decoder_plain)):
            p_logits = model(inp, text)
    torch.cuda.synchronize()
    assert k_logits.shape == (2, 19, 801, 801)
    assert torch.isfinite(k_logits).all()
    diff = (k_logits - p_logits).abs()
    scale = p_logits.abs().max().item()
    agree = (k_logits.argmax(1) == p_logits.argmax(1)).float().mean().item()
    log(f'cityscapes eval: crop batch {tuple(crops.shape)} kernels vs plain: '
        f'max_abs_err {diff.max().item():.3e} mean_abs_err '
        f'{diff.mean().item():.3e} logit scale {scale:.3f} argmax agreement '
        f'{agree:.5f}')
    assert diff.max().item() <= DEC_TOL * scale
    prof = profile_image(evaluator, s, cfg)
    profile_evaluate(evaluator, SynthImages(seed=1, sizes=((1024, 2048),) * 2,
                                            nclass=19), cfg,
                     'cityscapes eval')
    return launches, dict(ms_per_image=dt * 1e3, peak_mib=peak / 2**20,
                          calls=calls, **prof)


def run_cityscapes_train():
    """exp 44's training step on the banded route: the timed steps with
    launch counts, a profile, then one step with every kernel call held to
    its rounded reference on the call's own inputs."""
    from semivl_tpu_torch.configs import cityscapes_train_cfg
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    cfg = cityscapes_train_cfg()
    t0 = time.perf_counter()
    bundle = scaled_bundle(cfg)
    model = bundle.model
    prms = list(model.parameters())
    log(f'cityscapes train: built the exp-44 training bundle in '
        f'{time.perf_counter() - t0:.1f} s, '
        f'{sum(p.numel() for p in prms) / 1e6:.1f} M params, '
        f'{sum(p.numel() for p in prms if p.requires_grad) / 1e6:.1f} M '
        f'trainable, decoder backward {model.decode_head.decoder_bwd}')
    assert model.decode_head.decoder_bwd == 'banded'
    batch = train_batch(torch.Generator(device='cuda').manual_seed(6), b=1,
                        size=801, nclass=19)
    # the timed steps first: run after the per-call check's float64
    # references, the same steps measured ~50 % slower. The check then
    # takes its step from the model as built: the timed steps' updates are
    # not bit for bit the same from run to run (library reductions), and
    # GroupNorm amplifies what that moves in the decoder's inputs.
    state = {k: v.clone() for k, v in model.state_dict().items()}
    step, launches, perf = run_train(cfg, bundle, batch,
                                     expected=EXPECTED_CITYSCAPES)
    prof = profile_step(step, batch)
    del step
    model.load_state_dict(state)
    per_call = PerCallCheck(bwd='banded')
    opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
    check_step = make_semivl_train_step(bundle, cfg, opt, TOTAL_ITERS)
    with contextlib.ExitStack() as stack:
        for patch in per_call.patches():
            stack.enter_context(patch)
        metrics = {k: float(v) for k, v in check_step(
            batch, torch.Generator(device='cuda').manual_seed(7)).items()}
    worst = per_call.finish()
    model.load_state_dict(state)
    tols = dict(PER_CALL_TOLS, decoder_banded=STEP_DEC_BWD_TOL)
    log('cityscapes compare: per call, kernels vs rounded on the step\'s own '
        'inputs (worst rel-L2, calls, tol): ' + json.dumps(
            {k: [float(f'{e:.3e}'), n, tols[k]] for k, (e, n) in
             worst.items()}) + f'; loss terms {json.dumps(metrics)}')
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    per_call.check(tols, absent=('heads_fwd', 'heads_bwd'))
    return worst, launches, dict(perf, **prof)


def _gap_threshold(conf, lo_q=0.5, hi_q=0.95):
    """A threshold in the widest gap of the sorted confidences between two
    quantiles, and its distance to the nearest confidence."""
    v = conf.double().flatten().sort().values
    lo, hi = int(lo_q * len(v)), int(hi_q * len(v))
    i = lo + int(torch.argmax(v[lo + 1:hi] - v[lo:hi - 1]))
    return ((v[i] + v[i + 1]) / 2).item(), ((v[i + 1] - v[i]) / 2).item()


def _step_readings(got, ref):
    """Each limit's reading of one step (metrics, gradients, pseudo-labels)
    against the reference step's."""
    (m, g, lab), (m_r, g_r, lab_r) = got, ref
    top = max(t.abs().max().item() for t in g_r.values())
    leaves = {n: _rel_l2(g[n], g_r[n]) for n in g_r
              if g_r[n].abs().max().item() > VANISHING * top}
    norm = torch.stack([t.norm() for t in g.values()]).norm()
    norm_r = torch.stack([t.norm() for t in g_r.values()]).norm()
    worst = max(leaves, key=leaves.get)
    return dict(
        loss=max(abs(m[k] - m_r[k]) / abs(m_r[k]) for k in m_r),
        grad_median=sorted(leaves.values())[len(leaves) // 2],
        grad_worst=leaves[worst], worst_leaf=worst, leaves=len(leaves),
        vanishing=[n for n in g_r if n not in leaves],
        norm_ratio=(norm / norm_r).item(),
        agree=(lab == lab_r).float().mean().item())


class PerCallCheck:
    """Holds every kernel call of a step against its rounded reference on
    that call's own inputs: the forward kernels' outputs and the attention
    backward's gradient as they happen, the decoder backward afterwards from
    each call's recorded inputs, parameters and output gradient. ``worst``
    holds each kernel's worst relative L2 and the number of calls.

    The decoder backward is held to the rounded reference with float64
    sums, at the point the call's forward reached: the reference takes
    stage 1's raw conv2 as the kernels stored it, the input their backward
    reads (``raw2_1``). Its distance to the float32-sum reference is logged
    as data: on a step's own inputs that reference's float32 sums lie
    several per cent from its float64 ones, as far as the limits, and a
    flipped bf16 rounding of the stored raw conv2, which GroupNorm
    amplifies, moves the whole backward of stage 2. ``faults``: each call is
    rerun under DECODER_FAULTS (or the given dict of them), which must
    exceed the decoder's limit. ``attn_faults``: each packed attention call
    (forward and backward) over more than one key tile is rerun with phase
    3's planted fault, its last key tile skipped, which must exceed the
    attention's limits."""

    def __init__(self, bwd='whole', faults=False, attn_faults=False):
        from semivl_tpu_torch.ops import flash_attention as fa
        from semivl_tpu_torch.ops import fused_decoder as fd
        self.fa, self.fd = fa, fd
        self.bwd_key = 'decoder_bwd' if bwd == 'whole' else 'decoder_banded'
        self.worst = {k: [0.0, 0] for k in ('attention_fwd', 'attention_bwd',
                                            'heads_fwd', 'heads_bwd',
                                            'decoder_fwd', self.bwd_key)}
        self.decoder_calls = []
        self.planes = []   # P of each decoder call, in call order
        # True: every DECODER_FAULTS entry; a dict: those faults
        self.faults = DECODER_FAULTS if faults is True else (faults or {})
        self.fault_reads = []
        self.attn_faults = attn_faults
        self.attn_fault_reads = []   # (direction, L, rel-L2)

    @staticmethod
    def _last_tile_skipped(length):
        """The keys phase 3's planted fault keeps: all but the last
        128-key tile (or its partial tail)."""
        return length - (length % 128 or 128)

    def note(self, key, err):
        w = self.worst[key]
        w[0], w[1] = max(w[0], err), w[1] + 1

    def patches(self):
        fa, fd = self.fa, self.fd
        real_fwd, real_bwd = fa._fwd_kernel, fa.flash_mha_bwd
        real_hfwd, real_hbwd = fa.flash_mha_heads, fa.flash_mha_heads_bwd
        real_dec = fd.fused_vlg_decoder

        def fwd(q, k, v, heads, valid_len, with_lse):
            out, lse = real_fwd(q, k, v, heads, valid_len, with_lse)
            ref = fa._fwd_rounded(q, k, v, heads, valid_len)
            self.note('attention_fwd', _rel_l2(out, ref))
            length = q.shape[1]
            if self.attn_faults and valid_len == length \
                    and self._last_tile_skipped(length):
                bad = real_fwd(q, k, v, heads,
                               self._last_tile_skipped(length), False)[0]
                self.attn_fault_reads.append(('fwd', length,
                                              _rel_l2(bad, ref)))
            return out, lse

        def bwd(qkv, out, lse, g, heads, valid_len=None):
            got = real_bwd(qkv, out, lse, g, heads, valid_len)
            ref = fa.flash_mha_bwd_plain(qkv, out, g, heads, valid_len)
            self.note('attention_bwd', _rel_l2(got, ref))
            length = qkv.shape[1]
            if self.attn_faults and valid_len in (None, length) \
                    and self._last_tile_skipped(length):
                bad = fa._bwd_kernel(qkv, out, lse, g, heads,
                                     self._last_tile_skipped(length))
                self.attn_fault_reads.append(('bwd', length,
                                              _rel_l2(bad, ref)))
            return got

        def hfwd(qkv, heads, valid_len=None, with_lse=False):
            out, lse = real_hfwd(qkv, heads, valid_len, with_lse)
            self.note('heads_fwd', _rel_l2(out, fa.heads_attention_plain(
                qkv, heads, valid_len)))
            return out, lse

        def hbwd(qkv, out, lse, g, heads, valid_len=None):
            got = real_hbwd(qkv, out, lse, g, heads, valid_len)
            self.note('heads_bwd', _rel_l2(got, fa.flash_mha_bwd_plain(
                qkv, out, g, heads, valid_len)))
            return got

        def dec(x, skip1, skip2, p1, p2, head, bwd='whole'):
            self.planes.append(x.shape[0])
            out = real_dec(x, skip1, skip2, p1, p2, head, bwd=bwd)
            with torch.no_grad():
                ref = fd.fused_vlg_decoder_rounded(x, skip1, skip2, p1, p2,
                                                   head)
            self.note('decoder_fwd', _rel_l2(out, ref))
            if out.requires_grad:   # the step updates the parameters
                inputs = [t.detach().clone() for t in (x, skip1, skip2)]
                params = [{k: v.detach().clone() for k, v in d.items()}
                          for d in (p1, p2, head)]
                out.register_hook(lambda g: self.decoder_calls.append(
                    (inputs, params, g, bwd)))
            return out

        return [mock.patch.object(fa, '_fwd_kernel', fwd),
                mock.patch.object(fa, 'flash_mha_bwd', bwd),
                mock.patch.object(fa, 'flash_mha_heads', hfwd),
                mock.patch.object(fa, 'flash_mha_heads_bwd', hbwd),
                mock.patch.object(fd, 'fused_vlg_decoder', dec)]

    def check(self, tols, absent):
        """Every kernel of the path called and within its limit; the
        kernels in ``absent`` never called (the routing of the path); with
        ``faults`` every planted fault past the decoder's limit."""
        for k, (err, n) in self.worst.items():
            if k in absent:
                assert n == 0, (k, n)
            else:
                assert n > 0 and err <= tols[k], (k, err, n)
        assert all(bad > tols[self.bwd_key] for _, _, bad in
                   self.fault_reads), self.fault_reads
        assert all(bad > tols[f'attention_{d}'] for d, _, bad in
                   self.attn_fault_reads), self.attn_fault_reads

    def finish(self):
        """The decoder backward of each recorded call, kernels against the
        rounded reference, every gradient leaf but those that vanish (a
        sum that is zero in exact arithmetic, as the head bias's is under
        the cross entropy over class planes, carries only rounding)."""
        fd, names = self.fd, decoder_leaves()
        for inputs, params, g, bwd in self.decoder_calls:
            def kernels(*a):
                return fd.fused_vlg_decoder(*a, bwd=bwd)

            with torch.no_grad():   # the stage-2 input the backward reads
                raw2_1 = fd._stage(*inputs[:2], params[0])[0]
            got, ref32, ref64 = (
                decoder_grads(fn, inputs, params, g) for fn in (
                    kernels, _rounded(raw2_1=raw2_1),
                    _rounded(float64=True, raw2_1=raw2_1)))
            ref = ref64
            top = max(r.abs().max().item() for r in ref)
            kept = [i for i, r in enumerate(ref)
                    if r.abs().max().item() > VANISHING * top]

            def rel(grads, want):
                return {names[i]: _rel_l2(grads[i], want[i]) for i in kept}

            def fmt(d):
                return json.dumps({k: float(f'{v:.3e}') for k, v in d.items()})

            errs, noise = rel(got, ref), rel(ref32, ref64)
            p = inputs[0].shape[0]
            msg = (f'compare: decoder backward ({bwd}) call P={p}, per-leaf '
                   f'rel-L2 vs rounded (float64 sums): {fmt(errs)}; '
                   f'vanishing: {sorted(set(names) - set(errs))}; the '
                   f'reference\'s float32 against its float64 sums: worst '
                   f'leaf {max(noise.values()):.3e}; kernels vs the '
                   f'float32-sum reference (data): {fmt(rel(got, ref32))}')
            if self.faults:
                for what, fault in self.faults.items():
                    with fault():
                        bad = max(rel(decoder_grads(kernels, inputs, params,
                                                    g), ref).values())
                    self.fault_reads.append((p, what, bad))
                    msg += f'; planted fault ({what}) worst leaf {bad:.3e}'
            log(msg)
            self.note(self.bwd_key, max(errs.values()))
        return self.worst


def compare_step(cfg, bundle, batch):
    """One step with the kernels against one with the rounded references
    patched in (``packed_attention_rounded``, ``fused_vlg_decoder_rounded``:
    plain PyTorch that rounds to bf16 where the kernels do), from the same
    state, batch and injected feature-perturbation masks. The confidence
    thresholds are lowered into gaps of this batch's confidences, so every
    loss term carries gradient; the pseudo-labels and confidences the
    kernels step draws are replayed in the others (argmax labels of a
    near-uniform random-init teacher flip under any change of rounding),
    and each route's own labels are compared apart.

    Two kinds of reading. Per call (``PerCallCheck``): every kernel launch
    of the kernels step against its rounded reference on that call's own
    inputs, held to the kernel limits of phases 3-4. Whole step: loss
    terms, pseudo-label agreement, the global gradient norm and the median
    of the trainable leaves' gradient errors. The whole-step gradient
    cannot be held tighter than the network's own bf16 noise: the two
    routes' decoder inputs differ by ~1e-4, and GroupNorm over
    bf16-stored raw convolutions turns that into several per cent of
    gradient. A step with a planted fault (the decoder's conv1 dgrad
    without a tap) must fail the whole-step gradient limits."""
    from semivl_tpu_torch.models import vlm as vlm_mod
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    from semivl_tpu_torch.train import step as step_mod
    from semivl_tpu_torch.train.optim import build_optimizer
    model = bundle.model
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device='cuda').manual_seed(5)
    b = batch['mask_x'].shape[0]
    keeps = [torch.rand(b, 1, 1, c, generator=gen, device='cuda') < 0.5
             for c in (768, 768, 512)]
    calls = [0]

    def fp_dropout(x, rate, generator=None):
        keep = keeps[calls[0] % len(keeps)]
        calls[0] += 1
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    text = torch.as_tensor(bundle.text_feats).cuda()
    mcc_text = torch.as_tensor(bundle.mcc_text_feats).cuda()
    unlabeled = torch.cat([batch['img_w_other'], batch['img_w']])
    guided = torch.cat([batch['img_w'], batch['img_w_other']])
    with torch.no_grad():
        conf = torch.softmax(model(unlabeled, text).float(), 1).amax(1)
        mc_conf = model.maskclip_probs(guided, mcc_text).amax(-1)
    (th, th_gap), (mc_th, mc_gap) = _gap_threshold(conf), _gap_threshold(
        mc_conf)
    cfg = dict(cfg, conf_thresh=th, mcc_conf_thresh=mc_th)
    log(f'compare: thresholds lowered into gaps of this batch\'s '
        f'confidences: conf_thresh {th:.6f} (gap +-{th_gap:.2e}), '
        f'mcc_conf_thresh {mc_th:.6f} (gap +-{mc_gap:.2e})')

    recorded = {}

    def pinned(owner, name):
        """The step's label source ``owner.name``: its outputs recorded in
        the first (kernels) step and replayed in the later ones."""
        if name not in recorded:
            real, recorded[name] = getattr(owner, name), []

            def record(*args, **kwargs):
                recorded[name].append(real(*args, **kwargs))
                return recorded[name][-1]

            return mock.patch.object(owner, name, record)
        replay = iter(recorded[name])
        return mock.patch.object(owner, name, lambda *a, **k: next(replay))

    def one(*patches):
        model.load_state_dict(state)
        opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
        step = step_mod.make_semivl_train_step(bundle, cfg, opt,
                                              TOTAL_ITERS)
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(vlm_mod, 'dropout2d',
                                                  fp_dropout))
            for patch in patches:
                stack.enter_context(patch)
            with torch.no_grad():   # this route's own pseudo-labels
                c, lab = torch.softmax(model(unlabeled, text).float(),
                                       1).max(1)
                labels = torch.cat([
                    torch.where(c >= th, lab, 255).flatten(),
                    model.forward_maskclip(guided, mcc_text,
                                           mc_th).flatten()])
            stack.enter_context(pinned(step_mod, '_softmax_conf_label'))
            stack.enter_context(pinned(vlm_mod.VLM, 'forward_maskclip'))
            metrics = {k: float(v) for k, v in step(batch).items()}
        grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
                 if p.requires_grad}   # every trainable leaf has a gradient
        return metrics, grads, labels

    per_call = PerCallCheck()
    kern = one(*per_call.patches())
    worst = per_call.finish()
    ref = one(mock.patch.object(fa, 'packed_attention',
                                fa.packed_attention_rounded),
              mock.patch.object(fd, 'fused_vlg_decoder',
                                _route_blind(fd.fused_vlg_decoder_rounded)))
    fault = one(conv1_dgrad_without_a_tap())
    model.load_state_dict(state)
    torch.cuda.synchronize()
    tols = dict(PER_CALL_TOLS, decoder_bwd=STEP_DEC_BWD_TOL)
    log('compare: per call, kernels vs rounded on the step\'s own inputs '
        '(worst rel-L2, calls, tol): ' + json.dumps(
            {k: [float(f'{e:.3e}'), n, tols[k]] for k, (e, n) in
             worst.items()}))
    log(f'compare: loss terms kernels {json.dumps(kern[0])}')
    log(f'compare: loss terms rounded {json.dumps(ref[0])}')
    limits = dict(loss=STEP_LOSS_TOL, grad_median=STEP_GRAD_TOL,
                  norm_ratio=STEP_NORM_TOL, agree=STEP_AGREE_MIN)
    r = _step_readings(kern, ref)
    rf = _step_readings(fault, ref)
    for what, rd in (('kernels', r), ('planted fault (decoder conv1 dgrad '
                                      'without a tap)', rf)):
        log(f'compare: {what} vs rounded: loss terms rel diff '
            f'{rd["loss"]:.3e}; per-leaf gradient rel-L2 median '
            f'{rd["grad_median"]:.3e} over {rd["leaves"]} leaves, worst '
            f'{rd["grad_worst"]:.3e} ({rd["worst_leaf"]}); global grad '
            f'norm ratio {rd["norm_ratio"]:.6f}; pseudo-label agreement '
            f'{rd["agree"]:.6f}; limits {json.dumps(limits)}')
    log(f'compare: vanishing leaves (not compared): {r["vanishing"]}')
    assert calls[0] == 9, calls
    assert all(kern[0][k] > 0 for k in step_mod.LOSS_KEYS), kern[0]
    per_call.check(tols, absent=('heads_fwd', 'heads_bwd'))
    assert r['loss'] <= STEP_LOSS_TOL, r
    assert r['grad_median'] <= STEP_GRAD_TOL, r
    assert abs(r['norm_ratio'] - 1) <= STEP_NORM_TOL, r
    assert r['agree'] >= STEP_AGREE_MIN, r
    assert rf['grad_median'] > STEP_GRAD_TOL, rf
    assert abs(rf['norm_ratio'] - 1) > STEP_NORM_TOL, rf
    return worst


def profile_step(step, batch, top=15):
    """Device time by kernel for one training step, against the
    unprofiled wall time of a step: the device's idle share."""
    gen = torch.Generator(device='cuda').manual_seed(4)

    def run():
        step(batch, gen)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    return _profile(run, wall_ms, 'one training step', top)


# the port's kernels in a profile, by a part of their profiler key, and the
# launch counters whose sum each must show as records
PROFILED_KERNELS = (
    ('attention_fwd::fwd_kernel', ('attention_fwd', 'heads_fwd')),
    ('attention_bwd::prep_kernel', ('attention_bwd', 'heads_bwd')),
    ('attention_bwd::dkdv_kernel', ('attention_bwd', 'heads_bwd')),
    ('attention_bwd::dq_kernel', ('attention_bwd', 'heads_bwd')))


# the decoder's kernels in a profile, by a part of their profiler key: the
# stage forward (#5: decoder_igemm.cuh's products, GN+ReLU passes and the
# head's CUDA-core conv3x3_kernel), the whole-plane backward (#6/#7:
# the same products and fused_decoder_bwd.cu's passes) and the banded
# passes (#8-#10)
DECODER_KERNEL_KEYS = ('conv3x3_kernel', 'gn_relu_kernel', 'gn_stats_kernel',
                       'igemm::', 'gn_bwd_', 'sum_partials', 'plane_sum',
                       'channel_total', 'gn_solve')


def _profile(run, wall_ms, what, top, windows=4):
    """One call of ``run`` under the profiler, by kernel. The profiler on
    the card's machine at times drops records, so a window is whole only
    if the port's kernels show as many records as their launch counters
    moved and another whole window shows the same kernels as many times;
    else it is taken again, up to ``windows`` windows. The records against
    the launches, and whether the window was whole, are logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for n in range(1, windows + 1):
        before = _counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        moved = {k: v - before[k] for k, v in _counters().items()}
        # device-side events only (an op's own entry repeats its kernels'
        # time); busy time counts kernels: a copy to pageable host memory
        # lasts as long as the host's staging does, so copies are apart
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total]
        # user annotations (``record_function`` ranges such as the
        # optimizer's ``Optimizer.step#AdamW.step``) span kernels that
        # have rows of their own: not kernel time. A kernel's name has
        # spaces or brackets (``{lambda()#3}``), an annotation's none.
        notes = {e.key for e in prof.key_averages()
                 if getattr(e, 'is_user_annotation', False)}
        annotations = [r for r in rows if r[2] in notes
                       or re.fullmatch(r'[\w.]+#[\w.]+', r[2])]
        copies = [r for r in rows if r[2].startswith(('Memcpy', 'Memset'))]
        rows = [r for r in rows if r not in copies and r not in annotations]
        counts = {key: count for _, count, key in rows}
        port = {name: (sum(c for k, c in counts.items() if name in k),
                       sum(moved[x] for x in keys))
                for name, keys in PROFILED_KERNELS}
        whole = all(got == want for got, want in port.values())
        if whole and counts in seen:
            break
        if whole:
            seen.append(counts)
    else:
        whole = False
    dev_ms = sum(r[0] for r in rows)
    log(f'profile: {what}: wall {wall_ms:.2f} ms (unprofiled), device busy '
        f'(kernels) {dev_ms:.2f} ms, idle share {1 - dev_ms / wall_ms:.3f}; '
        f'copies {[(round(ms, 3), key) for ms, _, key in copies]}; '
        f'annotations left out of busy '
        f'{[(round(ms, 3), key) for ms, _, key in annotations]}')
    log(f'profile:   window {n} of {windows}, whole: {whole}; the port\'s '
        f'kernels, records / launches: '
        f'{ {k.split("::")[1]: v for k, v in port.items()} }')
    # the top rows, and the attention kernels wherever they rank
    ranked = sorted(rows, reverse=True)
    for i, (ms, count, key) in enumerate(ranked):
        if i < top or 'attention_' in key:
            log(f'profile:   {ms:8.3f} ms {100 * ms / dev_ms:5.1f}% '
                f'x{count:<5d} {key[:90]}')
    # the backward's three kernels (prep, dK/dV, dQ) run once a call
    bwd_ms = sum(ms for ms, _, key in rows if 'attention_bwd' in key)
    log(f'profile:   attention backward, all three kernels: {bwd_ms:.3f} ms')
    dec_ms = sum(ms for ms, _, key in rows if any(
        k in key for k in DECODER_KERNEL_KEYS))
    log(f'profile:   decoder kernels (forward and backward): {dec_ms:.3f} ms, '
        f'{dec_ms / dev_ms:.3f} of busy')
    return dict(wall_ms=wall_ms, busy_ms=dev_ms,
                idle_share=1 - dev_ms / wall_ms, attention_bwd_ms=bwd_ms,
                decoder_ms=dec_ms, decoder_share=dec_ms / dev_ms,
                whole_window=whole, windows=n)


def profile_image(evaluator, sample, cfg, top=12):
    """Device time by kernel for one image (2 crops), against the
    unprofiled wall time of the same call: the device's idle share."""
    def run():
        evaluator.predict(sample['img'][None], sample['mask'].shape,
                          cfg['eval_mode'])
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(5):
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    return _profile(run, wall_ms, f'one {sample["img"].shape[:2]} image',
                    top)


def profile_evaluate(evaluator, ds, cfg, what):
    """``evaluate``'s wall time (unprofiled, mean of 3) and the device's
    idle share over ``ds``, pipelined (the defaults: ``eval_prefetch`` and
    ``eval_device_metrics``) and serial (both off), in turns; the two
    give equal histograms."""
    from semivl_tpu_torch.evaluation.predict import evaluate_histograms
    hists, out = {}, {}
    serial = dict(cfg, eval_prefetch=False, eval_device_metrics=False)
    for name, c in (('pipelined', cfg), ('serial', serial),
                    ('pipelined again', cfg)):
        def run(c=c, name=name):
            hists[name] = evaluate_histograms(evaluator, ds,
                                              cfg['eval_mode'], c)
            torch.cuda.synchronize()

        run()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        out[name] = _profile(run, wall_ms, f'{what}: evaluate ({name})', 4)
    for a, b in zip(hists['pipelined'], hists['serial']):
        assert np.array_equal(a, b)
    log(f'{what}: evaluate over {len(ds)} images, wall ms and idle share, '
        'pipelined / serial / pipelined: ' + json.dumps(
            {k: [round(v['wall_ms'], 2), round(v['idle_share'], 3)]
             for k, v in out.items()}))
    return out


# ------------------------------------------------------------ phase 9

def check_heads_attention(gen):
    """The head-split kernels (#1/#2) at each of HEADS_CASES: forward and
    backward against their plain versions (which round where the kernels
    do, so the plain version is the rounded reference), bit-identical
    reruns, the 12x64 case against the packed kernels, planted faults,
    the dispatcher's 'auto' route, and times beside SDPA's."""
    from semivl_tpu_torch.ops import attention
    from semivl_tpu_torch.ops import flash_attention as fa
    rows = {}
    for name, b, length, heads, d, valid in HEADS_CASES:
        c = heads * d
        qkv = torch.randn(b, length, 3 * c, generator=gen, device='cuda',
                          dtype=torch.bfloat16)
        g = torch.randn(b, length, c, generator=gen, device='cuda',
                        dtype=torch.bfloat16)
        out, lse = fa.flash_mha_heads(qkv, heads, valid, True)
        dqkv = fa.flash_mha_heads_bwd(qkv, out, lse, g, heads, valid)
        want = fa.heads_attention_plain(qkv, heads, valid)
        want_g = fa.flash_mha_bwd_plain(qkv, out, g, heads, valid)
        again = fa.flash_mha_heads(qkv, heads, valid, True)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), name
        assert torch.isfinite(dqkv.float()).all(), name
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert torch.equal(dqkv, fa.flash_mha_heads_bwd(qkv, out, lse, g,
                                                        heads, valid))
        err = (out.float() - want.float()).abs().max().item()
        rel = _rel_l2(out, want)
        scale_g = want_g.float().abs().max().item()
        err_g = (dqkv.float() - want_g.float()).abs().max().item()
        rel_g = _rel_l2(dqkv, want_g)
        ms = cuda_ms(lambda: fa.flash_mha_heads(qkv, heads, valid))
        dev_ms = device_ms(lambda: fa.flash_mha_heads(qkv, heads, valid))
        plain_ms = cuda_ms(lambda: fa.heads_attention_plain(qkv, heads,
                                                            valid), 5)
        bwd_ms = cuda_ms(lambda: fa.flash_mha_heads_bwd(qkv, out, lse, g,
                                                        heads, valid))
        bwd_dev_ms = device_ms(lambda: fa.flash_mha_heads_bwd(
            qkv, out, lse, g, heads, valid))
        bwd_plain_ms = cuda_ms(lambda: fa.flash_mha_bwd_plain(
            qkv, out, g, heads, valid), 5)
        lib_ms, lib_bwd_ms = _sdpa_ms(qkv, heads, valid), _sdpa_ms(
            qkv, heads, valid, g)
        lib_dev_ms = _sdpa_ms(qkv, heads, valid, timer=device_ms)
        lib_bwd_dev_ms = _sdpa_ms(qkv, heads, valid, g, timer=device_ms)
        keys = valid or length
        flops = 4 * b * heads * length * keys * d
        bound_ms, by = bound(flops, 4 * b * length * c * 2)
        bwd_bound_ms, bwd_by = bound(
            2 * flops, 2 * 8 * b * length * c + 4 * b * heads * length)
        extra = ''
        if d == 64 and heads % 2 == 0:
            p_out, p_lse = fa._fwd_kernel(*qkv.split(c, dim=-1), heads,
                                          keys, True)
            p_g = fa.flash_mha_bwd(qkv, p_out, p_lse, g, heads, valid)
            vs_packed = (_rel_l2(out, p_out), _rel_l2(dqkv, p_g))
            extra = (f'; vs packed kernels rel-L2 fwd {vs_packed[0]:.3e} '
                     f'bwd {vs_packed[1]:.3e} (tol {HEADS_VS_PACKED_TOL})')
            assert max(vs_packed) <= HEADS_VS_PACKED_TOL, vs_packed
        log(f'heads attention {name} ({b}, {length}, {c})/{heads}: fwd '
            f'max_abs_err {err:.3e} (tol {ATTN_TOL}) rel-L2 {rel:.3e} (tol '
            f'{ATTN_REL_TOL}) kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} '
            f'sdpa_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} ({by}) TFLOP/s '
            f'{flops / ms / 1e9:.1f}, device-only kernel_ms {fmt_ms(dev_ms)} '
            f'sdpa_ms {fmt_ms(lib_dev_ms)}; bwd '
            f'max_abs_err {err_g:.3e} of scale {scale_g:.3f} rel-L2 '
            f'{rel_g:.3e} (tol {ATTN_BWD_REL_TOL}) kernel_ms {bwd_ms:.4f} '
            f'plain_ms {bwd_plain_ms:.4f} sdpa_bwd_ms {lib_bwd_ms:.4f} '
            f'bound_ms {bwd_bound_ms:.4f} ({bwd_by}), device-only kernel_ms '
            f'{fmt_ms(bwd_dev_ms)} sdpa_bwd_ms '
            f'{fmt_ms(lib_bwd_dev_ms)}{extra}')
        assert err <= ATTN_TOL and rel <= ATTN_REL_TOL, (name, err, rel)
        if length < 64:
            # the tiny shapes: the kernel rounds p and the output where its
            # plain version does, but exp2, 1/l and another order of float32
            # sums can move a p across a bf16 rounding boundary, which moves
            # an output by one bf16 ulp at most (H100: the tiny ViT's output
            # is its plain version's bit for bit, the tiny semantic shape's
            # one ulp off in a few elements)
            diff = (out.float() - want.float()).abs()
            ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
            n_diff = int((diff > 0).sum())
            log(f'heads attention {name}: {n_diff} of {out.numel()} outputs '
                f'differ from the plain version, by {err:.3e} at most')
            assert (diff <= ulp).all(), (name, n_diff)
            if name == 'tiny ViT 4x16':
                assert torch.equal(out, want), (name, n_diff)
        assert err_g <= ATTN_BWD_TOL * scale_g, (name, err_g, scale_g)
        assert rel_g <= ATTN_BWD_REL_TOL, (name, rel_g)
        rows[name] = (
            dict(max_abs_err=err, rel_err=rel, tol=ATTN_REL_TOL, ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                 bound_by=by, device_ms=dev_ms, library_device_ms=lib_dev_ms),
            dict(max_abs_err=err_g, rel_err=rel_g, tol=ATTN_BWD_REL_TOL,
                 ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
                 bound_ms=bwd_bound_ms, bound_by=bwd_by, device_ms=bwd_dev_ms,
                 library_device_ms=lib_bwd_dev_ms))
        if name.startswith('encoder'):
            # planted faults: the last key tile skipped; the row statistics
            # off by 1 % (a wrong normalisation of p in the backward)
            bad = _rel_l2(fa.flash_mha_heads(qkv, heads,
                                             length - fa._BK)[0], want)
            bad_g = _rel_l2(fa.flash_mha_heads_bwd(
                qkv, out, lse + 0.01, g, heads, valid), want_g)
            log(f'heads attention planted faults: last key tile skipped '
                f'rel-L2 {bad:.3e}, log-sum-exp + 0.01 in the backward '
                f'rel-L2 {bad_g:.3e}')
            assert bad > ATTN_REL_TOL and bad_g > ATTN_BWD_REL_TOL
            faults = dict(skipped_key_tile=bad, lse_off=bad_g)
    for r in rows.values():
        r[0]['planted_faults'] = faults
    # the dispatcher on the card, JAX's table: 'auto' sends heads other
    # than an even count of 64 to the head-split kernel from 1536 tokens on
    # and keeps shorter ones plain
    for length, heads, d, moved in ((2602, 11, 64, 1), (1025, 24, 32, 0),
                                    (1536, 16, 48, 1)):
        qkv = torch.randn(1, length, 3 * heads * d, generator=gen,
                          device='cuda', dtype=torch.bfloat16)
        before = fa.heads_launches
        with torch.no_grad():
            out = attention.qkv_attention(qkv, heads, 'auto')
        assert fa.heads_launches - before == moved, (length, heads, d)
        assert attention.route(length, length, heads * d, heads, 'auto',
                               True) == ('heads' if moved else 'plain')
        assert torch.isfinite(out.float()).all()
    # widths that are not a multiple of 16 under 'auto': zero-padded to the
    # next one, forward and backward through the kernels, within the
    # limits of the kernels' own widths
    for length, heads, d in PADDED_HEADS_CASES:
        c = heads * d
        qkv = torch.randn(1, length, 3 * c, generator=gen, device='cuda',
                          dtype=torch.bfloat16)
        g = torch.randn(1, length, c, generator=gen, device='cuda',
                        dtype=torch.bfloat16)
        x = qkv.clone().requires_grad_(True)
        before = (fa.heads_launches, fa.heads_bwd_launches)
        out = attention.qkv_attention(x, heads, 'auto')
        (got_g,) = torch.autograd.grad(out, x, g)
        moved = (fa.heads_launches - before[0],
                 fa.heads_bwd_launches - before[1])
        want = fa.heads_attention_plain(qkv, heads)
        want_g = fa.flash_mha_bwd_plain(qkv, out.detach(), g, heads)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        rel, rel_g = _rel_l2(out, want), _rel_l2(got_g, want_g)
        scale_g = want_g.float().abs().max().item()
        err_g = (got_g.float() - want_g.float()).abs().max().item()
        log(f'heads attention, {heads} heads of {d} (padded to '
            f'{fa.padded_head_dim(d)}) at L = {length} under \'auto\': '
            f'launches {moved}; fwd max_abs_err {err:.3e} (tol {ATTN_TOL}) '
            f'rel-L2 {rel:.3e} (tol {ATTN_REL_TOL}); bwd max_abs_err '
            f'{err_g:.3e} of scale {scale_g:.3f} rel-L2 {rel_g:.3e} (tol '
            f'{ATTN_BWD_REL_TOL})')
        assert moved == (1, 1), moved
        assert torch.isfinite(out.float()).all() and torch.isfinite(
            got_g.float()).all()
        assert err <= ATTN_TOL and rel <= ATTN_REL_TOL, (d, err, rel)
        assert err_g <= ATTN_BWD_TOL * scale_g and rel_g <= ATTN_BWD_REL_TOL
    # widths above 128 (the CUDA-core kernels) under 'auto' and 'pallas':
    # the head-split kernels, forward and backward, within the limits of
    # the kernels' own widths
    for d in (136, 256):
        c = 2 * d
        qkv = torch.randn(1, 1536, 3 * c, generator=gen, device='cuda',
                          dtype=torch.bfloat16)
        g = torch.randn(1, 1536, c, generator=gen, device='cuda',
                        dtype=torch.bfloat16)
        want = fa.heads_attention_plain(qkv, 2)
        for impl in ('auto', 'pallas'):
            x = qkv.clone().requires_grad_(True)
            before = (fa.heads_launches, fa.heads_bwd_launches)
            out = attention.qkv_attention(x, 2, impl)
            (got_g,) = torch.autograd.grad(out, x, g)
            moved = (fa.heads_launches - before[0],
                     fa.heads_bwd_launches - before[1])
            want_g = fa.flash_mha_bwd_plain(qkv, out.detach(), g, 2)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            rel, rel_g = _rel_l2(out, want), _rel_l2(got_g, want_g)
            scale_g = want_g.float().abs().max().item()
            err_g = (got_g.float() - want_g.float()).abs().max().item()
            log(f'heads attention, 2 heads of {d} at L = 1536 under '
                f'\'{impl}\': launches {moved}; fwd max_abs_err {err:.3e} '
                f'rel-L2 {rel:.3e}; bwd max_abs_err {err_g:.3e} of scale '
                f'{scale_g:.3f} rel-L2 {rel_g:.3e}')
            assert moved == (1, 1), (d, impl, moved)
            assert err <= ATTN_TOL and rel <= ATTN_REL_TOL, (d, err, rel)
            assert err_g <= ATTN_BWD_TOL * scale_g and \
                rel_g <= ATTN_BWD_REL_TOL, (d, err_g, rel_g)
    log('heads attention: the dispatcher\'s \'auto\' route sends 11 heads '
        'of 64 at L = 2602, 16 heads of 48 and heads of 136 and 256 at '
        'L = 1536 to the head-split kernels, 24 heads of 32 at L = 1025 to '
        'the plain math')
    return rows


# ----------------------------------------------------------- phase 10

def _up_stage_flops(p, b, h, cin, cs, cout, cu=None):
    """Flops of one Up stage on h x h input planes: the transpose conv, the
    up half of conv1 per plane, the skip half per image, conv2."""
    hw, cu = 4 * h * h, cin - cs if cu is None else cu
    return 2 * hw * (p * cin * cu + 9 * p * cu * cout + 9 * b * cs * cout
                     + 9 * p * cout * cout)


# stages at widths the fused Up stage zero-pads (fused_decoder.stage_plan):
# (name, h, Cin, Cs, Cout, Cu) at 14 x 21 planes
PADDED_UP_STAGES = (('padded Cu 80 -> 96, Cs 24 -> 32', 32, 128, 24, 32, 80),
                    ('Cu 144 in column groups 128 + 16, Cs 8 -> 16', 16, 160,
                     8, 16, 144))


def check_fused_up():
    """The fused Up stage (#11). Its main path is the bench entry point
    (``tools.fused_up_bench.run``: the flagship's two stages at 14 x 21
    planes), with the kernel's launches read around it; then each stage,
    with and without the head, against its plain version, its rounded
    reference and cuDNN's chain, with two planted faults that must fail
    (conv1 without its top-left tap; conv1's skip half left out inside the
    kernel's sequence); then the stages of ``PADDED_UP_STAGES``."""
    import torch.nn.functional as F
    from semivl_tpu_torch.ops import fused_up as fu
    from semivl_tpu_torch.tools import fused_up_bench as bench
    torch.cuda.synchronize()
    fu.launches = 0
    bench_rows = bench.run('cuda')
    torch.cuda.synchronize()
    launches = fu.launches
    for r in bench_rows:
        log(f'fused_up_bench {r["name"]}: plain {r["plain_ms"]:7.3f} ms   '
            f'fused {r["fused_ms"]:7.3f} ms   speedup {r["speedup"]:4.2f}x   '
            f'mean|err| {r["mean_err"]:.4f} (signal {r["signal"]:.3f})   '
            f'cudnn {r["cudnn_ms"]:7.3f} ms; {r["shape"]}')
    log(f'fused_up_bench: {launches} kernel launches (expected '
        f'{sum(r["fused_calls"] for r in bench_rows)})')
    assert launches == sum(r['fused_calls'] for r in bench_rows) > 0
    rows = {}
    gen = torch.Generator(device='cuda').manual_seed(11)
    stages = [(name, h, cin, cs, cout, None)
              for name, h, cin, cs, cout in bench.STAGES]
    for i, (name, h, cin, cs, cout, cu) in enumerate(
            stages + list(PADDED_UP_STAGES)):
        x, skip, p = bench.make_stage(h, cin, cs, cout, device='cuda',
                                      seed=i, cu=cu)
        b = skip.shape[0]
        head = dict(weight=0.2 * torch.randn(1, cout, 3, 3, generator=gen,
                                             device='cuda'),
                    bias=torch.randn(1, generator=gen, device='cuda'))
        padded = cu is not None
        for hd in (None, head):
            case = name + (' + head' if hd else '')
            with torch.no_grad():
                got = fu.fused_up_stage(x, skip, p, hd)
                again = fu.fused_up_stage(x, skip, p, hd)
                plain = fu.fused_up_stage_plain(x, skip, p, hd)
                rounded = fu.fused_up_stage_rounded(x, skip, p, hd)

                def lib():
                    y = bench.cudnn_stage(x, skip, p)
                    if hd is None:
                        return y
                    return F.conv2d(y, hd['weight'].to(y.dtype),
                                    hd['bias'].to(y.dtype), padding=1)

                lib_out = lib()
                torch.cuda.synchronize()
                assert torch.isfinite(got.float()).all(), case
                assert torch.equal(got, again), case
                scale = plain.float().abs().max().item()
                err = (got.float() - plain.float()).abs().max().item()
                rel = _rel_l2(got, rounded)
                lib_rel = _rel_l2(lib_out, plain)
                ms = cuda_ms(lambda: fu.fused_up_stage(x, skip, p, hd), 10)
                dev_ms = None if padded else device_ms(
                    lambda: fu.fused_up_stage(x, skip, p, hd), 5)
                plain_ms = cuda_ms(
                    lambda: fu.fused_up_stage_plain(x, skip, p, hd), 10)
                lib_ms = cuda_ms(lib, 10)
                lib_dev = None if padded else device_ms(lib, 5)
                fault = ''
                if hd is None:
                    w0 = p['conv1_weight'].clone()
                    w0[:, :, 0, 0] = 0
                    bad = _rel_l2(fu.fused_up_stage(
                        x, skip, dict(p, conv1_weight=w0)), rounded)
                    bad_seq = _rel_l2(fu._kernel(x, skip, p, None,
                                                 skip_half=False), rounded)
                    fault = (f'; planted faults (conv1 without its top-left '
                             f'tap) rel-L2 {bad:.3e}, (conv1\'s skip half '
                             f'left out in the kernel) {bad_seq:.3e}')
                    assert bad > DEC_REL_TOL, (case, bad)
                    assert bad_seq > DEC_REL_TOL, (case, bad_seq)
            flops = _up_stage_flops(x.shape[0], b, h, cin, cs, cout, cu) + (
                2 * x.shape[0] * 4 * h * h * 9 * cout if hd else 0)
            nbytes = 2 * (x.numel() + skip.numel() + got.numel())
            bound_ms, by = bound(flops, nbytes)
            log(f'fused up {case} x {tuple(x.shape)} skip '
                f'{tuple(skip.shape)} -> {tuple(got.shape)}: max_abs_err vs '
                f'plain {err:.3e} of scale {scale:.3f} (tol {DEC_TOL} x '
                f'scale), rel-L2 vs rounded {rel:.3e} (tol {DEC_REL_TOL}), '
                f'cuDNN chain vs plain rel-L2 {lib_rel:.3e}; kernel_ms '
                f'{ms:.3f} device_ms {fmt_ms(dev_ms)} plain_ms '
                f'{plain_ms:.3f} cudnn_ms {lib_ms:.3f} cudnn device_ms '
                f'{fmt_ms(lib_dev)} bound_ms {bound_ms:.4f} ({by}) GFLOP '
                f'{flops / 1e9:.1f} ({tflops(flops, dev_ms)} TFLOP/s '
                f'device-only)' + fault)
            assert err <= DEC_TOL * max(scale, 1.0), (case, err, scale)
            assert rel <= DEC_REL_TOL, (case, rel)
            rows[case] = dict(max_abs_err=err, rel_err=rel, tol=DEC_REL_TOL,
                              ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                              library_ms=lib_ms, library_device_ms=lib_dev,
                              bound_ms=bound_ms, bound_by=by)
        del x, skip, got, again, plain, rounded, lib_out
        torch.cuda.empty_cache()
    return rows, launches, bench_rows


# ----------------------------------------------------------- phase 11

def tiny_expected(cfg):
    """Kernel launches of one tiny SemiVL step, from the configs: every
    attention on the head-split kernels, forward in the teacher pass, the
    guidance encoder and both student passes, backward in both student
    passes for every layer but the last encoder block's (as
    EXPECTED_PER_STEP counts the flagship's); the decoder as the
    flagship's."""
    from semivl_tpu_torch.configs import get_model_config
    model = get_model_config(cfg['model'], cfg['crop_size'])['model']
    guide = get_model_config(cfg['clip_encoder'], cfg['crop_size'])
    per_pass = (model['backbone']['num_layers']
                + model['decode_head']['num_layers'])
    return dict(EXPECTED_PER_STEP, attention_fwd=0, attention_bwd=0,
                heads_fwd=3 * per_pass + guide['backbone']['num_layers'],
                heads_bwd=2 * (per_pass - 1))


def run_tiny():
    """The tiny VLM under ``attention_impl = 'pallas'``: evaluation of
    64-px-scale images with launch counts, one crop batch through the
    kernels and the plain versions, then one SemiVL step (1 + 1 crops)
    with every kernel call held to its reference and timed steps with
    launch counts asserted."""
    from semivl_tpu_torch.configs import get_model_config, tiny_cfg
    from semivl_tpu_torch.configs import tiny_train_cfg
    from semivl_tpu_torch.evaluation.predict import (
        Evaluator, _chunk_sizes, evaluate)
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    cfg = tiny_cfg()
    bundle = build_model(cfg, dtype=torch.bfloat16, device='cuda', seed=0)
    model = bundle.model
    evaluator = Evaluator(model, bundle.text_feats, cfg, device='cuda')
    ds = SynthImages(seed=1, sizes=((64, 85), (85, 64), (64, 64), (64, 96)))
    for i in range(len(ds)):
        s = ds.get(i)
        pred = evaluator.predict(s['img'][None], s['mask'].shape,
                                 cfg['eval_mode'])
        assert pred.shape == (1,) + s['mask'].shape, pred.shape
    n_batches = sum(len(_chunk_sizes(len(evaluator._zegclip_coords(
        *ds.get(i)['img'].shape[:2])))) for i in range(len(ds)))
    model_cfg = get_model_config(cfg['model'], cfg['crop_size'])['model']
    per_pass = (model_cfg['backbone']['num_layers']
                + model_cfg['decode_head']['num_layers'])
    torch.cuda.synchronize()
    fa.launches = fa.heads_launches = fd.launches = 0
    t0 = time.perf_counter()
    miou, iou = evaluate(evaluator, ds, cfg['eval_mode'], cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eval_launches = {'attention': fa.launches, 'heads': fa.heads_launches,
                     'decoder': fd.launches}
    log(f'tiny eval: {len(ds)} images at 64-px scale, {n_batches} crop '
        f'batches: mIoU {miou:.4f} in {dt * 1e3:.1f} ms; launches '
        f'{eval_launches} (expected heads {per_pass * n_batches}, decoder '
        f'{2 * n_batches}, packed 0)')
    assert np.isfinite(miou) and iou.shape == (21,)
    assert eval_launches == {'attention': 0, 'heads': per_pass * n_batches,
                             'decoder': 2 * n_batches}, eval_launches
    s = ds.get(0)
    img = torch.from_numpy(s['img']).cuda()
    crops = torch.stack([img[y:y + 64, x:x + 64] for y, x in
                         evaluator._zegclip_coords(*s['img'].shape[:2])])
    with torch.no_grad():
        inp = evaluator._to_model_input(crops)
        k_logits = model(inp, evaluator.text)
        with mock.patch.object(fa, 'heads_attention',
                               fa.heads_attention_plain), \
                mock.patch.object(fd, 'fused_vlg_decoder',
                                  _route_blind(fd.fused_vlg_decoder_plain)):
            p_logits = model(inp, evaluator.text)
    torch.cuda.synchronize()
    diff = (k_logits - p_logits).abs()
    scale = p_logits.abs().max().item()
    log(f'tiny eval: crop batch {tuple(crops.shape)} kernels vs plain: '
        f'max_abs_err {diff.max().item():.3e} logit scale {scale:.3f}')
    assert torch.isfinite(k_logits).all()
    assert diff.max().item() <= DEC_TOL * max(scale, 1.0)

    cfg = tiny_train_cfg()
    bundle = build_model(cfg, dtype=torch.bfloat16, device='cuda', seed=0)
    model = bundle.model
    batch = train_batch(torch.Generator(device='cuda').manual_seed(8), b=1,
                        size=64)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    per_call = PerCallCheck(faults=True)
    opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
    check_step = make_semivl_train_step(bundle, cfg, opt, TOTAL_ITERS)
    with contextlib.ExitStack() as stack:
        for patch in per_call.patches():
            stack.enter_context(patch)
        metrics = {k: float(v) for k, v in check_step(
            batch, torch.Generator(device='cuda').manual_seed(9)).items()}
    worst = per_call.finish()
    model.load_state_dict(state)
    tols = dict(PER_CALL_TOLS, decoder_bwd=TINY_DEC_BWD_TOL)
    log('tiny compare: per call, kernels vs references on the step\'s own '
        'inputs (worst rel-L2, calls, tol): ' + json.dumps(
            {k: [float(f'{e:.3e}'), n, tols[k]] for k, (e, n) in
             worst.items()}) + f'; loss terms {json.dumps(metrics)}')
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    per_call.check(tols, absent=('attention_fwd', 'attention_bwd'))
    expected = tiny_expected(cfg)
    _, launches, perf = run_train(cfg, bundle, batch, expected=expected)
    return worst, launches, eval_launches, dict(
        perf, eval_ms=dt * 1e3, eval_batches=n_batches, eval_miou=miou)


# ------------------------------------------------------------ phase 13

VOC_HW = (375, 500)   # a Pascal VOC image's usual geometry


def write_voc_dataset(root, seed=0, counts=(('labeled', 2),
                                            ('unlabeled', 4), ('val', 2),
                                            ('unlabeled_8', 8))):
    """A synthetic dataset at Pascal VOC's geometry under ``root``: 500x375
    JPEG images (``JPEGImages/``) and palette PNG label maps
    (``SegmentationClass/``, 21 classes, a 255 border), with a split list
    per kind; returns {kind: list path}. Phase 13 trains on 4 unlabeled
    images (2 steps of 2 on one card), phase 14's two ranks on 8 (2 steps
    of 2 a rank); the kinds are written in order, so the first three
    are the same with or without the last."""
    from PIL import Image
    from semivl_tpu_torch.datasets.palettes import get_palette
    rs = np.random.RandomState(seed)
    for d in ('JPEGImages', 'SegmentationClass'):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    palette = get_palette('pascal').flatten().tolist()
    paths = {}
    for kind, n in counts:
        lines = []
        for i in range(n):
            name = f'{kind}_{i}'
            img = rs.randint(0, 256, VOC_HW + (3,), np.uint8)
            Image.fromarray(img).save(
                os.path.join(root, 'JPEGImages', name + '.jpg'), quality=90)
            mask = rs.randint(0, 21, VOC_HW).astype(np.uint8)
            mask[:, :5] = 255
            m = Image.fromarray(mask)
            m.putpalette(palette)   # a palette PNG, as VOC's
            m.save(os.path.join(root, 'SegmentationClass', name + '.png'))
            lines.append(f'JPEGImages/{name}.jpg SegmentationClass/{name}.png')
        paths[kind] = os.path.join(root, f'{kind}.txt')
        with open(paths[kind], 'w') as f:
            f.write('\n'.join(lines) + '\n')
    return paths


def save_trained_weights(bundle, path):
    """Every matrix of the model's parameters (those ``scaled_bundle``
    scales) as an npz of state-dict names, the trainer's
    ``init_param_overrides``."""
    np.savez(path, **{n: p.detach().float().cpu().numpy()
                      for n, p in bundle.model.named_parameters()
                      if p.ndim >= 2})
    return path


def _ckpt(run, name='latest'):
    return torch.load(os.path.join(run, 'ckpt', name), map_location='cpu',
                      weights_only=True)


def trainer_cfg(tmp, paths, overrides, unlabeled='unlabeled', **extra):
    """Exp 40's generated split-92 config on the dataset under
    ``tmp/voc``, for one epoch from phase 6's weights, written to
    ``tmp/<name>.yaml``: (config, path). The counted runs leave the
    per-epoch debug grid out: its forwards would add launches that are not
    the step's nor the evaluation's."""
    import yaml
    from semivl_tpu_torch.configs.experiments import generate_experiment_cfgs
    cfg = generate_experiment_cfgs(40)[0]
    assert cfg['split'] == '92' and cfg['batch_size'] == 2
    cfg.update(data_root=os.path.join(tmp, 'voc'),
               labeled_id_path=paths['labeled'],
               unlabeled_id_path=paths[unlabeled],
               val_id_path=paths['val'], epochs=1, debug_images=False,
               init_param_overrides=overrides, **extra)
    name = '_'.join(['exp40', unlabeled] + sorted(extra))
    path = os.path.join(tmp, name + '.yaml')
    with open(path, 'w') as f:
        yaml.dump(cfg, f)
    return cfg, path


def eval_batches(cfg, indices):
    """The crop batches the evaluation of val images ``indices`` runs."""
    from semivl_tpu_torch.data.dataset import SemiDataset
    from semivl_tpu_torch.evaluation.predict import Evaluator, _chunk_sizes
    valset = SemiDataset(cfg, 'val', id_path=cfg['val_id_path'])
    coords = Evaluator(torch.nn.Identity(), np.zeros((21, 512)), cfg,
                       'cuda')._zegclip_coords
    return sum(len(_chunk_sizes(len(coords(*valset.get(i)['img']
                                           .shape[:2]))))
               for i in indices)


def with_eval(step_launches, steps, batches, per_call=None):
    """Launches of ``steps`` training steps and an evaluation of
    ``batches`` crop batches, each a forward (``per_call``: the flagship's
    14 attention and 2 decoder launches by default)."""
    per_call = per_call or dict(attention=14, decoder=2)
    expected = {k: steps * v for k, v in step_launches.items()}
    expected['attention_fwd'] += per_call['attention'] * batches
    expected['decoder_fwd'] += per_call['decoder'] * batches
    return expected


def run_trainer(overrides, step_launches, tmp, paths):
    """Phase 13: the trainer CLI on the card (see the module's docstring).
    Returns the launches read around the two-step run, the throughput the
    loop logged, the resumed run's distance from the uninterrupted one and
    the uninterrupted run's final state."""
    from semivl_tpu_torch import native
    from semivl_tpu_torch.data.dataset import SemiDataset
    from semivl_tpu_torch.tools import train as cli
    built = native.native_available()
    log('trainer: native decode ' + ('built' if built else 'not built (g++ '
        'with the libjpeg and libpng headers is needed); PIL decodes'))
    cfg, cfg_path = trainer_cfg(tmp, paths, overrides)
    valset = SemiDataset(cfg, 'val', id_path=paths['val'])
    batches = eval_batches(cfg, range(len(valset)))
    expected = with_eval(step_launches, 2, batches)
    cwd = os.getcwd()
    os.chdir(tmp)   # the run dirs go under exp/ there
    try:
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        best, run = cli.main(['--config', cfg_path, '--seed', '0'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counters()
        with open(os.path.join(run, 'metrics.jsonl')) as f:
            metrics = {}
            for line in f:
                metrics.update(json.loads(line))
        log(f'trainer: exp 40 (split 92) for 1 epoch of 2 steps and an '
            f'evaluation of {len(valset)} images ({batches} crop batches) in '
            f'{wall:.1f} s (the CLI call: model build, data, steps, '
            f'evaluation, checkpoints); best mIoU {best:.4f}; the loop\'s '
            f'window: imgs_per_sec_per_chip '
            f'{metrics["train/imgs_per_sec_per_chip"]:.3f}, iter_time '
            f'{metrics["train/iter_time"]:.3f} s, loss_all '
            f'{metrics["train/loss_all"]:.4f}; eval fps '
            f'{metrics["eval/fps"]:.3f}')
        log(f'trainer: launches {launches} (expected {expected}: 2 x phase '
            f'6\'s per step + {batches} evaluation batches)')
        assert launches == expected, (launches, expected)
        for name in ('all_args.yaml', 'config.yaml', 'metrics.jsonl',
                     'ckpt/latest', 'ckpt/best'):
            assert os.path.isfile(os.path.join(run, name)), name
        assert all(np.isfinite(v) for k, v in metrics.items()
                   if k.startswith('train/loss')), metrics
        state = _ckpt(run)
        assert state['iteration'] == 2
        assert all(torch.isfinite(v).all() for v in state['model'].values())

        _, cut = trainer_cfg(tmp, paths, overrides, preempt_at_step=0)
        _, run_b = cli.main(['--config', cut, '--seed', '0'])
        with open(os.path.join(run_b, 'ckpt', 'latest.extra.json')) as f:
            extra = json.load(f)
        assert _ckpt(run_b)['iteration'] == 1 and extra['epoch_step'] == 1
        cli.main(['--config', cfg_path, '--seed', '0', '--resume-from',
                  run_b])
        resumed = _ckpt(run_b)
        assert resumed['iteration'] == 2
        dist = max(((resumed['model'][k].float() - v.float()).norm()
                    / v.float().norm().clamp(min=1e-30)).item()
                   for k, v in state['model'].items())
        equal = all(torch.equal(resumed['model'][k], v)
                    for k, v in state['model'].items())
        log(f'trainer: preempted after step 0 and resumed to step 2: '
            f'parameters {"bit-equal" if equal else "not bit-equal"} to the '
            f'uninterrupted run, worst leaf rel-L2 {dist:.3e}')
    finally:
        os.chdir(cwd)
    return launches, dict(wall_s=wall, native_decode=built,
                          imgs_per_sec_per_chip=metrics[
                              'train/imgs_per_sec_per_chip'],
                          resumed_rel_l2=dist, resumed_bit_equal=equal), \
        state['model']


# ------------------------------------------------------------ phase 14

RANK_TIMEOUT_S = 480   # a launch of ranks, model builds and nvcc-free


class Ranks:
    """``world`` processes of this script in its rank-worker mode, started
    with torchrun's environment (``parallel.dist.RankProcesses``);
    ``join()`` gives each rank's result as it saved it. A rank that exits
    non-zero or outlives ``RANK_TIMEOUT_S`` fails the phase; ``join``
    kills every rank on its way out, ``kill_all`` any still running when
    the phase fails."""

    running = []

    def __init__(self, task, spec, world, tmp, what):
        from semivl_tpu_torch.parallel import dist
        self.what, self.world = what, world
        self.out = tempfile.mkdtemp(prefix=f'{task}_', dir=tmp)
        spec_path = os.path.join(self.out, 'spec.json')
        with open(spec_path, 'w') as f:
            json.dump(spec, f)
        self.t0 = time.perf_counter()
        self.ranks = dist.RankProcesses(
            [sys.executable, os.path.abspath(__file__), '--rank-worker',
             task, spec_path, self.out], world, stdout=sys.stderr)
        Ranks.running.append(self.ranks)

    @classmethod
    def kill_all(cls):
        for ranks in cls.running:
            ranks.kill()

    def join(self):
        rcs = self.ranks.wait(max(1.0, RANK_TIMEOUT_S - (
            time.perf_counter() - self.t0)))
        assert rcs == [0] * self.world, f'{self.what}: ranks exited {rcs}'
        log(f'ranks: {self.what}: {self.world} rank(s) in '
            f'{time.perf_counter() - self.t0:.1f} s')
        return [torch.load(os.path.join(self.out, f'rank{r}.pt'),
                           weights_only=False) for r in range(self.world)]


def _rank_state(model):
    """A rank's trainable parameters and buffers, on the host."""
    return {**{n: p.detach().cpu() for n, p in model.named_parameters()
               if p.requires_grad},
            **{n: b.detach().cpu() for n, b in model.named_buffers()}}


def _worker_trainer(spec):
    """The trainer CLI as this rank (``spec['argv'][rank]``), its step and
    the evaluation's global histograms recorded. With ``spec['gloo']`` the
    rank first makes a gloo group on card 0 (ranks sharing one card, which
    NCCL refuses), which the trainer joins; else the trainer makes its
    NCCL group on ``cuda:LOCAL_RANK``."""
    from semivl_tpu_torch.evaluation import predict
    from semivl_tpu_torch.evaluation.metrics import miou_from_histograms
    from semivl_tpu_torch.parallel import dist
    from semivl_tpu_torch.tools import train as cli
    from semivl_tpu_torch.train import loop
    rank = int(os.environ['RANK'])
    steps, hists, worlds = [], [], []
    make = loop.make_semivl_train_step

    def make_step(*a, **k):
        steps.append(make(*a, **k))
        worlds.append((dist.world_size(), dist.dist.get_backend()))
        return steps[-1]

    def recording_evaluate(*a, **k):
        inter, union = predict.evaluate_histograms(*a, **k)
        hists.append((inter, union))
        return miou_from_histograms(inter, union)

    os.chdir(spec['cwd'])
    if spec.get('gloo'):
        dist.setup_distributed(device='cuda:0', backend='gloo')
    with mock.patch.object(loop, 'make_semivl_train_step', make_step), \
            mock.patch.object(loop, 'evaluate', recording_evaluate):
        _, run = cli.main(spec['argv'][rank])
    return dict(run=run, iteration=steps[0].iteration, world=worlds[0],
                hists=hists, state=_rank_state(steps[0].model))


def _same_as_rank_0(tensors):
    """True on every rank whose ``tensors`` are bit-equal to rank 0's
    (each broadcast from rank 0 and compared)."""
    from semivl_tpu_torch.parallel import dist
    same = True
    for t in tensors:
        t0 = t.detach().clone()
        dist.dist.broadcast(t0, src=0)
        same = same and torch.equal(t0, t)
    return same


def _worker_cityscapes(spec):
    """Exp 44's step as this rank (``spec['gloo']``: gloo on card 0; else
    NCCL on ``cuda:LOCAL_RANK``): one step on the rank's synthetic crops,
    its launches, the BatchNorm running statistics and whether its
    trainable parameters and buffers are bit-equal to rank 0's, then
    timed steps and, on rank 0, a profile of one."""
    from semivl_tpu_torch.configs import cityscapes_train_cfg
    from semivl_tpu_torch.parallel import dist
    from semivl_tpu_torch.train.loop import step_generator
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    if spec.get('gloo'):
        rank, world, device = dist.setup_distributed(device='cuda:0',
                                                     backend='gloo')
    else:
        rank, world, device = dist.setup_distributed()
    cfg = cityscapes_train_cfg()
    bundle = scaled_bundle(cfg)
    opt, _ = build_optimizer(cfg, bundle.model, TOTAL_ITERS)
    step = make_semivl_train_step(bundle, cfg, opt, TOTAL_ITERS)
    batch = cityscapes_rank_batch(rank)
    gen = step_generator(0, 0, device, rank)
    _reset_counters()
    metrics = step(batch, gen)
    torch.cuda.synchronize()
    launches = _counters()
    stats = {n: b.detach().cpu() for n, b in bundle.model.named_buffers()}
    same = _same_as_rank_0([p for p in bundle.model.parameters()
                            if p.requires_grad]
                           + list(bundle.model.buffers()))
    metrics = {k: float(v) for k, v in metrics.items()}

    def run():
        step(batch, gen)
        torch.cuda.synchronize()

    run()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    # the step's gradient mean alone, on this step's gradients
    grads = [p.grad for g in opt.param_groups for p in g['params']
             if p.grad is not None]
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.mean_over_ranks_([g.clone() for g in grads])
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t0) * 1e3 / 3
    grad_mib = sum(g.numel() * g.element_size() for g in grads) / 2**20
    torch.cuda.reset_peak_memory_stats()
    # two profiled windows on rank 0 (``windows=2`` always runs two), two
    # plain steps on rank 1: the ranks' collectives pair up
    if rank == 0:
        prof = _profile(run, wall_ms, f'exp 44 step, rank 0 of {world} '
                        f'({dist.dist.get_backend()})', 10, windows=2)
    else:
        run()
        run()
        prof = None
    peak = torch.cuda.max_memory_allocated()
    dist.barrier()
    dist.shutdown()
    return dict(launches=launches, stats=stats, same_as_rank_0=same,
                metrics=metrics, ms_per_step=wall_ms, profile=prof, peak_mib=peak / 2**20,
                grad_mean_ms=reduce_ms, grad_mib=grad_mib)


def rank_worker(task, spec_path, out_dir):
    """One rank of phase 14 (``--rank-worker``), its result saved to
    ``out_dir/rank<RANK>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    _reset_counters()
    result = dict(trainer=_worker_trainer,
                  cityscapes_step=_worker_cityscapes)[task](spec)
    if task == 'trainer':
        result['launches'] = _counters()
    torch.save(result, os.path.join(out_dir,
                                    f'rank{os.environ["RANK"]}.pt'))
    return 0


def cityscapes_rank_batch(rank):
    """Rank ``rank``'s exp-44 batch (1 + 1 801^2 crops), seeded by rank."""
    return train_batch(torch.Generator(device='cuda').manual_seed(20 + rank),
                       b=1, size=801, nclass=19)


def _states_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _worst_rel(a, b):
    return max(((a[k].double() - b[k].double()).abs().max()
                / b[k].double().abs().max().clamp(min=1e-30)).item()
               for k in b)


def averaged_step(cfg, total_iters):
    """One process's counterpart of the two-rank step 0: each rank's batch
    and generator through the step's backward on the kernels, the two
    gradients averaged as the ranks' all-reduce does ((g0 + g1) / 2), and
    the same AdamW update; returns the trainable parameters and buffers."""
    from semivl_tpu_torch.data.dataset import SemiDataset
    from semivl_tpu_torch.data.loader import ShardedLoader
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.train import loop
    from semivl_tpu_torch.train.step import make_semivl_train_step
    device = torch.device('cuda')
    bundle = build_model(cfg, dtype=loop.model_dtype(cfg, device),
                         device=device, seed=0)
    optimizer, _ = loop.init_state(bundle, cfg, total_iters)
    step = make_semivl_train_step(bundle, cfg, optimizer, total_iters)
    trainset_u = SemiDataset(cfg, 'train_u', id_path=cfg['unlabeled_id_path'],
                             seed=0)
    trainset_l = SemiDataset(cfg, 'train_l', id_path=cfg['labeled_id_path'],
                             nsample=len(trainset_u.ids), seed=1)
    bs = cfg['batch_size']
    params = [p for g in optimizer.param_groups for p in g['params']]
    grads = []
    for r in (0, 1):
        bl = next(ShardedLoader(trainset_l, bs, 2, seed=0, process_index=r,
                                process_count=2).epoch(0))
        bu = next(ShardedLoader(trainset_u, bs, 2, seed=0, pair=True,
                                process_index=r,
                                process_count=2).epoch(0))
        batch = {k: torch.from_numpy(np.require(v, requirements=('C', 'W')))
                 .to(device) for k, v in loop.step_batch(bl, bu).items()}
        metrics = step.backward(batch, loop.step_generator(0, 0, device, r))
        grads.append([None if p.grad is None else p.grad.clone()
                      for p in params])
    for p, g0, g1 in zip(params, *grads):
        p.grad = None if g0 is None else (g0 + g1) / 2
    step.update(metrics)
    return _rank_state(bundle.model)


def one_rank_histograms(cfg, run):
    """One process's evaluation histograms over the whole val set of the
    weights in ``run``'s ``latest`` checkpoint."""
    from semivl_tpu_torch.data.dataset import SemiDataset
    from semivl_tpu_torch.evaluation.predict import (Evaluator,
                                                     evaluate_histograms)
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.train.loop import model_dtype
    device = torch.device('cuda')
    bundle = build_model(cfg, dtype=model_dtype(cfg, device), device=device,
                         seed=0)
    bundle.model.load_state_dict(_ckpt(run)['model'])
    ev = Evaluator(bundle.model, bundle.text_feats, cfg, device)
    return evaluate_histograms(ev, SemiDataset(cfg, 'val',
                                               id_path=cfg['val_id_path']),
                               cfg['eval_mode'], cfg)


def check_cityscapes_stats(ranks):
    """The ranks' BatchNorm running statistics after exp 44's step
    against one process's train-mode BatchNorm over every rank's images
    batched together (pass 1 [x | w], then pass 2 [s1 | s2] with CutMix,
    as the step's student passes), and against rank 0's images alone
    (what a rank without cross-rank statistics would hold)."""
    from semivl_tpu_torch.configs import cityscapes_train_cfg
    from semivl_tpu_torch.train.step import (cutmix_box_from_coords,
                                             cutmix_image)
    enc = scaled_bundle(cityscapes_train_cfg()).model.conv_encoder
    init = {n: b.clone() for n, b in enc.named_buffers()}

    def passes(batches):
        enc.load_state_dict({**enc.state_dict(), **init})
        with torch.no_grad():
            enc(torch.cat([torch.cat([b['img_x'], b['img_w']])
                           for b in batches]), train=True)
            mixed = []
            for b in batches:
                for v, box in (('s1', 'cutmix_box1'), ('s2', 'cutmix_box2')):
                    mask = cutmix_box_from_coords(b[box], 801)
                    mixed.append(cutmix_image(b[f'img_{v}'],
                                              b[f'img_{v}_other'], mask))
            enc(torch.cat(mixed), train=True)
        return {f'conv_encoder.{n}': b.cpu()
                for n, b in enc.named_buffers()}

    batches = [cityscapes_rank_batch(r) for r in range(len(ranks))]
    together, alone = passes(batches), passes(batches[:1])
    assert all(_states_equal(ranks[0]['stats'], r['stats']) for r in ranks)
    got = {k: ranks[0]['stats'][k] for k in together}
    assert len(got) == 26
    return _worst_rel(got, together), _worst_rel(alone, together)


MULTI_RANK_STATS_TOL = 1e-3   # of each statistic's scale: bf16 convs of
# batch 2 (a rank) against batch 4 (together) may round differently


def run_multi_rank(*args):
    """Phase 14 (see the module's docstring): returns each run's launches
    by path and the readings. No rank outlives it."""
    try:
        return _run_multi_rank(*args)
    finally:
        Ranks.kill_all()


def _run_multi_rank(overrides, step_launches, trainer_launches,
                    trainer_state, tmp, paths):
    from semivl_tpu_torch.data.dataset import SemiDataset
    t_phase = time.perf_counter()
    readings = {}
    # (a) the trainer CLI at WORLD_SIZE=1, a real NCCL group of one, beside
    # (b)'s straight run: two gloo ranks on card 0, 8 unlabeled images
    _, path1 = trainer_cfg(tmp, paths, overrides)
    cfg2, path2 = trainer_cfg(tmp, paths, overrides, 'unlabeled_8')
    _, cut2 = trainer_cfg(tmp, paths, overrides, 'unlabeled_8',
                          preempt_at_step=0)
    gloo = ['--seed', '0', '--device', 'cuda:0']
    world1 = Ranks('trainer', dict(cwd=tmp, argv=[[
        '--config', path1, '--seed', '0']]), 1, tmp, '(a) NCCL, world 1')
    straight = Ranks('trainer', dict(cwd=tmp, gloo=True, argv=[
        ['--config', path2] + gloo] * 2), 2, tmp, '(b) gloo, straight')
    [one], straight = world1.join(), straight.join()
    straight_s = time.perf_counter() - t_phase
    assert one['world'] == (1, 'nccl'), one['world']
    final = _ckpt(os.path.join(tmp, one['run']))['model']
    assert one['launches'] == trainer_launches, (one['launches'],
                                                 trainer_launches)
    assert _states_equal(final, trainer_state), 'world 1 != phase 13'
    log('ranks: (a) NCCL world 1: parameters torch.equal to phase 13\'s '
        f'uninterrupted run; launches {one["launches"]} == phase 13\'s')

    # (b): rank 0 alone preempted after step 0, then resumed; meanwhile
    # this process takes step 0 as one process and evaluates the straight
    # run's weights
    cut = Ranks('trainer', dict(cwd=tmp, gloo=True, argv=[
        ['--config', cut2] + gloo, ['--config', path2] + gloo]), 2, tmp,
        '(b) gloo, rank 0 preempted after step 0').join()
    resumed = Ranks('trainer', dict(cwd=tmp, gloo=True, argv=[
        ['--config', path2, '--resume-from', cut[0]['run']] + gloo] * 2), 2,
        tmp, '(b) gloo, resumed')
    ref = averaged_step(cfg2, 2)
    alone = one_rank_histograms(cfg2, os.path.join(tmp, straight[0]['run']))
    resumed = resumed.join()
    for name, runs in (('straight', straight), ('preempted', cut),
                       ('resumed', resumed)):
        assert runs[0]['world'] == runs[1]['world'] == (2, 'gloo')
        assert runs[0]['run'] == runs[1]['run']
        assert _states_equal(runs[0]['state'], runs[1]['state']), name
    assert [r['iteration'] for r in straight] == [2, 2]
    assert [r['iteration'] for r in cut] == [1, 1], 'ranks stopped apart'
    assert [r['iteration'] for r in resumed] == [2, 2]
    assert _states_equal(resumed[0]['state'], straight[0]['state']), \
        'resumed != uninterrupted'
    n_val = len(SemiDataset(cfg2, 'val', id_path=paths['val']))
    for r, run in enumerate(straight):
        want = with_eval(step_launches, 2,
                         eval_batches(cfg2, range(r, n_val, 2)))
        assert run['launches'] == want, (r, run['launches'], want)
    # the two-rank step 0 against one process averaging the halves
    step0 = cut[0]['state']
    step0_equal = _states_equal(step0, ref)
    step0_rel = _worst_rel(step0, ref)
    log(f'ranks: (b) step 0 of two ranks against one process averaging '
        f'the two halves\' gradients: bit-equal {step0_equal}, worst leaf '
        f'{step0_rel:.3e}')
    assert step0_equal, step0_rel
    # the evaluation's global histograms against one rank's, same weights
    hist = straight[0]['hists'][-1]
    assert all(np.array_equal(a, b) for a, b in zip(
        hist, straight[1]['hists'][-1]))
    assert all(np.array_equal(a, b) for a, b in zip(hist, alone)), \
        (hist, alone)
    torch.cuda.empty_cache()
    log(f'ranks: (b) two gloo ranks on one card: ranks torch.equal after '
        f'each run; preempted on rank 0 alone, both stopped after step 0; '
        f'resumed torch.equal to the straight run; histograms equal to one '
        f'rank\'s ({int(hist[1].sum())} union pixels); straight run '
        f'{straight_s:.1f} s')
    readings['two_rank_voc'] = dict(
        step0_bit_equal=step0_equal, step0_worst_rel=step0_rel,
        straight_run_s=straight_s)

    # (c) exp 44's step on two gloo ranks: cross-rank BatchNorm
    cs = Ranks('cityscapes_step', dict(gloo=True), 2, tmp,
               '(c) exp 44 step, two gloo ranks').join()
    for r, run in enumerate(cs):
        assert run['launches'] == EXPECTED_CITYSCAPES, (r, run['launches'])
        assert run['same_as_rank_0'], r
        assert all(np.isfinite(v) for v in run['metrics'].values())
    stats_rel, alone_rel = check_cityscapes_stats(cs)
    log(f'ranks: (c) BatchNorm running statistics equal on both ranks; '
        f'against one process over both ranks\' images {stats_rel:.3e} '
        f'(limit {MULTI_RANK_STATS_TOL}), rank 0\'s images alone '
        f'{alone_rel:.3e}; per rank {cs[0]["ms_per_step"]:.1f} and '
        f'{cs[1]["ms_per_step"]:.1f} ms/step, of which the gradient mean '
        f'({cs[0]["grad_mib"]:.1f} MiB, gloo through the host) '
        f'{cs[0]["grad_mean_ms"]:.1f} ms alone; peak '
        f'{cs[0]["peak_mib"]:.0f} MiB (two ranks share the card: the code '
        'path, not multi-card scaling)')
    assert stats_rel < MULTI_RANK_STATS_TOL < alone_rel / 10
    prof = cs[0]['profile']
    readings['two_rank_cityscapes'] = dict(
        stats_rel=stats_rel, alone_rel=alone_rel,
        ms_per_step=[r['ms_per_step'] for r in cs],
        grad_mean_ms=[r['grad_mean_ms'] for r in cs],
        grad_mib=cs[0]['grad_mib'],
        rank0_busy_ms=prof['busy_ms'], rank0_idle_share=prof['idle_share'],
        rank0_whole_window=prof['whole_window'], peak_mib=cs[0]['peak_mib'])
    readings['phase_s'] = time.perf_counter() - t_phase
    log(f'ranks: phase 14 in {readings["phase_s"]:.1f} s')
    return dict(nccl_world1=one['launches'],
                gloo_two_ranks_voc=[r['launches'] for r in straight],
                gloo_two_ranks_cityscapes=[r['launches'] for r in cs]), \
        readings


def run_across_cards(world):
    """``--cards N``: phase 14's full-width paths on N cards, one NCCL rank
    a card (see the module's docstring). Returns the readings."""
    from semivl_tpu_torch.ops import _build
    assert torch.cuda.device_count() >= world >= 2, torch.cuda.device_count()
    log(f'build: kernels built in {_build.build_all():.1f} s')
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        n_u, n_val = 4 * world, world + 1
        paths = write_voc_dataset(os.path.join(tmp, 'voc'), counts=(
            ('labeled', 2), (f'unlabeled_{n_u}', n_u), ('val', n_val)))
        # exp 40's CLI: 2 steps of 2 + 2 crops a rank, seeded weights
        cfg, path = trainer_cfg(tmp, paths, None, f'unlabeled_{n_u}')
        runs = Ranks('trainer', dict(cwd=tmp, argv=[
            ['--config', path, '--seed', '0']] * world), world, tmp,
            f'exp 40 trainer, {world} NCCL ranks').join()
        for r, run in enumerate(runs):
            assert run['world'] == (world, 'nccl'), run['world']
            assert run['run'] == runs[0]['run'] and run['iteration'] == 2
            assert _states_equal(run['state'], runs[0]['state']), r
            want = with_eval(EXPECTED_PER_STEP, 2,
                             eval_batches(cfg, range(r, n_val, world)))
            assert run['launches'] == want, (r, run['launches'], want)
            assert all(np.array_equal(a, b) for a, b in zip(
                run['hists'][-1], runs[0]['hists'][-1])), r
        alone = one_rank_histograms(cfg, os.path.join(tmp, runs[0]['run']))
        hist = runs[0]['hists'][-1]
        assert all(np.array_equal(a, b) for a, b in zip(hist, alone)), \
            (hist, alone)
        log(f'cards: exp 40 CLI on {world} NCCL ranks: parameters and '
            f'buffers torch.equal on every rank, launches 2 x the step\'s '
            f'plus each rank\'s share of {n_val} val images, histograms '
            f'equal to one process\'s ({int(hist[1].sum())} union pixels)')
        torch.cuda.empty_cache()

        cs = Ranks('cityscapes_step', {}, world, tmp,
                   f'exp 44 step, {world} NCCL ranks').join()
        for r, run in enumerate(cs):
            assert run['launches'] == EXPECTED_CITYSCAPES, (r,
                                                            run['launches'])
            assert run['same_as_rank_0'], r
            assert all(np.isfinite(v) for v in run['metrics'].values())
        stats_rel, alone_rel = check_cityscapes_stats(cs)
        prof = cs[0]['profile']
        log(f'cards: exp 44 step on {world} NCCL ranks: parameters and '
            f'BatchNorm statistics bit-equal on every rank; statistics '
            f'against one process over every rank\'s images {stats_rel:.3e} '
            f'(limit {MULTI_RANK_STATS_TOL}), rank 0\'s images alone '
            f'{alone_rel:.3e}; ms/step by rank '
            f'{[round(r["ms_per_step"], 2) for r in cs]}, the gradient mean '
            f'({cs[0]["grad_mib"]:.1f} MiB, NCCL) '
            f'{[round(r["grad_mean_ms"], 3) for r in cs]} ms alone')
        assert stats_rel < MULTI_RANK_STATS_TOL < alone_rel / 10
        readings['cityscapes'] = dict(
            stats_rel=stats_rel, alone_rel=alone_rel,
            ms_per_step=[r['ms_per_step'] for r in cs],
            grad_mean_ms=[r['grad_mean_ms'] for r in cs],
            grad_mib=cs[0]['grad_mib'], rank0_busy_ms=prof['busy_ms'],
            rank0_idle_share=prof['idle_share'],
            rank0_whole_window=prof['whole_window'],
            peak_mib=[r['peak_mib'] for r in cs])
    return readings


# ------------------------------------------------------------ phase 15

def vit_blocks(vit):
    """The block count of a ViT config (the VPT ViT's key is ``layers``)."""
    return vit.get('layers' if vit['type'] == 'VPTCLIPVisionTransformer'
                   else 'num_layers', 12)


def launches_per_call(cfg):
    """The kernel launches of one model call under the run config's model
    (a launch serves the whole batch): the packed attention forward once
    per ViT block and SemanticTransformer layer, the decoder forward twice
    (a VLG head's two Up stages, over all B x N planes: N classes or
    concepts; a DeepLabV3+ or ATM head has none, the ATM head's
    cross-attention being plain products). The UniMatch DeepLabV3+
    (``model = 'deeplabv3plus'``) launches none: convolutions and
    BatchNorm, as JAX computes it outside any Pallas kernel."""
    from semivl_tpu_torch.configs.models import get_model_config
    if cfg['model'] == 'deeplabv3plus':
        return dict(attention=0, decoder=0)
    model = get_model_config(cfg['model'], img_size=cfg['crop_size'])['model']
    head = model['decode_head']
    vlg = head['type'] == 'VLGHead'
    return dict(attention=vit_blocks(model['backbone'])
                + (head.get('num_layers', 2) if vlg else 0),
                decoder=2 if vlg else 0)


def launches_per_step(cfg):
    """A step's launches derived from the run config. SemiVL and UniMatch:
    the forward of the teacher pass and both student passes
    (``launches_per_call``), the guidance encoder's blocks when the
    consistency loss is on; the attention backward once per layer the loss
    reaches in each student pass (a MaskCLIP ViT's last block feeds its
    attention output only to the cls embedding, which no head reads; the
    timm ViT's last block feeds the final maps; the VPT ViT's trained
    prompts enter every block); the decoder backward twice per student
    pass, on the config's route (whole plane: tail and input; banded:
    passes A, B, C). The supervised baseline: one train pass, forward and
    backward. The UniMatch DeepLabV3+: none."""
    from semivl_tpu_torch.configs.models import get_model_config
    out = dict.fromkeys(EXPECTED_PER_STEP, 0)
    if cfg['model'] == 'deeplabv3plus':
        return out
    model = get_model_config(cfg['model'], img_size=cfg['crop_size'])['model']
    vit, head = model['backbone'], model['decode_head']
    fwd = launches_per_call(cfg)
    sem = fwd['attention'] - vit_blocks(vit)
    semi = cfg.get('method', 'semivl') != 'supervised'
    fwd_passes, bwd_passes = (3, 2) if semi else (1, 1)
    clip = 0
    if semi and cfg.get('clip_encoder') and cfg.get(
            'maskclip_consistency_lambda'):
        clip = get_model_config(cfg['clip_encoder'])['backbone'].get(
            'num_layers', 12)
    unread = vit['type'] == 'MaskClipVisionTransformer'
    out.update(attention_fwd=fwd_passes * fwd['attention'] + clip,
               attention_bwd=bwd_passes * (vit_blocks(vit) - unread + sem),
               decoder_fwd=fwd_passes * fwd['decoder'])
    if fwd['decoder']:
        route = cfg.get('decoder_bwd', head.get('decoder_bwd', 'whole'))
        for k in (('decoder_bwd_tail', 'decoder_bwd_input')
                  if route == 'whole' else
                  ('banded_pass_a', 'banded_pass_b', 'banded_pass_c')):
            out[k] = 2 * bwd_passes
    return out


def run_ade_train():
    """Phase 15 (a): exp 43's step at full width (ViT-B/16 + VLG over 150
    class planes a crop, the guidance encoder with ``ade_single``, 1 + 1
    512^2 crops, the whole-plane decoder backward): timed steps with the
    launches ``launches_per_step`` derives, peak memory and a profile; then,
    from the model as built, one step with every kernel call held to its
    rounded reference on its own inputs, and each decoder-backward call
    rerun with a planted fault that must fail its limit."""
    from semivl_tpu_torch.configs import ade_train_cfg
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    cfg = ade_train_cfg()
    expected = launches_per_step(cfg)
    t0 = time.perf_counter()
    bundle = scaled_bundle(cfg)
    model = bundle.model
    assert bundle.text_feats.shape == bundle.mcc_text_feats.shape == (150,
                                                                      512)
    log(f'ade train: built the exp-43 training bundle in '
        f'{time.perf_counter() - t0:.1f} s; launches per step from the '
        f'config {expected}')
    batch = train_batch(torch.Generator(device='cuda').manual_seed(8), b=1,
                        size=512, nclass=150)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    step, launches, perf = run_train(cfg, bundle, batch, expected=expected)
    prof = profile_step(step, batch)
    del step
    model.load_state_dict(state)
    per_call = PerCallCheck(faults={
        'conv1 dgrad without its top-left tap': conv1_dgrad_without_a_tap})
    opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
    check_step = make_semivl_train_step(bundle, cfg, opt, TOTAL_ITERS)
    with contextlib.ExitStack() as stack:
        for patch in per_call.patches():
            stack.enter_context(patch)
        metrics = {k: float(v) for k, v in check_step(
            batch, torch.Generator(device='cuda').manual_seed(9)).items()}
    worst = per_call.finish()
    model.load_state_dict(state)
    tols = dict(PER_CALL_TOLS, decoder_bwd=STEP_DEC_BWD_TOL)
    log('ade compare: per call, kernels vs rounded on the step\'s own '
        'inputs (worst rel-L2, calls, tol): ' + json.dumps(
            {k: [float(f'{e:.3e}'), n, tols[k]] for k, (e, n) in
             worst.items()}) + f'; planted fault reads '
        f'{[(p, f"{bad:.3e}") for p, _, bad in per_call.fault_reads]}; '
        f'loss terms {json.dumps(metrics)}')
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert len(per_call.fault_reads) == 2   # both student passes
    per_call.check(tols, absent=('heads_fwd', 'heads_bwd'))
    return worst, launches, dict(perf, **prof)


def run_ade_eval():
    """Phase 15 (b): exp 43's evaluation of one synthetic 512x2048 image
    (``zegclip_sliding_window``: 5 crops in batches of 4 + 1, 600 and 150
    class planes), launches read around ``evaluate``; one crop batch
    through the kernels and the plain versions; a profile of the image."""
    from semivl_tpu_torch.configs import ade_cfg
    from semivl_tpu_torch.evaluation.predict import (
        Evaluator, _chunk_sizes, evaluate)
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    cfg = ade_cfg()
    bundle = scaled_bundle(cfg)
    model = bundle.model
    evaluator = Evaluator(model, bundle.text_feats, cfg, device='cuda')
    ds = SynthImages(seed=2, sizes=((512, 2048),), nclass=150)
    s = ds.get(0)
    coords = evaluator._zegclip_coords(512, 2048)
    chunks = _chunk_sizes(len(coords))
    assert len(coords) == 5 and chunks == [4, 1], (coords, chunks)
    per_call = launches_per_call(cfg)
    expected = {'attention': per_call['attention'] * len(chunks),
                'heads': 0, 'decoder': per_call['decoder'] * len(chunks)}
    evaluator.predict(s['img'][None], s['mask'].shape, cfg['eval_mode'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.heads_launches = fd.launches = 0
    t0 = time.perf_counter()
    miou, iou = evaluate(evaluator, ds, cfg['eval_mode'], cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {'attention': fa.launches, 'heads': fa.heads_launches,
                'decoder': fd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f'ade eval: 1 image 512x2048, 5 crops in batches {chunks} (planes '
        f'{[c * 150 for c in chunks]}): mIoU {miou:.4f} in {dt * 1e3:.1f} ms, '
        f'peak memory {peak / 2**20:.1f} MiB; launches {launches} (expected '
        f'{expected})')
    assert np.isfinite(miou) and iou.shape == (150,)
    assert launches == expected, (launches, expected)
    img = torch.from_numpy(s['img']).cuda()
    crops = torch.stack([img[y:y + 512, x:x + 512] for y, x in coords[:4]])
    with torch.no_grad():
        inp = evaluator._to_model_input(crops)
        k_logits = model(inp, evaluator.text)
        with mock.patch.object(fa, 'packed_attention',
                               fa.packed_attention_plain), \
                mock.patch.object(fd, 'fused_vlg_decoder',
                                  _route_blind(fd.fused_vlg_decoder_plain)):
            p_logits = model(inp, evaluator.text)
    torch.cuda.synchronize()
    assert k_logits.shape == (4, 150, 512, 512)
    assert torch.isfinite(k_logits).all()
    diff = (k_logits - p_logits).abs()
    scale = p_logits.abs().max().item()
    agree = (k_logits.argmax(1) == p_logits.argmax(1)).float().mean().item()
    log(f'ade eval: crop batch {tuple(crops.shape)} (600 planes) kernels vs '
        f'plain: max_abs_err {diff.max().item():.3e} mean_abs_err '
        f'{diff.mean().item():.3e} logit scale {scale:.3f} argmax agreement '
        f'{agree:.5f}')
    assert diff.max().item() <= DEC_TOL * scale
    prof = profile_image(evaluator, s, cfg)
    return launches, dict(ms_per_image=dt * 1e3, peak_mib=peak / 2**20,
                          **prof)


COCO_HW, ADE_HW = (480, 640), (512, 683)


def write_geometry_dataset(root, dataset, seed=0,
                           counts=(('labeled', 1), ('unlabeled', 2),
                                   ('val', 1))):
    """A synthetic dataset at COCO's or ADE20K's geometry under ``root``:
    JPEG images (COCO 640x480, its val image shorter than the crop; ADE
    short side 512) and PNG label maps (COCO 0-80 with a 255 border; ADE
    0-150, 0 being "other"); returns {kind: list path}."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    hw, top = (COCO_HW, 81) if dataset == 'coco' else (ADE_HW, 151)
    for d in ('images', 'masks'):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    paths = {}
    for kind, n in counts:
        lines = []
        for i in range(n):
            name = f'{kind}_{i}'
            Image.fromarray(rs.randint(0, 256, hw + (3,), np.uint8)).save(
                os.path.join(root, 'images', name + '.jpg'), quality=90)
            mask = rs.randint(0, top, hw).astype(np.uint8)
            if dataset == 'coco':
                mask[:, :5] = 255
            Image.fromarray(mask).save(os.path.join(root, 'masks',
                                                    name + '.png'))
            lines.append(f'images/{name}.jpg masks/{name}.png')
        paths[kind] = os.path.join(root, f'{kind}.txt')
        with open(paths[kind], 'w') as f:
            f.write('\n'.join(lines) + '\n')
    return paths


def run_generated_cli(what, cfg, tmp, paths, overrides, resume=False):
    """The trainer CLI on a generated config pointed at ``paths``, for one
    epoch from ``overrides``' weights (None: the seeded ones): its launches
    must be 2 x ``launches_per_step`` (two steps) plus its evaluation's
    (each crop batch a ``launches_per_call``). With ``resume``, a run
    preempted after step 0 and resumed must end bit-equal to it. Returns
    the launches and the wall."""
    import yaml
    from semivl_tpu_torch.data.dataset import SemiDataset
    from semivl_tpu_torch.tools import train as cli
    cfg = dict(cfg, data_root=os.path.dirname(paths['val']),
               labeled_id_path=paths['labeled'],
               unlabeled_id_path=paths['unlabeled'],
               val_id_path=paths['val'], epochs=1, debug_images=False)
    if overrides:
        cfg['init_param_overrides'] = overrides
    path = os.path.join(tmp, f'{what}.yaml')
    with open(path, 'w') as f:
        yaml.dump(cfg, f)
    valset = SemiDataset(cfg, 'val', id_path=paths['val'])
    per_call = launches_per_call(cfg)
    batches = (eval_batches(cfg, range(len(valset)))
               if any(per_call.values()) else 0)
    expected = with_eval(launches_per_step(cfg), 2, batches, per_call)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        best, run = cli.main(['--config', path, '--seed', '0'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counters()
    finally:
        os.chdir(cwd)
    run = os.path.join(tmp, run)   # the run dir is under tmp's exp/
    with open(os.path.join(run, 'metrics.jsonl')) as f:
        metrics = {}
        for line in f:
            metrics.update(json.loads(line))
    state = _ckpt(run)
    shapes = [tuple(valset.get(i)['img'].shape[:2])
              for i in range(len(valset))]
    log(f'{what}: {cfg["name"]} for 2 steps and an evaluation of val images '
        f'{shapes} ({batches} crop batches) in {wall:.1f} s; best mIoU '
        f'{best:.4f}, loss_all {metrics["train/loss_all"]:.4f}; launches '
        f'{launches} (expected {expected})')
    assert launches == expected, (launches, expected)
    assert state['iteration'] == 2
    assert all(np.isfinite(v) for k, v in metrics.items()
               if k.startswith('train/loss')), metrics
    assert all(torch.isfinite(v).all() for v in state['model'].values())
    if resume:
        cut = os.path.join(tmp, f'{what} cut.yaml')
        with open(cut, 'w') as f:
            yaml.dump(dict(cfg, preempt_at_step=0), f)
        os.chdir(tmp)
        try:
            _, run_b = cli.main(['--config', cut, '--seed', '0'])
            assert _ckpt(run_b)['iteration'] == 1
            cli.main(['--config', path, '--seed', '0', '--resume-from',
                      run_b])
        finally:
            os.chdir(cwd)
        resumed = _ckpt(os.path.join(tmp, run_b))
        equal = resumed['iteration'] == 2 and all(
            torch.equal(resumed['model'][k], v)
            for k, v in state['model'].items())
        log(f'{what}: preempted after step 0 and resumed to step 2: '
            f'parameters and buffers {"bit-equal" if equal else "NOT equal"}'
            ' to the straight run')
        assert equal
    return launches, wall


DLV3P_MODELS = ('vlm-dlv3p-bn12-sk4-ftap-mcvitb',
                'vlm-dlv3p-bn12-sk4-ft-mcvitb',
                'vlm-dlv3p-bn11-sk4-ft-tvit-in1k')


def run_dlv3p(name, tmp, voc_paths):
    """Phase 15 (d) for one of exp 41's DeepLabV3+ models at full width: one
    SemiVL step of 2 + 2 512^2 crops with every packed-attention call held
    to its rounded reference on its own inputs (no decoder kernel and no
    head-split kernel called), then ``run_train``'s step with the launches
    ``launches_per_step`` derives (attention only), the head's BatchNorm
    statistics changed, frozen leaves unchanged (``ftap``) or every
    backbone leaf changed (``ft``); an evaluation of one VOC-geometry
    image; for the timm row, the trainer CLI on its generated config for 2
    steps from these weights."""
    from semivl_tpu_torch.configs.experiments import generate_experiment_cfgs
    from semivl_tpu_torch.evaluation.predict import (
        Evaluator, _chunk_sizes, evaluate)
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    cfg = next(c for c in generate_experiment_cfgs(41)
               if c['model'] == 'mmseg.' + name and c['split'] == '92')
    expected = launches_per_step(cfg)
    t0 = time.perf_counter()
    bundle = scaled_bundle(cfg)
    model = bundle.model
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert bool(frozen) == ('ftap' in name), frozen[:3]
    assert all(p.requires_grad for n, p in model.named_parameters()
               if n.startswith('backbone.')) == ('ftap' not in name)
    log(f'{name}: built in {time.perf_counter() - t0:.1f} s, '
        f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, '
        f'{len(frozen)} frozen leaves; launches per step from the config '
        f'{expected}')
    batch = train_batch(torch.Generator(device='cuda').manual_seed(10))
    per_call = PerCallCheck()
    opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
    check_step = make_semivl_train_step(bundle, cfg, opt, TOTAL_ITERS)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with contextlib.ExitStack() as stack:
        for patch in per_call.patches():
            stack.enter_context(patch)
        metrics = {k: float(v) for k, v in check_step(
            batch, torch.Generator(device='cuda').manual_seed(11)).items()}
    worst = per_call.finish()
    model.load_state_dict(state)
    del check_step, opt
    log(f'{name}: per call, kernels vs rounded (worst rel-L2, calls): '
        + json.dumps({k: [float(f'{e:.3e}'), n] for k, (e, n) in
                      worst.items()}) + f'; loss terms {json.dumps(metrics)}')
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    per_call.check(PER_CALL_TOLS, absent=('heads_fwd', 'heads_bwd',
                                          'decoder_fwd', 'decoder_bwd'))
    step, launches, perf = run_train(cfg, bundle, batch, steps=1,
                                     expected=expected)
    del step
    n_stats = sum(1 for n, _ in model.named_buffers()
                  if n.startswith('decode_head.'))
    assert n_stats == 18, n_stats

    evaluator = Evaluator(model, bundle.text_feats, cfg, device='cuda')
    ds = SynthImages(seed=3, sizes=((512, 683),))
    calls = len(_chunk_sizes(len(evaluator._zegclip_coords(512, 683))))
    fwd = launches_per_call(cfg)
    torch.cuda.synchronize()
    fa.launches = fa.heads_launches = fd.launches = 0
    t0 = time.perf_counter()
    miou, iou = evaluate(evaluator, ds, cfg['eval_mode'], cfg)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    ev = {'attention': fa.launches, 'heads': fa.heads_launches,
          'decoder': fd.launches}
    log(f'{name}: evaluation of one 512x683 image ({calls} crop batch): '
        f'mIoU {miou:.4f} in {eval_ms:.1f} ms, launches {ev}')
    assert np.isfinite(miou) and iou.shape == (21,)
    assert ev == {'attention': fwd['attention'] * calls, 'heads': 0,
                  'decoder': 0}, ev
    out = dict(step=launches, eval=ev, perf=perf, per_call=worst)
    if 'tvit' in name:
        overrides = save_trained_weights(bundle,
                                         os.path.join(tmp, 'tvit.npz'))
        del bundle, model, evaluator
        torch.cuda.empty_cache()
        out['cli'], out['cli_wall_s'] = run_generated_cli(
            'tvit cli', cfg, tmp, voc_paths, overrides)
    return out


def run_phase15(tmp, voc_paths, overrides):
    """Phase 15 (see the module's docstring): exp 43's step and evaluation,
    the CLI on exp 42's and 43's generated configs, exp 41's three
    DeepLabV3+ models. Returns the launches by path and the readings."""
    from semivl_tpu_torch.configs import (cityscapes_train_cfg,
                                          flagship_train_cfg)
    from semivl_tpu_torch.configs.experiments import generate_experiment_cfgs
    # the derivation reproduces the constants phases 6 and 8 assert
    assert launches_per_step(flagship_train_cfg()) == EXPECTED_PER_STEP
    assert launches_per_step(cityscapes_train_cfg()) == EXPECTED_CITYSCAPES
    t_phase = time.perf_counter()
    launches, readings = {}, {}
    ade_err, launches['ade_train_step'], readings['ade_train'] = \
        run_ade_train()
    torch.cuda.empty_cache()
    launches['ade_eval_image'], readings['ade_eval'] = run_ade_eval()
    torch.cuda.empty_cache()
    for exp, dataset in ((42, 'coco'), (43, 'ade')):
        paths = write_geometry_dataset(os.path.join(tmp, dataset), dataset)
        cfg = generate_experiment_cfgs(exp)[0]
        key = f'{dataset}_cli_two_steps_and_eval'
        launches[key], readings[f'{dataset}_cli_wall_s'] = \
            run_generated_cli(f'{dataset} cli', cfg, tmp, paths, overrides)
        torch.cuda.empty_cache()
    for name in DLV3P_MODELS:
        out = run_dlv3p(name, tmp, voc_paths)
        short = name.replace('vlm-dlv3p-', '')
        launches[f'dlv3p_{short}_step'] = out['step']
        launches[f'dlv3p_{short}_eval_image'] = out['eval']
        readings[f'dlv3p_{short}'] = out['perf']
        if 'cli' in out:
            launches['tvit_cli_two_steps_and_eval'] = out['cli']
            readings['tvit_cli_wall_s'] = out['cli_wall_s']
        torch.cuda.empty_cache()
    readings['phase_s'] = time.perf_counter() - t_phase
    log(f'phase 15: {readings["phase_s"]:.1f} s')
    return ade_err, launches, readings


# ------------------------------------------------------------ phase 16

ZEGCLIP_L = 1 + 10 + 32 * 32   # cls token, prompts, patches of a 512 crop
ZEGCLIP_PROMPT_LEAVES = ['backbone.deep_prompt_embeddings',
                         'backbone.prompt_embeddings',
                         'backbone.prompt_norm.bias',
                         'backbone.prompt_norm.weight',
                         'backbone.prompt_proj.bias',
                         'backbone.prompt_proj.weight']


def zegclip_cfg(split='92'):
    """Exp 41's generated ZegCLIP config (``vlm-zegclip-rd-pt-vitb``,
    'mmseg' for both criteria) of ``split``."""
    from semivl_tpu_torch.configs.experiments import generate_experiment_cfgs
    return next(c for c in generate_experiment_cfgs(41)
                if 'zegclip' in c['model'] and c['split'] == split)


def unreached_leaves(model):
    """The ATM head's last layer after its attention logits (the masks are
    that layer's pre-softmax logits): no loss reaches these leaves."""
    pre = f'decode_head.decoder.{len(model.decode_head.decoder) - 1}.'
    return {n for n, _ in model.named_parameters() if n.startswith(pre)
            and not n.startswith((pre + 'attn.q.', pre + 'attn.k.'))}


def run_zegclip_train():
    """Phase 16 (a): exp 41's ZegCLIP step at full width (VPT ViT-B/16 with
    10 prompt tokens, ATM 3 x 8 heads x 512, 2 + 2 512^2 crops, SegLossPlus
    for both criteria): from the model as built, one step with every packed
    attention call held to its rounded reference on its own inputs and
    rerun with the last key tile skipped, which must fail; that step runs
    at ``conf_thresh`` 0, so its unlabeled SegLossPlus terms must be
    non-zero and finite and every backward call carries a gradient (at the
    config's 0.95 the random model keeps no pseudo-label: pass 2's
    gradient is zero). Then timed steps at the config's threshold with the
    launches ``launches_per_step`` derives (#3 and #4 only), peak memory,
    frozen leaves bit-identical and every prompt and head leaf changed but
    those no loss reaches and no weight decay moves; a profile. Returns
    the per-call errors, the launches, the readings and the bundle."""
    from semivl_tpu_torch.train.optim import (build_optimizer,
                                              custom_key_mults)
    from semivl_tpu_torch.train.step import make_semivl_train_step
    cfg = zegclip_cfg()
    expected = launches_per_step(cfg)
    assert expected == dict(dict.fromkeys(EXPECTED_PER_STEP, 0),
                            attention_fwd=36, attention_bwd=24), expected
    t0 = time.perf_counter()
    bundle = scaled_bundle(cfg)
    model = bundle.model
    keys = cfg['optimizer']['paramwise_cfg']['custom_keys']
    unreached = unreached_leaves(model)
    prm = dict(model.named_parameters())
    # AdamW decays a leaf without gradient: not one without decay, nor a
    # zero one (the built biases)
    unmoved = {n for n in unreached if custom_key_mults(keys, n)[1] == 0
               or not prm[n].any()}
    trained = sorted(n for n, p in model.named_parameters()
                     if p.requires_grad and n.startswith('backbone.'))
    assert trained == ZEGCLIP_PROMPT_LEAVES, trained
    assert all(p.requires_grad for n, p in model.named_parameters()
               if n.startswith('decode_head.'))
    prms = list(model.parameters())
    log(f'zegclip train: built exp 41\'s ZegCLIP bundle in '
        f'{time.perf_counter() - t0:.1f} s, '
        f'{sum(p.numel() for p in prms) / 1e6:.1f} M params, '
        f'{sum(p.numel() for p in prms if p.requires_grad) / 1e6:.2f} M '
        f'trainable; launches per step from the config {expected}; '
        f'{len(unreached)} head leaves no loss reaches, {len(unmoved)} of '
        f'them without weight decay or zero')
    batch = train_batch(torch.Generator(device='cuda').manual_seed(12))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    per_call = PerCallCheck(attn_faults=True)
    opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
    check_step = make_semivl_train_step(bundle, dict(cfg, conf_thresh=0.0),
                                        opt, TOTAL_ITERS)
    with contextlib.ExitStack() as stack:
        for patch in per_call.patches():
            stack.enter_context(patch)
        metrics = {k: float(v) for k, v in check_step(
            batch, torch.Generator(device='cuda').manual_seed(13)).items()}
    worst = per_call.finish()
    model.load_state_dict(state)
    del check_step, opt
    faults = per_call.attn_fault_reads
    log('zegclip compare: per call, kernels vs rounded (worst rel-L2, '
        'calls): ' + json.dumps({k: [float(f'{e:.3e}'), n] for k, (e, n) in
                                 worst.items()})
        + f'; planted fault (last key tile skipped) at L = {ZEGCLIP_L}: '
        f'forward rel-L2 >= {min(b for d, _, b in faults if d == "fwd"):.3e}'
        f' (tol {ATTN_REL_TOL}), backward >= '
        f'{min(b for d, _, b in faults if d == "bwd"):.3e} (tol '
        f'{ATTN_BWD_REL_TOL}); loss terms at conf_thresh 0 '
        f'{json.dumps(metrics)}')
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert min(metrics['loss_s1'], metrics['loss_s2'],
               metrics['loss_fp']) > 0, metrics
    assert [(d, n) for d, n, _ in faults] == [('fwd', ZEGCLIP_L)] * 36 + [
        ('bwd', ZEGCLIP_L)] * 24, [(d, n) for d, n, _ in faults]
    assert worst['attention_fwd'][1] == 36 and worst['attention_bwd'][1] == 24
    per_call.check(PER_CALL_TOLS, absent=('heads_fwd', 'heads_bwd',
                                          'decoder_fwd', 'decoder_bwd'))
    step, launches, perf = run_train(cfg, bundle, batch, expected=expected,
                                     unmoved=unmoved)
    prof = profile_step(step, batch)
    del step
    model.load_state_dict(state)
    return worst, launches, dict(perf, **prof, losses_at_thresh_0=metrics), \
        bundle


def run_zegclip_eval(bundle, cfg):
    """Phase 16 (b): ``zegclip_sliding_window`` evaluation of one synthetic
    512x683 image (2 crops in one batch), launches read around
    ``evaluate``; that crop batch through the kernels and the plain
    versions; a profile of the image."""
    from semivl_tpu_torch.evaluation.predict import (
        Evaluator, _chunk_sizes, evaluate)
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    model = bundle.model
    evaluator = Evaluator(model, bundle.text_feats, cfg, device='cuda')
    ds = SynthImages(seed=4, sizes=((512, 683),))
    s = ds.get(0)
    coords = evaluator._zegclip_coords(512, 683)
    chunks = _chunk_sizes(len(coords))
    assert chunks == [2], chunks
    expected = {'attention': launches_per_call(cfg)['attention'],
                'heads': 0, 'decoder': 0}
    evaluator.predict(s['img'][None], s['mask'].shape, cfg['eval_mode'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.heads_launches = fd.launches = 0
    t0 = time.perf_counter()
    miou, iou = evaluate(evaluator, ds, cfg['eval_mode'], cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {'attention': fa.launches, 'heads': fa.heads_launches,
                'decoder': fd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f'zegclip eval: 1 image 512x683, 2 crops in one batch: mIoU '
        f'{miou:.4f} in {dt * 1e3:.1f} ms, peak memory {peak / 2**20:.1f} '
        f'MiB; launches {launches} (expected {expected})')
    assert np.isfinite(miou) and iou.shape == (21,)
    assert launches == expected, (launches, expected)
    img = torch.from_numpy(s['img']).cuda()
    crops = torch.stack([img[y:y + 512, x:x + 512] for y, x in coords])
    with torch.no_grad():
        inp = evaluator._to_model_input(crops)
        k_logits = model(inp, evaluator.text)
        with mock.patch.object(fa, 'packed_attention',
                               fa.packed_attention_plain):
            p_logits = model(inp, evaluator.text)
    torch.cuda.synchronize()
    assert k_logits.shape == (2, 21, 512, 512)
    assert torch.isfinite(k_logits).all()
    diff = (k_logits - p_logits).abs()
    scale = p_logits.abs().max().item()
    agree = (k_logits.argmax(1) == p_logits.argmax(1)).float().mean().item()
    log(f'zegclip eval: crop batch {tuple(crops.shape)} kernels vs plain: '
        f'max_abs_err {diff.max().item():.3e} mean_abs_err '
        f'{diff.mean().item():.3e} logit scale {scale:.4f} (tol {DEC_TOL} x '
        f'scale) argmax agreement {agree:.5f}')
    assert diff.max().item() <= DEC_TOL * scale
    prof = profile_image(evaluator, s, cfg)
    return launches, dict(ms_per_image=dt * 1e3, peak_mib=peak / 2**20,
                          max_abs_err=diff.max().item(), logit_scale=scale,
                          **prof)


def run_concept():
    """Phase 16 (d): exp 40's step and evaluation with ``text_embedding_variant
    = pl_text = 'concept4_single'``: the VLG decoder over VOC's 98 concepts
    a crop, max-aggregated to 21 classes. One step with every kernel call
    held to its rounded reference on its own inputs (phase 15's limits),
    each decoder call over 98 planes a crop (teacher 2 x 98, pass 1 6 x
    98, pass 2 4 x 98); a step with the launches ``launches_per_step``
    derives, and a profile; an evaluation of one 512x683 image (2 x 98
    planes)."""
    from semivl_tpu_torch.configs import flagship_train_cfg
    from semivl_tpu_torch.evaluation.predict import (
        Evaluator, _chunk_sizes, evaluate)
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    cfg = dict(flagship_train_cfg(512), text_embedding_variant=
               'concept4_single', pl_text='concept4_single')
    expected = launches_per_step(cfg)
    bundle = scaled_bundle(cfg)
    model = bundle.model
    n = bundle.text_feats.shape[0]
    assert n == 98 and model.decode_head.num_classes == 21
    batch = train_batch(torch.Generator(device='cuda').manual_seed(14))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    per_call = PerCallCheck()
    opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
    check_step = make_semivl_train_step(bundle, cfg, opt, TOTAL_ITERS)
    with contextlib.ExitStack() as stack:
        for patch in per_call.patches():
            stack.enter_context(patch)
        metrics = {k: float(v) for k, v in check_step(
            batch, torch.Generator(device='cuda').manual_seed(15)).items()}
    worst = per_call.finish()
    model.load_state_dict(state)
    del check_step, opt
    tols = dict(PER_CALL_TOLS, decoder_bwd=STEP_DEC_BWD_TOL)
    log(f'concept compare: {n} concept planes a crop; decoder calls over P = '
        f'{per_call.planes}; per call, kernels vs rounded (worst rel-L2, '
        'calls, tol): ' + json.dumps(
            {k: [float(f'{e:.3e}'), c, tols[k]] for k, (e, c) in
             worst.items()}) + f'; loss terms {json.dumps(metrics)}')
    assert per_call.planes == [2 * n, 6 * n, 4 * n], per_call.planes
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    per_call.check(tols, absent=('heads_fwd', 'heads_bwd'))
    step, launches, perf = run_train(cfg, bundle, batch, steps=1,
                                     expected=expected)
    prof = profile_step(step, batch)
    del step
    evaluator = Evaluator(model, bundle.text_feats, cfg, device='cuda')
    ds = SynthImages(seed=5, sizes=((512, 683),))
    calls = len(_chunk_sizes(len(evaluator._zegclip_coords(512, 683))))
    fwd = launches_per_call(cfg)
    torch.cuda.synchronize()
    fa.launches = fa.heads_launches = fd.launches = 0
    t0 = time.perf_counter()
    miou, iou = evaluate(evaluator, ds, cfg['eval_mode'], cfg)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    ev = {'attention': fa.launches, 'heads': fa.heads_launches,
          'decoder': fd.launches}
    log(f'concept eval: one 512x683 image ({calls} crop batch of 2 x {n} '
        f'planes): mIoU {miou:.4f} in {eval_ms:.1f} ms, launches {ev}')
    assert np.isfinite(miou) and iou.shape == (21,)
    assert ev == {'attention': fwd['attention'] * calls, 'heads': 0,
                  'decoder': fwd['decoder'] * calls}, ev
    return worst, launches, ev, dict(perf, **prof, eval_ms=eval_ms)


def run_phase16(tmp, voc_paths):
    """Phase 16 (see the module's docstring): exp 41's ZegCLIP step, its
    evaluation and its CLI, then exp 40 over concept planes. (e), #3 and
    #4 at (4, 1035, 768)/12, runs with phase 3's cases. Returns the
    per-call errors, the launches by path and the readings."""
    t_phase = time.perf_counter()
    launches, readings, errs = {}, {}, {}
    errs['zegclip'], launches['zegclip_train_step'], \
        readings['zegclip_train'], bundle = run_zegclip_train()
    launches['zegclip_eval_image'], readings['zegclip_eval'] = \
        run_zegclip_eval(bundle, zegclip_cfg())
    overrides = save_trained_weights(bundle,
                                     os.path.join(tmp, 'zegclip.npz'))
    del bundle
    torch.cuda.empty_cache()
    launches['zegclip_cli_two_steps_and_eval'], \
        readings['zegclip_cli_wall_s'] = run_generated_cli(
            'zegclip cli', zegclip_cfg(), tmp, voc_paths, overrides)
    torch.cuda.empty_cache()
    errs['concept'], launches['concept_train_step'], \
        launches['concept_eval_image'], readings['concept'] = run_concept()
    torch.cuda.empty_cache()
    readings['phase_s'] = time.perf_counter() - t_phase
    log(f'phase 16: {readings["phase_s"]:.1f} s')
    return errs, launches, readings


# ------------------------------------------------------------ phase 17

def baseline_cfg(method):
    """Exp 40's model as the UniMatch or the supervised baseline: no
    guidance encoder, no consistency loss (the generator's baselines)."""
    from semivl_tpu_torch.configs import flagship_train_cfg
    return dict(flagship_train_cfg(512), method=method, clip_encoder=None,
                maskclip_consistency_lambda=0)


def dlv3p_cfg(backbone='r101', dataset='pascal', method='unimatch',
              **kw):
    """The UniMatch DeepLabV3+ baseline's generated config (``opt =
    'original'`` at lr 1e-3, ``lr_multi`` 10 on VOC and 1 on Cityscapes,
    CELoss unless given; no ``img_scale``: UniMatch's own pipeline, whose
    val images keep their size, so that ``original`` mode predicts at the
    label's size, as JAX's tests configure it)."""
    from semivl_tpu_torch.configs.experiments import config_from_vars
    kw.setdefault('criterion', 'CELoss')
    kw.setdefault('img_scale', None)
    return config_from_vars(
        exp_id=99, model=f'dlv3p-{backbone}', method=method, opt='original',
        lr=1e-3, criterion_u='CELoss', dataset=dataset,
        crop_size=801 if dataset == 'cityscapes' else 512, **kw)


def supervised_batch(batch):
    return dict(img=batch['img_x'], mask=batch['mask_x'])


def checked_step(cfg, bundle, batch, what):
    """One step of ``cfg``'s method from the model as built, every kernel
    call held to its rounded reference on its own inputs (phase 15's
    limits), each decoder-backward call rerun with a planted fault and
    each packed attention call with its last key tile skipped, all of
    which must fail; the UniMatch step at ``conf_thresh`` 0, so that every
    unlabeled term carries gradient. The model's state is restored."""
    from semivl_tpu_torch.train.optim import build_optimizer
    model = bundle.model
    state = {k: v.clone() for k, v in model.state_dict().items()}
    per_call = PerCallCheck(faults={
        'conv1 dgrad without its top-left tap': conv1_dgrad_without_a_tap},
        attn_faults=True)
    opt, _ = build_optimizer(cfg, model, TOTAL_ITERS)
    step = make_step(cfg)(bundle, dict(cfg, conf_thresh=0.0), opt,
                          TOTAL_ITERS)
    with contextlib.ExitStack() as stack:
        for patch in per_call.patches():
            stack.enter_context(patch)
        metrics = {k: float(v) for k, v in step(
            batch, torch.Generator(device='cuda').manual_seed(16)).items()}
    worst = per_call.finish()
    model.load_state_dict(state)
    tols = dict(PER_CALL_TOLS, decoder_bwd=STEP_DEC_BWD_TOL)
    log(f'{what} compare: per call, kernels vs rounded (worst rel-L2, '
        'calls, tol): ' + json.dumps(
            {k: [float(f'{e:.3e}'), n, tols[k]] for k, (e, n) in
             worst.items()}) + f'; planted decoder fault reads '
        f'{[f"{bad:.3e}" for _, _, bad in per_call.fault_reads]}; attention '
        f'fault reads >= '
        f'{min(b for _, _, b in per_call.attn_fault_reads):.3e}; loss terms '
        f'{json.dumps(metrics)}')
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert all(v > 0 for v in metrics.values()), metrics
    per_call.check(tols, absent=('heads_fwd', 'heads_bwd'))
    return worst


def run_baseline_steps():
    """Phase 17 (a) and (d): exp 40's model as the supervised baseline (2
    labeled crops) and as UniMatch (2 + 2), then UniMatch with the
    augmentation on the card (uint8 transport); each with a checked step,
    timed steps with the launches ``launches_per_step`` derives, peak
    memory and a profile; the card's augmented views against the same
    apply functions on the CPU on the same draws."""
    from semivl_tpu_torch.ops import augment
    launches, readings, errs = {}, {}, {}
    cfg_u = baseline_cfg('unimatch')
    bundle = scaled_bundle(cfg_u)
    assert bundle.model.clip_encoder is None
    batch = train_batch(torch.Generator(device='cuda').manual_seed(17))
    for method, b in (('supervised', supervised_batch(batch)),
                      ('unimatch', batch)):
        cfg = baseline_cfg(method)
        expected = launches_per_step(cfg)
        log(f'{method}: launches per step from the config {expected}')
        errs[method] = checked_step(cfg, bundle, b, method)
        step, launches[f'{method}_train_step'], perf = run_train(
            cfg, bundle, b, expected=expected)
        readings[method] = dict(perf, **profile_step(step, b))
        del step
        torch.cuda.empty_cache()

    cfg = dict(cfg_u, strong_aug_on_device=True,
               labeled_photometric_distortion=True)
    gen = torch.Generator(device='cuda').manual_seed(18)

    def u8(n):
        return torch.randint(0, 256, (n, 512, 512, 3), generator=gen,
                             device='cuda', dtype=torch.uint8)

    aug = {k: v for k, v in batch.items() if k in (
        'mask_x', 'ignore_mask', 'ignore_mask_other', 'cutmix_box1',
        'cutmix_box2')}
    aug.update(img_x=u8(2), img_raw=u8(2), img_raw_other=u8(2))
    step, launches['unimatch_aug_train_step'], perf = run_train(
        cfg, bundle, aug, expected=launches_per_step(cfg))
    readings['unimatch_aug'] = perf
    del step
    raw = augment.to_unit(torch.cat([aug['img_raw'], aug['img_raw'],
                                     aug['img_raw_other'],
                                     aug['img_raw_other']]))
    x = augment.to_unit(aug['img_x'])
    for name, draw, apply, imgs in (
            ('strong', augment.strong_draws, augment.apply_strong, raw),
            ('photometric', augment.photometric_draws,
             augment.apply_photometric, x)):
        d = draw(imgs.shape[0], gen, 'cuda')
        card = apply(imgs, d)
        ms = cuda_ms(lambda: apply(imgs, d), iters=10)
        cpu = apply(imgs.cpu(), {k: v.cpu() for k, v in d.items()})
        err = (card.cpu() - cpu).abs().max().item()
        scale = cpu.abs().max().item()
        log(f'augment: {name} views of {tuple(imgs.shape)} on the card vs '
            f'the CPU on the same draws: max_abs_err {err:.3e} (tol '
            f'{AUG_TOL} x scale {scale:.3f}); {ms:.3f} ms on the card')
        assert err <= AUG_TOL * scale
        readings[f'augment_{name}'] = dict(max_abs_err=err, ms=ms)
    return errs, launches, readings, bundle


def run_dlv3p_step(what, cfg, b, size, nclass):
    """Phase 17 (b)/(c): a step of the UniMatch DeepLabV3+ (the ``original``
    SGD, BatchNorm in train mode in the student passes and on the running
    statistics in the teacher pass) with no kernel launched, every
    parameter and running statistic moved, every leaf in the ``lr_multi``
    group; ms per step, peak memory and a profile."""
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.train.optim import build_optimizer
    bundle = build_model(cfg, dtype=torch.bfloat16, device='cuda', seed=0)
    n_params = sum(p.numel() for p in bundle.model.parameters())
    groups = {g['lr_mult'] for g in build_optimizer(
        cfg, bundle.model, TOTAL_ITERS)[0].param_groups}
    assert groups == {cfg['lr_multi']}, groups
    log(f'{what}: {cfg["name"]}: {n_params / 1e6:.1f} M params, every leaf '
        f'at lr x lr_multi {cfg["lr_multi"]}, criterion '
        f'{cfg["criterion"]["name"]}')
    batch = train_batch(torch.Generator(device='cuda').manual_seed(19),
                        b=b, size=size, nclass=nclass)
    step, launches, perf = run_train(cfg, bundle, batch, steps=2,
                                     expected=launches_per_step(cfg))
    assert not any(launches.values()), launches
    prof = profile_step(step, batch)
    return launches, dict(perf, **prof), bundle


EVAL_MODES = ('original', 'center_crop', 'padded_sliding_window')


def run_dlv3p_eval(bundle, cfg):
    """Phase 17 (e): the r101 DeepLabV3+ on one 512x683 image in each of the
    other eval modes (crop 512, stride 426), no kernel launched, and
    ``predict(..., return_logits=True)`` of each: finite maps of the
    mode's size."""
    from semivl_tpu_torch.evaluation.predict import Evaluator, evaluate
    cfg = dict(cfg, stride=426)
    evaluator = Evaluator(bundle.model, bundle.text_feats, cfg,
                          device='cuda')
    ds = SynthImages(seed=6, sizes=((512, 683),))
    s = ds.get(0)
    launches, readings = {}, {}
    for mode in EVAL_MODES:
        evaluator.predict(s['img'][None], s['mask'].shape, mode)
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        miou, iou = evaluate(evaluator, ds, mode, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counters()
        pred, logits = evaluator.predict(s['img'][None], s['mask'].shape,
                                         mode, return_logits=True)
        hw = (512, 512) if mode == 'center_crop' else (512, 683)
        log(f'dlv3p eval: {mode} on one 512x683 image: mIoU {miou:.4f} in '
            f'{ms:.1f} ms; return_logits {logits.shape}; launches {counts}')
        assert np.isfinite(miou) and iou.shape == (21,)
        assert logits.shape == (1, 21) + hw and pred.shape == (1,) + hw
        assert np.isfinite(logits).all()
        assert not any(counts.values()), counts
        launches[f'dlv3p_r101_eval_image_{mode}'] = dict(
            attention=counts['attention_fwd'], heads=counts['heads_fwd'],
            decoder=counts['decoder_fwd'])
        readings[mode] = dict(ms_per_image=ms)
    return launches, readings


def run_baseline_clis(tmp, voc_paths, overrides):
    """Phase 17 (f): the CLI over phase 13's dataset, 2 steps and an
    evaluation, on a ``dlv3p-r101`` supervised config (``eval_mode =
    'original'``, seeded weights) and on exp 40's split-92 config as
    UniMatch with ``strong_aug_on_device`` from ``overrides``' weights,
    preempted after step 0 and resumed."""
    from semivl_tpu_torch.configs.experiments import generate_experiment_cfgs
    launches, readings = {}, {}
    launches['dlv3p_supervised_cli_two_steps_and_eval'], \
        readings['dlv3p_supervised_cli_wall_s'] = run_generated_cli(
            'dlv3p supervised cli', dlv3p_cfg(method='supervised',
                                              eval_mode='original'),
            tmp, voc_paths, None)
    torch.cuda.empty_cache()
    cfg = dict(generate_experiment_cfgs(40)[0], method='unimatch',
               clip_encoder=None, maskclip_consistency_lambda=0,
               strong_aug_on_device=True)
    launches['unimatch_aug_cli_two_steps_and_eval'], \
        readings['unimatch_aug_cli_wall_s'] = run_generated_cli(
            'unimatch aug cli', cfg, tmp, voc_paths, overrides, resume=True)
    torch.cuda.empty_cache()
    return launches, readings


def run_phase17(tmp, voc_paths):
    """Phase 17 (see the module's docstring): the supervised and UniMatch
    baselines on exp 40's model, the UniMatch DeepLabV3+ (r101 on VOC and
    on Cityscapes with OHEM, xc65 on VOC), the other eval modes and the
    CLI. Returns the per-call errors, the launches by path and the
    readings."""
    t_phase = time.perf_counter()
    errs, launches, readings, bundle = run_baseline_steps()
    overrides = save_trained_weights(bundle,
                                     os.path.join(tmp, 'unimatch.npz'))
    del bundle
    torch.cuda.empty_cache()
    cfg = dlv3p_cfg()
    launches['dlv3p_r101_voc_step'], readings['dlv3p_r101_voc'], bundle = \
        run_dlv3p_step('dlv3p r101 voc', cfg, 2, 512, 21)
    new, readings['dlv3p_r101_eval'] = run_dlv3p_eval(bundle, cfg)
    launches.update(new)
    del bundle
    torch.cuda.empty_cache()
    launches['dlv3p_r101_cs_ohem_step'], readings['dlv3p_r101_cs_ohem'], _ \
        = run_dlv3p_step('dlv3p r101 cityscapes', dlv3p_cfg(
            dataset='cityscapes', criterion='OHEM'), 1, 801, 19)
    torch.cuda.empty_cache()
    launches['dlv3p_xc65_voc_step'], readings['dlv3p_xc65_voc'], _ = \
        run_dlv3p_step('dlv3p xc65 voc', dlv3p_cfg('xc65'), 2, 512, 21)
    torch.cuda.empty_cache()
    new, cli = run_baseline_clis(tmp, voc_paths, overrides)
    launches.update(new)
    readings.update(cli)
    readings['phase_s'] = time.perf_counter() - t_phase
    log(f'phase 17: {readings["phase_s"]:.1f} s')
    return errs, launches, readings


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    if sys.argv[1:2] == ['--rank-worker']:   # one rank of phase 14
        return rank_worker(*sys.argv[2:5])
    if sys.argv[1:2] == ['--cards']:   # phase 14 across N cards
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        try:
            readings = run_across_cards(int(sys.argv[2]))
        finally:
            Ranks.kill_all()
        log(f'cards: {json.dumps(readings)}')
        log(card)
        log(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}))
        return 0
    from semivl_tpu_torch.ops import _build
    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'torch {torch.__version__} cuda {torch.version.cuda} device '
        f'{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    log(f'card: {card}')
    log(f'build: kernels built in {_build.build_all():.1f} s')
    check_sass(_build)
    gen = torch.Generator(device='cuda').manual_seed(0)
    attn = {r['case']: r for r in check_attention(gen)}
    attn_bwd = {r['case']: r for r in check_attention_bwd(gen)}
    heads = check_heads_attention(gen)   # phase 9, before any profile
    torch.cuda.empty_cache()
    dec = check_decoder(torch.Generator().manual_seed(1))
    dec_voc = check_decoder(torch.Generator().manual_seed(6), b=6)
    dec_cs = check_decoder(torch.Generator().manual_seed(3), b=3, n=19, h=51,
                           w=51, skips=(32, 32))
    dec_edge = check_decoder(torch.Generator().manual_seed(4), b=1, n=19,
                             h=31, w=28, skips=(32, 32))
    dec_ade = check_decoder(torch.Generator().manual_seed(7), b=3, n=150)
    dec_tail, dec_input = check_decoder_bwd(torch.Generator().manual_seed(2))
    ade_tail, ade_input = check_decoder_bwd(torch.Generator().manual_seed(8),
                                            b=3, n=150)
    banded = check_banded_bwd(torch.Generator().manual_seed(5))
    torch.cuda.empty_cache()
    up_rows, up_launches, bench_rows = check_fused_up()   # phase 10
    wide = check_wide_widths()   # phase 12
    torch.cuda.empty_cache()
    eval_launches = run_slice()

    from semivl_tpu_torch.configs import flagship_train_cfg
    cfg = flagship_train_cfg(512)
    t0 = time.perf_counter()
    bundle = scaled_bundle(cfg)
    batch = train_batch(torch.Generator(device='cuda').manual_seed(2))
    prms = list(bundle.model.parameters())
    log(f'train: built the training bundle in {time.perf_counter() - t0:.1f}'
        f' s, {sum(p.numel() for p in prms) / 1e6:.1f} M params, '
        f'{sum(p.numel() for p in prms if p.requires_grad) / 1e6:.1f} M '
        'trainable')
    step_err = compare_step(cfg, bundle, batch)
    tmp = tempfile.TemporaryDirectory()
    overrides = save_trained_weights(bundle,
                                     os.path.join(tmp.name, 'weights.npz'))
    step, launches, _ = run_train(cfg, bundle, batch)
    profile_step(step, batch)
    del bundle, batch, prms, step
    torch.cuda.empty_cache()

    cs_eval_launches, cs_eval = run_cityscapes_eval()
    torch.cuda.empty_cache()
    cs_err, cs_launches, cs_train = run_cityscapes_train()
    log(f'cityscapes: evaluation {json.dumps(cs_eval)}; training '
        f'{json.dumps(cs_train)}')
    torch.cuda.empty_cache()

    tiny_err, tiny_launches, tiny_eval_launches, tiny_perf = run_tiny()
    log(f'tiny: {json.dumps(tiny_perf)}')
    torch.cuda.empty_cache()

    with tmp:
        paths = write_voc_dataset(os.path.join(tmp.name, 'voc'))
        trainer_launches, trainer, trainer_state = run_trainer(
            overrides, launches, tmp.name, paths)
        log(f'trainer: {json.dumps(trainer)}')
        torch.cuda.empty_cache()
        multi_launches, multi = run_multi_rank(
            overrides, launches, trainer_launches, trainer_state, tmp.name,
            paths)
        del trainer_state
        log(f'ranks: {json.dumps(multi)}')
        torch.cuda.empty_cache()
        ade_err, new_launches, new_paths = run_phase15(tmp.name, paths,
                                                       overrides)
        log(f'phase 15: {json.dumps(new_paths)}')
        torch.cuda.empty_cache()
        p16_err, p16_launches, p16_paths = run_phase16(tmp.name, paths)
        log(f'phase 16: {json.dumps(p16_paths)}')
        torch.cuda.empty_cache()
        p17_err, p17_launches, p17_paths = run_phase17(tmp.name, paths)
    log(f'phase 17: {json.dumps(p17_paths)}')
    new_launches.update(p16_launches)
    new_launches.update(p17_launches)

    keys = ('max_abs_err', 'rel_err', 'tol', 'ms', 'plain_ms', 'bound_ms',
            'bound_by', 'library_ms', 'device_ms', 'library_device_ms',
            'composed_rel_err', 'composed_tol', 'composed_control',
            'planted_forward_faults')

    def times(meas):
        return {k: meas[k] for k in keys if k in meas}

    def row(name, source, replaces, count, meas, shape, step_rel_err,
            **extra):
        return dict(name=name, route='cuda',
                    source=f'semivl_tpu_torch/csrc/{source}',
                    replaces=replaces, launches=count, shape=shape,
                    step_rel_err=step_rel_err, **times(meas), **extra)

    eval_keys = {'attention_fwd': 'attention', 'heads_fwd': 'heads',
                 'decoder_fwd': 'decoder'}

    def paths(key, flagship_eval=None, cityscapes_eval=None, tiny_eval=None):
        # phase 15's, 16's and 17's paths: steps and CLIs count every
        # kernel, evaluations the forward ones
        new = {name: (counts.get(eval_keys.get(key)) if 'eval_image' in name
                      else counts[key])
               for name, counts in new_launches.items()}
        return dict(launches_by_path=dict(
            flagship_eval=flagship_eval, flagship_train_step=launches[key],
            cityscapes_eval_image=cityscapes_eval,
            cityscapes_train_step=cs_launches[key], tiny_eval=tiny_eval,
            tiny_train_step=tiny_launches[key],
            trainer_cli_two_steps_and_eval=trainer_launches[key],
            trainer_cli_nccl_world1=multi_launches['nccl_world1'][key],
            trainer_cli_two_gloo_ranks_per_rank=[
                r[key] for r in multi_launches['gloo_two_ranks_voc']],
            cityscapes_step_two_gloo_ranks_per_rank=[
                r[key] for r in multi_launches['gloo_two_ranks_cityscapes']],
            **new))

    def worst(key):
        return max(step_err[key][0], cs_err[key][0], ade_err[key][0],
                   p16_err['zegclip'][key][0], p16_err['concept'][key][0],
                   p17_err['supervised'][key][0],
                   p17_err['unimatch'][key][0])

    kernels = [
        row('packed_attention_fwd', 'flash_attention.cu',
            'semivl_tpu/ops/flash_attention.py:328',
            cs_launches['attention_fwd'], attn['cityscapes encoder'],
            '(2, 2602, 768) 12 heads (801^2 crops); launches per Cityscapes '
            'training step', worst('attention_fwd'),
            flagship_1025=times(attn['encoder']),
            cityscapes_edge_869=times(attn['cityscapes edge crop']),
            semantic_l81=times(attn['semantic L=81']),
            semantic_l150=times(attn['semantic L=150']),
            timm_encoder_4x1025=times(attn['timm encoder']),
            zegclip_encoder_4x1035=times(attn['zegclip encoder']),
            **paths('attention_fwd', eval_launches['attention'],
                    cs_eval_launches['attention'])),
        row('packed_attention_bwd', 'flash_attention_heads.cu',
            'semivl_tpu/ops/flash_attention.py:368',
            cs_launches['attention_bwd'], attn_bwd['cityscapes encoder'],
            '(2, 2602, 768) 12 heads; launches per Cityscapes training step',
            worst('attention_bwd'), flagship_1025=times(attn_bwd['encoder']),
            semantic_l81=times(attn_bwd['semantic L=81']),
            semantic_l150=times(attn_bwd['semantic L=150']),
            zegclip_encoder_4x1035=times(attn_bwd['zegclip encoder']),
            **paths('attention_bwd')),
        row('decoder_stage_fwd', 'fused_decoder.cu',
            'semivl_tpu/ops/fused_decoder.py:459', cs_launches['decoder_fwd'],
            dec_cs, 'fused_vlg_decoder call (2 stage launches), P=57 at '
            '51x51; library: cuDNN\'s chain; launches per Cityscapes '
            'training step', worst('decoder_fwd'),
            products='semivl_tpu_torch/csrc/decoder_igemm.cuh',
            planted_faults=dec_cs['planted_faults'],
            flagship_p42_32x32=times(dec), voc_step_p126_32x32=times(dec_voc),
            cityscapes_edge_p19_31x28=times(dec_edge),
            ade_step_p450_32x32=times(dec_ade),
            wide_widths=wide,
            **paths('decoder_fwd', eval_launches['decoder'],
                    cs_eval_launches['decoder'])),
        row('decoder_stage_bwd_tail', 'fused_decoder_bwd.cu',
            'semivl_tpu/ops/fused_decoder.py:534',
            launches['decoder_bwd_tail'], dec_tail,
            'both stages at P=126 (ms); plain/library ms are the whole '
            'decoder backward; launches per flagship training step (0 on '
            'the Cityscapes banded route)', max(
                step_err['decoder_bwd'][0], ade_err['decoder_bwd'][0],
                p16_err['concept']['decoder_bwd'][0],
                p17_err['supervised']['decoder_bwd'][0],
                p17_err['unimatch']['decoder_bwd'][0]),
            products='semivl_tpu_torch/csrc/decoder_igemm.cuh',
            whole_bwd_ms=dec_tail['whole_bwd_ms'],
            whole_bwd_device_ms=dec_tail['whole_bwd_device_ms'],
            ade_p450=times(ade_tail),
            **paths('decoder_bwd_tail')),
        row('decoder_stage_bwd_input', 'fused_decoder_bwd.cu',
            'semivl_tpu/ops/fused_decoder.py:728',
            launches['decoder_bwd_input'], dec_input,
            'both stages at P=126 (ms); plain/library ms are the whole '
            'decoder backward; launches per flagship training step (0 on '
            'the Cityscapes banded route)', max(
                step_err['decoder_bwd'][0], ade_err['decoder_bwd'][0],
                p16_err['concept']['decoder_bwd'][0],
                p17_err['supervised']['decoder_bwd'][0],
                p17_err['unimatch']['decoder_bwd'][0]),
            products='semivl_tpu_torch/csrc/decoder_igemm.cuh',
            whole_bwd_ms=dec_input['whole_bwd_ms'],
            whole_bwd_device_ms=dec_input['whole_bwd_device_ms'],
            ade_p450=times(ade_input),
            **paths('decoder_bwd_input')),
    ]
    for k, line in (('A', 168), ('B', 318), ('C', 414)):
        key = f'banded_pass_{k.lower()}'
        kernels.append(row(
            key, 'fused_decoder_banded.cu',
            f'semivl_tpu/ops/fused_decoder_banded.py:{line}',
            cs_launches[key], banded[k],
            'both stages at P=57, 51x51 base (ms, plain_ms: this pass); '
            'library_ms: the library\'s convolutions for this pass\'s work '
            '(library_is); launches per Cityscapes training step',
            cs_err['decoder_banded'][0],
            products='semivl_tpu_torch/csrc/decoder_igemm.cuh',
            **{x: banded[k][x] for x in (
                'library_is', 'composed_rel_err_vs_rounded', 'banded_bwd_ms',
                'whole_plane_bwd_ms', 'plain_bwd_ms',
                'chain_library_bwd_ms')},
            **paths(key)))
    for i, (key, line) in enumerate((('heads_fwd', 61), ('heads_bwd', 133))):
        kernels.insert(i, row(
            f'heads_attention_{key[6:]}', 'flash_attention_heads.cu',
            f'semivl_tpu/ops/flash_attention.py:{line}', tiny_launches[key],
            heads['tiny ViT 4x16'][i], '(2, 17, 64) 4 heads of 16 (the tiny '
            'ViT); launches per tiny training step (tiny_eval: the whole '
            'evaluation)', tiny_err[key][0],
            cases={name: times(r[i]) for name, r in heads.items()},
            **paths(key, eval_launches['heads'] if i == 0 else None,
                    cs_eval_launches['heads'] if i == 0 else None,
                    tiny_eval_launches['heads'] if i == 0 else None)))
    kernels.append(row(
        'fused_up_stage', 'fused_decoder.cu',
        'semivl_tpu/ops/fused_up.py:129',
        up_launches, up_rows['up1'], 'up1 x (294, 128, 32, 32) skip (14, 32, '
        '64, 64) Cout 64; launches over one run of tools/fused_up_bench.py '
        '(both stages); no model routes to it', None,
        products='semivl_tpu_torch/csrc/decoder_igemm.cuh',
        cases={name: times(r) for name, r in up_rows.items()},
        bench=bench_rows, launches_by_path=dict(fused_up_bench=up_launches)))
    log(f'run: phases 1-17 in {time.perf_counter() - t_run:.1f} s')
    log(json.dumps({'kernels': kernels}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
