#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's student frame, teacher poser, both students' training, distillation to a character model, the verification slice (the int8 teacher, tha4-torch-verify, tha4-torch-eval), data-parallel distillation, the block zoo, native codec and native mocap receiver, and the A/B and run-report tools on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card (``nvidia-smi`` name and power limit) and the versions;
2. build: the kernels of ``tha4_tpu_torch/csrc`` from source, with the
   seconds taken and nvcc's register / spill report per kernel;
3. K1 (``sine_chain_t``) against its plain PyTorch version at the four call
   shapes of one frame, f32 and bf16, with max-abs error, median times, the
   restated bound (the products at the peak for their type against the
   fast_sin epilogue on the CUDA cores, each printed) and its share
   (``python3 chip_smoke.py --phase k1`` runs it alone after phases 1-2);
4. K2 (``grid_sample_fast``) against its plain version at 512^2 x 4, f32 and
   bf16, on a smooth grid and on one with displacements past 150 px, timed
   two ways beside ``F.grid_sample``: the card's own time (a CUDA graph of
   20 calls) and 200 calls back to back (the host's rate where the wrapper
   is slower than the kernel); then at the body
   path's teacher warps, B = 8 at 128^2, 192^2, 256^2 and 512^2, f32 and
   bf16, smooth and far grids (512^2 also timed);
5. the main path: a seeded random-init character model at full width
   (written to a temporary directory), loaded through
   ``CharacterModel.load(...).get_poser(...)``, answers 8 pose requests in
   bf16 and in f32.  All six outputs must be finite; K1 must launch 4 times
   and K2 once per frame; the f32 frame must match the same model's plain
   run on the CPU; the bf16 frame must be within 28 dB PSNR of the f32 one;
   the headless CLI must write a PNG; ms/frame at batch 1 is printed;
   then the serving slice on the same model: the frame bench
   (``python -m tha4_tpu_torch.tools.bench``: its CUDA-graph scalar equal
   to its eager scalar bit for bit, 400 K1 and 100 K2 launches at capture),
   the puppeteer as a user runs it (``python -m
   tha4_tpu_torch.apps.puppeteer --benchmark``: the iFacialMocap trace in
   f32 writing one PNG a rendered frame, the mediapipe trace in bf16 with
   ``--calibrate-head --save-calibration``, 300 synthetic bf16 frames; 4
   K1 and 1 K2 launches a frame in each process), the f32 frames of the first 4 replayed poses against the CPU
   and the bf16 ones against them (``utils.fidelity`` PSNR >= 28 dB, SSIM),
   the first PNG equal to ``encode_display_u8`` of the same frame made in
   this process, and the ``--web`` puppeteer and the student web poser on
   ephemeral ports (4 K1 and 1 K2 launches a request); its seconds printed;
6. K4 (``sine_chain_t_bwd``) against its plain version at the face
   student's training shape (N = 8, 128^2) and at body level 1 (N = 1,
   256^2, with prev), f32 and bf16: every gradient within its bar, two
   calls bit-identical, median times, the restated bound and its share;
7. the training path: a seeded full-width random mode_12 teacher and the
   synthetic character, mask and ``DistillerConfig`` (written to a
   temporary directory) train the face student through
   ``DistillationJobs(...).make_face_trainer().train()`` in bf16 at batch
   8 for 32 steps, across two checkpoint boundaries.  Losses must be
   finite; each step must launch K1, K4 once and K2 twice; the checkpoints
   must load; resuming from the first must reproduce the run; the f32
   student gradients on the card (K1 + K4) must match the plain backward
   on the CPU for the same loss cotangent; ms/step at batch 8 in bf16 and
   f32 is printed, split into teacher, student and Adam;
8. K3, the differentiable warp, at the body student's head warp, (8,
   512^2, 4) f32 and bf16, smooth and far (> 150 px) grids: its forward
   (``grid_sample_train_forward``, K2's kernel) equal to K2 bit for bit,
   its grid backward (``grid_sample_grid_backward``) against its plain
   version, two calls and the autograd path bit-identical; the card's own
   times (CUDA graphs) of the forward, the backward and the pair beside
   ``F.grid_sample`` and ``aten.grid_sampler_2d_backward`` (grid only), the
   pair back to back directly and through autograd beside ``F.grid_sample``
   forward + grid backward through autograd, and the pair's bound and share;
9. K5 (``poly_sin`` forward and backward) at the body student's widest
   layer, (8, 512^2, 90), f32 -> bf16 (the mixed path), bf16 and f32;
10. the body teacher: a seeded full-width random mode_07 (zero-init layers
    brought to life by ``random_teacher_07``) at B = 1, 4 (the body sample
    grid's render) and 8, bf16 and f32:
    33 finite outputs of the expected shapes through exactly 5 K2, 102 K6
    and 102 fold launches a call, and every device launch of a call counted
    by ``torch.profiler``; K6 against its plain version at every size those
    calls gave it, f32 and bf16 (the deep levels on the split grid among them);
    the f32 card outputs at B = 1 against the same teacher's plain
    CPU run and its f64 run on the CPU (the exact answer, which says which
    f32 side is off), and each U-Net alone on the CPU run's inputs, with
    the bf16 teacher's distance from f64 beside each bar (it must fail
    them); ms per call and the convolutions' multiply-adds (cuDNN's and K6's);
11. the body-training path: ``DistillationJobs(...).make_body_trainer(
    phases).train()`` with the default six phases scaled to 32 steps at
    batch 8, bf16 with the selective-f32 student, across two checkpoint
    boundaries.  Losses must be finite; each step must launch K2 five
    times, K3's forward and its grid backward once each, each poly_sin
    kernel 9 times, K6 102 times (the teacher's U-Nets), K1 and K4 never;
    resuming
    from checkpoint 1 must reproduce the run; the f32 student gradients on
    the card must match the plain backward on the CPU for the same labels
    and poses, split at the head output (the trunk on the card's head
    cotangent; the head, K3 and the loss on the card's head output), and
    end to end once the pixels where the loss is not smooth between the two
    devices (a texel edge or an L1 kink crossed) are dropped, with the
    head's grid-change rows and every level nonzero; ms/step at batch 8 in
    bf16 mixed and f32, split into teacher, student and Adam;
12. K6 (``fused_affine_conv3_nchw``, the U-Nets' GroupNorm/FiLM/SiLU + conv3
    + skip) and its fold (``fold_groupnorm_film``) against their plain
    versions at the five costliest shapes of the teacher's U-Nets at B = 8,
    f32 and bf16: error over max |plain|, two calls bit-identical, device
    times beside ``F.conv2d`` alone (channels last, cuDNN) and the share of
    the bound, K6 after its fold beside ``F.group_norm`` then ``F.conv2d``;
    a CUDA input that needs a gradient is refused;
13. the teacher poser: the five seeded full-width random mode_07 state
    dicts written as ``.pt`` files drive the ``tha4-torch-pose`` CLI
    (``python -m tha4_tpu_torch.apps.full_manual_poser``) in f32, in bf16
    and in a 3-frame bf16 sweep, each writing its PNGs; then
    ``mode_07.create_poser(module_file_names=...)`` poses one image 4 times
    in bf16 and in f32: the eyebrow decomposer runs once (the prologue
    cache), every call launches K6 102 times and K2 5 times, the f32
    outputs equal ``mode_07.compute_outputs`` of the same teacher on the
    card in cuDNN's deterministic mode (two calls in its default mode are
    compared too: some of its f32 algorithms are not deterministic), ms per
    pose at B = 1 is printed; ``mode_12.create_poser`` gives its 22 outputs;
    then the web poser's ``--teacher`` handler on the same files, in this
    process: /meta and /pose.png, 102 K6, 102 fold and 5 K2 launches a
    request;
14. distillation to a character model through ``pipeline.run_config``
    (the ``tha4-torch-distill`` command's callee), at full width, bf16
    teacher and selective-f32 body student, both sample cadences at 10 000,
    16 steps a student at batch 8 and a checkpoint every 8, cuDNN
    deterministic: the face target (16 face steps and its sample grid at 0),
    then ``all`` (the face tasks up to date, 16 body steps, its grid at 0,
    both exports, the character PNG and yaml), each with its exact launch
    counts; a rerun that launches nothing and leaves every file's mtime;
    the body's last checkpoint and ``body_morpher.pt`` deleted and rerun,
    once with the snapshot at the end kept (no step) and once without it
    (resumed from checkpoint 1, 8 steps), each ``.pt`` equal to the first
    bit for bit; the grids' sizes and the TensorBoard events against the
    JSONL rows; the written model posed through
    ``CharacterModel.load(...).get_poser(...)`` in f32 and bf16 (4 K1 and
    1 K2 a frame), f32 equal bit for bit to a poser from the last
    checkpoints' ``.npz`` files, bf16 >= 28 dB; ms/step through the DAG,
    the sample grids' and renders' ms and an export's;
15. the verification slice (``python3 chip_smoke.py --phase int8`` runs it
    alone after phases 1-2, making its own preconditions): Q1
    (``int8_conv``, the int8 teacher's conv) against its plain version bit
    for bit, and two calls against each other, at every (dtype, signature)
    of the full-width mode_07 at B = 8 and of mode_12, bf16 and f32, each
    timed beside cuDNN's conv of the same shape and Q1's bound, with its
    convs a call and Q1's total a teacher call; the costliest also beside
    ``torch._int_mm`` on an im2col and the plain version; the int8
    teacher's body labels (outputs 0, 2, 3, 5) against bf16 and f32 (label
    PSNR, grid-change L1) and its time a call against bf16, split into Q1
    and the rest;
    ``pipeline.run_config`` with ``teacher_int8`` (``tha4-torch-distill
    --teacher-int8``), 8 steps a student, beside the same run without it:
    Q1 launched once per eligible conv per teacher call and K6 never, both
    scales files written; ``tha4-torch-verify`` on a full-width bundle it
    writes (five damped random teacher ``.pt`` files, a pose dataset, a
    synthetic character and mask, a random character model; no reference
    source): exit 0, steps 2 and 5 ``skip``, the rest ``ok``; and
    ``tha4-torch-eval --against`` between two random character models, f32
    and bf16;
16. data-parallel distillation (``python3 chip_smoke.py --phase ddp`` runs
    it alone after phases 1-2; the ranks are spawned processes that load
    the parent's build): (a) two gloo ranks sharing the card train both
    shipped students against the full-width random teachers, 4 steps each
    at batch 8 (4 a rank, teacher lookahead K = 2), bf16 and f32, through
    ``DistillationJobs``' trainers: the ranks' parameters bit-equal, the
    one-process run (K = 1) matched at the stated bars, each rank's exact
    launches and ms a step (two ranks sharing one card: not a scaling
    figure); (b) one NCCL rank: its DDP face and body steps equal the plain
    steps bit for bit (f32, cuDNN deterministic); (c) ``run_config`` with
    ``num_gpus: 2`` and no ranks warns and exports the ``num_gpus: 1``
    run's ``.pt`` files bit for bit, and two gloo ranks through
    ``run_config`` write each checkpoint and export once (rank 0), and a
    run stopped at the body's snapshot and rerun exports the same ``.pt``
    files bit for bit.  NCCL across several GPUs needs more than one card
    and is not checked here;
17. the rest of the JAX package's twins (``python3 chip_smoke.py --phase
    rest`` runs it alone after phases 1-2): (a) the block zoo at the face
    morpher's published widths (192^2, 4 -> 64 channels, bottleneck 24^2
    with 6 resnet blocks, max 512), batch 8: ``ResizeConvEncoderDecoder``
    and ``ResizeConvUNet`` (instance norm with spectral norm on and off, and
    separable with spectral norm), both upsample modes; f32 on the card
    against the same module on the CPU (TF32 off), bf16 against f32, the
    ``sn_u`` vectors after three ``advance_spectral`` steps against the
    CPU's; ms a forward and a forward + backward + Adam step, peak memory;
    (b) a 512^2 RGBA ``load_image_hwc``, the native codec against numpy,
    ms each; (c) the iFacialMocap receiver, native and socket, fed by a
    loopback sender at 240 packets/s, read between bf16 student frames for
    300 frames: each packet's age when read (p50, p99) and the share of
    reads that got the newest packet sent; then ``tha4-torch-puppeteer
    --source udp`` fed by that sender, exit 0 on the native drain thread;
18. the tools slice (``python3 chip_smoke.py --phase tools`` runs it alone
    after phases 1-2), at full width, batch 8, cuDNN deterministic: one
    bf16 selective-f32 body step with ``teacher_dtype`` omitted, set to
    bf16, and as the recipe made it before ``teacher_dtype``, bit-equal;
    (a) ``python -m tha4_tpu_torch.tools.dtype_ab``, one call an arm (bf16,
    f32, bf16t+f32s, mixed), 32 steps and 64 eval poses each, merged into
    one JSON: the same pose stream (its sha256) in every arm, finite losses
    and evals, each arm's exact launches (K2, K3's pair, K5's pair, K6 and
    its fold; K1, K4 and Q1 never); (b) ``tools.quant_ab``, bf16 then int8,
    16 steps each, merged: Q1 a whole number of launches a step in the int8
    arm and none in the bf16 arm, K6 only in the f32 evaluation there, the
    delta int8 - bf16; (c) a body-only ``pipeline.run_config``
    with ``--random-teacher``'s teacher, 16 steps and two checkpoints, its
    launches exact; ``tools.run_report`` on its prefix (the examples and
    segments of its log) and ``tools.eval_body_checkpoint --export``
    (checkpoint 2, equal to ``tools.body_eval`` on the trainer's own module
    to f32 rounding, the exported ``.pt`` loaded into ``SirenMorpher`` equal
    to the checkpoint); each arm's evaluation and ms a step, and the
    phase's seconds;
19. R1 (``ops.cuda_resize``, the bilinear resize; ``python3 chip_smoke.py
    --phase resize`` runs it alone after phases 1-2) at the f32 frame's two
    level upsamples (NCHW, B = 1) and the body student's two training
    levels (NHWC bf16, B = 8, forward and adjoint): equal to its plain
    version bit for bit, the adjoint within its bar of the plain gradient
    and deterministic; the card's own times beside the bytes' bound, the
    port's dense interpolation-matrix GEMMs (its resize before R1, kept
    here as the baseline) and ``F.interpolate(mode="bilinear",
    align_corners=False)`` for reference.

The line before the last is a JSON object with one entry per kernel (K1,
K2, K3's forward and grid backward, K4-K6, the fold, Q1, R1, and K7 and the TPU
probe ``tools/warp_probe.py`` under their counterparts K6 and K2), each
with its bound: the larger of the bytes it
must move over 3.35 TB/s and its multiply-adds over the card's peak for
their type (989 TFLOP/s bf16, 67 TFLOP/s f32, 1979 TOP/s int8; the H100 SXM data sheet); the
last is
``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero without printing that line; so does a machine without
CUDA, and a directory without the rest of the repository.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
FRAMES = 8

# Bars.  f32: the precedent of tests/test_pallas_siren.py:54 (two valid f32
# summation orders through omega=30 sine layers).  bf16: kernel and plain
# version take the same bf16 operands with exact f32 products and f32 sums;
# only the order of the sums differs, and that moves a stored bf16
# activation by one step (2^-8 relative) now and then, which the next
# layers carry on.  So at most 4 bf16 steps at the output's scale.
K1_F32_ATOL = 1e-4
K1_BF16_STEPS = 4
# K2 computes the same f32 lerp in the same order as its plain version; the
# only rounding after it is the cast to the image dtype.
K2_F32_ATOL = 1e-5
K2_BF16_ATOL = 2.0**-7  # one bf16 step at |x| < 2 (images lie in [-1, 1])
# Card f32 frame vs CPU plain frame: tests/test_mode_14_parity.py:79-92,127-135.
FRAME_F32_ATOL = {"blended": 2e-3, "alpha": 2e-4, "color_change": 2e-4, "warped": 2e-3, "grid_change": 2e-4, "face": 2e-4}
FRAME_F32_MIN_PSNR = 60.0
BF16_MIN_PSNR = 28.0  # tests/test_mode_14_parity.py:166
# K4, each gradient over its largest magnitude.  f32: the omega = 30 bar of
# tests/test_pallas_siren.py:58-93.  bf16: four bf16 steps, since a sum
# order that flips one stored bf16 activation or g_a by a step (2^-8
# relative) moves the gradient entries it feeds by about that much.
K4_F32_ATOL = 1e-4
K4_BF16_ATOL = 4 * 2.0**-8
# The f32 training step on the card (K1 + K4) against the plain backward
# on the CPU, same cotangent: tests/test_pallas_siren.py:95-121, the bar
# for real level shapes at omega = 30.
STEP_F32_ATOL = 1e-3
# The body student's f32 gradients end to end, once the pixels where the
# loss is not smooth between the two devices' head outputs are dropped, the
# card against the CPU's whole backward at the card's head output: ten times
# the trunk's 1.4e-6 on the same cotangent, where the whole loss reads 1.1e-3.
STEP_MASKED_ATOL = 1e-5
# What the two head outputs' difference alone moves in those gradients,
# measured on the CPU (its backward at the card's head output against at its
# own): three times the largest reading, 1.6e-5, on NVIDIA H100s.  The head
# outputs differ by f32 rounding in the trunk's forward, and the smooth
# pixels' bilinear grid derivative moves with the sample point (1e-6 in a
# normalised grid point is 2.6e-4 px at 512^2).
STEP_DRIFT_ATOL = 5e-5
# Resume from checkpoint 1 against the uninterrupted run.  Bit-equal is
# expected (K1, K2 and K4 are deterministic, so are cuDNN's forward convs);
# the bar leaves room for a teacher conv whose sum order varied, which
# would move a label by a bf16 step and an Adam step by a fraction of lr.
RESUME_ATOL = 1e-6
# K3: its forward is K2's kernel (K2's bars); dgrid, the grid backward
# against its plain version (the corners regathered, the channel sums in
# another order), over its largest, tests/test_pallas_warp.py:44-60.
K3_DGRID_ATOL = 2e-5
# K5: the same f32 operations, none contracted, then one rounding.
K5_F32_ATOL = 1e-6
K5_BF16_ATOL = 2.0**-8  # one bf16 step at |x| <= 1
# mode_07 f32 on the card against its plain run on the CPU, and each of
# them against the same teacher's f64 run on the CPU, the exact answer for
# these f32 weights and inputs.  Readings on an H100 (card f32 | CPU f32 |
# card bf16, each against f64): the random full-width mode_12 networks carry
# both f32 runs equally far, face_morphed_full 6.2e-4 | 6.6e-4 | 1.5; the
# upscaler warps that across the hard edge of the pasted face square, posed
# 1.1e-3 | 1.9e-3 | 0.91; grid change 9.2e-6 | 1.4e-5 | 3.0e-2.  The card
# vs CPU bars: the grid change's is the body morpher's and upscaler's bar
# (tests/test_teacher_nets.py:293,335, 1e-4) doubled for the cascade; the
# others are the 2e-3 / 3e-3 of tests/test_torch_body_teacher.py, since the
# CPU's own f32 error reaches 6.6e-4 / 1.9e-3.  Against f64, twice the
# card's reading rounded up, where bf16 fails by 10^3.  Every one of the 33
# outputs must clear 70 dB PSNR card against CPU (that test's floor) and be
# no further from f64 than the CPU's f32 run, within TEACHER_EXACT_RATIO
# (read: 1.34x at most); tests/test_torch_body_teacher.py holds the port
# so against the JAX package at 1.5x.
TEACHER_F32_ATOL = {"posed": 3e-3, "grid_change": 2e-4, "face_morphed_full": 2e-3}
TEACHER_F32_MIN_PSNR = 70.0
TEACHER_EXACT_ATOL = {"posed": 3e-3, "grid_change": 2e-5, "face_morphed_full": 2e-3}
TEACHER_EXACT_RATIO = 2.0
# Each U-Net alone on the CPU f32 run's inputs.  Card vs CPU, at those bars
# doubled: all of the body morpher's outputs, and the upscaler's alpha and
# grid change.  Against f64, all ten outputs, the upscaler's RGBA images
# too: the card reads 1.7e-6 (direct) to 2.7e-5 (warped), the CPU's f32
# 5.2e-4 / 2.9e-3 (it is the side that is off), bf16 2.4e-2 / 0.12; no
# bf16 output passes the bar.
UNET_F32_ATOL = 2e-4
UNET_EXACT_ATOL = 1e-4
UNET_OUTPUT_NAMES = ("merged", "alpha", "warped", "grid_change", "direct")
# K6 against its plain version, max-abs error over max |plain|.  f32: FMA
# sums in another order than cuDNN's over 9 * Cin terms (~1e-6 read);
# bf16: the same bf16 operands with f32 sums in another order, and one
# rounding of the output (2^-9).
K6_F32_REL = 1e-4
K6_BF16_REL = 1e-2
# The fold's CUDA path against its plain version, each of scale and shift
# over its largest: the same f32 arithmetic, the statistics summed in
# another order.
FOLD_REL = 1e-5
# The five costliest K6 shapes of the teacher's U-Nets at B = 8: (name, H =
# W, Cin, Cout, skip: "identity", the 1x1 skip's Cs, or None).
K6_SHAPES = [
    ("512^2 32->32 +identity", 512, 32, 32, "identity"),
    ("512^2 96->32", 512, 96, 32, None),
    ("512^2 32->32 +1x1(96)", 512, 32, 32, 96),
    ("512^2 64->64 +identity", 512, 64, 64, "identity"),
    ("256^2 64->64 +identity", 256, 64, 64, "identity"),
]
K6_MAIN_SHAPE = "512^2 64->64 +identity"  # the kernels line's ms
K6_PER_TEACHER_CALL = 55 + 47  # upscaler + body morpher U-Nets
_K6_SKIP_CONV = 2  # K6's skip modes: 0 none, 1 identity, 2 a 1x1 conv
# mode_07.create_poser's f32 outputs against compute_outputs of the same
# frozen teacher: the same kernels on the same inputs, with cuDNN in its
# deterministic mode (read: bit-equal; 3.1e-4 apart in its default mode).
POSER_F32_ATOL = 1e-6
POSES = 4
# The frame bench (tha4_tpu_torch/tools/bench.py): its metric and frames.
SERVING_METRIC = "student_512x512_frames_per_sec_per_chip"
BENCH_FRAMES = 100
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): the bounds' rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# The CUDA cores' f32 instruction rate: the 67 TFLOP/s count an FMA as two.
CUDA_CORE_OPS_PER_S = PEAK_FLOPS["f32"] / 2
# f32 operations of one sine layer output (csrc/common.cuh fast_sin; the _rn
# intrinsics keep every multiply and add its own instruction): the bias add,
# the omega multiply, the reduction (6), r^2, the polynomial (10) and its
# last multiply; fast_cos adds one.
SIN_OPS = 20
COS_OPS = SIN_OPS + 1
# The keys every entry of the kernels line has.
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
TRAIN_STEPS = 32
TRAIN_BATCH = 8
DISTILL_STEPS = 16  # phase_distill: steps a student, a checkpoint every half
OUTPUT_NAMES = ["blended", "alpha", "color_change", "warped", "grid_change", "face"]


def _psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return math.inf if mse == 0.0 else 10.0 * math.log10(4.0 / mse)  # signal range [-1, 1]


def _time_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, one pair of CUDA events per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int = 200, warmup: int = 5) -> float:
    """Device time of ``fn`` in ms: one pair of CUDA events around ``reps``
    back-to-back calls, divided by ``reps``.  The host enqueues ahead of the
    card, so a short kernel's Python and launch cost stays outside the
    window, unless the host is slower than the card (then this is the host's
    rate, which is what a caller would get)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, calls: int = 20, reps: int = 20) -> float:
    """The card's own time for one ``fn()``: ``calls`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between one pair of
    events.  No host work is inside the window, so a kernel of a few
    microseconds is timed, not the Python and launch cost around it."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _device_ms(graph.replay, reps=reps, warmup=2) / calls


def _bound(nbytes: float, flops: float, tag: str) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for their type, whichever is larger."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[tag] * 1e3
    return {"bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _chain_macs(chain, n: int, hw: int) -> int:
    """Multiply-adds of one pass of a packed chain over n x hw pixels."""
    return sum(int(ci) * int(co) for ci, co, _, _ in chain.specs) * n * hw


def _chain_sines(chain, n: int, hw: int) -> int:
    """The sine layers' outputs over n x hw pixels: one fast_sin each."""
    return int(chain.specs[: chain.num_sine, 1].sum()) * n * hw


def _chain_bound(nbytes: float, macs: float, sine_ops: float, tag: str) -> dict:
    """K1's and K4's bound, restated: the bytes over the memory rate, the
    products (2 x multiply-adds) over the peak for their type, and the sine
    epilogue's f32 operations over the CUDA cores' rate.  In bf16 the
    products run on the tensor cores beside the epilogue, so the larger of
    the three bounds; in f32 both run on the CUDA cores, so their sum
    against the bytes."""
    parts = {
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "products_ms": 2.0 * macs / PEAK_FLOPS[tag] * 1e3,
        "epilogue_ms": sine_ops / CUDA_CORE_OPS_PER_S * 1e3,
    }
    ops_ms = parts["products_ms"] + parts["epilogue_ms"] if tag == "f32" else max(parts["products_ms"], parts["epilogue_ms"])
    bound = max(parts["bytes_ms"], ops_ms)
    return {"bound_ms": bound, "bound_by": "bytes" if parts["bytes_ms"] >= ops_ms else "operations", **parts}


def _bound_text(b: dict) -> str:
    return (f"bound {b['bound_ms']:.4f} ms (products {b['products_ms']:.4f}, sine epilogue {b['epilogue_ms']:.4f}, "
            f"bytes {b['bytes_ms']:.4f})")


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script runs only on a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        print(line)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    return smi.splitlines()[0]


def phase_build() -> float:
    from tha4_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    so = cuda_build.build()
    cuda_build.library()
    seconds = time.perf_counter() - t0
    print(f"build: {so.name} in {seconds:.2f} s")
    log = so.with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("  nvcc: " + line.strip())
    return seconds


def _level_inputs(torch, gen, size, prev_channels, pose_dim, dtype, n: int = 1):
    """Seeded level inputs for a batch of n: prev in [-1, 1] like sine
    outputs, the identity grid, poses in [0, 1]."""
    from tha4_tpu_torch.models.siren import pos_t

    hw = size * size
    prev = None
    if prev_channels:
        prev = (torch.rand((n, prev_channels, hw), generator=gen) * 2.0 - 1.0).to("cuda", dtype)
    pose = torch.rand((n, pose_dim), generator=gen).cuda()
    return prev, pos_t(size, dtype, "cuda"), pose


def phase_k1(torch, face, body) -> dict:
    """K1 against its plain version at the frame's four calls (N = 1, timed)
    and at the batches that training and the sample grids give it: the face
    at N = 8 (the training step; its grid) and the body levels at N = 4 (the
    body grid's student), in both dtypes."""
    from tha4_tpu_torch.distiller import pipeline
    from tha4_tpu_torch.ops import cuda_siren

    gen = torch.Generator().manual_seed(SEED + 1)
    results = {"f32_err": 0.0, "bf16_err": 0.0, "ms": {}, "plain_ms": {}, "bound": {}, "calls": {}}
    face_cfg, body_cfg = face.cfg, body.cfg

    def check(name, tag, chain, prev, pos, pose) -> tuple:
        out = cuda_siren.sine_chain_t(prev, pos, pose, chain)
        ref = cuda_siren.chain_t_plain(prev, pos, pose, chain)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != pos.dtype:
            raise AssertionError(f"K1 {name} {tag}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
        err = float((out.float() - ref.float()).abs().max())
        scale = max(1.0, float(ref.float().abs().max()))
        bar = K1_F32_ATOL if pos.dtype == torch.float32 else K1_BF16_STEPS * 2.0**-8 * scale
        if not err <= bar:
            raise AssertionError(f"K1 {name} {tag}: max_abs_err {err} over the bar {bar}")
        results[f"{tag}_err"] = max(results[f"{tag}_err"], err)
        return out, err, bar

    for dtype, tag in [(torch.float32, "f32"), (torch.bfloat16, "bf16")]:
        chains = [face.pack(dtype, "cuda")] + body.pack(dtype, "cuda")
        calls = [
            ("face", chains[0], face_cfg.image_size, 0, face_cfg.pose_size),
            ("L0", chains[1], body_cfg.levels[0].image_size, 0, body_cfg.pose_size),
            ("L1", chains[2], body_cfg.levels[1].image_size, body_cfg.levels[1].intermediate_channels, body_cfg.pose_size),
            ("L2", chains[3], body_cfg.levels[2].image_size, body_cfg.levels[2].intermediate_channels, body_cfg.pose_size),
        ]
        k_total = p_total = 0.0
        nbytes = macs = sines = 0
        for name, chain, size, cp, pose_dim in calls:
            prev, pos, pose = _level_inputs(torch, gen, size, cp, pose_dim, dtype)
            out, err, bar = check(name, tag, chain, prev, pos, pose)
            call_bytes = _nbytes(prev, pos, pose, chain.w, chain.b, out)
            call_macs, call_sines = _chain_macs(chain, 1, size * size), _chain_sines(chain, 1, size * size)
            nbytes, macs, sines = nbytes + call_bytes, macs + call_macs, sines + call_sines
            k_ms = _time_ms(lambda: cuda_siren.sine_chain_t(prev, pos, pose, chain))
            p_ms = _time_ms(lambda: cuda_siren.chain_t_plain(prev, pos, pose, chain))
            k_total += k_ms
            p_total += p_ms
            bound = _chain_bound(call_bytes, call_macs, call_sines * SIN_OPS, tag)
            results["calls"][f"{name}_{tag}"] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err, **bound}
            shape = " -> ".join(str(int(c)) for c in [chain.specs[0, 0]] + list(chain.specs[:, 1]))
            print(f"K1 {name:4s} {tag:4s} {size}^2 {shape}: max_abs_err {err:.3e} (bar {bar:.1e}), "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; {_bound_text(bound)}, share {bound['bound_ms'] / k_ms:.3f}")
        for (name, chain, size, cp, pose_dim), n in zip(calls, (TRAIN_BATCH,) + (pipeline.BODY_SAMPLES,) * 3):
            _, err, bar = check(f"{name} N={n}", tag, chain, *_level_inputs(torch, gen, size, cp, pose_dim, dtype, n))
            print(f"K1 {name:4s} {tag:4s} N={n} {size}^2: max_abs_err {err:.3e} (bar {bar:.1e})")
        results["ms"][tag], results["plain_ms"][tag] = k_total, p_total
        bound = results["bound"][tag] = _chain_bound(nbytes, macs, sines * SIN_OPS, tag)
        print(f"K1 per frame {tag}: kernel {k_total:.4f} ms, plain {p_total:.4f} ms; {_bound_text(bound)}, "
              f"share {bound['bound_ms'] / k_total:.3f} ({bound['bound_by']}: {macs / 1e9:.2f} G multiply-adds, "
              f"{sines / 1e6:.1f} M fast_sin, {nbytes / 1e6:.1f} MB)")
    return results


def phase_k2(torch) -> dict:
    from tha4_tpu_torch.ops import cuda_warp, warp

    gen = torch.Generator().manual_seed(SEED + 2)
    size = 512
    identity = warp.identity_grid(size, size, "cuda")[None]
    coarse = torch.randn((1, 2, 8, 8), generator=gen)
    smooth = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    smooth = (smooth / smooth.abs().max()).permute(0, 2, 3, 1).contiguous().cuda()
    px = 2.0 / size  # one pixel in normalised units
    grids = {
        "smooth<=30px": identity + smooth * (30.0 * px),
        # A 200 px shift plus up to 50 px of variation: every sample 150-250 px away.
        "far>150px": identity + 200.0 * px + smooth * (50.0 * px),
    }
    image32 = (torch.rand((1, size, size, 4), generator=gen) * 2.0 - 1.0).cuda()
    results = {"f32_err": 0.0, "bf16_err": 0.0, "ms": {}, "plain_ms": {}, "library_ms": {}, "bound": {}, "b2b_ms": {},
               "b2b_library_ms": {}, "b8_ms": {}, "b8_library_ms": {}}
    for dtype, tag, bar in [(torch.float32, "f32", K2_F32_ATOL), (torch.bfloat16, "bf16", K2_BF16_ATOL)]:
        image = image32.to(dtype)
        for gname, grid in grids.items():
            grid = grid.contiguous()
            out = cuda_warp.grid_sample_fast(image, grid)
            ref = cuda_warp.grid_sample_bilinear_border(image, grid)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            # One PyTorch call of the same function; it takes the grid in the
            # image's dtype (cast before the clock).
            image_nchw, grid_t = image.permute(0, 3, 1, 2), grid.to(dtype)

            def kernel():
                return cuda_warp.grid_sample_fast(image, grid)

            def library():
                return torch.nn.functional.grid_sample(image_nchw, grid_t, mode="bilinear", padding_mode="border",
                                                       align_corners=False)

            k_dev, l_dev = _device_ms(kernel), _device_ms(library)
            k_graph, l_graph = _graph_ms(kernel), _graph_ms(library)
            p_ms = _time_ms(lambda: cuda_warp.grid_sample_bilinear_border(image, grid))
            print(f"K2 {tag:4s} {size}^2x4 {gname}: max_abs_err {err:.3e} (bar {bar:.1e}); the card's own time (CUDA "
                  f"graph of 20 calls) kernel {k_graph:.5f} ms, F.grid_sample {l_graph:.5f} ms; 200 calls back to back "
                  f"kernel {k_dev:.5f} ms, F.grid_sample {l_dev:.5f} ms; plain {p_ms:.4f} ms")
            if out.dtype != dtype or not err <= bar:
                raise AssertionError(f"K2 {tag} {gname}: max_abs_err {err} over the bar {bar} (dtype {out.dtype})")
            results[f"{tag}_err"] = max(results[f"{tag}_err"], err)
            if gname.startswith("smooth"):
                results["ms"][tag], results["plain_ms"][tag], results["library_ms"][tag] = k_graph, p_ms, l_graph
                results["b2b_ms"][tag], results["b2b_library_ms"][tag] = k_dev, l_dev
                # 3 lerps (a multiply and an add each) per output value.
                results["bound"][tag] = _bound(_nbytes(image, grid, out), 6.0 * out.numel(), tag)

    # The body-training path's shapes: the mode_07 teacher warps at B = 8
    # at 128^2 (combiner), 192^2 (face morpher), 256^2 (body morpher) and
    # 512^2 (upscaler, twice), in bf16, and in f32 for the f32 step.
    n = TRAIN_BATCH
    for size in (128, 192, 256, 512):
        identity = warp.identity_grid(size, size, "cuda")[None]
        coarse = torch.randn((n, 2, 8, 8), generator=gen)
        smooth = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
        smooth = (smooth / smooth.abs().max()).permute(0, 2, 3, 1).contiguous().cuda()
        px = 2.0 / size
        # The B = 1 grids scaled to the size: at 512^2 a shift of 200 px plus 50 px of variation.
        far = size * 200.0 / 512
        grids = {"smooth": identity + smooth * (30.0 * px), f"far>{far * 0.75:.0f}px": identity + far * px + smooth * (far * 0.25 * px)}
        image32 = (torch.rand((n, size, size, 4), generator=gen) * 2.0 - 1.0).cuda()
        errs = []
        for dtype, tag, bar in [(torch.float32, "f32", K2_F32_ATOL), (torch.bfloat16, "bf16", K2_BF16_ATOL)]:
            image = image32.to(dtype)
            for gname, grid in grids.items():
                grid = grid.contiguous()
                out = cuda_warp.grid_sample_fast(image, grid)
                ref = cuda_warp.grid_sample_bilinear_border(image, grid)
                err = float((out.float() - ref.float()).abs().max())
                errs.append(f"{tag} {gname} {err:.1e}")
                if out.dtype != dtype or out.shape != ref.shape or not err <= bar:
                    raise AssertionError(f"K2 N={n} {size}^2 {tag} {gname}: max_abs_err {err} over the bar {bar} ({out.dtype}, {tuple(out.shape)})")
                results[f"{tag}_err"] = max(results[f"{tag}_err"], err)
                if size == 512 and gname == "smooth":
                    image_nchw, grid_t = image.permute(0, 3, 1, 2), grid.to(dtype)
                    results["b8_ms"][tag] = _graph_ms(lambda: cuda_warp.grid_sample_fast(image, grid))
                    results["b8_library_ms"][tag] = _graph_ms(lambda: torch.nn.functional.grid_sample(
                        image_nchw, grid_t, mode="bilinear", padding_mode="border", align_corners=False))
        print(f"K2 N={n} {size}^2x4 (the body path's teacher warps): max_abs_err " + ", ".join(errs)
              + f" (bars {K2_F32_ATOL:.0e} f32, {K2_BF16_ATOL:.1e} bf16)")
    print("K2 N=8 512^2x4 smooth, the card's own time (CUDA graph of 20 calls): " + ", ".join(
        f"{tag} kernel {results['b8_ms'][tag]:.5f} ms, F.grid_sample {results['b8_library_ms'][tag]:.5f} ms"
        for tag in ("f32", "bf16")))
    return results


def phase_main_path(torch, workdir: str) -> dict:
    from tha4_tpu_torch.apps import character_model_manual_poser
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.charmodel.synthetic import FLOW_SCALE, write_random_character_model
    from tha4_tpu_torch.ops import cuda_resize, cuda_siren, cuda_warp
    from tha4_tpu_torch.tools import bench

    yaml_path = write_random_character_model(os.path.join(workdir, "model"), seed=SEED)
    model = CharacterModel.load(yaml_path)
    image = model.get_character_image()
    posers = {"bf16": model.get_poser(torch.bfloat16, "cuda"), "f32": model.get_poser(torch.float32, "cuda")}
    poses = list(bench.pose_sweep(posers["f32"].pose_parameters, FRAMES))

    cuda_siren.sine_chain_t.launches = 0
    cuda_warp.grid_sample_fast.launches = 0
    cuda_resize.bilinear_resize_forward.launches = 0
    outputs = {tag: [poser.get_posing_outputs(image, pose) for pose in poses] for tag, poser in posers.items()}
    torch.cuda.synchronize()
    launches = {"sine_chain_t": cuda_siren.sine_chain_t.launches, "grid_sample_fast": cuda_warp.grid_sample_fast.launches,
                "bilinear_resize_forward": cuda_resize.bilinear_resize_forward.launches}
    frames = FRAMES * len(posers)
    print(f"main path: {frames} frames at B=1 (bf16 and f32, {FRAMES} poses each): "
          f"K1 launches {launches['sine_chain_t']}, K2 launches {launches['grid_sample_fast']}, "
          f"R1 launches {launches['bilinear_resize_forward']}")
    if launches != {"sine_chain_t": 4 * frames, "grid_sample_fast": frames, "bilinear_resize_forward": 2 * frames}:
        raise AssertionError(f"expected {4 * frames} K1, {frames} K2 and {2 * frames} R1 launches, got {launches}")

    for tag, outs in outputs.items():
        for outs_i in outs:
            shapes = [tuple(o.shape) for o in outs_i]
            expected = [(1, 512, 512, 4), (1, 512, 512, 1), (1, 512, 512, 4), (1, 512, 512, 4), (1, 512, 512, 2), (1, 128, 128, 4)]
            if shapes != expected or any(o.device.type != "cuda" or o.dtype != torch.float32 for o in outs_i):
                raise AssertionError(f"{tag}: outputs {shapes}")
            if not all(bool(torch.isfinite(o).all()) for o in outs_i):
                raise AssertionError(f"{tag}: non-finite output")
    print("main path: all 6 outputs finite with the expected shapes, f32, on the card")

    flow_px = max(float(o[4].abs().max()) for o in outputs["f32"]) * 512 / 2.0
    print(f"main path: largest flow {flow_px:.1f} px (head grid-change rows scaled by {FLOW_SCALE})")

    cpu_poser = model.get_poser(torch.float32, "cpu")
    errs = {name: [] for name in OUTPUT_NAMES}
    psnrs = []
    for pose, card in zip(poses, outputs["f32"]):
        plain = cpu_poser.get_posing_outputs(image, pose)
        if not all(bool(torch.isfinite(o).all()) for o in plain):
            raise AssertionError("CPU plain frame: non-finite output")
        for name, a, b in zip(OUTPUT_NAMES, card, plain):
            errs[name].append(float((a.cpu() - b).abs().max()))
        psnrs.append(_psnr(card[0].cpu(), plain[0]))
    worst = {name: max(v) for name, v in errs.items()}
    min_psnr = min(psnrs)
    identical = all(v == 0.0 for v in worst.values())
    print("main path f32 card vs CPU plain: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; blended PSNR min {min_psnr:.2f} dB" + (" (bit-identical)" if identical else ""))
    for name, err in worst.items():
        if not err <= FRAME_F32_ATOL[name]:
            raise AssertionError(f"f32 card vs CPU: {name} max_abs_err {err} over {FRAME_F32_ATOL[name]}")
    if not min_psnr > FRAME_F32_MIN_PSNR:
        raise AssertionError(f"f32 card vs CPU: PSNR {min_psnr} dB")

    bf16_psnr = [_psnr(b[0], f[0]) for b, f in zip(outputs["bf16"], outputs["f32"])]
    print(f"main path bf16 vs f32 blended PSNR: min {min(bf16_psnr):.2f} dB, mean {statistics.mean(bf16_psnr):.2f} dB")
    if not min(bf16_psnr) >= BF16_MIN_PSNR:
        raise AssertionError(f"bf16 vs f32 PSNR {min(bf16_psnr)} dB under {BF16_MIN_PSNR}")

    png = os.path.join(workdir, "cli.png")
    before = (cuda_siren.sine_chain_t.launches, cuda_warp.grid_sample_fast.launches)
    rc = character_model_manual_poser.main(
        ["--model", yaml_path, "--device", "cuda", "--bf16", "--set", "eye_wink_left=1", "--set", "head_x=0.5", "--output", png]
    )
    after = (cuda_siren.sine_chain_t.launches, cuda_warp.grid_sample_fast.launches)
    if rc != 0 or not os.path.getsize(png) or (after[0] - before[0], after[1] - before[1]) != (4, 1):
        raise AssertionError(f"CLI: rc {rc}, launches {before} -> {after}")
    print(f"CLI: wrote {os.path.getsize(png)} bytes of PNG through 4 K1 and 1 K2 launches")

    image_dev = torch.from_numpy(image).cuda()
    ms = {}
    for tag, poser in posers.items():
        def frame(i=[0]):
            poser.get_posing_outputs(image_dev, poses[i[0] % FRAMES])
            i[0] += 1
        for _ in range(3):
            frame()
        torch.cuda.synchronize()
        times = []
        for _ in range(30):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000.0)
        ms[tag] = statistics.median(times)
        print(f"main path {tag}: {ms[tag]:.3f} ms/frame at B=1 (median of 30, host clock to synchronize, "
              f"image already on the card), {1000.0 / ms[tag]:.1f} frames/s")
    return {"launches": launches, "ms": ms, "yaml": yaml_path}


def _subprocess(cmd, what: str, timeout: int = 300) -> list:
    """Run one of the port's entry points as a user would; its stdout lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *cmd], cwd=root, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    print(f"{what}: rc 0 in {time.perf_counter() - t0:.1f} s")
    return proc.stdout.strip().splitlines()


def _puppeteer_run(what: str, args: list, expect: str = None) -> dict:
    """``python -m tha4_tpu_torch.apps.puppeteer --benchmark ...`` on the card:
    its benchmark line, with the rendered frames and the kernel launches of
    the process (the warm-up frame included); ``expect``, a line it must print."""
    lines = _subprocess(["tha4_tpu_torch.apps.puppeteer", *args, "--benchmark", "--device", "cuda"], what)
    if expect is not None and not any(expect in line for line in lines):
        raise AssertionError(f"{what}: no line {expect!r} in its output:\n" + "\n".join(lines))
    line = next(l for l in lines if l.startswith("frames="))
    print(f"  {line}")
    fields = re.search(r"frames=(\d+) rendered=(\d+) latency mean=([\d.]+)ms p50=([\d.]+)ms p99=([\d.]+)ms "
                       r"throughput=([\d.]+) fps \(pipeline depth 1\) on .*; launches K1 (\d+) K2 (\d+)$", line)
    if fields is None:
        raise AssertionError(f"{what}: unexpected benchmark line {line!r}")
    frames, rendered, mean, p50, p99, fps, k1, k2 = fields.groups()
    out = {"frames": int(frames), "rendered": int(rendered), "latency_mean_ms": float(mean), "latency_p50_ms": float(p50),
           "latency_p99_ms": float(p99), "fps": float(fps), "k1": int(k1), "k2": int(k2)}
    if not out["rendered"] or (out["k1"], out["k2"]) != (4 * (out["rendered"] + 1), out["rendered"] + 1):
        raise AssertionError(f"{what}: {out['rendered']} frames rendered (and 1 warm-up) through K1 {out['k1']}, "
                             f"K2 {out['k2']} launches; expected 4 and 1 a frame")
    return out


def _http_get(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as response:
        return response.read()


def _png_rgba(png: bytes, what: str) -> np.ndarray:
    import io

    import PIL.Image

    pixels = np.asarray(PIL.Image.open(io.BytesIO(png)))
    if pixels.shape != (512, 512, 4) or pixels.dtype != np.uint8:
        raise AssertionError(f"{what}: a {pixels.shape} {pixels.dtype} image, not 512^2 RGBA uint8")
    return pixels


def _serve(server):
    """Serve ``server`` on a daemon thread; returns the thread."""
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(server, *threads) -> None:
    server.shutdown()
    server.server_close()
    for thread in threads:
        thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("a server thread did not stop")


def phase_serving(torch, workdir: str, yaml_path: str) -> dict:
    """The serving slice on the card at full width: the frame bench and the
    puppeteer as subprocesses, the puppeteer's frames against the CPU and its
    PNGs, the --web puppeteer and the student web poser in-process."""
    import PIL.Image

    from tha4_tpu_torch.apps import puppeteer, web_poser
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter
    from tha4_tpu_torch.ops import cuda_siren, cuda_warp
    from tha4_tpu_torch.utils import fidelity

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    ifm_trace = os.path.join(root, "tests", "fixtures", "ifacialmocap_trace.jsonl")
    mp_trace = os.path.join(root, "tests", "fixtures", "mediapipe_trace.jsonl")
    results = {}

    lines = _subprocess(["tha4_tpu_torch.tools.bench", "--model", yaml_path], "bench (python -m tha4_tpu_torch.tools.bench)")
    detail, headline = json.loads(lines[-2]), json.loads(lines[-1])
    print(f"  {lines[-2]}\n  {lines[-1]}")
    if set(headline) != {"metric", "value", "unit", "vs_baseline", "device"} or headline["metric"] != SERVING_METRIC:
        raise AssertionError(f"bench: last line {headline}")
    if not math.isfinite(detail["graph_scalar"]) or detail["graph_scalar"] != detail["eager_scalar"]:
        raise AssertionError(f"bench: graph scalar {detail['graph_scalar']!r} != eager scalar {detail['eager_scalar']!r}")
    if detail["launches_at_capture"] != {"sine_chain_t": 4 * BENCH_FRAMES, "grid_sample_fast": BENCH_FRAMES}:
        raise AssertionError(f"bench: launches at capture {detail['launches_at_capture']}")
    results["bench"] = {**detail, "headline": headline}

    png_dir = os.path.join(workdir, "puppeteer_frames")
    calibration = os.path.join(workdir, "calibration.json")
    runs = {
        "ifacialmocap_f32": _puppeteer_run("puppeteer file:ifacialmocap f32 --output-dir", [
            "--model", yaml_path, "--source", f"file:{ifm_trace}", "--dtype", "f32", "--output-dir", png_dir]),
        "mediapipe_bf16": _puppeteer_run("puppeteer file:mediapipe bf16 --calibrate-head --save-calibration", [
            "--model", yaml_path, "--source", f"file:{mp_trace}", "--dtype", "bf16", "--calibrate-head",
            "--save-calibration", calibration]),
        "synthetic_bf16": _puppeteer_run("puppeteer synthetic bf16 300 frames", [
            "--model", yaml_path, "--source", "synthetic", "--frames", "300", "--dtype", "bf16"]),
    }
    pngs = sorted(os.listdir(png_dir))
    if len(pngs) != runs["ifacialmocap_f32"]["rendered"]:
        raise AssertionError(f"puppeteer --output-dir: {len(pngs)} PNGs for {runs['ifacialmocap_f32']['rendered']} frames")
    with open(calibration) as f:
        kind = json.load(f)["kind"]
    if kind != "MediaPipeFacePoseConverterArgs":
        raise AssertionError(f"puppeteer --save-calibration: kind {kind}")
    print(f"puppeteer: {len(pngs)} PNGs for {len(pngs)} rendered frames; the saved calibration is a {kind}")
    results["puppeteer"] = runs

    model = CharacterModel.load(yaml_path)
    image = torch.from_numpy(model.get_character_image()).cuda()
    posers = {"f32": model.get_poser(torch.float32, "cuda"), "bf16": model.get_poser(torch.bfloat16, "cuda")}
    cpu_poser = model.get_poser(torch.float32, "cpu")
    converter = IFacialMocapPoseConverter()
    poses = [np.asarray(converter.convert(b), np.float32) for b in puppeteer.file_pose_stream(ifm_trace, POSES)]
    counters = (cuda_siren.sine_chain_t, cuda_warp.grid_sample_fast)
    for c in counters:
        c.launches = 0
    card = [posers["f32"].get_posing_outputs(image, pose) for pose in poses]
    card_bf16 = [posers["bf16"].get_posing_outputs(image, pose)[0] for pose in poses]
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    if launches != {"sine_chain_t": 8 * POSES, "grid_sample_fast": 2 * POSES}:
        raise AssertionError(f"puppeteer parity: launches {launches}")
    blended = [(b[0].cpu().numpy(), f[0][0].cpu().numpy()) for b, f in zip(card_bf16, card)]
    bf16_db = [fidelity.psnr(b, f) for b, f in blended]
    bf16_ssim = [fidelity.ssim(b, f) for b, f in blended]
    print(f"puppeteer bf16 vs f32 blended frames of the first 4 replayed poses: PSNR min {min(bf16_db):.2f} dB "
          f"(bar {BF16_MIN_PSNR}), windowed SSIM min {min(bf16_ssim):.4f} (utils.fidelity)")
    if not min(bf16_db) >= BF16_MIN_PSNR:
        raise AssertionError(f"puppeteer bf16 vs f32: PSNR {min(bf16_db)} dB under {BF16_MIN_PSNR}")
    worst = {name: 0.0 for name in OUTPUT_NAMES}
    for pose, outs in zip(poses, card):
        for name, a, b in zip(OUTPUT_NAMES, outs, cpu_poser.get_posing_outputs(model.get_character_image(), pose)):
            worst[name] = max(worst[name], float((a.cpu() - b).abs().max()))
    print("puppeteer f32 frames of the first 4 replayed poses, card vs CPU plain: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    for name, err in worst.items():
        if not err <= FRAME_F32_ATOL[name]:
            raise AssertionError(f"puppeteer f32 card vs CPU: {name} {err} over {FRAME_F32_ATOL[name]}")
    written = np.asarray(PIL.Image.open(os.path.join(png_dir, "frame_000001.png")))
    encoded = imagecodec.encode_display_u8(card[0][0])[0].cpu().numpy()
    if not np.array_equal(written, encoded):
        raise AssertionError(f"puppeteer PNG frame 1 differs from encode_display_u8 of the in-process frame in "
                             f"{int((written != encoded).sum())} bytes")
    print("puppeteer: the f32 run's frame_000001.png equals encode_display_u8 of the in-process f32 card frame, byte for byte")
    results["parity"] = {"launches": launches, "max_abs_err": worst, "bf16_psnr_min": min(bf16_db),
                         "bf16_ssim_min": min(bf16_ssim)}

    stream = puppeteer.file_pose_stream(ifm_trace)
    for c in counters:
        c.launches = 0
    server, state, render = puppeteer._make_web_server(0, posers["bf16"], image, IFacialMocapPoseConverter(),
                                                       lambda: next(stream, None), False, save_dir=workdir)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    render.start()
    serve = _serve(server)
    try:
        deadline = time.time() + 120
        while not state["png"]:
            if time.time() > deadline:
                raise AssertionError("--web puppeteer: no frame within 120 s")
            time.sleep(0.05)
        frame = _png_rgba(_http_get(base + "/frame.png"), "--web puppeteer /frame.png")
        calib = json.loads(_http_get(base + "/calib"))
    finally:
        state["stop"] = True
        _stop(server, serve, render)
    torch.cuda.synchronize()
    web = {c.__name__: c.launches for c in counters}
    if calib["kind"] != "IFacialMocapPoseConverterArgs" or not web["grid_sample_fast"] or web["sine_chain_t"] != 4 * web["grid_sample_fast"]:
        raise AssertionError(f"--web puppeteer: /calib kind {calib['kind']}, launches {web}")
    print(f"--web puppeteer (bf16, the ifacialmocap trace replayed): /frame.png {frame.shape[1]}x{frame.shape[0]} RGBA, "
          f"/calib {len(calib['values'])} parameters; {web['grid_sample_fast']} frames through K1 {web['sine_chain_t']}, "
          f"K2 {web['grid_sample_fast']} launches")

    for c in counters:
        c.launches = 0
    state = web_poser._PoserState(posers["bf16"], image, posers["bf16"].pose_parameters)
    server = web_poser.ThreadingHTTPServer(("127.0.0.1", 0), web_poser._make_handler(state))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    serve = _serve(server)
    per_request = []
    try:
        meta = json.loads(_http_get(base + "/meta"))
        for pose in poses[:2]:
            before = [c.launches for c in counters]
            _png_rgba(_http_get(f"{base}/pose.png?i=0&p=" + ",".join(repr(float(v)) for v in pose)), "web poser /pose.png")
            per_request.append(tuple(c.launches - b for c, b in zip(counters, before)))
    finally:
        _stop(server, serve)
    if len(meta["params"]) != 45 or meta["output_length"] != 6 or any(r != (4, 1) for r in per_request):
        raise AssertionError(f"web poser: {len(meta['params'])} params, {meta['output_length']} outputs, "
                             f"(K1, K2) launches a request {per_request}")
    print(f"web poser (student, bf16): /meta 45 params, /pose.png 512^2 RGBA; (K1, K2) launches a request {per_request}")
    poser_launches = {c.__name__: c.launches for c in counters}
    results["launches"] = {name: launches[name] + web[name] + poser_launches[name] for name in poser_launches}
    results["seconds"] = time.perf_counter() - t0
    print(f"serving phase: {results['seconds']:.1f} s; in-process launches K1 {results['launches']['sine_chain_t']}, "
          f"K2 {results['launches']['grid_sample_fast']}")
    return results


def phase_web_teacher(torch, workdir: str) -> dict:
    """``tha4-torch-web-poser --teacher`` in-process: the five full-width
    random mode_07 ``.pt`` files that ``phase_teacher_poser`` wrote, through
    ``mode_07.create_poser`` and the web poser's handler, on the card."""
    from tha4_tpu_torch.apps import web_poser
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.ops import cuda_conv, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.tools import bench

    files = {key: os.path.join(workdir, f"{key}.pt") for key in mode_07.NETWORK_KEYS}
    poser = mode_07.create_poser(module_file_names=files, compute_dtype=torch.bfloat16, device="cuda")
    image = torch.from_numpy(imagecodec.load_image_hwc(os.path.join(workdir, "character.png"))).cuda()
    state = web_poser._PoserState(poser, image, poser.pose_parameters)
    server = web_poser.ThreadingHTTPServer(("127.0.0.1", 0), web_poser._make_handler(state))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    serve = _serve(server)
    counters = (cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film, cuda_warp.grid_sample_fast)
    for c in counters:
        c.launches = 0
    per_request = []
    try:
        meta = json.loads(_http_get(base + "/meta"))
        for pose in bench.pose_sweep(poser.pose_parameters, 2):
            before = [c.launches for c in counters]
            _png_rgba(_http_get(f"{base}/pose.png?i=0&p=" + ",".join(repr(float(v)) for v in pose)),
                      "web poser --teacher /pose.png")
            per_request.append(tuple(c.launches - b for c, b in zip(counters, before)))
    finally:
        _stop(server, serve)
    torch.cuda.synchronize()
    if len(meta["params"]) != 45 or meta["output_length"] != 33 or any(r != (K6_PER_TEACHER_CALL, K6_PER_TEACHER_CALL, 5) for r in per_request):
        raise AssertionError(f"web poser --teacher: {len(meta['params'])} params, {meta['output_length']} outputs, "
                             f"(K6, fold, K2) launches a request {per_request}")
    print(f"web poser --teacher (bf16, five .pt files): /meta 45 params and 33 outputs, /pose.png 512^2 RGBA; "
          f"(K6, fold, K2) launches a request {per_request}")
    return {c.__name__: c.launches for c in counters}


def phase_k4(torch, face, body) -> dict:
    from tha4_tpu_torch.models.siren import pos_t
    from tha4_tpu_torch.ops import cuda_siren

    gen = torch.Generator().manual_seed(SEED + 3)
    results = {"f32_err": 0.0, "f32_abs_err": 0.0, "bf16_err": 0.0, "ms": {}, "plain_ms": {}, "bound": {}, "calls": {}}
    level1 = body.cfg.levels[1]
    for dtype, tag, bar in [(torch.float32, "f32", K4_F32_ATOL), (torch.bfloat16, "bf16", K4_BF16_ATOL)]:
        cases = [
            ("face", face.pack(dtype, "cuda"), TRAIN_BATCH, face.cfg.image_size, 0),
            ("L1", body.pack(dtype, "cuda")[1], 1, level1.image_size, level1.intermediate_channels),
        ]
        for name, chain, n, size, cp in cases:
            hw = size * size
            pose_dim = int(chain.specs[0, 0]) - cp - 2
            prev = (torch.rand((n, cp, hw), generator=gen) * 2.0 - 1.0).to("cuda", dtype) if cp else None
            pos = pos_t(size, dtype, "cuda")
            pose = torch.rand((n, pose_dim), generator=gen).cuda()
            g = torch.randn((n, chain.out_channels, hw), generator=gen).to("cuda", dtype)
            args = (prev, pos, pose, chain, g)
            first = cuda_siren.sine_chain_t_bwd(*args)
            again = cuda_siren.sine_chain_t_bwd(*args)
            ref = cuda_siren.chain_t_bwd_plain(*args)
            torch.cuda.synchronize()
            errs = {}
            for gname, a, b, r in zip(["dprev", "dpose", "dW", "db"], first, again, ref):
                if r is None:
                    continue
                if not torch.equal(a, b):
                    raise AssertionError(f"K4 {name} {tag}: two calls give different {gname}")
                if a.shape != r.shape or a.dtype != r.dtype:
                    raise AssertionError(f"K4 {name} {tag} {gname}: {tuple(a.shape)} {a.dtype} vs {tuple(r.shape)} {r.dtype}")
                abs_err = float((a.float() - r.float()).abs().max())
                errs[gname] = abs_err / max(float(r.float().abs().max()), 1e-3)
                if dtype == torch.float32:
                    results["f32_abs_err"] = max(results["f32_abs_err"], abs_err)
            k_ms = _time_ms(lambda: cuda_siren.sine_chain_t_bwd(*args), iters=10)
            p_ms = _time_ms(lambda: cuda_siren.chain_t_bwd_plain(*args), iters=10)
            # Three chain products (the forward recomputed, g through each
            # layer, the weight gradients); a fast_sin and a fast_cos per
            # sine-layer output.
            bound = _chain_bound(_nbytes(prev, pos, pose, chain.w, chain.b, g, *first), 3 * _chain_macs(chain, n, hw),
                                 _chain_sines(chain, n, hw) * (SIN_OPS + COS_OPS), tag)
            shape = " -> ".join(str(int(c)) for c in [chain.specs[0, 0]] + list(chain.specs[:, 1]))
            print(f"K4 {name:4s} {tag:4s} N={n} {size}^2 {shape}: scaled err "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (bar {bar:.1e}); two calls bit-identical; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
                  + f"{_bound_text(bound)}, share {bound['bound_ms'] / k_ms:.3f}")
            worst = max(errs.values())
            if not worst <= bar:
                raise AssertionError(f"K4 {name} {tag}: scaled error {worst} over the bar {bar}")
            results[f"{tag}_err"] = max(results[f"{tag}_err"], worst)
            results["calls"][f"{name}_{tag}"] = {"ms": k_ms, "plain_ms": p_ms, "max_scaled_err": worst,
                                                 "bit_identical": True, **bound}
            if name == "face":
                results["ms"][tag], results["plain_ms"][tag], results["bound"][tag] = k_ms, p_ms, bound
    return results


def _timed_steps(torch, recipes, student, teacher, image, mask, dtype, pipelined: bool, iters: int = 20, warmup: int = 3) -> dict:
    """One training step at batch 8: host-clock ms per step over ``iters``
    steps, and the medians of its CUDA-event split into teacher labels,
    student forward + backward, and Adam.  The poses are on the card before
    the loop.  ``pipelined``: nothing waits between steps, so the host
    enqueues a step while the card runs the one before; otherwise every step
    ends in a synchronize, as the trainer's copy of each step's poses from
    pageable host memory makes it wait."""
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses

    student = copy.deepcopy(student)
    optimizer = recipes.make_adam(student)
    batches = [sample_poses(torch.Generator().manual_seed(SEED + 100 + i), TRAIN_BATCH).cuda() for i in range(warmup + iters)]
    events = []
    for i, poses in enumerate(batches):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        target = recipes.face_teacher_targets(teacher, image, poses, dtype)
        ev[1].record()
        optimizer.zero_grad(set_to_none=True)
        total, _ = recipes.face_loss(student, target, mask, poses, dtype)
        total.backward()
        ev[2].record()
        for group in optimizer.param_groups:
            group["lr"] = 1e-4
        optimizer.step()
        ev[3].record()
        if not pipelined:
            ev[3].synchronize()
        events.append(ev)
    torch.cuda.synchronize()
    out = {"step_ms": (time.perf_counter() - t0) * 1000.0 / iters}
    for j, key in enumerate(["teacher_ms", "student_ms", "adam_ms"]):
        out[key] = statistics.median(ev[j].elapsed_time(ev[j + 1]) for ev in events[warmup:])
    return out


def phase_training(torch, workdir: str) -> dict:
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.distiller.pipeline import DistillationJobs
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.ops import cuda_siren, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_12
    from tha4_tpu_torch.training import checkpoint as ckpt

    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill"), seed=SEED, batch_size=TRAIN_BATCH))
    teacher_params = mode_12.init(torch.Generator().manual_seed(SEED + 7))
    total = TRAIN_STEPS * TRAIN_BATCH

    def jobs(prefix: str) -> DistillationJobs:
        os.makedirs(prefix, exist_ok=True)
        return DistillationJobs(
            dataclasses.replace(config, prefix=prefix), teacher_params_12=teacher_params, compute_dtype=torch.bfloat16,
            device="cuda", face_total_examples=total, examples_per_checkpoint=total // 2, examples_per_snapshot=total // 4,
        )

    run = jobs(os.path.join(workdir, "run"))
    trainer = run.make_face_trainer()
    trainer.cfg.log_every_seconds = 0.0  # a log row, and so a loss to check, every step
    counters = [cuda_siren.sine_chain_t, cuda_siren.sine_chain_t_bwd, cuda_warp.grid_sample_fast]
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    n_params = sum(t.numel() for sd in teacher_params.values() for t in sd.values())
    print(f"training: face student, {TRAIN_STEPS} steps at B={TRAIN_BATCH} in bf16 through "
          f"DistillationJobs.make_face_trainer().train(), teacher mode_12 at full width ({n_params / 1e6:.1f} M params, random): "
          f"{wall:.2f} s; launches {launches}")
    expected = {"sine_chain_t": TRAIN_STEPS, "sine_chain_t_bwd": TRAIN_STEPS, "grid_sample_fast": 2 * TRAIN_STEPS}
    if launches != expected or result["examples_seen"] != total:
        raise AssertionError(f"expected {expected} launches and {total} examples, got {launches}, {result['examples_seen']}")

    prefix = trainer.cfg.prefix
    with open(os.path.join(prefix, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != TRAIN_STEPS or not all(math.isfinite(r[k]) for r in rows for k in ("full", "eye_mouth", "loss")):
        raise AssertionError(f"training: {len(rows)} log rows, or a loss that is not finite")
    print(f"training: loss {rows[0]['loss']:.5f} at step 1, {rows[-1]['loss']:.5f} at step {TRAIN_STEPS}, all finite")
    for d, seen in [(ckpt.checkpoint_dir(prefix, i), i * total // 2) for i in range(3)] + [(ckpt.snapshot_dir(prefix), total)]:
        if not ckpt.can_load(d, ["module"]) or ckpt.read_examples_seen(d) != seen:
            raise AssertionError(f"training: {d} is not a loadable state at {seen} examples")

    resumed_trainer = jobs(os.path.join(workdir, "resumed")).make_face_trainer()
    shutil.copytree(ckpt.checkpoint_dir(prefix, 1), ckpt.checkpoint_dir(resumed_trainer.cfg.prefix, 1))
    resumed = resumed_trainer.train()
    diffs = [float((a - b).abs().max()) for a, b in zip(result["module"].state_dict().values(), resumed["module"].state_dict().values())]
    print(f"training: resumed from checkpoint 1 ({total // 2} examples) to {resumed['examples_seen']}: "
          f"params max abs diff {max(diffs):.3e} (bar {RESUME_ATOL:.0e})" + (" (bit-identical)" if max(diffs) == 0.0 else ""))
    if resumed["examples_seen"] != total or not max(diffs) <= RESUME_ATOL:
        raise AssertionError("training: resume does not reproduce the uninterrupted run")

    # f32 step: K1 + K4 on the card against the plain backward on the CPU,
    # with the same params, poses, labels and loss cotangent.
    student = result["module"]
    teacher32 = mode_12.FaceTeacher.from_params(teacher_params).freeze(torch.float32, "cuda")
    image = run.character_image()
    mask = torch.from_numpy(recipes.load_face_mask_crop(run.config.face_mask_image_file_name)).cuda()
    poses = sample_poses(torch.Generator().manual_seed(SEED + 9), TRAIN_BATCH).cuda()
    target = recipes.face_teacher_targets(teacher32, image, poses, torch.float32)
    card = copy.deepcopy(student)
    pose = poses[:, : card.cfg.pose_size].float()
    pred = siren.siren_face_morpher_train_apply(card, pose, torch.float32)
    pred.retain_grad()
    loss, _ = recipes.face_loss_terms(pred, target, mask)
    loss.backward()
    s = card.cfg.image_size
    cot = pred.grad.permute(0, 3, 1, 2).reshape(TRAIN_BATCH, card.cfg.image_channels, s * s).contiguous().cpu()
    chain = copy.deepcopy(student).cpu().pack(torch.float32, "cpu")
    _, _, dw, db = cuda_siren.chain_t_bwd_plain(None, siren.pos_t(s, torch.float32, "cpu"), pose.cpu(), chain, cot)
    convs = [l.linear for l in card.siren.sine_layers] + [card.siren.last_linear]
    step_err = 0.0
    for conv, (ci, co, wo, bo) in zip(convs, chain.specs):
        for grad, ref in [(conv.weight.grad.reshape(-1), dw[wo : wo + co * ci]), (conv.bias.grad, db[bo : bo + co])]:
            step_err = max(step_err, float((grad.cpu() - ref).abs().max()) / max(float(ref.abs().max()), 1e-12))
    print(f"training: f32 student gradients, card (K1 + K4) vs CPU plain backward, same cotangent: "
          f"scaled max err {step_err:.3e} (bar {STEP_F32_ATOL:.0e})")
    if not step_err <= STEP_F32_ATOL:
        raise AssertionError(f"training: f32 card gradients {step_err} over the bar {STEP_F32_ATOL}")

    steps = {}
    teacher16 = mode_12.FaceTeacher.from_params(teacher_params).freeze(torch.bfloat16, "cuda")
    for tag, dtype, teacher in [("bf16", torch.bfloat16, teacher16), ("f32", torch.float32, teacher32)]:
        for mode, pipelined in [("synchronized", False), ("pipelined", True)]:
            t = steps[f"{tag}_{mode}"] = _timed_steps(torch, recipes, student, teacher, image, mask, dtype, pipelined)
            print(f"training step {tag} at B={TRAIN_BATCH}, {mode}: {t['step_ms']:.3f} ms/step host clock over 20 steps "
                  f"({TRAIN_BATCH * 1000.0 / t['step_ms']:.1f} examples/s); CUDA-event medians: teacher {t['teacher_ms']:.3f} ms, "
                  f"student fwd+bwd {t['student_ms']:.3f} ms, Adam {t['adam_ms']:.3f} ms")
    return {"launches": launches, "steps": steps, "step_err": step_err, "resume_diff": max(diffs), "wall_s": wall}


def phase_k3(torch) -> dict:
    """K3 at the body student's head warp, (8, 512^2, 4), f32 and bf16: its
    forward (K2's kernel, ``grid_sample_train_forward``) and its grid
    backward (``grid_sample_grid_backward``)."""
    from tha4_tpu_torch.ops import cuda_warp, warp

    gen = torch.Generator().manual_seed(SEED + 10)
    n, size = TRAIN_BATCH, 512
    identity = warp.identity_grid(size, size, "cuda")[None]
    coarse = torch.randn((n, 2, 8, 8), generator=gen)
    smooth = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    smooth = (smooth / smooth.abs().max()).permute(0, 2, 3, 1).contiguous().cuda()
    px = 2.0 / size
    grids = {"smooth<=30px": identity + smooth * (30.0 * px), "far>150px": identity + 200.0 * px + smooth * (50.0 * px)}
    image32 = (torch.rand((n, size, size, 4), generator=gen) * 2.0 - 1.0).cuda()
    g32 = torch.randn((n, size, size, 4), generator=gen).cuda()
    keys = ("fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms", "library_fwd_ms", "library_bwd_ms", "pair_ms",
            "pair_library_ms", "pair_b2b_ms", "pair_autograd_ms", "pair_library_autograd_ms", "bound_fwd", "bound_bwd")
    results = {"f32_err": 0.0, "bf16_err": 0.0, "dgrid_err": 0.0, "dgrid_abs_err": 0.0, **{k: {} for k in keys}}
    for dtype, tag, out_bar in [(torch.float32, "f32", K2_F32_ATOL), (torch.bfloat16, "bf16", K2_BF16_ATOL)]:
        image, g = image32.to(dtype), g32.to(dtype)
        for gname, grid in grids.items():
            grid = grid.contiguous()
            out = cuda_warp.grid_sample_train_forward(image, grid)
            first = cuda_warp.grid_sample_grid_backward(g, image, grid)
            again = cuda_warp.grid_sample_grid_backward(g, image, grid)
            ref_out = cuda_warp.grid_sample_bilinear_border(image, grid)
            ref = cuda_warp.grid_sample_grid_backward_plain(g, image, grid)
            torch.cuda.synchronize()
            if out.dtype != dtype or not torch.equal(out, cuda_warp.grid_sample_fast(image, grid)):
                raise AssertionError(f"K3 {tag} {gname}: the differentiable forward is not K2's output ({out.dtype})")
            if first.dtype != torch.float32 or first.shape != (n, size, size, 2) or not torch.equal(first, again):
                raise AssertionError(f"K3 {tag} {gname}: two grid-backward calls differ, or dgrid is {first.dtype} {tuple(first.shape)}")
            out_err = float((out.float() - ref_out.float()).abs().max())
            dgrid_abs = float((first - ref).abs().max())
            dgrid_err = dgrid_abs / max(float(ref.abs().max()), 1e-12)
            # Through the autograd Function, twice: the same kernels on the
            # same cotangent, so bit-equal to the direct call.
            dgrids = []
            for _ in range(2):
                gr = grid.detach().requires_grad_()
                (cuda_warp.grid_sample_train(image, gr).float() * g.float()).sum().backward()
                dgrids.append(gr.grad)
            torch.cuda.synchronize()
            if not (torch.equal(dgrids[0], dgrids[1]) and torch.equal(dgrids[0], first)):
                raise AssertionError(f"K3 {tag} {gname}: the autograd gradient differs between calls or from the direct call")

            def fwd(grid=grid):
                return cuda_warp.grid_sample_train_forward(image, grid)

            def bwd(grid=grid):
                return cuda_warp.grid_sample_grid_backward(g, image, grid)

            def pair(grid=grid):
                return cuda_warp.grid_sample_train_forward(image, grid), cuda_warp.grid_sample_grid_backward(g, image, grid)

            def pair_autograd(grid=grid):
                gr = grid.detach().requires_grad_()
                return torch.autograd.grad(cuda_warp.grid_sample_train(image, gr), gr, g)

            # The PyTorch calls of the same functions; they take the grid in
            # the image's dtype (cast before the clock).
            image_nchw, g_nchw, grid_t = image.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2), grid.to(dtype)

            def library_fwd(grid_t=grid_t):
                return torch.nn.functional.grid_sample(image_nchw, grid_t, mode="bilinear", padding_mode="border",
                                                       align_corners=False)

            def library_bwd(grid_t=grid_t):  # bilinear (0), border (1), the grid's gradient alone
                return torch.ops.aten.grid_sampler_2d_backward(g_nchw, image_nchw, grid_t, 0, 1, False, [False, True])[1]

            def library_pair(grid_t=grid_t):
                return library_fwd(grid_t), library_bwd(grid_t)

            def library_autograd(grid_t=grid_t):
                gr = grid_t.detach().requires_grad_()
                return torch.autograd.grad(library_fwd(gr), gr, g_nchw)

            graph = {k: _graph_ms(f) for k, f in (("fwd_ms", fwd), ("bwd_ms", bwd), ("pair_ms", pair),
                                                    ("library_fwd_ms", library_fwd), ("library_bwd_ms", library_bwd),
                                                    ("pair_library_ms", library_pair))}
            b2b = {k: _device_ms(f, reps=100) for k, f in (("pair_b2b_ms", pair), ("pair_autograd_ms", pair_autograd),
                                                          ("pair_library_autograd_ms", library_autograd))}
            plain = {"plain_fwd_ms": _time_ms(lambda: cuda_warp.grid_sample_bilinear_border(image, grid)),
                     "plain_bwd_ms": _time_ms(lambda: cuda_warp.grid_sample_grid_backward_plain(g, image, grid))}
            # Bytes: each input read once, each output written once (the
            # corner gathers hit L2).  Operations: f32 on the CUDA cores in
            # both dtypes, each its own instruction (twice the count at the
            # f32 peak, which counts an FMA as two): 3 lerps a value
            # forward; backward 14 a value (the two lerps' differences and
            # products, dx, dy and the two channel sums).
            bound_fwd = _bound(_nbytes(image, grid, out), 2.0 * 6.0 * out.numel(), "f32")
            bound_bwd = _bound(_nbytes(g, image, grid, first), 2.0 * 14.0 * g.numel(), "f32")
            pair_bound = bound_fwd["bound_ms"] + bound_bwd["bound_ms"]
            print(f"K3 {tag:4s} N={n} {size}^2x4 {gname}: forward = K2 bit for bit, max_abs_err {out_err:.3e} (bar "
                  f"{out_bar:.1e}); grid backward max_abs_err {dgrid_abs:.3e}, scaled {dgrid_err:.2e} (bar "
                  f"{K3_DGRID_ATOL:.0e}); two calls and the autograd path bit-identical.  The card's own time (CUDA graph of "
                  f"20 calls): forward {graph['fwd_ms']:.5f} ms (F.grid_sample {graph['library_fwd_ms']:.5f}), grid backward "
                  f"{graph['bwd_ms']:.5f} ms (aten grid_sampler_2d_backward, grid only, {graph['library_bwd_ms']:.5f}), "
                  f"pair {graph['pair_ms']:.5f} ms (library {graph['pair_library_ms']:.5f}); 100 calls back to back: pair "
                  f"{b2b['pair_b2b_ms']:.5f} ms, through autograd {b2b['pair_autograd_ms']:.5f} ms, F.grid_sample forward + "
                  f"grid backward through autograd {b2b['pair_library_autograd_ms']:.5f} ms; plain forward "
                  f"{plain['plain_fwd_ms']:.4f} ms, plain backward {plain['plain_bwd_ms']:.4f} ms; bound forward "
                  f"{bound_fwd['bound_ms']:.4f} ms ({bound_fwd['bound_by']}), backward {bound_bwd['bound_ms']:.4f} ms "
                  f"({bound_bwd['bound_by']}), pair {pair_bound:.4f} ms, pair share {pair_bound / graph['pair_ms']:.3f}")
            if not out_err <= out_bar or not dgrid_err <= K3_DGRID_ATOL:
                raise AssertionError(f"K3 {tag} {gname}: forward error {out_err} (bar {out_bar}), dgrid scaled error "
                                     f"{dgrid_err} (bar {K3_DGRID_ATOL})")
            results[f"{tag}_err"] = max(results[f"{tag}_err"], out_err)
            results["dgrid_err"] = max(results["dgrid_err"], dgrid_err)
            results["dgrid_abs_err"] = max(results["dgrid_abs_err"], dgrid_abs)
            if gname.startswith("smooth"):
                for k, v in (*graph.items(), *b2b.items(), *plain.items(), ("bound_fwd", bound_fwd), ("bound_bwd", bound_bwd)):
                    results[k][tag] = v
    return results


def phase_poly_sin(torch) -> dict:
    """K5 at the body student's widest layer: (8, 512^2, 90)."""
    from tha4_tpu_torch.ops import cuda_poly_sin

    gen = torch.Generator().manual_seed(SEED + 11)
    shape = (TRAIN_BATCH, 512, 512, 90)
    a32 = (torch.randn(shape, generator=gen) * 40.0).cuda()  # omega * pre reaches +-150
    g32 = torch.randn(shape, generator=gen).cuda()
    results = {}
    for tag, a_dtype, out_dtype in [("f32->bf16", torch.float32, torch.bfloat16), ("bf16", torch.bfloat16, torch.bfloat16),
                                    ("f32", torch.float32, torch.float32)]:
        a, g = a32.to(a_dtype), g32.to(out_dtype)
        out = cuda_poly_sin.poly_sin_forward(a, out_dtype)
        da = cuda_poly_sin.poly_sin_backward(a, g)
        out_ref = cuda_poly_sin.poly_sin_plain(a, out_dtype)
        da_ref = cuda_poly_sin.poly_sin_bwd_plain(a, g)
        torch.cuda.synchronize()
        errs = [float((x.float() - r.float()).abs().max()) for x, r in ((out, out_ref), (da, da_ref))]
        bars = [K5_F32_ATOL if t == torch.float32 else K5_BF16_ATOL * s for t, s in ((out_dtype, 1.0), (a_dtype, float(da_ref.float().abs().max())))]
        times = {
            "fwd": _time_ms(lambda: cuda_poly_sin.poly_sin_forward(a, out_dtype), iters=10),
            "bwd": _time_ms(lambda: cuda_poly_sin.poly_sin_backward(a, g), iters=10),
            "plain_fwd": _time_ms(lambda: cuda_poly_sin.poly_sin_plain(a, out_dtype), iters=10),
            "plain_bwd": _time_ms(lambda: cuda_poly_sin.poly_sin_bwd_plain(a, g), iters=10),
            "torch_sin": _time_ms(lambda: torch.sin(a), iters=10),
            "dev_fwd": _device_ms(lambda: cuda_poly_sin.poly_sin_forward(a, out_dtype), reps=20),
            "dev_bwd": _device_ms(lambda: cuda_poly_sin.poly_sin_backward(a, g), reps=20),
            "dev_torch_sin": _device_ms(lambda: torch.sin(a), reps=20),
        }
        pt = "bf16" if a_dtype == torch.bfloat16 else "f32"
        # About 20 f32 operations per element (reduction, polynomial, cast).
        bound = {"fwd": _bound(_nbytes(a, out), 20.0 * a.numel(), pt), "bwd": _bound(_nbytes(a, g, da), 21.0 * a.numel(), pt)}
        print(f"K5 poly_sin {tag:9s} {shape}: max_abs_err fwd {errs[0]:.2e} bwd {errs[1]:.2e} (bars {bars[0]:.1e}, {bars[1]:.1e}); "
              f"kernel fwd {times['fwd']:.4f} ms (bound {bound['fwd']['bound_ms']:.4f}), bwd {times['bwd']:.4f} ms "
              f"(bound {bound['bwd']['bound_ms']:.4f}); plain fwd {times['plain_fwd']:.4f} ms, bwd {times['plain_bwd']:.4f} ms; "
              f"torch.sin {times['torch_sin']:.4f} ms; device time (20 calls back to back) fwd {times['dev_fwd']:.4f}, "
              f"bwd {times['dev_bwd']:.4f}, torch.sin {times['dev_torch_sin']:.4f} ms")
        if out.dtype != out_dtype or da.dtype != a_dtype or not (errs[0] <= bars[0] and errs[1] <= bars[1]):
            raise AssertionError(f"K5 {tag}: errors {errs} over {bars} (dtypes {out.dtype}, {da.dtype})")
        results[tag] = {"errs": errs, "bound": bound, **times}
    return results


def _conv_macs(torch, teacher, run) -> tuple:
    """Multiply-adds of every convolution in one ``run()`` of ``teacher``,
    counted from the shapes: by forward hooks on the conv modules cuDNN
    runs, and at K6's wrapper for the convs K6 runs (it reads its conv's
    weight and never calls the module; its 1x1 skip counts too, as the
    cuDNN 1x1 conv it replaces did).  Returns (the multiply-adds, K6's call
    sizes (N, H, W, Cin, Cout, Cs, skip mode) -> calls)."""
    from tha4_tpu_torch.ops import cuda_conv

    total = [0]
    k6_sizes = {}

    def hook(module, inputs, output):
        kh, kw = module.kernel_size
        if isinstance(module, torch.nn.ConvTranspose2d):  # each input value feeds cout x kh x kw outputs
            total[0] += inputs[0].numel() * module.out_channels * kh * kw // module.groups
        else:
            total[0] += output.numel() * module.in_channels * kh * kw // module.groups

    k6 = cuda_conv.fused_affine_conv3_nchw

    def k6_counted(x, scale, shift, w9, bias, skip=None, skip_w=None, layout=None):
        n, c, h, w = x.shape
        cout, cs = w9.shape[0], 0 if skip is None else skip.shape[1]
        mode = 0 if skip is None else (1 if skip_w is None else _K6_SKIP_CONV)
        size = (n, h, w, c, cout, cs, mode)
        k6_sizes[size] = k6_sizes.get(size, 0) + 1
        total[0] += n * h * w * cout * (9 * c + (cs if mode == _K6_SKIP_CONV else 0))
        return k6(x, scale, shift, w9, bias, skip, skip_w, layout)

    handles = [m.register_forward_hook(hook) for m in teacher.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    k6_counted.launches = k6.launches  # the wrapper counts on the function its module name holds
    cuda_conv.fused_affine_conv3_nchw = k6_counted
    try:
        with torch.no_grad():
            run()
    finally:
        cuda_conv.fused_affine_conv3_nchw = k6
        k6.launches = k6_counted.launches
        for h in handles:
            h.remove()
    return total[0], k6_sizes


def phase_body_teacher(torch, teacher_params, image) -> dict:
    """The full-width mode_07 at B = 1, 4 and 8, bf16 and f32."""
    from tha4_tpu_torch.distiller.pipeline import BODY_SAMPLES
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.models import body_morpher
    from tha4_tpu_torch.ops import cuda_conv, cuda_warp
    from tha4_tpu_torch.ops.resize import resize_bilinear
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.poser.modes.pose_parameters import NUM_EYEBROW_PARAMS, NUM_FACE_PARAMS
    from tha4_tpu_torch.tools.profile_step import device_ops

    checked = {"posed": 0, "grid_change": 3, "face_morphed_full": mode_07.INDEX_FACE_MORPHED_FULL}
    results = {"ms": {}, "conv_macs": {}, "launches_per_call": {}}
    b1 = {}  # dtype tag -> (teacher, poses, the B = 1 outputs on the CPU)
    k6_sizes = {}  # every size K6 took in these calls -> calls a teacher call
    for tag, dtype in [("bf16", torch.bfloat16), ("f32", torch.float32)]:
        teacher = mode_07.Teacher.from_params(teacher_params).freeze(dtype, "cuda")
        for n in (1, BODY_SAMPLES, TRAIN_BATCH):  # frames, the body sample grid's render, training
            poses = sample_poses(torch.Generator().manual_seed(SEED + 20 + n), n).cuda()
            images = image.to(dtype).expand(n, *image.shape[1:])
            cuda_warp.grid_sample_fast.launches = 0
            cuda_conv.fused_affine_conv3_nchw.launches = 0
            cuda_conv.fold_groupnorm_film.launches = 0
            with torch.no_grad():
                outs = mode_07.compute_outputs(teacher, images, poses.to(dtype))
            torch.cuda.synchronize()
            launches = (cuda_warp.grid_sample_fast.launches, cuda_conv.fused_affine_conv3_nchw.launches,
                        cuda_conv.fold_groupnorm_film.launches)
            if launches != (5, K6_PER_TEACHER_CALL, K6_PER_TEACHER_CALL):
                raise AssertionError(f"mode_07 {tag} B={n}: {launches} K2, K6 and fold launches, expected 5, "
                                     f"{K6_PER_TEACHER_CALL} and {K6_PER_TEACHER_CALL}")
            results["k6_launches_per_call"] = launches[1]
            sizes = [512] * 6 + [256] * 5 + [192] * 8 + [128] * 14
            if len(outs) != 33 or any(o.shape[:3] != (n, s, s) or o.dtype != dtype for o, s in zip(outs, sizes)):
                raise AssertionError(f"mode_07 {tag} B={n}: outputs {[(tuple(o.shape), o.dtype) for o in outs]}")
            if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
                raise AssertionError(f"mode_07 {tag} B={n}: non-finite output")
            with torch.no_grad():
                ms = _time_ms(lambda: mode_07.compute_outputs(teacher, images, poses.to(dtype)), iters=5, warmup=1)
            results["ms"][f"{tag}_b{n}"] = ms
            macs, sizes = _conv_macs(torch, teacher, lambda: mode_07.compute_outputs(teacher, images, poses.to(dtype)))
            k6_sizes.update(sizes)
            results["conv_macs"][f"{tag}_b{n}"] = macs
            with torch.no_grad():
                ops = device_ops(lambda: mode_07.compute_outputs(teacher, images, poses.to(dtype)))
            results["launches_per_call"][f"{tag}_b{n}"] = ops
            flow = float(outs[3].float().abs().max()) * 512 / 2.0
            print(f"mode_07 {tag:4s} B={n}: 33 finite outputs of the expected shapes, 5 K2, {K6_PER_TEACHER_CALL} K6 and "
                  f"{K6_PER_TEACHER_CALL} fold launches; {ops} device launches a call (kernels, copies and fills, by "
                  f"torch.profiler); {ms:.3f} ms a call; "
                  f"{macs / 1e12:.3f} T conv multiply-adds (cuDNN's and K6's), {2.0 * macs / ms / 1e9:.1f} TFLOP/s over the call; "
                  f"largest upscaler flow {flow:.2f} px")
            if n == 1:
                b1[tag] = (teacher, poses, [o.cpu() for o in outs])
    results["k6_path"] = _k6_at_path_sizes(torch, k6_sizes)
    card_teacher, poses, card = b1["f32"]
    bf16_teacher, _, card16 = b1["bf16"]

    # The same teacher on the CPU in f32 (the plain run) and in f64 (the
    # exact answer for these f32 weights and inputs, which says which of the
    # two f32 runs is off), at B = 1 on the card's poses.
    cpu_teacher = mode_07.Teacher.from_params(teacher_params).freeze(torch.float32, "cpu")
    exact_teacher = mode_07.Teacher.from_params(teacher_params).freeze(torch.float64, "cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        plain = mode_07.compute_outputs(cpu_teacher, image.cpu(), poses.cpu())
        cpu_s = time.perf_counter() - t0
        exact = mode_07.compute_outputs(exact_teacher, image.cpu().double(), poses.cpu().double())
    f64_s = time.perf_counter() - t0 - cpu_s

    def gap(a, b) -> float:
        return float((a.double() - b.double()).abs().max())

    def gaps(on_card, on_cpu, on_exact, on_bf16) -> dict:
        return {"card_cpu": gap(on_card, on_cpu), "card_exact": gap(on_card, on_exact),
                "cpu_exact": gap(on_cpu, on_exact), "bf16_exact": gap(on_bf16, on_exact)}

    def ratio_over(rows: dict) -> list:
        # The card's f32 is no further from the exact answer than the CPU's
        # f32 is, within TEACHER_EXACT_RATIO.
        return [(k, r["card_exact"], r["cpu_exact"]) for k, r in rows.items()
                if not r["card_exact"] <= TEACHER_EXACT_RATIO * r["cpu_exact"] + 1e-7]

    rows = {i: gaps(card[i], plain[i], exact[i], card16[i]) for i in range(len(card))}
    psnr = min(_psnr(a, b) for a, b in zip(card, plain))
    print(f"mode_07 B=1 on the CPU: f32 {cpu_s:.1f} s, f64 {f64_s:.1f} s; max abs differences, card f32 vs CPU f32 | card f32 vs "
          f"f64 | CPU f32 vs f64 | card bf16 vs f64: " + "; ".join(
              f"{name} {rows[i]['card_cpu']:.2e} (bar {TEACHER_F32_ATOL[name]:.0e}) | {rows[i]['card_exact']:.2e} "
              f"(bar {TEACHER_EXACT_ATOL[name]:.0e}) | {rows[i]['cpu_exact']:.2e} | {rows[i]['bf16_exact']:.2e}"
              for name, i in checked.items()))
    worst = max(rows.values(), key=lambda r: r["card_exact"] / max(r["cpu_exact"], 1e-12))
    print(f"mode_07 B=1, all 33 outputs: card vs CPU PSNR min {psnr:.2f} dB (floor {TEACHER_F32_MIN_PSNR:.0f}); card f32 vs f64 "
          f"at most {worst['card_exact'] / max(worst['cpu_exact'], 1e-12):.2f}x the CPU f32's distance (bar {TEACHER_EXACT_RATIO}x); "
          f"largest distances from f64: card f32 {max(r['card_exact'] for r in rows.values()):.2e}, CPU f32 "
          f"{max(r['cpu_exact'] for r in rows.values()):.2e}, card bf16 {max(r['bf16_exact'] for r in rows.values()):.2e}")
    for name, i in checked.items():
        if not (rows[i]["card_cpu"] <= TEACHER_F32_ATOL[name] and rows[i]["card_exact"] <= TEACHER_EXACT_ATOL[name]):
            raise AssertionError(f"mode_07 f32 card: {name} {rows[i]} over {TEACHER_F32_ATOL[name]}, {TEACHER_EXACT_ATOL[name]}")
    if ratio_over(rows) or not psnr > TEACHER_F32_MIN_PSNR:
        raise AssertionError(f"mode_07 f32 card: further from f64 than the CPU f32 {ratio_over(rows)}, or PSNR {psnr} dB")

    # The two U-Nets alone, each on the CPU f32 run's own inputs.
    rotation = poses.cpu()[:, NUM_EYEBROW_PARAMS + NUM_FACE_PARAMS :]
    half = resize_bilinear(plain[mode_07.INDEX_FACE_MORPHED_FULL], (256, 256))
    coarse = [resize_bilinear(plain[6 + i], (512, 512)) for i in (body_morpher.INDEX_MERGED, body_morpher.INDEX_GRID_CHANGE)]
    inputs = {"body_morpher": (half, rotation), "upscaler": (plain[mode_07.INDEX_FACE_MORPHED_FULL], *coarse, rotation)}
    net_rows = {}
    for name, args in inputs.items():
        with torch.no_grad():
            on_card = getattr(card_teacher, name)(*(t.cuda() for t in args))
            on_cpu = getattr(cpu_teacher, name)(*args)
            on_exact = getattr(exact_teacher, name)(*(t.double() for t in args))
            on_bf16 = getattr(bf16_teacher, name)(*(t.to("cuda", torch.bfloat16) for t in args))
        net_rows[name] = {k: gaps(a.cpu(), b, e, h.cpu()) for k, a, b, e, h in zip(UNET_OUTPUT_NAMES, on_card, on_cpu, on_exact, on_bf16)}
        print(f"mode_07 B=1 {name} alone on the same inputs, card f32 vs CPU f32 | card f32 vs f64 | CPU f32 vs f64 | "
              f"card bf16 vs f64: " + "; ".join(f"{k} {r['card_cpu']:.2e} | {r['card_exact']:.2e} | {r['cpu_exact']:.2e} | "
                                                f"{r['bf16_exact']:.2e}" for k, r in net_rows[name].items()))
    held = [("body_morpher", k) for k in UNET_OUTPUT_NAMES] + [("upscaler", "alpha"), ("upscaler", "grid_change")]
    over = [(net, k, net_rows[net][k]["card_cpu"]) for net, k in held if not net_rows[net][k]["card_cpu"] <= UNET_F32_ATOL]
    over += [(net, k, r["card_exact"]) for net in net_rows for k, r in net_rows[net].items() if not r["card_exact"] <= UNET_EXACT_ATOL]
    print(f"mode_07 B=1 U-Nets alone: card f32 vs f64 at most {max(r['card_exact'] for v in net_rows.values() for r in v.values()):.2e} "
          f"(bar {UNET_EXACT_ATOL:.0e}), card bf16 vs f64 at least {min(r['bf16_exact'] for v in net_rows.values() for r in v.values()):.2e}")
    if over or ratio_over(net_rows["body_morpher"]) or ratio_over(net_rows["upscaler"]):
        raise AssertionError(f"mode_07 f32 U-Nets over their bars: {over}; further from f64 than the CPU f32: "
                             f"{ratio_over(net_rows['body_morpher'])} {ratio_over(net_rows['upscaler'])}")
    # The bars have teeth: bf16 fails each of them.
    passed16 = [name for name, i in checked.items() if rows[i]["bf16_exact"] <= TEACHER_EXACT_ATOL[name]]
    passed16 += [(net, k) for net in net_rows for k, r in net_rows[net].items() if r["bf16_exact"] <= UNET_EXACT_ATOL]
    if passed16:
        raise AssertionError(f"mode_07: the bf16 teacher passes the f32 bars against f64 at {passed16}")
    results.update(rows={name: rows[i] for name, i in checked.items()}, psnr=psnr, net_rows=net_rows)
    return results


def _timed_body_steps(torch, recipes, student, teacher, image, dtype, mixed, pipelined: bool, iters: int = 10, warmup: int = 2) -> dict:
    """As ``_timed_steps``, for the body student: teacher labels, student
    forward + backward, Adam, at the default phase-3 weights."""
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses

    student = copy.deepcopy(student)
    optimizer = recipes.make_adam(student)
    weights = recipes.default_body_phases().loss_weights(recipes.BODY_LOSS_TERMS, 500_000)
    batches = [sample_poses(torch.Generator().manual_seed(SEED + 200 + i), TRAIN_BATCH).cuda() for i in range(warmup + iters)]
    events = []
    for i, poses in enumerate(batches):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        targets = recipes.body_teacher_targets(teacher, image, poses, dtype)
        ev[1].record()
        optimizer.zero_grad(set_to_none=True)
        total, _ = recipes.body_loss(student, targets, poses, weights, dtype, mixed)
        total.backward()
        ev[2].record()
        for group in optimizer.param_groups:
            group["lr"] = 1e-5
        optimizer.step()
        ev[3].record()
        if not pipelined:
            ev[3].synchronize()
        events.append(ev)
    torch.cuda.synchronize()
    out = {"step_ms": (time.perf_counter() - t0) * 1000.0 / iters}
    for j, key in enumerate(["teacher_ms", "student_ms", "adam_ms"]):
        out[key] = statistics.median(ev[j].elapsed_time(ev[j + 1]) for ev in events[warmup:])
    return out


def _body_gradient_check(torch, student, teacher32, image) -> dict:
    """The body student's f32 gradients on the card against the plain
    backward on the CPU, at B = 2, same labels (the card's f32 teacher) and
    poses, split at the head output: a bilinear sample's gradient jumps
    where its point crosses a texel edge, and a head output 1e-6 away on
    the CPU puts some points in another cell.  So the trunk (GEMMs,
    resizes, poly_sin kernels) is held on the card's head cotangent, and
    the head, K3 and the loss on the card's head output.  End to end, each
    device from its own head output, the gradients are held once the loss
    terms of the pixels where the loss is not smooth between the two
    devices' head outputs are dropped: the sample point lies in another
    texel, or an L1 term's prediction on the other side of its label.
    Every term of the body loss is per pixel, so that is their head
    cotangent zeroed.  The smooth pixels still carry the head outputs'
    difference, so the end-to-end comparison is held in two parts, each to
    a fixed bar: the card against the CPU's whole backward at the card's
    head output (the card's own share, ``STEP_MASKED_ATOL``), and the CPU's
    backward at the card's head output against at its own (what the head
    outputs' difference alone moves, ``STEP_DRIFT_ATOL``).  The end-to-end
    error is at most their sum."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.ops import warp

    poses = sample_poses(torch.Generator().manual_seed(SEED + 30), 2).cuda()
    weights = recipes.default_body_phases().loss_weights(recipes.BODY_LOSS_TERMS, 500_000)
    # The labels in cuDNN's deterministic mode: some of its default f32
    # algorithms are not deterministic, and labels that move by ~3e-4 from
    # run to run move which pixels sit near a kink, and so this reading.
    torch.backends.cudnn.deterministic = True
    try:
        targets = recipes.body_teacher_targets(teacher32, image, poses, torch.float32)
    finally:
        torch.backends.cudnn.deterministic = False
    cpu_targets = [t.cpu() for t in targets]

    def scaled_err(grads, refs):
        return max(float((grads[k].cpu() - r.cpu()).abs().max()) / max(float(r.abs().max()), 1e-12) for k, r in refs.items())

    def head_cotangent(head, labels):
        leaf = head.detach().requires_grad_()
        recipes.body_loss_terms(siren.morpher_head(leaf, labels[3]), labels, weights)[0].backward()
        return leaf.grad

    def trunk_grads(module, head, cot):
        params = dict(module.named_parameters())
        return dict(zip(params, torch.autograd.grad(head, list(params.values()), cot, retain_graph=True)))

    def cells(h):
        # The source texel each output pixel samples, from the head's grid change.
        size = h.shape[1]
        grid = warp.identity_grid(size, size)[None] + h[..., 0:2]
        return torch.floor(((grid + 1.0) * size - 1.0) * 0.5)

    def sides(h, labels):
        # The side of its label each L1 term's prediction lies on (recipes.body_loss_terms).
        with torch.no_grad():
            outs = siren.morpher_head(h, labels[3])
        pairs = [(siren.SIREN_MORPHER_INDEX_BLENDED_IMAGE, 0), (siren.SIREN_MORPHER_INDEX_WARPED_IMAGE, 1),
                 (siren.SIREN_MORPHER_INDEX_GRID_CHANGE, 2), (siren.SIREN_MORPHER_INDEX_COLOR_CHANGE, 0)]
        return torch.cat([torch.sign(outs[i].float() - labels[j].float()).cpu() for i, j in pairs], dim=-1)

    card, cpu_student = copy.deepcopy(student), copy.deepcopy(student).cpu()
    head = siren.siren_morpher_train_head(card, poses, torch.float32)
    cpu_head = siren.siren_morpher_train_head(cpu_student, poses.cpu(), torch.float32)
    cot, cpu_cot = head_cotangent(head, targets), head_cotangent(cpu_head, cpu_targets)
    card_grads = trunk_grads(card, head, cot)
    trunk_err = scaled_err(card_grads, trunk_grads(cpu_student, cpu_head, cot.cpu()))
    cot_on_cpu = head_cotangent(head.cpu(), cpu_targets)
    head_err = scaled_err({"head": cot}, {"head": cot_on_cpu})
    e2e_err = scaled_err(card_grads, trunk_grads(cpu_student, cpu_head, cpu_cot))
    same_texel = (cells(head.detach().cpu()) == cells(cpu_head.detach())).all(dim=-1, keepdim=True)
    same_side = (sides(head.detach(), targets) == sides(cpu_head.detach(), cpu_targets)).all(dim=-1, keepdim=True)
    moved, flipped = int((~same_texel).sum()), int((same_texel & ~same_side).sum())
    smooth = same_texel & same_side
    masked_ref = trunk_grads(cpu_student, cpu_head, cpu_cot * smooth)
    card_masked = trunk_grads(card, head, cot * smooth.cuda())
    at_card_head = trunk_grads(cpu_student, cpu_head, cot_on_cpu * smooth)
    masked_err = scaled_err(card_masked, masked_ref)
    share_err = scaled_err(card_masked, at_card_head)
    drift_err = scaled_err(at_card_head, masked_ref)
    head_gap = float((head.detach().cpu() - cpu_head.detach()).abs().max())
    step_err = max(trunk_err, head_err)
    head_rows = float(card_grads["last_linear.weight"][0:2].abs().max())
    level_grads = [float(card_grads[f"siren_layers.{i}.0.linear.weight"].abs().max()) for i in range(len(student.siren_layers))]
    print(f"body training: f32 student gradients at B=2, card vs CPU plain backward, same labels (bar {STEP_F32_ATOL:.0e}, scaled): "
          f"trunk on the card's head cotangent {trunk_err:.3e}, head + K3 + loss on the card's head output {head_err:.3e}; "
          f"end to end {e2e_err:.3e}, with {moved} of {same_texel.numel()} sample points in another texel and {flipped} more "
          f"pixels with an L1 term on the other side of its label on the CPU, and {masked_err:.3e} with those pixels' loss terms "
          f"dropped on both devices: the card against the CPU's backward at the card's head output {share_err:.3e} (bar "
          f"{STEP_MASKED_ATOL:.0e}), the CPU's backward at the card's head output against at its own {drift_err:.3e} (bar "
          f"{STEP_DRIFT_ATOL:.0e}; head outputs at most {head_gap:.3e} apart); head grid-change rows |g| max {head_rows:.3e}; "
          f"first layer of each level |g| max " + ", ".join(f"{v:.3e}" for v in level_grads))
    if not (step_err <= STEP_F32_ATOL and share_err <= STEP_MASKED_ATOL and drift_err <= STEP_DRIFT_ATOL):
        raise AssertionError(f"body training: f32 card gradients {trunk_err}, {head_err} over the bar {STEP_F32_ATOL}, "
                             f"or {share_err} over {STEP_MASKED_ATOL}, or {drift_err} over {STEP_DRIFT_ATOL}")
    if not (head_rows > 0.0 and all(v > 0.0 for v in level_grads)):
        raise AssertionError("body training: a zero gradient on the head's grid-change rows or on a level")
    return {"step_err": step_err, "e2e_err": e2e_err, "masked_err": masked_err, "share_err": share_err,
            "drift_err": drift_err, "head_gap": head_gap, "moved": moved, "flipped": flipped}


def phase_body_training(torch, workdir: str, config, teacher_params) -> dict:
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.distiller.pipeline import DistillationJobs
    from tha4_tpu_torch.ops import cuda_conv, cuda_poly_sin, cuda_siren, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.training import checkpoint as ckpt
    from tha4_tpu_torch.training.schedules import TrainingPhase, TrainingPhases

    total = TRAIN_STEPS * TRAIN_BATCH
    # The reference's six phases, their bounds scaled from 1.5M examples to
    # this run's 256: the lr and the weights change at 34, 68, ... examples.
    phases = TrainingPhases([
        TrainingPhase(p.num_examples_upper_bound * total // recipes.BODY_MORPHER_TOTAL_EXAMPLES, p.learning_rate, dict(p.loss_weights))
        for p in recipes.default_body_phases().phases
    ])

    def jobs(prefix: str) -> DistillationJobs:
        os.makedirs(prefix, exist_ok=True)
        return DistillationJobs(
            dataclasses.replace(config, prefix=prefix), teacher_params_07=teacher_params, compute_dtype=torch.bfloat16,
            device="cuda", body_total_examples=total, examples_per_checkpoint=total // 2, examples_per_snapshot=total // 4,
        )

    run = jobs(os.path.join(workdir, "run"))
    trainer = run.make_body_trainer(phases)
    trainer.cfg.log_every_seconds = 0.0
    counters = [cuda_warp.grid_sample_fast, cuda_warp.grid_sample_train_forward, cuda_warp.grid_sample_grid_backward,
                cuda_poly_sin.poly_sin_forward,
                cuda_poly_sin.poly_sin_backward, cuda_siren.sine_chain_t, cuda_siren.sine_chain_t_bwd,
                cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film]
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    print(f"body training: {TRAIN_STEPS} steps at B={TRAIN_BATCH}, bf16 teacher and selective-f32 student, through "
          f"DistillationJobs.make_body_trainer(phases).train(), teacher mode_07 at full width (random): {wall:.2f} s; launches {launches}")
    expected = {"grid_sample_fast": 5 * TRAIN_STEPS, "grid_sample_train_forward": TRAIN_STEPS,
                "grid_sample_grid_backward": TRAIN_STEPS, "poly_sin_forward": 9 * TRAIN_STEPS,
                "poly_sin_backward": 9 * TRAIN_STEPS, "sine_chain_t": 0, "sine_chain_t_bwd": 0,
                "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL * TRAIN_STEPS, "fold_groupnorm_film": K6_PER_TEACHER_CALL * TRAIN_STEPS}
    if launches != expected or result["examples_seen"] != total:
        raise AssertionError(f"body training: expected {expected} launches and {total} examples, got {launches}, {result['examples_seen']}")

    prefix = trainer.cfg.prefix
    with open(os.path.join(prefix, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = (*recipes.BODY_LOSS_TERMS, "loss")
    if len(rows) != TRAIN_STEPS or not all(math.isfinite(r[k]) for r in rows for k in keys):
        raise AssertionError(f"body training: {len(rows)} log rows, or a loss that is not finite")
    lrs = sorted({r["lr"] for r in rows}, reverse=True)
    print(f"body training: loss {rows[0]['loss']:.5f} at step 1, {rows[-1]['loss']:.5f} at step {TRAIN_STEPS}, all finite; "
          f"lr {lrs} across the scaled phases; last terms " + ", ".join(f"{k} {rows[-1][k]:.5f}" for k in recipes.BODY_LOSS_TERMS))
    if len(lrs) < 3:
        raise AssertionError(f"body training: the run crossed no phase change (lr {lrs})")
    for d, seen in [(ckpt.checkpoint_dir(prefix, i), i * total // 2) for i in range(3)] + [(ckpt.snapshot_dir(prefix), total)]:
        if not ckpt.can_load(d, ["module"]) or ckpt.read_examples_seen(d) != seen:
            raise AssertionError(f"body training: {d} is not a loadable state at {seen} examples")

    resumed_trainer = jobs(os.path.join(workdir, "resumed")).make_body_trainer(phases)
    shutil.copytree(ckpt.checkpoint_dir(prefix, 1), ckpt.checkpoint_dir(resumed_trainer.cfg.prefix, 1))
    resumed = resumed_trainer.train()
    diffs = [float((a - b).abs().max()) for a, b in zip(result["module"].state_dict().values(), resumed["module"].state_dict().values())]
    print(f"body training: resumed from checkpoint 1 ({total // 2} examples) to {resumed['examples_seen']}: "
          f"params max abs diff {max(diffs):.3e} (bar {RESUME_ATOL:.0e})" + (" (bit-identical)" if max(diffs) == 0.0 else ""))
    if resumed["examples_seen"] != total or not max(diffs) <= RESUME_ATOL:
        raise AssertionError("body training: resume does not reproduce the uninterrupted run")

    student = result["module"]
    image = run.character_image()
    teacher32 = mode_07.Teacher.from_params(teacher_params).freeze(torch.float32, "cuda")
    grads = _body_gradient_check(torch, student, teacher32, image)

    steps = {}
    teacher16 = mode_07.Teacher.from_params(teacher_params).freeze(torch.bfloat16, "cuda")
    for tag, dtype, teacher, mixed in [("bf16_mixed", torch.bfloat16, teacher16, True), ("f32", torch.float32, teacher32, False)]:
        for mode, pipelined in [("synchronized", False), ("pipelined", True)]:
            t = steps[f"{tag}_{mode}"] = _timed_body_steps(torch, recipes, student, teacher, image, dtype, mixed, pipelined)
            print(f"body training step {tag} at B={TRAIN_BATCH}, {mode}: {t['step_ms']:.3f} ms/step host clock over 10 steps "
                  f"({TRAIN_BATCH * 1000.0 / t['step_ms']:.1f} examples/s); CUDA-event medians: teacher {t['teacher_ms']:.3f} ms, "
                  f"student fwd+bwd {t['student_ms']:.3f} ms, Adam {t['adam_ms']:.3f} ms")
    return {"launches": launches, "steps": steps, **grads, "resume_diff": max(diffs), "wall_s": wall}


def _file_state(root: str) -> dict:
    """Every file under ``root`` with its mtime in ns."""
    out = {}
    for directory, _, files in os.walk(root):
        for f in files:
            path = os.path.join(directory, f)
            out[path] = os.stat(path).st_mtime_ns
    return out


def phase_distill(torch, workdir: str, teacher_params) -> dict:
    """Distillation to a character model through ``pipeline.run_config``,
    the ``tha4-torch-distill`` command's callee, at full width (the random
    mode_07 of phase 10, mode_12 taken from it; the shipped students), bf16
    teacher and selective-f32 body student, both sample cadences at the
    config's default 10 000, 16 steps a student at batch 8 and a checkpoint
    every 8 steps.  cuDNN runs in its deterministic mode, so that the
    resumed export can be held bit for bit."""
    import PIL.Image

    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.distiller import pipeline, recipes, sample_output
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.ops import cuda_conv, cuda_poly_sin, cuda_siren, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_14
    from tha4_tpu_torch.tools import bench
    from tha4_tpu_torch.training import checkpoint as ckpt
    from tha4_tpu_torch.training import tensorboard
    from tha4_tpu_torch.training.trainer import Trainer, TrainerConfig

    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill_dag"), seed=SEED + 30,
                                                         batch_size=TRAIN_BATCH, sample_cadence=10_000))
    total = DISTILL_STEPS * TRAIN_BATCH
    kwargs = dict(teacher_params_07=teacher_params, compute_dtype=torch.bfloat16, device="cuda", face_total_examples=total,
                  body_total_examples=total, examples_per_checkpoint=total // 2, examples_per_snapshot=total // 4)
    counters = [cuda_siren.sine_chain_t, cuda_siren.sine_chain_t_bwd, cuda_warp.grid_sample_fast,
                cuda_warp.grid_sample_train_forward, cuda_warp.grid_sample_grid_backward, cuda_poly_sin.poly_sin_forward,
                cuda_poly_sin.poly_sin_backward, cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film]
    names = [c.__name__ for c in counters]

    # Host-clock records of the DAG's work, through wrappers on the methods
    # run_config's own DistillationJobs calls: each training task (its
    # steps counted from the examples it resumed at and ended at), each
    # sample grid and each export.  A student's first task logs a row and
    # a TensorBoard event every step, so that the events can be held
    # against the JSONL rows; every later task, whose time is the reading,
    # logs at the trainer's own cadence.
    tasks, samples, exports, saves, starts, jobs_seen = [], [], [], [], [], []
    train, save, load, write_face, write_body, export = (
        Trainer.train, Trainer._save, Trainer._load_or_init, pipeline.DistillationJobs.write_face_samples,
        pipeline.DistillationJobs.write_body_samples, pipeline.DistillationJobs._export_student)

    def rows(prefix):
        path = os.path.join(prefix, "log", "scalars.jsonl")
        return sum(1 for _ in open(path)) if os.path.exists(path) else 0

    def timed_train(self, target_examples=None):
        first = not any(t["prefix"] == self.cfg.prefix for t in tasks)
        self.cfg.log_every_seconds = 0.0 if first else TrainerConfig.log_every_seconds
        n_samples, n_saves = len(samples), len(saves)
        t0 = time.perf_counter()
        out = train(self, target_examples)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0 - sum(s for _, _, s in samples[n_samples:])
        tasks.append({"prefix": self.cfg.prefix, "steps": (out["examples_seen"] - starts[-1]) // self.cfg.total_batch_size,
                      "s": seconds, "saves": len(saves) - n_saves, "save_s": sum(saves[n_saves:]),
                      "log_every_seconds": self.cfg.log_every_seconds})
        return out

    def recorded_load(self, target_examples):
        state = load(self, target_examples)
        starts.append(state[2])
        return state

    def timed_save(self, *args):
        t0 = time.perf_counter()
        save(self, *args)
        saves.append(time.perf_counter() - t0)

    def timed_write(write, kind):
        def run(self, student, examples_seen):
            jobs_seen.append(self)
            t0 = time.perf_counter()
            write(self, student, examples_seen)
            samples.append((kind, examples_seen, time.perf_counter() - t0))
        return run

    def timed_export(checkpoint_file, module, dest):
        t0 = time.perf_counter()
        export(checkpoint_file, module, dest)
        exports.append((dest, time.perf_counter() - t0))

    def drive(target: str) -> dict:
        for c in counters:
            c.launches = 0
        pipeline.run_config(config, target=target, **kwargs)
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in counters}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    Trainer.train, Trainer._save, Trainer._load_or_init = timed_train, timed_save, recorded_load
    pipeline.DistillationJobs.write_face_samples = timed_write(write_face, "face")
    pipeline.DistillationJobs.write_body_samples = timed_write(write_body, "body")
    pipeline.DistillationJobs._export_student = staticmethod(timed_export)
    try:
        runs = {"face": drive("face")}
        pngs = {kind: sample_output.sample_output_file_name(getattr(config, f"{kind}_morpher_prefix")(), 0) for kind in ("face", "body")}
        if os.path.exists(pngs["body"]) or os.path.exists(config.character_model_yaml_file_name()):
            raise AssertionError("distill: the face target ran body or character-model tasks")
        runs["all"] = drive("all")
        outputs = _file_state(config.prefix)
        runs["rerun"] = drive("all")
        if _file_state(config.prefix) != outputs:
            raise AssertionError("distill: the rerun of an up to date DAG wrote files")
        body_prefix, body_pt = config.body_morpher_prefix(), config.character_model_body_morpher_file_name()
        with open(body_pt, "rb") as f:
            first_pt = f.read()
        resumed = {}
        for case, drop in (("snapshot", []), ("checkpoint_1", [ckpt.snapshot_dir(body_prefix)])):
            for path in [ckpt.checkpoint_dir(body_prefix, 2), *drop]:
                shutil.rmtree(path)
            os.remove(body_pt)
            runs[f"resume_{case}"] = drive("all")
            with open(body_pt, "rb") as f:
                resumed[case] = f.read() == first_pt
    finally:
        Trainer.train, Trainer._save, Trainer._load_or_init = train, save, load
        pipeline.DistillationJobs.write_face_samples = write_face
        pipeline.DistillationJobs.write_body_samples = write_body
        pipeline.DistillationJobs._export_student = staticmethod(export)
        torch.backends.cudnn.deterministic = deterministic

    face_step = {"sine_chain_t": 1, "sine_chain_t_bwd": 1, "grid_sample_fast": 2}
    body_step = {"grid_sample_fast": 5, "grid_sample_train_forward": 1, "grid_sample_grid_backward": 1,
                 "poly_sin_forward": 9, "poly_sin_backward": 9, "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL,
                 "fold_groupnorm_film": K6_PER_TEACHER_CALL}
    face_render = {"sine_chain_t": 1, "grid_sample_fast": 2}  # the student's f32 chain and mode_12 at B = 8
    body_render = {"sine_chain_t": 3, "grid_sample_fast": 5 + 1, "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL,
                   "fold_groupnorm_film": K6_PER_TEACHER_CALL}  # mode_07 at B = 4 and the student's three levels and warp

    def expect(*terms) -> dict:
        out = dict.fromkeys(names, 0)
        for counts, times in terms:
            for k, v in counts.items():
                out[k] += v * times
        return out

    expected = {"face": expect((face_step, DISTILL_STEPS), (face_render, 1)),
                "all": expect((body_step, DISTILL_STEPS), (body_render, 1)), "rerun": expect(),
                "resume_snapshot": expect(), "resume_checkpoint_1": expect((body_step, DISTILL_STEPS // 2))}
    for run, launches in runs.items():
        print(f"distill {run}: launches {launches}")
        if launches != expected[run]:
            raise AssertionError(f"distill {run}: expected {expected[run]} launches, got {launches}")
    print(f"distill: the rerun of the up to date DAG launched nothing and left {len(outputs)} files' mtimes as they were; "
          f"the body's body_morpher.pt rewritten from the snapshot at {total} (no step) and retrained from checkpoint 1 "
          f"({DISTILL_STEPS // 2} steps) equals the first bit for bit: {resumed}")
    if not all(resumed.values()):
        raise AssertionError(f"distill: a resumed body_morpher.pt differs from the first: {resumed}")

    for kind, shape in (("face", (pipeline.FACE_SAMPLES * pipeline.FACE_SAMPLE_CELL, 2 * pipeline.FACE_SAMPLE_CELL)),
                        ("body", (pipeline.BODY_SAMPLES * pipeline.BODY_SAMPLE_CELL, 4 * pipeline.BODY_SAMPLE_CELL))):
        pixels = np.asarray(PIL.Image.open(pngs[kind]))
        if pixels.shape != shape + (4,):
            raise AssertionError(f"distill: {kind} sample grid {pixels.shape}, expected {shape + (4,)}")
        prefix = getattr(config, f"{kind}_morpher_prefix")()
        log = os.path.join(prefix, "log")
        events = [e for f in sorted(os.listdir(log)) if f.startswith("events.out.tfevents.")
                  for e in tensorboard.read_events(os.path.join(log, f)) if e["scalars"]]
        if len(events) != rows(prefix) or not events or not all(math.isfinite(v) for e in events for v in e["scalars"].values()):
            raise AssertionError(f"distill: {kind} TensorBoard events {len(events)}, JSONL rows {rows(prefix)}")
        print(f"distill: {kind} sample grid at 0 decodes to {pixels.shape[0]}x{pixels.shape[1]}; {len(events)} TensorBoard "
              f"scalar events read back through read_events, as many as the JSONL's rows")

    # Posing the character model the DAG wrote, against a poser from the last checkpoints' .npz files.
    model = CharacterModel.load(config.character_model_yaml_file_name())
    image = model.get_character_image()
    posers = {"f32": model.get_poser(torch.float32, "cuda"), "bf16": model.get_poser(torch.bfloat16, "cuda")}
    poses = list(bench.pose_sweep(posers["f32"].pose_parameters, POSES))
    for c in counters:
        c.launches = 0
    frames = {tag: [poser.get_posing_outputs(image, pose) for pose in poses] for tag, poser in posers.items()}
    torch.cuda.synchronize()
    pose_launches = {c.__name__: c.launches for c in counters}
    if pose_launches != expect(({"sine_chain_t": 4, "grid_sample_fast": 1}, 2 * POSES)):
        raise AssertionError(f"distill: posing the character model launched {pose_launches}")
    npz = {key: os.path.join(ckpt.checkpoint_dir(prefix, 2), "module_module.npz") for key, prefix in
           ((mode_14.KEY_FACE_MORPHER, config.face_morpher_prefix()), (mode_14.KEY_BODY_MORPHER, body_prefix))}
    from_npz = mode_14.create_poser(module_file_names=npz, compute_dtype=torch.float32, device="cuda")
    equal = all(torch.equal(a, b) for pose, outs in zip(poses, frames["f32"])
                for a, b in zip(outs, from_npz.get_posing_outputs(image, pose)))
    finite = all(bool(torch.isfinite(o).all()) for outs in frames.values() for f in outs for o in f)
    psnr = min(_psnr(b[0], f[0]) for b, f in zip(frames["bf16"], frames["f32"]))
    print(f"distill: the exported character model poses {POSES} poses in f32 and bf16 through CharacterModel.load(...)"
          f".get_poser(...): launches {pose_launches} (4 K1 and 1 K2 a frame); f32 frames equal the .npz poser's bit for "
          f"bit: {equal}; bf16 vs f32 blended PSNR min {psnr:.2f} dB (floor {BF16_MIN_PSNR:.0f}); finite {finite}")
    if not (equal and finite and psnr >= BF16_MIN_PSNR):
        raise AssertionError("distill: the exported model's frames fail their checks")

    # Times.  ms/step: each training task on the host clock, its sample
    # grid's time taken out, snapshot and checkpoint writes left in; the
    # second task of each student is past its first-call costs and logs at
    # the trainer's own cadence (the first logs every step, see above).
    ms_step = {}
    for kind in ("face", "body"):
        prefix = getattr(config, f"{kind}_morpher_prefix")()
        first, second = [t for t in tasks if t["prefix"] == prefix][:2]
        ms_step[kind] = {"task_1_logging_every_step": 1000.0 * first["s"] / first["steps"],
                         "task_2": 1000.0 * second["s"] / second["steps"], "task_2_saves": second["saves"],
                         "task_2_without_saves": 1000.0 * (second["s"] - second["save_s"]) / second["steps"],
                         "task_2_log_every_seconds": second["log_every_seconds"]}
    # One render (to host arrays) and one grid (render and PNG) after the
    # run, medians of 3; the grids go to an examples_seen no run reaches.
    jobs = jobs_seen[-1]
    renders, grids = {}, {}
    for kind, key, seed, n in (("face", mode_14.KEY_FACE_MORPHER, config.face_morpher_random_seed_1, pipeline.FACE_SAMPLES),
                               ("body", mode_14.KEY_BODY_MORPHER, config.body_morpher_random_seed_1, pipeline.BODY_SAMPLES)):
        render, student = getattr(jobs, f"render_{kind}_samples"), mode_14._load_student(npz[key], kind)
        write, poses_n = getattr(jobs, f"write_{kind}_samples"), jobs.sample_poses(seed, n)
        for out, fn in ((renders, lambda: render(student, poses_n)), (grids, lambda: write(student, 9_999_999_992))):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                times.append(1000.0 * (time.perf_counter() - t0))
            out[kind] = statistics.median(times)
    write_ms = {kind: 1000.0 * s for kind, _, s in samples}
    export_ms = statistics.median(1000.0 * s for _, s in exports)
    # The production cadence's grids a student: one at 0, one every 10 000
    # examples, and one more after each checkpoint task but the first (a
    # task resumes at its boundary, a multiple of the cadence, and samples
    # after its first step, as the JAX trainer does).
    grid_counts = {kind: 1 + total_ex // 10_000 + total_ex // recipes.EXAMPLES_PER_CHECKPOINT - 1 for kind, total_ex in
                   (("face", recipes.FACE_MORPHER_TOTAL_EXAMPLES), ("body", recipes.BODY_MORPHER_TOTAL_EXAMPLES))}
    cadence_s = sum(write_ms[k] + (grid_counts[k] - 1) * grids[k] for k in grid_counts) / 1000.0
    print(f"distill through the DAG (host clock, cuDNN deterministic, the second task logging every "
          f"{ms_step['face']['task_2_log_every_seconds']:.0f} s): face {ms_step['face']['task_2']:.2f} ms/step (without "
          f"the task's {ms_step['face']['task_2_saves']} snapshot and checkpoint writes "
          f"{ms_step['face']['task_2_without_saves']:.2f}; the first task, logging every step and with first-call costs, "
          f"{ms_step['face']['task_1_logging_every_step']:.2f}), body {ms_step['body']['task_2']:.2f} ms/step (without its "
          f"{ms_step['body']['task_2_saves']} state writes {ms_step['body']['task_2_without_saves']:.2f}; first task "
          f"{ms_step['body']['task_1_logging_every_step']:.2f}); sample grid at 0 (render and PNG, the run's first render, "
          f"freezing the f32 teacher) face {write_ms['face']:.1f} ms, body {write_ms['body']:.1f} ms; after the run "
          f"(medians of 3) a render to host arrays face {renders['face']:.2f} ms, body {renders['body']:.2f} ms, a grid "
          f"face {grids['face']:.1f} ms, body {grids['body']:.1f} ms; export {export_ms:.2f} ms a student "
          f"({len(exports)} exports); the production cadence's {grid_counts['face']} face and {grid_counts['body']} body "
          f"grids (the first at its first-render time): {cadence_s:.1f} s a character")
    totals = dict.fromkeys(names, 0)
    for launches in list(runs.values()) + [pose_launches]:
        for k, v in launches.items():
            totals[k] += v
    return {"launches": totals, "runs": runs, "ms_step": ms_step, "sample_write_ms": write_ms, "render_ms": renders,
            "grid_ms": grids, "grid_counts": grid_counts, "export_ms": export_ms, "cadence_s": cadence_s, "pose_launches": pose_launches, "bf16_psnr": psnr}


def _k6_inputs(torch, gen, n: int, h: int, w: int, cin: int, cout: int, cs: int, mode: int) -> tuple:
    """Seeded K6 inputs on the card, f32 and NHWC: x, scale, shift, the HWIO
    weight, bias, skip (mode 1: identity, 2: 1x1 from cs channels) and the
    1x1 weight, None where the call has none."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    skip = randn(n, h, w, cs) if mode else None
    skip_w = randn(cout, cs) / math.sqrt(cs) if mode == _K6_SKIP_CONV else None
    scale = torch.rand((n, cin), generator=gen, device="cuda") + 0.5
    shift = torch.rand((n, cin), generator=gen, device="cuda") - 0.5
    return randn(n, h, w, cin), scale, shift, randn(3, 3, cin, cout) / math.sqrt(9 * cin), randn(cout) * 0.1, skip, skip_w


def _k6_check(torch, inputs: tuple, dtype, bar: float, name: str) -> tuple:
    """K6 against its plain version on ``inputs`` (``_k6_inputs``) in
    ``dtype``, laid out as the U-Net passes them (NCHW views of NHWC
    memory, with the weights' device layout made once, as a frozen U-Net
    keeps it): two calls bit-identical, the error over max |plain| within
    ``bar``.  Returns (the wrapper's arguments, its output, max-abs error,
    that error over max |plain|); the plain version takes the first seven."""
    from tha4_tpu_torch.ops import cuda_conv

    x32, scale, shift, w32, bias, skip32, skip_w32 = inputs
    x = x32.to(dtype).permute(0, 3, 1, 2)
    sk = None if skip32 is None else skip32.to(dtype).permute(0, 3, 1, 2)
    skw = None if skip_w32 is None else skip_w32.to(dtype)
    w9 = cuda_conv.to_w9(w32, dtype).contiguous()
    layout = cuda_conv.device_weight_layout(w9, skw, cuda_conv.layout_block(w9.shape[0], dtype), cuda_conv.CK, dtype)
    args = (x, scale, shift, w9, bias, sk, skw, layout)
    first = cuda_conv.fused_affine_conv3_nchw(*args)
    again = cuda_conv.fused_affine_conv3_nchw(*args)
    ref = cuda_conv.fused_affine_conv3_plain(*args[:7])
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError(f"K6 {name} {dtype}: two calls differ")
    err = float((first.float() - ref.float()).abs().max())
    rel = err / float(ref.float().abs().max())
    if first.dtype != dtype or first.shape != ref.shape or not rel <= bar:
        raise AssertionError(f"K6 {name} {dtype}: error {rel} over max |plain| (bar {bar}), {first.dtype} {tuple(first.shape)}")
    return args, first, err, rel


def _k6_at_path_sizes(torch, sizes: dict) -> dict:
    """K6 against its plain version at every size the teacher's U-Nets gave
    it (``sizes``: (N, H, W, Cin, Cout, Cs, skip mode) -> calls per teacher
    call), f32 and bf16, on seeded inputs at the bars of ``phase_k6``.  The
    deep levels at B = 1 and the 16^2-64^2 ones at B = 8 make grids too small
    for the card, which split the channel chunks among blocks and sum f32
    partials in a second kernel: at least one size in each dtype must."""
    from tha4_tpu_torch.ops import cuda_conv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    results = {"sizes": len(sizes), "f32_err": 0.0, "bf16_err": 0.0, "f32_rel": 0.0, "bf16_rel": 0.0,
               "split_sizes": {"f32": 0, "bf16": 0}, "split_calls": {}}
    for size in sorted(sizes):
        n, h, w, cin, cout, cs, mode = size
        inputs = _k6_inputs(torch, gen, *size)
        line = []
        for dtype, tag, bar in [(torch.float32, "f32", K6_F32_REL), (torch.bfloat16, "bf16", K6_BF16_REL)]:
            splits = cuda_conv._plan(*size, int(dtype == torch.bfloat16))[0]
            _, _, err, rel = _k6_check(torch, inputs, dtype, bar, f"N={n} {h}x{w} {cin}->{cout}")
            results[f"{tag}_err"] = max(results[f"{tag}_err"], err)
            results[f"{tag}_rel"] = max(results[f"{tag}_rel"], rel)
            if splits > 1:
                results["split_sizes"][tag] += 1
                key = f"{tag}_b{n}"
                results["split_calls"][key] = results["split_calls"].get(key, 0) + sizes[size]
            line.append(f"{tag} {rel:.2e} ({splits} split{'s' if splits > 1 else ''})")
        skip = ("", " +identity", f" +1x1({cs})")[mode]
        print(f"K6 at a path size, N={n} {h}x{w} {cin}->{cout}{skip}, {sizes[size]} a call: error over max |plain| "
              + ", ".join(line))
    print(f"K6 at the {len(sizes)} sizes of the teacher's calls at B = 1, 4 and {TRAIN_BATCH}: within the bars "
          f"({K6_F32_REL:.0e} f32, {K6_BF16_REL:.0e} bf16; read {results['f32_rel']:.2e}, {results['bf16_rel']:.2e}); "
          f"split grids at {results['split_sizes']} sizes, calls a teacher call {results['split_calls']}")
    if not (results["split_sizes"]["f32"] and results["split_sizes"]["bf16"]):
        raise AssertionError(f"K6: no path size takes the split grid {results['split_sizes']}")
    return results


def _fold_inputs(torch, gen, x) -> tuple:
    """The fold's arguments for ``x`` (N, C, H, W), as a ResBlock's norm1
    has them: 32 groups, an f32 affine, two FiLMs in x's dtype, each the two
    halves of one (N, 2C) linear output."""
    n, c = x.shape[:2]
    gamma = torch.rand(c, generator=gen, device="cuda") + 0.5
    beta = torch.rand(c, generator=gen, device="cuda") - 0.5
    film = tuple((torch.randn((n, 2 * c), generator=gen, device="cuda") * 0.3).to(x.dtype).chunk(2, dim=-1) for _ in range(2))
    return x, min(32, c), gamma, beta, film


def phase_k6(torch) -> dict:
    """K6 and its fold at the five costliest shapes of the teacher's U-Nets,
    B = 8."""
    from tha4_tpu_torch.ops import cuda_conv

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    n = TRAIN_BATCH
    results = {"f32_err": 0.0, "bf16_err": 0.0, "f32_rel": 0.0, "bf16_rel": 0.0, "fold_rel": 0.0, "fold_abs": 0.0, "shapes": {}}
    for name, size, cin, cout, skip in K6_SHAPES:
        cs = 0 if skip is None else (cout if skip == "identity" else skip)
        mode = 0 if skip is None else (1 if skip == "identity" else _K6_SKIP_CONV)
        inputs = _k6_inputs(torch, gen, n, size, size, cin, cout, cs, mode)
        row = {}
        for dtype, tag, bar in [(torch.float32, "f32", K6_F32_REL), (torch.bfloat16, "bf16", K6_BF16_REL)]:
            args, first, err, rel = _k6_check(torch, inputs, dtype, bar, name)
            x = args[0]
            # One PyTorch call of the convolution alone: cuDNN, channels last.
            w_lib = inputs[3].permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)
            b_lib = inputs[4].to(dtype)
            macs = n * size * size * cout * (9 * cin + (cs if mode == _K6_SKIP_CONV else 0))
            bound = _bound(_nbytes(*args[:7], first), 2.0 * macs, tag)
            # The fold on this shape's x (a ResBlock's norm1 with its two
            # FiLMs), and K6 with its fold against cuDNN with PyTorch's group
            # norm (the norm's affine only: PyTorch has no call with the FiLMs).
            fold_args = _fold_inputs(torch, gen, x)
            with torch.no_grad():
                fold = cuda_conv.fold_groupnorm_film(*fold_args)
                fold_again = cuda_conv.fold_groupnorm_film(*fold_args)
            fold_ref = cuda_conv.fold_groupnorm_film_plain(*fold_args)
            torch.cuda.synchronize()
            fold_abs = max(float((a - r).abs().max()) for a, r in zip(fold, fold_ref))
            fold_rel = max(float((a - r).abs().max()) / float(r.abs().max()) for a, r in zip(fold, fold_ref))
            if not (all(torch.equal(a, b) for a, b in zip(fold, fold_again)) and fold_rel <= FOLD_REL):
                raise AssertionError(f"fold {name} {tag}: {fold_rel} of max |plain| (bar {FOLD_REL}), or two calls differ")

            def k6_with_fold():
                with torch.no_grad():
                    return cuda_conv.fused_affine_conv3_nchw(x, *cuda_conv.fold_groupnorm_film(*fold_args), *args[3:])

            def library_with_norm():
                return F.conv2d(F.group_norm(x, fold_args[1], fold_args[2].to(dtype), fold_args[3].to(dtype)), w_lib, b_lib,
                                padding=1)

            times = dict(
                ms=_device_ms(lambda: cuda_conv.fused_affine_conv3_nchw(*args), reps=20),
                plain_ms=_time_ms(lambda: cuda_conv.fused_affine_conv3_plain(*args[:7]), iters=10),
                library_ms=_device_ms(lambda: F.conv2d(x, w_lib, b_lib, padding=1), reps=20),
                fold_ms=_device_ms(lambda: cuda_conv.fold_groupnorm_film(*fold_args), reps=20),
                fold_plain_ms=_device_ms(lambda: cuda_conv.fold_groupnorm_film_plain(*fold_args), reps=10),
                with_fold_ms=_device_ms(k6_with_fold, reps=20),
                library_with_norm_ms=_device_ms(library_with_norm, reps=20),
            )
            fold_bound = _bound(_nbytes(x, *fold), 8.0 * x.numel(), "f32")
            row[tag] = {"max_abs_err": err, "rel_err": rel, **times, **bound, "macs": macs, "fold_rel_err": fold_rel,
                        "fold_max_abs_err": fold_abs, "fold_bound_ms": fold_bound["bound_ms"], "fold_bound_by": fold_bound["bound_by"]}
            results[f"{tag}_err"] = max(results[f"{tag}_err"], err)
            results[f"{tag}_rel"] = max(results[f"{tag}_rel"], rel)
            results["fold_rel"] = max(results["fold_rel"], fold_rel)
            results["fold_abs"] = max(results["fold_abs"], fold_abs)
            print(f"K6 {tag:4s} N={n} {name}: max_abs_err {err:.3e} ({rel:.2e} of max |plain|, bar {bar:.0e}); two calls "
                  f"bit-identical; device times (20 calls back to back): kernel {times['ms']:.4f} ms, F.conv2d alone "
                  f"{times['library_ms']:.4f} ms; plain {times['plain_ms']:.4f} ms (one event pair a call); "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: {macs / 1e9:.1f} G multiply-adds, "
                  f"{_nbytes(*args[:7], first) / 1e6:.0f} MB), {bound['bound_ms'] / times['ms']:.2f} of it; fold {fold_rel:.1e} of "
                  f"max |plain| (bar {FOLD_REL:.0e}), two calls bit-identical, {times['fold_ms']:.4f} ms against its plain "
                  f"version's {times['fold_plain_ms']:.4f} (bound {fold_bound['bound_ms']:.4f}); K6 with its fold "
                  f"{times['with_fold_ms']:.4f} ms, F.group_norm + F.conv2d {times['library_with_norm_ms']:.4f} ms")
        results["shapes"][name] = row
    before = cuda_conv.fused_affine_conv3_nchw.launches
    try:
        cuda_conv.fused_affine_conv3_nchw(args[0], args[1].clone().requires_grad_(), *args[2:])
    except RuntimeError as e:
        print(f"K6: a CUDA input that requires a gradient is refused ({e})")
    else:
        raise AssertionError("K6 took an input that requires a gradient")
    if cuda_conv.fused_affine_conv3_nchw.launches != before:
        raise AssertionError("K6 launched on an input that requires a gradient")
    return results


def phase_teacher_poser(torch, workdir: str, teacher_params) -> dict:
    """The teacher poser at full width: the CLI from five .pt files, then
    ``mode_07.create_poser`` and ``mode_12.create_poser``."""
    import PIL.Image

    from tha4_tpu_torch.charmodel.synthetic import synthetic_character_image
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.ops import cuda_conv, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_07, mode_12
    from tha4_tpu_torch.tools import bench

    files = {key: os.path.join(workdir, f"{key}.pt") for key in mode_07.NETWORK_KEYS}
    for key, path in files.items():
        torch.save(teacher_params[key], path)
    png = os.path.join(workdir, "character.png")
    PIL.Image.fromarray(synthetic_character_image(512, SEED), "RGBA").save(png)
    module_args = [a for key, path in files.items() for a in ("--module-file", f"{key}={path}")]
    root = os.path.dirname(os.path.abspath(__file__))
    runs = [
        ("f32", ["--output", os.path.join(workdir, "pose_f32.png")], [os.path.join(workdir, "pose_f32.png")]),
        ("bf16", ["--bf16", "--output", os.path.join(workdir, "pose_bf16.png")], [os.path.join(workdir, "pose_bf16.png")]),
        ("bf16 sweep", ["--bf16", "--sweep", "head_y", "--frames", "3", "--output-dir", os.path.join(workdir, "sweep")],
         [os.path.join(workdir, "sweep", f"head_y_{i:03d}.png") for i in range(3)]),
    ]
    for tag, extra, pngs in runs:
        cmd = [sys.executable, "-m", "tha4_tpu_torch.apps.full_manual_poser", *module_args, "--input", png,
               "--set", "head_y=0.5", "--device", "cuda", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or not all(os.path.isfile(p) and PIL.Image.open(p).size == (512, 512) for p in pngs):
            raise AssertionError(f"tha4-torch-pose {tag}: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
        print(f"tha4-torch-pose {tag} (five full-width .pt files, {seconds:.1f} s with the load): wrote {len(pngs)} PNG(s); "
              + "; ".join(line.split("/")[-1] for line in proc.stdout.strip().splitlines()))

    image = torch.from_numpy(imagecodec.load_image_hwc(png)).cuda()  # one object: the decomposer runs once
    results = {"launches": {}, "ms": {}}
    sizes = [512] * 6 + [256] * 5 + [192] * 8 + [128] * 14
    for tag, dtype in [("bf16", torch.bfloat16), ("f32", torch.float32)]:
        poser = mode_07.create_poser(module_file_names=files, compute_dtype=dtype, device="cuda")
        poses = list(bench.pose_sweep(poser.pose_parameters, POSES))
        per_call, outs = [], []
        counters = (cuda_conv.fused_affine_conv3_nchw, cuda_warp.grid_sample_fast, cuda_conv.fold_groupnorm_film)
        for c in counters:
            c.launches = 0
        for pose in poses:
            before = [c.launches for c in counters]
            outs.append(poser.get_posing_outputs(image, pose))
            per_call.append(tuple(c.launches - b for c, b in zip(counters, before)))
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        results["launches"][tag] = launches
        if any(c != (K6_PER_TEACHER_CALL, 5, K6_PER_TEACHER_CALL) for c in per_call) or poser.prologue_cache_misses != 1:
            raise AssertionError(f"mode_07.create_poser {tag}: (K6, K2, fold) launches per call {per_call}, "
                                 f"prologue cache misses {poser.prologue_cache_misses} (expected 1)")
        for o in outs:
            if [tuple(t.shape) for t in o] != [(1, s, s, t.shape[3]) for s, t in zip(sizes, o)] or len(o) != 33:
                raise AssertionError(f"mode_07.create_poser {tag}: outputs {[tuple(t.shape) for t in o]}")
            if not all(t.dtype == torch.float32 and t.device.type == "cuda" and bool(torch.isfinite(t).all()) for t in o):
                raise AssertionError(f"mode_07.create_poser {tag}: an output is not finite f32 on the card")
        line = (f"mode_07.create_poser {tag}: {POSES} poses of one image, 33 finite f32 outputs each, the decomposer run once "
                f"(prologue cache misses {poser.prologue_cache_misses}); K6, K2 and fold launches per call {per_call[0]}")
        if tag == "f32":
            # cuDNN's default algorithms are not all deterministic: two runs of
            # the same teacher may differ by a rounding, which the random
            # full-width cascade carries to ~1e-4.  So the poser is held
            # against compute_outputs in cuDNN's deterministic mode, on a new
            # image object (the prologue runs again, in that mode too).
            pose = torch.from_numpy(poses[-1])[None].cuda()
            with torch.no_grad():
                repeat = [mode_07.compute_outputs(poser.params, image[None], pose) for _ in range(2)]
            nondeterministic = max(float((a - b).abs().max()) for a, b in zip(*repeat))
            torch.backends.cudnn.deterministic = True
            try:
                fresh = image.clone()
                got = poser.get_posing_outputs(fresh, poses[-1])
                with torch.no_grad():
                    inline = mode_07.compute_outputs(poser.params, fresh[None], pose)
            finally:
                torch.backends.cudnn.deterministic = False
            diff = max(float((a - b).abs().max()) for a, b in zip(got, inline))
            line += (f"; against mode_07.compute_outputs of the same teacher on the card (cuDNN deterministic): max abs "
                     f"diff {diff:.3e} (bar {POSER_F32_ATOL:.0e}); two compute_outputs calls in cuDNN's default mode "
                     f"differ by {nondeterministic:.3e}")
            if not diff <= POSER_F32_ATOL:
                raise AssertionError(f"mode_07.create_poser f32: {diff} from compute_outputs")
        print(line)

        def pose_once(i=[0]):
            poser.get_posing_outputs(image, poses[i[0] % POSES])
            i[0] += 1
        for _ in range(2):
            pose_once()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            pose_once()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000.0)
        results["ms"][tag] = statistics.median(times)
        print(f"mode_07.create_poser {tag}: {results['ms'][tag]:.3f} ms per pose at B=1 (median of 10, host clock to "
              f"synchronize, image on the card, prologue cached)")
        del poser, outs
        torch.cuda.empty_cache()

    face = mode_12.create_poser(module_file_names={k: files[k] for k in mode_12.NETWORK_KEYS}, compute_dtype=torch.bfloat16)
    cuda_conv.fused_affine_conv3_nchw.launches = 0
    cuda_warp.grid_sample_fast.launches = 0
    outs = face.get_posing_outputs(image, bench.pose_sweep(face.pose_parameters, 1)[0])
    torch.cuda.synchronize()
    launches = (cuda_conv.fused_affine_conv3_nchw.launches, cuda_warp.grid_sample_fast.launches)
    shapes = [tuple(t.shape[:3]) for t in outs]
    if shapes != [(1, s, s) for s in [192] * 8 + [128] * 14] or launches != (0, 2) or face.prologue_cache_misses:
        raise AssertionError(f"mode_12.create_poser: outputs {shapes}, (K6, K2) launches {launches}")
    if not all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in outs):
        raise AssertionError("mode_12.create_poser: an output is not finite f32")
    print(f"mode_12.create_poser bf16: 22 finite f32 outputs of the expected shapes, (K6, K2) launches {launches}, no prologue")
    return results


# -- phase 15: the verification slice (Q1, the int8 teacher, tha4-torch-verify and -eval) --

INT8_PEAK_OPS = 1979e12  # dense int8 tensor-core rate of one H100 SXM (NVIDIA's data sheet)
INT8_STEPS = 8  # phase_int8: steps a student with and without --teacher-int8
CAL_SEED = 0xCA11B


def _q1_bound(x, cout: int, k: int) -> dict:
    """Q1's least time: x read once, the int8 weight, scale and bias, the
    output written once (x's dtype), over the memory rate; 2 x its
    multiply-adds over the int8 tensor-core peak."""
    n, h, w, cin = x.shape
    nbytes = x.numel() * x.element_size() + k * k * cin * cout + 4 * cout + (n * h * w + 1) * cout * x.element_size()
    macs = n * h * w * cout * k * k * cin
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2.0 * macs / INT8_PEAK_OPS * 1e3
    return {"bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else "operations", "macs": macs}


def _q1_library_ms(torch, x, w8, x_scale: float, k: int) -> dict:
    """The yardstick: ``torch._int_mm`` (int8 x int8 -> int32) on an
    ``F.unfold`` im2col of the quantized x, alone and with the quantize and
    the unfold; never used by the port."""
    import torch.nn.functional as F

    n, h, w, cin = x.shape
    cout = w8.shape[3]
    inv = float(np.float32(1.0 / x_scale))
    b = w8.permute(2, 0, 1, 3).reshape(cin * k * k, cout).contiguous()

    def im2col():
        xq = torch.round(x.float() * inv).clamp(-127, 127).permute(0, 3, 1, 2)
        cols = F.unfold(xq, k, padding=k // 2) if k > 1 else xq.reshape(n, cin, h * w)
        return cols.transpose(1, 2).reshape(n * h * w, cin * k * k).to(torch.int8)

    a = im2col()
    return {"library_ms": _device_ms(lambda: torch._int_mm(a, b), reps=20, warmup=2),
            "library_with_unfold_ms": _device_ms(lambda: torch._int_mm(im2col(), b), reps=20, warmup=2)}


def _q1_time_signature(torch, x, layout, scale: float, plain_args: tuple) -> dict:
    """One (dtype, signature)'s timing on its path input: Q1, and cuDNN's
    conv of the same shape in x's dtype (channels last, no bias, as at the
    costliest), 10 calls back to back each, beside Q1's bound."""
    from tha4_tpu_torch.ops import cuda_int8_conv

    _, w8, w_s, _, pad, bias = plain_args
    k = w8.shape[0]
    ms = _device_ms(lambda: cuda_int8_conv.int8_conv(x, layout, w_s, scale, pad, bias), reps=10, warmup=2)
    xc, wc = x.permute(0, 3, 1, 2), w8.permute(3, 2, 0, 1).to(x.dtype)
    cudnn_ms = _device_ms(lambda: torch.nn.functional.conv2d(xc, wc, None, padding=pad), reps=10, warmup=2)
    bound = _q1_bound(x, w8.shape[3], k)
    return {"ms": ms, "cudnn_ms": cudnn_ms, **bound, "bound_share": bound["bound_ms"] / ms}


def _check_q1_at_the_path(torch, fn, teacher, images, poses, scales, errs: dict, costliest: dict, table: dict,
                          model: str) -> None:
    """One int8 call of ``fn`` with every eligible conv's Q1 output held
    against its plain version on the same card inputs, bit for bit, at each
    (dtype, signature) not yet in ``errs`` (which records the error), and
    each such pair timed (``_q1_time_signature``) into ``table``, which also
    counts the convs of each pair a call of ``model``; the inputs of the
    costliest conv of each dtype (most multiply-adds) are kept in
    ``costliest`` for its detailed timing."""
    from tha4_tpu_torch.ops import cuda_int8_conv, quant

    real = quant.conv_hook

    def checked(ctx, conv, x):
        out = real(ctx, conv, x)
        sig = quant.nchw_signature(x, conv)
        key = ("bf16" if x.dtype == torch.bfloat16 else "f32", json.dumps(sig))
        row = table.setdefault(key, {"dtype": key[0], "signature": sig, "convs": {}})
        row["convs"][model] = row["convs"].get(model, 0) + 1
        if key not in errs:
            xs, k = x.permute(0, 2, 3, 1), conv.kernel_size[0]
            layout, w_s = quant._int8_weights(conv)
            w8 = cuda_int8_conv._hwio(layout)
            bias = quant._int8_bias(conv, x.dtype)
            scale = ctx.scales[ctx.idx - 1]["scale"]
            plain_args = (xs, w8, w_s, scale, conv.padding[0], bias)
            plain = cuda_int8_conv.int8_conv_plain(*plain_args)
            errs[key] = float((out.permute(0, 2, 3, 1).float() - plain.float()).abs().max())
            if not torch.equal(out.permute(0, 2, 3, 1), plain) or not torch.equal(real(ctx_again(ctx), conv, x), out):
                raise AssertionError(f"Q1 {key}: differs from its plain version by {errs[key]}, or from itself")
            row.update(_q1_time_signature(torch, xs, layout, scale, plain_args), batch=xs.shape[0])
            macs = xs.shape[0] * xs.shape[1] * xs.shape[2] * w8.shape[3] * k * k * xs.shape[3]
            if macs > costliest.get(key[0], {}).get("macs", 0):
                costliest[key[0]] = {"signature": key[1], "macs": macs, "x": xs.contiguous(), "w8": w8,
                                     "args": (layout, w_s, scale, conv.padding[0], bias)}
        return out

    def ctx_again(ctx):
        """The scope as it stood at this conv: a second call of the hook
        takes the same scale without moving the scope on."""
        again = quant._Apply(ctx.scales)
        again.idx = ctx.idx - 1
        return again

    quant.conv_hook = checked
    try:
        with torch.no_grad(), quant.apply_scales(scales):
            fn(teacher, images, poses)
        torch.cuda.synchronize()
    finally:
        quant.conv_hook = real


def _damped_teacher_files(torch, teacher_params, directory: str) -> None:
    """The five full-width teacher state dicts as ``.pt`` files, the heads
    damped as tests/test_verify.py:83-91 damps its stand-ins."""
    from tha4_tpu_torch.poser.modes import mode_07

    gen = torch.Generator().manual_seed(SEED + 50)
    params = {key: {k: v.clone() for k, v in sd.items()} for key, sd in teacher_params.items()}
    damped = [("eyebrow_morphing_combiner", "morphed_eyebrow_layer_grid_change.weight", 0.02),
              ("face_morpher", "iris_mouth_grid_change.weight", 0.02),
              ("body_morpher", "body.last.2.weight", 0.01), ("body_morpher", "body.last.2.bias", 0.01),
              ("upscaler", "body.last.2.weight", 0.01), ("upscaler", "body.last.2.bias", 0.01),
              ("upscaler", "coarse_image_conv.weight", 0.05), ("upscaler", "coarse_image_conv.bias", 0.05)]
    for net, name, std in damped:
        params[net][name] = torch.randn(params[net][name].shape, generator=gen) * std
    os.makedirs(directory, exist_ok=True)
    for key in mode_07.NETWORK_KEYS:
        torch.save(params[key], os.path.join(directory, f"{key}.pt"))


def phase_int8(torch, workdir: str, teacher_params, image) -> dict:
    """Phase 15: Q1 against its plain version at every eligible signature of
    the full-width mode_07 (B = 8) and mode_12, bf16 and f32, and timed at
    the costliest; the int8 teacher's body labels against bf16 and f32;
    ``tha4-torch-distill --teacher-int8`` through ``pipeline.run_config``
    (8 steps a student, beside the run without it); ``tha4-torch-verify``
    on a written full-width bundle; ``tha4-torch-eval --against``."""
    import contextlib
    import io

    import PIL.Image

    from tha4_tpu_torch.apps import evaluate, verify
    from tha4_tpu_torch.charmodel.synthetic import (
        synthetic_face_mask, write_distiller_inputs, write_random_character_model,
    )
    from tha4_tpu_torch.distiller import pipeline, recipes
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.ops import cuda_build, cuda_conv, cuda_int8_conv, cuda_poly_sin, cuda_siren, cuda_warp, quant
    from tha4_tpu_torch.poser.modes import mode_07, mode_12
    from tha4_tpu_torch.utils import fidelity, precision

    # The phase's own preconditions, whatever ran before it: the kernels
    # built, full-f32 products (no TF32 in cuBLAS or cuDNN) and cuDNN's
    # default algorithms.
    t_phase = time.perf_counter()
    cuda_build.library()
    precision.set_full_f32()
    torch.backends.cudnn.deterministic = False
    results = {}
    cal_poses = sample_poses(torch.Generator().manual_seed(CAL_SEED), TRAIN_BATCH).cuda()
    poses = sample_poses(torch.Generator().manual_seed(SEED + 51), TRAIN_BATCH).cuda()

    # (a) Q1 at every eligible signature, bf16 and f32, mode_07 at B = 8 and mode_12.
    errs, costliest, teachers, scales, table = {}, {}, {}, {}, {}
    for tag, dtype in [("bf16", torch.bfloat16), ("f32", torch.float32)]:
        teachers[tag] = mode_07.Teacher.from_params(teacher_params).freeze(dtype, "cuda")
        images = image.to(dtype).expand(TRAIN_BATCH, -1, -1, -1)
        scales[tag] = quant.run_calibration(mode_07.compute_outputs, teachers[tag], images, cal_poses.to(dtype))
        _check_q1_at_the_path(torch, mode_07.compute_outputs, teachers[tag], images, poses.to(dtype), scales[tag], errs,
                              costliest, table, "mode_07")
        face = mode_12.FaceTeacher.from_params({k: teacher_params[k] for k in mode_12.NETWORK_KEYS}).freeze(dtype, "cuda")
        s12 = quant.run_calibration(mode_12.compute_outputs, face, images, cal_poses.to(dtype))
        _check_q1_at_the_path(torch, mode_12.compute_outputs, face, images, poses.to(dtype), s12, errs, costliest, table,
                              "mode_12")
        results[f"convs_07_{tag}"], results[f"convs_12_{tag}"] = len(scales[tag]), len(s12)
        del face
    print(f"Q1: equal to its plain version bit for bit, and two calls to each other, at all {len(errs)} (dtype, "
          f"signature) pairs of the full-width mode_07 at B = {TRAIN_BATCH} ({results['convs_07_bf16']} eligible convs a "
          f"call) and mode_12 ({results['convs_12_bf16']}), bf16 and f32")
    # Every pair timed: Q1 beside cuDNN's conv and the bound, and Q1's total
    # a teacher call (the convs of the pair a call x its time).
    signatures = sorted(table.values(), key=lambda r: (r["dtype"], -r["macs"]))
    totals = {}
    for r in signatures:
        print(f"Q1 {r['dtype']:4s} {json.dumps(r['signature']):42s} x{json.dumps(r['convs']):30s} {r['ms']:.4f} ms, "
              f"cuDNN {r['cudnn_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), share {r['bound_share']:.3f}")
        for model, n in r["convs"].items():
            for key, v in (("ms", r["ms"]), ("cudnn_ms", r["cudnn_ms"]), ("bound_ms", r["bound_ms"])):
                name = f"{model}_{r['dtype']}"
                totals.setdefault(name, {}).setdefault(key, 0.0)
                totals[name][key] += n * v
    results.update(signatures=[{k: v for k, v in r.items()} for r in signatures], q1_per_call=totals)
    print(f"Q1 a teacher call at B = {TRAIN_BATCH} (the convs x their times): {totals}")

    # Q1 timed at the costliest signature (most multiply-adds) at B = 8.
    timed = {}
    for tag, c in costliest.items():
        x, w8, (layout, w_s, scale, pad, bias) = c["x"], c["w8"], c["args"]
        k = w8.shape[0]
        ms = _device_ms(lambda: cuda_int8_conv.int8_conv(x, layout, w_s, scale, pad, bias), reps=20, warmup=2)
        plain_ms = _time_ms(lambda: cuda_int8_conv.int8_conv_plain(x, w8, w_s, scale, pad, bias), iters=3, warmup=1)
        bound = _q1_bound(x, w8.shape[3], k)
        lib = _q1_library_ms(torch, x, w8, scale, k)
        conv_ms = _device_ms(lambda: torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w8.permute(3, 2, 0, 1).to(x.dtype),
                                                                None, padding=pad), reps=20, warmup=2)
        timed[tag] = {"signature": c["signature"], "ms": ms, "plain_ms": plain_ms, **bound, **lib, "cudnn_ms": conv_ms,
                      "tops": 2.0 * bound["macs"] / ms / 1e9}
        print(f"Q1 {tag} at {c['signature']} (B = {x.shape[0]}): {ms:.4f} ms ({timed[tag]['tops']:.1f} TOP/s), plain "
              f"{plain_ms:.3f}, bound {bound['bound_ms']:.4f} ({bound['bound_by']}), torch._int_mm {lib['library_ms']:.4f} "
              f"(with the quantize and unfold {lib['library_with_unfold_ms']:.4f}), cuDNN {tag} conv {conv_ms:.4f}")
    max_err = max(errs.values())
    costliest.clear()

    # (b) The int8 teacher's body labels against bf16 and f32 at B = 8.
    with torch.no_grad():
        int8 = recipes.body_teacher_targets(teachers["bf16"], image, poses, torch.bfloat16, scales["bf16"])
        bf16 = recipes.body_teacher_targets(teachers["bf16"], image, poses, torch.bfloat16)
        f32 = recipes.body_teacher_targets(teachers["f32"], image, poses, torch.float32)
    labels = {}
    for name, (a, b) in {"int8_vs_bf16": (int8, bf16), "int8_vs_f32": (int8, f32), "bf16_vs_f32": (bf16, f32)}.items():
        psnr = min(_psnr(a[i].float(), b[i].float()) for i in (0, 1, 3))
        grid_l1 = float((a[2].float() - b[2].float()).abs().mean())
        if not math.isfinite(grid_l1) or not psnr > 0.0:
            raise AssertionError(f"int8 teacher labels {name}: PSNR {psnr}, grid L1 {grid_l1}")
        labels[name] = {"psnr_min": psnr, "grid_change_l1": grid_l1}
    k6, q1 = cuda_conv.fused_affine_conv3_nchw.launches, cuda_int8_conv.int8_conv.launches
    with torch.no_grad():
        teacher_ms = {
            "int8": _time_ms(lambda: recipes.body_teacher_targets(teachers["bf16"], image, poses, torch.bfloat16, scales["bf16"]),
                             iters=5, warmup=1),
            "bf16": _time_ms(lambda: recipes.body_teacher_targets(teachers["bf16"], image, poses, torch.bfloat16), iters=5, warmup=1),
        }
    q1_ms = totals["mode_07_bf16"]["ms"]
    teacher_ms["int8_q1"], teacher_ms["int8_glue"] = q1_ms, teacher_ms["int8"] - q1_ms
    print(f"int8 teacher (bf16 activations) body labels at B = {TRAIN_BATCH}: {labels}; a call {teacher_ms['int8']:.2f} ms "
          f"(Q1 {q1_ms:.2f}, the rest {teacher_ms['int8_glue']:.2f}) against bf16 {teacher_ms['bf16']:.2f} ms")
    del teachers, int8, bf16, f32
    torch.cuda.empty_cache()

    # (c) tha4-torch-distill --teacher-int8 through run_config, 8 steps a student, and without it.
    counters = [cuda_siren.sine_chain_t, cuda_siren.sine_chain_t_bwd, cuda_warp.grid_sample_fast,
                cuda_warp.grid_sample_train_forward, cuda_warp.grid_sample_grid_backward, cuda_poly_sin.poly_sin_forward,
                cuda_poly_sin.poly_sin_backward, cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film,
                cuda_int8_conv.int8_conv]
    distill = {}
    total = INT8_STEPS * TRAIN_BATCH
    step_ms = {}
    make_face, make_body = recipes.make_face_distill_group, recipes.make_body_distill_group

    def timed_steps(make, kind):
        """The trainer's groups (one step each at batch 8 on one card), each
        step's ms the group's over its steps."""
        def made(*args, **kwargs):
            group = make(*args, **kwargs)

            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = group(*a, **k)
                torch.cuda.synchronize()
                n = len(a[2])
                step_ms.setdefault(kind, []).extend([(time.perf_counter() - t0) * 1e3 / n] * n)
                return out
            return run
        return made

    recipes.make_face_distill_group, recipes.make_body_distill_group = (timed_steps(make_face, "face"),
                                                                        timed_steps(make_body, "body"))
    try:
        for arm, int8_on in (("int8", True), ("bf16", False)):
            config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, f"distill_{arm}"), seed=SEED + 52,
                                                                 batch_size=TRAIN_BATCH))
            step_ms.clear()
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            pipeline.run_config(config, target="all", teacher_params_07=teacher_params, compute_dtype=torch.bfloat16,
                                device="cuda", face_total_examples=total, body_total_examples=total,
                                examples_per_checkpoint=total, examples_per_snapshot=total, teacher_int8=int8_on)
            torch.cuda.synchronize()
            launches = {c.__name__: c.launches for c in counters}
            files = {tag: os.path.join(config.prefix, f"teacher_int8_scales_{tag}.json") for tag in ("07", "12")}
            row = {"launches": launches, "s": time.perf_counter() - t0,
                   "ms_step": {k: statistics.median(v[1:]) for k, v in step_ms.items()},
                   "steps": {k: len(v) for k, v in step_ms.items()}}
            if int8_on:
                convs = {tag: len(quant.load_scales(path)) for tag, path in files.items()}
                expected = INT8_STEPS * (convs["07"] + convs["12"])
                unfused = ("fused_affine_conv3_nchw", "fold_groupnorm_film")  # the U-Nets' K6 path, not taken under int8
                if launches["int8_conv"] != expected or any(bool(launches[k]) == (k in unfused) for k in launches):
                    raise AssertionError(f"--teacher-int8: launches {launches}, expected {expected} Q1 (8 steps x "
                                         f"{convs['07']} + 8 x {convs['12']} eligible convs), every student and warp "
                                         "kernel, and no K6 or fold")
                row["convs"] = convs
            elif any(os.path.exists(p) for p in files.values()) or launches["int8_conv"]:
                raise AssertionError(f"without --teacher-int8: launches {launches}, scales files written")
            if row["steps"] != {"face": INT8_STEPS, "body": INT8_STEPS}:
                raise AssertionError(f"distill {arm}: steps {row['steps']}")
            if not os.path.isfile(config.character_model_yaml_file_name()):
                raise AssertionError(f"distill {arm}: no character model written")
            distill[arm] = row
            print(f"tha4-torch-distill {'--teacher-int8' if int8_on else '(bf16 teacher)'} via run_config, "
                  f"{INT8_STEPS} steps a student at B = {TRAIN_BATCH}: {row['s']:.1f} s, ms/step {row['ms_step']}, "
                  f"launches {launches}" + (f", scales files with {row['convs']} convs" if int8_on else ""))
    finally:
        recipes.make_face_distill_group, recipes.make_body_distill_group = make_face, make_body

    # (d) tha4-torch-verify on a written full-width bundle, no reference source.
    data = os.path.join(workdir, "verify_data")
    _damped_teacher_files(torch, teacher_params, os.path.join(data, "tha4"))
    torch.save(torch.from_numpy(fidelity.random_pose_suite(64, seed=SEED + 53)), os.path.join(data, "pose_dataset.pt"))
    model_dir = os.path.join(data, "character_models", "lambda_00")
    write_random_character_model(model_dir, seed=SEED + 54)
    os.makedirs(os.path.join(data, "images"), exist_ok=True)
    PIL.Image.fromarray(synthetic_face_mask(512, SEED + 54)).save(os.path.join(data, "images", "lambda_00_face_mask.png"))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = verify.main(["--data-dir", data, "--poses", "2", "--examples", "64",
                          "--reference-src", os.path.join(workdir, "no_reference_source")])
    verify_s = time.perf_counter() - t0
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    statuses = {k: v["status"] for k, v in summary["checks"].items()}
    want = {"teacher files load": "ok", "teacher weight conversion": "ok", "golden render": "skip",
            "int8 teacher fidelity": "ok", "pose dataset": "ok", "distill smoke (loss decrease)": "ok",
            "student fidelity eval": "skip"}
    if rc != 0 or statuses != want:
        raise AssertionError(f"tha4-torch-verify: exit {rc}, checks {summary['checks']}")
    print(f"tha4-torch-verify on the full-width bundle: exit 0 in {verify_s:.1f} s; int8 check "
          f"{summary['checks']['int8 teacher fidelity']}; distill smoke {summary['checks']['distill smoke (loss decrease)']}")

    # (e) tha4-torch-eval --against between two written random character models, f32 and bf16.
    other = write_random_character_model(os.path.join(workdir, "eval_b"), seed=SEED + 55)
    yaml_a = os.path.join(model_dir, "character_model.yaml")
    evals = {}
    for dtype in ("f32", "bf16"):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = evaluate.main(["--model", yaml_a, "--against", other, "--poses", "4", "--dtype", dtype])
        stats = json.loads(out.getvalue().strip().splitlines()[-1])
        stats["s"] = time.perf_counter() - t0
        if rc != 0 or stats["frames"] != 4 or not all(math.isfinite(stats[k]) for k in ("psnr_min", "ssim_mean",
                                                                                          "lpips_proxy_mean")):
            raise AssertionError(f"tha4-torch-eval --against {dtype}: exit {rc}, {stats}")
        evals[dtype] = stats
    print(f"tha4-torch-eval --against: {evals}")
    results.update(timed=timed, max_err=max_err, labels=labels, teacher_ms=teacher_ms, distill=distill,
                   verify={"s": verify_s, "checks": summary["checks"]}, eval=evals, seconds=time.perf_counter() - t_phase)
    print(f"phase 15: {results['seconds']:.1f} s")
    return results


# -- phase 16: data parallelism ------------------------------------------------

DDP_STEPS = 4  # steps a student in every data-parallel run, at batch 8
DDP_PG_TIMEOUT_S = 300  # a rank waits this long at a collective
DDP_LAUNCH_TIMEOUT_S = 600  # a launch's whole run
# Two gloo ranks (4 poses each, teacher lookahead K = 2) against one
# process (8 poses, K = 1), 4 steps a student.  f32: the JAX package's bars
# for its sharded run against one device (tests/test_multichip.py:200-205,
# loss rtol 1e-5 there 2e-5, parameters atol 1e-5), which the face holds.
# The body does not: a rank sums its student's gradients over 4 x 512^2
# pixels where one process sums over 8 x 512^2, in another order.  Read on
# an H100, the first step's gradients are then 2.2e-6 of their largest
# apart with no sign changed, and four Adam steps through the omega = 30
# sines carry that to 7.3e-5 in the parameters and 7.4e-4 in the last
# losses.  One process whose student forward and backward are split 4 + 4
# as the ranks split them (``_split_body_group``) does the same sums in the
# same order: it reads the ranks' run bit for bit, and the plain one
# process's distance from it is theirs to the digit, so the batch split is
# the whole cause.  The f32 body is held to the JAX bars against that
# witness, and against the plain one process, as bf16 below, to a tenth
# of bf16's own distance from f32 in the last losses and the update.  Both
# f32 students' first-step gradients, scaled by their largest, must stay
# within the CPU test's bars (tests/test_torch_parallel.py: face 1e-5,
# body 1e-4).
# bf16: the student's weights are rounded to bf16 (2^-8 of themselves) at
# every step's packing, and the sine chain carries a flipped rounding on,
# so an equally valid order of sums moves the run along bf16's own noise:
# read on an H100, the face's last loss 1.8e-3 and its update 2.2e-2
# relative from one process.
# The measure of that noise is the one-process bf16 run's distance from the
# one-process f32 run from the same start; the two ranks must stay within
# a fraction of it, in the last losses and in the update over the run,
# |dp_ranks - dp_one| / |dp_one| over all parameters.
DDP_F32_LOSS_RTOL = 1e-5
DDP_F32_PARAM_ATOL = 1e-5
DDP_F32_GRAD_ATOL = {"face": 1e-5, "body": 1e-4}
DDP_F32_BODY_SHARE = 0.1
DDP_BF16_SHARE = 0.5
# Kernel launches of one step of each student, and of one teacher call.
DDP_STUDENT_LAUNCHES = {"face": {"sine_chain_t": 1, "sine_chain_t_bwd": 1},
                        "body": {"grid_sample_train_forward": 1, "grid_sample_grid_backward": 1, "poly_sin_forward": 9,
                                 "poly_sin_backward": 9}}
DDP_TEACHER_LAUNCHES = {"face": {"grid_sample_fast": 2},
                        "body": {"grid_sample_fast": 5, "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL,
                                 "fold_groupnorm_film": K6_PER_TEACHER_CALL}}


def _teacher_ms_a_pose(torch, jobs) -> dict:
    """The production (bf16) teachers' labels, in ms a pose, at 4 and at
    ``recipes.TEACHER_SATURATION_BATCH`` (8) poses a call: lookahead pays
    on this card where a call of 8 labels a pose faster than one of 4."""
    from tha4_tpu_torch.distiller import recipes

    image, dtype = jobs.character_image(), jobs.compute_dtype
    poses = jobs.pose_source.batch(torch.Generator().manual_seed(SEED + 71), recipes.TEACHER_SATURATION_BATCH).cuda()
    label = {"face": lambda p: recipes.face_teacher_targets(jobs.face_teacher(), image, p, dtype),
             "body": lambda p: recipes.body_teacher_targets(jobs.body_teacher(), image, p, dtype)}
    return {kind: {n: _time_ms(lambda: fn(poses[:n]), iters=10, warmup=2) / n for n in (4, len(poses))}
            for kind, fn in label.items()}


class _StopAtSnapshot(Exception):
    """Raised on every rank after a snapshot's write: a run stopped there."""


def _ddp_counters():
    from tha4_tpu_torch.ops import cuda_conv, cuda_poly_sin, cuda_siren, cuda_warp

    return [cuda_siren.sine_chain_t, cuda_siren.sine_chain_t_bwd, cuda_warp.grid_sample_fast,
            cuda_warp.grid_sample_train_forward, cuda_warp.grid_sample_grid_backward, cuda_poly_sin.poly_sin_forward,
            cuda_poly_sin.poly_sin_backward, cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film]


def _ddp_config(config_path: str, prefix: str, num_gpus: int):
    from tha4_tpu_torch.distiller.config import DistillerConfig

    os.makedirs(prefix, exist_ok=True)
    return dataclasses.replace(DistillerConfig.load(config_path), prefix=prefix, num_gpus=num_gpus)


def _ddp_kwargs(teacher_params, dtype, per_checkpoint: int) -> dict:
    """``DistillationJobs``'s arguments: the full-width random teachers,
    the shipped students, DDP_STEPS steps a student on the card."""
    total = DDP_STEPS * TRAIN_BATCH
    return dict(teacher_params_07=teacher_params, compute_dtype=dtype, device="cuda", face_total_examples=total,
                body_total_examples=total, examples_per_checkpoint=per_checkpoint, examples_per_snapshot=per_checkpoint)


def _split_body_group(torch, jobs, parts: int = 2):
    """The body trainer's ``train_group`` in one process (K = 1) with the
    student's forward and backward split as ``parts`` ranks split them:
    the teacher labels the global batch, each part's gradient of its own
    mean loss is divided by ``parts`` and the parts summed, as DDP averages
    them; the losses are the parts' mean, as ``mesh.mean_over_ranks``."""
    from tha4_tpu_torch.distiller import recipes

    teacher, image, dtype = jobs.body_teacher(), jobs.character_image(), jobs.compute_dtype
    batch = jobs.config.body_morpher_batch_size
    per = batch // parts

    def group(student, optimizer, gens, lrs, weights_list):
        for gen, lr, weights in zip(gens, lrs, weights_list):
            poses = jobs.local_poses(gen, batch)
            labels = recipes.body_teacher_targets(teacher, image, poses, dtype)
            grads, named = None, []
            for i in range(parts):
                part = slice(i * per, (i + 1) * per)
                optimizer.zero_grad(set_to_none=True)
                total, terms = recipes.body_loss(student, tuple(t[part] for t in labels), poses[part], weights, dtype,
                                                 jobs.student_mixed)
                total.backward()
                g = [p.grad / parts for p in student.parameters()]
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                named.append(terms)
            for p, g in zip(student.parameters(), grads):
                p.grad = g
            for param_group in optimizer.param_groups:
                param_group["lr"] = lr
            optimizer.step()
        return {k: sum(n[k].detach().float() for n in named) / parts for k in named[0]}

    return group


def _ddp_train(torch, jobs, kinds=("face", "body"), split_body: bool = False) -> dict:
    """The students' DDP_STEPS steps through their trainers: the final
    parameters, the first step's gradients (as Adam takes them, averaged
    over the ranks), the last step's losses (over the global batch) and ms
    a step, each group timed between two synchronizes.  ``split_body``:
    the body's steps run as ``_split_body_group``."""
    out = {}
    for kind in kinds:
        trainer = jobs.make_face_trainer() if kind == "face" else jobs.make_body_trainer()
        init = {k: v.detach().float().cpu().numpy() for k, v in trainer._fresh_state()[0].state_dict().items()}
        ms, first_grads = [], {}
        if kind == "body" and split_body:
            trainer.train_group = _split_body_group(torch, jobs)
        make_optimizer, group = trainer.make_optimizer, trainer.train_group

        def hooked(module):
            optimizer = make_optimizer(module)
            names = [n for n, _ in module.named_parameters()]

            def before_step(opt, args, kwargs):
                if not first_grads:
                    first_grads.update({n: p.grad.detach().float().cpu().numpy()
                                        for n, p in zip(names, opt.param_groups[0]["params"])})

            optimizer.register_step_pre_hook(before_step)
            return optimizer

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = group(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / len(args[2]))
            return metrics

        trainer.make_optimizer, trainer.train_group = hooked, timed
        done = trainer.train()
        out[kind] = {"init": init, "params": {k: v.detach().float().cpu().numpy() for k, v in done["module"].state_dict().items()},
                     "grads": first_grads, "loss": {k: float(v) for k, v in done["metrics"].items()}, "ms": ms,
                     "lookahead": trainer.cfg.lookahead}
    return out


def _ddp_rank_main(config_path: str, workdir: str, teacher_params) -> dict:
    """A rank of phase 16 (a) and (c): both students in bf16 and f32
    through their trainers, then the DAG through ``run_config`` twice, once
    stopped at the body's snapshot and rerun."""
    import torch

    from tha4_tpu_torch.distiller import pipeline
    from tha4_tpu_torch.parallel import mesh
    from tha4_tpu_torch.training import checkpoint as ckpt
    from tha4_tpu_torch.training.trainer import Trainer
    from tha4_tpu_torch.utils import precision

    precision.set_full_f32()  # as the parent runs: a spawned rank inherits neither setting
    torch.backends.cudnn.deterministic = True
    out = {"rank": mesh.rank(), "world": mesh.world_size(), "backend": torch.distributed.get_backend(),
           "device": torch.cuda.get_device_name(torch.cuda.current_device())}
    counters = _ddp_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    total = DDP_STEPS * TRAIN_BATCH
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        jobs = pipeline.DistillationJobs(_ddp_config(config_path, os.path.join(workdir, f"ddp_{tag}_ranks"), 2),
                                         **_ddp_kwargs(teacher_params, dtype, total))
        out[tag] = _ddp_train(torch, jobs)
        del jobs
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30

    writes, exports, stopped = [], [], []
    save_state, export, trainer_save = ckpt.save_state, pipeline.DistillationJobs._export_student, Trainer._save

    def counted_save(directory, *args):
        writes.append(os.path.relpath(directory, workdir))
        save_state(directory, *args)

    def counted_export(checkpoint_file, module, dest):
        exports.append(os.path.relpath(dest, workdir))
        export(checkpoint_file, module, dest)

    kwargs = _ddp_kwargs(teacher_params, torch.bfloat16, total // 2)
    config_a = _ddp_config(config_path, os.path.join(workdir, "dag_ranks_a"), 2)
    config_b = _ddp_config(config_path, os.path.join(workdir, "dag_ranks_b"), 2)

    def stopping_save(self, directory, module, optimizer, examples_seen, key):
        trainer_save(self, directory, module, optimizer, examples_seen, key)  # rank 0 writes, both pass the barrier
        if directory == ckpt.snapshot_dir(config_b.body_morpher_prefix()) and examples_seen == total // 2 and not stopped:
            stopped.append(examples_seen)
            raise _StopAtSnapshot()

    ckpt.save_state, pipeline.DistillationJobs._export_student = counted_save, staticmethod(counted_export)
    try:
        pipeline.run_config(config_a, "all", **kwargs)
        Trainer._save = stopping_save
        try:
            pipeline.run_config(config_b, "all", **kwargs)
        except _StopAtSnapshot:
            pass
        Trainer._save = trainer_save
        pipeline.run_config(config_b, "all", **kwargs)
    finally:
        ckpt.save_state, pipeline.DistillationJobs._export_student, Trainer._save = save_state, staticmethod(export), trainer_save
    out["dag"] = {"writes": writes, "exports": exports, "stopped": stopped}
    return out


def _nccl_rank_main(config_path: str, workdir: str, teacher_params) -> dict:
    """Phase 16 (b), one rank over NCCL: a DDP face step and a DDP body step
    in f32, cuDNN deterministic, against the plain step from the same
    student, poses and labels; the largest difference of the losses,
    gradients and parameters."""
    import torch

    from tha4_tpu_torch.distiller import pipeline, recipes
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.parallel import mesh
    from tha4_tpu_torch.utils import precision

    precision.set_full_f32()
    torch.backends.cudnn.deterministic = True
    jobs = pipeline.DistillationJobs(_ddp_config(config_path, os.path.join(workdir, "nccl"), 1),
                                     **_ddp_kwargs(teacher_params, torch.float32, DDP_STEPS * TRAIN_BATCH))
    out = {"backend": torch.distributed.get_backend(), "world": mesh.world_size(),
           "deterministic": torch.backends.cudnn.deterministic}
    poses = jobs.pose_source.batch(torch.Generator().manual_seed(SEED + 60), TRAIN_BATCH).cuda()
    mask = torch.from_numpy(recipes.load_face_mask_crop(jobs.config.face_mask_image_file_name)).cuda()
    weights = recipes.default_body_phases().loss_weights(recipes.BODY_LOSS_TERMS, 0)
    for kind in ("face", "body"):
        runs = []
        for wrapped in (False, True):
            gen = torch.Generator().manual_seed(SEED + 61)
            if kind == "face":
                student = siren.SirenFaceMorpher(jobs.face_student_cfg, generator=gen).cuda()
                step = recipes.make_face_distill_step(jobs.face_teacher(), jobs.character_image(), mask, torch.float32)
                args = (1e-4,)
            else:
                student = siren.SirenMorpher(jobs.body_student_cfg, generator=gen).cuda()
                step = recipes.make_body_distill_step(jobs.body_teacher(), jobs.character_image(), torch.float32, True)
                args = (1e-4, weights)
            named = step(mesh.data_parallel(student) if wrapped else student, recipes.make_adam(student), poses, *args)
            runs.append([named[k] for k in sorted(named)] + [p.grad for p in student.parameters()]
                        + [p.detach() for p in student.parameters()])
        out[kind] = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*runs))
    return out


def _pt_bytes(config) -> dict:
    out = {}
    for kind in ("face", "body"):
        with open(getattr(config, f"character_model_{kind}_morpher_file_name")(), "rb") as f:
            out[kind] = f.read()
    return out


def phase_ddp(torch, workdir: str, teacher_params, card: str) -> dict:
    """Phase 16, data-parallel distillation on the one card: (a) two gloo
    ranks against one process, both students, bf16 and f32; (b) one NCCL
    rank's DDP step against the plain step; (c) ``num_gpus: 2`` through
    ``run_config`` without ranks (one process, as ``num_gpus: 1``), and a
    two-rank ``run_config`` stopped at a snapshot and rerun."""
    import logging

    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.distiller import pipeline
    from tha4_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    config_path = write_distiller_inputs(os.path.join(workdir, "ddp_inputs"), seed=SEED + 70, batch_size=TRAIN_BATCH)
    total = DDP_STEPS * TRAIN_BATCH
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # The one-process runs: (a)'s references (the f32 body's also with
        # its forward split as the ranks split it), and (c)'s num_gpus 1 and 2.
        single = {}
        for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            jobs = pipeline.DistillationJobs(_ddp_config(config_path, os.path.join(workdir, f"ddp_{tag}_one"), 1),
                                             **_ddp_kwargs(teacher_params, dtype, total))
            single[tag] = _ddp_train(torch, jobs)
            if tag == "bf16":
                jobs_bf16 = jobs
            del jobs
        jobs = pipeline.DistillationJobs(_ddp_config(config_path, os.path.join(workdir, "ddp_f32_split"), 1),
                                         **_ddp_kwargs(teacher_params, torch.float32, total))
        split = _ddp_train(torch, jobs, kinds=("body",), split_body=True)["body"]
        del jobs
        pts, warned = {}, {}
        for n in (1, 2):
            config = _ddp_config(config_path, os.path.join(workdir, f"dag_num_gpus_{n}"), n)
            records = []
            handler = logging.Handler(logging.WARNING)
            handler.emit = records.append
            pipeline.logger.addHandler(handler)
            try:
                pipeline.run_config(config, "all", **_ddp_kwargs(teacher_params, torch.bfloat16, total // 2))
            finally:
                pipeline.logger.removeHandler(handler)
            warned[n] = any("config requests 2 GPUs" in r.getMessage() for r in records)
            pts[n] = _pt_bytes(config)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    teacher_ms = _teacher_ms_a_pose(torch, jobs_bf16)
    del jobs_bf16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = mesh.launch(_ddp_rank_main, 2, "gloo", args=(config_path, workdir, teacher_params),
                        timeout_s=DDP_LAUNCH_TIMEOUT_S, pg_timeout_s=DDP_PG_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = mesh.launch(_nccl_rank_main, 1, "nccl", args=(config_path, workdir, teacher_params),
                          timeout_s=DDP_LAUNCH_TIMEOUT_S, pg_timeout_s=DDP_PG_TIMEOUT_S)
    nccl_s = time.perf_counter() - t0

    # (a) the ranks against each other and against one process.
    r0, r1 = ranks
    if (r0["world"], r1["world"], r0["backend"]) != (2, 2, "gloo"):
        raise AssertionError(f"ddp: ranks {r0['world']}, {r1['world']} over {r0['backend']}")
    def grad_distance(a: dict, one: dict) -> dict:
        """The first step's gradients: the largest difference over the
        largest magnitude, tensor by tensor, and the signs that differ (Adam's
        first step moves a parameter by lr x its gradient's sign)."""
        return {"grad_rel": max(float(np.abs(a[k] - one[k]).max() / max(np.abs(one[k]).max(), 1e-30)) for k in one),
                "sign_flips": int(sum((np.sign(a[k]) != np.sign(one[k])).sum() for k in one)),
                "n": int(sum(one[k].size for k in one))}

    def distance(a: dict, one: dict) -> dict:
        """``a``'s last losses and parameters against ``one``'s, and the
        update over the run from their common start."""
        moved = [(a["params"][k] - one["init"][k], one["params"][k] - one["init"][k]) for k in one["params"]]
        return {"loss_rel": max(abs(a["loss"][k] - one["loss"][k]) / abs(one["loss"][k]) for k in one["loss"]),
                "param_abs": max(float(np.abs(a["params"][k] - one["params"][k]).max()) for k in one["params"]),
                "update_rel": (math.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in moved))
                               / math.sqrt(sum(float((y ** 2).sum()) for _, y in moved)))}

    print(f"ddp (a): the bf16 teachers' labels, ms a pose at 4 and 8 poses a call, one process ({card}): "
          + "; ".join(f"{kind} {t[4]:.3f} and {t[8]:.3f}" for kind, t in teacher_ms.items()))
    compared, failed = {}, []
    for tag in ("bf16", "f32"):
        for kind in ("face", "body"):
            a, b, one = r0[tag][kind], r1[tag][kind], single[tag][kind]
            if (a["lookahead"], one["lookahead"]) != (2, 1):
                raise AssertionError(f"ddp {tag} {kind}: lookahead {a['lookahead']} in a rank, {one['lookahead']} alone")
            for part in ("params", "grads"):
                if not all(np.array_equal(a[part][k], b[part][k]) for k in a[part]):
                    raise AssertionError(f"ddp {tag} {kind}: the two ranks' {part} differ")
            row = distance(a, one) | {"first_grads": grad_distance(a["grads"], one["grads"]), "ms_rank0": a["ms"],
                                      "ms_rank1": b["ms"], "ms_one": one["ms"]}
            noise = row["bf16_from_f32"] = distance(single["bf16"][kind], single["f32"][kind])
            extra = ""
            if tag == "f32" and kind == "face":
                ok = row["loss_rel"] <= DDP_F32_LOSS_RTOL and row["param_abs"] <= DDP_F32_PARAM_ATOL
                bars = f"bars {DDP_F32_LOSS_RTOL:g} and {DDP_F32_PARAM_ATOL:g}"
            else:
                share = DDP_F32_BODY_SHARE if tag == "f32" else DDP_BF16_SHARE
                ok = all(row[k] <= share * noise[k] for k in ("loss_rel", "update_rel"))
                bars = (f"bars {share:g} x the one-process bf16 run's distance from f32: losses "
                        f"{noise['loss_rel']:.3g}, update {noise['update_rel']:.3g}")
            if tag == "f32":
                grad_bar = DDP_F32_GRAD_ATOL[kind]
                ok = ok and row["first_grads"]["grad_rel"] <= grad_bar
                extra = (f"; first step's gradients {row['first_grads']['grad_rel']:.3g} of their largest apart (bar "
                         f"{grad_bar:g}), {row['first_grads']['sign_flips']} of {row['first_grads']['n']} signs flipped")
            if tag == "f32" and kind == "body":
                # The witness: one process with the student's forward split as the ranks split it.
                row["split"] = distance(a, split) | {"first_grads": grad_distance(a["grads"], split["grads"])}
                row["split_from_one"] = distance(split, one) | {"first_grads": grad_distance(split["grads"], one["grads"])}
                held = row["split"]["loss_rel"] <= DDP_F32_LOSS_RTOL and row["split"]["param_abs"] <= DDP_F32_PARAM_ATOL
                ok = ok and held
                extra += (f"; against one process with its forward split 4 + 4: losses {row['split']['loss_rel']:.3g}, "
                          f"parameters {row['split']['param_abs']:.3g}, first gradients "
                          f"{row['split']['first_grads']['grad_rel']:.3g} (bars {DDP_F32_LOSS_RTOL:g} and "
                          f"{DDP_F32_PARAM_ATOL:g}: {'held' if held else 'FAILED'}); that split run from the plain one: "
                          f"losses {row['split_from_one']['loss_rel']:.3g}, parameters "
                          f"{row['split_from_one']['param_abs']:.3g}, the update {row['split_from_one']['update_rel']:.3g}")
            compared[f"{tag}_{kind}"] = row
            print(f"ddp (a) {tag} {kind}: ranks bit-equal; against one process: losses {row['loss_rel']:.3g} relative, "
                  f"parameters {row['param_abs']:.3g} apart, the update {row['update_rel']:.3g} relative ({bars}){extra}: "
                  f"{'held' if ok else 'FAILED'}; ms a step rank 0 {[round(x, 2) for x in a['ms']]}, rank 1 "
                  f"{[round(x, 2) for x in b['ms']]}, one process {[round(x, 2) for x in one['ms']]}")
            if not ok:
                failed.append(f"{tag} {kind}")
    if failed:
        raise AssertionError(f"ddp (a): {failed} fail their bars")
    expected = dict.fromkeys((c.__name__ for c in _ddp_counters()), 0)
    for kind in ("face", "body"):
        for name, n in DDP_STUDENT_LAUNCHES[kind].items():
            expected[name] += 2 * DDP_STEPS * n  # two dtypes
        for name, n in DDP_TEACHER_LAUNCHES[kind].items():
            expected[name] += 2 * (DDP_STEPS // 2) * n  # a teacher call labels a group of K = 2 steps
    for r in ranks:
        if r["launches"] != expected:
            raise AssertionError(f"ddp: rank {r['rank']} launched {r['launches']}, expected {expected}")
    print(f"ddp (a): two gloo ranks sharing one card ({card}; not a scaling figure), {DDP_STEPS} steps a student at "
          f"batch {TRAIN_BATCH} (4 a rank, teacher lookahead K = 2), each rank's launches {r0['launches']}, peak device "
          f"memory a rank {r0['peak_gb']:.1f} / {r1['peak_gb']:.1f} GiB; the launch took {ranks_s:.1f} s")

    # (b) NCCL at world size 1.
    if (nccl["backend"], nccl["world"], nccl["deterministic"]) != ("nccl", 1, True) or nccl["face"] or nccl["body"]:
        raise AssertionError(f"ddp (b): {nccl}")
    print(f"ddp (b): one NCCL rank, f32, cuDNN deterministic: the DDP face and body steps equal the plain steps bit for "
          f"bit (largest difference {nccl['face']}, {nccl['body']}); {nccl_s:.1f} s with the launch")

    # (c) run_config: num_gpus 2 without ranks, and two ranks stopped at a snapshot.
    if not warned[2] or warned[1] or pts[1] != pts[2]:
        raise AssertionError(f"ddp (c): num_gpus 2 on one card warned {warned[2]} (num_gpus 1: {warned[1]}), "
                             f"exports equal {pts[1] == pts[2]}")
    dag = r0["dag"]
    ckpts = [w for w in dag["writes"] if "/checkpoint/" in w]
    if r1["dag"]["writes"] or r1["dag"]["exports"] or len(ckpts) != len(set(ckpts)) or dag["stopped"] != [total // 2]:
        raise AssertionError(f"ddp (c): rank 0 {dag}, rank 1 {r1['dag']}")
    if len(dag["exports"]) != 4 or len(ckpts) != 2 * 2 * 3:  # two runs, two students, checkpoints 0-2
        raise AssertionError(f"ddp (c): exports {dag['exports']}, checkpoint writes {ckpts}")
    if _pt_bytes(_ddp_config(config_path, os.path.join(workdir, "dag_ranks_a"), 2)) != _pt_bytes(
            _ddp_config(config_path, os.path.join(workdir, "dag_ranks_b"), 2)):
        raise AssertionError("ddp (c): the two-rank DAG stopped at the body's snapshot and rerun exports other .pt files")
    print(f"ddp (c): num_gpus 2 on one card warns and exports the num_gpus 1 run's .pt files bit for bit; two gloo ranks "
          f"through run_config: rank 0 wrote {len(ckpts)} checkpoints once each and {len(dag['exports'])} exports, rank 1 "
          f"none; stopped at the body's snapshot at {total // 2} and rerun, the .pt files equal the uninterrupted run's")
    seconds = time.perf_counter() - t_phase
    print(f"phase 16: {seconds:.1f} s")
    return {"compared": compared, "launches": r0["launches"], "peak_gb": [r0["peak_gb"], r1["peak_gb"]],
            "teacher_ms_a_pose": teacher_ms, "ranks_s": ranks_s, "nccl_s": nccl_s, "seconds": seconds, "card": card}


# The face morpher's published widths (tha4_tpu/models/face_morpher.py:38-44),
# the configuration of phase 17's resize-conv nets, at batch 8.
REST_NET = dict(image_size=192, input_channels=4, start_channels=64, bottleneck_image_size=24, num_bottleneck_blocks=6,
                max_channels=512)
REST_BATCH = 8
REST_CPU_BATCH = 1  # the card's first sample against the CPU (every norm is per sample)
# Phase 17's bars.  f32 card against the same module on the CPU (TF32 off),
# error over each level's largest |CPU| value: two f32 orders of sums
# through 14-16 convs, 100x the ~1e-6 the teacher's f32 U-Nets read.  bf16
# against f32 on the card, over each level's largest and mean |f32| value:
# every conv and norm output rounded to bf16 (2^-8) through 14-16 conv and
# norm layers, a few percent in all; about three times the readings on an
# H100 (0.021-0.036 and 0.021-0.031).  sn_u after three advance_spectral
# steps, card against CPU: unit vectors of length <= 512.
REST_F32_REL = 1e-4
REST_BF16_MAX_REL = 0.1
REST_BF16_MEAN_REL = 0.075
REST_SN_U_ATOL = 1e-5
REST_SN_STEPS = 3
CODEC_ATOL = 2e-6  # tests/test_native_codec.py:27
MOCAP_RATE = 240.0  # packets a second from the loopback sender
MOCAP_FRAMES = 300
MOCAP_PORT = 49350  # the in-process receivers; the puppeteer listens on 49983


def _rest_nets():
    """Phase 17's networks: both resize-conv nets at REST_NET, both upsample
    modes, the U-Net under three block configurations."""
    from tha4_tpu_torch.models import resize_conv as R
    from tha4_tpu_torch.ops import blocks as B

    blocks = {"instance+sn": B.BlockConfig(use_spectral_norm=True), "instance": B.BlockConfig(),
              "separable+sn": B.BlockConfig(use_spectral_norm=True, separable=True)}
    nets = {}
    for mode in ("bilinear", "nearest"):
        nets[f"encoder_decoder/{mode}"] = lambda g, m=mode: R.ResizeConvEncoderDecoder(
            R.ResizeConvEncoderDecoderConfig(**REST_NET, upsample_mode=m), g)
        for name, block in blocks.items():
            nets[f"unet/{name}/{mode}"] = lambda g, m=mode, b=block: R.ResizeConvUNet(
                R.ResizeConvUNetConfig(**REST_NET, upsample_mode=m, block=b), g)
    return nets


def _rel(a, b, reduce) -> float:
    return float(reduce((a.float() - b.float()).abs()) / reduce(b.float().abs()))


def _zoo_macs(torch, module, x) -> int:
    """Multiply-adds of every conv in one forward of ``module`` on ``x``,
    from the shapes: each output (a transposed conv: each input) element
    takes one weight slice, weight[0]."""
    from tha4_tpu_torch.ops.blocks import WrappedConv

    total = [0]

    def count(conv, inputs, out):
        total[0] += (inputs[0] if conv.transpose else out).numel() * conv.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in module.modules() if isinstance(m, WrappedConv)]
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _zoo_train_ms(torch, module, x) -> tuple:
    """ms a forward + backward + Adam step (CUDA events, median of 5) and the
    peak device memory in GiB over those steps."""
    opt = torch.optim.Adam(module.parameters(), lr=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = sum((o.float() ** 2).mean() for o in module(x))
        loss.backward()
        opt.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(step, iters=5, warmup=2)
    return ms, torch.cuda.max_memory_allocated() / 2**30


def _phase_zoo(torch) -> dict:
    """17(a): the block zoo at the face morpher's widths on the card."""
    from tha4_tpu_torch.ops import blocks as B

    gen = torch.Generator().manual_seed(SEED + 17)
    x_cpu = torch.randn(REST_BATCH, REST_NET["input_channels"], REST_NET["image_size"], REST_NET["image_size"],
                        generator=gen)
    x = x_cpu.cuda()
    size, shapes = REST_NET["bottleneck_image_size"], []
    while size <= REST_NET["image_size"]:
        channels = min(REST_NET["start_channels"] * REST_NET["image_size"] // size, REST_NET["max_channels"])
        shapes.append((REST_BATCH, channels, size, size))
        size *= 2
    out = {}
    for i, (name, make) in enumerate(_rest_nets().items()):
        cpu = make(torch.Generator().manual_seed(SEED + 170 + i))
        card = copy.deepcopy(cpu).cuda()
        with torch.no_grad():
            ref = cpu(x_cpu[:REST_CPU_BATCH])
            f32 = card(x)
            bf16 = card(x.bfloat16())
        if [tuple(o.shape) for o in f32] != shapes or \
                any(o.dtype != torch.bfloat16 for o in bf16) or not all(bool(torch.isfinite(o).all()) for o in f32 + bf16):
            raise AssertionError(f"{name}: outputs {[tuple(o.shape) for o in f32]} / {[o.dtype for o in bf16]}, or not finite")
        r = {
            "f32_rel": max(_rel(o[:REST_CPU_BATCH].cpu(), c, torch.max) for o, c in zip(f32, ref)),
            "bf16_max_rel": max(_rel(b, f, torch.max) for b, f in zip(bf16, f32)),
            "bf16_mean_rel": max(_rel(b, f, torch.mean) for b, f in zip(bf16, f32)),
        }
        del f32, bf16, ref
        if not r["f32_rel"] <= REST_F32_REL:
            raise AssertionError(f"{name}: f32 card vs CPU {r['f32_rel']:.3e} over {REST_F32_REL}")
        if not (r["bf16_max_rel"] <= REST_BF16_MAX_REL and r["bf16_mean_rel"] <= REST_BF16_MEAN_REL):
            raise AssertionError(f"{name}: bf16 vs f32 {r['bf16_max_rel']:.3e} / {r['bf16_mean_rel']:.3e} over "
                                 f"{REST_BF16_MAX_REL} / {REST_BF16_MEAN_REL}")
        sn_cpu = {k: v for k, v in cpu.state_dict().items() if k.endswith("sn_u")}
        if sn_cpu:
            start = {k: v.clone() for k, v in sn_cpu.items()}
            for _ in range(REST_SN_STEPS):
                B.advance_spectral(cpu)
                B.advance_spectral(card)
            sn_card = {k: v for k, v in card.state_dict().items() if k.endswith("sn_u")}
            r["sn_u_err"] = max(float((sn_card[k].cpu() - v).abs().max()) for k, v in sn_cpu.items())
            r["sn_u_moved"] = max(float((v - start[k]).abs().max()) for k, v in sn_cpu.items())
            r["sn_convs"] = len(sn_cpu)
            if not (r["sn_u_err"] <= REST_SN_U_ATOL and r["sn_u_moved"] > 1e-3):
                raise AssertionError(f"{name}: sn_u after {REST_SN_STEPS} steps, card vs CPU {r['sn_u_err']:.3e} "
                                     f"(bar {REST_SN_U_ATOL}), moved {r['sn_u_moved']:.3e}")
        for tag, xt in (("f32", x), ("bf16", x.bfloat16())):
            with torch.no_grad():
                r[f"fwd_ms_{tag}"] = _time_ms(lambda: card(xt), iters=10, warmup=2)
            r[f"step_ms_{tag}"], r[f"peak_gib_{tag}"] = _zoo_train_ms(torch, card, xt)
        r["params_m"] = sum(p.numel() for p in cpu.parameters()) / 1e6
        r["gmacs"] = _zoo_macs(torch, card, x) / 1e9
        r["products_bound_ms_bf16"] = 2e3 * r["gmacs"] * 1e9 / PEAK_FLOPS["bf16"]
        print(f"zoo {name} ({r['params_m']:.2f} M params, {r['gmacs']:.1f} G multiply-adds a forward, the products "
              f"{r['products_bound_ms_bf16']:.3f} ms at the bf16 peak): f32 card vs CPU {r['f32_rel']:.3e}, bf16 vs f32 max "
              f"{r['bf16_max_rel']:.3e} mean {r['bf16_mean_rel']:.3e}"
              + (f", sn_u x{r['sn_convs']} after {REST_SN_STEPS} steps card vs CPU {r['sn_u_err']:.3e}" if sn_cpu else "")
              + f"; fwd {r['fwd_ms_f32']:.3f} / {r['fwd_ms_bf16']:.3f} ms, fwd+bwd+Adam {r['step_ms_f32']:.3f} / "
              f"{r['step_ms_bf16']:.3f} ms (f32 / bf16, B={REST_BATCH}), peak {r['peak_gib_f32']:.2f} / "
              f"{r['peak_gib_bf16']:.2f} GiB")
        out[name] = r
        del cpu, card
        torch.cuda.empty_cache()
    return out


def _phase_codec() -> dict:
    """17(b): a 512^2 RGBA decode, native against numpy."""
    import PIL.Image

    from tha4_tpu_torch.core import imagecodec

    rgba = np.random.default_rng(SEED).integers(0, 256, size=(512, 512, 4), dtype=np.uint8)
    rgba[..., 3] = np.maximum(rgba[..., 3], 1)
    pil = PIL.Image.fromarray(rgba, "RGBA")
    native = imagecodec.load_image_hwc(pil)
    plain = imagecodec.load_image_hwc(pil, native=False)
    err = float(np.abs(native - plain).max())
    if native.shape != (512, 512, 4) or not err <= CODEC_ATOL:
        raise AssertionError(f"codec: native {native.shape} vs numpy, max_abs_err {err} over {CODEC_ATOL}")
    ms = {}
    for tag, native_flag in (("native", True), ("numpy", False)):
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            imagecodec.load_image_hwc(pil, native=native_flag)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[tag] = statistics.median(times)
    print(f"codec: 512^2 RGBA load_image_hwc native vs numpy max_abs_err {err:.3e}; {ms['native']:.3f} ms native, "
          f"{ms['numpy']:.3f} ms numpy (median of 20, host clock, decode from a PIL image)")
    return {"max_abs_err": err, "ms": ms}


class _MocapSender:
    """A loopback iFacialMocap sender at MOCAP_RATE packets a second, each
    packet's sequence number in a blendshape the converter ignores
    (tongueOut = seq / 100) and jawOpen stepping through the converter's
    unclamped range (0.1-0.4), so that nearly every packet changes the pose;
    records each packet's send time."""

    def __init__(self, port: int):
        import threading

        self.port = port
        self.sent = []  # send time by sequence number
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        import socket

        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            t0 = time.perf_counter()
            while not self._stop.is_set():
                seq = len(self.sent)
                packet = f"tongueOut&{seq}|jawOpen&{11 + seq % 29}|=head#1.0,2.0,3.0,0,0,0|".encode()
                self.sent.append(time.perf_counter())
                tx.sendto(packet, ("127.0.0.1", self.port))
                self._stop.wait(max(0.0, t0 + (seq + 1) / MOCAP_RATE - time.perf_counter()))
        finally:
            tx.close()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            raise AssertionError("the mocap sender did not stop")


def _phase_mocap(torch, workdir: str) -> dict:
    """17(c): the receiver, native and socket, between student frames on the
    card; then tha4-torch-puppeteer --source udp."""
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.charmodel.synthetic import write_random_character_model
    from tha4_tpu_torch.mocap import ifacialmocap_constants as C
    from tha4_tpu_torch.mocap.ifacialmocap import IFacialMocapReceiver
    from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter

    yaml_path = write_random_character_model(os.path.join(workdir, "model"), seed=SEED)
    model = CharacterModel.load(yaml_path)
    poser = model.get_poser(torch.bfloat16, "cuda")
    image = torch.from_numpy(model.get_character_image()).cuda()
    converter = IFacialMocapPoseConverter()
    out = {}
    for tag, use_native in (("native", True), ("socket", False)):
        rx = IFacialMocapReceiver(port=MOCAP_PORT, use_native=use_native)
        rx.start()
        native = rx.draining_natively
        ages, newest, empty, frame_ms = [], 0, 0, []
        try:
            with _MocapSender(MOCAP_PORT) as sender:
                time.sleep(0.05)
                blend = None
                for _ in range(MOCAP_FRAMES):
                    got = rx.read_pose()
                    t_read = time.perf_counter()
                    if got is None:
                        empty += 1
                    else:
                        seq = round(got[C.TONGUE_OUT] * 100)
                        ages.append((t_read - sender.sent[seq]) * 1e3)
                        newest += seq == len(sender.sent) - 1
                        blend = got
                    if blend is not None:
                        t0 = time.perf_counter()
                        poser.pose(image, np.asarray(converter.convert(blend), np.float32))
                        torch.cuda.synchronize()
                        frame_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            rx.close()
        if native != use_native or len(ages) < MOCAP_FRAMES // 4:
            raise AssertionError(f"receiver {tag}: native drain {native}, {len(ages)} packets over {MOCAP_FRAMES} reads")
        out[tag] = {"age_ms_p50": float(np.percentile(ages, 50)), "age_ms_p99": float(np.percentile(ages, 99)),
                    "newest_share": newest / len(ages), "reads": MOCAP_FRAMES, "packets": len(ages), "empty_reads": empty,
                    "frame_ms_p50": float(np.percentile(frame_ms, 50))}
        print(f"receiver {tag}: {MOCAP_FRAMES} reads between bf16 student frames ({out[tag]['frame_ms_p50']:.3f} ms "
              f"median), sender at {MOCAP_RATE:.0f} packets/s: {len(ages)} packets, {empty} reads with nothing new; "
              f"age p50 {out[tag]['age_ms_p50']:.3f} ms, p99 {out[tag]['age_ms_p99']:.3f} ms; newest packet sent "
              f"in {out[tag]['newest_share']:.3f} of reads")
    with _MocapSender(49983):
        out["puppeteer"] = _puppeteer_run("puppeteer --source udp (native receiver)", [
            "--model", yaml_path, "--source", "udp", "--frames", "30", "--dtype", "bf16"],
            expect="Listening for iFacialMocap packets on UDP 49983 (native drain thread)")
    return out


def phase_rest(torch) -> dict:
    """Phase 17: the block zoo, the native codec and the native receiver."""
    from tha4_tpu_torch.utils import precision

    t0 = time.perf_counter()
    precision.set_full_f32()
    zoo = _phase_zoo(torch)
    codec = _phase_codec()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rest_") as workdir:
        mocap = _phase_mocap(torch, workdir)
    seconds = time.perf_counter() - t0
    print(f"phase 17 (the block zoo, codec, receiver): {seconds:.1f} s; the CPU references on "
          f"{torch.get_num_threads()} threads")
    return {"zoo": zoo, "codec": codec, "mocap": mocap, "seconds": seconds}


def main_rest_alone(torch) -> int:
    """``--phase rest``: phase 17 alone, after the device and the build."""
    rest = phase_rest(torch)
    print(json.dumps(rest))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _body_inputs(torch, workdir: str) -> tuple:
    """The distiller config (synthetic character and mask), the seeded
    full-width random mode_07 and the character image on the card."""
    from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, write_distiller_inputs
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.distiller.config import DistillerConfig

    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill"), seed=SEED, batch_size=TRAIN_BATCH))
    teacher_params = random_teacher_07(torch.Generator().manual_seed(SEED + 8))
    image = torch.from_numpy(imagecodec.load_image_hwc(config.character_image_file_name))[None].cuda()
    return config, teacher_params, image


def main_int8_alone(torch) -> int:
    """``--phase int8``: phase 15 alone, after the device and the build, on
    the inputs the whole run gives it; for a quick check of the
    verification slice.  Its line of results is printed as JSON."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_body_") as workdir:
        _, teacher_params, image = _body_inputs(torch, workdir)
        int8 = phase_int8(torch, workdir, teacher_params, image)
    print(json.dumps({k: int8[k] for k in ("timed", "q1_per_call", "teacher_ms", "seconds")}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main_ddp_alone(torch, card: str) -> int:
    """``--phase ddp``: phase 16 alone, after the device and the build (the
    ranks load the parent's build), on the inputs the whole run gives it."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as workdir:
        _, teacher_params, _ = _body_inputs(torch, workdir)
        ddp = phase_ddp(torch, workdir, teacher_params, card)
    print(json.dumps({k: ddp[k] for k in ("compared", "peak_gb", "teacher_ms_a_pose", "ranks_s", "nccl_s", "seconds", "card")}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# Phase 18, the tools slice: dtype_ab's arms, quant_ab's, and a body run's
# report and checkpoint evaluation, through the tools' own entry points.
# Steps a dtype_ab and a quant_ab arm, at TRAIN_BATCH: at 64 and 32 the
# whole script took 882.5 s on an NVIDIA H100 80GB HBM3 at 700 W (phase
# 18: 150.3 s), over half its 1200 s limit, so they were cut to these.
TOOLS_AB_STEPS = 32
TOOLS_QUANT_STEPS = 16
TOOLS_EVAL_POSES = 64  # the held-out suite: 8 batches
TOOLS_RUN_STEPS = 16  # the body run of (c): two checkpoints of 8 steps
# The checkpoint's evaluation against body_eval on the trainer's own module:
# the same f32 weights, the teacher in cuDNN's deterministic mode.
TOOLS_EVAL_RTOL = 1e-6


def _tool_counters():
    from tha4_tpu_torch.ops import cuda_conv, cuda_int8_conv, cuda_poly_sin, cuda_siren, cuda_warp

    return [cuda_warp.grid_sample_fast, cuda_warp.grid_sample_train_forward, cuda_warp.grid_sample_grid_backward,
            cuda_poly_sin.poly_sin_forward, cuda_poly_sin.poly_sin_backward, cuda_conv.fused_affine_conv3_nchw,
            cuda_conv.fold_groupnorm_film, cuda_siren.sine_chain_t, cuda_siren.sine_chain_t_bwd, cuda_int8_conv.int8_conv]


def _counted(torch, fn, *args):
    """fn(*args) with every launch counter set to 0 just before it; returns
    (its result, {counter: launches}, seconds)."""
    counters = _tool_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in counters}, time.perf_counter() - t0


def _step_launches(steps: int, evals: int, teacher_calls: int = None) -> dict:
    """The launches of ``steps`` body steps (one teacher call each, or
    ``teacher_calls``) and ``evals`` evaluation batches (an f32 teacher call
    and a student forward under no_grad: K2, not K3)."""
    calls = steps if teacher_calls is None else teacher_calls
    return {"grid_sample_fast": 5 * calls + 6 * evals, "grid_sample_train_forward": steps, "grid_sample_grid_backward": steps,
            "poly_sin_forward": 9 * (steps + evals), "poly_sin_backward": 9 * steps,
            "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL * (calls + evals),
            "fold_groupnorm_film": K6_PER_TEACHER_CALL * (calls + evals), "sine_chain_t": 0, "sine_chain_t_bwd": 0,
            "int8_conv": 0}


def _parent_body_step(torch, recipes, mode_07, teacher, image, poses, dtype, mixed, student, optimizer, weights):
    """The body step as the recipe made it before ``teacher_dtype``."""
    with torch.no_grad():
        t = mode_07.compute_outputs(teacher, image.to(dtype).expand(len(poses), -1, -1, -1), poses.to(dtype))
    targets = tuple(t[i] for i in (0, 2, 3, mode_07.INDEX_FACE_MORPHED_FULL))
    optimizer.zero_grad(set_to_none=True)
    return recipes.adam_step(optimizer, *recipes.body_loss(student, targets, poses, weights, dtype, mixed), 1e-4)


def _tools_teacher_dtype_check(torch, teacher_params, image) -> dict:
    """One bf16 selective-f32 body step at B = 8, full width, three ways:
    ``teacher_dtype`` omitted (None), ``teacher_dtype=bf16``, and the step
    as the recipe made it before; cuDNN deterministic.  Losses and
    parameters must be equal bit for bit."""
    from tha4_tpu_torch.distiller import pose_dataset, recipes
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.tools import dtype_ab

    teacher = mode_07.Teacher.from_params(teacher_params).freeze(torch.bfloat16, "cuda")
    poses = pose_dataset.sample_poses(torch.Generator().manual_seed(SEED + 18), TRAIN_BATCH).cuda()
    student0 = dtype_ab.student_init(siren.SirenMorpherConfig())
    runs = []
    for how in ("omitted", "bf16", "parent"):
        student = siren.SirenMorpher()
        student.load_state_dict(student0)
        student.cuda()
        optimizer = recipes.make_adam(student)
        if how == "parent":
            named = _parent_body_step(torch, recipes, mode_07, teacher, image, poses, torch.bfloat16, True, student, optimizer,
                                      dtype_ab.LOSS_WEIGHTS)
        else:
            kw = {} if how == "omitted" else {"teacher_dtype": torch.bfloat16}
            step = recipes.make_body_distill_step(teacher, image, torch.bfloat16, True, **kw)
            named = step(student, optimizer, poses, 1e-4, dtype_ab.LOSS_WEIGHTS)
        runs.append(({k: v.clone() for k, v in named.items()}, {k: v.clone() for k, v in student.state_dict().items()}))
    (named0, state0), *rest = runs
    equal = all(all(torch.equal(named0[k], n[k]) for k in named0) and all(torch.equal(state0[k], s[k]) for k in state0)
                for n, s in rest)
    print(f"phase 18 (a): teacher_dtype None, = bf16 and the recipe's step before it, one bf16 mixed step at B={TRAIN_BATCH}: "
          f"{'bit-equal' if equal else 'NOT bit-equal'} (loss {float(named0['loss']):.6f})")
    if not equal:
        raise AssertionError("phase 18 (a): teacher_dtype=None does not reproduce the recipe's step bit for bit")
    del teacher
    return {"teacher_dtype_none_bit_equal": equal}


def _tools_dtype_ab(torch, workdir: str) -> dict:
    """(a) ``python -m tha4_tpu_torch.tools.dtype_ab``, one call an arm,
    merged into one JSON."""
    from tha4_tpu_torch.tools import dtype_ab

    path = os.path.join(workdir, "dtype_ab.json")
    argv = ["--examples", str(TOOLS_AB_STEPS * TRAIN_BATCH), "--batch", str(TRAIN_BATCH), "--eval-poses", str(TOOLS_EVAL_POSES),
            "--json", path]
    launches, seconds = {}, {}
    for arm in dtype_ab.ARMS:
        record, launches[arm], seconds[arm] = _counted(torch, dtype_ab.main, argv + ["--arms", arm])
        expected = _step_launches(TOOLS_AB_STEPS, TOOLS_EVAL_POSES // TRAIN_BATCH)
        print(f"phase 18 (a): dtype_ab arm {arm}: {TOOLS_AB_STEPS} steps + {TOOLS_EVAL_POSES} eval poses in {seconds[arm]:.1f} s; "
              f"launches {launches[arm]}")
        if launches[arm] != expected:
            raise AssertionError(f"phase 18 (a): arm {arm} launched {launches[arm]}, expected {expected}")
    results = record["results"]
    digests = {arm: results[arm]["poses_sha256"] for arm in dtype_ab.ARMS}
    finite = all(math.isfinite(results[arm][k]) for arm in dtype_ab.ARMS for k in ("train_loss", "blended_l1", "warped_l1",
                                                                                     "grid_l1", "psnr_vs_f32"))
    print(f"phase 18 (a): pose stream sha256 {sorted(set(digests.values()))} over the four arms; losses finite: {finite}")
    if len(set(digests.values())) != 1 or set(results) != set(dtype_ab.ARMS) or not finite:
        raise AssertionError(f"phase 18 (a): the arms saw other poses, or a number is not finite: {results}")
    return {"results": results, "delta": record["delta"], "launches": launches, "seconds": seconds, "card": record["card"]}


def _tools_quant_ab(torch, workdir: str) -> dict:
    """(b) ``python -m tha4_tpu_torch.tools.quant_ab``, bf16 then int8 merged."""
    from tha4_tpu_torch.tools import quant_ab

    path = os.path.join(workdir, "quant_ab.json")
    argv = ["--steps", str(TOOLS_QUANT_STEPS), "--batch", str(TRAIN_BATCH), "--eval-batches", str(TOOLS_EVAL_POSES // TRAIN_BATCH),
            "--json", path]
    launches, seconds = {}, {}
    evals = TOOLS_EVAL_POSES // TRAIN_BATCH
    for arm in quant_ab.ARMS:
        record, launches[arm], seconds[arm] = _counted(torch, quant_ab.main, argv + ["--arms", arm])
        print(f"phase 18 (b): quant_ab arm {arm}: {TOOLS_QUANT_STEPS} steps + {evals} eval batches in {seconds[arm]:.1f} s; "
              f"launches {launches[arm]}")
    q1 = launches["int8"]["int8_conv"]
    per_call = q1 // TOOLS_QUANT_STEPS
    expected = {"bf16": _step_launches(TOOLS_QUANT_STEPS, evals),
                # the calibration's bf16 call and every int8 call leave K6 for the unfused order
                "int8": {**_step_launches(TOOLS_QUANT_STEPS, evals, teacher_calls=TOOLS_QUANT_STEPS + 1),
                         "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL * evals,
                         "fold_groupnorm_film": K6_PER_TEACHER_CALL * evals, "int8_conv": q1}}
    if launches != expected or per_call == 0 or q1 != per_call * TOOLS_QUANT_STEPS:
        raise AssertionError(f"phase 18 (b): launches {launches}, expected {expected} with Q1 a whole number of convs a step")
    results = record["results"]
    if set(results) != set(quant_ab.ARMS) or not record["delta"] or \
            results["bf16"]["poses_sha256"] != results["int8"]["poses_sha256"]:
        raise AssertionError(f"phase 18 (b): the merged record is incomplete or the arms saw other poses: {record}")
    print(f"phase 18 (b): Q1 {per_call} launches a step in the int8 arm, 0 in the bf16 arm; delta int8-bf16 "
          + ", ".join(f"{k} {v:+.5f}" for k, v in record["delta"].items()))
    return {"results": results, "delta": record["delta"], "launches": launches, "seconds": seconds, "q1_per_step": per_call}


def _tools_run(torch, workdir: str) -> dict:
    """(c) A body-only ``run_config`` with ``--random-teacher`` semantics,
    cut to two checkpoints; then ``run_report`` and
    ``eval_body_checkpoint --export`` on its prefix."""
    import contextlib
    import io

    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.convert.torch_weights import load_torch_state_dict
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.distiller import pipeline
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.poser.modes import mode_07
    from tha4_tpu_torch.tools import body_eval, eval_body_checkpoint, run_report
    from tha4_tpu_torch.training import checkpoint as ckpt
    from tha4_tpu_torch.training.trainer import Trainer
    from tha4_tpu_torch.utils import fidelity

    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "tools_run"), seed=SEED + 18,
                                                         batch_size=TRAIN_BATCH))
    total = TOOLS_RUN_STEPS * TRAIN_BATCH
    kwargs = dict(teacher_params_07=mode_07.init(torch.Generator().manual_seed(0), mode_07.TeacherConfig()),
                  compute_dtype=torch.bfloat16, device="cuda", face_total_examples=total, body_total_examples=total,
                  examples_per_checkpoint=total // 2,
                  examples_per_snapshot=total // 2, student_mixed=True)
    trained = []
    train = Trainer.train

    def logged_train(self, target_examples=None):  # a log row every step, so that the report has rows to read
        self.cfg.log_every_seconds = 0.0
        out = train(self, target_examples)
        trained.append(out)
        return out

    Trainer.train = logged_train
    try:
        _, launches, run_s = _counted(torch, lambda: pipeline.run_config(config, target="body", **kwargs))
    finally:
        Trainer.train = train
    expected = _step_launches(TOOLS_RUN_STEPS, 0)
    print(f"phase 18 (c): body-only run_config (--random-teacher), {TOOLS_RUN_STEPS} steps, checkpoints every "
          f"{total // 2} examples, in {run_s:.1f} s; launches {launches}")
    if launches != expected:
        raise AssertionError(f"phase 18 (c): the run launched {launches}, expected {expected}")
    body_prefix = config.body_morpher_prefix()
    with open(os.path.join(body_prefix, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = run_report.main([config.prefix, "--json", "--batch", str(TRAIN_BATCH)])
        phases = run_report.main([config.prefix, "--json", "--phases", "--batch", str(TRAIN_BATCH)])
    body = [r for r in report if r["student"] == "body"]
    print(f"phase 18 (c): run_report: {report}; --phases: {phases}")
    # Each checkpoint task is one Trainer.train call, whose elapsed starts
    # anew: a segment each, covering its examples after its first step's row.
    if (len(body) != 1 or not body[0]["examples_seen"] == rows[-1]["examples_seen"] == total
            or body[0]["segments"] != len(trained) != 2 or len(rows) != TOOLS_RUN_STEPS
            or body[0]["examples_covered"] != total - len(trained) * TRAIN_BATCH or len(phases) != 1):
        raise AssertionError(f"phase 18 (c): the report does not match the log ({len(rows)} rows, last at "
                             f"{rows[-1]['examples_seen']} examples, {len(trained)} train calls)")

    export = os.path.join(workdir, "tools_export")
    result, eval_launches, eval_s = _counted(torch, eval_body_checkpoint.main, [
        config.prefix, "--export", export, "--eval-poses", str(TOOLS_EVAL_POSES), "--batch", str(TRAIN_BATCH)])
    npz = ckpt._load_npz(os.path.join(ckpt.checkpoint_dir(body_prefix, 2), "module_module.npz"))
    exported = siren.SirenMorpher()
    exported.load_state_dict(load_torch_state_dict(os.path.join(export, "body_morpher.pt")))
    same_weights = all(np.array_equal(v.numpy(), npz[k]) for k, v in exported.state_dict().items())
    teacher = mode_07.Teacher.from_params(kwargs["teacher_params_07"]).freeze(torch.float32, "cuda")
    image = torch.from_numpy(imagecodec.load_image_hwc(config.character_image_file_name))[None].cuda()
    direct = body_eval.evaluate_body_student(teacher, trained[-1]["module"], image,
                                             fidelity.random_pose_suite(TOOLS_EVAL_POSES, seed=body_eval.EVAL_SEED), TRAIN_BATCH)
    errs = {k: abs(result[k] - direct[k]) / abs(direct[k]) for k in body_eval.METRICS}
    print(f"phase 18 (c): eval_body_checkpoint (checkpoint {result['checkpoint']}, {result['examples']} examples) in "
          f"{eval_s:.1f} s: " + ", ".join(f"{k} {result[k]:.6f}" for k in body_eval.METRICS)
          + f"; against body_eval on the trainer's module, relative {max(errs.values()):.2e} (bar {TOOLS_EVAL_RTOL:.0e}); "
          f"the export loads into SirenMorpher and equals checkpoint 2: {same_weights}; launches {eval_launches}")
    if (result["checkpoint"], result["examples"]) != (2, total) or not same_weights or max(errs.values()) > TOOLS_EVAL_RTOL:
        raise AssertionError(f"phase 18 (c): checkpoint evaluation {result} against {direct}, export equal {same_weights}")
    if eval_launches != {**_step_launches(0, TOOLS_EVAL_POSES // TRAIN_BATCH)}:
        raise AssertionError(f"phase 18 (c): the evaluation launched {eval_launches}")
    return {"report": report, "phases": phases, "eval": result, "run_s": run_s, "eval_s": eval_s, "launches": launches}


def phase_tools(torch, teacher_params) -> dict:
    """Phase 18: the tools slice on the card, cuDNN deterministic."""
    from tha4_tpu_torch.tools import body_eval

    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as workdir:
            check = _tools_teacher_dtype_check(torch, teacher_params, body_eval.character_image(None, "cuda"))
            torch.cuda.empty_cache()
            ab = _tools_dtype_ab(torch, workdir)
            torch.cuda.empty_cache()
            qab = _tools_quant_ab(torch, workdir)
            torch.cuda.empty_cache()
            run = _tools_run(torch, workdir)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    seconds = time.perf_counter() - t0
    for arm, r in ab["results"].items():
        print(f"phase 18 (a): {arm}: {r['ms_per_step']:.2f} ms/step, train loss {r['train_loss']:.5f}, eval "
              + ", ".join(f"{k} {r[k]:.5f}" for k in body_eval.METRICS))
    print(f"phase 18 (the tools slice): {seconds:.1f} s")
    return {**check, "dtype_ab": ab, "quant_ab": qab, "run": run, "seconds": seconds}


def main_tools_alone(torch) -> int:
    """``--phase tools``: phase 18 alone, after the device and the build."""
    from tha4_tpu_torch.charmodel.synthetic import random_teacher_07

    tools = phase_tools(torch, random_teacher_07(torch.Generator().manual_seed(SEED + 8)))
    print(json.dumps(tools))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# R1's cases: (name, layout, dtype, input shape, output size, with the adjoint).
R1_CASES = [
    ("frame L0->L1", "nchw", "f32", (1, 180, 128, 128), (256, 256), False),
    ("frame L1->L2", "nchw", "f32", (1, 90, 256, 256), (512, 512), False),
    ("train L0->L1", "nhwc", "bf16", (TRAIN_BATCH, 128, 128, 180), (256, 256), True),
    ("train L1->L2", "nhwc", "bf16", (TRAIN_BATCH, 256, 256, 90), (512, 512), True),
]


def _dense_resize(torch, size_in, size_out, channels_last):
    """The port's bilinear resize before R1, the phase's baseline: two f32
    interpolation-matrix GEMMs (the matrices made once, here), H then W, on
    the NCHW view, then a cast to the input dtype."""
    from tha4_tpu_torch.ops.cuda_resize import _taps_np

    mats = []
    for n_in, n_out in zip(size_in, size_out):
        taps = _taps_np(n_in, n_out)
        m = np.zeros((n_in, n_out), dtype=np.float32)
        cols = np.arange(n_out)
        m[taps[:, 0], cols] += taps[:, 2].view(np.float32)
        m[taps[:, 1], cols] += taps[:, 3].view(np.float32)
        mats.append(torch.from_numpy(m).cuda())
    mh, mw = mats

    def nchw(x):
        return torch.matmul(torch.matmul(mh.T, x.float()), mw).to(x.dtype)

    return (lambda x: nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)) if channels_last else nchw


def phase_resize(torch) -> dict:
    """R1 at the frame's and the body student's shapes (phase 19)."""
    from tha4_tpu_torch.ops import cuda_resize

    F = torch.nn.functional
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    results = {"cases": {}, "max_abs_err": 0.0, "max_bwd_err": 0.0}
    launches = cuda_resize.bilinear_resize_forward.launches + cuda_resize.bilinear_resize_backward.launches
    gen = torch.Generator().manual_seed(SEED + 19)
    for name, layout, tag, shape, size, adjoint in R1_CASES:
        dtype, cl = dtypes[tag], layout == "nhwc"
        x = (torch.rand(shape, generator=gen) * 2.0 - 1.0).to("cuda", dtype)
        in_size = shape[1:3] if cl else shape[2:]
        out = cuda_resize.resize(x, size, cl)
        ref = cuda_resize.resize_plain(x, size, cl)
        view = x[:, :, :, 1:] if cl else x[:, :, 1:, :]
        view_out, view_ref = cuda_resize.resize(view, size, cl), cuda_resize.resize_plain(view, size, cl)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max()) for a, b in ((out, ref), (view_out, view_ref)))
        results["max_abs_err"] = max(results["max_abs_err"], err)
        if out.dtype != dtype or not out.is_contiguous() or not torch.equal(out, ref) or not torch.equal(view_out, view_ref):
            raise AssertionError(f"R1 {name}: not equal to its plain version ({out.dtype}, {err:.3e})")
        del view_out, view_ref
        dense = _dense_resize(torch, in_size, size, cl)
        dense_err = float((dense(x).float() - ref.float()).abs().max())
        nchw = x.permute(0, 3, 1, 2) if cl else x

        def library(nchw=nchw, size=size):
            return F.interpolate(nchw, size=size, mode="bilinear", align_corners=False)

        calls = 5 if shape[0] > 1 else 20
        case = {
            "shape": list(shape), "size": list(size), "layout": layout, "dtype": tag,
            "ms": _graph_ms(lambda x=x, size=size, cl=cl: cuda_resize.resize(x, size, cl), calls=calls),
            "dense_ms": _graph_ms(lambda x=x, dense=dense: dense(x), calls=calls),
            "library_ms": _graph_ms(library, calls=calls),
            "plain_ms": _time_ms(lambda x=x, size=size, cl=cl: cuda_resize.resize_plain(x, size, cl), iters=5),
            "dense_max_abs_diff": dense_err,
            **_bound(_nbytes(x, out), 4.0 * out.numel(), "f32" if tag == "f32" else "bf16"),
        }
        case["bound_share"] = case["bound_ms"] / case["ms"]
        text = (f"R1 {name} {layout} {tag} {tuple(shape)} -> {size}: max abs diff from plain {err:.3e} (contiguous and a sliced view); the card's own time (CUDA graph "
                f"of {calls} calls) kernel {case['ms']:.4f} ms, dense GEMMs {case['dense_ms']:.4f} ms "
                f"(max diff {dense_err:.2e}), F.interpolate {case['library_ms']:.4f} ms; bound {case['bound_ms']:.4f} "
                f"ms ({case['bound_by']}), share {case['bound_share']:.3f}; plain {case['plain_ms']:.3f} ms")
        if adjoint:
            g = (torch.rand(out.shape, generator=gen) * 2.0 - 1.0).to("cuda", dtype)
            dx = [cuda_resize.bilinear_resize_backward(g, in_size, cl) for _ in range(2)]
            xr = x.detach().clone().requires_grad_(True)
            (plain_dx,) = torch.autograd.grad(cuda_resize.resize_plain(xr, size, cl), xr, g)
            torch.cuda.synchronize()
            got, want = dx[0].float(), plain_dx.float()
            step = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()).clamp_min(2.0**-126))) - 7)
            err = float(((got - want).abs() / step).max())
            if not torch.equal(dx[0], dx[1]) or not err <= 1.0:
                raise AssertionError(f"R1 {name} adjoint: {err:.3f} bf16 steps from the plain gradient, or two calls differ")
            results["max_bwd_err"] = max(results["max_bwd_err"], err)
            xg = x.detach().clone().requires_grad_(True)

            def fwd_bwd(fn):
                return lambda: torch.autograd.grad(fn(), xg, g)

            def library_nhwc(xg=xg, size=size):
                return F.interpolate(xg.permute(0, 3, 1, 2), size=size, mode="bilinear", align_corners=False).permute(0, 2, 3, 1)

            bwd = _bound(_nbytes(g, dx[0]), 4.0 * g.numel(), "bf16")
            case.update({
                "bwd_ms": _graph_ms(lambda g=g, in_size=in_size, cl=cl: cuda_resize.bilinear_resize_backward(g, in_size, cl),
                                    calls=calls),
                "bwd_bound_ms": bwd["bound_ms"], "bwd_bound_by": bwd["bound_by"],
                "bwd_err_steps": err,
                "pair_autograd_ms": _device_ms(fwd_bwd(lambda: cuda_resize.resize(xg, size, cl)), reps=20, warmup=2),
                "dense_pair_autograd_ms": _device_ms(fwd_bwd(lambda: dense(xg)), reps=20, warmup=2),
                "library_pair_autograd_ms": _device_ms(fwd_bwd(library_nhwc if cl else lambda: library(xg, size)),
                                                       reps=20, warmup=2),
            })
            case["bwd_bound_share"] = case["bwd_bound_ms"] / case["bwd_ms"]
            text += (f"; adjoint {case['bwd_ms']:.4f} ms against {case['bwd_bound_ms']:.4f} ms "
                     f"(share {case['bwd_bound_share']:.3f}), {err:.2f} bf16 steps from the plain gradient at most, two "
                     f"calls bit-identical; forward + backward through autograd, 20 back to back: R1 "
                     f"{case['pair_autograd_ms']:.4f} ms, dense GEMMs {case['dense_pair_autograd_ms']:.4f} ms, "
                     f"F.interpolate {case['library_pair_autograd_ms']:.4f} ms")
        print(text)
        results["cases"][name] = case
        del x, out, ref
        torch.cuda.empty_cache()
    frame = [results["cases"][k] for k in ("frame L0->L1", "frame L1->L2")]
    results["frame_ms"] = sum(c["ms"] for c in frame)
    results["frame_dense_ms"] = sum(c["dense_ms"] for c in frame)
    results["frame_library_ms"] = sum(c["library_ms"] for c in frame)
    results["frame_plain_ms"] = sum(c["plain_ms"] for c in frame)
    results["frame_bound_ms"] = sum(c["bound_ms"] for c in frame)
    results["launches"] = (cuda_resize.bilinear_resize_forward.launches + cuda_resize.bilinear_resize_backward.launches
                           - launches)
    print(f"R1 a frame (both upsamples, f32): kernel {results['frame_ms']:.4f} ms, dense GEMMs "
          f"{results['frame_dense_ms']:.4f} ms, F.interpolate {results['frame_library_ms']:.4f} ms, bound "
          f"{results['frame_bound_ms']:.4f} ms (share {results['frame_bound_ms'] / results['frame_ms']:.3f})")
    return results


def main_resize_alone(torch) -> int:
    """``--phase resize``: phase 19 alone, after the device and the build."""
    print(json.dumps(phase_resize(torch)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main_k1_alone(torch) -> int:
    """``--phase k1``: phase 3 alone, after the device and the build."""
    from tha4_tpu_torch.models import siren

    gen = torch.Generator().manual_seed(SEED)
    face, body = siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen)
    with torch.inference_mode():
        k1 = phase_k1(torch, face, body)
    print(json.dumps(k1))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch

    # Fail before printing anything where the repository is missing.
    import tha4_tpu_torch  # noqa: F401

    from tha4_tpu_torch.utils import precision

    card = phase_device(torch)
    # f32 means full-f32 products on both sides of every comparison.
    precision.set_full_f32()
    build_s = phase_build()
    if sys.argv[1:] == ["--phase", "k1"]:
        return main_k1_alone(torch)
    if sys.argv[1:] == ["--phase", "int8"]:
        return main_int8_alone(torch)
    if sys.argv[1:] == ["--phase", "ddp"]:
        return main_ddp_alone(torch, card)
    if sys.argv[1:] == ["--phase", "rest"]:
        return main_rest_alone(torch)
    if sys.argv[1:] == ["--phase", "tools"]:
        return main_tools_alone(torch)
    if sys.argv[1:] == ["--phase", "resize"]:
        return main_resize_alone(torch)
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}; none, --phase k1, --phase int8, --phase ddp, "
                         "--phase rest, --phase tools or --phase resize")

    from tha4_tpu_torch.models import siren

    gen = torch.Generator().manual_seed(SEED)
    face, body = siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen)
    with torch.inference_mode():
        k1 = phase_k1(torch, face, body)
        k2 = phase_k2(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        main_path = phase_main_path(torch, workdir)
        serving = phase_serving(torch, workdir, main_path["yaml"])
    with torch.inference_mode():
        k4 = phase_k4(torch, face, body)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        training = phase_training(torch, workdir)
    k3 = phase_k3(torch)
    with torch.inference_mode():
        k5 = phase_poly_sin(torch)
    k6 = phase_k6(torch)  # grad mode on: it also checks that K6 refuses an input that needs a gradient
    with tempfile.TemporaryDirectory(prefix="chip_smoke_body_") as workdir:
        config, teacher_params, image = _body_inputs(torch, workdir)
        poser = phase_teacher_poser(torch, workdir, teacher_params)
        web_teacher = phase_web_teacher(torch, workdir)
        body_teacher = phase_body_teacher(torch, teacher_params, image)
        body = phase_body_training(torch, workdir, config, teacher_params)
        distill = phase_distill(torch, workdir, teacher_params)
        int8 = phase_int8(torch, workdir, teacher_params, image)
        torch.cuda.empty_cache()
        ddp = phase_ddp(torch, workdir, teacher_params, card)
    torch.cuda.empty_cache()
    rest = phase_rest(torch)
    torch.cuda.empty_cache()
    tools = phase_tools(torch, teacher_params)
    torch.cuda.empty_cache()
    resize = phase_resize(torch)

    k5_mixed = k5["f32->bf16"]
    k6_main = k6["shapes"][K6_MAIN_SHAPE]
    k6_path = body_teacher["k6_path"]
    k2_entry = {
        "name": "grid_sample_fast", "route": "cuda", "source": "tha4_tpu_torch/csrc/warp.cu",
        "replaces": "tha4_tpu/ops/pallas_warp.py:216",
        "launches": main_path["launches"]["grid_sample_fast"],
        "max_abs_err": k2["f32_err"], "ms": k2["ms"]["bf16"], "plain_ms": k2["plain_ms"]["bf16"],
        **k2["bound"]["bf16"], "library_ms": k2["library_ms"]["bf16"],
        "max_abs_err_bf16": k2["bf16_err"], "ms_f32": k2["ms"]["f32"], "plain_ms_f32": k2["plain_ms"]["f32"],
        "bound_ms_f32": k2["bound"]["f32"]["bound_ms"], "library_ms_f32": k2["library_ms"]["f32"],
        "ms_b8": k2["b8_ms"]["bf16"], "library_ms_b8": k2["b8_library_ms"]["bf16"], "ms_b8_f32": k2["b8_ms"]["f32"],
        "library_ms_b8_f32": k2["b8_library_ms"]["f32"], "b2b_ms": k2["b2b_ms"]["bf16"],
        "b2b_library_ms": k2["b2b_library_ms"]["bf16"], "b2b_ms_f32": k2["b2b_ms"]["f32"],
        "b2b_library_ms_f32": k2["b2b_library_ms"]["f32"],
        "timed": "the card's own time (a CUDA graph of 20 calls, replayed) of one 512^2x4 warp at B = 1, smooth grid, "
                 "bf16 image; *_f32 with an f32 image; *_b8 at B = 8; b2b_*: one event pair around 200 calls back to "
                 "back (the host's rate where it is slower than the card); plain: one event pair a call; library: F.grid_sample (bilinear, border, align_corners=False), grid cast to the "
                 "image dtype",
        "launches_training": training["launches"]["grid_sample_fast"],
        "launches_body_training": body["launches"]["grid_sample_fast"],
        "launches_distill": distill["launches"]["grid_sample_fast"],
        "launches_serving": serving["launches"]["grid_sample_fast"] + web_teacher["grid_sample_fast"],
        "launches_bench_capture": serving["bench"]["launches_at_capture"]["grid_sample_fast"],
    }
    k6_entry = {
        "name": "affine_silu_conv3", "route": "cuda", "source": "tha4_tpu_torch/csrc/affine_conv3.cu",
        "replaces": "tha4_tpu/ops/pallas_conv.py:174",
        "launches": sum(v["fused_affine_conv3_nchw"] for v in poser["launches"].values()),
        "max_abs_err": max(k6["f32_err"], k6_path["f32_err"]), "ms": k6_main["bf16"]["ms"],
        "plain_ms": k6_main["bf16"]["plain_ms"],
        "bound_ms": k6_main["bf16"]["bound_ms"], "bound_by": k6_main["bf16"]["bound_by"],
        "library_ms": k6_main["bf16"]["library_ms"],
        "bound_share": k6_main["bf16"]["bound_ms"] / k6_main["bf16"]["ms"],
        "bound_share_f32": k6_main["f32"]["bound_ms"] / k6_main["f32"]["ms"],
        "ms_with_fold": k6_main["bf16"]["with_fold_ms"], "library_with_norm_ms": k6_main["bf16"]["library_with_norm_ms"],
        "max_abs_err_bf16": max(k6["bf16_err"], k6_path["bf16_err"]),
        "max_rel_err": max(k6["f32_rel"], k6_path["f32_rel"]), "max_rel_err_bf16": max(k6["bf16_rel"], k6_path["bf16_rel"]),
        "path_sizes_checked": k6_path["sizes"], "path_split_sizes": k6_path["split_sizes"],
        "path_split_calls": k6_path["split_calls"],
        "ms_f32": k6_main["f32"]["ms"], "plain_ms_f32": k6_main["f32"]["plain_ms"],
        "bound_ms_f32": k6_main["f32"]["bound_ms"], "library_ms_f32": k6_main["f32"]["library_ms"],
        "launches_body_teacher_call": body_teacher["k6_launches_per_call"],
        "launches_body_training": body["launches"]["fused_affine_conv3_nchw"],
        "launches_distill": distill["launches"]["fused_affine_conv3_nchw"],
        "launches_web_teacher": web_teacher["fused_affine_conv3_nchw"],
        "shapes": k6["shapes"],
        "timed": f"device time (20 calls back to back) at N=8, {K6_MAIN_SHAPE}, bf16; *_f32 in f32; plain: one event "
                 "pair a call; every shape in shapes (ms, library_ms: 20 calls back to back; plain_ms: one event pair a "
                 "call; with_fold_ms: K6 after its fold, library_with_norm_ms: F.group_norm then F.conv2d, both "
                 "back to back); bound_share: bound_ms / ms; errors also "
                 "over every size of the teacher's calls at B = 1, 4 and 8 (path_*: sizes checked, those on the split "
                 "grid, their calls a teacher call); library: F.conv2d alone "
                 "(channels last, cuDNN); launches: the teacher poser's 4 poses in bf16 and in f32",
    }
    kernels = {
        "kernels": [
            {
                "name": "sine_chain_t", "route": "cuda", "source": "tha4_tpu_torch/csrc/sine_chain.cu",
                "replaces": "tha4_tpu/ops/pallas_siren.py:196",
                "launches": main_path["launches"]["sine_chain_t"],
                "max_abs_err": k1["f32_err"], "ms": k1["ms"]["bf16"], "plain_ms": k1["plain_ms"]["bf16"],
                **k1["bound"]["bf16"], "library_ms": None,
                "max_abs_err_bf16": k1["bf16_err"], "ms_f32": k1["ms"]["f32"], "plain_ms_f32": k1["plain_ms"]["f32"],
                "bound_ms_f32": k1["bound"]["f32"]["bound_ms"],
                "timed": "sum of the four calls of one frame (face, L0, L1, L2), bf16; *_f32 in f32; bound: the larger "
                         "of the bytes, the products at the peak for their type and the sine epilogue on the CUDA "
                         "cores (f32: products plus epilogue); calls: each call and dtype",
                "bound_share": k1["bound"]["bf16"]["bound_ms"] / k1["ms"]["bf16"], "calls": k1["calls"],
                "launches_training": training["launches"]["sine_chain_t"],
                "launches_distill": distill["launches"]["sine_chain_t"],
                "launches_serving": serving["launches"]["sine_chain_t"],
                "launches_bench_capture": serving["bench"]["launches_at_capture"]["sine_chain_t"],
            },
            k2_entry,
            {
                "name": "sine_chain_t_bwd", "route": "cuda", "source": "tha4_tpu_torch/csrc/sine_chain_bwd.cu",
                "replaces": "tha4_tpu/ops/pallas_siren.py:433",
                "launches": training["launches"]["sine_chain_t_bwd"],
                "launches_distill": distill["launches"]["sine_chain_t_bwd"],
                "max_abs_err": k4["f32_abs_err"], "ms": k4["ms"]["bf16"], "plain_ms": k4["plain_ms"]["bf16"],
                **k4["bound"]["bf16"], "library_ms": None,
                "max_scaled_err": k4["f32_err"], "max_scaled_err_bf16": k4["bf16_err"],
                "ms_f32": k4["ms"]["f32"], "plain_ms_f32": k4["plain_ms"]["f32"], "bound_ms_f32": k4["bound"]["f32"]["bound_ms"],
                "timed": "one face-student backward, N=8, 128^2, 41->128x8->4, bf16; *_f32 in f32; launches from the training "
                         "run; bound as K1's, three chain products and a fast_sin and fast_cos per sine output; calls: "
                         "face and L1, each dtype",
                "bound_share": k4["bound"]["bf16"]["bound_ms"] / k4["ms"]["bf16"], "calls": k4["calls"],
            },
            {
                "name": "grid_sample_train_forward", "route": "cuda", "source": "tha4_tpu_torch/csrc/warp.cu",
                "replaces": "tha4_tpu/ops/pallas_warp.py:239",
                "launches": body["launches"]["grid_sample_train_forward"],
                "launches_distill": distill["launches"]["grid_sample_train_forward"],
                "max_abs_err": k3["f32_err"], "ms": k3["fwd_ms"]["bf16"], "plain_ms": k3["plain_fwd_ms"]["bf16"],
                **k3["bound_fwd"]["bf16"], "library_ms": k3["library_fwd_ms"]["bf16"],
                "bound_share": k3["bound_fwd"]["bf16"]["bound_ms"] / k3["fwd_ms"]["bf16"],
                "max_abs_err_bf16": k3["bf16_err"], "ms_f32": k3["fwd_ms"]["f32"], "plain_ms_f32": k3["plain_fwd_ms"]["f32"],
                "bound_ms_f32": k3["bound_fwd"]["f32"]["bound_ms"], "library_ms_f32": k3["library_fwd_ms"]["f32"],
                "bound_share_f32": k3["bound_fwd"]["f32"]["bound_ms"] / k3["fwd_ms"]["f32"],
                "timed": "K3's forward (K2's kernel, counted apart) at the body head's warp, N=8, 512^2x4, smooth grid, bf16 "
                         "image; *_f32 with an f32 image; the card's own time (a CUDA graph of 20 calls); plain: one event "
                         "pair a call; library: F.grid_sample, grid in the image dtype; launches from the body training run",
            },
            {
                "name": "grid_sample_grid_backward", "route": "cuda", "source": "tha4_tpu_torch/csrc/warp.cu",
                "replaces": "tha4_tpu/ops/pallas_warp.py:336",
                "launches": body["launches"]["grid_sample_grid_backward"],
                "launches_distill": distill["launches"]["grid_sample_grid_backward"],
                "max_abs_err": k3["dgrid_abs_err"], "max_scaled_err": k3["dgrid_err"],
                "ms": k3["bwd_ms"]["bf16"], "plain_ms": k3["plain_bwd_ms"]["bf16"],
                **k3["bound_bwd"]["bf16"], "library_ms": k3["library_bwd_ms"]["bf16"],
                "bound_share": k3["bound_bwd"]["bf16"]["bound_ms"] / k3["bwd_ms"]["bf16"],
                "ms_f32": k3["bwd_ms"]["f32"], "plain_ms_f32": k3["plain_bwd_ms"]["f32"],
                "bound_ms_f32": k3["bound_bwd"]["f32"]["bound_ms"], "library_ms_f32": k3["library_bwd_ms"]["f32"],
                "bound_share_f32": k3["bound_bwd"]["f32"]["bound_ms"] / k3["bwd_ms"]["f32"],
                **{f"pair_{k}{sfx}": v for tag, sfx in (("bf16", ""), ("f32", "_f32")) for k, v in (
                    ("ms", k3["pair_ms"][tag]), ("library_ms", k3["pair_library_ms"][tag]),
                    ("bound_ms", k3["bound_fwd"][tag]["bound_ms"] + k3["bound_bwd"][tag]["bound_ms"]),
                    ("bound_share", (k3["bound_fwd"][tag]["bound_ms"] + k3["bound_bwd"][tag]["bound_ms"]) / k3["pair_ms"][tag]),
                    ("b2b_ms", k3["pair_b2b_ms"][tag]), ("autograd_ms", k3["pair_autograd_ms"][tag]),
                    ("library_autograd_ms", k3["pair_library_autograd_ms"][tag]))},
                "timed": "K3's grid backward at the body head's warp, N=8, 512^2x4, smooth grid, bf16 image and g; *_f32 "
                         "in f32; the card's own time (a CUDA graph of 20 calls); plain: one event pair a call; library: "
                         "aten.grid_sampler_2d_backward with the grid's gradient alone, grid in the image dtype; pair_*: "
                         "forward + grid backward (pair_ms, pair_library_ms: CUDA graphs of direct calls; pair_b2b_ms: 100 "
                         "direct calls back to back; pair_autograd_ms: 100 through grid_sample_train and autograd.grad; "
                         "pair_library_autograd_ms: F.grid_sample and autograd.grad, 100 back to back); pair_bound_ms: "
                         "the two kernels' bounds added; launches from the body training run",
            },
            {
                "name": "poly_sin_forward", "route": "cuda", "source": "tha4_tpu_torch/csrc/poly_sin.cu",
                "replaces": "tha4_tpu/ops/pallas_siren.py:84",
                "launches": body["launches"]["poly_sin_forward"],
                "launches_distill": distill["launches"]["poly_sin_forward"],
                "max_abs_err": k5_mixed["errs"][0], "ms": k5_mixed["fwd"], "plain_ms": k5_mixed["plain_fwd"],
                **k5_mixed["bound"]["fwd"], "library_ms": k5_mixed["torch_sin"],
                "ms_f32": k5["f32"]["fwd"], "plain_ms_f32": k5["f32"]["plain_fwd"], "ms_bf16": k5["bf16"]["fwd"],
                "timed": "(8, 512^2, 90) f32 pre-activation -> bf16 (the selective-f32 path); library: torch.sin, f32 -> f32; "
                         "launches from the body training run",
            },
            {
                "name": "poly_sin_backward", "route": "cuda", "source": "tha4_tpu_torch/csrc/poly_sin.cu",
                "replaces": "tha4_tpu/ops/pallas_siren.py:110",
                "launches": body["launches"]["poly_sin_backward"],
                "launches_distill": distill["launches"]["poly_sin_backward"],
                "max_abs_err": k5_mixed["errs"][1], "ms": k5_mixed["bwd"], "plain_ms": k5_mixed["plain_bwd"],
                **k5_mixed["bound"]["bwd"], "library_ms": None,
                "ms_f32": k5["f32"]["bwd"], "plain_ms_f32": k5["f32"]["plain_bwd"], "ms_bf16": k5["bf16"]["bwd"],
                "timed": "(8, 512^2, 90) f32 a, bf16 g -> f32 da; launches from the body training run",
            },
            k6_entry,
            {
                "name": "group_norm_fold", "route": "cuda", "source": "tha4_tpu_torch/csrc/group_norm_fold.cu",
                "replaces": "tha4_tpu/ops/pallas_conv.py:55",
                "launches": sum(v["fold_groupnorm_film"] for v in poser["launches"].values()),
                "max_abs_err": k6["fold_abs"], "max_rel_err": k6["fold_rel"],
                "ms": k6_main["bf16"]["fold_ms"], "plain_ms": k6_main["bf16"]["fold_plain_ms"],
                "bound_ms": k6_main["bf16"]["fold_bound_ms"], "bound_by": k6_main["bf16"]["fold_bound_by"], "library_ms": None,
                "ms_f32": k6_main["f32"]["fold_ms"], "plain_ms_f32": k6_main["f32"]["fold_plain_ms"],
                "bound_ms_f32": k6_main["f32"]["fold_bound_ms"],
                "launches_per_mode_07_call": 2 * body_teacher["k6_launches_per_call"],
                "launches_distill": distill["launches"]["fold_groupnorm_film"],
                "launches_web_teacher": web_teacher["fold_groupnorm_film"],
                "timed": f"device time, 20 calls back to back, of the fold of a ResBlock's norm1 and two FiLMs over K6's x at "
                         f"N=8, {K6_MAIN_SHAPE}, bf16; *_f32 in f32; two kernel launches a call; launches: fold calls of "
                         "the teacher poser's 4 poses in bf16 and in f32; no single PyTorch call computes it",
            },
            {
                "name": "int8_conv", "route": "cuda", "source": "tha4_tpu_torch/csrc/int8_conv.cu",
                "replaces": "tha4_tpu/ops/quant.py:219",
                "launches": int8["distill"]["int8"]["launches"]["int8_conv"],
                "max_abs_err": int8["max_err"], "ms": int8["timed"]["bf16"]["ms"], "plain_ms": int8["timed"]["bf16"]["plain_ms"],
                "bound_ms": int8["timed"]["bf16"]["bound_ms"], "bound_by": int8["timed"]["bf16"]["bound_by"],
                "library_ms": int8["timed"]["bf16"]["library_ms"],
                "library_with_unfold_ms": int8["timed"]["bf16"]["library_with_unfold_ms"],
                "cudnn_bf16_ms": int8["timed"]["bf16"]["cudnn_ms"], "signature": int8["timed"]["bf16"]["signature"],
                "bound_share": int8["timed"]["bf16"]["bound_ms"] / int8["timed"]["bf16"]["ms"],
                "ms_f32": int8["timed"]["f32"]["ms"], "plain_ms_f32": int8["timed"]["f32"]["plain_ms"],
                "bound_ms_f32": int8["timed"]["f32"]["bound_ms"], "library_ms_f32": int8["timed"]["f32"]["library_ms"],
                "cudnn_f32_ms": int8["timed"]["f32"]["cudnn_ms"], "signature_f32": int8["timed"]["f32"]["signature"],
                "convs_per_call": {k: v for k, v in int8.items() if k.startswith("convs_")},
                "q1_per_call": int8["q1_per_call"], "signatures": int8["signatures"],
                "timed": "device time, 20 calls back to back, at the costliest eligible conv (most multiply-adds) of the "
                         "full-width mode_07 at B = 8, bf16 x; *_f32 with f32 x; plain: int8_conv_plain (an f64 cuDNN "
                         "conv of the integers), one event pair a call; library: torch._int_mm on the F.unfold im2col "
                         "alone (library_with_unfold_ms: with the quantize, unfold and cast); cudnn_*_ms: F.conv2d of the "
                         "same shape in that dtype; bound: bytes over 3.35 TB/s or 2 x multiply-adds over the 1979 TOP/s "
                         "int8 peak; max_abs_err: over every (dtype, signature) of mode_07 and mode_12; launches: the "
                         "--teacher-int8 distillation run (8 face and 8 body steps); signatures: every (dtype, signature) "
                         "of mode_07 at B = 8 and mode_12, Q1 and "
                         "cuDNN's conv 10 calls back to back each, its convs a call; q1_per_call: those convs x their "
                         "times, per model and dtype",
            },
            {
                "name": "bilinear_resize", "route": "cuda", "source": "tha4_tpu_torch/csrc/resize.cu",
                "replaces": "none (tha4_tpu/ops/resize.py:39, dense interpolation matrices on the MXU)",
                "launches": main_path["launches"]["bilinear_resize_forward"],
                "max_abs_err": resize["max_abs_err"], "ms": resize["frame_ms"], "plain_ms": resize["frame_plain_ms"],
                "bound_ms": resize["frame_bound_ms"], "bound_by": "bytes", "library_ms": resize["frame_library_ms"],
                "dense_ms": resize["frame_dense_ms"], "bound_share": resize["frame_bound_ms"] / resize["frame_ms"],
                "max_bwd_err_bf16_steps": resize["max_bwd_err"], "cases": resize["cases"],
                "timed": "the f32 frame's two level upsamples (NCHW, B = 1) added, the card's own time (CUDA graphs of "
                         "20 calls); dense: the port's interpolation-matrix GEMMs before R1; library: F.interpolate "
                         "(bilinear, align_corners=False); cases: each shape, with the body student's training levels "
                         "(NHWC bf16, B = 8) forward and adjoint; max_abs_err: the kernel against its plain version "
                         "over every case, contiguous and a sliced view (0 when bit for bit); launches: the main path's frames",
            },
            {
                **{k: v for k, v in k6_entry.items() if k in KERNEL_KEYS}, "name": "fused_packed_conv3 (counterpart: affine_silu_conv3)",
                "replaces": "tha4_tpu/ops/pallas_packed_conv.py:142",
                "timed": "K6's numbers: the packed layout is a reshape of NHWC, and K6 on the NHWC view is its counterpart "
                         "(tests/test_torch_affine_conv.py::test_k7_packed_kernel_is_k6_on_the_nhwc_view)",
            },
            {
                **{k: v for k, v in k2_entry.items() if k in KERNEL_KEYS}, "name": "warp_probe variant_forward (counterpart: grid_sample_fast)",
                "replaces": "tools/warp_probe.py:51",
                "timed": "K2's numbers: the probe computes K2's function (tests/test_torch_warp.py::"
                         "test_probe_variant_is_k2_on_its_bf16_image)",
            },
        ],
        "frame_ms": main_path["ms"], "train_step_ms": training["steps"], "body_teacher_ms": body_teacher["ms"],
        "teacher_pose_ms": poser["ms"],
        "body_train_step_ms": body["steps"], "build_s": build_s, "card": card,
        "distill": {k: distill[k] for k in ("ms_step", "sample_write_ms", "render_ms", "grid_ms", "grid_counts", "export_ms",
                                             "cadence_s", "bf16_psnr")},
        "serving": {"bench": serving["bench"], "puppeteer": serving["puppeteer"], "seconds": serving["seconds"]},
        "int8": {k: int8[k] for k in ("labels", "teacher_ms", "distill", "eval", "seconds")}
        | {"verify_s": int8["verify"]["s"], "verify_int8": int8["verify"]["checks"]["int8 teacher fidelity"]},
        "ddp": {k: ddp[k] for k in ("compared", "peak_gb", "teacher_ms_a_pose", "ranks_s", "nccl_s", "seconds")},
        "rest": rest,
        "tools": {"dtype_ab": tools["dtype_ab"]["results"], "dtype_ab_launches": tools["dtype_ab"]["launches"],
                  "quant_ab": tools["quant_ab"]["results"], "quant_ab_delta": tools["quant_ab"]["delta"],
                  "quant_ab_launches": tools["quant_ab"]["launches"], "q1_per_step": tools["quant_ab"]["q1_per_step"],
                  "run_report": tools["run"]["report"], "checkpoint_eval": tools["run"]["eval"], "seconds": tools["seconds"]},
    }
    for entry in kernels["kernels"]:
        if set(KERNEL_KEYS) - set(entry) or not entry["launches"] > 0:
            raise AssertionError(f"kernels line: {entry['name']} lacks {set(KERNEL_KEYS) - set(entry)} or was never launched")
    print(json.dumps(kernels))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
