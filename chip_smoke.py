#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's student frame, teacher poser, both students' training, distillation to a character model and the verification slice (the int8 teacher, tha4-torch-verify, tha4-torch-eval) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card (``nvidia-smi`` name and power limit) and the versions;
2. build: the kernels of ``tha4_tpu_torch/csrc`` from source, with the
   seconds taken and nvcc's register / spill report per kernel;
3. K1 (``sine_chain_t``) against its plain PyTorch version at the four call
   shapes of one frame, f32 and bf16, with max-abs error, median times, the
   restated bound (the products at the peak for their type against the
   fast_sin epilogue on the CUDA cores, each printed) and its share;
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
15. the verification slice: Q1 (``int8_conv``, the int8 teacher's conv)
    against its plain version bit for bit at every (dtype, signature) of
    the full-width mode_07 at B = 8 and of mode_12, bf16 and f32, timed at
    the costliest beside ``torch._int_mm`` on an im2col and cuDNN; the int8
    teacher's body labels (outputs 0, 2, 3, 5) against bf16 and f32 (label
    PSNR, grid-change L1) and its time a call against bf16;
    ``pipeline.run_config`` with ``teacher_int8`` (``tha4-torch-distill
    --teacher-int8``), 8 steps a student, beside the same run without it:
    Q1 launched once per eligible conv per teacher call and K6 never, both
    scales files written; ``tha4-torch-verify`` on a full-width bundle it
    writes (five damped random teacher ``.pt`` files, a pose dataset, a
    synthetic character and mask, a random character model; no reference
    source): exit 0, steps 2 and 5 ``skip``, the rest ``ok``; and
    ``tha4-torch-eval --against`` between two random character models, f32
    and bf16.

The line before the last is a JSON object with one entry per kernel (K1,
K2, K3's forward and grid backward, K4-K6, the fold, Q1, and K7 and the TPU
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
    from tha4_tpu_torch.ops import cuda_siren, cuda_warp
    from tha4_tpu_torch.tools import bench

    yaml_path = write_random_character_model(os.path.join(workdir, "model"), seed=SEED)
    model = CharacterModel.load(yaml_path)
    image = model.get_character_image()
    posers = {"bf16": model.get_poser(torch.bfloat16, "cuda"), "f32": model.get_poser(torch.float32, "cuda")}
    poses = list(bench.pose_sweep(posers["f32"].pose_parameters, FRAMES))

    cuda_siren.sine_chain_t.launches = 0
    cuda_warp.grid_sample_fast.launches = 0
    outputs = {tag: [poser.get_posing_outputs(image, pose) for pose in poses] for tag, poser in posers.items()}
    torch.cuda.synchronize()
    launches = {"sine_chain_t": cuda_siren.sine_chain_t.launches, "grid_sample_fast": cuda_warp.grid_sample_fast.launches}
    frames = FRAMES * len(posers)
    print(f"main path: {frames} frames at B=1 (bf16 and f32, {FRAMES} poses each): "
          f"K1 launches {launches['sine_chain_t']}, K2 launches {launches['grid_sample_fast']}")
    if launches != {"sine_chain_t": 4 * frames, "grid_sample_fast": frames}:
        raise AssertionError(f"expected {4 * frames} K1 and {frames} K2 launches, got {launches}")

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


def _puppeteer_run(what: str, args: list) -> dict:
    """``python -m tha4_tpu_torch.apps.puppeteer --benchmark ...`` on the card:
    its benchmark line, with the rendered frames and the kernel launches of
    the process (the warm-up frame included)."""
    lines = _subprocess(["tha4_tpu_torch.apps.puppeteer", *args, "--benchmark", "--device", "cuda"], what)
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


def _check_q1_at_the_path(torch, fn, teacher, images, poses, scales, errs: dict, costliest: dict) -> None:
    """One int8 call of ``fn`` with every eligible conv's Q1 output held
    against its plain version on the same card inputs, bit for bit, at each
    (dtype, signature) not yet in ``errs`` (which records the error); the
    inputs of the costliest conv of each dtype (most multiply-adds) are
    kept in ``costliest`` for its timing."""
    from tha4_tpu_torch.ops import cuda_int8_conv, quant

    real = quant.conv_hook

    def checked(ctx, conv, x):
        out = real(ctx, conv, x)
        sig = quant.nchw_signature(x, conv)
        key = ("bf16" if x.dtype == torch.bfloat16 else "f32", json.dumps(sig))
        if key not in errs:
            xs, k = x.permute(0, 2, 3, 1), conv.kernel_size[0]
            w8 = cuda_int8_conv._hwio(conv.int8_layout, xs.shape[3])
            bias = None if conv.bias is None else conv.bias.to(x.dtype)
            scale = ctx.scales[ctx.idx - 1]["scale"]
            plain = cuda_int8_conv.int8_conv_plain(xs, w8, conv.int8_scale, scale, conv.padding[0], bias)
            errs[key] = float((out.permute(0, 2, 3, 1).float() - plain.float()).abs().max())
            if not torch.equal(out.permute(0, 2, 3, 1), plain):
                raise AssertionError(f"Q1 {key}: differs from its plain version by {errs[key]}")
            macs = xs.shape[0] * xs.shape[1] * xs.shape[2] * w8.shape[3] * k * k * xs.shape[3]
            if macs > costliest.get(key[0], {}).get("macs", 0):
                costliest[key[0]] = {"signature": key[1], "macs": macs, "x": xs.contiguous(), "w8": w8,
                                     "args": (conv.int8_layout, conv.int8_scale, scale, conv.padding[0], bias)}
        return out

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
    from tha4_tpu_torch.ops import cuda_conv, cuda_int8_conv, cuda_poly_sin, cuda_siren, cuda_warp, quant
    from tha4_tpu_torch.poser.modes import mode_07, mode_12
    from tha4_tpu_torch.utils import fidelity

    t_phase = time.perf_counter()
    results = {}
    cal_poses = sample_poses(torch.Generator().manual_seed(CAL_SEED), TRAIN_BATCH).cuda()
    poses = sample_poses(torch.Generator().manual_seed(SEED + 51), TRAIN_BATCH).cuda()

    # (a) Q1 at every eligible signature, bf16 and f32, mode_07 at B = 8 and mode_12.
    errs, costliest, teachers, scales = {}, {}, {}, {}
    for tag, dtype in [("bf16", torch.bfloat16), ("f32", torch.float32)]:
        teachers[tag] = mode_07.Teacher.from_params(teacher_params).freeze(dtype, "cuda")
        images = image.to(dtype).expand(TRAIN_BATCH, -1, -1, -1)
        scales[tag] = quant.run_calibration(mode_07.compute_outputs, teachers[tag], images, cal_poses.to(dtype))
        _check_q1_at_the_path(torch, mode_07.compute_outputs, teachers[tag], images, poses.to(dtype), scales[tag], errs,
                              costliest)
        face = mode_12.FaceTeacher.from_params({k: teacher_params[k] for k in mode_12.NETWORK_KEYS}).freeze(dtype, "cuda")
        s12 = quant.run_calibration(mode_12.compute_outputs, face, images, cal_poses.to(dtype))
        _check_q1_at_the_path(torch, mode_12.compute_outputs, face, images, poses.to(dtype), s12, errs, costliest)
        results[f"convs_07_{tag}"], results[f"convs_12_{tag}"] = len(scales[tag]), len(s12)
        del face
    print(f"Q1: equal to its plain version bit for bit at all {len(errs)} (dtype, signature) pairs of the full-width "
          f"mode_07 at B = {TRAIN_BATCH} ({results['convs_07_bf16']} eligible convs a call) and mode_12 "
          f"({results['convs_12_bf16']}), bf16 and f32")

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
    print(f"int8 teacher (bf16 activations) body labels at B = {TRAIN_BATCH}: {labels}; a call {teacher_ms['int8']:.2f} ms "
          f"against bf16 {teacher_ms['bf16']:.2f} ms")
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
    make_face, make_body = recipes.make_face_distill_step, recipes.make_body_distill_step

    def timed_steps(make, kind):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a, **k)
                torch.cuda.synchronize()
                step_ms.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
                return out
            return run
        return made

    recipes.make_face_distill_step, recipes.make_body_distill_step = (timed_steps(make_face, "face"),
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
        recipes.make_face_distill_step, recipes.make_body_distill_step = make_face, make_body

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


def main() -> int:
    import torch

    # Fail before printing anything where the repository is missing.
    import tha4_tpu_torch  # noqa: F401

    card = phase_device(torch)
    # f32 means full-f32 products on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = phase_build()

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
        from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, write_distiller_inputs
        from tha4_tpu_torch.core import imagecodec
        from tha4_tpu_torch.distiller.config import DistillerConfig

        config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill"), seed=SEED, batch_size=TRAIN_BATCH))
        teacher_params = random_teacher_07(torch.Generator().manual_seed(SEED + 8))
        image = torch.from_numpy(imagecodec.load_image_hwc(config.character_image_file_name))[None].cuda()
        poser = phase_teacher_poser(torch, workdir, teacher_params)
        web_teacher = phase_web_teacher(torch, workdir)
        body_teacher = phase_body_teacher(torch, teacher_params, image)
        body = phase_body_training(torch, workdir, config, teacher_params)
        distill = phase_distill(torch, workdir, teacher_params)
        int8 = phase_int8(torch, workdir, teacher_params, image)

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
                "timed": "device time, 20 calls back to back, at the costliest eligible conv (most multiply-adds) of the "
                         "full-width mode_07 at B = 8, bf16 x; *_f32 with f32 x; plain: int8_conv_plain (an f64 cuDNN "
                         "conv of the integers), one event pair a call; library: torch._int_mm on the F.unfold im2col "
                         "alone (library_with_unfold_ms: with the quantize, unfold and cast); cudnn_*_ms: F.conv2d of the "
                         "same shape in that dtype; bound: bytes over 3.35 TB/s or 2 x multiply-adds over the 1979 TOP/s "
                         "int8 peak; max_abs_err: over every (dtype, signature) of mode_07 and mode_12; launches: the "
                         "--teacher-int8 distillation run (8 face and 8 body steps)",
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
