#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's student frame and face-student training on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device: the card (``nvidia-smi`` name and power limit) and the versions;
2. build: the kernels of ``tha4_tpu_torch/csrc`` from source, with the
   seconds taken and nvcc's register / spill report per kernel;
3. K1 (``sine_chain_t``) against its plain PyTorch version at the four call
   shapes of one frame, f32 and bf16, with max-abs error and median times;
4. K2 (``grid_sample_fast``) against its plain version at 512^2 x 4, f32 and
   bf16, on a smooth grid and on one with displacements past 150 px;
5. the main path: a seeded random-init character model at full width
   (written to a temporary directory), loaded through
   ``CharacterModel.load(...).get_poser(...)``, answers 8 pose requests in
   bf16 and in f32.  All six outputs must be finite; K1 must launch 4 times
   and K2 once per frame; the f32 frame must match the same model's plain
   run on the CPU; the bf16 frame must be within 28 dB PSNR of the f32 one;
   the headless CLI must write a PNG; ms/frame at batch 1 is printed;
6. K4 (``sine_chain_t_bwd``) against its plain version at the face
   student's training shape (N = 8, 128^2) and at body level 1 (N = 1,
   256^2, with prev), f32 and bf16: every gradient within its bar, two
   calls bit-identical, median times;
7. the training path: a seeded full-width random mode_12 teacher and the
   synthetic character, mask and ``DistillerConfig`` (written to a
   temporary directory) train the face student through
   ``DistillationJobs(...).make_face_trainer().train()`` in bf16 at batch
   8 for 32 steps, across two checkpoint boundaries.  Losses must be
   finite; each step must launch K1, K4 once and K2 twice; the checkpoints
   must load; resuming from the first must reproduce the run; the f32
   student gradients on the card (K1 + K4) must match the plain backward
   on the CPU for the same loss cotangent; ms/step at batch 8 in bf16 and
   f32 is printed, split into teacher, student and Adam.

The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero without printing that line; so does a machine without
CUDA, and a directory without the rest of the repository.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
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
# Resume from checkpoint 1 against the uninterrupted run.  Bit-equal is
# expected (K1, K2 and K4 are deterministic, so are cuDNN's forward convs);
# the bar leaves room for a teacher conv whose sum order varied, which
# would move a label by a bf16 step and an Adam step by a fraction of lr.
RESUME_ATOL = 1e-6
TRAIN_STEPS = 32
TRAIN_BATCH = 8
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


def _bench_pose(pose_parameters, i: int) -> np.ndarray:
    """The animated sweep of bench.py:59-72: blink, talk, head and body
    sway, breathing."""
    idx = pose_parameters.get_parameter_index
    pose = pose_parameters.get_default_pose()
    pose[idx("head_x")] = 0.6 * math.sin(i / 4.0)
    pose[idx("head_y")] = math.sin(i / 10.0)
    pose[idx("neck_z")] = 0.5 * math.sin(i / 6.0)
    pose[idx("body_z")] = 0.4 * math.sin(i / 9.0)
    pose[idx("breathing")] = 0.5 + 0.5 * math.sin(i / 5.0)
    pose[idx("mouth_aaa")] = 0.5 + 0.5 * math.sin(i / 3.0)
    blink = min(max(math.sin(i / 7.0) * 8.0 - 7.0, 0.0), 1.0)
    pose[idx("eye_wink_left")] = blink
    pose[idx("eye_wink_right")] = blink
    return pose


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


def _level_inputs(torch, gen, size, prev_channels, pose_dim, dtype):
    """Seeded level inputs: prev in [-1, 1] like sine outputs, the identity
    grid, a pose in [0, 1]."""
    from tha4_tpu_torch.models.siren import pos_t

    hw = size * size
    prev = None
    if prev_channels:
        prev = (torch.rand((1, prev_channels, hw), generator=gen) * 2.0 - 1.0).to("cuda", dtype)
    pose = torch.rand((1, pose_dim), generator=gen).cuda()
    return prev, pos_t(size, dtype, "cuda"), pose


def phase_k1(torch, face, body) -> dict:
    from tha4_tpu_torch.ops import cuda_siren

    gen = torch.Generator().manual_seed(SEED + 1)
    results = {"f32_err": 0.0, "bf16_err": 0.0, "ms": {}, "plain_ms": {}}
    face_cfg, body_cfg = face.cfg, body.cfg
    for dtype, tag in [(torch.float32, "f32"), (torch.bfloat16, "bf16")]:
        chains = [face.pack(dtype, "cuda")] + body.pack(dtype, "cuda")
        calls = [
            ("face", chains[0], face_cfg.image_size, 0, face_cfg.pose_size),
            ("L0", chains[1], body_cfg.levels[0].image_size, 0, body_cfg.pose_size),
            ("L1", chains[2], body_cfg.levels[1].image_size, body_cfg.levels[1].intermediate_channels, body_cfg.pose_size),
            ("L2", chains[3], body_cfg.levels[2].image_size, body_cfg.levels[2].intermediate_channels, body_cfg.pose_size),
        ]
        k_total = p_total = 0.0
        for name, chain, size, cp, pose_dim in calls:
            prev, pos, pose = _level_inputs(torch, gen, size, cp, pose_dim, dtype)
            out = cuda_siren.sine_chain_t(prev, pos, pose, chain)
            ref = cuda_siren.chain_t_plain(prev, pos, pose, chain)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dtype:
                raise AssertionError(f"K1 {name} {tag}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
            err = float((out.float() - ref.float()).abs().max())
            scale = max(1.0, float(ref.float().abs().max()))
            bar = K1_F32_ATOL if dtype == torch.float32 else K1_BF16_STEPS * 2.0**-8 * scale
            k_ms = _time_ms(lambda: cuda_siren.sine_chain_t(prev, pos, pose, chain))
            p_ms = _time_ms(lambda: cuda_siren.chain_t_plain(prev, pos, pose, chain))
            k_total += k_ms
            p_total += p_ms
            shape = " -> ".join(str(int(c)) for c in [chain.specs[0, 0]] + list(chain.specs[:, 1]))
            print(f"K1 {name:4s} {tag:4s} {size}^2 {shape}: max_abs_err {err:.3e} (bar {bar:.1e}), "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            if not err <= bar:
                raise AssertionError(f"K1 {name} {tag}: max_abs_err {err} over the bar {bar}")
            results[f"{tag}_err"] = max(results[f"{tag}_err"], err)
        results["ms"][tag], results["plain_ms"][tag] = k_total, p_total
        print(f"K1 per frame {tag}: kernel {k_total:.4f} ms, plain {p_total:.4f} ms")
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
    results = {"f32_err": 0.0, "bf16_err": 0.0, "ms": {}, "plain_ms": {}}
    for dtype, tag, bar in [(torch.float32, "f32", K2_F32_ATOL), (torch.bfloat16, "bf16", K2_BF16_ATOL)]:
        image = image32.to(dtype)
        for gname, grid in grids.items():
            grid = grid.contiguous()
            out = cuda_warp.grid_sample_fast(image, grid)
            ref = cuda_warp.grid_sample_bilinear_border(image, grid)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            k_ms = _time_ms(lambda: cuda_warp.grid_sample_fast(image, grid))
            p_ms = _time_ms(lambda: cuda_warp.grid_sample_bilinear_border(image, grid))
            print(f"K2 {tag:4s} {size}^2x4 {gname}: max_abs_err {err:.3e} (bar {bar:.1e}), "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            if out.dtype != dtype or not err <= bar:
                raise AssertionError(f"K2 {tag} {gname}: max_abs_err {err} over the bar {bar} (dtype {out.dtype})")
            results[f"{tag}_err"] = max(results[f"{tag}_err"], err)
            if gname.startswith("smooth"):
                results["ms"][tag], results["plain_ms"][tag] = k_ms, p_ms
    return results


def phase_main_path(torch, workdir: str) -> dict:
    from tha4_tpu_torch.apps import character_model_manual_poser
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.charmodel.synthetic import FLOW_SCALE, write_random_character_model
    from tha4_tpu_torch.ops import cuda_siren, cuda_warp

    yaml_path = write_random_character_model(os.path.join(workdir, "model"), seed=SEED)
    model = CharacterModel.load(yaml_path)
    image = model.get_character_image()
    posers = {"bf16": model.get_poser(torch.bfloat16, "cuda"), "f32": model.get_poser(torch.float32, "cuda")}
    poses = [_bench_pose(posers["f32"].pose_parameters, i) for i in range(FRAMES)]

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
    return {"launches": launches, "ms": ms}


def phase_k4(torch, face, body) -> dict:
    from tha4_tpu_torch.models.siren import pos_t
    from tha4_tpu_torch.ops import cuda_siren

    gen = torch.Generator().manual_seed(SEED + 3)
    results = {"f32_err": 0.0, "f32_abs_err": 0.0, "bf16_err": 0.0, "ms": {}, "plain_ms": {}}
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
            shape = " -> ".join(str(int(c)) for c in [chain.specs[0, 0]] + list(chain.specs[:, 1]))
            print(f"K4 {name:4s} {tag:4s} N={n} {size}^2 {shape}: scaled err "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (bar {bar:.1e}); two calls bit-identical; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            worst = max(errs.values())
            if not worst <= bar:
                raise AssertionError(f"K4 {name} {tag}: scaled error {worst} over the bar {bar}")
            results[f"{tag}_err"] = max(results[f"{tag}_err"], worst)
            if name == "face":
                results["ms"][tag], results["plain_ms"][tag] = k_ms, p_ms
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
    with torch.inference_mode():
        k4 = phase_k4(torch, face, body)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        training = phase_training(torch, workdir)

    kernels = {
        "kernels": [
            {
                "name": "sine_chain_t", "route": "cuda", "source": "tha4_tpu_torch/csrc/sine_chain.cu",
                "replaces": "tha4_tpu/ops/pallas_siren.py:196",
                "launches": main_path["launches"]["sine_chain_t"],
                "max_abs_err": k1["f32_err"], "ms": k1["ms"]["bf16"], "plain_ms": k1["plain_ms"]["bf16"],
                "max_abs_err_bf16": k1["bf16_err"], "ms_f32": k1["ms"]["f32"], "plain_ms_f32": k1["plain_ms"]["f32"],
                "timed": "sum of the four calls of one frame (face, L0, L1, L2), bf16; *_f32 in f32",
                "launches_training": training["launches"]["sine_chain_t"],
            },
            {
                "name": "grid_sample_fast", "route": "cuda", "source": "tha4_tpu_torch/csrc/warp.cu",
                "replaces": "tha4_tpu/ops/pallas_warp.py:216",
                "launches": main_path["launches"]["grid_sample_fast"],
                "max_abs_err": k2["f32_err"], "ms": k2["ms"]["bf16"], "plain_ms": k2["plain_ms"]["bf16"],
                "max_abs_err_bf16": k2["bf16_err"], "ms_f32": k2["ms"]["f32"], "plain_ms_f32": k2["plain_ms"]["f32"],
                "timed": "one 512^2x4 warp, smooth grid, bf16 image; *_f32 with an f32 image",
                "launches_training": training["launches"]["grid_sample_fast"],
            },
            {
                "name": "sine_chain_t_bwd", "route": "cuda", "source": "tha4_tpu_torch/csrc/sine_chain_bwd.cu",
                "replaces": "tha4_tpu/ops/pallas_siren.py:433",
                "launches": training["launches"]["sine_chain_t_bwd"],
                "max_abs_err": k4["f32_abs_err"], "ms": k4["ms"]["bf16"], "plain_ms": k4["plain_ms"]["bf16"],
                "max_scaled_err": k4["f32_err"], "max_scaled_err_bf16": k4["bf16_err"],
                "ms_f32": k4["ms"]["f32"], "plain_ms_f32": k4["plain_ms"]["f32"],
                "timed": "one face-student backward, N=8, 128^2, 41->128x8->4, bf16; *_f32 in f32; launches from the training run",
            },
        ],
        "frame_ms": main_path["ms"], "train_step_ms": training["steps"], "build_s": build_s, "card": card,
    }
    print(json.dumps(kernels))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
