"""Profile or time one distillation step on one GPU.

    python -m tha4_tpu_torch.tools.profile_step [--student body|face|frame] [--dtype bf16|f32]
                                                [--steps 5] [--int8]
    python tha4_tpu_torch/tools/profile_step.py --time [--root DIR] [--label NAME]

Builds the shipped teacher at full width with seeded random weights (mode_07
from ``charmodel.synthetic.random_teacher_07`` for the body student, mode_12
for the face student), the shipped student and the synthetic character.

Profiling (the default) runs two warm-up steps of the recipe at batch 8
(``recipes.make_body_distill_step`` with the selective-f32 student in bf16,
or ``make_face_distill_step``; ``--student frame``: the student frame at
B = 1, as ``frame_ms`` below runs it; ``--int8``: the body step with its
teacher under the int8 scope, so that Q1 and the unfused ResBlocks' glue
stand apart), then ``--steps`` steps under
``torch.profiler`` with the poses already on the card.  It prints one line
per kernel group and the busiest kernels, each as device ms per step and
launches per step, then a JSON summary: device busy ms per step (the sum of
kernel times: one stream, so kernels do not overlap), wall ms per step under
the profiler, and their ratio, the busy share.

``--time`` prints one JSON line for the student frame, the face step and
the body path instead:

* ``frame_ms``: one bf16 frame at B = 1 of a seeded random full-width
  character model (``charmodel.synthetic``) through
  ``CharacterModel.get_poser(...).get_posing_outputs`` with the image on the
  card, host clock to ``torch.cuda.synchronize()``, the median of 30 after 3
  warm-up frames;
* ``face_step_ms``: one bf16 face step at B = 8, host clock to
  ``torch.cuda.synchronize()``, the median of 10 after 3 warm-up steps;

* ``teacher_ms``: one ``mode_07.compute_outputs`` call at B = 1 and 8, bf16
  and f32, the median of 20 CUDA-event timings after 2 warm-up calls (in a
  tree whose teacher captures its call as a CUDA graph, the timed calls
  are replays);
* ``body_step_ms``: one bf16 body step at B = 8, host clock to
  ``torch.cuda.synchronize()``, the median of 10 after 3 warm-up steps;
  ``body_teacher_ms``, the CUDA-event median of its teacher labels;
  ``int8_body_step_ms`` and ``int8_body_teacher_ms``, the same under the
  int8 teacher (``--teacher-int8``: ``ops.quant`` scales calibrated on the
  character image and a seeded pose batch, as ``DistillationJobs`` does);
* ``k6_launches_per_call`` where the tree has K6 (``ops.cuda_conv``);
* ``teacher_launches``: the device operations (kernels, copies, fills) one
  ``mode_07.compute_outputs`` call enqueues at B = 1 and 8, bf16 and f32,
  counted by ``torch.profiler`` (a replay: the body's, and its input and
  output copies);
* ``k2_b2b_ms``: K2 (``ops.cuda_warp.grid_sample_fast``) at the frame's
  512^2 x 4 warp, B = 1, f32 and bf16, one event pair around 200 calls back
  to back over 200: the rate a caller gets where the wrapper's host work
  is slower than the kernel; ``grid_sample_b2b_ms`` the same for
  ``F.grid_sample``.

``--root`` imports ``tha4_tpu_torch`` from another checkout (run the file
by its path then, not with ``-m``), so that one command can time two
trees on one card in turns, for example a parent commit unpacked by ``git
archive`` and this one (parent, change, change, parent), through the APIs
both trees have.  Needs a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

BATCH = 8
SEED = 20261016
TOP = 15  # the busiest kernels listed
TEACHER_ITERS = 20  # --time: CUDA-event timings a teacher median (B = 1 calls spread by +-20 %)
# Kernel name fragments -> group, first match wins.
GROUPS = (
    ("K1 sine_chain", ("sine_chain_kernel", "sine_chain_tc_kernel")),
    ("K4 sine_chain_bwd", ("sine_chain_bwd_kernel", "sum_slabs_kernel", "sine_chain_bwd_tc_kernel", "sine_chain_dw_kernel",
                           "column_sum_kernel", "dpose_kernel")),
    ("K2 warp, K3 forward", ("grid_sample_kernel",)),
    # grid_sample_corners_kernel: K3's forward in trees whose backward was
    # elementwise over its dx / dy fields, so that --root can profile them.
    ("K3 warp", ("grid_sample_grid_backward_kernel", "grid_sample_corners_kernel")),
    ("K5 poly_sin", ("poly_sin_",)),
    ("K6 affine_silu_conv3", ("affine_silu_conv3",)),
    ("K6 fold", ("group_norm_stats", "group_norm_fold")),
    ("Q1 int8_conv", ("int8_conv", "int8_quantize")),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "nchwToNhwc", "nhwcToNchw", "xmma")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "Kernel2", "sm90_")),
    ("reduction", ("reduce",)),
    ("elementwise, copies", ("elementwise", "vectorized", "copy", "cat", "index", "fill", "Memcpy", "Memset")),
)


def _group(name: str) -> str:
    for group, fragments in GROUPS:
        if any(f in name for f in fragments):
            return group
    return "other"


def _setup(student_kind: str, dtype: torch.dtype, workdir: str, int8: bool = False):
    """(teacher, image, poses, step()) for one optimizer step of the chosen
    recipe; ``step()`` takes the next of four pose batches on the card.
    ``int8``: the body teacher labels under ``ops.quant`` scales calibrated
    on the image and a pose batch of its own (teacher[1])."""
    from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, write_distiller_inputs
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.poser.modes import mode_07, mode_12

    config = DistillerConfig.load(write_distiller_inputs(workdir, seed=SEED, batch_size=BATCH))
    image = torch.from_numpy(imagecodec.load_image_hwc(config.character_image_file_name))[None].cuda()
    gen = torch.Generator().manual_seed(SEED)
    poses = [sample_poses(gen, BATCH).cuda() for _ in range(4)]
    scales = None
    if student_kind == "body":
        teacher = mode_07.Teacher.from_params(random_teacher_07(gen)).freeze(dtype, "cuda")
        student = siren.SirenMorpher(generator=gen).cuda()
        if int8:
            from tha4_tpu_torch.ops import quant

            cal_poses = sample_poses(torch.Generator().manual_seed(0xCA11B), BATCH).cuda().to(dtype)
            scales = quant.run_calibration(mode_07.compute_outputs, teacher, image.to(dtype).expand(BATCH, -1, -1, -1),
                                           cal_poses)
        recipe = recipes.make_body_distill_step(teacher, image, dtype, mixed=dtype == torch.bfloat16, teacher_quant=scales)
        weights = recipes.default_body_phases().loss_weights(recipes.BODY_LOSS_TERMS, 500_000)

        def run(optimizer, p):
            recipe(student, optimizer, p, 1e-5, weights)
    else:
        teacher = mode_12.FaceTeacher.from_params(mode_12.init(gen)).freeze(dtype, "cuda")
        student = siren.SirenFaceMorpher(generator=gen).cuda()
        mask = torch.from_numpy(recipes.load_face_mask_crop(config.face_mask_image_file_name)).cuda()
        recipe = recipes.make_face_distill_step(teacher, image, mask, dtype)

        def run(optimizer, p):
            recipe(student, optimizer, p, 1e-4)

    optimizer = recipes.make_adam(student)
    count = [0]

    def step():
        run(optimizer, poses[count[0] % len(poses)])
        count[0] += 1

    return (teacher, scales), image, poses, step


def _event_ms(fn, iters: int, warmup: int = 2) -> float:
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


def _back_to_back_ms(fn, reps: int = 200, warmup: int = 5) -> float:
    """One event pair around ``reps`` calls of ``fn`` back to back, over
    ``reps``."""
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


def _k2_back_to_back() -> dict:
    """``k2_b2b_ms`` and ``grid_sample_b2b_ms``, f32 and bf16."""
    from tha4_tpu_torch.ops import cuda_warp, warp

    grid = warp.identity_grid(512, 512, "cuda")[None].contiguous()
    image32 = (torch.rand((1, 512, 512, 4), generator=torch.Generator().manual_seed(SEED)) * 2.0 - 1.0).cuda()
    result = {"k2_b2b_ms": {}, "grid_sample_b2b_ms": {}}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        image, grid_t = image32.to(dtype), grid.to(dtype)
        result["k2_b2b_ms"][tag] = _back_to_back_ms(lambda: cuda_warp.grid_sample_fast(image, grid))
        result["grid_sample_b2b_ms"][tag] = _back_to_back_ms(lambda: torch.nn.functional.grid_sample(
            image.permute(0, 3, 1, 2), grid_t, mode="bilinear", padding_mode="border", align_corners=False))
    return result


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) one ``fn()`` enqueues,
    by ``torch.profiler`` after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def _host_ms(fn, iters: int, warmup: int) -> float:
    """Median host-clock ms of ``fn()`` to ``torch.cuda.synchronize()``."""
    times = []
    for i in range(warmup + iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


def _frame(dtype: torch.dtype, workdir: str):
    """frame(): one student frame at B = 1 of a seeded random full-width
    character model, the image on the card, the next of four poses."""
    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.charmodel.synthetic import write_random_character_model

    model = CharacterModel.load(write_random_character_model(os.path.join(workdir, "model"), seed=SEED))
    poser = model.get_poser(dtype, "cuda")
    image = torch.from_numpy(model.get_character_image()).cuda()
    poses = torch.rand((4, 45), generator=torch.Generator().manual_seed(SEED)).cuda()
    count = [0]

    def frame():
        poser.get_posing_outputs(image, poses[count[0] % 4])
        count[0] += 1

    return frame


def _time_student() -> dict:
    """``frame_ms`` and ``face_step_ms`` of the ``--time`` line."""
    with tempfile.TemporaryDirectory(prefix="profile_step_") as workdir:
        frame_ms = _host_ms(_frame(torch.bfloat16, workdir), 30, 3)
        step = _setup("face", torch.bfloat16, workdir)[3]
        face_step_ms = _host_ms(step, 10, 3)
    return {"frame_ms": frame_ms, "face_step_ms": face_step_ms}


def _time_body(label: str) -> dict:
    """The ``--time`` line: the student frame and face step, the mode_07
    teacher and the bf16 body step."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.poser.modes import mode_07

    k6 = None
    if importlib.util.find_spec("tha4_tpu_torch.ops.cuda_conv") is not None:
        from tha4_tpu_torch.ops import cuda_conv

        k6 = cuda_conv.fused_affine_conv3_nchw
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"label": label, "card": card, **_time_student(), "teacher_ms": {}, "teacher_launches": {}}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with tempfile.TemporaryDirectory(prefix="profile_step_") as workdir:
            (teacher, _), image, poses, step = _setup("body", dtype, workdir)
        for n in (1, BATCH):
            images, p = image.to(dtype).expand(n, *image.shape[1:]), poses[0][:n].to(dtype)
            with torch.no_grad():
                if k6 is not None:
                    k6.launches = 0
                    mode_07.compute_outputs(teacher, images, p)
                    result["k6_launches_per_call"] = k6.launches
                result["teacher_ms"][f"{tag}_b{n}"] = _event_ms(lambda: mode_07.compute_outputs(teacher, images, p), TEACHER_ITERS)
                result["teacher_launches"][f"{tag}_b{n}"] = device_ops(lambda: mode_07.compute_outputs(teacher, images, p))
        if dtype == torch.float32:
            del teacher, step
            torch.cuda.empty_cache()
    result["body_step_ms"] = _host_ms(step, 10, 3)
    with torch.no_grad():
        result["body_teacher_ms"] = _event_ms(lambda: recipes.body_teacher_targets(teacher, image, poses[0], torch.bfloat16), 5)
        result.update(_k2_back_to_back())
    del teacher, step
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="profile_step_") as workdir:
        (teacher, scales), image, poses, step = _setup("body", torch.bfloat16, workdir, int8=True)
    result["int8_body_step_ms"] = _host_ms(step, 10, 3)
    with torch.no_grad():
        result["int8_body_teacher_ms"] = _event_ms(
            lambda: recipes.body_teacher_targets(teacher, image, poses[0], torch.bfloat16, scales), 5)
    return result


def _profile(student: str, dtype: torch.dtype, steps: int, int8: bool = False) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory(prefix="profile_step_") as workdir:
        step = _frame(dtype, workdir) if student == "frame" else _setup(student, dtype, workdir, int8)[3]
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / steps
        by_name[e.name][1] += 1
    by_group = collections.defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_name.items():
        by_group[_group(name)][0] += ms
        by_group[_group(name)][1] += n
    busy = sum(ms for ms, _ in by_name.values())
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    batch = 1 if student == "frame" else BATCH
    print(f"{student} step, {tag}, B={batch}, {steps} steps on {torch.cuda.get_device_name(0)}:")
    for group, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {group:24s} {ms:9.3f} ms/step  {n / steps:7.1f} launches/step  {100.0 * ms / busy:5.1f} %")
    print(f"  busiest {TOP} kernels:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"    {ms:9.3f} ms/step  {n / steps:6.1f}/step  {name[:110]}")
    return {
        "student": student, "dtype": tag, "batch": batch, "steps": steps, "int8_teacher": int8,
        "device_busy_ms": busy, "wall_ms": wall_ms, "busy_share": busy / wall_ms,
        "kernels_per_step": len(kernels) / steps,
        "groups_ms": {g: v[0] for g, v in by_group.items()}, "device": torch.cuda.get_device_name(0),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--student", choices=("body", "face", "frame"), default="body")
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--int8", action="store_true", help="profile the body step under the int8 teacher (--teacher-int8)")
    parser.add_argument("--time", action="store_true", help="time the frame, face step and body path instead of profiling a step")
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                        help="the checkout whose tha4_tpu_torch runs (default: the one this file lies in)")
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import tha4_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(tha4_tpu_torch.__file__))) != root:
        raise SystemExit(f"profile_step: imported {tha4_tpu_torch.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 2
    # Full-f32 products, set as utils.precision.set_full_f32 sets them (the
    # tool also runs trees that predate that module).
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    if args.time:
        summary = _time_body(args.label or root)
    else:
        summary = _profile(args.student, torch.bfloat16 if args.dtype == "bf16" else torch.float32, args.steps, args.int8)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
