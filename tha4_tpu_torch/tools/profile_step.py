"""Profile one distillation step on one GPU: device time by kernel, busy share.

    python -m tha4_tpu_torch.tools.profile_step [--student body|face] [--dtype bf16|f32]
                                                [--steps 5]

Builds the shipped teacher at full width with seeded random weights (mode_07
from ``charmodel.synthetic.random_teacher_07`` for the body student, mode_12
for the face student), the shipped student and the synthetic character, runs
two warm-up steps of the recipe at batch 8 (``recipes.make_body_distill_step``
with the selective-f32 student in bf16, or ``make_face_distill_step``), then
``--steps`` steps under ``torch.profiler`` with the poses already on the card.
Prints one line per kernel group and the busiest kernels, each as device ms
per step and launches per step, then a JSON summary: device busy ms per step
(the sum of kernel times: one stream, so kernels do not overlap), wall ms per
step under the profiler, and their ratio, the busy share.  Needs a CUDA
device; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile
import time

import torch

BATCH = 8
SEED = 20261016
TOP = 15  # the busiest kernels listed
# Kernel name fragments -> group, first match wins.
GROUPS = (
    ("K1 sine_chain", ("sine_chain_kernel",)),
    ("K4 sine_chain_bwd", ("sine_chain_bwd_kernel", "sum_slabs_kernel")),
    ("K2 warp", ("grid_sample_kernel",)),
    ("K3 warp corners", ("grid_sample_corners_kernel",)),
    ("K5 poly_sin", ("poly_sin_",)),
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


def _build_step(student_kind: str, dtype: torch.dtype, workdir: str):
    """(step() -> None) running one optimizer step of the chosen recipe."""
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
    if student_kind == "body":
        teacher = mode_07.Teacher.from_params(random_teacher_07(gen)).freeze(dtype, "cuda")
        student = siren.SirenMorpher(generator=gen).cuda()
        recipe = recipes.make_body_distill_step(teacher, image, dtype, mixed=dtype == torch.bfloat16)
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

    return step


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--student", choices=("body", "face"), default="body")
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory(prefix="profile_step_") as workdir:
        step = _build_step(args.student, dtype, workdir)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / args.steps
        by_name[e.name][1] += 1
    by_group = collections.defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_name.items():
        by_group[_group(name)][0] += ms
        by_group[_group(name)][1] += n
    busy = sum(ms for ms, _ in by_name.values())
    print(f"{args.student} step, {args.dtype}, B={BATCH}, {args.steps} steps on {torch.cuda.get_device_name(0)}:")
    for group, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {group:24s} {ms:9.3f} ms/step  {n / args.steps:7.1f} launches/step  {100.0 * ms / busy:5.1f} %")
    print(f"  busiest {TOP} kernels:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"    {ms:9.3f} ms/step  {n / args.steps:6.1f}/step  {name[:110]}")
    summary = {
        "student": args.student, "dtype": args.dtype, "batch": BATCH, "steps": args.steps,
        "device_busy_ms": busy, "wall_ms": wall_ms, "busy_share": busy / wall_ms,
        "kernels_per_step": len(kernels) / args.steps,
        "groups_ms": {g: v[0] for g, v in by_group.items()}, "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
