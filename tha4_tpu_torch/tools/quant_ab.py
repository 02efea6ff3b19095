"""A/B: does the int8 frozen teacher change what the body student learns?
(counterpart of ``tools/quant_ab.py``)

    python -m tha4_tpu_torch.tools.quant_ab [--steps 1500] [--batch 8]
        [--eval-batches 8] [--arms bf16,int8] [--json out.json]
        [--model character_model.yaml] [--device cuda|cpu]

Two body-student trainings from one init and one pose stream, one against
the bf16 teacher (the pipeline's default), one against the int8 teacher
(``ops.quant``, its convolutions on Q1), then both students evaluated
against the f32 teacher's labels (``tools.body_eval``).  Equal eval
losses say the int8 labels' extra quantization noise does not change what
the student learns at this horizon; a worse int8 arm says it biases it.

As in the JAX tool: the teacher is ``mode_07.init`` from a generator seeded
0 at the shipped widths (random weights, the harder case for post-training
quantization: no learned structure to ride), frozen in bf16 and calibrated
once (``quant.run_calibration``) on the character image and
``sample_poses`` of a generator seeded 0, at the batch; the student starts
from a generator seeded 0 and keeps its parameters in bf16
(``tools/quant_ab.py:99``), unlike the pipeline, whose master weights are
f32; both arms train plain bf16 (not selective f32) at lr 1e-4 with the loss
weights 1.0, 2.5, 5.0, 1.0, lookahead 1, on ``sample_poses`` from a
generator seeded 7.  The evaluation takes ``--eval-batches`` batches of
``sample_poses`` from a generator seeded 0xE7A1, the student in bf16.

Prints each arm's eval and ``delta int8-bf16``, and returns (and with
``--json`` writes, merging arms already in the file) ``results.{arm}.
{blended_l1, warped_l1, grid_l1, psnr_vs_f32, train_loss, wall_s,
ms_per_step, poses_sha256}``, ``delta``, ``steps``, ``batch``, ``lr`` and
``card``.
"""

from __future__ import annotations

import argparse
import hashlib
import time
from typing import Callable, Optional, Sequence

import torch

from tha4_tpu_torch.distiller import pose_dataset, recipes
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops import quant
from tha4_tpu_torch.poser.modes import mode_07
from tha4_tpu_torch.tools import body_eval, dtype_ab
from tha4_tpu_torch.utils import precision

ARMS = ("bf16", "int8")
DTYPE = torch.bfloat16


def calibrate(teacher16: mode_07.Teacher, image: torch.Tensor, batch: int):
    """The int8 teacher's activation scales: one bf16 forward at the batch."""
    poses = pose_dataset.sample_poses(torch.Generator().manual_seed(0), batch).to(image.device, DTYPE)
    return quant.run_calibration(mode_07.compute_outputs, teacher16, image.to(DTYPE).expand(batch, -1, -1, -1), poses)


def eval_poses(batches: int, batch: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(body_eval.EVAL_SEED)
    return torch.cat([pose_dataset.sample_poses(gen, batch) for _ in range(batches)])


def run(teacher_params: mode_07.Params, image: torch.Tensor, arms: Sequence[str], steps: int, batch: int,
        eval_batches: int, device: torch.device, json_path: Optional[str] = None,
        teacher_cfg: Optional[mode_07.TeacherConfig] = None, student_cfg: Optional[siren.SirenMorpherConfig] = None,
        log: Callable[[str], None] = print) -> dict:
    """Train and evaluate ``arms`` (of ``ARMS``); returns the record."""
    unknown = sorted(set(arms) - set(ARMS))
    if unknown:
        raise ValueError(f"unknown arms {unknown}; the arms are {list(ARMS)}")
    student_cfg = student_cfg or siren.SirenMorpherConfig()
    precision.set_full_f32()  # the f32 evaluation teacher
    teacher16 = mode_07.Teacher.from_params(teacher_params, teacher_cfg).freeze(DTYPE, device)
    teacher32 = mode_07.Teacher.from_params(teacher_params, teacher_cfg).freeze(torch.float32, device)
    scales = calibrate(teacher16, image, batch) if "int8" in arms else None
    if scales is not None:
        log(f"calibrated {len(scales)} convs")
    student0 = dtype_ab.student_init(student_cfg)
    suite = eval_poses(eval_batches, batch)
    results = body_eval.load_results(json_path)
    record = {}
    for tag in arms:
        student = siren.SirenMorpher(student_cfg)
        student.load_state_dict(student0)
        student.to(device, DTYPE)
        optimizer = recipes.make_adam(student)
        step = recipes.make_body_distill_step(teacher16, image, DTYPE, False, scales if tag == "int8" else None)
        gen = torch.Generator().manual_seed(dtype_ab.POSE_SEED)
        digest = hashlib.sha256()
        t0 = time.perf_counter()
        for _ in range(steps):
            poses = pose_dataset.sample_poses(gen, batch)
            digest.update(poses.numpy().tobytes())
            named = step(student, optimizer, poses.to(device), dtype_ab.LR, dtype_ab.LOSS_WEIGHTS)
        train_loss = float(named["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        ev = body_eval.evaluate_body_student(teacher32, student, image, suite, batch, DTYPE)
        results[tag] = {**ev, "train_loss": train_loss, "wall_s": wall, "ms_per_step": 1000 * wall / steps,
                        "poses_sha256": digest.hexdigest()}
        log(f"{tag}: {steps} steps in {wall:.1f}s ({1000 * wall / steps:.1f} ms/step)  final-train-loss {train_loss:.4f}")
        log("  eval vs f32 teacher: " + "  ".join(f"{key}={ev[key]:.5f}" for key in body_eval.METRICS))
        delta = {}
        if "bf16" in results and "int8" in results:
            delta = {key: results["int8"][key] - results["bf16"][key] for key in body_eval.METRICS}
        record = {"results": results, "delta": delta, "steps": steps, "batch": batch, "lr": dtype_ab.LR,
                  "card": body_eval.card(device)}
        if json_path:
            body_eval.write_json(json_path, record)
    if record.get("delta"):
        log("delta int8-bf16: " + "  ".join(f"{key}={v:+.5f}" for key, v in record["delta"].items()))
    return record


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--eval-batches", type=int, default=8)
    parser.add_argument("--arms", default=",".join(ARMS), help="comma-separated arm subset; --json merges into existing results")
    parser.add_argument("--json", default=None)
    parser.add_argument("--model", default=None, help="character_model.yaml (default: the synthetic character)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    device = body_eval.resolve_device(args.device)
    teacher_params = mode_07.init(torch.Generator().manual_seed(0), mode_07.TeacherConfig())
    image = body_eval.character_image(args.model, device)
    return run(teacher_params, image, [a for a in args.arms.split(",") if a], args.steps, args.batch, args.eval_batches,
               device, args.json, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
