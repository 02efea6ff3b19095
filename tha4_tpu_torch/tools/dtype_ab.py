"""A/B: does the training dtype change what the body student learns?
(counterpart of ``tools/dtype_ab.py``)

    python -m tha4_tpu_torch.tools.dtype_ab [--examples 50000] [--batch 8]
        [--lookahead K] [--eval-poses 64] [--arms bf16,f32,bf16t+f32s,mixed]
        [--json out.json] [--model character_model.yaml] [--device cuda|cpu]

Body-student trainings from one init and one pose stream, one an arm, each
then evaluated against the f32 teacher's labels on a held-out pose suite
(``utils.fidelity.random_pose_suite(n, seed=0xE7A1)``) in f32
(``tools.body_eval``): blended, warped and grid-change L1 and the blended
PSNR.  The arms differ only in the activation dtypes of the recipe
(``recipes.make_body_distill_group``):

  * ``bf16``: teacher and student in bf16;
  * ``f32``: both in f32 (full f32, no TF32: the reference's semantics);
  * ``bf16t+f32s``: the teacher in bf16 (``teacher_dtype``), the student
    in f32, which says which side a bf16 quality cost comes from;
  * ``mixed``: bf16 with the selective-f32 student (the pipeline's default).

The same in every arm: the student's init (a torch generator seeded 0) and
its f32 master weights; the teacher, ``mode_07.init`` from a generator
seeded 0 at the shipped widths (the random teacher of ``tha4-torch-distill
--random-teacher``), frozen once per dtype; the pose stream,
``pose_dataset.sample_poses`` on a generator seeded 7 (its sha256 is
recorded per arm); the lr, 1e-4; the loss weights, 1.0, 2.5, 5.0, 1.0 in
``BODY_LOSS_TERMS`` order.  ``--lookahead`` defaults to
``recipes.default_lookahead(batch)`` (1 at batch 8 on one card); the
update stream is the same at any K, and the step count is rounded up to a
multiple of K.  Without ``--model`` the character is
``charmodel.synthetic.synthetic_character_image(512, 0)``.

``--json`` writes the JAX tool's layout: ``results.{arm}.{train_loss,
wall_s, ms_per_step, blended_l1, warped_l1, grid_l1, psnr_vs_f32}`` (plus
``poses_sha256``), ``delta`` (bf16 - f32, where both are there),
``examples``, ``batch``, ``lookahead``, ``lr`` and ``card`` (the card's name
and power limit).  Arms already in the file are kept, so ``--arms`` runs
can be merged; the file is written after every arm.
"""

from __future__ import annotations

import argparse
import hashlib
import time
from typing import Callable, Optional, Sequence

import torch

from tha4_tpu_torch.distiller import pose_dataset, recipes
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_07
from tha4_tpu_torch.tools import body_eval
from tha4_tpu_torch.utils import fidelity, precision

# tag -> (student dtype, teacher dtype or None for the student's, selective-f32 student)
ARMS = {
    "bf16": (torch.bfloat16, None, False),
    "f32": (torch.float32, None, False),
    "bf16t+f32s": (torch.float32, torch.bfloat16, False),
    "mixed": (torch.bfloat16, None, True),
}
LR = 1e-4
LOSS_WEIGHTS = dict(zip(recipes.BODY_LOSS_TERMS, (1.0, 2.5, 5.0, 1.0)))
POSE_SEED = 7


def student_init(student_cfg: siren.SirenMorpherConfig):
    """The one init every arm starts from: f32 state dict on the CPU."""
    return siren.SirenMorpher(student_cfg, generator=torch.Generator().manual_seed(0)).state_dict()


def run(teacher_params: mode_07.Params, image: torch.Tensor, arms: Sequence[str], examples: int, batch: int,
        lookahead: int, eval_poses: int, device: torch.device, json_path: Optional[str] = None,
        teacher_cfg: Optional[mode_07.TeacherConfig] = None, student_cfg: Optional[siren.SirenMorpherConfig] = None,
        log: Callable[[str], None] = print) -> dict:
    """Train and evaluate ``arms`` (keys of ``ARMS``); returns the JSON
    record (written to ``json_path`` after every arm where given)."""
    unknown = sorted(set(arms) - set(ARMS))
    if unknown:
        raise ValueError(f"unknown arms {unknown}; the arms are {list(ARMS)}")
    student_cfg = student_cfg or siren.SirenMorpherConfig()
    precision.set_full_f32()  # the f32 arm and the evaluation: full-f32 products; bf16 is untouched
    k = max(1, int(lookahead))
    n_steps = -(-examples // batch)
    n_steps = -(-n_steps // k) * k
    log(f"{n_steps} steps x B{batch} = {n_steps * batch} examples, lookahead {k}")
    student0 = student_init(student_cfg)
    teachers = {}

    def teacher(dtype):
        if dtype not in teachers:
            teachers[dtype] = mode_07.Teacher.from_params(teacher_params, teacher_cfg).freeze(dtype, device)
        return teachers[dtype]

    suite = fidelity.random_pose_suite(eval_poses, seed=body_eval.EVAL_SEED)
    results = body_eval.load_results(json_path)
    if results:
        log(f"merging into existing arms: {sorted(results)}")
    record = {}
    for tag in arms:
        dtype, teacher_dtype, mixed = ARMS[tag]
        student = siren.SirenMorpher(student_cfg)
        student.load_state_dict(student0)
        student.to(device)
        optimizer = recipes.make_adam(student)
        group = recipes.make_body_distill_group(teacher(teacher_dtype or dtype), image, dtype, mixed, None, teacher_dtype)
        gen = torch.Generator().manual_seed(POSE_SEED)
        digest = hashlib.sha256()
        t0 = time.perf_counter()
        for g in range(n_steps // k):
            poses = [pose_dataset.sample_poses(gen, batch) for _ in range(k)]
            for p in poses:
                digest.update(p.numpy().tobytes())
            named = group(student, optimizer, [p.to(device) for p in poses], [LR] * k, [LOSS_WEIGHTS] * k)
            if g == 0 or (g + 1) % max(1, 256 // k) == 0:
                done = (g + 1) * k
                log(f"  [{tag}] step {done}/{n_steps}  loss {float(named['loss']):.4f}  "
                    f"{1000 * (time.perf_counter() - t0) / done:.1f} ms/step")
        train_loss = float(named["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        ev = body_eval.evaluate_body_student(teacher(torch.float32), student, image, suite, batch)
        results[tag] = {"train_loss": train_loss, "wall_s": wall, "ms_per_step": 1000 * wall / n_steps, **ev,
                        "poses_sha256": digest.hexdigest()}
        log(f"{tag}: {n_steps} steps in {wall:.1f}s ({1000 * wall / n_steps:.1f} ms/step)  final-train-loss {train_loss:.4f}")
        log("  eval vs f32 teacher: " + "  ".join(f"{key}={ev[key]:.5f}" for key in body_eval.METRICS))
        delta = {}
        if "bf16" in results and "f32" in results:
            delta = {key: results["bf16"][key] - results["f32"][key] for key in body_eval.METRICS}
        record = {"results": results, "delta": delta, "examples": n_steps * batch, "batch": batch, "lookahead": k,
                  "lr": LR, "card": body_eval.card(device)}
        if json_path:
            body_eval.write_json(json_path, record)
    if record.get("delta"):
        log("delta bf16-f32: " + "  ".join(f"{key}={v:+.5f}" for key, v in record["delta"].items()))
    if json_path:
        log(f"wrote {json_path}")
    return record


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--examples", type=int, default=50_000)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lookahead", type=int, default=None, help="teacher lookahead K (default: recipes.default_lookahead)")
    parser.add_argument("--eval-poses", type=int, default=64)
    parser.add_argument("--json", default=None)
    parser.add_argument("--arms", default=",".join(ARMS),
                        help="comma-separated arm subset; --json merges into existing results")
    parser.add_argument("--model", default=None, help="character_model.yaml (default: the synthetic character)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    device = body_eval.resolve_device(args.device)
    lookahead = args.lookahead if args.lookahead is not None else recipes.default_lookahead(args.batch)
    teacher_params = mode_07.init(torch.Generator().manual_seed(0), mode_07.TeacherConfig())
    image = body_eval.character_image(args.model, device)
    return run(teacher_params, image, [a for a in args.arms.split(",") if a], args.examples, args.batch, lookahead,
               args.eval_poses, device, args.json, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
