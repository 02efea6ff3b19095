"""Evaluate a body-student checkpoint of a distillation run against its
random teacher (counterpart of ``tools/eval_body_checkpoint.py``).

    python -m tha4_tpu_torch.tools.eval_body_checkpoint PREFIX [--index N]
        [--eval-poses 64] [--batch 8] [--json out.json] [--export DIR]
        [--model character_model.yaml] [--device cuda|cpu]

Loads checkpoint N (default: the newest complete one) of the body student
under ``DistillerConfig.load(PREFIX/config.yaml).body_morpher_prefix()``,
in the port's checkpoint layout (``training/checkpoint.py``), rebuilds the
teacher the run trained against as ``tha4-torch-distill --random-teacher``
builds it (``mode_07.init`` from a generator seeded 0 at the shipped
widths), and reports ``tools.body_eval`` on
``utils.fidelity.random_pose_suite(--eval-poses, seed=0xE7A1)`` in f32:
the units of ``dtype_ab``, so that a run's end quality compares with the
A/B's arms.  ``examples`` is the count the checkpoint recorded (the JAX
tool writes index x 100 000, the production cadence).  The character is
the run's own image (``character_image_file_name`` of its config), or that
of ``--model``.

``--export DIR`` also writes the checkpoint as ``DIR/body_morpher.pt``
through the DAG's export (``DistillationJobs._export_student``).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from tha4_tpu_torch.distiller.config import DistillerConfig
from tha4_tpu_torch.distiller.pipeline import DistillationJobs
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_07
from tha4_tpu_torch.tools import body_eval
from tha4_tpu_torch.training import checkpoint as ckpt
from tha4_tpu_torch.training.trainer import KEY_MODULE
from tha4_tpu_torch.utils import fidelity, precision


def newest_checkpoint(body_prefix: str) -> int:
    """The highest index N such that checkpoints 1..N are complete; 0 if
    none is."""
    index = 0
    while ckpt.can_load(ckpt.checkpoint_dir(body_prefix, index + 1), [KEY_MODULE]):
        index += 1
    return index


def evaluate(prefix: str, index: Optional[int] = None, eval_poses: int = 64, batch: int = 8, model: Optional[str] = None,
             export: Optional[str] = None, device="cuda", teacher_cfg: Optional[mode_07.TeacherConfig] = None,
             student_cfg: Optional[siren.SirenMorpherConfig] = None, log: Callable[[str], None] = print) -> dict:
    """The checkpoint's record: ``checkpoint``, ``examples`` and the four
    metrics of ``body_eval``."""
    device = torch.device(device)
    config = DistillerConfig.load(os.path.join(prefix, "config.yaml"))
    body_prefix = config.body_morpher_prefix()
    if index is None:
        index = newest_checkpoint(body_prefix)
        if index == 0:
            raise SystemExit(f"no complete checkpoints under {body_prefix}")
    directory = ckpt.checkpoint_dir(body_prefix, index)
    path = os.path.join(directory, f"module_{KEY_MODULE}.npz")
    student = siren.SirenMorpher(student_cfg or siren.SirenMorpherConfig())
    student.load_state_dict({k: torch.from_numpy(v) for k, v in ckpt._load_npz(path).items()})
    examples = ckpt.read_examples_seen(directory)
    log(f"checkpoint {index:04d} ({examples:,} examples): {path}")

    precision.set_full_f32()
    teacher_cfg = teacher_cfg or mode_07.TeacherConfig()
    teacher = mode_07.Teacher.from_params(mode_07.init(torch.Generator().manual_seed(0), teacher_cfg), teacher_cfg)
    teacher.freeze(torch.float32, device)
    if model:
        image = body_eval.character_image(model, device)
    else:
        from tha4_tpu_torch.core import imagecodec

        image = torch.from_numpy(np.ascontiguousarray(imagecodec.load_image_hwc(config.character_image_file_name)))[None].to(device)
    suite = fidelity.random_pose_suite(eval_poses, seed=body_eval.EVAL_SEED)
    result = {"checkpoint": index, "examples": examples,
              **body_eval.evaluate_body_student(teacher, student.to(device), image, suite, batch)}
    log("  ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}" for k, v in result.items()))

    if export:
        os.makedirs(export, exist_ok=True)
        DistillationJobs._export_student(path, siren.SirenMorpher(student.cfg), os.path.join(export, "body_morpher.pt"))
        log(f"exported body_morpher.pt (checkpoint {index:04d}) to {export}")
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("prefix")
    parser.add_argument("--index", type=int, default=None, help="checkpoint index (default: the newest complete one)")
    parser.add_argument("--eval-poses", type=int, default=64)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--json", default=None)
    parser.add_argument("--export", default=None, metavar="DIR", help="also write this checkpoint as DIR/body_morpher.pt")
    parser.add_argument("--model", default=None,
                        help="character_model.yaml supplying the character image (default: the run's own image)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    device = body_eval.resolve_device(args.device)
    result = evaluate(args.prefix, args.index, args.eval_poses, args.batch, args.model, args.export, device,
                      log=lambda line: print(line, flush=True))
    if args.json:
        body_eval.write_json(args.json, result)
        print(f"wrote {args.json}", flush=True)
    return result


if __name__ == "__main__":
    main()
