"""distill — train the per-character student models from a config file, on
the card (counterpart of ``tha4_tpu/apps/distill.py``, ``tha4-torch-distill``).

CLI-compatible with the reference (reference: src/tha4/app/distill.py:8-25)
and the JAX package's command:

  tha4-torch-distill --config_file <prefix>/config.yaml [--device cuda|cpu]

With ``num_gpus: N`` in the config it trains on N GPUs: it starts the N
ranks itself where N are visible, or runs as one of them under

  torchrun --nproc-per-node N -m tha4_tpu_torch.apps.distill --config_file ...

It writes ``<prefix>/character_model/`` (``character.png``,
``face_morpher.pt``, ``body_morpher.pt``, ``character_model.yaml``), which
``tha4-torch-char-pose`` and ``tha4-torch-puppeteer`` open.  Interruptible at
any time; rerunning the same command resumes from the newest checkpoint or
snapshot (the documented contract, reference docs/distill.md).
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--bf16", action="store_true", default=True,
                        help="teacher labels and student products in bf16 (the default)")
    parser.add_argument("--f32", dest="bf16", action="store_false", help="everything in f32")
    parser.add_argument(
        "--random-teacher",
        action="store_true",
        help="initialize the five teacher networks randomly (seed 0) at the shipped architecture instead of loading "
        "data/tha4/*.pt: for pipeline validation and timing where the pretrained teacher weights are absent. The "
        "trained students mimic a random teacher and are NOT usable character models; training cost is identical.",
    )
    parser.add_argument("--face-examples", type=int, default=None,
                        help="the face student's total training examples (default: the reference's 1,000,000); a "
                        "multiple of the 100k checkpoint cadence")
    parser.add_argument("--body-examples", type=int, default=None,
                        help="the body student's total training examples (default: the reference's 1,500,000); a "
                        "multiple of the 100k checkpoint cadence")
    parser.add_argument("--mixed", action="store_true", default=True,
                        help="selective-f32 body student training: bf16 matmul operands with f32 sums, sines and "
                        "head (the default)")
    parser.add_argument("--no-mixed", dest="mixed", action="store_false", help="plain-bf16 body student training")
    parser.add_argument("--only", choices=("all", "face", "body"), default="all",
                        help="run only one student's training task from the DAG instead of the full pipeline")
    parser.add_argument("--teacher-int8", action="store_true",
                        help="run the frozen teacher with int8 convolutions (post-training quantization, calibrated once "
                        "on the character image; ops/quant.py, the Q1 kernel); the distillation labels differ slightly "
                        "from the bf16 teacher: tha4-torch-verify measures how much on the weights in use before you "
                        "enable it")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    from tha4_tpu_torch.distiller import recipes

    kwargs = {}
    for name, value in (("face", args.face_examples), ("body", args.body_examples)):
        if value is None:
            continue
        if value <= 0 or value % recipes.EXAMPLES_PER_CHECKPOINT != 0:
            parser.error(f"--{name}-examples must be a positive multiple of {recipes.EXAMPLES_PER_CHECKPOINT}")
        kwargs[f"{name}_total_examples"] = value

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    import torch

    from tha4_tpu_torch.distiller import pipeline
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.parallel import mesh

    # Under torchrun, join its process group (one rank a GPU over NCCL, or gloo on the CPU).
    joined = not mesh.is_distributed() and mesh.initialize_multihost(backend="gloo" if args.device == "cpu" else "nccl")
    config = DistillerConfig.load(args.config_file)
    if args.random_teacher:
        from tha4_tpu_torch.poser.modes import mode_07

        logging.warning("--random-teacher: training against a randomly initialized teacher (full shipped "
                        "architecture); outputs are for pipeline and timing validation only")
        kwargs["teacher_params_07"] = mode_07.init(torch.Generator().manual_seed(0), mode_07.TeacherConfig())
    kwargs["student_mixed"] = args.mixed
    kwargs["teacher_int8"] = args.teacher_int8
    try:
        pipeline.run_config(config, target=args.only, compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                            device=args.device, **kwargs)
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
