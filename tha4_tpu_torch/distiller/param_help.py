"""Per-parameter distiller documentation (a copy of
``tha4_tpu/distiller/param_help.py``, with the port's own text for the
device fields).

Equivalent of the reference's in-app HTML help corpus
(reference: distiller-ui-doc/params/*.html, one page per DistillerConfig
field).  Surfaced by ``tha4-torch-distill-config --explain <param>`` (or
``--explain all``).
"""

from __future__ import annotations

from typing import Dict

PARAM_HELP: Dict[str, str] = {
    "prefix": """\
The directory under which the distillation job stores trained models,
checkpoints, snapshots, sample outputs and logs.  Use a dedicated
subdirectory per character (e.g. ``jobs/my_character``); every artifact path
in the config is resolved relative to the machine it runs on, so keep the
prefix inside your project tree.  The final artifacts land in
``<prefix>/character_model/``.""",
    "character_image_file_name": """\
The image of the humanoid character to distill.  Requirements:

  * PNG format with an alpha channel,
  * exactly 512 x 512 pixels,
  * ONE humanoid character, standing upright, facing forward,
  * hands below and away from the head,
  * the head roughly inside the 128 x 128 box centered in the middle of the
    top half of the image (x in [192, 320], y in [64, 192]),
  * alpha = 0 on every background pixel (the loader premultiplies by alpha).

The teacher networks were trained on anime-style characters drawn to this
layout; deviating from it degrades output quality.""",
    "face_mask_image_file_name": """\
A binary mask marking the character's movable facial organs.  Requirements:

  * PNG format, 512 x 512, RGB (no alpha),
  * every pixel either black (0,0,0) or white (255,255,255) — the config
    validator scans each pixel and rejects anything else,
  * white covers the movable face parts.  Three rectangles work well: one
    per eye+eyebrow, one for the mouth and jaw line.

During face-student training the mask's 128 x 128 face crop weights the L1
loss 20x inside the white region, focusing capacity on eyes and mouth.""",
    "num_gpus": """\
Data-parallel device count (the reference's ``num_gpus``: CUDA devices).
Each step's pose batch is split over that many ranks, one a GPU, and DDP
averages the gradients, so N GPUs make one GPU's updates (the teacher
labels several steps a call when a rank's batch is below 8).
tha4-torch-distill starts the ranks itself when that many GPUs are
visible, or runs as one of them under ``torchrun --nproc-per-node N``; with
fewer GPUs visible it warns and trains on one.  Both batch sizes must be
divisible by this count.""",
    "num_cpu_workers": """\
Host-side worker threads for pose-data processing.  This framework samples
each step's poses from a seeded generator on the host in the training
loop, so the setting exists for config compatibility with the reference,
where it sized DataLoader worker processes; 1 is always enough here.""",
    "face_morpher_batch_size": """\
Training examples per parameter update for the FACE student (SIREN face
morpher).  The shipped recipe uses 8, the value the lr schedule and the 1M
example budget were tuned for.  Smaller values save memory at the cost of
more steps; must be divisible by num_gpus.""",
    "body_morpher_batch_size": """\
Training examples per parameter update for the BODY student (3-level SIREN
morpher).  The shipped recipe uses 8 (see face_morpher_batch_size); the six
lr/loss-weight phases assume it.  Must be divisible by num_gpus.""",
    "face_morpher_random_seed_0": """\
Seed for the face student's parameter initialization and training-data
stream.  Any integer in [0, 2^64).  Two runs with identical seeds and config
produce identical checkpoints (resume is deterministic too).""",
    "face_morpher_random_seed_1": """\
Secondary seed for the face student: drives validation/sample-output pose
selection, independent of the training stream so changing one never
perturbs the other.""",
    "body_morpher_random_seed_0": """\
Seed for the body student's parameter initialization and training-data
stream (see face_morpher_random_seed_0).""",
    "body_morpher_random_seed_1": """\
Secondary seed for the body student (see face_morpher_random_seed_1).""",
    "face_morpher_num_training_examples_per_sample_output": """\
How often the face-student trainer writes a sample-output grid PNG
(groundtruth vs prediction, alpha and flow channels) under
``<prefix>/face_morpher/sample_outputs``.  Choices: every 10,000, 100,000 or
1,000,000 examples, or null to disable.  Sample outputs are the de-facto
visual regression test of a distillation run — keep them on unless disk is
tight.""",
    "body_morpher_num_training_examples_per_sample_output": """\
How often the body-student trainer writes sample-output grids (see the face
variant).  Body grids include the warped image, grid-change HSV-wheel
visualization and alpha channels.""",
}


def explain(name: str) -> str:
    if name == "all":
        parts = []
        for key in PARAM_HELP:
            parts.append(f"{key}\n{'-' * len(key)}\n{PARAM_HELP[key]}")
        return "\n\n".join(parts)
    if name not in PARAM_HELP:
        raise KeyError(f"no help for {name!r}; known: {', '.join(PARAM_HELP)} (or 'all')")
    return PARAM_HELP[name]
