"""Narrow widths of the two configurations for CPU tests (the image sizes
stay as published: the program pastes and crops at fixed places)."""

import copy
import json
import time

from benchmark import harness

FACE = {"image_size": 128, "image_channels": 4, "pose_size": 39, "intermediate_channels": 16, "num_sine_layers": 3,
        "paste_y": 80, "paste_x": 192}
LEVELS = [{"image_size": 128, "intermediate_channels": 24, "num_sine_layers": 2},
          {"image_size": 256, "intermediate_channels": 12, "num_sine_layers": 2},
          {"image_size": 512, "intermediate_channels": 8, "num_sine_layers": 2}]


def config(name: str) -> dict:
    with open(harness.ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        return json.load(f)


def student_cfg() -> dict:
    cfg = config("mode14_student")
    cfg["face"] = dict(FACE)
    cfg["body"]["levels"] = copy.deepcopy(LEVELS)
    return cfg


def distill_cfg(batch: int = 2) -> dict:
    cfg = config("mode07_body_distill")
    t = cfg["teacher"]
    for k in ("eyebrow_decomposer", "eyebrow_morphing_combiner", "face_morpher"):
        t[k].update(start_channels=4, num_bottleneck_blocks=1, max_channels=8)
    for k in ("body_morpher", "upscaler"):
        t[k].update(model_channels=8, level_channel_multipliers=[1, 1, 1, 2, 2], level_use_attention=[False] * 4 + [True],
                    num_middle_res_blocks=2, cond_internal_channels=16, attention_heads=2)
    cfg["student"]["levels"] = copy.deepcopy(LEVELS)
    cfg["training"]["batch_size"] = batch
    return cfg


def run(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False, **kw) -> dict:
    """One CPU run of a cell at narrow widths."""
    cfg = student_cfg() if workload.startswith("frame.") else distill_cfg()
    return harness.run_cell(workload, seed, seconds, trace, t0=time.perf_counter(), device="cpu", cfg_override=cfg, **kw)
