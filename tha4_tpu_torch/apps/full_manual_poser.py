"""full_manual_poser — pose a character with the five-network teacher
(counterpart of ``tha4_tpu/apps/full_manual_poser.py``, ``tha4-pose``).

Headless CLI: load a 512x512 RGBA image, set pose parameters by name,
render any of the 33 teacher outputs to PNG on the chosen device (``cuda``
by default, with no fallback; ``--device cpu`` runs the plain versions).
Each frame prints its host time and, on a GPU, its device time from a pair
of CUDA events.  ``build_pose`` is shared with the student CLI.

Examples:
  tha4-torch-pose --input char.png --set mouth_aaa=1 --set head_y=0.5 --output out.png
  tha4-torch-pose --input char.png --sweep head_y --frames 5 --output-dir sweep/ --bf16
  tha4-torch-pose --input char.png --module-file upscaler=/path/upscaler.pt --device cpu
  tha4-torch-pose --list-params
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_pose(pose_parameters, assignments):
    """The default pose with ``(name, value)`` assignments applied."""
    pose = pose_parameters.get_default_pose()
    for name, value in assignments:
        pose[pose_parameters.get_parameter_index(name)] = value
    return pose


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", help="512x512 RGBA character image")
    parser.add_argument("--output", default="output.png")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                        help="set a pose parameter (repeatable)")
    parser.add_argument("--output-index", type=int, default=0,
                        help="which of the 33 teacher outputs to save")
    parser.add_argument("--sweep", default=None, metavar="NAME",
                        help="sweep one parameter over its range")
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--list-params", action="store_true")
    parser.add_argument("--list-outputs", action="store_true")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--module-file", action="append", default=[], metavar="KEY=PATH",
                        help="override a teacher weight file (e.g. face_morpher=/path.pt)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")
    args = parser.parse_args(argv)

    from tha4_tpu_torch.poser.modes.pose_parameters import get_pose_parameters

    pose_parameters = get_pose_parameters()

    if args.list_params:
        for group in pose_parameters.get_pose_parameter_groups():
            for name in group.get_parameter_names():
                lo, hi = group.get_range()
                print(f"{name:32s} [{lo}, {hi}] default {group.get_default_value()}")
        return 0

    if args.list_outputs:
        names = (
            [f"{i}: upscaler {n}" for i, n in enumerate(["merged", "alpha", "warped", "grid_change", "direct"])]
            + ["5: face_morphed_full"]
            + [f"{6+i}: body_morpher {n}" for i, n in enumerate(["merged", "alpha", "warped", "grid_change", "direct"])]
            + [f"{11+i}: face_morpher output {i}" for i in range(8)]
            + [f"{19+i}: eyebrow_combiner output {i}" for i in range(8)]
            + [f"{27+i}: eyebrow_decomposer output {i}" for i in range(6)]
        )
        print("\n".join(names))
        return 0

    if not args.input:
        parser.error("--input is required")

    import torch

    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.poser.modes import mode_07

    device = torch.device(args.device)
    module_file_names = dict(kv.split("=", 1) for kv in args.module_file)
    poser = mode_07.create_poser(
        module_file_names=module_file_names or None,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=device,
    )
    # One tensor on the device for every frame: the decomposer runs once.
    image = torch.from_numpy(imagecodec.load_image_hwc(args.input)).to(device)
    assignments = []
    for kv in args.set:
        name, value = kv.split("=", 1)
        assignments.append((name, float(value)))

    def render(pose, path):
        events = None
        if device.type == "cuda":
            events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            events[0].record()
        t0 = time.perf_counter()
        out = poser.pose(image, pose, args.output_index)
        if events is not None:
            events[1].record()
        frame = out[0].cpu()  # waits for the device
        dt = (time.perf_counter() - t0) * 1000.0
        if frame.shape[-1] != 4:
            frame = frame[..., :1].repeat(1, 1, 3)
        imagecodec.save_image_hwc(frame, path)
        device_ms = "" if events is None else f", {events[0].elapsed_time(events[1]):.1f} ms device"
        print(f"{path}: {dt:.1f} ms{device_ms}")

    if args.sweep:
        out_dir = args.output_dir or "sweep"
        os.makedirs(out_dir, exist_ok=True)
        group = next(
            g for g in pose_parameters.get_pose_parameter_groups() if args.sweep in g.get_parameter_names()
        )
        lo, hi = group.get_range()
        for i in range(args.frames):
            value = lo + (hi - lo) * i / max(args.frames - 1, 1)
            pose = build_pose(pose_parameters, assignments + [(args.sweep, value)])
            render(pose, f"{out_dir}/{args.sweep}_{i:03d}.png")
    else:
        pose = build_pose(pose_parameters, assignments)
        render(pose, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
