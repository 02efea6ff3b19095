"""character_model_manual_poser — pose a distilled character model (students).

Headless CLI: load a character_model.yaml, set pose parameters by name,
render the student outputs to PNG on the chosen device.

Examples:
  python -m tha4_tpu_torch.apps.character_model_manual_poser \
      --model data/character_models/lambda_00/character_model.yaml \
      --set eye_wink_left=1 --output out.png
  python -m tha4_tpu_torch.apps.character_model_manual_poser --model ... \
      --sweep head_y --frames 8 --output-dir sweep/ --bf16
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True, help="character_model.yaml")
    parser.add_argument("--output", default="output.png")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    parser.add_argument("--output-index", type=int, default=0, help="0..5 (mode_14 outputs)")
    parser.add_argument("--sweep", default=None, metavar="NAME")
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")
    args = parser.parse_args(argv)

    import torch

    from tha4_tpu_torch.apps.full_manual_poser import build_pose
    from tha4_tpu_torch.charmodel.character_model import CharacterModel
    from tha4_tpu_torch.core import imagecodec

    model = CharacterModel.load(args.model)
    poser = model.get_poser(torch.bfloat16 if args.bf16 else torch.float32, args.device)
    image = model.get_character_image()
    pose_parameters = poser.pose_parameters
    assignments = [(kv.split("=", 1)[0], float(kv.split("=", 1)[1])) for kv in args.set]

    def render(pose, path):
        t0 = time.perf_counter()
        frame = poser.pose(image, pose, args.output_index)[0].cpu()  # .cpu() waits for the device
        dt = (time.perf_counter() - t0) * 1000.0
        if frame.shape[-1] != 4:
            frame = frame[..., :1].repeat(1, 1, 4)
        imagecodec.save_image_hwc(frame, path)
        print(f"{path}: {dt:.1f} ms")

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
        render(build_pose(pose_parameters, assignments), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
