"""tha4-torch-eval — fidelity evaluation of a character model, on the card
(counterpart of ``tha4_tpu/apps/evaluate.py``, ``tha4-eval``).

Renders a deterministic pose suite through the port's student poser and
(when the original PyTorch implementation is importable) side by side
through it, or through a second character model (--against), reporting
PSNR, windowed SSIM and a self-contained random-feature perceptual proxy
(utils/fidelity.lpips_proxy; pass --lpips-weights for true AlexNet-LPIPS).

--dtype bf16 evaluates the production fast path (the puppeteer/bench
configuration) against the f32 reference, so the bench's frames/s can be
quoted together with its measured fidelity.

Examples:
  tha4-torch-eval --model data/character_models/lambda_00/character_model.yaml --poses 16
  tha4-torch-eval --model a/character_model.yaml --against b/character_model.yaml
  tha4-torch-eval --model a/character_model.yaml --dtype bf16 --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys

# --matmul-precision's words, JAX's, onto torch.set_float32_matmul_precision's.
MATMUL_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True, help="character_model.yaml")
    parser.add_argument("--against", default=None,
                        help="second character_model.yaml to compare with (default: the PyTorch reference "
                        "implementation on the same model)")
    parser.add_argument("--poses", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reference-src", default="/root/reference/src")
    parser.add_argument("--lpips-weights", default=None,
                        help="state dict of lpips.LPIPS(net='alex') for TRUE LPIPS; without it the self-contained "
                        "random-feature proxy is still reported")
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                        help="compute dtype for the port's poser (bf16 = the production fast path)")
    parser.add_argument("--matmul-precision", choices=tuple(MATMUL_PRECISION), default=None,
                        help="f32 matmul precision for this call (torch.set_float32_matmul_precision: default -> "
                        "medium, high -> high, highest -> highest; restored afterwards; unset: left as it is). The "
                        "hand-written kernels keep their stated operand precision whatever this flag says")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    import torch

    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.utils import fidelity

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    before = torch.get_float32_matmul_precision()
    if args.matmul_precision is not None:
        torch.set_float32_matmul_precision(MATMUL_PRECISION[args.matmul_precision])
    try:
        if args.against is not None:
            a = CharacterModel.load(args.model)
            b = CharacterModel.load(args.against)
            stats = fidelity.compare_posers(
                a.get_poser(compute_dtype=dtype, device=args.device), b.get_poser(device=args.device),
                a.get_character_image(), fidelity.random_pose_suite(args.poses, args.seed),
                lpips_weights=args.lpips_weights,
            )
        else:
            stats = fidelity.compare_with_reference(
                args.model, num_poses=args.poses, reference_src=args.reference_src, seed=args.seed,
                lpips_weights=args.lpips_weights, compute_dtype=dtype, device=args.device,
            )
            if stats is None:
                print("reference implementation not found; use --against", file=sys.stderr)
                return 2
    finally:
        torch.set_float32_matmul_precision(before)
    stats["dtype"] = args.dtype
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
