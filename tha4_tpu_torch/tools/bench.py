"""Bench: 512x512 student frames per second on one card, B = 1, bf16
(counterpart of the root ``bench.py``, by its own method).

    python -m tha4_tpu_torch.tools.bench [--model character_model.yaml]

The reference's headline real-time metric (BASELINE.md: student real-time
puppeteering; the real-time target is more than 60 fps per chip).  The frames
are the JAX bench's 100-frame sweep (``pose_sweep``: blink, talk, head and
body sway, breathing over their real ranges, the default pose underneath).
Without ``--model`` the character is the full-width random-init model of
``charmodel.synthetic.write_random_character_model`` (seed 0),
written to a temporary directory.

Method, the counterpart of the JAX bench's ``lax.scan``: the 100 poses sit
in one tensor on the card, and ``mode_14.compute_outputs`` of every frame,
each frame's mean blended output added into one f32 scalar on the card,
is captured in one CUDA graph.  After one eager run (which makes the cached
grids and matrices and K1's plans) and one untimed replay, one replay is
timed with the host clock up to ``float(scalar)``: ``fps = n / dt``.  The
same 100 frames run eagerly, timed with the host clock up to a
synchronize, give the eager fps, which is what the puppeteer's loop sees.

Prints a JSON line with the detail (both readings, both scalars, which must
agree bit for bit, and the K1 and K2 launches counted at capture: the
Python counters count once at capture and never at replay), then, as the
last line, the JAX bench's keys (``metric``, ``value``, ``unit``,
``vs_baseline``) plus ``device``: the card's name and power limit as
``nvidia-smi`` gives them.  Needs a CUDA device: ``--device cpu`` is
refused.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BASELINE_FPS = 60.0  # the real-time target: >60 fps/chip (BASELINE.md)
METRIC = "student_512x512_frames_per_sec_per_chip"
FRAMES = 100


def pose_sweep(pose_parameters, n: int = FRAMES) -> np.ndarray:
    """(n, 45) float32: the JAX bench's animated sweep (``bench.py:56-72``),
    the eight parameters resolved by name over the default pose.  Each value
    is the formula at frame index i, computed in f64 and rounded once."""
    idx = {name: pose_parameters.get_parameter_index(name) for name in (
        "head_x", "head_y", "neck_z", "body_z", "breathing", "mouth_aaa", "eye_wink_left", "eye_wink_right")}
    i = np.arange(n, dtype=np.float64)
    poses = np.tile(np.asarray(pose_parameters.get_default_pose(), np.float64), (n, 1))
    poses[:, idx["head_x"]] = 0.6 * np.sin(i / 4.0)
    poses[:, idx["head_y"]] = np.sin(i / 10.0)
    poses[:, idx["neck_z"]] = 0.5 * np.sin(i / 6.0)
    poses[:, idx["body_z"]] = 0.4 * np.sin(i / 9.0)
    poses[:, idx["breathing"]] = 0.5 + 0.5 * np.sin(i / 5.0)
    poses[:, idx["mouth_aaa"]] = 0.5 + 0.5 * np.sin(i / 3.0)
    blink = np.clip(np.sin(i / 7.0) * 8.0 - 7.0, 0.0, 1.0)
    poses[:, idx["eye_wink_left"]] = blink
    poses[:, idx["eye_wink_right"]] = blink
    return poses.astype(np.float32)


def frame_sum(poser, image: torch.Tensor, poses: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc`` <- the sum over frames of each frame's mean blended output, in
    f32 on ``acc``'s device: ``mode_14.compute_outputs`` straight on device
    tensors (image (1, H, W, 4) and poses (n, 45), both in the poser's
    compute dtype), with nothing copied from the host, so the loop can be
    captured in a CUDA graph."""
    from tha4_tpu_torch.poser.modes import mode_14

    acc.zero_()
    for i in range(poses.shape[0]):
        outs = mode_14.compute_outputs(poser.face_cfg, poser.body_cfg, poser.face_chain, poser.body_chains,
                                       image, poses[i : i + 1])
        acc += outs[0].float().mean()
    return acc


def measure(poser, image: torch.Tensor, poses: torch.Tensor) -> dict:
    """Eager and CUDA-graph fps of ``frame_sum`` over ``poses`` on the card."""
    from tha4_tpu_torch.ops import cuda_siren, cuda_warp

    device, n = image.device, poses.shape[0]
    stream = torch.cuda.current_stream(device)
    acc = torch.zeros((), dtype=torch.float32, device=device)
    with torch.no_grad():
        # The warm-up runs on a side stream, as before a capture the CUDA
        # graph guide asks: cuBLAS's workspace and the cached tensors are
        # made there, outside the capture.
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            frame_sum(poser, image, poses, acc)
        stream.wait_stream(side)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        frame_sum(poser, image, poses, acc)
        torch.cuda.synchronize(device)
        eager_s = time.perf_counter() - t0
        eager_scalar = float(acc)

        graph_acc = torch.zeros((), dtype=torch.float32, device=device)
        graph = torch.cuda.CUDAGraph()
        cuda_siren.sine_chain_t.launches = 0
        cuda_warp.grid_sample_fast.launches = 0
        with torch.cuda.graph(graph):
            frame_sum(poser, image, poses, graph_acc)
        launches = {"sine_chain_t": cuda_siren.sine_chain_t.launches,
                    "grid_sample_fast": cuda_warp.grid_sample_fast.launches}
        graph.replay()
        float(graph_acc)  # untimed
        t0 = time.perf_counter()
        graph.replay()
        graph_scalar = float(graph_acc)
        graph_s = time.perf_counter() - t0
    return {"frames": n, "fps": n / graph_s, "eager_fps": n / eager_s, "graph_ms_per_frame": graph_s * 1e3 / n,
            "eager_ms_per_frame": eager_s * 1e3 / n, "graph_scalar": graph_scalar, "eager_scalar": eager_scalar,
            "launches_at_capture": launches}


def headline(fps: float, device_description: str) -> dict:
    """The last line: the JAX bench's keys, rounded as it rounds them, plus
    the card."""
    return {"metric": METRIC, "value": round(fps, 2), "unit": "fps", "vs_baseline": round(fps / BASELINE_FPS, 3),
            "device": device_description}


def card(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", default=None, help="character_model.yaml (default: a full-width random-init model)")
    parser.add_argument("--device", default="cuda", help="a CUDA device (default cuda); the CPU is refused")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type != "cuda":
        parser.error(f"--device {args.device}: the bench times a CUDA card; there is no CPU fallback")
    if not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is False; the bench runs only on a CUDA device")

    from tha4_tpu_torch.charmodel import CharacterModel
    from tha4_tpu_torch.charmodel.synthetic import write_random_character_model

    with tempfile.TemporaryDirectory(prefix="tha4_bench_") as tmp:
        model = CharacterModel.load(args.model or write_random_character_model(tmp, seed=0))
        poser = model.get_poser(torch.bfloat16, device)
        image = torch.from_numpy(model.get_character_image())[None].to(device, torch.bfloat16)
    poses = torch.from_numpy(pose_sweep(poser.pose_parameters, FRAMES)).to(device, torch.bfloat16)

    result = measure(poser, image, poses)
    description = card(device)
    print(json.dumps({**result, "model": args.model or "random full-width (seed 0)", "card": description}))
    if not math.isfinite(result["graph_scalar"]):
        raise SystemExit(f"bench: the frames' scalar is not finite ({result['graph_scalar']})")
    print(json.dumps(headline(result["fps"], description)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
