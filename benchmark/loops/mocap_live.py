"""Live puppeteering traffic: one client in a closed loop, flat out.

The generator turns a traffic file's channels into a seeded iFacialMocap
packet stream (every blendshape, bone and quaternion a packet carries;
each channel a sine or a blink with a seeded period, phase and noise), at
``packet_hz`` for ``stream_seconds``, made in set-up and cycled if the
window outlasts it.  Every packet differs from the one before, so the
puppeteer's pose-equality short-circuit never fires.

Each frame is the puppeteer's serial chain (``apps/puppeteer``): convert
the next packet (``now`` from its timestamp), pose at B = 1, display-encode
on the card, copy into one pinned host buffer, which waits for the frame.
A frame's latency runs from the packet handed to the converter to its
bytes in the host buffer.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

BLENDSHAPES = (
    "eyeLookInLeft", "eyeLookOutLeft", "eyeLookDownLeft", "eyeLookUpLeft", "eyeBlinkLeft", "eyeSquintLeft", "eyeWideLeft",
    "eyeLookInRight", "eyeLookOutRight", "eyeLookDownRight", "eyeLookUpRight", "eyeBlinkRight", "eyeSquintRight",
    "eyeWideRight", "browDownLeft", "browOuterUpLeft", "browDownRight", "browOuterUpRight", "browInnerUp",
    "noseSneerLeft", "noseSneerRight", "cheekSquintLeft", "cheekSquintRight", "cheekPuff", "mouthLeft",
    "mouthDimpleLeft", "mouthFrownLeft", "mouthLowerDownLeft", "mouthPressLeft", "mouthSmileLeft", "mouthStretchLeft",
    "mouthUpperUpLeft", "mouthRight", "mouthDimpleRight", "mouthFrownRight", "mouthLowerDownRight", "mouthPressRight",
    "mouthSmileRight", "mouthStretchRight", "mouthUpperUpRight", "mouthClose", "mouthFunnel", "mouthPucker",
    "mouthRollLower", "mouthRollUpper", "mouthShrugLower", "mouthShrugUpper", "jawLeft", "jawRight", "jawForward",
    "jawOpen", "tongueOut",
)
BONES = tuple(f"{part}Bone{axis}" for part in ("head", "leftEye", "rightEye") for axis in "XYZ")
QUATS = ("headBoneQuat", "leftEyeBoneQuat", "rightEyeBoneQuat")


def stream(traffic: dict, seed: int):
    """(packets, timestamps): ``packet_hz * stream_seconds`` packet dicts."""
    rng = np.random.default_rng([int(seed), 0x1F4C])
    n = int(traffic["packet_hz"] * traffic["stream_seconds"])
    t = np.arange(n) / traffic["packet_hz"]
    values = {}
    for ch in traffic["channels"]:
        period = rng.uniform(*ch["period_s"])
        phase = rng.uniform(0.0, 2.0 * math.pi)
        wave = np.sin(2.0 * math.pi * t / period + phase)
        lo, hi = ch.get("range", (0.0, 1.0))
        for key in ch["keys"]:
            if ch["kind"] == "blink":
                v = wave * ch["sharpness"] - (ch["sharpness"] - 1.0)
            else:
                v = ch["base"] + ch["amp"] * wave + ch.get("noise", 0.0) * rng.standard_normal(n)
            values[key] = np.clip(v, lo, hi)
    base = {name: 0.0 for name in BLENDSHAPES + BONES}
    packets = []
    for i in range(n):
        packet = dict(base)
        for key, v in values.items():
            packet[key] = float(v[i])
        for key in QUATS:
            packet[key] = [0.0, 0.0, 0.0, 1.0]
        packets.append(packet)
    return packets, t


def run(ctx) -> dict:
    """Set up, warm up, measure for ``ctx.seconds``, then check."""
    traffic, cfg, config, rec = ctx.traffic, ctx.cfg, ctx.config, ctx.recorder
    device = torch.device(ctx.device)
    packets, stamps = stream(traffic, ctx.seed)
    n_packets, period = len(packets), len(packets) / traffic["packet_hz"]
    data = config.inputs(cfg, ctx.seed, device)
    build = config.control if ctx.program == "control" else config.program
    chain = build(cfg, data, traffic["dtype"], device)
    size = chain.image.shape[0]
    host = torch.empty((size, size, 4), dtype=torch.uint8, pin_memory=device.type == "cuda")
    state = {"last_pose": None}

    def frame(i: int):
        """One frame of packet i; None where the pose repeats (no render)."""
        blend = packets[i % n_packets]
        now = float(stamps[i % n_packets]) + (i // n_packets) * period
        with rec.span("convert"):
            pose = chain.convert(blend, now=now)
        if pose == state["last_pose"]:
            return None
        state["last_pose"] = pose
        with rec.span("pose"):
            outs = chain.pose(chain.image, np.asarray(pose, np.float32))
        with rec.span("encode"):
            display = chain.encode(outs[0])[0]
        with rec.span("copy"):
            host.copy_(display)  # waits for the frame
        return pose, outs, display

    # Warm-up on packets from the end of the stream, which the window reaches last.
    with torch.inference_mode():
        for k in range(traffic["warmup_frames"]):
            frame(n_packets - 1 - k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rec.spans.clear()

    rng = np.random.default_rng([int(ctx.seed), 0x5A3])
    # The frames to compare: a uniform sample of those the window delivers,
    # drawn from the seed as they come (a reservoir), so that it always
    # holds ``compare_frames`` of them.
    size, draws = traffic["compare_frames"], np.random.default_rng([int(ctx.seed), 0x5A4]).random(1 << 20)
    kept, poses, latencies = [], [], []
    state["last_pose"] = None
    rec.start_window()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    t_end = t_start + ctx.seconds
    i = 0
    with torch.inference_mode():
        while time.perf_counter() < t_end:
            t0 = time.perf_counter()
            result = frame(i)
            if result is not None:
                latencies.append(time.perf_counter() - t0)
                poses.append(result[0])
                n = len(latencies)
                if n <= size:
                    kept.append((result[0], result[1], result[2]))
                else:
                    slot = int(draws[n % len(draws)] * n)
                    if slot < size:
                        kept[slot] = (result[0], result[1], result[2])
            i += 1
    window_s = time.perf_counter() - t_start
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec.end_window()

    # The copy: the host buffer holds the last frame's bytes.
    last_display = result[2] if result is not None else None
    copy_gap = 0.0 if last_display is None else float((host.to(last_display.device).int() - last_display.int()).abs().max())
    # The converter: a sample of the window's packets through the reference rule, exactly.
    sample = rng.choice(len(poses), size=min(len(poses), traffic["compare_poses"]), replace=False)
    pose_gap = max(
        (max(abs(a - b) for a, b in zip(poses[k], config.reference_pose(packets[k % n_packets]))) for k in sample.tolist()),
        default=0.0,
    )
    gaps = config.compare(cfg, data, [(np.asarray(p, np.float32), outs, d) for p, outs, d in kept])
    limits = ctx.limits
    checks = [("pose", pose_gap, limits["pose"]), ("copy", copy_gap, limits["copy"])]
    checks += [(name, gaps[name], limits[name]) for name in gaps]
    return {
        "setup_s": setup_s,
        "window_s": window_s,
        "units": len(latencies),
        "attempted": i,
        "failed": 0,
        "latencies_s": latencies,
        "spans": dict(rec.spans),
        "per_unit": config.per_unit(cfg, traffic["dtype"]),
        "dtype": traffic["dtype"],
        "memory_peak_bytes": memory_peak,
        "compared": {"frames": len(kept), "poses": len(sample)},
        "checks": checks,
    }
