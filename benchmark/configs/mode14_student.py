"""mode14_student: the shipped character-model student, both sides.

``inputs`` makes the weights and the character from the seed on the
device; ``program`` builds the port's chain from them (the puppeteer's
converter, ``mode_14.StudentPoser`` and the display encode); ``control``
puts the plain reference in the program's place; ``reference`` and
``compare`` decide ``correct``; ``per_unit`` counts a frame's FLOPs and its
kernels' bounds.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch

from benchmark import counts, inputs as bench_inputs
from benchmark.reference import converter as ref_converter, student14

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def inputs(cfg: dict, seed: int, device) -> dict:
    """{weights: {name: f32 tensor}, image: (S, S, 4) f32}, from the seed."""
    weights = bench_inputs.siren_weights(student14.weight_names(cfg), seed, device, cfg["omega"], cfg["assumed"]["flow_scale"])
    return {"weights": weights, "image": bench_inputs.synthetic_character(cfg["body"]["image_size"], seed, device)}


def _modules(cfg: dict, weights: Dict[str, torch.Tensor]):
    from tha4_tpu_torch.models import siren

    f, b = cfg["face"], cfg["body"]
    face_cfg = siren.SirenFaceMorpherConfig(
        image_size=f["image_size"], image_channels=f["image_channels"], pose_size=f["pose_size"],
        siren=siren.SirenConfig(in_channels=2 + f["pose_size"], out_channels=f["image_channels"],
                                intermediate_channels=f["intermediate_channels"], num_sine_layers=f["num_sine_layers"],
                                omega0=cfg["omega"]))
    body_cfg = siren.SirenMorpherConfig(
        image_size=b["image_size"], image_channels=b["image_channels"], pose_size=b["pose_size"],
        levels=tuple(siren.SirenMorpherLevelConfig(lv["image_size"], lv["intermediate_channels"], lv["num_sine_layers"])
                     for lv in b["levels"]))
    face, body = siren.SirenFaceMorpher(face_cfg), siren.SirenMorpher(body_cfg)
    for prefix, module in (("face.", face), ("body.", body)):
        state = {k[len(prefix):]: (v[:, :, None, None] if v.dim() == 2 else v) for k, v in weights.items() if k.startswith(prefix)}
        module.load_state_dict(state)
    return face, body


def program(cfg: dict, data: dict, dtype: str, device) -> SimpleNamespace:
    """The puppeteer's chain from the port: ``IFacialMocapPoseConverter``
    (default calibration, breathing off), ``StudentPoser`` in ``dtype``, and
    ``imagecodec.encode_display_u8``; the image stays on the card."""
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter
    from tha4_tpu_torch.poser.modes import mode_14

    face, body = _modules(cfg, data["weights"])
    poser = mode_14.StudentPoser(face, body, compute_dtype=DTYPES[dtype], device=device)
    return SimpleNamespace(convert=IFacialMocapPoseConverter().convert, pose=poser.get_posing_outputs,
                           encode=imagecodec.encode_display_u8, image=data["image"])


def control(cfg: dict, data: dict, dtype: str, device) -> SimpleNamespace:
    """The plain reference in the program's place, one precision below the
    configuration's: f32 storage with TF32 products (for f32), the outputs
    in the program's order."""
    if dtype != "f32":
        raise ValueError(f"no control is defined for {dtype}")
    weights = data["weights"]

    def pose(image, pose_np):
        p = torch.as_tensor(pose_np, device=device)[None]
        before = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            out = student14.frame(cfg, weights, image[None], p)
        finally:
            torch.set_float32_matmul_precision(before)
        return [out[k] for k in OUTPUTS]

    return SimpleNamespace(convert=lambda m, now=None: ref_converter.convert(m), pose=pose,
                           encode=student14.display_u8, image=data["image"])


# The program's six outputs (mode_14.compute_outputs) by name, in order.
OUTPUTS = ("blended", "alpha", "color_change", "warped", "grid_change", "face")


def reference_pose(packet: dict) -> list:
    return ref_converter.convert(packet)


def compare(cfg: dict, data: dict, frames) -> Dict[str, float]:
    """The program's frames [(pose f32 numpy, outputs, display uint8)]
    against the float64 reference on the same pose: ``face`` and ``body``
    (the five body outputs), the widest gaps in model units; ``display``,
    the share in % of display bytes more than one level off.  (Where alpha
    is within rounding of zero, straight alpha divides by it: a byte there
    can be off by 255 in any run, so the display is judged by its share.)"""
    w64 = {k: v.double() for k, v in data["weights"].items()}
    image = data["image"].double()[None]
    gaps = {"face": 0.0, "body": 0.0, "display": 0.0}
    for pose, outs, display in frames:
        ref = student14.frame(cfg, w64, image, torch.as_tensor(pose, device=image.device).double()[None])
        for name, out in zip(OUTPUTS, outs):
            gap = float((out.double() - ref[name]).abs().max())
            key = "face" if name == "face" else "body"
            gaps[key] = max(gaps[key], gap)
        off = (display.to(torch.int16) - ref["display"][0].to(torch.int16)).abs() > 1
        gaps["display"] = max(gaps["display"], 100.0 * float(off.float().mean()))
    return gaps


def per_unit(cfg: dict, dtype: str) -> dict:
    """One frame's model FLOPs (the SIRENs' products; the upsamples and
    the warp are a few operations a pixel and not counted) and the bound of its four SIREN chains (K1): bytes
    read and written once, products at the dtype's peak, the sine epilogue
    on the CUDA cores."""
    f, b = cfg["face"], cfg["body"]
    width = counts.BYTES[dtype]
    levels = b["levels"]
    # (layers, pixels, previous level's channels, pose values, ends in a head)
    chains = [(student14.face_layers(cfg), f["image_size"] ** 2, 0, f["pose_size"], True)]
    for i, layers in enumerate(student14.body_layers(cfg)):
        cp = 0 if i == 0 else levels[i]["intermediate_channels"]
        chains.append((layers, levels[i]["image_size"] ** 2, cp, b["pose_size"], i == len(levels) - 1))
    macs = nbytes = sines = 0
    for layers, pixels, cp, pose_dim, head in chains:
        macs += counts.chain_macs(layers, pixels)
        params = sum(ci * co for ci, co in layers)
        nbytes += (cp + 2 + layers[-1][1]) * pixels * width + params * width + sum(co for _, co in layers) * 4 + pose_dim * 4
        sines += sum(co for _, co in (layers[:-1] if head else layers)) * pixels
    return {"flops": 2 * macs, "bounds_s": {"K1 sine_chain": counts.chain_bound_s(nbytes, macs, sines, dtype)}}
