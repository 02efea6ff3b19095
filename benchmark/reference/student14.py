"""The mode_14 student frame in plain PyTorch, from the published networks
(the reference's ``siren_face_morpher_00`` and ``siren_morpher_03``):

  face  = SIREN([pos_x, pos_y | pose[0:39]]): 41 -> 128 x 8 sine layers -> 4,
          a 128^2 RGBA crop, pasted at rows 80:208, cols 192:320;
  body  = three SIREN levels over [previous level upsampled | pos | pose],
          the last ending in a 7-channel head: grid change (2), alpha (1),
          colour (4); the pasted image warped by identity + grid change
          (bilinear, border, align_corners=False), then blended with the
          colour by alpha;
  frame = the blended image display-encoded: straight alpha, linear ->
          sRGB, rounded to uint8.

Sine layers are ``sin(omega * (W x + b))`` with ``torch.sin``; upsampling is
``F.interpolate(bilinear, align_corners=False)``; the warp is
``F.grid_sample``.  Every operation runs in the dtype of the weights it is
given (float64 for the reference, float32 with TF32 for the control).
Weights are the benchmark's own ``{name: tensor}`` dict (``weight_names``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

OMEGA = 30.0
FACE_Y0, FACE_X0 = 80, 192


def face_layers(cfg: dict) -> List[Tuple[int, int]]:
    """(cin, cout) of the face SIREN's sine layers and head."""
    f = cfg["face"]
    dims = [2 + f["pose_size"]] + [f["intermediate_channels"]] * f["num_sine_layers"]
    return list(zip(dims[:-1], dims[1:])) + [(f["intermediate_channels"], f["image_channels"])]


def body_layers(cfg: dict) -> List[List[Tuple[int, int]]]:
    """Per level, (cin, cout) of its sine layers; the last level's list ends
    with the head."""
    b = cfg["body"]
    levels = b["levels"]
    out = []
    for i, lv in enumerate(levels):
        c = lv["intermediate_channels"]
        cin = b["pose_size"] + 2 + (0 if i == 0 else c)
        cout = levels[i + 1]["intermediate_channels"] if i + 1 < len(levels) else c
        dims = [cin] + [c] * (lv["num_sine_layers"] - 1) + [cout]
        out.append(list(zip(dims[:-1], dims[1:])))
    out[-1].append((levels[-1]["intermediate_channels"], b["image_channels"] + 3))
    return out


def weight_names(cfg: dict) -> List[Tuple[str, Tuple[int, int], str]]:
    """(state-dict name, (cout, cin), init kind) of every weight matrix, in
    the order the benchmark draws them; each has a bias ``name[:-6] +
    'bias'``.  Names are the reference ``.pt`` keys (without the 1x1)
    under ``face.`` and ``body.``."""
    out = []
    face = face_layers(cfg)
    for i, (ci, co) in enumerate(face[:-1]):
        out.append((f"face.siren.sine_layers.{i}.linear.weight", (co, ci), "first" if i == 0 else "sine"))
    out.append(("face.siren.last_linear.weight", face[-1][::-1], "head"))
    return out + body_weight_names(cfg["body"])


def body_weight_names(b: dict) -> List[Tuple[str, Tuple[int, int], str]]:
    """``weight_names`` of the body student alone; its head is ``flow_head``."""
    out = []
    levels = body_layers({"body": b})
    for i, level in enumerate(levels):
        sines = level[:-1] if i == len(levels) - 1 else level
        for j, (ci, co) in enumerate(sines):
            out.append((f"body.siren_layers.{i}.{j}.linear.weight", (co, ci), "first" if i == j == 0 else "sine"))
    out.append(("body.last_linear.weight", levels[-1][-1][::-1], "flow_head"))
    return out


def _identity_grid(size: int, dtype, device) -> torch.Tensor:
    """(size, size, 2) normalised pixel centres, x first."""
    c = (2.0 * torch.arange(size, dtype=dtype, device=device) + 1.0) / size - 1.0
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _siren(w: Dict[str, torch.Tensor], names: Sequence[str], x: torch.Tensor, sines: int, op=None) -> torch.Tensor:
    """x (N, C, HW) through the named layers; the first ``sines`` take the
    sine; ``op`` rounds both operands of each product (the identity if None)."""
    op = op or (lambda t: t)
    for k, name in enumerate(names):
        x = torch.matmul(op(w[name]), op(x)) + w[name[:-6] + "bias"][:, None]
        if k < sines:
            x = torch.sin(OMEGA * x)
    return x


def _level_input(prev, size: int, pose: torch.Tensor) -> torch.Tensor:
    n = pose.shape[0]
    pos = _identity_grid(size, pose.dtype, pose.device).reshape(size * size, 2).T
    parts = [] if prev is None else [prev]
    parts += [pos[None].expand(n, 2, size * size), pose[:, :, None].expand(n, pose.shape[1], size * size)]
    return torch.cat(parts, dim=1)


def frame(cfg: dict, w: Dict[str, torch.Tensor], image: torch.Tensor, pose: torch.Tensor) -> Dict[str, torch.Tensor]:
    """image (N, S, S, 4) in model units and pose (N, 45), in the weights'
    dtype -> {face, blended, alpha, color_change, warped, grid_change}
    (NHWC) and ``display`` (N, S, S, 4) uint8."""
    f = cfg["face"]
    n = pose.shape[0]
    face_names = [name for name, _, _ in weight_names(cfg) if name.startswith("face.")]
    fs = f["image_size"]
    face = _siren(w, face_names, _level_input(None, fs, pose[:, : f["pose_size"]]), f["num_sine_layers"])
    face = face.reshape(n, f["image_channels"], fs, fs).permute(0, 2, 3, 1)
    body_in = image.clone()
    body_in[:, FACE_Y0 : FACE_Y0 + fs, FACE_X0 : FACE_X0 + fs, :] = face
    out = body(cfg["body"], w, body_in, pose)
    out["face"] = face
    out["display"] = display_u8(out["blended"])
    return out


def body(b: dict, w: Dict[str, torch.Tensor], image: torch.Tensor, pose: torch.Tensor, op=None) -> Dict[str, torch.Tensor]:
    """The body student (config ``b``, weights under ``body.``): image
    (N, S, S, 4) and pose (N, 45) -> {blended, alpha, color_change, warped,
    grid_change}, NHWC; differentiable in the weights and the grid (the
    warp's image is a constant to the student).  ``op`` as ``_siren``'s."""
    n = pose.shape[0]
    names = [name for name, _, _ in body_weight_names(b)]
    x = None
    levels = b["levels"]
    for i, lv in enumerate(levels):
        s = lv["image_size"]
        prev = None
        if i > 0:
            ps = levels[i - 1]["image_size"]
            prev = F.interpolate(x.reshape(n, -1, ps, ps), size=(s, s), mode="bilinear", align_corners=False)
            prev = prev.reshape(n, -1, s * s)
        level_names = [x_ for x_ in names if x_.startswith(f"body.siren_layers.{i}.")]
        if i == len(levels) - 1:
            level_names.append("body.last_linear.weight")
        x = _siren(w, level_names, _level_input(prev, s, pose), lv["num_sine_layers"], op)
    s = levels[-1]["image_size"]
    head = x.reshape(n, b["image_channels"] + 3, s, s).permute(0, 2, 3, 1)
    grid_change, alpha, color = head[..., 0:2], head[..., 2:3], head[..., 3:]
    grid = _identity_grid(s, head.dtype, head.device)[None] + grid_change
    warped = F.grid_sample(image.permute(0, 3, 1, 2).detach(), grid, mode="bilinear", padding_mode="border",
                           align_corners=False).permute(0, 2, 3, 1)
    blended = (1.0 - alpha) * warped + alpha * color
    return {"blended": blended, "alpha": alpha, "color_change": color, "warped": warped, "grid_change": grid_change}


def display_u8(image: torch.Tensor) -> torch.Tensor:
    """Model units (premultiplied linear RGBA in [-1, 1]) -> straight-alpha
    sRGB uint8."""
    x = (image + 1.0) / 2.0
    a = x[..., 3:4].clamp(0.0, 1.0)
    small = a.abs() < 1e-5
    rgb = torch.where(small, torch.zeros_like(x[..., 0:3]), x[..., 0:3] / torch.where(small, torch.ones_like(a), a))
    rgb = rgb.clamp(0.0, 1.0)
    rgb = torch.where(rgb <= 0.003130804953560372, rgb * 12.92, 1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return torch.round(torch.cat([rgb, a], dim=-1) * 255.0).to(torch.uint8)
