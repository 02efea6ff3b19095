"""The mode_07 teacher (THA4's five networks) in plain PyTorch, NCHW, from
the published description (the reference's ``eyebrow_decomposer_00``,
``eyebrow_morphing_combiner_00``, ``face_morpher_08``, ``morpher_00`` and
``upscaler_02``, and ``poser/modes/mode_07.py``):

  decomposer(image[64:192, 192:320])                     -> eyebrow, background
  combiner(background, eyebrow, pose[0:12])               -> the eyebrows, morphed
  face morpher(image[32:224, 160:352] with them pasted, pose[12:39])
  face_morphed_full = the face pasted back into the 512^2 image
  body morpher U-Net(bilinear 256^2 of it, pose[39:45])
  upscaler U-Net(face_morphed_full, 512^2 of the body's image and grid change)

Weights are read by name from ``{network: {state-dict key: tensor}}``
through ``Weights``; with ``Weights(None)`` a forward on meta tensors lists
every name and shape instead (the benchmark draws the weights from that
table) and the U-Nets' GroupNorm [-> FiLM] -> SiLU -> 3x3 conv [+ skip]
sites as (n, cin, cout, h, w, skip channels, 1x1 skip projection).  Every
operation runs in the dtype of its input (float32 for the reference).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to e4m3's 448), back in ``t``'s dtype; the gradient passes
    straight through."""
    scale = t.detach().abs().max().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach()) if t.requires_grad else q


class Weights:
    """Named weights; without a state dict, a recorder of names and shapes.
    ``operand`` (the identity by default, ``fp8`` for the control) rounds
    both operands of every product: convolutions, linears, attention."""

    def __init__(self, params: Optional[Dict[str, Dict[str, torch.Tensor]]], operand=None):
        self.params = params
        self.op = operand or (lambda t: t)
        self.table: Dict[str, tuple] = {}
        self.k6_sites: List[tuple] = []

    def get(self, net: str, name: str, shape, dtype, device) -> torch.Tensor:
        if self.params is None:
            self.table[f"{net}.{name}"] = tuple(shape)
            return torch.empty(shape, dtype=dtype, device="meta")
        w = self.params[net][name]
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{net}.{name}: shape {tuple(w.shape)}, expected {tuple(shape)}")
        return w.to(dtype)


def _conv(W, net, name, x, cout, k, stride=1, pad=None, bias=True):
    pad = k // 2 if pad is None else pad
    w = W.get(net, name + ".weight", (cout, x.shape[1], k, k), x.dtype, x.device)
    b = W.get(net, name + ".bias", (cout,), x.dtype, x.device) if bias else None
    return F.conv2d(W.op(x), W.op(w), b, stride, pad)


def _inorm(W, net, name, x):
    c = x.shape[1]
    return F.instance_norm(x, weight=W.get(net, name + ".weight", (c,), x.dtype, x.device),
                           bias=W.get(net, name + ".bias", (c,), x.dtype, x.device), eps=1e-5)


def _gnorm(W, net, name, x):
    c = x.shape[1]
    return F.group_norm(x, min(32, c), W.get(net, name + ".weight", (c,), x.dtype, x.device),
                        W.get(net, name + ".bias", (c,), x.dtype, x.device), eps=1e-5)


def _linear(W, net, name, x, cout):
    w = W.get(net, name + ".weight", (cout, x.shape[1]), x.dtype, x.device)
    return W.op(x) @ W.op(w).t() + W.get(net, name + ".bias", (cout,), x.dtype, x.device)


def identity_grid(size: int, dtype, device) -> torch.Tensor:
    c = (2.0 * torch.arange(size, dtype=dtype, device=device) + 1.0) / size - 1.0
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def warp(image: torch.Tensor, grid_change: torch.Tensor) -> torch.Tensor:
    """NCHW image at identity + grid change ((N, 2, H, W), x first): bilinear, border."""
    grid = identity_grid(image.shape[-1], grid_change.dtype, grid_change.device)[None] + grid_change.permute(0, 2, 3, 1)
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="border", align_corners=False)


def color_change(alpha, color, image):
    return color * alpha + image * (1.0 - alpha)


def rgb_change(alpha, color, image):
    return torch.cat([color[:, 0:3] * alpha + image[:, 0:3] * (1.0 - alpha), image[:, 3:4]], dim=1)


# -- the encoder-decoder trunk and its heads ---------------------------------


def encoder_decoder(W, net, prefix, cfg: dict, x, pose=None):
    def block(name, h, cout, kind):
        if kind == "conv":
            h = _conv(W, net, name + ".0", h, cout, 3, bias=False)
        elif kind == "down":
            h = _conv(W, net, name + ".0", h, cout, 4, stride=2, pad=1, bias=False)
        else:
            w = W.get(net, name + ".0.weight", (h.shape[1], cout, 4, 4), h.dtype, h.device)
            h = F.conv_transpose2d(W.op(h), W.op(w), None, 2, 1)
        return F.relu(_inorm(W, net, name + ".1", h))

    def channels(size):
        return min(cfg["start_channels"] * (cfg["image_size"] // size), cfg["max_channels"])

    size, ch = cfg["image_size"], cfg["start_channels"]
    x = block(prefix + "downsample_blocks.0", x, ch, "conv")
    k = 1
    while size > cfg["bottleneck_image_size"]:
        size //= 2
        ch = channels(size)
        x = block(f"{prefix}downsample_blocks.{k}", x, ch, "down")
        k += 1
    if pose is not None:
        n, _, h, w = x.shape
        x = torch.cat([x, pose[:, :, None, None].expand(n, pose.shape[1], h, w)], dim=1)
    x = block(prefix + "bottleneck_blocks.0", x, ch, "conv")
    for j in range(1, cfg["num_bottleneck_blocks"]):
        p = f"{prefix}bottleneck_blocks.{j}.resnet_path"
        h = F.relu(_inorm(W, net, p + ".1", _conv(W, net, p + ".0", x, ch, 3, bias=False)))
        x = x + _inorm(W, net, p + ".4", _conv(W, net, p + ".3", h, ch, 3, bias=False))
    k = 0
    while size < cfg["image_size"]:
        size *= 2
        ch = channels(size)
        x = block(f"{prefix}upsample_blocks.{k}", x, ch, "up")
        k += 1
    return x


def _head(W, net, name, feature, cout, act):
    return act(_conv(W, net, name + ".0", feature, cout, 3))


def eyebrow_decomposer(W, cfg, image):
    net = "eyebrow_decomposer"
    f = encoder_decoder(W, net, "body.", cfg, image)
    c = image.shape[1]
    bg_alpha = _head(W, net, "background_layer_alpha", f, 1, torch.sigmoid)
    bg_color = _head(W, net, "background_layer_color_change", f, c, torch.tanh)
    eb_alpha = _head(W, net, "eyebrow_layer_alpha", f, 1, torch.sigmoid)
    eb_color = _head(W, net, "eyebrow_layer_color_change", f, c, torch.tanh)
    # The eyebrow layer lerps from its colour change towards the image.
    return [color_change(eb_alpha, image, eb_color), eb_alpha, eb_color, color_change(bg_alpha, bg_color, image), bg_alpha, bg_color]


def eyebrow_combiner(W, cfg, background, eyebrow, pose):
    net = "eyebrow_morphing_combiner"
    f = encoder_decoder(W, net, "body.", cfg, torch.cat([background, eyebrow], dim=1), pose)
    c = eyebrow.shape[1]
    grid_change = _conv(W, net, "morphed_eyebrow_layer_grid_change", f, 2, 3, bias=False)
    alpha = _head(W, net, "morphed_eyebrow_layer_alpha", f, 1, torch.sigmoid)
    color = _head(W, net, "morphed_eyebrow_layer_color_change", f, c, torch.tanh)
    warped = warp(eyebrow, grid_change)
    morphed = color_change(alpha, color, warped)
    combine_alpha = _head(W, net, "combine_alpha", f, 1, torch.sigmoid)
    return [rgb_change(combine_alpha, morphed, background), combine_alpha,
            rgb_change((morphed[:, 3:4] + 1.0) / 2.0, morphed, background), morphed, alpha, color, warped, grid_change]


def face_morpher(W, cfg, image, pose):
    net = "face_morpher"
    f = encoder_decoder(W, net, "", cfg, image, pose)
    c = image.shape[1]
    grid_change = _conv(W, net, "iris_mouth_grid_change", f, 2, 3, bias=False)
    image_0 = warp(image, grid_change)
    im_color = _head(W, net, "iris_mouth_color_change", f, c, torch.tanh)
    im_alpha = _head(W, net, "iris_mouth_alpha", f, 1, torch.sigmoid)
    image_1 = color_change(im_alpha, im_color, image_0)
    eye_color = _head(W, net, "eye_color_change", f, c, torch.tanh)
    eye_alpha = _head(W, net, "eye_alpha", f, 1, torch.sigmoid)
    return [color_change(eye_alpha, eye_color, image_1), eye_alpha, eye_color, image_1, im_alpha, im_color, image_0, grid_change]


# -- the conditional U-Net ----------------------------------------------------


def _resblock(W, net, p, x, cout, t_emb, cond_emb, sampling, cb):
    h = F.silu(_gnorm(W, net, p + ".norm0", x))
    resample = {"same": lambda a: a, "up": lambda a: F.interpolate(a, scale_factor=2, mode="nearest"),
                "down": lambda a: F.avg_pool2d(a, 2)}[sampling]
    h = _conv(W, net, p + ".conv0", resample(h), cout, 3)
    if sampling == "same":
        W.k6_sites.append((x.shape[0], x.shape[1], cout, x.shape[2], x.shape[3], 0, False))
    h = _gnorm(W, net, p + ".norm1", h)
    for layers, c in ((p + ".cond0_layers.1", t_emb), (p + ".cond1_layers.1", cond_emb)):
        scale, shift = _linear(W, net, layers, F.silu(c), 2 * cout).chunk(2, dim=1)
        h = h * (cb + scale[:, :, None, None]) + shift[:, :, None, None]
    skip = resample(x)
    W.k6_sites.append((h.shape[0], cout, cout, h.shape[2], h.shape[3], skip.shape[1], x.shape[1] != cout))
    h = _conv(W, net, p + ".conv1", F.silu(h), cout, 3)
    if x.shape[1] != cout:
        skip = _conv(W, net, p + ".skip", skip, cout, 1)
    return skip + h


def _attention(W, net, p, x, heads):
    n, c, hh, ww = x.shape
    ch = c // heads
    qkv = _conv(W, net, p + ".qkv", _gnorm(W, net, p + ".norm", x), 3 * c, 1)
    q, k, v = (t.reshape(n, heads, ch, hh * ww) for t in qkv.chunk(3, dim=1))
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    weight = torch.softmax(torch.einsum("nhct,nhcs->nhts", W.op(q * scale), W.op(k * scale)), dim=-1)
    out = torch.einsum("nhts,nhcs->nhct", W.op(weight), W.op(v)).reshape(n, c, hh, ww)
    return x + _conv(W, net, p + ".conv", out, c, 1)


def unet(W, net, prefix, cfg: dict, x, cond, first_conv_addition=None):
    """The shipped conditional U-Net (t = 0, heads by count, the new qkv order)."""
    n = x.shape[0]
    mc, mults, att = cfg["model_channels"], cfg["level_channel_multipliers"], cfg["level_use_attention"]
    cond_ch, heads, cb = cfg["cond_internal_channels"], cfg["attention_heads"], 1.0
    half = mc // 2
    freqs = torch.exp(-math.log(10000.0) / (half - 1) * torch.arange(half, dtype=x.dtype, device=x.device))
    t_in = torch.cat([torch.cos(freqs * 0.0), torch.sin(freqs * 0.0)])[None].expand(n, mc)
    t_emb = _linear(W, net, prefix + "time_embed.3", F.silu(_linear(W, net, prefix + "time_embed.1", t_in, cond_ch)), cond_ch)
    cond_emb = _linear(W, net, prefix + "cond_embed.2", F.silu(_linear(W, net, prefix + "cond_embed.0", cond, cond_ch)), cond_ch)
    h = _conv(W, net, prefix + "first_conv", x, mc, 3)
    if first_conv_addition is not None:
        h = h + first_conv_addition
    hs = [h]
    levels = len(mults)
    for i in range(levels):
        out_ch = mc * mults[i]
        for j in range(cfg["num_res_blocks_per_level"]):
            h = _resblock(W, net, f"{prefix}down_blocks.{i}.res_blocks.{j}", h, out_ch, t_emb, cond_emb, "same", cb)
            if att[i]:
                h = _attention(W, net, f"{prefix}down_blocks.{i}.attention_blocks.{j}", h, heads)
            hs.append(h)
        if i < levels - 1:
            h = _resblock(W, net, f"{prefix}down_blocks.{i}.downsample", h, out_ch, t_emb, cond_emb, "down", cb)
            hs.append(h)
    current = h.shape[1]
    for k in range(cfg["num_middle_res_blocks"] - 1):
        h = _resblock(W, net, f"{prefix}middle_blocks.{2 * k}", h, current, t_emb, cond_emb, "same", cb)
        h = _attention(W, net, f"{prefix}middle_blocks.{2 * k + 1}.module", h, heads)
    h = _resblock(W, net, f"{prefix}middle_blocks.{2 * (cfg['num_middle_res_blocks'] - 1)}", h, current, t_emb, cond_emb, "same", cb)
    for idx, i in enumerate(reversed(range(levels))):
        out_ch = mc * mults[i]
        for j in range(cfg["num_res_blocks_per_level"] + 1):
            h = _resblock(W, net, f"{prefix}up_blocks.{idx}.resnet_blocks.{j}", torch.cat([h, hs.pop()], dim=1), out_ch,
                          t_emb, cond_emb, "same", cb)
            if att[i]:
                h = _attention(W, net, f"{prefix}up_blocks.{idx}.attention_blocks.{j}", h, heads)
        if i > 0:
            h = _resblock(W, net, f"{prefix}up_blocks.{idx}.upsample", h, out_ch, t_emb, cond_emb, "up", cb)
    W.k6_sites.append((n, h.shape[1], cfg["out_channels"], h.shape[2], h.shape[3], 0, False))
    return _conv(W, net, prefix + "last.2", F.silu(_gnorm(W, net, prefix + "last.0", h)), cfg["out_channels"], 3)


def _direct_grid_alpha(out, image):
    c = image.shape[1]
    direct, grid_change, alpha = out[:, :c], out[:, c : c + 2], torch.sigmoid(out[:, c + 2 : c + 3])
    warped = warp(image, grid_change)
    return [color_change(alpha, direct, warped), alpha, warped, grid_change, direct]


def body_morpher(W, cfg, image, pose):
    return _direct_grid_alpha(unet(W, "body_morpher", "body.", cfg, image, pose), image)


def upscaler(W, cfg, rest, coarse_posed, coarse_grid, pose):
    feature = torch.cat([coarse_posed, warp(rest, coarse_grid), coarse_grid], dim=1)
    addition = _conv(W, "upscaler", "coarse_image_conv", feature, cfg["model_channels"], 3)
    return _direct_grid_alpha(unet(W, "upscaler", "body.", cfg, rest, pose, addition), rest)


def _resize(x, size):
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)


# The networks in the order they run; "face" ends in face_morphed_full, the
# face pasted back into the image.
STAGES = ("decomposer", "combiner", "face", "body", "upscaler")


def stages(W: Weights, cfg: dict, image: torch.Tensor, pose: torch.Tensor, given: Optional[dict] = None) -> dict:
    """image (N, 4, 512, 512), pose (N, 45) -> {stage: its outputs, NCHW}.
    With ``given`` (another run's outputs, keyed alike), each network takes
    its inputs from ``given``'s outputs of the networks before it instead of
    its own, so that each is held alone."""
    out = {}

    def upstream(stage):
        return (given or out)[stage]

    out["decomposer"] = eyebrow_decomposer(W, cfg["eyebrow_decomposer"], image[:, :, 64:192, 192:320])
    decomposed = upstream("decomposer")
    out["combiner"] = eyebrow_combiner(W, cfg["eyebrow_morphing_combiner"], decomposed[3], decomposed[0], pose[:, :12])
    face_in = image[:, :, 32:224, 160:352].clone()
    face_in[:, :, 32:160, 32:160] = upstream("combiner")[2]
    face = face_morpher(W, cfg["face_morpher"], face_in, pose[:, 12:39])
    full = image.clone()
    full[:, :, 32:224, 160:352] = face[0]
    out["face"] = face + [full]
    full = upstream("face")[-1]
    rotation = pose[:, 39:45]
    out["body"] = body_morpher(W, cfg["body_morpher"], _resize(full, 256), rotation)
    body = upstream("body")
    out["upscaler"] = upscaler(W, cfg["upscaler"], full, _resize(body[0], 512), _resize(body[3], 512), rotation)
    return out


def labels_of(out: dict) -> List[torch.Tensor]:
    """The body student's four labels among ``stages``' outputs: the
    upscaler's posed image, its warped image and grid change, and
    face_morphed_full."""
    return [out["upscaler"][0], out["upscaler"][2], out["upscaler"][3], out["face"][-1]]


def labels(W: Weights, cfg: dict, image: torch.Tensor, pose: torch.Tensor) -> List[torch.Tensor]:
    """image (N, 4, 512, 512), pose (N, 45) -> the four labels, NCHW."""
    return labels_of(stages(W, cfg, image, pose))
