"""Weights as reference ``.pt`` state dicts
(counterpart of ``tha4_tpu/convert/export_torch.py``).

These functions are also the weight bridge from the JAX package: they take
its params as numpy arrays and return state dicts that the port's modules
load.  Students: ``{"w": (Cin, Cout), "b": (Cout,)}`` per layer, with
w.T -> (O, I, 1, 1).  The mode_12 teacher (``face_teacher_state_dicts``):
the inverse of ``tha4_tpu/convert/torch_weights.py:convert_eyebrow_decomposer``,
``convert_eyebrow_morphing_combiner`` and ``convert_face_morpher_08``: HWIO
conv weights -> OIHW; a transposed conv's forward-conv HWIO (over the
dilated input) -> torch's flipped (I, O, kh, kw); norm scale/bias ->
weight/bias.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _conv1x1(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).T)[:, :, None, None].copy())


def _vec(b) -> torch.Tensor:
    return torch.from_numpy(np.asarray(b, np.float32).copy())


def siren_face_morpher_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    sd = {}
    for i, layer in enumerate(params["siren"]["sine_layers"]):
        sd[f"siren.sine_layers.{i}.linear.weight"] = _conv1x1(layer["w"])
        sd[f"siren.sine_layers.{i}.linear.bias"] = _vec(layer["b"])
    sd["siren.last_linear.weight"] = _conv1x1(params["siren"]["last_linear"]["w"])
    sd["siren.last_linear.bias"] = _vec(params["siren"]["last_linear"]["b"])
    return sd


def siren_morpher_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    sd = {}
    for i, level in enumerate(params["levels"]):
        for j, layer in enumerate(level):
            sd[f"siren_layers.{i}.{j}.linear.weight"] = _conv1x1(layer["w"])
            sd[f"siren_layers.{i}.{j}.linear.bias"] = _vec(layer["b"])
    sd["last_linear.weight"] = _conv1x1(params["last_linear"]["w"])
    sd["last_linear.bias"] = _vec(params["last_linear"]["b"])
    return sd


def _conv(sd: Dict, prefix: str, p: Dict) -> None:
    sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))))
    if "b" in p:
        sd[prefix + ".bias"] = _vec(p["b"])


def _conv_transpose(sd: Dict, prefix: str, p: Dict) -> None:
    w = np.transpose(np.asarray(p["w"], np.float32), (2, 3, 0, 1))[:, :, ::-1, ::-1]
    sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(w))


def _norm(sd: Dict, prefix: str, p: Dict) -> None:
    sd[prefix + ".weight"] = _vec(p["scale"])
    sd[prefix + ".bias"] = _vec(p["bias"])


def _encoder_decoder(sd: Dict, prefix: str, p: Dict) -> None:
    for i, block in enumerate(p["downsample_blocks"]):
        _conv(sd, f"{prefix}downsample_blocks.{i}.0", block["conv"])
        _norm(sd, f"{prefix}downsample_blocks.{i}.1", block["norm"])
    for i, block in enumerate(p["bottleneck_blocks"]):
        if i == 0:
            _conv(sd, f"{prefix}bottleneck_blocks.0.0", block["conv"])
            _norm(sd, f"{prefix}bottleneck_blocks.0.1", block["norm"])
        else:
            path = f"{prefix}bottleneck_blocks.{i}.resnet_path"
            _conv(sd, f"{path}.0", block["conv0"])
            _norm(sd, f"{path}.1", block["norm0"])
            _conv(sd, f"{path}.3", block["conv1"])
            _norm(sd, f"{path}.4", block["norm1"])
    for i, block in enumerate(p["upsample_blocks"]):
        _conv_transpose(sd, f"{prefix}upsample_blocks.{i}.0", block["conv"])
        _norm(sd, f"{prefix}upsample_blocks.{i}.1", block["norm"])


def _teacher_net(p: Dict, prefix: str, heads: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """heads: name -> key prefix under the module (``name.0`` for a
    Sequential(conv, act) head, ``name`` for a bare conv)."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder_decoder(sd, prefix, p["body"])
    for name, key in heads.items():
        _conv(sd, key, p[name]["conv"])
    return sd


def face_teacher_state_dicts(params: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's mode_12 params (numpy arrays) -> the three state
    dicts of ``poser.modes.mode_12``, keyed by network name."""
    decomposer_heads = ["background_layer_alpha", "background_layer_color_change", "eyebrow_layer_alpha", "eyebrow_layer_color_change"]
    combiner_heads = ["morphed_eyebrow_layer_alpha", "morphed_eyebrow_layer_color_change", "combine_alpha"]
    face_heads = ["iris_mouth_color_change", "iris_mouth_alpha", "eye_color_change", "eye_alpha"]
    return {
        "eyebrow_decomposer": _teacher_net(
            params["eyebrow_decomposer"], "body.", {h: f"{h}.0" for h in decomposer_heads}
        ),
        "eyebrow_morphing_combiner": _teacher_net(
            params["eyebrow_morphing_combiner"], "body.",
            {"morphed_eyebrow_layer_grid_change": "morphed_eyebrow_layer_grid_change", **{h: f"{h}.0" for h in combiner_heads}},
        ),
        "face_morpher": _teacher_net(
            params["face_morpher"], "",
            {"iris_mouth_grid_change": "iris_mouth_grid_change", **{h: f"{h}.0" for h in face_heads}},
        ),
    }


def _linear(sd: Dict, prefix: str, p: Dict) -> None:
    sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["w"], np.float32).T))
    sd[prefix + ".bias"] = _vec(p["b"])


def _unet_resblock(sd: Dict, prefix: str, p: Dict) -> None:
    _norm(sd, prefix + ".norm0", p["norm0"])
    _conv(sd, prefix + ".conv0", p["conv0"])
    _linear(sd, prefix + ".cond0_layers.1", p["cond0"])
    _norm(sd, prefix + ".norm1", p["norm1"])
    _conv(sd, prefix + ".conv1", p["conv1"])
    _linear(sd, prefix + ".cond1_layers.1", p["cond1"])
    if "skip" in p:
        _conv(sd, prefix + ".skip", p["skip"])


def _attention_block(sd: Dict, prefix: str, p: Dict) -> None:
    _norm(sd, prefix + ".norm", p["norm"])
    _conv(sd, prefix + ".qkv", p["qkv"])
    _conv(sd, prefix + ".conv", p["proj"])


def unet_state_dict(p: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``models.unet`` params -> the port's ``models.unet.Unet`` keys
    (the reference's), under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, prefix + "time_embed.1", p["time_embed"][0])
    _linear(sd, prefix + "time_embed.3", p["time_embed"][1])
    _linear(sd, prefix + "cond_embed.0", p["cond_embed"][0])
    _linear(sd, prefix + "cond_embed.2", p["cond_embed"][1])
    _conv(sd, prefix + "first_conv", p["first_conv"])
    for i, blk in enumerate(p["down_blocks"]):
        for j, rb in enumerate(blk["res_blocks"]):
            _unet_resblock(sd, f"{prefix}down_blocks.{i}.res_blocks.{j}", rb)
        for j, ab in enumerate(blk.get("attention_blocks", [])):
            _attention_block(sd, f"{prefix}down_blocks.{i}.attention_blocks.{j}", ab)
        if "downsample" in blk:
            _unet_resblock(sd, f"{prefix}down_blocks.{i}.downsample", blk["downsample"])
    for i, blk in enumerate(p["middle_blocks"]):
        if "res" in blk:
            _unet_resblock(sd, f"{prefix}middle_blocks.{i}", blk["res"])
        else:
            _attention_block(sd, f"{prefix}middle_blocks.{i}.module", blk["attn"])
    for k, blk in enumerate(p["up_blocks"]):
        for j, rb in enumerate(blk["res_blocks"]):
            _unet_resblock(sd, f"{prefix}up_blocks.{k}.resnet_blocks.{j}", rb)
        for j, ab in enumerate(blk.get("attention_blocks", [])):
            _attention_block(sd, f"{prefix}up_blocks.{k}.attention_blocks.{j}", ab)
        if "upsample" in blk:
            _unet_resblock(sd, f"{prefix}up_blocks.{k}.upsample", blk["upsample"])
    _norm(sd, prefix + "last.0", p["last_norm"])
    _conv(sd, prefix + "last.2", p["last_conv"])
    return sd


def teacher_07_state_dicts(params: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's mode_07 params (numpy arrays) -> the five state
    dicts of ``poser.modes.mode_07``, keyed by network name."""
    upscaler = unet_state_dict(params["upscaler"]["body"], "body.")
    _conv(upscaler, "coarse_image_conv", params["upscaler"]["coarse_image_conv"])
    return {
        **face_teacher_state_dicts(params),
        "body_morpher": unet_state_dict(params["body_morpher"]["body"], "body."),
        "upscaler": upscaler,
    }


def save_module_pt(module: nn.Module, file_name: str) -> None:
    """Write a student module's state dict in the reference ``.pt`` format."""
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, file_name)


# ---------------------------------------------------------------------------
# The block zoo (ops.blocks, ops.separable, ops.norms_extra, ops.spectral_norm,
# models.resize_conv): the port's attribute names are the JAX param keys, so
# one walk over the JAX params, guided by the port module, converts each leaf
# family.
# ---------------------------------------------------------------------------


def zoo_conv_state(p: Dict, conv: nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX conv's ``w`` (HWIO; a transposed conv's: the forward conv over
    the 2x-dilated input), ``b`` and ``sn_u`` -> the port conv's ``weight``
    (OIHW; a transposed conv's torch (I, O / groups, kh, kw), flipped),
    ``bias`` and ``sn_u`` (unchanged: it indexes output channels)."""
    w = np.asarray(p["w"], np.float32)
    if getattr(conv, "transpose", False) or isinstance(conv, nn.ConvTranspose2d):
        kh, kw, cin_g, cout = w.shape
        groups = conv.groups
        wg = w.reshape(kh, kw, cin_g, groups, cout // groups).transpose(3, 2, 4, 0, 1)  # (g, I/g, O/g, kh, kw)
        w = wg.reshape(groups * cin_g, cout // groups, kh, kw)[:, :, ::-1, ::-1]
    else:
        w = w.transpose(3, 2, 0, 1)
    sd = {"weight": torch.from_numpy(np.array(w, order="C"))}
    if "b" in p:
        sd["bias"] = _vec(p["b"])
    if "sn_u" in p:
        sd["sn_u"] = _vec(p["sn_u"])
    return sd


_NORM_KEYS = {"scale": "weight", "bias": "bias", "running_mean": "running_mean", "running_var": "running_var"}


def zoo_norm_state(p: Dict) -> Dict[str, torch.Tensor]:
    """A JAX norm's params (instance/layer affine ``scale``/``bias``, Bias2d's
    ``bias``, batch norm's running statistics too) -> the port norm's."""
    return {_NORM_KEYS[k]: _vec(v) for k, v in p.items()}


def zoo_state_dict(module: nn.Module, params) -> Dict[str, torch.Tensor]:
    """JAX params of a block-zoo network (``ops.blocks`` builders,
    ``ops.separable``, ``models.resize_conv``, a norm), numpy arrays -> the
    state dict of the port ``module`` built with the same config."""
    from tha4_tpu_torch.ops import nn as tnn
    from tha4_tpu_torch.ops import norms_extra

    norms = (tnn.InstanceNorm2d, norms_extra.LayerNorm2d, norms_extra.Bias2d, norms_extra.BatchNorm2d)
    sd: Dict[str, torch.Tensor] = {}

    def visit(node, path: str) -> None:
        target = module.get_submodule(path[:-1])
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, f"{path}{i}.")
        elif "w" in node:
            sd.update({path + k: v for k, v in zoo_conv_state(node, target).items()})
        elif isinstance(target, norms):
            sd.update({path + k: v for k, v in zoo_norm_state(node).items()})
        else:
            for k, v in node.items():
                if isinstance(v, (dict, list, tuple)):
                    visit(v, f"{path}{k}.")
                else:
                    sd[path + k] = _vec(v)  # a bare leaf: the resnet block's learned scale

    visit(params, "")
    return sd
