"""Student weights as reference ``.pt`` state dicts
(counterpart of ``tha4_tpu/convert/export_torch.py``).

``siren_face_morpher_state_dict`` and ``siren_morpher_state_dict`` are also
the weight bridge from the JAX package: they take its student params as
numpy arrays (``{"w": (Cin, Cout), "b": (Cout,)}`` per layer) and return
state dicts that the port's modules load, with w.T -> (O, I, 1, 1) and b as
it is.
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


def save_module_pt(module: nn.Module, file_name: str) -> None:
    """Write a student module's state dict in the reference ``.pt`` format."""
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, file_name)
