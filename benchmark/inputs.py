"""Inputs that the benchmark makes from ``--seed``, on the device, in a few
large calls: the synthetic character and seeded weights.  Both sides of a
comparison are handed the same tensors."""

from __future__ import annotations

import math

import torch


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for the seed; ``stream`` separates draws."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (2**63))


def synthetic_character(size: int, seed: int, device) -> torch.Tensor:
    """(size, size, 4) f32 model units (premultiplied linear RGBA in
    [-1, 1]) of a seeded character: a soft-edged head-and-body silhouette
    of smooth colour gradients and blobs on a transparent background,
    quantised to 8 bits as a PNG would hold it.  All draws are one call."""
    gen = generator(seed, device, stream=1)
    r = torch.rand(12 + 6 * 6, generator=gen, device=device, dtype=torch.float64)
    ax = (torch.arange(size, device=device, dtype=torch.float64) + 0.5) / size
    y, x = torch.meshgrid(ax, ax, indexing="ij")
    head = ((x - 0.5) / 0.22) ** 2 + ((y - 0.3) / 0.2) ** 2
    body = ((x - 0.5) / 0.33) ** 2 + ((y - 0.85) / 0.35) ** 2
    alpha = ((1.0 - torch.minimum(head, body)) * 12.0).clamp(0.0, 1.0)
    channels = []
    for c in range(3):
        phase, freq = r[2 * c : 2 * c + 2] * 2 * math.pi, 1.0 + 2.0 * r[6 + 2 * c : 8 + 2 * c]
        channels.append(0.5 + 0.25 * torch.sin(2 * math.pi * freq[0] * x + phase[0]) * torch.cos(2 * math.pi * freq[1] * y + phase[1]))
    rgb = torch.stack(channels, dim=-1)
    for k in range(6):
        p = r[12 + 6 * k : 18 + 6 * k]
        cx, cy, radius = 0.3 + 0.4 * p[0], 0.15 + 0.75 * p[1], 0.02 + 0.04 * p[2]
        blob = torch.exp(-(((x - cx) ** 2 + (y - cy) ** 2) / (2.0 * radius**2)))
        rgb = rgb + blob[..., None] * (p[3:6] - rgb) * 0.8
    u8 = torch.round(torch.cat([rgb.clamp(0.0, 1.0), alpha[..., None]], dim=-1) * 255.0) / 255.0
    rgb, a = u8[..., :3], u8[..., 3:]
    linear = torch.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return (torch.cat([linear * a, a], dim=-1) * 2.0 - 1.0).float()


def uniform(seed: int, n: int, device, stream: int) -> torch.Tensor:
    """n f32 draws of U(-1, 1) in one call."""
    return torch.rand(n, generator=generator(seed, device, stream), device=device) * 2.0 - 1.0


def normal(seed: int, n: int, device, stream: int) -> torch.Tensor:
    """n f32 draws of N(0, 1) in one call."""
    return torch.randn(n, generator=generator(seed, device, stream), device=device)


def siren_weights(table, seed: int, device, omega: float, flow_scale: float = 1.0, stream: int = 2) -> dict:
    """{name: f32 tensor} of SIREN layers from a ``(name, (cout, cin), kind)``
    table, from one uniform and one normal draw: ``first`` U(+-1/cin),
    ``sine`` U(+-sqrt(6/cin)/omega), ``head`` and ``flow_head`` N(0, 2/cin)
    (a flow head's two grid-change rows, weights and biases, times
    ``flow_scale``), every bias U(+-1/sqrt(cin))."""
    u = uniform(seed, sum(co * ci + co for _, (co, ci), _ in table), device, stream)
    g = normal(seed, sum(co * ci for _, (co, ci), _ in table), device, stream + 1)
    weights, uo, go = {}, 0, 0
    for name, (co, ci), kind in table:
        w_bound = {"first": 1.0 / ci, "sine": math.sqrt(6.0 / ci) / omega}.get(kind)
        if w_bound is None:
            w = g[go : go + co * ci].view(co, ci) * math.sqrt(2.0 / ci)
        else:
            w = u[uo : uo + co * ci].view(co, ci) * w_bound
        b = u[uo + co * ci : uo + co * ci + co] / math.sqrt(ci)
        if kind == "flow_head":
            scale = torch.ones(co, device=device)
            scale[0:2] = flow_scale
            w, b = w * scale[:, None], b * scale
        weights[name], weights[name[:-6] + "bias"] = w.contiguous(), b.contiguous()
        uo, go = uo + co * ci + co, go + co * ci
    return weights
