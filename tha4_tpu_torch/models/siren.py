"""SIREN student networks (counterpart of ``tha4_tpu/models/siren.py``).

Two students:
  * ``SirenFaceMorpher`` — pose -> 128x128 RGBA face crop;
  * ``SirenMorpher`` — three coarse-to-fine levels over the 512^2 character,
    ending in a head whose grid change warps the image and whose alpha and
    colour are blended over the warp.

The modules hold parameters only, with the reference ``.pt`` state-dict
layout (``siren.sine_layers.{i}.linear.weight`` (O, I, 1, 1) for the face,
``siren_layers.{i}.{j}.linear.*`` and ``last_linear.*`` for the body), so a
shipped or JAX-exported character model loads with ``load_state_dict``.
The forward runs through ``pack`` (once per dtype and device) and the
``*_apply`` functions, one K1 launch per level and one K2 launch per frame.
The face student trains through ``siren_face_morpher_train_apply``: K1
forward and K4 backward over the module's live f32 parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from tha4_tpu_torch.ops import cuda_siren, warp
from tha4_tpu_torch.ops.cuda_siren import PackedChain
from tha4_tpu_torch.ops.resize import resize_bilinear_nchw

OMEGA = 30.0


@dataclass(frozen=True)
class SirenConfig:
    in_channels: int
    out_channels: int
    intermediate_channels: int
    num_sine_layers: int
    use_tanh: bool = False
    omega0: float = OMEGA


@dataclass(frozen=True)
class SirenFaceMorpherConfig:
    image_size: int = 128
    image_channels: int = 4
    pose_size: int = 39
    siren: SirenConfig = field(
        default_factory=lambda: SirenConfig(
            in_channels=41, out_channels=4, intermediate_channels=128, num_sine_layers=8
        )
    )


@dataclass(frozen=True)
class SirenMorpherLevelConfig:
    image_size: int
    intermediate_channels: int
    num_sine_layers: int


@dataclass(frozen=True)
class SirenMorpherConfig:
    image_size: int = 512
    image_channels: int = 4
    pose_size: int = 45
    levels: Tuple[SirenMorpherLevelConfig, ...] = (
        SirenMorpherLevelConfig(128, 360, 3),
        SirenMorpherLevelConfig(256, 180, 3),
        SirenMorpherLevelConfig(512, 90, 3),
    )


# Output list indices (reference: siren_morpher_03.py:141-145)
SIREN_MORPHER_INDEX_BLENDED_IMAGE = 0
SIREN_MORPHER_INDEX_ALPHA = 1
SIREN_MORPHER_INDEX_COLOR_CHANGE = 2
SIREN_MORPHER_INDEX_WARPED_IMAGE = 3
SIREN_MORPHER_INDEX_GRID_CHANGE = 4
SIREN_MORPHER_OUTPUT_LENGTH = 5


def _conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel_size=1)


class SineLinear(nn.Module):
    """A 1x1 conv followed by sin(omega * x); holds ``linear.{weight,bias}``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = _conv1x1(cin, cout)


@torch.no_grad()
def _init_sine(conv: nn.Conv2d, is_first: bool, omega0: float, gen: torch.Generator) -> None:
    """SIREN init: first layer U(+-1/cin), later U(+-sqrt(6/cin)/omega0);
    bias U(+-1/sqrt(cin)) (torch Conv2d default)."""
    cin = conv.in_channels
    bound = 1.0 / cin if is_first else math.sqrt(6.0 / cin) / omega0
    conv.weight.uniform_(-bound, bound, generator=gen)
    b_bound = 1.0 / math.sqrt(cin)
    conv.bias.uniform_(-b_bound, b_bound, generator=gen)


@torch.no_grad()
def _init_he(conv: nn.Conv2d, gen: torch.Generator) -> None:
    """He init for the head: N(0, 2/cin); bias U(+-1/sqrt(cin))."""
    cin = conv.in_channels
    conv.weight.normal_(0.0, math.sqrt(2.0 / cin), generator=gen)
    b_bound = 1.0 / math.sqrt(cin)
    conv.bias.uniform_(-b_bound, b_bound, generator=gen)


def _matrix(conv: nn.Conv2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The squeezed (Co, Ci) weight, which is K1's layout, and the bias."""
    return conv.weight.detach()[:, :, 0, 0], conv.bias.detach()


class Siren(nn.Module):
    def __init__(self, cfg: SirenConfig):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.in_channels] + [cfg.intermediate_channels] * cfg.num_sine_layers
        self.sine_layers = nn.ModuleList(SineLinear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.last_linear = _conv1x1(cfg.intermediate_channels, cfg.out_channels)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for i, layer in enumerate(self.sine_layers):
            _init_sine(layer.linear, i == 0, self.cfg.omega0, gen)
        _init_he(self.last_linear, gen)


class SirenFaceMorpher(nn.Module):
    """pose (N, 39) -> (N, 128, 128, 4) RGBA face crop."""

    def __init__(self, cfg: Optional[SirenFaceMorpherConfig] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg or SirenFaceMorpherConfig()
        self.siren = Siren(self.cfg.siren)
        self.siren.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))

    def pack(self, dtype: torch.dtype, device=None) -> PackedChain:
        layers = [_matrix(l.linear) for l in self.siren.sine_layers]
        return cuda_siren.pack_chain(layers, _matrix(self.siren.last_linear), dtype, device)


class SirenMorpher(nn.Module):
    """(N, 512, 512, 4) image + (N, 45) pose -> the five body outputs."""

    def __init__(self, cfg: Optional[SirenMorpherConfig] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg = cfg or SirenMorpherConfig()
        levels = []
        for i, lv in enumerate(cfg.levels):
            c = lv.intermediate_channels
            cin = cfg.pose_size + 2 + (0 if i == 0 else c)
            cout = cfg.levels[i + 1].intermediate_channels if i < len(cfg.levels) - 1 else c
            dims = [cin] + [c] * (lv.num_sine_layers - 1) + [cout]
            levels.append(nn.ModuleList(SineLinear(a, b) for a, b in zip(dims[:-1], dims[1:])))
        self.siren_layers = nn.ModuleList(levels)
        self.last_linear = _conv1x1(cfg.levels[-1].intermediate_channels, cfg.image_channels + 3)
        self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Only level 0's first layer takes the first-layer bound."""
        for i, level in enumerate(self.siren_layers):
            for j, layer in enumerate(level):
                _init_sine(layer.linear, i == 0 and j == 0, OMEGA, gen)
        _init_he(self.last_linear, gen)

    def pack(self, dtype: torch.dtype, device=None) -> List[PackedChain]:
        """One chain per level; the last level carries the head."""
        chains = []
        for i, level in enumerate(self.siren_layers):
            head = _matrix(self.last_linear) if i == len(self.siren_layers) - 1 else None
            chains.append(cuda_siren.pack_chain([_matrix(l.linear) for l in level], head, dtype, device))
        return chains


def pos_t(size: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(2, size*size) identity-grid positions in the compute dtype."""
    return warp.identity_grid(size, size, device).reshape(size * size, 2).T.to(dtype).contiguous()


def siren_face_morpher_apply(cfg: SirenFaceMorpherConfig, chain: PackedChain, pose: torch.Tensor) -> torch.Tensor:
    """pose (N, pose_size) -> (N, S, S, C) crop in the compute dtype."""
    n, s = pose.shape[0], cfg.image_size
    out = cuda_siren.sine_chain_t(None, pos_t(s, chain.dtype, pose.device), pose.float().contiguous(), chain, cfg.siren.omega0)
    out = out.reshape(n, cfg.image_channels, s, s).permute(0, 2, 3, 1)
    return torch.tanh(out) if cfg.siren.use_tanh else out


def siren_face_morpher_train_apply(
    module: SirenFaceMorpher, pose: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """The training path of ``siren_face_morpher_apply``: differentiable in
    the module's live f32 parameters (K1 forward, K4 backward).  pose
    (N, pose_size) f32 -> (N, S, S, C) in ``dtype``."""
    cfg = module.cfg
    n, s = pose.shape[0], cfg.image_size
    mats = [(c.weight[:, :, 0, 0], c.bias) for c in [l.linear for l in module.siren.sine_layers] + [module.siren.last_linear]]
    out = cuda_siren.sine_chain_t_train(
        None, pos_t(s, dtype, pose.device), pose.float().contiguous(), mats[:-1], mats[-1], dtype, cfg.siren.omega0
    )
    out = out.reshape(n, cfg.image_channels, s, s).permute(0, 2, 3, 1)
    return torch.tanh(out) if cfg.siren.use_tanh else out


def _morpher_head(out_nhwc: torch.Tensor, image: torch.Tensor) -> List[torch.Tensor]:
    """Slice grid change / alpha / colour from the head, warp, alpha-blend;
    ordered per SIREN_MORPHER_INDEX_*."""
    grid_change = out_nhwc[..., 0:2]
    alpha = out_nhwc[..., 2:3]
    color_change = out_nhwc[..., 3:]
    warped = warp.apply_grid_change(grid_change, image)
    blended = (1.0 - alpha) * warped + alpha * color_change
    return [blended, alpha, color_change, warped, grid_change]


def siren_morpher_apply(
    cfg: SirenMorpherConfig, chains: Sequence[PackedChain], image: torch.Tensor, pose: torch.Tensor
) -> List[torch.Tensor]:
    """image (N, S, S, C) + pose (N, P) -> the five body outputs.

    Channels-first (N, C, HW) between levels, with a torch-rule bilinear
    upsample in between; one K1 launch per level."""
    n = pose.shape[0]
    pose32 = pose.float().contiguous()
    x = None
    for i, (lv, chain) in enumerate(zip(cfg.levels, chains)):
        s = lv.image_size
        prev = None
        if i > 0:
            prev_s = cfg.levels[i - 1].image_size
            ch = x.shape[1]
            prev = resize_bilinear_nchw(x.reshape(n, ch, prev_s, prev_s), (s, s)).reshape(n, ch, s * s)
        x = cuda_siren.sine_chain_t(prev, pos_t(s, chain.dtype, pose.device), pose32, chain, OMEGA)
    s = cfg.levels[-1].image_size
    out = x.reshape(n, cfg.image_channels + 3, s, s).permute(0, 2, 3, 1)
    return _morpher_head(out, image)
