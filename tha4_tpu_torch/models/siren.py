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
forward and K4 backward over the module's live f32 parameters.  The body
student trains through ``siren_morpher_train_apply``, the channels-last
formulation of the JAX package's training path: GEMMs, the ``poly_sin``
kernels (K5) after every sine layer and the differentiable warp K3.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from tha4_tpu_torch.ops import cuda_siren, warp
from tha4_tpu_torch.ops.cuda_poly_sin import poly_sin
from tha4_tpu_torch.ops.cuda_siren import PackedChain
from tha4_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_nchw

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


def morpher_head(out_nhwc: torch.Tensor, image: torch.Tensor) -> List[torch.Tensor]:
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
    return morpher_head(out, image)


# ---------------------------------------------------------------------------
# The body student's training path (tha4_tpu/models/siren.py:73-110, 247-321)
# ---------------------------------------------------------------------------


def _rows(conv: nn.Conv2d) -> torch.Tensor:
    """The live f32 weight as a (Cin, Cout) matrix, the JAX layout."""
    return conv.weight[:, :, 0, 0].t()


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Operands rounded to x's dtype, exact f32 products and f32 sums: the
    JAX package's ``matmul(..., preferred_element_type=f32)``."""
    return torch.matmul(x.float(), w.to(x.dtype).float())


def _first_sine_linear_split(conv: nn.Conv2d, x: Optional[torch.Tensor], pose: torch.Tensor, size: int, mixed: bool) -> torch.Tensor:
    """A level's first sine layer without the [x | pos | pose] concat: the
    weight rows split that way, the position and pose terms are f32 products
    folded into the bias, and level 0 (no x) has no x product.  ``mixed``:
    everything up to the sine in f32, the output in the pose's dtype;
    otherwise the bias is rounded to that dtype, the x product is in it, and
    so is omega * pre, before the sine.  Parameters stored in bf16 are
    widened for the f32 terms, as the JAX package widens them."""
    dtype = pose.dtype
    w = _rows(conv).float()
    cx = 0 if x is None else x.shape[-1]
    pos_term = warp.identity_grid(size, size, pose.device) @ w[cx : cx + 2]
    pose_term = pose.float() @ w[cx + 2 :]
    bias_f32 = pos_term[None] + pose_term[:, None, None, :] + conv.bias.float()
    if mixed:
        pre = bias_f32 if x is None else _matmul_f32(x, w[:cx]) + bias_f32
        return poly_sin(OMEGA * pre, dtype)
    bias = bias_f32.to(dtype)
    pre = bias if x is None else torch.matmul(x, w[:cx].to(dtype)) + bias
    return poly_sin(OMEGA * pre)


def _sine_linear(conv: nn.Conv2d, x: torch.Tensor, mixed: bool) -> torch.Tensor:
    """sin(omega * (x @ w + b)) in x's dtype; ``mixed``: f32 up to the sine."""
    if mixed:
        return poly_sin(OMEGA * (_matmul_f32(x, _rows(conv)) + conv.bias), x.dtype)
    return poly_sin(OMEGA * (torch.matmul(x, _rows(conv).to(x.dtype)) + conv.bias.to(x.dtype)))


def _linear(conv: nn.Conv2d, x: torch.Tensor, mixed: bool) -> torch.Tensor:
    """The head: in x's dtype, or ``mixed``: f32 products, sums and output."""
    if mixed:
        return _matmul_f32(x, _rows(conv)) + conv.bias
    return torch.matmul(x, _rows(conv).to(x.dtype)) + conv.bias.to(x.dtype)


def siren_morpher_train_head(module: SirenMorpher, pose: torch.Tensor, dtype: torch.dtype, mixed: bool = False) -> torch.Tensor:
    """The body student's training forward up to its head: pose (N, P) ->
    the (N, S, S, C + 3) head output, differentiable in the module's live
    f32 parameters (cast inside).  Channels-last GEMMs, a torch-rule
    bilinear upsample between levels and ``poly_sin`` after every sine layer
    (9 launches forward, 9 backward for the shipped student).  ``mixed``:
    bf16 operands, f32 sums, sines and head (the JAX package's
    selective-f32 training)."""
    cfg = module.cfg
    pose = pose.to(dtype)
    x = None
    for i, (lv, level) in enumerate(zip(cfg.levels, module.siren_layers)):
        s = lv.image_size
        xr = None if i == 0 else resize_bilinear(x, (s, s))
        x = _first_sine_linear_split(level[0].linear, xr, pose, s, mixed)
        for layer in level[1:]:
            x = _sine_linear(layer.linear, x, mixed)
    return _linear(module.last_linear, x, mixed)


def siren_morpher_train_apply(
    module: SirenMorpher, image: torch.Tensor, pose: torch.Tensor, dtype: torch.dtype, mixed: bool = False
) -> List[torch.Tensor]:
    """The body student's training forward, the counterpart of
    ``siren_morpher_apply_nhwc``: image (N, S, S, C) and pose (N, P) in
    ``dtype`` -> the five outputs, the head's warp through K3."""
    return morpher_head(siren_morpher_train_head(module, pose, dtype, mixed), image)
