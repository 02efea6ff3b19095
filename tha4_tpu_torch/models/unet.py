"""ADM-style conditional U-Net, the trunk of the body morpher and the
upscaler teachers (counterpart of the plain NHWC flow of
``tha4_tpu/models/unet.py``).

  * ResBlocks with two FiLM scale-shifts: the (vestigial, t = 0) time
    embedding, then the pose embedding; resampling inside the block
    (nearest-2x up / avg-pool-2x down on both paths); zero-init ``conv1``.
  * Spatial self-attention over the deepest level's tokens, in both qkv
    orders: q and k each scaled by ch^-1/4, softmax in f32, explicit
    matmuls (not SDPA, so the JAX arithmetic is kept); zero-init output
    projection.
  * The down path stores every block output as a skip; each up level
    consumes ``num_res_blocks_per_level + 1`` of them, last in first out.

Parameters carry the reference ``state_dict`` keys that
``tha4_tpu/convert/torch_weights.py:convert_unet`` reads (``time_embed.{1,3}``,
``cond_embed.{0,2}``, ``down_blocks.{i}.res_blocks.{j}.cond0_layers.1``,
``middle_blocks.{2i+1}.module``, ``up_blocks.{k}.resnet_blocks.{j}``,
``last.{0,2}``, ...).  Activations are NHWC; the convolutions see them as
channels-last NCHW (``ops.nn.conv_nhwc``), cuDNN's fast layout.

K6 (``ops.cuda_conv.fused_affine_conv3_nchw``) runs every 3x3 conv that
follows a group norm and its SiLU directly: each ResBlock's ``conv1``
(GN -> FiLM(t) -> FiLM(pose) -> SiLU -> conv1, plus the skip), the ``conv0``
of every ``"same"`` ResBlock (GN -> SiLU -> conv0) and ``last``.  The norm
and the FiLMs fold into one per-(n, c) scale and shift
(``fold_groupnorm_film``), so they, the SiLU, the bias and the residual add
cost no pass of their own; K6 rounds once, where the plain chain rounds
after each step.  The ``conv0`` of ``"up"`` / ``"down"`` blocks (the
resample sits between the SiLU and the conv), the first conv and the
attention's 1x1s stay cuDNN's.  A shipped upscaler call launches K6 55
times, a body morpher call 47 times.

Under an int8 scope (``ops.quant``: calibration or ``apply_scales``), and
only there, the ResBlocks and ``last`` take the JAX package's unfused order
instead, so that every eligible conv reaches the ``ops.nn.Conv2d`` hook in
the JAX teacher's order; K6 is not launched then.

The JAX module's lane-packed flow (``_apply_packed_flow``,
``_fused_resblock*``, the ``probe`` cut) is TPU 128-lane packing and is left
behind on purpose: channels-last is the GPU's form of the same layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tha4_tpu_torch.ops import cuda_conv, quant
from tha4_tpu_torch.ops import nn as tnn
from tha4_tpu_torch.ops import wide
from tha4_tpu_torch.ops.resize import downsample_avg_2x, upsample_nearest_2x


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: Optional[int] = 1
    num_head_channels: Optional[int] = None
    use_new_attention_order: bool = False

    def heads_for(self, channels: int) -> int:
        if self.num_head_channels is None:
            assert channels % self.num_heads == 0
            return self.num_heads
        assert channels % self.num_head_channels == 0
        return channels // self.num_head_channels


@dataclass(frozen=True)
class UnetConfig:
    in_channels: int = 3
    out_channels: int = 3
    model_channels: int = 64
    level_channel_multipliers: Tuple[int, ...] = (1, 2, 4, 8)
    level_use_attention: Tuple[bool, ...] = (False, False, False, False)
    num_res_blocks_per_level: int = 2
    num_middle_res_blocks: int = 2
    time_embedding_channels: Optional[int] = None
    cond_input_channels: int = 4
    cond_internal_channels: int = 512
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    dropout_prob: float = 0.1  # inert: the teachers run in eval mode
    condition_bias: float = 1.0

    @property
    def num_levels(self) -> int:
        return len(self.level_channel_multipliers)

    @property
    def t_emb_channels(self) -> int:
        return self.time_embedding_channels or self.model_channels


def compute_timestep_embedding(t: torch.Tensor, out_channels: int) -> torch.Tensor:
    """Sinusoidal embedding of t (N, 1), [cos || sin]."""
    half = out_channels // 2
    scale = -math.log(10000.0) / (half - 1)
    times = torch.exp(scale * torch.arange(0, half, dtype=t.dtype, device=t.device))[None, :] * t
    emb = torch.cat([torch.cos(times), torch.sin(times)], dim=1)
    if out_channels % 2 == 1:
        emb = F.pad(emb, (1, 1))
    return emb


def _w9(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv``'s 3x3 weight in K6's w9 layout and ``dtype``: the copy
    ``Unet.store_w9`` keeps for a frozen network, else made from the weight
    now (a weight that needs a gradient is passed on, for K6 to refuse)."""
    w9 = _stored(conv, "w9", dtype)
    return cuda_conv.to_w9(conv.weight.permute(2, 3, 1, 0), dtype) if w9 is None else w9


def _stored(module: nn.Module, name: str, dtype: torch.dtype):
    """The copy ``Unet.store_w9`` keeps under ``name`` if it is in ``dtype``."""
    t = getattr(module, name, None)
    return t if t is not None and t.dtype == dtype else None


def _fold(norm: tnn.GroupNorm, x: torch.Tensor, film=(), condition_bias: float = 1.0):
    """The group norm over NHWC ``x`` and the FiLMs after it as K6's per-(n, c)
    scale and shift."""
    return cuda_conv.fold_groupnorm_film(x.permute(0, 3, 1, 2), norm.num_groups, norm.weight, norm.bias, film,
                                         condition_bias)


def _affine_conv3(x: torch.Tensor, conv: nn.Conv2d, scale, shift, skip=None, skip_w=None, bias=None) -> torch.Tensor:
    """K6 on contiguous NHWC tensors (every U-Net activation is one):
    conv(silu(x * scale + shift)) + bias [+ skip]; ``bias`` f32, by default
    the conv's own."""
    if bias is None:
        bias = _stored(conv, "bias32", torch.float32)
        bias = wide(conv.bias) if bias is None else bias
    skip = None if skip is None else skip.permute(0, 3, 1, 2)
    out = cuda_conv.fused_affine_conv3_nchw(x.permute(0, 3, 1, 2), scale, shift, _w9(conv, x.dtype), bias, skip, skip_w,
                                            _stored(conv, "k6_layout", x.dtype))
    return out.permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    """GN -> SiLU -> [resample] -> conv0 -> GN -> FiLM(t) -> FiLM(pose) ->
    SiLU -> conv1, plus the [resampled, 1x1-projected] input.  K6 runs conv1
    with the skip, and conv0 where nothing is resampled."""

    def __init__(self, cin: int, cout: int, cond_channels: int, sampling: str = "same"):
        super().__init__()
        self.sampling = sampling
        self.norm0 = tnn.GroupNorm(cin)
        self.conv0 = tnn.conv3(cin, cout, bias=True)
        self.cond0_layers = nn.Sequential(nn.SiLU(), tnn.Linear(cond_channels, 2 * cout))
        self.norm1 = tnn.GroupNorm(cout)
        self.conv1 = tnn.conv3(cout, cout, bias=True)
        self.cond1_layers = nn.Sequential(nn.SiLU(), tnn.Linear(cond_channels, 2 * cout))
        self.skip = tnn.conv1(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor, cond0: torch.Tensor, cond1: torch.Tensor, condition_bias: float) -> torch.Tensor:
        resample = {"same": lambda a: a, "up": upsample_nearest_2x, "down": downsample_avg_2x}[self.sampling]
        if quant.current() is not None:
            return self._forward_unfused(resample, x, cond0, cond1, condition_bias)
        # A cuDNN conv's output (the first conv of an image that lies NCHW, an
        # up / down block's conv0) can be an NHWC view of NCHW memory; K6 and
        # its fold read NHWC memory.  Free where x already is NHWC.
        x = x.contiguous()
        if self.sampling == "same":
            h = _affine_conv3(x, self.conv0, *_fold(self.norm0, x))
        else:
            h = tnn.conv_nhwc(self.conv0, resample(F.silu(self.norm0(x)))).contiguous()
        film = (self.cond0_layers(cond0).chunk(2, dim=-1), self.cond1_layers(cond1).chunk(2, dim=-1))  # (scale, shift) each
        scale, shift = _fold(self.norm1, h, film, condition_bias)
        skip = resample(x)
        if self.skip is None:
            return _affine_conv3(h, self.conv1, scale, shift, skip)
        # The 1x1 skip's bias joins conv1's.
        skip_w = _stored(self, "skip_w", h.dtype)
        if skip_w is None:
            skip_w = self.skip.weight[:, :, 0, 0].to(h.dtype)
        bias = _stored(self, "skip_bias", torch.float32)
        if bias is None:
            bias = wide(self.conv1.bias) + wide(self.skip.bias)
        return _affine_conv3(h, self.conv1, scale, shift, skip, skip_w, bias)

    def _forward_unfused(self, resample, x, cond0, cond1, condition_bias: float) -> torch.Tensor:
        """The JAX package's unfused order (``tha4_tpu/models/unet.py:345-368``),
        which an int8 scope takes: its eligible convs (conv0, conv1, then the
        1x1 skip, each with its own bias) reach the ``ops.nn.Conv2d`` hook in
        the order the JAX teacher visits them, and none is fused into K6."""
        h = tnn.conv_nhwc(self.conv0, resample(F.silu(self.norm0(x))))
        h = self.norm1(h)
        for layers, cond in ((self.cond0_layers, cond0), (self.cond1_layers, cond1)):
            scale, shift = layers(cond).chunk(2, dim=-1)
            h = h * (condition_bias + scale[:, None, None, :]) + shift[:, None, None, :]
        h = tnn.conv_nhwc(self.conv1, F.silu(h))
        skip = resample(x)
        if self.skip is not None:
            skip = tnn.conv_nhwc(self.skip, skip)
        return skip + h


class AttentionBlock(nn.Module):
    """x + proj(attention(qkv(GN(x)))); the projection's key is ``conv``."""

    def __init__(self, channels: int, attention: AttentionConfig):
        super().__init__()
        self.attention = attention
        self.norm = tnn.GroupNorm(channels)
        self.qkv = tnn.conv1(channels, 3 * channels)
        self.conv = tnn.conv1(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, hh, ww, c = x.shape
        heads = self.attention.heads_for(c)
        ch = c // heads
        qkv = tnn.conv_nhwc(self.qkv, self.norm(x)).reshape(n, hh * ww, 3 * c)
        if self.attention.use_new_attention_order:
            q, k, v = (t.reshape(n, hh * ww, heads, ch) for t in qkv.chunk(3, dim=-1))
        else:  # per head (q, k, v) interleaved: (heads, 3, ch)
            qkv = qkv.reshape(n, hh * ww, heads, 3, ch)
            q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        weight = torch.einsum("nthc,nshc->nhts", q * scale, k * scale)
        weight = torch.softmax(wide(weight), dim=-1).to(x.dtype)
        out = torch.einsum("nhts,nshc->nthc", weight, v).reshape(n, hh, ww, c)
        return x + tnn.conv_nhwc(self.conv, out)


class _Wrapped(nn.Module):
    """A middle-block attention sits under ``.module`` in the reference."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module


class Unet(nn.Module):
    """x (N,S,S,Cin), t (N,1), cond (N,cond_input_channels) -> (N,S,S,Cout)."""

    def __init__(self, cfg: UnetConfig):
        super().__init__()
        self.cfg = cfg
        cond_ch = cfg.cond_internal_channels
        self.time_embed = nn.Sequential(nn.Identity(), tnn.Linear(cfg.t_emb_channels, cond_ch), nn.SiLU(), tnn.Linear(cond_ch, cond_ch))
        self.cond_embed = nn.Sequential(tnn.Linear(cfg.cond_input_channels, cond_ch), nn.SiLU(), tnn.Linear(cond_ch, cond_ch))
        self.first_conv = tnn.conv3(cfg.in_channels, cfg.model_channels, bias=True)

        current = cfg.model_channels
        channels = [current]
        self.down_blocks = nn.ModuleList()
        for i in range(cfg.num_levels):
            out_ch = cfg.model_channels * cfg.level_channel_multipliers[i]
            blk = nn.Module()
            blk.res_blocks = nn.ModuleList()
            for j in range(cfg.num_res_blocks_per_level):
                blk.res_blocks.append(ResBlock(current if j == 0 else out_ch, out_ch, cond_ch))
                channels.append(out_ch)
            if cfg.level_use_attention[i]:
                blk.attention_blocks = nn.ModuleList(AttentionBlock(out_ch, cfg.attention) for _ in blk.res_blocks)
            if i < cfg.num_levels - 1:
                blk.downsample = ResBlock(out_ch, out_ch, cond_ch, "down")
                channels.append(out_ch)
            self.down_blocks.append(blk)
            current = out_ch

        self.middle_blocks = nn.ModuleList()
        for _ in range(cfg.num_middle_res_blocks - 1):
            self.middle_blocks.append(ResBlock(current, current, cond_ch))
            self.middle_blocks.append(_Wrapped(AttentionBlock(current, cfg.attention)))
        self.middle_blocks.append(ResBlock(current, current, cond_ch))

        self.up_blocks = nn.ModuleList()
        for i in reversed(range(cfg.num_levels)):
            skip_channels = [channels.pop() for _ in range(cfg.num_res_blocks_per_level + 1)]
            out_ch = cfg.model_channels * cfg.level_channel_multipliers[i]
            blk = nn.Module()
            blk.resnet_blocks = nn.ModuleList(
                ResBlock((current if j == 0 else out_ch) + skip_channels[j], out_ch, cond_ch)
                for j in range(cfg.num_res_blocks_per_level + 1)
            )
            if cfg.level_use_attention[i]:
                blk.attention_blocks = nn.ModuleList(AttentionBlock(out_ch, cfg.attention) for _ in blk.resnet_blocks)
            if i > 0:
                blk.upsample = ResBlock(out_ch, out_ch, cond_ch, "up")
            self.up_blocks.append(blk)
            current = out_ch
        assert not channels
        self.last = nn.Sequential(tnn.GroupNorm(current), nn.SiLU(), tnn.conv3(current, cfg.out_channels, bias=True))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's init: torch-default ('none') convs and linears,
        unit norms, and zero weights and biases in every ResBlock's conv1,
        every attention projection and the last conv."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                tnn.init_linear_(m, gen)
            elif isinstance(m, nn.Conv2d):
                tnn.init_conv_(m, "none", gen)
            elif isinstance(m, tnn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in self.modules():
            if isinstance(m, ResBlock):
                tnn.init_conv_(m.conv1, "zero", gen)
            elif isinstance(m, AttentionBlock):
                tnn.init_conv_(m.conv, "zero", gen)
        tnn.init_conv_(self.last[2], "zero", gen)

    @torch.no_grad()
    def store_w9(self) -> None:
        """Keep what K6 reads beside each of its convs, on its device, as
        buffers outside the state dict, so that a call neither lays out nor
        casts anything: the weight in w9 layout in its dtype (``w9``) and
        the bias in f32 (``bias32``); on a ResBlock with a 1x1 skip, the
        skip's weight as a (Cout, Cs) matrix in its dtype (``skip_w``) and
        the two biases' f32 sum (``skip_bias``); and the weights as the
        kernel reads them (``k6_layout``: w9, and on conv1 of such a block
        skip_w too, in ``cuda_conv.device_weight_layout``).  For a frozen
        network only: a later change to a weight does not reach its copy."""
        convs = [(self.last[2], None)]
        for m in self.modules():
            if isinstance(m, ResBlock):
                skip_w = None
                if m.skip is not None:
                    skip_w = m.skip.weight[:, :, 0, 0].contiguous()
                    m.register_buffer("skip_w", skip_w, persistent=False)
                    m.register_buffer("skip_bias", (wide(m.conv1.bias) + wide(m.skip.bias)).float(), persistent=False)
                convs += [(m.conv1, skip_w)] + ([(m.conv0, None)] if m.sampling == "same" else [])
        for conv, skip_w in convs:
            w9 = cuda_conv.to_w9(conv.weight.permute(2, 3, 1, 0)).contiguous()
            block = cuda_conv.layout_block(w9.shape[0], w9.dtype)
            conv.register_buffer("w9", w9, persistent=False)
            conv.register_buffer("bias32", conv.bias.float().contiguous(), persistent=False)
            conv.register_buffer("k6_layout", cuda_conv.device_weight_layout(w9, skip_w, block, cuda_conv.CK, w9.dtype),
                                 persistent=False)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                first_conv_addition: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``first_conv_addition`` (N,S,S,model_channels) is added to the first
        conv's output (the reference's UnetWithFirstConvAddition)."""
        cfg = self.cfg
        t_emb = self.time_embed(compute_timestep_embedding(wide(t), cfg.t_emb_channels)).to(x.dtype)
        cond_emb = self.cond_embed(wide(cond)).to(x.dtype)
        cb = cfg.condition_bias

        h = tnn.conv_nhwc(self.first_conv, x)
        if first_conv_addition is not None:
            h = h + first_conv_addition
        hs: List[torch.Tensor] = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, rb in enumerate(blk.res_blocks):
                h = rb(h, t_emb, cond_emb, cb)
                if cfg.level_use_attention[i]:
                    h = blk.attention_blocks[j](h)
                hs.append(h)
            if hasattr(blk, "downsample"):
                h = blk.downsample(h, t_emb, cond_emb, cb)
                hs.append(h)

        for blk in self.middle_blocks:
            h = blk.module(h) if isinstance(blk, _Wrapped) else blk(h, t_emb, cond_emb, cb)

        for idx, blk in enumerate(self.up_blocks):
            i = cfg.num_levels - 1 - idx
            for j, rb in enumerate(blk.resnet_blocks):
                h = rb(torch.cat([h, hs.pop()], dim=-1), t_emb, cond_emb, cb)
                if cfg.level_use_attention[i]:
                    h = blk.attention_blocks[j](h)
            if hasattr(blk, "upsample"):
                h = blk.upsample(h, t_emb, cond_emb, cb)
        assert not hs

        norm, _, last_conv = self.last
        if quant.current() is not None:  # the unfused order, as the ResBlocks
            return tnn.conv_nhwc(last_conv, F.silu(norm(h)))
        h = h.contiguous()
        return _affine_conv3(h, last_conv, *_fold(norm, h))
