"""Q1: the int8 teacher's convolution (counterpart of
``tha4_tpu/ops/quant.py:conv2d_int8``, which JAX leaves to XLA's
``lax.conv_general_dilated`` on int8 operands: no ``pallas_call``).

``int8_conv(x, layout, w_scale, x_scale, padding, bias)`` takes NHWC ``x``
(f32 or bf16, any strides; it is made contiguous, which is free where the
activation lies channels-last), the int8 weight in Q1's device layout
(``weight_layout``, an ``Int8Layout``: the padded tensor and the channel
counts it holds), the per-Cout f32 weight scale and the static activation
scale, and returns NHWC in x's dtype:

    xq  = clip(round_half_even(x.f32 * f32(1 / x_scale)), -127, 127)
    acc = conv(xq, w8)                       (int32, exact)
    out = T(acc.f32 * (f32(x_scale) * w_scale)) [+ T(bias)]   (T = x's dtype)

For a CUDA tensor it launches ``csrc/int8_conv.cu`` (x quantized once into
an int8 scratch copy, then the conv on s8 ``wgmma``, a split K adding a
reduce) or raises; for a CPU tensor it runs ``int8_conv_plain``.  The
integer sum is exact on both, so the two agree bit for bit.  3x3 with
padding 1 and 1x1 with padding 0, stride 1, are the eligible convs of the
teachers, and all that Q1 takes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tha4_tpu_torch.ops import cuda_build

# Q1's K step: each tap's input channels are padded to a multiple of it.
K_CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def layout_block(cout: int) -> int:
    """BN, the output channels of one block of Q1's device layout: the
    smallest of 32, 64, 128 that holds Cout, else 128 (``make_plan`` in
    csrc/int8_conv.cu takes the block from the layout)."""
    return next((b for b in (32, 64, 128) if cout <= b), 128)


class Int8Layout(NamedTuple):
    """One conv's int8 weight as Q1 reads it (``weight_layout``), with the
    channel counts its padding hides: ``int8_conv`` checks x and the scales
    against them."""

    tensor: torch.Tensor  # (Cout blocks, Cin chunks, kh * kw, 2, BN, 16) int8
    cin: int
    cout: int


def weight_layout(w8: torch.Tensor) -> Int8Layout:
    """HWIO int8 -> Q1's device layout, (Cout blocks, Cin chunks, kh * kw, 2,
    BN, 16) int8: per block of BN output channels and chunk of 32 input
    channels, each tap's two 16-channel groups, each output channel's 16
    bytes contiguous, as one bulk copy brings a chunk; Cin zero-padded to a
    multiple of 32 and Cout to a multiple of BN (``layout_block``)."""
    kh, kw, cin, cout = w8.shape
    bn = layout_block(cout)
    chunks, blocks = -(-cin // K_CHUNK), -(-cout // bn)
    padded = torch.zeros((kh * kw, chunks * K_CHUNK, blocks * bn), dtype=torch.int8, device=w8.device)
    padded[:, :cin, :cout] = w8.reshape(kh * kw, cin, cout)
    tensor = padded.reshape(kh * kw, chunks, 2, 16, blocks, bn).permute(4, 1, 0, 2, 5, 3).contiguous()
    return Int8Layout(tensor, cin, cout)


def _hwio(layout: Int8Layout) -> torch.Tensor:
    """``weight_layout``'s inverse: the HWIO int8 weight."""
    blocks, chunks, taps, _, bn, _ = layout.tensor.shape
    k = 3 if taps == 9 else 1
    w = layout.tensor.permute(2, 1, 3, 5, 0, 4).reshape(taps, chunks * K_CHUNK, blocks * bn)
    return w[:, :layout.cin, :layout.cout].reshape(k, k, layout.cin, layout.cout)


def _scales(x_scale: float):
    """(f32(1 / x_scale), f32(x_scale)): the reciprocal divided in double,
    then rounded, as ``jnp.float32(1.0 / x_scale)``."""
    return np.float32(1.0 / x_scale), np.float32(x_scale)


def int8_conv_plain(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor, x_scale: float, padding: int,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version, exact: an f64 conv of the integer values (every
    partial sum an integer below 2^53, 3 * 3 * 512 * 127^2 at the widest),
    rounded to the integer it is in case the backend's algorithm is not a
    direct sum.  x NHWC, w8 HWIO int8; NHWC out in x's dtype."""
    inv, xs = _scales(x_scale)
    xq = torch.round(x.float() * torch.tensor(inv)).clamp(-127, 127)
    acc = F.conv2d(xq.double().permute(0, 3, 1, 2), w8.double().permute(3, 2, 0, 1), padding=padding).round()
    out = (acc.permute(0, 2, 3, 1).float() * (torch.tensor(xs, device=x.device) * w_scale.float())).to(x.dtype)
    return out if bias is None else out + bias.to(x.dtype)


def _check(x: torch.Tensor, layout: Int8Layout, w_scale: torch.Tensor, padding: int, bias) -> tuple:
    if x.dtype not in _DTYPES:
        raise ValueError(f"int8_conv takes f32 or bf16 x, got {x.dtype}")
    if not isinstance(layout, Int8Layout):
        raise ValueError(f"int8_conv: the layout must be an Int8Layout (weight_layout), got {type(layout).__name__}")
    t, cin, cout = layout
    if x.dim() != 4 or t.dim() != 6 or t.dtype != torch.int8:
        raise ValueError(f"int8_conv: x must be NHWC and the layout (Cout blocks, Cin chunks, taps, 2, BN, 16) int8, "
                         f"got {tuple(x.shape)}, {tuple(t.shape)} {t.dtype}")
    taps = t.shape[2]
    bn = layout_block(cout)
    if t.shape != (-(-cout // bn), -(-cin // K_CHUNK), taps, 2, bn, 16):
        raise ValueError(f"int8_conv: a layout of {tuple(t.shape)} does not hold {cin} -> {cout} channels")
    if (taps, padding) not in ((9, 1), (1, 0)) or x.shape[3] != cin:
        raise ValueError(f"int8_conv: 3x3 with padding 1 or 1x1 with padding 0 over the layout's {cin} channels, got "
                         f"{taps} taps, padding {padding}, {x.shape[3]} channels")
    if w_scale.shape != (cout,) or w_scale.dtype != torch.float32:
        raise ValueError(f"int8_conv: w_scale must be ({cout},) f32, got {tuple(w_scale.shape)} {w_scale.dtype}")
    if bias is not None and (bias.shape != (cout,) or bias.dtype != x.dtype):
        raise ValueError(f"int8_conv: bias must be ({cout},) {x.dtype}, got {tuple(bias.shape)} {bias.dtype}")
    for v in (t, w_scale) + (() if bias is None else (bias,)):
        if v.device != x.device or not v.is_contiguous():
            raise ValueError("int8_conv: weights, scales and bias must be contiguous, on x's device")
    if t.data_ptr() % 16:
        raise ValueError("int8_conv: the weight layout must be 16-byte aligned")
    return taps, cout, cin


@functools.lru_cache(maxsize=None)
def _splits(n: int, h: int, w: int, cin: int, cout: int, k: int, bn: int) -> int:
    """How many work items share one tile's K chunks at this size (above 1
    the call needs an int32 workspace), asked of the library once."""
    splits = ctypes.c_int()
    status = cuda_build.library().tha4_int8_conv_plan(n, h, w, cin, cout, k, bn, ctypes.byref(splits))
    cuda_build.check(status, "int8_conv plan")
    return splits.value


def int8_conv(x: torch.Tensor, layout: Int8Layout, w_scale: torch.Tensor, x_scale: float, padding: int,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return int8_conv_plain(x, _hwio(layout), w_scale, x_scale, padding, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    if x.requires_grad:
        raise ValueError("int8_conv: the int8 teacher runs without gradients")
    taps, cout, cin = _check(x, layout, w_scale, padding, bias)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("int8_conv: x must be 16-byte aligned")
    n, h, w, _ = x.shape
    t = layout.tensor
    k, bn = 3 if taps == 9 else 1, t.shape[4]
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    splits = _splits(n, h, w, cin, cout, k, bn)
    xq = torch.empty((n, h, w, t.shape[1] * K_CHUNK), dtype=torch.int8, device=x.device)
    workspace = torch.empty((splits, n, h, w, cout), dtype=torch.int32, device=x.device) if splits > 1 else None
    inv, xs = _scales(x_scale)
    status = cuda_build.library().tha4_int8_conv_forward(
        x.data_ptr(), xq.data_ptr(), t.data_ptr(), w_scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), 0 if workspace is None else workspace.data_ptr(), n, h, w, cin, cout, k, bn, float(inv),
        float(xs), _DTYPES[x.dtype], cuda_build.current_stream(x.device))
    cuda_build.check(status, "int8_conv")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
