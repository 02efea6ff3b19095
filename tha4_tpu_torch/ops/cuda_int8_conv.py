"""Q1: the int8 teacher's convolution (counterpart of
``tha4_tpu/ops/quant.py:conv2d_int8``, which JAX leaves to XLA's
``lax.conv_general_dilated`` on int8 operands: no ``pallas_call``).

``int8_conv(x, layout, w_scale, x_scale, padding, bias)`` takes NHWC ``x``
(f32 or bf16, any strides; it is made contiguous), the int8 weight in Q1's
layout (``weight_layout``), the per-Cout f32 weight scale and the static
activation scale, and returns NHWC in x's dtype:

    xq  = clip(round_half_even(x.f32 * f32(1 / x_scale)), -127, 127)
    acc = conv(xq, w8)                       (int32, exact)
    out = T(acc.f32 * (f32(x_scale) * w_scale)) [+ T(bias)]   (T = x's dtype)

For a CUDA tensor it launches ``csrc/int8_conv.cu`` (which quantizes x as
it loads it: no int8 copy of x is written) or raises; for a CPU tensor it
runs ``int8_conv_plain``.  The integer sum is exact on both, so the two
agree bit for bit.  3x3 with padding 1 and 1x1 with padding 0, stride 1,
are the eligible convs of the teachers, and all that Q1 takes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tha4_tpu_torch.ops import cuda_build

# Q1's K step: each tap's input channels are padded to a multiple of it.
K_CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def weight_layout(w8: torch.Tensor) -> torch.Tensor:
    """HWIO int8 -> (kh * kw, Cout, Cin rounded up to 32) int8, zero padded:
    each output channel's inputs of a tap contiguous, as Q1 loads them."""
    kh, kw, cin, cout = w8.shape
    cpad = -(-cin // K_CHUNK) * K_CHUNK
    out = torch.zeros((kh * kw, cout, cpad), dtype=torch.int8, device=w8.device)
    out[:, :, :cin] = w8.reshape(kh * kw, cin, cout).transpose(1, 2)
    return out


def _hwio(layout: torch.Tensor, cin: int) -> torch.Tensor:
    taps, cout, _ = layout.shape
    k = 3 if taps == 9 else 1
    return layout[:, :, :cin].transpose(1, 2).reshape(k, k, cin, cout)


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


def _check(x: torch.Tensor, layout: torch.Tensor, w_scale: torch.Tensor, padding: int, bias) -> tuple:
    if x.dtype not in _DTYPES:
        raise ValueError(f"int8_conv takes f32 or bf16 x, got {x.dtype}")
    if x.dim() != 4 or layout.dim() != 3 or layout.dtype != torch.int8:
        raise ValueError(f"int8_conv: x must be NHWC and the layout (taps, Cout, Cin32) int8, got {tuple(x.shape)}, "
                         f"{tuple(layout.shape)} {layout.dtype}")
    taps, cout, cpad = layout.shape
    cin = x.shape[3]
    if (taps, padding) not in ((9, 1), (1, 0)) or cpad != -(-cin // K_CHUNK) * K_CHUNK:
        raise ValueError(f"int8_conv: 3x3 with padding 1 or 1x1 with padding 0 over {cin} channels, got {taps} taps, "
                         f"padding {padding}, {cpad} padded channels")
    if w_scale.shape != (cout,) or w_scale.dtype != torch.float32:
        raise ValueError(f"int8_conv: w_scale must be ({cout},) f32, got {tuple(w_scale.shape)} {w_scale.dtype}")
    if bias is not None and (bias.shape != (cout,) or bias.dtype != x.dtype):
        raise ValueError(f"int8_conv: bias must be ({cout},) {x.dtype}, got {tuple(bias.shape)} {bias.dtype}")
    for t in (layout, w_scale) + (() if bias is None else (bias,)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_conv: weights, scales and bias must be contiguous, on x's device")
    if layout.data_ptr() % 16:
        raise ValueError("int8_conv: the weight layout must be 16-byte aligned")
    return taps, cout, cin


def int8_conv(x: torch.Tensor, layout: torch.Tensor, w_scale: torch.Tensor, x_scale: float, padding: int,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return int8_conv_plain(x, _hwio(layout, x.shape[3]), w_scale, x_scale, padding, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    if x.requires_grad:
        raise ValueError("int8_conv: the int8 teacher runs without gradients")
    taps, cout, cin = _check(x, layout, w_scale, padding, bias)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("int8_conv: x must be 16-byte aligned")
    n, h, w, _ = x.shape
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    inv, xs = _scales(x_scale)
    status = cuda_build.library().tha4_int8_conv_forward(
        x.data_ptr(), layout.data_ptr(), w_scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), n, h, w, cin, cout, 3 if taps == 9 else 1, float(inv), float(xs), _DTYPES[x.dtype],
        cuda_build.current_stream(x.device))
    cuda_build.check(status, "int8_conv")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
