"""R1: the torch-rule bilinear resize, forward and adjoint, NCHW or NHWC.

``resize`` serves ``ops.resize.resize_bilinear_nchw`` and
``resize_bilinear``: for CUDA tensors it launches the kernel in
``csrc/resize.cu``, for CPU tensors it runs ``resize_plain``, the plain
PyTorch version, and anything else raises.  Both compute each output
element from two source taps per axis, the H pass first and then the W
pass, each ``w0 * a + w1 * b`` in f32 with one rounding a step, and round
once to the input dtype: the same arithmetic, so the kernel equals the plain
version bit for bit.  The plain version keeps an f64 input in f64.  The
taps come from the JAX package's rule for its dense interpolation matrices
(``tha4_tpu/ops/resize.py``: half-pixel source ``(i + 0.5) * in / out -
0.5`` in f64, clamped, the weights rounded to f32); where the matrices' two
entries fall on one source index the second weight is 0, so the two-tap
sum is the matrix product without its products by zero.

The kernel reads its input in place through its strides, so a permuted or
sliced view costs no copy, and writes a contiguous output in the call's
layout.  An NCHW image whose W shrinks more than about 400-fold (the NCHW
kernel's chunk of source columns would not fit its shared memory) is
resized as its NHWC view, and comes back as the NCHW view of a contiguous
NHWC output.  A CUDA input that requires a gradient under grad mode goes
through ``BilinearResizeFunction``, whose backward is the adjoint kernel: a
deterministic gather (each input element sums, in f32 and in a fixed order,
the output elements whose taps hit it; no atomics), which reads its
cotangent as NHWC in either layout.  On the CPU autograd differentiates
the plain version.

The tables are made once per (in, out, device) and cached, so a frame that
has run once can be captured in a CUDA graph; the forward's are never
dropped, so that such a graph's addresses stay valid.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from tha4_tpu_torch.ops import cuda_build, wide


@functools.lru_cache(maxsize=64)
def _taps_np(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, 4) int32: each output index's i0, i1 and the bits of its
    f32 weights w0 = 1 - t, w1 = t (torch's half-pixel rule)."""
    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    src = np.clip((i + 0.5) * scale - 0.5, 0.0, in_size - 1.0)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    t = src - i0
    taps = np.empty((out_size, 4), dtype=np.int32)
    taps[:, 0], taps[:, 1] = i0, i1
    taps[:, 2] = (1.0 - t).astype(np.float32).view(np.int32)
    taps[:, 3] = t.astype(np.float32).view(np.int32)
    return taps


@functools.lru_cache(maxsize=64)
def _adjoint_np(in_size: int, out_size: int) -> np.ndarray:
    """The inverse of ``_taps_np``, flat int32: 2 * out_size entries (o,
    bits(w)) sorted by source index, stably in (o, tap), then the
    in_size + 1 offsets of each source index's entries."""
    taps = _taps_np(in_size, out_size)
    src = taps[:, :2].reshape(-1)
    order = np.argsort(src, kind="stable")
    entries = np.stack([np.repeat(np.arange(out_size, dtype=np.int32), 2)[order], taps[:, 2:].reshape(-1)[order]], axis=1)
    offsets = np.zeros(in_size + 1, dtype=np.int32)
    np.cumsum(np.bincount(src, minlength=in_size), out=offsets[1:])
    return np.concatenate([entries.reshape(-1), offsets]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def taps(in_size: int, out_size: int, device: str) -> torch.Tensor:
    """``_taps_np`` on ``device``.  A normal tensor even when first asked for
    under inference mode (see ``ops.warp._identity_grid``).  Kept for the
    process's life (one per size pair the program resizes by): a captured
    CUDA graph reads it by address."""
    with torch.inference_mode(False):
        return torch.tensor(_taps_np(in_size, out_size), device=device)


@functools.lru_cache(maxsize=128)
def adjoint_taps(in_size: int, out_size: int, device: str) -> torch.Tensor:
    """``_adjoint_np`` on ``device``, for the adjoint kernel."""
    with torch.inference_mode(False):
        return torch.tensor(_adjoint_np(in_size, out_size), device=device)


def _dims(image: torch.Tensor, channels_last: bool) -> Tuple[int, int, int, int]:
    """(N, C, H, W) of an NCHW or, ``channels_last``, NHWC tensor."""
    if image.dim() != 4:
        raise ValueError(f"image must be 4-D, got {tuple(image.shape)}")
    n, a, b, c = image.shape
    return (n, c, a, b) if channels_last else (n, a, b, c)


def _pass(x: torch.Tensor, t: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis: w0 * x[i0] + w1 * x[i1] along ``dim``, in x's dtype."""
    shape = (-1,) + (1,) * (x.dim() - 1 - dim)
    w0 = t[:, 2].view(torch.float32).to(x.dtype).reshape(shape)
    w1 = t[:, 3].view(torch.float32).to(x.dtype).reshape(shape)
    return w0 * x.index_select(dim, t[:, 0].long()) + w1 * x.index_select(dim, t[:, 1].long())


def resize_plain(image: torch.Tensor, size: Tuple[int, int], channels_last: bool) -> torch.Tensor:
    """The plain version of R1: the H pass, then the W pass, in f32 (f64 for
    an f64 image), then one cast to the image dtype; an axis whose size does
    not change is passed through."""
    _, _, h, w = _dims(image, channels_last)
    ho, wo = size
    hdim, wdim = (1, 2) if channels_last else (2, 3)
    device = str(image.device)
    x = wide(image)
    if h != ho:
        x = _pass(x, taps(h, ho, device), hdim)
    if w != wo:
        x = _pass(x, taps(w, wo, device), wdim)
    return x.to(image.dtype)


_DTYPES = (torch.float32, torch.bfloat16)


def _launch_args(t: torch.Tensor, channels_last: bool, what: str) -> Tuple[int, ...]:
    """What the kernels take of the tensor they read: its strides in (N, C,
    H, W) order, the channels a thread reads at once (NHWC: 4, 2 or 1,
    whichever divides C; 1 for the NCHW forward, which picks its own) and
    whether they can be read in one load (NHWC with channel stride 1, the
    other strides and the address aligned).  Raises on a dtype the kernels
    do not take or an offset past 31 bits."""
    if t.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype must be float32 or bfloat16 on the card, got {t.dtype}")
    s = t.stride()
    strides = (s[0], s[3], s[1], s[2]) if channels_last else tuple(s)
    if sum((size - 1) * stride for size, stride in zip(t.shape, s)) >= 2**31:
        raise ValueError(f"{what}: {tuple(t.shape)} with strides {tuple(s)} has offsets past 31 bits")
    run = t.shape[3] if channels_last else 1
    vec = 4 if run % 4 == 0 else 2 if run % 2 == 0 else 1
    vec_load = (channels_last and strides[1] == 1 and all(x % vec == 0 for x in (strides[0], strides[2], strides[3]))
                and t.data_ptr() % (vec * t.element_size()) == 0)
    return (*strides, int(t.dtype == torch.bfloat16), vec, int(vec_load))


@functools.lru_cache(maxsize=128)
def _rows_fit(w: int, wo: int) -> bool:
    """Whether the NCHW kernel takes a W resize w -> wo."""
    return bool(cuda_build.library().tha4_bilinear_resize_rows_fit(w, wo))


def bilinear_resize_forward(image: torch.Tensor, size: Tuple[int, int], channels_last: bool) -> torch.Tensor:
    """R1's forward on a CUDA tensor (f32 or bf16, any strides): a new
    tensor in the same layout and dtype, contiguous unless an NCHW image
    went the NHWC way."""
    n, c, h, w = _dims(image, channels_last)
    ho, wo = size
    if not channels_last and not _rows_fit(w, wo):
        return bilinear_resize_forward(image.permute(0, 2, 3, 1), size, True).permute(0, 3, 1, 2)
    args = _launch_args(image, channels_last, "bilinear_resize_forward")
    out = image.new_empty((n, ho, wo, c) if channels_last else (n, c, ho, wo))
    device = image.device
    key = str(device)
    status = cuda_build.library().tha4_bilinear_resize_forward(
        image.data_ptr(), out.data_ptr(), taps(h, ho, key).data_ptr(), taps(w, wo, key).data_ptr(), n, c, h, w, ho, wo,
        int(channels_last), *args, cuda_build.current_stream(device),
    )
    cuda_build.check(status, "bilinear_resize_forward")
    bilinear_resize_forward.launches += 1
    return out


bilinear_resize_forward.launches = 0


def bilinear_resize_backward(g: torch.Tensor, in_size: Tuple[int, int], channels_last: bool) -> torch.Tensor:
    """R1's adjoint on a CUDA cotangent ``g`` (the output's shape and dtype,
    any strides): the input's gradient in g's dtype, a contiguous NHWC
    tensor (for an NCHW ``g``, its NCHW view)."""
    if not channels_last:
        return bilinear_resize_backward(g.permute(0, 2, 3, 1), in_size, True).permute(0, 3, 1, 2)
    n, c, ho, wo = _dims(g, True)
    h, w = in_size
    args = _launch_args(g, True, "bilinear_resize_backward")
    dx = g.new_empty((n, h, w, c))
    device = g.device
    key = str(device)
    status = cuda_build.library().tha4_bilinear_resize_backward(
        g.data_ptr(), dx.data_ptr(), adjoint_taps(h, ho, key).data_ptr(), adjoint_taps(w, wo, key).data_ptr(), n, c, h, w,
        ho, wo, *args, cuda_build.current_stream(device),
    )
    cuda_build.check(status, "bilinear_resize_backward")
    bilinear_resize_backward.launches += 1
    return dx


bilinear_resize_backward.launches = 0


class BilinearResizeFunction(torch.autograd.Function):
    """R1 with its gradient: the forward kernel, the adjoint kernel."""

    @staticmethod
    def forward(ctx, image, size, channels_last):
        _, _, h, w = _dims(image, channels_last)
        ctx.in_size, ctx.channels_last = (h, w), channels_last
        return bilinear_resize_forward(image, size, channels_last)

    @staticmethod
    def backward(ctx, g):
        return bilinear_resize_backward(g, ctx.in_size, ctx.channels_last), None, None


def resize(image: torch.Tensor, size: Tuple[int, int], channels_last: bool) -> torch.Tensor:
    """Torch-rule bilinear resize of an NCHW or, ``channels_last``, NHWC
    ``image`` to (H, W) = ``size``: the kernel for a CUDA tensor (with its
    adjoint where a gradient is wanted), the plain version for a CPU
    tensor; a ``ValueError`` on any other device."""
    size = (int(size[0]), int(size[1]))
    device = image.device
    if device.type == "cpu":
        return resize_plain(image, size, channels_last)
    if device.type != "cuda":
        raise ValueError(f"resize: unsupported device {device}")
    if torch.is_grad_enabled() and image.requires_grad:
        return BilinearResizeFunction.apply(image, size, channels_last)
    return bilinear_resize_forward(image, size, channels_last)
