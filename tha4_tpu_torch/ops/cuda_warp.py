"""K2 and K3: the bilinear border warp and its differentiable form
(counterpart of ``tha4_tpu/ops/pallas_warp.py``).

``grid_sample_fast`` (K2) launches the CUDA kernel in ``csrc/warp.cu`` for
CUDA tensors and runs ``grid_sample_bilinear_border``, the plain PyTorch
version, for CPU tensors.  Both compute torch ``grid_sample(mode='bilinear',
padding_mode='border', align_corners=False)`` on NHWC images exactly: unlike
the TPU kernel there is no displacement window and no bf16 lerp weight, so
``ops.warp`` needs no choice of warp mode.  K2 has no
autograd, so it refuses a grid or image that requires a gradient while grad
mode is on: a bare K2 call must never drop a gradient silently.

``grid_sample_train`` is the differentiable warp (K3), the counterpart of
the JAX ``grid_sample_fast``'s custom VJP.  Its forward is K2's kernel
(``grid_sample_train_forward``, counted apart from K2's bare calls), and it
saves the image and the grid.  Its backward, ``grid_sample_grid_backward``,
gathers the four corners again and forms dgrid = sum_c dout_c * D_c *
clamp mask * size / 2, where D is dOut/d(ix) or dOut/d(iy).  The TPU kernel
writes D in the forward instead, two f32 fields that at the body student's
(8, 512^2, 4) are 67 MB written and read back; on an NVIDIA H100 80GB HBM3
(700 W) one batch of images fits in its 50 MB L2, so the regather costs
little: the pair moves 117 MB in bf16 and 185 MB in f32 (``csrc/warp.cu``
has its times).  The image is a constant: its cotangent is zero,
the contract of ``pallas_warp.py:24-31``.  One ``torch.autograd.Function``
serves both devices; on the CPU the backward runs
``grid_sample_grid_backward_plain``, the elementwise formula over
``grid_sample_corners_plain``'s fields, the JAX residuals' plain mirror.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tha4_tpu_torch.ops import cuda_build, wide


def _corners(image: torch.Tensor, grid: torch.Tensor):
    """The four corners (f32, or f64 for f64 inputs; (N, Ho, Wo, C) each)
    and the lerp weights (N, Ho, Wo, 1), in the order clip -> floor -> corners of
    ``tha4_tpu/ops/warp.py:grid_sample_bilinear_border``."""
    n, h, w, c = image.shape
    gx = wide(grid[..., 0])
    gy = wide(grid[..., 1])
    ix = (((gx + 1.0) * w - 1.0) * 0.5).clamp(0.0, w - 1.0)
    iy = (((gy + 1.0) * h - 1.0) * 0.5).clamp(0.0, h - 1.0)
    ix0 = ix.floor()
    iy0 = iy.floor()
    tx = (ix - ix0)[..., None]
    ty = (iy - iy0)[..., None]
    ix0 = ix0.long()
    iy0 = iy0.long()
    ix1 = (ix0 + 1).clamp(max=w - 1)
    iy1 = (iy0 + 1).clamp(max=h - 1)

    flat = wide(image.reshape(n, h * w, c))
    ho, wo = grid.shape[1], grid.shape[2]

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(n, ho * wo, 1).expand(n, ho * wo, c)
        return torch.gather(flat, 1, idx).reshape(n, ho, wo, c)

    return gather(iy0, ix0), gather(iy0, ix1), gather(iy1, ix0), gather(iy1, ix1), tx, ty


def grid_sample_bilinear_border(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``image`` (N,H,W,C) at ``grid`` (N,Ho,Wo,2) in [-1,1].

    The plain version of K2: coordinate math and lerp in f32 whatever the
    image dtype (f64 for an f64 image and grid; lerp x, then y); the result
    is cast to the image dtype."""
    v00, v01, v10, v11, tx, ty = _corners(image, grid)
    top = v00 + (v01 - v00) * tx
    bottom = v10 + (v11 - v10) * tx
    return (top + (bottom - top) * ty).to(image.dtype)


def grid_sample_corners_plain(image: torch.Tensor, grid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU corners kernel's outputs: (out in the image dtype, dx, dy
    f32), all (N, Ho, Wo, C), in the f32 order of ``_fwd_corners_kernel``
    (``pallas_warp.py:203-213``); ``out`` equals K2's.  The plain backward
    is built on dx and dy."""
    v00, v01, v10, v11, tx, ty = _corners(image, grid)
    top_dx = v01 - v00
    bot_dx = v11 - v10
    top = v00 + top_dx * tx
    bot = v10 + bot_dx * tx
    dy = bot - top
    out = (top + dy * ty).to(image.dtype)
    dx = top_dx + (bot_dx - top_dx) * ty
    return out, dx, dy


def _forward(image: torch.Tensor, grid: torch.Tensor, wrapper) -> torch.Tensor:
    """K2's kernel on CUDA tensors (anything it does not take raises),
    counted on ``wrapper``; its plain version on CPU tensors; a
    ``ValueError`` on any other device."""
    device = image.device
    if device.type != "cuda":
        if device.type == "cpu":
            return grid_sample_bilinear_border(image, grid)
        raise ValueError(f"{wrapper.__name__}: unsupported device {device}")
    n, h, w, ho, wo, is_bf16 = _check(image, grid)
    out = image.new_empty((n, ho, wo, 4))
    status = cuda_build.library().tha4_grid_sample_forward(image.data_ptr(), grid.data_ptr(), out.data_ptr(), n, h, w, ho, wo,
                                                 is_bf16, cuda_build.current_stream(device))
    if status:
        cuda_build.check(status, wrapper.__name__)
    wrapper.launches += 1
    return out


def grid_sample_fast(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Warp NHWC ``image`` (N,H,W,4, f32 or bf16) at ``grid`` (N,Ho,Wo,2 f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.  No autograd, on either
    device: ``grid_sample_train`` is the differentiable warp.  The kernel
    takes a few microseconds at a frame's 512^2, about what this wrapper
    costs the host, so the CUDA path reads each tensor attribute once."""
    if torch.is_grad_enabled() and (grid.requires_grad or image.requires_grad):
        raise RuntimeError("grid_sample_fast has no gradient: warp a grid that requires grad "
                           "with grid_sample_train (ops.warp.apply_grid_change routes it)")
    return _forward(image, grid, grid_sample_fast)


grid_sample_fast.launches = 0


def grid_sample_train_forward(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """K3's forward, K2's kernel launched for the differentiable warp and
    counted apart from K2's bare calls; the plain version on the CPU."""
    return _forward(image, grid, grid_sample_train_forward)


grid_sample_train_forward.launches = 0


def grid_sample_grad(g: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor, grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """dgrid from the output's cotangent ``g`` and the corners kernel's
    fields (``pallas_warp.py:336-350``): the channel sums of g * D, zero
    where the unnormalised coordinate is clamped (strict masks), times
    size / 2; in the grid's dtype."""
    dout = wide(g)
    dv_dix = (dout * dx).sum(dim=-1)
    dv_diy = (dout * dy).sum(dim=-1)
    ix_un = ((wide(grid[..., 0]) + 1.0) * w - 1.0) * 0.5
    iy_un = ((wide(grid[..., 1]) + 1.0) * h - 1.0) * 0.5
    gxmask = ((ix_un > 0.0) & (ix_un < w - 1.0)).to(dv_dix.dtype)
    gymask = ((iy_un > 0.0) & (iy_un < h - 1.0)).to(dv_diy.dtype)
    return torch.stack([dv_dix * gxmask * (0.5 * w), dv_diy * gymask * (0.5 * h)], dim=-1).to(grid.dtype)


def grid_sample_grid_backward_plain(g: torch.Tensor, image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The plain version of K3's backward: dgrid (N, Ho, Wo, 2) from the
    output's cotangent, the image and the grid, the JAX package's
    elementwise formula over the corners kernel's fields (f64 throughout
    for f64 inputs)."""
    _, dx, dy = grid_sample_corners_plain(image, grid)
    return grid_sample_grad(g, dx, dy, grid, image.shape[1], image.shape[2])


def grid_sample_grid_backward(g: torch.Tensor, image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """K3's backward: dgrid (N, Ho, Wo, 2) f32 for the output's cotangent
    ``g`` (N, Ho, Wo, 4, the image's dtype).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything it does not take
    raises."""
    device = image.device
    if device.type != "cuda":
        if device.type == "cpu":
            return grid_sample_grid_backward_plain(g, image, grid)
        raise ValueError(f"grid_sample_grid_backward: unsupported device {device}")
    n, h, w, ho, wo, is_bf16 = _check(image, grid)
    if g.device != device or g.dtype != image.dtype or g.shape != (n, ho, wo, 4):
        raise ValueError(f"g must be (N, Ho, Wo, 4) = {(n, ho, wo, 4)} in {image.dtype} on {device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    if not g.is_contiguous() or g.data_ptr() % (8 if is_bf16 else 16):
        raise ValueError("g must be contiguous and aligned for vector loads")
    dgrid = torch.empty((n, ho, wo, 2), dtype=torch.float32, device=device)
    status = cuda_build.library().tha4_grid_sample_grid_backward(
        g.data_ptr(), image.data_ptr(), grid.data_ptr(), dgrid.data_ptr(), n, h, w, ho, wo, is_bf16,
        cuda_build.current_stream(device),
    )
    cuda_build.check(status, "grid_sample_grid_backward")
    grid_sample_grid_backward.launches += 1
    return dgrid


grid_sample_grid_backward.launches = 0


class GridSampleFunction(torch.autograd.Function):
    """K3: K2's kernel forward, the regathering backward; gradients reach
    the grid only."""

    @staticmethod
    def forward(ctx, image, grid):
        out = grid_sample_train_forward(image, grid)
        if image.is_inference():
            # An inference tensor cannot be saved for backward: keep a
            # normal copy of it (a frame rendered under inference_mode).
            with torch.inference_mode(False):
                image = image.clone()
        ctx.save_for_backward(image, grid)
        return out

    @staticmethod
    def backward(ctx, g):
        image, grid = ctx.saved_tensors
        dgrid = grid_sample_grid_backward(g.contiguous(), image, grid) if ctx.needs_input_grad[1] else None
        dimage = torch.zeros_like(image) if ctx.needs_input_grad[0] else None
        return dimage, dgrid


def grid_sample_train(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The differentiable warp: K3 (its plain version on the CPU), gradient
    to the grid only; the image's cotangent is zero."""
    return GridSampleFunction.apply(image, grid)


_DTYPES = (torch.float32, torch.bfloat16)


def _check(image: torch.Tensor, grid: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """Raise on what the kernels do not take; else (N, H, W, Ho, Wo, is_bf16)."""
    ishape, gshape, dtype = image.shape, grid.shape, image.dtype
    if grid.device != image.device:
        raise ValueError(f"grid on {grid.device}, image on {image.device}")
    if len(ishape) != 4 or ishape[3] != 4:
        raise ValueError(f"image must be (N, H, W, 4), got {tuple(ishape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"image dtype must be float32 or bfloat16, got {dtype}")
    if len(gshape) != 4 or gshape[0] != ishape[0] or gshape[3] != 2:
        raise ValueError(f"grid must be (N, Ho, Wo, 2) with N = {ishape[0]}, got {tuple(gshape)}")
    if grid.dtype != torch.float32:
        raise ValueError(f"grid dtype must be float32, got {grid.dtype}")
    if not (image.is_contiguous() and grid.is_contiguous()):
        raise ValueError("image and grid must be contiguous")
    # One texel is one 16-byte (f32) or 8-byte (bf16) load; a grid point 8 bytes.
    is_bf16 = int(dtype == torch.bfloat16)
    if image.data_ptr() % (8 if is_bf16 else 16) or grid.data_ptr() % 8:
        raise ValueError("image or grid is not aligned for vector loads")
    return ishape[0], ishape[1], ishape[2], gshape[1], gshape[2], is_bf16
