"""K2: the bilinear border warp (counterpart of ``tha4_tpu/ops/pallas_warp.py``).

``grid_sample_fast`` launches the CUDA kernel in ``csrc/warp.cu`` for CUDA
tensors and runs ``grid_sample_bilinear_border``, the plain PyTorch version,
for CPU tensors.  Both compute torch ``grid_sample(mode='bilinear',
padding_mode='border', align_corners=False)`` on NHWC images exactly: unlike
the TPU kernel there is no displacement window and no bf16 lerp weight, so
``'auto'`` and ``'strict'`` are the same thing in ``ops.warp``.

No autograd: the students that train so far take no gradient through a
warp; the gradient-emitting variant (K3) comes with the body student.
"""

from __future__ import annotations

import torch

from tha4_tpu_torch.ops import cuda_build


def grid_sample_bilinear_border(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``image`` (N,H,W,C) at ``grid`` (N,Ho,Wo,2) in [-1,1].

    The plain version: coordinate math and lerp in f32 whatever the image
    dtype, in the order clip -> floor -> corners -> lerp x -> lerp y of
    ``tha4_tpu/ops/warp.py:grid_sample_bilinear_border``; the result is cast
    to the image dtype."""
    n, h, w, c = image.shape
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
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

    flat = image.reshape(n, h * w, c).float()
    ho, wo = grid.shape[1], grid.shape[2]

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(n, ho * wo, 1).expand(n, ho * wo, c)
        return torch.gather(flat, 1, idx).reshape(n, ho, wo, c)

    v00 = gather(iy0, ix0)
    v01 = gather(iy0, ix1)
    v10 = gather(iy1, ix0)
    v11 = gather(iy1, ix1)
    top = v00 + (v01 - v00) * tx
    bottom = v10 + (v11 - v10) * tx
    return (top + (bottom - top) * ty).to(image.dtype)


def grid_sample_fast(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Warp NHWC ``image`` (N,H,W,4, f32 or bf16) at ``grid`` (N,Ho,Wo,2 f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises."""
    if image.device.type == "cpu":
        return grid_sample_bilinear_border(image, grid)
    if image.device.type != "cuda":
        raise ValueError(f"grid_sample_fast: unsupported device {image.device}")
    _check(image, grid)
    n, h, w, _ = image.shape
    ho, wo = grid.shape[1], grid.shape[2]
    out = torch.empty((n, ho, wo, 4), dtype=image.dtype, device=image.device)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    status = cuda_build.library().tha4_grid_sample_forward(
        image.data_ptr(), grid.data_ptr(), out.data_ptr(), n, h, w, ho, wo,
        int(image.dtype == torch.bfloat16), stream,
    )
    cuda_build.check(status, "grid_sample_fast")
    grid_sample_fast.launches += 1
    return out


grid_sample_fast.launches = 0


def _check(image: torch.Tensor, grid: torch.Tensor) -> None:
    if grid.device != image.device:
        raise ValueError(f"grid on {grid.device}, image on {image.device}")
    if image.dim() != 4 or image.shape[3] != 4:
        raise ValueError(f"image must be (N, H, W, 4), got {tuple(image.shape)}")
    if image.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"image dtype must be float32 or bfloat16, got {image.dtype}")
    if grid.dim() != 4 or grid.shape[0] != image.shape[0] or grid.shape[3] != 2:
        raise ValueError(f"grid must be (N, Ho, Wo, 2) with N = {image.shape[0]}, got {tuple(grid.shape)}")
    if grid.dtype != torch.float32:
        raise ValueError(f"grid dtype must be float32, got {grid.dtype}")
    if not (image.is_contiguous() and grid.is_contiguous()):
        raise ValueError("image and grid must be contiguous")
    # One texel is one 16-byte (f32) or 8-byte (bf16) load; a grid point 8 bytes.
    if image.data_ptr() % (4 * image.element_size()) or grid.data_ptr() % 8:
        raise ValueError("image or grid is not aligned for vector loads")
