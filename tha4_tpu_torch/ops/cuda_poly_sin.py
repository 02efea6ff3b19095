"""K5: the polynomial sine of the SIREN training path, with its gradient
(counterpart of ``tha4_tpu/ops/pallas_siren.py:poly_sin``).

``poly_sin(a, out_dtype)`` is ``fast_sin(a)`` rounded to ``out_dtype`` (by
default ``a``'s), as a ``torch.autograd.Function`` whose only residual is
``a`` in its incoming dtype; its gradient is ``g * fast_cos(a)`` in f32,
rounded to ``a``'s dtype.  ``out_dtype`` narrower than ``a`` (f32 -> bf16)
fuses the JAX package's ``poly_sin(a).astype(bf16)`` of its selective-f32
path: the same values and the same gradient.

``poly_sin_forward`` / ``poly_sin_backward`` launch the elementwise CUDA
kernels in ``csrc/poly_sin.cu`` for CUDA tensors and run the plain PyTorch
versions (``poly_sin_plain`` / ``poly_sin_bwd_plain``) for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from tha4_tpu_torch.ops import cuda_build
from tha4_tpu_torch.ops.cuda_siren import fast_cos, fast_sin

# (a dtype, out dtype) -> the kernels' dtype code
_DTYPES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.float32, torch.bfloat16): 2,
}


def poly_sin_plain(a: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    return fast_sin(a).to(a.dtype).to(out_dtype)


def poly_sin_bwd_plain(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return (g.float() * fast_cos(a)).to(a.dtype)


def _check(a: torch.Tensor, out_dtype: torch.dtype, g: Optional[torch.Tensor] = None) -> int:
    code = _DTYPES.get((a.dtype, out_dtype))
    if code is None:
        raise ValueError(f"poly_sin takes f32 -> f32, bf16 -> bf16 or f32 -> bf16, got {a.dtype} -> {out_dtype}")
    tensors = [a] if g is None else [a, g]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("poly_sin: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("poly_sin: tensors must be 16-byte aligned")
    if g is not None and (g.shape != a.shape or g.dtype != out_dtype or g.device != a.device):
        raise ValueError(f"poly_sin: g must be {tuple(a.shape)} {out_dtype} on {a.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    return code


def poly_sin_forward(a: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if a.device.type == "cpu":
        return poly_sin_plain(a, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"poly_sin_forward: unsupported device {a.device}")
    code = _check(a, out_dtype)
    out = torch.empty(a.shape, dtype=out_dtype, device=a.device)
    stream = cuda_build.current_stream(a.device)
    status = cuda_build.library().tha4_poly_sin_forward(a.data_ptr(), out.data_ptr(), a.numel(), code, stream)
    cuda_build.check(status, "poly_sin_forward")
    poly_sin_forward.launches += 1
    return out


poly_sin_forward.launches = 0


def poly_sin_backward(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient with respect to ``a``, in ``a``'s dtype; ``g`` has the
    forward output's dtype."""
    if a.device.type == "cpu":
        return poly_sin_bwd_plain(a, g)
    if a.device.type != "cuda":
        raise ValueError(f"poly_sin_backward: unsupported device {a.device}")
    code = _check(a, g.dtype, g)
    da = torch.empty_like(a)
    stream = cuda_build.current_stream(a.device)
    status = cuda_build.library().tha4_poly_sin_backward(a.data_ptr(), g.data_ptr(), da.data_ptr(), a.numel(), code, stream)
    cuda_build.check(status, "poly_sin_backward")
    poly_sin_backward.launches += 1
    return da


poly_sin_backward.launches = 0


class PolySinFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, out_dtype):
        ctx.save_for_backward(a)
        return poly_sin_forward(a, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return poly_sin_backward(a, g.contiguous()), None


def poly_sin(a: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable ``fast_sin(a)`` in ``out_dtype`` (default ``a.dtype``)."""
    return PolySinFunction.apply(a, out_dtype or a.dtype)
