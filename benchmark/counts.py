"""The yardstick's arithmetic: published peaks, roofline bounds, operation
and byte counts, and the kernel groups of a device trace.

Frozen here so that later changes to the program do not move it.  The
peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates without
sparsity, at the full 700 W limit).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# The CUDA cores' f32 instruction rate: the 67 TFLOP/s count an FMA as two.
CUDA_CORE_OPS_PER_S = PEAK_FLOPS["f32"] / 2
# f32 operations of one sine-layer output in the fused SIREN kernel: the
# bias add, the omega multiply, the range reduction (6), r^2, the degree-11
# polynomial (10) and its last multiply.
SIN_OPS = 20
BYTES = {"f32": 4, "bf16": 2}

# Kernel name fragments -> group, first match wins.
GROUPS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("K1 sine_chain", ("sine_chain_kernel", "sine_chain_tc_kernel")),
    ("K4 sine_chain_bwd", ("sine_chain_bwd_kernel", "sum_slabs_kernel", "sine_chain_bwd_tc_kernel", "sine_chain_dw_kernel",
                           "column_sum_kernel", "dpose_kernel")),
    ("K2 warp, K3 forward", ("grid_sample_kernel",)),
    ("K3 warp", ("grid_sample_grid_backward_kernel", "grid_sample_corners_kernel")),
    ("K5 poly_sin", ("poly_sin_",)),
    ("K6 affine_silu_conv3", ("affine_silu_conv3",)),
    ("K6 fold", ("group_norm_stats", "group_norm_fold")),
    ("Q1 int8_conv", ("int8_conv", "int8_quantize")),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "nchwToNhwc", "nhwcToNchw", "xmma")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "Kernel2", "sm90_")),
    ("reduction", ("reduce",)),
    ("elementwise, copies", ("elementwise", "vectorized", "copy", "cat", "index", "fill", "Memcpy", "Memset")),
)


def group_of(name: str) -> str:
    for group, fragments in GROUPS:
        if any(f in name for f in fragments):
            return group
    return "other"


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time: bytes over the memory rate or operations over the
    dtype's peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def chain_macs(layers: Iterable[Tuple[int, int]], pixels: int) -> int:
    """Multiply-adds of one pass of a SIREN chain of (cin, cout) layers."""
    return sum(ci * co for ci, co in layers) * pixels


def chain_bound_s(nbytes: float, macs: float, sine_outputs: float, dtype: str) -> float:
    """A fused SIREN chain's bound: bytes over the memory rate; the products
    (2 x multiply-adds) at the dtype's peak; the sine epilogue's f32
    operations on the CUDA cores.  In bf16 the products run on the tensor
    cores beside the epilogue (the larger of the two); in f32 both run on
    the CUDA cores (their sum)."""
    products = 2.0 * macs / PEAK_FLOPS[dtype]
    epilogue = sine_outputs * SIN_OPS / CUDA_CORE_OPS_PER_S
    ops = products + epilogue if dtype == "f32" else max(products, epilogue)
    return max(nbytes / HBM_BYTES_PER_S, ops)


def merge_intervals(intervals: Sequence[Tuple[float, float]]):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged
