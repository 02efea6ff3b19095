"""K1: the fused SIREN level (counterpart of ``tha4_tpu/ops/pallas_siren.py``).

A SIREN level is a chain of 1x1-conv sine layers over a pixel grid,
channels-first: the level input is h = [prev | pos_x, pos_y | pose] per
pixel, each sine layer is h <- fast_sin(omega * (W h + b)), and the last
body level ends in a head linear without a sine.

``sine_chain_t`` launches the CUDA kernel in ``csrc/sine_chain.cu`` for CUDA
tensors and runs ``chain_t_plain`` for CPU tensors.

Precision rule (``tha4_tpu/ops/pallas_util.py:kernel_dot_precision``):
  * float32 means full-f32 products: no TF32 anywhere;
  * bfloat16 means bf16 operands (weights, activations, pos, pose) with f32
    accumulation and f32 bias.  ``chain_t_plain`` emulates that exactly by
    upcasting the bf16 operands to f32 before an f32 matmul: a product of
    two bf16 values is exact in f32.

Weights are packed once per poser and dtype (``pack_chain``): each layer's
(Co, Ci) matrix, which is the squeezed 1x1-conv weight as stored, flattened
into one buffer in the compute dtype, and the biases into one f32 buffer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tha4_tpu_torch.ops import cuda_build

_SIN_C1 = 9.9999959991e-01
_SIN_C3 = -1.6666552633e-01
_SIN_C5 = 8.3324029750e-03
_SIN_C7 = -1.9808632984e-04
_SIN_C9 = 2.6997142332e-06
_SIN_C11 = -2.0362228527e-08
_INV_TWO_PI = 0.15915494309189535
_TWO_PI_HI = 6.28125
_TWO_PI_LO = 1.9353071795864769e-03

MAX_LAYERS = 16  # csrc/sine_chain.cu kMaxLayers


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """Polynomial sine in f32: Cody-Waite reduction by 2*pi, then an odd
    degree-11 polynomial; max error 6.5e-7 for |x| <= 200.  Same constants
    and operation order as ``pallas_siren._fast_sin`` and the CUDA kernel
    (``torch.round`` rounds half to even, as ``jnp.round`` and ``rintf``)."""
    x = x.float()
    k = torch.round(x * _INV_TWO_PI)
    r = x - k * _TWO_PI_HI - k * _TWO_PI_LO
    r2 = r * r
    return r * (_SIN_C1 + r2 * (_SIN_C3 + r2 * (_SIN_C5 + r2 * (_SIN_C7 + r2 * (_SIN_C9 + r2 * _SIN_C11)))))


@dataclass(frozen=True)
class PackedChain:
    """One SIREN level's weights, packed for ``sine_chain_t``.

    ``w``: every layer's (Co, Ci) matrix, row-major, concatenated, in the
    compute dtype.  ``b``: the biases concatenated, f32.  ``specs``: one
    (ci, co, w_offset, b_offset) row per layer, int32, on the host.  The
    first ``num_sine`` layers have a sine; a remaining last layer is the head.
    """

    w: torch.Tensor
    b: torch.Tensor
    specs: np.ndarray
    num_sine: int

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype

    @property
    def num_layers(self) -> int:
        return len(self.specs)

    @property
    def out_channels(self) -> int:
        return int(self.specs[-1, 1])

    def layer(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        ci, co, wo, bo = (int(v) for v in self.specs[i])
        return self.w[wo : wo + co * ci].view(co, ci), self.b[bo : bo + co]


def pack_chain(
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    head: Optional[Tuple[torch.Tensor, torch.Tensor]],
    dtype: torch.dtype,
    device=None,
) -> PackedChain:
    """Pack sine layers (and an optional head) given as (W (Co, Ci), b (Co))."""
    mats = list(layers) + ([head] if head is not None else [])
    if len(mats) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers per chain, got {len(mats)}")
    specs = []
    w_off = b_off = 0
    for w, b in mats:
        co, ci = w.shape
        specs.append((ci, co, w_off, b_off))
        w_off += co * ci
        b_off += co
    w = torch.cat([w.detach().reshape(-1) for w, _ in mats]).to(device=device, dtype=dtype)
    b = torch.cat([b.detach().reshape(-1) for _, b in mats]).to(device=device, dtype=torch.float32)
    return PackedChain(w.contiguous(), b.contiguous(), np.asarray(specs, dtype=np.int32), len(layers))


def _level_input(prev, pos_t, pose, dtype):
    n, hw = pose.shape[0], pos_t.shape[1]
    parts = [] if prev is None else [prev.to(dtype)]
    parts.append(pos_t.to(dtype)[None].expand(n, 2, hw))
    parts.append(pose.float().to(dtype)[:, :, None].expand(n, pose.shape[1], hw))
    return torch.cat(parts, dim=1)


def chain_t_plain(
    prev: Optional[torch.Tensor],
    pos_t: torch.Tensor,
    pose: torch.Tensor,
    chain: PackedChain,
    omega: float = 30.0,
) -> torch.Tensor:
    """The plain PyTorch version of K1: (N, Cp, HW) -> (N, Cout, HW).

    Compute-dtype operands, f32 products and sums, f32 bias added before the
    omega multiply, activations stored in the compute dtype between layers,
    output in the compute dtype."""
    dtype = chain.dtype
    h = _level_input(prev, pos_t, pose, dtype)
    for i in range(chain.num_layers):
        w, b = chain.layer(i)
        acc = torch.matmul(w.float(), h.float()) + b[:, None]
        h = (fast_sin(omega * acc) if i < chain.num_sine else acc).to(dtype)
    return h


def sine_chain_t(
    prev: Optional[torch.Tensor],
    pos_t: torch.Tensor,
    pose: torch.Tensor,
    chain: PackedChain,
    omega: float = 30.0,
) -> torch.Tensor:
    """One SIREN level, channels-first.

    prev (N, Cp, HW) in the compute dtype or None; pos_t (2, HW) in the
    compute dtype; pose (N, P) f32; returns (N, Cout, HW) in the compute
    dtype.  CPU tensors take ``chain_t_plain``; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    if pos_t.device.type == "cpu":
        return chain_t_plain(prev, pos_t, pose, chain, omega)
    if pos_t.device.type != "cuda":
        raise ValueError(f"sine_chain_t: unsupported device {pos_t.device}")
    _check(prev, pos_t, pose, chain)
    n, hw = pose.shape[0], pos_t.shape[1]
    out = torch.empty((n, chain.out_channels, hw), dtype=chain.dtype, device=pos_t.device)
    stream = torch.cuda.current_stream(pos_t.device).cuda_stream
    status = cuda_build.library().tha4_sine_chain_forward(
        None if prev is None else prev.data_ptr(), int(prev is not None),
        0 if prev is None else prev.shape[1],
        pos_t.data_ptr(), pose.data_ptr(), pose.shape[1],
        chain.w.data_ptr(), chain.b.data_ptr(), chain.specs.ctypes.data,
        chain.num_layers, chain.num_sine, float(omega), out.data_ptr(), n, hw,
        int(chain.dtype == torch.bfloat16), stream,
    )
    cuda_build.check(status, "sine_chain_t")
    sine_chain_t.launches += 1
    return out


sine_chain_t.launches = 0


def _check(prev, pos_t, pose, chain: PackedChain) -> None:
    device, dtype = pos_t.device, chain.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    tensors = {"pos_t": pos_t, "pose": pose, "chain.w": chain.w, "chain.b": chain.b}
    if prev is not None:
        tensors["prev"] = prev
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, pos_t on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pos_t.dim() != 2 or pos_t.shape[0] != 2 or pos_t.dtype != dtype:
        raise ValueError(f"pos_t must be (2, HW) {dtype}, got {tuple(pos_t.shape)} {pos_t.dtype}")
    if chain.b.dtype != torch.float32:
        raise ValueError(f"chain.b must be float32, got {chain.b.dtype}")
    last_ci, last_co, last_w, last_b = (int(v) for v in chain.specs[-1])
    if chain.w.numel() != last_w + last_co * last_ci or chain.b.numel() != last_b + last_co:
        raise ValueError("chain.w / chain.b sizes do not match chain.specs")
    if pose.dim() != 2 or pose.dtype != torch.float32:
        raise ValueError(f"pose must be (N, P) float32, got {tuple(pose.shape)} {pose.dtype}")
    cp = 0
    if prev is not None:
        if prev.dim() != 3 or prev.shape[0] != pose.shape[0] or prev.shape[2] != pos_t.shape[1]:
            raise ValueError(f"prev must be (N, Cp, HW), got {tuple(prev.shape)}")
        if prev.dtype != dtype:
            raise ValueError(f"prev dtype {prev.dtype} != compute dtype {dtype}")
        cp = prev.shape[1]
    ci0 = int(chain.specs[0, 0])
    if ci0 != cp + 2 + pose.shape[1]:
        raise ValueError(f"first layer takes {ci0} channels, level input has {cp + 2 + pose.shape[1]}")
