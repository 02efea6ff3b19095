"""K1 and K4: the fused SIREN level and its backward
(counterpart of ``tha4_tpu/ops/pallas_siren.py``).

A SIREN level is a chain of 1x1-conv sine layers over a pixel grid,
channels-first: the level input is h = [prev | pos_x, pos_y | pose] per
pixel, each sine layer is h <- fast_sin(omega * (W h + b)), and the last
body level ends in a head linear without a sine.

``sine_chain_t`` launches the CUDA kernel in ``csrc/sine_chain.cu`` (K1) for
CUDA tensors and runs ``chain_t_plain`` for CPU tensors;
``sine_chain_t_bwd`` launches ``csrc/sine_chain_bwd.cu`` (K4) or runs
``chain_t_bwd_plain`` the same way.  ``SineChainFunction`` ties the two
into a ``torch.autograd.Function`` over f32 master weights, for training.

Precision rule (``tha4_tpu/ops/pallas_util.py:kernel_dot_precision``):
  * float32 means full-f32 products: no TF32 anywhere;
  * bfloat16 means bf16 operands (weights, activations, pos, pose) with f32
    accumulation and f32 bias.  ``chain_t_plain`` emulates that exactly by
    upcasting the bf16 operands to f32 before an f32 matmul: a product of
    two bf16 values is exact in f32.

Weights are packed once per poser and dtype (``pack_chain``): each layer's
(Co, Ci) matrix, which is the squeezed 1x1-conv weight as stored, flattened
into one buffer in the compute dtype, and the biases into one f32 buffer.
The chain also carries the same weights in its K1 kernel's layout, made by
one gather (``tile_layout``): in bf16 the tensor-core kernels' tiles
(``tile_index``; csrc/sine_chain_tc.cuh), in f32 the CUDA-core kernel's
weight-stage images (csrc/sine_chain.cu).

Two designs per kernel: bf16 runs on the tensor cores (``wgmma``, the
``tha4_sine_chain_tc_*`` entry points), f32 on the CUDA cores (no TF32).
The bf16 kernels fold layer 0's pose columns and bias into one f32 vector
per batch element and its position columns into two FMAs: the same exact
products as the plain versions, summed in another order.
"""

from __future__ import annotations

import ctypes
import functools
import math
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


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) = fast_sin(x + pi/2), as ``pallas_siren._fast_cos``: the
    backward's stand-in for the polynomial's own derivative (they differ by
    ~1e-6, the polynomial's fit error)."""
    return fast_sin(x.float() + math.pi / 2)


@dataclass(frozen=True)
class PackedChain:
    """One SIREN level's weights, packed for ``sine_chain_t``.

    ``w``: every layer's (Co, Ci) matrix, row-major, concatenated, in the
    compute dtype.  ``b``: the biases concatenated, f32.  ``specs``: one
    (ci, co, w_offset, b_offset) row per layer, int32, on the host.  The
    first ``num_sine`` layers have a sine; a remaining last layer is the head.
    ``tiles``: ``w`` in the K1 kernel's weight layout for the dtype
    (``tile_layout``).
    """

    w: torch.Tensor
    b: torch.Tensor
    specs: np.ndarray
    num_sine: int
    tiles: Optional[torch.Tensor] = None

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
    specs = chain_specs([tuple(w.shape) for w, _ in mats])
    w = torch.cat([w.detach().reshape(-1) for w, _ in mats]).to(device=device, dtype=dtype).contiguous()
    b = torch.cat([b.detach().reshape(-1) for _, b in mats]).to(device=device, dtype=torch.float32)
    return PackedChain(w, b.contiguous(), specs, len(layers), tile_layout(w, specs))


_TILE_N = 128  # csrc/sine_chain_tc.cuh kNChunk: output rows of a weight tile
_TILE_K = 64  # kKBlock: input columns of a weight tile


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


@functools.lru_cache(maxsize=64)
def _tile_index(spec_rows: Tuple[Tuple[int, ...], ...]) -> np.ndarray:
    last_ci, last_co, last_w, _ = spec_rows[-1]
    zero = last_w + last_co * last_ci  # the index of the appended 0
    mats = []
    for ci, co, wo, _ in spec_rows:
        m = np.full((_pad16(co), _pad16(ci)), zero, dtype=np.int64)
        m[:co, :ci] = wo + np.arange(co)[:, None] * ci + np.arange(ci)[None, :]
        mats.append(m)
    parts = []
    for m in mats + [m.T for m in reversed(mats)]:
        rows, cols = m.shape
        for n0 in range(0, rows, _TILE_N):
            nb = min(_TILE_N, rows - n0)
            for k0 in range(0, cols, _TILE_K):
                kb = min(_TILE_K, cols - k0)
                parts.append(m[n0 : n0 + nb, k0 : k0 + kb].reshape(nb, kb // 8, 8).transpose(1, 0, 2).ravel())
    return np.concatenate(parts)


def tile_index(specs: np.ndarray) -> np.ndarray:
    """The tensor-core kernels' weight layout as indices into the packed
    weights with one 0 appended (index ``w.numel()``).

    Per layer, the (Co, Ci) matrix padded to multiples of 16 and cut into
    tiles of up to 128 rows x 64 columns, row chunks outer, column blocks
    inner; each tile stored [column group of 8][rows][8], the shared-memory
    image of ``wgmma``'s K-major B operand.  First every layer's W (the
    forward, K1), then every layer's W^T from the last (the backward, K4)."""
    return _tile_index(tuple(tuple(int(v) for v in row) for row in specs))


@functools.lru_cache(maxsize=64)
def _tile_index_tensor(spec_bytes: bytes, f32: bool, device) -> torch.Tensor:
    rows = tuple(tuple(int(v) for v in row) for row in _spec_rows(spec_bytes))
    return torch.from_numpy(_f32_stage_index(spec_bytes) if f32 else _tile_index(rows)).to(device)


def tile_layout(w: torch.Tensor, specs: np.ndarray) -> Optional[torch.Tensor]:
    """``w`` in its K1 kernel's weight layout, one gather: bf16 in the
    tensor-core kernels' tile layout (``tile_index``); f32 as the CUDA-core
    kernel's stage images (csrc/sine_chain.cu): for every layer, every pass
    of ``_f32_pass_channels`` output channels at the chain's ``f32_plan``
    tile and every ``_F32_KC`` input channels, W^T's rows k of that block,
    each padded with zeros to the pass's channels plus 4, zero rows past
    the layer's input channels.  None for an f32 chain no tile fits."""
    f32 = w.dtype == torch.float32
    spec_bytes = specs.tobytes()
    if f32 and _f32_tile(spec_bytes) is None:
        return None  # no tile fits: sine_chain_t raises with f32_plan's reason
    index = _tile_index_tensor(spec_bytes, f32, w.device)
    return torch.cat([w, w.new_zeros(1)])[index]


# csrc/sine_chain.cu, the f32 kernel: threads a block, pixels and output
# channels a thread, input channels a weight stage, the depth activation
# rows are padded to, and the pixel tiles it is built for, in the order the
# plan tries them.
_F32_THREADS, _F32_TM, _F32_TN, _F32_KC, _F32_KSTEP = 256, 4, 8, 32, 8
_F32_TILES = (64, 32)
_SMEM_LIMIT = 232448  # 227 KB, the most one block may use on Hopper


def _f32_pass_channels(tile: int) -> int:
    """Output channels of one pass of the f32 kernel at ``tile`` pixels."""
    return _F32_THREADS // (tile // _F32_TM) * _F32_TN


def f32_smem_bytes(tile: int, rows: int) -> int:
    """Shared memory of one block of the f32 K1 (csrc/sine_chain.cu
    smem_bytes): two activation buffers of ``rows`` x ``tile`` floats and two
    weight stages of ``_F32_KC`` rows of one pass's channels, padded by 4."""
    return 4 * (2 * rows * tile + 2 * _F32_KC * (_f32_pass_channels(tile) + 4))


def _spec_rows(spec_bytes: bytes) -> np.ndarray:
    return np.frombuffer(spec_bytes, dtype=np.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def _f32_tile(spec_bytes: bytes) -> Optional[Tuple[int, int]]:
    specs = _spec_rows(spec_bytes)
    widest = int(max(specs[0, 0], specs[:, 1].max()))
    rows = -(-widest // _F32_KSTEP) * _F32_KSTEP
    for tile in _F32_TILES:
        smem = f32_smem_bytes(tile, rows)
        if smem <= _SMEM_LIMIT:
            return tile, smem
    return None


def f32_plan(specs: np.ndarray) -> Tuple[int, int]:
    """The f32 K1's plan for a chain: (pixels a block, shared memory bytes a
    block).  The tile is the first of ``_F32_TILES`` whose two activation
    buffers (rows: the chain's widest layer or level input, padded to 8)
    and two weight stages fit one Hopper block; raises where none does."""
    plan = _f32_tile(specs.tobytes())
    if plan is None:
        widest = int(max(specs[0, 0], specs[:, 1].max()))
        need = f32_smem_bytes(_F32_TILES[-1], -(-widest // _F32_KSTEP) * _F32_KSTEP)
        raise ValueError(f"sine_chain_t: a {widest}-channel f32 chain needs {need} bytes of shared memory per block "
                         f"at the smallest tile ({_F32_TILES[-1]} pixels), over the {_SMEM_LIMIT} a Hopper block "
                         "may use")
    return plan


@functools.lru_cache(maxsize=64)
def _f32_stage_index(spec_bytes: bytes) -> np.ndarray:
    specs = _spec_rows(spec_bytes)
    cols = _f32_pass_channels(_f32_tile(spec_bytes)[0])
    last_ci, last_co, last_w, _ = (int(v) for v in specs[-1])
    zero = last_w + last_co * last_ci  # the index of the appended 0
    parts = []
    for ci, co, wo, _ in (tuple(int(v) for v in row) for row in specs):
        for o0 in range(0, co, cols):
            for k0 in range(0, ci, _F32_KC):
                image = np.full((_F32_KC, cols + 4), zero, dtype=np.int64)
                o = np.arange(o0, min(o0 + cols, co))
                k = np.arange(k0, min(k0 + _F32_KC, ci))
                image[: len(k), : len(o)] = wo + o[None, :] * ci + k[:, None]
                parts.append(image.ravel())
    return np.concatenate(parts)


def f32_layout_elems(specs: np.ndarray) -> int:
    """The floats of a chain's f32 stage layout (``tile_layout``)."""
    return int(_f32_stage_index(specs.tobytes()).size)


def chain_specs(shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """The (ci, co, w_offset, b_offset) rows of a chain of (Co, Ci) layers
    packed one after the other."""
    if len(shapes) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers per chain, got {len(shapes)}")
    specs = []
    w_off = b_off = 0
    for co, ci in shapes:
        specs.append((ci, co, w_off, b_off))
        w_off += co * ci
        b_off += co
    return np.asarray(specs, dtype=np.int32)


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
    n, hw, cp = pose.shape[0], pos_t.shape[1], 0 if prev is None else prev.shape[1]
    out = torch.empty((n, chain.out_channels, hw), dtype=chain.dtype, device=pos_t.device)
    stream = cuda_build.current_stream(pos_t.device)
    lib = cuda_build.library()
    prev_ptr = None if prev is None else prev.data_ptr()
    if chain.dtype == torch.bfloat16:
        _tc_plan(chain, cp, pose.shape[1], n, hw, pos_t.device, backward=False)
        fold = torch.empty((n, int(chain.specs[0, 1])), dtype=torch.float32, device=pos_t.device)
        status = lib.tha4_sine_chain_tc_forward(
            prev_ptr, cp, pos_t.data_ptr(), pose.data_ptr(), pose.shape[1], chain.w.data_ptr(), chain.b.data_ptr(),
            chain.tiles.data_ptr(), chain.specs.ctypes.data, chain.num_layers, chain.num_sine, float(omega),
            out.data_ptr(), fold.data_ptr(), n, hw, stream,
        )
    else:
        tile, _ = f32_plan(chain.specs)
        tiles = chain.tiles
        if tiles is None or tiles.numel() != f32_layout_elems(chain.specs) or tiles.device != pos_t.device:
            raise ValueError(f"sine_chain_t: chain.tiles is not this chain's f32 stage layout on {pos_t.device} "
                             "(tile_layout)")
        status = lib.tha4_sine_chain_forward(
            prev_ptr, int(prev is not None), cp, pos_t.data_ptr(), pose.data_ptr(), pose.shape[1],
            tiles.data_ptr(), tiles.numel(), chain.b.data_ptr(), chain.specs.ctypes.data,
            chain.num_layers, chain.num_sine, float(omega), out.data_ptr(), n, hw, tile, stream,
        )
    cuda_build.check(status, "sine_chain_t")
    sine_chain_t.launches += 1
    return out


sine_chain_t.launches = 0


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan(spec_bytes: bytes, num_sine: int, cp: int, pose_dim: int, n: int, hw: int, sms: int) -> Tuple[int, ...]:
    plan = (ctypes.c_longlong * 5)()
    specs = np.frombuffer(spec_bytes, dtype=np.int32)
    status = cuda_build.library().tha4_sine_chain_tc_plan(
        specs.ctypes.data, len(specs) // 4, num_sine, cp, pose_dim, n, hw, sms, plan)
    cuda_build.check(status, "sine_chain_tc_plan")
    return tuple(plan)


def _tc_plan(chain: PackedChain, cp: int, pose_dim: int, n: int, hw: int, device, backward: bool) -> Tuple[int, ...]:
    """The bf16 kernels' plan (csrc/sine_chain.cu tha4_sine_chain_tc_plan):
    (K1 shared memory, K4 shared memory, K1 and K4 layout elements, K4
    workspace bytes).  Raises where a block would need more shared memory
    than Hopper has, or where ``chain.tiles`` is not the layout the kernels
    read."""
    plan = _plan(chain.specs.tobytes(), chain.num_sine, cp, pose_dim, n, hw, _sm_count(device.index))
    smem = plan[1] if backward else plan[0]
    name = "sine_chain_t_bwd" if backward else "sine_chain_t"
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: this chain needs {smem} bytes of shared memory per block, "
                         f"over the {_SMEM_LIMIT} a Hopper block may use")
    if chain.tiles is None or chain.tiles.numel() != plan[3] or chain.tiles.device != device:
        raise ValueError(f"{name}: chain.tiles is not this chain's tile layout on {device} (tile_layout)")
    return plan


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


# ---------------------------------------------------------------------------
# K4: the backward (counterpart of pallas_siren.fused_sine_chain_t_bwd)
# ---------------------------------------------------------------------------

_BWD_TILE = 32  # csrc/sine_chain_bwd.cu kTile (the f32 kernel)


def chain_t_bwd_plain(
    prev: Optional[torch.Tensor],
    pos_t: torch.Tensor,
    pose: torch.Tensor,
    chain: PackedChain,
    g: torch.Tensor,
    omega: float = 30.0,
):
    """The plain PyTorch version of K4.  g (N, Cout, HW) is the cotangent of
    ``chain_t_plain``'s output; returns (dprev or None, dpose (N, P) f32,
    dw, db), dw and db f32 in ``chain.w`` / ``chain.b``'s packed layout.

    The TPU kernel's rules: recompute the forward; per layer
    g_a = g * (omega * fast_cos(omega * a)) (g for the head), db = sum of
    g_a in f32, then g_a rounded to the compute dtype for dW = g_a h^T and
    g <- W^T g_a (exact products of compute-dtype values, f32 sums); dprev in
    prev's dtype; the position rows' gradient is dropped."""
    dtype = chain.dtype
    h = _level_input(prev, pos_t, pose, dtype)
    inputs, pre = [], []
    for i in range(chain.num_sine):
        w, b = chain.layer(i)
        inputs.append(h)
        pre.append(torch.matmul(w.float(), h.float()) + b[:, None])
        h = fast_sin(omega * pre[-1]).to(dtype)
    if chain.num_layers > chain.num_sine:
        inputs.append(h)
    g = g.float()
    dws, dbs = [], []
    for i in reversed(range(chain.num_layers)):
        w, _ = chain.layer(i)
        ga = g * (omega * fast_cos(omega * pre[i])) if i < chain.num_sine else g
        dbs.append(ga.sum(dim=(0, 2)))
        ga = ga.to(dtype).float()
        dws.append(torch.einsum("nop,nip->oi", ga, inputs[i].float()).reshape(-1))
        g = torch.matmul(w.float().T, ga)
    cp = 0 if prev is None else prev.shape[1]
    dprev = None if prev is None else g[:, :cp].to(prev.dtype)
    dpose = g[:, cp + 2 :].sum(dim=2)
    return dprev, dpose, torch.cat(dws[::-1]), torch.cat(dbs[::-1])


def bwd_smem_bytes(chain: PackedChain, cin: int) -> int:
    """Shared memory one block of the f32 K4 needs: every sine layer's f32
    pre-activations plus three C_max-row buffers, 33 words a row."""
    stash = int(chain.specs[: chain.num_sine, 1].sum())
    cmax = max([cin] + [int(c) for c in chain.specs[:, 1]])
    return (stash + 3 * cmax) * (_BWD_TILE + 1) * 4


def sine_chain_t_bwd(
    prev: Optional[torch.Tensor],
    pos_t: torch.Tensor,
    pose: torch.Tensor,
    chain: PackedChain,
    g: torch.Tensor,
    omega: float = 30.0,
):
    """The backward of ``sine_chain_t``: (dprev or None, dpose, dw, db) as
    ``chain_t_bwd_plain`` returns them.  CPU tensors take the plain version;
    CUDA tensors launch K4, and anything it does not take raises.  dw, db and
    dpose are views of one f32 buffer."""
    if pos_t.device.type == "cpu":
        return chain_t_bwd_plain(prev, pos_t, pose, chain, g, omega)
    if pos_t.device.type != "cuda":
        raise ValueError(f"sine_chain_t_bwd: unsupported device {pos_t.device}")
    _check(prev, pos_t, pose, chain)
    n, hw, pose_dim = pose.shape[0], pos_t.shape[1], pose.shape[1]
    if g.shape != (n, chain.out_channels, hw) or g.dtype != chain.dtype or g.device != pos_t.device:
        raise ValueError(f"g must be ({n}, {chain.out_channels}, {hw}) {chain.dtype} on {pos_t.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if chain.num_sine < chain.num_layers - 1:
        raise ValueError("K4 takes sine layers and at most one head")
    cp = 0 if prev is None else prev.shape[1]
    device = pos_t.device
    w_total, b_total = chain.w.numel(), chain.b.numel()
    grads = torch.empty(w_total + b_total + n * pose_dim, dtype=torch.float32, device=device)
    dprev = None if prev is None else torch.empty_like(prev)
    stream = cuda_build.current_stream(device)
    lib = cuda_build.library()
    prev_ptr = None if prev is None else prev.data_ptr()
    dprev_ptr = None if dprev is None else dprev.data_ptr()
    sms = _sm_count(device.index)
    if chain.dtype == torch.bfloat16:
        plan = _tc_plan(chain, cp, pose_dim, n, hw, device, backward=True)
        workspace = torch.empty(plan[4], dtype=torch.uint8, device=device)
        status = lib.tha4_sine_chain_tc_backward(
            prev_ptr, cp, pos_t.data_ptr(), pose.data_ptr(), pose_dim, chain.w.data_ptr(), chain.b.data_ptr(),
            chain.tiles.data_ptr(), chain.specs.ctypes.data, chain.num_layers, chain.num_sine, float(omega),
            g.data_ptr(), dprev_ptr, workspace.data_ptr(), workspace.numel(), grads.data_ptr(), n, hw, sms, stream,
        )
    else:
        smem = bwd_smem_bytes(chain, cp + 2 + pose_dim)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"sine_chain_t_bwd: this chain needs {smem} bytes of shared memory per block, "
                             f"over the {_SMEM_LIMIT} a Hopper block may use")
        # One persistent block per SM; the grid size fixes the order of every sum.
        blocks = min(n * -(-hw // _BWD_TILE), sms)
        scratch = torch.empty((blocks, grads.numel()), dtype=torch.float32, device=device)
        status = lib.tha4_sine_chain_backward(
            prev_ptr, int(prev is not None), cp, pos_t.data_ptr(), pose.data_ptr(), pose_dim,
            chain.w.data_ptr(), chain.b.data_ptr(), chain.specs.ctypes.data,
            chain.num_layers, chain.num_sine, float(omega), g.data_ptr(),
            dprev_ptr, scratch.data_ptr(), blocks, grads.data_ptr(), n, hw, stream,
        )
    cuda_build.check(status, "sine_chain_t_bwd")
    sine_chain_t_bwd.launches += 1
    dpose = grads[w_total + b_total :].view(n, pose_dim)
    return dprev, dpose, grads[:w_total], grads[w_total : w_total + b_total]


sine_chain_t_bwd.launches = 0


class SineChainFunction(torch.autograd.Function):
    """One SIREN level with K1 as its forward and K4 as its backward.

    It takes the f32 master weights (``w32``, ``b32`` in the packed layout of
    ``specs``) and casts them to the compute dtype inside (in bf16 also to
    the tile layout, one gather a step), so the weight
    gradients come back f32 whatever the compute dtype, as JAX's do
    (``pallas_siren.py:500-501``).  No gradient flows to ``pos_t``."""

    @staticmethod
    def forward(ctx, w32, b32, prev, pos_t, pose, specs, num_sine, omega, dtype):
        w = w32.to(dtype).contiguous()
        chain = PackedChain(w, b32.contiguous(), specs, num_sine, tile_layout(w, specs))
        ctx.chain, ctx.omega = chain, omega
        ctx.save_for_backward(prev, pos_t, pose)
        return sine_chain_t(prev, pos_t, pose, chain, omega)

    @staticmethod
    def backward(ctx, g):
        prev, pos_t, pose = ctx.saved_tensors
        dprev, dpose, dw, db = sine_chain_t_bwd(prev, pos_t, pose, ctx.chain, g.contiguous(), ctx.omega)
        return dw, db, dprev, None, dpose, None, None, None, None


def sine_chain_t_train(
    prev: Optional[torch.Tensor],
    pos_t: torch.Tensor,
    pose: torch.Tensor,
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    head: Optional[Tuple[torch.Tensor, torch.Tensor]],
    dtype: torch.dtype,
    omega: float = 30.0,
) -> torch.Tensor:
    """Differentiable ``sine_chain_t`` over f32 (W (Co, Ci), b) parameters:
    one K1 launch forward, one K4 launch backward (their plain versions on
    the CPU)."""
    mats = list(layers) + ([head] if head is not None else [])
    w32 = torch.cat([w.reshape(-1) for w, _ in mats])
    b32 = torch.cat([b.reshape(-1) for _, b in mats])
    specs = chain_specs([tuple(w.shape) for w, _ in mats])
    return SineChainFunction.apply(w32, b32, prev, pos_t, pose, specs, len(layers), omega, dtype)
