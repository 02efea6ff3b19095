"""K6: the pre-activated 3x3 convolution of the U-Nets' ResBlocks
(counterpart of ``tha4_tpu/ops/pallas_conv.py``), and its fold.

    out = conv3x3(SiLU(x * scale + shift)) + bias [+ skip | + skip_w @ skip]

``scale`` and ``shift`` are per (n, c): a GroupNorm and the FiLM chain after
it folded together (``fold_groupnorm_film``), so one pass over ``x`` does the
norm's affine, both FiLMs, the SiLU, the convolution, its bias and the
residual.  The 3x3 weight travels in the JAX package's ``w9`` layout,
(Cout, 9 * Cin) with k ordered (dy, dx, ci) (``to_w9``).

Layout: ``x`` is logically NCHW, as at the JAX function, and lies in memory
channels last: the U-Net's NHWC activations are passed as
``h.permute(0, 3, 1, 2)`` (as ``ops.nn.conv_nhwc`` does) and the result comes
back the same way.  The kernel needs those strides and the wrapper checks
them.

``fused_affine_conv3_nchw`` launches the CUDA kernel in
``csrc/affine_conv3.cu`` for CUDA tensors (bf16 on ``wgmma``, f32 with FMAs
on the CUDA cores, never TF32) and runs ``fused_affine_conv3_plain``, the
plain PyTorch version, for CPU tensors; anything the kernel does not take
raises.  The kernel reads ``w9`` and ``skip_w`` in a device layout
(``device_weight_layout``): a frozen U-Net keeps it beside each conv
(``Unet.store_w9``) and passes it in; otherwise the wrapper lays the
weights out for the call.  ``fold_groupnorm_film`` likewise
launches ``csrc/group_norm_fold.cu`` (two launches: one pass of statistics
over ``x``, then the affine and the FiLMs) for CUDA tensors and runs
``fold_groupnorm_film_plain`` for CPU ones.  Neither has a gradient on
either device: each refuses an input that requires one while grad mode is
on (the teacher is frozen, and a silently dropped gradient is a fault).

K7 (``tha4_tpu/ops/pallas_packed_conv.py:fused_packed_conv3``) computes the
same function on the TPU's lane-packed layout (N, H, W/f, f*C), a reshape of
contiguous NHWC; its counterpart here is K6 on the NHWC view.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tha4_tpu_torch.ops import cuda_build, wide

_SKIP_NONE, _SKIP_IDENTITY, _SKIP_CONV = 0, 1, 2
# Input channels per chunk of K6's device weight layout (CK in
# csrc/affine_conv3.cu).
CK = 16


def to_w9(w_hwio: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> (Cout, 9 * Cin), k-major: (dy, dx, ci)."""
    kh, kw, ci, co = w_hwio.shape
    assert kh == 3 and kw == 3
    w = w_hwio.permute(3, 0, 1, 2).reshape(co, kh * kw * ci)
    return w.to(dtype) if dtype is not None else w


def fold_groupnorm_film_plain(
    x: torch.Tensor,
    num_groups: int,
    gn_scale: torch.Tensor,
    gn_bias: torch.Tensor,
    film: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    condition_bias: float = 1.0,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, c) (scale, shift), f32 (f64 for an f64 ``x``), such that
    ``x * scale + shift`` is GroupNorm(x) with its affine, then each FiLM
    ``y -> y * (condition_bias + f_scale) + f_shift`` in turn: the plain
    version of ``csrc/group_norm_fold.cu``.

    The statistics are f32 and centred (``torch.var_mean``), as
    ``ops.nn.group_norm`` takes them in f32, not the E[x^2] - mean^2 of
    ``pallas_conv.py:71``, which cancels badly in f32 for large means."""
    n, c, h, w = x.shape
    g = num_groups
    xf = wide(x).reshape(n, g, c // g, h, w)
    var, mean = torch.var_mean(xf, dim=(2, 3, 4), correction=0)  # (N, G)
    dt = xf.dtype
    r_c = torch.rsqrt(var + eps).repeat_interleave(c // g, dim=1)
    mean_c = mean.repeat_interleave(c // g, dim=1)
    a = gn_scale.to(dt)[None, :].expand(n, c)
    b = gn_bias.to(dt)[None, :].expand(n, c)
    for f_scale, f_shift in film:
        m = condition_bias + f_scale.to(dt)
        a = a * m
        b = b * m + f_shift.to(dt)
    scale = a * r_c
    return scale, b - mean_c * scale


def fold_groupnorm_film(
    x: torch.Tensor,
    num_groups: int,
    gn_scale: torch.Tensor,
    gn_bias: torch.Tensor,
    film: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    condition_bias: float = 1.0,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, c) (scale, shift) of a GroupNorm and the FiLMs after it, as
    ``fold_groupnorm_film_plain`` computes them.

    x (N, C, H, W) in channels-last memory.  CPU tensors take the plain
    version; CUDA tensors (x f32 or bf16, at most two FiLMs) launch the
    fold's two kernels, which read ``x`` once in its own dtype; anything they
    do not take raises."""
    film = tuple(film)
    tensors = (x, gn_scale, gn_bias, *(t for pair in film for t in pair))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fold_groupnorm_film has no gradient: run it under torch.no_grad() on a frozen network")
    if x.device.type == "cpu":
        return fold_groupnorm_film_plain(x, num_groups, gn_scale, gn_bias, film, condition_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fold_groupnorm_film: unsupported device {x.device}")
    n, c, h, w = x.shape
    is_bf16 = int(x.dtype == torch.bfloat16)
    if x.dtype not in (torch.float32, torch.bfloat16) or not _channels_last(x) or x.data_ptr() % 16:
        raise ValueError(f"fold_groupnorm_film: x must be 16-byte aligned f32 or bf16 lying channels last, got {x.dtype}")
    if len(film) > 2:
        raise ValueError(f"fold_groupnorm_film: the CUDA fold takes at most two FiLMs, got {len(film)}")
    blocks = _fold_blocks(n, h * w, c, num_groups, is_bf16)
    gamma, beta = (t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous() for t in (gn_scale, gn_bias))
    film_dtype = film[0][0].dtype if film else torch.float32
    rows = []
    for pair in film:
        for t in pair:
            if t.dtype != film_dtype or t.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"fold_groupnorm_film: FiLM terms must share one dtype, f32 or bf16, got {t.dtype} and {film_dtype}")
            if t.shape != (n, c) or t.stride(1) != 1:
                raise ValueError(f"fold_groupnorm_film: a FiLM term must be ({n}, {c}) with unit channel stride, got {tuple(t.shape)}")
            rows += [t.data_ptr(), t.stride(0)]
    for t in (gamma, beta, *(t for pair in film for t in pair)):
        if t.device != x.device:
            raise ValueError(f"fold_groupnorm_film: a tensor on {t.device}, x on {x.device}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"fold_groupnorm_film: the norm's affine must be ({c},)")
    rows += [None, 0] * (4 - len(rows) // 2)
    workspace = torch.empty((n * blocks * num_groups * 3,), dtype=torch.float32, device=x.device)
    scale = torch.empty((n, c), dtype=torch.float32, device=x.device)
    shift = torch.empty_like(scale)
    status = cuda_build.library().tha4_group_norm_fold(
        x.data_ptr(), n, h * w, c, num_groups, is_bf16, gamma.data_ptr(), beta.data_ptr(), *rows, len(film),
        int(film_dtype == torch.bfloat16), float(condition_bias), float(eps), workspace.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), cuda_build.current_stream(x.device),
    )
    cuda_build.check(status, "fold_groupnorm_film")
    fold_groupnorm_film.launches += 1
    return scale, shift


fold_groupnorm_film.launches = 0


@functools.lru_cache(maxsize=None)
def _fold_blocks(n: int, hw: int, c: int, groups: int, is_bf16: int) -> int:
    """Blocks per image of the fold's statistics pass, per size."""
    blocks = cuda_build.library().tha4_group_norm_fold_blocks(n, hw, c, groups, is_bf16)
    if blocks < 1:
        raise ValueError(f"fold_groupnorm_film: sizes the CUDA fold does not take (C = {c}, {groups} groups; C a "
                         f"multiple of {8 if is_bf16 else 4} and at most 2048)")
    return blocks


def fused_affine_conv3_plain(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor],
    w9: torch.Tensor,
    bias: torch.Tensor,
    skip: Optional[torch.Tensor] = None,
    skip_w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version, in the kernel's arithmetic: ``x * scale + shift``
    and the SiLU in f32, rounded once to ``x``'s dtype (``pallas_conv.py:117``);
    zero padding after the activation, since SiLU(shift) != 0
    (``pallas_conv.py:118-126``); the convolution in f32 on those operands;
    bias and skip added in f32, then one rounding to ``x``'s dtype.  An f64
    ``x`` stays in f64 throughout."""
    dt = wide(x).dtype
    co, k9 = w9.shape
    c = k9 // 9
    if scale is None:
        act = x
    else:
        v = x.to(dt) * scale.to(dt)[:, :, None, None] + shift.to(dt)[:, :, None, None]
        act = F.silu(v).to(x.dtype)
    w = w9.reshape(co, 3, 3, c).permute(0, 3, 1, 2).to(dt)
    out = F.conv2d(act.to(dt), w, bias.to(dt), padding=1)
    if skip is not None:
        if skip_w is None:
            out = out + skip.to(dt)
        else:
            out = out + F.conv2d(skip.to(dt), skip_w.to(dt)[:, :, None, None])
    return out.to(x.dtype)


def fused_affine_conv3_nchw(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor],
    w9: torch.Tensor,
    bias: torch.Tensor,
    skip: Optional[torch.Tensor] = None,
    skip_w: Optional[torch.Tensor] = None,
    layout: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """conv3(silu(x * scale + shift)) + bias [+ skip or skip_w @ skip].

    x (N, C, H, W) in channels-last memory, f32 or bf16; scale, shift (N, C)
    f32, or both None for no pre-activation; w9 (Cout, 9 * C); bias (Cout,),
    the 1x1 skip's own bias folded in; skip (N, Cs, H, W) channels last in
    x's dtype, Cs = Cout for the identity; skip_w (Cout, Cs) or None;
    ``layout``: w9 and skip_w in K6's device layout in x's dtype
    (``device_weight_layout`` at ``layout_block(Cout, dtype)``), or None to
    lay them out for this call.  Returns (N, Cout, H, W) in x's dtype,
    channels last.  CPU tensors take the plain version (which reads w9 and
    skip_w); CUDA tensors launch K6."""
    tensors = (x, scale, shift, w9, bias, skip, skip_w, layout)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("fused_affine_conv3_nchw has no gradient: run it under torch.no_grad() on a frozen network")
    if x.device.type == "cpu":
        return fused_affine_conv3_plain(x, scale, shift, w9, bias, skip, skip_w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_affine_conv3_nchw: unsupported device {x.device}")
    n, c, h, w = x.shape
    co = w9.shape[0]
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    mode = _SKIP_NONE if skip is None else (_SKIP_IDENTITY if skip_w is None else _SKIP_CONV)
    _check(x, scale, shift, w9, bias, skip, skip_w)
    dims = (n, h, w, c, co, 0 if skip is None else skip.shape[1], mode, int(x.dtype == torch.bfloat16))
    # Small grids split the channel chunks among blocks, which sum into a
    # workspace of f32 partials (added in a fixed order: deterministic).
    splits, bn, ck, elems = _plan(*dims)
    if layout is None:
        layout = device_weight_layout(w9, skip_w, bn, ck, x.dtype)
    elif (layout.dtype != x.dtype or layout.numel() != elems or layout.device != x.device or not layout.is_contiguous()
          or layout.data_ptr() % 16):
        raise ValueError(f"fused_affine_conv3_nchw: layout must be the contiguous, 16-byte aligned device layout of "
                         f"{elems} elements in {x.dtype}, got {layout.numel()} in {layout.dtype}")
    workspace = torch.empty((splits, n, h, w, co), dtype=torch.float32, device=x.device) if splits > 1 else None
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    status = cuda_build.library().tha4_affine_conv3_forward(
        x.data_ptr(), None if scale is None else scale.data_ptr(), None if shift is None else shift.data_ptr(),
        layout.data_ptr(), bias.data_ptr(), None if skip is None else skip.data_ptr(), out.data_ptr(), *dims,
        None if workspace is None else workspace.data_ptr(), cuda_build.current_stream(x.device),
    )
    cuda_build.check(status, "fused_affine_conv3_nchw")
    fused_affine_conv3_nchw.launches += 1
    return out.permute(0, 3, 1, 2)


fused_affine_conv3_nchw.launches = 0


@functools.lru_cache(maxsize=None)
def _plan(n: int, h: int, w: int, c: int, co: int, cs: int, mode: int, is_bf16: int) -> Tuple[int, int, int, int]:
    """K6's plan for one call size, asked of the library once: (splits, BN,
    CK, elements of the weights' device layout).  BN and CK are those a
    stored layout was made with (``layout_block``, ``CK``)."""
    plan = (ctypes.c_int * 4)()
    if cuda_build.library().tha4_affine_conv3_plan(n, h, w, c, co, cs, mode, is_bf16, plan) != 0:
        raise ValueError(f"fused_affine_conv3_nchw: sizes the kernel does not take {(n, h, w, c, co, cs, mode)}")
    if (plan[1], plan[2]) != (layout_block(co, torch.bfloat16 if is_bf16 else torch.float32), CK):
        raise RuntimeError(f"K6's library plans BN {plan[1]}, CK {plan[2]} where cuda_conv.layout_block and CK say "
                           f"{layout_block(co, torch.bfloat16 if is_bf16 else torch.float32)}, {CK}")
    return tuple(plan)


def layout_block(cout: int, dtype: torch.dtype) -> int:
    """BN, the output channels of one block of K6's device layout for a
    conv of ``cout`` channels in ``dtype`` (``make_plan`` in
    csrc/affine_conv3.cu): the smallest of 32, 64, 128, 256 (bf16) or 32,
    64 (f32) that holds Cout, else the largest."""
    widths = (32, 64, 128, 256) if dtype == torch.bfloat16 else (32, 64)
    return next((b for b in widths if cout <= b), widths[-1])


def device_weight_layout(w9: torch.Tensor, skip_w: Optional[torch.Tensor], bn: int, ck: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """w9 (Cout, 9 * Cin) and the 1x1 skip's skip_w (Cout, Cs) or None in the
    order K6 reads them, flat, in ``dtype``: per block of ``bn`` output
    channels, the conv's input channels in chunks of ``ck`` (each chunk's
    nine taps), then the skip's chunks; channels past Cin, Cs or Cout are 0.
    A chunk is [tap][ck // 8][bn][8] in bf16 (each tap a K-major wgmma B
    operand of 16-byte core-matrix rows), [tap][ck][bn] in f32."""
    co, k9 = w9.shape
    cin = k9 // 9
    nb, qc = -(-co // bn), -(-cin // ck)
    bf16 = dtype == torch.bfloat16
    wt = F.pad(w9.to(dtype).reshape(co, 9, cin), (0, qc * ck - cin, 0, 0, 0, nb * bn - co)).reshape(nb, bn, 9, qc, ck)
    wt = wt.reshape(nb, bn, 9, qc, ck // 8, 8).permute(0, 3, 2, 4, 1, 5) if bf16 else wt.permute(0, 3, 2, 4, 1)
    parts = [wt.reshape(nb, -1)]
    if skip_w is not None:
        cs = skip_w.shape[1]
        qs = -(-cs // ck)
        st = F.pad(skip_w.to(dtype), (0, qs * ck - cs, 0, nb * bn - co)).reshape(nb, bn, qs, ck)
        st = st.reshape(nb, bn, qs, ck // 8, 8).permute(0, 2, 3, 1, 4) if bf16 else st.permute(0, 2, 3, 1)
        parts.append(st.reshape(nb, -1))
    return torch.cat(parts, dim=1).reshape(-1)


def _channels_last(t: torch.Tensor) -> bool:
    """NHWC memory viewed as NCHW; a dimension of size 1 may have any stride."""
    n, c, h, w = t.shape
    return all(size == 1 or stride == want for size, stride, want in zip(t.shape, t.stride(), (h * w * c, 1, w * c, c)))


def _check(x, scale, shift, w9, bias, skip, skip_w) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    n, c, h, w = x.shape
    co = w9.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype must be float32 or bfloat16, got {x.dtype}")
    if not _channels_last(x):
        raise ValueError("x must lie channels last (an NHWC tensor viewed as NCHW)")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift go together")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and (t.shape != (n, c) or t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({n}, {c}), got {tuple(t.shape)} {t.dtype}")
    if w9.shape != (co, 9 * c):
        raise ValueError(f"w9 must be (Cout, 9 * {c}), got {tuple(w9.shape)}")
    if bias.shape != (co,):
        raise ValueError(f"bias must be ({co},), got {tuple(bias.shape)}")
    if skip is not None:
        if skip.dim() != 4 or skip.shape[0] != n or skip.shape[2:] != (h, w) or skip.dtype != x.dtype:
            raise ValueError(f"skip must be (N, Cs, {h}, {w}) in {x.dtype}, got {tuple(skip.shape)} {skip.dtype}")
        if not _channels_last(skip):
            raise ValueError("skip must lie channels last")
        if skip_w is None and skip.shape[1] != co:
            raise ValueError(f"an identity skip needs Cs = Cout = {co}, got {skip.shape[1]}")
        if skip_w is not None and skip_w.shape != (co, skip.shape[1]):
            raise ValueError(f"skip_w must be ({co}, {skip.shape[1]}), got {tuple(skip_w.shape)}")
    elif skip_w is not None:
        raise ValueError("skip_w without skip")
    for t in (x, scale, shift, w9, bias, skip, skip_w):
        if t is not None and t.device != x.device:
            raise ValueError(f"a tensor on {t.device}, x on {x.device}")
    # The kernel loads x and skip 16 bytes at a time (the weights' device
    # layout is a tensor of its own).
    for t in (x, scale, shift, bias, skip):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("fused_affine_conv3_nchw: tensors must be 16-byte aligned")
