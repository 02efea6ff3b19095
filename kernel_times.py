#!/usr/bin/env python3
"""Each hand-written kernel of the port on the card: its time beside its
bound, its plain PyTorch version and one library call of the same function.

    python3 kernel_times.py [--kernel K1 [--kernel K6 ...]]

One JSON line per kernel (K1, K2, K3, K4, K5, K6, fold, Q1, R1; all of
them without ``--kernel``), each with the card's name and power limit and,
per variant (a dtype, or a call of a path):

* ``ms``: the card's own time, the calls captured in a CUDA graph and the
  graph replayed between one pair of events, so no host work is inside;
* ``bound_ms`` and ``bound_by``: the least time, the bytes read and written
  once over the memory rate or the operations over the peak for their
  type (``benchmark/counts.py``'s peaks and bounds; K1 and K4 add the sine
  epilogue on the CUDA cores, ``counts.chain_bound_s``);
* ``plain_ms``: the plain version on the card, the median of one event
  pair a call;
* ``library_ms``: one PyTorch call of the same function, as ``ms``; null
  where PyTorch has none;
* ``err``: the largest absolute difference between the kernel's output and
  its plain version's on the same inputs, over the plain output's largest
  magnitude (at least 1e-3), the worst output of a tuple (recorded, not
  checked).

and ``launches``: each launch counter of the kernel's wrappers, by how much
it moved.  The shapes are the paths' own, at full width.  The tool checks
only that each of those counters moved; parity is the card tests'
(``tests/test_torch_cuda.py``).  A machine without CUDA exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import statistics
import subprocess
import sys

import torch

from benchmark import counts

SEED = 20261016
BATCH = 8
# f32 operations of the fast_cos beside each fast_sin in K4's backward
# (csrc/common.cuh): one more than ``counts.SIN_OPS``.
COS_OPS = counts.SIN_OPS + 1
INT8_PEAK_OPS = 1979e12  # dense int8 tensor-core rate of one H100 SXM (NVIDIA's data sheet)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def graph_ms(fn, calls: int = 20, reps: int = 20) -> float:
    """The card's own time for one ``fn()``: ``calls`` calls captured in a
    CUDA graph (after one call outside it), the graph replayed ``reps``
    times between one pair of events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / calls


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """The median of one event pair around each of ``iters`` calls of
    ``fn`` (after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(kernel, plain) -> float:
    """The largest absolute difference of two outputs over the plain one's
    largest magnitude (at least 1e-3), the worst pair where they are tuples
    (pairs of ``None`` skipped)."""
    pairs = zip(kernel, plain) if isinstance(kernel, (tuple, list)) else [(kernel, plain)]
    return max(float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-3)
               for a, b in pairs if a is not None)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes_: float, flops: float, dtype: str, peak: float = None) -> dict:
    """``counts.bound_s`` in ms, and which side bounds it; ``peak``: a rate
    in place of ``counts.PEAK_FLOPS[dtype]``."""
    byte_s = nbytes_ / counts.HBM_BYTES_PER_S
    s = max(byte_s, flops / peak) if peak else counts.bound_s(nbytes_, flops, dtype)
    return {"bound_ms": s * 1e3, "bound_by": "bytes" if byte_s >= s else "operations"}


def chain_bound(nbytes_: float, macs: float, sines: float, dtype: str) -> dict:
    """``counts.chain_bound_s`` in ms, ``sines`` the epilogue's fast_sin
    outputs (``counts.SIN_OPS`` f32 operations each)."""
    s = counts.chain_bound_s(nbytes_, macs, sines, dtype)
    return {"bound_ms": s * 1e3, "bound_by": "bytes" if nbytes_ / counts.HBM_BYTES_PER_S >= s else "operations"}


def row(ms, bounds: dict, plain_ms, library_ms=None, err=None) -> dict:
    return {"ms": ms, **bounds, "plain_ms": plain_ms, "library_ms": library_ms, "err": err}


def _chain_counts(chain, n: int, hw: int) -> tuple:
    """(multiply-adds, sine-layer outputs) of one pass of a packed chain."""
    macs = sum(int(ci) * int(co) for ci, co, _, _ in chain.specs) * n * hw
    return macs, int(chain.specs[: chain.num_sine, 1].sum()) * n * hw


def _students():
    from tha4_tpu_torch.models import siren

    gen = torch.Generator().manual_seed(SEED)
    return siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen)


def k1() -> dict:
    """The four chains of one frame (face, body levels 0-2; N = 1), added,
    in each dtype, and each call apart."""
    from tha4_tpu_torch.models.siren import pos_t
    from tha4_tpu_torch.ops import cuda_siren

    face, body = _students()
    gen = torch.Generator().manual_seed(SEED + 1)
    out, calls = {}, {}
    for tag, dtype in DTYPES.items():
        chains = [face.pack(dtype, "cuda")] + body.pack(dtype, "cuda")
        levels = [(face.cfg.image_size, 0, face.cfg.pose_size)] + [
            (lv.image_size, 0 if i == 0 else lv.intermediate_channels, body.cfg.pose_size) for i, lv in enumerate(body.cfg.levels)]
        total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "macs": 0, "sines": 0}
        errs = []
        for name, chain, (size, cp, pose_dim) in zip(("face", "L0", "L1", "L2"), chains, levels):
            prev = (torch.rand((1, cp, size * size), generator=gen) * 2.0 - 1.0).to("cuda", dtype) if cp else None
            args = (prev, pos_t(size, dtype, "cuda"), torch.rand((1, pose_dim), generator=gen).cuda(), chain)
            out_t = cuda_siren.sine_chain_t(*args)
            macs, sines = _chain_counts(chain, 1, size * size)
            call_bytes = nbytes(*args[:3], chain.w, chain.b, out_t)
            ms, plain = graph_ms(lambda: cuda_siren.sine_chain_t(*args)), event_ms(lambda: cuda_siren.chain_t_plain(*args), 10)
            errs.append(max_err(out_t, cuda_siren.chain_t_plain(*args)))
            calls[f"{name} {tag}"] = row(ms, chain_bound(call_bytes, macs, sines, tag), plain, err=errs[-1])
            for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", call_bytes), ("macs", macs), ("sines", sines)):
                total[k] += v
        out[f"frame {tag}"] = row(total["ms"], chain_bound(total["bytes"], total["macs"], total["sines"], tag),
                                  total["plain_ms"], err=max(errs))
    return {"shape": "the frame's four chains, N = 1", "timed": {**out, **calls}}


def _smooth_grid(gen, n: int, size: int, px: float):
    """Identity plus a smooth field of up to ``px`` pixels, (N, H, W, 2) f32."""
    from tha4_tpu_torch.ops import warp

    coarse = torch.randn((n, 2, 8, 8), generator=gen)
    field = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    field = (field / field.abs().max()).permute(0, 2, 3, 1).contiguous().cuda()
    return (warp.identity_grid(size, size, "cuda")[None] + field * (px * 2.0 / size)).contiguous()


def k2() -> dict:
    from tha4_tpu_torch.ops import cuda_warp

    gen = torch.Generator().manual_seed(SEED + 2)
    grid = _smooth_grid(gen, 1, 512, 30.0)
    image32 = (torch.rand((1, 512, 512, 4), generator=gen) * 2.0 - 1.0).cuda()
    timed = {}
    for tag, dtype in DTYPES.items():
        image = image32.to(dtype)
        out = cuda_warp.grid_sample_fast(image, grid)
        image_nchw, grid_t = image.permute(0, 3, 1, 2), grid.to(dtype)
        timed[tag] = row(graph_ms(lambda: cuda_warp.grid_sample_fast(image, grid)),
                         bound(nbytes(image, grid, out), 6.0 * out.numel(), tag),  # 3 lerps a value
                         event_ms(lambda: cuda_warp.grid_sample_bilinear_border(image, grid), 10),
                         graph_ms(lambda: torch.nn.functional.grid_sample(image_nchw, grid_t, mode="bilinear",
                                                                          padding_mode="border", align_corners=False)),
                         max_err(out, cuda_warp.grid_sample_bilinear_border(image, grid)))
    return {"shape": "(1, 512^2, 4), a smooth grid of up to 30 px", "timed": timed}


def k3() -> dict:
    """Forward (K2's kernel) and grid backward as a pair."""
    from tha4_tpu_torch.ops import cuda_warp

    gen = torch.Generator().manual_seed(SEED + 10)
    grid = _smooth_grid(gen, BATCH, 512, 30.0)
    image32 = (torch.rand((BATCH, 512, 512, 4), generator=gen) * 2.0 - 1.0).cuda()
    g32 = torch.randn((BATCH, 512, 512, 4), generator=gen).cuda()
    timed = {}
    for tag, dtype in DTYPES.items():
        image, g = image32.to(dtype), g32.to(dtype)
        out, dgrid = cuda_warp.grid_sample_train_forward(image, grid), cuda_warp.grid_sample_grid_backward(g, image, grid)
        image_nchw, g_nchw, grid_t = image.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2), grid.to(dtype)

        def library():
            out = torch.nn.functional.grid_sample(image_nchw, grid_t, mode="bilinear", padding_mode="border", align_corners=False)
            return out, torch.ops.aten.grid_sampler_2d_backward(g_nchw, image_nchw, grid_t, 0, 1, False, [False, True])[1]

        # f32 on the CUDA cores in both dtypes, each operation its own
        # instruction (twice the count at the f32 peak, which counts an FMA
        # as two): 3 lerps a value forward, 14 a value backward.
        fwd = bound(nbytes(image, grid, out), 2.0 * 6.0 * out.numel(), "f32")
        bwd = bound(nbytes(g, image, grid, dgrid), 2.0 * 14.0 * g.numel(), "f32")
        timed[tag] = row(graph_ms(lambda: (cuda_warp.grid_sample_train_forward(image, grid),
                                           cuda_warp.grid_sample_grid_backward(g, image, grid))),
                         {"bound_ms": fwd["bound_ms"] + bwd["bound_ms"], "bound_by": f"{fwd['bound_by']}, {bwd['bound_by']}"},
                         event_ms(lambda: (cuda_warp.grid_sample_bilinear_border(image, grid),
                                           cuda_warp.grid_sample_grid_backward_plain(g, image, grid)), 10),
                         graph_ms(library),
                         max_err((out, dgrid), (cuda_warp.grid_sample_bilinear_border(image, grid),
                                                cuda_warp.grid_sample_grid_backward_plain(g, image, grid))))
    return {"shape": "the body student's head warp, (8, 512^2, 4), forward + grid backward", "timed": timed}


def k4() -> dict:
    """The face student's training backward, N = 8 at 128^2."""
    from tha4_tpu_torch.models.siren import pos_t
    from tha4_tpu_torch.ops import cuda_siren

    face, _ = _students()
    gen = torch.Generator().manual_seed(SEED + 3)
    size = face.cfg.image_size
    timed = {}
    for tag, dtype in DTYPES.items():
        chain = face.pack(dtype, "cuda")
        pose = torch.rand((BATCH, face.cfg.pose_size), generator=gen).cuda()
        g = torch.randn((BATCH, chain.out_channels, size * size), generator=gen).to("cuda", dtype)
        args = (None, pos_t(size, dtype, "cuda"), pose, chain, g)
        grads = cuda_siren.sine_chain_t_bwd(*args)
        macs, sines = _chain_counts(chain, BATCH, size * size)
        # Three chain products (the forward recomputed, g through each layer,
        # the weight gradients); a fast_sin and a fast_cos a sine output, in
        # fast_sin's operations.
        timed[tag] = row(graph_ms(lambda: cuda_siren.sine_chain_t_bwd(*args), calls=5),
                         chain_bound(nbytes(*args[1:3], chain.w, chain.b, g, *grads), 3 * macs,
                                     sines * (counts.SIN_OPS + COS_OPS) / counts.SIN_OPS, tag),
                         event_ms(lambda: cuda_siren.chain_t_bwd_plain(*args), 5),
                         err=max_err(grads, cuda_siren.chain_t_bwd_plain(*args)))
    return {"shape": "the face student's step, N = 8, 128^2, 41 -> 128 x 8 -> 4", "timed": timed}


def k5() -> dict:
    """Forward and backward at the body student's widest layer."""
    from tha4_tpu_torch.ops import cuda_poly_sin

    gen = torch.Generator().manual_seed(SEED + 11)
    shape = (BATCH, 512, 512, 90)
    a32 = (torch.randn(shape, generator=gen) * 40.0).cuda()  # omega x pre reaches +-150
    g32 = torch.randn(shape, generator=gen).cuda()
    timed = {}
    for tag, a_dtype, out_dtype in (("f32->bf16", torch.float32, torch.bfloat16), ("f32", torch.float32, torch.float32)):
        a, g = a32.to(a_dtype), g32.to(out_dtype)
        out, da = cuda_poly_sin.poly_sin_forward(a, out_dtype), cuda_poly_sin.poly_sin_backward(a, g)
        # About 20 f32 operations an element (reduction, polynomial, cast).
        timed[f"fwd {tag}"] = row(graph_ms(lambda: cuda_poly_sin.poly_sin_forward(a, out_dtype), calls=5),
                                  bound(nbytes(a, out), 20.0 * a.numel(), "f32"),
                                  event_ms(lambda: cuda_poly_sin.poly_sin_plain(a, out_dtype), 5),
                                  graph_ms(lambda: torch.sin(a), calls=5),
                                  max_err(out, cuda_poly_sin.poly_sin_plain(a, out_dtype)))
        timed[f"bwd {tag}"] = row(graph_ms(lambda: cuda_poly_sin.poly_sin_backward(a, g), calls=5),
                                  bound(nbytes(a, g, da), 21.0 * a.numel(), "f32"),
                                  event_ms(lambda: cuda_poly_sin.poly_sin_bwd_plain(a, g), 5),
                                  err=max_err(da, cuda_poly_sin.poly_sin_bwd_plain(a, g)))
    return {"shape": "(8, 512^2, 90); f32->bf16 is the selective-f32 path; library: torch.sin", "timed": timed}


def k6() -> dict:
    """The U-Nets' (8, 512^2, 64 -> 64) ResBlock conv with its identity
    skip, laid out as a frozen U-Net passes it (NCHW views of NHWC memory,
    the weights' device layout made once)."""
    from tha4_tpu_torch.ops import cuda_conv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    n, size, c = BATCH, 512, 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    timed = {}
    for tag, dtype in DTYPES.items():
        x, skip = (randn(n, size, size, c).to(dtype).permute(0, 3, 1, 2) for _ in range(2))
        scale = torch.rand((n, c), generator=gen, device="cuda") + 0.5
        shift = torch.rand((n, c), generator=gen, device="cuda") - 0.5
        w32 = randn(3, 3, c, c) / math.sqrt(9 * c)
        w9 = cuda_conv.to_w9(w32, dtype).contiguous()
        layout = cuda_conv.device_weight_layout(w9, None, cuda_conv.layout_block(c, dtype), cuda_conv.CK, dtype)
        args = (x, scale, shift, w9, randn(c) * 0.1, skip, None, layout)
        out = cuda_conv.fused_affine_conv3_nchw(*args)
        w_lib = w32.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)
        b_lib = args[4].to(dtype)
        macs = x.numel() * c * 9
        timed[tag] = row(graph_ms(lambda: cuda_conv.fused_affine_conv3_nchw(*args)),
                         bound(nbytes(*args[:7], out), 2.0 * macs, tag),
                         event_ms(lambda: cuda_conv.fused_affine_conv3_plain(*args[:7]), 5),
                         graph_ms(lambda: torch.nn.functional.conv2d(x, w_lib, b_lib, padding=1)),
                         max_err(out, cuda_conv.fused_affine_conv3_plain(*args[:7])))
    return {"shape": "(8, 512^2, 64 -> 64) with its identity skip; library: F.conv2d alone, channels last", "timed": timed}


def fold() -> dict:
    """A ResBlock's norm1 with its two FiLMs over K6's x."""
    from tha4_tpu_torch.ops import cuda_conv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    timed = {}
    for tag, dtype in DTYPES.items():
        x = torch.randn((BATCH, 512, 512, 64), generator=gen, device="cuda").to(dtype).permute(0, 3, 1, 2)
        n, c = x.shape[:2]
        gamma = torch.rand(c, generator=gen, device="cuda") + 0.5
        beta = torch.rand(c, generator=gen, device="cuda") - 0.5
        film = tuple((torch.randn((n, 2 * c), generator=gen, device="cuda") * 0.3).to(dtype).chunk(2, dim=-1) for _ in range(2))
        args = (x, min(32, c), gamma, beta, film)
        with torch.no_grad():
            scale_shift = cuda_conv.fold_groupnorm_film(*args)
            timed[tag] = row(graph_ms(lambda: cuda_conv.fold_groupnorm_film(*args)),
                             bound(nbytes(x, *scale_shift), 8.0 * x.numel(), "f32"),
                             event_ms(lambda: cuda_conv.fold_groupnorm_film_plain(*args), 10),
                             err=max_err(scale_shift, cuda_conv.fold_groupnorm_film_plain(*args)))
    return {"shape": "x of (8, 512^2, 64), 32 groups, two FiLMs", "timed": timed}


def q1() -> dict:
    """The int8 teacher's costliest conv, (8, 128^2, 256 -> 256) 3x3."""
    from tha4_tpu_torch.ops import cuda_int8_conv, quant

    gen = torch.Generator().manual_seed(SEED + 51)
    n, h, w, cin, cout, k = BATCH, 128, 128, 256, 256, 3
    w8, w_s = quant.quantize_weight(torch.randn((k, k, cin, cout), generator=gen) * 0.1)
    layout = cuda_int8_conv.weight_layout(w8)
    layout = layout._replace(tensor=layout.tensor.cuda())
    w8, w_s = w8.cuda(), w_s.cuda()
    timed = {}
    for tag, dtype in DTYPES.items():
        x = torch.randn((n, h, w, cin), generator=gen).to("cuda", dtype)
        bias = (torch.randn(cout, generator=gen) * 0.1).to("cuda", dtype)
        scale = float(x.float().abs().max()) * 1.1 / 127.0
        args = (x, layout, w_s, scale, k // 2, bias)
        out = cuda_int8_conv.int8_conv(*args)
        macs = n * h * w * cout * k * k * cin
        # The library: torch._int_mm (int8 x int8 -> int32) on an F.unfold
        # im2col of the quantized x, made before the clock.
        xq = torch.round(x.float() / scale).clamp(-127, 127).permute(0, 3, 1, 2)
        cols = torch.nn.functional.unfold(xq, k, padding=k // 2).transpose(1, 2).reshape(n * h * w, cin * k * k).to(torch.int8)
        b = w8.permute(2, 0, 1, 3).reshape(cin * k * k, cout).contiguous()
        timed[tag] = row(graph_ms(lambda: cuda_int8_conv.int8_conv(*args), calls=10),
                         bound(nbytes(x, layout.tensor, w_s, bias, out), 2.0 * macs, tag, peak=INT8_PEAK_OPS),
                         event_ms(lambda: cuda_int8_conv.int8_conv_plain(x, w8, w_s, scale, k // 2, bias), 3, warmup=1),
                         graph_ms(lambda: torch._int_mm(cols, b), calls=10),
                         max_err(out, cuda_int8_conv.int8_conv_plain(x, w8, w_s, scale, k // 2, bias)))
    return {"shape": "(8, 128^2, 256 -> 256) 3x3; library: torch._int_mm on the im2col", "timed": timed}


def r1() -> dict:
    """The f32 frame's two level upsamples (NCHW, N = 1), added, and the
    body student's two training levels (NHWC bf16, N = 8), forward and
    adjoint."""
    from tha4_tpu_torch.ops import cuda_resize

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(SEED + 19)
    cases = [("frame L0->L1", False, torch.float32, (1, 180, 128, 128), (256, 256)),
             ("frame L1->L2", False, torch.float32, (1, 90, 256, 256), (512, 512)),
             ("train L0->L1", True, torch.bfloat16, (BATCH, 128, 128, 180), (256, 256)),
             ("train L1->L2", True, torch.bfloat16, (BATCH, 256, 256, 90), (512, 512))]
    timed = {}
    for name, cl, dtype, shape, size in cases:
        x = (torch.rand(shape, generator=gen) * 2.0 - 1.0).to("cuda", dtype)
        nchw = x.permute(0, 3, 1, 2) if cl else x
        out = cuda_resize.resize(x, size, cl)
        calls = 5 if shape[0] > 1 else 20
        tag = "f32" if dtype == torch.float32 else "bf16"
        timed[name] = row(graph_ms(lambda: cuda_resize.resize(x, size, cl), calls=calls),
                          bound(nbytes(x, out), 4.0 * out.numel(), tag),
                          event_ms(lambda: cuda_resize.resize_plain(x, size, cl), 5),
                          graph_ms(lambda: F.interpolate(nchw, size=size, mode="bilinear", align_corners=False), calls=calls),
                          max_err(out, cuda_resize.resize_plain(x, size, cl)))
        if cl:
            g = (torch.rand(out.shape, generator=gen) * 2.0 - 1.0).to("cuda", dtype)
            in_size = shape[1:3]
            dx = cuda_resize.bilinear_resize_backward(g, in_size, cl)
            xr = x.detach().requires_grad_(True)
            timed[f"{name} adjoint"] = row(
                graph_ms(lambda: cuda_resize.bilinear_resize_backward(g, in_size, cl), calls=calls),
                bound(nbytes(g, dx), 4.0 * g.numel(), tag),
                event_ms(lambda: torch.autograd.grad(cuda_resize.resize_plain(xr, size, cl), xr, g), 5),
                err=max_err(dx, torch.autograd.grad(cuda_resize.resize_plain(xr, size, cl), xr, g)[0]))
    frame = [timed.pop(k) for k in ("frame L0->L1", "frame L1->L2")]
    added = {k: sum(r[k] for r in frame) for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
    timed = {"frame f32": {**added, "bound_by": "bytes", "err": max(r["err"] for r in frame)}, **timed}
    return {"shape": "the f32 frame's two upsamples added; the student's training levels at N = 8; library: F.interpolate",
            "timed": timed}


# Each kernel's timing function and the launch counters (``module.wrapper``
# under ``tha4_tpu_torch.ops``) that its run must move.
KERNELS = {"K1": (k1, ["cuda_siren.sine_chain_t"]), "K2": (k2, ["cuda_warp.grid_sample_fast"]),
           "K3": (k3, ["cuda_warp.grid_sample_train_forward", "cuda_warp.grid_sample_grid_backward"]),
           "K4": (k4, ["cuda_siren.sine_chain_t_bwd"]),
           "K5": (k5, ["cuda_poly_sin.poly_sin_forward", "cuda_poly_sin.poly_sin_backward"]),
           "K6": (k6, ["cuda_conv.fused_affine_conv3_nchw"]), "fold": (fold, ["cuda_conv.fold_groupnorm_film"]),
           "Q1": (q1, ["cuda_int8_conv.int8_conv"]),
           "R1": (r1, ["cuda_resize.bilinear_resize_forward", "cuda_resize.bilinear_resize_backward"])}


def counter(name: str):
    module, wrapper = name.split(".")
    return getattr(importlib.import_module(f"tha4_tpu_torch.ops.{module}"), wrapper)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", action="append", choices=list(KERNELS), help="a kernel to time (repeatable; default all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch.cuda.is_available() is False; this tool times the card")
    from tha4_tpu_torch.ops import cuda_build
    from tha4_tpu_torch.utils import precision

    precision.set_full_f32()
    cuda_build.library()
    name, limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                                 text=True, check=True, timeout=60).stdout.strip().splitlines()[0].split(", ")
    for kernel in args.kernel or list(KERNELS):
        fn, names = KERNELS[kernel]
        before = {n: counter(n).launches for n in names}
        line = fn()
        moved = {n: counter(n).launches - before[n] for n in names}
        idle = [n for n, v in moved.items() if not v]
        if idle:
            raise SystemExit(f"kernel_times: {kernel} did not launch {idle}")
        print(json.dumps({"kernel": kernel, "card": name, "power_limit": limit, **line, "launches": moved}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
