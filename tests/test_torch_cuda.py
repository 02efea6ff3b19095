"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; each skips itself where
``torch.cuda.is_available()`` is False.  On a machine with a card (and no
jax, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel is held at the shapes of the paths that call it, at full
width, and at ragged ones.  ``kernel_times.py`` times them.
"""

import math
import os

import numpy as np
import pytest
import torch

from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops import cuda_resize, cuda_siren, cuda_warp
from tha4_tpu_torch.ops.warp import identity_grid
from test_torch_siren_fold import (
    K1_CASES, K1_F32_CASES, SUM_ORDER_SENSITIVE, chain_t_exact, chain_t_folded, k1_bf16_bar, k1_case, max_diff,
    random_chain,
)
from torch_card import SEED, card

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dtype,cp,dims,head,hw", [
    (dtype, *case) for case in K1_CASES for dtype in (torch.float32, torch.bfloat16)
] + [(torch.float32, *case) for case in K1_F32_CASES])
def test_sine_chain_kernel_matches_plain(card, dtype, cp, dims, head, hw):
    prev, pos, pose, chain = k1_case(cp, dims, head, hw, dtype, card)
    before = cuda_siren.sine_chain_t.launches
    out = cuda_siren.sine_chain_t(prev, pos, pose, chain)
    torch.cuda.synchronize()
    assert cuda_siren.sine_chain_t.launches == before + 1
    ref = cuda_siren.chain_t_plain(prev, pos, pose, chain)
    if dtype == torch.bfloat16 and (cp, dims, head, hw) == SUM_ORDER_SENSITIVE:
        # Here two f32 orders of the plain arithmetic differ by more than the
        # bar (the witness in tests/test_torch_siren_fold.py), so the kernel is
        # held to the plain version summed in its own order.
        ref = chain_t_folded(prev, pos, pose, chain)
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4
    else:  # see tests/test_torch_siren.py: summation order moves a bf16 step now and then
        assert float(err.max()) <= k1_bf16_bar(ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("level,n", [(level, 1) for level in ("face", 0, 1, 2)] + [("face", 8)] + [(level, 4) for level in (0, 1, 2)])
def test_sine_chain_kernel_at_the_shipped_chains(card, dtype, level, n):
    """K1 at the shipped students' chains (SIREN init, seeded): the frame's
    four calls (N = 1), the face at its training batch and the body levels
    at the body sample grid's batch.  f32 within 1e-4 (two valid f32 orders
    through omega = 30 sine layers, tests/test_pallas_siren.py:54); bf16
    within four bf16 steps of the output's scale (the same bf16 operands,
    exact f32 products and f32 sums in another order)."""
    gen = torch.Generator().manual_seed(SEED)
    face, body = siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen)
    if level == "face":
        chain, size, cp, pose_dim = face.pack(dtype, card), face.cfg.image_size, 0, face.cfg.pose_size
    else:
        chain, size, pose_dim = body.pack(dtype, card)[level], body.cfg.levels[level].image_size, body.cfg.pose_size
        cp = 0 if level == 0 else body.cfg.levels[level].intermediate_channels
    gen = torch.Generator().manual_seed(SEED + 1)
    prev = (torch.rand((n, cp, size * size), generator=gen) * 2.0 - 1.0).to(card, dtype) if cp else None
    pos, pose = siren.pos_t(size, dtype, card), torch.rand((n, pose_dim), generator=gen).to(card)
    out = cuda_siren.sine_chain_t(prev, pos, pose, chain)
    ref = cuda_siren.chain_t_plain(prev, pos, pose, chain)
    assert out.shape == ref.shape and out.dtype == dtype
    err = float((out.float() - ref.float()).abs().max())
    assert err <= (1e-4 if dtype == torch.float32 else k1_bf16_bar(ref)), err


def test_sine_chain_kernel_at_the_sum_order_witness(card):
    """The bf16 kernel at ``SUM_ORDER_SENSITIVE`` beside the CPU witness: its
    distance to the unfolded and folded plain versions and to the f64 run.
    The kernel is no farther from the f64 run than the farther of the two
    plain f32 orders."""
    prev, pos, pose, chain = k1_case(*SUM_ORDER_SENSITIVE, torch.bfloat16, card)
    out = cuda_siren.sine_chain_t(prev, pos, pose, chain).cpu()
    cpu = k1_case(*SUM_ORDER_SENSITIVE, torch.bfloat16, "cpu")
    plain, folded, exact = (f(*cpu) for f in (cuda_siren.chain_t_plain, chain_t_folded, chain_t_exact))
    readings = {"kernel_vs_plain": max_diff(out, plain), "kernel_vs_folded": max_diff(out, folded),
                "kernel_vs_f64": max_diff(out, exact), "plain_vs_f64": max_diff(plain, exact),
                "folded_vs_f64": max_diff(folded, exact), "bar": k1_bf16_bar(plain)}
    print(f"K1 bf16 witness on the card: {readings}")
    assert readings["kernel_vs_f64"] <= max(readings["plain_vs_f64"], readings["folded_vs_f64"]), readings


@pytest.mark.parametrize("level", ["face", 0, 1, 2])
def test_f32_sine_chain_kernel_at_the_sum_order_witness(card, level):
    """The f32 kernel at one of the frame's four chains (shipped widths and
    sizes, SIREN init, N = 1) beside the plain version on the card and on
    the CPU and the f64 run: the kernel is no farther from the f64 run than
    the farther of the two plain f32 versions (each of its outputs is one
    FMA chain over k in order)."""
    gen = torch.Generator().manual_seed(7)
    face, body = siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen)
    if level == "face":
        chain, size, cp, pose_dim = face.pack(torch.float32), face.cfg.image_size, 0, face.cfg.pose_size
    else:
        chain, size, pose_dim = body.pack(torch.float32)[level], body.cfg.levels[level].image_size, body.cfg.pose_size
        cp = 0 if level == 0 else body.cfg.levels[level].intermediate_channels
    prev = torch.rand((1, cp, size * size), generator=gen) * 2 - 1 if cp else None
    cpu = (prev, siren.pos_t(size, torch.float32, "cpu"), torch.rand((1, pose_dim), generator=gen))
    on_card = tuple(None if t is None else t.to(card) for t in cpu)
    card_chain = cuda_siren.PackedChain(chain.w.to(card), chain.b.to(card), chain.specs, chain.num_sine,
                                        chain.tiles.to(card))
    out = cuda_siren.sine_chain_t(*on_card, card_chain)
    plain = cuda_siren.chain_t_plain(*on_card, card_chain)
    exact = chain_t_exact(*on_card, card_chain)
    plain_cpu = cuda_siren.chain_t_plain(*cpu, chain)
    readings = {"kernel_vs_plain": max_diff(out, plain), "kernel_vs_f64": max_diff(out, exact),
                "plain_vs_f64": max_diff(plain, exact), "plain_cpu_vs_f64": max_diff(plain_cpu, exact.cpu())}
    print(f"K1 f32 witness, level {level}, on the card: {readings}")
    assert readings["kernel_vs_f64"] <= max(readings["plain_vs_f64"], readings["plain_cpu_vs_f64"]), readings


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)])
def test_warp_kernel_matches_plain(card, dtype, atol):
    rng = np.random.default_rng(7)
    image = torch.from_numpy(rng.uniform(-1, 1, (2, 96, 160, 4)).astype(np.float32)).to(card, dtype)
    grid = torch.from_numpy(rng.uniform(-1.5, 1.5, (2, 64, 80, 2)).astype(np.float32)).to(card)
    grid[1] = identity_grid(64, 80, card) + 0.01
    before = cuda_warp.grid_sample_fast.launches
    out = cuda_warp.grid_sample_fast(image, grid)
    torch.cuda.synchronize()
    assert cuda_warp.grid_sample_fast.launches == before + 1
    assert out.dtype == dtype and out.shape == (2, 64, 80, 4)
    ref = cuda_warp.grid_sample_bilinear_border(image, grid)
    assert float((out.float() - ref.float()).abs().max()) <= atol


def _bwd_case(case, dtype, device):
    """K4's shapes: the face student's training batch (N = 8, 128^2,
    41->128x8->4), the body's level 1 (N = 1, 256^2, prev 180 channels,
    227->180->180->90), a small chain with a ragged last tile, and a chain
    with K of 20, N of 360 and 7 and a ragged tile at N = 2."""
    rng = np.random.default_rng(len(case))
    if case in ("odd", "wide"):
        dims, n, cp, hw = ([15, 40, 16, 5], 3, 6, 77) if case == "odd" else ([29, 360, 7], 2, 20, 130)
        chain, size = random_chain(rng, dims, 1, dtype, device), None
        pos = torch.from_numpy(rng.uniform(-1, 1, (2, hw)).astype(np.float32)).to(device, dtype)
    else:
        gen = torch.Generator().manual_seed(4)
        face, body = siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen)
        chain, n, size, cp = (face.pack(dtype, device), 8, 128, 0) if case == "face" else (body.pack(dtype, device)[1], 1, 256, 180)
        hw = size * size
        pos = siren.pos_t(size, dtype, device)
    pose_dim = int(chain.specs[0, 0]) - cp - 2
    prev = torch.from_numpy(rng.uniform(-1, 1, (n, cp, hw)).astype(np.float32)).to(device, dtype) if cp else None
    pose = torch.from_numpy(rng.uniform(0, 1, (n, pose_dim)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((n, chain.out_channels, hw)).astype(np.float32)).to(device, dtype)
    return prev, pos, pose, chain, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["face", "L1", "odd", "wide"])
def test_sine_chain_bwd_kernel_matches_plain(card, dtype, case):
    prev, pos, pose, chain, g = _bwd_case(case, dtype, card)
    before = cuda_siren.sine_chain_t_bwd.launches
    first = cuda_siren.sine_chain_t_bwd(prev, pos, pose, chain, g)
    again = cuda_siren.sine_chain_t_bwd(prev, pos, pose, chain, g)
    torch.cuda.synchronize()
    assert cuda_siren.sine_chain_t_bwd.launches == before + 2
    ref = cuda_siren.chain_t_bwd_plain(prev, pos, pose, chain, g)
    for name, a, b, r in zip(["dprev", "dpose", "dw", "db"], first, again, ref):
        if r is None:
            assert a is None and b is None
            continue
        assert torch.equal(a, b), f"{name}: two calls differ"  # no float atomics
        assert a.dtype == r.dtype and a.shape == r.shape
        scale = max(float(r.float().abs().max()), 1e-3)
        err = float((a.float() - r.float()).abs().max()) / scale
        # f32: tests/test_pallas_siren.py:58-93 at omega = 30; bf16: four bf16
        # steps, since a summation order that flips one stored bf16
        # activation or g_a by a step moves the entries it feeds by that much.
        assert err <= (1e-4 if dtype == torch.float32 else 2.0**-6), (name, err)


def test_autograd_function_launches_k1_forward_and_k4_backward(card):
    prev, pos, pose, chain, g = _bwd_case("odd", torch.bfloat16, card)
    mats = [tuple(t.float().clone().requires_grad_() for t in chain.layer(i)) for i in range(chain.num_layers)]
    k1, k4 = cuda_siren.sine_chain_t.launches, cuda_siren.sine_chain_t_bwd.launches
    out = cuda_siren.sine_chain_t_train(prev, pos, pose, mats[:-1], mats[-1], torch.bfloat16)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert (cuda_siren.sine_chain_t.launches - k1, cuda_siren.sine_chain_t_bwd.launches - k4) == (1, 1)
    _, _, dw, db = cuda_siren.chain_t_bwd_plain(prev, pos, pose, chain, g)
    for (w, b), (ci, co, wo, bo) in zip(mats, chain.specs):
        assert w.grad.dtype == torch.float32
        for grad, ref in [(w.grad.reshape(-1), dw[wo : wo + co * ci]), (b.grad, db[bo : bo + co])]:
            assert float((grad - ref).abs().max()) <= 2.0**-6 * max(float(ref.abs().max()), 1e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    image = torch.zeros((1, 8, 8, 3), device=card)
    with pytest.raises(ValueError, match="N, H, W, 4"):
        cuda_warp.grid_sample_fast(image, torch.zeros((1, 8, 8, 2), device=card))
    chain = random_chain(np.random.default_rng(0), [5, 8], 0, torch.float32, "cpu")
    pos = torch.zeros((2, 16), device=card)
    with pytest.raises(ValueError, match="on cpu"):
        cuda_siren.sine_chain_t(None, pos, torch.zeros((1, 3), device=card), chain)
    # Past each K4 design's shared memory: level 0 in f32 (a 33-word row per
    # stashed channel), 1100 channels in bf16 (two 64-pixel activation buffers).
    for dtype, dims in [(torch.float32, [47, 360, 360, 180]), (torch.bfloat16, [47, 1100, 180])]:
        wide = random_chain(np.random.default_rng(0), dims, 0, dtype, card)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_siren.sine_chain_t_bwd(
                None, torch.zeros((2, 64), device=card, dtype=dtype), torch.zeros((1, 45), device=card), wide,
                torch.zeros((1, dims[-1], 64), device=card, dtype=dtype),
            )
    # The f32 K1: past its smallest tile's shared memory, and a weight
    # layout that is not the chain's.
    wide = random_chain(np.random.default_rng(0), [47, 700, 8], 0, torch.float32, card)
    pos = torch.zeros((2, 64), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_siren.sine_chain_t(None, pos, torch.zeros((1, 45), device=card), wide)
    chain = random_chain(np.random.default_rng(0), [47, 90, 8], 0, torch.float32, card)
    stale = cuda_siren.PackedChain(chain.w, chain.b, chain.specs, chain.num_sine, chain.tiles[:-4])
    with pytest.raises(ValueError, match="stage layout"):
        cuda_siren.sine_chain_t(None, pos, torch.zeros((1, 45), device=card), stale)


def _warp_grid(rng, kind, n, h, w):
    """(N, H, W, 2) f32 grids for K3: ``border``, uniform past [-1, 1] with
    the first and last texel centres of each axis pasted in (there the
    unclamped coordinate is exactly 0 or size - 1, and the strict mask is
    0; exactly so for sizes that are powers of two); ``smooth``, identity
    plus a smooth field of up to 8 px; ``far``, a shift of 40 % of the image
    plus that field."""
    ident = identity_grid(h, w).numpy()[None].repeat(n, 0)
    coarse = torch.from_numpy(rng.standard_normal((n, 2, 6, 6)).astype(np.float32))
    field = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    field = (field / field.abs().max()).permute(0, 2, 3, 1).numpy() * (16.0 / min(h, w))
    if kind == "border":
        grid = rng.uniform(-1.2, 1.2, (n, h, w, 2)).astype(np.float32)
        for i in (0, -1):
            grid[:, i, :, 1] = ident[:, i, :, 1]
            grid[:, :, i, 0] = ident[:, :, i, 0]
        return grid
    return (ident + field + (0.8 if kind == "far" else 0.0)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["border", "smooth", "far"])
@pytest.mark.parametrize("n,h,w", [(2, 64, 128), (8, 512, 512)])  # and the body student's head warp
def test_warp_corners_kernel_and_grid_gradient_match_plain(card, dtype, kind, n, h, w):
    """K3 on the card: its forward (K2's kernel, counted apart) equals K2
    bit for bit; the grid-backward kernel is within 2e-5 of its largest
    |dgrid| of its plain version and of the CPU's autograd gradient
    (tests/test_pallas_warp.py:44-60), gives exact zeros where the strict
    mask is 0, and two calls and the autograd path on the card are
    bit-identical; each launch counter moves by one a call; a bf16 grid and
    a non-contiguous g raise."""
    rng = np.random.default_rng(8)
    image = torch.from_numpy(rng.uniform(-1, 1, (n, h, w, 4)).astype(np.float32)).to(card, dtype)
    grid = torch.from_numpy(_warp_grid(rng, kind, n, h, w)).to(card)
    g = torch.from_numpy(rng.standard_normal((n, h, w, 4)).astype(np.float32)).to(card, dtype)
    fwd, bwd = cuda_warp.grid_sample_train_forward, cuda_warp.grid_sample_grid_backward
    before = fwd.launches, bwd.launches
    out = fwd(image, grid)
    first = bwd(g, image, grid)
    again = bwd(g, image, grid)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 2)
    assert out.dtype == dtype and torch.equal(out, cuda_warp.grid_sample_fast(image, grid))
    assert first.dtype == torch.float32 and first.shape == (n, h, w, 2) and torch.equal(first, again)
    ref = cuda_warp.grid_sample_grid_backward_plain(g, image, grid)
    scale = float(ref.abs().max())
    assert scale > 0 and float((first - ref).abs().max()) <= 2e-5 * scale
    if kind == "border":
        iy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
        ix = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
        assert not iy[:, 0].any() and not ix[:, :, 0].any() and (iy[:, -1] == h - 1).all() and (ix[:, :, -1] == w - 1).all()
        assert not first[:, [0, -1], :, 1].any() and not first[:, :, [0, -1], 0].any()
    grads = []
    for device in (card, "cpu"):
        gr = grid.detach().to(device).requires_grad_()
        (cuda_warp.grid_sample_train(image.to(device), gr).float() * g.to(device).float()).sum().backward()
        grads.append(gr.grad.cpu())
    assert torch.equal(grads[0], first.cpu())
    assert float((grads[0] - grads[1]).abs().max()) <= 2e-5 * float(grads[1].abs().max())
    with pytest.raises(ValueError, match="grid dtype"):
        bwd(g, image, grid.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        bwd(g.transpose(1, 2).contiguous().transpose(1, 2), image, grid)
    assert bwd.launches == before[1] + 2 + 1  # the autograd call on the card


def test_bare_warp_refuses_a_cuda_grad_grid(card):
    image = torch.zeros((1, 16, 16, 4), device=card)
    grid = torch.zeros((1, 16, 16, 2), device=card, requires_grad=True)
    before = cuda_warp.grid_sample_fast.launches
    with pytest.raises(RuntimeError, match="grid_sample_train"):
        cuda_warp.grid_sample_fast(image, grid)
    assert cuda_warp.grid_sample_fast.launches == before


@pytest.mark.parametrize("a_dtype,out_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(3, 1001), (8, 512, 512, 90)])  # and the body student's widest layer
def test_poly_sin_kernels_match_plain(card, a_dtype, out_dtype, shape):
    """K5 forward and backward, bit-equal to the plain versions (the same
    f32 operations with no contraction), a length with a ragged tail."""
    from tha4_tpu_torch.ops import cuda_poly_sin

    rng = np.random.default_rng(9)
    a = torch.from_numpy((rng.standard_normal(shape) * 40.0).astype(np.float32)).to(card, a_dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card, out_dtype)
    before = (cuda_poly_sin.poly_sin_forward.launches, cuda_poly_sin.poly_sin_backward.launches)
    out = cuda_poly_sin.poly_sin_forward(a, out_dtype)
    da = cuda_poly_sin.poly_sin_backward(a, g)
    torch.cuda.synchronize()
    assert (cuda_poly_sin.poly_sin_forward.launches, cuda_poly_sin.poly_sin_backward.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == out_dtype and da.dtype == a_dtype
    assert torch.equal(out, cuda_poly_sin.poly_sin_plain(a, out_dtype))
    assert torch.equal(da, cuda_poly_sin.poly_sin_bwd_plain(a, g))


def test_body_student_step_launches_poly_sin_and_k3(card):
    """The body student's training forward and backward on the card: K3's
    forward and its grid backward once each and no bare K2, 9 poly_sin
    launches each way, no K1 or K4."""
    from tha4_tpu_torch.ops import cuda_poly_sin

    student = siren.SirenMorpher(generator=torch.Generator().manual_seed(3)).to(card)
    image = torch.rand((1, 512, 512, 4), device=card, dtype=torch.bfloat16) * 2 - 1
    pose = torch.rand((1, 45), device=card)
    counters = [cuda_poly_sin.poly_sin_forward, cuda_poly_sin.poly_sin_backward, cuda_warp.grid_sample_train_forward,
                cuda_warp.grid_sample_grid_backward, cuda_warp.grid_sample_fast, cuda_siren.sine_chain_t,
                cuda_siren.sine_chain_t_bwd]
    before = [c.launches for c in counters]
    outs = siren.siren_morpher_train_apply(student, image, pose, torch.bfloat16, mixed=True)
    sum(o.float().mean() for o in outs).backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [9, 9, 1, 1, 0, 0, 0]
    assert student.last_linear.weight.grad[0:2].abs().max() > 0


def _affine_conv_case(seed, n, cin, cout, h, w, skip, dtype, device):
    """K6's inputs: x, skip channels last; a shift of 1-2 so that SiLU(shift)
    is far from 0 and zero padding before the activation would show."""
    from tha4_tpu_torch.ops import cuda_conv

    rng = np.random.default_rng(seed)
    cl = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, dtype).permute(0, 3, 1, 2)
    x = cl(rng.standard_normal((n, h, w, cin)))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (n, cin)).astype(np.float32)).to(device)
    shift = torch.from_numpy(rng.uniform(1.0, 2.0, (n, cin)).astype(np.float32)).to(device)
    w9 = cuda_conv.to_w9(torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)), dtype).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(device)
    skip_t = skip_w = None
    if skip == "identity":
        skip_t = cl(rng.standard_normal((n, h, w, cout)))
    elif skip.startswith("conv"):
        cs = int(skip[4:])
        skip_t = cl(rng.standard_normal((n, h, w, cs)))
        skip_w = torch.from_numpy((rng.standard_normal((cout, cs)) / np.sqrt(cs)).astype(np.float32)).to(device, dtype)
    return x, scale, shift, w9, bias, skip_t, skip_w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,cin,cout,h,w,skip", [
    (1, 32, 7, 24, 40, "none"),         # the U-Net's last conv: Cout 7, a partial Cout block
    (2, 96, 32, 16, 16, "none"),        # an up level's conv0 input: 96 channels
    (1, 512, 256, 16, 16, "conv512"),   # the deepest up level: Cin 512 in chunks, four Cout blocks, 1x1 skip
    (1, 64, 64, 8, 8, "identity"),      # a tile larger than the image
    (2, 24, 40, 13, 21, "identity"),    # border tiles, H and W not multiples of the tile, a partial chunk
    (1, 12, 16, 13, 21, "conv20"),      # channel counts that are not multiples of 8 (scalar loads)
    (2, 64, 128, 13, 21, "identity"),   # Cout 128 in one block
    (1, 256, 256, 32, 32, "conv256"),   # Cout 256 in one block, a deep level's 1x1 skip
    (2, 96, 64, 70, 130, "conv32"),     # several 64-column tiles, ragged in both directions
    (1, 64, 300, 24, 40, "identity"),   # Cout past 256: two Cout blocks
    # The five costliest of the teacher's U-Nets at B = 8.
    (8, 32, 32, 512, 512, "identity"), (8, 96, 32, 512, 512, "none"), (8, 32, 32, 512, 512, "conv96"),
    (8, 64, 64, 512, 512, "identity"), (8, 64, 64, 256, 256, "identity"),
])
def test_affine_conv3_kernel_matches_plain(card, dtype, n, cin, cout, h, w, skip):
    """K6 against its plain version, max-abs error over max |plain|: 1e-4 in
    f32 (FMA sums in another order), 1e-2 in bf16 (the same bf16 operands,
    one final rounding, and an activation rounded to the other bf16
    neighbour now and then); two calls bit-identical."""
    from tha4_tpu_torch.ops import cuda_conv

    args = _affine_conv_case(cin * 1000 + cout, n, cin, cout, h, w, skip, dtype, card)
    before = cuda_conv.fused_affine_conv3_nchw.launches
    first = cuda_conv.fused_affine_conv3_nchw(*args)
    again = cuda_conv.fused_affine_conv3_nchw(*args)
    torch.cuda.synchronize()
    assert cuda_conv.fused_affine_conv3_nchw.launches == before + 2
    ref = cuda_conv.fused_affine_conv3_plain(*args)
    assert first.dtype == dtype and first.shape == ref.shape == (n, cout, h, w)
    assert first.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(first, again)
    err = float((first.float() - ref.float()).abs().max()) / float(ref.float().abs().max())
    assert err <= (1e-4 if dtype == torch.float32 else 1e-2), err


def test_affine_conv3_refuses_what_the_kernel_does_not_take(card):
    from tha4_tpu_torch.ops import cuda_conv

    x, scale, shift, w9, bias, _, _ = _affine_conv_case(0, 1, 16, 8, 8, 8, "none", torch.float32, card)
    before = cuda_conv.fused_affine_conv3_nchw.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        cuda_conv.fused_affine_conv3_nchw(x, scale.requires_grad_(), shift, w9, bias)
    scale = scale.detach()
    with pytest.raises(ValueError, match="channels last"):
        cuda_conv.fused_affine_conv3_nchw(x.contiguous(), scale, shift, w9, bias)
    with pytest.raises(ValueError, match="identity skip"):
        cuda_conv.fused_affine_conv3_nchw(x, scale, shift, w9, bias, x)
    assert cuda_conv.fused_affine_conv3_nchw.launches == before


def test_affine_conv3_splits_only_small_grids(card):
    """A grid that would not fill the card (the deep levels' few tiles)
    splits its channel chunks among blocks; a 512^2 batch does not; sizes
    the kernel refuses raise."""
    from tha4_tpu_torch.ops import cuda_conv

    assert cuda_conv._plan(1, 16, 16, 512, 256, 512, 2, 1)[0] > 1
    assert cuda_conv._plan(1, 16, 16, 512, 256, 512, 2, 0)[0] > 1
    assert cuda_conv._plan(8, 512, 512, 64, 64, 64, 1, 1)[0] == 1
    with pytest.raises(ValueError, match="does not take"):
        cuda_conv._plan(1, 16, 16, 512, 256, 512, 3, 1)


def _fold_case(seed, n, c, h, w, groups, films, dtype, device, mean=0.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((n, h, w, c)) * 2.0 + mean).astype(np.float32)).to(device, dtype).permute(0, 3, 1, 2)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(device)
    beta = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32)).to(device)
    # Each FiLM's (scale, shift) as the U-Net makes them: halves of one (N, 2C) linear output.
    film = tuple(torch.from_numpy((rng.standard_normal((n, 2 * c)) * 0.3).astype(np.float32)).to(device, dtype).chunk(2, dim=-1)
                 for _ in range(films))
    return x, groups, gamma, beta, film


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,groups,films,mean", [
    (2, 64, 24, 40, 32, 2, 0.0),      # a ResBlock's norm1 and its two FiLMs
    (1, 96, 16, 16, 32, 0, 0.0),      # an up level's cat: three channels a group
    (3, 24, 13, 21, 4, 1, 0.0),       # six channels a group: groups across the 16-byte vectors
    (1, 512, 16, 16, 32, 2, 0.0),     # the deepest level
    (8, 32, 64, 64, 32, 2, 0.0),      # many blocks an image
    (1, 32, 40, 40, 8, 0, 1000.0),    # a mean 500x the spread: centred statistics
    # norm1 of the costliest K6 shapes at B = 8
    (8, 32, 512, 512, 32, 2, 0.0), (8, 96, 512, 512, 32, 2, 0.0), (8, 64, 512, 512, 32, 2, 0.0),
    (8, 64, 256, 256, 32, 2, 0.0),
])
def test_fold_kernel_matches_plain(card, dtype, n, c, h, w, groups, films, mean):
    """The fold's two kernels against its plain version on the same x:
    scale and shift within 1e-5 of their largest in f32 (another order of
    f32 sums for the statistics), 1e-5 in bf16 as well (the same bf16 x read
    in f32); two calls bit-identical."""
    from tha4_tpu_torch.ops import cuda_conv

    args = _fold_case(n * 1000 + c, n, c, h, w, groups, films, dtype, card, mean)
    before = cuda_conv.fold_groupnorm_film.launches
    with torch.no_grad():
        first = cuda_conv.fold_groupnorm_film(*args, condition_bias=1.0)
        again = cuda_conv.fold_groupnorm_film(*args, condition_bias=1.0)
    torch.cuda.synchronize()
    assert cuda_conv.fold_groupnorm_film.launches == before + 2
    ref = cuda_conv.fold_groupnorm_film_plain(*args, condition_bias=1.0)
    for a, b, r in zip(first, again, ref):
        assert a.dtype == torch.float32 and a.shape == (n, c)
        assert torch.equal(a, b)
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max()), float((a - r).abs().max())


def test_fold_kernel_refuses_what_it_does_not_take(card):
    from tha4_tpu_torch.ops import cuda_conv

    x, groups, gamma, beta, film = _fold_case(1, 1, 16, 8, 8, 4, 2, torch.float32, card)
    before = cuda_conv.fold_groupnorm_film.launches
    with pytest.raises(ValueError, match="channels last"):
        cuda_conv.fold_groupnorm_film(x.contiguous(), groups, gamma, beta, film)
    with pytest.raises(ValueError, match="at most two"):
        cuda_conv.fold_groupnorm_film(x, groups, gamma, beta, film + film)
    with pytest.raises(RuntimeError, match="no gradient"):
        cuda_conv.fold_groupnorm_film(x, groups, gamma.requires_grad_(), beta, film)
    with pytest.raises(ValueError, match="does not take"):  # bf16 reads 8 channels at a time
        cuda_conv.fold_groupnorm_film(*_fold_case(2, 1, 12, 8, 8, 4, 0, torch.bfloat16, card))
    assert cuda_conv.fold_groupnorm_film.launches == before


def test_frozen_unet_reuses_one_weight_layout_per_conv(card, monkeypatch):
    """A frozen U-Net passes K6 the layouts ``Unet.store_w9`` made, so a
    call lays out no weight, and its output is bit-identical to the same
    network's before it was frozen (the wrapper laying out each call)."""
    from tha4_tpu_torch.models import unet
    from tha4_tpu_torch.ops import cuda_conv

    cfg = unet.UnetConfig(in_channels=4, out_channels=7, model_channels=32, level_channel_multipliers=(1, 2),
                          level_use_attention=(False, True), num_res_blocks_per_level=1, num_middle_res_blocks=1,
                          cond_input_channels=6, cond_internal_channels=16,
                          attention=unet.AttentionConfig(num_heads=2, use_new_attention_order=True))
    net = unet.Unet(cfg).requires_grad_(False).eval().to(card)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(torch.bfloat16)
    x = torch.rand((2, 32, 32, 4), device=card, dtype=torch.bfloat16)
    args = (torch.zeros((2, 1), device=card), torch.rand((2, 6), device=card))
    with torch.no_grad():
        unfrozen = net(x, *args)
        net.store_w9()
        made = []
        real = cuda_conv.device_weight_layout
        monkeypatch.setattr(cuda_conv, "device_weight_layout", lambda *a: made.append(1) or real(*a))
        first = net(x, *args)
        again = net(x, *args)
    torch.cuda.synchronize()
    assert not made and torch.equal(first, again) and torch.equal(first, unfrozen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,ho,wo", [(1, 33, 47, 29, 45), (3, 16, 16, 7, 9), (2, 512, 512, 512, 511)]
                         + [(8, s, s, s, s) for s in (128, 192, 256, 512)])  # the mode_07 teacher's warps at B = 8
def test_warp_kernel_at_ragged_sizes(card, dtype, n, h, w, ho, wo):
    """K2 where the output's rows and columns are not multiples of a block,
    an odd output width, and a batch: bit-identical to the plain version in
    f32 (the same f32 lerps in the same order), one bf16 step in bf16."""
    rng = np.random.default_rng(ho * wo)
    image = torch.from_numpy(rng.uniform(-1, 1, (n, h, w, 4)).astype(np.float32)).to(card, dtype)
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, ho, wo, 2)).astype(np.float32)).to(card)
    out = cuda_warp.grid_sample_fast(image, grid)
    torch.cuda.synchronize()
    ref = cuda_warp.grid_sample_bilinear_border(image, grid)
    assert out.dtype == dtype and out.shape == (n, ho, wo, 4)
    if dtype == torch.float32:
        assert torch.equal(out, ref)
    else:
        assert float((out.float() - ref.float()).abs().max()) <= 2.0**-7


# -- R1, the bilinear resize (csrc/resize.cu) -----------------------------------

# (layout, dtype, input shape, output size): the frame's two level upsamples
# (NCHW f32), the body student's training levels (NHWC, at its batch of 8 in
# bf16, and at 2), the mode_07 teacher's 512 -> 256 and 256 -> 512 hops (4
# and 2 channels), and an odd case both ways.
R1_CASES = [
    ("nchw", torch.float32, (1, 180, 128, 128), (256, 256)),
    ("nchw", torch.float32, (1, 90, 256, 256), (512, 512)),
    ("nhwc", torch.bfloat16, (8, 128, 128, 180), (256, 256)),
    ("nhwc", torch.bfloat16, (8, 256, 256, 90), (512, 512)),
    ("nhwc", torch.bfloat16, (2, 128, 128, 180), (256, 256)),
    ("nhwc", torch.bfloat16, (2, 256, 256, 90), (512, 512)),
    ("nhwc", torch.float32, (2, 128, 128, 180), (256, 256)),
    ("nhwc", torch.float32, (2, 256, 256, 90), (512, 512)),
    ("nhwc", torch.bfloat16, (2, 512, 512, 4), (256, 256)),
    ("nhwc", torch.bfloat16, (2, 256, 256, 4), (512, 512)),
    ("nhwc", torch.bfloat16, (2, 256, 256, 2), (512, 512)),
    ("nhwc", torch.float32, (2, 512, 512, 4), (256, 256)),
    ("nchw", torch.float32, (2, 3, 37, 53), (64, 29)),
    ("nhwc", torch.bfloat16, (2, 37, 53, 3), (64, 29)),
]


def _r1_input(card, layout, dtype, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0).to(card, dtype), layout == "nhwc"


@pytest.mark.parametrize("layout,dtype,shape,size", R1_CASES)
def test_resize_kernel_equals_plain(card, layout, dtype, shape, size):
    """R1's forward equals its plain version on the card bit for bit (the
    same f32 two-tap steps in the same order, one rounding to the dtype),
    on a contiguous input and on a sliced view read in place; one launch a
    call."""
    x, channels_last = _r1_input(card, layout, dtype, shape, sum(shape))
    before = cuda_resize.bilinear_resize_forward.launches
    out = cuda_resize.resize(x, size, channels_last)
    torch.cuda.synchronize()
    assert cuda_resize.bilinear_resize_forward.launches == before + 1
    ref = cuda_resize.resize_plain(x, size, channels_last)
    assert out.dtype == dtype and out.shape == ref.shape and out.is_contiguous()
    assert torch.equal(out, ref)
    view = x[:, :, :, 1:] if channels_last else x[:, :, 1:, :]
    out = cuda_resize.resize(view, size, channels_last)
    assert torch.equal(out, cuda_resize.resize_plain(view, size, channels_last))


@pytest.mark.parametrize("layout,dtype,shape,size", R1_CASES)
def test_resize_adjoint_matches_plain_gradient(card, layout, dtype, shape, size):
    """R1's adjoint through autograd against autograd of the plain version
    on the card: within 1e-6 of the plain gradient's largest value in f32,
    one bf16 step in bf16; two calls bit-identical (a gather, no atomics)."""
    x, channels_last = _r1_input(card, layout, dtype, shape, sum(shape) + 1)
    x.requires_grad_(True)
    before = cuda_resize.bilinear_resize_backward.launches
    out = cuda_resize.resize(x, size, channels_last)
    g = (torch.rand(out.shape, generator=torch.Generator().manual_seed(7)) * 2.0 - 1.0).to(card, dtype)
    out.backward(g)
    assert cuda_resize.bilinear_resize_backward.launches == before + 1
    x_ref = x.detach().clone().requires_grad_(True)
    cuda_resize.resize_plain(x_ref, size, channels_last).backward(g)
    torch.cuda.synchronize()
    got, ref = x.grad.float(), x_ref.grad.float()
    assert x.grad.dtype == dtype and got.shape == ref.shape
    if dtype == torch.float32:
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    else:
        step = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), ref.abs()).clamp_min(2.0**-126))) - 7)
        assert bool(((got - ref).abs() <= step).all())
    in_size = shape[1:3] if channels_last else shape[2:]
    again = [cuda_resize.bilinear_resize_backward(g, in_size, channels_last) for _ in range(2)]
    assert torch.equal(again[0], again[1]) and torch.equal(again[0], x.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_kernel_takes_a_steep_nchw_downsample(card, dtype):
    """A W downsample too steep for the NCHW kernel's shared memory (2000 ->
    4 columns) goes the NHWC way through a permuted view: one launch, equal
    to the plain version bit for bit, and its adjoint within the bars of
    ``test_resize_adjoint_matches_plain_gradient``."""
    x, _ = _r1_input(card, "nchw", dtype, (2, 3, 5, 2000), 2021)
    x.requires_grad_(True)
    before = cuda_resize.bilinear_resize_forward.launches
    out = cuda_resize.resize(x, (3, 4), False)
    assert cuda_resize.bilinear_resize_forward.launches == before + 1
    x_ref = x.detach().clone().requires_grad_(True)
    ref = cuda_resize.resize_plain(x_ref, (3, 4), False)
    assert out.shape == ref.shape and torch.equal(out, ref)
    g = (torch.rand(out.shape, generator=torch.Generator().manual_seed(8)) * 2.0 - 1.0).to(card, dtype)
    out.backward(g)
    ref.backward(g)
    torch.cuda.synchronize()
    got, want = x.grad.float(), x_ref.grad.float()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    else:
        step = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()).clamp_min(2.0**-126))) - 7)
        assert bool(((got - want).abs() <= step).all())


def test_a_frame_launches_the_resize_twice(card):
    """One full-width f32 student frame: R1 upsamples level 0 to 1 and 1 to
    2, two launches, and no adjoint."""
    from tha4_tpu_torch.poser.modes import mode_14

    gen = torch.Generator().manual_seed(21)
    poser = mode_14.StudentPoser(siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen),
                                 compute_dtype=torch.float32, device=card)
    image = (torch.rand((1, 512, 512, 4), generator=gen) * 2.0 - 1.0).to(card)
    pose = torch.rand((1, 45), generator=gen).to(card)
    before = (cuda_resize.bilinear_resize_forward.launches, cuda_resize.bilinear_resize_backward.launches)
    with torch.no_grad():
        for _ in range(3):
            mode_14.compute_outputs(poser.face_cfg, poser.body_cfg, poser.face_chain, poser.body_chains, image, pose)
    torch.cuda.synchronize()
    after = (cuda_resize.bilinear_resize_forward.launches, cuda_resize.bilinear_resize_backward.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (6, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_captured_frames_equal_eager_frames(card, dtype):
    """The frame bench's method (``tools.bench``): full-width student frames
    captured in one CUDA graph and replayed equal the same frames run
    eagerly, bit for bit (K1 and K2 are deterministic), output by output
    and in the bench's scalar; the capture counts 4 K1 and 1 K2 launches a
    frame, the replay none."""
    import PIL.Image

    from tha4_tpu_torch.charmodel.synthetic import synthetic_character_image
    from tha4_tpu_torch.core import imagecodec
    from tha4_tpu_torch.poser.modes import mode_14
    from tha4_tpu_torch.tools import bench

    gen = torch.Generator().manual_seed(14)
    poser = mode_14.StudentPoser(siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen),
                                 compute_dtype=dtype, device=card)
    image = imagecodec.load_image_hwc(PIL.Image.fromarray(synthetic_character_image(512, seed=4), mode="RGBA"))
    image = torch.from_numpy(image)[None].to(card, dtype)
    poses = torch.from_numpy(bench.pose_sweep(poser.pose_parameters, 3)).to(card, dtype)

    def frames():
        return [mode_14.compute_outputs(poser.face_cfg, poser.body_cfg, poser.face_chain, poser.body_chains,
                                        image, poses[i : i + 1]) for i in range(poses.shape[0])]

    with torch.no_grad():
        eager = frames()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = (cuda_siren.sine_chain_t.launches, cuda_warp.grid_sample_fast.launches)
        with torch.cuda.graph(graph):
            captured = frames()
        counted = (cuda_siren.sine_chain_t.launches, cuda_warp.grid_sample_fast.launches)
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
    assert (counted[0] - before[0], counted[1] - before[1]) == (12, 3)
    assert (cuda_siren.sine_chain_t.launches, cuda_warp.grid_sample_fast.launches) == counted
    for e, c in zip(eager, captured):
        for a, b in zip(e, c):
            assert torch.equal(a, b)
    result = bench.measure(poser, image, poses)
    assert result["graph_scalar"] == result["eager_scalar"] and math.isfinite(result["graph_scalar"])
    assert result["launches_at_capture"] == {"sine_chain_t": 12, "grid_sample_fast": 3}


@pytest.mark.parametrize("student", ["face", "body"])
def test_a_step_after_a_sample_render_equals_one_without(card, tmp_path, student):
    """The distiller's trainer renders its sample grid at 0, before the first
    step, and the render is the first to make the cached grids and resize
    tables: one step after it (full-width random teachers and students,
    bf16, batch 2) equals the same step with sample outputs off, bit for
    bit, with cuDNN in its deterministic mode."""
    import dataclasses

    from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, write_distiller_inputs
    from tha4_tpu_torch.distiller import sample_output
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.distiller.pipeline import DistillationJobs
    from tha4_tpu_torch.ops import cuda_resize, warp

    config = DistillerConfig.load(write_distiller_inputs(str(tmp_path / "inputs"), seed=5, batch_size=2, sample_cadence=10_000))
    params = random_teacher_07(torch.Generator().manual_seed(55))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = []
        for render in (True, False):
            warp._identity_grid.cache_clear()
            cuda_resize.taps.cache_clear()
            prefix = str(tmp_path / f"render_{render}")
            os.makedirs(prefix)
            jobs = DistillationJobs(dataclasses.replace(config, prefix=prefix), teacher_params_07=params, device=card,
                                    face_total_examples=2, body_total_examples=2, examples_per_checkpoint=2,
                                    examples_per_snapshot=2)
            trainer = jobs.make_face_trainer() if student == "face" else jobs.make_body_trainer()
            if not render:
                trainer.sample_output_fn = None
            result = trainer.train()
            assert result["examples_seen"] == 2
            png = sample_output.sample_output_file_name(trainer.cfg.prefix, 0)
            assert os.path.isfile(png) == render
            states.append({k: v.cpu() for k, v in result["module"].state_dict().items()})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert states[0].keys() == states[1].keys()
    for name in states[0]:
        assert torch.equal(states[0][name], states[1][name]), name


# -- Q1, the int8 teacher's conv (csrc/int8_conv.cu) --------------------------


def _q1_case(card, dtype, n, h, w, cin, cout, k, seed):
    from tha4_tpu_torch.ops import cuda_int8_conv, quant

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=gen).to(dtype)
    wf = torch.randn((k, k, cin, cout), generator=gen) * 0.1
    w8, w_s = quant.quantize_weight(wf)
    bias = (torch.randn(cout, generator=gen) * 0.1).to(dtype)
    scale = float(x.float().abs().max()) * 1.1 / 127.0
    layout = cuda_int8_conv.weight_layout(w8)
    ref = cuda_int8_conv.int8_conv(x, layout, w_s, scale, k // 2, bias)  # the plain version, on the CPU
    args = (x.to(card), layout._replace(tensor=layout.tensor.to(card)), w_s.to(card), scale, k // 2, bias.to(card))
    return args, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,cout,k", [(2, 17, 23, 64, 96, 3), (1, 24, 24, 59, 32, 3), (3, 9, 31, 48, 16, 3),
                                              (2, 16, 16, 128, 200, 1), (1, 13, 7, 16, 70, 1),
                                              (2, 19, 70, 4, 32, 3), (1, 24, 24, 32, 4, 3), (8, 16, 16, 512, 256, 3),
                                              (8, 72, 130, 96, 128, 3), (1, 512, 512, 64, 32, 1), (2, 80, 70, 64, 128, 1),
                                              (8, 16, 16, 256, 768, 1), (8, 32, 32, 512, 256, 1), (2, 17, 70, 59, 70, 3),
                                              (1, 40, 130, 64, 32, 1), (8, 128, 128, 256, 256, 3)])
def test_q1_equals_its_plain_version_bit_for_bit(card, dtype, n, h, w, cin, cout, k):
    """Exact integer sums on both sides, so the same bits: on ragged pixel
    counts and widths that are not a multiple of the 64-column tile (70,
    130), Cin 4 and not a multiple of 16 or 32 (59: the pose-concatenated
    bottleneck), Cout 4, 70 and past one 128-channel block (200, 256, 768),
    3x3 and 1x1 (at 512^2, 64 -> 32, the upscaler's skip; the teachers'
    16^2 and 32^2 1x1 convs); the K chunks split among blocks (16^2, Cin
    512, and every small grid) and not (130 wide, three chunks)."""
    from tha4_tpu_torch.ops import cuda_int8_conv

    args, ref = _q1_case(card, dtype, n, h, w, cin, cout, k, seed=cin + cout)
    before = cuda_int8_conv.int8_conv.launches
    out = cuda_int8_conv.int8_conv(*args)
    torch.cuda.synchronize()
    assert cuda_int8_conv.int8_conv.launches == before + 1
    assert out.dtype == dtype and torch.equal(out.cpu(), ref)
    plain = cuda_int8_conv.int8_conv_plain(args[0], cuda_int8_conv._hwio(args[1]), *args[2:])
    assert torch.equal(out, plain)  # the plain version on the card too
    assert torch.equal(cuda_int8_conv.int8_conv(*args), out)  # two calls, the same bits


def test_q1_raises_on_what_it_does_not_take(card):
    from tha4_tpu_torch.ops import cuda_int8_conv

    (x, layout, w_s, scale, pad, bias), _ = _q1_case(card, torch.float32, 1, 8, 8, 32, 32, 3, seed=1)
    with pytest.raises(ValueError, match="f32 or bf16"):
        cuda_int8_conv.int8_conv(x.half(), layout, w_s, scale, pad, None)
    with pytest.raises(ValueError, match="padding"):
        cuda_int8_conv.int8_conv(x, layout, w_s, scale, 0, bias)
    with pytest.raises(ValueError, match="bias"):
        cuda_int8_conv.int8_conv(x, layout, w_s, scale, pad, bias.double())
    with pytest.raises(ValueError, match="x's device"):
        cuda_int8_conv.int8_conv(x, layout._replace(tensor=layout.tensor.cpu()), w_s, scale, pad, bias)
    with pytest.raises(ValueError, match="w_scale"):  # 16 of the layout's 32 output channels
        cuda_int8_conv.int8_conv(x, layout, w_s[:16].contiguous(), scale, pad, bias[:16].contiguous())


def test_resblock_under_a_scope_launches_q1_not_k6(card):
    """A U-Net ResBlock with a 1x1 skip, frozen on the card: under
    ``apply_scales`` it launches Q1 for conv0, conv1 and the skip and no
    K6; outside the scope K6 and no Q1."""
    from tha4_tpu_torch.models import unet
    from tha4_tpu_torch.ops import cuda_conv, cuda_int8_conv, quant

    gen = torch.Generator().manual_seed(3)
    block = unet.ResBlock(32, 64, 16)
    for p in block.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1, generator=gen)
    block.requires_grad_(False).eval().to(card)
    quant.store_int8(block)
    x = torch.randn((2, 16, 16, 32), generator=gen).to(card)
    cond = torch.randn((2, 16), generator=gen).to(card)
    scales = quant.run_calibration(block, x, cond, cond, 1.0)
    assert [e["sig"][1] for e in scales] == [[3, 3, 32, 64], [3, 3, 64, 64], [1, 1, 32, 64]]
    k6, q1 = cuda_conv.fused_affine_conv3_nchw.launches, cuda_int8_conv.int8_conv.launches
    with torch.no_grad(), quant.apply_scales(scales):
        out = block(x, cond, cond, 1.0)
    torch.cuda.synchronize()
    assert (cuda_conv.fused_affine_conv3_nchw.launches - k6, cuda_int8_conv.int8_conv.launches - q1) == (0, 3)
    with torch.no_grad():
        block(x, cond, cond, 1.0)
    assert (cuda_conv.fused_affine_conv3_nchw.launches - k6, cuda_int8_conv.int8_conv.launches - q1) == (2, 3)
    assert out.shape == (2, 16, 16, 64) and bool(torch.isfinite(out).all())
