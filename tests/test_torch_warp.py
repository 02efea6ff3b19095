"""K2 (the bilinear border warp) and the resize ops of the PyTorch port
against the JAX package.

``grid_sample_bilinear_border`` is the port's plain version of the CUDA
kernel ``csrc/warp.cu``; on the CPU ``grid_sample_fast`` runs it.  It is held
against JAX's exact warp and, within that kernel's displacement budget,
against the interpreted Pallas kernel (set up as tests/test_pallas_warp.py
sets it up).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.ops import pallas_warp
from tha4_tpu.ops import resize as jresize
from tha4_tpu.ops import warp as jwarp
from tha4_tpu_torch.ops import cuda_warp, resize, warp

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _smooth_flow(rng, n, h, w, amplitude):
    """A smooth (N, H, W, 2) offset field: an 8x8 random field upsampled."""
    coarse = rng.standard_normal((n, 2, 8, 8)).astype(np.float32) * amplitude
    flow = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=(h, w), mode="bilinear", align_corners=False)
    return flow.permute(0, 2, 3, 1).contiguous().numpy()


def test_identity_grid_matches_jax():
    np.testing.assert_array_equal(warp.identity_grid(37, 53).numpy(), np.asarray(jwarp.identity_grid(37, 53)))


@pytest.mark.parametrize(
    "name,grid_fn",
    [
        # Out of [-1, 1] in both directions: border clamps on every side.
        ("border", lambda rng, shape: rng.uniform(-1.7, 1.7, shape)),
        # Displacements of up to about half the image, far past any window.
        ("large", lambda rng, shape: np.asarray(jwarp.identity_grid(*shape[1:3]))[None] + rng.uniform(-1.0, 1.0, shape)),
        # Exact pixel centres and the image edge, where floor() and the corner clamp meet.
        ("centres", lambda rng, shape: np.asarray(jwarp.identity_grid(*shape[1:3]))[None].repeat(shape[0], 0)),
    ],
)
def test_plain_warp_matches_jax_f32(name, grid_fn):
    rng = np.random.default_rng(10)
    image = rng.standard_normal((2, 24, 40, 4)).astype(np.float32)
    grid = grid_fn(rng, (2, 24, 40, 2)).astype(np.float32)
    ref = np.asarray(jwarp.grid_sample_bilinear_border(jnp.asarray(image), jnp.asarray(grid)))
    ours = cuda_warp.grid_sample_bilinear_border(torch.from_numpy(image), torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_plain_warp_bf16_image_matches_jax():
    """A bf16 image is lerped in f32 and cast once: at most one bf16 step
    (2^-7 at |x| < 2) from JAX, which does the same."""
    rng = np.random.default_rng(11)
    image = rng.uniform(-1.0, 1.0, (1, 32, 32, 4)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (1, 32, 32, 2)).astype(np.float32)
    ref = jwarp.grid_sample_bilinear_border(jnp.asarray(image).astype(jnp.bfloat16), jnp.asarray(grid))
    ours = cuda_warp.grid_sample_bilinear_border(torch.from_numpy(image).bfloat16(), torch.from_numpy(grid))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2.0**-7)


@pytest.mark.parametrize("size", [128, 256])
def test_plain_warp_matches_interpreted_pallas(interpret, size):
    rng = np.random.default_rng(size)
    image = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    by, bx = pallas_warp.displacement_budget_px(image.shape, (1, size, size, 2))
    flow = _smooth_flow(rng, 1, size, size, 0.05)
    # Keep every displacement inside the TPU kernel's window budget.
    limit = np.float32([bx / (size / 2.0), by / (size / 2.0)])
    flow = np.clip(flow, -0.9 * limit, 0.9 * limit)
    grid = (np.asarray(jwarp.identity_grid(size, size))[None] + flow).astype(np.float32)
    ref = np.asarray(pallas_warp.grid_sample_fast(jnp.asarray(image), jnp.asarray(grid)))
    ours = cuda_warp.grid_sample_fast(torch.from_numpy(image), torch.from_numpy(grid)).numpy()
    # The precedent of tests/test_pallas_warp.py:41 (the TPU kernel's folded
    # lerp weights go through a DEFAULT-precision dot).
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("how", ["apply_grid_change", "grid_sample_bilinear_border"])
def test_apply_grid_change_matches_jax(how):
    """The warp by a grid change, and the plain warp on identity plus that
    change, against the JAX package's exact warp."""
    rng = np.random.default_rng(12)
    image = rng.standard_normal((2, 32, 48, 4)).astype(np.float32)
    grid_change = _smooth_flow(rng, 2, 32, 48, 0.3)
    ref = np.asarray(jwarp.apply_grid_change(jnp.asarray(grid_change), jnp.asarray(image), fast="never"))
    if how == "apply_grid_change":
        ours = warp.apply_grid_change(torch.from_numpy(grid_change), torch.from_numpy(image))
    else:
        grid = warp.identity_grid(32, 48)[None] + torch.from_numpy(grid_change)
        ours = cuda_warp.grid_sample_bilinear_border(torch.from_numpy(image), grid)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_apply_grid_change_broadcasts_one_flow():
    rng = np.random.default_rng(13)
    image = torch.from_numpy(rng.standard_normal((3, 16, 16, 4)).astype(np.float32))
    grid_change = torch.from_numpy(_smooth_flow(rng, 1, 16, 16, 0.2))
    out = warp.apply_grid_change(grid_change, image)
    for i in range(3):
        torch.testing.assert_close(out[i : i + 1], warp.apply_grid_change(grid_change, image[i : i + 1]))


def test_color_and_rgb_change_match_jax():
    rng = np.random.default_rng(14)
    alpha = rng.uniform(0, 1, (1, 8, 8, 1)).astype(np.float32)
    color = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    image = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (alpha, color, image)]
    np.testing.assert_allclose(warp.apply_color_change(*t).numpy(), np.asarray(jwarp.apply_color_change(alpha, color, image)), atol=1e-6)
    np.testing.assert_allclose(warp.apply_rgb_change(*t).numpy(), np.asarray(jwarp.apply_rgb_change(alpha, color, image)), atol=1e-6)


def test_warp_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(15)
    image = torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1, 1, (1, 16, 16, 2)).astype(np.float32))
    before = cuda_warp.grid_sample_fast.launches
    torch.testing.assert_close(cuda_warp.grid_sample_fast(image, grid), cuda_warp.grid_sample_bilinear_border(image, grid), rtol=0, atol=0)
    assert cuda_warp.grid_sample_fast.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_warp.grid_sample_fast(image.to("meta"), grid.to("meta"))


# Upsamples (the frame's and the student's levels), a mixed resize, the
# teacher's downsample, odd sizes both ways, and one axis unchanged.
RESIZE_CASES = [((128, 128), (256, 256)), ((256, 256), (512, 512)), ((64, 48), (40, 80)), ((512, 512), (256, 256)),
                ((37, 53), (64, 29)), ((16, 16), (16, 24)), ((9, 7), (5, 7))]


@pytest.mark.parametrize("hw_in,hw_out", RESIZE_CASES)
def test_resize_matches_bilinear_matrices(hw_in, hw_out):
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 3, *hw_in)).astype(np.float32)
    mh = jresize._bilinear_matrix_np(hw_in[0], hw_out[0])
    mw = jresize._bilinear_matrix_np(hw_in[1], hw_out[1])
    want = mh.T @ x @ mw
    ours = resize.resize_bilinear_nchw(torch.from_numpy(x), hw_out).numpy()
    np.testing.assert_allclose(ours, want, atol=1e-5)
    ref = np.asarray(jresize.resize_bilinear_nchw(jnp.asarray(x), hw_out))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    nhwc = x.transpose(0, 2, 3, 1)
    ours_nhwc = resize.resize_bilinear(torch.from_numpy(nhwc), hw_out).numpy()
    np.testing.assert_allclose(ours_nhwc, np.asarray(jresize.resize_bilinear(jnp.asarray(nhwc), hw_out)), atol=1e-5)


@pytest.mark.parametrize("hw_in,hw_out", RESIZE_CASES)
def test_resize_plain_is_the_two_tap_formula(hw_in, hw_out):
    """R1's plain version, both layouts, equals the two-tap formula in f32
    bit for bit: per axis fl(fl(w0 * a) + fl(w1 * b)) with the taps and
    weights of the JAX package's matrix rule, H first, then W.  The kernel
    (csrc/resize.cu) is held to the plain version bit for bit on the card."""
    x = np.random.default_rng(20).standard_normal((2, 3, *hw_in)).astype(np.float32)

    def axis(x, n_in, n_out, ax):
        if n_in == n_out:
            return x
        src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1.0)
        i0 = np.floor(src).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        t = src - i0
        shape = (-1,) + (1,) * (x.ndim - 1 - ax)
        w0, w1 = (1.0 - t).astype(np.float32).reshape(shape), t.astype(np.float32).reshape(shape)
        return w0 * np.take(x, i0, axis=ax) + w1 * np.take(x, i1, axis=ax)

    want = axis(axis(x, hw_in[0], hw_out[0], 2), hw_in[1], hw_out[1], 3)
    np.testing.assert_array_equal(resize.resize_bilinear_nchw(torch.from_numpy(x), hw_out).numpy(), want)
    nhwc = resize.resize_bilinear(torch.from_numpy(x.transpose(0, 2, 3, 1)), hw_out)
    assert nhwc.is_contiguous()
    np.testing.assert_array_equal(nhwc.numpy(), want.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("hw_in,hw_out", RESIZE_CASES)
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_resize_gradient_matches_jax_vjp(hw_in, hw_out, layout):
    """The plain version's gradient (autograd on the CPU, the adjoint
    kernel's reference) against the VJP of the JAX package's resize."""
    import jax

    rng = np.random.default_rng(21)
    shape = (2, 3, *hw_in) if layout == "nchw" else (2, *hw_in, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    ours_fn, jax_fn = ((resize.resize_bilinear_nchw, jresize.resize_bilinear_nchw) if layout == "nchw"
                       else (resize.resize_bilinear, jresize.resize_bilinear))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ours_fn(xt, hw_out)
    g = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: jax_fn(a, hw_out), jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)


def test_resize_reads_views_in_place_keeps_f64_and_refuses_other_devices():
    """A permuted or sliced view resizes as its contiguous copy would; f64
    stays f64 on the plain version; the CPU launches nothing; a device that
    is neither the CPU nor CUDA raises."""
    from tha4_tpu_torch.ops import cuda_resize

    x = torch.from_numpy(np.random.default_rng(22).standard_normal((2, 9, 10, 12)).astype(np.float32))
    view = x[..., 3:8]
    before = cuda_resize.bilinear_resize_forward.launches
    torch.testing.assert_close(resize.resize_bilinear(view, (17, 6)), resize.resize_bilinear(view.contiguous(), (17, 6)),
                               rtol=0, atol=0)
    nchw = x.permute(0, 3, 1, 2)
    torch.testing.assert_close(resize.resize_bilinear_nchw(nchw, (5, 20)),
                               resize.resize_bilinear_nchw(nchw.contiguous(), (5, 20)), rtol=0, atol=0)
    assert cuda_resize.bilinear_resize_forward.launches == before
    wide = resize.resize_bilinear_nchw(nchw.double(), (5, 20))
    assert wide.dtype == torch.float64
    torch.testing.assert_close(wide.float(), resize.resize_bilinear_nchw(nchw, (5, 20)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        resize.resize_bilinear(x.to("meta"), (4, 4))


def test_resize_bf16_computes_in_f32_then_casts():
    x = torch.from_numpy(np.random.default_rng(17).standard_normal((1, 2, 16, 16)).astype(np.float32)).bfloat16()
    out = resize.resize_bilinear_nchw(x, (32, 32))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, resize.resize_bilinear_nchw(x.float(), (32, 32)).bfloat16(), rtol=0, atol=0)


def test_nearest_and_avg_2x_match_jax():
    x = np.random.default_rng(18).standard_normal((2, 6, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(resize.upsample_nearest_2x(torch.from_numpy(x)).numpy(), np.asarray(jresize.upsample_nearest_2x(jnp.asarray(x))))
    np.testing.assert_allclose(resize.downsample_avg_2x(torch.from_numpy(x)).numpy(), np.asarray(jresize.downsample_avg_2x(jnp.asarray(x))), atol=1e-6)


def _warp_probe():
    """``tools/warp_probe.py``, a script rather than a package module, loaded by its path."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "warp_probe.py"
    spec = importlib.util.spec_from_file_location("warp_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("size,th,kh", [(128, 64, 128), (256, 64, 192)])
def test_probe_variant_is_k2_on_its_bf16_image(interpret, size, th, kh):
    """The TPU probe ``tools/warp_probe.py:variant_forward`` with its
    ``_fwd_kernel_bf16`` (interpreted: two bf16 one-hot matmuls and an f32
    lerp) computes K2's function: on a seeded bf16 image in [0, 1) and
    displacements inside its window it is within one bf16 step of the output
    (2^-8 below 1: the probe lerps y first, K2 x first, both in f32, and the
    rounding to bf16 can then fall to either neighbour) of K2's plain version,
    ``grid_sample_bilinear_border``, on the same image and f32 grid."""
    probe = _warp_probe()
    rng = np.random.default_rng(size)
    image = rng.uniform(0.0, 1.0, (1, size, size, 4)).astype(np.float32)
    flow = _smooth_flow(rng, 1, size, size, 0.1)
    # Vertical displacements within the window's budget of (kh - th - 8) / 2 rows.
    budget = (kh - th - 8) / 2.0 * 0.9 / (size / 2.0)
    flow[..., 1] = np.clip(flow[..., 1], -budget, budget)
    grid = (np.asarray(jwarp.identity_grid(size, size))[None] + flow).astype(np.float32)
    image16 = jnp.asarray(image).astype(jnp.bfloat16)
    out = probe.variant_forward(jnp.transpose(image16, (0, 3, 1, 2)), jnp.asarray(grid[..., 0]), jnp.asarray(grid[..., 1]),
                                size, th, kh, probe._fwd_kernel_bf16)
    ours = jnp.transpose(out, (0, 2, 3, 1)).astype(jnp.float32)
    k2 = cuda_warp.grid_sample_fast(torch.from_numpy(np.array(image16.astype(jnp.float32))).bfloat16(), torch.from_numpy(grid))
    assert k2.dtype == torch.bfloat16 and out.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(ours), k2.float().numpy(), atol=2.0**-8, rtol=0)
