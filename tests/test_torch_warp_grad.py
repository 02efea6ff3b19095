"""K3, the differentiable warp of the PyTorch port, against the JAX package.

K3's forward is K2's kernel; its backward, ``grid_sample_grid_backward``
(``csrc/warp.cu``), gathers the corners again.  On the CPU both run their
plain versions: ``grid_sample_bilinear_border`` and
``grid_sample_grid_backward_plain``, the JAX package's elementwise formula
over ``grid_sample_corners_plain``'s fields (the TPU corners kernel's
outputs).  The fields, the backward and the gradient through
``grid_sample_train`` are held against ``jax.grad`` over the exact warp
(``tha4_tpu/ops/warp.py:grid_sample_bilinear_border``) and against the
Pallas warp's custom VJP (``pallas_warp.grid_sample_fast``, interpreted as
tests/test_pallas_warp.py:18-25 runs it), at that test's bar: 2e-5 of the
gradient's largest magnitude, at 128^2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.ops import pallas_warp
from tha4_tpu.ops import warp as jwarp
from tha4_tpu_torch.ops import cuda_warp, warp

torch.set_num_threads(2)

GRAD_ATOL = 2e-5  # tests/test_pallas_warp.py:44-60, scaled by the largest gradient


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _smooth_grid(seed, n, size, scale=0.05):
    """Identity plus an 8x8 random field upsampled, as tests/test_pallas_warp.py:28-31."""
    coarse = jax.random.normal(jax.random.PRNGKey(seed), (n, 8, 8, 2), jnp.float32) * scale
    flow = jax.image.resize(coarse, (n, size, size, 2), "bilinear")
    return np.array(jwarp.identity_grid(size, size)[None] + flow)


def _image(seed, n, size):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, size, size, 4), jnp.float32))


def _port_grad(image, grid, image_requires_grad=False):
    image = torch.from_numpy(image).requires_grad_(image_requires_grad)
    grid = torch.from_numpy(grid).requires_grad_()
    out = cuda_warp.grid_sample_train(image, grid)
    (out.float() ** 2).sum().backward()
    return out.detach(), grid.grad, image.grad


def test_corners_forward_matches_jax_and_k2():
    """out equals K2's plain warp bit for bit and JAX's exact warp to f32
    rounding; dx and dy are the derivatives of the bilinear sample along the
    source x and y: central differences of the exact warp, in pixels."""
    size = 64
    image, grid = _image(1, 2, size), _smooth_grid(1, 2, size, 0.2)
    out, dx, dy = cuda_warp.grid_sample_corners_plain(torch.from_numpy(image), torch.from_numpy(grid))
    assert out.dtype == dx.dtype == dy.dtype == torch.float32 and dx.shape == dy.shape == (2, size, size, 4)
    assert torch.equal(out, cuda_warp.grid_sample_bilinear_border(torch.from_numpy(image), torch.from_numpy(grid)))
    ref = np.asarray(jwarp.grid_sample_bilinear_border(jnp.asarray(image), jnp.asarray(grid)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    eps = 1e-3  # pixels; the bilinear sample is linear between texel centres
    for axis, d in ((0, dx), (1, dy)):
        step = np.zeros(2, np.float32)
        step[axis] = eps * 2.0 / size
        plus = jwarp.grid_sample_bilinear_border(jnp.asarray(image), jnp.asarray(grid + step))
        minus = jwarp.grid_sample_bilinear_border(jnp.asarray(image), jnp.asarray(grid - step))
        fd = np.asarray(plus - minus) / (2 * eps)
        # Away from texel-centre crossings, where the one-sided slopes differ,
        # and from the border clamp, where the backward's mask zeroes D.
        i = ((grid[..., axis] + 1.0) * size - 1.0) * 0.5
        inside = (np.abs(i - np.round(i)) > 2 * eps) & (i > 2 * eps) & (i < size - 1 - 2 * eps)
        np.testing.assert_allclose(d.numpy()[inside], fd[inside], atol=2e-2)


def test_corners_forward_matches_interpreted_pallas_fields(interpret):
    """The plain dx / dy against the Pallas kernel's own
    (``_grid_sample_fast_fwd`` residuals, NCHW there) inside its window
    budget."""
    size = 128
    image, grid = _image(2, 1, size), _smooth_grid(2, 1, size)
    out_ref, (dx_ref, dy_ref, *_) = pallas_warp._grid_sample_fast_fwd(jnp.asarray(image), jnp.asarray(grid))
    out, dx, dy = cuda_warp.grid_sample_corners_plain(torch.from_numpy(image), torch.from_numpy(grid))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.transpose(np.asarray(dx_ref), (0, 2, 3, 1)), atol=1e-5)
    np.testing.assert_allclose(dy.numpy(), np.transpose(np.asarray(dy_ref), (0, 2, 3, 1)), atol=1e-5)


def test_grid_gradient_matches_jax_grad_of_exact_warp():
    size = 128
    image, grid = _image(0, 1, size), _smooth_grid(0, 1, size)
    ref = np.asarray(jax.grad(lambda g: (jwarp.grid_sample_bilinear_border(jnp.asarray(image), g) ** 2).sum())(jnp.asarray(grid)))
    _, dgrid, _ = _port_grad(image, grid)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(dgrid.numpy() / scale, ref / scale, atol=GRAD_ATOL)


def test_grid_gradient_matches_interpreted_pallas_vjp(interpret):
    size = 128
    image, grid = _image(3, 1, size), _smooth_grid(3, 1, size)
    ref = np.asarray(jax.grad(lambda g: (pallas_warp.grid_sample_fast(jnp.asarray(image), g) ** 2).sum())(jnp.asarray(grid)))
    _, dgrid, _ = _port_grad(image, grid)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(dgrid.numpy() / scale, ref / scale, atol=GRAD_ATOL)


def test_border_clamp_zeroes_the_gradient():
    """Samples outside [-1, 1] clamp to the border: no gradient there (the
    strict masks of pallas_warp.py:344-345), as JAX's autodiff of the exact
    warp's clip gives."""
    rng = np.random.default_rng(4)
    image = rng.standard_normal((2, 24, 40, 4)).astype(np.float32)
    grid = rng.uniform(-1.7, 1.7, (2, 24, 40, 2)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda g: (jwarp.grid_sample_bilinear_border(jnp.asarray(image), g) ** 2).sum())(jnp.asarray(grid)))
    _, dgrid, _ = _port_grad(image, grid)
    outside = np.abs(grid) > 1.0
    assert outside.mean() > 0.3 and not dgrid.numpy()[outside].any()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(dgrid.numpy() / scale, ref / scale, atol=GRAD_ATOL)


def test_image_cotangent_is_zero():
    """The contract of pallas_warp.py:24-31: the fast warp's image cotangent
    is exactly zero, while the plain warp (``grid_sample_bilinear_border``)
    differentiates the image."""
    size = 32
    image, grid = _image(5, 1, size), _smooth_grid(5, 1, size)
    _, _, dimage = _port_grad(image, grid, image_requires_grad=True)
    assert dimage is not None and dimage.shape == image.shape and not dimage.any()
    im = torch.from_numpy(image).requires_grad_()
    (cuda_warp.grid_sample_bilinear_border(im, warp.identity_grid(size, size)[None]) ** 2).sum().backward()
    assert im.grad.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_grid_change_under_grad_reaches_the_grid(dtype):
    """A grid change that needs a gradient goes through K3 (one
    GridSampleFunction node), and its gradient is JAX's through the exact
    warp; a bf16 image is sampled in f32 and its output cast, K2's values."""
    rng = np.random.default_rng(6)
    size = 48
    image = rng.uniform(-1, 1, (2, size, size, 4)).astype(np.float32)
    change = (0.05 * _smooth_grid(6, 2, size, 1.0) - 0.05 * np.asarray(jwarp.identity_grid(size, size))).astype(np.float32)
    gc = torch.from_numpy(change).requires_grad_()
    img = torch.from_numpy(image).to(dtype)
    out = warp.apply_grid_change(gc, img)
    assert type(out.grad_fn).__name__ == "GridSampleFunctionBackward" and out.dtype == dtype
    with torch.no_grad():
        torch.testing.assert_close(out, warp.apply_grid_change(gc, img), rtol=0, atol=0)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    # The exact warp over the image's values in f32 (JAX's jnp path would take
    # the corner differences in bf16; the Pallas kernel, like K3, in f32),
    # its output rounded to the image dtype.
    jimg = jnp.asarray(img.float().numpy())
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def loss(c):
        return (jwarp.apply_grid_change(c, jimg, fast="never").astype(jdtype).astype(jnp.float32) * cot).sum()

    ref = np.asarray(jax.grad(loss)(jnp.asarray(change)))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(gc.grad.numpy() / scale, ref / scale, atol=GRAD_ATOL)


def test_bare_k2_refuses_a_gradient():
    """grid_sample_fast has no autograd: under grad mode it refuses a grid
    (or image) that requires a gradient, on the CPU as on the card, instead
    of dropping the gradient; under no_grad it runs."""
    image = torch.zeros((1, 8, 8, 4))
    grid = torch.zeros((1, 8, 8, 2), requires_grad=True)
    with pytest.raises(RuntimeError, match="grid_sample_train"):
        cuda_warp.grid_sample_fast(image, grid)
    with pytest.raises(RuntimeError, match="no gradient"):
        cuda_warp.grid_sample_fast(image.requires_grad_(), grid.detach())
    with torch.no_grad():
        assert cuda_warp.grid_sample_fast(image, grid).shape == (1, 8, 8, 4)


def _bf16_exact(a, dtype):
    """``a`` in ``dtype`` as a torch tensor and as the same values in numpy f32."""
    t = torch.from_numpy(a).to(dtype)
    return t, t.float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_backward_plain_matches_jax_vjp_of_interpreted_pallas(interpret, dtype):
    """K3's plain backward against ``jax.vjp`` of the Pallas warp for a
    random cotangent, with an f32 and a bf16 image (the cotangent in the
    output's dtype, as autograd hands it over)."""
    size = 128
    rng = np.random.default_rng(20)
    image, image_np = _bf16_exact(_image(20, 1, size), dtype)
    grid = _smooth_grid(20, 1, size)
    g, g_np = _bf16_exact(rng.standard_normal((1, size, size, 4)).astype(np.float32), dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out, vjp = jax.vjp(lambda gr: pallas_warp.grid_sample_fast(jnp.asarray(image_np).astype(jdtype), gr), jnp.asarray(grid))
    (ref,) = vjp(jnp.asarray(g_np).astype(out.dtype))
    ref = np.asarray(ref)
    dgrid = cuda_warp.grid_sample_grid_backward_plain(g, image, torch.from_numpy(grid))
    assert dgrid.dtype == torch.float32 and dgrid.shape == (1, size, size, 2)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(dgrid.numpy() / scale, ref / scale, atol=GRAD_ATOL)


def test_grid_backward_plain_matches_jax_bwd_on_its_own_residuals(interpret):
    """``_grid_sample_fast_bwd`` over the residuals the interpreted Pallas
    forward saved, against the plain backward from the image and the grid:
    the same function, without the fields between forward and backward.
    JAX's image cotangent is zero, as the port's."""
    size = 128
    rng = np.random.default_rng(21)
    image, grid = _image(21, 2, size), _smooth_grid(21, 2, size)
    g = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    _, residual = pallas_warp._grid_sample_fast_fwd(jnp.asarray(image), jnp.asarray(grid))
    dimage_ref, ref = pallas_warp._grid_sample_fast_bwd(residual, jnp.asarray(g))
    assert not np.asarray(dimage_ref).any()
    ref = np.asarray(ref)
    dgrid = cuda_warp.grid_sample_grid_backward_plain(torch.from_numpy(g), torch.from_numpy(image), torch.from_numpy(grid))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(dgrid.numpy() / scale, ref / scale, atol=GRAD_ATOL)


def test_autograd_saves_only_the_image_and_the_grid():
    """The differentiable warp keeps no (N, Ho, Wo, 4) f32 field for its
    backward: what autograd saves is the image and the grid themselves."""
    rng = np.random.default_rng(22)
    image = torch.from_numpy(rng.standard_normal((2, 16, 24, 4)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1, 1, (2, 12, 20, 2)).astype(np.float32)).requires_grad_()
    out = cuda_warp.grid_sample_train(image, grid)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == image.data_ptr() and torch.equal(saved[0], image)
    assert saved[1].data_ptr() == grid.data_ptr() and torch.equal(saved[1], grid)
    assert not any(t.shape == out.shape and t.dtype == torch.float32 for t in saved)


def test_inference_image_still_trains():
    """An image made under ``torch.inference_mode`` (a frame rendered before
    training) cannot be saved for backward as it is; the warp keeps a normal
    copy, and the grid's gradient is the one a normal image gives."""
    rng = np.random.default_rng(23)
    image_np = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    grid_np = rng.uniform(-1, 1, (1, 16, 16, 2)).astype(np.float32)
    with torch.inference_mode():
        frozen = torch.from_numpy(image_np).clone()
    grads = []
    for image in (frozen, torch.from_numpy(image_np)):
        grid = torch.from_numpy(grid_np).requires_grad_()
        (cuda_warp.grid_sample_train(image, grid) ** 2).sum().backward()
        grads.append(grid.grad)
    assert frozen.is_inference() and torch.equal(grads[0], grads[1])


def test_grid_backward_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    """K3's wrappers on CPU tensors run the plain versions and count no
    launch; on any device but the CPU and CUDA they raise."""
    rng = np.random.default_rng(7)
    image = torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1, 1, (1, 16, 16, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32))
    before = cuda_warp.grid_sample_grid_backward.launches, cuda_warp.grid_sample_train_forward.launches
    assert torch.equal(cuda_warp.grid_sample_grid_backward(g, image, grid),
                       cuda_warp.grid_sample_grid_backward_plain(g, image, grid))
    assert torch.equal(cuda_warp.grid_sample_train_forward(image, grid),
                       cuda_warp.grid_sample_bilinear_border(image, grid))
    assert (cuda_warp.grid_sample_grid_backward.launches, cuda_warp.grid_sample_train_forward.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_warp.grid_sample_grid_backward(g.to("meta"), image.to("meta"), grid.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_warp.grid_sample_train_forward(image.to("meta"), grid.to("meta"))


def test_plain_warp_in_f64_matches_torch_grid_sample():
    """An f64 image and grid keep the plain warp in f64 (the wide dtype of
    ``ops.wide``), so an f64 reference run has no f32 step in its warps:
    torch's own ``grid_sample`` in f64 agrees to f64 rounding, where the
    f32 warp of the same inputs is ~1e-7 away."""
    image = torch.from_numpy(_image(3, 2, 64)).double()
    grid = torch.from_numpy(_smooth_grid(4, 2, 64, scale=0.2)).double()
    ours = cuda_warp.grid_sample_bilinear_border(image, grid)
    ref = torch.nn.functional.grid_sample(image.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="border",
                                          align_corners=False).permute(0, 2, 3, 1)
    assert ours.dtype == torch.float64
    assert float((ours - ref).abs().max()) < 1e-12
    f32 = cuda_warp.grid_sample_bilinear_border(image.float(), grid.float())
    assert float((f32.double() - ref).abs().max()) > 1e-9


def test_plain_grid_backward_in_f64_matches_torch_grid_sample():
    """f64 inputs keep K3's plain backward in f64 (``ops.wide``), so an f64
    reference run has no f32 step in its grid gradient: torch's own
    ``grid_sample`` backward in f64 (the same strict border masks) agrees to
    f64 rounding."""
    rng = np.random.default_rng(24)
    image = torch.from_numpy(_image(6, 2, 64)).double()
    grid = torch.from_numpy(_smooth_grid(7, 2, 64, scale=0.2)).double()
    g = torch.from_numpy(rng.standard_normal((2, 64, 64, 4)))
    ours = cuda_warp.grid_sample_grid_backward_plain(g, image, grid)
    gr = grid.clone().requires_grad_()
    out = torch.nn.functional.grid_sample(image.permute(0, 3, 1, 2), gr, mode="bilinear", padding_mode="border",
                                          align_corners=False)
    (ref,) = torch.autograd.grad(out, gr, g.permute(0, 3, 1, 2))
    assert ours.dtype == torch.float64
    assert float((ours - ref).abs().max()) < 1e-12 * float(ref.abs().max())
