"""K1 (the fused SIREN level) in the PyTorch port against the JAX package.

``chain_t_plain`` is the port's plain version of the CUDA kernel
``csrc/sine_chain.cu``; on the CPU ``sine_chain_t`` runs it.  It is held
against the interpreted Pallas kernel ``fused_sine_chain_t`` (set up as
tests/test_pallas_siren.py sets it up) and against ``_jnp_chain_t``, on the
same numpy-made inputs and weights.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.ops import pallas_siren
from tha4_tpu_torch.ops import cuda_siren
from test_torch_siren_fold import chain_t_folded

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(pallas_siren, "_fused_ok", lambda *a: True)


def _layers(rng, dims):
    return [
        {
            "w": (rng.standard_normal((ci, co)) * (0.5 / np.sqrt(ci))).astype(np.float32),
            "b": (rng.standard_normal(co) * 0.1).astype(np.float32),
        }
        for ci, co in zip(dims[:-1], dims[1:])
    ]


def _case(seed, with_prev, with_final, n=2, hw=1024, pose_dim=7, cp=6, widths=(24, 16), head=5):
    rng = np.random.default_rng(seed)
    cin = (cp if with_prev else 0) + 2 + pose_dim
    layers = _layers(rng, [cin, *widths])
    final = _layers(rng, [widths[-1], head])[0] if with_final else None
    pos = rng.uniform(-1.0, 1.0, (2, hw)).astype(np.float32)
    pose = rng.uniform(-1.0, 1.0, (n, pose_dim)).astype(np.float32)
    prev = rng.uniform(-1.0, 1.0, (n, cp, hw)).astype(np.float32) if with_prev else None
    return prev, pos, pose, layers, final


def _pack(layers, final, dtype):
    def mat(layer):
        return torch.from_numpy(np.ascontiguousarray(layer["w"].T)), torch.from_numpy(layer["b"])

    return cuda_siren.pack_chain([mat(l) for l in layers], None if final is None else mat(final), dtype)


def _port(prev, pos, pose, layers, final, dtype, omega=30.0):
    chain = _pack(layers, final, dtype)
    prev_t = None if prev is None else torch.from_numpy(prev).to(dtype)
    out = cuda_siren.sine_chain_t(prev_t, torch.from_numpy(pos).to(dtype), torch.from_numpy(pose), chain, omega)
    assert out.dtype == dtype
    return out.float().numpy()


def _jax(fn, prev, pos, pose, layers, final, dtype, omega=30.0):
    jl = jax.tree.map(jnp.asarray, layers)
    jf = None if final is None else jax.tree.map(jnp.asarray, final)
    jprev = None if prev is None else jnp.asarray(prev).astype(dtype)
    out = fn(jprev, jnp.asarray(pos).astype(dtype), jnp.asarray(pose), jl, jf, omega)
    return np.asarray(out.astype(jnp.float32))


PREV_FINAL = [(False, True), (True, False), (True, True)]


@pytest.mark.parametrize("with_prev,with_final", PREV_FINAL)
def test_plain_matches_interpreted_pallas_f32(interpret, with_prev, with_final):
    args = _case(0, with_prev, with_final)
    ref = _jax(pallas_siren.fused_sine_chain_t, *args, jnp.float32)
    ours = _port(*args, torch.float32)
    # The precedent of tests/test_pallas_siren.py:54: omega=30 amplifies f32
    # rounding inside the sine chain; 1e-4 is the floor of two valid orders.
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("with_prev,with_final", PREV_FINAL)
def test_plain_matches_jnp_chain_f32(with_prev, with_final):
    args = _case(1, with_prev, with_final, widths=(32, 16))
    ref = _jax(pallas_siren._jnp_chain_t, *args, jnp.float32)
    ours = _port(*args, torch.float32)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("with_prev,with_final", PREV_FINAL)
def test_plain_matches_interpreted_pallas_bf16(interpret, with_prev, with_final):
    """Both sides take bf16 operands with exact f32 products, f32 sums and an
    f32 bias, and store bf16 activations.  They differ only in the order of
    the f32 sums, which now and then moves a stored activation by one bf16
    step (2^-8 relative); the next layer's omega=30 carries that on.  So: at
    least 99% of the outputs are bit-equal, none is more than 4 bf16 steps
    at |x| <= 2 (3.2e-2) away, and the mean error is under 1e-4."""
    args = _case(2, with_prev, with_final)
    ref = _jax(pallas_siren.fused_sine_chain_t, *args, jnp.bfloat16)
    ours = _port(*args, torch.bfloat16)
    err = np.abs(ours - ref)
    assert np.mean(err == 0.0) >= 0.99, np.mean(err == 0.0)
    assert err.max() <= 3.2e-2, err.max()
    assert err.mean() <= 1e-4, err.mean()


def test_fast_sin_matches_jax():
    x = np.random.default_rng(3).uniform(-200.0, 200.0, 200_000).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, np.pi, -np.pi, 200.0, -200.0, 3.14159274, 100.530965])])
    ours = cuda_siren.fast_sin(torch.from_numpy(x)).numpy()
    ref = np.asarray(pallas_siren._fast_sin(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(ours, np.sin(x.astype(np.float64)), atol=2e-6)


def test_fast_sin_rounds_half_to_even():
    """k = round(x / 2pi) must round half to even, as jnp.round and rintf do
    (2.5 -> 2, 3.5 -> 4), never half away from zero."""
    x = torch.tensor([2.5, 3.5, -2.5], dtype=torch.float32) / cuda_siren._INV_TWO_PI
    k = torch.round(x * cuda_siren._INV_TWO_PI)
    assert k.tolist() == [2.0, 4.0, -2.0]


def test_pack_chain_layout():
    rng = np.random.default_rng(4)
    layers = _layers(rng, [9, 8, 6])
    final = _layers(rng, [6, 3])[0]
    chain = _pack(layers, final, torch.bfloat16)
    assert chain.w.dtype == torch.bfloat16 and chain.b.dtype == torch.float32
    assert chain.num_layers == 3 and chain.num_sine == 2 and chain.out_channels == 3
    assert chain.specs.tolist() == [[9, 8, 0, 0], [8, 6, 72, 8], [6, 3, 120, 14]]
    w, b = chain.layer(1)
    np.testing.assert_array_equal(w.float().numpy(), torch.from_numpy(layers[1]["w"].T).bfloat16().float().numpy())
    np.testing.assert_array_equal(b.numpy(), layers[1]["b"])


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    prev, pos, pose, layers, final = _case(5, True, True, hw=64)
    before = cuda_siren.sine_chain_t.launches
    chain = _pack(layers, final, torch.float32)
    args = (torch.from_numpy(prev), torch.from_numpy(pos), torch.from_numpy(pose), chain)
    torch.testing.assert_close(cuda_siren.sine_chain_t(*args), cuda_siren.chain_t_plain(*args), rtol=0, atol=0)
    assert cuda_siren.sine_chain_t.launches == before


def test_wrapper_refuses_other_devices():
    prev, pos, pose, layers, final = _case(6, False, True, hw=64)
    chain = _pack(layers, final, torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_siren.sine_chain_t(None, torch.from_numpy(pos).to("meta"), torch.from_numpy(pose), chain)


def _port_folded(prev, pos, pose, layers, final, dtype, omega=30.0):
    chain = _pack(layers, final, dtype)
    prev_t = None if prev is None else torch.from_numpy(prev).to(dtype)
    out = chain_t_folded(prev_t, torch.from_numpy(pos).to(dtype), torch.from_numpy(pose), chain, omega)
    return out.float().numpy()


@pytest.mark.parametrize("with_prev,with_final", PREV_FINAL)
def test_folded_plain_matches_interpreted_pallas_f32(interpret, with_prev, with_final):
    """The bf16 kernels' layer 0, pose columns and bias folded into one f32
    vector and the position columns into two FMAs, is the same function:
    only the order of the f32 sums moves, so the f32 bar of two valid
    orders holds."""
    args = _case(7, with_prev, with_final)
    ref = _jax(pallas_siren.fused_sine_chain_t, *args, jnp.float32)
    np.testing.assert_allclose(_port_folded(*args, torch.float32), ref, atol=1e-4)


@pytest.mark.parametrize("with_prev,with_final", PREV_FINAL)
def test_folded_plain_matches_interpreted_pallas_bf16(interpret, with_prev, with_final):
    """The bars of test_plain_matches_interpreted_pallas_bf16: the fold
    reorders f32 sums of the same exact bf16 products."""
    args = _case(8, with_prev, with_final)
    ref = _jax(pallas_siren.fused_sine_chain_t, *args, jnp.bfloat16)
    err = np.abs(_port_folded(*args, torch.bfloat16) - ref)
    assert np.mean(err == 0.0) >= 0.99, np.mean(err == 0.0)
    assert err.max() <= 3.2e-2, err.max()
    assert err.mean() <= 1e-4, err.mean()


def _untile(flat, rows, cols):
    """Inverse of one matrix's tiles (csrc/sine_chain_tc.cuh): row chunks of
    128, column blocks of 64, each stored [column group of 8][rows][8]."""
    m = np.zeros((rows, cols), dtype=flat.dtype)
    i = 0
    for n0 in range(0, rows, 128):
        nb = min(128, rows - n0)
        for k0 in range(0, cols, 64):
            kb = min(64, cols - k0)
            m[n0 : n0 + nb, k0 : k0 + kb] = flat[i : i + nb * kb].reshape(kb // 8, nb, 8).transpose(1, 0, 2).reshape(nb, kb)
            i += nb * kb
    return m, i


# The face student and the three body levels at their shipped widths (the
# last level with its head), and a ragged chain.
LEVEL_DIMS = [
    ([41] + [128] * 8 + [4], 1),
    ([47, 360, 360, 180], 0),
    ([227, 180, 180, 90], 0),
    ([137, 90, 90, 90, 7], 1),
    ([15, 370, 8, 3], 1),
]


@pytest.mark.parametrize("dims,head", LEVEL_DIMS)
def test_tile_layout_round_trips_to_each_layer(dims, head):
    """Read back, the bf16 tile layout holds every layer's (Co, Ci) matrix
    padded with zeros to multiples of 16 (the forward tiles), then every
    layer's transpose from the last (the backward tiles), and nothing else."""
    rng = np.random.default_rng(len(dims))
    layers = _layers(rng, dims)
    chain = _pack(layers[: len(layers) - head], layers[-1] if head else None, torch.bfloat16)
    flat = chain.tiles.float().numpy()
    mats = [chain.layer(i)[0].float().numpy() for i in range(chain.num_layers)]
    pad = lambda x: -(-x // 16) * 16  # noqa: E731
    offset = 0
    for m in mats + [m.T for m in reversed(mats)]:
        got, used = _untile(flat[offset:], pad(m.shape[0]), pad(m.shape[1]))
        want = np.zeros_like(got)
        want[: m.shape[0], : m.shape[1]] = m
        np.testing.assert_array_equal(got, want)
        offset += used
    assert offset == flat.size
    f32 = cuda_siren.pack_chain([(torch.zeros(4, 5), torch.zeros(4))], None, torch.float32)
    assert f32.tiles.numel() == cuda_siren.f32_layout_elems(f32.specs)


@pytest.mark.parametrize("dims,head", LEVEL_DIMS + [([12, 100, 61, 3], 1), ([30, 500, 20], 0)])
def test_f32_stage_layout_round_trips_to_each_layer(dims, head):
    """Read back, the f32 layout holds, for every layer, pass of the plan's
    tile and 32 input channels, W^T's block padded with zeros to the pass's
    channels plus 4 and to 32 rows, in the kernel's order, and nothing else."""
    rng = np.random.default_rng(len(dims))
    layers = _layers(rng, dims)
    chain = _pack(layers[: len(layers) - head], layers[-1] if head else None, torch.float32)
    tile, _ = cuda_siren.f32_plan(chain.specs)
    cols = cuda_siren._f32_pass_channels(tile)
    flat = chain.tiles.numpy()
    offset = 0
    for i in range(chain.num_layers):
        w = chain.layer(i)[0].numpy()
        co, ci = w.shape
        for o0 in range(0, co, cols):
            for k0 in range(0, ci, 32):
                image = flat[offset : offset + 32 * (cols + 4)].reshape(32, cols + 4)
                want = np.zeros_like(image)
                block = w[o0 : o0 + cols, k0 : k0 + 32].T
                want[: block.shape[0], : block.shape[1]] = block
                np.testing.assert_array_equal(image, want)
                offset += image.size
    assert offset == flat.size == cuda_siren.f32_layout_elems(chain.specs)


# The f32 kernel's chains: the frame's four (the face student's is also its
# training chain, at any batch) and the ragged and wide card cases.
F32_PLAN_CASES = [
    ([41] + [128] * 8 + [4], 64, 99328), ([47, 360, 360, 180], 64, 218112), ([227, 180, 180, 90], 64, 152576),
    ([137, 90, 90, 90, 7], 64, 107520), ([12, 100, 61, 3], 64, 87040), ([30, 500, 20], 32, 195584),
]


@pytest.mark.parametrize("dims,tile,smem", F32_PLAN_CASES)
def test_f32_plan_fits_each_chain_in_one_block(dims, tile, smem):
    """The plan takes the larger tile where both activation buffers (the
    widest layer, padded to 8 rows) and both weight stages fit a Hopper
    block's 227 KB, else the smaller."""
    specs = cuda_siren.chain_specs([(co, ci) for ci, co in zip(dims[:-1], dims[1:])])
    assert cuda_siren.f32_plan(specs) == (tile, smem)
    assert smem <= 232448
    rows = -(-max(dims) // 8) * 8
    assert smem == 4 * (2 * rows * tile + 2 * 32 * (256 // (tile // 4) * 8 + 4))


@pytest.mark.parametrize("dims", [[47, 700, 8], [2000, 16]])
def test_f32_plan_raises_on_a_chain_no_tile_fits(dims):
    specs = cuda_siren.chain_specs([(co, ci) for ci, co in zip(dims[:-1], dims[1:])])
    with pytest.raises(ValueError, match="shared memory per block at the smallest tile"):
        cuda_siren.f32_plan(specs)
    chain = cuda_siren.pack_chain([(torch.zeros(co, ci), torch.zeros(co)) for ci, co in zip(dims[:-1], dims[1:])],
                                  None, torch.float32)
    assert chain.tiles is None
