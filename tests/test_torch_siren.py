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
