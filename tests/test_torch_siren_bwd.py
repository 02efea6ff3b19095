"""K4 (the fused SIREN backward) in the PyTorch port against the JAX package.

``chain_t_bwd_plain`` is the port's plain version of the CUDA kernel
``csrc/sine_chain_bwd.cu``; on the CPU ``sine_chain_t_bwd`` and the autograd
Function run it.  It is held against the interpreted Pallas kernel
``fused_sine_chain_t_bwd`` (set up as tests/test_pallas_siren.py sets it up)
and against ``jax.vjp`` of ``_jnp_chain_t``, at the shapes and bars of
tests/test_pallas_siren.py:57-121, on the same numpy-made inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.ops import pallas_siren
from tha4_tpu_torch.ops import cuda_siren
from test_torch_siren_fold import chain_t_bwd_folded

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _layers(rng, dims):
    return [
        {
            "w": (rng.standard_normal((ci, co)) * (0.5 / np.sqrt(ci))).astype(np.float32),
            "b": (rng.standard_normal(co) * 0.1).astype(np.float32),
        }
        for ci, co in zip(dims[:-1], dims[1:])
    ]


def _case(seed, with_prev, with_final, n=2, hw=512, pose_dim=5, cp=4, widths=(16, 16), head=3):
    """tests/test_pallas_siren.py:57-93's shapes, made with numpy: inputs,
    layers in JAX's (Ci, Co) layout and an output cotangent."""
    rng = np.random.default_rng(seed)
    cin = (cp if with_prev else 0) + 2 + pose_dim
    layers = _layers(rng, [cin, *widths])
    final = _layers(rng, [widths[-1], head])[0] if with_final else None
    pos = rng.standard_normal((2, hw)).astype(np.float32)
    pose = rng.standard_normal((n, pose_dim)).astype(np.float32)
    prev = rng.standard_normal((n, cp, hw)).astype(np.float32) if with_prev else None
    cot = rng.standard_normal((n, (final or layers[-1])["w"].shape[1], hw)).astype(np.float32)
    return prev, pos, pose, layers, final, cot


def _chain(layers, final, dtype):
    def mat(layer):
        return torch.from_numpy(np.ascontiguousarray(layer["w"].T)), torch.from_numpy(layer["b"])

    return cuda_siren.pack_chain([mat(l) for l in layers], None if final is None else mat(final), dtype)


def _port_bwd(prev, pos, pose, layers, final, cot, dtype, omega):
    """(dprev, dpose, [dW (Ci, Co) per layer], [db per layer]) as numpy f32."""
    chain = _chain(layers, final, dtype)
    prev_t = None if prev is None else torch.from_numpy(prev).to(dtype)
    dprev, dpose, dw, db = cuda_siren.sine_chain_t_bwd(
        prev_t, torch.from_numpy(pos).to(dtype), torch.from_numpy(pose), chain,
        torch.from_numpy(cot).to(dtype), omega,
    )
    assert dw.dtype == db.dtype == dpose.dtype == torch.float32
    dws, dbs = [], []
    for ci, co, wo, bo in chain.specs:
        dws.append(dw[wo : wo + co * ci].view(co, ci).T.numpy())
        dbs.append(db[bo : bo + co].numpy())
    return (None if dprev is None else dprev.float().numpy()), dpose.numpy(), dws, dbs


def _jax_args(prev, pos, pose, layers, final, cot, dtype):
    jl = jax.tree.map(jnp.asarray, layers)
    jf = None if final is None else jax.tree.map(jnp.asarray, final)
    jprev = None if prev is None else jnp.asarray(prev).astype(dtype)
    return jprev, jnp.asarray(pos).astype(dtype), jnp.asarray(pose), jl, jf, jnp.asarray(cot).astype(dtype)


def _flat(dprev, dpose, dws, dbs):
    """Named gradients, JAX's tree order aside."""
    out = {"dpose": np.asarray(dpose, np.float32)}
    if dprev is not None:
        out["dprev"] = np.asarray(dprev, np.float32)
    for i, (w, b) in enumerate(zip(dws, dbs)):
        out[f"dW{i}"] = np.asarray(w, np.float32)
        out[f"db{i}"] = np.asarray(b, np.float32)
    return out


def _jax_kernel_bwd(prev, pos, pose, layers, final, cot, dtype, omega):
    jprev, jpos, jpose, jl, jf, jcot = _jax_args(prev, pos, pose, layers, final, cot, dtype)
    dprev, dpose, dlayers, dfinal = pallas_siren.fused_sine_chain_t_bwd(jprev, jpos, jpose, jl, jf, omega, jcot)
    mats = dlayers + ([dfinal] if dfinal is not None else [])
    return _flat(None if dprev is None else dprev.astype(jnp.float32), dpose, [m["w"] for m in mats], [m["b"] for m in mats])


def _jax_vjp_bwd(prev, pos, pose, layers, final, cot, omega):
    jprev, jpos, jpose, jl, jf, jcot = _jax_args(prev, pos, pose, layers, final, cot, jnp.float32)
    _, vjp = jax.vjp(lambda pr, po, la, fl: pallas_siren._jnp_chain_t(pr, jpos, po, la, fl, omega), jprev, jpose, jl, jf)
    dprev, dpose, dlayers, dfinal = vjp(jcot)
    mats = dlayers + ([dfinal] if dfinal is not None else [])
    return _flat(dprev, dpose, [m["w"] for m in mats], [m["b"] for m in mats])


def _assert_scaled(ours, ref, atol):
    """tests/test_pallas_siren.py:88-92: each gradient over its largest
    magnitude (at least 1e-3)."""
    assert ours.keys() == ref.keys()
    for name in ref:
        scale = max(float(np.abs(ref[name]).max()), 1e-3)
        np.testing.assert_allclose(ours[name] / scale, ref[name] / scale, atol=atol, err_msg=name)


PREV_FINAL = [(False, True), (True, False), (True, True)]
# tests/test_pallas_siren.py:58-65: at omega = 3 two f32 evaluation orders
# agree to 1e-5; at omega = 30 each sine layer amplifies f32 rounding ~omega
# times in the cotangent chain, so the shared floor is 1e-4.
OMEGA_ATOL = [(3.0, 1e-5), (30.0, 1e-4)]


@pytest.mark.parametrize("with_prev,with_final", PREV_FINAL)
@pytest.mark.parametrize("omega,atol", OMEGA_ATOL)
def test_plain_bwd_matches_interpreted_pallas_f32(interpret, with_prev, with_final, omega, atol):
    args = _case(0, with_prev, with_final)
    ref = _jax_kernel_bwd(*args, jnp.float32, omega)
    ours = _flat(*_port_bwd(*args, torch.float32, omega))
    _assert_scaled(ours, ref, atol)


@pytest.mark.parametrize("with_prev,with_final", PREV_FINAL)
@pytest.mark.parametrize("omega,atol", OMEGA_ATOL)
def test_plain_bwd_matches_jax_vjp_f32(with_prev, with_final, omega, atol):
    """Against autodiff of the jnp chain, which differentiates the sine
    polynomial exactly where K4 takes fast_cos (~1e-6 apart)."""
    args = _case(1, with_prev, with_final)
    ref = _jax_vjp_bwd(*args, omega)
    ours = _flat(*_port_bwd(*args, torch.float32, omega))
    _assert_scaled(ours, ref, atol)


# tests/test_pallas_siren.py:95-102: level-1-like shapes; at omega = 1 the
# two agree to 1e-5, at omega = 30 three chained sine layers amplify f32
# rounding up to ~omega^3 in the worst direction, floor 1e-3.
@pytest.mark.parametrize("omega,atol", [(1.0, 1e-5), (30.0, 1e-3)])
def test_plain_bwd_real_level_shapes(interpret, omega, atol):
    args = _case(5, True, False, n=2, hw=1024, pose_dim=45, cp=12, widths=(32, 32, 16))
    ours = _flat(*_port_bwd(*args, torch.float32, omega))
    _assert_scaled(ours, _jax_vjp_bwd(*args, omega), atol)
    _assert_scaled(ours, _jax_kernel_bwd(*args, jnp.float32, omega), atol)


def test_plain_bwd_matches_interpreted_pallas_bf16(interpret):
    """Both take bf16 operands with exact f32 products and f32 sums, round
    g_a to bf16 before the products, and keep f32 pre-activations.  They
    differ in the order of the f32 sums, which now and then moves a stored
    bf16 activation, g_a or dprev by one step (2^-8 relative); the gradient
    entries that step feeds move by about that much of their size.  Bar:
    one bf16 step, 2^-8, of each gradient's largest magnitude (measured
    1.4e-4 here, in dprev)."""
    args = _case(2, True, True, widths=(24, 16))
    ref = _jax_kernel_bwd(*args, jnp.bfloat16, 30.0)
    ours = _flat(*_port_bwd(*args, torch.bfloat16, 30.0))
    _assert_scaled(ours, ref, 2.0**-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_gives_the_plain_gradients(dtype):
    """SineChainFunction over f32 master weights: its CPU gradients are
    chain_t_bwd_plain's, and the weight gradients stay f32 in bf16."""
    prev, pos, pose, layers, final, cot = _case(3, True, True, hw=256)
    params = [
        (torch.from_numpy(np.ascontiguousarray(l["w"].T)).requires_grad_(), torch.from_numpy(l["b"]).requires_grad_())
        for l in layers + [final]
    ]
    prev_t = torch.from_numpy(prev).to(dtype).requires_grad_()
    pos_t, pose_t = torch.from_numpy(pos).to(dtype), torch.from_numpy(pose)
    out = cuda_siren.sine_chain_t_train(prev_t, pos_t, pose_t, params[:-1], params[-1], dtype, 30.0)
    assert out.dtype == dtype
    (out.float() * torch.from_numpy(cot)).sum().backward()

    chain = _chain(layers, final, dtype)
    torch.testing.assert_close(out, cuda_siren.chain_t_plain(prev_t.detach(), pos_t, pose_t, chain), rtol=0, atol=0)
    dprev, _, dw, db = cuda_siren.chain_t_bwd_plain(prev_t.detach(), pos_t, pose_t, chain, torch.from_numpy(cot).to(dtype))
    torch.testing.assert_close(prev_t.grad, dprev, rtol=0, atol=0)
    for (w, b), (ci, co, wo, bo) in zip(params, chain.specs):
        assert w.grad.dtype == b.grad.dtype == torch.float32
        torch.testing.assert_close(w.grad, dw[wo : wo + co * ci].view(co, ci), rtol=0, atol=0)
        torch.testing.assert_close(b.grad, db[bo : bo + co], rtol=0, atol=0)


def test_fast_cos_matches_jax():
    x = np.random.default_rng(4).uniform(-200.0, 200.0, 100_000).astype(np.float32)
    ours = cuda_siren.fast_cos(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(pallas_siren._fast_cos(jnp.asarray(x))))


def test_bwd_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    prev, pos, pose, layers, final, cot = _case(6, True, True, hw=64)
    chain = _chain(layers, final, torch.float32)
    args = (torch.from_numpy(prev), torch.from_numpy(pos), torch.from_numpy(pose), chain, torch.from_numpy(cot))
    before = cuda_siren.sine_chain_t_bwd.launches
    for a, b in zip(cuda_siren.sine_chain_t_bwd(*args), cuda_siren.chain_t_bwd_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cuda_siren.sine_chain_t_bwd.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_siren.sine_chain_t_bwd(None, args[1].to("meta"), args[2], chain, args[4])


def test_bwd_shared_memory_fits_the_face_and_level_shapes():
    """The face student (41->128x8->4) and body levels L1/L2 fit one Hopper
    block; L0 (360 wide) does not and would raise."""
    def chain(dims, head):
        mats = [(torch.zeros(co, ci), torch.zeros(co)) for ci, co in zip(dims[:-1], dims[1:])]
        return cuda_siren.pack_chain(mats[: len(mats) - head], mats[-1] if head else None, torch.bfloat16)

    assert cuda_siren.bwd_smem_bytes(chain([41] + [128] * 8 + [4], 1), 41) == (1024 + 3 * 128) * 33 * 4
    assert cuda_siren.bwd_smem_bytes(chain([227, 180, 180, 90], 0), 227) <= 232448
    assert cuda_siren.bwd_smem_bytes(chain([137, 90, 90, 90, 7], 1), 137) <= 232448
    assert cuda_siren.bwd_smem_bytes(chain([47, 360, 360, 180], 0), 47) > 232448


def _port_bwd_folded(prev, pos, pose, layers, final, cot, dtype, omega):
    chain = _chain(layers, final, dtype)
    prev_t = None if prev is None else torch.from_numpy(prev).to(dtype)
    dprev, dpose, dw, db = chain_t_bwd_folded(
        prev_t, torch.from_numpy(pos).to(dtype), torch.from_numpy(pose), chain, torch.from_numpy(cot).to(dtype), omega
    )
    dws = [dw[wo : wo + co * ci].view(co, ci).T.numpy() for ci, co, wo, bo in chain.specs]
    dbs = [db[bo : bo + co].numpy() for ci, co, wo, bo in chain.specs]
    return _flat(None if dprev is None else dprev.float().numpy(), dpose.numpy(), dws, dbs)


@pytest.mark.parametrize("with_prev,with_final", PREV_FINAL)
def test_folded_plain_bwd_matches_interpreted_pallas_f32(interpret, with_prev, with_final):
    """The bf16 kernels' order: layer 0's forward folded, dpose as W_pose^T
    times layer 0's summed rounded g_a (the same sum by linearity).  Only f32
    sum orders move: the omega = 30 bar of two valid orders."""
    args = _case(7, with_prev, with_final)
    _assert_scaled(_port_bwd_folded(*args, torch.float32, 30.0), _jax_kernel_bwd(*args, jnp.float32, 30.0), 1e-4)


def test_folded_plain_bwd_matches_interpreted_pallas_bf16(interpret):
    """The bar of test_plain_bwd_matches_interpreted_pallas_bf16: one bf16
    step of each gradient's largest magnitude."""
    args = _case(2, True, True, widths=(24, 16))
    _assert_scaled(_port_bwd_folded(*args, torch.bfloat16, 30.0), _jax_kernel_bwd(*args, jnp.bfloat16, 30.0), 2.0**-8)


def test_folded_plain_bwd_real_level_shapes(interpret):
    args = _case(5, True, False, n=2, hw=1024, pose_dim=45, cp=12, widths=(32, 32, 16))
    _assert_scaled(_port_bwd_folded(*args, torch.float32, 30.0), _jax_kernel_bwd(*args, jnp.float32, 30.0), 1e-3)
