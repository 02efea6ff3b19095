"""K6 of the PyTorch port (``ops/cuda_conv.py``), its plain version and the
U-Net's fused ResBlocks, against the JAX package on the CPU.

The Pallas kernels run in interpret mode, as tests/test_pallas_conv.py:18-22
runs them: ``pallas_conv.fused_affine_conv3_nchw`` (K6) at the shapes of
tests/test_pallas_conv.py:31-71, and ``pallas_packed_conv.fused_packed_conv3``
(K7) on inputs packed as tests/test_pallas_packed_conv.py packs them, whose
counterpart in the port is K6 on the NHWC view.  The ResBlocks are held
against JAX's plain ``unet._resblock`` with its lane-packed fusion switched
off (tests/test_pallas_conv.py:96-121).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.convert import torch_weights as jtw
from tha4_tpu.models import unet as junet
from tha4_tpu.ops import packed_conv as PC
from tha4_tpu.ops import pallas_conv
from tha4_tpu.ops import pallas_packed_conv as PPC
from tha4_tpu_torch.models import body_morpher, unet, upscaler
from tha4_tpu_torch.ops import cuda_conv

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _cl(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NCHW numpy -> an NCHW tensor in channels-last memory."""
    return torch.from_numpy(a).to(dtype).contiguous(memory_format=torch.channels_last)


def _case(rng, case):
    """tests/test_pallas_conv.py:31-71: (x, scale, shift, w_hwio, bias, skip,
    skip_w) as numpy f32, NCHW."""
    f32 = np.float32
    n, c, h, w = {"plain": (2, 8, 16, 128), "affine": (2, 8, 32, 128)}.get(case, (1, 8, 16, 128))
    co = 5 if case == "plain" else 8
    x = rng.standard_normal((n, c, h, w)).astype(f32)
    scale = shift = skip = skip_w = None
    if case == "affine":
        scale = rng.uniform(0.5, 1.5, (n, c)).astype(f32)
        shift = rng.uniform(-0.5, 0.5, (n, c)).astype(f32)
    wts = (rng.standard_normal((3, 3, c, co)) * 0.2).astype(f32)
    b = rng.standard_normal(co).astype(f32) if case in ("plain", "affine") else np.zeros(co, f32)
    if case == "identity":
        skip = rng.standard_normal((n, co, h, w)).astype(f32)
    if case == "conv_skip":
        skip = rng.standard_normal((n, 12, h, w)).astype(f32)
        skip_w = (rng.standard_normal((co, 12)) * 0.2).astype(f32)
    return x, scale, shift, wts, b, skip, skip_w


def _both(args, dtype):
    """The interpreted Pallas kernel and the port's wrapper (its plain version
    on the CPU) on the same inputs, f32 numpy out."""
    x, scale, shift, wts, b, skip, skip_w = args
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = pallas_conv.fused_affine_conv3_nchw(
        jnp.asarray(x).astype(jdtype), j(scale), j(shift), pallas_conv.to_w9(jnp.asarray(wts), jdtype), jnp.asarray(b),
        None if skip is None else jnp.asarray(skip).astype(jdtype), None if skip_w is None else jnp.asarray(skip_w).astype(jdtype),
    )
    t = lambda a: None if a is None else torch.from_numpy(a)
    ours = cuda_conv.fused_affine_conv3_nchw(
        _cl(x, dtype), t(scale), t(shift), cuda_conv.to_w9(torch.from_numpy(wts), dtype), t(b),
        None if skip is None else _cl(skip, dtype), None if skip_w is None else t(skip_w).to(dtype),
    )
    assert ours.dtype == dtype and tuple(ours.shape) == ref.shape
    return ours.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("case", ["plain", "affine", "identity", "conv_skip"])
def test_plain_version_matches_interpreted_pallas_kernel(rng, case):
    ours, ref = _both(_case(rng, case), torch.float32)
    np.testing.assert_allclose(ours, ref, atol=2e-5)


def test_plain_version_matches_interpreted_pallas_kernel_bf16(rng):
    """The same bf16 operands (the activation rounded once to bf16), exact
    products, f32 sums in another order, one rounding at the end: two bf16
    steps at the largest output's scale."""
    x, _, _, wts, b, skip, skip_w = _case(rng, "conv_skip")
    scale = rng.uniform(0.5, 1.5, (x.shape[0], x.shape[1])).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, (x.shape[0], x.shape[1])).astype(np.float32)
    ours, ref = _both((x, scale, shift, wts, b, skip, skip_w), torch.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(ours, ref, atol=2 * ulp)


def test_padding_comes_after_the_activation(rng):
    """A shift with SiLU(shift) != 0 at H, W that are not multiples of the
    kernel's 8 x 16 tile: the border outputs see zeros, not SiLU(shift)."""
    n, c, co, h, w = 2, 8, 4, 13, 21
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    scale = np.full((n, c), 0.5, np.float32)
    shift = np.full((n, c), 2.0, np.float32)
    wts = rng.standard_normal((3, 3, c, co)).astype(np.float32) * 0.2
    ours = cuda_conv.fused_affine_conv3_nchw(_cl(x), torch.from_numpy(scale), torch.from_numpy(shift),
                                             cuda_conv.to_w9(torch.from_numpy(wts)), torch.zeros(co))
    act = torch.nn.functional.silu(torch.from_numpy(x) * 0.5 + 2.0)
    ref = torch.nn.functional.conv2d(act, torch.from_numpy(wts).permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-5)
    leaky = torch.nn.functional.conv2d(torch.nn.functional.pad(act, (1, 1, 1, 1), value=float(torch.nn.functional.silu(torch.tensor(2.0)))),
                                       torch.from_numpy(wts).permute(3, 2, 0, 1))
    assert float((leaky - ref).abs()[:, :, 0, :].max()) > 0.1  # the rule has teeth at the border


def test_fold_groupnorm_film_matches_jax(rng):
    """tests/test_pallas_conv.py:74-93: the port's fold against JAX's, 1e-5."""
    n, c, h, w = 2, 16, 8, 128
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    gn_scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    gn_bias = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    f_scale = (rng.standard_normal((n, c)) * 0.3).astype(np.float32)
    f_shift = (rng.standard_normal((n, c)) * 0.3).astype(np.float32)
    ref = pallas_conv.fold_groupnorm_film(jnp.asarray(x), 8, jnp.asarray(gn_scale), jnp.asarray(gn_bias),
                                          ((jnp.asarray(f_scale), jnp.asarray(f_shift)),), 1.0)
    t = torch.from_numpy
    ours = cuda_conv.fold_groupnorm_film(_cl(x), 8, t(gn_scale), t(gn_bias), ((t(f_scale), t(f_shift)),), 1.0)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32 and tuple(o.shape) == (n, c)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_fold_keeps_its_accuracy_at_large_means(rng):
    """Centred statistics: at a mean 1000x the spread the f32 fold stays
    within 2e-4 of an f64 group norm (measured 3.6e-5), where E[x^2] -
    mean^2 in f32 misses the variance by up to 8 % (~0.1 here)."""
    n, c, h, w = 1, 8, 16, 16
    x = (rng.standard_normal((n, c, h, w)) + 1000.0).astype(np.float32)
    scale, shift = cuda_conv.fold_groupnorm_film(_cl(x), 4, torch.ones(c), torch.zeros(c))
    got = _cl(x).double() * scale.double()[:, :, None, None] + shift.double()[:, :, None, None]
    ref = torch.nn.functional.group_norm(torch.from_numpy(x).double(), 4, eps=1e-5)
    assert float((got - ref).abs().max()) < 2e-4


@pytest.mark.parametrize("skip", ["none", "identity", "conv"])
def test_k7_packed_kernel_is_k6_on_the_nhwc_view(rng, skip):
    """K7 (interpreted) on the packed layout (N, H, W/f, f*C) against the
    port's K6 on the NHWC tensor it is a reshape of."""
    n, h, w, c, f = 2, 96, 128, 16, 8
    co = c if skip == "identity" else 8
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wconv = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((co,)) * 0.1).astype(np.float32)
    scale = (rng.standard_normal((n, c)) * 0.3 + 1.0).astype(np.float32)
    shift = (rng.standard_normal((n, c)) * 0.2).astype(np.float32)
    skw = (rng.standard_normal((c, co)) * 0.1).astype(np.float32)
    xp = PC.pack_nhwc(jnp.asarray(x), f)
    packed = PPC.fused_packed_conv3(
        xp, PC.tile_channel_vector(jnp.asarray(scale), f), PC.tile_channel_vector(jnp.asarray(shift), f),
        PC.pack_conv3_weights(jnp.asarray(wconv), f), PC.tile_channel_vector(jnp.asarray(b), f), skip=skip,
        skip_w=PC.pack_conv1_weights(jnp.asarray(skw), f)[0, 0] if skip == "conv" else None,
    )
    ref = np.asarray(PC.unpack_nhwc(packed, f))
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    ours = cuda_conv.fused_affine_conv3_nchw(
        x_t, torch.from_numpy(scale), torch.from_numpy(shift), cuda_conv.to_w9(torch.from_numpy(wconv)), torch.from_numpy(b),
        None if skip == "none" else x_t, torch.from_numpy(skw).t().contiguous() if skip == "conv" else None,
    )
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, atol=2e-5)


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


RESBLOCK_CASES = [
    (8, 8, "same"), (12, 8, "same"), (32, 32, "same"), (96, 32, "same"),
    (8, 16, "down"), (32, 32, "down"), (96, 32, "down"),
    (16, 8, "up"), (32, 32, "up"), (96, 32, "up"),
]


def _resblock_case(rng, cin, cout, sampling):
    """A ResBlock with every branch live (conv1 included), JAX's params for
    it and seeded inputs: (block, params, x, cond0, cond1), numpy f32."""
    block = unet.ResBlock(cin, cout, 24, sampling)
    gen = torch.Generator().manual_seed(cin * 100 + cout)
    with torch.no_grad():
        for p in block.parameters():
            p.uniform_(-0.3, 0.3, generator=gen)
        for norm in (block.norm0, block.norm1):
            norm.weight.uniform_(0.5, 1.5, generator=gen)
    params = jax.tree.map(jnp.asarray, jtw._unet_resblock({f"m.{k}": v for k, v in _np_sd(block).items()}, "m"))
    n, h, w = 2, 16, 128
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    cond0, cond1 = (rng.standard_normal((n, 24)).astype(np.float32) for _ in range(2))
    return block, params, x, cond0, cond1


@pytest.mark.parametrize("cin,cout,sampling", RESBLOCK_CASES)
def test_fused_resblock_matches_jax_plain_resblock(rng, monkeypatch, cin, cout, sampling):
    """The port's ResBlock (K6 for conv1 with its skip, and for conv0 of a
    "same" block) against JAX's plain path, at the ten cases of
    tests/test_pallas_conv.py:96-102 and its 3e-5."""
    monkeypatch.setattr(junet, "_fuse_resblock_ok", lambda *a: False)
    block, params, x, cond0, cond1 = _resblock_case(rng, cin, cout, sampling)
    ref = junet._resblock(params, jnp.asarray(x), jnp.asarray(cond0), jnp.asarray(cond1), sampling, 1.0)
    calls = []
    real = cuda_conv.fused_affine_conv3_nchw
    monkeypatch.setattr(cuda_conv, "fused_affine_conv3_nchw", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        ours = block(torch.from_numpy(x), torch.from_numpy(cond0), torch.from_numpy(cond1), 1.0)
    assert len(calls) == (2 if sampling == "same" else 1)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-5)


@pytest.mark.parametrize("cin,cout,sampling", RESBLOCK_CASES)
def test_bf16_fused_resblock_is_closer_to_f32_than_jax_bf16(rng, monkeypatch, cin, cout, sampling):
    """K6 rounds once (the activation to bf16, then the output), where the
    plain chain rounds after the group norm, each FiLM, the SiLU, the conv
    and the residual add.  So in bf16 (conv weights and activations bf16,
    norms f32, as ``Teacher.freeze`` keeps them) the port's ResBlock must be
    no further from JAX's f32 ResBlock than JAX's own bf16 ResBlock is: the
    largest error at most JAX's, and the RMS error at most 0.9x JAX's
    (read on the ten cases: 0.43-0.78x the largest, 0.55-0.80x the RMS)."""
    monkeypatch.setattr(junet, "_fuse_resblock_ok", lambda *a: False)
    block, params, x, cond0, cond1 = _resblock_case(rng, cin, cout, sampling)
    ref = np.asarray(junet._resblock(params, jnp.asarray(x), jnp.asarray(cond0), jnp.asarray(cond1), sampling, 1.0))
    b16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jax16 = np.asarray(junet._resblock(params, b16(x), b16(cond0), b16(cond1), sampling, 1.0).astype(jnp.float32))
    for m in block.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(torch.bfloat16)
    with torch.no_grad():
        ours = block(*(torch.from_numpy(a).bfloat16() for a in (x, cond0, cond1)), 1.0)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    rms = lambda d: float(np.sqrt(np.mean(d * d)))
    assert np.abs(ours - ref).max() <= np.abs(jax16 - ref).max()
    assert rms(ours - ref) <= 0.9 * rms(jax16 - ref)


@pytest.mark.parametrize("net,size,launches", [("upscaler", 32, 55), ("body_morpher", 16, 47)])
def test_shipped_unets_launch_k6_per_call(monkeypatch, net, size, launches):
    """The shipped U-Nets at their full widths (a small image: the count does
    not depend on it): every ResBlock's conv1, every "same" block's conv0 and
    the last conv go through K6, 55 times for the upscaler and 47 for the
    body morpher, 102 per mode_07 call."""
    cfg = (upscaler.shipped_unet_config if net == "upscaler" else body_morpher.shipped_unet_config)()
    model = unet.Unet(cfg)
    resblocks = [m for m in model.modules() if isinstance(m, unet.ResBlock)]
    same = [m for m in resblocks if m.sampling == "same"]
    assert (len(resblocks), len(same)) == ((32, 22) if net == "upscaler" else (27, 19))
    calls = []
    real = cuda_conv.fused_affine_conv3_nchw
    monkeypatch.setattr(cuda_conv, "fused_affine_conv3_nchw", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((1, size, size, cfg.in_channels), generator=gen)
    with torch.no_grad():
        out = model(x, torch.zeros((1, 1)), torch.rand((1, cfg.cond_input_channels), generator=gen))
    assert out.shape == (1, size, size, cfg.out_channels)
    assert len(calls) == launches == len(resblocks) + len(same) + 1
    assert max(s[1] for s in calls) == 512  # the deepest up level's cat


def test_wrapper_refuses_an_input_that_needs_a_gradient(rng):
    x = _cl(rng.standard_normal((1, 8, 8, 16)).astype(np.float32))
    w9 = torch.zeros((4, 72), requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        cuda_conv.fused_affine_conv3_nchw(x, None, None, w9, torch.zeros(4))
    with torch.no_grad():
        assert cuda_conv.fused_affine_conv3_nchw(x, None, None, w9, torch.zeros(4)).shape == (1, 4, 8, 16)
    block = unet.ResBlock(8, 8, 4)  # trainable weights, grad mode on
    with pytest.raises(RuntimeError, match="no gradient"):
        block(torch.zeros((1, 8, 8, 8)), torch.zeros((1, 4)), torch.zeros((1, 4)), 1.0)


def test_cached_w9_follows_the_weight():
    """Unfrozen, the U-Net lays each K6 conv's weight out anew at every
    call, so an in-place change reaches K6.  Frozen (``Unet.store_w9``, run
    by ``Teacher.freeze``), it keeps one w9 per K6 conv, in the weight's
    dtype, outside the state dict."""
    cfg = unet.UnetConfig(in_channels=4, out_channels=7, model_channels=8, level_channel_multipliers=(1, 2),
                          level_use_attention=(False, False), num_res_blocks_per_level=1, num_middle_res_blocks=1,
                          cond_input_channels=6, cond_internal_channels=16)
    net = unet.Unet(cfg)
    conv = net.last[2]
    keys = set(net.state_dict())
    with torch.no_grad():
        first = unet._w9(conv, torch.float32)
        conv.weight.mul_(2.0)
        assert torch.equal(unet._w9(conv, torch.float32), 2.0 * first)
        net.store_w9()
        conv.weight.mul_(0.5)  # frozen: the copy keeps the weight it was made from
        assert unet._w9(conv, torch.float32) is conv.w9 and torch.equal(conv.w9, 2.0 * first)
        assert unet._w9(conv, torch.bfloat16).dtype == torch.bfloat16
    resblocks = [m for m in net.modules() if isinstance(m, unet.ResBlock)]
    stored = [m for m in net.modules() if getattr(m, "w9", None) is not None]
    assert len(stored) == len(resblocks) + sum(m.sampling == "same" for m in resblocks) + 1
    for m in stored:
        if m is not conv:
            assert torch.equal(m.w9, cuda_conv.to_w9(m.weight.permute(2, 3, 1, 0)))
    assert set(net.state_dict()) == keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,cs,bn", [(24, 7, 0, 32), (40, 70, 20, 64), (16, 300, 0, 256)])
def test_device_weight_layout_puts_each_weight_where_k6_reads_it(dtype, cin, cout, cs, bn):
    """K6's device layout, read back with the kernel's own indexing
    (csrc/affine_conv3.cu chunk_weights): per Cout block, chunk q of the
    conv at q * 9 * CK * BN, then the 1x1 skip's chunks; inside a chunk
    [tap][CK / 8][BN][8] in bf16, [tap][CK][BN] in f32; zeros past Cin, Cs
    and Cout."""
    ck = 16
    gen = torch.Generator().manual_seed(cin + cout)
    w9 = torch.randn((cout, 9 * cin), generator=gen).to(dtype)
    skip_w = torch.randn((cout, cs), generator=gen).to(dtype) if cs else None
    flat = cuda_conv.device_weight_layout(w9, skip_w, bn, ck, dtype)
    qc, qs, nb = -(-cin // ck), -(-cs // ck), -(-cout // bn)
    assert flat.dtype == dtype and flat.shape == (nb * (9 * qc + qs) * ck * bn,)

    def at(block, chunk_offset, t, ci, n):
        if dtype == torch.bfloat16:
            inner = ((t * (ck // 8) + ci // 8) * bn + n) * 8 + ci % 8
        else:
            inner = (t * ck + ci) * bn + n
        return flat[block * (9 * qc + qs) * ck * bn + chunk_offset + inner]

    rng = np.random.default_rng(cin)
    for co, ci, t in zip(rng.integers(0, nb * bn, 60), rng.integers(0, qc * ck, 60), rng.integers(0, 9, 60)):
        block, n = divmod(int(co), bn)
        q, cq = divmod(int(ci), ck)
        want = w9[co, t * cin + ci] if co < cout and ci < cin else 0.0
        assert float(at(block, q * 9 * ck * bn, int(t), cq, n)) == float(want)
    for co, ci in zip(rng.integers(0, nb * bn, 30), rng.integers(0, max(qs, 1) * ck, 30)):
        if not cs:
            break
        block, n = divmod(int(co), bn)
        s, cq = divmod(int(ci), ck)
        want = skip_w[co, ci] if co < cout and ci < cs else 0.0
        assert float(at(block, (qc * 9 + s) * ck * bn, 0, cq, n)) == float(want)


def test_device_weight_layout_is_made_once_per_weight_and_follows_it(monkeypatch):
    """K6's device layout.  Unfrozen, the U-Net passes none, so the wrapper
    lays out the weights as they are at each call; frozen
    (``Unet.store_w9``), every K6 conv keeps one, made from its w9 (conv1
    of a block with a 1x1 skip: and the skip's matrix) at the kernel's BN
    for its dtype, outside the state dict, and passes it at every call."""
    cfg = unet.UnetConfig(in_channels=4, out_channels=7, model_channels=8, level_channel_multipliers=(1, 2),
                          level_use_attention=(False, False), num_res_blocks_per_level=1, num_middle_res_blocks=1,
                          cond_input_channels=6, cond_internal_channels=16)
    net = unet.Unet(cfg).requires_grad_(False)
    keys = set(net.state_dict())
    seen = []
    real = cuda_conv.fused_affine_conv3_nchw
    monkeypatch.setattr(cuda_conv, "fused_affine_conv3_nchw", lambda *a: seen.append(a) or real(*a))
    x, t, cond = torch.rand((1, 8, 8, 4)), torch.zeros((1, 1)), torch.rand((1, 6))
    net(x, t, cond)
    assert seen and all(a[7] is None for a in seen)
    net.store_w9()
    seen.clear()
    net(x, t, cond)
    convs = [m for m in net.modules() if getattr(m, "k6_layout", None) is not None]
    assert len(seen) == len(convs) and {id(a[7]) for a in seen} == {id(m.k6_layout) for m in convs}
    skips = {id(b.conv1): b.skip_w for b in net.modules() if isinstance(b, unet.ResBlock) and b.skip is not None}
    assert skips
    for m in convs:
        bn = cuda_conv.layout_block(m.w9.shape[0], m.w9.dtype)
        want = cuda_conv.device_weight_layout(m.w9, skips.get(id(m)), bn, cuda_conv.CK, m.w9.dtype)
        assert m.k6_layout.dtype == m.weight.dtype and torch.equal(m.k6_layout, want)
    assert set(net.state_dict()) == keys


def test_plan_is_asked_once_per_size(monkeypatch):
    """K6's wrapper asks the library for a call size's plan once (the
    split plan, BN and the layout's size), not at every call."""
    calls = []

    class Library:
        def tha4_affine_conv3_plan(self, *args):
            calls.append(args[:8])
            plan = args[8]
            plan[0], plan[1], plan[2], plan[3] = 3, 64, 16, 9 * 16 * 64
            return 0

    monkeypatch.setattr(cuda_conv.cuda_build, "library", lambda: Library())
    cuda_conv._plan.cache_clear()
    try:
        sizes = (1, 16, 16, 16, 64, 0, 0, 1)
        assert cuda_conv._plan(*sizes) == (3, 64, 16, 9 * 16 * 64)
        assert cuda_conv._plan(*sizes) == (3, 64, 16, 9 * 16 * 64)
        cuda_conv._plan(2, 16, 16, 16, 64, 0, 0, 1)
        assert calls == [sizes, (2, 16, 16, 16, 64, 0, 0, 1)]
    finally:
        cuda_conv._plan.cache_clear()


def test_cached_skip_weight_and_bias_follow_the_weight(monkeypatch):
    """A ResBlock with a 1x1 skip passes K6 the skip's weight as a (Cout,
    Cs) matrix and the f32 sum of the two biases.  Unfrozen, both are made
    from the weights at every call; frozen (``Unet.store_w9``), they are
    the stored copies, outside the state dict, and so is each conv's f32
    bias."""
    cfg = unet.UnetConfig(in_channels=4, out_channels=7, model_channels=8, level_channel_multipliers=(1, 2),
                          level_use_attention=(False, False), num_res_blocks_per_level=1, num_middle_res_blocks=1,
                          cond_input_channels=6, cond_internal_channels=16)
    net = unet.Unet(cfg)
    keys = set(net.state_dict())
    block = next(m for m in net.modules() if isinstance(m, unet.ResBlock) and m.skip is not None)
    seen = []
    real = cuda_conv.fused_affine_conv3_nchw
    monkeypatch.setattr(cuda_conv, "fused_affine_conv3_nchw", lambda *a: seen.append(a) or real(*a))
    x = torch.rand((1, 8, 8, block.norm0.weight.shape[0]))
    cond = torch.rand((1, 16))
    with torch.no_grad():
        block.skip.weight.mul_(3.0)
        block(x, cond, cond, 1.0)
        skip_w, bias = seen[-1][6], seen[-1][4]
        assert torch.equal(skip_w, block.skip.weight[:, :, 0, 0])
        assert torch.equal(bias, block.conv1.bias + block.skip.bias)
        net.store_w9()
        block.skip.weight.mul_(0.5)  # frozen: the copies keep the weights they were made from
        block(x, cond, cond, 1.0)
        assert seen[-1][6] is block.skip_w and torch.equal(block.skip_w, skip_w)
        assert seen[-1][4] is block.skip_bias and seen[-1][4].dtype == torch.float32
        assert seen[-2][4] is block.conv0.bias32  # a "same" block's conv0: its own bias, stored in f32
    assert set(net.state_dict()) == keys


def test_shipped_unets_give_k6_and_its_fold_channels_last_tensors(monkeypatch):
    """Every x and skip the shipped U-Nets hand K6 and its fold lies
    channels last (NHWC memory viewed as NCHW), which the kernels need and
    the wrappers check on the card, also for an input image that lies NCHW
    (a resize's output, as the body morpher gets it), whose first conv then
    returns NCHW memory."""
    checked = []
    real_conv, real_fold = cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film

    def conv(x, scale, shift, w9, bias, skip=None, skip_w=None, layout=None):
        checked.append(cuda_conv._channels_last(x) and (skip is None or cuda_conv._channels_last(skip)))
        return real_conv(x, scale, shift, w9, bias, skip, skip_w, layout)

    def fold(x, *args, **kwargs):
        checked.append(cuda_conv._channels_last(x))
        return real_fold(x, *args, **kwargs)

    monkeypatch.setattr(cuda_conv, "fused_affine_conv3_nchw", conv)
    monkeypatch.setattr(cuda_conv, "fold_groupnorm_film", fold)
    for cfg in (upscaler.shipped_unet_config(), body_morpher.shipped_unet_config()):
        model = unet.Unet(cfg)
        gen = torch.Generator().manual_seed(2)
        with torch.no_grad():
            model(torch.rand((1, cfg.in_channels, 32, 32), generator=gen).permute(0, 2, 3, 1), torch.zeros((1, 1)),
                  torch.rand((1, cfg.cond_input_channels), generator=gen))
    assert len(checked) == 2 * (55 + 47) and all(checked)
