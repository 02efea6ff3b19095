"""The block zoo of the PyTorch port against the JAX package: ``ops.blocks``
(every ``BlockConfig`` flag), ``ops.separable``, ``ops.norms_extra``,
``ops.spectral_norm`` and ``models.resize_conv``.

Sizes follow tests/test_blocks.py: a 32^2 image, 4 -> 8 channels, batch 2.
The JAX params come from the JAX builders (``init_*``) with a seed, their
norm affines and biases redrawn from numpy so that no affine is the
identity, and cross into the port module through
``convert.export_torch.zoo_state_dict``.  The same numpy input goes through
both.  f32 at the JAX suite's own bar (tests/test_blocks.py:238, 3e-5), the
JAX side jitted; bf16 with the JAX side eager, op by op as PyTorch runs
(under ``jit`` XLA keeps some bf16 intermediates in f32), where both sides
round every conv and norm output to bf16 with sums in their own order, at
four bf16 steps (2^-6) relative to the largest output.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.models import resize_conv as jresize_conv
from tha4_tpu.ops import blocks as JB
from tha4_tpu.ops import norms_extra as jnorms
from tha4_tpu.ops import separable as jsep
from tha4_tpu_torch.convert.export_torch import zoo_state_dict
from tha4_tpu_torch.models import resize_conv
from tha4_tpu_torch.ops import blocks as B
from tha4_tpu_torch.ops import norms_extra, separable

torch.set_num_threads(2)

F32_ATOL = 3e-5
BF16_REL = 2.0**-6
SN_U_ATOL = 1e-6
GRAD_REL = 1e-4  # the UNet's gradients, over each tensor's largest


def _perturb(params, rng):
    """Redraw every ``scale`` and ``bias`` leaf (norm affines, conv biases,
    the resnet block's learned scale) away from its init."""
    if isinstance(params, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) if k == "scale"
                    else rng.uniform(-0.5, 0.5, np.shape(v)).astype(np.float32) if k == "bias"
                    else _perturb(v, rng)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_perturb(v, rng) for v in params)
    return np.asarray(params, np.float32)


def _jax_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _port(module, params):
    module.load_state_dict(zoo_state_dict(module, params), strict=True)
    return module


def _compare(ours, theirs, dtype):
    ours, theirs = np.asarray(ours, np.float32), np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape
    assert np.isfinite(ours).all()
    if dtype == "f32":
        np.testing.assert_allclose(ours, theirs, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(ours, theirs, atol=BF16_REL * np.abs(theirs).max(), rtol=0)


SN = JB.BlockConfig(use_spectral_norm=True)
SEP = JB.BlockConfig(separable=True)
SEP_SN = JB.BlockConfig(use_spectral_norm=True, separable=True)


def _port_cfg(cfg):
    return B.BlockConfig(cfg.init, cfg.use_spectral_norm, cfg.norm, cfg.nonlin, cfg.separable)


def _upsample_separable_reference(cfg, params, x):
    """The separable upsample block from the JAX package's primitives with
    the depthwise weight its grouping needs, (4, 4, 1, Cin): the JAX
    builder's (4, 4, Cin, Cin) is refused by ``lax.conv`` for Cin > 1."""
    conv = params["conv"]
    h = JB._conv_transpose_s2(conv["depthwise_t"], x, groups=x.shape[-1])
    h = JB._conv(conv["pointwise"], h)
    return JB.tnn.nonlinearity(cfg.nonlin, JB._norm_apply(cfg, params.get("norm"), h))


def _depthwise_t(params, rng, cin):
    params["conv"]["depthwise_t"]["w"] = rng.standard_normal((4, 4, 1, cin)).astype(np.float32) * 0.25
    if "sn_u" in params["conv"]["depthwise_t"]:
        u = rng.standard_normal(cin).astype(np.float32)
        params["conv"]["depthwise_t"]["sn_u"] = u / np.linalg.norm(u)
    return params


# (id, JAX init(key) -> params, JAX apply(params, x), port module from the JAX config, input (N, H, W, C))
def _cases():
    cases = []
    for norm in ("instance", "layer", "pixel", "none_affine", "none"):
        cfg = JB.BlockConfig(norm=norm)
        cases.append((f"conv3_block-{norm}", lambda k, c=cfg: JB.init_conv_block(k, 3, 4, 8, c),
                      lambda p, x, c=cfg: JB.apply_conv_block(c, p, x), lambda c=cfg: B.ConvBlock(3, 4, 8, _port_cfg(c)),
                      (2, 32, 32, 4)))
    for name, cfg in (("sn", SN), ("separable", SEP), ("separable-sn", SEP_SN),
                      ("leaky-xavier", JB.BlockConfig(nonlin="leaky_relu_02", init="xavier"))):
        cases.append((f"conv7_block-{name}", lambda k, c=cfg: JB.init_conv_block(k, 7, 4, 8, c),
                      lambda p, x, c=cfg: JB.apply_conv_block(c, p, x), lambda c=cfg: B.ConvBlock(7, 4, 8, _port_cfg(c)),
                      (2, 32, 32, 4)))
    for name, cfg in (("sn", SN), ("separable-sn", SEP_SN)):
        cases.append((f"conv3-{name}", lambda k, c=cfg: JB.init_conv3(k, 4, 8, True, c),
                      lambda p, x: JB.apply_conv3(p, x), lambda c=cfg: B.conv3(4, 8, True, _port_cfg(c)), (2, 32, 32, 4)))
    for name, cfg, out_1x1, shape in (("instance", JB.BlockConfig(), False, (2, 32, 32, 4)),
                                      ("separable-sn-layer", JB.BlockConfig("he", True, "layer", "relu", True), False,
                                       (2, 32, 32, 4)),
                                      ("output_1x1", JB.BlockConfig(), True, (2, 2, 2, 4)),
                                      ("output_1x1-pixel", JB.BlockConfig(norm="pixel"), True, (2, 2, 2, 4))):
        cases.append((f"downsample-{name}", lambda k, c=cfg, o=out_1x1: JB.init_downsample_block(k, 4, 8, o, c),
                      lambda p, x, c=cfg: JB.apply_downsample_block(c, p, x),
                      lambda c=cfg, o=out_1x1: B.DownsampleBlock(4, 8, o, _port_cfg(c)), shape))
    cases.append(("upsample-sn", lambda k: JB.init_upsample_block(k, 4, 8, SN),
                  lambda p, x: JB.apply_upsample_block(SN, p, x), lambda: B.UpsampleBlock(4, 8, _port_cfg(SN)),
                  (2, 16, 16, 4)))
    cases.append(("upsample-separable-cin1", lambda k: JB.init_upsample_block(k, 1, 8, SEP),
                  lambda p, x: JB.apply_upsample_block(SEP, p, x), lambda: B.UpsampleBlock(1, 8, _port_cfg(SEP)),
                  (2, 16, 16, 1)))
    cases.append(("upsample-separable-sn-cin4",
                  lambda k: _depthwise_t(JB.init_upsample_block(k, 4, 8, SEP_SN), np.random.default_rng(5), 4),
                  lambda p, x: _upsample_separable_reference(SEP_SN, p, x), lambda: B.UpsampleBlock(4, 8, _port_cfg(SEP_SN)),
                  (2, 16, 16, 4)))
    for name, cfg, is_1x1, scale in (("3x3-sn", SN, False, False), ("learned_scale", JB.BlockConfig(), False, True),
                                     ("1x1-sn", SN, True, False), ("separable-sn-pixel",
                                                                   JB.BlockConfig("he", True, "pixel", "relu", True),
                                                                   False, False)):
        cases.append((f"resnet-{name}", lambda k, c=cfg, o=is_1x1, s=scale: JB.init_resnet_block(k, 8, c, o, s),
                      lambda p, x, c=cfg, o=is_1x1: JB.apply_resnet_block(c, p, x, is_1x1=o),
                      lambda c=cfg, o=is_1x1, s=scale: B.ResnetBlock(8, _port_cfg(c), o, s), (2, 16, 16, 8)))
    cases.append(("separable-conv2d", lambda k: jsep.init_separable_conv(k, 3, 4, 8, bias=True),
                  lambda p, x: jsep.separable_conv2d(p, x), lambda: separable.separable_conv(3, 4, 8, True),
                  (2, 32, 32, 4)))
    cases.append(("separable-conv_block", lambda k: jsep.init_separable_conv_block(k, 3, 4, 8),
                  lambda p, x: jsep.separable_conv_block(p, x, "silu"),
                  lambda: separable.separable_conv_block(3, 4, 8, "silu"), (2, 32, 32, 4)))
    cases.append(("separable-resnet", lambda k: jsep.init_separable_resnet_block(k, 8),
                  lambda p, x: jsep.separable_resnet_block(p, x, "elu"),
                  lambda: separable.separable_resnet_block(8, "elu"), (2, 16, 16, 8)))
    cases.append(("layer_norm_2d", lambda k: JB.tnn.init_norm_affine(8), lambda p, x: jnorms.layer_norm_2d(p, x),
                  lambda: norms_extra.LayerNorm2d(8), (2, 16, 16, 8)))
    cases.append(("pixel_norm", lambda k: {}, lambda p, x: jnorms.pixel_norm(x), norms_extra.PixelNorm, (2, 16, 16, 8)))
    cases.append(("bias_2d", lambda k: jnorms.init_bias_2d(8), lambda p, x: jnorms.bias_2d(p, x),
                  lambda: norms_extra.Bias2d(8), (2, 16, 16, 8)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_matches_jax(case, dtype):
    name, jinit, japply, make, shape = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    params = _perturb(jinit(jax.random.PRNGKey(7)), rng)
    x = rng.standard_normal(shape).astype(np.float32)
    module = _port(make(), params)
    if dtype == "f32":
        theirs = jax.jit(japply)(_jax_tree(params), jnp.asarray(x))
        ours = _nhwc(module(_nchw(x)))
    else:
        theirs = japply(_jax_tree(params), jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)
        ours = _nhwc(module(_nchw(x).bfloat16()))
    _compare(ours, np.asarray(theirs), dtype)


def test_spectral_norm_is_applied_and_advanced_as_in_jax(rng):
    """Three ``advance_spectral`` steps move ``sn_u`` of every conv of a
    separable spectral resnet block as JAX's do (1e-6); the block's output
    after them matches; a forward alone persists nothing; and the flag
    matters at the conv (the instance norm after it cancels sigma)."""
    cfg = JB.BlockConfig("he", True, "instance", "relu", True)
    params = _perturb(JB.init_resnet_block(jax.random.PRNGKey(3), 8, cfg), rng)
    module = _port(B.ResnetBlock(8, _port_cfg(cfg)), params)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    before = {k: v.clone() for k, v in module.state_dict().items() if k.endswith("sn_u")}
    assert len(before) == 4
    module(_nchw(x))
    assert all(torch.equal(module.state_dict()[k], v) for k, v in before.items())
    jparams = _jax_tree(params)
    for _ in range(3):
        jparams = JB.advance_spectral(jparams)
        B.advance_spectral(module)
    theirs = zoo_state_dict(module, jax.tree_util.tree_map(np.asarray, jparams))
    for key in before:
        np.testing.assert_allclose(module.state_dict()[key].numpy(), theirs[key].numpy(), atol=SN_U_ATOL, rtol=0)
        assert not torch.allclose(module.state_dict()[key], before[key], atol=1e-3)
    _compare(_nhwc(module(_nchw(x))), np.asarray(JB.apply_resnet_block(cfg, jparams, jnp.asarray(x))), "f32")
    conv = module.conv0.pointwise
    raw = _nhwc(conv(_nchw(x)))
    conv.sn_u = None
    assert not np.allclose(raw, _nhwc(conv(_nchw(x))), atol=1e-3)


def test_batch_norm_running_statistics_over_two_training_calls(rng):
    """Two training calls advance the running statistics as JAX's
    ``batch_norm`` does (unbiased variance, momentum 0.1); then an eval
    call uses them; bf16 statistics stay f32."""
    jparams = _perturb(jnorms.init_batch_norm(8), rng)
    module = _port(norms_extra.BatchNorm2d(8), jparams)
    jparams = _jax_tree(jparams)
    module.train()
    for i in range(2):
        x = (rng.standard_normal((2, 16, 16, 8)) * (1 + i) + i).astype(np.float32)
        theirs, jparams = jnorms.batch_norm(jparams, jnp.asarray(x), training=True)
        _compare(_nhwc(module(_nchw(x))), np.asarray(theirs), "f32")
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(module, key).numpy(), np.asarray(jparams[key]), atol=1e-6, rtol=0)
    module.eval()
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    theirs, _ = jnorms.batch_norm(jparams, jnp.asarray(x), training=False)
    _compare(_nhwc(module(_nchw(x))), np.asarray(theirs), "f32")
    theirs, _ = jnorms.batch_norm(jparams, jnp.asarray(x, jnp.bfloat16), training=False)
    _compare(_nhwc(module(_nchw(x).bfloat16())), np.asarray(theirs.astype(jnp.float32)), "bf16")
    assert module.running_var.dtype == torch.float32


def _unet_cfgs(mode, block):
    kw = dict(image_size=32, input_channels=4, start_channels=4, bottleneck_image_size=8, num_bottleneck_blocks=2,
              max_channels=8, upsample_mode=mode)
    return jresize_conv.ResizeConvUNetConfig(**kw, block=block), resize_conv.ResizeConvUNetConfig(**kw, block=_port_cfg(block))


def _encdec_cfgs(mode):
    kw = dict(image_size=32, input_channels=4, start_channels=4, bottleneck_image_size=8, num_bottleneck_blocks=2,
              max_channels=8, upsample_mode=mode)
    return jresize_conv.ResizeConvEncoderDecoderConfig(**kw), resize_conv.ResizeConvEncoderDecoderConfig(**kw)


NETS = [(net, mode, block) for mode in ("bilinear", "nearest") for net, block in
        (("encoder_decoder", None), ("unet", JB.BlockConfig()), ("unet-separable-sn", SEP_SN))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("net,mode,block", NETS, ids=[f"{n}-{m}" for n, m, _ in NETS])
def test_resize_conv_net_matches_jax(net, mode, block, dtype, rng):
    """Every level's feature of both resize-conv nets, both upsample modes."""
    if net == "encoder_decoder":
        jcfg, cfg = _encdec_cfgs(mode)
        params = _perturb(jresize_conv.init(jax.random.PRNGKey(1), jcfg), rng)
        module = _port(resize_conv.ResizeConvEncoderDecoder(cfg), params)
        japply = jresize_conv.apply
    else:
        jcfg, cfg = _unet_cfgs(mode, block)
        params = _perturb(jresize_conv.unet_init(jax.random.PRNGKey(2), jcfg), rng)
        module = _port(resize_conv.ResizeConvUNet(cfg), params)
        japply = jresize_conv.unet_apply
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    jdtype, tdtype = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    run = jax.jit(japply, static_argnums=0) if dtype == "f32" else japply
    theirs = run(jcfg, _jax_tree(params), jnp.asarray(x, jdtype))
    ours = module(_nchw(x).to(tdtype))
    assert len(ours) == len(theirs) == 3
    for o, t in zip(ours, theirs):
        assert o.dtype == tdtype
        _compare(_nhwc(o), np.asarray(t.astype(jnp.float32)), dtype)


def test_unet_gradient_matches_jax_grad(rng):
    """d(loss)/d(every parameter) and d(loss)/d(input) of the ResizeConvUNet,
    loss = the mean square of every level's feature, against ``jax.grad``."""
    jcfg, cfg = _unet_cfgs("bilinear", JB.BlockConfig())
    params = _perturb(jresize_conv.unet_init(jax.random.PRNGKey(4), jcfg), rng)
    module = _port(resize_conv.ResizeConvUNet(cfg), params)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)

    def jloss(p, image):
        return sum(jnp.mean(f ** 2) for f in jresize_conv.unet_apply(jcfg, p, image))

    jgrads, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_jax_tree(params), jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    loss = sum((f ** 2).mean() for f in module(xt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jax.jit(jloss)(_jax_tree(params), jnp.asarray(x))), rtol=1e-6)
    theirs = zoo_state_dict(module, jax.tree_util.tree_map(np.asarray, jgrads))
    grads = dict(module.named_parameters())
    assert set(theirs) == set(grads)
    for key, g in theirs.items():
        ours = grads[key].grad.numpy()
        np.testing.assert_allclose(ours, g.numpy(), atol=GRAD_REL * np.abs(g.numpy()).max(), rtol=0, err_msg=key)
    gx = _nhwc(xt.grad)
    np.testing.assert_allclose(gx, np.asarray(jgx), atol=GRAD_REL * np.abs(np.asarray(jgx)).max(), rtol=0)
