"""The mode_07 teacher of the PyTorch port (U-Net, body morpher, upscaler,
the 33-output DAG) against the JAX package.

Blocks, networks and the whole teacher run in f32 on the CPU at small
widths: the five-level tiny U-Net and the small mode_12 networks of
tests/test_multichip.py:133-147 (model channels 8, attention at the deepest
level, 32^2 tokens at 512^2), at the real image geometry.  Weights cross
between the packages as reference state dicts: port state dicts through the
JAX converters (``tha4_tpu/convert/torch_weights.py``), or JAX params
through the port's bridge (``convert.export_torch.teacher_07_state_dicts``).
The zero-init layers get small random weights (``charmodel.synthetic.
random_teacher_07``), so every residual branch runs and the warps move by a
few pixels; images are smooth synthetic characters, as in
tests/test_torch_teacher.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_teacher import SMALL, _images
from tha4_tpu.convert import torch_weights as jtw
from tha4_tpu.models import body_morpher as jbody_morpher
from tha4_tpu.models import eyebrow as jeyebrow
from tha4_tpu.models import face_morpher as jface_morpher
from tha4_tpu.models import unet as junet
from tha4_tpu.models import upscaler as jupscaler
from tha4_tpu.ops import nn as jnn
from tha4_tpu.poser.modes import mode_07 as jmode_07
from tha4_tpu_torch.charmodel.synthetic import random_teacher_07
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.models import body_morpher, eyebrow, face_morpher, unet, upscaler
from tha4_tpu_torch.ops import cuda_warp
from tha4_tpu_torch.ops import nn as tnn
from tha4_tpu_torch.poser.modes import mode_07

torch.set_num_threads(2)

# Bars of tests/test_teacher_nets.py:236,293,335 (U-Net 5e-5, body morpher
# and upscaler 1e-4, against the reference torch modules in f32).
UNET_ATOL, MORPHER_ATOL = 5e-5, 1e-4


def _tiny_unet(new_order=True, **kw):
    return dict(
        in_channels=4, out_channels=7, model_channels=8, level_channel_multipliers=(1, 1, 1, 2, 2),
        level_use_attention=(False, False, False, False, True), num_res_blocks_per_level=1,
        num_middle_res_blocks=2, cond_input_channels=6, cond_internal_channels=16,
        attention=dict(num_heads=2, use_new_attention_order=new_order), **kw,
    )


def _unet_cfgs(new_order=True):
    kw = _tiny_unet(new_order)
    attention = kw.pop("attention")
    return (junet.UnetConfig(attention=junet.AttentionConfig(**attention), **kw),
            unet.UnetConfig(attention=unet.AttentionConfig(**attention), **kw))


def _teacher_cfgs():
    jun, un = _unet_cfgs()
    jcfg = jmode_07.TeacherConfig(
        eyebrow_decomposer=jeyebrow.EyebrowDecomposerConfig(**SMALL),
        eyebrow_combiner=jeyebrow.EyebrowCombinerConfig(**SMALL),
        face_morpher=jface_morpher.FaceMorpherConfig(**SMALL),
        body_morpher=jbody_morpher.BodyMorpherConfig(unet=jun),
        upscaler=jupscaler.UpscalerConfig(unet=jun),
    )
    cfg = mode_07.TeacherConfig(
        eyebrow_decomposer=eyebrow.EyebrowDecomposerConfig(**SMALL),
        eyebrow_combiner=eyebrow.EyebrowCombinerConfig(**SMALL),
        face_morpher=face_morpher.FaceMorpherConfig(**SMALL),
        body_morpher=body_morpher.BodyMorpherConfig(unet=un),
        upscaler=upscaler.UpscalerConfig(unet=un),
    )
    return jcfg, cfg


def _np_sd(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _randomize(module, seed):
    """Every conv and linear at torch's default init, norms with random
    affines: no zero branch left."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tnn.GroupNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / float(np.sqrt(m.weight[0].numel()))
                m.weight.uniform_(-bound, bound, generator=gen)
                m.bias.uniform_(-bound, bound, generator=gen)
    return module


def _to_jax_07(params, jcfg):
    """Port state dicts -> JAX mode_07 params, through the JAX converters."""
    sd = {k: _np_sd(v) for k, v in params.items()}
    return {
        "eyebrow_decomposer": jtw.convert_eyebrow_decomposer(sd["eyebrow_decomposer"]),
        "eyebrow_morphing_combiner": jtw.convert_eyebrow_morphing_combiner(sd["eyebrow_morphing_combiner"]),
        "face_morpher": jtw.convert_face_morpher_08(sd["face_morpher"]),
        "body_morpher": jtw.convert_morpher_00(sd["body_morpher"], jcfg.body_morpher.unet),
        "upscaler": jtw.convert_upscaler_02(sd["upscaler"], jcfg.upscaler.unet),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [8, 64, 96])
def test_group_norm_matches_jax(rng, dtype, channels):
    """min(32, C) groups.  f32 to rounding; bf16 follows the JAX bf16
    arithmetic (tests/test_torch_teacher.py:89-107)."""
    x = (rng.standard_normal((2, 8, 8, channels)) * 3.0 + 1.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, channels).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jnn.group_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x).astype(jdtype), min(32, channels))
    norm = tnn.GroupNorm(channels)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        ours = norm(torch.from_numpy(x).to(dtype))
    assert ours.dtype == dtype and norm.num_groups == min(32, channels)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    else:
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2.0**-8, atol=2.0**-8)
        assert np.mean(ours.float().numpy() == ref) >= 0.95


@pytest.mark.parametrize("sampling,cin,cout", [("same", 8, 16), ("same", 16, 16), ("down", 8, 8), ("up", 16, 16)])
def test_resblock_matches_jax(rng, sampling, cin, cout):
    block = _randomize(unet.ResBlock(cin, cout, 16, sampling), 1)
    params = jtw._unet_resblock({f"m.{k}": v for k, v in _np_sd(block.state_dict()).items()}, "m")
    x = rng.standard_normal((2, 16, 16, cin)).astype(np.float32)
    t_emb, cond = (rng.standard_normal((2, 16)).astype(np.float32) for _ in range(2))
    ref = junet._resblock(_jax(params), jnp.asarray(x), jnp.asarray(t_emb), jnp.asarray(cond), sampling)
    with torch.no_grad():
        ours = block(torch.from_numpy(x), torch.from_numpy(t_emb), torch.from_numpy(cond), 1.0)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("new_order", [True, False])
def test_attention_matches_jax(rng, new_order):
    cfg = unet.AttentionConfig(num_heads=2, use_new_attention_order=new_order)
    block = _randomize(unet.AttentionBlock(16, cfg), 2)
    params = jtw._attention_block({f"m.{k}": v for k, v in _np_sd(block.state_dict()).items()}, "m")
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    ref = junet._attention(_jax(params), jnp.asarray(x), junet.AttentionConfig(num_heads=2, use_new_attention_order=new_order))
    with torch.no_grad():
        ours = block(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("new_order", [True, False])
def test_unet_matches_jax(rng, new_order):
    jcfg, cfg = _unet_cfgs(new_order)
    net = _randomize(unet.Unet(cfg), 3)
    params = jtw.convert_unet(_np_sd(net.state_dict()), jcfg)
    x = rng.standard_normal((2, 64, 64, 4)).astype(np.float32)
    t = np.array([[0.0], [3.7]], np.float32)  # the vestigial time path at t != 0 too
    pose = rng.uniform(-1, 1, (2, 6)).astype(np.float32)
    addition = (0.1 * rng.standard_normal((2, 64, 64, 8))).astype(np.float32)
    ref = jax.jit(functools.partial(junet.apply, jcfg))(_jax(params), *(jnp.asarray(a) for a in (x, t, pose, addition)))
    with torch.no_grad():
        ours = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(pose), torch.from_numpy(addition))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=UNET_ATOL)


@pytest.mark.parametrize("new_order", [True, False])
def test_bf16_unet_is_as_close_to_f32_as_jax_bf16(rng, new_order):
    """The port's bf16 U-Net (K6's one rounding per fused conv, where JAX's
    plain chain rounds after every step) against JAX's f32 U-Net: its RMS
    error at most JAX's own bf16 U-Net's, its largest error within 1.5x
    JAX's (a cascade's largest error lands on one pixel or another: read
    0.88x / 0.90x here, 1.36x on other inputs; RMS 0.81x / 0.76x)."""
    jcfg, cfg = _unet_cfgs(new_order)
    net = _randomize(unet.Unet(cfg), 3)
    params = _jax(jtw.convert_unet(_np_sd(net.state_dict()), jcfg))
    x = rng.standard_normal((2, 64, 64, 4)).astype(np.float32)
    t = np.array([[0.0], [3.7]], np.float32)
    pose = rng.uniform(-1, 1, (2, 6)).astype(np.float32)
    addition = (0.1 * rng.standard_normal((2, 64, 64, 8))).astype(np.float32)
    run = jax.jit(functools.partial(junet.apply, jcfg))
    ref = np.asarray(run(params, *(jnp.asarray(a) for a in (x, t, pose, addition))))
    b16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jax16 = np.asarray(run(params, b16(x), jnp.asarray(t), jnp.asarray(pose), b16(addition)).astype(jnp.float32))
    for m in net.modules():  # the bf16 teacher's storage (Teacher.freeze)
        if isinstance(m, nn.Conv2d):
            m.to(torch.bfloat16)
    with torch.no_grad():
        ours = net(torch.from_numpy(x).bfloat16(), torch.from_numpy(t), torch.from_numpy(pose), torch.from_numpy(addition).bfloat16())
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    rms = lambda d: float(np.sqrt(np.mean(d * d)))
    assert rms(ours - ref) <= rms(jax16 - ref)
    assert np.abs(ours - ref).max() <= 1.5 * np.abs(jax16 - ref).max()


@pytest.fixture(scope="module")
def teacher_run():
    """The tiny teacher from ``random_teacher_07`` (its flows scaled up to a
    few pixels at these narrow widths), both packages' 33 outputs on the
    same images and poses."""
    jcfg, cfg = _teacher_cfgs()
    params = random_teacher_07(torch.Generator().manual_seed(31), cfg)
    with torch.no_grad():
        for net in ("body_morpher", "upscaler"):
            params[net]["body.last.2.weight"][4:6] *= 8.0
    teacher = mode_07.Teacher.from_params(params, cfg)
    jparams = _to_jax_07(params, jcfg)
    rng = np.random.default_rng(32)
    image = _images(int(rng.integers(1000)), 2)
    pose = rng.uniform(0.0, 1.0, (2, 45)).astype(np.float32)
    pose[:, 35:45] = rng.uniform(-1.0, 1.0, (2, 10))
    ref = jax.jit(functools.partial(jmode_07.compute_outputs, jcfg))(_jax(jparams), jnp.asarray(image), jnp.asarray(pose))
    with torch.no_grad():
        ours = mode_07.compute_outputs(teacher, torch.from_numpy(image), torch.from_numpy(pose))
    return jcfg, jparams, teacher, image, pose, [np.asarray(r) for r in ref], [o.numpy() for o in ours]


def test_mode_07_all_33_outputs_match_jax_f32(teacher_run):
    """Each network's input already carries the upstream networks' f32
    differences, so the cascade's bars are twice the per-network ones (the
    mode_12 precedent, tests/test_torch_teacher.py:167-181): 2e-4 for the
    upscaler's and the body's outputs and face_morphed_full, the mode_12
    cascade bars for the rest.  The upscaler's two warps of
    face_morphed_full (outputs 0 and 2) get 3e-3: that image has a hard
    edge, jumps of up to 2 between neighbouring pixels, where the pasted
    face square meets the character, so the grid change's f32 difference
    (held at 2e-4, measured 6.7e-6, i.e. 1.7e-3 px) moves a sample there by
    up to 1.4e-3 (measured).  Every output also clears 70 dB PSNR."""
    *_, ref, ours = teacher_run
    assert len(ours) == len(ref) == mode_07.OUTPUT_LENGTH == 33
    bars = [3e-3, 2e-4, 3e-3] + [2 * MORPHER_ATOL] * 8 + [4e-4] * 8 + [1e-4] * 8 + [2e-5] * 6
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert o.shape == r.shape, i
        np.testing.assert_allclose(o, r, atol=bars[i], err_msg=f"output {i}")
        mse = float(np.mean((o.astype(np.float64) - r) ** 2))
        assert mse == 0.0 or 10.0 * np.log10(4.0 / mse) > 70.0, (i, mse)
    # The grid changes (upscaler output 3, body output 9) move the warps by
    # more than a pixel: 2 / size normalised units per pixel.
    assert np.abs(ref[3]).max() > 2 / 512 and np.abs(ref[9]).max() > 2 / 256


@pytest.mark.parametrize("net", ["body_morpher", "upscaler"])
def test_teacher_unet_networks_match_jax_f32(teacher_run, rng, net):
    jcfg, jparams, teacher, *_ = teacher_run
    images = _images(int(rng.integers(1000)), 4)
    pose = rng.uniform(-1, 1, (2, 6)).astype(np.float32)
    with torch.no_grad():
        if net == "body_morpher":
            x = np.ascontiguousarray(images[:2, ::2, ::2])
            ref = jax.jit(functools.partial(jbody_morpher.apply, jcfg.body_morpher))(_jax(jparams["body_morpher"]), jnp.asarray(x), jnp.asarray(pose))
            ours = teacher.body_morpher(torch.from_numpy(x), torch.from_numpy(pose))
        else:
            rest, coarse = images[:2], images[2:]
            grid = (0.01 * rng.standard_normal((2, 512, 512, 2))).astype(np.float32)
            grid = np.array(jax.image.resize(jnp.asarray(grid[:, ::64, ::64]), (2, 512, 512, 2), "bilinear"))
            ref = jax.jit(functools.partial(jupscaler.apply, jcfg.upscaler))(_jax(jparams["upscaler"]), *(jnp.asarray(a) for a in (rest, coarse, grid, pose)))
            ours = teacher.upscaler(*(torch.from_numpy(a) for a in (rest, coarse, grid, pose)))
    assert len(ours) == len(ref) == 5
    for i, (o, r) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=MORPHER_ATOL, err_msg=f"{net} output {i}")


def test_bridge_round_trips_both_ways(teacher_run):
    """port init -> state dicts -> the JAX converters -> the port's bridge ->
    the same tensors; and JAX params (the layout of ``jmode_07.init``) ->
    the bridge -> the port's modules -> the JAX converters -> the same
    arrays."""
    jcfg, jparams, *_ = teacher_run
    cfg = _teacher_cfgs()[1]
    params = mode_07.init(torch.Generator().manual_seed(3), cfg)
    back = export_torch.teacher_07_state_dicts(_to_jax_07(params, jcfg))
    assert back.keys() == params.keys() == set(mode_07.NETWORK_KEYS)
    for key in params:
        assert back[key].keys() == params[key].keys(), key
        for name, t in params[key].items():
            assert torch.equal(back[key][name], t), (key, name)
    # The zero-init layers start at zero, the others do not.
    body = params["body_morpher"]
    assert not body["body.last.2.weight"].any() and not body["body.down_blocks.0.res_blocks.0.conv1.bias"].any()
    assert not body["body.middle_blocks.1.module.conv.weight"].any()
    assert not params["upscaler"]["coarse_image_conv.weight"].any() and body["body.first_conv.weight"].any()

    layout = jax.eval_shape(functools.partial(jmode_07.init, cfg=jcfg), jax.random.PRNGKey(4))
    assert jax.tree.structure(layout) == jax.tree.structure(jparams)
    assert [a.shape for a in jax.tree.leaves(layout)] == [a.shape for a in jax.tree.leaves(jparams)]
    teacher = mode_07.Teacher.from_params(export_torch.teacher_07_state_dicts(jparams), cfg)
    again = _to_jax_07(teacher.params(), jcfg)
    assert jax.tree.structure(again) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_freeze_and_bf16_teacher_runs_five_warps(monkeypatch):
    """bf16 convs, f32 norms and linears; 33 finite bf16 outputs of the
    expected shapes through exactly five warps (K2 on the card)."""
    _, cfg = _teacher_cfgs()
    teacher = mode_07.Teacher.from_params(random_teacher_07(torch.Generator().manual_seed(5), cfg), cfg)
    teacher.freeze(torch.bfloat16, "cpu")
    assert not any(p.requires_grad for p in teacher.parameters())
    assert teacher.upscaler.body.first_conv.weight.dtype == torch.bfloat16
    assert teacher.upscaler.body.last[0].weight.dtype == torch.float32
    assert teacher.body_morpher.body.cond_embed[0].weight.dtype == torch.float32
    calls = []
    monkeypatch.setattr(cuda_warp, "grid_sample_fast", lambda image, grid: calls.append(image.shape) or cuda_warp.grid_sample_bilinear_border(image, grid))
    rng = np.random.default_rng(6)
    image = torch.from_numpy(_images(7, 1)).bfloat16()
    pose = torch.from_numpy(rng.uniform(0, 1, (1, 45)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        outs = mode_07.compute_outputs(teacher, image, pose)
    assert [tuple(s) for s in calls] == [(1, 128, 128, 4), (1, 192, 192, 4), (1, 256, 256, 4), (1, 512, 512, 4), (1, 512, 512, 4)]
    assert all(o.dtype == torch.bfloat16 and bool(torch.isfinite(o.float()).all()) for o in outs)
    assert [tuple(o.shape[1:]) for o in outs[:11]] == [(512, 512, 4), (512, 512, 1), (512, 512, 4), (512, 512, 2), (512, 512, 4),
                                                       (512, 512, 4), (256, 256, 4), (256, 256, 1), (256, 256, 4), (256, 256, 2), (256, 256, 4)]


def test_shipped_configs_match_jax():
    assert dataclasses.asdict(mode_07.TeacherConfig()) == dataclasses.asdict(jmode_07.TeacherConfig())
    assert mode_07.DEFAULT_TEACHER_FILES == jmode_07.DEFAULT_TEACHER_FILES
    assert mode_07.INDEX_FACE_MORPHED_FULL == jmode_07.INDEX_FACE_MORPHED_FULL


def test_mode_07_runs_in_f64_as_the_f32_runs_reference(teacher_run):
    """The same teacher frozen in f64 on the CPU computes every output in
    f64 (group norms, resizes, warps, softmax and embeddings included): the
    exact answer that tells which of two f32 results is off.  Each f32 run
    is about twice as far from it as the two f32 runs are from each other
    (measured: upscaler warped 3.3e-3 port, 3.9e-3 JAX, 1.6e-3 apart), and
    the port is, output by output, no further from it than the JAX package
    is, within 1.5x."""
    import copy

    _, _, teacher, image, pose, ref, ours = teacher_run
    exact_teacher = copy.deepcopy(teacher).freeze(torch.float64, "cpu")
    with torch.no_grad():
        exact = mode_07.compute_outputs(exact_teacher, torch.from_numpy(image).double(), torch.from_numpy(pose).double())
    assert all(e.dtype == torch.float64 for e in exact)
    for i, (e, o, r) in enumerate(zip(exact, ours, ref)):
        port_err, jax_err = (float(np.abs(x - e.numpy()).max()) for x in (o, r))
        assert 0.0 < port_err <= 1.5 * jax_err + 1e-7, (i, port_err, jax_err)
