"""The mode_12 face teacher of the PyTorch port against the JAX package.

Blocks, networks and the whole teacher run at small widths (the small
teacher of tests/test_distill.py:24-38: start 4 channels, max 8) and the
real image geometry, in f32 on the CPU.  Weights cross between the packages
as reference state dicts: JAX params through the port's bridge
(``convert.export_torch.face_teacher_state_dicts``), or port state dicts
through the JAX converters (``tha4_tpu/convert/torch_weights.py``).  The
zero-init grid-change heads get small random weights so the warps move, by
a few pixels, as a trained teacher's do.  The images are seeded
synthetic characters: smooth, as character art is, so a warp turns the
~1e-5 relative drift of two valid f32 evaluation orders into errors of that
order and not into the jumps between neighbouring pixels of white noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.convert import torch_weights as jtw
from tha4_tpu.models import encoder_decoder as jencdec
from tha4_tpu.models import eyebrow as jeyebrow
from tha4_tpu.models import face_morpher as jface_morpher
from tha4_tpu.ops import nn as jnn
from tha4_tpu.poser.modes import mode_12 as jmode_12
from tha4_tpu_torch.charmodel.synthetic import synthetic_character_image
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.models import encoder_decoder, eyebrow, face_morpher
from tha4_tpu_torch.ops import nn as tnn
from tha4_tpu_torch.poser.modes import mode_12

torch.set_num_threads(2)

# Bars of tests/test_teacher_nets.py:87,131,165 (decomposer, combiner, face
# morpher against the reference torch modules in f32).
DECOMPOSER_ATOL, COMBINER_ATOL, FACE_ATOL = 2e-5, 5e-5, 2e-4
SMALL = dict(start_channels=4, num_bottleneck_blocks=1, max_channels=8)


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _seeded(module, seed):
    for m in module.modules():
        if isinstance(m, tnn.InstanceNorm2d):  # give the affine non-trivial values
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed))
                m.bias.uniform_(-0.2, 0.2, generator=torch.Generator().manual_seed(seed + 1))
    tnn.reset_convs_(module, "he", torch.Generator().manual_seed(seed))
    return module


@pytest.mark.parametrize("nonlin", ["relu", "leaky_relu_02"])
def test_blocks_match_jax_f32(rng, nonlin):
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    cases = [
        (tnn.conv_block(6, 8, nonlin), lambda sd: jtw._conv_block(sd, "m"),
         lambda p, x: jnn.conv_block(p, x, nonlin)),
        (tnn.downsample_block(6, 8, nonlin), lambda sd: jtw._conv_block(sd, "m"),
         lambda p, x: jnn.downsample_block(p, x, nonlin)),
        (tnn.upsample_block(6, 8, nonlin), lambda sd: jtw._upsample_block(sd, "m"),
         lambda p, x: jnn.upsample_block(p, x, nonlin)),
        (tnn.ResnetBlock(6, nonlin), lambda sd: jtw._resnet_block(sd, "m"),
         lambda p, x: jnn.resnet_block(p, x, nonlin)),
    ]
    for i, (module, convert, apply) in enumerate(cases):
        module = _seeded(module, i)
        params = convert({f"m.{k}": v for k, v in _np_sd(module).items()})
        ref = np.asarray(apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
        with torch.no_grad():
            ours = _nhwc(module(_nchw(x)))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=2e-5, err_msg=type(module).__name__ + str(i))


def test_instance_norm_matches_jax(rng):
    """f32 to rounding; bf16 follows the JAX bf16 arithmetic (f32 mean, bf16
    centring, f32 variance of the bf16 squares), so the two round the same
    values: at most one bf16 step (2^-8 relative) apart where the f32 sums'
    order tips a rounding."""
    x = (rng.standard_normal((2, 8, 8, 5)) * 3.0 + 1.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 5).astype(np.float32)
    for dtype, jdtype in [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]:
        ref = jnn.instance_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x).astype(jdtype))
        ours = tnn.instance_norm(_nchw(x).to(dtype), torch.from_numpy(scale), torch.from_numpy(bias))
        assert ours.dtype == dtype
        ref = np.asarray(ref.astype(jnp.float32))
        ours = _nhwc(ours.float())
        if dtype == torch.float32:
            np.testing.assert_allclose(ours, ref, atol=1e-5)
        else:
            np.testing.assert_allclose(ours, ref, rtol=2.0**-8, atol=2.0**-8)
            assert np.mean(ours == ref) >= 0.95


def test_encoder_decoder_matches_jax(rng):
    kw = dict(image_size=32, input_image_channels=4, num_pose_params=3, start_channels=4,
              bottleneck_image_size=8, num_bottleneck_blocks=3, max_channels=8)
    module = _seeded(encoder_decoder.PoserEncoderDecoder00(encoder_decoder.EncoderDecoderConfig(**kw)), 7)
    params = jtw.convert_poser_encoder_decoder(_np_sd(module), "")
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    pose = rng.uniform(0, 1, (2, 3)).astype(np.float32)
    ref = jencdec.apply(jencdec.EncoderDecoderConfig(**kw), jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(pose))
    with torch.no_grad():
        ours = _nhwc(module.encode_decode(_nchw(x), torch.from_numpy(pose)))
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5)


def _jax_teacher(seed=11):
    """The small teacher at the real geometry, its JAX params with random
    grid-change heads, and the matching port configuration."""
    jcfg = jmode_12.FaceTeacherConfig(
        eyebrow_decomposer=jeyebrow.EyebrowDecomposerConfig(**SMALL),
        eyebrow_combiner=jeyebrow.EyebrowCombinerConfig(**SMALL),
        face_morpher=jface_morpher.FaceMorpherConfig(**SMALL),
    )
    params = jax.tree.map(np.asarray, jmode_12.init(jax.random.PRNGKey(seed), jcfg))
    grid_rng = np.random.default_rng(seed)
    for net, name in [("eyebrow_morphing_combiner", "morphed_eyebrow_layer_grid_change"), ("face_morpher", "iris_mouth_grid_change")]:
        w = params[net][name]["conv"]["w"]
        params[net][name]["conv"]["w"] = (grid_rng.standard_normal(w.shape) * 0.002).astype(np.float32)
    cfg = mode_12.FaceTeacherConfig(
        eyebrow_decomposer=eyebrow.EyebrowDecomposerConfig(**SMALL),
        eyebrow_combiner=eyebrow.EyebrowCombinerConfig(**SMALL),
        face_morpher=face_morpher.FaceMorpherConfig(**SMALL),
    )
    return jcfg, params, cfg


def _images(seed, n=2):
    """(n, 512, 512, 4) synthetic characters in model units, [-1, 1]."""
    return np.stack([synthetic_character_image(512, seed + i) for i in range(n)]).astype(np.float32) / 127.5 - 1.0


def _image_and_pose(rng, n=2):
    image = _images(int(rng.integers(1000)), n)
    pose = rng.uniform(0.0, 1.0, (n, 45)).astype(np.float32)
    pose[:, 35:42] = rng.uniform(-1.0, 1.0, (n, 7))
    return image, pose


@pytest.fixture(scope="module")
def teacher_run():
    jcfg, params, cfg = _jax_teacher()
    teacher = mode_12.FaceTeacher.from_params(export_torch.face_teacher_state_dicts(params), cfg)
    image, pose = _image_and_pose(np.random.default_rng(12))
    ref = jmode_12.compute_outputs(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(image), jnp.asarray(pose))
    with torch.no_grad():
        ours = mode_12.compute_outputs(teacher, torch.from_numpy(image), torch.from_numpy(pose))
    return jcfg, params, teacher, image, pose, [np.asarray(r) for r in ref], [o.numpy() for o in ours]


def test_mode_12_all_22_outputs_match_jax_f32(teacher_run):
    """Inside the cascade each network's input already carries the upstream
    networks' f32 differences (decomposer -> combiner -> face morpher), so
    the max-abs bars are twice the per-network ones, which the network tests
    below meet on identical inputs; and the PSNR floors of the JAX package's
    own cascade test (tests/test_teacher_poser_parity.py:262: 50 / 70 / 90 dB
    for face / combiner / decomposer outputs)."""
    *_, ref, ours = teacher_run
    assert len(ours) == len(ref) == mode_12.OUTPUT_LENGTH == 22
    for i, (o, r) in enumerate(zip(ours, ref)):
        atol, floor = (2 * FACE_ATOL, 50.0) if i < 8 else (2 * COMBINER_ATOL, 70.0) if i < 16 else (DECOMPOSER_ATOL, 90.0)
        assert o.shape == r.shape, i
        np.testing.assert_allclose(o, r, atol=atol, err_msg=f"output {i}")
        mse = float(np.mean((o.astype(np.float64) - r) ** 2))
        assert mse == 0.0 or 10.0 * np.log10(4.0 / mse) > floor, (i, mse)
    # The random grid-change heads really move the warps (outputs 7 and 15):
    # by more than 2 px, in normalised units of 2 / size per pixel.
    assert np.abs(ref[7]).max() > 2 * 2 / 192 and np.abs(ref[15]).max() > 2 * 2 / 128


@pytest.mark.parametrize("net", ["decomposer", "combiner", "face_morpher"])
def test_teacher_networks_match_jax_f32(teacher_run, rng, net):
    jcfg, params, teacher, *_ = teacher_run
    jp = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        images = _images(int(rng.integers(1000)), 4)
        if net == "decomposer":
            x = np.ascontiguousarray(images[:2, 64:192, 192:320])
            ref = jeyebrow.eyebrow_decomposer_apply(jcfg.eyebrow_decomposer, jp["eyebrow_decomposer"], jnp.asarray(x))
            ours, atol = teacher.eyebrow_decomposer(torch.from_numpy(x)), DECOMPOSER_ATOL
        elif net == "combiner":
            bg, eb = np.ascontiguousarray(images[:2, 64:192, 192:320]), np.ascontiguousarray(images[2:, 64:192, 192:320])
            pose = rng.uniform(0, 1, (2, 12)).astype(np.float32)
            ref = jeyebrow.eyebrow_combiner_apply(
                jcfg.eyebrow_combiner, jp["eyebrow_morphing_combiner"], jnp.asarray(bg), jnp.asarray(eb), jnp.asarray(pose)
            )
            ours = teacher.eyebrow_morphing_combiner(torch.from_numpy(bg), torch.from_numpy(eb), torch.from_numpy(pose))
            atol = COMBINER_ATOL
        else:
            x = np.ascontiguousarray(images[:2, 32:224, 160:352])
            pose = rng.uniform(0, 1, (2, 27)).astype(np.float32)
            ref = jface_morpher.apply(jcfg.face_morpher, jp["face_morpher"], jnp.asarray(x), jnp.asarray(pose))
            ours, atol = teacher.face_morpher(torch.from_numpy(x), torch.from_numpy(pose)), FACE_ATOL
    assert len(ours) == len(ref)
    for i, (o, r) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=atol, err_msg=f"{net} output {i}")


def test_bridge_round_trip_is_exact():
    """port init -> state dicts -> the JAX converters -> the port's bridge ->
    the same tensors."""
    cfg = _jax_teacher()[2]
    params = mode_12.init(torch.Generator().manual_seed(3), cfg)
    jax_params = {
        "eyebrow_decomposer": jtw.convert_eyebrow_decomposer(_np_params(params["eyebrow_decomposer"])),
        "eyebrow_morphing_combiner": jtw.convert_eyebrow_morphing_combiner(_np_params(params["eyebrow_morphing_combiner"])),
        "face_morpher": jtw.convert_face_morpher_08(_np_params(params["face_morpher"])),
    }
    back = export_torch.face_teacher_state_dicts(jax_params)
    assert back.keys() == params.keys()
    for key in params:
        assert back[key].keys() == params[key].keys(), key
        for name, t in params[key].items():
            assert torch.equal(back[key][name], t), (key, name)
    # The grid-change heads start at zero, the others do not.
    assert not params["face_morpher"]["iris_mouth_grid_change.weight"].any()
    assert params["face_morpher"]["eye_alpha.0.weight"].any()


def _np_params(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_freeze_casts_convs_and_keeps_norms_f32():
    cfg = _jax_teacher()[2]
    teacher = mode_12.FaceTeacher.from_params(mode_12.init(torch.Generator().manual_seed(5), cfg), cfg)
    teacher.freeze(torch.bfloat16, "cpu")
    assert not any(p.requires_grad for p in teacher.parameters())
    assert teacher.face_morpher.eye_alpha[0].weight.dtype == torch.bfloat16
    assert teacher.face_morpher.downsample_blocks[0][1].weight.dtype == torch.float32
    image, pose = _image_and_pose(np.random.default_rng(6), n=1)
    with torch.no_grad():
        outs = mode_12.compute_outputs(teacher, torch.from_numpy(image).bfloat16(), torch.from_numpy(pose).bfloat16())
    assert all(o.dtype == torch.bfloat16 and bool(torch.isfinite(o.float()).all()) for o in outs)
    assert outs[mode_12.INDEX_FACE_MORPHED_IMAGE].shape == (1, 192, 192, 4)


def test_shipped_config_matches_jax():
    ours, ref = dataclasses.asdict(mode_12.FaceTeacherConfig()), dataclasses.asdict(jmode_12.FaceTeacherConfig())
    assert ours == ref
