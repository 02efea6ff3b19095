"""The int8 frozen teacher of the PyTorch port (``ops/quant.py``, Q1's plain
version ``ops/cuda_int8_conv.py``, the ``ops.nn.Conv2d`` hook and the
U-Net's unfused route under a scope) against the JAX package's
``tha4_tpu/ops/quant.py``, on the CPU.

The int8 conv and the weight quantization are exact, so they are held bit
for bit; the calibration protocol as ``tests/test_quant.py`` holds JAX's;
the small mode_07 (the tiny U-Net of ``tests/test_torch_body_teacher.py``,
face networks at 16/32 channels, so that every kind of call site is
eligible) and mode_12 visit their eligible convs in JAX's order, and given
JAX's own scales file the port's int8 teacher matches JAX's int8 outputs.
Weights cross from JAX params through ``convert.export_torch``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_body_teacher import _to_jax_07, _unet_cfgs
from tests.test_torch_teacher import _images
from tha4_tpu.models import body_morpher as jbody_morpher
from tha4_tpu.models import eyebrow as jeyebrow
from tha4_tpu.models import face_morpher as jface_morpher
from tha4_tpu.models import upscaler as jupscaler
from tha4_tpu.ops import quant as jquant
from tha4_tpu.poser.modes import mode_07 as jmode_07
from tha4_tpu.poser.modes import mode_12 as jmode_12
from tha4_tpu_torch.charmodel.synthetic import random_teacher_07
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.distiller import recipes
from tha4_tpu_torch.models import body_morpher, eyebrow, face_morpher, siren, upscaler
from tha4_tpu_torch.ops import cuda_conv, cuda_int8_conv, quant
from tha4_tpu_torch.ops import nn as tnn
from tha4_tpu_torch.poser.modes import mode_07, mode_12

torch.set_num_threads(2)

FACE = dict(start_channels=16, num_bottleneck_blocks=3, max_channels=32)
# The scales of the two packages' calibrations, over the scale: the same f32
# network summed in two orders (XLA's and PyTorch's CPU convs), the maxima
# of activations that the cascade carries (read: 2.2e-6 mode_12, 1.1e-5
# mode_07).
SCALE_RTOL = 1e-4


def _bits(t) -> np.ndarray:
    """Raw bits, so that bf16 and f32 are compared exactly."""
    a = np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))
    return a.view(np.uint32)


def _jnp(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)


# ---------------------------------------------------------------------------
# The op: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [3, 1])
def test_conv2d_int8_equals_jax_bit_for_bit(rng, dtype, k):
    x = torch.from_numpy(rng.standard_normal((2, 12, 10, 24)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((k, k, 24, 40)) * 0.1).astype(np.float32))
    scale = float(x.float().abs().max()) * 1.1 / 127.0
    ours = quant.conv2d_int8(x, w, scale, k // 2)
    theirs = jquant.conv2d_int8(_jnp(x), jnp.asarray(w.numpy()), scale, k // 2)
    assert ours.dtype == dtype and tuple(ours.shape) == (2, 12, 10, 40)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))
    # The wrapper on the CPU (Q1's layout, the bias added in x's dtype) is
    # JAX's conv2d under a scope: the int8 conv, then + b.astype(x.dtype).
    b = torch.from_numpy((rng.standard_normal(40) * 0.1).astype(np.float32))
    w8, w_s = quant.quantize_weight(w)
    wrapped = cuda_int8_conv.int8_conv(x, cuda_int8_conv.weight_layout(w8), w_s, scale, k // 2, b.to(dtype))
    np.testing.assert_array_equal(_bits(wrapped), _bits(theirs + jnp.asarray(b.numpy()).astype(theirs.dtype)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_weight_equals_jax_bit_for_bit(rng, dtype):
    w = torch.from_numpy(rng.standard_normal((3, 3, 32, 48)).astype(np.float32)).to(dtype)
    w[:, :, :, 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    w8, s = quant.quantize_weight(w)
    jw8, js = jquant.quantize_weight(_jnp(w))
    assert w8.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_weight_layout_round_trips(rng):
    w8 = torch.from_numpy(rng.integers(-127, 128, (3, 3, 40, 24)).astype(np.int8))
    layout = cuda_int8_conv.weight_layout(w8)
    assert tuple(layout.shape) == (9, 24, 64) and not layout[:, :, 40:].any()
    assert torch.equal(cuda_int8_conv._hwio(layout, 40), w8)


def test_int8_conv_refuses_what_q1_does_not_take(rng):
    x = torch.zeros((1, 8, 8, 24))
    layout = cuda_int8_conv.weight_layout(torch.zeros((3, 3, 24, 16), dtype=torch.int8))
    with pytest.raises(ValueError, match="padding"):
        cuda_int8_conv._check(x, layout, torch.ones(16), 0, None)
    with pytest.raises(ValueError, match="f32 or bf16"):
        cuda_int8_conv._check(x.half(), layout, torch.ones(16), 1, None)
    with pytest.raises(ValueError, match="w_scale"):
        cuda_int8_conv._check(x, layout, torch.ones(8), 1, None)
    assert cuda_int8_conv._check(x, layout, torch.ones(16), 1, torch.zeros(16)) == (9, 16, 24)


# ---------------------------------------------------------------------------
# The protocol: tests/test_quant.py's cases on the port
# ---------------------------------------------------------------------------


def _conv(rng, k, cin, cout, stride=1):
    conv = tnn.Conv2d(cin, cout, kernel_size=k, stride=stride, padding=(k - 1) // 2 if stride == 1 else 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy((rng.standard_normal(conv.weight.shape) * 0.1).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy((rng.standard_normal(cout) * 0.01).astype(np.float32)))
    return conv


def _stack(params, x):
    """Two eligible convs + one ineligible head (cout=4 < 16), NCHW."""
    h = torch.nn.functional.silu(params["c0"](x))
    h = torch.nn.functional.silu(params["c1"](h))
    return params["head"](h)


@pytest.fixture
def stack_setup(rng):
    params = {"c0": _conv(rng, 3, 16, 32), "c1": _conv(rng, 3, 32, 32), "head": _conv(rng, 3, 32, 4)}
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 16)).astype(np.float32))
    return params, x


def _quantized(params, x, scales):
    with torch.no_grad(), quant.apply_scales(scales):
        return _stack(params, x)


def test_calibrate_apply_close(stack_setup):
    params, x = stack_setup
    with torch.no_grad():
        ref = _stack(params, x).numpy()
    scales = quant.run_calibration(_stack, params, x)
    assert len(scales) == 2  # head excluded by the cout >= 16 rule
    out = _quantized(params, x, scales).numpy()
    rel = np.mean(np.abs(out - ref)) / (np.mean(np.abs(ref)) + 1e-12)
    assert rel < 0.04, rel
    assert not np.allclose(out, ref)  # actually took the int8 path


def test_apply_none_is_noop(stack_setup):
    params, x = stack_setup
    with torch.no_grad():
        ref = _stack(params, x)
    assert torch.equal(_quantized(params, x, None), ref)


def test_signature_mismatch_raises(stack_setup):
    params, x = stack_setup
    scales = quant.run_calibration(_stack, params, x)
    with pytest.raises(RuntimeError, match="signature mismatch"):
        _quantized(params, torch.zeros((2, 16, 8, 8)), scales)  # wrong spatial dims


def test_consumption_mismatch_raises(stack_setup):
    params, x = stack_setup
    scales = quant.run_calibration(_stack, params, x)
    with pytest.raises(RuntimeError, match="consumed 1 of 2"):
        with torch.no_grad(), quant.apply_scales(scales):
            params["c0"](x)  # only one of the two calibrated convs


def test_too_many_convs_raises(stack_setup):
    params, x = stack_setup
    scales = quant.run_calibration(_stack, params, x)
    with pytest.raises(RuntimeError, match="more eligible convs"):
        with torch.no_grad(), quant.apply_scales(scales):
            h = params["c0"](x)
            h = params["c1"](torch.nn.functional.silu(h))
            params["c1"](torch.nn.functional.silu(h))


def test_batch_excluded_from_signature(stack_setup):
    params, x = stack_setup
    scales = quant.run_calibration(_stack, params, x)
    assert _quantized(params, torch.cat([x, x]), scales).shape[0] == 4


def test_strided_conv_not_quantized(rng):
    conv = _conv(rng, 4, 16, 32, stride=2)
    assert quant.run_calibration(conv, torch.from_numpy(rng.standard_normal((1, 16, 16, 16)).astype(np.float32))) == []


def test_merge_calibrations(stack_setup):
    params, x = stack_setup
    s1 = quant.run_calibration(_stack, params, x)
    s2 = quant.run_calibration(_stack, params, x * 2.0)
    for m, a, b in zip(quant.Calibration.merge([s1, s2]), s1, s2):
        assert m["scale"] == max(a["scale"], b["scale"])
    with pytest.raises(ValueError, match="conv count"):
        quant.Calibration.merge([s1, s1[:1]])


def test_stack_scales_equal_jax(stack_setup):
    """The same stack in JAX (NHWC, HWIO): the same signatures, and scales
    from the same maxima."""
    params, x = stack_setup
    jparams = {k: {"w": jnp.asarray(c.weight.detach().permute(2, 3, 1, 0).numpy()), "b": jnp.asarray(c.bias.detach().numpy())}
               for k, c in params.items()}

    def jstack(p, a):
        from tha4_tpu.ops import nn as jnn

        h = jax.nn.silu(jnn.conv2d(p["c0"], a))
        h = jax.nn.silu(jnn.conv2d(p["c1"], h))
        return jnn.conv2d(p["head"], h)

    theirs = jquant.run_calibration(jstack, jparams, jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    ours = quant.run_calibration(_stack, params, x)
    assert [e["sig"] for e in ours] == [e["sig"] for e in theirs] == [[[16, 16, 16], [3, 3, 16, 32], 1],
                                                                        [[16, 16, 32], [3, 3, 32, 32], 1]]
    np.testing.assert_allclose([e["scale"] for e in ours], [e["scale"] for e in theirs], rtol=1e-6)


# ---------------------------------------------------------------------------
# The scales file
# ---------------------------------------------------------------------------


def test_scales_file_loads_in_both_packages(tmp_path, stack_setup):
    params, x = stack_setup
    scales = quant.run_calibration(_stack, params, x)
    quant.save_scales(str(tmp_path / "ours.json"), scales)
    assert jquant.load_scales(str(tmp_path / "ours.json")) == scales == quant.load_scales(str(tmp_path / "ours.json"))
    jquant.save_scales(str(tmp_path / "theirs.json"), scales)
    assert quant.load_scales(str(tmp_path / "theirs.json")) == scales
    (tmp_path / "bad.json").write_text('{"format": "other", "scales": []}')
    with pytest.raises(ValueError, match="not a tha4 int8 scales file"):
        quant.load_scales(str(tmp_path / "bad.json"))


# ---------------------------------------------------------------------------
# The teachers: calibration order and the int8 outputs against JAX's
# ---------------------------------------------------------------------------


def _face_cfgs():
    jcfg = jmode_12.FaceTeacherConfig(eyebrow_decomposer=jeyebrow.EyebrowDecomposerConfig(**FACE),
                                      eyebrow_combiner=jeyebrow.EyebrowCombinerConfig(**FACE),
                                      face_morpher=jface_morpher.FaceMorpherConfig(**FACE))
    cfg = mode_12.FaceTeacherConfig(eyebrow_decomposer=eyebrow.EyebrowDecomposerConfig(**FACE),
                                    eyebrow_combiner=eyebrow.EyebrowCombinerConfig(**FACE),
                                    face_morpher=face_morpher.FaceMorpherConfig(**FACE))
    return jcfg, cfg


def _teacher_07_cfgs():
    (jf, f), (ju, u) = _face_cfgs(), _unet_cfgs()
    jcfg = jmode_07.TeacherConfig(eyebrow_decomposer=jf.eyebrow_decomposer, eyebrow_combiner=jf.eyebrow_combiner,
                                  face_morpher=jf.face_morpher, body_morpher=jbody_morpher.BodyMorpherConfig(unet=ju),
                                  upscaler=jupscaler.UpscalerConfig(unet=ju))
    cfg = mode_07.TeacherConfig(eyebrow_decomposer=f.eyebrow_decomposer, eyebrow_combiner=f.eyebrow_combiner,
                                face_morpher=f.face_morpher, body_morpher=body_morpher.BodyMorpherConfig(unet=u),
                                upscaler=upscaler.UpscalerConfig(unet=u))
    return jcfg, cfg


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    pose = rng.uniform(0.0, 1.0, (n, 45)).astype(np.float32)
    pose[:, 35:45] = rng.uniform(-1.0, 1.0, (n, 10))
    return _images(int(rng.integers(1000)), n), pose


@functools.lru_cache(maxsize=None)
def _teachers(mode: str):
    """(JAX compute_outputs, JAX params, port teacher): mode_07 from
    ``random_teacher_07`` (its zero-init layers brought to life) through the
    JAX converters and back through the bridge; mode_12 from JAX's init
    through the bridge."""
    if mode == "07":
        jcfg, cfg = _teacher_07_cfgs()
        jparams = _to_jax_07(random_teacher_07(torch.Generator().manual_seed(41), cfg), jcfg)
        teacher = mode_07.Teacher.from_params(export_torch.teacher_07_state_dicts(jparams), cfg)
        return functools.partial(jmode_07.compute_outputs, jcfg), jparams, teacher, mode_07.compute_outputs
    jcfg, cfg = _face_cfgs()
    jparams = jax.tree.map(np.asarray, jmode_12.init(jax.random.PRNGKey(42), jcfg))
    teacher = mode_12.FaceTeacher.from_params(export_torch.face_teacher_state_dicts(jparams), cfg)
    return functools.partial(jmode_12.compute_outputs, jcfg), jparams, teacher, mode_12.compute_outputs


@functools.lru_cache(maxsize=None)
def _calibrations(mode: str):
    jfn, jparams, teacher, fn = _teachers(mode)
    image, pose = _inputs(2, 43)
    theirs = jquant.run_calibration(jfn, jax.tree.map(jnp.asarray, jparams), jnp.asarray(image), jnp.asarray(pose))
    ours = quant.run_calibration(fn, teacher, torch.from_numpy(image), torch.from_numpy(pose))
    return theirs, ours


@pytest.mark.parametrize("mode", ["07", "12"])
def test_calibration_visits_the_convs_in_jax_order(mode):
    theirs, ours = _calibrations(mode)
    assert len(ours) == len(theirs) > (60 if mode == "07" else 10)
    assert [e["sig"] for e in ours] == [e["sig"] for e in theirs]
    np.testing.assert_allclose([e["scale"] for e in ours], [e["scale"] for e in theirs], rtol=SCALE_RTOL)
    if mode == "07":  # every kind of U-Net call site is among them: 3x3s, the 1x1 skips and the attention's 1x1s
        kinds = {tuple(e["sig"][1][:2]) for e in ours}
        assert kinds == {(3, 3), (1, 1)}


def _psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return np.inf if mse == 0.0 else 10.0 * np.log10(4.0 / mse)


# Port vs JAX int8 outputs on JAX's scales.  Quantization is a step
# function: where the packages' f32 activations (two summation orders, 1e-7
# apart) straddle a rounding boundary of x / scale, one element's int8 value
# differs by one step (1/127 of the scale), and at these widths (32 channels
# over a 16^2 bottleneck) the next layers carry that to a share of the
# output (read: the first flip at mode_12's conv 3, one element of 8192,
# then 2e-3 of the next conv's input).  Each output is held by its PSNR
# against JAX's int8 output, which must beat JAX's own int8-against-f32
# PSNR by INT8_MARGIN_DB (read: 15.6 dB at the least, mode_12; 23.0 mode_07);
# the eyebrow decomposer, the first network, which no flip reaches, is held
# at f32's bar.
INT8_MARGIN_DB = 10.0
FIRST_NET_REL = 1e-5


@pytest.mark.parametrize("mode", ["07", "12"])
def test_int8_teacher_matches_jax_on_jax_scales(mode, tmp_path):
    jfn, jparams, teacher, fn = _teachers(mode)
    theirs_scales, _ = _calibrations(mode)
    jquant.save_scales(str(tmp_path / "scales.json"), theirs_scales)
    scales = quant.load_scales(str(tmp_path / "scales.json"))
    image, pose = _inputs(1, 44)

    def jint8(p, i, q):
        with jquant.apply_scales(theirs_scales):
            return jfn(p, i, q)

    jp = jax.tree.map(jnp.asarray, jparams)
    theirs = [np.asarray(t) for t in jax.jit(jint8)(jp, jnp.asarray(image), jnp.asarray(pose))]
    float32 = [np.asarray(t) for t in jax.jit(jfn)(jp, jnp.asarray(image), jnp.asarray(pose))]
    with torch.no_grad(), quant.apply_scales(scales):
        ours = [t.numpy() for t in fn(teacher, torch.from_numpy(image), torch.from_numpy(pose))]
    assert len(ours) == len(theirs)
    for i, (o, t, f) in enumerate(zip(ours, theirs, float32)):
        if np.array_equal(t, f):  # nothing quantized upstream of it (a zero head)
            np.testing.assert_allclose(o, t, atol=1e-6, err_msg=f"output {i}")
        else:
            assert _psnr(o, t) >= _psnr(t, f) + INT8_MARGIN_DB, (i, _psnr(o, t), _psnr(t, f))
    for o, t in zip(ours[-6:], theirs[-6:]):
        assert np.abs(o - t).max() <= FIRST_NET_REL * np.abs(t).max()


def test_freeze_stores_int8_from_the_f32_weights():
    """A bf16 freeze quantizes each eligible conv from its f32 weight first:
    the stored int8 weight is JAX's ``quantize_weight`` of the f32 params,
    not of the bf16 copy."""
    _, jparams, _, _ = _teachers("12")
    cfg = _face_cfgs()[1]
    teacher = mode_12.FaceTeacher.from_params(export_torch.face_teacher_state_dicts(jparams), cfg).freeze(torch.bfloat16, "cpu")
    conv = teacher.face_morpher.bottleneck_blocks[0][0]  # 32 + 27 pose channels -> 32
    assert conv.weight.dtype == torch.bfloat16 and conv.int8_layout.dtype == torch.int8
    jw8, js = jquant.quantize_weight(jnp.asarray(jparams["face_morpher"]["body"]["bottleneck_blocks"][0]["conv"]["w"]))
    np.testing.assert_array_equal(cuda_int8_conv._hwio(conv.int8_layout, 59).numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(conv.int8_scale.numpy(), np.asarray(js))
    heads = [m for m in teacher.modules() if isinstance(m, nn.Conv2d) and not quant.conv_eligible(m)]
    assert heads and not any(hasattr(m, "int8_layout") for m in heads)


def test_unet_under_a_scope_takes_the_unfused_order(monkeypatch):
    """Under a scope the U-Nets launch no K6 (their eligible convs reach the
    hook, Q1's plain version here), and outside one they run as before."""
    _, _, teacher, fn = _teachers("07")
    k6, q1 = [], []
    real_k6, real_q1 = cuda_conv.fused_affine_conv3_nchw, cuda_int8_conv.int8_conv_plain
    monkeypatch.setattr(cuda_conv, "fused_affine_conv3_nchw", lambda *a, **k: k6.append(1) or real_k6(*a, **k))
    monkeypatch.setattr(cuda_int8_conv, "int8_conv_plain", lambda *a, **k: q1.append(1) or real_q1(*a, **k))
    theirs, _ = _calibrations("07")
    image, pose = _inputs(1, 45)
    with torch.no_grad():
        with quant.apply_scales(theirs):
            fn(teacher, torch.from_numpy(image), torch.from_numpy(pose))
        assert (len(k6), len(q1)) == (0, len(theirs))
        fn(teacher, torch.from_numpy(image), torch.from_numpy(pose))
    assert len(k6) > 0 and len(q1) == len(theirs)


# ---------------------------------------------------------------------------
# The recipes
# ---------------------------------------------------------------------------


def test_face_recipe_step_with_teacher_quant():
    """The distill-step plumbing end to end on the small face teacher, as
    ``tests/test_quant.py::test_face_chunk_with_teacher_quant``: the int8
    labels differ from the float ones, and the step trains."""
    _, _, teacher, _ = _teachers("12")
    image = torch.from_numpy(_images(46, 1))
    poses = torch.rand((2, 45), generator=torch.Generator().manual_seed(47))
    scales = quant.run_calibration(mode_12.compute_outputs, teacher, image.expand(2, -1, -1, -1), poses)
    assert len(scales) > 0
    int8 = recipes.face_teacher_targets(teacher, image, poses, torch.float32, scales)
    plain = recipes.face_teacher_targets(teacher, image, poses, torch.float32)
    assert int8.shape == plain.shape and not torch.equal(int8, plain)
    scfg = siren.SirenFaceMorpherConfig(siren=siren.SirenConfig(in_channels=41, out_channels=4, intermediate_channels=16,
                                                                num_sine_layers=2))
    student = siren.SirenFaceMorpher(scfg, generator=torch.Generator().manual_seed(48))
    step = recipes.make_face_distill_step(teacher, image, torch.ones((128, 128, 4)), torch.float32, scales)
    named = step(student, recipes.make_adam(student), poses, 1e-4)
    assert np.isfinite(float(named["loss"]))
