"""Body-student distillation in the PyTorch port against the JAX package.

``poly_sin`` (K5's plain version) against ``jax.vjp`` of
``pallas_siren.poly_sin``; the body student's training forward
``siren_morpher_train_apply`` against ``siren_morpher_apply_nhwc`` in f32
and in bf16 selective-f32 ("mixed"); one f32 step of the port's body recipe
against ``tha4_tpu.distiller.recipes.make_body_distill_step`` on the same
teacher and student params, character image and poses; the six phases; and
the trainer across a phase boundary with resume, on the CPU.  Sizes are
small: the tiny mode_07 teacher of tests/test_torch_body_teacher.py at the
real geometry, a 3-level student 16/8/8 channels wide, batch 2.
"""

import copy
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_body_teacher import _jax, _teacher_cfgs, _to_jax_07
from tha4_tpu.distiller import recipes as jrecipes
from tha4_tpu.models import siren as jsiren
from tha4_tpu.ops import pallas_siren
from tha4_tpu.poser.modes import mode_07 as jmode_07
from tha4_tpu.training import losses as jlosses
from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, write_distiller_inputs
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.core import imagecodec
from tha4_tpu_torch.distiller import pose_dataset, recipes
from tha4_tpu_torch.distiller.config import DistillerConfig
from tha4_tpu_torch.distiller.pipeline import DistillationJobs
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops import cuda_poly_sin
from tha4_tpu_torch.poser.modes import mode_07
from tha4_tpu_torch.training import checkpoint as ckpt
from tha4_tpu_torch.training.schedules import TrainingPhase, TrainingPhases

torch.set_num_threads(2)

LR = 1e-4
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# bf16 mixed, port against JAX: the same bf16 operands and exact products,
# f32 sums in another order; a stored bf16 activation moves by a step (2^-8
# relative) now and then and the next layers carry it on (measured: 2.3
# steps on the outputs, 5e-3 of the largest gradient).
BF16_OUT_STEPS = 4
BF16_GRAD_ATOL = 2.0**-6


def _student_cfgs(size=512):
    levels = ((size // 4, 16, 3), (size // 2, 8, 3), (size, 8, 3))
    return (jsiren.SirenMorpherConfig(image_size=size, levels=tuple(jsiren.SirenMorpherLevelConfig(*l) for l in levels)),
            siren.SirenMorpherConfig(image_size=size, levels=tuple(siren.SirenMorpherLevelConfig(*l) for l in levels)))


def _student_params(jcfg, seed):
    """JAX student params, the head's grid-change columns scaled to flows of
    a few pixels (a He-init head moves samples far past the border, where
    the warp's gradient is zero)."""
    params = jax.tree.map(np.array, jsiren.siren_morpher_init(jax.random.PRNGKey(seed), jcfg))
    params["last_linear"]["w"][:, 0:2] *= 0.05
    params["last_linear"]["b"][0:2] *= 0.05
    return params


def _port_layout(params):
    """JAX student params (or grads) -> the port's state-dict layout, numpy."""
    return {k: v.numpy() for k, v in export_torch.siren_morpher_state_dict(jax.tree.map(np.asarray, params)).items()}


@pytest.mark.parametrize("a_dtype,out_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
def test_poly_sin_matches_jax_vjp(a_dtype, out_dtype):
    """Bit-equal forward and backward, including the fused f32 -> bf16 form
    of JAX's ``poly_sin(a).astype(bf16)``; the residual is ``a`` alone."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((3, 17, 33)) * 40.0).astype(np.float32)  # omega * pre reaches +-150
    g = rng.standard_normal(a.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: pallas_siren.poly_sin(x).astype(JDTYPE[out_dtype]), jnp.asarray(a).astype(JDTYPE[a_dtype]))
    (dref,) = vjp(jnp.asarray(g).astype(JDTYPE[out_dtype]))
    at = torch.from_numpy(a).to(a_dtype).requires_grad_()
    out = cuda_poly_sin.poly_sin(at, out_dtype)
    assert out.dtype == out_dtype
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == a_dtype and torch.equal(saved[0], at)
    out.backward(torch.from_numpy(g).to(out_dtype))
    assert at.grad.dtype == a_dtype
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(at.grad.float().numpy(), np.asarray(dref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype,mixed", [(torch.float32, False), (torch.bfloat16, True)])
def test_student_train_apply_matches_jax(rng, dtype, mixed):
    """The five outputs and the gradients of sum(out * cotangent) in every
    parameter.  f32: 1e-5, a tenth of the omega = 30 bar of
    tests/test_pallas_siren.py:58-93 (measured 2.4e-6 out, 2.8e-6 scaled
    gradient); bf16 mixed: the bars above.  At 128^2."""
    jcfg, cfg = _student_cfgs(128)
    params = _student_params(jcfg, 3)
    student = siren.SirenMorpher(cfg)
    student.load_state_dict(export_torch.siren_morpher_state_dict(params))
    n = 2
    image = np.array(jax.image.resize(jnp.asarray(rng.uniform(-1, 1, (n, 8, 8, 4)).astype(np.float32)), (n, 128, 128, 4), "bilinear"))
    pose = rng.uniform(0, 1, (n, 45)).astype(np.float32)
    cots = [rng.standard_normal((n, 128, 128, c)).astype(np.float32) for c in (4, 1, 4, 4, 2)]
    jd = JDTYPE[dtype]

    @jax.jit
    def loss(p):
        outs = jsiren.siren_morpher_apply_nhwc(jcfg, p, jnp.asarray(image).astype(jd), jnp.asarray(pose).astype(jd), mixed=mixed)
        return sum((o.astype(jnp.float32) * c).sum() for o, c in zip(outs, cots)), outs

    (_, ref), jgrads = jax.value_and_grad(loss, has_aux=True)(_jax(params))
    outs = siren.siren_morpher_train_apply(student, torch.from_numpy(image).to(dtype), torch.from_numpy(pose).to(dtype), dtype, mixed)
    sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    for i, (o, r) in enumerate(zip(outs, ref)):
        r = np.asarray(r.astype(jnp.float32))
        assert o.shape == r.shape, i
        bar = 1e-5 if dtype == torch.float32 else BF16_OUT_STEPS * 2.0**-8 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(o.detach().float().numpy(), r, atol=bar, err_msg=f"output {i}")
    grads = _port_layout(jgrads)
    for name, p in student.named_parameters():
        assert p.grad.dtype == torch.float32, name
        r = grads[name]
        scale = float(np.abs(r).max())
        assert scale > 0.0, name
        np.testing.assert_allclose(p.grad.numpy() / scale, r / scale, atol=1e-5 if dtype == torch.float32 else BF16_GRAD_ATOL, err_msg=name)
    # The head's grid-change rows learn through the warp (K3's gradient).
    assert student.last_linear.weight.grad[0:2].abs().max() > 0


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return DistillerConfig.load(write_distiller_inputs(str(tmp_path_factory.mktemp("distill")), seed=23, batch_size=2))


@pytest.fixture(scope="module")
def body_step(inputs):
    """Both packages' f32 body step from the same params and batch, JAX's
    labels, and JAX's gradients of the loss on those labels."""
    jtcfg, tcfg = _teacher_cfgs()
    tparams = random_teacher_07(torch.Generator().manual_seed(41), tcfg)
    jt = _jax(_to_jax_07(tparams, jtcfg))
    jscfg, scfg = _student_cfgs()
    sparams = _student_params(jscfg, 5)
    js = _jax(sparams)
    image = imagecodec.load_image_hwc(inputs.character_image_file_name)[None]
    poses = pose_dataset.sample_poses(torch.Generator().manual_seed(8), 2).numpy()
    weights = jrecipes.default_body_phases().loss_weights(jrecipes.BODY_LOSS_TERMS, 650_000)
    wvec = jnp.asarray([weights[t] for t in jrecipes.BODY_LOSS_TERMS], jnp.float32)

    step = jrecipes.make_body_distill_step(jtcfg, jscfg, jnp.float32)
    jparams, _, jnamed = step(jax.tree.map(jnp.copy, js), jrecipes.adam_init(js), jt, jnp.asarray(image), jnp.asarray(poses), LR, wvec)
    t = jax.jit(functools.partial(jmode_07.compute_outputs, jtcfg))(jt, jnp.broadcast_to(jnp.asarray(image), (2, 512, 512, 4)), jnp.asarray(poses))
    targets = [np.asarray(t[i]) for i in (0, 2, 3, jmode_07.INDEX_FACE_MORPHED_FULL)]

    @jax.jit
    def loss(params):
        outs = jsiren.siren_morpher_apply_nhwc(jscfg, params, jnp.asarray(targets[3]), jnp.asarray(poses))
        return (wvec[0] * jlosses.l1(targets[0], outs[0]) + wvec[1] * jlosses.l1(targets[1], outs[3])
                + wvec[2] * jlosses.l1(targets[2], outs[4]) + wvec[3] * jlosses.l1(targets[0], outs[2]))

    jgrads = jax.grad(loss)(js)
    teacher = mode_07.Teacher.from_params(tparams, tcfg).freeze(torch.float32, "cpu")
    student = siren.SirenMorpher(scfg)
    student.load_state_dict(export_torch.siren_morpher_state_dict(sparams))
    port = dict(image=torch.from_numpy(image), poses=torch.from_numpy(poses), teacher=teacher, student=student, weights=weights)
    return dict(jax=dict(params=jparams, named=jnamed, grads=jgrads, targets=targets), port=port)


def test_body_step_losses_match_jax_f32(body_step):
    """The port's whole step (its own teacher labels) gives JAX's four
    weighted terms and their sum: means over 2M elements of |gt - pred|,
    where the teachers differ by ~1e-5 (tests/test_torch_body_teacher.py)."""
    port, ref = body_step["port"], body_step["jax"]
    student = copy.deepcopy(port["student"])
    step = recipes.make_body_distill_step(port["teacher"], port["image"], torch.float32)
    named = step(student, recipes.make_adam(student), port["poses"], LR, port["weights"])
    assert named.keys() == set(recipes.BODY_LOSS_TERMS) | {"loss"}
    for name in named:
        np.testing.assert_allclose(float(named[name]), float(ref["named"][name]), rtol=1e-5, err_msg=name)


def test_body_update_gradients_and_adam_match_jax_f32(body_step):
    """On JAX's teacher labels, so that both take the same L1 subgradient
    signs: gradients within 1e-4 of the largest, the omega = 30 bar of
    tests/test_pallas_siren.py:58-65 (measured 2e-6 to 7e-6 in the sine
    layers; 2.8e-5 in the head, whose gradient sums 2 x 512^2 products in
    another order), the head's grid-change rows nonzero; after Adam's first step equal to f32 rounding
    where |g| is above 1e-4 of the largest, and never more than 2 lr apart."""
    port, ref = body_step["port"], body_step["jax"]
    student = copy.deepcopy(port["student"])
    optimizer = recipes.make_adam(student)
    targets = tuple(torch.from_numpy(t.copy()) for t in ref["targets"])
    optimizer.zero_grad(set_to_none=True)
    named = recipes.adam_step(optimizer, *recipes.body_loss(student, targets, port["poses"], port["weights"], torch.float32, False), LR)
    np.testing.assert_allclose(float(named["loss"]), float(ref["named"]["loss"]), rtol=1e-5)
    grads, after = _port_layout(ref["grads"]), _port_layout(ref["params"])
    for name, p in student.named_parameters():
        g, r = p.grad.numpy(), grads[name]
        scale = float(np.abs(r).max())
        assert scale > 0.0, name
        np.testing.assert_allclose(g / scale, r / scale, atol=1e-4, err_msg=name)
        p_new = p.detach().numpy()
        assert np.abs(p_new - after[name]).max() <= 2 * LR + 1e-7, name
        firm = np.abs(r) > 1e-4 * scale
        np.testing.assert_allclose(p_new[firm], after[name][firm], rtol=0, atol=1e-7, err_msg=name)
    assert np.abs(grads["last_linear.weight"][0:2]).min() > 0.0


def test_body_phases_and_terms_match_jax():
    ours, ref = recipes.default_body_phases(), jrecipes.default_body_phases()
    assert recipes.BODY_LOSS_TERMS == jrecipes.BODY_LOSS_TERMS
    assert recipes.BODY_MORPHER_TOTAL_EXAMPLES == jrecipes.BODY_MORPHER_TOTAL_EXAMPLES == ours.total_examples
    assert len(ours.phases) == len(ref.phases) == 6
    for a, b in zip(ours.phases, ref.phases):
        assert (a.num_examples_upper_bound, a.learning_rate, dict(a.loss_weights)) == (b.num_examples_upper_bound, b.learning_rate, dict(b.loss_weights))
    for p in ref.phases:
        for e in [p.num_examples_upper_bound - 8, p.num_examples_upper_bound, p.num_examples_upper_bound + 8]:
            assert ours.learning_rate(e) == ref.learning_rate(e), e
            assert ours.loss_weights(recipes.BODY_LOSS_TERMS, e) == ref.loss_weights(jrecipes.BODY_LOSS_TERMS, e), e


# Two phases: the lr and every weight change at 4 examples.
TRAIN_PHASES = TrainingPhases([
    TrainingPhase(4, 1e-4, {"full_blended": 0.25, "full_warped": 0.25, "full_grid_change": 0.5, "full_color_change": 2.0}),
    TrainingPhase(8, 3e-5, {"full_blended": 10.0, "full_warped": 1.0, "full_grid_change": 1.0, "full_color_change": 1.0}),
])


def _jobs(inputs, prefix):
    os.makedirs(prefix, exist_ok=True)
    tcfg = _teacher_cfgs()[1]
    jobs = DistillationJobs(
        dataclasses.replace(inputs, prefix=prefix), teacher_params_07=random_teacher_07(torch.Generator().manual_seed(9), tcfg),
        teacher_cfg_07=tcfg, compute_dtype=torch.float32, device="cpu",
        body_total_examples=8, examples_per_checkpoint=4, examples_per_snapshot=4, student_mixed=False,
    )
    jobs.body_student_cfg = _student_cfgs()[1]
    return jobs


def test_body_trainer_crosses_a_phase_and_resumes_bitwise(inputs, tmp_path):
    """8 examples at batch 2, checkpoints every 4, a phase change at 4: the
    logged lr and weights follow the phases, and a run stopped at 4 and
    resumed by a fresh trainer, which crosses the phase change, ends
    bit-equal to an uninterrupted one."""
    whole = _jobs(inputs, str(tmp_path / "whole")).make_body_trainer(TRAIN_PHASES)
    whole.cfg.log_every_seconds = 0.0
    done = whole.train()
    assert done["examples_seen"] == 8
    prefix = whole.cfg.prefix
    assert prefix.endswith("/body_morpher")
    for i in range(3):
        assert ckpt.read_examples_seen(ckpt.checkpoint_dir(prefix, i)) == 4 * i
    rows = [json.loads(line) for line in open(os.path.join(prefix, "log", "scalars.jsonl"))]
    assert [r["lr"] for r in rows] == [1e-4] * 2 + [3e-5] * 2
    assert all(np.isfinite(r[k]) for r in rows for k in (*recipes.BODY_LOSS_TERMS, "loss"))
    # The blended term's weight rises 40x at the phase change.
    assert rows[2]["full_blended"] > 10 * rows[1]["full_blended"]

    first = _jobs(inputs, str(tmp_path / "resumed")).make_body_trainer(TRAIN_PHASES)
    assert first.train(4)["examples_seen"] == 4
    resumed = _jobs(inputs, str(tmp_path / "resumed")).make_body_trainer(TRAIN_PHASES).train()
    assert resumed["examples_seen"] == 8
    for (name, a), b in zip(done["module"].state_dict().items(), resumed["module"].state_dict().values()):
        assert torch.equal(a, b), name


def test_body_pipeline_takes_mode_12_from_mode_07_and_refuses_samples(inputs, tmp_path):
    jobs = _jobs(inputs, str(tmp_path / "p"))
    assert jobs.student_mixed is False and DistillationJobs(inputs).student_mixed is True
    assert all(jobs.teacher_params_12()[k] is jobs.teacher_params_07()[k] for k in mode_07.NETWORK_KEYS[:3])
    assert set(jobs.teacher_params_12()) == set(mode_07.NETWORK_KEYS[:3])
    assert jobs.config.body_morpher_prefix() == jobs.config.prefix + "/body_morpher"
    assert jobs.make_body_trainer().sample_output_fn is None  # the inputs' cadence is null
    # Sample outputs are ported: a cadence gives the trainer its sample writer.
    jobs.config = dataclasses.replace(jobs.config, body_morpher_num_training_examples_per_sample_output=10_000)
    trainer = jobs.make_body_trainer()
    assert trainer.cfg.examples_per_sample_output == 10_000 and trainer.sample_output_fn == jobs.write_body_samples


def test_constants_first_made_under_inference_mode_still_train(rng):
    """The cached identity grid and resize tables outlive the block that
    first asks for them: a frame rendered under ``torch.inference_mode``
    before training must not leave inference tensors that the training
    step's backward would have to save."""
    from tha4_tpu_torch.ops import cuda_resize, warp

    warp._identity_grid.cache_clear()
    cuda_resize.taps.cache_clear()
    _, cfg = _student_cfgs(64)
    student = siren.SirenMorpher(cfg)
    image = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 4)).astype(np.float32))
    pose = torch.from_numpy(rng.uniform(0, 1, (1, 45)).astype(np.float32))
    with torch.inference_mode():
        siren.siren_morpher_train_apply(student, image, pose, torch.float32)
    outs = siren.siren_morpher_train_apply(student, image, pose, torch.float32)
    sum(o.sum() for o in outs).backward()
    assert all(p.grad is not None for p in student.parameters())
