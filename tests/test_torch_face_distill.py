"""Face-student distillation in the PyTorch port against the JAX package.

One f32 step of the port's recipe is held against
``tha4_tpu.distiller.recipes.make_face_distill_step`` on the same student
and teacher params (JAX's, bridged), character image, mask and poses; the
trainer's checkpoint layout and resume are checked on the CPU.  Sizes are
small: the small teacher of tests/test_distill.py:24-38 at the real
geometry, a 41->32x3->4 student at 128^2, batch 2.  The character, mask
and config are the port's seeded synthetic inputs.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_teacher import _jax_teacher
from tha4_tpu.core import imagecodec as jimagecodec
from tha4_tpu.distiller import recipes as jrecipes
from tha4_tpu.distiller import pose_dataset as jpose_dataset
from tha4_tpu.distiller.config import DistillerConfig as JDistillerConfig
from tha4_tpu.models import siren as jsiren
from tha4_tpu.poser.modes import mode_12 as jmode_12
from tha4_tpu.training import losses as jlosses
from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
from tha4_tpu_torch.convert import export_torch
from tha4_tpu_torch.core import imagecodec
from tha4_tpu_torch.distiller import pose_dataset, recipes
from tha4_tpu_torch.distiller.config import DistillerConfig
from tha4_tpu_torch.distiller.pipeline import DistillationJobs
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.poser.modes import mode_12
from tha4_tpu_torch.training import checkpoint as ckpt
from tha4_tpu_torch.training import schedules

torch.set_num_threads(2)

LR = 1e-4


def _students():
    jcfg = jsiren.SirenFaceMorpherConfig(siren=jsiren.SirenConfig(41, 4, 32, 3))
    cfg = siren.SirenFaceMorpherConfig(siren=siren.SirenConfig(41, 4, 32, 3))
    return jcfg, cfg


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return DistillerConfig.load(write_distiller_inputs(str(tmp_path_factory.mktemp("distill")), seed=21, batch_size=2))


@pytest.fixture(scope="module")
def one_step(inputs):
    """Both packages' f32 step from the same params and batch, and JAX's
    gradients of the same loss."""
    jtcfg, tparams, tcfg = _jax_teacher(seed=13)
    jscfg, scfg = _students()
    sparams = jax.tree.map(np.asarray, jsiren.siren_face_morpher_init(jax.random.PRNGKey(5), jscfg))
    image = jimagecodec.load_image_hwc(inputs.character_image_file_name)[None]
    mask = jrecipes.load_face_mask_crop(inputs.face_mask_image_file_name)
    poses = pose_dataset.sample_poses(torch.Generator().manual_seed(8), 2).numpy()
    jt, js = jax.tree.map(jnp.asarray, tparams), jax.tree.map(jnp.asarray, sparams)

    step = jrecipes.make_face_distill_step(jtcfg, jscfg, jnp.float32)
    jparams, _, jnamed = step(jax.tree.map(jnp.copy, js), jrecipes.adam_init(js), jt, jnp.asarray(image), jnp.asarray(mask), jnp.asarray(poses), LR)
    face = jmode_12.compute_outputs(jtcfg, jt, jnp.broadcast_to(jnp.asarray(image), (2, 512, 512, 4)), jnp.asarray(poses))[0]
    target = np.asarray(face[:, 48:176, 32:160, :])

    def loss(params):
        pred = jsiren.siren_face_morpher_apply(jscfg, params, jnp.asarray(poses[:, :39]))
        return jlosses.l1(target, pred) + jlosses.masked_l1(target, pred, jnp.asarray(mask)[None], 20.0)

    jgrads = jax.grad(loss)(js)

    teacher = mode_12.FaceTeacher.from_params(export_torch.face_teacher_state_dicts(tparams), tcfg).freeze(torch.float32, "cpu")
    student = siren.SirenFaceMorpher(scfg)
    student.load_state_dict(export_torch.siren_face_morpher_state_dict(sparams))
    port = dict(image=torch.from_numpy(image), mask=torch.from_numpy(mask), poses=torch.from_numpy(poses), teacher=teacher, student=student)
    return dict(jax=dict(params=jparams, named=jnamed, grads=jgrads, target=target, image=image, mask=mask), port=port)


def _port_layout(params):
    """JAX student params (or grads) -> the port's state-dict layout, numpy."""
    return {k: v.numpy() for k, v in export_torch.siren_face_morpher_state_dict(jax.tree.map(np.asarray, params)).items()}


def test_synthetic_inputs_load_the_same_in_both_packages(inputs, one_step):
    port, ref = one_step["port"], one_step["jax"]
    np.testing.assert_array_equal(port["image"].numpy(), ref["image"])
    np.testing.assert_array_equal(recipes.load_face_mask_crop(inputs.face_mask_image_file_name), ref["mask"])
    assert 0.02 < ref["mask"].mean() < 0.5  # the eyes and the mouth cover part of the face square
    # The JAX package reads the port's config yaml as its own.
    assert dataclasses.asdict(JDistillerConfig.load(inputs.prefix + "/../config.yaml")) == dataclasses.asdict(inputs)


def test_face_step_losses_match_jax_f32(one_step):
    """The port's whole step (its own teacher labels) gives JAX's named
    losses: means over 131k elements of |gt - pred|, where the teachers
    differ by ~1e-5 (tests/test_torch_teacher.py) and the students by less
    (measured 7e-8 relative)."""
    port, ref = one_step["port"], one_step["jax"]
    student = copy.deepcopy(port["student"])
    optimizer = recipes.make_adam(student)
    step = recipes.make_face_distill_step(port["teacher"], port["image"], port["mask"], torch.float32)
    named = step(student, optimizer, port["poses"], LR)
    assert named.keys() == {"full", "eye_mouth", "loss"}
    for name in named:
        np.testing.assert_allclose(float(named[name]), float(ref["named"][name]), rtol=1e-6, err_msg=name)


def test_face_update_gradients_and_adam_match_jax_f32(one_step):
    """On JAX's teacher labels, so that both take the same L1 subgradient
    signs: gradients scaled by their largest magnitude within 1e-5, a tenth
    of the omega = 30 bar of tests/test_pallas_siren.py:58-65, since the
    SIREN init keeps each layer's gain near 1 (measured 9e-7; K4's fast_cos
    and JAX's exact polynomial derivative are ~1e-6 apart).  After Adam's first
    step, p - lr * g / (|g| + eps): equal to f32 rounding wherever |g| is
    above the gradients' noise floor (1e-4 of the largest), and never more
    than one step, 2 lr, apart."""
    port, ref = one_step["port"], one_step["jax"]
    student = copy.deepcopy(port["student"])
    optimizer = recipes.make_adam(student)
    named = recipes.student_update(
        student, optimizer, torch.from_numpy(ref["target"].copy()), port["mask"], port["poses"], LR, torch.float32
    )
    np.testing.assert_allclose(float(named["loss"]), float(ref["named"]["loss"]), rtol=1e-6)
    grads = _port_layout(ref["grads"])
    after = _port_layout(ref["params"])
    for name, p in student.named_parameters():
        g, r = p.grad.numpy(), grads[name]
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g / scale, r / scale, atol=1e-5, err_msg=name)
        p_new = p.detach().numpy()
        assert np.abs(p_new - after[name]).max() <= 2 * LR + 1e-7, name
        firm = np.abs(r) > 1e-4 * scale
        np.testing.assert_allclose(p_new[firm], after[name][firm], rtol=0, atol=1e-7, err_msg=name)


def test_lr_ladder_matches_jax():
    ours, ref = recipes.default_face_lr_fn(), jrecipes.default_face_lr_fn()
    for e in [0, 8, 199_999, 200_000, 499_992, 500_000, 799_999, 800_000, 1_000_000]:
        assert ours(e) == ref(e), e
    assert ours(0) == 1e-4 and ours(800_000) == 1e-4 / 30


def test_training_phases_match_jax():
    ref = jrecipes.default_body_phases()
    ours = schedules.TrainingPhases(
        [schedules.TrainingPhase(p.num_examples_upper_bound, p.learning_rate, dict(p.loss_weights)) for p in ref.phases]
    )
    terms = sorted({t for p in ref.phases for t in p.loss_weights} | {"absent"})
    assert ours.total_examples == ref.total_examples
    for p in ref.phases:
        for e in [p.num_examples_upper_bound - 1, p.num_examples_upper_bound, p.num_examples_upper_bound + 8]:
            assert ours.learning_rate(e) == ref.learning_rate(e), e
            assert ours.loss_weights(terms, e) == ref.loss_weights(terms, e), e
    with pytest.raises(ValueError, match="increase"):
        schedules.TrainingPhases([schedules.TrainingPhase(10, 1e-4), schedules.TrainingPhase(10, 1e-5)])


def test_pose_sampler_ranges_and_sparsity():
    """tests/test_distill.py:174-225, for the port's sampler: spans by name
    at the documented indices, ranges, one eyebrow pair / eye pair / mouth
    shape per pose, every mouth shape reached; and a batch is a function of
    its generator."""
    assert [s[:2] for s in pose_dataset._SPARSE_GROUPS] == [(0, 12), (12, 24), (26, 32)]
    assert [s[:2] for s in pose_dataset._SPARSE_GROUPS] == [jpose_dataset._EYEBROW, jpose_dataset._EYE, jpose_dataset._MOUTH_SHAPES]
    np.testing.assert_array_equal(pose_dataset._LOWS.numpy(), jpose_dataset._LOWS)
    np.testing.assert_array_equal(pose_dataset._HIGHS.numpy(), jpose_dataset._HIGHS)
    poses = pose_dataset.sample_poses(torch.Generator().manual_seed(7), 512).numpy()
    assert poses.shape == (512, 45) and poses.dtype == np.float32
    assert poses[:, :35].min() >= 0.0 and poses.max() <= 1.0 and poses[:, 35:42].min() >= -1.0
    assert ((poses[:, 26:32] > 0.0).sum(axis=1)).max() <= 1
    for start, stop in ((0, 12), (12, 24)):
        pairs = (np.abs(poses[:, start:stop].reshape(len(poses), -1, 2)).sum(axis=2) > 0.0).sum(axis=1)
        assert pairs.max() <= 1
    assert ((poses[:, 26:32] > 0.2).any(axis=0)).all()
    again = pose_dataset.sample_poses(torch.Generator().manual_seed(7), 512).numpy()
    np.testing.assert_array_equal(poses, again)


def _jobs(inputs, prefix, **kwargs):
    config = dataclasses.replace(inputs, prefix=prefix)
    os.makedirs(prefix, exist_ok=True)
    tcfg = _jax_teacher()[2]
    jobs = DistillationJobs(
        config, teacher_params_12=mode_12.init(torch.Generator().manual_seed(9), tcfg), teacher_cfg_12=tcfg,
        compute_dtype=torch.float32, device="cpu", **kwargs,
    )
    jobs.face_student_cfg = _students()[1]
    return jobs


def test_trainer_checkpoints_and_resume_bitwise(inputs, tmp_path):
    """24 examples at batch 2, checkpoints every 8, snapshots every 4: the
    layout of tha4_tpu/training/checkpoint.py; a run stopped at 12 and
    resumed by a fresh trainer ends bit-equal to an uninterrupted one."""
    kw = dict(face_total_examples=24, examples_per_checkpoint=8, examples_per_snapshot=4)
    whole = _jobs(inputs, str(tmp_path / "whole"), **kw).make_face_trainer()
    whole.cfg.log_every_seconds = 0.0
    done = whole.train()
    assert done["examples_seen"] == 24
    prefix = whole.cfg.prefix
    for i in range(4):
        d = ckpt.checkpoint_dir(prefix, i)
        assert ckpt.can_load(d, ["module"]), d
        assert ckpt.read_examples_seen(d) == 8 * i
        assert sorted(os.listdir(d)) == ["examples_seen_so_far.txt", "module_module.npz", "optimizer_module.npz", "rng_state_00000000.npz"]
    assert ckpt.read_examples_seen(ckpt.snapshot_dir(prefix)) == 24
    assert not any(name.endswith(".tmp") for name in os.listdir(os.path.join(prefix, "checkpoint")))
    rows = [json.loads(line) for line in open(os.path.join(prefix, "log", "scalars.jsonl"))]
    assert len(rows) == 12 and all(np.isfinite(r["loss"]) and r["lr"] == 1e-4 for r in rows)

    first = _jobs(inputs, str(tmp_path / "resumed"), **kw).make_face_trainer()
    assert first.train(12)["examples_seen"] == 12
    resumed = _jobs(inputs, str(tmp_path / "resumed"), **kw).make_face_trainer().train()
    assert resumed["examples_seen"] == 24
    for (name, a), b in zip(done["module"].state_dict().items(), resumed["module"].state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = done["optimizer"].state_dict()["state"], resumed["optimizer"].state_dict()["state"]
    assert sa.keys() == sb.keys() and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    assert done["key"] == resumed["key"]


def test_pipeline_refuses_what_is_not_ported(inputs, tmp_path, caplog):
    """``num_gpus`` follows the JAX package's rule: in a process that was
    not launched as one of its ranks it warns and trains as one process, and
    a batch that does not divide over it is refused (the run in full is
    tests/test_torch_parallel.py's).  Sample outputs are ported: a config's
    cadence (10 000 by default) gives the trainer its sample writer, and
    null gives none."""
    jobs = _jobs(inputs, str(tmp_path / "samples"))
    jobs.config = dataclasses.replace(jobs.config, face_morpher_num_training_examples_per_sample_output=10_000)
    trainer = jobs.make_face_trainer()
    assert trainer.cfg.examples_per_sample_output == 10_000 and trainer.sample_output_fn == jobs.write_face_samples
    assert _jobs(inputs, str(tmp_path / "off")).make_face_trainer().sample_output_fn is None
    with caplog.at_level("WARNING"):
        two = DistillationJobs(dataclasses.replace(inputs, num_gpus=2), device="cpu")
    assert two.config.num_gpus == 2 and "config requests 2 GPUs" in caplog.text
    for name in ("face_morpher_batch_size", "body_morpher_batch_size"):
        with pytest.raises(ValueError, match="does not divide over num_gpus = 2"):
            DistillationJobs(dataclasses.replace(inputs, num_gpus=2, **{name: 3}), device="cpu")
