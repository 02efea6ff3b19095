"""Distillation to a character model in the PyTorch port: the trainer's
sample cadence against the JAX trainer's, the task DAG end to end on tiny
teachers and students, and a full-width export posed by the JAX package.

The DAG runs ``DistillationJobs.define_tasks`` through the port's
``Workspace`` on the small teachers of tests/test_torch_{teacher,
body_teacher}.py and the small students of tests/test_torch_{face,body}_
distill.py at the real geometry, batch 2, 8 examples a student and a
checkpoint every 4, on the CPU (the kernels' plain versions).
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
import yaml

from tests.test_torch_body_distill import _student_cfgs
from tests.test_torch_body_teacher import _teacher_cfgs
from tests.test_torch_face_distill import _students
from tests.test_torch_mode14 import F32_ATOL, OUTPUT_NAMES, _random_pose
from tha4_tpu.charmodel import CharacterModel as JCharacterModel
from tha4_tpu.training import trainer as jtrainer
from tha4_tpu_torch.charmodel import CharacterModel
from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, write_distiller_inputs
from tha4_tpu_torch.convert.export_torch import save_module_pt
from tha4_tpu_torch.core import imagecodec
from tha4_tpu_torch.distiller import sample_output
from tha4_tpu_torch.distiller.config import DistillerConfig
from tha4_tpu_torch.distiller.pipeline import DistillationJobs, run_config
from tha4_tpu_torch.models import siren
from tha4_tpu_torch.ops import cuda_resize, warp
from tha4_tpu_torch.poser.modes import mode_12
from tha4_tpu_torch.tasks.workspace import Workspace
from tha4_tpu_torch.training import checkpoint as ckpt
from tha4_tpu_torch.training import tensorboard
from tha4_tpu_torch.training import trainer
from tha4_tpu_torch.utils import precision

torch.set_num_threads(2)

# -- the cadence ------------------------------------------------------------

CADENCE, BATCH, SNAPSHOT = 16, 4, 12
BOUNDARIES = [24, 48, 72]


def _port_trainer(prefix, seen):
    def group(module, optimizer, gens, lrs, weights):
        return {"loss": torch.tensor(float(torch.rand((), generator=gens[-1])))}

    return trainer.Trainer(
        trainer.TrainerConfig(prefix=prefix, checkpoint_examples=BOUNDARIES, total_batch_size=BATCH,
                              examples_per_snapshot=SNAPSHOT, examples_per_sample_output=CADENCE, log_every_seconds=0.0),
        init_module=lambda gen: torch.nn.Linear(2, 2),
        make_optimizer=lambda m: torch.optim.Adam(m.parameters()),
        train_group=group,
        lr_fn=lambda e: 1e-4,
        sample_output_fn=lambda module, examples_seen: seen.append(examples_seen),
    )


def _jax_trainer(prefix, seen):
    return jtrainer.Trainer(
        jtrainer.TrainerConfig(prefix=prefix, checkpoint_examples=BOUNDARIES, total_batch_size=BATCH,
                               examples_per_snapshot=SNAPSHOT, examples_per_sample_output=CADENCE, log_every_seconds=0.0),
        init_params=lambda key: {"w": jnp.zeros(2)},
        init_opt_state=lambda params: {"m": jnp.zeros(2)},
        train_step=lambda params, opt, batch, lr, weights, key: (params, opt, {"loss": jnp.float32(0.5)}),
        make_batch=lambda key, n: jnp.zeros(n),
        lr_fn=lambda e: 1e-4,
        sample_output_fn=lambda params, examples_seen: seen.append(examples_seen),
    )


@pytest.mark.parametrize("first_target", [None, 36, 48, 24])
def test_sample_cadence_matches_the_jax_trainer(tmp_path, first_target):
    """The same ``examples_seen`` at every sample call, fresh and on a
    resume: from a snapshot in mid-cadence (36), at a multiple of the
    cadence (48) and at a checkpoint (24).  Both write a TensorBoard file
    with as many events as the JSONL has rows, with the same tags."""
    calls = {}
    for name, make in (("port", _port_trainer), ("jax", _jax_trainer)):
        prefix = str(tmp_path / name)
        seen = []
        if first_target is not None:
            make(prefix, seen).train(first_target)
        seen.append("resume")
        make(prefix, seen).train()
        calls[name] = seen
        log = os.path.join(prefix, "log")
        rows = sum(1 for _ in open(os.path.join(log, "scalars.jsonl")))
        events = [e for f in sorted(os.listdir(log)) if f.startswith("events.out.tfevents.")
                  for e in tensorboard.read_events(os.path.join(log, f)) if e["scalars"]]
        assert len(events) == rows == 72 // BATCH
        assert set(events[0]["scalars"]) == {"training_module_loss_loss", "learning_rate"}
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == (0 if first_target is not None else "resume")
    if first_target is None:
        assert calls["port"] == ["resume", 0, 16, 32, 48, 64]


@pytest.mark.parametrize("cadence,writer", [(CADENCE, None), (None, lambda module, examples_seen: None)])
def test_a_sample_cadence_and_its_writer_come_together(tmp_path, cadence, writer):
    """Sampling has one switch, the writer: a cadence without one, or one
    without a cadence, is refused rather than ignored."""
    cfg = trainer.TrainerConfig(prefix=str(tmp_path), checkpoint_examples=BOUNDARIES, examples_per_sample_output=cadence)
    with pytest.raises(ValueError, match="together"):
        trainer.Trainer(cfg, init_module=lambda gen: torch.nn.Linear(2, 2), make_optimizer=lambda m: None,
                        train_group=None, lr_fn=lambda e: 1e-4, sample_output_fn=writer)


# -- the DAG end to end -----------------------------------------------------

TOTAL, PER_CHECKPOINT = 8, 4


def _tiny_jobs(config, samples=True):
    tcfg = _teacher_cfgs()[1]
    tcfg12 = mode_12.FaceTeacherConfig(eyebrow_decomposer=tcfg.eyebrow_decomposer, eyebrow_combiner=tcfg.eyebrow_combiner,
                                       face_morpher=tcfg.face_morpher)
    if not samples:
        config = dataclasses.replace(config, face_morpher_num_training_examples_per_sample_output=None,
                                     body_morpher_num_training_examples_per_sample_output=None)
    jobs = DistillationJobs(
        config, teacher_params_07=random_teacher_07(torch.Generator().manual_seed(71), tcfg), teacher_cfg_07=tcfg,
        teacher_cfg_12=tcfg12, compute_dtype=torch.float32, device="cpu", face_total_examples=TOTAL,
        body_total_examples=TOTAL, examples_per_checkpoint=PER_CHECKPOINT, examples_per_snapshot=2,
    )
    jobs.face_student_cfg = _students()[1]
    jobs.body_student_cfg = _student_cfgs()[1]
    return jobs


def _run(config, target, samples=True):
    jobs = _tiny_jobs(config, samples)
    workspace = Workspace()
    jobs.define_tasks(workspace)
    workspace.run({"all": f"{config.prefix}/all", "face": f"{config.face_morpher_prefix()}/train"}[target])
    return jobs


def _last_npz(prefix):
    return os.path.join(ckpt.checkpoint_dir(prefix, TOTAL // PER_CHECKPOINT), "module_module.npz")


def _outputs(config):
    """Every file the DAG writes that a rerun must leave alone, with its mtime."""
    out = {}
    for root, _, files in os.walk(config.prefix):
        for f in files:
            path = os.path.join(root, f)
            out[path] = os.stat(path).st_mtime_ns
    return out


@pytest.fixture(scope="module")
def dag(tmp_path_factory):
    """The face task, then ``all``, from a fresh prefix, with both sample
    cadences at the config's default, 10 000: each student renders its grid
    at 0, before its first step, and the render is the first to make the
    cached identity grids and resize tables."""
    directory = str(tmp_path_factory.mktemp("dag"))
    config = DistillerConfig.load(write_distiller_inputs(directory, seed=12, batch_size=2, sample_cadence=10_000))
    warp._identity_grid.cache_clear()
    cuda_resize.taps.cache_clear()
    face_jobs = _run(config, "face")
    assert face_jobs._body_trainer is None and not face_jobs._body_teachers
    assert not os.path.exists(config.character_model_yaml_file_name())
    jobs = _run(config, "all")
    assert jobs._face_trainer is None  # the face tasks were up to date
    return {"config": config, "directory": directory}


def test_dag_writes_checkpoints_samples_and_logs(dag):
    config = dag["config"]
    for prefix, size in ((config.face_morpher_prefix(), (8 * 128, 2 * 128)), (config.body_morpher_prefix(), (4 * 512, 4 * 512))):
        for index in range(TOTAL // PER_CHECKPOINT + 1):
            directory = ckpt.checkpoint_dir(prefix, index)
            assert ckpt.can_load(directory, ["module"]) and ckpt.read_examples_seen(directory) == index * PER_CHECKPOINT
        png = sample_output.sample_output_file_name(prefix, 0)
        assert np.asarray(PIL.Image.open(png)).shape == size + (4,)
        assert sorted(os.listdir(os.path.join(prefix, "sample_outputs"))) == ["sample_output_0000000000.png"]
        log = os.path.join(prefix, "log")
        assert len([f for f in os.listdir(log) if f.startswith("events.out.tfevents.")]) == 2  # one a training task


def test_exported_students_are_their_last_checkpoints(dag):
    """Each ``.pt`` holds the last checkpoint's state dict, f32 on the CPU,
    under the reference key names, and equals ``save_module_pt`` of the
    module loaded from that checkpoint."""
    config = dag["config"]
    for prefix, dest, make in ((config.face_morpher_prefix(), config.character_model_face_morpher_file_name(),
                                lambda: siren.SirenFaceMorpher(_students()[1])),
                               (config.body_morpher_prefix(), config.character_model_body_morpher_file_name(),
                                lambda: siren.SirenMorpher(_student_cfgs()[1]))):
        sd = torch.load(dest, map_location="cpu", weights_only=True)
        arrays = ckpt._load_npz(_last_npz(prefix))
        module = make()
        assert list(sd) == list(module.state_dict())
        assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in sd.values())
        assert all(np.array_equal(sd[k].numpy(), arrays[k]) for k in sd)
        module.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()})
        again = os.path.join(dag["directory"], "again", os.path.basename(dest))
        os.makedirs(os.path.dirname(again), exist_ok=True)
        save_module_pt(module, again)
        with open(dest, "rb") as a, open(again, "rb") as b:
            assert a.read() == b.read()
    assert not [f for f in os.listdir(config.character_model_prefix()) if f.startswith(".")]  # no staging left
    with open(config.character_model_character_png_file_name(), "rb") as a, open(config.character_image_file_name, "rb") as b:
        assert a.read() == b.read()


def test_character_model_loads_in_both_packages_from_elsewhere(dag, tmp_path, monkeypatch):
    """The yaml's paths are relative to its directory: it loads from another
    working directory, and the two packages pose it alike."""
    config = dag["config"]
    with open(config.character_model_yaml_file_name()) as f:
        assert yaml.safe_load(f) == {"character_image_file_name": "character.png", "face_morpher_file_name": "face_morpher.pt",
                                     "body_morpher_file_name": "body_morpher.pt"}
    monkeypatch.chdir(tmp_path)
    path = os.path.abspath(config.character_model_yaml_file_name())
    model, jmodel = CharacterModel.load(path), JCharacterModel.load(path)
    image = model.get_character_image()
    # The JAX package decodes through its native codec: the same pixels to an f32 rounding.
    np.testing.assert_allclose(image, jmodel.get_character_image(), rtol=0, atol=2.0**-22)
    pose = _random_pose(np.random.default_rng(5))
    ours = [o.numpy() for o in model.get_poser(torch.float32, device="cpu").get_posing_outputs(image, pose)]
    ref = [np.asarray(o) for o in jmodel.get_poser().get_posing_outputs(image, pose)]
    for name, a, r in zip(OUTPUT_NAMES, ours, ref):
        np.testing.assert_allclose(a, r, atol=F32_ATOL[name], err_msg=name)


def test_rerun_runs_nothing(dag, monkeypatch):
    """An up to date DAG: no task runs, no teacher is frozen, no file is
    written (every mtime unchanged, at nanosecond resolution)."""
    config = dag["config"]
    before = _outputs(config)
    monkeypatch.setattr(DistillationJobs, "make_face_trainer", lambda self: pytest.fail("face trainer made"))
    monkeypatch.setattr(DistillationJobs, "make_body_trainer", lambda self, phases=None: pytest.fail("body trainer made"))
    jobs = _run(config, "all")
    assert not jobs._face_teachers and not jobs._body_teachers
    assert _outputs(config) == before


@pytest.mark.parametrize("drop_snapshot", [False, True])
def test_deleted_last_checkpoint_retrains_to_the_same_pt(dag, drop_snapshot, monkeypatch):
    """Delete the body's last checkpoint and its ``.pt``: with the snapshot
    at the end kept, the trainer writes the missing checkpoint from it and
    trains no step; without it, the DAG resumes from checkpoint 1 and
    retrains 2 steps.  Either way the new ``body_morpher.pt`` equals the
    first bit for bit, and the face files are left alone."""
    config = dag["config"]
    prefix, dest = config.body_morpher_prefix(), config.character_model_body_morpher_file_name()
    with open(dest, "rb") as f:
        first = f.read()
    face_before = {k: v for k, v in _outputs(config).items() if "/face_morpher" in k}
    steps = []
    make_body_trainer = DistillationJobs.make_body_trainer

    def counted(self, phases=None):
        made = make_body_trainer(self, phases)
        group = made.train_group
        made.train_group = lambda *args: steps.extend([1] * len(args[2])) or group(*args)
        return made

    monkeypatch.setattr(DistillationJobs, "make_body_trainer", counted)
    shutil.rmtree(ckpt.checkpoint_dir(prefix, TOTAL // PER_CHECKPOINT))
    os.remove(dest)
    if drop_snapshot:
        shutil.rmtree(ckpt.snapshot_dir(prefix))
    jobs = _run(config, "all")
    assert jobs._face_trainer is None and jobs._body_trainer is not None
    with open(dest, "rb") as f:
        assert f.read() == first
    assert len(steps) == (PER_CHECKPOINT // 2 if drop_snapshot else 0)
    assert {k: v for k, v in _outputs(config).items() if "/face_morpher" in k} == face_before


def test_samples_at_zero_leave_training_unchanged(dag, tmp_path):
    """The same config with sample outputs off ends at the same weights, bit
    for bit, as the run whose first act was the render at 0."""
    config = dag["config"]
    off = dataclasses.replace(config, prefix=str(tmp_path / "off"))
    os.makedirs(off.prefix)
    jobs = _tiny_jobs(off, samples=False)
    workspace = Workspace()
    jobs.define_tasks(workspace)
    workspace.run(f"{off.face_morpher_prefix()}/train")
    workspace.run(f"{off.body_morpher_prefix()}/train")
    assert not os.path.exists(os.path.join(off.face_morpher_prefix(), "sample_outputs"))
    for a, b in ((config.face_morpher_prefix(), off.face_morpher_prefix()), (config.body_morpher_prefix(), off.body_morpher_prefix())):
        ours, ref = ckpt._load_npz(_last_npz(a)), ckpt._load_npz(_last_npz(b))
        assert ours.keys() == ref.keys() and all(np.array_equal(ours[k], ref[k]) for k in ours), a


def test_run_config_targets(dag, monkeypatch):
    """``run_config`` runs the node its target names."""
    ran = []
    monkeypatch.setattr(DistillationJobs, "define_tasks", lambda self, ws: None)
    monkeypatch.setattr(Workspace, "run", lambda self, name: ran.append(name))
    config = dag["config"]
    for target in ("body", "face", "all"):
        run_config(config, target=target, device="cpu")
    assert ran == [f"{config.body_morpher_prefix()}/train", f"{config.face_morpher_prefix()}/train", f"{config.prefix}/all"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_run_config_f32_turns_tf32_off(tmp_path, monkeypatch, dtype):
    """``tha4-torch-distill --f32`` (``run_config`` with an f32 compute
    dtype) turns TF32 off in cuBLAS's matmuls and cuDNN's convolutions, as
    the posers do; bf16 leaves both flags as they were."""
    monkeypatch.setattr(DistillationJobs, "define_tasks", lambda self, ws: None)
    monkeypatch.setattr(Workspace, "run", lambda self, name: None)
    config = DistillerConfig.load(write_distiller_inputs(str(tmp_path), seed=12, batch_size=2))
    with precision.restored():
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        run_config(config, compute_dtype=dtype, device="cpu")
        flags = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    assert flags == (("highest", False) if dtype == torch.float32 else ("high", True))


# -- a full-width export, posed by the JAX package ---------------------------


def test_full_width_export_poses_in_jax_at_mode14_bars(tmp_path):
    """A full-width port training checkpoint of each student (the shipped
    widths, seeded, the body head's flows scaled to a trained student's
    size), exported by ``_export_student`` with the character PNG and the
    yaml: the JAX package's ``CharacterModel.load(...).get_poser()`` poses
    it within tests/test_torch_mode14.py's f32 bars of the port's poser."""
    from tha4_tpu_torch.charmodel.synthetic import FLOW_SCALE, synthetic_character_image

    gen = torch.Generator().manual_seed(91)
    face, body = siren.SirenFaceMorpher(generator=gen), siren.SirenMorpher(generator=gen)
    with torch.no_grad():
        body.last_linear.weight[0:2] *= FLOW_SCALE
        body.last_linear.bias[0:2] *= FLOW_SCALE
    model_dir = tmp_path / "character_model"
    paths = {}
    for name, module in (("face_morpher", face), ("body_morpher", body)):
        directory = ckpt.checkpoint_dir(str(tmp_path / name), 10)
        ckpt.save_state(directory, {"module": module}, {"module": torch.optim.Adam(module.parameters())}, 1_000_000, 5)
        paths[name] = str(model_dir / f"{name}.pt")
        fresh = siren.SirenFaceMorpher() if name == "face_morpher" else siren.SirenMorpher()
        DistillationJobs._export_student(os.path.join(directory, "module_module.npz"), fresh, paths[name])
    PIL.Image.fromarray(synthetic_character_image(512, seed=8), mode="RGBA").save(model_dir / "character.png")
    yaml_path = str(model_dir / "character_model.yaml")
    CharacterModel(str(model_dir / "character.png"), paths["face_morpher"], paths["body_morpher"]).save(yaml_path)

    image = imagecodec.load_image_hwc(str(model_dir / "character.png"))
    pose = _random_pose(np.random.default_rng(23))
    ours = [o.numpy() for o in CharacterModel.load(yaml_path).get_poser(torch.float32, device="cpu").get_posing_outputs(image, pose)]
    ref = [np.asarray(o) for o in JCharacterModel.load(yaml_path).get_poser().get_posing_outputs(image, pose)]
    for name, a, r in zip(OUTPUT_NAMES, ours, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=F32_ATOL[name], err_msg=name)
    assert float(np.abs(ref[4]).max()) > 1e-3  # the grid change moves pixels
