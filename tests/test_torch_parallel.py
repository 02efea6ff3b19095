"""Data-parallel distillation in the PyTorch port: ``parallel/mesh.py``,
teacher lookahead and the ``num_gpus`` rule, on the CPU over gloo.

Two spawned ranks train the face and body students of
tests/test_torch_face_distill.py's sizes (the small teacher at the real
geometry, a 41->32x3->4 face student, tests/test_torch_body_distill.py's
small body student) with DDP.  They must agree with each other bit for bit
and with one process within the JAX package's bars
(tests/test_multichip.py:161-240): the one-process step is held against JAX
by the face and body distillation tests.  The spawned ranks import this
module, so it imports the port and never jax.  Every launch binds
127.0.0.1 on a free port, gives its process group a 60 s timeout, passes
numpy back and kills its children on a time limit, so a hang fails one test.

The card tests (marker ``cuda``) run the two ranks on one GPU over gloo and
one rank over NCCL.
"""

import dataclasses
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, write_distiller_inputs
from tha4_tpu_torch.distiller import pose_dataset, recipes
from tha4_tpu_torch.distiller.config import DistillerConfig
from tha4_tpu_torch.distiller.pipeline import DistillationJobs
from tha4_tpu_torch.models import body_morpher, eyebrow, face_morpher, siren, unet, upscaler
from tha4_tpu_torch.parallel import mesh
from tha4_tpu_torch.poser.modes import mode_07, mode_12
from tha4_tpu_torch.training import checkpoint as ckpt

LAUNCH_TIMEOUT_S = 300
PG_TIMEOUT_S = 60
LR = 1e-4
BATCH = 4  # the global batch: 2 a rank, so K = 4 at two ranks and 2 in one process
TOTAL, PER_CHECKPOINT = 32, 16  # 8 steps a run, a checkpoint and a snapshot every 4
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5  # the JAX package's lookahead bars (tests/test_multichip.py:228-230)
# The body's gradients scaled by their largest, one process against two
# ranks: a rank labels and differentiates 1 pose where one process takes 2,
# summing in another order, and where a sum moves by a rounding an L1 term
# at its kink or a warp sample at a texel edge flips, a jump of
# ~1/(2 x 512^2) of the head's gradient per pixel (measured: trunk 4e-6,
# head 4e-5; the face's 3e-7).  One process split as the ranks split the
# batch gives the ranks' step bit for bit, so the split is the whole cause.
BODY_GRAD_ATOL = 1e-4
SMALL = dict(start_channels=4, num_bottleneck_blocks=1, max_channels=8)


def _teacher_cfg():
    un = unet.UnetConfig(
        in_channels=4, out_channels=7, model_channels=8, level_channel_multipliers=(1, 1, 1, 2, 2),
        level_use_attention=(False, False, False, False, True), num_res_blocks_per_level=1, num_middle_res_blocks=2,
        cond_input_channels=6, cond_internal_channels=16, attention=unet.AttentionConfig(num_heads=2, use_new_attention_order=True),
    )
    return mode_07.TeacherConfig(
        eyebrow_decomposer=eyebrow.EyebrowDecomposerConfig(**SMALL), eyebrow_combiner=eyebrow.EyebrowCombinerConfig(**SMALL),
        face_morpher=face_morpher.FaceMorpherConfig(**SMALL), body_morpher=body_morpher.BodyMorpherConfig(unet=un),
        upscaler=upscaler.UpscalerConfig(unet=un),
    )


def _jobs(config_path: str, prefix: str, num_gpus: int, device="cpu", **kwargs) -> DistillationJobs:
    """The small teachers (seeded) and students on ``prefix``; every rank
    and the one-process run make the same."""
    config = dataclasses.replace(DistillerConfig.load(config_path), prefix=prefix, num_gpus=num_gpus)
    os.makedirs(prefix, exist_ok=True)
    tcfg = _teacher_cfg()
    tcfg12 = mode_12.FaceTeacherConfig(eyebrow_decomposer=tcfg.eyebrow_decomposer, eyebrow_combiner=tcfg.eyebrow_combiner,
                                       face_morpher=tcfg.face_morpher)
    kwargs = dict(face_total_examples=TOTAL, body_total_examples=TOTAL, examples_per_checkpoint=PER_CHECKPOINT,
                  examples_per_snapshot=PER_CHECKPOINT) | kwargs
    jobs = DistillationJobs(config, teacher_params_07=random_teacher_07(torch.Generator().manual_seed(71), tcfg),
                            teacher_cfg_07=tcfg, teacher_cfg_12=tcfg12, compute_dtype=torch.float32, device=device, **kwargs)
    jobs.face_student_cfg = siren.SirenFaceMorpherConfig(siren=siren.SirenConfig(41, 4, 32, 3))
    levels = ((128, 16, 3), (256, 8, 3), (512, 8, 3))
    jobs.body_student_cfg = siren.SirenMorpherConfig(image_size=512, levels=tuple(siren.SirenMorpherLevelConfig(*l) for l in levels))
    return jobs


def _poses(n: int, seed: int = 8) -> torch.Tensor:
    return pose_dataset.sample_poses(torch.Generator().manual_seed(seed), n)


def one_step(jobs: DistillationJobs, kind: str, poses: torch.Tensor, parts: int = 1) -> dict:
    """One recipe step on this rank's slice of ``poses`` (the whole batch in
    one process), through a DDP replica where a process group is up: the
    global losses, the averaged gradients and the parameters after Adam.
    ``parts`` > 1 (the body, one process): the step split as that many
    ranks split it, each part labelled and its gradient taken alone, then
    divided by ``parts`` and summed, as DDP averages."""
    device = jobs.device
    gen = torch.Generator().manual_seed(5)
    if kind == "face":
        student = siren.SirenFaceMorpher(jobs.face_student_cfg, generator=gen).to(device)
        mask = torch.from_numpy(recipes.load_face_mask_crop(jobs.config.face_mask_image_file_name)).to(device)
        step = recipes.make_face_distill_step(jobs.face_teacher(), jobs.character_image(), mask, jobs.compute_dtype)
        args = (LR,)
    else:
        student = siren.SirenMorpher(jobs.body_student_cfg, generator=gen).to(device)
        with torch.no_grad():  # flows of a few pixels (tests/test_torch_body_distill.py:62-69)
            student.last_linear.weight[0:2] *= 0.05
            student.last_linear.bias[0:2] *= 0.05
        step = recipes.make_body_distill_step(jobs.body_teacher(), jobs.character_image(), jobs.compute_dtype)
        args = (LR, recipes.default_body_phases().loss_weights(recipes.BODY_LOSS_TERMS, 0))
    replica = mesh.data_parallel(student) if mesh.is_distributed() else student
    local = mesh.shard_batch(poses, mesh.rank(), mesh.world_size()).to(device)
    if parts > 1:
        named = _split_body_step(jobs, student, recipes.make_adam(student), local, args[1], parts)
    else:
        named = mesh.mean_over_ranks(step(replica, recipes.make_adam(student), local, *args))
    return {"named": {k: float(v) for k, v in named.items()},
            "grads": {k: p.grad.detach().cpu().numpy() for k, p in student.named_parameters()},
            "params": {k: v.detach().cpu().numpy() for k, v in student.state_dict().items()}}


def _split_body_step(jobs: DistillationJobs, student, optimizer, poses: torch.Tensor, weights, parts: int) -> dict:
    per = len(poses) // parts
    grads, named = [], []
    for i in range(parts):
        part = poses[i * per : (i + 1) * per]
        labels = recipes.body_teacher_targets(jobs.body_teacher(), jobs.character_image(), part, jobs.compute_dtype)
        optimizer.zero_grad(set_to_none=True)
        total, terms = recipes.body_loss(student, labels, part, weights, jobs.compute_dtype, False)
        total.backward()
        grads.append([p.grad / parts for p in student.parameters()])
        named.append(terms)
    for p, *part_grads in zip(student.parameters(), *grads):
        p.grad = sum(part_grads)
    for group in optimizer.param_groups:
        group["lr"] = LR
    optimizer.step()
    return {k: sum(n[k].detach() for n in named) / parts for k in named[0]}


def _state(prefix: str, index: int) -> dict:
    """The face student's checkpoint ``index`` under a DAG prefix."""
    return ckpt._load_npz(os.path.join(ckpt.checkpoint_dir(os.path.join(prefix, "face_morpher"), index), "module_module.npz"))


def _counted_saves(record: list):
    """ckpt.save_state, recording each directory it writes."""
    save = ckpt.save_state

    def counted(directory, *args, **kwargs):
        record.append(directory)
        return save(directory, *args, **kwargs)

    return save, counted


def _rank_main(config_path: str, base: str) -> dict:
    """Rank r of two: the DDP face and body steps; the face trainer from
    scratch to 32 (A), to 16 then resumed to 32 (B, a copy at 16 kept as
    B16), and resumed from the one-process state at 16 (D)."""
    torch.set_num_threads(2)
    out = {"rank": mesh.rank(), "world": mesh.world_size()}
    jobs = _jobs(config_path, os.path.join(base, "steps"), 2)
    out["face_step"] = one_step(jobs, "face", _poses(BATCH))
    out["body_step"] = one_step(jobs, "body", _poses(2))

    writes, groups = [], []
    save, counted = _counted_saves(writes)
    ckpt.save_state = counted
    try:
        def trainer(prefix):
            made = _jobs(config_path, os.path.join(base, prefix), 2).make_face_trainer()
            made.cfg.log_every_seconds = 0.0
            group = made.train_group
            made.train_group = lambda *a: groups.append(len(a[2])) or group(*a)
            return made

        trainer("A").train()
        trainer("B").train(PER_CHECKPOINT)
        if mesh.rank() == 0:
            shutil.copytree(os.path.join(base, "B"), os.path.join(base, "B16"))
        mesh.barrier()
        trainer("B").train()
        trainer("D").train()
    finally:
        ckpt.save_state = save
    out.update(writes=[os.path.relpath(w, base) for w in writes], groups=groups, lookahead=recipes.default_lookahead(BATCH, 2))
    out["modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "tha4_tpu.")))
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(mesh.rank() + 1))
    out["replicated"] = mesh.replicate(module).weight.detach().numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The one-process runs (the steps; S from scratch to 32; D to 16),
    then two spawned gloo ranks (``_rank_main``), then B16 resumed in one
    process to 32."""
    base = str(tmp_path_factory.mktemp("ddp"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # as each rank runs
    try:
        config_path = write_distiller_inputs(os.path.join(base, "inputs"), seed=21, batch_size=BATCH)
        jobs = _jobs(config_path, os.path.join(base, "one"), 1)
        single = {"face_step": one_step(jobs, "face", _poses(BATCH)), "body_step": one_step(jobs, "body", _poses(2)),
                  "body_split": one_step(jobs, "body", _poses(2), parts=2)}
        _jobs(config_path, os.path.join(base, "S"), 1).make_face_trainer().train()
        _jobs(config_path, os.path.join(base, "D"), 1).make_face_trainer().train(PER_CHECKPOINT)
        results = mesh.launch(_rank_main, 2, "gloo", args=(config_path, base), timeout_s=LAUNCH_TIMEOUT_S,
                              pg_timeout_s=PG_TIMEOUT_S)
        _jobs(config_path, os.path.join(base, "B16"), 1).make_face_trainer().train()
    finally:
        torch.set_num_threads(threads)
    return {"base": base, "single": single, "ranks": results}


def _assert_close(rank: dict, single: dict, grad_atol: float = LOSS_RTOL):
    """Global losses within rtol 1e-5; gradients scaled by their largest
    within ``grad_atol``; after Adam's first step, p - lr * g / (|g| + eps), the
    parameters within the JAX bar wherever |g| is above the gradients' noise
    floor (1e-4 of the largest; below it g's sign is noise, as in
    tests/test_torch_face_distill.py), and never more than one step, 2 lr,
    apart."""
    for name, value in rank["named"].items():
        np.testing.assert_allclose(value, single["named"][name], rtol=LOSS_RTOL, err_msg=name)
    for name, g in rank["grads"].items():
        ref = single["grads"][name]
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(g / scale, ref / scale, atol=grad_atol, err_msg=name)
        p, p_ref = rank["params"][name], single["params"][name]
        assert np.abs(p - p_ref).max() <= 2 * LR + 1e-7, name
        firm = np.abs(ref) > 1e-4 * scale
        np.testing.assert_allclose(p[firm], p_ref[firm], atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("kind", ["face", "body"])
def test_two_rank_step_is_bit_equal_across_ranks_and_matches_one_process(ranks, kind):
    """The DDP step over two gloo ranks (the face batch 2 + 2, the body's
    1 + 1): both ranks hold the same averaged gradients and parameters bit
    for bit, and the one-process step's global losses, gradients (scaled by
    their largest; the body's to its own bar) and parameters within the JAX
    bars."""
    r0, r1 = (r[f"{kind}_step"] for r in ranks["ranks"])
    for part in ("grads", "params", "named"):
        for name in r0[part]:
            np.testing.assert_array_equal(r0[part][name], r1[part][name], err_msg=f"{part} {name}")
    _assert_close(r0, ranks["single"][f"{kind}_step"], LOSS_RTOL if kind == "face" else BODY_GRAD_ATOL)


def test_two_rank_body_step_is_one_process_split_as_the_ranks_split_it(ranks):
    """What separates the ranks' body step from one process's is the batch
    split alone: one process that labels and differentiates the two poses
    one at a time, halves each gradient and sums them (DDP's average) ends
    at the ranks' losses, gradients and parameters bit for bit."""
    rank, split = ranks["ranks"][0]["body_step"], ranks["single"]["body_split"]
    for part in ("grads", "params", "named"):
        for name in split[part]:
            np.testing.assert_array_equal(rank[part][name], split[part][name], err_msg=f"{part} {name}")


def test_two_rank_trainer_writes_each_state_once_and_resumes_bitwise(ranks):
    """Rank 0 alone writes checkpoint 0, the snapshot and checkpoint 1 at
    16, the snapshot and checkpoint 2 at 32; the teacher labels 4 steps a
    call (K = 4 at 2 poses a rank) in groups that stop at each boundary; a
    run stopped at the snapshot at 16 and resumed ends bit-equal to the run
    that never stopped; only rank 0 logs."""
    r0, r1 = ranks["ranks"]
    base = ranks["base"]
    assert (r0["world"], r1["world"], r0["lookahead"]) == (2, 2, 4)
    face = lambda p: os.path.join(p, "face_morpher")
    a_writes = [os.path.join(face("A"), "checkpoint", "0000"), os.path.join(face("A"), "snapshot"),
                os.path.join(face("A"), "checkpoint", "0001"), os.path.join(face("A"), "snapshot"),
                os.path.join(face("A"), "checkpoint", "0002")]
    # A's five states; B's three to 16 and two after its resume; D's two after its resume.
    assert r0["writes"][:5] == a_writes and len(r0["writes"]) == 12 and r1["writes"] == []
    assert r0["groups"] == r1["groups"] == [4] * 5  # A: 2 groups, B: 1 + 1, D: 1
    for index in range(3):
        a, b = _state(os.path.join(base, "A"), index), _state(os.path.join(base, "B"), index)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), index
    rows = open(os.path.join(base, "A", "face_morpher", "log", "scalars.jsonl")).read().splitlines()
    assert len(rows) == 2
    assert sorted(os.listdir(os.path.join(base, "A", "face_morpher", "checkpoint"))) == ["0000", "0001", "0002"]


def test_checkpoints_load_across_world_sizes(ranks):
    """A state written by two ranks resumes in one process (B16), and one
    written by one process resumes in two ranks (D); each run, and the
    two-rank run from scratch (A), ends within the JAX bars of the
    one-process run (S): the same update stream, the teacher's labels made
    at other batch sizes and the gradients summed in another order."""
    base = ranks["base"]
    s = _state(os.path.join(base, "S"), 2)
    for prefix in ("A", "D", "B16"):
        other = _state(os.path.join(base, prefix), 2)
        assert other.keys() == s.keys(), prefix
        for k in s:
            np.testing.assert_allclose(other[k], s[k], atol=PARAM_ATOL, err_msg=f"{prefix} {k}")
        assert not all(np.array_equal(other[k], _state(os.path.join(base, prefix), 1)[k]) for k in s), prefix


def test_spawned_ranks_import_no_jax(ranks):
    assert [r["modules"] for r in ranks["ranks"]] == [[], []]


def test_replicate_broadcasts_rank_0(ranks):
    for r in ranks["ranks"]:
        np.testing.assert_array_equal(r["replicated"], np.ones((2, 3), np.float32))


def test_lookahead_equals_plain_steps_and_resumes_bitwise(tmp_path):
    """Teacher lookahead K = 3 over 7 steps (two groups and a plain step,
    tests/test_multichip.py:208-230) makes K = 1's update stream within the
    JAX bars; a K = 3 run stopped at its snapshot after the first group and
    resumed ends bit-equal to the run that never stopped."""
    config_path = write_distiller_inputs(str(tmp_path / "inputs"), seed=22, batch_size=2)
    # A snapshot after each group (6, 12), then the plain step to 14.
    kw = dict(face_total_examples=14, examples_per_checkpoint=14, examples_per_snapshot=6)
    runs, calls = {}, {}
    for k in (1, 3):
        trainer = _jobs(config_path, str(tmp_path / f"k{k}"), 1, **kw).make_face_trainer()
        trainer.cfg.lookahead, trainer.cfg.log_every_seconds = k, 0.0
        group, calls[k] = trainer.train_group, []
        trainer.train_group = lambda *a, calls=calls[k], group=group: calls.append(len(a[2])) or group(*a)
        runs[k] = trainer.train()
    assert calls == {1: [1] * 7, 3: [3, 3, 1]}
    np.testing.assert_allclose(float(runs[3]["metrics"]["loss"]), float(runs[1]["metrics"]["loss"]), rtol=LOSS_RTOL)
    for (name, a), b in zip(runs[1]["module"].state_dict().items(), runs[3]["module"].state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=PARAM_ATOL, err_msg=name)

    prefix = str(tmp_path / "stopped")
    for target in (6, None):
        trainer = _jobs(config_path, prefix, 1, **kw).make_face_trainer()
        trainer.cfg.lookahead = 3
        done = trainer.train(target)
    assert done["examples_seen"] == 14
    assert all(torch.equal(v, runs[3]["module"].state_dict()[k]) for k, v in done["module"].state_dict().items())


def test_num_gpus_without_a_launcher_trains_as_one_process(tmp_path, caplog):
    """``num_gpus: 2`` in a process with no ranks and no GPUs: JAX's warning,
    and the face student's checkpoint equals the ``num_gpus: 1`` run's bit
    for bit; a batch that does not divide over 2 is refused."""
    config_path = write_distiller_inputs(str(tmp_path / "inputs"), seed=23, batch_size=2)
    states = {}
    for n in (1, 2):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            jobs = _jobs(config_path, str(tmp_path / f"n{n}"), n, face_total_examples=4, examples_per_checkpoint=4)
        trainer = jobs.make_face_trainer()
        assert ("config requests 2 GPUs" in caplog.text) == (n == 2) and trainer.cfg.lookahead == 4  # world 1, batch 2
        trainer.train()
        states[n] = _state(jobs.config.prefix, 1)
    assert all(np.array_equal(states[1][k], states[2][k]) for k in states[1])
    with pytest.raises(ValueError, match="does not divide over num_gpus = 2"):
        _jobs(write_distiller_inputs(str(tmp_path / "odd"), seed=23, batch_size=3), str(tmp_path / "odd_job"), 2)


def test_default_lookahead_sizing():
    """tests/test_multichip.py:233-240: K brings each rank's teacher batch
    to 8."""
    assert recipes.TEACHER_SATURATION_BATCH == 8
    assert recipes.default_lookahead(8, 1) == 1
    assert recipes.default_lookahead(8, 8) == 8
    assert recipes.default_lookahead(8, 4) == 4  # JAX's data=4 mesh: 2 poses a shard
    assert recipes.default_lookahead(64, 8) == 1
    assert recipes.default_lookahead(8, 2) == 2 and recipes.default_lookahead(2) == 4


def test_shard_batch_slices_and_refuses_a_remainder():
    batch = torch.arange(24).reshape(8, 3)
    parts = [mesh.shard_batch(batch, r, 4) for r in range(4)]
    assert torch.equal(torch.cat(parts), batch) and all(p.shape == (2, 3) for p in parts)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(torch.zeros(3, 2), 0, 2)


def test_initialize_multihost_branch_selection(monkeypatch):
    """tests/test_multichip.py:255-298 for torch.distributed: a launcher's
    environment initializes, nothing initializes nothing, an explicit
    address initializes; NCCL without a GPU raises."""
    for var in mesh.LAUNCH_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)
    assert mesh.initialize_multihost() is False and not mesh.is_distributed()
    assert (mesh.rank(), mesh.world_size()) == (0, 1)
    try:
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(mesh.free_port()))
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("LOCAL_RANK", "0")
        assert mesh.initialize_multihost(backend="gloo", timeout_s=PG_TIMEOUT_S) is True
        assert mesh.is_distributed() and (mesh.rank(), mesh.world_size()) == (0, 1)
        assert mesh.agree("rank 0's") == "rank 0's"
    finally:
        if mesh.is_distributed():
            torch.distributed.destroy_process_group()
    for var in mesh.LAUNCH_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(var)
    try:
        assert mesh.initialize_multihost(f"tcp://127.0.0.1:{mesh.free_port()}", rank=0, world_size=1, backend="gloo",
                                         timeout_s=PG_TIMEOUT_S) is True
        assert mesh.world_size() == 1
    finally:
        if mesh.is_distributed():
            torch.distributed.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl"):
            mesh.initialize_multihost(f"tcp://127.0.0.1:{mesh.free_port()}", rank=0, world_size=1, backend="nccl")
        assert not mesh.is_distributed()


def _failing_rank() -> None:
    if mesh.rank() == 1:
        raise ValueError("rank 1 fails")
    mesh.barrier()  # rank 0 waits for a rank that never comes


def test_a_failing_rank_fails_the_launch():
    """Nothing falls back: rank 1's exception fails the launch, and rank 0,
    left waiting at a barrier, is killed."""
    with pytest.raises(RuntimeError, match="rank 1 failed") as failure:
        mesh.launch(_failing_rank, 2, "gloo", timeout_s=120, pg_timeout_s=PG_TIMEOUT_S)
    assert "ValueError: rank 1 fails" in str(failure.value)


# -- on the card --------------------------------------------------------------


def _card_rank_main(config_path: str, base: str, kind: str) -> dict:
    torch.backends.cudnn.deterministic = True  # a spawned rank does not inherit its parent's setting
    jobs = _jobs(config_path, os.path.join(base, "card"), mesh.world_size(), device="cuda")
    return one_step(jobs, kind, _poses(BATCH if kind == "face" else 2))


def _card_inputs(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return write_distiller_inputs(str(tmp_path / "inputs"), seed=24, batch_size=BATCH), str(tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["face", "body"])
def test_cuda_two_ranks_share_the_card_over_gloo(tmp_path, monkeypatch, kind):
    """Two gloo ranks on one GPU: bit-equal ranks, the one-process step on
    the card within the JAX bars."""
    config_path, base = _card_inputs(tmp_path, monkeypatch)
    from tha4_tpu_torch.ops import cuda_build

    cuda_build.build()
    r0, r1 = mesh.launch(_card_rank_main, 2, "gloo", args=(config_path, base, kind), timeout_s=LAUNCH_TIMEOUT_S,
                         pg_timeout_s=PG_TIMEOUT_S)
    for part in ("grads", "params"):
        for name in r0[part]:
            np.testing.assert_array_equal(r0[part][name], r1[part][name], err_msg=f"{part} {name}")
    single = one_step(_jobs(config_path, os.path.join(base, "one"), 1, device="cuda"), kind, _poses(BATCH if kind == "face" else 2))
    _assert_close(r0, single, LOSS_RTOL if kind == "face" else BODY_GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["face", "body"])
def test_cuda_nccl_world_1_step_equals_the_plain_step(tmp_path, monkeypatch, kind):
    """One NCCL rank: the DDP step equals the plain step bit for bit (f32,
    cuDNN deterministic)."""
    config_path, base = _card_inputs(tmp_path, monkeypatch)
    from tha4_tpu_torch.ops import cuda_build

    cuda_build.build()
    (ddp,) = mesh.launch(_card_rank_main, 1, "nccl", args=(config_path, base, kind), timeout_s=LAUNCH_TIMEOUT_S,
                         pg_timeout_s=PG_TIMEOUT_S)
    plain = one_step(_jobs(config_path, os.path.join(base, "one"), 1, device="cuda"), kind, _poses(BATCH if kind == "face" else 2))
    for part in ("grads", "params", "named"):
        for name in plain[part]:
            np.testing.assert_array_equal(ddp[part][name], plain[part][name], err_msg=f"{part} {name}")
