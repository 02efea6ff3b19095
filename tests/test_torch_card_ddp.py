"""Data-parallel distillation on one card, at full width.

(a) Two gloo ranks sharing the card train both students against the seeded
full-width random teachers, 4 steps each at batch 8 (4 a rank, teacher
lookahead K = 2), bf16 and f32, through ``DistillationJobs``' trainers,
against one process (K = 1); (b) one NCCL rank's DDP steps against the
plain steps; (c) ``run_config`` with ``num_gpus: 2`` and no ranks, and two
gloo ranks through ``run_config`` stopped at the body's snapshot and rerun.
The ranks are spawned processes that load this module and the parent's
build.  NCCL across several GPUs needs more than one card and is not
checked here.  How to run: ``tests/torch_card.py``.
"""

import dataclasses
import logging
import math
import os

import numpy as np
import pytest
import torch

from torch_card import BATCH, K6_PER_TEACHER_CALL, SEED, kernel_counters, teacher_params, workdir

pytestmark = pytest.mark.cuda

STEPS = 4  # steps a student in every data-parallel run, at batch 8
PG_TIMEOUT_S = 300  # a rank waits this long at a collective
LAUNCH_TIMEOUT_S = 600  # a launch's whole run
# Two gloo ranks (4 poses each, teacher lookahead K = 2) against one
# process (8 poses, K = 1), 4 steps a student.  f32: the JAX package's bars
# for its sharded run against one device (tests/test_multichip.py:200-205,
# loss rtol 1e-5 there 2e-5, parameters atol 1e-5), which the face holds.
# The body does not: a rank sums its student's gradients over 4 x 512^2
# pixels where one process sums over 8 x 512^2, in another order.  Read on
# an H100, the first step's gradients are then 2.2e-6 of their largest
# apart with no sign changed, and four Adam steps through the omega = 30
# sines carry that to 7.3e-5 in the parameters and 7.4e-4 in the last
# losses.  One process whose student forward and backward are split 4 + 4
# as the ranks split them (``_split_body_group``) does the same sums in the
# same order: it reads the ranks' run bit for bit, and the plain one
# process's distance from it is theirs to the digit, so the batch split is
# the whole cause.  The f32 body is held to the JAX bars against that
# witness, and against the plain one process, as bf16 below, to a tenth
# of bf16's own distance from f32 in the last losses and the update.  Both
# f32 students' first-step gradients, scaled by their largest, must stay
# within the CPU test's bars (tests/test_torch_parallel.py: face 1e-5,
# body 1e-4).
# bf16: the student's weights are rounded to bf16 (2^-8 of themselves) at
# every step's packing, and the sine chain carries a flipped rounding on,
# so an equally valid order of sums moves the run along bf16's own noise:
# read on an H100, the face's last loss 1.8e-3 and its update 2.2e-2
# relative from one process.
# The measure of that noise is the one-process bf16 run's distance from the
# one-process f32 run from the same start; the two ranks must stay within
# a fraction of it, in the last losses and in the update over the run,
# |dp_ranks - dp_one| / |dp_one| over all parameters.
F32_LOSS_RTOL = 1e-5
F32_PARAM_ATOL = 1e-5
F32_GRAD_ATOL = {"face": 1e-5, "body": 1e-4}
F32_BODY_SHARE = 0.1
BF16_SHARE = 0.5
# Kernel launches of one step of each student, and of one teacher call.
STUDENT_LAUNCHES = {"face": {"sine_chain_t": 1, "sine_chain_t_bwd": 1},
                    "body": {"grid_sample_train_forward": 1, "grid_sample_grid_backward": 1, "poly_sin_forward": 9,
                             "poly_sin_backward": 9}}
TEACHER_LAUNCHES = {"face": {"grid_sample_fast": 2},
                    "body": {"grid_sample_fast": 5, "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL,
                             "fold_groupnorm_film": K6_PER_TEACHER_CALL}}
CASES = [(tag, kind) for tag in ("bf16", "f32") for kind in ("face", "body")]


class _StopAtSnapshot(Exception):
    """Raised on every rank after a snapshot's write: a run stopped there."""


def _config(config_path: str, prefix: str, num_gpus: int):
    from tha4_tpu_torch.distiller.config import DistillerConfig

    os.makedirs(prefix, exist_ok=True)
    return dataclasses.replace(DistillerConfig.load(config_path), prefix=prefix, num_gpus=num_gpus)


def _kwargs(teacher_params, dtype, per_checkpoint: int) -> dict:
    """``DistillationJobs``'s arguments: the full-width random teachers,
    the shipped students, STEPS steps a student on the card."""
    total = STEPS * BATCH
    return dict(teacher_params_07=teacher_params, compute_dtype=dtype, device="cuda", face_total_examples=total,
                body_total_examples=total, examples_per_checkpoint=per_checkpoint, examples_per_snapshot=per_checkpoint)


def _jobs(config_path: str, prefix: str, num_gpus: int, teacher_params, dtype, per_checkpoint: int = STEPS * BATCH):
    from tha4_tpu_torch.distiller import pipeline

    return pipeline.DistillationJobs(_config(config_path, prefix, num_gpus), **_kwargs(teacher_params, dtype, per_checkpoint))


def _split_body_group(jobs, parts: int = 2):
    """The body trainer's ``train_group`` in one process (K = 1) with the
    student's forward and backward split as ``parts`` ranks split them:
    the teacher labels the global batch, each part's gradient of its own
    mean loss is divided by ``parts`` and the parts summed, as DDP averages
    them; the losses are the parts' mean, as ``mesh.mean_over_ranks``."""
    from tha4_tpu_torch.distiller import recipes

    teacher, image, dtype = jobs.body_teacher(), jobs.character_image(), jobs.compute_dtype
    batch = jobs.config.body_morpher_batch_size
    per = batch // parts

    def group(student, optimizer, gens, lrs, weights_list):
        for gen, lr, weights in zip(gens, lrs, weights_list):
            poses = jobs.local_poses(gen, batch)
            labels = recipes.body_teacher_targets(teacher, image, poses, dtype)
            grads, named = None, []
            for i in range(parts):
                part = slice(i * per, (i + 1) * per)
                optimizer.zero_grad(set_to_none=True)
                total, terms = recipes.body_loss(student, tuple(t[part] for t in labels), poses[part], weights, dtype,
                                                 jobs.student_mixed)
                total.backward()
                g = [p.grad / parts for p in student.parameters()]
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                named.append(terms)
            for p, g in zip(student.parameters(), grads):
                p.grad = g
            for param_group in optimizer.param_groups:
                param_group["lr"] = lr
            optimizer.step()
        return {k: sum(n[k].detach().float() for n in named) / parts for k in named[0]}

    return group


def _train(jobs, kinds=("face", "body"), split_body: bool = False) -> dict:
    """The students' STEPS steps through their trainers: the initial and
    final parameters, the first step's gradients (as Adam takes them,
    averaged over the ranks), the last step's losses (over the global
    batch) and the lookahead.  ``split_body``: the body's steps run as
    ``_split_body_group``."""
    out = {}
    for kind in kinds:
        trainer = jobs.make_face_trainer() if kind == "face" else jobs.make_body_trainer()
        init = {k: v.detach().float().cpu().numpy() for k, v in trainer._fresh_state()[0].state_dict().items()}
        first_grads = {}
        if kind == "body" and split_body:
            trainer.train_group = _split_body_group(jobs)
        make_optimizer = trainer.make_optimizer

        def hooked(module):
            optimizer = make_optimizer(module)
            names = [n for n, _ in module.named_parameters()]

            def before_step(opt, args, kwargs):
                if not first_grads:
                    first_grads.update({n: p.grad.detach().float().cpu().numpy()
                                        for n, p in zip(names, opt.param_groups[0]["params"])})

            optimizer.register_step_pre_hook(before_step)
            return optimizer

        trainer.make_optimizer = hooked
        done = trainer.train()
        out[kind] = {"init": init, "params": {k: v.detach().float().cpu().numpy() for k, v in done["module"].state_dict().items()},
                     "grads": first_grads, "loss": {k: float(v) for k, v in done["metrics"].items()},
                     "lookahead": trainer.cfg.lookahead}
    return out


def _rank_main(config_path: str, workdir: str, teacher_params) -> dict:
    """A rank of (a) and (c): both students in bf16 and f32 through their
    trainers, then the DAG through ``run_config`` twice, once stopped at the
    body's snapshot and rerun."""
    from tha4_tpu_torch.distiller import pipeline
    from tha4_tpu_torch.parallel import mesh
    from tha4_tpu_torch.training import checkpoint as ckpt
    from tha4_tpu_torch.training.trainer import Trainer
    from tha4_tpu_torch.utils import precision

    precision.set_full_f32()  # as the parent runs: a spawned rank inherits neither setting
    torch.backends.cudnn.deterministic = True
    out = {"rank": mesh.rank(), "world": mesh.world_size(), "backend": torch.distributed.get_backend()}
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        out[tag] = _train(_jobs(config_path, os.path.join(workdir, f"ddp_{tag}_ranks"), 2, teacher_params, dtype))
    out["launches"] = {c.__name__: c.launches for c in counters}

    total = STEPS * BATCH
    writes, exports, stopped = [], [], []
    save_state, export, trainer_save = ckpt.save_state, pipeline.DistillationJobs._export_student, Trainer._save

    def counted_save(directory, *args):
        writes.append(os.path.relpath(directory, workdir))
        save_state(directory, *args)

    def counted_export(checkpoint_file, module, dest):
        exports.append(os.path.relpath(dest, workdir))
        export(checkpoint_file, module, dest)

    kwargs = _kwargs(teacher_params, torch.bfloat16, total // 2)
    config_a = _config(config_path, os.path.join(workdir, "dag_ranks_a"), 2)
    config_b = _config(config_path, os.path.join(workdir, "dag_ranks_b"), 2)

    def stopping_save(self, directory, module, optimizer, examples_seen, key):
        trainer_save(self, directory, module, optimizer, examples_seen, key)  # rank 0 writes, both pass the barrier
        if directory == ckpt.snapshot_dir(config_b.body_morpher_prefix()) and examples_seen == total // 2 and not stopped:
            stopped.append(examples_seen)
            raise _StopAtSnapshot()

    ckpt.save_state, pipeline.DistillationJobs._export_student = counted_save, staticmethod(counted_export)
    try:
        pipeline.run_config(config_a, "all", **kwargs)
        Trainer._save = stopping_save
        try:
            pipeline.run_config(config_b, "all", **kwargs)
        except _StopAtSnapshot:
            pass
        Trainer._save = trainer_save
        pipeline.run_config(config_b, "all", **kwargs)
    finally:
        ckpt.save_state, pipeline.DistillationJobs._export_student, Trainer._save = save_state, staticmethod(export), trainer_save
    out["dag"] = {"writes": writes, "exports": exports, "stopped": stopped}
    return out


def _nccl_rank_main(config_path: str, workdir: str, teacher_params) -> dict:
    """(b), one rank over NCCL: a DDP face step and a DDP body step in f32,
    cuDNN deterministic, against the plain step from the same student,
    poses and labels; the largest difference of the losses, gradients and
    parameters."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.parallel import mesh
    from tha4_tpu_torch.utils import precision

    precision.set_full_f32()
    torch.backends.cudnn.deterministic = True
    jobs = _jobs(config_path, os.path.join(workdir, "nccl"), 1, teacher_params, torch.float32)
    out = {"backend": torch.distributed.get_backend(), "world": mesh.world_size(),
           "deterministic": torch.backends.cudnn.deterministic}
    poses = jobs.pose_source.batch(torch.Generator().manual_seed(SEED + 60), BATCH).cuda()
    mask = torch.from_numpy(recipes.load_face_mask_crop(jobs.config.face_mask_image_file_name)).cuda()
    weights = recipes.default_body_phases().loss_weights(recipes.BODY_LOSS_TERMS, 0)
    for kind in ("face", "body"):
        runs = []
        for wrapped in (False, True):
            gen = torch.Generator().manual_seed(SEED + 61)
            if kind == "face":
                student = siren.SirenFaceMorpher(jobs.face_student_cfg, generator=gen).cuda()
                step = recipes.make_face_distill_step(jobs.face_teacher(), jobs.character_image(), mask, torch.float32)
                args = (1e-4,)
            else:
                student = siren.SirenMorpher(jobs.body_student_cfg, generator=gen).cuda()
                step = recipes.make_body_distill_step(jobs.body_teacher(), jobs.character_image(), torch.float32, True)
                args = (1e-4, weights)
            named = step(mesh.data_parallel(student) if wrapped else student, recipes.make_adam(student), poses, *args)
            runs.append([named[k] for k in sorted(named)] + [p.grad for p in student.parameters()]
                        + [p.detach() for p in student.parameters()])
        out[kind] = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*runs))
    return out


def _pt_bytes(config) -> dict:
    out = {}
    for kind in ("face", "body"):
        with open(getattr(config, f"character_model_{kind}_morpher_file_name")(), "rb") as f:
            out[kind] = f.read()
    return out


@pytest.fixture(scope="module")
def config_path(workdir):
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs

    return write_distiller_inputs(os.path.join(workdir, "ddp_inputs"), seed=SEED + 70, batch_size=BATCH)


@pytest.fixture(scope="module")
def one_process(config_path, workdir, teacher_params):
    """(a)'s references, cuDNN deterministic: each dtype's one-process run,
    and the f32 body's with its forward split as the ranks split it."""
    torch.backends.cudnn.deterministic = True
    try:
        single = {tag: _train(_jobs(config_path, os.path.join(workdir, f"ddp_{tag}_one"), 1, teacher_params, dtype))
                  for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))}
        jobs = _jobs(config_path, os.path.join(workdir, "ddp_f32_split"), 1, teacher_params, torch.float32)
        single["split"] = _train(jobs, kinds=("body",), split_body=True)["body"]
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return single


@pytest.fixture(scope="module")
def ranks(config_path, workdir, teacher_params):
    from tha4_tpu_torch.ops import cuda_build
    from tha4_tpu_torch.parallel import mesh

    cuda_build.build()  # once in the parent; the ranks load it
    return mesh.launch(_rank_main, 2, "gloo", args=(config_path, workdir, teacher_params), timeout_s=LAUNCH_TIMEOUT_S,
                       pg_timeout_s=PG_TIMEOUT_S)


def _grad_distance(a: dict, one: dict) -> dict:
    """The first step's gradients: the largest difference over the largest
    magnitude, tensor by tensor, and the signs that differ (Adam's first
    step moves a parameter by lr x its gradient's sign)."""
    return {"grad_rel": max(float(np.abs(a[k] - one[k]).max() / max(np.abs(one[k]).max(), 1e-30)) for k in one),
            "sign_flips": int(sum((np.sign(a[k]) != np.sign(one[k])).sum() for k in one))}


def _distance(a: dict, one: dict) -> dict:
    """``a``'s last losses and parameters against ``one``'s, and the update
    over the run from their common start."""
    moved = [(a["params"][k] - one["init"][k], one["params"][k] - one["init"][k]) for k in one["params"]]
    return {"loss_rel": max(abs(a["loss"][k] - one["loss"][k]) / abs(one["loss"][k]) for k in one["loss"]),
            "param_abs": max(float(np.abs(a["params"][k] - one["params"][k]).max()) for k in one["params"]),
            "update_rel": (math.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in moved))
                           / math.sqrt(sum(float((y ** 2).sum()) for _, y in moved)))}


@pytest.mark.parametrize("tag,kind", CASES)
def test_two_gloo_ranks_agree_and_match_one_process(ranks, one_process, tag, kind):
    r0, r1 = ranks
    assert (r0["world"], r1["world"], r0["backend"]) == (2, 2, "gloo")
    a, b, one = r0[tag][kind], r1[tag][kind], one_process[tag][kind]
    assert (a["lookahead"], one["lookahead"]) == (2, 1)
    for part in ("params", "grads"):
        assert all(np.array_equal(a[part][k], b[part][k]) for k in a[part]), f"the two ranks' {part} differ"
    row = _distance(a, one)
    noise = _distance(one_process["bf16"][kind], one_process["f32"][kind])
    print(f"{tag} {kind}: against one process {row}; the one-process bf16 run from f32 {noise}")
    if tag == "f32" and kind == "face":
        assert row["loss_rel"] <= F32_LOSS_RTOL and row["param_abs"] <= F32_PARAM_ATOL, row
    else:
        share = F32_BODY_SHARE if tag == "f32" else BF16_SHARE
        assert all(row[k] <= share * noise[k] for k in ("loss_rel", "update_rel")), (row, noise)
    if tag == "f32":
        assert _grad_distance(a["grads"], one["grads"])["grad_rel"] <= F32_GRAD_ATOL[kind]
    if tag == "f32" and kind == "body":
        # The witness: one process with the student's forward split as the ranks split it.
        split = _distance(a, one_process["split"])
        print(f"against the split one-process run: {split}")
        assert split["loss_rel"] <= F32_LOSS_RTOL and split["param_abs"] <= F32_PARAM_ATOL, split


def test_each_rank_launches_its_steps_and_its_teacher_calls(ranks):
    expected = dict.fromkeys((c.__name__ for c in kernel_counters()), 0)
    for kind in ("face", "body"):
        for name, n in STUDENT_LAUNCHES[kind].items():
            expected[name] += 2 * STEPS * n  # two dtypes
        for name, n in TEACHER_LAUNCHES[kind].items():
            expected[name] += 2 * (STEPS // 2) * n  # a teacher call labels a group of K = 2 steps
    assert [r["launches"] for r in ranks] == [expected, expected]


def test_nccl_world_1_steps_equal_the_plain_steps(config_path, workdir, teacher_params):
    from tha4_tpu_torch.ops import cuda_build
    from tha4_tpu_torch.parallel import mesh

    cuda_build.build()
    (nccl,) = mesh.launch(_nccl_rank_main, 1, "nccl", args=(config_path, workdir, teacher_params),
                          timeout_s=LAUNCH_TIMEOUT_S, pg_timeout_s=PG_TIMEOUT_S)
    assert (nccl["backend"], nccl["world"], nccl["deterministic"]) == ("nccl", 1, True)
    assert nccl["face"] == 0 and nccl["body"] == 0, nccl


def test_num_gpus_2_on_one_card_warns_and_exports_the_num_gpus_1_run(config_path, workdir, teacher_params):
    from tha4_tpu_torch.distiller import pipeline

    pts, warned = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for n in (1, 2):
            config = _config(config_path, os.path.join(workdir, f"dag_num_gpus_{n}"), n)
            records = []
            handler = logging.Handler(logging.WARNING)
            handler.emit = records.append
            pipeline.logger.addHandler(handler)
            try:
                pipeline.run_config(config, "all", **_kwargs(teacher_params, torch.bfloat16, STEPS * BATCH // 2))
            finally:
                pipeline.logger.removeHandler(handler)
            warned[n] = any("config requests 2 GPUs" in r.getMessage() for r in records)
            pts[n] = _pt_bytes(config)
    finally:
        torch.backends.cudnn.deterministic = False
    assert warned == {1: False, 2: True} and pts[1] == pts[2]


def test_two_ranks_through_run_config_write_once_and_resume_to_the_same_export(ranks, config_path, workdir):
    """Rank 0 writes each checkpoint once and both runs' exports, rank 1
    nothing; the run stopped at the body's snapshot and rerun exports the
    uninterrupted run's ``.pt`` files bit for bit."""
    r0, r1 = ranks
    dag = r0["dag"]
    ckpts = [w for w in dag["writes"] if "/checkpoint/" in w]
    assert not r1["dag"]["writes"] and not r1["dag"]["exports"]
    assert len(ckpts) == len(set(ckpts)) == 2 * 2 * 3 and len(dag["exports"]) == 4  # two runs, two students, checkpoints 0-2
    assert dag["stopped"] == [STEPS * BATCH // 2]
    assert _pt_bytes(_config(config_path, os.path.join(workdir, "dag_ranks_a"), 2)) == _pt_bytes(
        _config(config_path, os.path.join(workdir, "dag_ranks_b"), 2))
