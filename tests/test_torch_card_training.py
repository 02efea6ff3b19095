"""Both students' training on the card, at full width, through the
distiller's own trainers.

The face student (a seeded full-width random mode_12 teacher) and the body
student (the seeded full-width random mode_07, bf16 teacher, selective-f32
student, the six phases scaled to the run) each train 32 steps at batch 8
across two checkpoint boundaries: their launches, losses and checkpoints,
a resume from checkpoint 1, and the f32 gradients on the card against the
plain backward on the CPU.  How to run: ``tests/torch_card.py``.  Speed is
the benchmark's (``body_distill.bf16``) and ``profile_step --time``'s (the
face step, the bf16 and int8 body steps).
"""

import copy
import dataclasses
import json
import math
import os
import shutil

import pytest
import torch

from torch_card import BATCH, K6_PER_TEACHER_CALL, SEED, launches, reset, teacher_params, workdir

pytestmark = pytest.mark.cuda

STEPS = 32
# Resume from checkpoint 1 against the uninterrupted run.  Bit-equal is
# expected (K1, K2 and K4 are deterministic, so are cuDNN's forward convs);
# the bar leaves room for a teacher conv whose sum order varied, which
# would move a label by a bf16 step and an Adam step by a fraction of lr.
RESUME_ATOL = 1e-6
# The f32 training step on the card (K1 + K4) against the plain backward
# on the CPU, same cotangent: tests/test_pallas_siren.py:95-121, the bar
# for real level shapes at omega = 30.
STEP_F32_ATOL = 1e-3
# The body student's f32 gradients end to end, once the pixels where the
# loss is not smooth between the two devices' head outputs are dropped, the
# card against the CPU's whole backward at the card's head output: ten times
# the trunk's 1.4e-6 on the same cotangent, where the whole loss reads 1.1e-3.
STEP_MASKED_ATOL = 1e-5
# What the two head outputs' difference alone moves in those gradients,
# measured on the CPU (its backward at the card's head output against at its
# own): three times the largest reading, 1.6e-5, on NVIDIA H100s.  The head
# outputs differ by f32 rounding in the trunk's forward, and the smooth
# pixels' bilinear grid derivative moves with the sample point (1e-6 in a
# normalised grid point is 2.6e-4 px at 512^2).
STEP_DRIFT_ATOL = 5e-5


def _log_rows(prefix: str) -> list:
    with open(os.path.join(prefix, "log", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _checkpoints_load(prefix: str, total: int) -> bool:
    from tha4_tpu_torch.training import checkpoint as ckpt

    states = [(ckpt.checkpoint_dir(prefix, i), i * total // 2) for i in range(3)] + [(ckpt.snapshot_dir(prefix), total)]
    return all(ckpt.can_load(d, ["module"]) and ckpt.read_examples_seen(d) == seen for d, seen in states)


def _resume(make_trainer, prefix: str, workdir: str) -> dict:
    """A second run's result, from the first run's checkpoint 1."""
    from tha4_tpu_torch.training import checkpoint as ckpt

    trainer = make_trainer(os.path.join(workdir, "resumed"))
    shutil.copytree(ckpt.checkpoint_dir(prefix, 1), ckpt.checkpoint_dir(trainer.cfg.prefix, 1))
    return trainer.train()


# -- the face student ------------------------------------------------------------


@pytest.fixture(scope="module")
def face(workdir):
    """32 bf16 face steps at batch 8 through
    ``DistillationJobs.make_face_trainer().train()``, logging every step,
    with their K1, K4 and K2 launches."""
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.distiller.pipeline import DistillationJobs
    from tha4_tpu_torch.ops import cuda_siren, cuda_warp
    from tha4_tpu_torch.poser.modes import mode_12

    workdir = os.path.join(workdir, "face")
    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill"), seed=SEED, batch_size=BATCH))
    teacher_params = mode_12.init(torch.Generator().manual_seed(SEED + 7))
    total = STEPS * BATCH

    def jobs(prefix: str) -> DistillationJobs:
        os.makedirs(prefix, exist_ok=True)
        return DistillationJobs(
            dataclasses.replace(config, prefix=prefix), teacher_params_12=teacher_params, compute_dtype=torch.bfloat16,
            device="cuda", face_total_examples=total, examples_per_checkpoint=total // 2, examples_per_snapshot=total // 4,
        )

    run = jobs(os.path.join(workdir, "run"))
    trainer = run.make_face_trainer()
    trainer.cfg.log_every_seconds = 0.0  # a log row, and so a loss to check, every step
    counters = [cuda_siren.sine_chain_t, cuda_siren.sine_chain_t_bwd, cuda_warp.grid_sample_fast]
    reset(counters)
    result = trainer.train()
    return {"jobs": jobs, "run": run, "result": result, "launches": launches(counters), "prefix": trainer.cfg.prefix,
            "teacher_params": teacher_params, "workdir": workdir, "total": total}


def test_face_step_launches_k1_and_k4_once_and_k2_twice(face):
    assert face["launches"] == {"sine_chain_t": STEPS, "sine_chain_t_bwd": STEPS, "grid_sample_fast": 2 * STEPS}
    assert face["result"]["examples_seen"] == face["total"]


def test_face_training_logs_finite_losses_and_writes_loadable_checkpoints(face):
    rows = _log_rows(face["prefix"])
    assert len(rows) == STEPS and all(math.isfinite(r[k]) for r in rows for k in ("full", "eye_mouth", "loss"))
    assert _checkpoints_load(face["prefix"], face["total"])


def test_face_training_resumes_from_checkpoint_1(face):
    resumed = _resume(lambda prefix: face["jobs"](prefix).make_face_trainer(), face["prefix"], face["workdir"])
    diffs = [float((a - b).abs().max()) for a, b in zip(face["result"]["module"].state_dict().values(),
                                                       resumed["module"].state_dict().values())]
    assert resumed["examples_seen"] == face["total"] and max(diffs) <= RESUME_ATOL, max(diffs)


def test_face_f32_gradients_match_the_cpu_plain_backward(face):
    """K1 + K4 on the card against the plain backward on the CPU, with the
    same parameters, poses, labels and loss cotangent."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.ops import cuda_siren
    from tha4_tpu_torch.poser.modes import mode_12

    student, run = face["result"]["module"], face["run"]
    teacher32 = mode_12.FaceTeacher.from_params(face["teacher_params"]).freeze(torch.float32, "cuda")
    mask = torch.from_numpy(recipes.load_face_mask_crop(run.config.face_mask_image_file_name)).cuda()
    poses = sample_poses(torch.Generator().manual_seed(SEED + 9), BATCH).cuda()
    target = recipes.face_teacher_targets(teacher32, run.character_image(), poses, torch.float32)
    card = copy.deepcopy(student)
    pose = poses[:, : card.cfg.pose_size].float()
    pred = siren.siren_face_morpher_train_apply(card, pose, torch.float32)
    pred.retain_grad()
    loss, _ = recipes.face_loss_terms(pred, target, mask)
    loss.backward()
    s = card.cfg.image_size
    cot = pred.grad.permute(0, 3, 1, 2).reshape(BATCH, card.cfg.image_channels, s * s).contiguous().cpu()
    chain = copy.deepcopy(student).cpu().pack(torch.float32, "cpu")
    _, _, dw, db = cuda_siren.chain_t_bwd_plain(None, siren.pos_t(s, torch.float32, "cpu"), pose.cpu(), chain, cot)
    convs = [l.linear for l in card.siren.sine_layers] + [card.siren.last_linear]
    err = 0.0
    for conv, (ci, co, wo, bo) in zip(convs, chain.specs):
        for grad, ref in [(conv.weight.grad.reshape(-1), dw[wo : wo + co * ci]), (conv.bias.grad, db[bo : bo + co])]:
            err = max(err, float((grad.cpu() - ref).abs().max()) / max(float(ref.abs().max()), 1e-12))
    print(f"face f32 gradients, card vs CPU plain backward: scaled max err {err:.3e}")
    assert err <= STEP_F32_ATOL


# -- the body student ------------------------------------------------------------


@pytest.fixture(scope="module")
def body(workdir, teacher_params):
    """32 steps at batch 8 through ``make_body_trainer(phases).train()``,
    the six phases scaled to the run, logging every step, with the launches
    of every kernel a body step may take."""
    from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.distiller.pipeline import DistillationJobs
    from tha4_tpu_torch.ops import cuda_conv, cuda_poly_sin, cuda_siren, cuda_warp
    from tha4_tpu_torch.training.schedules import TrainingPhase, TrainingPhases

    workdir = os.path.join(workdir, "body")
    config = DistillerConfig.load(write_distiller_inputs(os.path.join(workdir, "distill"), seed=SEED, batch_size=BATCH))
    total = STEPS * BATCH
    # The reference's six phases, their bounds scaled from 1.5M examples to
    # this run's 256: the lr and the weights change at 34, 68, ... examples.
    phases = TrainingPhases([
        TrainingPhase(p.num_examples_upper_bound * total // recipes.BODY_MORPHER_TOTAL_EXAMPLES, p.learning_rate, dict(p.loss_weights))
        for p in recipes.default_body_phases().phases
    ])

    def jobs(prefix: str) -> DistillationJobs:
        os.makedirs(prefix, exist_ok=True)
        return DistillationJobs(
            dataclasses.replace(config, prefix=prefix), teacher_params_07=teacher_params, compute_dtype=torch.bfloat16,
            device="cuda", body_total_examples=total, examples_per_checkpoint=total // 2, examples_per_snapshot=total // 4,
        )

    run = jobs(os.path.join(workdir, "run"))
    trainer = run.make_body_trainer(phases)
    trainer.cfg.log_every_seconds = 0.0
    counters = [cuda_warp.grid_sample_fast, cuda_warp.grid_sample_train_forward, cuda_warp.grid_sample_grid_backward,
                cuda_poly_sin.poly_sin_forward, cuda_poly_sin.poly_sin_backward, cuda_siren.sine_chain_t,
                cuda_siren.sine_chain_t_bwd, cuda_conv.fused_affine_conv3_nchw, cuda_conv.fold_groupnorm_film]
    reset(counters)
    result = trainer.train()
    return {"jobs": jobs, "phases": phases, "run": run, "result": result, "launches": launches(counters),
            "prefix": trainer.cfg.prefix, "workdir": workdir, "total": total}


def test_body_step_launches(body):
    """K2 five times (the teacher's warps), K3's forward and grid backward
    once, each poly_sin kernel 9 times, K6 and its fold 102 times, K1 and
    K4 never."""
    assert body["launches"] == {
        "grid_sample_fast": 5 * STEPS, "grid_sample_train_forward": STEPS, "grid_sample_grid_backward": STEPS,
        "poly_sin_forward": 9 * STEPS, "poly_sin_backward": 9 * STEPS, "sine_chain_t": 0, "sine_chain_t_bwd": 0,
        "fused_affine_conv3_nchw": K6_PER_TEACHER_CALL * STEPS, "fold_groupnorm_film": K6_PER_TEACHER_CALL * STEPS,
    }
    assert body["result"]["examples_seen"] == body["total"]


def test_body_training_logs_finite_losses_across_the_phases_and_writes_loadable_checkpoints(body):
    from tha4_tpu_torch.distiller import recipes

    rows = _log_rows(body["prefix"])
    keys = (*recipes.BODY_LOSS_TERMS, "loss")
    assert len(rows) == STEPS and all(math.isfinite(r[k]) for r in rows for k in keys)
    lrs = sorted({r["lr"] for r in rows}, reverse=True)
    assert len(lrs) >= 3, f"the run crossed no phase change (lr {lrs})"
    assert _checkpoints_load(body["prefix"], body["total"])


def test_body_training_resumes_from_checkpoint_1(body):
    resumed = _resume(lambda prefix: body["jobs"](prefix).make_body_trainer(body["phases"]), body["prefix"], body["workdir"])
    diffs = [float((a - b).abs().max()) for a, b in zip(body["result"]["module"].state_dict().values(),
                                                       resumed["module"].state_dict().values())]
    assert resumed["examples_seen"] == body["total"] and max(diffs) <= RESUME_ATOL, max(diffs)


def test_body_f32_gradients_match_the_cpu_plain_backward(body, teacher_params):
    """The body student's f32 gradients on the card against the plain
    backward on the CPU, at B = 2, same labels (the card's f32 teacher) and
    poses, split at the head output: a bilinear sample's gradient jumps
    where its point crosses a texel edge, and a head output 1e-6 away on
    the CPU puts some points in another cell.  So the trunk (GEMMs,
    resizes, poly_sin kernels) is held on the card's head cotangent, and
    the head, K3 and the loss on the card's head output.  End to end, each
    device from its own head output, the gradients are held once the loss
    terms of the pixels where the loss is not smooth between the two
    devices' head outputs are dropped: the sample point lies in another
    texel, or an L1 term's prediction on the other side of its label.
    Every term of the body loss is per pixel, so that is their head
    cotangent zeroed.  The smooth pixels still carry the head outputs'
    difference, so the end-to-end comparison is held in two parts, each to
    a fixed bar: the card against the CPU's whole backward at the card's
    head output (the card's own share, ``STEP_MASKED_ATOL``), and the CPU's
    backward at the card's head output against at its own (what the head
    outputs' difference alone moves, ``STEP_DRIFT_ATOL``).  The end-to-end
    error is at most their sum."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.distiller.pose_dataset import sample_poses
    from tha4_tpu_torch.models import siren
    from tha4_tpu_torch.ops import warp
    from tha4_tpu_torch.poser.modes import mode_07

    student, image = body["result"]["module"], body["run"].character_image()
    teacher32 = mode_07.Teacher.from_params(teacher_params).freeze(torch.float32, "cuda")
    poses = sample_poses(torch.Generator().manual_seed(SEED + 30), 2).cuda()
    weights = recipes.default_body_phases().loss_weights(recipes.BODY_LOSS_TERMS, 500_000)
    # The labels in cuDNN's deterministic mode: some of its default f32
    # algorithms are not deterministic, and labels that move by ~3e-4 from
    # run to run move which pixels sit near a kink, and so this reading.
    torch.backends.cudnn.deterministic = True
    try:
        targets = recipes.body_teacher_targets(teacher32, image, poses, torch.float32)
    finally:
        torch.backends.cudnn.deterministic = False
    cpu_targets = [t.cpu() for t in targets]

    def scaled_err(grads, refs):
        return max(float((grads[k].cpu() - r.cpu()).abs().max()) / max(float(r.abs().max()), 1e-12) for k, r in refs.items())

    def head_cotangent(head, labels):
        leaf = head.detach().requires_grad_()
        recipes.body_loss_terms(siren.morpher_head(leaf, labels[3]), labels, weights)[0].backward()
        return leaf.grad

    def trunk_grads(module, head, cot):
        params = dict(module.named_parameters())
        return dict(zip(params, torch.autograd.grad(head, list(params.values()), cot, retain_graph=True)))

    def cells(h):
        # The source texel each output pixel samples, from the head's grid change.
        size = h.shape[1]
        grid = warp.identity_grid(size, size)[None] + h[..., 0:2]
        return torch.floor(((grid + 1.0) * size - 1.0) * 0.5)

    def sides(h, labels):
        # The side of its label each L1 term's prediction lies on (recipes.body_loss_terms).
        with torch.no_grad():
            outs = siren.morpher_head(h, labels[3])
        pairs = [(siren.SIREN_MORPHER_INDEX_BLENDED_IMAGE, 0), (siren.SIREN_MORPHER_INDEX_WARPED_IMAGE, 1),
                 (siren.SIREN_MORPHER_INDEX_GRID_CHANGE, 2), (siren.SIREN_MORPHER_INDEX_COLOR_CHANGE, 0)]
        return torch.cat([torch.sign(outs[i].float() - labels[j].float()).cpu() for i, j in pairs], dim=-1)

    card, cpu_student = copy.deepcopy(student), copy.deepcopy(student).cpu()
    head = siren.siren_morpher_train_head(card, poses, torch.float32)
    cpu_head = siren.siren_morpher_train_head(cpu_student, poses.cpu(), torch.float32)
    cot, cpu_cot = head_cotangent(head, targets), head_cotangent(cpu_head, cpu_targets)
    card_grads = trunk_grads(card, head, cot)
    trunk_err = scaled_err(card_grads, trunk_grads(cpu_student, cpu_head, cot.cpu()))
    cot_on_cpu = head_cotangent(head.cpu(), cpu_targets)
    head_err = scaled_err({"head": cot}, {"head": cot_on_cpu})
    same_texel = (cells(head.detach().cpu()) == cells(cpu_head.detach())).all(dim=-1, keepdim=True)
    same_side = (sides(head.detach(), targets) == sides(cpu_head.detach(), cpu_targets)).all(dim=-1, keepdim=True)
    smooth = same_texel & same_side
    masked_ref = trunk_grads(cpu_student, cpu_head, cpu_cot * smooth)
    card_masked = trunk_grads(card, head, cot * smooth.cuda())
    at_card_head = trunk_grads(cpu_student, cpu_head, cot_on_cpu * smooth)
    share_err = scaled_err(card_masked, at_card_head)
    drift_err = scaled_err(at_card_head, masked_ref)
    head_rows = float(card_grads["last_linear.weight"][0:2].abs().max())
    level_grads = [float(card_grads[f"siren_layers.{i}.0.linear.weight"].abs().max()) for i in range(len(student.siren_layers))]
    print(f"body f32 gradients at B=2: trunk {trunk_err:.3e}, head + K3 + loss {head_err:.3e}; "
          f"{int((~same_texel).sum())} sample points in another texel, {int((same_texel & ~same_side).sum())} more "
          f"pixels with an L1 term on the other side; the card's share {share_err:.3e}, the drift {drift_err:.3e}")
    assert max(trunk_err, head_err) <= STEP_F32_ATOL
    assert share_err <= STEP_MASKED_ATOL and drift_err <= STEP_DRIFT_ATOL
    assert head_rows > 0.0 and all(v > 0.0 for v in level_grads), "a zero gradient on the head's grid-change rows or a level"
