"""The plain references against the port's plain paths on the CPU at
narrow widths (this file imports both)."""

import copy
import math

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.loops import mocap_live
from benchmark.reference import converter, student14, teacher07
from benchmark.tests import narrow

BENCH = harness.ROOT / "benchmark"


def test_the_converter_is_the_ports_bit_for_bit():
    from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter

    traffic = narrow.json.loads((BENCH / "traffic" / "live.f32.json").read_text())
    packets, stamps = mocap_live.stream(traffic, 2**31 + 1)
    port = IFacialMocapPoseConverter()
    for packet, now in list(zip(packets, stamps))[::97]:
        assert port.convert(packet, now=float(now)) == converter.convert(packet)


def test_the_student_frame_matches_the_ports():
    m = harness.load_module(BENCH / "configs" / "mode14_student.py")
    cfg = narrow.student_cfg()
    data = m.inputs(cfg, 2**31 + 2, "cpu")
    chain = m.program(cfg, data, "f32", "cpu")
    pose = np.random.default_rng(0).uniform(-0.5, 1.0, 45).astype(np.float32)
    outs = chain.pose(chain.image, pose)
    ref = student14.frame(cfg, {k: v.double() for k, v in data["weights"].items()}, data["image"].double()[None],
                          torch.from_numpy(pose).double()[None])
    for name, out in zip(m.OUTPUTS, outs):
        assert float((out.double() - ref[name]).abs().max()) < 1e-4, name
    assert int((chain.encode(outs[0])[0].int() - ref["display"][0].int()).abs().gt(1).sum()) < 50


def test_the_teacher_labels_match_the_ports():
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.poser.modes import mode_07

    m = harness.load_module(BENCH / "configs" / "mode07_body_distill.py")
    cfg = narrow.distill_cfg()
    data = m.inputs(cfg, 2**31 + 3, "cpu")
    # In float64: a random narrow teacher amplifies f32 rounding into 1e-3
    # label differences, which say nothing of the arithmetic.  The port's
    # identity grids stay f32, so the two agree to ~1e-5, not to f64's 1e-12.
    teacher = mode_07.Teacher.from_params(data["teacher"], m.teacher_config(cfg["teacher"])).freeze(torch.float64, "cpu")
    poses = m.pose_batch(cfg, 7, 0, 2).double()
    image = data["image"].double()
    port = recipes.body_teacher_targets(teacher, image[None], poses, torch.float64)
    weights = {net: {k: v.double() for k, v in d.items()} for net, d in data["teacher"].items()}
    with torch.no_grad():
        ref = teacher07.labels(teacher07.Weights(weights), cfg["teacher"], image.permute(2, 0, 1)[None].expand(2, -1, -1, -1), poses)
    for a, b in zip(port, ref):
        assert float((a - b.permute(0, 2, 3, 1)).abs().max()) < 1e-4
    # The labels are not degenerate: the grid changes move pixels.
    assert float(ref[2].abs().max()) > 1e-4


def test_each_teacher_network_alone_matches_the_ports():
    """The reference networks on the inputs that the port gave each, as the
    check holds them, against the port's outputs as the tap keeps them:
    every output of every network, in the tap's order."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.poser.modes import mode_07

    m = harness.load_module(BENCH / "configs" / "mode07_body_distill.py")
    cfg = narrow.distill_cfg()
    data = m.inputs(cfg, 2**31 + 5, "cpu")
    teacher = mode_07.Teacher.from_params(data["teacher"], m.teacher_config(cfg["teacher"])).freeze(torch.float64, "cpu")
    poses = m.pose_batch(cfg, 8, 0, 2).double()
    got = []
    with m.teacher_tap(got):
        recipes.body_teacher_targets(teacher, data["image"].double()[None], poses, torch.float64)
    weights = {net: {k: v.double() for k, v in d.items()} for net, d in data["teacher"].items()}
    image = data["image"].double().permute(2, 0, 1)[None].expand(2, -1, -1, -1)
    with torch.no_grad():
        ref = teacher07.stages(teacher07.Weights(weights), cfg["teacher"], image, poses, got[0])
    assert [len(got[0][s]) for s in teacher07.STAGES] == [6, 8, 9, 5, 5]
    for stage in teacher07.STAGES:
        for i, (a, b) in enumerate(zip(got[0][stage], ref[stage])):
            assert a.shape == b.shape and float((a - b).abs().max()) < 1e-4, (stage, i)


def test_the_full_width_teacher_draws_flows_of_pixels():
    """The seeded full-width teacher's grid-change weights are the scaled
    ones (a few pixels at 512^2 on a trained teacher's scale)."""
    m = harness.load_module(BENCH / "configs" / "mode07_body_distill.py")
    cfg = narrow.config("mode07_body_distill")
    shapes, _ = m.table(cfg)
    a = cfg["assumed"]
    assert m._teacher_init("upscaler.body.last.2.weight", shapes["upscaler.body.last.2.weight"], shapes, a) == ("n", a["head_std"])
    assert m._teacher_init("face_morpher.iris_mouth_grid_change.weight", (2, 64, 3, 3), shapes, a) == ("n", a["flow_std"])
    key = "upscaler.body.down_blocks.0.res_blocks.0.conv1.weight"
    assert m._teacher_init(key, shapes[key], shapes, a) == ("u", a["residual_scale"] / math.sqrt(32 * 9))
    assert m._teacher_init("upscaler.body.last.0.weight", shapes["upscaler.body.last.0.weight"], shapes, a) == ("c", 1.0)


def test_the_student_training_step_matches_the_ports():
    """The reference student's loss and first gradient against the port's
    training path on the same labels, in float64 and on the smooth
    character (a warp sample point within rounding of a texel edge takes
    another cell on either side, and the gradient jumps there: ~1e-3 of a
    leaf end to end, PERF.md)."""
    from tha4_tpu_torch.distiller import recipes
    from tha4_tpu_torch.models import siren

    m = harness.load_module(BENCH / "configs" / "mode07_body_distill.py")
    cfg = narrow.distill_cfg()
    data = m.inputs(cfg, 2**31 + 4, "cpu")
    student = siren.SirenMorpher(m.student_config(cfg["student"])).double()
    student.load_state_dict({k[5:]: (v[:, :, None, None] if v.dim() == 2 else v).double() for k, v in data["student"].items()})
    poses = m.pose_batch(cfg, 9, 0, 2).double()
    torch.manual_seed(0)
    labels = [torch.rand(2, 512, 512, c, dtype=torch.float64) * 2 - 1 for c in (4, 4, 2)]
    labels[2] = labels[2] * 0.02
    labels.append(data["image"].double()[None].expand(2, -1, -1, -1).contiguous())
    _, weights = m.phase_at(cfg, 0)
    total, _ = recipes.body_loss(student, labels, poses, weights, torch.float64, False)
    total.backward()
    params = {k: v.double().clone().requires_grad_(True) for k, v in data["student"].items()}
    out = student14.body(cfg["student"], params, labels[3], poses)
    ref = (weights["full_blended"] * (labels[0] - out["blended"]).abs().mean()
           + weights["full_warped"] * (labels[1] - out["warped"]).abs().mean()
           + weights["full_grid_change"] * (labels[2] - out["grid_change"]).abs().mean()
           + weights["full_color_change"] * (labels[0] - out["color_change"]).abs().mean())
    ref.backward()
    assert abs(float(total.detach()) - float(ref.detach())) < 1e-6 * float(ref.detach())
    for name, p in student.named_parameters():
        g = params["body." + name].grad
        assert float((p.grad.reshape(g.shape) - g).norm()) < 1e-3 * float(g.norm()) + 1e-7, name
