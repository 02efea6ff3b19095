"""The port's profiling utilities (``tha4_tpu_torch.utils.profiling``) on the
CPU: the frame timer's window and barrier, the trace file, and the
program's spans: free with no profiler running, and under one placed where
the work happens, in order, without changing a bit of what the program
computes."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tha4_tpu_torch.charmodel.synthetic import random_teacher_07, synthetic_character_image
from tha4_tpu_torch.distiller import pose_dataset, recipes
from tha4_tpu_torch.mocap.ifacialmocap import create_default_ifacialmocap_pose
from tha4_tpu_torch.mocap.ifacialmocap_pose_converter import IFacialMocapPoseConverter
from tha4_tpu_torch.models import body_morpher, eyebrow, face_morpher, siren, unet, upscaler
from tha4_tpu_torch.poser.modes import mode_07, mode_14
from tha4_tpu_torch.utils import profiling

MODE07 = ["mode07.decomposer", "mode07.combiner", "mode07.face_morpher", "mode07.body_morpher", "mode07.upscaler"]
SMALL = dict(start_channels=4, num_bottleneck_blocks=1, max_channels=8)
LEVELS = ((128, 16, 2), (256, 8, 2), (512, 8, 2))


def test_frame_timer_keeps_a_rolling_window():
    timer = profiling.FrameTimer(window=3)
    assert timer.fps is None
    for k in range(5):
        out = timer.measure(lambda x: [x * 2.0, {"y": x}], torch.full((4,), float(k)))
        assert timer.last_ms is not None and timer.last_ms >= 0.0
    assert torch.equal(out[0], torch.full((4,), 8.0))
    assert len(timer.times) == 3 and timer.fps > 0.0


def test_frame_timer_ticks_as_the_puppeteers_fps_meter():
    timer = profiling.FrameTimer(window=3)
    assert timer.tick() is None
    rates = [timer.tick() for _ in range(4)]
    assert all(r > 0.0 for r in rates) and rates[-1] == timer.fps
    assert len(timer.times) == 3 and timer.last_ms is None


def test_fetch_barrier_takes_any_nesting_of_cpu_results():
    profiling.fetch_barrier([{"a": (torch.ones(2),)}])
    profiling.fetch_barrier({"none": None})
    profiling.fetch_barrier(3.0)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("test.matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(open(os.path.join(tmp_path, "trace", "trace.json")).read())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.get("name") == "tha4:test.matmul" for e in events)
    assert prof.key_averages() is not None


def test_span_without_a_profiler_builds_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("mode14.upload")
    with first:
        pass
    assert all(profiling.span(name) is first for name in ["distill.labels", "ifm.viseme_solve", "mode14.upload"])


def _spans(prof) -> list:
    """(name, start_ns, end_ns) of the program's spans, by start."""
    out = [(e.name()[len(profiling.SPAN_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name().startswith(profiling.SPAN_PREFIX)]
    return sorted(out, key=lambda s: s[1])


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, _spans(prof)


@pytest.fixture(scope="module")
def body_group():
    """A narrow mode_07 teacher frozen in f32, a narrow body student, the
    character and one batch of two poses; ``run(profiled)`` makes a fresh
    student and optimizer and runs one group on them."""
    un = unet.UnetConfig(
        in_channels=4, out_channels=7, model_channels=8, level_channel_multipliers=(1, 1, 1, 2, 2),
        level_use_attention=(False, False, False, False, True), num_res_blocks_per_level=1, num_middle_res_blocks=2,
        cond_input_channels=6, cond_internal_channels=16, attention=unet.AttentionConfig(num_heads=2, use_new_attention_order=True),
    )
    tcfg = mode_07.TeacherConfig(
        eyebrow_decomposer=eyebrow.EyebrowDecomposerConfig(**SMALL), eyebrow_combiner=eyebrow.EyebrowCombinerConfig(**SMALL),
        face_morpher=face_morpher.FaceMorpherConfig(**SMALL), body_morpher=body_morpher.BodyMorpherConfig(unet=un),
        upscaler=upscaler.UpscalerConfig(unet=un),
    )
    teacher = mode_07.Teacher.from_params(random_teacher_07(torch.Generator().manual_seed(17), tcfg), tcfg).freeze(torch.float32, "cpu")
    image = torch.from_numpy(synthetic_character_image(512, 3).astype(np.float32) / 127.5 - 1.0)[None]
    poses = pose_dataset.sample_poses(torch.Generator().manual_seed(8), 2)
    weights = recipes.default_body_phases().loss_weights(recipes.BODY_LOSS_TERMS, 0)
    group = recipes.make_body_distill_group(teacher, image, torch.float32)
    scfg = siren.SirenMorpherConfig(image_size=512, levels=tuple(siren.SirenMorpherLevelConfig(*l) for l in LEVELS))

    def run(profiled: bool):
        student = siren.SirenMorpher(scfg, generator=torch.Generator().manual_seed(5))
        optimizer = recipes.make_adam(student)
        args = (student, optimizer, [poses], [1e-4], [weights])
        named, spans = _profiled(group, *args) if profiled else (group(*args), None)
        return named, {k: p.detach().clone() for k, p in student.named_parameters()}, spans

    return run


def test_body_group_spans_are_placed_in_order(body_group):
    """One group under a profiler: the labels, with the teacher's five
    networks inside them in order, then the gradients zeroed, the forward,
    the backward and the update."""
    _, _, spans = body_group(True)
    top = [s for s in spans if not s[0].startswith("mode07.")]
    assert [s[0] for s in top] == ["distill.labels", "distill.adam", "distill.forward", "distill.backward", "distill.adam"]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    labels = top[0]
    nets = [s for s in spans if s[0].startswith("mode07.")]
    assert [s[0] for s in nets] == MODE07
    assert all(labels[1] <= s[1] and s[2] <= labels[2] for s in nets)
    assert all(a[2] <= b[1] for a, b in zip(nets, nets[1:]))


def test_body_group_is_bit_equal_with_and_without_the_profiler(body_group):
    named_a, params_a, _ = body_group(False)
    named_b, params_b, _ = body_group(True)
    assert named_a.keys() == named_b.keys()
    assert all(torch.equal(named_a[k], named_b[k]) for k in named_a)
    assert all(torch.equal(params_a[k], params_b[k]) for k in params_a)


def test_frame_spans_and_outputs_bit_equal_under_the_profiler():
    """The converter's viseme solve, the pose's upload and the frame's
    compute, each once a frame; the pose and six outputs bit-equal with and
    without the profiler."""
    face_cfg = siren.SirenFaceMorpherConfig(siren=siren.SirenConfig(41, 4, 16, 3))
    body_cfg = siren.SirenMorpherConfig(levels=tuple(siren.SirenMorpherLevelConfig(*l) for l in LEVELS))
    gen = torch.Generator().manual_seed(3)
    poser = mode_14.StudentPoser(siren.SirenFaceMorpher(face_cfg, generator=gen), siren.SirenMorpher(body_cfg, generator=gen),
                                 device="cpu")
    image = torch.from_numpy(synthetic_character_image(512, 4).astype(np.float32) / 127.5 - 1.0)
    converter = IFacialMocapPoseConverter()
    packet = create_default_ifacialmocap_pose()
    packet.update(jawOpen=0.6, mouthFunnel=0.3, mouthPucker=0.2, mouthLowerDownLeft=0.4, mouthSmileLeft=0.2)  # the mouth open: the solve runs

    def frame():
        pose = converter.convert(packet, now=1.0)
        return pose, poser.get_posing_outputs(image, np.asarray(pose, np.float32))

    pose_a, outs_a = frame()
    (pose_b, outs_b), spans = _profiled(frame)
    assert [s[0] for s in spans] == ["ifm.viseme_solve", "mode14.upload", "mode14.compute"]
    assert pose_a == pose_b
    assert len(outs_a) == len(outs_b) == mode_14.OUTPUT_LENGTH
    assert all(torch.equal(a, b) for a, b in zip(outs_a, outs_b))
