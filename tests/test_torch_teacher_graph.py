"""mode_07's call as a CUDA graph: what the CPU can hold of it.

A CPU call stays eager and gives the body's outputs bit for bit; the rule
that decides whether a graph may take a call (``mode_07.refusal``); the
signature that keys a teacher's graphs; the bookkeeping of
``compute_outputs`` (warm-up, capture, replays), its bound and ``freeze``
with the graph and the body stubbed, since a graph needs the card.  The
card holds the replays themselves: ``tests/test_torch_card_teacher.py``.
"""

import pytest
import torch

from tha4_tpu_torch.models import body_morpher, eyebrow, face_morpher, unet, upscaler
from tha4_tpu_torch.ops import quant
from tha4_tpu_torch.poser.modes import mode_07

torch.set_num_threads(2)

SMALL = dict(start_channels=4, num_bottleneck_blocks=1, max_channels=8)


def _tiny_teacher_config() -> mode_07.TeacherConfig:
    """The five networks at the widths of tests/test_torch_body_teacher.py,
    at the real image geometry."""
    un = unet.UnetConfig(
        in_channels=4, out_channels=7, model_channels=8, level_channel_multipliers=(1, 1, 1, 2, 2),
        level_use_attention=(False, False, False, False, True), num_res_blocks_per_level=1, num_middle_res_blocks=2,
        cond_input_channels=6, cond_internal_channels=16, attention=unet.AttentionConfig(num_heads=2, use_new_attention_order=True))
    return mode_07.TeacherConfig(
        eyebrow_decomposer=eyebrow.EyebrowDecomposerConfig(**SMALL), eyebrow_combiner=eyebrow.EyebrowCombinerConfig(**SMALL),
        face_morpher=face_morpher.FaceMorpherConfig(**SMALL), body_morpher=body_morpher.BodyMorpherConfig(unet=un),
        upscaler=upscaler.UpscalerConfig(unet=un))


@pytest.fixture(scope="module")
def tiny():
    """A frozen tiny random teacher and one call's inputs: the image
    expanded to B = 2 as the recipe passes it, and two poses."""
    from tha4_tpu_torch.charmodel.synthetic import random_teacher_07

    cfg = _tiny_teacher_config()
    teacher = mode_07.Teacher.from_params(random_teacher_07(torch.Generator().manual_seed(7), cfg), cfg)
    teacher.freeze(torch.float32, "cpu")
    gen = torch.Generator().manual_seed(8)
    image = (torch.rand((1, 512, 512, 4), generator=gen) * 2.0 - 1.0).expand(2, -1, -1, -1)
    pose = torch.rand((2, 45), generator=gen)
    return teacher, image, pose


@pytest.fixture
def counts():
    mode_07.counts.reset()
    yield mode_07.counts
    mode_07.counts.reset()


def test_a_cpu_call_stays_eager_and_is_the_body_bit_for_bit(tiny, counts):
    teacher, image, pose = tiny
    with torch.no_grad():
        got = mode_07.compute_outputs(teacher, image, pose)
        again = mode_07.compute_outputs(teacher, image, pose)
        body = mode_07._compute_outputs(teacher, image, pose)
    assert len(got) == mode_07.OUTPUT_LENGTH
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, again, body))
    assert (counts.eager_calls, counts.captures, counts.replays) == (2, 0, 0)
    assert teacher not in mode_07._graphs


def _inputs(n=2, dtype=torch.float32, device="cpu"):
    return (torch.zeros((1, 512, 512, 4), dtype=dtype, device=device).expand(n, -1, -1, -1),
            torch.zeros((n, 45), dtype=dtype, device=device))


@pytest.mark.parametrize("case,want", [
    ("input requires grad", "grad"),
    ("int8 scales active", "quant"),
    ("a calibration active", "quant"),
    ("a CPU input", "device"),
    ("a meta input", "device"),
])
def test_the_rule_refuses(case, want):
    image, pose = _inputs(device="meta" if case == "a meta input" else "cpu")
    if case == "input requires grad":
        pose = pose.clone().requires_grad_(True)
    if case == "int8 scales active":
        with quant.apply_scales([]):
            got = mode_07.refusal((image, pose))
    elif case == "a calibration active":
        with quant.calibrate():
            got = mode_07.refusal((image, pose))
    else:
        got = mode_07.refusal((image, pose))
    assert got == want


def _variant(case):
    """A call's inputs and whether the decomposer's outputs are given, one
    thing changed from ``_inputs()``."""
    image, pose = _inputs()
    if case == "the same layout, new tensors":
        return _inputs(), False
    if case == "batch":
        return _inputs(n=4), False
    if case == "dtype":
        return _inputs(dtype=torch.bfloat16), False
    if case == "strides":
        return (image.contiguous(), pose), False
    if case == "decomposer given":
        dec = tuple(torch.zeros((2, 128, 128, 4)) for _ in range(6))
        return (image, pose, *dec), True
    raise ValueError(case)


@pytest.mark.parametrize("case,same", [
    ("the same layout, new tensors", True),
    ("batch", False),
    ("dtype", False),
    ("strides", False),
    ("decomposer given", False),
])
def test_the_signature_separates_shape_dtype_strides_and_the_decomposer(case, same):
    base = mode_07.signature(_inputs(), False)
    inputs, given = _variant(case)
    assert (mode_07.signature(inputs, given) == base) == same


def test_the_signature_separates_the_backend_flags():
    base = mode_07.signature(_inputs(), False)
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not before
    try:
        flipped = mode_07.signature(_inputs(), False)
    finally:
        torch.backends.cudnn.deterministic = before
    with torch.inference_mode():
        inference = mode_07.signature(_inputs(), False)
    assert flipped != base and inference != base and mode_07.signature(_inputs(), False) == base


class _FakeGraph:
    """Stands in for ``_TeacherGraph``: records its captures and replays."""

    made = []

    def __init__(self, teacher, inputs, decomposer_given):
        self.replays = 0
        _FakeGraph.made.append(self)

    def replay(self, inputs):
        self.replays += 1
        return ("replayed", inputs[0].shape[0])


@pytest.fixture
def stubbed(monkeypatch, counts):
    """``compute_outputs`` on CPU tensors as on the card: the rule lets
    every call through, the body and the graph are stubs."""
    _FakeGraph.made = []
    monkeypatch.setattr(mode_07, "refusal", lambda inputs: None)
    monkeypatch.setattr(mode_07, "_compute_outputs", lambda teacher, image, pose, dec=None: ("eager", image.shape[0]))
    monkeypatch.setattr(mode_07, "_TeacherGraph", _FakeGraph)
    teacher = mode_07.Teacher(_tiny_teacher_config())
    yield teacher
    mode_07._graphs.pop(teacher, None)


def test_a_signature_warms_up_then_captures_then_replays(stubbed, counts):
    got = [mode_07.compute_outputs(stubbed, *_inputs()) for _ in range(6)]
    assert got == [("eager", 2)] + [("replayed", 2)] * 5
    assert (counts.eager_calls, counts.captures, counts.replays) == (1, 1, 4)
    assert len(_FakeGraph.made) == 1 and _FakeGraph.made[0].replays == 5


def test_the_signatures_stay_bounded_least_recently_used_first(stubbed, counts):
    sizes = range(1, mode_07.MAX_SIGNATURES + 3)
    for n in sizes:
        mode_07.compute_outputs(stubbed, *_inputs(n))
        mode_07.compute_outputs(stubbed, *_inputs(1))  # B = 1 stays the most recently used
    kept = mode_07._graphs[stubbed]
    assert len(kept) == mode_07.MAX_SIGNATURES
    assert mode_07.signature(_inputs(1), False) in kept and mode_07.signature(_inputs(2), False) not in kept
    assert mode_07.compute_outputs(stubbed, *_inputs(2)) == ("eager", 2)  # dropped: warmed up again


def test_freeze_drops_the_teachers_graphs(stubbed, counts):
    for _ in range(3):
        mode_07.compute_outputs(stubbed, *_inputs())
    assert mode_07._graphs[stubbed][mode_07.signature(_inputs(), False)] is _FakeGraph.made[0]
    stubbed.freeze(torch.float32, "cpu")
    assert stubbed not in mode_07._graphs
    assert mode_07.compute_outputs(stubbed, *_inputs()) == ("eager", 2)


@pytest.mark.parametrize("case", ["expanded image", "channel slice", "pose rows"])
def test_a_graphs_own_input_is_laid_out_as_the_call_and_takes_its_copy(case):
    """``_like`` keeps shape, strides and storage offset; ``_dense`` writes
    a broadcast dimension once."""
    base = torch.arange(3 * 8 * 6 * 4, dtype=torch.float32).reshape(3, 8, 6, 4)
    t = {"expanded image": base[:1].expand(5, -1, -1, -1), "channel slice": base[..., 1:3],
         "pose rows": base.reshape(-1, 8)[5:9]}[case]
    own = mode_07._like(t)
    assert (own.shape, own.stride(), own.storage_offset(), own.dtype) == (t.shape, t.stride(), t.storage_offset(), t.dtype)
    mode_07._dense(own).copy_(mode_07._dense(t))
    assert torch.equal(own, t)
    assert mode_07._dense(t).shape == ((1, 8, 6, 4) if case == "expanded image" else t.shape)
