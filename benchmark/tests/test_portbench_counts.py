"""The yardstick's counts against hand counts at narrow widths."""

import math

from benchmark import counts, harness
from benchmark.reference import student14
from benchmark.tests import narrow

BENCH = harness.ROOT / "benchmark"


def test_chain_macs_and_bound_by_hand():
    layers = [(41, 16), (16, 16), (16, 4)]  # two sine layers and a head
    pixels = 128 * 128
    macs = counts.chain_macs(layers, pixels)
    assert macs == (41 * 16 + 16 * 16 + 16 * 4) * pixels
    nbytes, sines = 10_000.0, 32 * pixels
    f32 = counts.chain_bound_s(nbytes, macs, sines, "f32")
    assert math.isclose(f32, 2 * macs / 67e12 + sines * 20 / 33.5e12)
    bf16 = counts.chain_bound_s(nbytes, macs, sines, "bf16")
    assert math.isclose(bf16, max(2 * macs / 989e12, sines * 20 / 33.5e12))
    assert math.isclose(counts.chain_bound_s(1e12, 1, 1, "f32"), 1e12 / 3.35e12)


def test_the_frame_counts_by_hand():
    m = harness.load_module(BENCH / "configs" / "mode14_student.py")
    cfg = narrow.student_cfg()
    face = 128 * 128 * (41 * 16 + 2 * 16 * 16 + 16 * 4)
    l0 = 128 * 128 * (47 * 24 + 24 * 12)  # a level's last layer gives the next level's width
    l1 = 256 * 256 * (59 * 12 + 12 * 8)  # 12 + 2 + 45 in
    l2 = 512 * 512 * (55 * 8 + 8 * 8 + 8 * 7)  # 8 + 2 + 45 in, then the head
    assert m.per_unit(cfg, "f32")["flops"] == 2 * (face + l0 + l1 + l2)
    assert [(ci, co) for ci, co in student14.body_layers(cfg)[1]] == [(59, 12), (12, 8)]


def test_the_published_frame_is_chip_smokes_count():
    """At full width: 3.79e10 FLOPs a frame and K1's restated f32 bound of
    0.6441 ms (PERF.md, K1's row)."""
    m = harness.load_module(BENCH / "configs" / "mode14_student.py")
    u = m.per_unit(narrow.config("mode14_student"), "f32")
    assert u["flops"] == 37_885_313_024
    assert abs(u["bounds_s"]["K1 sine_chain"] * 1e3 - 0.6441) < 1e-4


def test_the_k6_sites_and_the_step_by_hand():
    m = harness.load_module(BENCH / "configs" / "mode07_body_distill.py")
    full = narrow.config("mode07_body_distill")
    _, sites = m.table(full)
    assert len(sites) == 102  # K6 launches a shipped mode_07 call (PERF.md)
    # The upscaler's last conv: GN -> SiLU -> 3x3 conv 32 -> 7 at 512^2, no skip.
    assert sites[-1] == (1, 32, 7, 512, 512, 0, False)
    n, cin, cout, h, w, cs, proj = sites[-1]
    u = m.per_unit(full)
    assert u["bounds_s"]["K6"] > counts.bound_s((cin + cout) * h * w * 8 * 2, 2 * 8 * h * w * cout * 9 * cin, "bf16")
    assert 5.9e12 < u["flops"] < 6.1e12  # ~5.2 TFLOP of teacher and ~0.8 of student a step
