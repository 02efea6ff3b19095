"""The native viseme solve (``tha4_tpu_torch/native/viseme.cpp``) against
the numpy loop it replaces (``solve_viseme_decomposition``), byte for byte:
the same BLAS routines on the same inputs and the same elementwise
operations give the same bits, so no tolerance is involved.

Needs ``g++``.
"""

import math

import numpy as np
import pytest

from tha4_tpu_torch.mocap import ifacialmocap_pose_converter as conv


def _seeded_points():
    return np.random.default_rng(2000).uniform(-0.1, 1.2, size=(2000, 4))


def _edge_points():
    """The self-check's probes, and points at and around the norm guard and
    the box's faces."""
    extra = [[1e-12, 0.0, 0.0, 0.0], [2e-12, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, -1e-13], [1.0, 1.0, 1.0, 1.0 + 1e-15],
             [-1.0, -1.0, -1.0, -1.0], [5.0, 5.0, 5.0, 5.0], [0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 0.25, 0.75]]
    return np.concatenate([conv._viseme_probes(), np.asarray(extra)])


def _stream_points():
    """The mouth points of a seeded 60 Hz, 60 s stream of jaw, lower-lip,
    funnel and pucker sines with noise, through the converter's default
    calibration; only the open-mouth packets (those that solve)."""
    rng = np.random.default_rng([18, 0x1F4C])
    t = np.arange(3600) / 60.0

    def sine(base, amp, periods, noise):
        wave = np.sin(2.0 * math.pi * t / rng.uniform(*periods) + rng.uniform(0.0, 2.0 * math.pi))
        return np.clip(base + amp * wave + noise * rng.standard_normal(t.size), 0.0, 1.0)

    jaw = sine(0.3, 0.25, (0.35, 0.7), 0.02)
    lower = np.clip(sine(0.2, 0.15, (0.5, 1.0), 0.01) + sine(0.2, 0.15, (0.5, 1.0), 0.01), 0.0, 1.0)
    funnel, pucker = sine(0.25, 0.2, (1.5, 3.0), 0.01), sine(0.15, 0.15, (2.0, 4.0), 0.01)
    mouth_open = np.clip((jaw - 0.1) / 0.3, 0.0, 1.0)
    points = np.stack([mouth_open, lower, funnel, pucker], axis=1)[::3]
    return points[points[:, 0] > 0.0]


@pytest.mark.parametrize("points", [_seeded_points, _edge_points, _stream_points],
                         ids=["seeded", "edges", "stream"])
def test_native_solve_equals_the_numpy_loop_byte_for_byte(points):
    pts = points()
    assert len(pts) >= {"_seeded_points": 2000, "_edge_points": 24, "_stream_points": 500}[points.__name__]
    for p in pts:
        native = conv.solve_viseme_decomposition_native(p)
        reference = conv.solve_viseme_decomposition(p)
        assert native.dtype == np.float64 and native.shape == (4,)
        assert native.tobytes() == reference.tobytes(), (p.tolist(), native.tolist(), reference.tolist())


def test_native_solve_keeps_the_iterations_and_step():
    """Other iteration counts and steps reach the same bits too, and zero
    iterations leave d at its start."""
    p = [0.7, 0.4, 0.3, 0.2]
    for iterations, lr in [(0, 0.02), (1, 0.02), (17, 0.05), (300, 0.02), (1000, 0.001)]:
        native = conv.solve_viseme_decomposition_native(p, iterations, lr)
        assert native.tobytes() == conv.solve_viseme_decomposition(p, iterations, lr).tobytes(), (iterations, lr)
    assert not conv.solve_viseme_decomposition_native(p, 0).any()
    with pytest.raises(ValueError):
        conv.solve_viseme_decomposition_native([0.1, 0.2, 0.3])
