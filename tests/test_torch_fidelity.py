"""The port's fidelity metrics against the JAX package's: both are the same
numpy code, so they agree to 1e-12 relative on seeded images."""

import numpy as np
import pytest

from tha4_tpu.utils import fidelity as jfidelity
from tha4_tpu_torch.utils import fidelity

RTOL = 1e-12


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0.0, 0.05, shape), -1.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 48, 4), (40, 40), (8, 9, 3)], ids=["rgba", "gray", "under-window"])
@pytest.mark.parametrize("name", ["psnr", "ssim_global", "ssim"])
def test_metrics_equal_jax(name, shape):
    a, b = _images(shape, seed=len(shape) * 7 + shape[0])
    ours, theirs = getattr(fidelity, name)(a, b), getattr(jfidelity, name)(a, b)
    assert np.isfinite(ours)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL)
    assert getattr(fidelity, name)(a, a) == getattr(jfidelity, name)(a, a)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_pose_suite_equals_jax(seed):
    ours, theirs = fidelity.random_pose_suite(16, seed), jfidelity.random_pose_suite(16, seed)
    assert ours.dtype == np.float32 and ours.shape == (16, 45)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL)
