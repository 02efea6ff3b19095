"""Fidelity metrics between rendered frames: PSNR and SSIM (counterpart of the
numpy parts of ``tha4_tpu/utils/fidelity.py``).

``ssim`` is the standard gaussian-windowed form (Wang et al.);
``ssim_global`` is the cheap single-window variant kept only for regression
tracking.  ``random_pose_suite`` draws a seeded pose set over the schema's
ranges.  All of it is numpy: tensors are brought to the host by the caller.
The JAX package's LPIPS (``lpips``, its proxy ``lpips_proxy``) and
``compare_posers`` are not ported yet.
"""

from __future__ import annotations

import numpy as np

SIGNAL_RANGE = 2.0  # model units are [-1, 1]


def psnr(a: np.ndarray, b: np.ndarray, signal_range: float = SIGNAL_RANGE) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(signal_range ** 2 / mse)


def ssim_global(a: np.ndarray, b: np.ndarray, signal_range: float = SIGNAL_RANGE) -> float:
    """GLOBAL-statistics SSIM: one window covering the whole image.

    NOT the standard (Wang et al.) windowed SSIM — it is far more forgiving
    of local errors and is only kept as a cheap regression scalar for
    near-identical renders.  Use :func:`ssim` (windowed) for any claim of
    fidelity."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * signal_range) ** 2
    c2 = (0.03 * signal_range) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    )


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _filter2_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' gaussian filter over the leading two (H, W) axes of
    an (H, W, C) array, pure numpy (no scipy dependency in the hot path)."""
    size = k.shape[0]
    # rows
    out = np.zeros((img.shape[0] - size + 1,) + img.shape[1:], np.float64)
    for i in range(size):
        out += k[i] * img[i : i + out.shape[0]]
    # cols
    out2 = np.zeros((out.shape[0], out.shape[1] - size + 1) + out.shape[2:], np.float64)
    for i in range(size):
        out2 += k[i] * out[:, i : i + out2.shape[1]]
    return out2


def ssim(
    a: np.ndarray,
    b: np.ndarray,
    signal_range: float = SIGNAL_RANGE,
    window_size: int = 11,
    sigma: float = 1.5,
) -> float:
    """Standard windowed SSIM (Wang et al. 2004): 11x11 gaussian window,
    sigma 1.5, 'valid' padding, averaged over pixels and channels.

    Matches skimage.metrics.structural_similarity(gaussian_weights=True,
    use_sample_covariance=False) up to boundary handling.  Inputs are HWC (or
    HW) in model units; ``signal_range`` is the dynamic range (2.0 for
    [-1, 1] tensors)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    if min(a.shape[0], a.shape[1]) < window_size:
        return ssim_global(a, b, signal_range)
    k = _gaussian_kernel1d(window_size, sigma)
    c1 = (0.01 * signal_range) ** 2
    c2 = (0.03 * signal_range) ** 2
    mu_a = _filter2_valid(a, k)
    mu_b = _filter2_valid(b, k)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    var_a = _filter2_valid(a * a, k) - mu_aa
    var_b = _filter2_valid(b * b, k) - mu_bb
    cov = _filter2_valid(a * b, k) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    )
    return float(ssim_map.mean())


def random_pose_suite(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic pose set covering the schema ranges."""
    from tha4_tpu_torch.poser.modes.pose_parameters import get_pose_parameters

    pp = get_pose_parameters()
    rng = np.random.default_rng(seed)
    poses = rng.uniform(0, 1, (n, pp.get_parameter_count())).astype(np.float32)
    for group in pp.get_pose_parameter_groups():
        lo, hi = group.get_range()
        for k in range(group.arity):
            idx = group.parameter_index + k
            poses[:, idx] = poses[:, idx] * (hi - lo) + lo
    return poses
