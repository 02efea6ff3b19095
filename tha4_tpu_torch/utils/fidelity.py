"""Fidelity metrics between rendered frames: PSNR, windowed SSIM, LPIPS and a
self-contained perceptual proxy (counterpart of ``tha4_tpu/utils/fidelity.py``).

``ssim`` is the standard gaussian-windowed form (Wang et al.);
``ssim_global`` is the cheap single-window variant kept only for regression
tracking.  ``lpips`` is a weights-file hook for true AlexNet-LPIPS (None
without the file); ``lpips_proxy`` is an LPIPS-shaped distance over a
fixed-seed random conv stack, the JAX package's own weights, drawn here in
numpy (``utils/threefry.py``) from the same key.  ``random_pose_suite``
draws a seeded pose set over the schema's ranges; ``compare_posers`` and
``compare_with_reference`` hold two posers, or a character model against the
original PyTorch implementation where its source is mounted, frame by frame.
PSNR and SSIM are numpy (tensors come to the host); the proxy runs on the
frames' device.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

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


def _host(frame) -> np.ndarray:
    """A frame as f32 numpy (a tensor is brought to the host)."""
    if hasattr(frame, "detach"):
        frame = frame.detach().float().cpu().numpy()
    return np.asarray(frame, np.float32)


# ---------------------------------------------------------------------------
# LPIPS (weights-optional hook): the JAX package's torch code, as it is
# ---------------------------------------------------------------------------

def lpips(a, b, weights_file: Optional[str] = None) -> Optional[float]:
    """LPIPS(alex) distance between two HWC images in [-1, 1] model units.

    ``weights_file``: torch state dict of the official lpips.LPIPS(net='alex')
    module (keys ``net.slice*.*.weight`` for the AlexNet trunk and
    ``lin*.model.1.weight`` for the calibration 1x1 convs).  Returns None when
    no weights file is given/found — LPIPS is unavailable, not zero.  Runs on
    the CPU in f32, as the JAX package's does."""
    if weights_file is None or not os.path.isfile(weights_file):
        return None
    import torch
    import torch.nn.functional as F

    sd = torch.load(weights_file, map_location="cpu", weights_only=True)

    def get(k):
        if k not in sd:
            raise KeyError(
                f"LPIPS weights file missing key {k!r}; expected the state "
                "dict of lpips.LPIPS(net='alex') from the official package"
            )
        return sd[k]

    # AlexNet features: conv indices within torchvision features (0,3,6,8,10),
    # grouped by the lpips package into slice1..slice5 (keys keep the
    # original indices).
    convs = [(1, 0), (2, 3), (3, 6), (4, 8), (5, 10)]

    def prep(x):
        # HWC [-1,1] model units (premultiplied RGBA) -> RGB NCHW in the
        # lpips 'scaling layer' normalization.
        x = _host(x)[..., :3]
        t = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (2, 0, 1))))[None]
        shift = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
        scale = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)
        return (t - shift) / scale

    def features(t):
        feats = []
        h = t
        pools_before = {3, 6}  # maxpool precedes convs at indices 3 and 6
        for si, ci in convs:
            if ci in pools_before:
                h = F.max_pool2d(h, 3, stride=2)
            w = get(f"net.slice{si}.{ci}.weight")
            bias = get(f"net.slice{si}.{ci}.bias")
            stride = 4 if ci == 0 else 1
            pad = 2 if ci == 0 else (2 if ci == 3 else 1)
            h = F.relu(F.conv2d(h, w, bias, stride=stride, padding=pad))
            feats.append(h)
        return feats

    with torch.no_grad():
        fa = features(prep(a))
        fb = features(prep(b))
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (xa.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            nb = xb / (xb.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            lin = get(f"lin{i}.model.1.weight")
            d = F.conv2d((na - nb).square(), lin)
            total += float(d.mean())
    return total


# ---------------------------------------------------------------------------
# Self-contained perceptual proxy (no pretrained weights needed)
# ---------------------------------------------------------------------------

# An LPIPS-shaped distance over a FIXED-SEED random VGG-style stack (the JAX
# package's module comment, tha4_tpu/utils/fidelity.py:197-212, has the
# literature): deep feature maps, per-channel unit normalization, squared
# differences averaged over space and layers.  A PROXY: good for relative
# comparisons, not calibrated to human judgments like true AlexNet-LPIPS.

_PROXY_CHANNELS = (16, 32, 64, 96, 128)
_PROXY_SEED = 20260817
_proxy_cache: Dict[str, list] = {}


def proxy_weights() -> List[np.ndarray]:
    """The stack's 3x3 He-init kernels, HWIO f32: ``jax.random.PRNGKey(
    20260817)``, then per layer ``key, k = split(key)`` and ``normal(k, (3,
    3, cin, cout)) * sqrt(2 / (9 cin))``, drawn in numpy."""
    from tha4_tpu_torch.utils import threefry

    if "numpy" not in _proxy_cache:
        key = threefry.prng_key(_PROXY_SEED)
        weights, cin = [], 3
        for cout in _PROXY_CHANNELS:
            key, k = threefry.split(key)
            weights.append(threefry.normal(k, (3, 3, cin, cout)) * np.float32(np.sqrt(2.0 / (9 * cin))))
            cin = cout
        _proxy_cache["numpy"] = weights
    return _proxy_cache["numpy"]


def _same_stride2(x, w):
    """conv(x, w), stride 2, XLA's "SAME" padding: the lower half of the
    total padding before, the rest after (0 before and 1 after on an even
    side)."""
    import torch.nn.functional as F

    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad wants the last axis first
        total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=2)


def lpips_proxy(a, b) -> float:
    """Perceptual distance between two HWC images in [-1, 1] model units via
    the fixed-seed RANDOM-feature LPIPS proxy: zero external weights,
    deterministic.  Scale is its own (roughly: <0.005 visually identical,
    >0.05 clearly different); only compare lpips_proxy values with each
    other.  Numpy frames run on the CPU, tensors on the first frame's
    device, in full f32 (no TF32)."""
    import torch

    def prep(x):
        t = x.detach().float() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
        if t.dim() == 2:
            t = t[..., None]
        if t.shape[-1] < 3:  # grayscale -> broadcast to RGB
            t = t[..., :1].expand(*t.shape[:-1], 3)
        return t[..., :3].permute(2, 0, 1)[None].contiguous()

    ha = prep(a)
    hb = prep(b).to(ha.device)
    weights = [torch.from_numpy(w).permute(3, 2, 0, 1).to(ha.device) for w in proxy_weights()]
    total = ha.new_zeros(())
    allow_tf32, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, False
    try:
        with torch.no_grad():
            for w in weights:
                ha, hb = torch.relu(_same_stride2(ha, w)), torch.relu(_same_stride2(hb, w))
                na = ha * torch.rsqrt((ha * ha).sum(dim=1, keepdim=True) + 1e-10)
                nb = hb * torch.rsqrt((hb * hb).sum(dim=1, keepdim=True) + 1e-10)
                total = total + ((na - nb) ** 2).sum(dim=1).mean()
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    return float(total / len(weights))


def _stats(psnrs, ssims, proxies, lpipss) -> Dict:
    out = {
        "psnr_mean": float(np.mean(psnrs)),
        "psnr_min": float(np.min(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
        "lpips_proxy_mean": float(np.mean(proxies)),
        "frames": len(psnrs),
    }
    if lpipss:
        out["lpips_mean"] = float(np.mean(lpipss))
    return out


def compare_posers(poser_a, poser_b, image, poses: np.ndarray, output_index: int = 0,
                   lpips_weights: Optional[str] = None) -> Dict:
    """Frame-by-frame PSNR / windowed-SSIM / random-feature perceptual proxy
    (+ true LPIPS when weights are given) between two Poser implementations."""
    psnrs, ssims, proxies, lpipss = [], [], [], []
    for pose in poses:
        ta, tb = poser_a.pose(image, pose, output_index), poser_b.pose(image, pose, output_index)
        fa, fb = _host(ta), _host(tb)
        psnrs.append(psnr(fa, fb))
        ssims.append(ssim(np.squeeze(fa), np.squeeze(fb)))
        proxies.append(lpips_proxy(ta.squeeze(), tb.squeeze()))
        d = lpips(np.squeeze(fa), np.squeeze(fb), lpips_weights)
        if d is not None:
            lpipss.append(d)
    return _stats(psnrs, ssims, proxies, lpipss)


def compare_with_reference(character_model_yaml: str, num_poses: int = 16, reference_src: str = "/root/reference/src",
                           seed: int = 0, lpips_weights: Optional[str] = None, compute_dtype=None,
                           device="cuda", matmul_precision: Optional[str] = None) -> Optional[Dict]:
    """Render the same pose suite through the port's student poser (in
    ``compute_dtype``, f32 by default, on ``device``, at ``matmul_precision``)
    and the original
    PyTorch implementation (its mode_14, on the CPU in f32); PSNR / SSIM /
    perceptual-proxy stats, or None where the reference source is not
    mounted."""
    if not os.path.isdir(reference_src):
        return None
    if reference_src not in sys.path:
        sys.path.insert(0, reference_src)
    import torch

    from tha4_tpu_torch.charmodel import CharacterModel

    ours = CharacterModel.load(character_model_yaml)
    poser = ours.get_poser(compute_dtype=compute_dtype or torch.float32, device=device, matmul_precision=matmul_precision)
    image = ours.get_character_image()

    # The reference's mode_14 loaders directly (its CharacterModel class
    # pulls in omegaconf, which may be absent).
    import tha4.poser.modes.mode_14 as ref_mode_14

    ref_poser = ref_mode_14.create_poser(
        torch.device("cpu"),
        module_file_names={
            ref_mode_14.KEY_FACE_MORPHER: ours.face_morpher_file_name,
            ref_mode_14.KEY_BODY_MORPHER: ours.body_morpher_file_name,
        },
    )
    ref_image = torch.from_numpy(np.ascontiguousarray(np.transpose(image, (2, 0, 1)))).float()

    psnrs, ssims, proxies, lpipss = [], [], [], []
    for pose in random_pose_suite(num_poses, seed):
        fa = _host(poser.pose(image, pose))[0]
        with torch.no_grad():
            fb = ref_poser.pose(ref_image, torch.from_numpy(pose))[0].permute(1, 2, 0).numpy()
        psnrs.append(psnr(fa, fb))
        ssims.append(ssim(fa, fb))
        proxies.append(lpips_proxy(fa, fb))
        d = lpips(fa, fb, lpips_weights)
        if d is not None:
            lpipss.append(d)
    return _stats(psnrs, ssims, proxies, lpipss)
