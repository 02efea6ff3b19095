"""The port's fidelity metrics against the JAX package's.  PSNR and SSIM are
the same numpy code, so they agree to 1e-12 relative on seeded images; the
perceptual proxy's weights are jax.random's draws made again in numpy
(``utils/threefry.py``), its convs PyTorch's; LPIPS is the same torch code;
``compare_posers`` runs both packages' posers on the same character models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.utils import fidelity as jfidelity
from tha4_tpu_torch.utils import fidelity, threefry

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


# ---------------------------------------------------------------------------
# The perceptual proxy's weights: jax.random's draws in numpy
# ---------------------------------------------------------------------------


def _jax_keys():
    """The proxy's per-layer keys and shapes, as the JAX package draws them."""
    key, out, cin = jax.random.PRNGKey(fidelity._PROXY_SEED), [], 3
    for cout in fidelity._PROXY_CHANNELS:
        key, k = jax.random.split(key)
        out.append((k, (3, 3, cin, cout), cin))
        cin = cout
    return out


def test_threefry_bits_equal_jax_random():
    """Under the partitionable threefry (jax's default; read, not set), the
    split keys, the raw bits and the uniforms equal jax.random's bit for
    bit."""
    assert jax.config.jax_threefry_partitionable
    assert tuple(int(v) for v in threefry.prng_key(fidelity._PROXY_SEED)) == tuple(
        int(v) for v in np.asarray(jax.random.PRNGKey(fidelity._PROXY_SEED)))
    key = threefry.prng_key(fidelity._PROXY_SEED)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    for jkey, shape, _ in _jax_keys():
        key, k = threefry.split(key)
        assert (int(k[0]), int(k[1])) == tuple(int(v) for v in np.asarray(jkey))
        np.testing.assert_array_equal(threefry.bits(k, shape), np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
        np.testing.assert_array_equal(threefry.uniform(k, shape, lo, 1.0),
                                      np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0)))


def _ulps(a, b) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


# The normals come through erf_inv(u) over log1p(-u^2): the port's log1p
# matches XLA's exactly below |x| < sqrt(2) - 1 and rounds differently from
# XLA's logf beyond in 3.6 % of the draws, by one ulp, which erf_inv's slope
# near |u| = 1 spreads.  Read: normals 3 ulp, weights (one more f32
# multiply) 4 ulp, at most.
NORMAL_ULPS, WEIGHT_ULPS = 3, 4


def test_proxy_weights_match_jax_to_a_few_ulp():
    ours = fidelity.proxy_weights()
    theirs = jfidelity._proxy_params()
    assert len(ours) == len(theirs) == 5
    for (jkey, shape, cin), o, t in zip(_jax_keys(), ours, theirs):
        assert o.dtype == np.float32 and o.shape == shape == t.shape
        key_np = tuple(np.uint32(v) for v in np.asarray(jkey))
        assert _ulps(threefry.normal(key_np, shape), np.asarray(jax.random.normal(jkey, shape, jnp.float32))) <= NORMAL_ULPS
        assert _ulps(o, np.asarray(t)) <= WEIGHT_ULPS


@pytest.mark.parametrize("shape", [(512, 512, 4), (37, 45, 3), (33, 33)], ids=["512", "odd", "gray-odd"])
def test_lpips_proxy_matches_jax(shape):
    a, b = _images(shape, seed=shape[0])
    ours, theirs = fidelity.lpips_proxy(a, b), jfidelity.lpips_proxy(a, b)
    assert ours > 0.0
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    assert fidelity.lpips_proxy(a, a) == 0.0
    # Tensors run on their device (here the CPU) and give the same distance.
    np.testing.assert_allclose(fidelity.lpips_proxy(torch.from_numpy(a), torch.from_numpy(b)), ours, rtol=1e-6)


def test_proxy_same_padding_is_xla_s():
    """Stride-2 "SAME": 0 before and 1 after on an even side, 1 and 1 on an
    odd one, as lax.conv_general_dilated pads."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 3, 2, 3)).astype(np.float32)
    for size in (8, 9):
        x = rng.standard_normal((1, size, size + 1, 2)).astype(np.float32)
        theirs = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                              dimension_numbers=("NHWC", "HWIO", "NHWC"))
        ours = fidelity._same_stride2(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1))
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(theirs), atol=1e-5)


def _lpips_weights(path):
    """JAX's synthetic LPIPS(alex) weights file (tests/test_fidelity.py:67)."""
    gen = torch.Generator().manual_seed(0)
    sd = {}
    chans = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]
    for (si, ci), (cin, cout, k) in zip([(1, 0), (2, 3), (3, 6), (4, 8), (5, 10)], chans):
        sd[f"net.slice{si}.{ci}.weight"] = 0.1 * torch.randn(cout, cin, k, k, generator=gen)
        sd[f"net.slice{si}.{ci}.bias"] = torch.zeros(cout)
    for i, (_, cout, _) in enumerate(chans):
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, cout, 1, 1, generator=gen)
    torch.save(sd, path)
    return str(path)


def test_lpips_matches_jax_on_its_synthetic_weights(tmp_path):
    path = _lpips_weights(tmp_path / "lpips_alex.pt")
    a, b = _images((64, 64, 4), seed=9)
    ours = fidelity.lpips(a, b, path)
    assert ours > 0.0 and fidelity.lpips(a, a, path) == pytest.approx(0.0, abs=1e-12)
    np.testing.assert_allclose(ours, jfidelity.lpips(a, b, path), rtol=1e-6)
    assert fidelity.lpips(a, b, None) is None and fidelity.lpips(a, b, str(tmp_path / "missing.pt")) is None


@pytest.fixture(scope="module")
def two_models(tmp_path_factory):
    """Two narrow character models (tests/test_torch_mode14.py's widths) that
    both packages' CharacterModel load."""
    from tests.test_torch_mode14 import _port_cfgs
    from tha4_tpu_torch.charmodel.synthetic import write_random_character_model

    root = tmp_path_factory.mktemp("models")
    return [write_random_character_model(str(root / name), seed, *_port_cfgs()) for name, seed in (("a", 3), ("b", 4))]


# compare_posers' stats, port against JAX on the same models: the two
# packages' f32 frames differ by ~1e-5 (test_torch_mode14.py's bars), which
# moves a PSNR between two different models by far less than 1e-3 of itself.
STATS_RTOL = {"psnr_mean": 1e-4, "psnr_min": 1e-4, "ssim_mean": 1e-5, "lpips_proxy_mean": 1e-4}


def test_compare_posers_matches_jax(two_models):
    from tha4_tpu.charmodel import CharacterModel as JCharacterModel
    from tha4_tpu_torch.charmodel import CharacterModel

    poses = fidelity.random_pose_suite(3, 1)
    a, b = (CharacterModel.load(p) for p in two_models)
    ja, jb = (JCharacterModel.load(p) for p in two_models)
    ours = fidelity.compare_posers(a.get_poser(torch.float32, "cpu"), b.get_poser(torch.float32, "cpu"),
                                   a.get_character_image(), poses)
    theirs = jfidelity.compare_posers(ja.get_poser(), jb.get_poser(), ja.get_character_image(), poses)
    assert ours.keys() == theirs.keys() and ours["frames"] == theirs["frames"] == 3
    assert np.isfinite(ours["psnr_min"]) and ours["psnr_min"] < 60.0  # two different models
    for key, rtol in STATS_RTOL.items():
        np.testing.assert_allclose(ours[key], theirs[key], rtol=rtol, err_msg=key)
    same = fidelity.compare_posers(a.get_poser(torch.float32, "cpu"), a.get_poser(torch.float32, "cpu"),
                                   a.get_character_image(), poses[:1])
    assert same["psnr_min"] == float("inf") and same["lpips_proxy_mean"] == 0.0


def test_compare_with_reference_without_the_reference(two_models, tmp_path):
    assert fidelity.compare_with_reference(two_models[0], num_poses=1, reference_src=str(tmp_path / "none"),
                                           device="cpu") is None
