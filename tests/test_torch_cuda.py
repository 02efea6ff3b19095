"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; each skips itself where
``torch.cuda.is_available()`` is False.  On a machine with a card (and no
jax, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tha4_tpu_torch.ops import cuda_siren, cuda_warp
from tha4_tpu_torch.ops.warp import identity_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _chain(rng, dims, head, dtype, device):
    mats = [
        (torch.from_numpy((rng.standard_normal((co, ci)) * (0.5 / np.sqrt(ci))).astype(np.float32)),
         torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32)))
        for ci, co in zip(dims[:-1], dims[1:])
    ]
    return cuda_siren.pack_chain(mats[: len(mats) - head], mats[-1] if head else None, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cp,dims,head,hw", [(0, [9, 24, 16, 5], 1, 1000), (6, [15, 40, 16], 0, 4096), (6, [15, 370, 8, 3], 1, 77)])
def test_sine_chain_kernel_matches_plain(card, dtype, cp, dims, head, hw):
    rng = np.random.default_rng(hw)
    n, pose_dim = 2, dims[0] - cp - 2
    chain = _chain(rng, dims, head, dtype, card)
    prev = torch.from_numpy(rng.uniform(-1, 1, (n, cp, hw)).astype(np.float32)).to(card, dtype) if cp else None
    pos = torch.from_numpy(rng.uniform(-1, 1, (2, hw)).astype(np.float32)).to(card, dtype)
    pose = torch.from_numpy(rng.uniform(-1, 1, (n, pose_dim)).astype(np.float32)).to(card)
    before = cuda_siren.sine_chain_t.launches
    out = cuda_siren.sine_chain_t(prev, pos, pose, chain)
    torch.cuda.synchronize()
    assert cuda_siren.sine_chain_t.launches == before + 1
    ref = cuda_siren.chain_t_plain(prev, pos, pose, chain)
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4
    else:  # see tests/test_torch_siren.py: summation order moves a bf16 step now and then
        assert float(err.max()) <= 4 * 2.0**-8 * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)])
def test_warp_kernel_matches_plain(card, dtype, atol):
    rng = np.random.default_rng(7)
    image = torch.from_numpy(rng.uniform(-1, 1, (2, 96, 160, 4)).astype(np.float32)).to(card, dtype)
    grid = torch.from_numpy(rng.uniform(-1.5, 1.5, (2, 64, 80, 2)).astype(np.float32)).to(card)
    grid[1] = identity_grid(64, 80, card) + 0.01
    before = cuda_warp.grid_sample_fast.launches
    out = cuda_warp.grid_sample_fast(image, grid)
    torch.cuda.synchronize()
    assert cuda_warp.grid_sample_fast.launches == before + 1
    assert out.dtype == dtype and out.shape == (2, 64, 80, 4)
    ref = cuda_warp.grid_sample_bilinear_border(image, grid)
    assert float((out.float() - ref.float()).abs().max()) <= atol


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    image = torch.zeros((1, 8, 8, 3), device=card)
    with pytest.raises(ValueError, match="N, H, W, 4"):
        cuda_warp.grid_sample_fast(image, torch.zeros((1, 8, 8, 2), device=card))
    chain = _chain(np.random.default_rng(0), [5, 8], 0, torch.float32, "cpu")
    pos = torch.zeros((2, 16), device=card)
    with pytest.raises(ValueError, match="on cpu"):
        cuda_siren.sine_chain_t(None, pos, torch.zeros((1, 3), device=card), chain)
