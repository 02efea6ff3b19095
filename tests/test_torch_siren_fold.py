"""The bf16 K1 / K4 kernels' order of sums in plain PyTorch, and the
witness for the one card test case that order alone moves past its bar.

The tensor-core kernels (csrc/sine_chain_tc.cuh) fold layer 0's pose
columns and bias into one f32 vector per batch element and its position
columns into two FMAs.  ``chain_t_folded`` / ``chain_t_bwd_folded`` are
that arithmetic in plain PyTorch: the same exact bf16 products as
``cuda_siren.chain_t_plain`` / ``chain_t_bwd_plain``, summed in another
order.  tests/test_torch_siren.py and tests/test_torch_siren_bwd.py hold
them against the interpreted Pallas kernels; tests/test_torch_cuda.py holds
the kernels against the plain versions.  ``chain_t_exact`` runs the same
arithmetic with its sums and sines in f64.

This module imports no JAX, so tests/test_torch_cuda.py can use it on a
machine without it.  ``pytest -s`` prints the witness's readings.
"""

import numpy as np
import pytest
import torch

from tha4_tpu_torch.ops import cuda_siren
from tha4_tpu_torch.ops.cuda_siren import fast_cos, fast_sin

# The card test's K1 cases (tests/test_torch_cuda.py): (cp, dims, head, hw).
K1_CASES = [
    (0, [9, 24, 16, 5], 1, 1000), (6, [15, 40, 16], 0, 4096), (6, [15, 370, 8, 3], 1, 77),
    # bf16 on wgmma: K of 20 (not a multiple of 16), N of 360 (three chunks) and 7, HW not a multiple of 64
    (20, [29, 360, 7], 1, 130),
    # N of 4, a one-layer chain whose only layer is folded
    (3, [12, 4], 0, 64),
]
# The f32 kernel's further card cases: the frame's four chains at their
# shipped widths and sizes, a ragged chain (pixels not a multiple of 4 nor of
# the tile, channels not a multiple of 8) and one too wide for the larger
# tile (csrc/sine_chain.cu; ops/cuda_siren.py f32_plan).
K1_F32_CASES = [
    (0, [41] + [128] * 8 + [4], 1, 128 * 128), (0, [47, 360, 360, 180], 0, 128 * 128),
    (180, [227, 180, 180, 90], 0, 256 * 256), (90, [137, 90, 90, 90, 7], 1, 512 * 512),
    (5, [12, 100, 61, 3], 1, 999), (0, [30, 500, 20], 0, 777),
]
# The one of them where two f32 orders of the same bf16 arithmetic differ
# by more than the bf16 bar (weights ten times SIREN's scale, 131072 outputs).
SUM_ORDER_SENSITIVE = (6, [15, 40, 16], 0, 4096)


def random_chain(rng, dims, head, dtype, device):
    """A chain of (Co, Ci) layers with N(0, 0.25 / Ci) weights and N(0, 0.01)
    biases, the last a head when ``head``."""
    mats = [
        (torch.from_numpy((rng.standard_normal((co, ci)) * (0.5 / np.sqrt(ci))).astype(np.float32)),
         torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32)))
        for ci, co in zip(dims[:-1], dims[1:])
    ]
    return cuda_siren.pack_chain(mats[: len(mats) - head], mats[-1] if head else None, dtype, device)


def k1_case(cp, dims, head, hw, dtype, device):
    """The card test's inputs for one of ``K1_CASES``: (prev, pos, pose, chain)."""
    rng = np.random.default_rng(hw)
    n, pose_dim = 2, dims[0] - cp - 2
    chain = random_chain(rng, dims, head, dtype, device)
    prev = torch.from_numpy(rng.uniform(-1, 1, (n, cp, hw)).astype(np.float32)).to(device, dtype) if cp else None
    pos = torch.from_numpy(rng.uniform(-1, 1, (2, hw)).astype(np.float32)).to(device, dtype)
    pose = torch.from_numpy(rng.uniform(-1, 1, (n, pose_dim)).astype(np.float32)).to(device)
    return prev, pos, pose, chain


def k1_bf16_bar(ref):
    """K1's bf16 bar: four bf16 steps of the output's magnitude."""
    return 4 * 2.0**-8 * max(1.0, float(ref.float().abs().max()))


def _first_layer_folded(prev, pos_t, pose, w, b, dtype):
    """Layer 0's f32 pre-activation (N, Co, HW) in the bf16 kernels' order:
    W_prev prev, plus the two position FMAs, plus W_pose pose + b."""
    cp = 0 if prev is None else prev.shape[1]
    w = w.float()
    pre0 = torch.matmul(pose.float().to(dtype).float(), w[:, cp + 2 :].T) + b  # (N, Co)
    pos = pos_t.to(dtype).float()
    acc = w[:, cp, None] * pos[0]
    if prev is not None:
        acc = torch.matmul(w[:, :cp], prev.float()) + acc
    return acc + w[:, cp + 1, None] * pos[1] + pre0[:, :, None]


def chain_t_folded(prev, pos_t, pose, chain, omega=30.0):
    """``cuda_siren.chain_t_plain`` with layer 0 in the bf16 kernels' order."""
    dtype = chain.dtype
    h = cuda_siren._level_input(prev, pos_t, pose, dtype)
    for i in range(chain.num_layers):
        w, b = chain.layer(i)
        acc = _first_layer_folded(prev, pos_t, pose, w, b, dtype) if i == 0 else torch.matmul(w.float(), h.float()) + b[:, None]
        h = (fast_sin(omega * acc) if i < chain.num_sine else acc).to(dtype)
    return h


def chain_t_bwd_folded(prev, pos_t, pose, chain, g, omega=30.0):
    """``cuda_siren.chain_t_bwd_plain`` in the bf16 kernels' order: layer 0's
    forward folded, and dpose = W_pose^T (layer 0's rounded g_a summed over
    pixels), the same sum by linearity."""
    dtype = chain.dtype
    h = cuda_siren._level_input(prev, pos_t, pose, dtype)
    inputs, pre = [], []
    for i in range(chain.num_sine):
        w, b = chain.layer(i)
        inputs.append(h)
        pre.append(_first_layer_folded(prev, pos_t, pose, w, b, dtype) if i == 0
                   else torch.matmul(w.float(), h.float()) + b[:, None])
        h = fast_sin(omega * pre[-1]).to(dtype)
    if chain.num_layers > chain.num_sine:
        inputs.append(h)
    g = g.float()
    dws, dbs = [], []
    for i in reversed(range(chain.num_layers)):
        w, _ = chain.layer(i)
        ga = g * (omega * fast_cos(omega * pre[i])) if i < chain.num_sine else g
        dbs.append(ga.sum(dim=(0, 2)))
        ga = ga.to(dtype).float()
        dws.append(torch.einsum("nop,nip->oi", ga, inputs[i].float()).reshape(-1))
        g = torch.matmul(w.float().T, ga)
    cp = 0 if prev is None else prev.shape[1]
    dprev = None if prev is None else g[:, :cp].to(prev.dtype)
    dpose = torch.matmul(ga.sum(dim=2), chain.layer(0)[0].float()[:, cp + 2 :])
    return dprev, dpose, torch.cat(dws[::-1]), torch.cat(dbs[::-1])


def chain_t_exact(prev, pos_t, pose, chain, omega=30.0):
    """The plain version's arithmetic with its sums and sines in f64: the
    same compute-dtype operands and activations rounded to the compute dtype
    between layers, so any order of f32 sums approximates it."""
    dtype = chain.dtype
    h = cuda_siren._level_input(prev, pos_t, pose, dtype)
    for i in range(chain.num_layers):
        w, b = chain.layer(i)
        acc = torch.matmul(w.double(), h.double()) + b.double()[:, None]
        h = (torch.sin(omega * acc) if i < chain.num_sine else acc).to(dtype)
    return h


def max_diff(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("cp,dims,head,hw", K1_CASES)
def test_sum_order_alone_moves_only_the_sensitive_case_past_the_bf16_bar(cp, dims, head, hw):
    """Witness for the card test's bf16 K1 cases, all on the CPU without
    tensor cores: the unfolded plain version, the folded one and the f64
    run.  At ``SUM_ORDER_SENSITIVE`` the two f32 orders differ by more than
    the bar, and neither is within the bar of the f64 run, so no f32 order
    can be held to another at that bar there; at every other case the two
    orders agree within it."""
    prev, pos, pose, chain = k1_case(cp, dims, head, hw, torch.bfloat16, "cpu")
    plain = cuda_siren.chain_t_plain(prev, pos, pose, chain)
    folded = chain_t_folded(prev, pos, pose, chain)
    exact = chain_t_exact(prev, pos, pose, chain)
    bar = k1_bf16_bar(plain)
    readings = {"folded_vs_plain": max_diff(folded, plain), "plain_vs_f64": max_diff(plain, exact),
                "folded_vs_f64": max_diff(folded, exact), "bar": bar}
    print(f"K1 bf16 {'->'.join(map(str, dims))} HW={hw} (CPU): {readings}")
    if (cp, dims, head, hw) == SUM_ORDER_SENSITIVE:
        assert min(readings["folded_vs_plain"], readings["plain_vs_f64"], readings["folded_vs_f64"]) > bar, readings
    else:
        assert readings["folded_vs_plain"] <= bar, readings
