"""Every module of the JAX package has a counterpart in the PyTorch port.

A file-name walk (neither package is imported): each ``.py`` and ``.cpp``
under ``tha4_tpu/`` has a twin at the same path under ``tha4_tpu_torch/``,
or stands in ``DECISIONS`` with its counterpart or the reason it stays
behind.  A module added to the JAX package without either fails here.
"""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX file -> (port files that carry its function, or none; why).
DECISIONS = {
    "ops/pallas_siren.py": (
        ["csrc/sine_chain.cu", "csrc/sine_chain_bwd.cu", "csrc/poly_sin.cu", "ops/cuda_siren.py", "ops/cuda_poly_sin.py"],
        "K1 fused_sine_chain_t, K4 its backward and K5 poly_sin: hand-written Hopper kernels",
    ),
    "ops/pallas_warp.py": (
        ["csrc/warp.cu", "ops/cuda_warp.py"],
        "K2 grid_sample_fast and K3 its grid-gradient variant: hand-written Hopper kernels",
    ),
    "ops/pallas_conv.py": (
        ["csrc/affine_conv3.cu", "csrc/group_norm_fold.cu", "ops/cuda_conv.py"],
        "K6 fused_affine_conv3_nchw and its fold: hand-written Hopper kernels",
    ),
    "ops/pallas_packed_conv.py": (
        ["csrc/affine_conv3.cu", "ops/cuda_conv.py"],
        "K7 is K6 on the lane-packed view, a reshape of NHWC: K6 on the NHWC view is its counterpart",
    ),
    "ops/packed_conv.py": (
        [],
        "TPU lane packing for the U-Net's packed flow, which _fuse_resblock_ok (tha4_tpu/models/unet.py:128-129) "
        "turns off on any backend but a TPU; its function is K6's",
    ),
    "utils/compile_cache.py": (
        ["ops/cuda_build.py", "native/loader.py"],
        "XLA's persistent compile cache; the port's counterpart is its digest-keyed build cache",
    ),
    "ops/pallas_util.py": (
        ["utils/precision.py"],
        "kernel_dot_precision, the full-f32 rule; the port sets f32 precision in utils/precision.py",
    ),
}


def _files(package: str):
    base = os.path.join(ROOT, package)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if name.endswith((".py", ".cpp")):
                yield os.path.relpath(os.path.join(dirpath, name), base)


def test_every_jax_module_has_a_twin_or_a_recorded_decision():
    jax_files = set(_files("tha4_tpu"))
    port = os.path.join(ROOT, "tha4_tpu_torch")
    missing = sorted(f for f in jax_files if not os.path.exists(os.path.join(port, f)) and f not in DECISIONS)
    assert not missing, f"JAX modules with no port twin and no recorded decision: {missing}"
    assert len(jax_files) >= 80  # the walk found the package


def test_the_decision_table_is_current():
    """Each decision names a JAX file that exists and has no twin, and every
    counterpart it names exists in the port."""
    port = os.path.join(ROOT, "tha4_tpu_torch")
    for jax_file, (counterparts, reason) in DECISIONS.items():
        assert os.path.isfile(os.path.join(ROOT, "tha4_tpu", jax_file)), jax_file
        assert not os.path.exists(os.path.join(port, jax_file)), f"{jax_file} now has a twin: drop its decision"
        assert reason
        for path in counterparts:
            assert os.path.isfile(os.path.join(port, path)), path
