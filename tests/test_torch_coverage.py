"""Every module of the JAX package, and every tool under the root
``tools/``, has a counterpart in the PyTorch port.

A file-name walk (neither package is imported): each ``.py`` and ``.cpp``
under ``tha4_tpu/`` has a twin at the same path under ``tha4_tpu_torch/``,
or stands in ``DECISIONS`` with its counterpart or the reason it stays
behind; each ``tools/*.py`` has a twin under ``tha4_tpu_torch/tools/`` or
stands in ``TOOL_DECISIONS``.  A module or tool added without either fails
here.
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


# Root tool -> (port files that carry what it measures, or none; why no twin).
# The probes time the TPU program's structure (XLA's fusions and cost
# analysis, lax.scan chunks, VMEM tiling, the lane-packed flow); the port
# measures its own kernels and steps with chip_smoke.py (every kernel against
# its bound and a library call) and tools/profile_step.py.
_PROFILE = "tools/profile_step.py"
TOOL_DECISIONS = {
    "warp_probe.py": (["csrc/warp.cu", "ops/cuda_warp.py"],
                      "a Pallas variant of the forward warp: K2 computes its function (chip_smoke.py's kernels line)"),
    "chunk_bench.py": ([_PROFILE, "distiller/recipes.py"],
                       "times XLA's compiled multi-step chunks; eager steps have none: profile_step --time and phase 16's "
                       "lookahead timing"),
    "teacher_interactive_probe.py": (["poser/general_poser.py"],
                                     "the eyebrow decomposer's cache; the teacher poser's prologue cache, counted in "
                                     "chip_smoke.py phase 13"),
    "perf_audit.py": ([_PROFILE], "roofline rows from XLA's cost analysis on the TPU"),
    "precision_sweep.py": (["tools/bench.py", "apps/evaluate.py"],
                           "selective-precision variants of the JAX student frame; the port's frame is K1's, held in "
                           "f32 and bf16 by chip_smoke.py phases 3 and 5"),
    "scan_probe.py": ([_PROFILE], "the lax.scan chunk against straight-line XLA code"),
    "upscaler_floor.py": ([_PROFILE], "the TPU upscaler's conv floor; the port times K6 at the U-Nets' shapes (phase 12)"),
    "flow_prefix_probe.py": ([_PROFILE], "prefixes of the TPU U-Net's packed flow, which the port does not have"),
    "unet_glue_probe.py": ([_PROFILE], "XLA's glue between the TPU U-Net's blocks"),
    "upblock_probe.py": ([_PROFILE], "the packed up-path ResBlock on the TPU"),
    "student_bwd_probe.py": ([_PROFILE], "the JAX student's fwd+bwd split by XLA fusions; K4 and K5 are timed on "
                                         "their own (phases 6, 9)"),
    "student_head_probe.py": ([_PROFILE], "the JAX student's head and warp by XLA fusions; K3 is timed on its own "
                                          "(phase 8)"),
    "quant_probe.py": (["ops/cuda_int8_conv.py", _PROFILE],
                       "XLA's int8 conv at the TPU's shapes; Q1 is timed at every signature (phase 15)"),
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


def _tools():
    return sorted(n for n in os.listdir(os.path.join(ROOT, "tools")) if n.endswith(".py"))


def test_every_root_tool_has_a_twin_or_a_recorded_decision():
    tools = _tools()
    port = os.path.join(ROOT, "tha4_tpu_torch", "tools")
    missing = [t for t in tools if not os.path.exists(os.path.join(port, t)) and t not in TOOL_DECISIONS]
    assert not missing, f"root tools with no port twin and no recorded decision: {missing}"
    assert {"dtype_ab.py", "quant_ab.py", "run_report.py", "eval_body_checkpoint.py"} <= set(tools)
    assert all(os.path.exists(os.path.join(port, t)) for t in tools if t not in TOOL_DECISIONS)


def test_the_tool_decision_table_is_current():
    port = os.path.join(ROOT, "tha4_tpu_torch")
    for tool, (counterparts, reason) in TOOL_DECISIONS.items():
        assert os.path.isfile(os.path.join(ROOT, "tools", tool)), tool
        assert not os.path.exists(os.path.join(port, "tools", tool)), f"{tool} now has a twin: drop its decision"
        assert reason and counterparts, tool
        for path in counterparts:
            assert os.path.isfile(os.path.join(port, path)), path
