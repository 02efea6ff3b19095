"""tha4_tpu_torch — the PyTorch/CUDA port of tha4_tpu for NVIDIA Hopper.

The package mirrors ``tha4_tpu``'s module paths so each counterpart is easy to
find, and keeps its public layouts: NHWC images, (N, 45) poses and
(N, H, W, 2) grid changes with x first.  It imports ``torch`` and never
``jax``; it carries its own copies of the small numpy-only pieces (pose
schema, Poser interface, character-model yaml I/O, image codec).

The two hot operations of the real-time student frame run as hand-written
CUDA kernels for sm_90a (``csrc/``), built with nvcc at first use:

  * ``ops.cuda_siren.sine_chain_t`` — a whole SIREN level per call;
  * ``ops.cuda_warp.grid_sample_fast`` — the bilinear border warp.

Each has a plain PyTorch version beside it, which runs only for tensors on
the CPU; a CUDA tensor always goes to the kernel, and a failed build or
launch raises.
"""

__version__ = "0.1.0"
