"""The f32 precision of the card's library calls, set in one way.

cuBLAS's f32 matmuls take ``torch.set_float32_matmul_precision`` and
cuDNN's f32 convolutions ``torch.backends.cudnn.allow_tf32`` (the first
does not reach them).  The port writes nothing else: the legacy matmul flag
``torch.backends.cuda.matmul.allow_tf32`` mixed with
``set_float32_matmul_precision`` leaves ``torch.get_float32_matmul_precision()``
raising until the next set (torch 2.13).

The JAX package names a matmul precision per call (``default``, ``high``,
``highest``: ``jax.default_matmul_precision``); ``MATMUL_PRECISION`` maps
those words onto torch's.  The hand-written kernels keep their stated
operand precision whatever is set here.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

MATMUL_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}


def set_full_f32() -> None:
    """f32 means full-f32 products, as JAX's ``highest`` on its f32 path: no
    TF32 in cuBLAS's matmuls or cuDNN's convolutions."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False


@contextmanager
def matmul_precision(name: Optional[str]):
    """The f32 matmul precision JAX calls ``name`` for the block, the one
    before restored after; None leaves it as it is."""
    if name is None:
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(MATMUL_PRECISION[name])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


@contextmanager
def restored():
    """Both settings as they were before the block, whatever it sets."""
    matmul, cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn
