"""Spectral normalization, one power-iteration step
(counterpart of ``tha4_tpu/ops/spectral_norm.py``).

Functional, as in the JAX package: ``spectral_normalize`` returns the
normalized weight and the advanced ``u`` and changes nothing, so a forward
runs one fresh step from the stored ``u`` and persists none; a trainer
persists the step once per optimization step (``ops.blocks.advance_spectral``).
``torch.nn.utils.spectral_norm`` differs: it writes ``u`` back on every
train-mode forward.

The weight is seen as a matrix with one row per output channel of the conv
(``sn_matrix``).  The JAX package reshapes HWIO to (O, H*W*I), the port's
OIHW to (O, I*H*W): the columns differ by a permutation, which leaves sigma
and ``u`` (length O) unchanged, so a JAX ``sn_u`` carries across as is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sn_matrix(w: torch.Tensor, transpose: bool = False, groups: int = 1) -> torch.Tensor:
    """(O, rest) view of a conv weight, rows = the conv's output channels.

    A conv's OIHW weight is already output-major; a transposed conv's
    (I, O / groups, kh, kw) weight is regrouped so that output channel
    ``g * (O / groups) + j`` is row ``g * (O / groups) + j``."""
    if not transpose:
        return w.reshape(w.shape[0], -1)
    cin, cout_g = w.shape[0], w.shape[1]
    wg = w.reshape(groups, cin // groups, cout_g, -1).transpose(1, 2)  # (g, O/g, I/g, kh*kw)
    return wg.reshape(groups * cout_g, -1)


def init_spectral_state(w: torch.Tensor, generator: Optional[torch.Generator] = None, transpose: bool = False,
                        groups: int = 1) -> torch.Tensor:
    """A unit-norm normal ``u`` of length O (the matrix's rows)."""
    rows = sn_matrix(w, transpose, groups).shape[0]
    u = torch.randn(rows, generator=generator, dtype=w.dtype, device="cpu").to(w.device)
    return u / (torch.linalg.vector_norm(u) + 1e-12)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, eps: float = 1e-12, transpose: bool = False,
                       groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step; returns (w / sigma, new u), the new ``u``
    detached (the JAX package's ``stop_gradient``)."""
    w2 = sn_matrix(w, transpose, groups)  # (O, rest)
    v = w2.t() @ u
    v = v / (torch.linalg.vector_norm(v) + eps)
    u_new = w2 @ v
    u_new = u_new / (torch.linalg.vector_norm(u_new) + eps)
    sigma = u_new @ (w2 @ v)
    return w / sigma, u_new.detach()
