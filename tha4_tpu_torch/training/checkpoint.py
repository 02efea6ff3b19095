"""Checkpointing: directory per checkpoint, examples-seen progress, resume scan
(counterpart of ``tha4_tpu/training/checkpoint.py``).

The layout, file names, completeness check, resume scan and atomic write are
the JAX package's:

    {prefix}/checkpoint/{NNNN}/      every checkpoint boundary
    {prefix}/snapshot/               rolling
        examples_seen_so_far.txt
        module_<name>.npz            the module's state dict, one array per key
        optimizer_<name>.npz         the optimizer's per-parameter state
        rng_state_00000000.npz       the run's stream key (process 0)

A state is written into ``<dir>.tmp`` and renamed into place, so a partly
written one never passes ``can_load``.  The contents are the port's own
(a torch state dict and ``torch.optim`` state, not JAX pytrees), and the two
packages do not load each other's checkpoints.  The optimizer's
hyperparameters are not stored: they come from the code, as optax's do.

Under data parallelism the trainer has rank 0 write the unwrapped module's
state and every rank load the same directory after that write, so a state
holds nothing of the world size: one written by two ranks loads in one
process, and the other way round.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

EXAMPLES_FILE = "examples_seen_so_far.txt"
RNG_FILE = "rng_state_00000000.npz"  # rank 0's; every rank's stream key is the same
SEP = "\x1f"  # between a parameter index and a state name in optimizer_*.npz


def _optimizer_arrays(optimizer: torch.optim.Optimizer) -> Dict[str, np.ndarray]:
    state = optimizer.state_dict()["state"]
    return {f"{i}{SEP}{name}": value.detach().cpu().numpy() for i, entry in state.items() for name, value in entry.items()}


def _load_optimizer(optimizer: torch.optim.Optimizer, arrays: Dict[str, np.ndarray]) -> None:
    sd = optimizer.state_dict()
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in arrays.items():
        index, name = key.split(SEP)
        state.setdefault(int(index), {})[name] = torch.from_numpy(value)
    sd["state"] = state
    optimizer.load_state_dict(sd)


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_state(
    directory: str,
    modules: Dict[str, nn.Module],
    optimizers: Dict[str, torch.optim.Optimizer],
    examples_seen: int,
    rng_key: int,
) -> None:
    """Write a complete training state; atomic through a temp-dir rename."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, EXAMPLES_FILE), "w") as f:
        f.write(str(int(examples_seen)))
    for name, module in modules.items():
        np.savez(os.path.join(tmp, f"module_{name}.npz"), **{k: v.detach().cpu().numpy() for k, v in module.state_dict().items()})
    for name, optimizer in optimizers.items():
        np.savez(os.path.join(tmp, f"optimizer_{name}.npz"), **_optimizer_arrays(optimizer))
    np.savez(os.path.join(tmp, RNG_FILE), key=np.uint64(rng_key))
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)


def can_load(directory: str, module_names: List[str]) -> bool:
    """Every file of a complete state is there."""
    if not os.path.isfile(os.path.join(directory, EXAMPLES_FILE)):
        return False
    for name in module_names:
        for kind in ("module", "optimizer"):
            if not os.path.isfile(os.path.join(directory, f"{kind}_{name}.npz")):
                return False
    return os.path.isfile(os.path.join(directory, RNG_FILE))


def read_examples_seen(directory: str) -> int:
    with open(os.path.join(directory, EXAMPLES_FILE)) as f:
        return int(f.read().strip())


def load_state(
    directory: str,
    modules: Dict[str, nn.Module],
    optimizers: Dict[str, torch.optim.Optimizer],
):
    """Load a state into the given modules and optimizers, in place; returns
    (examples_seen, rng_key)."""
    for name, module in modules.items():
        sd = _load_npz(os.path.join(directory, f"module_{name}.npz"))
        module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    for name, optimizer in optimizers.items():
        _load_optimizer(optimizer, _load_npz(os.path.join(directory, f"optimizer_{name}.npz")))
    with np.load(os.path.join(directory, RNG_FILE)) as data:
        rng_key = int(data["key"])
    return read_examples_seen(directory), rng_key


def checkpoint_dir(prefix: str, index: int) -> str:
    return os.path.join(prefix, "checkpoint", f"{index:04d}")


def snapshot_dir(prefix: str) -> str:
    return os.path.join(prefix, "snapshot")


def find_resume_dir(prefix: str, target_examples: int, batch_size: int, module_names: List[str]) -> Optional[str]:
    """The newest loadable state whose progress fits the target: the
    snapshot, else the checkpoints from newest to oldest."""
    snap = snapshot_dir(prefix)
    if can_load(snap, module_names) and read_examples_seen(snap) <= target_examples + batch_size:
        return snap
    root = os.path.join(prefix, "checkpoint")
    if os.path.isdir(root):
        indices = sorted((int(m.group(1)) for d in os.listdir(root) if (m := re.fullmatch(r"(\d{4})", d))), reverse=True)
        for index in indices:
            d = checkpoint_dir(prefix, index)
            if can_load(d, module_names) and read_examples_seen(d) <= target_examples + batch_size:
                return d
    return None
