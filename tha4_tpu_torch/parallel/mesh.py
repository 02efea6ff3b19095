"""Data parallelism over ``torch.distributed`` (counterpart of
``tha4_tpu/parallel/mesh.py``'s ``data`` axis).

The JAX package shards a batch over the ``data`` axis of a device mesh and
lets XLA insert the gradient's sum.  Here every rank is a process with its
own device, the module is replicated, and DistributedDataParallel averages
the gradients after each backward, as the reference's torchrun + DDP
trainer did:

  * ``initialize_multihost`` joins a process group when an address is
    given or a launcher's environment says one is pending (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``/``LOCAL_RANK``);
  * ``rank``/``world_size`` (0 and 1 outside a group), ``barrier`` and
    ``agree`` (rank 0's value on every rank); within ``alone()`` the
    process is a group of one whatever group it joined, so that this
    module is the one place that says whether a process is a rank;
  * ``shard_batch``: this rank's contiguous slice of a global batch;
  * ``replicate`` (a broadcast from rank 0) and ``data_parallel`` (the DDP
    wrap), ``apply`` to run a training forward through either;
  * ``mean_over_ranks``: the global batch's named losses;
  * ``launch``: one spawned process per rank, results handed back as numpy.

The mesh's ``space`` axis (image rows sharded across chips) has no
counterpart: it is left behind on purpose (ROADMAP, Queue 1 item 5).
Nothing falls back: NCCL without a GPU for every rank, or a failed
process-group init, raises.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import queue as queue_module
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

# The reference trainer's collective timeout (torch's default for gloo).
# A rank waits this long at a barrier while rank 0 writes a checkpoint or a
# sample grid.
DEFAULT_TIMEOUT_S = 1800.0
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize_multihost(
    address: Optional[str] = None,
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join a process group; returns whether one was joined.

    An explicit ``address`` (``tcp://host:port``) initializes; so does a
    launcher's environment (all of ``LAUNCH_ENV``); otherwise nothing
    happens and the result is False.  Arguments win over the environment.
    ``backend`` is ``nccl`` (the default where CUDA is available: one GPU a
    rank, ``local_rank`` its index) or ``gloo`` (the CPU, or several ranks
    sharing a card, ``local_rank`` modulo the card count).  The device is
    set before the group is made, so that every later CUDA call of this
    process lands on it."""
    if dist.is_initialized():
        return True
    env = os.environ
    if address is None and all(k in env for k in LAUNCH_ENV):
        address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if address is None:
        return False
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA, and torch.cuda.is_available() is False")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"nccl: local rank {local_rank} has no GPU of its own ({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(local_rank)
    elif backend == "gloo":
        if torch.cuda.is_available():
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
    else:
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


_alone = 0  # the depth of ``alone()`` blocks


@contextlib.contextmanager
def alone():
    """Within it this process is rank 0 of a world of one, though it
    joined a process group: what it trains takes no part in the group's
    data parallelism and writes its own files (a swarm unit).  Like the
    group itself, it holds for the whole process."""
    global _alone
    _alone += 1
    try:
        yield
    finally:
        _alone -= 1


def is_distributed() -> bool:
    """Whether this process trains as one rank of a process group."""
    return not _alone and dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def barrier() -> None:
    """Wait for every rank (nothing outside a group)."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def agree(value: Any) -> Any:
    """Rank 0's ``value`` on every rank (a picklable object)."""
    if not is_distributed():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous slice of a global batch (a tensor or an
    array) along dim 0, of ``len(batch) / world`` rows."""
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} does not divide over {world} ranks")
    per = n // world
    return batch[rank * per : (rank + 1) * per]


def replicate(module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers broadcast to every rank, in place."""
    if is_distributed():
        with torch.no_grad():
            for tensor in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(tensor.data, src=0)
    return module


class _Applied(nn.Module):
    """``forward(fn, *args) = fn(module, *args)``: lets DDP run a training
    forward that is a function of the module rather than its ``forward``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, fn: Callable, *args):
        return fn(self.module, *args)


def data_parallel(module: nn.Module) -> DistributedDataParallel:
    """The DDP wrap of ``module`` (its parameters are shared, so an
    optimizer made on the module steps the replica): gradients are averaged
    over the ranks in the backward.  Run training forwards through
    ``apply``."""
    device = next(module.parameters()).device
    return DistributedDataParallel(_Applied(module), device_ids=[device.index] if device.type == "cuda" else None)


def apply(student, fn: Callable, *args):
    """``fn(module, *args)``, through DDP's forward where ``student`` is a
    replica (its backward then averages the gradients), else directly."""
    if isinstance(student, DistributedDataParallel):
        return student(fn, *args)
    return fn(student, *args)


def unwrap(student) -> nn.Module:
    """The module inside a ``data_parallel`` replica (or the module)."""
    return student.module.module if isinstance(student, DistributedDataParallel) else student


def mean_over_ranks(named: dict) -> dict:
    """Scalar tensors averaged over the ranks: each rank's losses are means
    over its slice, so their mean is the global batch's.  One all-reduce;
    every rank must call it."""
    if not is_distributed() or not named:
        return named
    keys = list(named)
    stacked = torch.stack([named[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(stacked)
    stacked /= dist.get_world_size()
    return {k: stacked[i] for i, k in enumerate(keys)}


# -- launch -------------------------------------------------------------


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_numpy(value):
    """Tensors (in dicts, lists and tuples) as numpy arrays: a tensor sent
    through a queue shares a file descriptor that dies with its process."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return value.float().numpy() if value.dtype == torch.bfloat16 else value.numpy()
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_numpy(v) for v in value)
    return value


def _rank_main(fn, args, rank: int, world: int, backend: str, port: int, pg_timeout_s: float, results) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        initialize_multihost(f"tcp://127.0.0.1:{port}", rank=rank, world_size=world, local_rank=rank, backend=backend,
                             timeout_s=pg_timeout_s)
        results.put((rank, True, _to_numpy(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world: int, backend: str = "gloo", args: Sequence = (), timeout_s: Optional[float] = None,
           pg_timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` spawned processes, rank r joined to a
    process group on 127.0.0.1 (``backend``) before it calls ``fn``;
    returns each rank's result, tensors as numpy, in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).  The first
    rank to fail, or to exit without a result, fails the launch, and
    ``timeout_s`` (None: no limit) bounds the whole run; either way every
    child still running is killed before this raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, tuple(args), r, world, backend, port, pg_timeout_s, results),
                         name=f"rank{r}") for r in range(world)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out, failed = {}, {}
    try:
        for p in procs:
            p.start()
        while len(out) < world and not failed:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"launch: {world - len(out)} of {world} ranks gave no result within {timeout_s} s")
            try:
                r, ok, payload = results.get(timeout=0.5)
            except queue_module.Empty:
                # A rank puts its result before it exits 0, so only another exit code is a loss.
                dead = [(i, p.exitcode) for i, p in enumerate(procs) if i not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"launch: rank {dead[0][0]} exited with code {dead[0][1]} and no result")
                continue
            (out if ok else failed)[r] = payload
        if failed:
            # The first failure can make its peers fail at their next
            # collective: gather what arrives in a moment, so that the
            # message holds the cause.
            grace = time.monotonic() + 2.0
            while time.monotonic() < grace:
                try:
                    r, ok, payload = results.get(timeout=0.2)
                except queue_module.Empty:
                    continue
                if not ok:
                    failed[r] = payload
            raise RuntimeError("".join(f"launch: rank {r} failed:\n{failed[r]}" for r in sorted(failed)))
        for p in procs:
            p.join(timeout=60 if deadline is None else max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"launch: {p.name} exited with code {p.exitcode} after its result")
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        results.close()
    return [out[r] for r in range(world)]
