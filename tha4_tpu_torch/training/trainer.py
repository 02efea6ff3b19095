"""The training loop: examples-seen accounting, cadences, resume
(counterpart of ``tha4_tpu/training/trainer.py``).

  * progress is counted in examples seen, never steps;
  * a checkpoint at every boundary of ``checkpoint_examples`` into
    ``{prefix}/checkpoint/{i:04d}`` (and checkpoint 0 on a fresh start), a
    rolling snapshot every ``examples_per_snapshot`` examples;
  * resume from the newest loadable state whose progress fits the target;
  * the lr is ``lr_fn(examples_seen)`` and the loss weights
    ``loss_weights_fn(examples_seen)`` before every step;
  * the named losses go to ``{prefix}/log/scalars.jsonl`` every
    ``log_every_seconds``, and to a TensorBoard events file beside it
    (``training/tensorboard.py``; tags ``training_module_<term>_loss`` and
    ``learning_rate``, the reference's);
  * where a ``sample_output_fn(module, examples_seen)`` is given, it runs
    every ``examples_per_sample_output`` examples, and at 0 on a fresh start
    (the JAX trainer's cadence, ``tha4_tpu/training/trainer.py:319-327,
    394-401``);
  * a run resumed from a snapshot taken at a checkpoint boundary whose
    checkpoint is missing (stopped between the two writes) writes that
    checkpoint before it goes on, so that the task DAG's checkpoint file
    appears whenever its task ran.

Eager PyTorch runs the optimizer steps one by one: the JAX trainer's
compile-ahead exists for XLA's compiled multi-step programs and has no
counterpart here, nor has its validation hook, which no distillation job
sets.  A step's randomness comes from a ``torch.Generator`` seeded from
(the run's key, the step index), so a step's batch does not depend on where
a run stopped and resumed.

The trainer's one callback, ``train_group``, runs a group of K steps
(teacher lookahead, ``lookahead`` K; a plain step is a group of one) whose
teacher labels are made in one call.  A group never crosses a snapshot,
checkpoint, sample or target boundary (the boundaries of the JAX trainer's
chunks, ``tha4_tpu/training/trainer.py:205``); short of one, the steps run
one a group.  So a run resumed from any state it wrote takes the same
groups as one that never stopped.

Data parallelism (a ``torch.distributed`` group; ``parallel.mesh`` alone
says whether this process is one of its ranks): every rank draws the same
global batch from the same generator and takes its slice (the step's job),
and trains a ``data_parallel`` replica of the module, so N ranks make one
process's updates.  The named losses are averaged over the ranks after
every step, outside the logging branch, which rank 0's clock decides.
Rank 0 alone writes checkpoints, snapshots, the JSONL and TensorBoard logs
and the sample grids (from the unwrapped module), and a barrier follows
each write; rank 0 picks the state to resume from and every rank loads it.
The state saved is the unwrapped module's, so a checkpoint is the same
files at any world size.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from tha4_tpu_torch.parallel import mesh
from tha4_tpu_torch.training import checkpoint as ckpt
from tha4_tpu_torch.training.tensorboard import SummaryWriter

logger = logging.getLogger(__name__)

KEY_MODULE = "module"
_MASK64 = (1 << 64) - 1


def get_least_greater_multiple(value: int, multiple: int) -> int:
    """The smallest multiple of ``multiple`` strictly greater than ``value``."""
    return (value // multiple + 1) * multiple


def step_seed(key: int, step: int) -> int:
    """A 64-bit seed for step ``step`` of the stream ``key``: SplitMix64's
    finaliser over key + (step + 1) * golden ratio."""
    z = (key + (step + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclass
class TrainerConfig:
    prefix: str
    checkpoint_examples: List[int]  # cumulative boundaries
    total_batch_size: int = 8
    examples_per_snapshot: int = 10_000
    examples_per_sample_output: Optional[int] = None  # set iff the trainer has a sample_output_fn
    random_seed: int = 2965603729
    log_every_seconds: float = 10.0
    lookahead: int = 1  # K: steps a group, whose teacher labels are made in one call


def group_steps(examples_seen: int, boundary: int, batch_size: int, lookahead: int) -> int:
    """Steps in the next group: K while K steps reach no further than the
    step that reaches ``boundary``, else 1 (JAX's ``n_groups, rem`` split
    of a chunk that ends there)."""
    steps_to_boundary = -(-(boundary - examples_seen) // batch_size)
    return lookahead if steps_to_boundary >= lookahead else 1


class Trainer:
    """Drives one student's training.

      init_module(generator) -> nn.Module (on its device)
      make_optimizer(module) -> torch.optim.Optimizer
      train_group(module, optimizer, generators, lrs, loss_weights) -> the
          last step's {name: scalar tensor}: K optimizer steps, step j with
          the j-th of each list (its own generator, lr and loss weights)
      lr_fn(examples_seen) -> float
      loss_weights_fn(examples_seen) -> {term: float} (default: none, {})
      sample_output_fn(module, examples_seen) -> None (writes sample PNGs);
          it must leave the module as it found it and draw from no
          generator of the steps

    ``module`` in a step is the module, or its ``data_parallel`` replica
    where a process group is up.
    """

    def __init__(
        self,
        cfg: TrainerConfig,
        init_module: Callable[[torch.Generator], nn.Module],
        make_optimizer: Callable[[nn.Module], torch.optim.Optimizer],
        train_group: Callable,
        lr_fn: Callable[[int], float],
        loss_weights_fn: Optional[Callable[[int], Dict[str, float]]] = None,
        sample_output_fn: Optional[Callable[[nn.Module, int], None]] = None,
    ):
        self.cfg = cfg
        self.init_module = init_module
        self.make_optimizer = make_optimizer
        self.train_group = train_group
        self.lr_fn = lr_fn
        self.loss_weights_fn = loss_weights_fn or (lambda examples_seen: {})
        self.sample_output_fn = sample_output_fn
        if (sample_output_fn is None) != (cfg.examples_per_sample_output is None):
            raise ValueError("examples_per_sample_output and sample_output_fn are given together or not at all")

    def _fresh_state(self):
        root = torch.Generator().manual_seed(self.cfg.random_seed)
        module = self.init_module(root)
        key = int(torch.randint(0, 2**62, (1,), generator=root))
        return module, self.make_optimizer(module), key

    # -- ranks: outside a process group this process is rank 0 of one.

    def _save(self, directory: str, module, optimizer, examples_seen: int, key: int) -> None:
        """Rank 0 writes; every rank waits for the write."""
        if mesh.rank() == 0:
            ckpt.save_state(directory, {KEY_MODULE: module}, {KEY_MODULE: optimizer}, examples_seen, key)
        mesh.barrier()

    def _sample(self, module, examples_seen: int) -> None:
        if mesh.rank() == 0:
            self.sample_output_fn(module, examples_seen)
        mesh.barrier()

    def _load_or_init(self, target_examples: int):
        module, optimizer, key = self._fresh_state()
        resume = mesh.agree(
            ckpt.find_resume_dir(self.cfg.prefix, target_examples, self.cfg.total_batch_size, [KEY_MODULE])
            if mesh.rank() == 0 else None)
        if resume is not None:
            logger.info("Resuming from %s", resume)
            examples_seen, key = ckpt.load_state(resume, {KEY_MODULE: module}, {KEY_MODULE: optimizer})
            return module, optimizer, examples_seen, key
        logger.info("Starting fresh training state")
        self._save(ckpt.checkpoint_dir(self.cfg.prefix, 0), module, optimizer, 0, key)
        return module, optimizer, 0, key

    def train(self, target_examples: Optional[int] = None) -> Dict:
        cfg = self.cfg
        if target_examples is None:
            target_examples = cfg.checkpoint_examples[-1]
        log_path = os.path.join(cfg.prefix, "log", "scalars.jsonl")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)

        module, optimizer, examples_seen, key = self._load_or_init(target_examples)
        if examples_seen in cfg.checkpoint_examples and examples_seen <= target_examples:
            directory = ckpt.checkpoint_dir(cfg.prefix, cfg.checkpoint_examples.index(examples_seen) + 1)
            if not mesh.agree(ckpt.can_load(directory, [KEY_MODULE])):
                self._save(directory, module, optimizer, examples_seen, key)
                logger.info("Wrote the missing checkpoint %s at %d examples", directory, examples_seen)
        next_snapshot = get_least_greater_multiple(examples_seen, cfg.examples_per_snapshot)
        checkpoints_due = [c for c in cfg.checkpoint_examples if examples_seen < c <= target_examples]
        sampling = self.sample_output_fn is not None
        next_sample = target_examples
        if sampling:
            next_sample = get_least_greater_multiple(max(examples_seen - 1, 0), cfg.examples_per_sample_output)
            if examples_seen == 0:
                self._sample(module, examples_seen)
                next_sample = cfg.examples_per_sample_output
        in_group = mesh.is_distributed()
        replica = mesh.data_parallel(module) if in_group else module
        writer = mesh.rank() == 0
        metrics: Dict[str, torch.Tensor] = {}
        t_start = last_log_time = time.monotonic()
        log_file = open(log_path, "a") if writer else None
        tb_writer = SummaryWriter(os.path.dirname(log_path)) if writer else None
        try:
            while examples_seen < target_examples:
                boundary = min([next_snapshot, next_sample, target_examples] + checkpoints_due[:1])
                n_steps = group_steps(examples_seen, boundary, cfg.total_batch_size, cfg.lookahead)
                seen = [examples_seen + j * cfg.total_batch_size for j in range(n_steps)]
                step = examples_seen // cfg.total_batch_size
                gens = [torch.Generator().manual_seed(step_seed(key, step + j)) for j in range(n_steps)]
                lrs = [self.lr_fn(e) for e in seen]
                weights = [self.loss_weights_fn(e) for e in seen]
                metrics = self.train_group(replica, optimizer, gens, lrs, weights)
                if in_group:
                    metrics = mesh.mean_over_ranks(metrics)
                examples_seen += n_steps * cfg.total_batch_size
                lr = lrs[-1]

                now = time.monotonic()
                if writer and now - last_log_time > cfg.log_every_seconds:
                    row = {k: float(v) for k, v in metrics.items()}
                    row.update(examples_seen=examples_seen, lr=lr, elapsed=now - t_start)
                    log_file.write(json.dumps(row) + "\n")
                    log_file.flush()
                    scalars = {f"training_{KEY_MODULE}_{k}_loss": row[k] for k in metrics}
                    scalars["learning_rate"] = lr
                    tb_writer.add_scalars(scalars, examples_seen)
                    tb_writer.flush()
                    logger.info("Showed %d training examples. loss=%.5f", examples_seen, row.get("loss", -1.0))
                    last_log_time = now

                if examples_seen >= next_snapshot:
                    self._save(ckpt.snapshot_dir(cfg.prefix), module, optimizer, examples_seen, key)
                    next_snapshot = get_least_greater_multiple(examples_seen, cfg.examples_per_snapshot)
                if sampling and examples_seen >= next_sample:
                    self._sample(module, examples_seen)
                    next_sample = get_least_greater_multiple(examples_seen, cfg.examples_per_sample_output)
                while checkpoints_due and examples_seen >= checkpoints_due[0]:
                    index = cfg.checkpoint_examples.index(checkpoints_due.pop(0)) + 1
                    self._save(ckpt.checkpoint_dir(cfg.prefix, index), module, optimizer, examples_seen, key)
                    logger.info("Wrote checkpoint %04d at %d examples", index, examples_seen)
        finally:
            if writer:
                log_file.close()
                tb_writer.close()
        return {"module": module, "optimizer": optimizer, "examples_seen": examples_seen, "key": key, "metrics": metrics}
