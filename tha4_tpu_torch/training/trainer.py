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

Eager PyTorch runs one optimizer step per iteration: the JAX trainer's
chunk planning and compile-ahead exist for XLA's compiled multi-step
programs and have no counterpart here, nor has its validation hook, which
no distillation job sets.  A step's randomness comes from a
``torch.Generator`` seeded from (the run's key, the step index), so a step's
batch does not depend on where a run stopped and resumed.
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


class Trainer:
    """Drives one student's training.

      init_module(generator) -> nn.Module (on its device)
      make_optimizer(module) -> torch.optim.Optimizer
      train_step(module, optimizer, generator, lr, loss_weights) -> {name: scalar tensor}
          one optimizer step; ``generator`` is this step's own
      lr_fn(examples_seen) -> float
      loss_weights_fn(examples_seen) -> {term: float} (default: none, {})
      sample_output_fn(module, examples_seen) -> None (writes sample PNGs);
          it must leave the module as it found it and draw from no
          generator of the steps
    """

    def __init__(
        self,
        cfg: TrainerConfig,
        init_module: Callable[[torch.Generator], nn.Module],
        make_optimizer: Callable[[nn.Module], torch.optim.Optimizer],
        train_step: Callable,
        lr_fn: Callable[[int], float],
        loss_weights_fn: Optional[Callable[[int], Dict[str, float]]] = None,
        sample_output_fn: Optional[Callable[[nn.Module, int], None]] = None,
    ):
        self.cfg = cfg
        self.init_module = init_module
        self.make_optimizer = make_optimizer
        self.train_step = train_step
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

    def _save(self, directory: str, module, optimizer, examples_seen: int, key: int) -> None:
        ckpt.save_state(directory, {KEY_MODULE: module}, {KEY_MODULE: optimizer}, examples_seen, key)

    def _load_or_init(self, target_examples: int):
        module, optimizer, key = self._fresh_state()
        resume = ckpt.find_resume_dir(self.cfg.prefix, target_examples, self.cfg.total_batch_size, [KEY_MODULE])
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
            if not ckpt.can_load(directory, [KEY_MODULE]):
                self._save(directory, module, optimizer, examples_seen, key)
                logger.info("Wrote the missing checkpoint %s at %d examples", directory, examples_seen)
        next_snapshot = get_least_greater_multiple(examples_seen, cfg.examples_per_snapshot)
        checkpoints_due = [c for c in cfg.checkpoint_examples if examples_seen < c <= target_examples]
        sampling = self.sample_output_fn is not None
        if sampling:
            next_sample = get_least_greater_multiple(max(examples_seen - 1, 0), cfg.examples_per_sample_output)
            if examples_seen == 0:
                self.sample_output_fn(module, examples_seen)
                next_sample = cfg.examples_per_sample_output
        metrics: Dict[str, torch.Tensor] = {}
        t_start = last_log_time = time.monotonic()
        log_file = open(log_path, "a")
        tb_writer = SummaryWriter(os.path.dirname(log_path))
        try:
            while examples_seen < target_examples:
                lr = self.lr_fn(examples_seen)
                weights = self.loss_weights_fn(examples_seen)
                step = examples_seen // cfg.total_batch_size
                metrics = self.train_step(module, optimizer, torch.Generator().manual_seed(step_seed(key, step)), lr, weights)
                examples_seen += cfg.total_batch_size

                now = time.monotonic()
                if now - last_log_time > cfg.log_every_seconds:
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
                    self.sample_output_fn(module, examples_seen)
                    next_sample = get_least_greater_multiple(examples_seen, cfg.examples_per_sample_output)
                while checkpoints_due and examples_seen >= checkpoints_due[0]:
                    index = cfg.checkpoint_examples.index(checkpoints_due.pop(0)) + 1
                    self._save(ckpt.checkpoint_dir(cfg.prefix, index), module, optimizer, examples_seen, key)
                    logger.info("Wrote checkpoint %04d at %d examples", index, examples_seen)
        finally:
            log_file.close()
            tb_writer.close()
        return {"module": module, "optimizer": optimizer, "examples_seen": examples_seen, "key": key, "metrics": metrics}
