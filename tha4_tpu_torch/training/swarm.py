"""Swarm training: independent models trained side by side, no gradient
sync (counterpart of ``tha4_tpu/training/swarm.py``; the reference's
swarm_unit_trainer.py:332-344, torchrun as a plain launcher, each rank
training its own model from a rank -> trainer-factory dict).

  * ``train_process_unit``: this process trains the unit of its rank
    (``parallel.mesh.rank``), alone: the unit's trainer is made and run
    within ``parallel.mesh.alone()``, so that it, and any job that reads
    the world, take no part in the process group's data parallelism; a
    rank with no unit idles;
  * ``train_all``: one process trains every unit in turn.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from tha4_tpu_torch.parallel import mesh
from tha4_tpu_torch.training.trainer import Trainer

logger = logging.getLogger(__name__)


class SwarmTrainer:
    def __init__(self, unit_trainer_factories: Dict[int, Callable[[], Trainer]]):
        self.unit_trainer_factories = dict(unit_trainer_factories)

    def train_unit(self, unit: int, target_examples: Optional[int] = None):
        logger.info("Swarm unit %d starting", unit)
        with mesh.alone():
            return self.unit_trainer_factories[unit]().train(target_examples)

    def train_process_unit(self, target_examples: Optional[int] = None):
        unit = mesh.rank()
        if unit not in self.unit_trainer_factories:
            logger.info("Process %d has no swarm unit; idle", unit)
            return None
        return self.train_unit(unit, target_examples)

    def train_all(self, target_examples: Optional[int] = None) -> Dict[int, object]:
        return {unit: self.train_unit(unit, target_examples) for unit in sorted(self.unit_trainer_factories)}
