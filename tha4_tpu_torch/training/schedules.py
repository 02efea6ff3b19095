"""Learning-rate and loss-weight schedules keyed on examples seen
(counterpart of ``tha4_tpu/training/schedules.py``).  Host-side functions,
evaluated before every step."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence


@dataclass(frozen=True)
class TrainingPhase:
    num_examples_upper_bound: int
    learning_rate: float
    loss_weights: Dict[str, float] = field(default_factory=dict)


class TrainingPhases:
    """Piecewise-constant schedule over examples seen."""

    def __init__(self, phases: Sequence[TrainingPhase]):
        if not phases:
            raise ValueError("at least one phase")
        for a, b in zip(phases, phases[1:]):
            if a.num_examples_upper_bound >= b.num_examples_upper_bound:
                raise ValueError("phase bounds must increase")
        self.phases = list(phases)

    @property
    def total_examples(self) -> int:
        return self.phases[-1].num_examples_upper_bound

    def _phase_at(self, examples_seen: int) -> TrainingPhase:
        for phase in self.phases[:-1]:
            if examples_seen < phase.num_examples_upper_bound:
                return phase
        return self.phases[-1]

    def learning_rate(self, examples_seen: int) -> float:
        return self._phase_at(examples_seen).learning_rate

    def loss_weights(self, terms: Sequence[str], examples_seen: int) -> Dict[str, float]:
        phase = self._phase_at(examples_seen)
        return {t: phase.loss_weights.get(t, 0.0) for t in terms}


def step_lr_schedule(base_lr: float, boundaries: Sequence[int], divisors: Sequence[float]):
    """base_lr / divisor_i once examples seen reach boundary_i (the face
    student's ladder: /3, /10, /30 at 200k, 500k, 800k)."""
    if len(boundaries) != len(divisors):
        raise ValueError("one divisor per boundary")

    def lr(examples_seen: int) -> float:
        rate = base_lr
        for b, d in zip(boundaries, divisors):
            if examples_seen >= b:
                rate = base_lr / d
        return rate

    return lr
