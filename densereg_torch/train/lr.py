"""Learning-rate schedule: staircase exponential decay."""

from __future__ import annotations


def staircase_exponential_decay(init_lr: float, decay_steps: int,
                                decay_factor: float):
    """``count -> init_lr * decay_factor ** (count // max(decay_steps, 1))``,
    evaluated at the optimizer's update count before it increments (the
    first update uses ``init_lr``), as ``optax.exponential_decay(...,
    staircase=True)`` is."""
    steps = max(int(decay_steps), 1)
    return lambda count: init_lr * decay_factor ** (int(count) // steps)
