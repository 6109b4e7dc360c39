"""Learning-rate schedules: plain callables `step -> lr`.

Counterpart of the JAX package's `train/schedules.py`, with the semantics of
the optax schedules it builds on (`linear_schedule`, `join_schedules`,
`constant_schedule`).  The trainer sets the optimizer's lr from the schedule
before each update, at the number of updates made so far (optax's count).
"""

from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda step: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: from init_value to end_value over
    transition_steps, constant after; constant init_value when
    transition_steps <= 0."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(step):
        count = min(max(step, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def join_schedules(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """optax.join_schedules: schedule i + 1 takes over at boundary i, fed the
    steps counted from that boundary."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out

    return schedule


def keras_inverse_time_decay(base_lr: float, decay: float) -> Schedule:
    """Keras-1-style per-step decay: lr_t = lr / (1 + decay * step)."""
    return lambda step: base_lr / (1.0 + decay * step)


def warmup_linear_scaling(
    base_lr: float,
    n_replicas: int,
    steps_per_epoch: int,
    warmup_epochs: int = 5,
    batch_size_divider: float = 4.0,
    after: Schedule | None = None,
) -> Schedule:
    """Goyal-et-al linear scaling + warmup, the reference's Horovod recipe:
    a linear ramp from base_lr to base_lr * n_replicas / divider over
    warmup_epochs, then `after` (from step 0 of the post-warmup phase) or
    the scaled lr."""
    target = base_lr * n_replicas / batch_size_divider
    warmup_steps = warmup_epochs * steps_per_epoch
    warm = linear_schedule(base_lr, target, warmup_steps)
    tail = after if after is not None else constant_schedule(target)
    return join_schedules([warm, tail], [warmup_steps])
