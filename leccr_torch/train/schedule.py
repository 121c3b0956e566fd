"""LR schedule: linear warmup → linear decay to 0, stepped per optimizer
step (the port of `leccr_tpu/train/schedule.py`).

The first step's learning rate is `schedule(0)`, as with optax (whose
count is read before it is incremented): with a warmup, that is 0.
"""

from __future__ import annotations

from typing import Callable, Union


def resolve_warmup(num_warmup_steps: Union[float, int],
                   total_steps: int) -> int:
    """Warmup as a step count: an int is a count, a float a fraction of
    total_steps."""
    if isinstance(num_warmup_steps, float):
        if not 0.0 <= num_warmup_steps < 1.0:
            raise ValueError(f"a warmup fraction must be in [0, 1), got "
                             f"{num_warmup_steps}")
        return int(total_steps * num_warmup_steps)
    return int(num_warmup_steps)


def linear_warmup_decay(lr: float, total_steps: int,
                        num_warmup_steps: Union[float, int]
                        ) -> Callable[[int], float]:
    """step -> learning rate: lr · step/warmup while step < warmup, then
    lr · (total − step)/(total − warmup), clipped to [0, lr]."""
    warmup = resolve_warmup(num_warmup_steps, total_steps)

    def schedule(step: int) -> float:
        if step < warmup:
            frac = step / max(1.0, warmup)
        else:
            frac = (total_steps - step) / max(1.0, total_steps - warmup)
        return lr * min(max(frac, 0.0), 1.0)

    return schedule
