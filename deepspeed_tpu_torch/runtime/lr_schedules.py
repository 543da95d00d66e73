"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``):
``WarmupLR``, ``WarmupDecayLR``, ``OneCycle`` and ``LRRangeTest`` as
``step -> lr`` callables. Each computes in fp32, as the JAX schedules do
inside the jitted step, and returns the fp32 value as a Python float."""

import math
from typing import Callable, Optional

import torch

WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
ONE_CYCLE = "OneCycle"
LR_RANGE_TEST = "LRRangeTest"
VALID_LR_SCHEDULES = [WARMUP_LR, WARMUP_DECAY_LR, ONE_CYCLE, LR_RANGE_TEST]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _warmup(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type):
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step / warmup_num_steps, 0.0, 1.0)
        if warmup_type == "log":
            # log(step)/log(N) ramp as in the reference (guard step < 1)
            frac = torch.where(step < warmup_num_steps,
                               torch.log(torch.clamp(step, min=1.0)) / math.log(warmup_num_steps),
                               _f32(1.0))
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return schedule


def _as_float(fn) -> Callable[[int], float]:
    return lambda step: float(fn(_f32(step)))


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log") -> Callable[[int], float]:
    """Reference ``WarmupLR``: log or linear ramp, then constant."""
    return _as_float(_warmup(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type))


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Callable[[int], float]:
    """Reference ``WarmupDecayLR``: warmup, then linear decay to 0."""
    base = _warmup(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        decay = torch.clamp((total_num_steps - step) / max(1.0, total_num_steps - warmup_num_steps),
                            0.0, 1.0)
        return torch.where(step < warmup_num_steps, base(step), warmup_max_lr * decay)

    return _as_float(schedule)


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, **_unused) -> Callable[[int], float]:
    """Reference ``OneCycle``: the lr triangle and an optional decay tail
    (the momentum leg belongs to the optimizer config)."""
    if cycle_second_step_size is None:
        cycle_second_step_size = cycle_first_step_size
    total_cycle = cycle_first_step_size + cycle_second_step_size

    def schedule(step: torch.Tensor) -> torch.Tensor:
        up = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (step / cycle_first_step_size)
        down = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * ((step - cycle_first_step_size)
                                                               / cycle_second_step_size)
        in_cycle = torch.where(step < cycle_first_step_size, up,
                               torch.maximum(down, _f32(cycle_min_lr)))
        if decay_step_size > 0:
            decay_steps = torch.clamp(step - total_cycle, min=0.0) / decay_step_size
            tail = cycle_min_lr * (1.0 / (1.0 + decay_lr_rate * decay_steps))
            return torch.where(step > total_cycle, tail, in_cycle)
        return in_cycle

    return _as_float(schedule)


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Callable[[int], float]:
    """Reference ``LRRangeTest``: a linearly or staircase increasing lr."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return _as_float(schedule)


_SCHEDULES = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    ONE_CYCLE: one_cycle,
    LR_RANGE_TEST: lr_range_test,
}


def get_lr_schedule(name: str, params: dict) -> Callable[[int], float]:
    if name not in _SCHEDULES:
        raise ValueError(f"unknown lr schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    return _SCHEDULES[name](**params)
