"""LR schedules selectable from config.

The port's copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (pure Python,
no tensors): ``LRRangeTest``, ``OneCycle``, ``WarmupLR``, ``WarmupDecayLR``,
``WarmupCosineLR`` as ``step -> lr`` callables behind the torch-scheduler
surface the engine drives (``step()``/``get_lr()``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

VALID_LR_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR", "WarmupCosineLR"]


class LRSchedule:
    """Minimal stateful wrapper matching the torch-scheduler surface the
    reference engine drives (``step()``/``get_last_lr()``)."""

    def __init__(self, fn, base_lr: float):
        self._fn = fn
        self._base_lr = base_lr
        # torch schedulers run an implicit step() at construction, so the
        # first optimizer step sees iteration 0 and the second sees 1.
        self.last_batch_iteration = 0

    def step(self, increment: int = 1):
        self.last_batch_iteration += increment

    def get_lr(self) -> float:
        return float(self._fn(max(self.last_batch_iteration, 0)))

    def get_last_lr(self):
        return [self.get_lr()]

    def state_dict(self) -> Dict[str, Any]:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict[str, Any]):
        self.last_batch_iteration = sd["last_batch_iteration"]


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_) -> LRSchedule:
    """Reference ``WarmupLR`` (lr_schedules.py:634): warm up then hold."""
    warmup_num_steps = max(2, warmup_num_steps)

    def fn(step: int) -> float:
        if step < warmup_num_steps:
            if warmup_type == "log":
                gamma = math.log(step + 1) / math.log(warmup_num_steps)
            else:
                gamma = step / warmup_num_steps
            return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma
        return warmup_max_lr

    return LRSchedule(fn, warmup_max_lr)


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> LRSchedule:
    """Reference ``WarmupDecayLR`` (:723): warmup then linear decay to 0."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def fn(step: int) -> float:
        if step < warmup_num_steps:
            return warm._fn(step)
        frac = (total_num_steps - step) / max(1, total_num_steps - warmup_num_steps)
        return warmup_max_lr * max(0.0, frac)

    return LRSchedule(fn, warmup_max_lr)


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_type: str = "linear", lr: float = 0.001, **_) -> LRSchedule:
    """Reference ``WarmupCosineLR`` (:774): ratios of the base lr."""

    def fn(step: int) -> float:
        if step < warmup_num_steps:
            if warmup_type == "log":
                ratio = warmup_min_ratio + (1 - warmup_min_ratio) * (
                    math.log(step + 1) / math.log(max(2, warmup_num_steps)))
            else:
                ratio = warmup_min_ratio + (1 - warmup_min_ratio) * step / max(1, warmup_num_steps)
        else:
            progress = (step - warmup_num_steps) / max(1, total_num_steps - warmup_num_steps)
            progress = min(1.0, progress)
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * progress))
        return lr * ratio

    return LRSchedule(fn, lr)


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, cycle_first_step_size: int = 2000,
              cycle_second_step_size: int = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, **_) -> LRSchedule:
    """Reference ``OneCycle`` (:370), lr phases only (momentum cycling is a
    no-op for our stateless optimizers' config)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size

    def fn(step: int) -> float:
        if step < cycle_first_step_size:
            frac = step / cycle_first_step_size
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
        if step < cycle_first_step_size + second:
            frac = (step - cycle_first_step_size) / second
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * frac
        if decay_step_size > 0:
            decay_steps = (step - cycle_first_step_size - second) / decay_step_size
            return cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        return cycle_min_lr

    return LRSchedule(fn, cycle_max_lr)


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  **_) -> LRSchedule:
    """Reference ``LRRangeTest`` (:267)."""

    def fn(step: int) -> float:
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1 + interval * lr_range_test_step_rate)

    return LRSchedule(fn, lr_range_test_min_lr)


_FACTORIES = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "OneCycle": one_cycle,
    "LRRangeTest": lr_range_test,
}


def build_lr_schedule(scheduler_config, base_lr: float) -> LRSchedule:
    if scheduler_config is None or scheduler_config.type is None:
        return LRSchedule(lambda step: base_lr, base_lr)
    if scheduler_config.type not in _FACTORIES:
        raise ValueError(
            f"Unknown scheduler '{scheduler_config.type}'; valid: {VALID_LR_SCHEDULES}")
    params = dict(scheduler_config.params)
    if scheduler_config.type == "WarmupCosineLR":
        params.setdefault("lr", base_lr)
    return _FACTORIES[scheduler_config.type](**params)
