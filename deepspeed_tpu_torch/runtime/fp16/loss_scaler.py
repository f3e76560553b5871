"""Loss scaling.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``. There the
state is a pytree of device scalars updated inside the jitted step; the
port steps eagerly, so the state is a small host dict and the overflow
check is one device reduction whose flag the engine reads (fp16 only).
Static scaling (``dynamic`` False) passes through unchanged.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

LossScaleState = Dict[str, object]


def static_loss_scale_state(scale: float) -> LossScaleState:
    return {"cur_scale": float(scale), "cur_hysteresis": 1,
            "last_overflow_iter": -1, "iter": 0, "dynamic": False}


def dynamic_loss_scale_state(initial_scale_power: int = 16,
                             hysteresis: int = 2) -> LossScaleState:
    state = static_loss_scale_state(2.0 ** initial_scale_power)
    state["dynamic"] = True
    state["cur_hysteresis"] = int(hysteresis)
    return state


def has_overflow(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global non-finite check over gradient tensors: a 0-d bool tensor."""
    flags = [torch.logical_not(torch.isfinite(g).all()) for g in grads]
    return torch.stack(flags).any()


def update_scale(state: LossScaleState, overflow: bool, *,
                 scale_window: int = 1000, min_scale: float = 1.0,
                 hysteresis: int = 2, scale_factor: float = 2.0,
                 consecutive_hysteresis: bool = False) -> LossScaleState:
    """One DynamicLossScaler step: on overflow consume hysteresis and, once
    exhausted, halve the scale (never below ``min_scale``); after
    ``scale_window`` clean iterations double it. With
    ``consecutive_hysteresis`` every clean step restores the budget."""
    it, cur, hyst = state["iter"], state["cur_scale"], state["cur_hysteresis"]
    last = state["last_overflow_iter"]
    if overflow:
        new_hyst = hyst - 1
        drop = new_hyst <= 0
        new_scale = max(cur / scale_factor, min_scale) if drop else cur
        new_hyst = hysteresis if drop else new_hyst
    else:
        grow = (it - last) % scale_window == scale_window - 1
        new_scale = cur * scale_factor if grow else cur
        new_hyst = hysteresis if consecutive_hysteresis else hyst
    out = dict(state)
    if state["dynamic"]:
        out["cur_scale"] = float(new_scale)
        out["cur_hysteresis"] = int(new_hyst)
    if overflow:
        out["last_overflow_iter"] = it
    out["iter"] = it + 1
    return out
