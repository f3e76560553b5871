"""0/1 Adam.

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/zoadam.py``: 1-bit Adam
with local steps. The momentum is updated locally every step and
synchronized by the 1-bit all-reduce only on a sync boundary (``step %
local_interval == 0``, the interval ``2 ** min(step // local_step_scaler,
10)`` doubling as training goes); the variance is refreshed from the
momentum while ``step <= var_freeze_step`` on its own doubling interval
(``var_update_scaler``), counted by ``var_counter``, then frozen. The
update is bias-corrected, the variance's correction by ``var_counter``.
Between sync boundaries the ranks step on their own momentum, so their
masters differ until the next one.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch

from .adam import OptState, WriteBack, compress, onebit_init


@dataclasses.dataclass(frozen=True)
class ZeroOneAdam:
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    var_freeze_step: int = 100
    var_update_scaler: int = 16     # the variance's refresh interval
    local_step_scaler: int = 4      # the momentum's sync interval

    name = "zero_one_adam"

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        state = onebit_init(params)
        state["var_counter"] = 0    # variance updates so far
        return state

    def phase(self, step: int) -> Tuple[bool, bool]:
        """``(sync_boundary, var_update)`` of step ``step`` (1-based)."""
        local_interval = 2 ** min(step // self.local_step_scaler, 10)
        var_interval = 2 ** min(step // self.var_update_scaler, 10)
        return (step % local_interval == 0,
                step <= self.var_freeze_step and step % var_interval == 0)

    def update(self, local_grads: Mapping[str, torch.Tensor], state: OptState, lr,
               write_back: WriteBack = None):
        b1, b2 = self.betas
        step = state["step"] + 1
        sync, var_update = self.phase(step)
        var_counter = state["var_counter"] + int(var_update)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = 1.0 - f32(b1) ** f32(step)
        bc2 = 1.0 - f32(b2) ** f32(max(var_counter, 1))
        for path, p in state["master"].items():
            m = b1 * state["exp_avg"][path] + (1 - b1) * local_grads[path].float()
            if sync:
                m = compress(state, path, m)
            v = state["exp_avg_sq"][path]
            if var_update:
                v = b2 * v + (1 - b2) * m * m
            bc1_, bc2_ = bc1.to(p.device), bc2.to(p.device)
            p.copy_(p - lr * ((m / bc1_) / (torch.sqrt(v / bc2_) + self.eps)
                              + self.weight_decay * p))
            state["exp_avg"][path].copy_(m)
            state["exp_avg_sq"][path].copy_(v)
            if write_back is not None:
                write_back(path, p)
        state["step"], state["var_counter"] = step, var_counter
        return state["master"], state
