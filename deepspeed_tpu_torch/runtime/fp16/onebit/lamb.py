"""1-bit LAMB.

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/lamb.py``: LAMB while
``step <= freeze_step`` (no bias correction), each leaf's trust ratio
``clip(|p| / |update|, min_coeff, max_coeff)`` (1 where either norm is 0)
also kept as an EMA, ``lamb_coeff``; after it the variance and the
coefficients are frozen and only the momentum is synchronized by the
1-bit all-reduce. The state layout is ``onebit/adam.py``'s plus
``lamb_coeff`` (an fp32 scalar a leaf).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from .adam import OnebitAdam, OptState, onebit_init


@dataclasses.dataclass(frozen=True)
class OnebitLamb(OnebitAdam):
    max_coeff: float = 10.0
    min_coeff: float = 0.01
    coeff_beta: float = 0.9   # the EMA of the frozen trust coefficient

    name = "onebit_lamb"

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        state = onebit_init(params)
        state["lamb_coeff"] = {path: torch.ones((), dtype=torch.float32, device=p.device)
                               for path, p in params.items()}
        return state

    def _trust(self, p: torch.Tensor, update: torch.Tensor) -> torch.Tensor:
        w_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(update)
        ratio = torch.clamp(w_norm / u_norm, self.min_coeff, self.max_coeff)
        return torch.where((w_norm > 0) & (u_norm > 0), ratio, torch.ones_like(ratio))

    def _step(self, path, state, p, update, lr, warmup):
        coeff = state["lamb_coeff"][path]
        if not warmup:
            p.sub_(update.mul_(lr * coeff))
            return
        trust = self._trust(p, update)
        coeff.copy_(self.coeff_beta * coeff + (1 - self.coeff_beta) * trust)
        p.sub_(update.mul_(lr * trust))
