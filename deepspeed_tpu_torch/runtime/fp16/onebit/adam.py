"""1-bit Adam.

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/adam.py``: Adam without
bias correction while ``step <= freeze_step`` (the gradients averaged over
the ranks at full width); after it the variance is frozen and only the
momentum is synchronized, by the error-compensated 1-bit all-reduce
(``runtime/comm/compressed.py``).

The optimizers of this package take the JAX tree's leaves: ``init`` and
``update`` are keyed by the JAX leaf path (``convert.jax_leaf``), each
tensor in the JAX leaf's layout (the layers stacked, kernels ``[in,
out]``), because the compression's scales are means over a whole JAX leaf
and LAMB's trust ratio a norm over one. ``update`` takes this rank's local
gradients (fp32 after the unscale) and steps the state in place, leaf by
leaf, in place (each JAX formula's operations in its order, so the values
are the JAX function's); ``write_back(path, master)`` is called once a
leaf's master is new, so the caller can cast its parameters without a
second full copy. The
phase is chosen on the host from the step count, a Python int stored as
JAX stores it (int32 in a tag).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ....comm import comm as dist
from ....utils.groups import DATA_AXIS
from ...comm.compressed import compressed_allreduce, error_state

OptState = Dict[str, Any]
WriteBack = Optional[Callable[[str, torch.Tensor], None]]


def onebit_init(params: Mapping[str, torch.Tensor]) -> OptState:
    """The state every 1-bit optimizer starts from: step 0, fp32 master
    copies, zero moments and zero worker / server errors (for the world's
    ranks)."""
    n = dist.get_world_size()
    state: OptState = {"step": 0, "master": {}, "exp_avg": {}, "exp_avg_sq": {},
                       "worker_error": {}, "server_error": {}}
    for path, p in params.items():
        state["master"][path] = p.detach().float().clone()
        state["exp_avg"][path] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state["exp_avg_sq"][path] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        we, se = error_state(p.numel(), n, p.device)
        state["worker_error"][path], state["server_error"][path] = we, se
    return state


def rank_mean(g: torch.Tensor) -> torch.Tensor:
    """The warm-up's full-width gradient average over the ranks (the JAX
    ``pmean``)."""
    dist.record_collective("all_reduce", g.numel() * 4, DATA_AXIS, overlapped=False)
    return dist.all_reduce(g.float()).div_(dist.get_world_size())


def compress(state: OptState, path: str, m_local: torch.Tensor) -> torch.Tensor:
    """``m_local`` through the compressed all-reduce against the leaf's
    carried errors, which are replaced; returns the synchronized value."""
    m, state["worker_error"][path], state["server_error"][path] = compressed_allreduce(
        m_local, state["worker_error"][path], state["server_error"][path])
    return m


@dataclasses.dataclass(frozen=True)
class OnebitAdam:
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    freeze_step: int = 100

    name = "onebit_adam"

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return onebit_init(params)

    def update(self, local_grads: Mapping[str, torch.Tensor], state: OptState, lr,
               write_back: WriteBack = None):
        """One step from this rank's local gradients; ``(master, state)``,
        both the state's own dicts, updated in place."""
        b1, b2 = self.betas
        step = state["step"] + 1
        warmup = step <= self.freeze_step
        for path, p in state["master"].items():
            m, v = state["exp_avg"][path], state["exp_avg_sq"][path]
            g = local_grads[path].float()
            if warmup:
                g = rank_mean(g)
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
            else:
                m.copy_(compress(state, path, m.mul_(b1).add_((1 - b1) * g)))
            del g
            update = m / torch.sqrt(v).add_(self.eps)
            if self.weight_decay:
                update.add_(self.weight_decay * p)
            self._step(path, state, p, update, lr, warmup)
            if write_back is not None:
                write_back(path, p)
        state["step"] = step
        return state["master"], state

    def _step(self, path, state, p, update, lr, warmup):
        """``p -= lr * update`` in place (1-bit LAMB scales ``update``)."""
        p.sub_(update.mul_(lr))
