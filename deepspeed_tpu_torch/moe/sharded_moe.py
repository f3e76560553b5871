"""Gating math of the port's mixture of experts.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py``: ``capacity`` (:25) and
``top_k_gating_indices`` (:32), in plain torch. This is the route's
reference: the fused route kernel (``ops/transformer/moe.py``,
``csrc/moe_route.cu``) repeats its fp32 operations in the same order, so
the picks, positions and kept choices of the two agree bit for bit.

The order of operations is the JAX one:

- the softmax in fp32 (max subtracted, ``exp``, the sum over the experts
  taken in index order, one divide);
- the top-k pick as a masked re-argmax over the *gates* (not the logits:
  softmax can map two different logits to one fp32 gate), the lowest index
  winning ties, as ``lax.top_k`` does;
- choice by choice, each token's rank among the tokens that picked the same
  expert (a cumsum), offset by the expert's kept total of the earlier
  choices, then the capacity clamp;
- the gates of the kept choices normalised by their sum (at least 1e-9).

The expert exchange over a mesh (``_AllToAll``, the dense one-hot
``top_k_gating``) is not ported: it waits for a live expert axis (ROADMAP
A6).
"""

from __future__ import annotations

from typing import Tuple

import torch


def capacity(num_tokens: int, num_experts: int, capacity_factor: float,
             min_capacity: int) -> int:
    """Tokens per expert (the reference ``_capacity``)."""
    cap = int(num_tokens * capacity_factor * 1.0 / num_experts)
    return max(cap, min_capacity)


def softmax_fp32(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in fp32, the sum over the experts taken in
    index order (the route kernel's order)."""
    x = logits.float()
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    s = e[..., 0]
    for j in range(1, e.shape[-1]):
        s = s + e[..., j]
    return e / s[..., None]


def top_k_gating_indices(logits: torch.Tensor, top_k: int, capacity_: int
                         ) -> Tuple[torch.Tensor, ...]:
    """Top-k gate with capacity, in index form. ``logits`` [tokens, experts].

    Returns ``expert_idx [T, k]`` int32, ``pos [T, k]`` int32 (the slot in
    the expert's bucket, clamped to ``capacity_ - 1``), ``keep [T, k]`` bool,
    ``weight [T, k]`` fp32 (normalised; 0 where dropped), ``aux_loss``
    (GShard: ``sum(me * ce) * E``) and ``me [E]`` (mean gate)."""
    tokens, num_experts = logits.shape
    gates = softmax_fp32(logits)
    picked = gates
    idxs = []
    for _ in range(top_k):
        idx = torch.argmax(picked, dim=1)       # the first maximum: lowest index
        idxs.append(idx)
        picked = picked.masked_fill(
            torch.nn.functional.one_hot(idx, num_experts).bool(), float("-inf"))
    # means as sums divided by the count, as jnp.mean computes them; the
    # count is a device tensor because torch on CUDA multiplies by the
    # reciprocal of a Python number (mean too): another rounding
    mask1 = torch.nn.functional.one_hot(idxs[0], num_experts).float()
    count = torch.full((), tokens, dtype=torch.float32, device=logits.device)
    me = gates.sum(dim=0) / count
    ce = mask1.sum(dim=0) / count
    aux_loss = (me * ce).sum() * num_experts

    counts = torch.zeros(num_experts, dtype=torch.int32, device=logits.device)
    gate_sum = torch.zeros(tokens, dtype=torch.float32, device=logits.device)
    poss, keeps, gatews = [], [], []
    for idx_k in idxs:
        mask_k = torch.nn.functional.one_hot(idx_k, num_experts).int()
        pos_in_expert = torch.cumsum(mask_k, dim=0, dtype=torch.int32) - mask_k
        pos_k = (pos_in_expert * mask_k).sum(dim=1, dtype=torch.int32) + counts[idx_k]
        keep = pos_k < capacity_
        gate_k = gates.gather(1, idx_k[:, None])[:, 0] * keep
        poss.append(torch.clamp_max(pos_k, capacity_ - 1))
        keeps.append(keep)
        gatews.append(gate_k)
        counts = counts + (mask_k * keep[:, None]).sum(dim=0, dtype=torch.int32)
        gate_sum = gate_sum + gate_k
    denom = torch.clamp_min(gate_sum, 1e-9)
    weight = torch.stack(gatews, dim=1) / denom[:, None]
    return (torch.stack(idxs, dim=1).int(), torch.stack(poss, dim=1).int(),
            torch.stack(keeps, dim=1), weight, aux_loss, me)
