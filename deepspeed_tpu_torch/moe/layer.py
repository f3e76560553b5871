"""Mixture-of-experts layer of the port.

Counterpart of ``deepspeed_tpu/moe/layer.py``: ``moe_reference_forward``
(:39) and ``MoE`` (:83). The JAX ``MoE`` is a frozen dataclass whose params
pytree holds ``gate [H, E]``, ``wi_gate`` / ``wi_up`` (or ``wi``) ``[E, H, F]``
and ``wo [E, F, H]``; here ``MoE`` is an ``nn.Module`` that owns them, the
expert weights in the ``[out, in]`` layout the grouped FFN kernel reads:
``wi_gate`` / ``wi_up`` / ``wi`` ``[E, F, H]`` and ``wo [E, H, F]``
(``convert.params_from_jax`` transposes). ``forward`` runs the kernel path
of ``ops/transformer/moe.py`` (route, gather, grouped FFN and combine): the
kernels on CUDA tensors, their plain versions on CPU tensors.

``forward(x, dropless=True)`` routes with ``capacity_factor = E`` and
``min_capacity = 1`` (capacity = the token count, nothing dropped), as the
serving model's ``_moe_serve`` does (``inference/v2/model.py:83-96``).

Training: the parameters are made with ``requires_grad=False``, as every
layer of the port's is, and a training engine turns it on. With gradients
on, ``forward`` returns ``(out, aux)`` both differentiable: the kernel path
runs as one custom operator whose backward is the VJP of
``moe_reference_forward`` below, recomputed from the tokens and the weights
(``ops/transformer/moe.py``).

Not ported: the expert exchange over a mesh and the capacity-chunked
dispatch (ROADMAP A6), and what the JAX kernel does not serve either
(top_k > 2, fp16, other activations: they raise ``NotImplementedError``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..nn import layers as L
from ..ops.transformer import moe as moe_ops
from .sharded_moe import capacity as _capacity
from .sharded_moe import top_k_gating_indices

Params = Dict[str, torch.Tensor]


def moe_reference_forward(params: Params, tokens: torch.Tensor, *, top_k: int,
                          capacity: int, activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The XLA expert path of the JAX layer as one plain statement: gating ->
    capacity-slot gather -> batched FFN in the compute dtype -> weighted
    combine of the picked rows. ``tokens [T, H]`` -> ``(out [T, H], aux)``,
    params in the port's layout. Empty slots read token 0's row, as the JAX
    function does with ``mask_pad=False`` (its fp16 mask is not served)."""
    n_tok, h = tokens.shape
    dt = tokens.dtype
    e = params["gate"].shape[-1]
    logits = tokens @ params["gate"].to(dt)
    eidx, pos, keep, weight, aux, _ = top_k_gating_indices(logits, top_k, capacity)
    cap = capacity
    slot = torch.where(keep, eidx.long() * cap + pos.long(), e * cap).reshape(-1)
    src = torch.zeros(e * cap + 1, dtype=torch.int32, device=tokens.device)
    src[slot] = torch.arange(1, n_tok + 1, dtype=torch.int32,
                             device=tokens.device).repeat_interleave(top_k)
    src = src[:e * cap]
    expert_in = tokens[(src.long() - 1).clamp_min(0)].reshape(e, cap, h)
    if activation == "silu_gated":
        mid = (L.silu(torch.bmm(expert_in, params["wi_gate"].to(dt).mT))
               * torch.bmm(expert_in, params["wi_up"].to(dt).mT))
    else:
        mid = L.gelu(torch.bmm(expert_in, params["wi"].to(dt).mT))
    flat_out = torch.bmm(mid, params["wo"].to(dt).mT).reshape(e * cap, h)
    picked = flat_out[torch.where(keep, eidx.long() * cap + pos.long(), 0)]
    w = (weight * keep).to(dt)
    return (picked * w[:, :, None]).sum(dim=1), aux


class MoE(nn.Module):
    """Top-k gated mixture of experts over the last axis of its input."""

    def __init__(self, hidden_size: int, intermediate_size: int, num_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25, min_capacity: int = 4,
                 activation: str = "silu_gated", init_scale: float = L.INIT_SCALE,
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or torch.float32
        moe_ops.check_supported(top_k=top_k, activation=activation, dtype=dtype,
                                num_experts=num_experts)
        self.hidden_size, self.intermediate_size = hidden_size, intermediate_size
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.min_capacity = capacity_factor, min_capacity
        self.activation, self.init_scale = activation, init_scale
        e, h, f = num_experts, hidden_size, intermediate_size
        new = lambda *shape: nn.Parameter(torch.empty(*shape, device=device, dtype=dtype),
                                          requires_grad=False)
        self.gate = new(h, e)
        if activation == "silu_gated":
            self.wi_gate, self.wi_up = new(e, f, h), new(e, f, h)
        else:
            self.wi = new(e, f, h)
        self.wo = new(e, h, f)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """normal(0, init_scale) for every weight, in registration order."""
        for p in self.parameters():
            p.normal_(0.0, self.init_scale, generator=generator)

    def capacity(self, n_tokens: int, dropless: bool = False) -> int:
        if dropless:
            return _capacity(n_tokens, self.num_experts, float(self.num_experts), 1)
        return _capacity(n_tokens, self.num_experts, self.capacity_factor, self.min_capacity)

    def forward(self, x: torch.Tensor, dropless: bool = False, with_aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``x [..., H]`` -> ``(out [..., H], aux)``; aux None when not
        asked for (``with_aux=False`` saves its launches where no gradient is
        taken). Differentiable in ``x`` and the weights, through aux too."""
        tokens = x.reshape(-1, self.hidden_size)
        fwd = moe_ops.make_moe_forward(top_k=self.top_k,
                                       capacity=self.capacity(tokens.shape[0], dropless),
                                       activation=self.activation, with_aux=with_aux)
        out, aux = fwd(dict(self.named_parameters()), tokens)
        return out.reshape(x.shape), aux
