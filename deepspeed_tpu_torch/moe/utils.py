"""MoE parameter utilities of the port.

Counterpart of ``deepspeed_tpu/moe/utils.py`` (``is_moe_spec``,
``expert_param_mask``, ``split_params_into_shared_and_expert_params``),
over the port's named parameters (``model.named_parameters()`` or a
``state_dict``) in place of a pytree and its PartitionSpecs. An expert
parameter is one the JAX specs shard over the ``expert`` axis
(``deepspeed_tpu/moe/layer.py`` ``MoE.specs``): a MoE layer's ``wi_gate``,
``wi_up``, ``wi`` and ``wo``, never its router ``gate``. The split is what
stays useful on one device: per-group optimizer hyperparameters over the
expert and the shared parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

#: the MoE leaves the JAX specs shard over the expert axis
EXPERT_LEAVES = ("wi_gate", "wi_up", "wi", "wo")


def is_moe_param(name: str) -> bool:
    """True for an expert weight: ``<...>.moe.<wi_gate | wi_up | wi | wo>``
    (the reference ``is_moe_param``, ``moe/utils.py:23``)."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in EXPERT_LEAVES


def expert_param_mask(params: Mapping[str, Any]) -> Dict[str, bool]:
    """``{name: True for an expert weight}`` over the same names."""
    return {name: is_moe_param(name) for name in params}


def split_params_into_shared_and_expert_params(
        params: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Two dicts of ``params``' keys, ``(shared, expert)``: each value in
    exactly one of them, ``None`` under its key in the other (reference
    ``moe/utils.py:29``)."""
    mask = expert_param_mask(params)
    shared = {n: None if mask[n] else p for n, p in params.items()}
    expert = {n: p if mask[n] else None for n, p in params.items()}
    return shared, expert
