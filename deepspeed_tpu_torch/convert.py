"""Carry a JAX parameter tree across to the port.

``params_from_jax`` turns the tree ``deepspeed_tpu``'s ``TransformerLM.init``
produces (``models/transformer.py:283-312``: a nested dict of arrays, block
parameters stacked on a leading layer axis, ``Linear`` kernels stored
``[in, out]``) into a ``state_dict`` for the port's ``TransformerLM``:
blocks unstacked into ``blocks.{l}.*``, kernels transposed to ``[out, in]``
(the ``torch.nn.functional.linear`` layout), ``embedding``/``scale`` leaves
renamed ``weight``. The tree's leaves must already be host arrays (for
example after ``jax.device_get``); bf16 leaves keep their bits. A
weight-only-quantized subtree (``{"q", "scale"}`` in place of ``kernel``,
from the JAX ``quantize_param_tree`` or ``host_quantize_kernel``) becomes
``<layer>.q`` / ``<layer>.scale`` with the same bytes and no transpose: the
port's quantized ``Linear`` keeps the JAX storage layout.

A MoE block's leaves (``blocks.moe.{gate, wi_gate, wi_up, wi, wo}``, bare
arrays stacked ``[L, ...]``) become ``blocks.{l}.moe.*`` under the same
names. ``gate [H, E]`` keeps its layout; the expert weights are transposed
in their last two axes into the ``[out, in]`` layout the grouped FFN kernel
reads: ``wi_gate`` / ``wi_up`` / ``wi`` ``[E, H, F]`` -> ``[E, F, H]``, ``wo
[E, F, H]`` -> ``[E, H, F]``.

``opt_state_from_jax`` carries the JAX optimizer state (``step``, and the
``master`` / ``exp_avg`` / ``exp_avg_sq`` trees, each shaped like the
params; a Lion state has no ``exp_avg_sq``) across the same way, for ``DeepSpeedEngine.load_opt_state``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# JAX leaf name -> port parameter name
_LEAF = {"embedding": "weight", "scale": "weight", "kernel": "weight",
         "bias": "bias"}
# MoE leaves (bare arrays): name -> whether the last two axes transpose
_MOE_LEAF = {"gate": False, "wi_gate": True, "wi_up": True, "wi": True, "wo": True}


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no native bf16: move the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _leaf(name: str, a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2).contiguous() if name == "kernel" else a


def _port_name(name: str, leaves: Mapping[str, Any]) -> str:
    """The port's name of a JAX leaf; inside a quantized subtree ``q`` and
    ``scale`` keep theirs (elsewhere ``scale`` is a norm's weight)."""
    if "q" in leaves and name in ("q", "scale"):
        return name
    if name not in _LEAF:
        raise KeyError(f"unknown JAX parameter leaf {name!r}")
    return _LEAF[name]


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` params -> the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for top, sub in tree.items():
        if top == "blocks":
            for layer, leaves in sub.items():
                if layer == "moe":
                    for name, stacked in leaves.items():
                        if name not in _MOE_LEAF:
                            raise KeyError(f"unknown JAX MoE leaf {name!r}")
                        t = _tensor(stacked)
                        if _MOE_LEAF[name]:
                            t = t.transpose(-1, -2)
                        for l in range(t.shape[0]):
                            out[f"blocks.{l}.moe.{name}"] = t[l].contiguous()
                    continue
                for name, stacked in leaves.items():
                    t = _tensor(stacked)
                    for l in range(t.shape[0]):
                        out[f"blocks.{l}.{layer}.{_port_name(name, leaves)}"] = \
                            _leaf(name, t[l])
        else:
            for name, a in sub.items():
                out[f"{top}.{_port_name(name, sub)}"] = _leaf(name, _tensor(a))
    return out


def opt_state_from_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX ``Optimizer`` state -> ``{"step": int, slot: {name: tensor}}``
    in the port's parameter names and layouts."""
    out: Dict[str, Any] = {"step": int(np.asarray(state["step"]))}
    for slot, tree in state.items():
        if slot != "step":
            out[slot] = params_from_jax(tree)
    return out
