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

Top-level subtrees may nest: an encoder's MLM head
(``mlm.{dense, ln}`` layers beside the bare decoder bias ``mlm.bias``) and
a task model's ``head.{mid, classifier}`` become ``mlm.dense.weight``,
``mlm.bias``, ``head.classifier.weight`` and so on.

A MoE block's leaves (``blocks.moe.{gate, wi_gate, wi_up, wi, wo}``, bare
arrays stacked ``[L, ...]``) become ``blocks.{l}.moe.*`` under the same
names. ``gate [H, E]`` keeps its layout; the expert weights are transposed
in their last two axes into the ``[out, in]`` layout the grouped FFN kernel
reads: ``wi_gate`` / ``wi_up`` / ``wi`` ``[E, H, F]`` -> ``[E, F, H]``, ``wo
[E, F, H]`` -> ``[E, H, F]``.

``opt_state_from_jax`` carries the JAX optimizer state (``step``, and the
``master`` / ``exp_avg`` / ``exp_avg_sq`` trees, each shaped like the
params; a Lion state has no ``exp_avg_sq``) across the same way, for ``DeepSpeedEngine.load_opt_state``.

The way back, for checkpoints in the JAX on-disk format: ``params_to_jax`` /
``opt_state_to_jax`` invert the two (host arrays, bf16 as its bits,
``BF16_BITS``), ``jax_leaves`` yields the leaves one at a time, and
``JaxLeaf`` maps a port leaf, or a region of it such as a ZeRO shard, to
its place in the stacked JAX leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# JAX leaf name -> port parameter name
_LEAF = {"embedding": "weight", "scale": "weight", "kernel": "weight",
         "bias": "bias"}
# MoE leaves (bare arrays): name -> whether the last two axes transpose
_MOE_LEAF = {"gate": False, "wi_gate": True, "wi_up": True, "wi": True, "wo": True}
# port modules whose ``weight`` is a JAX ``Embedding``'s ``embedding``
_EMBEDDINGS = ("wte", "wpe", "wtt")
#: a bf16 leaf on the host: its two bytes a value, as ``np.savez`` writes an
#: ``ml_dtypes`` bfloat16 array (numpy has no bf16 of its own)
BF16_BITS = np.dtype("V2")


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:  # numpy has no bf16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
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
            _from_subtree(top, sub, out)
    return out


def _from_subtree(prefix: str, sub: Mapping[str, Any], out: Dict[str, torch.Tensor]) -> None:
    """A top-level subtree that is not stacked: a layer's leaves, or nested
    layers (``mlm.{dense, ln, bias}``, ``head.{mid, classifier}``)."""
    for name, a in sub.items():
        if isinstance(a, Mapping):
            _from_subtree(f"{prefix}.{name}", a, out)
        else:
            out[f"{prefix}.{_port_name(name, sub)}"] = _leaf(name, _tensor(a))


def opt_state_from_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX ``Optimizer`` state -> ``{"step": int, slot: {name: tensor}}``
    in the port's parameter names and layouts."""
    out: Dict[str, Any] = {"step": int(np.asarray(state["step"]))}
    for slot, tree in state.items():
        if slot != "step":
            out[slot] = params_from_jax(tree)
    return out


# -- the way back: the port's names and layouts to the JAX tree ---------------


def host_array(t: torch.Tensor) -> np.ndarray:
    """A C-ordered host copy of ``t`` as numpy (bf16 as ``BF16_BITS``);
    never a view of ``t``'s storage, so a later in-place update of ``t``
    leaves it."""
    t = t.detach().contiguous().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of a leaf read from a checkpoint, whose ``meta.json``
    dtype is ``dtype`` (a bf16 leaf arrives as its ``uint16`` bits)."""
    a = np.ascontiguousarray(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """Where a port leaf lives in the JAX tree: the leaf's ``/``-joined path,
    its layer on the stacked leading axis (None for a leaf that is not
    stacked) and whether its last two axes are transposed (``kernel``s and
    the MoE expert weights)."""
    path: str
    layer: Optional[int]
    transpose: bool

    def shape(self, port_shape: Sequence[int], num_layers: int) -> Tuple[int, ...]:
        """The JAX leaf's shape from one port leaf's shape."""
        s = list(port_shape)
        if self.transpose:
            s[-2], s[-1] = s[-1], s[-2]
        return tuple(([num_layers] if self.layer is not None else []) + s)

    def span(self, region: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
        """A region of the port leaf (a ``(start, stop)`` a dim) as a span of
        the JAX leaf: the layer's ``l:l+1`` first, then the dims in JAX order."""
        r = list(region)
        if self.transpose:
            r[-2], r[-1] = r[-1], r[-2]
        return ([(self.layer, self.layer + 1)] if self.layer is not None else []) + r

    def swap_layout(self, t: torch.Tensor) -> torch.Tensor:
        """A port tensor in the JAX leaf's axis order (no layer axis), or a
        JAX one in the port's: the transpose is its own inverse."""
        return t.transpose(-1, -2) if self.transpose else t


def jax_leaf(name: str, ndim: int) -> JaxLeaf:
    """The JAX leaf of the port parameter ``name`` (of ``ndim`` dims): the
    inverse of the naming in ``params_from_jax``."""
    parts = name.split(".")
    layer, prefix = None, ""
    if parts[0] == "blocks":
        layer, prefix, parts = int(parts[1]), "blocks/", parts[2:]
        if parts[0] == "moe":
            if len(parts) != 2 or parts[1] not in _MOE_LEAF:
                raise KeyError(f"unknown port MoE leaf {name!r}")
            return JaxLeaf(f"blocks/moe/{parts[1]}", layer, _MOE_LEAF[parts[1]])
    if len(parts) < 2 or parts[-1] not in ("weight", "bias", "q", "scale") or \
            (layer is not None and len(parts) != 2):
        raise KeyError(f"unknown port parameter {name!r}")
    module, leaf = "/".join(parts[:-1]), parts[-1]
    if leaf != "weight":   # a bias, or a quantized kernel's leaves (the JAX layout)
        return JaxLeaf(f"{prefix}{module}/{leaf}", layer, False)
    jname = ("embedding" if module in _EMBEDDINGS else "scale" if ndim == 1 else "kernel")
    return JaxLeaf(f"{prefix}{module}/{jname}", layer, jname == "kernel")


def to_jax_leaf(members: Sequence[Tuple[JaxLeaf, torch.Tensor]]) -> torch.Tensor:
    """The JAX leaf, on the tensors' device, of port tensors that share one
    path: the layers stacked in order on the leading axis, or the one
    tensor of a leaf that is not stacked; each in the JAX axis order."""
    if members[0][0].layer is None:
        jl, t = members[0]
        return jl.swap_layout(t.detach())
    members = sorted(members, key=lambda m: m[0].layer)
    if [m[0].layer for m in members] != list(range(len(members))):
        raise ValueError(f"{members[0][0].path}: the port holds layers "
                         f"{[m[0].layer for m in members]}, not 0..L-1")
    return torch.stack([jl.swap_layout(t.detach()) for jl, t in members])


def jax_leaves(tensors: Mapping[str, torch.Tensor]) -> Iterator[Tuple[str, np.ndarray]]:
    """``(JAX path, host array)`` of every leaf of the port tensors
    ``tensors`` (a ``state_dict`` or a slot of the optimizer state), one
    leaf at a time: a stacked leaf is built on the tensors' device, then
    copied to the host once."""
    groups: Dict[str, List[Tuple[JaxLeaf, torch.Tensor]]] = {}
    for name, t in tensors.items():
        jl = jax_leaf(name, t.dim())
        groups.setdefault(jl.path, []).append((jl, t))
    for path, members in groups.items():
        yield path, host_array(to_jax_leaf(members))


def _nest(flat: Iterator[Tuple[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, a in flat:
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = a
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> the JAX ``TransformerLM`` params tree
    of host arrays (bf16 as ``BF16_BITS``): the inverse of
    ``params_from_jax``."""
    return _nest(jax_leaves(state_dict))


def opt_state_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state -> the JAX ``Optimizer`` state (``step``
    an int32 scalar, each slot a params tree): the inverse of
    ``opt_state_from_jax``. The fused optimizers' bucket list is left out:
    the slots are views into it."""
    out: Dict[str, Any] = {"step": np.asarray(state["step"], np.int32)}
    for slot, tree in state.items():
        if slot not in ("step", "buckets"):
            out[slot] = params_to_jax(tree)
    return out
