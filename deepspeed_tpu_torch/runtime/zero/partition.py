"""ZeRO partition plan of the port: which dim of each leaf is sharded over
the data-parallel ranks, for params, gradients and optimizer state.

Counterpart of ``deepspeed_tpu/runtime/zero/partition.py``. The JAX plan
is a tree of ``PartitionSpec``s that GSPMD turns into collectives; the
port's plan is a dict ``{leaf name: shard dim or None}`` over its own leaf
shapes (per-layer ``[out, in]`` weights), which the data-parallel engine
turns into explicit ``torch.distributed`` collectives. The rule is
``add_axes_to_spec``'s (``:144-183``) on a leaf with no tensor-parallel
axis: shard the largest dim that the world divides, the later dim on a
tie; a leaf below ``min_size`` elements stays replicated. By stage
(``:233-250``): params sharded at stage 3 above
``stage3_param_persistence_threshold``, gradients at stage >= 2, the fp32
master and moments at stage >= 1.

Rank r's shard of a leaf sharded over dim d is the slice
``[r * s, (r + 1) * s)`` of dim d, s = size / n: what the JAX mesh
places on the r-th device of the data axis.

``BucketEntry`` and ``plan_comm_buckets`` (``:67-127``) plan the overlap
schedule's launches (``runtime/zero/overlap.py``): small leaves fused into
one flat collective, oversize leaves split into chunks. Pure Python, the
JAX function line for line.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ...utils.groups import DATA_AXIS, EXPERT_AXIS, MICS_AXIS, SEQ_AXIS
from .config import DeepSpeedZeroConfig

ShardDims = Dict[str, Optional[int]]


def dp_axes_in(spec: Sequence) -> Tuple[Optional[int], Tuple[str, ...]]:
    """``(dim, dp_axes)`` of the ZeRO-sharded dim of a partition spec (a
    sequence of ``None``, axis names or tuples of them), or ``(None, ())``."""
    dp_set = (DATA_AXIS, MICS_AXIS, EXPERT_AXIS, SEQ_AXIS)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        ax = entry if isinstance(entry, (tuple, list)) else (entry,)
        dp = tuple(a for a in ax if a in dp_set)
        if dp:
            return dim, dp
    return None, ()


@dataclasses.dataclass(frozen=True)
class BucketEntry:
    """One collective launch of the overlap schedule: several small leaves
    fused into one flat gather / scatter, or one big leaf split into
    ``chunks`` pipelined launches."""
    leaves: Tuple[int, ...]   # leaf indices (flatten order) in this launch
    chunks: int = 1           # >1 only for single-leaf entries


def plan_comm_buckets(sizes: Sequence[int], keys: Sequence[Any],
                      extents: Sequence[Optional[int]], bucket_elems: int,
                      max_chunks: int = 16) -> Tuple[List[BucketEntry], List[int]]:
    """The bucket plan of one launch set (gathers or reductions) over a
    leaf list, in flatten order.

    ``sizes``: full element counts. ``keys``: fuse-compatibility key a
    leaf (axes and dtype); only leaves of one key share a launch.
    ``extents``: the shard's leading extent with the dp dim moved to front
    (chunk bounds divide it); None marks a replicated leaf, which never
    fuses or chunks.

    A leaf of ``size >= bucket_elems`` stands alone, split into the smallest
    divisor of its extent (at most ``max_chunks``) that brings each chunk
    under the bucket; smaller leaves pack greedily, per key, into fused
    launches that stay under it. Returns ``(entries, oversize)``:
    ``oversize`` lists the leaves still above the bucket after the best
    split."""
    bucket = int(bucket_elems)
    entries: List[BucketEntry] = []
    oversize: List[int] = []
    open_groups: dict = {}  # key -> [idx list, total elems]

    def close(key):
        g = open_groups.pop(key, None)
        if g:
            entries.append(BucketEntry(leaves=tuple(g[0])))

    for i, (sz, key, ext) in enumerate(zip(sizes, keys, extents)):
        if ext is None or bucket <= 0:
            entries.append(BucketEntry(leaves=(i,)))
            continue
        if sz >= bucket:
            chunks = 1
            for c in range(1, min(int(ext), max_chunks) + 1):
                if ext % c == 0:
                    chunks = c
                    if sz / c <= bucket:
                        break
            if sz / chunks > bucket:
                oversize.append(i)
            entries.append(BucketEntry(leaves=(i,), chunks=chunks))
            continue
        g = open_groups.get(key)
        if g is not None and g[1] + sz > bucket:
            close(key)
            g = None
        if g is None:
            open_groups[key] = [[i], sz]
        else:
            g[0].append(i)
            g[1] += sz
    for key in list(open_groups):
        close(key)
    return entries, oversize


def shard_dim(shape: Sequence[int], n: int, min_size: int = 0) -> Optional[int]:
    """The dim of ``shape`` that ZeRO shards over ``n`` ranks, or None:
    ``add_axes_to_spec`` on an unsharded spec."""
    numel = 1
    for s in shape:
        numel *= s
    if n == 1 or numel < max(min_size, 1):
        return None
    candidates = [i for i, s in enumerate(shape) if s % n == 0 and s >= n]
    if not candidates:
        return None
    return max(candidates, key=lambda i: (shape[i], i))


class ZeroPartitionPlan:
    """Shard dims of every leaf for params, grads and optimizer state."""

    def __init__(self, zero_config: DeepSpeedZeroConfig, shapes: Mapping[str, Sequence[int]],
                 n_dp: int):
        self.config = zero_config
        self.stage = zero_config.stage
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.n_dp = n_dp

    def _dims(self, sharded: bool, min_size: int = 0) -> ShardDims:
        return {k: shard_dim(s, self.n_dp, min_size) if sharded else None
                for k, s in self.shapes.items()}

    def param_dims(self) -> ShardDims:
        """Model (bit16) params: sharded only at stage 3."""
        return self._dims(self.stage >= 3, self.config.stage3_param_persistence_threshold)

    def grad_dims(self) -> ShardDims:
        """The gradient accumulator: sharded at stage >= 2."""
        return self._dims(self.stage >= 2)

    def optimizer_dims(self) -> ShardDims:
        """The fp32 master and moments: sharded at stage >= 1."""
        return self._dims(self.stage >= 1)


def shard_of(t: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous shard of ``t`` along ``dim`` (``t`` itself
    when ``dim`` is None)."""
    if dim is None:
        return t
    s = t.shape[dim] // n
    return t.narrow(dim, rank * s, s).contiguous()
