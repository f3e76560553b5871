"""Parallel topology of the port: the ``data`` and ``seq`` axes over the
``torch.distributed`` world.

Counterpart of ``deepspeed_tpu/runtime/topology.py:42-96`` (the axis names
are in ``utils/groups.py``). The JAX package builds one device mesh whose
named axes are the parallel groups; the port runs one process a rank, and a
rank's coordinates on the axes are its index into a grid of the JAX mesh
order (``MESH_AXES``: ``seq`` inside ``data``), so rank ``r`` of a world of
``data x seq`` ranks sits at data ``r // seq``, seq ``r % seq``, as a device
of the JAX mesh does. Each live axis is one ``torch.distributed`` group a
rank (the world itself where the axis spans it).

A global batch's rows split over the data ranks only (``PartitionSpec(
BATCH_AXES)``): rank ``r`` owns rows ``[d * B / data, (d + 1) * B / data)``
of it, ``d`` its data coordinate. With ``seq`` > 1 each rank then holds the
contiguous sequence slice of its seq coordinate (``seq_slice``), the
``SEQ_SHARDED`` layout of ``deepspeed_tpu/sequence/layer.py``. The dense
gradient group is ``data x seq`` (``DENSE_GRAD_AXES``), as in JAX.

Every other axis of size > 1 raises, naming its ROADMAP item: ``mics``
(hpZ / MiCS) A6, ``expert`` A6 and A7, ``model`` A6, ``pipe`` A10. A world
of one without a process group is the single-device engine.

``set_topology`` / ``get_topology`` publish the engine's topology to code
that has no engine handle (the model's attention), as the JAX engine does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

from ..comm import comm as dist
from ..utils.groups import (BATCH_AXES, DATA_AXIS, DENSE_GRAD_AXES, EXPERT_AXIS, MESH_AXES,
                            MICS_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS)

_UNPORTED_AXES = {
    PIPE_AXIS: "A10 (pipeline parallelism)",
    MICS_AXIS: "A6 (hpZ / MiCS sub-group partitioning)",
    EXPERT_AXIS: "A6 / A7 (expert parallelism)",
    MODEL_AXIS: "A6 (tensor parallelism)",
}
LIVE_AXES = (DATA_AXIS, SEQ_AXIS)


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Parallel degrees; ``data`` -1 is the world size over ``seq``."""
    pipe: int = 1
    data: int = -1
    mics: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1


# one torch.distributed group per member list, made once per process: every
# rank must call new_group for every group, in the same order
_GROUPS: Dict[Tuple[int, ...], Any] = {}


class MeshTopology:
    """The port's topology over a world of ``world_size`` ranks: ``data x
    seq`` is the world, every other axis 1."""

    def __init__(self, config: Union[TopologyConfig, Mapping[str, Any], None] = None,
                 world_size: Optional[int] = None, rank: Optional[int] = None):
        if isinstance(config, Mapping):
            config = TopologyConfig(**config)
        config = config or TopologyConfig()
        for axis, item in _UNPORTED_AXES.items():
            size = getattr(config, axis)
            if size != 1:
                raise NotImplementedError(
                    f"topology axis {axis!r} of size {size} is not ported: ROADMAP {item}")
        n = dist.get_world_size() if world_size is None else world_size
        seq = config.seq
        if seq < 1 or n % seq:
            raise ValueError(f"topology seq={seq} does not divide the world of {n} ranks")
        data = n // seq if config.data == -1 else config.data
        if data * seq != n:
            raise ValueError(f"topology data={data} x seq={seq} needs a world of "
                             f"{data * seq} ranks, the process group has {n}")
        self.config = dataclasses.replace(config, data=data)
        self.rank = dist.get_rank() if rank is None else rank
        self.shape = tuple(getattr(self.config, a) for a in MESH_AXES)
        self.coords = dict(zip(MESH_AXES, _unravel(self.rank, self.shape)))
        self._groups: Dict[str, Any] = {}

    def axis_size(self, axis) -> int:
        if isinstance(axis, (tuple, list)):
            size = 1
            for a in axis:
                size *= self.axis_size(a)
            return size
        return getattr(self.config, axis)

    @property
    def world_size(self) -> int:
        return self.axis_size(MESH_AXES)

    @property
    def data_parallel_size(self) -> int:
        """The dense gradient group's size: ``data x seq`` (JAX's)."""
        return self.axis_size(DENSE_GRAD_AXES)

    @property
    def sequence_parallel_size(self) -> int:
        return self.axis_size(SEQ_AXIS)

    @property
    def seq_rank(self) -> int:
        return self.coords[SEQ_AXIS]

    def axis_ranks(self, axis: str, rank: Optional[int] = None) -> List[int]:
        """The world ranks of ``rank``'s group along ``axis`` (this rank's
        by default), in their order on the axis."""
        coords = list(_unravel(self.rank if rank is None else rank, self.shape))
        i = MESH_AXES.index(axis)
        out = []
        for c in range(self.shape[i]):
            coords[i] = c
            out.append(_ravel(coords, self.shape))
        return out

    def group(self, axis: str):
        """This rank's ``torch.distributed`` group along ``axis``: ``None``
        (the default group) where the axis spans the world; otherwise the
        groups of every line of the axis are made, each once a process, in
        rank order, as ``new_group`` wants from every rank."""
        if axis in self._groups:
            return self._groups[axis]
        mine = self.axis_ranks(axis)
        if len(mine) == self.world_size:
            group = None
        else:
            lines = sorted({tuple(self.axis_ranks(axis, r)) for r in range(self.world_size)})
            for line in lines:
                if line not in _GROUPS:
                    _GROUPS[line] = dist.new_group(list(line))
            group = _GROUPS[tuple(mine)]
        self._groups[axis] = group
        return group

    def batch_rows(self, global_rows: int) -> slice:
        """The rows of a global batch of ``global_rows`` that this rank owns:
        split over the batch axes (``data``, ``mics``) only."""
        n = self.axis_size(BATCH_AXES)
        if global_rows % n:
            raise ValueError(f"a global batch of {global_rows} rows does not split "
                             f"over {n} data-parallel ranks")
        per = global_rows // n
        d = self.coords[DATA_AXIS]
        return slice(d * per, (d + 1) * per)

    def seq_slice(self, seq_len: int) -> slice:
        """This rank's contiguous slice of a sequence of ``seq_len``."""
        sp = self.sequence_parallel_size
        if seq_len % sp:
            raise ValueError(f"a sequence of {seq_len} tokens does not split over "
                             f"{sp} sequence-parallel ranks")
        per = seq_len // sp
        return slice(self.seq_rank * per, (self.seq_rank + 1) * per)

    def __repr__(self) -> str:
        c = self.config
        return (f"MeshTopology(pipe={c.pipe}, data={c.data}, mics={c.mics}, "
                f"expert={c.expert}, seq={c.seq}, model={c.model}; rank {self.rank})")


def _unravel(index: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for size in reversed(shape):
        out.append(index % size)
        index //= size
    return tuple(reversed(out))


def _ravel(coords, shape: Tuple[int, ...]) -> int:
    index = 0
    for c, size in zip(coords, shape):
        index = index * size + c
    return index


_TOPOLOGY: Optional[MeshTopology] = None


def set_topology(topology: Optional[MeshTopology]) -> Optional[MeshTopology]:
    """Publish ``topology`` as the process-global instance (``None``
    clears it): the model's attention reads its ``seq`` axis."""
    global _TOPOLOGY
    _TOPOLOGY = topology
    return topology


def get_topology() -> Optional[MeshTopology]:
    return _TOPOLOGY


def reset() -> None:
    set_topology(None)


def sequence_parallel() -> Tuple[int, int, Any]:
    """``(sp, seq rank, seq group)`` of the published topology; ``(1, 0,
    None)`` without one."""
    t = _TOPOLOGY
    if t is None or t.sequence_parallel_size == 1:
        return 1, 0, None
    return t.sequence_parallel_size, t.seq_rank, t.group(SEQ_AXIS)
