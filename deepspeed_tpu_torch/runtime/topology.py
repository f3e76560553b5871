"""Parallel topology of the port: the ``data`` axis is the
``torch.distributed`` world.

Counterpart of ``deepspeed_tpu/runtime/topology.py:42-96`` (the axis names
are in ``utils/groups.py``). The JAX package builds one
device mesh whose named axes are the parallel groups; the port runs one
process a rank and has one live axis, ``data``, whose members are the
ranks of the default process group. Rank r owns the contiguous rows
``[r * B / n, (r + 1) * B / n)`` of a global batch, as
``PartitionSpec(BATCH_AXES)`` shards them.

Every other axis of size > 1 raises, naming its ROADMAP item: ``mics`` (hpZ
/ MiCS) and ``expert`` A6 and A7, ``model`` and ``seq`` A6 and A8, ``pipe``
A10. A world of one without a process group is the single-device engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

from ..comm import comm as dist
from ..utils.groups import (DATA_AXIS, DENSE_GRAD_AXES, EXPERT_AXIS, MICS_AXIS, MODEL_AXIS,
                            PIPE_AXIS, SEQ_AXIS)

_UNPORTED_AXES = {
    PIPE_AXIS: "A10 (pipeline parallelism)",
    MICS_AXIS: "A6 (hpZ / MiCS sub-group partitioning)",
    EXPERT_AXIS: "A6 / A7 (expert parallelism)",
    SEQ_AXIS: "A6 / A8 (sequence parallelism)",
    MODEL_AXIS: "A6 (tensor parallelism)",
}


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Parallel degrees; ``data`` -1 is the world size."""
    pipe: int = 1
    data: int = -1
    mics: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1


class MeshTopology:
    """The port's topology over a world of ``world_size`` ranks: ``data`` is
    the world, every other axis 1."""

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
        data = n if config.data == -1 else config.data
        if data != n:
            raise ValueError(f"topology data={data} needs a world of {data} ranks, "
                             f"the process group has {n}")
        self.config = dataclasses.replace(config, data=data)
        self.rank = dist.get_rank() if rank is None else rank

    def axis_size(self, axis) -> int:
        if isinstance(axis, (tuple, list)):
            size = 1
            for a in axis:
                size *= self.axis_size(a)
            return size
        return getattr(self.config, axis)

    @property
    def data_parallel_size(self) -> int:
        return self.axis_size(DENSE_GRAD_AXES)

    def batch_rows(self, global_rows: int) -> slice:
        """The rows of a global batch of ``global_rows`` that this rank owns."""
        n = self.data_parallel_size
        if global_rows % n:
            raise ValueError(f"a global batch of {global_rows} rows does not split "
                             f"over {n} data-parallel ranks")
        per = global_rows // n
        return slice(self.rank * per, (self.rank + 1) * per)

    def __repr__(self) -> str:
        c = self.config
        return (f"MeshTopology(pipe={c.pipe}, data={c.data}, mics={c.mics}, "
                f"expert={c.expert}, seq={c.seq}, model={c.model}; rank {self.rank})")
