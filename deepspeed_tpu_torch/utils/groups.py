"""Mesh-axis names of the port.

Counterpart of the axis names that ``deepspeed_tpu/utils/groups.py``
exports (defined in ``deepspeed_tpu/runtime/topology.py``). They sit below
both the communication layer (``comm/comm.py``) and the runtime
(``runtime/topology.py``, ``runtime/zero/partition.py``), which import them
from here. The port's live axes are ``data`` and ``seq``: together they
are the ``torch.distributed`` world, ``seq`` inside ``data`` as in the
JAX mesh order ``MESH_AXES``.
"""

from __future__ import annotations

from typing import Tuple

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
MICS_AXIS = "mics"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

# the JAX mesh's axis order (``deepspeed_tpu/runtime/topology.py:48``): a
# rank's coordinates are its index into a grid of this order, row-major
MESH_AXES: Tuple[str, ...] = (PIPE_AXIS, DATA_AXIS, MICS_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)

# the batch's leading dim is sharded over both data-parallel axes
BATCH_AXES: Tuple[str, ...] = (DATA_AXIS, MICS_AXIS)
# the compound axes of gradient sync and ZeRO partitioning
DENSE_GRAD_AXES: Tuple[str, ...] = (DATA_AXIS, MICS_AXIS, EXPERT_AXIS, SEQ_AXIS)
