"""Mesh-axis names of the port.

Counterpart of the axis names that ``deepspeed_tpu/utils/groups.py``
exports (defined in ``deepspeed_tpu/runtime/topology.py``). They sit below
both the communication layer (``comm/comm.py``) and the runtime
(``runtime/topology.py``, ``runtime/zero/partition.py``), which import them
from here. The port's only live axis is ``data``: the
``torch.distributed`` world.
"""

from __future__ import annotations

from typing import Tuple

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
MICS_AXIS = "mics"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

# the batch's leading dim is sharded over both data-parallel axes
BATCH_AXES: Tuple[str, ...] = (DATA_AXIS, MICS_AXIS)
# the compound axes of gradient sync and ZeRO partitioning
DENSE_GRAD_AXES: Tuple[str, ...] = (DATA_AXIS, MICS_AXIS, EXPERT_AXIS, SEQ_AXIS)
