"""ZeRO configuration of the port.

Counterpart of ``deepspeed_tpu/runtime/zero/config.py``, reduced to the
fields the data-parallel engine reads: ``stage``; ``overlap_comm`` and
whether the user wrote it (``overlap_comm_explicit``, ``:101-114``: the
default is true at stage 3), which route a micro step to the layer-pipelined
overlap schedule (``runtime/zero/overlap.py``) or the barrier schedule;
``reduce_bucket_size`` and ``allgather_bucket_size`` (element counts, the
overlap schedule's fusion and split bound, ``:70-72``);
``stage3_param_persistence_threshold``; the ZeRO++ knobs
``zero_quantized_weights`` (qwZ), ``zero_quantized_gradients`` (qgZ) and
``zero_hpz_partition_size``; ``mics_shard_size``. Other keys of the JAX
model are accepted and ignored, except those the port does not cover,
which ``runtime/config.py`` rejects.

``validate_zeropp`` is the ZeRO++ check of ``deepspeed_tpu/runtime/
engine.py:241-270``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

@dataclasses.dataclass(frozen=True)
class DeepSpeedZeroConfig:
    stage: int = 0
    overlap_comm: bool = False
    overlap_comm_explicit: bool = False
    reduce_bucket_size: int = int(5e8)
    allgather_bucket_size: int = int(5e8)
    stage3_param_persistence_threshold: int = int(1e5)
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DeepSpeedZeroConfig":
        names = {f.name for f in dataclasses.fields(cls)} - {"overlap_comm_explicit"}
        kw = {k: v for k, v in (d or {}).items() if k in names}
        stage = int(kw.get("stage", 0))
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage must be 0-3, got {stage}")
        explicit = kw.get("overlap_comm") is not None
        if not explicit:
            kw["overlap_comm"] = stage == 3
        return cls(**kw, overlap_comm_explicit=explicit)

    @property
    def zeropp(self) -> bool:
        return (self.zero_quantized_weights or self.zero_quantized_gradients
                or self.zero_hpz_partition_size > 1)


def validate_zeropp(zc: DeepSpeedZeroConfig, one_bit: bool = False) -> None:
    """The JAX engine's ZeRO++ checks (hpZ, which the port does not cover,
    raises earlier, in ``runtime/config.py``)."""
    if not zc.zeropp:
        return
    if zc.stage < 2:
        raise ValueError("ZeRO++ requires zero stage >= 2")
    if zc.zero_quantized_weights and zc.stage < 3:
        raise ValueError("zero_quantized_weights requires zero stage 3 "
                         "(params must be sharded to gather)")
    if one_bit:
        raise ValueError("ZeRO++ and 1-bit optimizers are mutually exclusive "
                         "compression schemes")
