"""Config of the training engine.

Counterpart of ``deepspeed_tpu/runtime/config.py``, reduced to the keys the
port's training step reads: batch sizes (``train_batch_size =
train_micro_batch_size_per_gpu * gradient_accumulation_steps *
data_parallel_size``, ``:293-326``), ``optimizer``, ``scheduler``,
``bf16``, ``fp16`` (loss-scale fields), ``gradient_clipping``,
``data_types`` (``grad_accum_dtype``, ``optimizer_moment_dtype``,
``optimizer_moment_sq_dtype``), ``fp16_master_weights_and_grads``,
``zero_optimization`` (``runtime/zero/config.py``: the stage, the ZeRO++
knobs ``zero_quantized_weights`` / ``zero_quantized_gradients``,
``overlap_comm`` and the bucket sizes),
``comm_transport`` (the transport planner's policy, ``comm/comm.py``),
``overlap_plan`` (default true, JAX ``:226``: false pins the overlap
schedule to the identity plan, ``runtime/overlap_planner.py``),
``checkpoint`` (``async_save``, ``keep_last_n``),
``activation_checkpointing`` (``ActivationCheckpointingConfig``: stored; as
in JAX only its ``policy`` acts, through
``activation_checkpointing.checkpointing.configure``) and ``topology``
(``data`` and ``seq``, whose product is the world size). The batch sizes
resolve over ``data_parallel_size = data x seq``, as the JAX resolution
counts the dense gradient group (``DENSE_GRAD_AXES``, ``:292-300``), though a
global batch's rows split over ``data`` alone. On a world of one,
ZeRO partitions nothing, exactly as in JAX. Keys for features the port
does not cover yet raise ``NotImplementedError`` naming their ROADMAP
item: other topology axes, hpZ, MiCS, offload, the watchdog's
``checkpoint.escalation_*`` keys, and
``comm_transport.hierarchical`` set to other than its default (the
algorithm is chosen only where a second data axis is live).
``comm_transport.activation_width`` steers the Ulysses exchange (the MoE
exchange it also steers needs the ``expert`` axis, which raises) and
``.permute_width`` the ring's K/V hops. Keys that only tune logging or what
the port ignores are accepted.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from ..comm import comm as dist
from .optimizers import is_onebit
from .topology import _UNPORTED_AXES, LIVE_AXES
from .zero.config import DeepSpeedZeroConfig, validate_zeropp


class DeepSpeedConfigError(Exception):
    pass


@dataclasses.dataclass
class FP16Config:
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class BF16Config:
    enabled: bool = False
    immediate_grad_update: bool = False


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    """The JAX block (``runtime/config.py:90-99``). Only ``policy`` acts
    (``checkpointing.configure``); the other flags are stored, unread, as in
    JAX."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "full"


def _enabled(block) -> bool:
    return isinstance(block, dict) and bool(block.get("enabled"))


# top-level key -> (ROADMAP item, does this value ask for the feature)
_UNPORTED = {
    "pipeline": ("A10 (pipeline parallelism)",
                 lambda b: isinstance(b, dict) and b.get("stages", 1) > 1),
    "hybrid_engine": ("A12 (hybrid engine)", _enabled),
    "elasticity": ("A12 (elastic training and resume)", _enabled),
    "telemetry": ("A12 (telemetry)", _enabled),
    "guardian": ("A12 (numerics guardian)", _enabled),
    "autotuning": ("A12 (autotuning)", _enabled),
    "flops_profiler": ("A12 (profiling)", _enabled),
    "curriculum_learning": ("A12 (data pipeline)", _enabled),
    "data_efficiency": ("A12 (data pipeline)", _enabled),
    "progressive_layer_drop": ("A12 (progressive layer drop)", _enabled),
    "quantize_training": ("A12 (compression)", _enabled),
    "compression_training": ("A12 (compression)", lambda b: bool(b)),
}
# ``checkpoint`` keys of features the port does not run yet
_CHECKPOINT_UNPORTED = {
    "escalation_dir": "A12 (the watchdog's escalation save)",
    "escalation_save_timeout_s": "A12 (the watchdog's escalation save)",
}
_ZERO_UNPORTED = {
    "offload_optimizer": "A9 (offload)",
    "offload_param": "A9 (offload)",
    "zero_hpz_partition_size": "A6 (hpZ secondary partition)",
    "mics_shard_size": "A6 (MiCS sub-group partitioning)",
}


def _zero_asks(key: str, val) -> bool:
    if not val:
        return False
    if isinstance(val, dict):
        return val.get("device", "cpu") != "none"
    if key == "zero_hpz_partition_size":
        return val > 1
    if key == "mics_shard_size":
        return val > 0
    return True


# transport keys that steer collectives the port does not run: only the
# default is accepted
_TRANSPORT_UNPORTED = {
    "hierarchical": "A6 (the algorithm is chosen only where a second data axis is "
                    "live, hpZ / MiCS)",
}


def _reject_unported(pd: Dict[str, Any]) -> None:
    for key, (item, asks) in _UNPORTED.items():
        if key in pd and asks(pd[key]):
            raise NotImplementedError(f"config key {key!r} is not ported: ROADMAP {item}")
    for axis, size in (pd.get("topology") or {}).items():
        if axis not in _UNPORTED_AXES and axis not in LIVE_AXES:
            raise DeepSpeedConfigError(f"unknown topology axis {axis!r}")
        if axis in _UNPORTED_AXES and size != 1:
            raise NotImplementedError(f"topology axis {axis!r} of size {size} is not "
                                      f"ported: ROADMAP {_UNPORTED_AXES[axis]}")
    for key in pd.get("checkpoint") or {}:
        if key in _CHECKPOINT_UNPORTED:
            raise NotImplementedError(f"config key checkpoint.{key} is not ported: ROADMAP "
                                      f"{_CHECKPOINT_UNPORTED[key]}")
    transport = pd.get("comm_transport") or {}
    for key, item in _TRANSPORT_UNPORTED.items():
        if key in transport and transport[key] != dist.TRANSPORT_DEFAULTS[key]:
            raise NotImplementedError(f"comm_transport.{key}={transport[key]!r} is not "
                                      f"ported: ROADMAP {item}")
    zero = pd.get("zero_optimization") or {}
    for key, item in _ZERO_UNPORTED.items():
        if _zero_asks(key, zero.get(key)):
            raise NotImplementedError(
                f"zero_optimization.{key} is not ported: ROADMAP {item}")
    try:
        DeepSpeedZeroConfig.from_dict(zero)
    except ValueError as e:
        raise DeepSpeedConfigError(str(e)) from None


class DeepSpeedConfig:
    """Parses the user dict or JSON path; exposes typed fields."""

    def __init__(self, config: Any, data_parallel_size: Optional[int] = None):
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        if config is not None and not isinstance(config, dict):
            raise DeepSpeedConfigError(
                f"Expected a dict or json path for config, got {type(config)}")
        pd = self._param_dict = dict(config or {})
        _reject_unported(pd)
        self.fp16 = FP16Config(**pd.get("fp16", {}))
        self.bf16 = BF16Config(**pd.get("bf16", pd.get("bfloat16", {})))
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        self.optimizer = OptimizerConfig(**pd["optimizer"]) if "optimizer" in pd else None
        self.scheduler = SchedulerConfig(**pd["scheduler"]) if "scheduler" in pd else None
        self.gradient_clipping: float = pd.get("gradient_clipping", 0.0)
        data_types = pd.get("data_types") if isinstance(pd.get("data_types"), dict) else {}
        self.data_types_grad_accum_dtype = data_types.get("grad_accum_dtype")
        self.data_types_optimizer_moment_dtype = data_types.get("optimizer_moment_dtype")
        self.data_types_optimizer_moment_sq_dtype = data_types.get("optimizer_moment_sq_dtype")
        self.fp16_master_weights_and_grads = bool(pd.get("fp16_master_weights_and_grads", False))
        self.checkpoint_config: Dict[str, Any] = dict(pd.get("checkpoint") or {})
        self.activation_checkpointing_config = ActivationCheckpointingConfig(
            **pd.get("activation_checkpointing", {}))
        self.zero_config = DeepSpeedZeroConfig.from_dict(pd.get("zero_optimization") or {})
        self.zero_stage: int = self.zero_config.stage
        try:
            validate_zeropp(self.zero_config, one_bit=is_onebit(self.optimizer))
        except ValueError as e:
            raise DeepSpeedConfigError(str(e)) from None
        self.comm_transport: Dict[str, Any] = dict(pd.get("comm_transport") or {})
        self.overlap_plan: bool = bool(pd.get("overlap_plan", True))
        self.topology: Dict[str, int] = dict(pd.get("topology") or {})
        if data_parallel_size is None:
            seq = self.topology.get("seq", 1)
            data = self.topology.get("data", -1)
            if data == -1:
                n = dist.get_world_size()
                if n % seq:
                    raise DeepSpeedConfigError(
                        f"Cannot infer data-parallel degree: {n} ranks not divisible by "
                        f"seq={seq}")
                data = n // seq
            data_parallel_size = data * seq
        self.data_parallel_size = data_parallel_size
        self.train_micro_batch_size_per_gpu = pd.get("train_micro_batch_size_per_gpu")
        self.train_batch_size = pd.get("train_batch_size")
        self.gradient_accumulation_steps = pd.get("gradient_accumulation_steps")
        self._resolve_batch()

    def _resolve_batch(self) -> None:
        """The JAX batch resolution (``runtime/config.py:293-326``)."""
        dp = self.data_parallel_size
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if train is not None and micro is not None and gas is not None:
            if train != micro * gas * dp:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({train}) != micro_batch ({micro}) * "
                    f"gradient_accumulation_steps ({gas}) * data_parallel_size ({dp})")
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
            if gas * micro * dp != train:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by micro_batch*dp = {micro * dp}")
        elif train is not None and gas is not None:
            micro = train // (gas * dp)
            if micro * gas * dp != train:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by gas*dp = {gas * dp}")
        elif micro is not None:
            gas = gas or 1
            train = micro * gas * dp
        elif train is not None:
            micro, gas = train // dp, 1
            if micro * dp != train:
                raise DeepSpeedConfigError(f"train_batch_size {train} not divisible by dp {dp}")
        else:
            micro, gas, train = 1, 1, dp
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
