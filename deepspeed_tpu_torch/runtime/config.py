"""Config of the single-device training engine.

Counterpart of ``deepspeed_tpu/runtime/config.py``, reduced to the keys the
single-device step reads: batch sizes (``train_batch_size =
train_micro_batch_size_per_gpu * gradient_accumulation_steps`` on a world
of one), ``optimizer``, ``scheduler``, ``bf16``, ``fp16`` (loss-scale
fields), ``gradient_clipping``, ``data_types`` (``grad_accum_dtype``,
``optimizer_moment_dtype``, ``optimizer_moment_sq_dtype``),
``fp16_master_weights_and_grads`` and ``zero_optimization.stage``, which
partitions nothing on one device, exactly as in JAX. Keys for features the
port does not cover yet raise ``NotImplementedError`` naming their ROADMAP
item; keys that only tune logging or what a world of one ignores are
accepted.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


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


def _enabled(block) -> bool:
    return isinstance(block, dict) and bool(block.get("enabled"))


# top-level key -> (ROADMAP item, does this value ask for the feature)
_UNPORTED = {
    "pipeline": ("A10 (pipeline parallelism)",
                 lambda b: isinstance(b, dict) and b.get("stages", 1) > 1),
    "topology": ("A6 (meshes of more than one device)",
                 lambda b: any(v not in (1, -1) if k == "data" else v != 1
                               for k, v in (b or {}).items())),
    "moe": ("A7 (mixture of experts)", lambda b: bool(b)),
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
    "comm_transport": ("A6 (collectives)", lambda b: bool(b)),
    "checkpoint": ("A4 (checkpoints)", lambda b: bool(b)),
}
_ZERO_UNPORTED = {
    "offload_optimizer": "A9 (offload)",
    "offload_param": "A9 (offload)",
    "zero_quantized_weights": "A6 (ZeRO++)",
    "zero_quantized_gradients": "A6 (ZeRO++)",
    "zero_hpz_partition_size": "A6 (ZeRO++)",
}


def _reject_unported(pd: Dict[str, Any]) -> None:
    for key, (item, asks) in _UNPORTED.items():
        if key in pd and asks(pd[key]):
            raise NotImplementedError(f"config key {key!r} is not ported: ROADMAP {item}")
    zero = pd.get("zero_optimization") or {}
    for key, item in _ZERO_UNPORTED.items():
        val = zero.get(key)
        if val and not (isinstance(val, dict) and val.get("device", "cpu") == "none") \
                and not (key == "zero_hpz_partition_size" and val == 1):
            raise NotImplementedError(
                f"zero_optimization.{key} is not ported: ROADMAP {item}")
    stage = zero.get("stage", 0)
    if stage not in (0, 1, 2, 3):
        raise DeepSpeedConfigError(f"zero_optimization.stage must be 0-3, got {stage}")


class DeepSpeedConfig:
    """Parses the user dict or JSON path; exposes typed fields."""

    def __init__(self, config: Any):
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
        self.zero_stage: int = (pd.get("zero_optimization") or {}).get("stage", 0)
        self.train_micro_batch_size_per_gpu = pd.get("train_micro_batch_size_per_gpu")
        self.train_batch_size = pd.get("train_batch_size")
        self.gradient_accumulation_steps = pd.get("gradient_accumulation_steps")
        self._resolve_batch()

    def _resolve_batch(self) -> None:
        """The JAX batch resolution on a data-parallel world of one."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if train is not None and micro is not None and gas is not None:
            if train != micro * gas:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({train}) != micro_batch ({micro}) * "
                    f"gradient_accumulation_steps ({gas}) * data_parallel_size (1)")
        elif train is not None and micro is not None:
            gas = train // micro
            if gas * micro != train:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by micro_batch*dp = {micro}")
        elif train is not None and gas is not None:
            micro = train // gas
            if micro * gas != train:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by gas*dp = {gas}")
        elif micro is not None:
            gas = gas or 1
            train = micro * gas
        elif train is not None:
            micro, gas = train, 1
        else:
            micro, gas, train = 1, 1, 1
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
