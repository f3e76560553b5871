"""Mixture of experts of the port (counterpart of ``deepspeed_tpu/moe``)."""

from .layer import MoE, moe_reference_forward  # noqa: F401
from .sharded_moe import capacity, top_k_gating_indices  # noqa: F401
