"""Sequence parallelism of the port (counterpart of ``deepspeed_tpu/sequence``)."""

from .layer import DistributedAttention, ulysses_attention  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
