"""Ragged batching state of the port (counterpart of
``deepspeed_tpu/inference/v2/ragged``)."""

from .blocked_allocator import BlockedAllocator  # noqa: F401
from .kv_cache import BlockedKVCache  # noqa: F401
from .ragged_manager import DSStateManager  # noqa: F401
from .sequence_descriptor import DSSequenceDescriptor  # noqa: F401
from .wave import WaveDescriptors, WaveEntry, build_wave  # noqa: F401
