"""Ragged-batching serving of the port (counterpart of
``deepspeed_tpu/inference/v2``): blocked KV cache on the device, UID-
addressed sequence state, Dynamic SplitFuse token budgeting, and one
ragged-wave forward whose attention is the hand-written CUDA kernel
``csrc/ragged_paged_attention.cu``."""

from .config_v2 import DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig  # noqa: F401
from .engine_v2 import InferenceEngineV2, build_engine  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, Request, generate  # noqa: F401
