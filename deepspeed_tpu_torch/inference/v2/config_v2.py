"""Engine-v2 configuration (counterpart of
``deepspeed_tpu/inference/v2/config_v2.py``).

The JAX config's ``wave_dispatch`` switch (the legacy two-class dispatch)
is not carried over: the port has one dispatch, the ragged wave. Fields
that select what the port does not cover yet (tensor parallelism, a
data-sharded pool, an fp8 KV cache) are kept so that such a configuration
raises ``NotImplementedError`` instead of being silently served another way
(``check_supported``). ``quantization_mode`` takes ``int8`` / ``wint8`` /
``int4`` / ``wint4`` (``inference/quantization``); an unknown mode raises
``ValueError``, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quantization.quantization import QuantizationConfig

_LATER = "(ROADMAP A5: serving features left out of slice 1)"


@dataclasses.dataclass
class DeepSpeedTPStateManagerConfig:
    """Ragged state-manager knobs."""
    max_tracked_sequences: int = 2048
    max_ragged_batch_size: int = 768       # token budget per forward
    max_ragged_sequence_count: int = 512   # sequences per forward
    max_context: int = 8192                # longest trackable sequence


@dataclasses.dataclass
class RaggedInferenceEngineConfig:
    tensor_parallel_degree: int = 1
    state_manager: DeepSpeedTPStateManagerConfig = dataclasses.field(
        default_factory=DeepSpeedTPStateManagerConfig)
    kv_block_size: int = 16                # tokens per KV block (page)
    num_kv_blocks: Optional[int] = None    # None => derived from max_context
    kv_cache_dtype: torch.dtype = torch.bfloat16
    max_prefill_chunk: int = 256           # SplitFuse prefill chunk cap
    quantization_mode: Optional[str] = None
    # "replicated" and "auto" both mean the single pool of one device;
    # "data" (a pool sharded over a data axis) is not ported
    kv_pool_sharding: str = "auto"
    # atom tile of the ragged wave: every scheduled sequence-chunk splits
    # into atoms of <= ragged_block_q query tokens
    ragged_block_q: int = 8
    # decode-only scheduler steps fuse up to this many tokens per sequence
    # (sampling on the device between steps); 1 disables. The JAX value is
    # 32, a TPU choice (a round trip a burst). On the H100, with each burst
    # a CUDA graph's replays and one copy to the host, 8, 16 and 32 give the
    # same tokens/s within the spread of repeated runs (chip_smoke.py
    # [engine-sweep], PERF.md); 16 halves the longest wait of a new request
    # behind a burst against 32
    decode_burst: int = 16

    def check_supported(self, model_dtype: torch.dtype) -> None:
        if self.tensor_parallel_degree != 1:
            raise NotImplementedError(f"tensor_parallel_degree > 1 is not ported {_LATER}")
        QuantizationConfig.from_mode(self.quantization_mode)   # raises for an unknown mode
        if self.kv_pool_sharding == "data":
            raise NotImplementedError(f"a data-sharded KV pool is not ported {_LATER}")
        if self.kv_pool_sharding not in ("auto", "replicated"):
            raise ValueError(f"kv_pool_sharding must be auto|data|replicated, "
                             f"got {self.kv_pool_sharding!r}")
        if self.kv_cache_dtype != model_dtype:
            raise NotImplementedError(
                f"a KV cache dtype ({self.kv_cache_dtype}) other than the "
                f"model's ({model_dtype}) is not ported {_LATER}")
