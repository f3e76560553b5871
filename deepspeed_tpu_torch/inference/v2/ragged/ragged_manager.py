"""Sequence state manager (counterpart of
``deepspeed_tpu/inference/v2/ragged/ragged_manager.py``, single pool):
UID -> sequence descriptor tracking, block accounting against the
``BlockedAllocator``, and host offload / restore of whole sequences."""

from __future__ import annotations

from typing import Dict, Optional

from ..config_v2 import DeepSpeedTPStateManagerConfig
from .blocked_allocator import BlockedAllocator
from .kv_cache import BlockedKVCache
from .sequence_descriptor import DSSequenceDescriptor


class DSStateManager:

    def __init__(self, config: DeepSpeedTPStateManagerConfig,
                 kv_cache: BlockedKVCache):
        self._config = config
        self.kv_cache = kv_cache
        self.block_size = kv_cache.block_size
        self._allocator = BlockedAllocator(kv_cache.num_blocks)
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        # uid -> (descriptor, host_k, host_v): sequences whose KV is
        # stashed in host memory (preemption under KV pressure)
        self._offloaded: Dict[int, tuple] = {}

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    @property
    def allocator(self) -> BlockedAllocator:
        return self._allocator

    @property
    def tracked_sequences(self) -> int:
        return len(self._seqs)

    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        seq = self._seqs.get(uid)
        if seq is None:
            if len(self._seqs) >= self._config.max_tracked_sequences:
                raise RuntimeError(
                    f"tracking {len(self._seqs)} sequences, limit "
                    f"{self._config.max_tracked_sequences}")
            seq = DSSequenceDescriptor(uid, self.block_size)
            self._seqs[uid] = seq
        return seq

    def allocate_blocks(self, seq: DSSequenceDescriptor, new_tokens: int) -> None:
        need = seq.blocks_needed(new_tokens)
        if need:
            seq.extend_blocks(self._allocator.allocate(need))

    def flush_sequence(self, uid: int) -> None:
        """Free a sequence's blocks and forget it; also drops a host stash."""
        seq = self._seqs.pop(uid, None)
        if seq is not None and seq.blocks:
            self._allocator.free(seq.blocks)
        self._offloaded.pop(uid, None)

    # -- host offload / restore ------------------------------------------
    def is_offloaded(self, uid: int) -> bool:
        return uid in self._offloaded

    def offload_sequence(self, uid: int) -> None:
        """Page a live sequence's KV blocks to host memory and free them on
        the device; the descriptor rides along so ``restore_sequence``
        resumes decoding without a re-prefill."""
        seq = self._seqs.pop(uid)
        host_k, host_v = self.kv_cache.offload(seq.blocks)
        self._allocator.free(seq.blocks)
        self._offloaded[uid] = (seq, host_k, host_v)

    def can_restore(self, uid: int, headroom: int = 0) -> bool:
        """``headroom``: free blocks demanded beyond the restore itself
        (the scheduler's guard against restore -> preempt thrash)."""
        seq, _, _ = self._offloaded[uid]
        return len(seq.blocks) + headroom <= self._allocator.free_blocks

    def restore_sequence(self, uid: int) -> None:
        """Re-place an offloaded sequence's KV into freshly allocated
        blocks (ids generally differ from offload time)."""
        seq, host_k, host_v = self._offloaded.pop(uid)
        fresh = self._allocator.allocate(len(seq.blocks))
        self.kv_cache.restore(host_k, host_v, fresh)
        seq.blocks = fresh
        self._seqs[uid] = seq
