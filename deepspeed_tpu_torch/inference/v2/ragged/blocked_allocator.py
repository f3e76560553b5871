"""Free-list allocator for KV-cache blocks.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``
with one shard: block ids are host metadata, block contents live on the
device in ``BlockedKVCache``. Block 0 is reserved as the null block:
padded block-table entries and padded token writes go there, so padding
never touches live cache state. Ids are handed out in the same order as
the JAX allocator's single shard (1, 2, 3, ...).
"""

from __future__ import annotations

from typing import Iterable, List


class BlockedAllocator:

    NULL_BLOCK = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 reserved), got {num_blocks}")
        self._num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def total_blocks(self) -> int:
        return self._num_blocks - 1

    def allocate(self, num_blocks: int) -> List[int]:
        """Pop ``num_blocks`` ids; raises if too few are free (callers
        consult ``free_blocks`` first)."""
        if num_blocks > len(self._free):
            raise ValueError(f"cannot allocate {num_blocks} blocks, "
                             f"{len(self._free)} free")
        out = self._free[len(self._free) - num_blocks:]
        del self._free[len(self._free) - num_blocks:]
        return out

    def free(self, blocks: Iterable[int]) -> None:
        for blk in blocks:
            if not (0 <= blk < self._num_blocks):
                raise ValueError(f"block id {blk} out of range")
            if blk == self.NULL_BLOCK:
                raise ValueError(f"cannot free the null block {blk}")
            self._free.append(blk)
