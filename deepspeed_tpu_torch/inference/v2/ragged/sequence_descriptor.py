"""Per-sequence tracking state (counterpart of
``deepspeed_tpu/inference/v2/ragged/sequence_descriptor.py``): UID, tokens
whose KV is cached, and the ordered KV block ids the sequence owns."""

from __future__ import annotations

from typing import List


class DSSequenceDescriptor:

    def __init__(self, uid: int, block_size: int):
        self.uid = uid
        self._block_size = block_size
        self.seen_tokens = 0           # tokens whose KV is in cache
        self.blocks: List[int] = []    # ordered KV block ids

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.blocks)

    def blocks_needed(self, new_tokens: int) -> int:
        """Additional blocks required to hold ``new_tokens`` more tokens."""
        total = self.seen_tokens + new_tokens
        return max(0, -(-total // self._block_size) - len(self.blocks))

    def extend_blocks(self, blocks: List[int]) -> None:
        self.blocks.extend(blocks)

    def post_forward(self, new_tokens: int) -> None:
        """Advance the seen-token count after a forward pass."""
        self.seen_tokens += new_tokens
