"""Blocked (paged) KV cache on the device.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py``. The
layout is the same: ``k_pages`` / ``v_pages`` of shape
``[num_layers, kv_heads, num_blocks, block_size, head_dim]``.

The JAX cache is a functional value: every forward takes the pool as a
donated jit argument and returns a new handle (``kv_cache.py:80``
``update``). Here the pool is preallocated once and updated IN PLACE: the
model writes each layer's new K/V with ``index_copy_`` into
``k_pages[l]`` / ``v_pages[l]``, so no handle ever changes.

``offload`` / ``restore`` page a set of blocks to pinned host memory and
back. Block-id lists are padded to power-of-two lengths with the null
block 0, as the JAX cache pads them (``kv_cache.py:90-142``), so the host
stash has the JAX stash's shape.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .ragged_wrapper import _next_bucket


class BlockedKVCache:

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 num_blocks: int, block_size: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device = None):
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        shape = (num_layers, num_kv_heads, num_blocks, block_size, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)

    @property
    def per_token_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim * itemsize

    def mem_bytes(self) -> int:
        return 2 * self.k_pages.numel() * self.k_pages.element_size()

    def _ids(self, block_ids: List[int], n: int) -> torch.Tensor:
        ids = torch.zeros(n, dtype=torch.int64)
        ids[:len(block_ids)] = torch.as_tensor(block_ids, dtype=torch.int64)
        return ids.to(self.device)

    def offload(self, block_ids: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copy ``block_ids``'s pages to host memory, returning (k, v) of
        shape ``[L, kvH, n_padded, ps, D]`` (pinned when the pool is on a
        GPU). The pad rows, read from the null block, are dead weight the
        matching ``restore`` writes back to the null block."""
        ids = self._ids(block_ids, _next_bucket(len(block_ids), lo=1))
        pin = self.device.type == "cuda"
        out = []
        for pages in (self.k_pages, self.v_pages):
            sel = pages[:, :, ids]
            host = torch.empty(sel.shape, dtype=sel.dtype, pin_memory=pin)
            host.copy_(sel)
            out.append(host)
        return out[0], out[1]

    def restore(self, host_k: torch.Tensor, host_v: torch.Tensor,
                block_ids: List[int]) -> None:
        """Scatter offloaded pages into freshly allocated blocks (ids may
        differ from the offload-time ids); pad rows land in null block 0."""
        n = host_k.shape[2]
        if len(block_ids) > n:
            raise ValueError(f"{len(block_ids)} blocks for a stash of {n}")
        ids = self._ids(block_ids, n)
        self.k_pages[:, :, ids] = host_k.to(self.device)
        self.v_pages[:, :, ids] = host_v.to(self.device)

    def host_bytes(self, n_blocks: int) -> int:
        """Host bytes one offloaded stash of n_blocks occupies (padded)."""
        return (_next_bucket(n_blocks, lo=1) * self.block_size
                * self.per_token_bytes)
