"""Ragged inference model over a blocked KV cache.

Counterpart of ``deepspeed_tpu/inference/v2/model.py`` for the ragged-wave
path: ``wave_forward`` (every wave, any mix of prefill chunks and decode
tokens) and ``decode_burst`` (K decode steps with sampling on the device).
The JAX legacy two-class programs (``ragged_forward``, ``prefill_chunk``,
``decode``) are not ported (ROADMAP A5).

A MoE model's layers route DROPLESS on every wave and decode step
(``capacity_factor = E``, ``min_capacity = 1``: capacity = the token
count, so generation does not depend on how requests are batched), as the
JAX model's ``_moe_serve`` does (``model.py:83-96``), through the MoE
kernels of ``ops/transformer/moe.py``.

The KV pool is updated IN PLACE: each layer's new K/V rows are written
with ``index_copy_`` into ``k_pages[l]`` / ``v_pages[l]`` of the
preallocated pool, where the JAX program carries the pool functionally
through its layer loop and donates it at the jit boundary
(``model.py:162-200``). The methods therefore return only their outputs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...models.transformer import Block, TransformerLM
from .kernels.paged_decode import paged_gqa_decode
from .kernels.ragged_paged_attention import ragged_paged_attention

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class RaggedInferenceModel:

    def __init__(self, model: TransformerLM, block_size: int,
                 max_blocks_per_seq: int, ragged_block_q: int = 8):
        self.model = model
        self.config = model.config
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.ragged_block_q = ragged_block_q
        self._scale = model.config.attn_scale

    # -- shared pieces ------------------------------------------------------
    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """tokens [N] -> [N, hidden] in the compute dtype."""
        return self.model.embed(tokens, positions)

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, hidden] -> fp32 logits [N, vocab]."""
        return self.model.head(x)

    def _qkv(self, block: Block, h: torch.Tensor, rope):
        """PRE-NORMED h [N, hidden] -> q [N, H, D], k/v [N, kvH, D], rope
        applied from the forward's tables ``rope`` (None: no rope)."""
        c = self.config
        N = h.shape[0]
        q = block.q_proj(h).view(N, c.num_heads, c.head_dim)
        k = block.k_proj(h).view(N, c.kv_heads, c.head_dim)
        v = block.v_proj(h).view(N, c.kv_heads, c.head_dim)
        if rope is not None:
            q = self.model.rotate(q, rope)
            k = self.model.rotate(k, rope)
        return q, k, v

    def _mlp(self, block: Block, h: torch.Tensor) -> torch.Tensor:
        return block.mlp(h, dropless=True)

    @staticmethod
    def _write_kv(pages: torch.Tensor, new: torch.Tensor,
                  flat_idx: torch.Tensor) -> None:
        """In place: pages [kvH, P, ps, D] <- new [N, kvH, D] at flat slots
        ``flat_idx [N]`` (int64) of the ``P*ps`` token slots."""
        kvH, P, ps, D = pages.shape
        pages.view(kvH, P * ps, D).index_copy_(
            1, flat_idx, new.transpose(0, 1).to(pages.dtype))

    def _layer_loop(self, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    x: torch.Tensor, attn_fn: AttnFn, write_idx: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
        rope = self.model.rope(positions) if self.config.position == "rope" else None
        for l, block in enumerate(self.model.blocks):
            h1 = block.ln_1(x)
            q, k, v = self._qkv(block, h1, rope)
            self._write_kv(k_pages[l], k, write_idx)
            self._write_kv(v_pages[l], v, write_idx)
            attn = attn_fn(q, k_pages[l], v_pages[l])
            x = x + block.o_proj(attn.reshape(x.shape[0], -1))
            x = x + self._mlp(block, block.ln_2(x))
        return x

    # -- programs -----------------------------------------------------------
    @torch.inference_mode()
    def wave_forward(self, k_pages, v_pages, tokens, positions, write_idx,
                     cu_q_lens, kv_lens, page_tables, last_rows) -> torch.Tensor:
        """One ragged wave (``ragged/wave.py`` descriptors, on the model's
        device): every layer's attention is one ``ragged_paged_attention``
        launch; projections, MLP and norms run over the flat [N] stream.
        Returns fp32 logits [R, V], one row per scheduled sequence-chunk
        (``last_rows``)."""
        x = self._embed(tokens, positions)
        max_flat = k_pages.shape[2] * self.block_size
        write_idx = write_idx.long().clamp(0, max_flat - 1)

        def attn(q, k_l, v_l):
            return ragged_paged_attention(q, k_l, v_l, kv_lens, page_tables,
                                          cu_q_lens, scale=self._scale,
                                          block_q=self.ragged_block_q)

        x = self._layer_loop(k_pages, v_pages, x, attn, write_idx, positions)
        sel = x[last_rows.long().clamp(0, x.shape[0] - 1)]
        return self._unembed(sel)

    @torch.inference_mode()
    def decode_burst(self, k_pages, v_pages, tokens, positions, block_tables,
                     temperatures: torch.Tensor, num_steps: int,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """K = ``num_steps`` decode steps for B sequences, sampling on the
        device between steps: greedy (argmax) where temperature <= 0, else
        ``torch.multinomial`` over softmax(logits / T) with ``generator``.
        ``positions[b]`` is the position of the INPUT token; blocks for
        all K steps must already be in ``block_tables [B, mp]`` (int32).
        Returns the sampled tokens [B, K] (int64)."""
        ps = self.block_size
        max_flat = k_pages.shape[2] * ps
        max_pos = self.max_blocks_per_seq * ps - 1
        sampled_rows = bool((temperatures > 0).any())
        out = []
        for _ in range(num_steps):
            x = self._embed(tokens, positions)
            pos_c = positions.clamp(0, max_pos)
            page_slot = (pos_c // ps).clamp(0, block_tables.shape[1] - 1)
            pages_of = block_tables.gather(1, page_slot[:, None].long())[:, 0]
            write_idx = (pages_of.long() * ps + pos_c % ps).clamp(0, max_flat - 1)
            ctx = (pos_c + 1).to(torch.int32)

            def attn(q, k_l, v_l):
                return paged_gqa_decode(q, k_l, v_l, ctx, block_tables,
                                        scale=self._scale)

            x = self._layer_loop(k_pages, v_pages, x, attn, write_idx, positions)
            logits = self._unembed(x)                       # [B, V]
            nxt = torch.argmax(logits, dim=-1)
            if sampled_rows:
                temp = temperatures.clamp_min(1e-6)[:, None]
                probs = torch.softmax(logits / temp, dim=-1)
                drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
                nxt = torch.where(temperatures <= 0.0, nxt, drawn)
            out.append(nxt)
            tokens, positions = nxt, positions + 1
        return torch.stack(out, dim=1)
