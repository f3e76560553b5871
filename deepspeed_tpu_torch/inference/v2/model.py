"""Ragged inference model over a blocked KV cache.

Counterpart of ``deepspeed_tpu/inference/v2/model.py`` for the ragged-wave
path: ``wave_forward`` (every wave, any mix of prefill chunks and decode
tokens), ``decode_step`` (one decode step of B sequences over a
``DecodeState``, the JAX burst's scan body ``one``) and ``decode_burst``
(K calls of ``decode_step``, the eager form of the burst; the engine replays
a CUDA graph of one ``decode_step`` instead, ``decode_graph.py``). The JAX
legacy two-class programs (``ragged_forward``, ``prefill_chunk``,
``decode``) are not ported (ROADMAP A5).

A step samples on the device as ``jax.random.categorical`` does, by
Gumbel-max (``sample_next``): ``argmax(logits / T + g)`` with ``g =
-log(-log(u))`` and ``u`` uniform from an explicit ``torch.Generator``;
rows with ``T <= 0`` take ``argmax(logits)``. The draws differ from JAX's
(another generator); their distribution is the same. Whether a step draws
at all is a Python flag (``sampled``) decided on the host, so a step reads
no device value on the host and a greedy step draws nothing.

A MoE model's layers route DROPLESS on every wave and decode step
(``capacity_factor = E``, ``min_capacity = 1``: capacity = the token
count, so generation does not depend on how requests are batched), as the
JAX model's ``_moe_serve`` does (``model.py:83-96``), through the MoE
kernels of ``ops/transformer/moe.py``.

ALiBi slopes (``model.alibi``, one device tensor a model, at a fixed
address) and each layer's window (``model.window(l)``, a Python int) go to
both paged kernels with every layer's call; a CUDA graph of a decode step
captures them as they are (the slopes' address and the windows as launch
arguments). The JAX engine sends such models to its XLA paged path; the
port's kernels take them.

The KV pool is updated IN PLACE: each layer's new K/V rows are written
with ``index_copy_`` into ``k_pages[l]`` / ``v_pages[l]`` of the
preallocated pool, where the JAX program carries the pool functionally
through its layer loop and donates it at the jit boundary
(``model.py:162-200``). The methods therefore return only their outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ...models.transformer import TransformerLM
from .kernels.paged_decode import paged_gqa_decode
from .kernels.ragged_paged_attention import ragged_paged_attention

#: (q, the layer's k / v pages, the layer index) -> attention
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int], torch.Tensor]


@dataclasses.dataclass
class DecodeState:
    """The tensors one decode step reads and updates in place, on the
    model's device: ``tokens [B]`` (int32, the input token of each row),
    ``positions [B]`` (int32, the position of that token),
    ``block_tables [B, mp]`` (int32; blocks for every step of the burst
    already allocated), ``temperatures [B]`` (fp32), the step index ``k
    [1]`` (int64) and the history ``hist [B, width]`` (int64), whose column
    ``k`` each step fills. A CUDA graph of a step reads and writes these
    tensors at fixed addresses, so the engine fills them in place."""
    tokens: torch.Tensor
    positions: torch.Tensor
    block_tables: torch.Tensor
    temperatures: torch.Tensor
    k: torch.Tensor
    hist: torch.Tensor

    @classmethod
    def empty(cls, batch: int, mp: int, width: int, device) -> "DecodeState":
        i32 = dict(dtype=torch.int32, device=device)
        return cls(tokens=torch.zeros(batch, **i32), positions=torch.zeros(batch, **i32),
                   block_tables=torch.zeros(batch, mp, **i32),
                   temperatures=torch.zeros(batch, dtype=torch.float32, device=device),
                   k=torch.zeros(1, dtype=torch.int64, device=device),
                   hist=torch.zeros(batch, width, dtype=torch.int64, device=device))

    def load(self, tokens, positions, block_tables, temperatures) -> None:
        """Copy a burst's inputs (tensors or numpy arrays of the state's
        shapes) into the state and set the step index to 0."""
        for dst, src in ((self.tokens, tokens), (self.positions, positions),
                         (self.block_tables, block_tables),
                         (self.temperatures, temperatures)):
            dst.copy_(torch.as_tensor(src))
        self.k.zero_()


def sample_next(logits: torch.Tensor, temperatures: torch.Tensor, sampled: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The next token of each row of fp32 ``logits [B, V]`` (int64 [B]):
    ``argmax(logits)``, and where ``sampled`` a Gumbel-max draw from
    softmax(logits / T) for the rows with ``T > 0``, its uniforms from
    ``generator``. ``sampled`` False draws nothing."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampled:
        return greedy
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u))      # u = 0 gives -inf: never drawn
    drawn = torch.argmax(logits / temperatures.clamp_min(1e-6)[:, None] + gumbel, dim=-1)
    return torch.where(temperatures <= 0.0, greedy, drawn)


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
        """Every layer over the flat stream ``x [N, hidden]``: sequential
        or parallel blocks (the JAX serving model's ``body``,
        ``model.py:187-195``), MoE MLPs routed dropless."""
        rope = self.model.rope(positions) if self.config.position == "rope" else None
        for l, block in enumerate(self.model.blocks):
            h1 = block.ln_1(x)
            q, k, v = self.model._qkv(block, h1, rope)
            self._write_kv(k_pages[l], k, write_idx)
            self._write_kv(v_pages[l], v, write_idx)
            attn = attn_fn(q, k_pages[l], v_pages[l], l)
            x, _ = self.model._residual(block, x, h1, attn, None, dropless=True)
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

        slopes = self.model.alibi(x.device)

        def attn(q, k_l, v_l, l):
            return ragged_paged_attention(q, k_l, v_l, kv_lens, page_tables,
                                          cu_q_lens, scale=self._scale,
                                          block_q=self.ragged_block_q,
                                          alibi_slopes=slopes, window=self.model.window(l))

        x = self._layer_loop(k_pages, v_pages, x, attn, write_idx, positions)
        sel = x[last_rows.long().clamp(0, x.shape[0] - 1)]
        return self._unembed(sel)

    @torch.inference_mode()
    def decode_step(self, k_pages, v_pages, state: DecodeState, sampled: bool = False,
                    generator: Optional[torch.Generator] = None) -> None:
        """One decode step of the B sequences of ``state``, the JAX burst's
        scan body ``one``: embed each row's input token, write its K/V at
        its position, attend over its block table with ``paged_gqa_decode``
        and pick the next token (``sample_next``). In place, on the
        device: the token goes to ``hist[:, k]``, becomes the input token,
        and ``positions`` and ``k`` advance by one. Nothing is read back to
        the host, so K calls run K steps, and a CUDA graph of one call
        replays a step."""
        ps = self.block_size
        max_flat = k_pages.shape[2] * ps
        max_pos = self.max_blocks_per_seq * ps - 1
        tables = state.block_tables
        x = self._embed(state.tokens, state.positions)
        pos_c = state.positions.clamp(0, max_pos)
        page_slot = (pos_c // ps).clamp(0, tables.shape[1] - 1)
        pages_of = tables.gather(1, page_slot[:, None].long())[:, 0]
        write_idx = (pages_of.long() * ps + pos_c % ps).clamp(0, max_flat - 1)
        ctx = (pos_c + 1).to(torch.int32)

        slopes = self.model.alibi(x.device)

        def attn(q, k_l, v_l, l):
            return paged_gqa_decode(q, k_l, v_l, ctx, tables, scale=self._scale,
                                    alibi_slopes=slopes, window=self.model.window(l))

        x = self._layer_loop(k_pages, v_pages, x, attn, write_idx, state.positions)
        nxt = sample_next(self._unembed(x), state.temperatures, sampled, generator)
        state.hist.index_copy_(1, state.k, nxt[:, None])
        state.tokens.copy_(nxt)
        state.positions.add_(1)
        state.k.add_(1)

    @torch.inference_mode()
    def decode_burst(self, k_pages, v_pages, tokens, positions, block_tables,
                     temperatures: torch.Tensor, num_steps: int,
                     generator: Optional[torch.Generator] = None,
                     sampled: Optional[bool] = None) -> torch.Tensor:
        """K = ``num_steps`` calls of ``decode_step`` for B sequences, run
        eagerly: greedy (argmax) where temperature <= 0, else a Gumbel-max
        draw from softmax(logits / T) with ``generator``.
        ``positions[b]`` is the position of the INPUT token; blocks for
        all K steps must already be in ``block_tables [B, mp]`` (int32).
        ``sampled`` says whether any row samples; None reads it from
        ``temperatures`` (one read back to the host, before the first
        step). Returns the sampled tokens [B, K] (int64)."""
        if sampled is None:
            sampled = bool((temperatures > 0).any())
        state = DecodeState.empty(tokens.shape[0], block_tables.shape[1], num_steps,
                                  tokens.device)
        state.load(tokens, positions, block_tables, temperatures)
        for _ in range(num_steps):
            self.decode_step(k_pages, v_pages, state, sampled, generator)
        return state.hist
