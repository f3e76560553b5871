"""Plain PyTorch paged attention over a blocked KV cache.

Counterpart of ``deepspeed_tpu/inference/v2/kernels/paged_attention.py``
(``_gather_pages``, ``_xla_paged_decode``, ``ragged_chunk_attention``,
``chunk_prefill_attention``; ``:58-240``). These are the plain versions the
two CUDA kernels are held against, and what the kernel wrappers run for
tensors on the CPU. Numerics follow the JAX functions: fp32 logits, the
same ``NEG_INF`` masking, softmax in fp32, probabilities cast to the query
dtype before the product with V.

Page layout everywhere: ``[kv_heads, num_pages, page_size, head_dim]``.

ALiBi and sliding windows follow the JAX contract (``:192-201``):
``alibi_slopes [H]`` adds ``slope[h] * (c - pos_q)`` in fp32 to the scaled
logits before the mask, head ``h = kv * g + gi`` (the slopes laid out
``reshape(kvH, g)``); ``window`` (an int, 0 or None = global) keeps the keys
``sliding_window_allowed`` allows, the last ``window`` positions up to the
query's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ....ops.transformer.attention import sliding_window_allowed

NEG_INF = -2.3819763e38


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """pages [kvH, P, ps, D], block_tables [B, mp] -> [B, kvH, mp*ps, D]."""
    g = pages[:, block_tables.long()]                  # [kvH, B, mp, ps, D]
    if out_dtype is not None and g.dtype != out_dtype:
        g = g.to(out_dtype)
    kvH, B, mp, ps, D = g.shape
    return g.permute(1, 0, 2, 3, 4).reshape(B, kvH, mp * ps, D)


def _scale(D: int, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / (D ** 0.5)


def _alibi(alibi_slopes, kvH: int, device) -> torch.Tensor:
    """fp32 slopes ``[kvH, g]`` (head ``h = kv * g + gi``)."""
    return torch.as_tensor(alibi_slopes, device=device).float().reshape(kvH, -1)


def paged_decode_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     context_lens: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     scale: Optional[float] = None,
                                     alibi_slopes: Optional[torch.Tensor] = None,
                                     window: Optional[int] = None) -> torch.Tensor:
    """One query token per sequence: q [B, H, D] -> [B, H, D].

    ``context_lens[b]`` counts tokens INCLUDING the one just written at
    position ``context_lens[b]-1`` (``_xla_paged_decode``)."""
    B, H, D = q.shape
    k = _gather_pages(k_pages, block_tables, out_dtype=q.dtype)
    v = _gather_pages(v_pages, block_tables, out_dtype=q.dtype)
    kvH, C = k.shape[1], k.shape[2]
    qg = q.reshape(B, kvH, H // kvH, D)
    logits = torch.einsum("bkgd,bkcd->bkgc", qg.float(), k.float()) * _scale(D, scale)
    keys = torch.arange(C, device=q.device)[None, :]
    pos_q = context_lens.long()[:, None] - 1                      # [B, 1]
    if alibi_slopes is not None:
        rel = (keys - pos_q).float()                              # [B, C]
        logits = logits + _alibi(alibi_slopes, kvH, q.device)[None, :, :, None] \
            * rel[:, None, None, :]
    mask = keys < context_lens[:, None]
    if window is not None:
        mask = mask & sliding_window_allowed(pos_q, keys, window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgc,bkcd->bkgd", probs, v).reshape(B, H, D)


def ragged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, history_lens: torch.Tensor,
                           block_tables: torch.Tensor,
                           scale: Optional[float] = None,
                           alibi_slopes: Optional[torch.Tensor] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Batched SplitFuse attention: S sequence-chunks x T tokens each.

    q [S, T, H, D]; query t of chunk s sits at absolute position
    ``history_lens[s] + t`` and sees context positions ``<=`` that.
    block_tables [S, mp]. Returns [S, T, H, D]."""
    S, T, H, D = q.shape
    k = _gather_pages(k_pages, block_tables, out_dtype=q.dtype)  # [S,kvH,C,D]
    v = _gather_pages(v_pages, block_tables, out_dtype=q.dtype)
    kvH, C = k.shape[1], k.shape[2]
    qg = q.reshape(S, T, kvH, H // kvH, D).permute(0, 2, 3, 1, 4)  # [S,k,g,T,D]
    logits = torch.einsum("skgtd,skcd->skgtc", qg.float(), k.float()) * _scale(D, scale)
    pos_q = history_lens.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    keys = torch.arange(C, device=q.device)[None, None, :]
    if alibi_slopes is not None:
        rel = (keys - pos_q[:, :, None]).float()                  # [S, T, C]
        logits = logits + _alibi(alibi_slopes, kvH, q.device)[None, :, :, None, None] \
            * rel[:, None, None]
    allowed = keys <= pos_q[:, :, None]
    if window is not None:
        allowed = allowed & sliding_window_allowed(pos_q[:, :, None], keys, window)
    logits = torch.where(allowed[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("skgtc,skcd->skgtd", probs, v)
    return out.permute(0, 3, 1, 2, 4).reshape(S, T, H, D)


def chunk_prefill_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                            v_ctx: torch.Tensor, history_len: torch.Tensor,
                            scale: Optional[float] = None,
                            alibi_slopes: Optional[torch.Tensor] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """Prefill-chunk attention for ONE sequence.

    q [T, H, D] at absolute positions ``history_len + i``; k_ctx/v_ctx
    [kvH, C, D] (history + this chunk). Causal: query i sees context
    positions ``<= history_len + i``. Returns [T, H, D]."""
    T, H, D = q.shape
    kvH, C, _ = k_ctx.shape
    qg = q.reshape(T, kvH, H // kvH, D).permute(1, 2, 0, 3)      # [kvH, g, T, D]
    logits = torch.einsum("kgtd,kcd->kgtc", qg.float(), k_ctx.float()) * _scale(D, scale)
    pos_q = history_len + torch.arange(T, device=q.device)
    keys = torch.arange(C, device=q.device)[None, :]
    if alibi_slopes is not None:
        rel = (keys - pos_q[:, None]).float()
        logits = logits + _alibi(alibi_slopes, kvH, q.device)[:, :, None, None] * rel[None, None]
    allowed = keys <= pos_q[:, None]
    if window is not None:
        allowed = allowed & sliding_window_allowed(pos_q[:, None], keys, window)
    logits = torch.where(allowed[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("kgtc,kcd->kgtd", probs, v_ctx.to(q.dtype))
    return out.permute(2, 0, 1, 3).reshape(T, H, D)
