"""Training attention of the port.

Counterpart of ``deepspeed_tpu/ops/transformer/attention.py``. The JAX
module chooses between XLA attention, a query-chunked XLA path and several
Pallas kernels by sequence length and ``DSTPU_*`` switches, thresholds set
from TPU measurements (``FLASH_DEFAULT_MIN_SEQ``). The port has one
implementation: ``flash_attention`` is the flash kernel pair
(``flash.py``) on CUDA tensors and its plain version on CPU tensors, at
every length, with no switches.

``attention_reference`` mirrors the JAX ``_xla_attention``: the whole
score matrix at once, GQA without repeating K/V, bottom-right causal via
``q_offset``, window, segment ids and ALiBi. Tests hold it against the
JAX function; nothing on the training path calls it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .flash import flash_attention_kernel


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (Press et al.; HF BLOOM's
    ``build_alibi_tensor`` closest-power-of-2 construction)."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = base ** np.arange(1, closest + 1, dtype=np.float32)
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_extra = min(closest, num_heads - closest)
        extra = extra_base ** np.arange(1, 1 + 2 * n_extra, 2, dtype=np.float32)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


def sliding_window_allowed(q_pos: torch.Tensor, k_pos: torch.Tensor,
                           window) -> torch.Tensor:
    """True where key ``k_pos`` is within the causal sliding window of query
    ``q_pos`` (broadcasting); ``window`` <= 0 is global."""
    allowed = (q_pos - k_pos) < int(window)
    return allowed if int(window) > 0 else torch.ones_like(allowed)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: Optional[float],
                        segment_ids: Optional[torch.Tensor],
                        alibi: Optional[torch.Tensor] = None,
                        window=None, q_offset=None,
                        q_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference-semantics attention (``_xla_attention``), ``[B, S, H, D]``
    in and out: fp32 logits, -1e30 masking, fp32 softmax cast to q's dtype
    before the product with V."""
    B, Sq, H, D = q.shape
    kvH, k_len = k.shape[2], k.shape[1]
    G = H // kvH
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qt = q.permute(0, 2, 1, 3).reshape(B, kvH, G, Sq, D)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qt.float(), kt.float()) * scale
    if q_offset is None:
        q_offset = k_len - Sq
    q_pos = torch.arange(Sq, device=q.device)[:, None] + int(q_offset)
    k_pos = torch.arange(k_len, device=q.device)[None, :]
    if alibi is not None:
        rel = (k_pos - q_pos).float()
        slopes = torch.as_tensor(alibi, device=q.device).float().reshape(kvH, G)
        logits = logits + slopes[None, :, :, None, None] * rel
    if causal:
        mask = q_pos >= k_pos
        if window is not None:
            mask = mask & sliding_window_allowed(q_pos, k_pos, window)
        logits = torch.where(mask[None, None, None], logits, -1e30)
    if segment_ids is not None:
        q_seg = q_segment_ids if q_segment_ids is not None else segment_ids
        seg_mask = q_seg[:, :, None] == segment_ids[:, None, :]
        logits = torch.where(seg_mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vt)
    return out.reshape(B, H, Sq, D).permute(0, 2, 1, 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    alibi_slopes=None, window=None, q_offset=None,
                    q_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention, ``[B, S, H, D]``, GQA-aware, differentiable:
    the flash kernels on CUDA, their plain version on the CPU.
    ``alibi_slopes`` [num_heads] adds the ALiBi bias; ``window`` (0 =
    global) is the causal sliding window; ``q_offset`` the first query's
    position among the keys (default bottom-right: ``Sk - Sq``);
    ``q_segment_ids`` the queries' segment ids where they are not
    ``segment_ids`` (the keys')."""
    return flash_attention_kernel(q, k, v, causal=causal, scale=scale,
                                  segment_ids=segment_ids, q_segment_ids=q_segment_ids,
                                  alibi_slopes=alibi_slopes, window=window,
                                  q_offset=q_offset)
