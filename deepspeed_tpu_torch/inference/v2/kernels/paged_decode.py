"""Paged GQA decode attention: one query token per sequence against its
block table.

Counterpart of ``deepspeed_tpu/inference/v2/kernels/pallas_paged_decode.py``
(``paged_gqa_decode``). The decode bursts (``RaggedInferenceModel
.decode_burst``) call it once per layer and step.

- plain version: ``paged_decode_attention_reference`` (the JAX
  ``_xla_paged_decode``), run for tensors on the CPU;
- kernel: ``csrc/paged_decode.cu`` (the Pallas ``_decode_kernel``'s
  counterpart), launched for tensors on a GPU, with q pre-scaled and cast
  back to q's dtype as the Pallas call does. ``launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .paged_attention import paged_decode_attention_reference
from .ragged_paged_attention import check_kernel_args

launches = 0


def paged_gqa_decode(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, context_lens: torch.Tensor,
                     block_tables: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, D]; k_pages/v_pages [kvH, P, ps, D]; context_lens [B]
    (including the token just written at ``context_lens[b]-1``);
    block_tables [B, mp] -> [B, H, D]."""
    B, H, D = q.shape
    kvH = k_pages.shape[0]
    if H % kvH:
        raise ValueError(f"query heads {H} not a multiple of kv heads {kvH}")
    if k_pages.dtype != q.dtype:
        raise NotImplementedError(
            f"a KV pool of {k_pages.dtype} under {q.dtype} queries (fp8 KV) "
            f"is not ported (ROADMAP A5)")
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages,
                                                context_lens, block_tables,
                                                scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no paged decode attention for {q.device}")
    return _paged_gqa_decode_cuda(q, k_pages, v_pages, context_lens,
                                  block_tables, scale)


def bind(lib: ctypes.CDLL):
    """The kernel's C entry point in a built library, typed."""
    fn = lib.dstt_paged_decode
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from ....ops.op_builder import builder
    return bind(builder.load("paged_decode"))


def _paged_gqa_decode_cuda(q, k_pages, v_pages, context_lens, block_tables,
                           scale: float):
    global launches
    B, H, D = q.shape
    kvH, P, ps, _ = k_pages.shape
    mp = block_tables.shape[1]
    check_kernel_args(q, k_pages, v_pages, (
        ("context_lens", context_lens), ("block_tables", block_tables)))
    if context_lens.shape != (B,) or block_tables.shape[0] != B:
        raise ValueError(f"context_lens {tuple(context_lens.shape)} / "
                         f"block_tables {tuple(block_tables.shape)} for {B} "
                         f"sequences")
    q_scaled = (q * scale).to(q.dtype)
    out = torch.empty_like(q)
    rc = _kernel()(q_scaled.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   out.data_ptr(), context_lens.data_ptr(),
                   block_tables.data_ptr(), B, H, kvH, P, ps, D, mp,
                   int(q.dtype == torch.bfloat16),
                   torch.cuda.current_stream(q.device).cuda_stream)
    from ....ops.op_builder.builder import launch_check
    launch_check(rc, "paged_gqa_decode")
    launches += 1
    return out
