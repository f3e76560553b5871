"""Paged GQA decode attention: one query token per sequence against its
block table.

Counterpart of ``deepspeed_tpu/inference/v2/kernels/pallas_paged_decode.py``
(``paged_gqa_decode``). The decode bursts (``RaggedInferenceModel
.decode_step``) call it once per layer and step.

- plain version: ``paged_decode_attention_reference`` (the JAX
  ``_xla_paged_decode``), run for tensors on the CPU;
- kernel: ``csrc/paged_decode.cu`` (the Pallas ``_decode_kernel``'s
  counterpart), launched for tensors on a GPU. It scales q and rounds it
  back to q's dtype itself, as the Pallas call's caller does, so a call is
  one launch. ``launches`` counts launches.

``alibi_slopes [H]`` (fp32) and ``window`` (0 or None = global) are the
layer's ALiBi slopes and causal window, in the plain version and the
kernel alike.

The kernel splits each context over its visible keys (``split_plan``:
from ``max(0, ctx - window)`` under a window, so a local layer reads its
window, not the context): units of ``SPLIT_UNIT`` keys, at most
``max_splits(mp, ps, window)`` splits a sequence,
each a block; the last block of a (sequence, kv head, row group) merges
the splits' partials in split order in the same launch. The partials and
the blocks' counters live in buffers this module keeps per device and
stream (``_scratch``); every launch leaves the counters zero. What a
captured CUDA graph may rely on: the buffers it captured stay where they
are for the life of the process, and its counters are zero at the start
of every replay (the launch before left them so); a capture never
allocates scratch, so the step runs once on the capture stream first.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from ....ops.scratch import Scratch
from .paged_attention import paged_decode_attention_reference
from .ragged_paged_attention import check_kernel_args, kernel_slopes

launches = 0

SPLIT_UNIT = 128  # keys a split unit (csrc/paged_decode.cu kUnit)
MAX_SPLITS = 16   # splits a sequence at most
MAX_ROW_BYTES = 1024  # a K / V row: bf16 D 512, fp32 D 256 (any D below)


def max_splits(mp: int, ps: int, window: int = 0) -> int:
    """Splits a sequence at most, from the block table's width and the
    layer's window alone (the host knows both without a sync): one per unit
    of the widest context the table holds, or of the window, at most
    ``MAX_SPLITS``."""
    keys = mp * ps if window <= 0 else min(mp * ps, window)
    return max(1, min(MAX_SPLITS, -(-keys // SPLIT_UNIT)))


def split_plan(context_len: int, mp: int, ps: int,
               window: int = 0) -> List[Tuple[int, int]]:
    """The key ranges ``[lo, hi)`` the kernel's splits take for one context,
    in split order (``csrc/paged_decode.cu`` ``plan``): the keys from
    ``max(0, context_len - window)`` (0 without a window) to
    ``min(context_len, mp * ps)`` in units of ``SPLIT_UNIT``, cut into at
    most ``max_splits(mp, ps, window)`` runs of whole units; no keys is one
    empty split."""
    n_keys = min(max(context_len, 0), mp * ps)
    lo = min(max(context_len - window, 0), n_keys) if window > 0 else 0
    units = max(1, -(-(n_keys - lo) // SPLIT_UNIT))
    per = -(-units // min(max_splits(mp, ps, window), units))
    n = -(-units // per)
    return [(lo + s * per * SPLIT_UNIT, min(lo + (s + 1) * per * SPLIT_UNIT, n_keys))
            for s in range(n)]


def row_group(g: int, row_bytes: int = 0) -> int:
    """Query rows of one kv head a block takes (the kernel's GR): the whole
    GQA group up to 8 rows, else groups of 8; at most 2 for K / V rows of
    more than 512 bytes (32 lanes a row: the registers of 2 rows), and 1 for
    rows that are no multiple of 16 bytes (the kernel's NARROW form, built
    for one row a block only)."""
    gr = 1 if g == 1 else 2 if g == 2 else 4 if g <= 4 else 8
    if row_bytes % 16:
        return 1
    return min(gr, 2) if row_bytes > 512 else gr


def paged_gqa_decode(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, context_lens: torch.Tensor,
                     block_tables: torch.Tensor,
                     scale: Optional[float] = None,
                     alibi_slopes: Optional[torch.Tensor] = None,
                     window: Optional[int] = None) -> torch.Tensor:
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
                                                scale, alibi_slopes, window)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no paged decode attention for {q.device}")
    return _paged_gqa_decode_cuda(q, k_pages, v_pages, context_lens,
                                  block_tables, scale, alibi_slopes, window)


def bind(lib: ctypes.CDLL):
    """The kernel's C entry point in a built library, typed."""
    fn = lib.dstt_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                  ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from ....ops.op_builder import builder
    return bind(builder.load("paged_decode"))


# the split partials and counters, per (device, stream): every launch leaves
# the counters zero (the last block of a cell resets its counter), so they
# are zeroed once, and a captured graph's replays find them zero too;
# launches on one stream run in order. A buffer a graph captured is never
# freed or moved (``ops/scratch.py``).
_bufs = Scratch()


def _scratch(dev: torch.device, stream: int, n_partial: int, n_cells: int,
             capturing: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index or 0, stream)
    part = _bufs.get(key + ("partial",), n_partial, lambda n: torch.empty(
        max(n, 1 << 16), dtype=torch.float32, device=dev), capturing)
    cnt = _bufs.get(key + ("counters",), n_cells, lambda n: torch.zeros(
        max(n, 1024), dtype=torch.int32, device=dev), capturing)
    return part, cnt


def _paged_gqa_decode_cuda(q, k_pages, v_pages, context_lens, block_tables,
                           scale: float, alibi_slopes=None, window: Optional[int] = None):
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
    if D * q.element_size() > MAX_ROW_BYTES:
        raise NotImplementedError(
            f"head_dim {D} in {q.dtype}: the decode kernel takes rows of at "
            f"most {MAX_ROW_BYTES} bytes, 32 lanes a row (ROADMAP B10)")
    gr = row_group(H // kvH, D * q.element_size())
    cells = B * kvH * -(-(H // kvH) // gr)
    window = max(int(window or 0), 0)
    splits = max_splits(mp, ps, window)
    slopes = kernel_slopes(alibi_slopes, q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counters = _scratch(q.device, stream, cells * splits * gr * (D + 2), cells,
                              torch.cuda.is_current_stream_capturing())
    out = torch.empty_like(q)
    rc = _kernel()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   out.data_ptr(), context_lens.data_ptr(),
                   block_tables.data_ptr(), part.data_ptr(), counters.data_ptr(), slopes,
                   B, H, kvH, P, ps, D, mp, splits, gr, window, scale,
                   int(q.dtype == torch.bfloat16), stream)
    from ....ops.op_builder.builder import launch_check
    launch_check(rc, "paged_gqa_decode")
    launches += 1
    return out
