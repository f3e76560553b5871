"""Ulysses sequence parallelism.

Counterpart of ``deepspeed_tpu/sequence/layer.py``. Activations arrive
sequence-sharded: each rank of the ``seq`` group holds ``[b, s/sp, h, d]``,
its contiguous slice of the sequence (``runtime/topology.py``).

``ulysses_attention`` has two forms with one result, full-sequence
attention of the rank's query rows:

- the all-to-all form, where the query heads and the kv heads divide by
  sp: one all-to-all a tensor scatters heads and gathers the sequence
  (``[b, s/sp, h, d] -> [b, s, h/sp, d]``), the local attention runs on the
  whole sequence and the rank's heads, and the inverse all-to-all brings
  the output back (``_all_to_all_form``). ALiBi slopes are cut to the
  rank's heads, segment ids gathered whole. The exchange is an
  ``autograd.Function`` whose backward is the inverse exchange. (The JAX
  package takes its constraint form for segment ids and ALiBi,
  ``:113-131``; its result is the same full-sequence attention.)
- the gather form, where the heads do not divide: K and V are gathered
  whole along the sequence (the backward reduce-scatters their gradients)
  and the rank's own query rows attend to them at ``q_offset`` = their
  first position. It computes what the JAX constraint form computes.

The exchange travels as ``kind="activation"``: the transport planner's
``activation_width`` (bf16 for wider activations, a pure-movement cast;
full width with ``comm_transport.enabled`` false).

``DistributedAttention`` is the explicit wrapper of the reference class
(scatter ``scatter_idx``, gather ``gather_idx``), at full width.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..comm import comm as dist
from ..runtime import topology as topo_mod
from ..utils.groups import SEQ_AXIS


class _SeqAllToAll(torch.autograd.Function):
    """All-to-all over the seq group; the backward is the inverse one."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, kind, axis):
        ctx.args = (group, split_axis, concat_axis, kind, axis)
        return dist.all_to_all(x, group, split_axis, concat_axis, kind=kind, axis=axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, kind, axis = ctx.args
        return dist.all_to_all(g.contiguous(), group, concat_axis, split_axis, kind=kind,
                               axis=axis), None, None, None, None, None


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """``x [b, s/sp, ...]`` gathered whole along dim 1, in rank order."""
    full = dist.all_gather(x.movedim(1, 0).contiguous(), group=group)
    return full.movedim(0, 1)


class _SeqAllGather(torch.autograd.Function):
    """Gather along the sequence; the backward reduce-scatters (sums) the
    gradient back to each rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        dist.record_collective("all_gather", x.numel() * x.element_size(), SEQ_AXIS,
                               overlapped=False)
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        dist.record_collective("reduce_scatter", g.numel() * g.element_size(), SEQ_AXIS,
                               overlapped=False)
        part = dist.reduce_scatter(g.movedim(1, 0).contiguous(), group=ctx.group)
        return part.movedim(0, 1), None


def _all_to_all_form(attn_fn: Callable, q, k, v, sp: int, r: int, group, kwargs):
    H = q.shape[2]
    slopes = kwargs.get("alibi_slopes")
    if slopes is not None:
        per = H // sp
        kwargs["alibi_slopes"] = torch.as_tensor(slopes).reshape(H)[r * per:(r + 1) * per]
    # The JAX exchange takes its wire kind from the overlap planner's
    # _plan_ulysses (runtime/overlap_planner.py:340-348), which always gives
    # "activation"; the port has no overlap planner (ROADMAP A6) and names
    # the kind itself.
    kind = dist.KIND_ACTIVATION

    def gather_seq(x):   # [b, s/sp, h, d] -> [b, s, h/sp, d]
        return _SeqAllToAll.apply(x, group, 2, 1, kind, SEQ_AXIS)

    out = attn_fn(gather_seq(q), gather_seq(k), gather_seq(v), **kwargs)
    return _SeqAllToAll.apply(out, group, 1, 2, kind, SEQ_AXIS)


def _gather_form(attn_fn: Callable, q, k, v, r: int, group, kwargs, seg_local):
    if seg_local is not None:
        kwargs["q_segment_ids"] = seg_local
    return attn_fn(q, _SeqAllGather.apply(k, group), _SeqAllGather.apply(v, group),
                   q_offset=r * q.shape[1], **kwargs)


def ulysses_attention(attn_fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      **kwargs) -> torch.Tensor:
    """``attn_fn(q, k, v, **kwargs)`` over the whole sequence for this
    rank's slice of it. q ``[b, s/sp, H, D]``, k / v ``[b, s/sp, kvH, D]``,
    ``segment_ids [b, s/sp]`` (optional) sequence-sharded on entry; the
    output ``[b, s/sp, H, D]`` too. Without a published ``seq`` axis it is
    ``attn_fn`` itself. ``attn_fn`` takes ``q_offset`` and
    ``q_segment_ids`` (the gather form passes them)."""
    sp, r, group = topo_mod.sequence_parallel()
    if sp == 1:
        return attn_fn(q, k, v, **kwargs)
    kwargs = dict(kwargs)
    seg = kwargs.get("segment_ids")
    if seg is not None:
        kwargs["segment_ids"] = _gather_seq(torch.as_tensor(seg, device=q.device), group)
    if q.shape[2] % sp == 0 and k.shape[2] % sp == 0:
        return _all_to_all_form(attn_fn, q, k, v, sp, r, group, kwargs)
    return _gather_form(attn_fn, q, k, v, r, group, kwargs, seg)


class DistributedAttention:
    """Explicit all-to-all wrapper (reference ``sequence/layer.py:60``):
    scatter ``scatter_idx`` (heads), gather ``gather_idx`` (sequence) before
    ``local_attention``, the inverse after, at full width.
    ``sequence_process_group`` is an axis name of the published topology
    (default ``seq``), whose exchanges are recorded on it, or a process
    group."""

    def __init__(self, local_attention: Callable, sequence_process_group=SEQ_AXIS,
                 scatter_idx: int = 2, gather_idx: int = 1):
        self.local_attn = local_attention
        self.group = sequence_process_group
        self.scatter_idx = scatter_idx
        self.gather_idx = gather_idx

    def __call__(self, query, key, value, *args, **kwargs):
        group, axis = self.group, None
        if isinstance(group, str):
            t = topo_mod.get_topology()
            group, axis = (None if t is None else t.group(group)), group
        s_i, g_i = self.scatter_idx, self.gather_idx
        q, k, v = (_SeqAllToAll.apply(x, group, s_i, g_i, None, axis)
                   for x in (query, key, value))
        context = self.local_attn(q, k, v, *args, **kwargs)
        return _SeqAllToAll.apply(context, group, g_i, s_i, None, axis)
