"""Layer-granular ZeRO overlap: the bucket-planned collectives of the
pipelined gather-compute-scatter schedule.

Counterpart of ``deepspeed_tpu/runtime/zero/overlap.py``. The barrier
schedule (``DataParallelEngine``) gathers the whole tree before the loss and
reduce-scatters every gradient after the whole backward, so all of its
collective time is exposed. The overlap schedule gathers layer *l+1* while
layer *l* computes and reduce-scatters layer *l*'s gradients while layer
*l-1*'s backward runs; this module owns its communication half:

- ``build_tree_comm`` plans one leaf list's launches with
  ``zero/partition.py`` ``plan_comm_buckets``: small leaves fused into one
  flat collective (``allgather_bucket_size`` / ``reduce_bucket_size``),
  oversize leaves split into chunks. Each bucket gets its transport plan
  from ``comm.resolve_transport`` (parameters ``KIND_PARAM``, int8 when qwZ
  asks; gradients ``KIND_GRAD``, whose default wire is int8 for buckets of
  at least ``comm_transport.min_bytes``, as in JAX). A quantized fused
  buffer pads each leaf to a multiple of the quantization group (256) so
  that no group spans two leaves.
- ``TreeComm.gather`` / ``scatter`` launch a leaf list's collectives and
  return a handle (``comm.Pending``) whose ``wait()`` gives the full params
  or the reduced gradient shards (divided by the data-parallel size): the
  schedule issues and computes on. ``flush_deferred`` reduces the
  replicated leaves that ``scatter`` left local, one fused all-reduce per
  dtype at the micro-step boundary (the planner's ``defer_replicated``).
- Error feedback (``comm_transport.error_feedback``): ``err_struct`` gives
  one residual slot a scatter launch (its shape, None where feedback does
  not apply); ``scatter(gs, err=slots)`` quantizes each eligible bucket
  with ``ef_quantized_reduce_scatter`` and its handle gives ``(shards,
  new_slots)``. Feedback applies to the flat int8 wire of a bucket whose
  leaves have a shard dim and that is not split into chunks.
- Every launch is recorded with ``comm.record_collective`` (logical and
  wire bytes) under the tree's schedule class, overlapped or exposed;
  ``schedule_class`` overrides it for the schedule's edge launches (the
  forward's prologue gather, the backward's last reduce-scatter), which have
  no compute to hide under. The port launches eagerly, so each launch is
  recorded once, where it runs; the JAX ``trace_executions`` (a scan body
  traced once and launched per iteration) has no counterpart.

A leaf list here is one schedule step's leaves in flatten order, each a
tensor ``[lps, *leaf shape]`` (the step's layers stacked, ``lps`` 1 or 2),
described by its shard dim in that view (None: replicated over the data
ranks). Not ported: the hierarchical scatter, which needs a second live
data axis (hpZ / MiCS) and is never chosen on the port's one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...comm import comm as dist
from ...ops.quantizer.quantizer import (ef_quantized_reduce_scatter_start,
                                        fp8_all_gather_start, fp8_reduce_scatter_start,
                                        gather_in_row_chunks_start,
                                        quantized_all_gather_start,
                                        quantized_reduce_scatter_start,
                                        scatter_in_row_chunks_start)
from ...utils.groups import DATA_AXIS
from .partition import BucketEntry, plan_comm_buckets

_QUANT_GROUP = 256  # quantizer default; fused buffers pad leaves to this


@dataclasses.dataclass(frozen=True)
class LeafComm:
    """A leaf's collective geometry: its shard dim (None: replicated over
    the data ranks), the axes of its gather / scatter, its full shape and
    dtype."""
    dim: Optional[int]
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: Any


def _leaf_comms(dims, shapes, dtypes, n_dp: int) -> List[LeafComm]:
    out = []
    for dim, shape, dtype in zip(dims, shapes, dtypes):
        live = dim is not None and n_dp > 1
        out.append(LeafComm(dim=dim if live else None, axes=(DATA_AXIS,) if live else (),
                            shape=tuple(shape), dtype=dtype))
    return out


def _pad_rows(k: int, quantized: bool) -> int:
    """A k-element leaf's segment in a fused buffer: rounded up to a
    quantization-group multiple on a quantized wire (zeros quantize
    exactly under symmetric quantization)."""
    if not quantized:
        return k
    return -(-k // _QUANT_GROUP) * _QUANT_GROUP


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def build_tree_comm(names: Sequence[str], gather_dims, grad_dims, shapes, dtypes, *,
                    n_dp: int, quant_weights: bool, quant_grads: bool,
                    allgather_bucket: int, reduce_bucket: int, overlapped: bool,
                    name: str = "", defer_replicated: bool = False,
                    group=None) -> "TreeComm":
    """The gather / scatter pair of one leaf list (the JAX function's
    arguments with the spec trees as shard dims, in flatten order).
    ``gather_dims``: where the gathers read from (the param shard dims);
    ``grad_dims``: where the gradient shards land. ``defer_replicated``:
    replicated leaves skip their reduction in ``scatter`` and come back
    local, for ``flush_deferred``."""
    gcomms = _leaf_comms(gather_dims, shapes, dtypes, n_dp)
    scomms = _leaf_comms(grad_dims, shapes, dtypes, n_dp)

    def plan(comms, bucket):
        sizes = [int(np.prod(lc.shape)) or 1 for lc in comms]
        keys = [(lc.axes, _dtype_name(lc.dtype)) for lc in comms]
        exts = [None if lc.dim is None else lc.shape[lc.dim] // n_dp for lc in comms]
        return plan_comm_buckets(sizes, keys, exts, bucket)

    gather_plan, g_over = plan(gcomms, allgather_bucket)
    scatter_plan, s_over = plan(scomms, reduce_bucket)

    def transports(entries, comms, kind, requested, op):
        plans = []
        for e in entries:
            lc = comms[e.leaves[0]]
            if lc.dim is None:
                plans.append(dist.TransportPlan())   # replicated leaf: a full all-reduce
                continue
            nbytes = sum(int(np.prod(comms[i].shape)) for i in e.leaves) * 4
            plans.append(dist.resolve_transport(kind, op, nbytes, lc.axes,
                                                axis_sizes={DATA_AXIS: n_dp},
                                                requested=requested))
        return plans

    gather_tp = transports(gather_plan, gcomms, dist.KIND_PARAM,
                           dist.WIDTH_INT8 if quant_weights else None, "all_gather")
    scatter_tp = transports(scatter_plan, scomms, dist.KIND_GRAD,
                            dist.WIDTH_INT8 if quant_grads else None, "reduce_scatter")
    return TreeComm(list(names), gcomms, scomms, gather_plan, scatter_plan, gather_tp,
                    scatter_tp, oversize=sorted({names[i] for i in g_over}
                                                | {names[i] for i in s_over}),
                    n_dp=n_dp, overlapped=overlapped, name=name,
                    defer_replicated=defer_replicated, group=group)


class TreeComm:
    """The launches of one leaf list (``build_tree_comm``)."""

    def __init__(self, names, gcomms, scomms, gather_plan: List[BucketEntry],
                 scatter_plan: List[BucketEntry], gather_tp, scatter_tp, *, oversize,
                 n_dp: int, overlapped: bool, name: str, defer_replicated: bool, group):
        self.names = names
        self.gcomms, self.scomms = gcomms, scomms
        self.gather_plan, self.scatter_plan = gather_plan, scatter_plan
        self.gather_tp, self.scatter_tp = gather_tp, scatter_tp
        self.oversize = oversize
        self.n_dp = n_dp
        self.overlapped = overlapped
        self.name = name
        self.group = group
        self.defer_replicated = defer_replicated
        #: leaves whose reduction ``scatter`` leaves to ``flush_deferred``
        self.deferred_leaves = tuple(i for i, lc in enumerate(scomms)
                                     if lc.dim is None) if defer_replicated else ()

    @contextlib.contextmanager
    def schedule_class(self, overlapped: bool):
        """Record the launches issued inside as ``overlapped`` (the
        schedule's edge launches are exposed by design)."""
        old = self.overlapped
        self.overlapped = bool(overlapped)
        try:
            yield
        finally:
            self.overlapped = old

    def _rec(self, op: str, nbytes: int, tp: Optional[dist.TransportPlan] = None,
             n_elems: Optional[int] = None, itemsize: int = 4) -> None:
        wire = tp.wire_bytes(n_elems, itemsize) if tp is not None else nbytes
        dist.record_collective(op, nbytes, DATA_AXIS, overlapped=self.overlapped,
                               wire_bytes=wire)

    def plan_summary(self) -> str:
        fused = sum(1 for e in self.gather_plan if len(e.leaves) > 1)
        chunked = sum(1 for e in self.gather_plan if e.chunks > 1)
        widths = sorted({tp.width for tp in self.scatter_tp})
        return (f"{self.name}: {len(self.gcomms)} leaves -> {len(self.gather_plan)} gather "
                f"launches ({fused} fused, {chunked} chunked) / {len(self.scatter_plan)} "
                f"reduce launches (widths {'/'.join(widths)}, 0 hierarchical)")

    # -- gather ----------------------------------------------------------------
    def _gather_one(self, x: torch.Tensor, lc: LeafComm, chunks: int, tp):
        if lc.dim is None:
            return dist.ready(x)
        xm = x.movedim(lc.dim, 0)
        self._rec("all_gather", x.numel() * x.element_size(), tp, x.numel(), x.element_size())
        g = self.group
        if tp.width == dist.WIDTH_INT8:
            h = quantized_all_gather_start(xm, g, group_size=tp.group_size, n_chunks=chunks)
        elif tp.width == dist.WIDTH_FP8:
            h = fp8_all_gather_start(xm, g, group_size=tp.group_size, n_chunks=chunks)
        elif chunks > 1:
            h = gather_in_row_chunks_start(lambda c: dist.all_gather_async(c, g), xm,
                                           self.n_dp, chunks)
        else:
            h = dist.all_gather_async(xm, g)
        return dist.Pending([h], lambda r: r[0].movedim(0, lc.dim).contiguous())

    def _gather_fused(self, xs, lcs, tp):
        n, q = self.n_dp, tp.quantized
        flats, meta = [], []
        for x, lc in zip(xs, lcs):
            xm = x.movedim(lc.dim, 0)
            k = xm.numel()
            kp = _pad_rows(k, q)
            f = xm.reshape(-1)
            if kp != k:
                f = torch.nn.functional.pad(f, (0, kp - k))
            flats.append(f)
            meta.append((tuple(xm.shape), k, kp))
        buf = torch.cat(flats)
        self._rec("all_gather", buf.numel() * buf.element_size(), tp, buf.numel(),
                  buf.element_size())
        if tp.width == dist.WIDTH_INT8:
            h = quantized_all_gather_start(buf, self.group, group_size=tp.group_size)
        elif tp.width == dist.WIDTH_FP8:
            h = fp8_all_gather_start(buf, self.group, group_size=tp.group_size)
        else:
            h = dist.all_gather_async(buf, self.group)

        def split(r):
            R = r[0].reshape(n, buf.numel())
            outs, off = [], 0
            for lc, (mshape, k, kp) in zip(lcs, meta):
                seg = R[:, off:off + k].reshape((n,) + mshape)
                off += kp
                full = seg.reshape((n * mshape[0],) + mshape[1:])
                outs.append(full.movedim(0, lc.dim).to(lc.dtype).contiguous())
            return outs

        return dist.Pending([h], split)

    def gather(self, xs: Sequence[torch.Tensor]):
        """Launch the gathers of the leaf list ``xs`` (this rank's shards,
        replicated leaves whole); the handle's ``wait()`` gives the full
        leaves in order."""
        parts, where = [], []
        for entry, tp in zip(self.gather_plan, self.gather_tp):
            if len(entry.leaves) == 1:
                i = entry.leaves[0]
                parts.append(self._gather_one(xs[i], self.gcomms[i], entry.chunks, tp))
                where.append((i,))
            else:
                lcs = [self.gcomms[i] for i in entry.leaves]
                parts.append(self._gather_fused([xs[i] for i in entry.leaves], lcs, tp))
                where.append(entry.leaves)

        def place(results):
            outs = [None] * len(xs)
            for leaves, r in zip(where, results):
                for i, o in zip(leaves, r if len(leaves) > 1 else [r]):
                    outs[i] = o
            return outs

        return dist.Pending(parts, place)

    # -- scatter ---------------------------------------------------------------
    def _wire_input(self, g: torch.Tensor, tp) -> torch.Tensor:
        """What a reduction sends: the int8 quantizer reads bf16 as it is
        (its result equals that of the fp32 copy, which is never made);
        every other wire reduces in fp32."""
        return g if tp.width == dist.WIDTH_INT8 else g.float()

    def _ef_applies(self, tp) -> bool:
        """Error feedback compensates the flat int8 wire (a hierarchical
        plan keeps the plain quantizer, as in JAX; the port never plans
        one)."""
        return tp.error_feedback and tp.width == dist.WIDTH_INT8 \
            and tp.algo != dist.ALGO_HIERARCHICAL

    def _start_scatter(self, x: torch.Tensor, tp, chunks: int = 1, err=None):
        """Launch one reduction; with ``err`` (an eligible bucket's
        residual) the handle gives ``(shard, new_err)``."""
        g = self.group
        if err is not None:
            return ef_quantized_reduce_scatter_start(x, err, g, group_size=tp.group_size,
                                                     out_dtype=torch.float32)
        if tp.width == dist.WIDTH_INT8:
            return quantized_reduce_scatter_start(x, g, group_size=tp.group_size,
                                                  n_chunks=chunks, out_dtype=torch.float32)
        if tp.width == dist.WIDTH_FP8:
            return fp8_reduce_scatter_start(x, g, group_size=tp.group_size, n_chunks=chunks)
        if chunks > 1:
            return scatter_in_row_chunks_start(lambda c: dist.reduce_scatter_async(c, group=g),
                                               x, self.n_dp, chunks)
        return dist.reduce_scatter_async(x, group=g)

    @staticmethod
    def _split_err(r, err):
        """A reduction's result and its new residual (None without one)."""
        return r if err is not None else (r, None)

    def _scatter_one(self, g: torch.Tensor, lc: LeafComm, chunks: int, tp, err=None):
        """One leaf's reduction; the handle gives ``(shard, new_err)``
        (``new_err`` None unless ``err`` was given to an eligible leaf)."""
        if lc.dim is None:
            if self.defer_replicated:
                return dist.ready((g, None))
            self._rec("all_reduce", g.numel() * g.element_size())
            h = dist.all_reduce_async(g, group=self.group)
            return dist.Pending([h], lambda r: (r[0] / self.n_dp, None))
        op = "all_to_all" if tp.quantized else "reduce_scatter"
        self._rec(op, g.numel() * 4, tp, g.numel())
        err = err if self._ef_applies(tp) and chunks <= 1 else None
        h = self._start_scatter(self._wire_input(g, tp).movedim(lc.dim, 0), tp, chunks, err)

        def finish(r):
            out, new_err = self._split_err(r[0], err)
            return out.movedim(0, lc.dim) / self.n_dp, new_err

        return dist.Pending([h], finish)

    def _scatter_fused(self, gs, lcs, tp, err=None):
        """A fused bucket's reduction; the handle gives ``(shards,
        new_err)``, the residual flat over the bucket's destination-major
        buffer."""
        n = self.n_dp
        cols, meta = [], []
        for g, lc in zip(gs, lcs):
            gm = self._wire_input(g, tp).movedim(lc.dim, 0)
            rest_shape = (gm.shape[0] // n,) + tuple(gm.shape[1:])
            k = int(np.prod(rest_shape))
            kp = _pad_rows(k, tp.quantized)
            col = gm.reshape(n, k)   # destination-major rows
            if kp != k:
                col = torch.nn.functional.pad(col, (0, kp - k))
            cols.append(col)
            meta.append((rest_shape, k, kp))
        buf = torch.cat(cols, dim=1).reshape(-1)
        op = "all_to_all" if tp.quantized else "reduce_scatter"
        self._rec(op, buf.numel() * 4, tp, buf.numel())
        err = err if self._ef_applies(tp) else None
        h = self._start_scatter(buf, tp, err=err)

        def split(r):
            red, new_err = self._split_err(r[0], err)
            outs, off = [], 0
            for lc, (rest_shape, k, kp) in zip(lcs, meta):
                seg = red[off:off + k].reshape(rest_shape)
                off += kp
                outs.append(seg.movedim(0, lc.dim) / n)
            return outs, new_err

        return dist.Pending([h], split)

    def err_struct(self) -> List[Optional[Tuple[int, ...]]]:
        """The error-feedback residual of each scatter launch: its shape
        (fp32), or None where feedback does not apply (a full-width, fp8,
        replicated or chunked bucket). A lone leaf's residual is the leaf
        with its shard dim first; a fused bucket's is flat, ``n`` times the
        sum of its leaves' padded shard sizes. The caller owns the state:
        zeros first, then what ``scatter(..., err=)`` gives back."""
        out: List[Optional[Tuple[int, ...]]] = []
        for entry, tp in zip(self.scatter_plan, self.scatter_tp):
            lcs = [self.scomms[i] for i in entry.leaves]
            if lcs[0].dim is None or not self._ef_applies(tp) or entry.chunks > 1:
                out.append(None)
            elif len(lcs) == 1:
                lc = lcs[0]
                out.append((lc.shape[lc.dim],) + tuple(s for d, s in enumerate(lc.shape)
                                                         if d != lc.dim))
            else:
                n = self.n_dp
                out.append((n * sum(_pad_rows(int(np.prod(lc.shape)) // n, tp.quantized)
                                    for lc in lcs),))
        return out

    def scatter(self, gs: Sequence[torch.Tensor], err: Optional[Sequence] = None):
        """Launch the reductions of the gradient list ``gs`` (full leaves);
        the handle's ``wait()`` gives this rank's fp32 shards divided by the
        data-parallel size (a replicated leaf whole and reduced, or local
        where deferred). With ``err`` (a residual a launch, as
        ``err_struct`` shapes them) the eligible buckets are compensated and
        ``wait()`` gives ``(shards, new_err)``; an eligible slot given None
        comes back as zeros, an ineligible one as None."""
        parts, where = [], []
        for j, (entry, tp) in enumerate(zip(self.scatter_plan, self.scatter_tp)):
            e_in = err[j] if err is not None else None
            if len(entry.leaves) == 1:
                i = entry.leaves[0]
                parts.append(self._scatter_one(gs[i], self.scomms[i], entry.chunks, tp, e_in))
                where.append((i,))
            else:
                lcs = [self.scomms[i] for i in entry.leaves]
                parts.append(self._scatter_fused([gs[i] for i in entry.leaves], lcs, tp, e_in))
                where.append(entry.leaves)

        def place(results):
            outs, new_errs = [None] * len(gs), []
            for leaves, (r, ne) in zip(where, results):
                for i, o in zip(leaves, r if len(leaves) > 1 else [r]):
                    outs[i] = o
                new_errs.append(ne)
            if err is None:
                return outs
            dev = gs[0].device
            return outs, [torch.zeros(s, dtype=torch.float32, device=dev)
                          if ne is None and s is not None else ne
                          for ne, s in zip(new_errs, self.err_struct())]

        return dist.Pending(parts, place)

    def flush_deferred(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Reduce the deferred replicated gradients ``leaves`` (the local
        values ``scatter`` returned, any number of steps' worth): one fused
        all-reduce per dtype, divided by the data-parallel size, each leaf
        back in its shape. Bitwise the per-leaf all-reduces."""
        leaves = list(leaves)
        by_dtype = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flats = [leaves[i].reshape(-1) for i in idx]
            buf = torch.cat(flats) if len(flats) > 1 else flats[0]
            self._rec("all_reduce", buf.numel() * buf.element_size())
            red = dist.all_reduce(buf, group=self.group) / self.n_dp
            off = 0
            for i in idx:
                k = leaves[i].numel()
                leaves[i] = red[off:off + k].reshape(leaves[i].shape)
                off += k
        return leaves
