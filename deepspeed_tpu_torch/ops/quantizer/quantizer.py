"""Block quantization and the quantized collectives of ZeRO++.

Counterpart of ``deepspeed_tpu/ops/quantizer/quantizer.py``: symmetric and
asymmetric blockwise int8 / int4 quantization (int4 packed two to a byte,
last-axis two's-complement nibbles: the collective wire format), the
scaled-fp8 wire (``torch.float8_e4m3fn``), and the collectives built on
them over a ``torch.distributed`` group:

- ``quantized_all_gather`` (qwZ: the int8 parameter all-gather);
- ``quantized_reduce_scatter`` (qgZ: quantize each destination chunk,
  all-to-all, dequantize, local sum);
- ``fp8_all_gather``, ``fp8_reduce_scatter`` and ``quantized_all_reduce``
  (reduce-scatter then all-gather, both on the low-precision wire);
- ``quantize_with_feedback`` and ``ef_quantized_reduce_scatter`` (error
  feedback on the int8 reduce-scatter: the compensated signal ``x + err``
  goes on the wire and the new residual comes back, ``x``'s shape in fp32;
  the wire, its padding and its layout are the plain call's);
- the issue halves ``quantized_all_gather_start``,
  ``quantized_reduce_scatter_start``, ``ef_quantized_reduce_scatter_start``,
  ``fp8_all_gather_start`` and ``fp8_reduce_scatter_start``: quantize and
  launch, returning a handle whose ``wait()`` dequantizes (the overlap
  schedule's form; each blocking function is its issue half waited at
  once);
- ``quantized_ppermute`` (the ring-attention K/V hop: quantize, permute the
  payload and its scales / zero points, dequantize on arrival; its backward
  permutes the cotangent along the inverse ring at full width, the JAX
  straight-through ``custom_vjp``).

The layouts, the per-segment padding and the effective group size
(``min(group_size, chunk)``, kept even for int4) are the JAX functions', so
the same inputs put the same bytes on the wire. A symmetric int8 quantize
runs the row-quantizer kernel (``ops/quantizer/quant.py``,
``csrc/quant_rows.cu``) on CUDA tensors at any group size; int4,
asymmetric and fp8 stay plain tensor code, as they stay XLA in the JAX
package. Each divide by a constant is the multiply by its fp32 reciprocal
that jitted XLA computes (``_recip``), so the port's wire matches the
jitted JAX wire bit for bit.

The axis argument of the JAX functions becomes ``group`` (a process group,
``None`` for the world).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...comm import comm as dist
from .quant import KERNEL_DTYPES, quantize_rows_int8

FP8_MAX = 448.0   # float8_e4m3fn's largest normal


def _recip(q: float, device) -> torch.Tensor:
    """fp32(1 / q) as a tensor: the multiply XLA compiles ``x / q`` into."""
    return torch.full((), float(np.float32(1.0) / np.float32(q)), dtype=torch.float32,
                      device=device)


def _groups(x: torch.Tensor, group_size: int, keep_dtype: bool = False) -> torch.Tensor:
    """``x`` flattened, zero-padded to a group multiple, ``[G, group_size]``;
    fp32 unless ``keep_dtype`` (the int8 kernel widens bf16 itself)."""
    flat = x.reshape(-1)
    if not keep_dtype:
        flat = flat.float()
    pad = (-flat.numel()) % group_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, group_size)


def gather_in_row_chunks_start(start_one: Callable, x: torch.Tensor, n: int,
                               n_chunks: int):
    """Split a shard's leading dim into ``n_chunks`` launches of
    ``start_one`` (a tiled all-gather over ``n`` members, launched); the
    handle's ``wait()`` interleaves the results back into the single-launch
    layout."""
    if x.shape[0] % n_chunks:
        raise ValueError(f"n_chunks={n_chunks} must divide the shard's "
                         f"leading dim {x.shape[0]}")
    ck = x.shape[0] // n_chunks
    parts = [start_one(x[c * ck:(c + 1) * ck]) for c in range(n_chunks)]

    def interleave(got):
        stacked = torch.stack([p.reshape((n, ck) + tuple(x.shape[1:])) for p in got], dim=1)
        return stacked.reshape((n * x.shape[0],) + tuple(x.shape[1:]))

    return dist.Pending(parts, interleave)


def gather_in_row_chunks(gather_one: Callable, x: torch.Tensor, n: int,
                         n_chunks: int) -> torch.Tensor:
    """:func:`gather_in_row_chunks_start` over a blocking ``gather_one``."""
    return gather_in_row_chunks_start(lambda c: dist.ready(gather_one(c)), x, n,
                                      n_chunks).wait()


def scatter_in_row_chunks_start(start_one: Callable, x: torch.Tensor, n: int,
                                n_chunks: int):
    """Split a reduce-scatter input ``[n*s0, ...]`` along the destination
    rows into ``n_chunks`` launches of ``start_one``; the handle's
    ``wait()`` gives the single launch's layout."""
    s0 = x.shape[0] // n
    if s0 % n_chunks:
        raise ValueError(f"n_chunks={n_chunks} must divide the output's "
                         f"leading dim {s0}")
    ck = s0 // n_chunks
    xr = x.reshape((n, s0) + tuple(x.shape[1:]))
    parts = [start_one(xr[:, c * ck:(c + 1) * ck].reshape((n * ck,) + tuple(x.shape[1:])))
             for c in range(n_chunks)]
    return dist.Pending(parts, lambda got: torch.cat(got, dim=0))


def scatter_in_row_chunks(scatter_one: Callable, x: torch.Tensor, n: int,
                          n_chunks: int) -> torch.Tensor:
    """:func:`scatter_in_row_chunks_start` over a blocking ``scatter_one``."""
    return scatter_in_row_chunks_start(lambda c: dist.ready(scatter_one(c)), x, n,
                                       n_chunks).wait()


def quantize_blockwise(x: torch.Tensor, num_bits: int = 8, group_size: int = 256,
                       symmetric: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, scale [G] fp32, zero [G] fp32)``: q int8 ``[G, group_size]``,
    or for int4 uint8 ``[G, group_size // 2]`` (two nibbles a byte); the
    zero point is all zeros when symmetric."""
    assert num_bits in (4, 8)
    if symmetric and num_bits == 8:
        q, scale = quantize_rows_int8(_groups(x, group_size, keep_dtype=x.dtype in KERNEL_DTYPES))
        return q, scale, torch.zeros_like(scale)
    groups = _groups(x, group_size)
    qmax = (1 << (num_bits - 1)) - 1
    qmin = -qmax - 1
    if symmetric:
        scale = groups.abs().amax(dim=1, keepdim=True) * _recip(qmax, x.device)
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        zero = torch.zeros_like(scale)
    else:
        gmax = groups.amax(dim=1, keepdim=True)
        gmin = groups.amin(dim=1, keepdim=True)
        scale = (gmax - gmin) * _recip(qmax - qmin, x.device)
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        zero = qmin - gmin / scale
    q = torch.clamp(torch.round(groups / scale + zero), qmin, qmax).to(torch.int8)
    if num_bits == 4:
        pairs = q.reshape(-1, group_size // 2, 2).to(torch.int16)
        q = ((pairs[..., 0] & 0x0F) | ((pairs[..., 1] & 0x0F) << 4)).to(torch.uint8)
    return q, scale[:, 0], zero[:, 0]


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                         num_bits: int = 8, group_size: int = 256,
                         out_size: Optional[int] = None, out_shape=None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    assert num_bits in (4, 8)
    if num_bits == 4:
        b = q.to(torch.int16)
        lo, hi = b & 0x0F, (b >> 4) & 0x0F
        lo = torch.where(lo >= 8, lo - 16, lo)
        hi = torch.where(hi >= 8, hi - 16, hi)
        vals = torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)
    else:
        vals = q
    out = ((vals.float() - zero[:, None]) * scale[:, None]).reshape(-1)
    if out_size is not None:
        out = out[:out_size]
    if out_shape is not None:
        out = out.reshape(out_shape)
    return out.to(dtype)


def quantize_blockwise_fp8(x: torch.Tensor, group_size: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled fp8: each group scaled so its absmax lands on 448 and cast to
    ``float8_e4m3fn``; ``(q [G, group_size], scale [G] fp32)``."""
    groups = _groups(x, group_size)
    scale = groups.abs().amax(dim=1, keepdim=True) * _recip(FP8_MAX, x.device)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return (groups / scale).to(torch.float8_e4m3fn), scale[:, 0]


def dequantize_blockwise_fp8(q: torch.Tensor, scale: torch.Tensor,
                             out_size: Optional[int] = None, out_shape=None,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    out = (q.float() * scale[:, None]).reshape(-1)
    if out_size is not None:
        out = out[:out_size]
    if out_shape is not None:
        out = out.reshape(out_shape)
    return out.to(dtype)


def quantize_with_feedback(x: torch.Tensor, err: torch.Tensor, num_bits: int = 8,
                           group_size: int = 256):
    """Error-feedback quantization: quantize the compensated signal
    ``comp = x + err`` (fp32) and return ``(q, scale, zero, comp -
    dequant(q))``, the last the new residual in ``x``'s shape. Carried from
    step to step, the residuals telescope: the dequantized sum over T steps
    is the sum of the signals plus ``err_0 - err_T``, so the accumulated
    error stays one step's quantization error."""
    comp = x.float() + err.float()
    q, scale, zero = quantize_blockwise(comp, num_bits, group_size)
    roundtrip = dequantize_blockwise(q, scale, zero, num_bits, group_size,
                                     out_size=comp.numel(), out_shape=comp.shape)
    return q, scale, zero, comp - roundtrip


def _wire_group_size(n_elems: int, group_size: int, num_bits: int) -> int:
    """The effective group size: never pad a small shard or chunk up to a
    full group; int4 groups stay even."""
    gs = max(1, min(group_size, n_elems))
    if num_bits == 4:
        gs = max(2, gs - gs % 2)
    return gs


def quantized_all_gather_start(x: torch.Tensor, group=None, num_bits: int = 8,
                               group_size: int = 256, n_chunks: int = 1):
    """The issue half of :func:`quantized_all_gather`: quantize the local
    shard (the row-quantizer kernel on CUDA), launch the gathers of the
    payload and of its scales / zero points; the handle's ``wait()``
    dequantizes."""
    n = dist.get_world_size(group)
    if n_chunks > 1:
        return gather_in_row_chunks_start(
            lambda c: quantized_all_gather_start(c, group, num_bits, group_size), x, n,
            n_chunks)
    gs = _wire_group_size(x.numel(), group_size, num_bits)
    q, scale, zero = quantize_blockwise(x, num_bits, gs)
    works = [dist.all_gather_async(q, group=group),
             dist.all_gather_async(torch.stack([scale, zero], dim=1), group=group)]

    def finish(got):
        q_g, side = got
        out = dequantize_blockwise(q_g, side[:, 0].contiguous(), side[:, 1].contiguous(),
                                   num_bits, gs)
        padded = -(-x.numel() // gs) * gs
        out = out.reshape(n, padded)[:, :x.numel()]
        return out.reshape((x.shape[0] * n,) + tuple(x.shape[1:])).to(x.dtype)

    return dist.Pending(works, finish)


def quantized_all_gather(x: torch.Tensor, group=None, num_bits: int = 8,
                         group_size: int = 256, n_chunks: int = 1) -> torch.Tensor:
    """qwZ all-gather: quantize the local shard, all-gather the payload and
    its scales / zero points, dequantize; ``[n * x.shape[0], ...]`` in
    ``x``'s dtype, each member's segment cut at its own group padding."""
    return quantized_all_gather_start(x, group, num_bits, group_size, n_chunks).wait()


def _scatter_wire_start(x: torch.Tensor, group, gs_req: int, num_bits: int, quantize,
                        dequantize, out_dtype: Optional[torch.dtype], err=None):
    """The all-to-all reduce-scatter shared by the int and fp8 wires,
    launched: quantize each destination chunk (padded at its tail to a
    group multiple) and launch the exchanges; ``wait()`` dequantizes and
    sums over the sources in rank order. With ``err`` (``x``'s shape) the
    chunks are quantized with error feedback (``quantize_with_feedback``)
    and ``wait()`` gives ``(out, new_err)``; a padded position's signal and
    residual are both zero, so the residual drops the padding."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce-scatter of leading dim {x.shape[0]} over {n} members")
    chunk = x.numel() // n
    gs = _wire_group_size(chunk, gs_req, num_bits)
    xr = x.reshape(n, chunk)
    er = None if err is None else err.float().reshape(n, chunk)
    pad = (-chunk) % gs
    if pad:
        xr = torch.nn.functional.pad(xr, (0, pad))
        er = None if er is None else torch.nn.functional.pad(er, (0, pad))
    new_err = None
    if er is None:
        q, side = quantize(xr, gs)
    else:
        q, scale, zero, new_err = quantize_with_feedback(xr, er, num_bits, gs)
        side = torch.stack([scale, zero], dim=1)
        new_err = new_err[:, :chunk].reshape(x.shape)
    works = [dist.all_to_all_rows_async(q, group=group),
             dist.all_to_all_rows_async(side, group=group)]

    def finish(got):
        q_t, side_t = got
        shard = dequantize(q_t, side_t, gs).reshape(n, chunk + pad)[:, :chunk]
        out = shard[0]
        for i in range(1, n):
            out = out + shard[i]
        out = out.reshape((x.shape[0] // n,) + tuple(x.shape[1:])).to(out_dtype or x.dtype)
        return out if new_err is None else (out, new_err)

    return dist.Pending(works, finish)


def _int_side(num_bits: int):
    """The int wire's quantize (payload and a ``[G, 2]`` scale / zero
    sideband) and dequantize."""
    def quantize(xr, gs):
        q, scale, zero = quantize_blockwise(xr, num_bits, gs)
        return q, torch.stack([scale, zero], dim=1)

    def dequantize(q, side, gs):
        return dequantize_blockwise(q, side[:, 0].contiguous(), side[:, 1].contiguous(),
                                    num_bits, gs)

    return quantize, dequantize


def quantized_reduce_scatter_start(x: torch.Tensor, group=None, num_bits: int = 8,
                                   group_size: int = 256, n_chunks: int = 1,
                                   out_dtype: Optional[torch.dtype] = None):
    """The issue half of :func:`quantized_reduce_scatter` (quantize with
    the row-quantizer kernel on CUDA, launch the exchanges); the handle's
    ``wait()`` dequantizes and sums."""
    n = dist.get_world_size(group)
    if n_chunks > 1:
        return scatter_in_row_chunks_start(
            lambda c: quantized_reduce_scatter_start(c, group, num_bits, group_size,
                                                     out_dtype=out_dtype), x, n, n_chunks)
    return _scatter_wire_start(x, group, group_size, num_bits, *_int_side(num_bits), out_dtype)


def quantized_reduce_scatter(x: torch.Tensor, group=None, num_bits: int = 8,
                             group_size: int = 256, n_chunks: int = 1,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """qgZ reduce-scatter of ``x [n * s0, ...]`` over the group: member r
    gets the sum of every member's rows ``[r * s0, (r + 1) * s0)``, in
    ``out_dtype`` (default ``x``'s dtype). The payload travels int8 (or
    int4) with per-group scales. A bf16 ``x`` is quantized as it is: the
    result equals that of ``x.float()``, whose copy is never made."""
    return quantized_reduce_scatter_start(x, group, num_bits, group_size, n_chunks,
                                          out_dtype).wait()


def ef_quantized_reduce_scatter_start(x: torch.Tensor, err: torch.Tensor, group=None,
                                      num_bits: int = 8, group_size: int = 256,
                                      out_dtype: Optional[torch.dtype] = None):
    """The issue half of :func:`ef_quantized_reduce_scatter`: the
    compensated quantize (``quantize_with_feedback`` through
    ``quantize_blockwise``, so the row-quantizer kernel on CUDA, in the
    launches of the plain wire) and the exchanges; the handle's ``wait()``
    gives ``(out, new_err)``."""
    if err.shape != x.shape:
        raise ValueError(f"error-feedback residual of shape {tuple(err.shape)} for a "
                         f"reduce-scatter input of shape {tuple(x.shape)}")
    return _scatter_wire_start(x, group, group_size, num_bits, *_int_side(num_bits),
                               out_dtype, err=err)


def ef_quantized_reduce_scatter(x: torch.Tensor, err: torch.Tensor, group=None,
                                num_bits: int = 8, group_size: int = 256,
                                out_dtype: Optional[torch.dtype] = None):
    """:func:`quantized_reduce_scatter` with error feedback: ``(out,
    new_err)``. This member's chunks carry ``x + err`` on the wire, and
    ``new_err`` (``x``'s shape, fp32; zeros on the first step) is the
    residual of their quantization, to be fed back on the next reduction of
    the same bucket. The wire format, padding and output layout are the
    plain call's; only the quantized values differ."""
    return ef_quantized_reduce_scatter_start(x, err, group, num_bits, group_size,
                                             out_dtype).wait()


def fp8_reduce_scatter_start(x: torch.Tensor, group=None, group_size: int = 256,
                             n_chunks: int = 1):
    """The issue half of :func:`fp8_reduce_scatter`."""
    n = dist.get_world_size(group)
    if n_chunks > 1:
        return scatter_in_row_chunks_start(
            lambda c: fp8_reduce_scatter_start(c, group, group_size), x, n, n_chunks)
    return _scatter_wire_start(x, group, group_size, 8, quantize_blockwise_fp8,
                               lambda q, scale, gs: dequantize_blockwise_fp8(q, scale), None)


def fp8_reduce_scatter(x: torch.Tensor, group=None, group_size: int = 256,
                       n_chunks: int = 1) -> torch.Tensor:
    """:func:`quantized_reduce_scatter` on the scaled-fp8 wire (one fp32
    scale a group, no zero point)."""
    return fp8_reduce_scatter_start(x, group, group_size, n_chunks).wait()


def fp8_all_gather_start(x: torch.Tensor, group=None, group_size: int = 256,
                         n_chunks: int = 1):
    """The issue half of :func:`fp8_all_gather`."""
    n = dist.get_world_size(group)
    if n_chunks > 1:
        return gather_in_row_chunks_start(lambda c: fp8_all_gather_start(c, group, group_size),
                                          x, n, n_chunks)
    gs = max(1, min(group_size, x.numel()))
    q, scale = quantize_blockwise_fp8(x, gs)
    works = [dist.all_gather_async(q, group=group), dist.all_gather_async(scale, group=group)]

    def finish(got):
        out = dequantize_blockwise_fp8(*got)
        padded = -(-x.numel() // gs) * gs
        out = out.reshape(n, padded)[:, :x.numel()]
        return out.reshape((x.shape[0] * n,) + tuple(x.shape[1:])).to(x.dtype)

    return dist.Pending(works, finish)


def fp8_all_gather(x: torch.Tensor, group=None, group_size: int = 256,
                   n_chunks: int = 1) -> torch.Tensor:
    """:func:`quantized_all_gather` on the scaled-fp8 wire."""
    return fp8_all_gather_start(x, group, group_size, n_chunks).wait()


def quantized_all_reduce(x: torch.Tensor, group=None, num_bits: int = 8,
                         group_size: int = 256, fp8: bool = False) -> torch.Tensor:
    """All-reduce as a quantized reduce-scatter then a quantized all-gather
    of the reduced shard (the JAX function's flat form; its ``outer``
    hierarchical tier needs two live data axes: ROADMAP A6)."""
    n = dist.get_world_size(group)
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    if fp8:
        full = fp8_all_gather(fp8_reduce_scatter(flat, group, group_size), group, group_size)
    else:
        full = quantized_all_gather(quantized_reduce_scatter(flat, group, num_bits, group_size),
                                    group, num_bits, group_size)
    return full[:x.numel()].reshape(x.shape).to(x.dtype)


class _QuantizedHop(torch.autograd.Function):
    """One quantized hop; the backward is the straight-through inverse hop."""

    @staticmethod
    def forward(ctx, x, perm, group, num_bits, group_size):
        ctx.perm, ctx.group = perm, group
        gs = _wire_group_size(x.numel(), group_size, num_bits)
        q, scale, zero = quantize_blockwise(x, num_bits, gs)
        q = dist.ppermute(q, perm, group)
        side = dist.ppermute(torch.stack([scale, zero], dim=1), perm, group)
        return dequantize_blockwise(q, side[:, 0].contiguous(), side[:, 1].contiguous(),
                                    num_bits, gs, out_size=x.numel(), out_shape=x.shape,
                                    dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        inv = [(dst, src) for src, dst in ctx.perm]
        return dist.ppermute(g.contiguous(), inv, ctx.group), None, None, None, None


def quantized_ppermute(t: torch.Tensor, perm, group=None, num_bits: int = 8,
                       group_size: int = 256) -> torch.Tensor:
    """Quantized point-to-point permutation (ring hops): quantize ``t``
    blockwise (symmetric, groups of ``min(group_size, t.numel())``),
    permute the payload with its fp32 scales and zero points, dequantize on
    arrival into ``t``'s dtype and shape. Differentiable: the backward
    permutes the cotangent along the inverse ring at full width
    (quantization is the identity to autograd), so rotating K/V blocks keep
    their gradients."""
    return _QuantizedHop.apply(t, list(perm), group, num_bits, group_size)
