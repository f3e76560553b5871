"""Ring attention: sequence parallelism whose K/V stay sequence-sharded and
rotate around the ``seq`` group.

Counterpart of ``deepspeed_tpu/sequence/ring_attention.py``. Each rank keeps
its query slice ``[b, s, H, D]`` (``s = S / sp``) and sees every rank's K/V
slice pass by, one hop at a time: sp flash calls (``flash_attention_with_lse``,
``ops/transformer/flash.py``), one a K/V slice, each at ``q_offset = (r -
owner) * s`` when causal (0 on the diagonal, ``+k s`` for a slice wholly in
the past, ``-k s`` for one wholly in the future, which comes back as (0,
``MASK_VALUE``) and merges to nothing), else 0. The partial results merge
exactly in fp32 (``merge_partials``), so no ``[s, s]`` score buffer exists
and no past hop is renormalized. Between two calls K and V move one rank
along the ring (``_HopWire.hop``): sp - 1 hops, as the sp-th of the JAX
loop carries blocks back to their owners unread.

The hop's wire is the transport planner's ``permute_width`` for activations
(int8 by default: ``quantized_ppermute``, the int8 row quantizer on CUDA;
``bf16`` a cast; ``full`` the identity). The backward is autograd through the
flash operator (with a cotangent on the LSE, which the merge produces), the
merge, and each hop's inverse: the cotangent travels the inverse ring at
full width. Both directions are recorded (``comm.record_collective``) with
their wire bytes.

The port has this one body: on CPU tensors the flash wrapper runs its plain
version, as everywhere in the port. JAX's second body ``_ring_local``, plain
XLA online softmax behind ``DSTPU_ATTN=xla``, is a test reference here
(``tests/test_torch_sequence.py``), not a second path.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..comm import comm as dist
from ..ops.quantizer.quantizer import quantized_ppermute
from ..ops.transformer.attention import flash_attention
from ..ops.transformer.flash import MASK_VALUE, flash_attention_with_lse, merge_partials
from ..runtime import topology as topo_mod
from ..utils.groups import SEQ_AXIS


class _Permute(torch.autograd.Function):
    """``comm.ppermute``; the backward permutes along the inverse ring."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return dist.ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inv = [(dst, src) for src, dst in ctx.perm]
        return dist.ppermute(g.contiguous(), inv, ctx.group), None, None


class _HopWire:
    """How one K or V block travels a hop on the transport plan's width:
    ``int8`` as a quantized payload with fp32 scales and zero points
    (``quantized_ppermute``), ``bf16`` a cast there and back, ``full`` as it
    is. Each hop is recorded on the ``seq`` axis with its wire bytes, and so
    is its inverse in the backward, which carries the cotangent at the width
    it arrives in (the block's own for ``int8`` and ``full``, bf16 for
    ``bf16``)."""

    def __init__(self, plan: dist.TransportPlan):
        self.plan = plan

    def hop(self, t: torch.Tensor, perm, group) -> torch.Tensor:
        nbytes = t.numel() * t.element_size()
        dist.record_collective("ppermute", nbytes, SEQ_AXIS, overlapped=False,
                               wire_bytes=self.plan.wire_bytes(t.numel(), t.element_size()))
        if self.plan.width == dist.WIDTH_INT8:
            return _recorded(quantized_ppermute(t, perm, group,
                                                group_size=self.plan.group_size), nbytes)
        if self.plan.width == dist.WIDTH_BF16 and t.element_size() > 2:
            return _recorded(_Permute.apply(t.to(torch.bfloat16), perm, group),
                             nbytes).to(t.dtype)
        return _recorded(_Permute.apply(t, perm, group), nbytes)


def _recorded(out: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``out``, whose cotangent, when the backward reaches it, is recorded
    as the inverse hop that carries it (``nbytes`` logical)."""
    if out.requires_grad:
        out.register_hook(lambda g: dist.record_collective(
            "ppermute", nbytes, SEQ_AXIS, overlapped=False,
            wire_bytes=g.numel() * g.element_size()))
    return out


def _ring_local_flash(q, k, v, *, sp: int, rank: int, group, causal: bool,
                      scale: float) -> torch.Tensor:
    """This rank's body: q / k / v its slices ``[b, s, H|kvH, D]``."""
    B, s, H, D = q.shape
    perm = [(j, (j + 1) % sp) for j in range(sp)]
    wire = _HopWire(dist.resolve_transport(dist.KIND_ACTIVATION, "ppermute",
                                           k.numel() * k.element_size(), SEQ_AXIS))
    # the cross-hop carry is fp32: merging in the input dtype would re-round
    # the running output once a hop
    o = torch.zeros((B, s, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, s), MASK_VALUE, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(sp):
        owner = (rank - i) % sp                   # the rank k_cur came from
        o_h, lse_h = flash_attention_with_lse(
            q, k_cur, v_cur, causal=causal, scale=scale,
            q_offset=(rank - owner) * s if causal else 0)
        o, lse = merge_partials(o, lse, o_h.float(), lse_h)
        if i + 1 < sp:
            k_cur = wire.hop(k_cur, perm, group)
            v_cur = wire.hop(v_cur, perm, group)
    return o.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q ``[b, s, H, D]``, k / v ``[b, s, kvH, D]``, this rank's slices of a
    sequence-sharded sequence (as ``ulysses_attention`` takes them); plain
    local attention without a published ``seq`` axis."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    sp, r, group = topo_mod.sequence_parallel()
    if sp <= 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _ring_local_flash(q, k, v, sp=sp, rank=r, group=group, causal=causal,
                             scale=scale)
