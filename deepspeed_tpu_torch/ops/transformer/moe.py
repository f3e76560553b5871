"""The mixture-of-experts route, dispatch gather and grouped expert FFN, with
the combine fused into the FFN's epilogue or run on its own.

Counterpart of ``deepspeed_tpu/ops/transformer/pallas_moe.py``. Five
wrappers, each beside its plain version (run for tensors on the CPU) and
its kernel (launched for tensors on a GPU; ``launches`` counts launches per
wrapper):

- ``moe_route`` (``moe_route_reference``; ``csrc/moe_route.cu``, the
  counterpart of ``_route_kernel``): fp32 or bf16 logits [T, E] (bf16 cast
  to fp32 in the kernel, as the JAX kernel's body casts) -> ``src [E*C]``
  int32 (token + 1, 0 = empty slot), ``slot_w [E*C]``, ``slot_tk [T, k]``
  int32 (the slot of each kept choice, 0 where dropped), ``w_tk [T, k]``
  (0 where dropped), ``me`` and ``ce [E]``;
- ``moe_dispatch_gather`` (``csrc/moe_dispatch.cu``, ``_gather_kernel``):
  ``tokens[max(src - 1, 0)]`` cast to the wire dtype, [T, H] -> [E*C, H];
- ``moe_dispatch_gather_int8`` (``csrc/moe_dispatch.cu``,
  ``_gather_int8_kernel``): the same rows (zeroed for empty slots with
  ``mask_pad``), each quantized as one symmetric int8 group: ``(q [E*C, H]
  int8, scale [E*C] fp32)``, byte-identical to ``quantize_rows_int8`` of the
  gathered rows (``ops/quantizer/quant.py``); ``plan_gather_int8`` is its
  launch plan (the wire quantizer's row forms, whose code it shares). No
  forward calls it: its path is the int8 expert exchange, which waits for a
  live expert axis (ROADMAP A6 / A7), as in the JAX package;
- ``moe_ffn_combine`` (``csrc/moe_ffn.cu``, ``_ffn_combine_kernel``): the
  grouped gated FFN over the payload [E, C, H] with ``slot_w * y``
  scattered into the token-major fp32 output [T, H];
- ``moe_ffn`` (``csrc/moe_ffn.cu``, ``_ffn_kernel``): the same FFN storing
  ``y [E, C, H]`` fp32;
- ``moe_combine`` (``csrc/moe_dispatch.cu``, ``_combine_kernel``):
  ``out[t] = sum_k w_tk[t, k] * y[slot_tk[t, k]]`` fp32, k in order from 0,
  for top_k 1 or 2 (a template parameter of the kernel); ``plan_combine``
  is its launch plan (threads a token, units a thread, a grid sized to the
  card).

``make_moe_forward`` composes them as the JAX function does: the router
product ``tokens @ gate`` (a plain ``torch.matmul``, as XLA computes it
there) fed to the route uncast, ``aux = sum(me * ce) * E`` when the caller
asks for it (serving does not), the gather, then the fused
FFN + combine for at most ``MOE_FUSED_COMBINE_MAX_TOKENS`` tokens and the
split FFN -> combine above. The threshold is the port's own, set from the
H100 sweep in ``chip_smoke.py`` (``PERF.md``); the JAX VMEM budgets
(``_FUSED_OUT_BUDGET``, ``_ROUTE_BUDGET``, ``_FFN_BUDGET``) are TPU numbers
and are not carried over. The capacity-chunked scan (``n_chunks``) exists
for a live expert axis and waits for it (ROADMAP A6). With gradients on,
the forward is the custom operator ``MOE_FWD_OP``: it saves the tokens and
the weights, and its backward is the VJP of the plain
``moe/layer.py`` ``moe_reference_forward`` recomputed at them, as the JAX
``custom_vjp`` has it (``pallas_moe.py`` ``make_moe_forward``).

Expert weights are in the ``[out, in]`` layout, the reduction axis
contiguous as the FFN kernel reads it: ``wi_gate`` / ``wi_up`` / ``wi``
``[E, F, H]`` and ``wo [E, H, F]`` (the JAX ``[E, H, F]`` / ``[E, F, H]``
transposed in their last two axes; ``convert.params_from_jax`` does it).
``gate`` is ``[H, E]`` as in JAX.

Numerics: routes are bitwise the plain version (``moe/sharded_moe.py``).
The FFN multiplies in fp32 (bf16 operands on the tensor cores) with the
intermediate ``silu(g) * u`` rounded to the compute dtype before the down
product; ``y``, the combine and the output before its final cast are
fp32. Rows of ``y`` whose slot is empty are zeros in the kernel and in the
plain version (the kernel skips empty capacity tiles; dropless serving
fills ``k * T`` of the ``E * T`` slots). The fused and split forms give the
same bits: each output element is 0 plus at most two products, added in
either order. Above 16 slots an expert, bf16 takes the kernel's wave form,
which counts each expert's filled slots in ``src`` and walks the row tiles
that hold them under one stream of each block's weight rows.

Not served, as the JAX kernel serves neither (``moe_kernel_supported``):
top_k > 2, fp16 (whose pad rows the XLA path masks) and activations other
than ``silu_gated`` and ``gelu``; they raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ...moe.sharded_moe import top_k_gating_indices
from ...nn import layers as L
from ..quantizer.quant import FORMS, _pow2, plan_rows, quantize_rows_int8_reference

ACTIVATIONS = ("silu_gated", "gelu")
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_EXPERTS = 64    # the route kernel's (csrc/moe_route.cu: kMaxE)
#: tokens up to which the forward takes the fused FFN + combine; the split
#: FFN -> combine above. Set from the H100 sweep of chip_smoke.py
#: (``[moe-sweep]``, PERF.md): fused up to the largest swept token count at
#: which it leads by more than 2% (256, 5.7% in two sweeps); at every other
#: count swept, 8 to 4096, the two forms are within 2% of each other.
MOE_FUSED_COMBINE_MAX_TOKENS = 256
_LATER = "ROADMAP A7: MoE top_k > 2, fp16 and other activations"

#: ``csrc/moe_dispatch.cu``: the combine's threads a block, 16-byte units a
#: thread and pick at most, blocks an SM its launch bound keeps resident
COMBINE_THREADS, COMBINE_UNITS, COMBINE_BLOCKS_PER_SM = 256, 4, 4

launches = {"moe_route": 0, "moe_dispatch_gather": 0, "moe_dispatch_gather_int8": 0,
            "moe_ffn_combine": 0, "moe_ffn": 0, "moe_combine": 0}


def check_supported(*, activation: str, dtype: torch.dtype, top_k: Optional[int] = None,
                    num_experts: Optional[int] = None) -> None:
    """Raise for what neither the JAX kernel nor the port serves."""
    if top_k is not None and top_k not in (1, 2):
        raise NotImplementedError(f"MoE top_k {top_k}: the route picks 1 or 2 ({_LATER})")
    if activation not in ACTIVATIONS:
        raise NotImplementedError(f"MoE activation {activation!r}: the expert FFN "
                                  f"computes {ACTIVATIONS} ({_LATER})")
    if dtype not in KERNEL_DTYPES:
        raise NotImplementedError(f"MoE in {dtype}: bf16 and fp32 only ({_LATER})")
    if num_experts is not None and not (top_k or 1) <= num_experts <= MAX_EXPERTS:
        raise NotImplementedError(f"MoE over {num_experts} experts with top_k {top_k}: "
                                  f"the route takes top_k <= E <= {MAX_EXPERTS} ({_LATER})")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def moe_route_reference(logits: torch.Tensor, *, top_k: int, capacity: int):
    """The route in torch: ``top_k_gating_indices`` and the inverse slot map
    built from it."""
    T, E = logits.shape
    S = E * capacity
    eidx, pos, keep, weight, _, me = top_k_gating_indices(logits, top_k, capacity)
    ce = (F.one_hot(eidx[:, 0].long(), E).float().sum(dim=0)
          / torch.full((), T, dtype=torch.float32, device=logits.device))
    slot = eidx.long() * capacity + pos.long()
    flat = torch.where(keep, slot, S).reshape(-1)            # dropped choices land past the end
    tok = torch.arange(1, T + 1, dtype=torch.int32, device=logits.device)
    src = torch.zeros(S + 1, dtype=torch.int32, device=logits.device)
    src[flat] = tok.repeat_interleave(top_k)
    slot_w = torch.zeros(S + 1, dtype=torch.float32, device=logits.device)
    slot_w[flat] = weight.reshape(-1)
    return (src[:S], slot_w[:S], torch.where(keep, slot, 0).int(), weight * keep, me, ce)


def moe_dispatch_gather_reference(tokens: torch.Tensor, src: torch.Tensor,
                                  wire_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    out = tokens.index_select(0, (src.long() - 1).clamp_min(0))
    return out if wire_dtype is None else out.to(wire_dtype)


def moe_dispatch_gather_int8_reference(tokens: torch.Tensor, src: torch.Tensor, *,
                                       mask_pad: bool = False):
    rows = tokens.index_select(0, (src.long() - 1).clamp_min(0))
    if mask_pad:
        rows = torch.where((src > 0)[:, None], rows, torch.zeros_like(rows))
    return quantize_rows_int8_reference(rows)


def _mid(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: Optional[torch.Tensor],
         activation: str) -> torch.Tensor:
    """One expert's ``act(x @ wi_gate^T) [* (x @ wi_up^T)]`` in fp32."""
    g = x @ wi_gate.float().T
    if activation == "silu_gated":
        return L.silu(g) * (x @ wi_up.float().T)
    return L.gelu(g)


def moe_ffn_reference(payload: torch.Tensor, wi_gate: torch.Tensor,
                      wi_up: Optional[torch.Tensor], wo: torch.Tensor,
                      src: torch.Tensor, *, activation: str) -> torch.Tensor:
    """The grouped FFN in torch, one expert at a time: fp32 products, the
    intermediate rounded to the payload's dtype, ``y [E, C, H]`` fp32 with
    zeros in the rows of empty slots."""
    E, C, H = payload.shape
    y = torch.empty(E, C, H, dtype=torch.float32, device=payload.device)
    for e in range(E):
        mid = _mid(payload[e].float(), wi_gate[e],
                   None if wi_up is None else wi_up[e], activation)
        y[e] = mid.to(payload.dtype).float() @ wo[e].float().T
    return torch.where((src.view(E, C) > 0)[..., None], y, 0.0)


def moe_ffn_combine_reference(payload, wi_gate, wi_up, wo, src, slot_w,
                              n_tokens: int, *, activation: str) -> torch.Tensor:
    """``moe_ffn_reference`` and the scatter of ``slot_w * y`` into a zeroed
    [n_tokens, H] fp32 output."""
    E, C, H = payload.shape
    y = moe_ffn_reference(payload, wi_gate, wi_up, wo, src,
                          activation=activation).view(E * C, H)
    out = torch.zeros(n_tokens, H, dtype=torch.float32, device=payload.device)
    filled = src > 0
    out.index_add_(0, src[filled].long() - 1, slot_w[filled, None] * y[filled])
    return out


def moe_combine_reference(y: torch.Tensor, slot_tk: torch.Tensor,
                          w_tk: torch.Tensor) -> torch.Tensor:
    """``out[t] = 0 + w_tk[t, 0] * y[slot_tk[t, 0]] + ...`` in fp32, k in order."""
    T, K = slot_tk.shape
    out = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    for k in range(K):
        out = out + w_tk[:, k, None] * y[slot_tk[:, k].long()]
    return out


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def plan_combine(T: int, H: int, vec: bool, sms: int) -> Tuple[int, int, int]:
    """``(lanes, units, blocks)`` of the combine kernel for ``T`` tokens of
    ``H`` columns, read in 16-byte units when ``vec`` (else value by value),
    on a card of ``sms`` SMs: ``lanes`` threads (a power of two up to
    ``COMBINE_THREADS``) share a token's row, ``units`` units a thread and
    pick (at most ``COMBINE_UNITS``; a row longer than ``lanes * units``
    units is walked in tiles of that many), and ``blocks`` covers every
    (token, tile) once or fills the card (``COMBINE_BLOCKS_PER_SM`` an SM),
    whichever is fewer: the groups walk the tokens."""
    n = H // 4 if vec else H
    units = min(COMBINE_UNITS, _pow2(-(-n // COMBINE_THREADS)))
    lanes = min(COMBINE_THREADS, _pow2(-(-n // units)))
    items = T * -(-n // (lanes * units))
    want = -(-items // (COMBINE_THREADS // lanes))
    return lanes, units, max(1, min(want, COMBINE_BLOCKS_PER_SM * sms))


def plan_gather_int8(S: int, H: int, itemsize: int, vec: bool, sms: int
                     ) -> Tuple[str, int, int, int]:
    """``(form, lanes, units, blocks)`` of the int8 dispatch gather for ``S``
    slots of rows of ``H`` values of ``itemsize`` bytes, read in 16-byte units
    when ``vec`` (else value by value), on a card of ``sms`` SMs. The gather
    runs the wire quantizer's row forms (``csrc/quant_common.cuh``) over its
    slots, so its plan is ``quant.plan_rows`` of ``S`` rows of ``H``: at
    Mixtral's H 4096 the ``block`` form (a block a slot's row, 2 bf16 or 4 fp32
    units a thread), ``min(S, 8 * sms)`` blocks walking the slots, which the
    launcher cuts to the blocks the card holds at once."""
    return plan_rows(S, H, itemsize, vec, sms)


class MoeRouteParams(ctypes.Structure):
    """``MoeRouteParams`` of ``csrc/moe_route.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("logits", "src", "slot_w", "slot_tk", "w_tk", "me", "ce")]
                + [(n, ctypes.c_int) for n in ("T", "E", "K", "cap", "bf16")])


class MoeFfnParams(ctypes.Structure):
    """``MoeFfnParams`` of ``csrc/moe_ffn.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "w1", "w3", "w2", "mid", "src", "slot_w", "y", "out")]
                + [(n, ctypes.c_int) for n in
                   ("E", "C", "H", "F", "T", "gated", "bf16", "fused")])


def bind_route(lib: ctypes.CDLL):
    fn = lib.dstt_moe_route
    fn.argtypes = [MoeRouteParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind_dispatch(lib: ctypes.CDLL):
    """``(gather, combine, gather_int8)`` of a ``moe_dispatch`` library."""
    gather, combine = lib.dstt_moe_gather, lib.dstt_moe_combine
    gather_int8 = lib.dstt_moe_gather_int8
    gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    combine.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    gather_int8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    gather.restype = combine.restype = gather_int8.restype = ctypes.c_int
    return gather, combine, gather_int8


def bind_ffn(lib: ctypes.CDLL):
    fn = lib.dstt_moe_ffn
    fn.argtypes = [MoeFfnParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _route_kernel():
    from ..op_builder import builder
    return bind_route(builder.load("moe_route"))


@functools.cache
def _dispatch_kernels():
    from ..op_builder import builder
    return bind_dispatch(builder.load("moe_dispatch"))


@functools.cache
def _ffn_kernel():
    from ..op_builder import builder
    return bind_ffn(builder.load("moe_ffn"))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: {t.dtype} on {t.device} (contiguous "
                         f"{t.is_contiguous()}); the kernel takes contiguous {dtype} on {device}")


def _route_cuda(logits: torch.Tensor, top_k: int, capacity: int):
    from ..op_builder.builder import launch_check
    T, E = logits.shape
    dev = logits.device
    _need("logits", logits, logits.dtype, dev)
    S = E * capacity
    src = torch.empty(S, dtype=torch.int32, device=dev)
    slot_w = torch.empty(S, dtype=torch.float32, device=dev)
    slot_tk = torch.empty(T, top_k, dtype=torch.int32, device=dev)
    w_tk = torch.empty(T, top_k, dtype=torch.float32, device=dev)
    me = torch.empty(E, dtype=torch.float32, device=dev)
    ce = torch.empty(E, dtype=torch.float32, device=dev)
    p = MoeRouteParams(logits=logits.data_ptr(), src=src.data_ptr(), slot_w=slot_w.data_ptr(),
                       slot_tk=slot_tk.data_ptr(), w_tk=w_tk.data_ptr(), me=me.data_ptr(),
                       ce=ce.data_ptr(), T=T, E=E, K=top_k, cap=capacity,
                       bf16=int(logits.dtype == torch.bfloat16))
    launch_check(_route_kernel()(p, _stream(logits)), "moe_route")
    launches["moe_route"] += 1
    return src, slot_w, slot_tk, w_tk, me, ce


def _gather_cuda(tokens: torch.Tensor, src: torch.Tensor, out_dtype: torch.dtype):
    from ..op_builder.builder import launch_check
    T, H = tokens.shape
    _need("tokens", tokens, tokens.dtype, tokens.device)
    _need("src", src, torch.int32, tokens.device)
    out = torch.empty(src.numel(), H, dtype=out_dtype, device=tokens.device)
    rc = _dispatch_kernels()[0](tokens.data_ptr(), src.data_ptr(), out.data_ptr(), src.numel(),
                                T, H, int(tokens.dtype == torch.bfloat16),
                                int(out_dtype == torch.bfloat16), _stream(tokens))
    launch_check(rc, "moe_dispatch_gather")
    launches["moe_dispatch_gather"] += 1
    return out


def _gather_int8_cuda(tokens: torch.Tensor, src: torch.Tensor, mask_pad: bool):
    from ..op_builder.builder import launch_check, sm_count
    T, H = tokens.shape
    dev = tokens.device
    _need("tokens", tokens, tokens.dtype, dev)
    _need("src", src, torch.int32, dev)
    S = src.numel()
    isz = tokens.element_size()
    vec = (H * isz) % 16 == 0 and tokens.data_ptr() % 16 == 0
    form, lanes, units, blocks = plan_gather_int8(S, H, isz, vec, sm_count(dev.index or 0))
    q = torch.empty(S, H, dtype=torch.int8, device=dev)
    scale = torch.empty(S, dtype=torch.float32, device=dev)
    rc = _dispatch_kernels()[2](tokens.data_ptr(), src.data_ptr(), q.data_ptr(),
                                scale.data_ptr(), S, T, H, int(tokens.dtype == torch.bfloat16),
                                int(mask_pad), FORMS.index(form), int(vec),
                                lanes.bit_length() - 1, units, blocks, _stream(tokens))
    launch_check(rc, "moe_dispatch_gather_int8")
    launches["moe_dispatch_gather_int8"] += 1
    return q, scale


def _ffn_cuda(payload, wi_gate, wi_up, wo, src, slot_w, n_tokens: int, activation: str,
              fused: bool) -> torch.Tensor:
    from ..op_builder.builder import launch_check
    E, C, H = payload.shape
    Fd = wi_gate.shape[1]
    dev, dt = payload.device, payload.dtype
    gated = activation == "silu_gated"
    operands = (("payload", payload), ("wi_gate", wi_gate), ("wo", wo)) + (
        (("wi_up", wi_up),) if gated else ())
    for name, t in operands:
        _need(name, t, dt, dev)
    _need("src", src, torch.int32, dev)
    if dt == torch.bfloat16:
        if H % 8 or Fd % 8:
            raise NotImplementedError(f"the bf16 expert FFN reads 16-byte chunks: H {H} and "
                                      f"F {Fd} must be multiples of 8")
        for name, t in operands:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the bf16 expert FFN reads it in 16-byte chunks "
                                 f"(cp.async, TMA), which need a 16-byte aligned start")
    mid = torch.empty(E, C, Fd, dtype=dt, device=dev)
    if fused:
        _need("slot_w", slot_w, torch.float32, dev)
        res = torch.zeros(n_tokens, H, dtype=torch.float32, device=dev)
    else:
        res = torch.empty(E, C, H, dtype=torch.float32, device=dev)
    p = MoeFfnParams(x=payload.data_ptr(), w1=wi_gate.data_ptr(),
                     w3=wi_up.data_ptr() if gated else None, w2=wo.data_ptr(),
                     mid=mid.data_ptr(), src=src.data_ptr(),
                     slot_w=slot_w.data_ptr() if fused else None,
                     y=None if fused else res.data_ptr(), out=res.data_ptr() if fused else None,
                     E=E, C=C, H=H, F=Fd, T=n_tokens, gated=int(gated),
                     bf16=int(dt == torch.bfloat16), fused=int(fused))
    name = "moe_ffn_combine" if fused else "moe_ffn"
    launch_check(_ffn_kernel()(p, _stream(payload)), name)
    launches[name] += 1
    return res


def _combine_cuda(y: torch.Tensor, slot_tk: torch.Tensor, w_tk: torch.Tensor) -> torch.Tensor:
    from ..op_builder.builder import launch_check, sm_count
    S, H = y.shape
    T, K = slot_tk.shape
    dev = y.device
    _need("y", y, torch.float32, dev)
    _need("slot_tk", slot_tk, torch.int32, dev)
    _need("w_tk", w_tk, torch.float32, dev)
    out = torch.empty(T, H, dtype=torch.float32, device=dev)
    vec = H % 4 == 0 and y.data_ptr() % 16 == 0
    lanes, units, blocks = plan_combine(T, H, vec, sm_count(dev.index or 0))
    rc = _dispatch_kernels()[1](y.data_ptr(), slot_tk.data_ptr(), w_tk.data_ptr(),
                                out.data_ptr(), T, K, H, S, int(vec), lanes.bit_length() - 1,
                                units, blocks, _stream(y))
    launch_check(rc, "moe_combine")
    launches["moe_combine"] += 1
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no MoE kernels for {t.device}")
    return t.device.type


def moe_route(logits: torch.Tensor, *, top_k: int, capacity: int):
    """Fused gating: fp32 or bf16 ``logits [T, E]`` -> ``(src [E*C] int32,
    slot_w [E*C] fp32, slot_tk [T, k] int32, w_tk [T, k] fp32, me [E], ce
    [E])``, the route of ``logits.float()`` (the cast is exact). ``aux =
    sum(me * ce) * E`` is left to the caller."""
    T, E = logits.shape
    if logits.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the route takes fp32 or bf16 logits, not {logits.dtype}")
    if T < 1 or capacity < 1:
        raise ValueError(f"route of {T} tokens at capacity {capacity}")
    check_supported(top_k=top_k, activation=ACTIVATIONS[0], dtype=torch.float32,
                    num_experts=E)
    if _on(logits) == "cpu":
        return moe_route_reference(logits.float(), top_k=top_k, capacity=capacity)
    return _route_cuda(logits, top_k, capacity)


def moe_dispatch_gather(tokens: torch.Tensor, src: torch.Tensor, *,
                        wire_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The capacity-slot gather with the wire cast: payload ``[E*C, H]`` in
    ``wire_dtype`` (default: the tokens' dtype), byte-identical to
    ``tokens.index_select(0, (src - 1).clamp_min(0)).to(wire_dtype)``."""
    out_dtype = tokens.dtype if wire_dtype is None else wire_dtype
    if tokens.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise NotImplementedError(f"gather from {tokens.dtype} to {out_dtype}: bf16 and fp32")
    if _on(tokens) == "cpu":
        return moe_dispatch_gather_reference(tokens, src, wire_dtype)
    return _gather_cuda(tokens, src, out_dtype)


def moe_dispatch_gather_int8(tokens: torch.Tensor, src: torch.Tensor, *,
                             mask_pad: bool = False):
    """The capacity-slot gather fused with a per-row symmetric int8
    quantize: ``(q [E*C, H] int8, scale [E*C] fp32)``, byte-identical to
    ``quantize_rows_int8(tokens[max(src - 1, 0)])`` (rows of empty slots
    zeroed first when ``mask_pad``)."""
    if tokens.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(f"int8 gather from {tokens.dtype}: bf16 and fp32")
    if _on(tokens) == "cpu":
        return moe_dispatch_gather_int8_reference(tokens, src, mask_pad=mask_pad)
    return _gather_int8_cuda(tokens, src, mask_pad)


def _check_ffn(payload, wi_gate, wi_up, wo, src, activation):
    E, C, H = payload.shape
    check_supported(activation=activation, dtype=payload.dtype)
    Fd = wi_gate.shape[1]
    want = {"wi_gate": (E, Fd, H), "wo": (E, H, Fd)}
    if activation == "silu_gated":
        if wi_up is None:
            raise ValueError("silu_gated needs wi_up")
        want["wi_up"] = (E, Fd, H)
    for name, t in (("wi_gate", wi_gate), ("wi_up", wi_up), ("wo", wo)):
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {want[name]} for payload "
                             f"{tuple(payload.shape)} (the [E, out, in] layout)")
    if src.numel() != E * C:
        raise ValueError(f"src holds {src.numel()} slots, the payload {E} x {C}")


def moe_ffn_combine(payload: torch.Tensor, wi_gate: torch.Tensor,
                    wi_up: Optional[torch.Tensor], wo: torch.Tensor, src: torch.Tensor,
                    slot_w: torch.Tensor, n_tokens: int, *, activation: str) -> torch.Tensor:
    """Fused grouped FFN + combine scatter: payload ``[E, C, H]`` ->
    token-major fp32 output ``[n_tokens, H]``."""
    _check_ffn(payload, wi_gate, wi_up, wo, src, activation)
    if _on(payload) == "cpu":
        return moe_ffn_combine_reference(payload, wi_gate, wi_up, wo, src, slot_w,
                                         n_tokens, activation=activation)
    return _ffn_cuda(payload, wi_gate, wi_up, wo, src, slot_w, n_tokens, activation, True)


def moe_ffn(payload: torch.Tensor, wi_gate: torch.Tensor, wi_up: Optional[torch.Tensor],
            wo: torch.Tensor, src: torch.Tensor, *, activation: str) -> torch.Tensor:
    """The split form's grouped FFN: ``y [E, C, H]`` fp32, zeros in the rows
    of empty slots (``src == 0``), which the kernel does not compute."""
    _check_ffn(payload, wi_gate, wi_up, wo, src, activation)
    if _on(payload) == "cpu":
        return moe_ffn_reference(payload, wi_gate, wi_up, wo, src, activation=activation)
    return _ffn_cuda(payload, wi_gate, wi_up, wo, src, None, 0, activation, False)


def moe_combine(y: torch.Tensor, slot_tk: torch.Tensor, w_tk: torch.Tensor) -> torch.Tensor:
    """The split combine: ``y [S, H]`` fp32 and the token-major metadata ->
    ``[T, H]`` fp32 (a dropped choice reads slot 0 with weight 0); top_k
    1 or 2, as the route picks."""
    check_supported(top_k=slot_tk.shape[1], activation=ACTIVATIONS[0], dtype=torch.float32)
    if _on(y) == "cpu":
        return moe_combine_reference(y, slot_tk, w_tk)
    return _combine_cuda(y, slot_tk, w_tk)


# ---------------------------------------------------------------------------
# the forward and its backward
# ---------------------------------------------------------------------------


def _kernel_forward(tokens: torch.Tensor, gate: torch.Tensor, wi_gate: torch.Tensor,
                    wi_up: Optional[torch.Tensor], wo: torch.Tensor, top_k: int,
                    capacity: int, activation: str, with_aux: bool):
    """The kernel path: the router product, route, gather, then the fused
    FFN + combine or the split FFN -> combine; ``(out, aux or None)``."""
    T, H = tokens.shape
    E = gate.shape[-1]
    logits = tokens @ gate.to(tokens.dtype)
    src, slot_w, slot_tk, w_tk, me, ce = moe_route(logits, top_k=top_k, capacity=capacity)
    aux = (me * ce).sum() * E if with_aux else None
    cast = lambda t: None if t is None else t.to(tokens.dtype)
    wi_gate, wi_up, wo = cast(wi_gate), cast(wi_up), cast(wo)
    payload = moe_dispatch_gather(tokens, src).view(E, capacity, H)
    if T <= MOE_FUSED_COMBINE_MAX_TOKENS:
        out = moe_ffn_combine(payload, wi_gate, wi_up, wo, src, slot_w, T,
                              activation=activation)
    else:
        y = moe_ffn(payload, wi_gate, wi_up, wo, src, activation=activation)
        out = moe_combine(y.view(E * capacity, H), slot_tk, w_tk)
    return out.to(tokens.dtype), aux


# The differentiable forward is a custom operator, as flash's is
# (``ops/transformer/flash.py``): a dispatch mode (the remat policies of
# ``runtime/activation_checkpointing``) sees it as ONE op, never the ctypes
# launches inside it, and keeps or recomputes it whole. It saves only its
# inputs; its backward is the VJP of the plain ``moe/layer.py``
# ``moe_reference_forward`` recomputed at them, the design of the JAX
# ``custom_vjp`` (``pallas_moe.py`` ``make_moe_forward``): no kernel computes
# an MoE gradient, and the reference's batched products stay ``torch.bmm``,
# as XLA computes them there. Both sides route from the same
# ``tokens @ gate`` and the route kernel is bitwise its plain version, so the
# backward differentiates the routes the forward took.
@torch.library.custom_op("dstpu_torch::moe_fwd", mutates_args=())
def _moe_fwd_op(tokens: torch.Tensor, gate: torch.Tensor, wi_gate: torch.Tensor,
                wi_up: Optional[torch.Tensor], wo: torch.Tensor, top_k: int, capacity: int,
                activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return _kernel_forward(tokens, gate, wi_gate, wi_up, wo, top_k, capacity, activation,
                           True)


#: the forward operator (what a remat policy names to keep or recompute)
MOE_FWD_OP = torch.ops.dstpu_torch.moe_fwd.default


def _setup_context(ctx, inputs, output):
    tokens, gate, wi_gate, wi_up, wo, *static = inputs
    ctx.save_for_backward(tokens, gate, wi_gate, wi_up, wo)
    ctx.static = tuple(static)
    ctx.set_materialize_grads(False)


def _backward(ctx, d_out, d_aux):
    from ...moe.layer import moe_reference_forward
    top_k, capacity, activation = ctx.static
    need = ctx.needs_input_grad[:5]
    gated = activation == "silu_gated"
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        tokens, gate, wi_gate, wi_up, wo = leaves
        params = {"gate": gate, "wi_gate" if gated else "wi": wi_gate, "wo": wo}
        if gated:
            params["wi_up"] = wi_up
        out, aux = moe_reference_forward(params, tokens, top_k=top_k, capacity=capacity,
                                         activation=activation)
        pairs = [(o, g) for o, g in ((out, d_out), (aux, d_aux)) if g is not None]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                         allow_unused=True) if pairs and wrt else ())
    return (*(next(grads, None) if t is not None and t.requires_grad else None
              for t in leaves), None, None, None)


torch.library.register_autograd("dstpu_torch::moe_fwd", _backward,
                                setup_context=_setup_context)


def make_moe_forward(*, top_k: int, capacity: int, activation: str, with_aux: bool = True
                     ) -> Callable[[Mapping[str, torch.Tensor], torch.Tensor],
                                   Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The kernel-path MoE forward ``(params, tokens [T, H]) -> (out [T, H]
    in the tokens' dtype, aux fp32)`` for one capacity: the fused FFN +
    combine up to ``MOE_FUSED_COMBINE_MAX_TOKENS`` tokens, the split form
    above. ``aux`` costs three launches: a caller that drops it (serving)
    asks for none with ``with_aux=False`` and gets None.

    With gradients on and an input that requires them, the forward runs as
    the operator ``MOE_FWD_OP``: differentiable in the tokens and every
    weight, through ``aux`` too, by the reference VJP (above). Without
    (serving, ``no_grad``) the same kernels run without the operator."""

    def forward(params: Mapping[str, torch.Tensor], tokens: torch.Tensor):
        check_supported(top_k=top_k, activation=activation, dtype=tokens.dtype)
        gated = activation == "silu_gated"
        args = (tokens, params["gate"], params["wi_gate"] if gated else params["wi"],
                params["wi_up"] if gated else None, params["wo"])
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
            out, aux = _moe_fwd_op(*args, top_k, capacity, activation)
            return out, aux if with_aux else None
        return _kernel_forward(*args, top_k, capacity, activation, with_aux)

    return forward
