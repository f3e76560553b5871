"""Flash attention for training: forward with the row log-sum-exp, and the
dQ and dK/dV backward, bound as a ``torch.autograd.Function``.

Counterpart of ``deepspeed_tpu/ops/transformer/pallas_flash.py``. Same
feature matrix: causal (bottom-right aligned through a runtime ``q_offset``,
which may be negative), GQA-native (K/V stay at kv heads), sliding window,
segment ids, ALiBi; fp32 softmax state with the finite ``MASK_VALUE``
sentinel, so a row with no visible key gives O = 0 and LSE = ``MASK_VALUE``;
a cotangent on the LSE folds into the backward's ``di`` term. Any ``Sq`` and
``Sk``: the ragged edge is masked, not padded.

- plain versions: ``flash_fwd_reference`` and ``flash_bwd_reference``, the
  Pallas kernels' tile math in torch (key tiles of ``block_k``, online
  softmax; ``p`` and ``ds`` cast to the input dtype before their products,
  as the Pallas kernels cast them), run for tensors on the CPU;
- kernels: ``csrc/flash_fwd.cu`` (``_fwd_kernel``'s counterpart) and
  ``csrc/flash_bwd.cu`` (``_dq_kernel``, ``_dkv_kernel``), launched for
  tensors on a GPU at every head_dim the Pallas kernels take
  (``head_dim_ok``): bf16 up to 128 on ``wgmma`` (the tiles of the head_dim
  rounded up to 16, zero past it); fp32, and bf16 at 256, 384 and 512, on
  the CUDA cores. The kernels read a head_dim that is no multiple of 8 in
  place where they can (``_kernel_inputs``): bf16 rows of an even head_dim
  (open-llama-3b's 100) as packed heads, fp32 rows of whole 16 bytes;
  anything else (odd head dims, GQA at such a head_dim) goes in padded with
  zero columns to the next multiple of 8 (``_pad8``), and the outputs are
  cut back.
  ``launches`` counts launches per kernel.

The forward and backward are registered as custom operators
(``dstpu_torch::flash_fwd`` / ``flash_bwd``) with the forward's autograd
formula; the forward saves only tensors (q, k, v, o, lse and the mask
inputs), so it is safe under ``torch.utils.checkpoint``, and a dispatch
mode sees the whole forward as one op (``FLASH_FWD_OP``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HALF_MASK = MASK_VALUE * 0.5
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# past 128 the kernels stage whole rows in shared memory: up to 512 columns
MAX_HEAD_DIM = 512
# packed heads: a head's columns sit up to 6 columns into its 128-column tile
MAX_PACKED_HEAD_DIM = 122


def head_dim_ok(D: int) -> bool:
    """``pallas_flash.supports``' head_dim rule: any head_dim up to 128, and
    multiples of 128 past it."""
    return 0 < D <= 128 or D % 128 == 0


def check_head_dim(D: int) -> None:
    """The kernels' head_dim gate (CUDA tensors only; the plain versions
    compute any head_dim): ``ValueError`` for a head_dim the Pallas kernel
    refuses too, ``NotImplementedError`` past ``MAX_HEAD_DIM``."""
    if not head_dim_ok(D):
        raise ValueError(
            f"head_dim {D}: past 128 the flash kernels take multiples of 128 only, as "
            f"the Pallas flash kernel does (pallas_flash.supports refuses {D} too; the "
            f"JAX package runs such a head_dim through XLA attention, which this port "
            f"does not do on CUDA tensors)")
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"head_dim {D}: the flash kernels stage rows of at most {MAX_HEAD_DIM} "
            f"columns (ROADMAP B10)")

launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


class MaskSpec(NamedTuple):
    """The mask of one call: ``window`` <= 0 is global; ``qseg``/``kseg``
    int32 ``[B, Sq]``/``[B, Sk]`` or None; ``slopes`` fp32 ``[H]`` or None."""
    causal: bool
    scale: float
    window: int
    q_offset: int
    qseg: Optional[torch.Tensor]
    kseg: Optional[torch.Tensor]
    slopes: Optional[torch.Tensor]


def mask_spec(q, k, *, causal=True, scale=None, segment_ids=None,
              q_segment_ids=None, alibi_slopes=None, window=None,
              q_offset=None) -> MaskSpec:
    """Check shapes and normalize the mask arguments (``_prepare``)."""
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    if H % kvH:
        raise ValueError(f"query heads {H} not a multiple of kv heads {kvH}")
    if window is not None and not causal:
        raise ValueError("sliding window is causal-only")
    dev = q.device
    qseg = kseg = slopes = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=dev)
        kseg = seg.to(torch.int32).contiguous()
        qs = seg if q_segment_ids is None else torch.as_tensor(q_segment_ids, device=dev)
        qseg = qs.to(torch.int32).contiguous()
    if alibi_slopes is not None:
        # a positional schedule, not a parameter: no gradient by contract
        slopes = torch.as_tensor(alibi_slopes, device=dev).detach().to(
            torch.float32).reshape(H).contiguous()
    return MaskSpec(
        causal=bool(causal),
        scale=float(scale) if scale is not None else 1.0 / (D ** 0.5),
        window=int(window) if window is not None else 0,
        q_offset=int(Sk - Sq if q_offset is None else q_offset),
        qseg=qseg, kseg=kseg, slopes=slopes)


# ---------------------------------------------------------------------------
# plain versions (the Pallas tile math in torch)
# ---------------------------------------------------------------------------


def _fold(x: torch.Tensor, kvH: int) -> torch.Tensor:
    """[B, S, H, D] -> fp32 [B, kvH, G, S, D] (head h = kvh * G + g)."""
    B, S, H, D = x.shape
    return x.float().reshape(B, S, kvH, H // kvH, D).permute(0, 2, 3, 1, 4)


def _unfold(x: torch.Tensor) -> torch.Tensor:
    B, kvH, G, S, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, kvH * G, D)


def _tile_logits(spec: MaskSpec, qf, kt, k0: int) -> torch.Tensor:
    """Masked, scaled fp32 logits of every query against keys
    ``[k0, k0 + bk)`` (``_tile_logits``): qf [B, kvH, G, Sq, D], kt [B, kvH,
    bk, D] -> [B, kvH, G, Sq, bk]."""
    B, kvH, G, Sq, _ = qf.shape
    bk = kt.shape[2]
    dev = qf.device
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * spec.scale
    q_pos = torch.arange(Sq, device=dev) + spec.q_offset
    cols = torch.arange(k0, k0 + bk, device=dev)
    if spec.slopes is not None:
        rel = (cols[None, :] - q_pos[:, None]).float()
        s = s + spec.slopes.reshape(1, kvH, G, 1, 1) * rel
    mask = None
    if spec.qseg is not None:
        mask = (spec.qseg[:, :, None] == spec.kseg[:, None, k0:k0 + bk])[:, None, None]
    if spec.causal:
        cm = q_pos[:, None] >= cols[None, :]
        if spec.window > 0:
            cm = cm & ((q_pos[:, None] - cols[None, :]) < spec.window)
        mask = cm if mask is None else mask & cm
    if mask is not None:
        s = torch.where(mask, s, MASK_VALUE)
    return s


def _spec_of(q, k, spec, kw) -> MaskSpec:
    return spec if spec is not None else mask_spec(q, k, **kw)


def flash_fwd_reference(q, k, v, *, spec: Optional[MaskSpec] = None,
                        block_k: int = 128, **mask_kw):
    """Plain forward: ``(out [B, Sq, H, D], lse [B, H, Sq] fp32)``. Online
    softmax over key tiles of ``block_k`` (``_fwd_kernel``)."""
    spec = _spec_of(q, k, spec, mask_kw)
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    qf = _fold(q, kvH)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.permute(0, 2, 1, 3)
    m = torch.full((B, kvH, G, Sq, 1), MASK_VALUE, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, kvH, G, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        s = _tile_logits(spec, qf, kf[:, :, k0:k0 + block_k], k0)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = m_next.clamp_min(HALF_MASK)
        p = torch.exp(s - m_safe)
        alpha = torch.exp(m.clamp_min(HALF_MASK) - m_safe)
        l = alpha * l + p.sum(-1, keepdim=True)
        m = m_next
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                          vf[:, :, k0:k0 + block_k].float())
        acc = acc * alpha + pv
    empty = l == 0.0
    inv = torch.where(empty, 0.0, 1.0 / torch.where(empty, 1.0, l))
    out = _unfold((acc * inv).to(q.dtype))
    lse = torch.where(empty, MASK_VALUE,
                      m.clamp_min(HALF_MASK) + torch.log(torch.where(empty, 1.0, l)))
    return out, lse.reshape(B, H, Sq)


def flash_bwd_reference(q, k, v, o, lse, do, dlse=None, *,
                        spec: Optional[MaskSpec] = None, block_k: int = 128,
                        **mask_kw):
    """Plain backward: ``(dq, dk, dv)`` from the forward's ``o`` and
    ``lse`` (``_dq_kernel`` and ``_dkv_kernel``; dK and dV summed over each
    kv head's query heads). ``dlse`` is the cotangent on the LSE or None."""
    spec = _spec_of(q, k, spec, mask_kw)
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    qf, dof = _fold(q, kvH), _fold(do, kvH)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    di = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # [B, H, Sq]
    if dlse is not None:
        di = di - dlse.float()
    di = di.reshape(B, kvH, G, Sq, 1)
    lse_b = lse.float().reshape(B, kvH, G, Sq, 1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0 in range(0, Sk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = _tile_logits(spec, qf, kt, k0)
        p = torch.where(lse_b > HALF_MASK, torch.exp(s - lse_b), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vt)
        ds = p * (dp - di) * spec.scale
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds.to(k.dtype).float(), kt)
        dk[:, :, k0:k0 + block_k] = torch.einsum(
            "bhgqk,bhgqd->bhkd", ds.to(q.dtype).float(), qf)
        dv[:, :, k0:k0 + block_k] = torch.einsum(
            "bhgqk,bhgqd->bhkd", p.to(do.dtype).float(), dof)
    return (_unfold(dq).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


class FlashParams(ctypes.Structure):
    """``flash::FlashParams`` of ``csrc/flash_common.cuh``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "o", "dout", "lse", "dlse", "di", "qseg", "kseg", "slopes",
        "out0", "out1")]
        + [(n, ctypes.c_longlong) for n in (
            "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh", "v_sb", "v_ss", "v_sh")]
        + [(n, ctypes.c_int) for n in (
            "B", "Sq", "Sk", "H", "kvH", "D", "causal", "window", "q_offset")]
        + [("scale", ctypes.c_float)])


def bind(fwd_lib: ctypes.CDLL, bwd_lib: ctypes.CDLL):
    """The three C entry points of the built libraries, typed:
    ``(fwd, dq, dkv)``."""
    fns = (fwd_lib.dstt_flash_fwd, bwd_lib.dstt_flash_dq, bwd_lib.dstt_flash_dkv)
    for fn in fns:
        fn.argtypes = [FlashParams, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


@functools.cache
def _kernels():
    from ..op_builder import builder
    return bind(builder.load("flash_fwd"), builder.load("flash_bwd"))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its rows can be read in place with 16-byte copies
    and TMA (unit last stride, positive 16-byte aligned row strides, an
    aligned base), else a contiguous copy."""
    per16 = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s > 0 and s % per16 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def _check(q, k, v):
    if q.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(f"flash kernel dtype {q.dtype}; takes bf16 or fp32")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is {q.dtype} "
                             f"on {q.device}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    check_head_dim(q.shape[3])


def _kernel_inputs(*xs: torch.Tensor):
    """The tensors (all of one head_dim and dtype) as the kernels read them.
    A head_dim that is a multiple of 8, and fp32 rows of whole 16 bytes (D a
    multiple of 4), are read in place (``_rows``). bf16 rows of an even
    head_dim up to ``MAX_PACKED_HEAD_DIM`` that is no multiple of 8 are read
    as packed heads when every tensor has the same heads (one kv head a
    query head): contiguous (head stride D), a token's H x D columns a
    multiple of 8 and a 16-byte aligned base, for the kernels' tensor maps
    over whole token rows (``csrc/flash_common.cuh`` ``packed_heads``). Any
    other (an odd head_dim, GQA) is zero-padded to the next multiple of 8
    (``_pad8``)."""
    D = xs[0].shape[-1]
    if D % 8 == 0 or (xs[0].dtype == torch.float32 and D % 4 == 0):
        return tuple(_rows(x) for x in xs)
    H = xs[0].shape[-2]
    if D % 2 == 0 and D <= MAX_PACKED_HEAD_DIM and xs[0].dtype == torch.bfloat16 and \
            H * D % 8 == 0 and all(x.shape[-2] == H for x in xs):
        packed = (x.contiguous() for x in xs)
        return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in packed)
    return tuple(_rows(x) for x in _pad8(*xs))


def _pad8(*xs: torch.Tensor):
    """The tensors with their last dim zero-padded to the next multiple of 8
    (a contiguous copy), or themselves when it is one already: rows of whole
    16 bytes for the head dims the kernels cannot read in place. Zero
    columns add nothing to S or dP, and the columns of O, dQ, dK and dV past
    the head_dim are cut off by the caller."""
    D = xs[0].shape[-1]
    if D % 8 == 0:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, 8 - D % 8)) for x in xs)


def _params(q, k, v, spec: MaskSpec) -> FlashParams:
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    ptr = lambda t: t.data_ptr() if t is not None else None
    return FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        qseg=ptr(spec.qseg), kseg=ptr(spec.kseg), slopes=ptr(spec.slopes),
        q_sb=q.stride(0), q_ss=q.stride(1), q_sh=q.stride(2),
        k_sb=k.stride(0), k_ss=k.stride(1), k_sh=k.stride(2),
        v_sb=v.stride(0), v_ss=v.stride(1), v_sh=v.stride(2),
        B=B, Sq=Sq, Sk=Sk, H=H, kvH=kvH, D=D, causal=int(spec.causal),
        window=spec.window, q_offset=spec.q_offset, scale=spec.scale)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_cuda(q, k, v, spec: MaskSpec):
    from ..op_builder.builder import launch_check
    _check(q, k, v)
    D0 = q.shape[3]
    q, k, v = _kernel_inputs(q, k, v)
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    p = _params(q, k, v, spec)
    p.out0, p.out1 = out.data_ptr(), lse.data_ptr()
    launch_check(_kernels()[0](p, int(q.dtype == torch.bfloat16), _stream(q)),
                 "flash_fwd")
    launches["flash_fwd"] += 1
    # an operator's outputs are fresh tensors, never views
    return (out if D0 == D else out[..., :D0].contiguous()), lse


def _bwd_cuda(q, k, v, o, lse, do, dlse, spec: MaskSpec):
    """The two backward launches. The dQ kernel computes ``di`` (rowsum(dO *
    O) - dLSE) into an fp32 buffer that the dK/dV kernel reads."""
    from ..op_builder.builder import launch_check
    _check(q, k, v)
    D0 = q.shape[3]
    q, k, v, o, do = _kernel_inputs(q, k, v, o.contiguous(), do.to(q.dtype).contiguous())
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    lse = lse.float().contiguous()
    dlse = dlse.float().contiguous() if dlse is not None else None
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, kvH, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    p = _params(q, k, v, spec)
    p.o, p.dout, p.lse, p.di = o.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr()
    p.dlse = dlse.data_ptr() if dlse is not None else None
    is_bf16 = int(q.dtype == torch.bfloat16)
    _, dq_fn, dkv_fn = _kernels()
    p.out0 = dq.data_ptr()
    launch_check(dq_fn(p, is_bf16, _stream(q)), "flash_dq")
    launches["flash_dq"] += 1
    p.out0, p.out1 = dk.data_ptr(), dv.data_ptr()
    launch_check(dkv_fn(p, is_bf16, _stream(q)), "flash_dkv")
    launches["flash_dkv"] += 1
    if D0 == D:
        return dq, dk, dv
    return tuple(t[..., :D0].contiguous() for t in (dq, dk, dv))


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no flash attention for {t.device}")
    return t.device.type


def flash_fwd(q, k, v, spec: MaskSpec):
    """The forward: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if _on(q) == "cpu":
        return flash_fwd_reference(q, k, v, spec=spec)
    return _fwd_cuda(q, k, v, spec)


def flash_bwd(q, k, v, o, lse, do, dlse, spec: MaskSpec):
    """The backward: the two kernels for CUDA tensors, the plain version for
    CPU tensors."""
    if _on(q) == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, dlse, spec=spec)
    return _bwd_cuda(q, k, v, o, lse, do, dlse, spec)


# The forward and the backward are custom operators, so a dispatch mode (the
# remat policies' ``runtime/activation_checkpointing``) sees each as ONE op:
# the kernels launch through ctypes, which no mode sees, and the plain
# versions' own torch ops stay inside the operator.
@torch.library.custom_op("dstpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qseg: Optional[torch.Tensor], kseg: Optional[torch.Tensor],
                  slopes: Optional[torch.Tensor], causal: bool, scale: float, window: int,
                  q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, MaskSpec(causal, scale, window, q_offset, qseg, kseg, slopes))


@torch.library.custom_op("dstpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor],
                  qseg: Optional[torch.Tensor], kseg: Optional[torch.Tensor],
                  slopes: Optional[torch.Tensor], causal: bool, scale: float, window: int,
                  q_offset: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    spec = MaskSpec(causal, scale, window, q_offset, qseg, kseg, slopes)
    return flash_bwd(q, k, v, o, lse, do, dlse, spec)


#: the forward operator (what a remat policy names to keep or recompute)
FLASH_FWD_OP = torch.ops.dstpu_torch.flash_fwd.default


def _setup_context(ctx, inputs, output):
    q, k, v, qseg, kseg, slopes, *static = inputs
    ctx.save_for_backward(q, k, v, *output, qseg, kseg, slopes)
    ctx.static = tuple(static)
    ctx.set_materialize_grads(False)


def _backward(ctx, do, dlse):
    q, k, v, out, lse, qseg, kseg, slopes = ctx.saved_tensors
    if do is None:
        do = torch.zeros_like(out)
    dq, dk, dv = _flash_bwd_op(q, k, v, out, lse, do, dlse, qseg, kseg, slopes, *ctx.static)
    return dq, dk, dv, None, None, None, None, None, None, None


torch.library.register_autograd("dstpu_torch::flash_fwd", _backward,
                                setup_context=_setup_context)


def flash_attention_with_lse(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        segment_ids: Optional[torch.Tensor] = None,
        q_segment_ids: Optional[torch.Tensor] = None,
        alibi_slopes=None, window=None, q_offset=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning ``(out [B, Sq, H, D], lse [B, H, Sq])``,
    differentiable in q, k and v, including through ``lse``. ``lse`` is
    fp32, ``MASK_VALUE`` on rows with no visible key."""
    s = mask_spec(q, k, causal=causal, scale=scale, segment_ids=segment_ids,
                  q_segment_ids=q_segment_ids, alibi_slopes=alibi_slopes,
                  window=window, q_offset=q_offset)
    return _flash_fwd_op(q, k, v, s.qseg, s.kseg, s.slopes, s.causal, s.scale,
                         s.window, s.q_offset)


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           scale: Optional[float] = None, segment_ids=None,
                           q_segment_ids=None, alibi_slopes=None, window=None,
                           q_offset=None) -> torch.Tensor:
    """Flash attention, ``[B, S, H, D]`` in and out."""
    out, _ = flash_attention_with_lse(
        q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
        q_segment_ids=q_segment_ids, alibi_slopes=alibi_slopes,
        window=window, q_offset=q_offset)
    return out


def merge_partials(o_a, lse_a, o_b, lse_b):
    """Exactly merge two partial attention results over disjoint key sets
    (``o [B, S, H, D]``, ``lse [B, H, S]`` fp32 with the ``MASK_VALUE``
    sentinel): the lse-weighted convex combination, NaN-free when a side
    saw only masked keys."""
    lse_m = torch.maximum(lse_a, lse_b)
    ea = torch.exp(lse_a - lse_m)
    eb = torch.exp(lse_b - lse_m)
    lse_out = lse_m + torch.log(ea + eb)
    wa = (ea / (ea + eb)).to(o_a.dtype)
    wb = (eb / (ea + eb)).to(o_b.dtype)
    expand = lambda w: w.transpose(1, 2)[..., None]
    return o_a * expand(wa) + o_b * expand(wb), lse_out
