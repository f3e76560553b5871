"""Fused Adam / AdamW / LAMB step over one flat bucket of parameters.

Counterpart of ``deepspeed_tpu/ops/adam/pallas_adam.py``. One call updates
a flat bucket (one large leaf, or several small ones, each padded to a
multiple of 128 elements): it reads grad, master and both moments once,
computes the step in fp32 in the Pallas kernel's exact order, and writes
the master, the optional param-dtype cast and the moments at their stored
dtypes. bf16 moment stores are stochastically rounded from the Pallas
kernel's integer hash stream, keyed on ``sr_seed(step, slot, bucket)`` and
the element's index in the bucket, so the bits match the JAX kernel's.

- plain version: ``adam_bucket_reference`` (torch ops, no fused
  multiply-add, true divisions), run for tensors on the CPU;
- kernel: ``csrc/fused_adam.cu`` (``_adam_kernel``'s counterpart),
  launched for tensors on a GPU; ``launches`` counts launches.

With ``inplace=True`` the master and the moments are updated in place (the
counterpart of the Pallas call's ``input_output_aliases``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

_LANES = 128
_BLOCK_ROWS = 512
_SR_SALT = 0x51AB51AB
_M32 = 0xFFFFFFFF
_MODES = {"adam": 0, "adamw": 1, "lamb": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches = 0


# ---------------------------------------------------------------------------
# counter-hash PRNG + stochastic rounding (bit-identical to the JAX kernel)
# ---------------------------------------------------------------------------


def _hash32(x):
    """triple32 (Wellons) avalanche hash of uint32 values: a Python int, or
    an int64 tensor holding values in [0, 2**32). Every multiply is taken
    modulo 2**32, as uint32 arithmetic wraps."""
    x = x ^ (x >> 17)
    x = (x * 0xED5AD4BB) & _M32
    x = x ^ (x >> 11)
    x = (x * 0xAC4C1B51) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x31848BAB) & _M32
    x = x ^ (x >> 14)
    return x


def sr_seed(step: int, slot: int, bucket: int) -> int:
    """The (step, slot, bucket) stream seed; ``slot`` 1 is exp_avg, 2
    exp_avg_sq, 3 sum_sq; ``bucket`` is the launch index within the step."""
    s = (int(step) & _M32) ^ _SR_SALT
    s = _hash32(s ^ ((slot * 0x9E3779B9) & _M32))
    return _hash32(s ^ ((bucket * 0x85EBCA6B) & _M32))


def _sr_to_bf16_bits(x_f32: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Add the noise's low 16 bits to the fp32 bits and truncate to the bf16
    prefix: E[stored] == value."""
    bits = x_f32.contiguous().view(torch.int32).to(torch.int64) & _M32
    hi = ((bits + (noise & 0xFFFF)) & 0xFFFF0000) >> 16
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)
    return hi.to(torch.int16).view(torch.bfloat16).reshape(x_f32.shape)


def _store(x_f32: torch.Tensor, dtype, seed: int, sr: bool) -> torch.Tensor:
    """Narrow to the stored dtype: bf16 with stochastic rounding from the
    (seed, element index) stream when ``sr``, else round to nearest."""
    if sr and dtype == torch.bfloat16:
        idx = torch.arange(x_f32.numel(), device=x_f32.device, dtype=torch.int64)
        return _sr_to_bf16_bits(x_f32, _hash32(idx ^ seed))
    return x_f32.to(dtype)


def bucket_geometry(n: int, block_rows: int = _BLOCK_ROWS) -> Tuple[int, int, int]:
    """(padded_elems, block_rows, grid) the JAX kernel uses for an
    n-element bucket (the port's kernel needs no tail padding)."""
    rows = -(-n // _LANES)
    bm = min(block_rows, rows)
    rows_p = -(-rows // bm) * bm
    return rows_p * _LANES, bm, rows_p // bm


def lane_padded(n: int) -> int:
    """A leaf's segment length inside a fused bucket."""
    return -(-n // _LANES) * _LANES


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _bias_corrections(step: int, beta1: float, beta2: float) -> Tuple[float, float]:
    """``1 - b**t`` in fp32, as the JAX wrapper computes them."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.float32(beta1) ** t), float(one - np.float32(beta2) ** t))


def adam_bucket_reference(grads, master, exp_avg, exp_avg_sq, *, lr: float,
                          bcd1: float, bcd2: float, gscale, beta1: float,
                          beta2: float, eps: float, weight_decay: float,
                          mode: str, seed_m: int, seed_v: int, m_dtype, v_dtype,
                          param_dtype, sr: bool):
    """The kernel's arithmetic in torch fp32, op by op in the Pallas order
    (``_adam_kernel``). Returns ``(master_out fp32, param_cast or None,
    m_store, v_store)``; for ``lamb`` ``master_out`` is the un-trust-scaled
    update."""
    f32 = torch.float32
    full = lambda x, like: torch.full((), x, dtype=f32, device=like.device).expand_as(like)
    g = grads.to(f32)
    g = g * (gscale.expand_as(g) if torch.is_tensor(gscale) else full(gscale, g))
    p = master.to(f32)
    m = exp_avg.to(f32)
    v = exp_avg_sq.to(f32)
    if mode == "adam" and weight_decay:
        g = g + weight_decay * p
    m2 = beta1 * m + (1.0 - beta1) * g
    v2 = beta2 * v + ((1.0 - beta2) * g) * g
    pc = None
    if mode == "lamb":
        out = m2 / (torch.sqrt(v2) + eps) + weight_decay * p
    else:
        mhat = m2 / full(bcd1, m2)    # true divisions, not reciprocal products
        vhat = v2 / full(bcd2, v2)
        u = mhat / (torch.sqrt(vhat) + eps)
        if mode == "adamw" and weight_decay:
            u = u + weight_decay * p
        out = p - lr * u
        if param_dtype is not None:
            pc = out.to(param_dtype)
    return (out, pc, _store(m2, m_dtype, seed_m, sr),
            _store(v2, v_dtype, seed_v, sr))


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------


class AdamParams(ctypes.Structure):
    """``AdamParams`` of ``csrc/fused_adam.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "g", "p", "m", "v", "p_out", "cast_out", "m_out", "v_out", "gscale")]
        + [("n", ctypes.c_longlong)]
        + [(n, ctypes.c_float) for n in (
            "lr", "bcd1", "bcd2", "beta1", "one_minus_beta1", "beta2",
            "one_minus_beta2", "eps", "weight_decay")]
        + [("seed_m", ctypes.c_uint), ("seed_v", ctypes.c_uint)]
        + [(n, ctypes.c_int) for n in (
            "mode", "g_dt", "p_dt", "m_dt", "v_dt", "p_out_dt", "cast_dt", "sr_m", "sr_v")])


def bind(lib: ctypes.CDLL):
    fn = lib.dstt_fused_adam
    fn.argtypes = [AdamParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from ..op_builder import builder
    return bind(builder.load("fused_adam"))


def _adam_cuda(grads, master, exp_avg, exp_avg_sq, outs, *, lr, bcd1, bcd2,
               gscale, beta1, beta2, eps, weight_decay, mode, seed_m, seed_v,
               sr_m, sr_v):
    from ..op_builder.builder import launch_check
    global launches
    p_out, cast_out, m_out, v_out = outs
    dev = grads.device
    if exp_avg.dtype != m_out.dtype or exp_avg_sq.dtype != v_out.dtype:
        raise ValueError("moments must be stored at their state dtype")
    for name, t in (("master", master), ("exp_avg", exp_avg), ("exp_avg_sq", exp_avg_sq),
                    *((n, o) for n, o in zip(("master_out", "param_cast", "m_out", "v_out"),
                                             outs) if o is not None)):
        if t.device != dev or not t.is_contiguous() or t.numel() != grads.numel():
            raise ValueError(f"{name}: {t.numel()} elements on {t.device} "
                             f"(contiguous {t.is_contiguous()}); grads "
                             f"{grads.numel()} on {dev}")
        if t.dtype not in _DTYPE_CODES:
            raise NotImplementedError(f"{name} dtype {t.dtype}")
    if gscale is not None:
        gscale = gscale.to(device=dev, dtype=torch.float32).contiguous()
    code = lambda t: _DTYPE_CODES[t.dtype] if t is not None else 0
    a = AdamParams(
        g=grads.data_ptr(), p=master.data_ptr(), m=exp_avg.data_ptr(),
        v=exp_avg_sq.data_ptr(), p_out=p_out.data_ptr(),
        cast_out=cast_out.data_ptr() if cast_out is not None else None,
        m_out=m_out.data_ptr(), v_out=v_out.data_ptr(),
        gscale=gscale.data_ptr() if gscale is not None else None,
        n=grads.numel(), lr=lr, bcd1=bcd1, bcd2=bcd2, beta1=beta1,
        one_minus_beta1=1.0 - beta1, beta2=beta2, one_minus_beta2=1.0 - beta2,
        eps=eps, weight_decay=weight_decay, seed_m=seed_m, seed_v=seed_v,
        mode=_MODES[mode], g_dt=code(grads), p_dt=code(master), m_dt=code(m_out),
        v_dt=code(v_out), p_out_dt=code(p_out), cast_dt=code(cast_out),
        sr_m=int(sr_m), sr_v=int(sr_v))
    launch_check(_kernel()(a, torch.cuda.current_stream(dev).cuda_stream),
                 "fused_adam")
    launches += 1


def adam_bucket_update(grads: torch.Tensor, master: torch.Tensor,
                       exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor, *,
                       step: int, lr: float, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-8,
                       weight_decay: float = 0.0, mode: str = "adamw",
                       grad_scale=None, seed_m: Optional[int] = None,
                       seed_v: Optional[int] = None, m_dtype=torch.float32,
                       v_dtype=torch.float32, param_dtype=None, sr: bool = True,
                       inplace: bool = False,
                       param_out: Optional[torch.Tensor] = None):
    """One fused step on a flat bucket. Returns ``(master_out, param_cast,
    m_store, v_store)``: ``master_out`` is the new fp32 master for
    'adam'/'adamw' and the un-trust-scaled LAMB update for 'lamb' (apply
    :func:`lamb_trust_epilogue` per leaf); ``param_cast`` is None unless
    ``param_dtype`` is given (never for lamb).

    ``grad_scale``: a float or a 0-d tensor on the bucket's device, folded
    into the fp32 cast of the gradient (unscale x clip). ``inplace``: the
    master (not for lamb) and the moments are updated in place, the master
    at its own dtype; ``param_out`` receives the cast when given."""
    if grads.dim() != 1:
        raise ValueError("bucket updates operate on flat buffers")
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}")
    if exp_avg.dtype != m_dtype or exp_avg_sq.dtype != v_dtype:
        raise ValueError(f"moments stored {exp_avg.dtype}/{exp_avg_sq.dtype}, "
                         f"expected {m_dtype}/{v_dtype}")
    lamb = mode == "lamb"
    bcd1, bcd2 = _bias_corrections(step, beta1, beta2)
    seed_m = 0 if seed_m is None else int(seed_m)
    seed_v = 0 if seed_v is None else int(seed_v)
    sr_m = sr and m_dtype == torch.bfloat16
    sr_v = sr and v_dtype == torch.bfloat16
    want_pc = param_dtype is not None and not lamb
    dev = grads.device
    if dev.type == "cpu":
        out, pc, mo, vo = adam_bucket_reference(
            grads, master, exp_avg, exp_avg_sq, lr=lr, bcd1=bcd1, bcd2=bcd2,
            gscale=1.0 if grad_scale is None else grad_scale, beta1=beta1,
            beta2=beta2, eps=eps, weight_decay=weight_decay, mode=mode,
            seed_m=seed_m, seed_v=seed_v, m_dtype=m_dtype, v_dtype=v_dtype,
            param_dtype=param_dtype if want_pc else None, sr=sr)
        if not inplace:
            return out, pc, mo, vo
        if not lamb:
            master.copy_(out)
            out = master
        exp_avg.copy_(mo)
        exp_avg_sq.copy_(vo)
        if pc is not None and param_out is not None:
            param_out.copy_(pc)
            pc = param_out
        return out, pc, exp_avg, exp_avg_sq
    if dev.type != "cuda":
        raise NotImplementedError(f"no fused Adam for {dev}")
    if not torch.is_tensor(grad_scale) and grad_scale is not None:
        grad_scale = torch.full((), float(grad_scale), dtype=torch.float32, device=dev)
    n = grads.numel()
    if inplace and not lamb:
        p_out = master
    else:
        p_out = torch.empty(n, dtype=torch.float32, device=dev)
    pc = None
    if want_pc:
        pc = param_out if param_out is not None else torch.empty(n, dtype=param_dtype, device=dev)
    m_out = exp_avg if inplace else torch.empty(n, dtype=m_dtype, device=dev)
    v_out = exp_avg_sq if inplace else torch.empty(n, dtype=v_dtype, device=dev)
    _adam_cuda(grads, master, exp_avg, exp_avg_sq, (p_out, pc, m_out, v_out),
               lr=lr, bcd1=bcd1, bcd2=bcd2, gscale=grad_scale, beta1=beta1,
               beta2=beta2, eps=eps, weight_decay=weight_decay, mode=mode,
               seed_m=seed_m, seed_v=seed_v, sr_m=sr_m, sr_v=sr_v)
    return p_out, pc, m_out, v_out


def lamb_trust_epilogue(p_f32: torch.Tensor, update: torch.Tensor, *, lr,
                        min_coeff: float, max_coeff: float) -> torch.Tensor:
    """Per-leaf LAMB trust scaling over one leaf's slice of the bucket
    update (``Optimizer._lamb_leaf``'s trust clause)."""
    w_norm = torch.linalg.vector_norm(p_f32)
    u_norm = torch.linalg.vector_norm(update)
    trust = torch.where((w_norm > 0) & (u_norm > 0),
                        torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                        torch.ones_like(w_norm))
    return p_f32 - lr * trust * update
