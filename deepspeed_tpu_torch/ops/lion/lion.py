"""Fused Lion step over one flat bucket of parameters.

Counterpart of ``deepspeed_tpu/ops/lion/pallas_lion.py``, the one-moment
sibling of ``ops/adam/adam.py``: the same flat buckets (one large leaf, or
several small ones each padded to a multiple of 128 elements), the same
stochastic rounding of bf16 moments (``sr_seed(step, 1, bucket)``, the Adam
first moment's stream). One call reads grad, master and moment once,
computes ``sign(b1 * m + (1 - b1) * g) + wd * p`` and the ``b2`` moment in
fp32 in the Pallas kernel's order, and writes the master, the optional
param-dtype cast and the moment at its stored dtype.

- plain version: ``lion_bucket_reference`` (torch ops, no fused
  multiply-add), run for tensors on the CPU;
- kernel: ``csrc/fused_lion.cu`` (``_lion_kernel``'s counterpart), launched
  for tensors on a GPU; ``launches`` counts launches.

With ``inplace=True`` the master and the moment are updated in place (the
counterpart of the Pallas call's ``input_output_aliases``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..adam.adam import _DTYPE_CODES, _store

launches = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def lion_bucket_reference(grads, master, exp_avg, *, lr: float, gscale,
                          beta1: float, beta2: float, weight_decay: float,
                          seed_m: int, m_dtype, param_dtype, sr: bool):
    """The kernel's arithmetic in torch fp32, op by op in the Pallas order
    (``_lion_kernel``). Returns ``(master_out fp32, param_cast or None,
    m_store)``."""
    f32 = torch.float32
    g = grads.to(f32)
    g = g * (gscale.expand_as(g) if torch.is_tensor(gscale)
             else torch.full((), gscale, dtype=f32, device=g.device).expand_as(g))
    p = master.to(f32)
    m = exp_avg.to(f32)
    c = beta1 * m + (1.0 - beta1) * g
    # jnp.sign: 0 at 0 and NaN at NaN (torch.sign gives 0 for NaN)
    u = torch.where(c > 0, torch.ones_like(c), torch.where(c < 0, -torch.ones_like(c), c))
    if weight_decay:
        u = u + weight_decay * p
    out = p - lr * u
    m2 = beta2 * m + (1.0 - beta2) * g
    pc = out.to(param_dtype) if param_dtype is not None else None
    return out, pc, _store(m2, m_dtype, seed_m, sr)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------


class LionParams(ctypes.Structure):
    """``LionParams`` of ``csrc/fused_lion.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "g", "p", "m", "p_out", "cast_out", "m_out", "gscale")]
        + [("n", ctypes.c_longlong)]
        + [(n, ctypes.c_float) for n in (
            "lr", "beta1", "one_minus_beta1", "beta2", "one_minus_beta2",
            "weight_decay")]
        + [("seed_m", ctypes.c_uint)]
        + [(n, ctypes.c_int) for n in (
            "g_dt", "p_dt", "m_dt", "p_out_dt", "cast_dt", "sr_m")])


def bind(lib: ctypes.CDLL):
    fn = lib.dstt_fused_lion
    fn.argtypes = [LionParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from ..op_builder import builder
    return bind(builder.load("fused_lion"))


def _lion_cuda(grads, master, exp_avg, outs, *, lr, gscale, beta1, beta2,
               weight_decay, seed_m, sr_m):
    from ..op_builder.builder import launch_check
    global launches
    p_out, cast_out, m_out = outs
    dev = grads.device
    if exp_avg.dtype != m_out.dtype:
        raise ValueError("the moment must be stored at its state dtype")
    for name, t in (("grads", grads), ("master", master), ("exp_avg", exp_avg),
                    *((n, o) for n, o in zip(("master_out", "param_cast", "m_out"), outs)
                      if o is not None)):
        if t.device != dev or not t.is_contiguous() or t.numel() != grads.numel():
            raise ValueError(f"{name}: {t.numel()} elements on {t.device} "
                             f"(contiguous {t.is_contiguous()}); grads "
                             f"{grads.numel()} on {dev}")
        if t.dtype not in _DTYPE_CODES:
            raise NotImplementedError(f"{name} dtype {t.dtype}")
    if gscale is not None:
        gscale = gscale.to(device=dev, dtype=torch.float32).contiguous()
    code = lambda t: _DTYPE_CODES[t.dtype] if t is not None else 0
    a = LionParams(
        g=grads.data_ptr(), p=master.data_ptr(), m=exp_avg.data_ptr(),
        p_out=p_out.data_ptr(),
        cast_out=cast_out.data_ptr() if cast_out is not None else None,
        m_out=m_out.data_ptr(),
        gscale=gscale.data_ptr() if gscale is not None else None,
        n=grads.numel(), lr=lr, beta1=beta1, one_minus_beta1=1.0 - beta1,
        beta2=beta2, one_minus_beta2=1.0 - beta2, weight_decay=weight_decay,
        seed_m=seed_m, g_dt=code(grads), p_dt=code(master), m_dt=code(m_out),
        p_out_dt=code(p_out), cast_dt=code(cast_out), sr_m=int(sr_m))
    launch_check(_kernel()(a, torch.cuda.current_stream(dev).cuda_stream),
                 "fused_lion")
    launches += 1


def lion_bucket_update(grads: torch.Tensor, master: torch.Tensor,
                       exp_avg: torch.Tensor, *, lr: float, beta1: float = 0.9,
                       beta2: float = 0.99, weight_decay: float = 0.0,
                       grad_scale=None, seed_m: Optional[int] = None,
                       m_dtype=torch.float32, param_dtype=None, sr: bool = True,
                       inplace: bool = False,
                       param_out: Optional[torch.Tensor] = None):
    """One fused Lion step on a flat bucket. Returns ``(master_out,
    param_cast, m_store)``; ``param_cast`` is None unless ``param_dtype`` is
    given.

    ``grad_scale``: a float or a 0-d tensor on the bucket's device, folded
    into the fp32 cast of the gradient (unscale x clip). ``inplace``: the
    master (at its own dtype) and the moment are updated in place;
    ``param_out`` receives the cast when given."""
    if grads.dim() != 1:
        raise ValueError("bucket updates operate on flat buffers")
    if exp_avg.dtype != m_dtype:
        raise ValueError(f"moment stored {exp_avg.dtype}, expected {m_dtype}")
    seed_m = 0 if seed_m is None else int(seed_m)
    dev = grads.device
    if dev.type == "cpu":
        out, pc, mo = lion_bucket_reference(
            grads, master, exp_avg, lr=lr,
            gscale=1.0 if grad_scale is None else grad_scale, beta1=beta1,
            beta2=beta2, weight_decay=weight_decay, seed_m=seed_m,
            m_dtype=m_dtype, param_dtype=param_dtype, sr=sr)
        if not inplace:
            return out, pc, mo
        master.copy_(out)
        exp_avg.copy_(mo)
        if pc is not None and param_out is not None:
            param_out.copy_(pc)
            pc = param_out
        return master, pc, exp_avg
    if dev.type != "cuda":
        raise NotImplementedError(f"no fused Lion for {dev}")
    if not torch.is_tensor(grad_scale) and grad_scale is not None:
        grad_scale = torch.full((), float(grad_scale), dtype=torch.float32, device=dev)
    n = grads.numel()
    p_out = master if inplace else torch.empty(n, dtype=torch.float32, device=dev)
    pc = None
    if param_dtype is not None:
        pc = param_out if param_out is not None else torch.empty(n, dtype=param_dtype, device=dev)
    m_out = exp_avg if inplace else torch.empty(n, dtype=m_dtype, device=dev)
    _lion_cuda(grads, master, exp_avg, (p_out, pc, m_out), lr=lr, gscale=grad_scale,
               beta1=beta1, beta2=beta2, weight_decay=weight_decay, seed_m=seed_m,
               sr_m=sr and m_dtype == torch.bfloat16)
    return p_out, pc, m_out
