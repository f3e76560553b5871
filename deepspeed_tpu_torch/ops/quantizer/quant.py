"""Symmetric int8 row quantizer: the ZeRO++ int8 wire.

Counterpart of ``deepspeed_tpu/ops/quantizer/pallas_quant.py``.
``quantize_rows_int8(groups [G, gs]) -> (q int8 [G, gs], scale fp32 [G])``:
per row ``scale = absmax * fp32(1/127)`` (1 where that is 0) and ``q =
clip(round_half_even(x / scale), -128, 127)``.

- plain version: ``quantize_rows_int8_reference`` (torch ops), run for
  tensors on the CPU;
- kernel: ``csrc/quant_rows.cu`` (``_quant_rows_kernel``'s counterpart),
  launched for tensors on a GPU, any group size; ``launches`` counts
  launches. ``plan_rows`` is its launch plan: which of the kernel's three
  forms takes a row length (a warp's lanes, a block, or a warp a long row),
  how a row spreads over lanes, and a grid sized to the card.

The two roundings are those of the jitted JAX wire: XLA compiles the
divide by the constant 127 into a multiply by its fp32 reciprocal and keeps
``x / scale`` a true divide. The plain version multiplies by a tensor
holding that reciprocal and divides by the scale tensor (torch on CUDA
would turn a divide by a Python number into a multiply), so the kernel,
the plain version and ``jax.jit(quantize_blockwise)`` agree bit for bit.

A bf16 row is widened in the kernel's registers: the wrapper hands the
kernel the tensor as it is, and no fp32 copy of it is made.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

#: fp32(1/127): the constant XLA multiplies by in place of ``absmax / 127``
INV_QMAX_INT8 = float(np.float32(1.0) / np.float32(127.0))
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: ``csrc/quant_rows.cu``: threads a block; values or 16-byte units a lane
#: (lanes form) or a thread (block form) holds; blocks an SM (8 blocks of 256
#: threads fill one)
THREADS, UNITS, BLOCKS_PER_SM = 256, 8, 8
FORMS = ("lanes", "block", "warp")

launches = 0


def _pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=None)   # the wire has a handful of (G, gs) pairs
def plan_rows(G: int, gs: int, itemsize: int, vec: bool, sms: int) -> Tuple[str, int, int, int]:
    """``(form, lanes, units, blocks)`` of the row kernel for ``G`` rows of
    ``gs`` values of ``itemsize`` bytes, read in 16-byte units when ``vec``
    (else value by value), on a card of ``sms`` SMs.

    A row of ``n <= 32 * UNITS`` units takes the ``lanes`` form: ``lanes``
    (a power of two up to 32) share it, ``units`` a lane, and a warp takes
    ``32 // lanes`` rows at a time. Up to ``THREADS * UNITS`` units a row
    takes the ``block`` form (all ``THREADS`` threads of a block, ``units``
    a thread); longer rows the ``warp`` form (a warp a row). ``blocks``
    covers every row once or fills the card (``BLOCKS_PER_SM`` an SM),
    whichever is fewer: the warps walk the rows. The launcher
    (``csrc/quant_common.cuh``) takes no more blocks than the kernel's
    occupancy lets the card hold at once."""
    n = gs * itemsize // 16 if vec else gs
    warps = THREADS // 32
    if n <= 32 * UNITS:
        lanes = min(32, _pow2(n))
        form, units, want = "lanes", _pow2(-(-n // lanes)), -(-G // (32 // lanes * warps))
    elif n <= THREADS * UNITS:
        form, lanes, units, want = "block", THREADS, _pow2(-(-n // THREADS)), G
    else:
        form, lanes, units, want = "warp", 32, 0, -(-G // warps)
    return form, lanes, units, max(1, min(want, BLOCKS_PER_SM * sms))


def quantize_rows_int8_reference(groups: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch fp32."""
    x = groups.float()
    inv = torch.full((), INV_QMAX_INT8, dtype=torch.float32, device=x.device)
    scale = x.abs().amax(dim=1, keepdim=True) * inv
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale[:, 0]


def bind(lib: ctypes.CDLL):
    fn = lib.dstt_quant_rows
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from ..op_builder import builder
    return bind(builder.load("quant_rows"))


def _quant_cuda(groups: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    from ..op_builder.builder import launch_check, sm_count
    if groups.dtype not in KERNEL_DTYPES or not groups.is_contiguous():
        raise ValueError(f"quantize_rows_int8: {groups.dtype} (contiguous "
                         f"{groups.is_contiguous()}); the kernel takes contiguous fp32 or bf16")
    G, gs = groups.shape
    dev = groups.device
    isz = groups.element_size()
    vec = (gs * isz) % 16 == 0 and groups.data_ptr() % 16 == 0
    form, lanes, units, blocks = plan_rows(G, gs, isz, vec, sm_count(dev.index or 0))
    q = torch.empty(G, gs, dtype=torch.int8, device=dev)
    scale = torch.empty(G, dtype=torch.float32, device=dev)
    rc = _kernel()(groups.data_ptr(), q.data_ptr(), scale.data_ptr(), G, gs,
                   int(groups.dtype == torch.bfloat16), FORMS.index(form), int(vec),
                   lanes.bit_length() - 1, units, blocks,
                   torch.cuda.current_stream(dev).cuda_stream)
    launch_check(rc, "quantize_rows_int8")
    launches += 1
    return q, scale


def quantize_rows_int8(groups: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of each row of ``groups [G, gs]`` (fp32
    or bf16): ``(q int8 [G, gs], scale fp32 [G])``."""
    if groups.dim() != 2:
        raise ValueError(f"quantize_rows_int8 takes [G, group_size], got {tuple(groups.shape)}")
    if groups.device.type == "cpu":
        return quantize_rows_int8_reference(groups)
    if groups.device.type != "cuda":
        raise NotImplementedError(f"no quantizer kernel for {groups.device}")
    return _quant_cuda(groups)
