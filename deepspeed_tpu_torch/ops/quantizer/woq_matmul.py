"""Weight-only-quantized matmul for decode-shaped activations.

Counterpart of ``deepspeed_tpu/ops/quantizer/pallas_woq_matmul.py``:

    x [M, K] @ groupwise int8 weights -> out [M, N] = sum_g (x_g @ q_g) * scale_g

with ``q [G, gs, N]`` int8, ``scale [G, 1, N]`` fp32 (the
``quantize_kernel`` layout, N contiguous) and ``K = G * gs``. The int8
weights are read at one byte each and converted in registers; each group's
partial product is accumulated in fp32, scaled, and the groups are summed in
fp32 with one cast at the end.

- plain version: ``woq_matmul_reference`` (torch ops), run for tensors on
  the CPU;
- kernel: ``csrc/woq_matmul.cu`` (``_woq_kernel``'s counterpart), launched
  for tensors on a GPU; ``launches`` counts calls that launched it.

Unlike the Pallas kernel, M needs no padding and N need not be a multiple
of 128 (a multiple of 4, for the kernel's 32-bit loads). The source holds
two kernels: bf16 activations of up to 64 rows, with the group size and N
multiples of 16, run on the tensor cores (``tensor_core_shape``), fed by
TMA; fp32 activations and every other shape run on the CUDA cores. Both
split K across blocks to fill the card (``plan_tc_splits``,
``plan_splits``) and add the splits in a fixed order: the tensor-core
kernel in the same launch (the last block of a column tile, found by a
counter a column tile that the wrapper keeps zeroed, ``_tile_counters``),
the CUDA-core kernel in a second one. Two runs give the same bits. What a
captured CUDA graph may rely on: the counters it captured stay where they
are for the life of the process and are zero at the start of every replay;
a capture never allocates them, so the step runs once on the capture
stream first. The split partials are allocated with each call (inside a
capture: in the graph's pool).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..scratch import Scratch

_COLS = 128        # output columns a block (csrc/woq_matmul.cu: kCols)
_ROW_TILE = 8      # rows of x a block of the CUDA-core kernel (the largest MT)
_MMA_MAX_ROWS = 64  # rows of x a block of the tensor-core kernel
_MMA_COLS = 256    # output columns a block of the tensor-core kernel (kTcCols)
_BLOCKS_PER_SM = 2  # blocks of the CUDA-core kernel an SM holds at once (its launch bounds)
#: a block's start (barriers, the first copies' round trip) in units of the
#: time it takes to stream one group of its weights, for the tensor-core plan
_TC_START_GROUPS = 1.0
_TC_MAX_GROUPS = 64  # groups a split of the tensor-core kernel: its scales in shared memory

launches = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def woq_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch: per-group fp32 products of ``x`` and
    the int8 weights, each scaled by its group's scale, summed over the
    groups in fp32, cast to ``x``'s dtype."""
    M, K = x.shape
    G, gs, N = q.shape
    xg = x.to(torch.float32).reshape(M, G, gs).transpose(0, 1)       # [G, M, gs]
    part = torch.bmm(xg, q.to(torch.float32))                         # [G, M, N]
    return (part * scale.reshape(G, 1, N)).sum(dim=0).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------


def tensor_core_shape(x: torch.Tensor, q: torch.Tensor) -> bool:
    """Whether the tensor-core kernel takes this call: bf16 activations of at
    most 64 rows, 16-row ``mma`` steps inside a group, 16-byte copies of the
    rows of q."""
    _, gs, N = q.shape
    return (x.dtype == torch.bfloat16 and x.shape[0] <= _MMA_MAX_ROWS
            and gs % 16 == 0 and N % 16 == 0)


@functools.lru_cache(maxsize=None)   # a model has a handful of (shape, rows) pairs
def plan_splits(M: int, N: int, G: int, sms: int) -> Tuple[int, int]:
    """``(groups_per_split, splits)``: how the CUDA-core kernel cuts K
    across blocks. A block covers ``_COLS`` columns, ``_ROW_TILE`` rows and
    ``groups_per_split`` groups, and ``2 * sms`` blocks run at once; the plan
    minimizes the groups a block walks times the waves of blocks, a split
    costing about half a group's time for its partial sums (added by a
    second launch). Ties go to fewer splits."""
    tiles = -(-N // _COLS) * -(-M // _ROW_TILE)
    slots = _BLOCKS_PER_SM * sms
    best = None
    for want in range(1, G + 1):
        per = -(-G // want)
        splits = -(-G // per)
        waves = -(-tiles * splits // slots)
        cost = waves * (per + (0.5 if splits > 1 else 0.0))
        if best is None or cost < best[0]:
            best = (cost, per, splits)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def plan_tc_splits(N: int, G: int, sms: int) -> Tuple[int, int]:
    """``(groups_per_split, splits)`` of the tensor-core kernel. A block
    covers ``_MMA_COLS`` columns and all rows of x, one block runs on an SM
    at a time (its shared memory), and the weight stream of a block costs
    its groups plus ``_TC_START_GROUPS``: the plan minimizes the waves of
    blocks times that. The splits are added in the same launch, so a split
    costs no pass of its own. A split holds at most ``_TC_MAX_GROUPS``
    groups (their scales sit in shared memory). Ties go to fewer splits."""
    tiles = -(-N // _MMA_COLS)
    best = None
    for want in range(-(-G // _TC_MAX_GROUPS), G + 1):
        per = -(-G // want)
        splits = -(-G // per)
        cost = -(-tiles * splits // sms) * (per + _TC_START_GROUPS)
        if best is None or cost < best[0]:
            best = (cost, per, splits)
    return best[1], best[2]


def launch_plan(x: torch.Tensor, q: torch.Tensor, sms: int) -> Tuple[bool, int, int]:
    """``(tensor cores, groups_per_split, splits)`` of one call."""
    G, _, N = q.shape
    if tensor_core_shape(x, q):
        return (True, *plan_tc_splits(N, G, sms))
    return (False, *plan_splits(x.shape[0], N, G, sms))


class WoqParams(ctypes.Structure):
    """``WoqParams`` of ``csrc/woq_matmul.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "q", "scale", "out", "partial",
                                                 "counters")]
                + [(n, ctypes.c_int) for n in (
                    "M", "K", "N", "G", "gs", "groups_per_split", "splits", "bf16", "mma")])


def bind(lib: ctypes.CDLL):
    fn = lib.dstt_woq_matmul
    fn.argtypes = [WoqParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from ..op_builder import builder
    return bind(builder.load("woq_matmul"))


# the tensor-core kernel's counters a column tile, per (device, stream): each
# launch leaves them zero (the last block of a tile resets its counter), so
# they are zeroed once, and a captured graph's replays find them zero too;
# launches on one stream run in order. A buffer a graph captured is never
# freed or moved (``ops/scratch.py``).
_bufs = Scratch()


def _tile_counters(dev: torch.device, stream: int, n: int,
                   capturing: bool = False) -> torch.Tensor:
    return _bufs.get((dev.index or 0, stream), n, lambda m: torch.zeros(
        max(m, 256), dtype=torch.int32, device=dev), capturing)


def _woq_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    from ..op_builder.builder import launch_check, sm_count
    global launches
    M, K = x.shape
    G, gs, N = q.shape
    dev = x.device
    if N % 4:
        raise NotImplementedError(f"the WOQ kernel reads 4 columns a load: N={N} "
                                  f"is not a multiple of 4")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} on {t.device} (contiguous {t.is_contiguous()}); "
                             f"x on {dev}")
    mma, per, splits = launch_plan(x, q, sm_count(dev.index or 0))
    if mma and any(t.data_ptr() % 16 for t in (x, q, scale)):
        raise ValueError("the tensor-core WOQ kernel reads x, q and scale through TMA: each "
                         "must start on a 16-byte boundary")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    partial = (torch.empty(splits, M, N, dtype=torch.float32, device=dev)
               if splits > 1 else None)
    counters = (_tile_counters(dev, stream, -(-N // _MMA_COLS),
                               torch.cuda.is_current_stream_capturing())
                if mma and splits > 1 else None)
    a = WoqParams(x=x.data_ptr(), q=q.data_ptr(), scale=scale.data_ptr(),
                  out=out.data_ptr(),
                  partial=partial.data_ptr() if partial is not None else None,
                  counters=counters.data_ptr() if counters is not None else None,
                  M=M, K=K, N=N, G=G, gs=gs, groups_per_split=per, splits=splits,
                  bf16=int(x.dtype == torch.bfloat16), mma=int(mma))
    launch_check(_kernel()(a, stream), "woq_matmul")
    launches += 1
    return out


def woq_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [M, K]`` (bf16 or fp32) times groupwise-quantized weights ``q [G,
    gs, N]`` int8 with ``scale [G, 1, N]`` fp32 -> ``[M, N]`` in ``x``'s
    dtype. CPU tensors run the plain version, CUDA tensors the kernel."""
    if x.dim() != 2 or q.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} must be [M, K] and q {tuple(q.shape)} [G, gs, N]")
    G, gs, N = q.shape
    if x.shape[1] != G * gs or scale.numel() != G * N:
        raise ValueError(f"x {tuple(x.shape)}, q {tuple(q.shape)}, scale "
                         f"{tuple(scale.shape)}: K must equal G * gs and scale hold G * N")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise NotImplementedError(f"q {q.dtype} / scale {scale.dtype}: the WOQ matmul "
                                  f"takes int8 weights and fp32 scales (packed int4 "
                                  f"is unpacked outside it)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"x dtype {x.dtype}")
    if x.device.type == "cpu":
        return woq_matmul_reference(x, q, scale)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no WOQ matmul for {x.device}")
    return _woq_cuda(x, q, scale)
