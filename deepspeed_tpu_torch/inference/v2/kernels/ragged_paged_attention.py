"""Ragged paged attention: ONE kernel launch for an arbitrary mixed wave.

Counterpart of ``deepspeed_tpu/inference/v2/kernels/ragged_paged_attention.py``.
A wave is any mix of prefill chunks and decode tokens, flattened by the
host builder (``ragged/wave.py``) into a token stream ``q [N, H, D]`` split
into atoms of at most ``block_q`` query tokens, described by

- ``cu_q_lens [A+1]``: atom a owns flat rows ``cu_q_lens[a]:cu_q_lens[a+1]``
  (zero-length atoms are padding);
- ``kv_lens [A]``: the atom's visible context INCLUDING its own tokens;
- ``page_indices [A, MP]``: the block table of the atom's sequence.

Causality is bottom-right aligned per atom: query row t sits at absolute
position ``kv_len - q_len + t``. ``alibi_slopes [H]`` (fp32) adds the ALiBi
bias and ``window`` (0 or None = global) is the layer's causal window, as
in ``ragged_chunk_attention``; both kernel forms take them (the JAX engine
sends such waves to its XLA path).

Two versions of the same function:

- ``ragged_paged_attention_reference``: plain PyTorch, the JAX XLA path
  (scatter the stream into atom tiles, ``ragged_chunk_attention`` with
  history ``kv_len - q_len``, gather back);
- the CUDA kernels of ``csrc/ragged_paged_attention.cu`` (the Pallas
  ``_wave_kernel``'s counterparts), which read the flat stream and the
  pool directly, scale q themselves (``bf16(float(q) * scale)``, the bits
  of ``(q * scale).to(q.dtype)``, as the Pallas call's caller scales it)
  and zero the stream's padding rows: one launch a call.

``ragged_paged_attention`` runs the plain version for tensors on the CPU
and a kernel for tensors on a GPU; there is no other switch. Which kernel
follows from the operands alone (``tensor_core_form``):

- the tensor-core form (``wgmma`` fed by TMA) for bf16 at head_dim 64 or
  128, GQA groups of at most 64 query rows, and page sizes 16, 32 or a
  multiple of 64 (the engine's 16 among them): one block a 64-row query
  tile of consecutive atoms of one sequence (``wave_tiles``), one K/V
  stream a tile;
- the CUDA-core form for everything else (fp32, other page sizes, and
  every other head_dim: open-llama-3b's 100, the tiny presets' 16, odd
  ones): one block an atom and kv head; inside it, an atom's ``q_len x g``
  query rows of one kv head are ordered ``row = t*g + gi``, the Pallas GQA
  fold. Rows are copied from the pool at the widest load their byte length
  allows (16, 8, 4 or 2 bytes).

``launches`` counts kernel launches, ``form_launches`` each form's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from .paged_attention import ragged_chunk_attention

launches = 0
form_launches = {"tensor_cores": 0, "cuda_cores": 0}

TILE_ROWS = 64   # query rows of a tensor-core tile

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _scatter_to_atoms(q: torch.Tensor, cu_q_lens: torch.Tensor, A: int,
                      block_q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [N, H, D] flat wave stream -> ([A, block_q, H, D] atom tiles, dest).

    Token i belongs to atom a = searchsorted(cu, i, right) - 1 at tile row
    i - cu[a]. Rows that fall outside a tile (flat-stream padding beyond
    the last atom) are dropped; their gathered output is garbage, as it is
    in the JAX version, and is discarded by the caller."""
    N = q.shape[0]
    cu = cu_q_lens.long()
    tok = torch.arange(N, device=q.device)
    a_of = (torch.searchsorted(cu, tok, right=True) - 1).clamp(0, A - 1)
    row = tok - cu[a_of]
    dest = torch.where(row < block_q, a_of * block_q + row,
                       torch.full_like(row, A * block_q))
    flat = q.new_zeros((A * block_q + 1,) + tuple(q.shape[1:]))  # +1: drop row
    flat[dest] = q
    return flat[:A * block_q].reshape(A, block_q, *q.shape[1:]), dest


def _gather_from_atoms(out_tiled: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """[A, bq, H, D] atom tiles -> [N, H, D] flat stream (pad rows clip)."""
    A, bq = out_tiled.shape[:2]
    flat = out_tiled.reshape(A * bq, *out_tiled.shape[2:])
    return flat[dest.clamp(0, A * bq - 1)]


def ragged_paged_attention_reference(q, k_pages, v_pages, kv_lens, page_indices,
                                     cu_q_lens, scale: Optional[float] = None,
                                     block_q: int = 8, alibi_slopes=None,
                                     window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: same contract as ``ragged_paged_attention``."""
    A = page_indices.shape[0]
    q_lens = cu_q_lens[1:] - cu_q_lens[:-1]
    q_tiled, dest = _scatter_to_atoms(q, cu_q_lens, A, block_q)
    out = ragged_chunk_attention(q_tiled, k_pages, v_pages,
                                 kv_lens.long() - q_lens.long(), page_indices,
                                 scale=scale, alibi_slopes=alibi_slopes, window=window)
    return _gather_from_atoms(out, dest)


def ragged_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, kv_lens: torch.Tensor,
                           page_indices: torch.Tensor, cu_q_lens: torch.Tensor,
                           scale: Optional[float] = None,
                           block_q: int = 8,
                           alibi_slopes: Optional[torch.Tensor] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """One ragged wave of attention: q [N, H, D] against the blocked pool
    ``k_pages`` / ``v_pages`` [kvH, P, ps, D]; returns [N, H, D].

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise: there is no fallback)."""
    N, H, D = q.shape
    kvH = k_pages.shape[0]
    if H % kvH:
        raise ValueError(f"query heads {H} not a multiple of kv heads {kvH}")
    if k_pages.dtype != q.dtype:
        raise NotImplementedError(
            f"a KV pool of {k_pages.dtype} under {q.dtype} queries (fp8 KV) "
            f"is not ported (ROADMAP A5)")
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(q, k_pages, v_pages, kv_lens,
                                                page_indices, cu_q_lens,
                                                scale, block_q, alibi_slopes, window)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no ragged paged attention for {q.device}")
    return _ragged_paged_attention_cuda(q, k_pages, v_pages, kv_lens,
                                        page_indices, cu_q_lens, scale,
                                        block_q, alibi_slopes, window)


def tensor_core_form(dtype: torch.dtype, g: int, D: int, ps: int) -> bool:
    """Whether a wave takes the tensor-core kernel: bf16, head_dim 64 or
    128, at most ``TILE_ROWS`` query heads a kv head, and pages of 16 or 32
    tokens or a multiple of 64 (whole pages or whole steps of 64 keys in
    the kernel's K/V tiles)."""
    return (dtype == torch.bfloat16 and D in (64, 128) and g <= TILE_ROWS
            and ps % 16 == 0 and (64 % ps == 0 or ps % 64 == 0))


def wave_tiles(cu_q_lens, kv_lens, page_indices, g: int,
               ps: int) -> List[Tuple[int, int, int, int]]:
    """The query tiles of the tensor-core kernel, in stream order, as
    ``(first row, tokens, position of the first row, atom whose table the
    tile reads)``: the kernel's rule (``csrc/ragged_paged_attention.cu``:
    the tile list of ``wave_wgmma``, ``begin_tiles``, ``tile_at``) in plain
    Python.

    Atom a continues atom a - 1 when both hold rows, ``kv_lens[a] - q_len[a]
    == kv_lens[a - 1]`` and their tables agree on atom a - 1's pages; such a
    run of atoms is one causal stretch of one sequence. A tile begins at a
    run's first row and at every row whose position is a multiple of
    ``TILE_ROWS // g``, and ends where the next one begins (the last at
    ``cu_q_lens[A]``); it reads the table of the atom of its last row."""
    cu = [int(x) for x in cu_q_lens]
    kv = [int(x) for x in kv_lens]
    A, MP = len(kv), page_indices.shape[1]
    tt = TILE_ROWS // g
    starts = []   # (first row, atom)
    for a in range(A):
        ql = cu[a + 1] - cu[a]
        if ql <= 0:
            continue
        p0 = kv[a] - ql
        cont = False
        if a > 0 and cu[a] - cu[a - 1] > 0 and p0 == kv[a - 1]:
            npg = min(MP, -(-max(kv[a - 1], 0) // ps))
            cont = bool((page_indices[a - 1][:npg] == page_indices[a][:npg]).all())
        if not cont and p0 % tt:
            starts.append((cu[a], a))
        starts += [(cu[a] + pos - p0, a) for pos in range(p0 + (-p0) % tt, p0 + ql, tt)]
    tiles = []
    for k, (row0, a0) in enumerate(starts):
        row1 = starts[k + 1][0] if k + 1 < len(starts) else cu[A]
        a1 = a0
        while a1 + 1 < A and cu[a1 + 1] <= row1 - 1:
            a1 += 1
        tiles.append((row0, row1 - row0, kv[a0] - (cu[a0 + 1] - cu[a0]) + row0 - cu[a0], a1))
    return tiles


def bind(lib: ctypes.CDLL):
    """The kernels' C entry points in a built library, typed: the
    CUDA-core form and the tensor-core form."""
    cuda_cores = lib.dstt_ragged_paged_attention
    cuda_cores.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    cuda_cores.restype = ctypes.c_int
    tensor_cores = lib.dstt_ragged_paged_attention_tc
    tensor_cores.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                             + [ctypes.c_float, ctypes.c_void_p])
    tensor_cores.restype = ctypes.c_int
    return cuda_cores, tensor_cores


@functools.cache
def _kernel():
    from ....ops.op_builder import builder
    return bind(builder.load("ragged_paged_attention"))


def check_kernel_args(q, k_pages, v_pages, descriptors) -> None:
    """What both CUDA kernels accept: one CUDA device, bf16 or fp32, the
    pool's dtype equal to q's, contiguous 16-byte aligned operands, int32
    descriptors, q's head_dim equal to the pool's (any head_dim)."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), *descriptors):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(f"kernel dtype {q.dtype}; takes bf16 or fp32")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("k_pages / v_pages dtype must equal q's")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in descriptors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    if q.shape[-1] != k_pages.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} and the pool {tuple(k_pages.shape)} "
                         f"differ in their last dim")


def kernel_slopes(alibi_slopes, q: torch.Tensor) -> Optional[int]:
    """The ALiBi slopes' address for a kernel (None without), after checking
    that they are contiguous fp32 ``[H]`` on q's device."""
    if alibi_slopes is None:
        return None
    H = q.shape[-2]
    if not torch.is_tensor(alibi_slopes) or alibi_slopes.dtype != torch.float32 or \
            tuple(alibi_slopes.shape) != (H,) or alibi_slopes.device != q.device or \
            not alibi_slopes.is_contiguous():
        raise ValueError(f"alibi_slopes must be contiguous fp32 [{H}] on {q.device}, got "
                         f"{getattr(alibi_slopes, 'dtype', type(alibi_slopes))} "
                         f"{tuple(getattr(alibi_slopes, 'shape', ()))}")
    return alibi_slopes.data_ptr()


def _ragged_paged_attention_cuda(q, k_pages, v_pages, kv_lens, page_indices,
                                 cu_q_lens, scale: float, block_q: int,
                                 alibi_slopes=None, window: Optional[int] = None):
    global launches
    N, H, D = q.shape
    kvH, P, ps, _ = k_pages.shape
    A, MP = page_indices.shape
    check_kernel_args(q, k_pages, v_pages, (
        ("kv_lens", kv_lens), ("page_indices", page_indices),
        ("cu_q_lens", cu_q_lens)))
    if kv_lens.shape != (A,) or cu_q_lens.shape != (A + 1,):
        raise ValueError(f"descriptors kv_lens {tuple(kv_lens.shape)} / "
                         f"cu_q_lens {tuple(cu_q_lens.shape)} for {A} atoms")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
            cu_q_lens.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
            kernel_slopes(alibi_slopes, q))
    window = max(int(window or 0), 0)
    cuda_cores, tensor_cores = _kernel()
    if tensor_core_form(q.dtype, H // kvH, D, ps):
        if kvH * P * ps >= 2 ** 31:
            raise NotImplementedError(f"a KV pool of {kvH * P * ps} rows (ROADMAP A5)")
        rc = tensor_cores(*ptrs, N, A, H, kvH, P, ps, D, MP, window, scale, stream)
        form = "tensor_cores"
    else:
        rc = cuda_cores(*ptrs, N, A, H, kvH, P, ps, D, MP, block_q, window, scale,
                        int(q.dtype == torch.bfloat16), stream)
        form = "cuda_cores"
    from ....ops.op_builder.builder import launch_check
    launch_check(rc, "ragged_paged_attention")
    launches += 1
    form_launches[form] += 1
    return out
