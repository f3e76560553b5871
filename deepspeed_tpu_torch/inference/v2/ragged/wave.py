"""Host-side ragged wave builder (counterpart of
``deepspeed_tpu/inference/v2/ragged/wave.py``, single pool).

A scheduled wave, any mix of prefill chunks and decode tokens, is
flattened into ONE token stream plus the per-atom descriptors the ragged
paged attention kernel reads (``cu_q_lens`` / ``kv_lens`` /
``page_indices``; see ``kernels/ragged_paged_attention.py``). Everything
here is numpy on the host, and bit-identical to the JAX builder: the
power-of-two padding of ``(N, A, MP, R)`` is kept, padded token rows write
to the null block 0 and belong to zero-length atoms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .ragged_wrapper import _next_bucket


@dataclasses.dataclass
class WaveEntry:
    """One scheduled sequence-chunk: ``tokens`` are the new tokens (1 for a
    decode), ``seen`` the tokens already in cache, ``blocks`` the
    sequence's block table."""
    uid: int
    tokens: np.ndarray
    seen: int
    blocks: List[int]


@dataclasses.dataclass
class WaveDescriptors:
    """Host arrays for one wave dispatch."""
    tokens: np.ndarray        # [N] i32 flat stream (atom-major)
    positions: np.ndarray     # [N] i32 absolute positions
    write_idx: np.ndarray     # [N] i32 flat slot in the pool
    cu_q_lens: np.ndarray     # [A+1] i32
    kv_lens: np.ndarray       # [A] i32
    page_indices: np.ndarray  # [A, MP] i32
    last_rows: np.ndarray     # [R] i32 flat row of each entry's last token
    row_of_uid: Dict[int, int]  # uid -> row in the logits output
    n_tokens: int             # valid (un-padded) token count


def wave_buckets(entries: Sequence[WaveEntry], block_q: int,
                 block_size: int) -> Tuple[int, int, int, int]:
    """(N, A, MP, R) buckets for an entry list."""
    total_q = sum(len(e.tokens) for e in entries)
    n_atoms = sum(-(-len(e.tokens) // block_q) for e in entries)
    max_pages = max((len(e.blocks) for e in entries), default=1)
    N = _next_bucket(max(total_q, 1), lo=16)
    A = _next_bucket(max(n_atoms, 1), lo=8)
    MP = _next_bucket(max(max_pages, 1), lo=4)
    R = _next_bucket(max(len(entries), 1), lo=8)
    return N, A, MP, R


def build_wave(entries: Sequence[WaveEntry], *, block_q: int,
               block_size: int) -> WaveDescriptors:
    """Flatten the entries into padded wave descriptors."""
    N, A, MP, R = wave_buckets(entries, block_q, block_size)
    ps = block_size
    tokens = np.zeros((N,), np.int32)
    positions = np.zeros((N,), np.int32)
    write_idx = np.zeros((N,), np.int32)   # pad rows -> null block slot 0
    cu = np.zeros((A + 1,), np.int32)
    kv_lens = np.zeros((A,), np.int32)
    pages = np.zeros((A, MP), np.int32)
    last_rows = np.zeros((R,), np.int32)
    row_of_uid: Dict[int, int] = {}

    flat = 0
    atom = 0
    for r, e in enumerate(entries):
        chunk = np.asarray(e.tokens, np.int32)
        q_len = len(chunk)
        if q_len == 0:
            raise ValueError(f"empty chunk for uid {e.uid}")
        blocks = np.asarray(e.blocks, np.int32)
        pos = e.seen + np.arange(q_len, dtype=np.int32)
        tokens[flat:flat + q_len] = chunk
        positions[flat:flat + q_len] = pos
        write_idx[flat:flat + q_len] = blocks[pos // ps] * ps + pos % ps
        for off in range(0, q_len, block_q):
            al = min(block_q, q_len - off)
            cu[atom + 1] = cu[atom] + al
            kv_lens[atom] = e.seen + off + al
            bt = blocks[:MP]
            pages[atom, :len(bt)] = bt
            atom += 1
        flat += q_len
        last_rows[r] = flat - 1
        row_of_uid[e.uid] = r
    # padding atoms: cu stays flat (zero-length), kv_lens 0
    cu[atom + 1:] = cu[atom]
    return WaveDescriptors(tokens, positions, write_idx, cu, kv_lens, pages,
                           last_rows, row_of_uid, n_tokens=flat)
