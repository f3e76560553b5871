"""Parity of the port's ragged paged attention
(``deepspeed_tpu_torch/inference/v2/kernels/ragged_paged_attention.py``)
with the JAX Pallas kernel run in interpret mode, as the JAX suite runs it
on the CPU (``ragged_paged_attention(..., use_pallas=True,
interpret=True)``), over prefill, mixed and decode-burst waves, GQA groups
g in {1, 2, 4} and page-straddling chunks; with ALiBi slopes and windows
(one crossing pages) against the JAX function's XLA atom path, which the
JAX engine takes for them, and ``ragged_chunk_attention`` /
``chunk_prefill_attention`` against the JAX ones. Both sides get the same
numpy inputs; fp32, tolerance 2e-5 (the JAX suite's fp32 bound for this
kernel).

On the CPU the port runs its plain version; the CUDA kernel is held to that
plain version on the GPU by ``chip_smoke.py``."""

import dataclasses
import importlib

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.ragged import wave as jwave
from deepspeed_tpu_torch.inference.v2.kernels import paged_attention as tpa
from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as trpa
from deepspeed_tpu_torch.inference.v2.ragged import wave as twave
from tests.port_threads import torch_threads  # noqa: F401

# the JAX kernels package re-exports a function under the module's name
jrpa = importlib.import_module(
    "deepspeed_tpu.inference.v2.kernels.ragged_paged_attention")
jpa = importlib.import_module("deepspeed_tpu.inference.v2.kernels.paged_attention")

BQ, PS, D, KVH = 8, 4, 16, 2
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _pallas_compiler_params(monkeypatch):
    """The JAX kernel names ``pltpu.TPUCompilerParams``, which newer JAX
    releases call ``pltpu.CompilerParams``; alias it for these tests so the
    reference runs unchanged under the installed JAX."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


WAVES = {
    # pure prefill: two fresh prompts, one longer than the atom tile
    "prefill": [(11, 0), (6, 0)],
    # mixed: decode rows + a continuing chunk + a fresh prompt
    "mixed": [(1, 9), (1, 17), (11, 5), (6, 0)],
    # decode burst: single-token rows, ragged contexts
    "decode-burst": [(1, 3), (1, 9), (1, 17), (1, 1), (1, 30), (1, 12)],
    # histories ending mid-page, chunks crossing page boundaries
    "straddle": [(6, 3), (5, 4), (9, 0), (1, 7)],
}


def _entries(mod, seqs):
    out, nxt = [], 1
    for uid, (q_len, seen) in enumerate(seqs):
        nb = -(-(seen + q_len) // PS)
        toks = np.arange(q_len, dtype=np.int32) + 100 * uid
        out.append(mod.WaveEntry(uid, toks, seen, list(range(nxt, nxt + nb))))
        nxt += nb
    return out, nxt


def _inputs(seqs, g, seed, d=D, shuffle=False):
    entries, n_pages = (_entries_shuffled(twave, seqs, seed) if shuffle
                        else _entries(twave, seqs))
    desc = twave.build_wave(entries, block_q=BQ, block_size=PS)
    rng = np.random.default_rng(seed)
    P = n_pages + 2
    k = rng.normal(size=(KVH, P, PS, d)).astype(np.float32)
    v = rng.normal(size=(KVH, P, PS, d)).astype(np.float32)
    q = rng.normal(size=(len(desc.tokens), KVH * g, d)).astype(np.float32)
    return q, k, v, desc


def _port(q, k, v, desc):
    t = torch.from_numpy
    return trpa.ragged_paged_attention(
        t(q), t(k), t(v), t(desc.kv_lens), t(desc.page_indices),
        t(desc.cu_q_lens), block_q=BQ).numpy()


def _jax_pallas(q, k, v, desc):
    j = jnp.asarray
    return np.asarray(jrpa.ragged_paged_attention(
        j(q), j(k), j(v), j(desc.kv_lens), j(desc.page_indices),
        j(desc.cu_q_lens), block_q=BQ, use_pallas=True, interpret=True))


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("wave", sorted(WAVES))
def test_plain_matches_jax_kernel(wave, g):
    q, k, v, desc = _inputs(WAVES[wave], g, seed=sorted(WAVES).index(wave) * 10 + g)
    n = desc.n_tokens
    np.testing.assert_allclose(_port(q, k, v, desc)[:n],
                               _jax_pallas(q, k, v, desc)[:n], **TOL)


@pytest.mark.parametrize("wave", sorted(WAVES))
def test_build_wave_is_bit_identical(wave):
    """The port's host builder reproduces the JAX builder byte for byte
    (descriptors, padding buckets, row map)."""
    got = twave.build_wave(_entries(twave, WAVES[wave])[0], block_q=BQ,
                           block_size=PS)
    want = jwave.build_wave(_entries(jwave, WAVES[wave])[0], block_q=BQ,
                            block_size=PS)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


def test_scatter_gather_match_jax():
    q, _, _, desc = _inputs(WAVES["mixed"], 2, seed=3)
    A = desc.page_indices.shape[0]
    got, dest = trpa._scatter_to_atoms(torch.from_numpy(q),
                                       torch.from_numpy(desc.cu_q_lens), A, BQ)
    want, jdest = jrpa._scatter_to_atoms(jnp.asarray(q), jnp.asarray(desc.cu_q_lens),
                                         A, BQ)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(trpa._gather_from_atoms(got, dest).numpy(),
                                  np.asarray(jrpa._gather_from_atoms(want, jdest)))


def test_padded_rows_are_finite():
    """Stream padding and whole padding atoms produce finite values."""
    q, k, v, desc = _inputs([(1, 2)], 2, seed=7)
    assert len(desc.tokens) > desc.n_tokens
    assert np.isfinite(_port(q, k, v, desc)).all()


def test_bf16_keeps_dtype_and_matches_fp32():
    q, k, v, desc = _inputs(WAVES["mixed"], 2, seed=5)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    out = trpa.ragged_paged_attention(
        t(q), t(k), t(v), torch.from_numpy(desc.kv_lens),
        torch.from_numpy(desc.page_indices), torch.from_numpy(desc.cu_q_lens),
        block_q=BQ)
    assert out.dtype == torch.bfloat16
    n = desc.n_tokens
    np.testing.assert_allclose(out.float().numpy()[:n], _port(q, k, v, desc)[:n],
                               rtol=2e-2, atol=2e-2)


def test_narrow_kv_store_is_not_ported():
    q, k, v, desc = _inputs(WAVES["mixed"], 1, seed=6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trpa.ragged_paged_attention(
            torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
            torch.from_numpy(v).to(torch.bfloat16),
            torch.from_numpy(desc.kv_lens), torch.from_numpy(desc.page_indices),
            torch.from_numpy(desc.cu_q_lens), block_q=BQ)


# ---- shuffled block tables and the tensor-core kernel's tile rule ----------


def _entries_shuffled(mod, seqs, seed):
    """As ``_entries``, each sequence's pages drawn from a seeded
    permutation of the pool (not consecutive)."""
    counts = [-(-(seen + q_len) // PS) for q_len, seen in seqs]
    order = np.random.default_rng(seed).permutation(sum(counts)) + 1
    out, at = [], 0
    for uid, ((q_len, seen), nb) in enumerate(zip(seqs, counts)):
        toks = np.arange(q_len, dtype=np.int32) + 100 * uid
        out.append(mod.WaveEntry(uid, toks, seen, [int(p) for p in order[at:at + nb]]))
        at += nb
    return out, at + 1


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("wave", sorted(WAVES))
def test_shuffled_tables_match_jax_kernel(wave, g):
    """Pages of each sequence scattered over the pool: the port's plain
    version against the Pallas kernel in interpret mode, fp32, 2e-5."""
    seed = sorted(WAVES).index(wave) * 10 + g + 100
    entries, n_pages = _entries_shuffled(twave, WAVES[wave], seed)
    desc = twave.build_wave(entries, block_q=BQ, block_size=PS)
    rng = np.random.default_rng(seed)
    P = n_pages + 2
    k = rng.normal(size=(KVH, P, PS, D)).astype(np.float32)
    v = rng.normal(size=(KVH, P, PS, D)).astype(np.float32)
    q = rng.normal(size=(len(desc.tokens), KVH * g, D)).astype(np.float32)
    n = desc.n_tokens
    np.testing.assert_allclose(_port(q, k, v, desc)[:n],
                               _jax_pallas(q, k, v, desc)[:n], **TOL)


# waves about the 64-row tile's edges (64 / g tokens a tile), decode atoms
# of many sequences, and histories ending mid-page, at the engine's atoms
# of 8 tokens and pages of 16
TILE_WAVES = {
    "prefill-2x256": [(256, 0), (256, 0)],
    "tile-edges": [(63, 0), (64, 0), (65, 17), (129, 64), (15, 0), (16, 3), (17, 0)],
    "mixed": [(1, 543), (1, 416), (256, 256), (77, 0), (5, 11), (44, 256)],
    "decode-40": [(1, 17 + 29 * i) for i in range(40)],
}


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("wave", sorted(TILE_WAVES))
def test_wave_tiles_cover_the_wave(wave, g):
    """The tensor-core kernel's tile rule (``wave_tiles``) on the port's
    wave builder's descriptors: every stream row of an atom lands in
    exactly one tile, no tile crosses sequences or holds more than 64 query
    rows, padding atoms and padding rows fall in no tile, and each tile's
    first row sits at its sequence's position and reads its sequence's
    table."""
    entries, _ = _entries_shuffled(twave, TILE_WAVES[wave], seed=g)
    desc = twave.build_wave(entries, block_q=8, block_size=16)
    tiles = trpa.wave_tiles(desc.cu_q_lens, desc.kv_lens, desc.page_indices, g, 16)
    # stream row -> (entry, position)
    owner, pos = [], []
    for e in entries:
        owner += [e.uid] * len(e.tokens)
        pos += list(range(e.seen, e.seen + len(e.tokens)))
    hits = np.zeros(len(desc.tokens), np.int32)
    for row0, n_tok, pos0, atom in tiles:
        assert 1 <= n_tok and n_tok * g <= trpa.TILE_ROWS
        rows = range(row0, row0 + n_tok)
        hits[row0:row0 + n_tok] += 1
        uids = {owner[r] for r in rows}
        assert len(uids) == 1, (row0, n_tok, uids)
        assert pos0 == pos[row0]
        assert desc.cu_q_lens[atom] < desc.cu_q_lens[atom + 1]       # not padding
        e = entries[uids.pop()]
        np.testing.assert_array_equal(desc.page_indices[atom, :len(e.blocks)], e.blocks)
    np.testing.assert_array_equal(hits[:desc.n_tokens], 1)
    np.testing.assert_array_equal(hits[desc.n_tokens:], 0)


def test_wave_tiles_merge_atoms_of_one_chunk():
    """A 256-token chunk is 32 atoms of 8 tokens; at g 1 it is 4 tiles of
    64, one K/V stream each, not one a atom; a chunk whose history ends
    mid-tile starts with a shorter tile."""
    entries, _ = _entries_shuffled(twave, [(256, 0), (100, 30)], seed=0)
    desc = twave.build_wave(entries, block_q=8, block_size=16)
    tiles = trpa.wave_tiles(desc.cu_q_lens, desc.kv_lens, desc.page_indices, 1, 16)
    assert [(r, n, p) for r, n, p, _ in tiles] == [
        (0, 64, 0), (64, 64, 64), (128, 64, 128), (192, 64, 192),
        (256, 34, 30), (290, 64, 64), (354, 2, 128)]


@pytest.mark.parametrize("dtype,g,D,ps,want", [
    (torch.bfloat16, 1, 128, 16, True), (torch.bfloat16, 8, 64, 32, True),
    (torch.bfloat16, 4, 128, 128, True), (torch.bfloat16, 64, 64, 64, True),
    (torch.float32, 1, 128, 16, False), (torch.bfloat16, 1, 128, 8, False),
    (torch.bfloat16, 1, 96, 16, False), (torch.bfloat16, 128, 64, 16, False),
    (torch.bfloat16, 1, 128, 48, False)])
def test_tensor_core_form_rule(dtype, g, D, ps, want):
    """Which kernel a wave takes on the card: bf16 at head_dim 64 / 128, at
    most 64 query rows a kv head, pages of 16, 32 or a multiple of 64."""
    assert trpa.tensor_core_form(dtype, g, D, ps) is want


# ---- head dims past the tensor-core form's 64 / 128 -------------------------


@pytest.mark.parametrize("shuffle", [False, True], ids=["consecutive", "shuffled"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("wave", sorted(WAVES))
@pytest.mark.parametrize("d", [100, 33])
def test_head_dims_match_jax_kernel(d, wave, g, shuffle):
    """open-llama-3b's head_dim 100 (bf16 rows of 200 bytes, which the CUDA
    kernel copies 8 bytes at a time) and an odd 33 (2-byte copies), with
    consecutive and shuffled block tables: the port's plain version against
    the Pallas kernel in interpret mode, fp32, 2e-5."""
    seed = sorted(WAVES).index(wave) * 10 + g + 200 + d
    q, k, v, desc = _inputs(WAVES[wave], g, seed, d=d, shuffle=shuffle)
    n = desc.n_tokens
    np.testing.assert_allclose(_port(q, k, v, desc)[:n],
                               _jax_pallas(q, k, v, desc)[:n], **TOL)


def _descriptors(desc):
    return (("kv_lens", torch.from_numpy(desc.kv_lens)),
            ("page_indices", torch.from_numpy(desc.page_indices)),
            ("cu_q_lens", torch.from_numpy(desc.cu_q_lens)))


@pytest.mark.parametrize("d", [100, 16, 33, 80, 256])
def test_check_kernel_args_takes_any_head_dim(d):
    """Both CUDA kernels' argument check takes every head_dim the JAX
    kernels take (no multiple-of-8 rule); q and the pool must agree on it."""
    q, k, v, desc = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                     for a in _inputs(WAVES["mixed"], 2, seed=d, d=d))
    trpa.check_kernel_args(q, k, v, _descriptors(desc))
    trpa.check_kernel_args(q.bfloat16(), k.bfloat16(), v.bfloat16(), _descriptors(desc))
    with pytest.raises(ValueError, match="last dim"):
        trpa.check_kernel_args(q[..., :-1].contiguous(), k, v, _descriptors(desc))


# -- ALiBi and sliding windows (the JAX XLA atom path's contract) -----------------------

# (slopes, window): ALiBi alone, a window that crosses pages (PS 4) alone, both
MASKS = {"alibi": (True, None), "window-6": (False, 6), "alibi-window-3": (True, 3)}


def _slopes(H, seed):
    return (0.25 + np.random.default_rng(seed).random(H)).astype(np.float32)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("wave", sorted(WAVES))
def test_alibi_and_window_match_jax(wave, mask, g):
    """The wrapper's plain version with ALiBi slopes and / or a window
    against the JAX ``ragged_paged_attention`` (which takes its XLA atom
    path for them), fp32, 2e-5."""
    q, k, v, desc = _inputs(WAVES[wave], g, seed=sorted(WAVES).index(wave) + 50 * g)
    alibi, window = MASKS[mask]
    slopes = _slopes(KVH * g, seed=g) if alibi else None
    t, j = torch.from_numpy, jnp.asarray
    got = trpa.ragged_paged_attention(
        t(q), t(k), t(v), t(desc.kv_lens), t(desc.page_indices), t(desc.cu_q_lens),
        block_q=BQ, alibi_slopes=None if slopes is None else t(slopes), window=window)
    want = jrpa.ragged_paged_attention(
        j(q), j(k), j(v), j(desc.kv_lens), j(desc.page_indices), j(desc.cu_q_lens),
        block_q=BQ, alibi_slopes=None if slopes is None else j(slopes),
        window=None if window is None else jnp.int32(window))
    n = desc.n_tokens
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n], **TOL)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_chunk_functions_match_jax(mask):
    """``ragged_chunk_attention`` (S chunks of T tokens over pages) and
    ``chunk_prefill_attention`` (one sequence's gathered context) with the
    same slopes / window as the JAX functions; GQA 2, scale 0.7."""
    alibi, window = MASKS[mask]
    rng = np.random.default_rng(7)
    S, T, H, mp = 3, 5, 4, 6
    q = rng.normal(size=(S, T, H, D)).astype(np.float32)
    k = rng.normal(size=(KVH, 20, PS, D)).astype(np.float32)
    v = rng.normal(size=(KVH, 20, PS, D)).astype(np.float32)
    tables = rng.permutation(19)[:S * mp].reshape(S, mp).astype(np.int32) + 1
    hist = np.asarray([0, 7, 15], np.int32)
    slopes = _slopes(H, seed=3) if alibi else None
    t, j = torch.from_numpy, jnp.asarray
    ts = None if slopes is None else t(slopes)
    js = None if slopes is None else j(slopes)
    jw = None if window is None else jnp.int32(window)
    got = tpa.ragged_chunk_attention(t(q), t(k), t(v), t(hist), t(tables), scale=0.7,
                                     alibi_slopes=ts, window=window)
    want = jpa.ragged_chunk_attention(j(q), j(k), j(v), j(hist), j(tables), scale=0.7,
                                      alibi_slopes=js, window=jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kc = k[:, tables[2]].reshape(KVH, mp * PS, D)[:, :hist[2] + T]
    vc = v[:, tables[2]].reshape(KVH, mp * PS, D)[:, :hist[2] + T]
    got = tpa.chunk_prefill_attention(t(q[2]), t(kc), t(vc), int(hist[2]), scale=0.7,
                                      alibi_slopes=ts, window=window)
    want = jpa.chunk_prefill_attention(j(q[2]), j(kc), j(vc), jnp.int32(hist[2]),
                                       scale=0.7, alibi_slopes=js, window=jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
