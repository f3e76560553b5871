"""Parity of the port's ragged paged attention
(``deepspeed_tpu_torch/inference/v2/kernels/ragged_paged_attention.py``)
with the JAX Pallas kernel run in interpret mode, as the JAX suite runs it
on the CPU (``ragged_paged_attention(..., use_pallas=True,
interpret=True)``), over prefill, mixed and decode-burst waves, GQA groups
g in {1, 2, 4} and page-straddling chunks. Both sides get the same numpy
inputs; fp32, tolerance 2e-5 (the JAX suite's fp32 bound for this kernel).

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
from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as trpa
from deepspeed_tpu_torch.inference.v2.ragged import wave as twave

# the JAX kernels package re-exports a function under the module's name
jrpa = importlib.import_module(
    "deepspeed_tpu.inference.v2.kernels.ragged_paged_attention")

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


def _inputs(seqs, g, seed):
    entries, n_pages = _entries(twave, seqs)
    desc = twave.build_wave(entries, block_q=BQ, block_size=PS)
    rng = np.random.default_rng(seed)
    P = n_pages + 2
    k = rng.normal(size=(KVH, P, PS, D)).astype(np.float32)
    v = rng.normal(size=(KVH, P, PS, D)).astype(np.float32)
    q = rng.normal(size=(len(desc.tokens), KVH * g, D)).astype(np.float32)
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
