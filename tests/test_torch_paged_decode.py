"""Parity of the port's paged decode attention
(``deepspeed_tpu_torch/inference/v2/kernels/paged_decode.py``) with the JAX
Pallas ``paged_gqa_decode`` in interpret mode (as the JAX suite runs it on
the CPU) and with the JAX plain ``_xla_paged_decode``, also with ALiBi
slopes and windows (``paged_decode_attention``'s XLA path), and the split
plan under a window. Same numpy inputs on both sides; fp32, tolerance
2e-5.

On the CPU the port runs its plain version; ``chip_smoke.py`` holds the
CUDA kernel to it on the GPU."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.kernels import paged_attention as tpa
from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as tpd
from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as trpa
from deepspeed_tpu_torch.inference.v2.ragged.wave import WaveEntry, build_wave
from tests.port_threads import torch_threads  # noqa: F401

# the JAX kernels package re-exports functions under the modules' names
jpa = importlib.import_module("deepspeed_tpu.inference.v2.kernels.paged_attention")
jpd = importlib.import_module("deepspeed_tpu.inference.v2.kernels.pallas_paged_decode")

PS, D, KVH = 4, 16, 2
TOL = dict(rtol=2e-5, atol=2e-5)
# contexts: inside one page, exactly one page, straddles, several pages
CTXS = [1, 3, 4, 5, 9, 17, 30]


def _inputs(ctxs, g, seed, d=D):
    rng = np.random.default_rng(seed)
    mp = max(-(-c // PS) for c in ctxs)
    tables, nxt = np.zeros((len(ctxs), mp), np.int32), 1
    for i, c in enumerate(ctxs):
        nb = -(-c // PS)
        tables[i, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    k = rng.normal(size=(KVH, nxt + 1, PS, d)).astype(np.float32)
    v = rng.normal(size=(KVH, nxt + 1, PS, d)).astype(np.float32)
    q = rng.normal(size=(len(ctxs), KVH * g, d)).astype(np.float32)
    return q, k, v, np.asarray(ctxs, np.int32), tables


def _port(q, k, v, ctx, tables):
    t = torch.from_numpy
    return tpd.paged_gqa_decode(t(q), t(k), t(v), t(ctx), t(tables)).numpy()


@pytest.mark.parametrize("g", [1, 2, 4])
def test_plain_matches_jax_kernel(g):
    q, k, v, ctx, tables = _inputs(CTXS, g, seed=g)
    j = jnp.asarray
    want = jpd.paged_gqa_decode(j(q), j(k), j(v), j(ctx), j(tables), interpret=True)
    np.testing.assert_allclose(_port(q, k, v, ctx, tables), np.asarray(want), **TOL)


@pytest.mark.parametrize("g", [1, 4])
def test_reference_matches_jax_plain(g):
    q, k, v, ctx, tables = _inputs(CTXS, g, seed=10 + g)
    j = jnp.asarray
    want = jpa._xla_paged_decode(j(q), j(k), j(v), j(ctx), j(tables), 1 / D ** 0.5)
    got = tpa.paged_decode_attention_reference(*map(torch.from_numpy,
                                                    (q, k, v, ctx, tables)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_pages_matches_jax():
    _, k, _, _, tables = _inputs(CTXS, 1, seed=3)
    got = tpa._gather_pages(torch.from_numpy(k), torch.from_numpy(tables))
    want = jpa._gather_pages(jnp.asarray(k), jnp.asarray(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_rows_of_a_ragged_wave_match():
    """A decode-only ragged wave and the paged decode give the same rows:
    the two attention forms of the serving path agree."""
    q, k, v, ctx, tables = _inputs(CTXS, 2, seed=4)
    entries = [WaveEntry(i, np.zeros(1, np.int32), int(c) - 1,
                         [int(b) for b in tables[i, :-(-int(c) // PS)]])
               for i, c in enumerate(ctx)]
    desc = build_wave(entries, block_q=8, block_size=PS)
    qw = np.zeros((len(desc.tokens),) + q.shape[1:], np.float32)
    qw[:len(ctx)] = q
    t = torch.from_numpy
    got = trpa.ragged_paged_attention(t(qw), t(k), t(v), t(desc.kv_lens),
                                      t(desc.page_indices), t(desc.cu_q_lens))
    np.testing.assert_allclose(got.numpy()[:len(ctx)], _port(q, k, v, ctx, tables),
                               **TOL)


def test_rejects_mismatched_heads():
    q, k, v, ctx, tables = _inputs(CTXS, 2, seed=5)
    with pytest.raises(ValueError, match="multiple"):
        _port(q[:, :3], k, v, ctx, tables)


def _inputs_shuffled(ctxs, g, seed, d=D):
    """As ``_inputs``, each sequence's pages drawn from a seeded
    permutation of the pool (not consecutive)."""
    rng = np.random.default_rng(seed)
    counts = [-(-c // PS) for c in ctxs]
    order = rng.permutation(sum(counts)) + 1
    tables, at = np.zeros((len(ctxs), max(counts)), np.int32), 0
    for i, n in enumerate(counts):
        tables[i, :n] = order[at:at + n]
        at += n
    k = rng.normal(size=(KVH, at + 2, PS, d)).astype(np.float32)
    v = rng.normal(size=(KVH, at + 2, PS, d)).astype(np.float32)
    q = rng.normal(size=(len(ctxs), KVH * g, d)).astype(np.float32)
    return q, k, v, np.asarray(ctxs, np.int32), tables


@pytest.mark.parametrize("g", [1, 2, 4])
def test_shuffled_tables_match_jax_kernel(g):
    """Pages scattered over the pool: the port's plain version against the
    Pallas kernel in interpret mode, fp32, 2e-5."""
    q, k, v, ctx, tables = _inputs_shuffled(CTXS + [40, 1, 16, 17], g, seed=20 + g)
    j = jnp.asarray
    want = jpd.paged_gqa_decode(j(q), j(k), j(v), j(ctx), j(tables), interpret=True)
    np.testing.assert_allclose(_port(q, k, v, ctx, tables), np.asarray(want), **TOL)


@pytest.mark.parametrize("ctx", [0, 1, 16, 17, 127, 128, 129, 513, 2048, 4133, 65537])
@pytest.mark.parametrize("mp", [1, 8, 33, 300, 5000])
def test_split_plan_covers_each_context_once(ctx, mp):
    """The decode kernel's split plan (``split_plan``, the mirror of
    ``csrc/paged_decode.cu`` ``plan``): its splits cover the keys the table
    holds, min(ctx, mp * ps), once and in order, at most ``max_splits``
    of them, each a whole number of ``SPLIT_UNIT`` units but the last."""
    ps = 16
    plan = tpd.split_plan(ctx, mp, ps)
    n_keys = min(ctx, mp * ps)
    assert 1 <= len(plan) <= tpd.max_splits(mp, ps) <= tpd.MAX_SPLITS
    assert plan[0][0] == 0 and plan[-1][1] == n_keys
    for (lo, hi), (lo2, _) in zip(plan, plan[1:]):
        assert hi == lo2 and hi > lo and (hi - lo) % tpd.SPLIT_UNIT == 0
    assert len({hi - lo for lo, hi in plan[:-1]}) <= 1


@pytest.mark.parametrize("g,want", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (16, 8)])
def test_row_group(g, want):
    """Query rows of one kv head a decode block takes: the GQA group up to
    8 rows, else groups of 8."""
    assert tpd.row_group(g) == want


@pytest.mark.parametrize("shuffle", [False, True], ids=["consecutive", "shuffled"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [100, 33, 256])
def test_head_dims_match_jax_kernel(d, g, shuffle):
    """open-llama-3b's head_dim 100 and an odd 33 (rows of no whole 16
    bytes: the CUDA kernel's NARROW form) and 256 (fp32 rows of 1024 bytes:
    32 lanes a row), consecutive and shuffled tables: the port's plain
    version against the Pallas kernel in interpret mode, fp32, 2e-5."""
    make = _inputs_shuffled if shuffle else _inputs
    q, k, v, ctx, tables = make(CTXS + [40, 1, 16, 17], g, seed=30 + g + d, d=d)
    j = jnp.asarray
    want = jpd.paged_gqa_decode(j(q), j(k), j(v), j(ctx), j(tables), interpret=True)
    np.testing.assert_allclose(_port(q, k, v, ctx, tables), np.asarray(want), **TOL)


@pytest.mark.parametrize("row_bytes,want", [(512, 8), (528, 2), (1024, 2), (200, 1), (66, 1)])
def test_row_group_of_wide_rows(row_bytes, want):
    """K / V rows above 512 bytes (32 lanes a row) take at most 2 query
    rows a block (a GQA group of 8 splits into 4 blocks), rows that are no
    multiple of 16 bytes (the NARROW form) one."""
    assert tpd.row_group(8, row_bytes) == want
    assert tpd.row_group(1, row_bytes) == 1


# -- ALiBi and sliding windows --------------------------------------------------------


@pytest.mark.parametrize("alibi,window", [(True, None), (False, 5), (True, 9), (False, 0)],
                         ids=["alibi", "window-5", "alibi-window-9", "window-0"])
@pytest.mark.parametrize("g", [1, 4])
def test_alibi_and_window_match_jax(g, alibi, window):
    """The wrapper's plain version with ALiBi slopes and / or a window (one
    that crosses pages; 0 = global) against the JAX ``paged_decode_attention``
    (its XLA path, ``_xla_paged_decode``), fp32, 2e-5."""
    q, k, v, ctx, tables = _inputs_shuffled(CTXS + [40, 16], g, seed=30 + g)
    slopes = ((0.25 + np.random.default_rng(g).random(KVH * g)).astype(np.float32)
              if alibi else None)
    t, j = torch.from_numpy, jnp.asarray
    got = tpd.paged_gqa_decode(t(q), t(k), t(v), t(ctx), t(tables),
                               alibi_slopes=None if slopes is None else t(slopes),
                               window=window)
    want = jpa.paged_decode_attention(j(q), j(k), j(v), j(ctx), j(tables),
                                      alibi_slopes=None if slopes is None else j(slopes),
                                      window=None if window is None else jnp.int32(window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ctx", [0, 1, 200, 256, 257, 300, 2048, 4133])
@pytest.mark.parametrize("window", [1, 100, 256, 4096])
def test_split_plan_with_a_window(ctx, window):
    """Under a window the splits cover exactly the keys the query sees,
    ``max(0, ctx - window)`` to ``min(ctx, mp * ps)``, once and in order,
    in whole units from the window's first key; the host's split count is
    capped by the window (GPT-Neo's local layers: 256 keys, two splits)."""
    mp, ps = 300, 16
    plan = tpd.split_plan(ctx, mp, ps, window)
    n_keys = min(ctx, mp * ps)
    lo = min(max(ctx - window, 0), n_keys)
    assert 1 <= len(plan) <= tpd.max_splits(mp, ps, window) <= -(-window // tpd.SPLIT_UNIT)
    assert plan[0][0] == lo and plan[-1][1] == n_keys
    for (a, b), (a2, _) in zip(plan, plan[1:]):
        assert b == a2 and b > a and (b - a) % tpd.SPLIT_UNIT == 0
    assert tpd.split_plan(ctx, mp, ps, 0) == tpd.split_plan(ctx, mp, ps)
