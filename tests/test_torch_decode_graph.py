"""The decode burst of the port's serving engine on the CPU: K calls of one
decode step (``inference/v2/model.py`` ``decode_step``), the batch padded
to a power-of-two bucket, run by ``inference/v2/decode_graph.py`` (which on
CUDA replays a captured step; on the CPU it calls the step eagerly).

- greedy burst tokens equal the JAX engine's ``decode_burst`` for
  llama2-tiny, int8 llama2-tiny and mixtral-tiny (fp32, the JAX parameters
  carried across by ``convert.params_from_jax``), B 1 / 3 / 8, bursts of K
  1, 2 and 8 in a row whose contexts cross block boundaries and whose
  block-table bucket grows from 4 to 8 blocks;
- ``decode_burst`` is bit for bit K calls of ``decode_step``; a padded
  burst gives the unpadded burst's tokens and live pages (to 1e-5: the
  CPU's fp32 products of 3 and of 4 rows sum in other orders) and writes
  its padded rows into the null block 0 alone;
- Gumbel-max sampling: seeded, greedy rows stay greedy, and the draws
  follow softmax(logits / T) by a chi-square bound;
- the launch accounting, the refusal to capture on the CPU and the kernel
  scratch's bookkeeping for captured buffers.

The JAX engine runs with ``kv_pool_sharding="replicated"`` (the 8-device
test mesh would otherwise shard the pool and renumber its blocks).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2.config_v2 import DeepSpeedTPStateManagerConfig as JaxSM
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.models import mixtral_model as jax_mixtral
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.inference.v2 import (DeepSpeedTPStateManagerConfig,
                                              RaggedInferenceEngineConfig, build_engine)
from deepspeed_tpu_torch.inference.v2.decode_graph import (DecodeGraphs, LaunchCounts,
                                                           StepGraph)
from deepspeed_tpu_torch.inference.v2.engine_v2 import BURST_BUCKET_LO
from deepspeed_tpu_torch.inference.v2.kernels import paged_decode
from deepspeed_tpu_torch.inference.v2.model import DecodeState, sample_next
from deepspeed_tpu_torch.models import llama_model, mixtral_model
from deepspeed_tpu_torch.ops.quantizer import woq_matmul
from deepspeed_tpu_torch.ops.scratch import Scratch
from tests.port_threads import torch_threads  # noqa: F401

V = 1024  # the tiny presets' vocabulary
ENGINE_KW = dict(kv_block_size=4, max_prefill_chunk=16)
SM_KW = dict(max_ragged_batch_size=64, max_ragged_sequence_count=8, max_context=64)
MODELS = ("llama2-tiny", "llama2-tiny-int8", "mixtral-tiny")
#: prompt lengths 10..13: bursts of 1, 2 and 8 cross the blocks' edges at 12,
#: 16 and 20 and grow the block-table bucket from 4 blocks to 8
PROMPT_LENS = (10, 11, 12, 13)
BURST_KS = (1, 2, 8)


def _models(name):
    if name == "mixtral-tiny":
        return (jax_mixtral("mixtral-tiny", dtype=jnp.float32, remat=False, max_seq_len=64),
                mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=64), None)
    return (jax_llama("llama2-tiny", dtype=jnp.float32, remat=False, max_seq_len=64),
            llama_model("llama2-tiny", dtype=torch.float32, max_seq_len=64),
            "int8" if name.endswith("int8") else None)


@pytest.fixture(scope="module", params=MODELS)
def engines(request):
    """(JAX engine, port engine over the JAX engine's parameters)."""
    jm, pm, mode = _models(request.param)
    jcfg = JaxConfig(num_kv_blocks=257, kv_cache_dtype=jnp.float32,
                     kv_pool_sharding="replicated", state_manager=JaxSM(**SM_KW),
                     quantization_mode=mode, **ENGINE_KW)
    dense = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.float32))
    jeng = JaxEngine(jm, config=jcfg, params=dense)
    pcfg = RaggedInferenceEngineConfig(
        num_kv_blocks=257, kv_cache_dtype=torch.float32, quantization_mode=mode,
        state_manager=DeepSpeedTPStateManagerConfig(**SM_KW), **ENGINE_KW)
    peng = build_engine(pm, pcfg, params=params_from_jax(jax.device_get(jeng.params)),
                        device="cpu")
    return jeng, peng


def _prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=PROMPT_LENS[i % len(PROMPT_LENS)]).astype(np.int32)
            for i in range(n)]


def _prefill(engs, uids, prompts):
    """Each prompt a ``put`` of its own on every engine; returns the JAX
    engine's next tokens (the first engine's)."""
    last = []
    for uid, p in zip(uids, prompts):
        logits = [np.asarray(e.put([uid], [p])) for e in engs]
        last.append(int(np.argmax(logits[0][0])))
    return np.asarray(last, np.int32)


@pytest.mark.parametrize("B", (1, 3, 8))
def test_greedy_bursts_match_the_jax_engine(engines, B):
    jeng, peng = engines
    uids = [1000 + 10 * B + i for i in range(B)]
    last = _prefill((jeng, peng), uids, _prompts(B, B))
    mps = []
    for K in BURST_KS:
        mps.append(peng._bucket_blocks(uids))
        want = np.asarray(jeng.decode_burst(uids, last, K))
        got = peng.decode_burst(uids, last, K)
        assert got.shape == (B, K)
        np.testing.assert_array_equal(got, want)
        last = want[:, -1].astype(np.int32)
    assert mps[0] == 4 and peng._bucket_blocks(uids) == 8   # the bucket grew
    assert peng.decode_graphs.captures == 0 and peng.decode_graphs.replays == 0
    for uid in uids:
        jeng.flush(uid)
        peng.flush(uid)
    assert peng.state_manager.free_blocks == jeng.state_manager.free_blocks


def _pages(peng):
    return peng.kv_cache.k_pages.clone(), peng.kv_cache.v_pages.clone()


def _set_pages(peng, pages):
    peng.kv_cache.k_pages.copy_(pages[0])
    peng.kv_cache.v_pages.copy_(pages[1])


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_burst_is_k_decode_steps(engines):
    """``decode_burst`` and K calls of ``decode_step`` on one state: the
    same tokens and the same pages, bit for bit."""
    _, peng = engines
    uids = [2000, 2001, 2002]
    last = _prefill((peng,), uids, _prompts(20, 3))
    K = 6
    seqs, inputs = peng.burst_inputs(uids, last, K)
    start = _pages(peng)
    model, kv = peng._model, peng.kv_cache
    toks = model.decode_burst(kv.k_pages, kv.v_pages, *_tensors(*inputs), K)
    after = _pages(peng)
    _set_pages(peng, start)
    state = DecodeState.empty(len(inputs[0]), inputs[2].shape[1], K, "cpu")
    state.load(*inputs)
    for _ in range(K):
        model.decode_step(kv.k_pages, kv.v_pages, state)
    assert torch.equal(state.hist, toks)
    assert int(state.k) == K
    assert torch.equal(state.positions, torch.from_numpy(inputs[1]) + K)
    assert torch.equal(kv.k_pages, after[0]) and torch.equal(kv.v_pages, after[1])
    for uid in uids:
        peng.flush(uid)


def test_padded_rows_write_only_the_null_block(engines):
    """A burst of 3 sequences padded to its bucket: the live rows' tokens
    and every live page as in the unpadded burst, no other block touched
    but the null block 0, which the padded rows write."""
    _, peng = engines
    uids = [3000, 3001, 3002]
    last = _prefill((peng,), uids, _prompts(30, 3))
    K = 5
    seqs, inputs = peng.burst_inputs(uids, last, K)
    B = len(inputs[0])
    assert B == max(BURST_BUCKET_LO, 4) and (inputs[2][3:] == 0).all()
    kv = peng.kv_cache
    kv.k_pages[:, :, 0] = 0          # earlier padded rows wrote the same values
    kv.v_pages[:, :, 0] = 0
    start = _pages(peng)
    unpadded = peng._model.decode_burst(kv.k_pages, kv.v_pages,
                                        *_tensors(*(a[:3] for a in inputs)), K)
    want = _pages(peng)
    _set_pages(peng, start)
    got = peng.decode_graphs.run(*inputs, K, seed=0)
    assert got.shape == (B, K)
    np.testing.assert_array_equal(got[:3], unpadded.numpy())
    live = sorted({b for seq in seqs for b in seq.blocks})
    others = [b for b in range(1, kv.num_blocks) if b not in live]
    for now, ref, before in zip(_pages(peng), want, start):
        # the CPU's fp32 products of 3 and of 4 rows sum in other orders
        torch.testing.assert_close(now[:, :, live], ref[:, :, live], rtol=1e-5, atol=1e-5)
        assert torch.equal(now[:, :, others], before[:, :, others])
        assert not torch.equal(now[:, :, 0], before[:, :, 0])
    for uid in uids:
        peng.flush(uid)


def test_a_burst_longer_than_the_history_runs_in_chunks(engines):
    """``DecodeGraphs`` of a 3-step history serves an 8-step burst in three
    chunks, with the tokens and pages of one 8-step burst."""
    _, peng = engines
    uids = [4000, 4001]
    last = _prefill((peng,), uids, _prompts(40, 2))
    seqs, inputs = peng.burst_inputs(uids, last, 8)
    start = _pages(peng)
    want = peng.decode_graphs.run(*inputs, 8, seed=0)
    want_pages = _pages(peng)
    _set_pages(peng, start)
    kv = peng.kv_cache
    short = DecodeGraphs(peng._model, kv.k_pages, kv.v_pages, width=3)
    np.testing.assert_array_equal(short.run(*inputs, 8, seed=0), want)
    assert torch.equal(kv.k_pages, want_pages[0]) and torch.equal(kv.v_pages, want_pages[1])
    for uid in uids:
        peng.flush(uid)


def test_sampled_bursts_are_seeded_and_greedy_rows_stay_greedy(engines):
    """Through the engine's burst runner: one seed gives the same tokens
    twice, another seed others; the temperature-0 rows of a mixed batch
    are the greedy burst's rows."""
    _, peng = engines
    uids = [5000, 5001, 5002, 5003]
    last = _prefill((peng,), uids, _prompts(50, 4))
    K = 6
    _, (tok, pos, tab, _) = peng.burst_inputs(uids, last, K)
    temps = np.zeros(len(tok), np.float32)
    temps[[1, 3]] = 1.5
    start = _pages(peng)
    runs = {}
    for name, t, seed in (("greedy", np.zeros_like(temps), 0), ("a", temps, 7),
                          ("b", temps, 7), ("c", temps, 8)):
        _set_pages(peng, start)
        runs[name] = peng.decode_graphs.run(tok, pos, tab, t, K, seed)
    np.testing.assert_array_equal(runs["a"], runs["b"])
    assert not np.array_equal(runs["a"][[1, 3]], runs["c"][[1, 3]])
    np.testing.assert_array_equal(runs["a"][[0, 2]], runs["greedy"][[0, 2]])
    np.testing.assert_array_equal(runs["c"][[0, 2]], runs["greedy"][[0, 2]])
    for uid in uids:
        peng.flush(uid)


def test_gumbel_max_draws_follow_the_softmax():
    """20000 draws of one 16-token row at T 0.7 from a seeded generator:
    their counts against 20000 x softmax(logits / T). The chi-square
    statistic has 15 degrees of freedom; it exceeds 37.70 with probability
    0.001 when the draws follow the softmax."""
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=16).astype(np.float32))
    T, n = 0.7, 20000
    gen = torch.Generator().manual_seed(11)
    draws = sample_next(logits.expand(n, 16).contiguous(), torch.full((n,), T), True, gen)
    counts = torch.bincount(draws, minlength=16).double()
    expected = n * torch.softmax(logits.double() / T, dim=0)
    assert float(expected.min()) > 5   # the chi-square approximation holds
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 37.70, chi2


def test_sampling_rows_seed_and_greedy_flag():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(64, 50)).astype(np.float32))
    temps = torch.from_numpy(np.where(np.arange(64) % 3 == 0, 0.0, 0.9).astype(np.float32))
    draw = lambda seed: sample_next(logits, temps, True, torch.Generator().manual_seed(seed))
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
    greedy = torch.argmax(logits, dim=-1)
    assert torch.equal(draw(3)[temps <= 0], greedy[temps <= 0])
    # the flag off draws nothing: the generator's state does not move
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    assert torch.equal(sample_next(logits, temps, False, gen), greedy)
    assert torch.equal(gen.get_state(), state)


def test_launch_counts_add_the_recorded_delta_once_a_replay():
    pd = types.SimpleNamespace(launches=5)
    moe = types.SimpleNamespace(launches={"moe_route": 1, "moe_ffn": 0})
    held = moe.launches
    counts = LaunchCounts([(pd, "launches"), (moe, "launches")])
    before = counts.snapshot()
    pd.launches += 3                     # what a capture's Python "launches"
    moe.launches["moe_route"] += 2
    delta = counts.delta(before)
    assert delta == [3, {"moe_route": 2, "moe_ffn": 0}]
    counts.add(delta, times=-1)          # the captured launches have not run
    assert (pd.launches, moe.launches) == (5, {"moe_route": 1, "moe_ffn": 0})
    step = StepGraph.__new__(StepGraph)  # a captured step without the card
    replays = []
    step.graph = types.SimpleNamespace(replay=lambda: replays.append(1))
    step.counts, step.delta = counts, delta
    for _ in range(4):
        step.replay()
    assert len(replays) == 4
    assert pd.launches == 5 + 4 * 3
    assert moe.launches == {"moe_route": 1 + 4 * 2, "moe_ffn": 0}
    assert moe.launches is held          # readers of the dict see the counts


def test_a_capture_on_the_cpu_raises():
    with pytest.raises(RuntimeError, match="CUDA device"):
        StepGraph(lambda: None, torch.device("cpu"), None, None, LaunchCounts([]))


@pytest.mark.parametrize("module", ("paged_decode", "woq_matmul"))
def test_scratch_keeps_every_buffer_handed_out_for_capture(monkeypatch, module):
    """The bookkeeping alone, on CPU tensors: a buffer handed out while a
    capture is underway is held when its key grows later; growing inside a
    capture raises; new counters start at zero."""
    mod = {"paged_decode": paged_decode, "woq_matmul": woq_matmul}[module]
    monkeypatch.setattr(mod, "_bufs", Scratch())
    dev = torch.device("cpu")
    if module == "paged_decode":
        get = lambda n, capturing=False: paged_decode._scratch(dev, 7, n, n, capturing)
    else:
        get = lambda n, capturing=False: (woq_matmul._tile_counters(dev, 7, n, capturing),)
    first = get(10)
    with pytest.raises(RuntimeError, match="capture"):
        get(1 << 20, capturing=True)
    captured = get(10, capturing=True)
    assert all(a is b for a, b in zip(captured, first))
    grown = get(1 << 20)
    assert all(a is not b for a, b in zip(grown, first))
    held = mod._bufs.held
    assert len(held) == len(first) and all(any(h is b for h in held) for b in first)
    assert not any(h is b for h in held for b in grown)
    assert int(grown[-1].abs().sum()) == 0           # counters start at zero
    assert all(a is b for a, b in zip(get(10), grown))   # the live buffer serves smaller calls
