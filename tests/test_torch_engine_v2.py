"""The port's serving engine against the JAX one: llama2-tiny, fp32, the JAX
parameters carried across by ``convert.params_from_jax``, the port on the
CPU (its plain attention path), the same numpy prompts on both sides.

- first-wave and decode logits agree to 1e-4 (fp32; summation order);
- ``generate`` greedy tokens are identical, with decode bursts, with
  single-token decode steps, and under KV pressure that preempts, offloads
  and restores sequences;
- the allocator and the KV cache's offload / restore behave as the JAX ones;
- a windowed llama2-tiny (window 8) gives the JAX engine's greedy tokens,
  ALiBi and windowed 1-layer models serve their plain forward's greedy
  continuation, and the encoders' block layouts build with the JAX tree's
  keys and logits (the engine refuses a bidirectional one).

The JAX engine runs with ``kv_pool_sharding="replicated"``: the test mesh
has 8 CPU devices, and a derived pool would otherwise be sharded and its
blocks renumbered.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2 import generate as jax_generate
from deepspeed_tpu.inference.v2.config_v2 import DeepSpeedTPStateManagerConfig as JaxSM
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import BlockedAllocator as JaxAlloc
from deepspeed_tpu.inference.v2.ragged.kv_cache import BlockedKVCache as JaxKV
from deepspeed_tpu.models import gpt2_model as jax_gpt2
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.inference.v2 import (DeepSpeedTPStateManagerConfig,
                                              RaggedInferenceEngineConfig,
                                              build_engine, generate)
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
from deepspeed_tpu_torch.models import llama_model
from deepspeed_tpu_torch.models.transformer import MoEConfig, TransformerConfig, TransformerLM
from tests.port_threads import torch_threads  # noqa: F401

V = 1024  # llama2-tiny vocabulary
TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE_KW = dict(kv_block_size=4, max_prefill_chunk=16)
SM_KW = dict(max_ragged_batch_size=64, max_ragged_sequence_count=8, max_context=64)


def _jax_engine(num_kv_blocks=257, params=None, model=None):
    model = model or jax_llama("llama2-tiny", dtype=jnp.float32, remat=False,
                               max_seq_len=64)
    cfg = JaxConfig(num_kv_blocks=num_kv_blocks, kv_cache_dtype=jnp.float32,
                    kv_pool_sharding="replicated", state_manager=JaxSM(**SM_KW),
                    **ENGINE_KW)
    eng = JaxEngine(model, config=cfg)
    if params is not None:
        eng.params = params
    return eng


def _port_engine(params, num_kv_blocks=257, model=None, **kw):
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=num_kv_blocks, kv_cache_dtype=torch.float32,
        state_manager=DeepSpeedTPStateManagerConfig(**SM_KW), **ENGINE_KW, **kw)
    model = model or llama_model("llama2-tiny", dtype=torch.float32, max_seq_len=64)
    return build_engine(model, cfg, params=params, device="cpu")


@pytest.fixture(scope="module")
def engines():
    jeng = _jax_engine()
    params = params_from_jax(jax.device_get(jeng.params))
    return jeng, _port_engine(params), params


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=n).astype(np.int32) for n in lengths]


def test_first_wave_logits_agree(engines):
    """A mixed first wave: one prompt longer than the prefill chunk (two
    waves), one shorter."""
    jeng, peng, _ = engines
    prompts = _prompts(0, (23, 9))
    want = jeng.put([1, 2], prompts)
    got = peng.put([1, 2], prompts)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for uid in (1, 2):
        jeng.flush(uid)
        peng.flush(uid)


def test_decode_step_logits_agree(engines):
    jeng, peng, _ = engines
    prompts = _prompts(1, (5, 11, 7))
    uids = [11, 12, 13]
    for eng in (jeng, peng):
        for uid, p in zip(uids, prompts):
            eng.put([uid], [p[:-1]])
    want = jeng.put(uids, [p[-1:] for p in prompts])
    got = peng.put(uids, [p[-1:] for p in prompts])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for uid in uids:
        jeng.flush(uid)
        peng.flush(uid)
    assert peng.state_manager.free_blocks == jeng.state_manager.free_blocks


def test_full_forward_matches_jax_apply(engines):
    jeng, peng, _ = engines
    ids = np.stack(_prompts(2, (12, 12)))
    want, _ = jax.jit(jeng.model.apply)(jeng.params, jnp.asarray(ids))
    got = peng.model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gpt2_style_model_matches_jax():
    """The other block layout the port carries: learned positions,
    LayerNorm with biases, tanh GELU, tied embeddings (gpt2-tiny), in the
    plain forward and in a served first wave."""
    jmodel = jax_gpt2("gpt2-tiny", dtype=jnp.float32, remat=False, max_seq_len=64)
    jeng = _jax_engine(model=jmodel)
    params = params_from_jax(jax.device_get(jeng.params))
    names = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype"}
    cfg = TransformerConfig(**{n: getattr(jmodel.config, n) for n in names},
                            dtype=torch.float32)
    peng = _port_engine(params, model=TransformerLM(cfg))
    ids = np.stack(_prompts(5, (12, 12)))
    want, _ = jax.jit(jmodel.apply)(jeng.params, jnp.asarray(ids))
    np.testing.assert_allclose(peng.model(torch.from_numpy(ids)).numpy(),
                               np.asarray(want), **TOL)
    prompts = _prompts(6, (19, 6))
    np.testing.assert_allclose(peng.put([1, 2], prompts),
                               np.asarray(jeng.put([1, 2], prompts)), **TOL)


@pytest.mark.parametrize("field,value", [("causal", False),
                                         ("mlm_head", True),
                                         ("norm_style", "post")])
def test_block_layouts_outside_the_port_raise(field, value):
    """A JAX config with an encoder's layout (bidirectional attention, the
    MLM head, post-norm), copied field by field as above, builds in the
    port: the JAX tree's keys, and logits equal to the JAX ``apply``'s. The
    serving engine refuses a bidirectional model with the JAX engine's
    ``ValueError``; the other two serve."""
    from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
    jcfg = dataclasses.replace(jax_gpt2("gpt2-tiny", max_seq_len=64).config,
                               dtype=jnp.float32, remat=False, **{field: value})
    names = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype"}
    cfg = TransformerConfig(**{n: getattr(jcfg, n) for n in names}, dtype=torch.float32)
    assert getattr(cfg, field) == value
    jm = JaxLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(3), jnp.float32)
    if field == "mlm_head":   # a bias the init leaves at zero
        jparams["mlm"]["bias"] = jnp.linspace(-1.0, 1.0, jcfg.vocab_size)
    state = params_from_jax(jax.device_get(jparams))
    model = TransformerLM(cfg, device="cpu")
    assert set(model.state_dict()) == set(state)
    model.load_state_dict(state)
    ids = np.stack(_prompts(8, (12, 12)))
    want, _ = jax.jit(jm.apply)(jparams, jnp.asarray(ids))
    got, _ = model.apply(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if field == "causal":
        with pytest.raises(ValueError, match="bidirectional encoders"):
            _port_engine(state, model=model)
    else:
        _port_engine(state, model=model)


def test_generate_greedy_tokens_identical(engines):
    """Default config: chunked prefill, mixed waves, then decode bursts."""
    jeng, peng, _ = engines
    prompts = [list(p) for p in _prompts(3, (5, 11, 7, 20))]
    want = jax_generate(jeng, prompts, max_new_tokens=10)
    assert generate(peng, prompts, max_new_tokens=10) == want
    assert peng.state_manager.free_blocks == jeng.state_manager.free_blocks


def test_single_token_steps_match_bursts(engines, monkeypatch):
    """decode_burst=1 (every decode a ragged wave) and the default bursts
    give the JAX engine's tokens."""
    jeng, _, params = engines
    prompts = [list(p) for p in _prompts(4, (6, 13))]
    want = jax_generate(jeng, prompts, max_new_tokens=9)
    single = _port_engine(params, decode_burst=1)
    bursts = []
    monkeypatch.setattr(single, "decode_burst",
                        lambda *a, **k: bursts.append(a) or None)
    assert generate(single, prompts, max_new_tokens=9) == want
    assert not bursts
    assert generate(_port_engine(params), prompts, max_new_tokens=9) == want


def test_preemption_offload_restore_identical(engines):
    """A 13-block pool forces preemption mid-generation: KV goes to host
    memory and back, and the tokens still match the JAX engine's."""
    jeng, _, params = engines
    prompts = [list(p) for p in _prompts(7, (8, 8, 8))]
    small_jax = _jax_engine(num_kv_blocks=13, params=jeng.params)
    want = jax_generate(small_jax, prompts, max_new_tokens=10, token_budget=32)
    small = _port_engine(params, num_kv_blocks=13)
    offloads, restores = [], []
    off, res = small.offload_sequence, small.restore_sequence
    small.offload_sequence = lambda uid: (offloads.append(uid), off(uid))[1]
    small.restore_sequence = lambda uid: (restores.append(uid), res(uid))[1]
    got = generate(small, prompts, max_new_tokens=10, token_budget=32)
    assert got == want
    assert offloads and sorted(restores) == sorted(offloads)


def test_sampled_generation_completes(engines):
    """temperature > 0: Gumbel-max sampling inside bursts (the draws
    differ from JAX's by construction; the counts and ranges do not)."""
    _, peng, _ = engines
    prompts = [list(p) for p in _prompts(8, (4, 9))]
    out = generate(peng, prompts, max_new_tokens=7, temperature=0.8)
    assert [len(o) for o in out] == [7, 7]
    assert all(0 <= t < V for o in out for t in o)


def test_allocator_matches_jax():
    ours, ref = BlockedAllocator(9), JaxAlloc(9)
    for n in (3, 2):
        assert ours.allocate(n) == ref.allocate(n)
    ours.free([2, 4])
    ref.free([2, 4])
    assert ours.allocate(3) == ref.allocate(3)
    assert ours.free_blocks == ref.free_blocks
    assert ours.total_blocks == ref.total_blocks
    for alloc in (ours, ref):
        with pytest.raises(ValueError):
            alloc.free([0])
        with pytest.raises(ValueError):
            alloc.allocate(99)


def test_kv_cache_offload_restore_matches_jax():
    shape = (2, 2, 16, 4, 8)
    rng = np.random.default_rng(9)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    ours = BlockedKVCache(2, 2, 8, 16, 4, dtype=torch.float32, device="cpu")
    ref = JaxKV(2, 2, 8, 16, 4, dtype=jnp.float32)
    ours.k_pages.copy_(torch.from_numpy(k0))
    ours.v_pages.copy_(torch.from_numpy(v0))
    ref.update(jnp.asarray(k0), jnp.asarray(v0))
    hk, hv = ours.offload([3, 5, 7])
    jk, jv = ref.offload([3, 5, 7])
    assert hk.shape == jk.shape == (2, 2, 4, 4, 8)  # padded to a power of two
    np.testing.assert_array_equal(hk.numpy(), jk)
    np.testing.assert_array_equal(hv.numpy(), jv)
    ours.restore(hk, hv, [9, 2, 11])
    ref.restore(jk, jv, [9, 2, 11])
    np.testing.assert_array_equal(ours.k_pages.numpy(), np.asarray(ref.k_pages))
    np.testing.assert_array_equal(ours.v_pages.numpy(), np.asarray(ref.v_pages))
    assert ours.host_bytes(3) == ref.host_bytes(3)
    assert ours.per_token_bytes == ref.per_token_bytes


def test_seeded_init_is_reproducible():
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=9, kv_cache_dtype=torch.float32,
        state_manager=DeepSpeedTPStateManagerConfig(**SM_KW), **ENGINE_KW)
    w = [build_engine(llama_model("llama2-tiny", dtype=torch.float32), cfg,
                      device="cpu", seed=s).model.blocks[1].q_proj.weight
         for s in (5, 5, 6)]
    assert torch.equal(w[0], w[1]) and not torch.equal(w[0], w[2])


@pytest.mark.parametrize("override", [
    dict(tensor_parallel_degree=2), dict(quantization_mode="wf6af16"),
    dict(kv_pool_sharding="data"), dict(kv_cache_dtype=torch.bfloat16)])
def test_unported_engine_configs_raise(override):
    """An unknown quantization mode is a ``ValueError``, as in JAX; what is
    left for later raises ``NotImplementedError`` naming its ROADMAP item."""
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=9, state_manager=DeepSpeedTPStateManagerConfig(**SM_KW),
        **{"kv_cache_dtype": torch.float32, **override})
    expected = (pytest.raises(ValueError, match="unknown quantization_mode")
                if "quantization_mode" in override
                else pytest.raises(NotImplementedError, match="ROADMAP"))
    with expected:
        build_engine(llama_model("llama2-tiny", dtype=torch.float32), cfg,
                     device="cpu")


@pytest.mark.parametrize("override", [
    dict(position="alibi"), dict(attn_windows=8), dict(moe=MoEConfig(num_experts=4, top_k=3))])
def test_unported_model_features_raise(override):
    """MoE is served; a top-3 route is not (the JAX kernel picks at most
    2). ALiBi and windowed models serve through the paged kernels: greedy
    tokens equal the argmax continuation of the plain full forward."""
    if "moe" in override:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TransformerLM(TransformerConfig(num_layers=1, hidden_size=32,
                                            num_heads=4, **override))
        return
    model = TransformerLM(TransformerConfig(num_layers=1, hidden_size=32, num_heads=4,
                                            max_seq_len=64, **override))
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=9, kv_cache_dtype=torch.float32,
        state_manager=DeepSpeedTPStateManagerConfig(**SM_KW), **ENGINE_KW)
    eng = build_engine(model, cfg, device="cpu")
    prompt = [int(t) for t in _prompts(9, (11,))[0] % model.config.vocab_size]
    got = generate(eng, [prompt], max_new_tokens=5)[0]
    ids = list(prompt)
    for _ in range(5):
        ids.append(int(eng.model(torch.tensor([ids]))[0, -1].argmax()))
    assert got == ids[len(prompt):]

def test_windowed_llama_greedy_tokens_match_the_jax_engine():
    """llama2-tiny with a sliding window of 8 on every layer: prompts past
    the window, chunked prefill and decode bursts, the same greedy tokens
    as the JAX engine (its XLA paged path)."""
    jeng = _jax_engine(model=jax_llama("llama2-tiny", dtype=jnp.float32, remat=False,
                                       max_seq_len=64, attn_windows=8))
    params = params_from_jax(jax.device_get(jeng.params))
    peng = _port_engine(params, model=llama_model("llama2-tiny", dtype=torch.float32,
                                                  max_seq_len=64, attn_windows=8))
    assert peng.model.windows == (8, 8)
    prompts = [list(p) for p in _prompts(10, (20, 9, 13))]
    want = jax_generate(jeng, prompts, max_new_tokens=10)
    assert generate(peng, prompts, max_new_tokens=10) == want
