"""Mixtral served by the port against the JAX engine: mixtral-tiny (2 layers,
4 experts, top-2), fp32, the JAX parameters carried across by
``convert.params_from_jax``, the port on the CPU (the plain versions of its
attention and MoE kernels), the same numpy prompts on both sides.

- ``params_from_jax`` of a MoE tree: the stacked bare-array leaves land in
  ``blocks.{l}.moe.*``, the expert weights transposed into the ``[out,
  in]`` layout, bf16 bits kept;
- the plain forward against the JAX ``apply`` (capacity factor 1.25, the
  training function) and, with ``dropless=True``, against the JAX
  ``apply`` of a dropless-configured model: 2e-4 (the JAX test's bound);
- served logits (a first wave, decode steps) against that dropless
  forward and against the JAX engine: 2e-4;
- ``generate`` greedy tokens identical to the JAX engine's, through
  chunked prefill, mixed waves and decode bursts, and with single-token
  decode steps;
- serving builds its MoE forwards without aux; asked for it, the layers'
  aux adds up to the JAX ``apply``'s;
- a seeded meta-device model is placed and served;
- MoE training and MoE under weight-only quantization raise, naming their
  ROADMAP items.

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

import deepspeed_tpu_torch
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2 import generate as jax_generate
from deepspeed_tpu.inference.v2.config_v2 import DeepSpeedTPStateManagerConfig as JaxSM
from deepspeed_tpu.models import mixtral_model as jax_mixtral
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.inference.v2 import (DeepSpeedTPStateManagerConfig,
                                              RaggedInferenceEngineConfig,
                                              build_engine, generate)
from deepspeed_tpu_torch.models import mixtral_model
from deepspeed_tpu_torch.ops.transformer import moe as moe_ops
from tests.port_threads import torch_threads  # noqa: F401

V = 1024  # mixtral-tiny vocabulary
TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE_KW = dict(kv_block_size=4, max_prefill_chunk=16)
SM_KW = dict(max_ragged_batch_size=64, max_ragged_sequence_count=8, max_context=64)


def _jax_model(**kw):
    return jax_mixtral("mixtral-tiny", dtype=jnp.float32, remat=False, max_seq_len=64, **kw)


def _jax_engine(**kw):
    cfg = JaxConfig(num_kv_blocks=257, kv_cache_dtype=jnp.float32,
                    kv_pool_sharding="replicated", state_manager=JaxSM(**SM_KW),
                    **ENGINE_KW, **kw)
    return JaxEngine(_jax_model(), config=cfg)


def _port_config(**kw):
    return RaggedInferenceEngineConfig(
        num_kv_blocks=257, kv_cache_dtype=torch.float32,
        state_manager=DeepSpeedTPStateManagerConfig(**SM_KW), **ENGINE_KW, **kw)


def _port_engine(params, **kw):
    model = mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=64)
    return build_engine(model, _port_config(**kw), params=params, device="cpu")


@pytest.fixture(scope="module")
def engines():
    jeng = _jax_engine()
    params = params_from_jax(jax.device_get(jeng.params))
    return jeng, _port_engine(params), params


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=n).astype(np.int32) for n in lengths]


def _dropless_apply(jeng, ids):
    """The JAX test's serving reference: the same weights applied through a
    dropless-configured model (``test_engine_v2.py:149-172``)."""
    m = jeng.model
    dropless = _jax_model(moe=dataclasses.replace(
        m.config.moe, capacity_factor=float(m.config.moe.num_experts), min_capacity=1))
    logits, _ = jax.jit(dropless.apply)(jeng.params, jnp.asarray(ids))
    return np.asarray(logits)


def test_params_from_jax_moe_tree(engines):
    jeng, _, params = engines
    blocks = jax.device_get(jeng.params)["blocks"]["moe"]
    assert set(blocks) == {"gate", "wi_gate", "wi_up", "wo"}
    for l in range(2):
        np.testing.assert_array_equal(params[f"blocks.{l}.moe.gate"].numpy(), blocks["gate"][l])
        for name in ("wi_gate", "wi_up", "wo"):
            got = params[f"blocks.{l}.moe.{name}"]
            assert got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), np.swapaxes(blocks[name][l], -1, -2))
    assert tuple(params["blocks.0.moe.wi_gate"].shape) == (4, 256, 128)
    assert tuple(params["blocks.0.moe.wo"].shape) == (4, 128, 256)
    # bf16 leaves keep their bits
    bf = {"blocks": {"moe": {"wo": np.asarray(jnp.asarray(blocks["wo"], jnp.bfloat16))}}}
    got = params_from_jax(bf)["blocks.1.moe.wo"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.swapaxes(bf["blocks"]["moe"]["wo"][1], -1, -2)
                                  .view(np.int16))
    with pytest.raises(KeyError, match="unknown JAX MoE leaf"):
        params_from_jax({"blocks": {"moe": {"router": blocks["gate"]}}})


def test_forward_matches_jax_apply(engines):
    """``dropless=False`` is the JAX ``apply`` (capacity factor 1.25 over
    all B * S tokens, choices dropped); ``dropless=True`` its dropless
    model."""
    jeng, peng, _ = engines
    ids = np.stack(_prompts(2, (24, 24)))
    want, _ = jax.jit(jeng.model.apply)(jeng.params, jnp.asarray(ids))
    got = peng.model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = peng.model(torch.from_numpy(ids), dropless=True)
    np.testing.assert_allclose(got.numpy(), _dropless_apply(jeng, ids), **TOL)


def test_prefill_matches_dropless_forward(engines):
    """The JAX engine test's check on the port: a 23-token prompt (two
    prefill waves) against the dropless forward."""
    jeng, peng, _ = engines
    toks = _prompts(21, (23,))[0]
    out = peng.put([81], [toks])
    np.testing.assert_allclose(out[0], _dropless_apply(jeng, toks[None])[0, -1], **TOL)
    np.testing.assert_allclose(out[0], jeng.put([81], [toks])[0], **TOL)
    peng.flush(81)
    jeng.flush(81)


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


def test_generate_greedy_tokens_identical(engines):
    """Chunked prefill, mixed waves, then decode bursts."""
    jeng, peng, _ = engines
    prompts = [list(p) for p in _prompts(3, (7, 12, 9, 20))]
    want = jax_generate(jeng, prompts, max_new_tokens=10)
    got = generate(peng, prompts, max_new_tokens=10)
    assert [list(map(int, g)) for g in got] == [list(map(int, w)) for w in want]
    assert all(len(g) == 10 for g in got)


def test_generate_single_step_decode_identical():
    """``decode_burst=1``: every decode token is a wave of its own."""
    jeng = _jax_engine(decode_burst=1)
    peng = _port_engine(params_from_jax(jax.device_get(jeng.params)), decode_burst=1)
    prompts = [list(p) for p in _prompts(4, (6, 13))]
    want = jax_generate(jeng, prompts, max_new_tokens=6)
    got = generate(peng, prompts, max_new_tokens=6)
    assert [list(map(int, g)) for g in got] == [list(map(int, w)) for w in want]


def test_serving_runs_through_the_moe_wrappers(engines):
    """Every wave and decode step routes, gathers and runs the FFN once a
    layer: the wrappers the kernels sit behind (their plain versions here)."""
    _, peng, _ = engines
    calls = []
    orig = moe_ops.make_moe_forward

    def counted(**kw):
        fwd = orig(**kw)
        return lambda p, x: (calls.append((x.shape[0], kw["capacity"])), fwd(p, x))[1]

    moe_ops.make_moe_forward = counted
    try:
        peng.put([90], [_prompts(5, (9,))[0]])
    finally:
        moe_ops.make_moe_forward = orig
    peng.flush(90)
    assert calls == [(16, 16)] * 2   # one 16-row padded wave, 2 layers, dropless


def test_serving_asks_for_no_aux_and_the_asked_aux_matches_jax_apply(engines, monkeypatch):
    """``Block.mlp`` (serving and the plain forward) builds its MoE forward
    without aux, which the JAX serving program drops as dead code; built
    with aux, the layers' aux adds up to the JAX ``apply``'s over the same
    tokens (capacity factor 1.25)."""
    jeng, peng, _ = engines
    ids = np.stack(_prompts(2, (24, 24)))
    _, want = jax.jit(jeng.model.apply)(jeng.params, jnp.asarray(ids))
    asked, auxes = [], []
    orig = moe_ops.make_moe_forward

    def with_aux_recorded(with_aux=True, **kw):
        asked.append(with_aux)
        fwd = orig(with_aux=True, **kw)
        return lambda p, x: (auxes.append(fwd(p, x)[1]), fwd(p, x))[1]

    monkeypatch.setattr(moe_ops, "make_moe_forward", with_aux_recorded)
    peng.model(torch.from_numpy(ids))
    assert asked == [False, False]
    np.testing.assert_allclose(float(sum(auxes)), float(want), rtol=1e-5)


def test_seeded_meta_model_is_placed_and_serves():
    model = mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=64)
    assert all(p.is_meta for p in model.parameters())
    eng = build_engine(model, _port_config(), device="cpu", seed=3)
    assert not any(p.is_meta for p in eng.model.parameters())
    again = build_engine(mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=64),
                         _port_config(), device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(eng.model.parameters(),
                                                 again.model.parameters()))
    out = generate(eng, [list(p) for p in _prompts(6, (5, 9))], max_new_tokens=4)
    assert [len(o) for o in out] == [4, 4]


def test_moe_training_raises():
    """The doors that raised before MoE training was ported (``initialize``,
    ``apply`` and ``loss`` on mixtral-tiny) now run: a finite loss with
    the aux term, a positive aux from ``apply``, and a step through the
    engine (``tests/test_torch_moe_training.py`` holds them to JAX)."""
    model = mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=64)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_micro_batch_size_per_gpu": 1,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    assert np.isfinite(float(engine.train_batch({"input_ids": ids})))
    model = mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=64)
    model.materialize("cpu")
    logits, aux = model.apply(ids)
    assert logits.shape == (1, 8, 1024) and float(aux) > 0
    loss = model.loss({"input_ids": ids})
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_moe_under_woq_raises(mode):
    model = mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=64)
    with pytest.raises(NotImplementedError, match="ROADMAP A5: MoE under WOQ"):
        build_engine(model, _port_config(quantization_mode=mode), device="cpu")
