"""The decoder families of the port (``models/gpt2.py``,
``opt_phi_falcon.py``, ``bloom_neox_gptj.py``) against the JAX package's,
on the CPU: JAX parameter trees drawn with numpy from a seed (no bias
zero and no norm scale one), carried across by
``convert.params_from_jax``; the same numpy batches on both sides; the JAX
side runs ``apply`` / ``loss`` / its engines as its own tests do (XLA
attention on the CPU), the port its plain kernel versions.

(a) every tiny preset: the config field for field, the state dict's keys
    equal to the JAX tree's, logits, loss and every parameter's gradient in
    fp32 (the engine suite's fp32 tolerance, ``test_torch_train_engine.py``:
    loss 1e-5 relative; logits and gradients 1e-4 relative, gradients with
    an absolute floor of 1e-5 x the largest gradient, since some are
    analytically zero, ``docs/KERNELS.md``);
(b) 3-step fp32 AdamW trajectories against the JAX engine (micro 1 on the
    8-device test mesh) for phi-tiny (a parallel block, partial rotary, a
    biased untied head) and bloom-tiny (ALiBi, the embedding norm);
(c) greedy tokens from ``build_engine`` + ``generate`` equal to the JAX
    engine's for phi-tiny, falcon-tiny (multi-query) and gpt-neox-tiny
    (a norm per parallel branch);
(d) BLOOM (ALiBi) and GPT-Neo (windows) serve: first-wave logits and
    greedy tokens equal the JAX engine's;
(e) a Phi tag the port saved loads in the JAX engine, and a BLOOM tag the
    JAX engine saved loads in the port, params equal;
(f) the plain flash forward and backward at head_dim 80, 96 and 256
    against the JAX Pallas kernel in interpret mode; a head_dim that
    ``pallas_flash.supports`` refuses (136: past 128 and no multiple of it)
    makes the port's kernel gate raise, while the plain version computes it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import models as jmodels
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2 import generate as jax_generate
from deepspeed_tpu.inference.v2.config_v2 import DeepSpeedTPStateManagerConfig as JaxSM
from deepspeed_tpu.ops.transformer import pallas_flash as jflash
from deepspeed_tpu_torch import models as tmodels
from deepspeed_tpu_torch.convert import params_from_jax, params_to_jax
from deepspeed_tpu_torch.inference.v2 import (DeepSpeedTPStateManagerConfig,
                                              RaggedInferenceEngineConfig,
                                              build_engine, generate)
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.ops.transformer import flash as tflash
from tests.port_threads import torch_threads  # noqa: F401

# preset -> (JAX model function, the port's)
FAMILIES = {
    "gpt2-tiny": (jmodels.gpt2_model, tmodels.gpt2_model),
    "opt-tiny": (jmodels.opt_model, tmodels.opt_model),
    "phi-tiny": (jmodels.phi_model, tmodels.phi_model),
    "falcon-tiny": (jmodels.falcon_model, tmodels.falcon_model),
    "bloom-tiny": (jmodels.bloom_model, tmodels.bloom_model),
    "gpt-neox-tiny": (jmodels.gpt_neox_model, tmodels.gpt_neox_model),
    "gpt-neo-tiny": (jmodels.gpt_neo_model, tmodels.gpt_neo_model),
    "gptj-tiny": (jmodels.gptj_model, tmodels.gptj_model),
}
S = 32   # gpt-neo-tiny's window of 8 binds
ADAMW = {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}}
CFG = {"optimizer": ADAMW, "gradient_clipping": 1.0}
ENGINE_KW = dict(kv_block_size=4, max_prefill_chunk=16)
SM_KW = dict(max_ragged_batch_size=64, max_ragged_sequence_count=8, max_context=64)
# XLA's CPU codegen at its lowest effort: these tiny programs would take
# longer to compile than to run at the default level
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _models(preset, **kw):
    jfn, tfn = FAMILIES[preset]
    return (jfn(preset, dtype=jnp.float32, remat=False, **kw),
            tfn(preset, dtype=torch.float32, remat=False, **kw))


def _params(jm, seed):
    """A JAX params tree of ``jm``'s shapes (``jax.eval_shape`` of ``init``:
    nothing compiled), its values from numpy: norm scales 1 + N(0, 0.05),
    every other leaf N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.float32))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(float(path[-1].key == "scale")
                                    + 0.05 * rng.standard_normal(s.shape), jnp.float32),
        shapes)


def _batch(vocab, seed, B=2):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


# -- (a) every tiny preset against JAX apply / loss / grad -----------------------------


@pytest.mark.parametrize("preset", list(FAMILIES))
def test_tiny_preset_matches_jax(preset):
    jm, tm = _models(preset)
    names = [f.name for f in dataclasses.fields(TransformerConfig) if f.name != "dtype"]
    assert {n: getattr(tm.config, n) for n in names} == \
        {n: getattr(jm.config, n) for n in names}
    params = _params(jm, seed=1)
    state = params_from_jax(jax.device_get(params))
    assert set(tm.state_dict()) == set(state)
    tm.to_empty(device="cpu").load_state_dict(state)
    for p in tm.parameters():
        p.requires_grad_(True)

    ids = _batch(jm.config.vocab_size, seed=2)
    batch = {"input_ids": jnp.asarray(ids)}
    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(
        lambda p: (jm.loss(p, batch), jm.apply(p, batch["input_ids"])[0]),
        has_aux=True)).lower(params).compile(FAST_COMPILE)(params)
    got_logits, _ = tm.apply(torch.from_numpy(ids))
    got_loss = tm.loss({"input_ids": torch.from_numpy(ids)})
    got_loss.backward()
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_g = params_from_jax(jax.device_get(want_grads))
    floor = 1e-5 * max(float(g.abs().max()) for g in want_g.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=1e-4,
                                   atol=floor, err_msg=name)


# -- (b) and (e) trajectories and tags against the JAX engine ---------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """For phi-tiny and bloom-tiny: the JAX engine (micro 1 on the 8-device
    mesh) and the port (micro 8) from the same params, 3 steps each on one
    batch; phi-tiny's port tag loaded by the JAX engine, bloom-tiny's JAX
    tag loaded by a port engine of another seed."""
    out = {}
    for preset in ("phi-tiny", "bloom-tiny"):
        d = tmp_path_factory.mktemp(preset)
        jm, tm = _models(preset)
        params = _params(jm, seed=3)
        jeng, *_ = deepspeed_tpu.initialize(
            model=jm, config=dict(CFG, train_micro_batch_size_per_gpu=1),
            model_parameters=params)
        init = params_from_jax(jax.device_get(params))
        peng, *_ = deepspeed_tpu_torch.initialize(
            model=tm, config=dict(CFG, train_micro_batch_size_per_gpu=8),
            model_parameters=init, device="cpu")
        batch = {"input_ids": _batch(jm.config.vocab_size, seed=4, B=8)}
        r = out[preset] = dict(
            jax=[float(jeng.train_batch(batch)) for _ in range(3)],
            port=[float(peng.train_batch(batch)) for _ in range(3)])
        if preset == "phi-tiny":
            peng.save_checkpoint(str(d))
            jeng.load_checkpoint(str(d))
            r["saved"] = {k: v.clone() for k, v in peng.module_state_dict().items()}
            r["loaded"] = params_from_jax(jax.device_get(jeng.state["params"]))
        else:
            jeng.save_checkpoint(str(d))
            other, *_ = deepspeed_tpu_torch.initialize(
                model=_models(preset)[1], config=dict(CFG, train_micro_batch_size_per_gpu=8),
                device="cpu", seed=5)
            other.load_checkpoint(str(d))
            r["saved"] = params_from_jax(jax.device_get(jeng.state["params"]))
            r["loaded"] = {k: v.clone() for k, v in other.module_state_dict().items()}
    return out


@pytest.mark.parametrize("preset", ["phi-tiny", "bloom-tiny"])
def test_train_trajectory_matches_the_jax_engine(trained, preset):
    r = trained[preset]
    np.testing.assert_allclose(r["port"], r["jax"], rtol=1e-5, atol=0)
    assert r["port"][-1] < r["port"][0]


@pytest.mark.parametrize("preset", ["phi-tiny", "bloom-tiny"])
def test_tags_load_in_the_other_package(trained, preset):
    """phi-tiny: port -> JAX; bloom-tiny: JAX -> port. The loaded params
    equal the saved ones, leaf for leaf, and the tree has no ``ln_2`` for
    phi (one norm a parallel block) and an ``ln_emb`` for bloom."""
    r = trained[preset]
    assert r["saved"].keys() == r["loaded"].keys()
    for k in r["saved"]:
        assert torch.equal(r["saved"][k], r["loaded"][k]), k
    tree = params_to_jax(r["saved"])
    assert ("ln_2" in tree["blocks"]) == (preset == "bloom-tiny")
    assert ("ln_emb" in tree) == (preset == "bloom-tiny")


# -- (c) and (d) serving ---------------------------------------------------------------


def _jax_engine(jm, params):
    """The JAX engine, decoding a token a wave (its tokens do not depend on
    the burst length, ``test_torch_engine_v2.py``; one program fewer to
    compile)."""
    cfg = JaxConfig(num_kv_blocks=257, kv_cache_dtype=jnp.float32,
                    kv_pool_sharding="replicated", state_manager=JaxSM(**SM_KW),
                    decode_burst=1, **ENGINE_KW)
    return JaxEngine(jm, config=cfg, params=params)


def _port_config():
    return RaggedInferenceEngineConfig(
        num_kv_blocks=257, kv_cache_dtype=torch.float32,
        state_manager=DeepSpeedTPStateManagerConfig(**SM_KW), **ENGINE_KW)


@pytest.mark.parametrize("preset", ["phi-tiny", "falcon-tiny", "gpt-neox-tiny"])
def test_generate_greedy_tokens_match_the_jax_engine(preset):
    jm, tm = _models(preset)
    params = _params(jm, seed=6)
    jeng = _jax_engine(jm, params)
    peng = build_engine(tm, _port_config(), params=params_from_jax(jax.device_get(params)),
                        device="cpu")
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, jm.config.vocab_size, size=n)) for n in (5, 9)]
    want = jax_generate(jeng, prompts, max_new_tokens=4)
    assert generate(peng, prompts, max_new_tokens=4) == want


@pytest.mark.parametrize("preset", ["bloom-tiny", "gpt-neo-tiny"])
def test_alibi_and_windowed_serving_raise(preset):
    """BLOOM (ALiBi) and GPT-Neo (a window of 8 on its second layer) serve:
    the first wave's logits (prompts past the window, one spanning two
    prefill chunks) and the greedy tokens equal the JAX engine's, whose
    paged programs take its XLA path for them."""
    jm, tm = _models(preset)
    params = _params(jm, seed=8)
    jeng = _jax_engine(jm, params)
    peng = build_engine(tm, _port_config(), params=params_from_jax(jax.device_get(params)),
                        device="cpu")
    rng = np.random.default_rng(9)
    prompts = [list(rng.integers(0, jm.config.vocab_size, size=n)) for n in (13, 21)]
    np.testing.assert_allclose(peng.put([1, 2], prompts), np.asarray(jeng.put([1, 2], prompts)),
                               rtol=1e-4, atol=1e-4)
    for uid in (1, 2):
        peng.flush(uid)
        jeng.flush(uid)
    want = jax_generate(jeng, prompts, max_new_tokens=6)
    assert generate(peng, prompts, max_new_tokens=6) == want


# -- (f) the plain flash versions at the new head dims ----------------------------------


@pytest.fixture
def _pallas_compiler_params(monkeypatch):
    """The JAX kernel names ``pltpu.TPUCompilerParams``, which newer JAX
    releases call ``pltpu.CompilerParams``."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


@pytest.mark.parametrize("D", [80, 96, 256])
def test_flash_plain_versions_at_new_head_dims(D, _pallas_compiler_params):
    """O, LSE and dQ / dK / dV (through dO and a cotangent on the LSE), fp32,
    GQA 2 on 1, 40 tokens, at the JAX flash suite's tolerances."""
    rng = np.random.default_rng(D)
    B, Sq, H, kvH = 1, 40, 2, 1
    arr = lambda *shape: (rng.normal(size=shape) * 0.3).astype(np.float32)
    q, k, v, do = arr(B, Sq, H, D), arr(B, Sq, kvH, D), arr(B, Sq, kvH, D), arr(B, Sq, H, D)
    dlse = arr(B, H, Sq)
    f = lambda q_, k_, v_: jflash.flash_attention_with_lse(
        q_, k_, v_, causal=True, block_q=40, block_k=40, interpret=True)
    (o, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [o, lse, *vjp((jnp.asarray(do), jnp.asarray(dlse)))]
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got_o, got_lse = tflash.flash_attention_with_lse(tq, tk, tv, causal=True)
    torch.autograd.backward([got_o, got_lse], [torch.from_numpy(do), torch.from_numpy(dlse)])
    got = [got_o, got_lse, tq.grad, tk.grad, tv.grad]
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=["o", "lse", "dq", "dk", "dv"][i],
                                   **(dict(rtol=2e-5, atol=5e-6) if i < 2
                                      else dict(rtol=5e-5, atol=5e-6)))
    assert tflash.head_dim_ok(D)


def test_other_head_dims_raise_naming_b10():
    """head_dim 136: the JAX shape gate refuses it, and the port's kernel
    gate raises a ValueError that says so; the plain version (CPU tensors)
    still computes it, as the JAX package's XLA attention does."""
    assert not jflash.supports((1, 4, 2, 136), (1, 4, 2, 136), compiled=False)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 2, 136, generator=g) for _ in range(3))
    out, lse = tflash.flash_attention_with_lse(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 136 ** 0.5
    s = s.masked_fill(~torch.ones(4, 4, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, s.logsumexp(-1), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="pallas_flash.supports refuses 136"):
        tflash._check(q, k, v)
