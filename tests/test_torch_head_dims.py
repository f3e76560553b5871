"""open-llama-3b's head_dim on the CPU, end to end: a 2-layer llama of
hidden 200 and 2 heads, head_dim 100 like the full-width preset (26 layers,
hidden 3200, 32 heads), against the JAX package's engines on the same
numpy-drawn params and batches.

- training: 3 fp32 AdamW steps through ``deepspeed_tpu_torch.initialize`` +
  ``train_batch`` (micro 8) against the JAX engine (micro 1 on the 8-device
  test mesh), at the engine suite's fp32 tolerance (1e-5 relative); the
  port's flash attention runs at head_dim 100 in every block;
- serving: greedy tokens from ``build_engine`` + ``generate`` equal to the
  JAX engine's (``InferenceEngineV2`` + ``generate``), both paged kernels'
  wrappers called at head_dim 100.

On the CPU the port runs its kernels' plain versions; ``chip_smoke.py``
drives open-llama-3b itself through the CUDA kernels (``[open-llama]``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import models as jmodels
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2 import generate as jax_generate
from deepspeed_tpu.inference.v2.config_v2 import DeepSpeedTPStateManagerConfig as JaxSM
from deepspeed_tpu_torch import models as tmodels
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.inference.v2 import (DeepSpeedTPStateManagerConfig,
                                              RaggedInferenceEngineConfig,
                                              build_engine, generate)
from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as tpd
from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as trpa
from deepspeed_tpu_torch.ops.transformer import flash as tflash
from tests.port_threads import torch_threads  # noqa: F401

# open-llama-3b's head_dim (3200 / 32) at 2 layers and 2 heads
WIDTHS = dict(num_layers=2, hidden_size=200, num_heads=2, num_kv_heads=2,
              intermediate_size=352, max_seq_len=64, vocab_size=256)
S = 32
CFG = {"optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
       "gradient_clipping": 1.0}
ENGINE_KW = dict(kv_block_size=4, max_prefill_chunk=16)
SM_KW = dict(max_ragged_batch_size=64, max_ragged_sequence_count=8, max_context=64)


def _models():
    return (jmodels.llama_model("llama2-tiny", dtype=jnp.float32, remat=False, **WIDTHS),
            tmodels.llama_model("llama2-tiny", dtype=torch.float32, remat=False, **WIDTHS))


def _params(jm, seed):
    """A JAX params tree of ``jm``'s shapes, its values from numpy: norm
    scales 1 + N(0, 0.05), every other leaf N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.float32))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(float(path[-1].key == "scale")
                                    + 0.05 * rng.standard_normal(s.shape), jnp.float32),
        shapes)


def test_config_has_open_llama_head_dim():
    jm, tm = _models()
    assert tm.config.head_dim == jm.config.head_dim == 100
    full = tmodels.llama_config("open-llama-3b")
    assert full.head_dim == 100 and full.num_layers == 26


def test_training_losses_match_the_jax_engine(monkeypatch):
    """3 AdamW steps on one batch: the losses within 1e-5 relative of the
    JAX engine's, falling; every forward of the port's flash at head_dim
    100."""
    jm, tm = _models()
    params = _params(jm, seed=3)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, config=dict(CFG, train_micro_batch_size_per_gpu=1),
        model_parameters=params)
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=tm, config=dict(CFG, train_micro_batch_size_per_gpu=8),
        model_parameters=params_from_jax(jax.device_get(params)), device="cpu")
    dims = []
    fwd = tflash.flash_fwd

    def flash_fwd(q, k, v, spec):
        dims.append(q.shape[-1])
        return fwd(q, k, v, spec)
    monkeypatch.setattr(tflash, "flash_fwd", flash_fwd)
    batch = {"input_ids": np.random.default_rng(4).integers(0, WIDTHS["vocab_size"],
                                                            size=(8, S))}
    want = [float(jeng.train_batch(batch)) for _ in range(3)]
    got = [float(peng.train_batch(batch)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    assert dims and set(dims) == {100}


def test_generate_greedy_tokens_match_the_jax_engine(monkeypatch):
    """Two prompts, 4 new tokens each: the port's engine gives the JAX
    engine's greedy tokens; its waves and decode steps call both paged
    kernels' wrappers at head_dim 100."""
    jm, tm = _models()
    params = _params(jm, seed=6)
    jeng = JaxEngine(jm, params=params, config=JaxConfig(
        num_kv_blocks=257, kv_cache_dtype=jnp.float32, kv_pool_sharding="replicated",
        state_manager=JaxSM(**SM_KW), decode_burst=1, **ENGINE_KW))
    peng = build_engine(tm, RaggedInferenceEngineConfig(
        num_kv_blocks=257, kv_cache_dtype=torch.float32,
        state_manager=DeepSpeedTPStateManagerConfig(**SM_KW), **ENGINE_KW),
        params=params_from_jax(jax.device_get(params)), device="cpu")
    seen = {"wave": set(), "decode": set()}
    wave, decode = trpa.ragged_paged_attention_reference, tpd.paged_decode_attention_reference

    def wave_dims(q, *a, **kw):
        seen["wave"].add(q.shape[-1])
        return wave(q, *a, **kw)

    def decode_dims(q, *a, **kw):
        seen["decode"].add(q.shape[-1])
        return decode(q, *a, **kw)
    monkeypatch.setattr(trpa, "ragged_paged_attention_reference", wave_dims)
    monkeypatch.setattr(tpd, "paged_decode_attention_reference", decode_dims)
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, WIDTHS["vocab_size"], size=n)) for n in (5, 9)]
    want = jax_generate(jeng, prompts, max_new_tokens=4)
    assert generate(peng, prompts, max_new_tokens=4) == want
    assert seen == {"wave": {100}, "decode": {100}}


@pytest.mark.parametrize("D", [100, 16, 33])
def test_head_dims_reach_the_kernels_unrefused(D):
    """The kernels' argument checks take the head dims of open-llama-3b,
    the tiny presets and odd ones on tensors of the shapes the engines give
    them: flash's (no ``NotImplementedError`` naming B10) and both paged
    kernels' (no multiple-of-8 ``ValueError``)."""
    x = torch.zeros(1, 8, 2, D)
    tflash._check(x, x, x)
    pool = torch.zeros(2, 5, 4, D)
    trpa.check_kernel_args(torch.zeros(3, 2, D), pool, pool, (
        ("kv_lens", torch.zeros(1, dtype=torch.int32)),
        ("page_indices", torch.zeros(1, 2, dtype=torch.int32)),
        ("cu_q_lens", torch.zeros(2, dtype=torch.int32))))
