"""OPT / Phi / Falcon presets (counterpart of
``deepspeed_tpu/models/opt_phi_falcon.py``; the port keeps its own copy of
the preset tables):

- **OPT**: ReLU MLP, learned positions with the HF +2 padding offset, tied
  embeddings, pre-LN;
- **Phi**: a parallel attention + MLP block from one LayerNorm, partial
  rotary (the first ``rope_dim`` dims of each head), an untied head with a
  bias;
- **Falcon**: a parallel block, rotary, LayerNorm with bias-free linears,
  multi-query / grouped KV attention, tied embeddings (falcon-40b: a norm
  per parallel branch).
"""

from __future__ import annotations

import torch

from .transformer import TransformerConfig, TransformerLM

_OPT_PRESETS = {
    "opt-tiny": dict(num_layers=2, num_heads=4, hidden_size=64,
                     intermediate_size=256, max_seq_len=64, vocab_size=256),
    "opt-125m": dict(num_layers=12, num_heads=12, hidden_size=768,
                     intermediate_size=3072, max_seq_len=2048),
    "opt-1.3b": dict(num_layers=24, num_heads=32, hidden_size=2048,
                     intermediate_size=8192, max_seq_len=2048),
    "opt-6.7b": dict(num_layers=32, num_heads=32, hidden_size=4096,
                     intermediate_size=16384, max_seq_len=2048),
    "opt-13b": dict(num_layers=40, num_heads=40, hidden_size=5120,
                    intermediate_size=20480, max_seq_len=2048),
    "opt-30b": dict(num_layers=48, num_heads=56, hidden_size=7168,
                    intermediate_size=28672, max_seq_len=2048),
}

_PHI_PRESETS = {
    "phi-tiny": dict(num_layers=2, num_heads=4, hidden_size=64,
                     intermediate_size=256, max_seq_len=64, vocab_size=256,
                     rope_dim=8),
    "phi-1_5": dict(num_layers=24, num_heads=32, hidden_size=2048,
                    intermediate_size=8192, max_seq_len=2048, vocab_size=51200,
                    rope_dim=32),
    "phi-2": dict(num_layers=32, num_heads=32, hidden_size=2560,
                  intermediate_size=10240, max_seq_len=2048, vocab_size=51200,
                  rope_dim=32),
}

_FALCON_PRESETS = {
    "falcon-tiny": dict(num_layers=2, num_heads=4, num_kv_heads=1,
                        hidden_size=64, intermediate_size=256,
                        max_seq_len=64, vocab_size=256),
    "falcon-7b": dict(num_layers=32, num_heads=71, num_kv_heads=1,
                      hidden_size=4544, intermediate_size=18176,
                      max_seq_len=2048, vocab_size=65024),
    "falcon-40b": dict(num_layers=60, num_heads=128, num_kv_heads=8,
                       hidden_size=8192, intermediate_size=32768,
                       max_seq_len=2048, vocab_size=65024,
                       parallel_norms=True),
}


def opt_config(preset: str = "opt-125m", dtype: torch.dtype = torch.bfloat16,
               **overrides) -> TransformerConfig:
    base = dict(vocab_size=50272, activation="relu", norm="layernorm",
                position="learned", position_offset=2, tie_embeddings=True,
                dtype=dtype)
    base.update(_OPT_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def opt_model(preset: str = "opt-125m", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(opt_config(preset, **overrides), device=device)


def phi_config(preset: str = "phi-2", dtype: torch.dtype = torch.bfloat16,
               **overrides) -> TransformerConfig:
    base = dict(activation="gelu", norm="layernorm", position="rope",
                parallel_block=True, tie_embeddings=False, lm_head_bias=True,
                dtype=dtype)
    base.update(_PHI_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def phi_model(preset: str = "phi-2", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(phi_config(preset, **overrides), device=device)


def falcon_config(preset: str = "falcon-7b", dtype: torch.dtype = torch.bfloat16,
                  **overrides) -> TransformerConfig:
    base = dict(activation="gelu_exact", norm="layernorm", position="rope",
                parallel_block=True, linear_bias=False, tie_embeddings=True,
                dtype=dtype)
    base.update(_FALCON_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def falcon_model(preset: str = "falcon-7b", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(falcon_config(preset, **overrides), device=device)
