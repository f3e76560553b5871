"""BLOOM / GPT-NeoX / GPT-Neo / GPT-J presets (counterpart of
``deepspeed_tpu/models/bloom_neox_gptj.py``; the port keeps its own copy of
the preset tables):

- **BLOOM**: ALiBi in place of position embeddings, a LayerNorm right after
  the word embeddings, sequential blocks, a tied head;
- **GPT-NeoX**: a parallel attention + MLP block with a norm a branch,
  partial rotary, an untied head;
- **GPT-Neo**: alternating global and local (windowed) layers, unscaled
  attention logits, bias-free q / k / v with a biased out_proj;
- **GPT-J**: a parallel block from one norm, partial interleaved rotary,
  bias-free attention with a biased MLP, an untied head with a bias.

Every family trains and serves: both paged kernels take BLOOM's ALiBi
slopes and GPT-Neo's windows.
"""

from __future__ import annotations

import torch

from .transformer import TransformerConfig, TransformerLM

_BLOOM_PRESETS = {
    "bloom-tiny": dict(num_layers=2, num_heads=4, hidden_size=64,
                       max_seq_len=64, vocab_size=256),
    "bloom-560m": dict(num_layers=24, num_heads=16, hidden_size=1024),
    "bloom-7b1": dict(num_layers=30, num_heads=32, hidden_size=4096),
    "bloom-176b": dict(num_layers=70, num_heads=112, hidden_size=14336),
}

_NEOX_PRESETS = {
    "gpt-neox-tiny": dict(num_layers=2, num_heads=4, hidden_size=64,
                          intermediate_size=256, max_seq_len=64,
                          vocab_size=256, rope_dim=4),
    "pythia-1b": dict(num_layers=16, num_heads=8, hidden_size=2048,
                      intermediate_size=8192, max_seq_len=2048,
                      vocab_size=50304, rope_dim=64),
    "gpt-neox-20b": dict(num_layers=44, num_heads=64, hidden_size=6144,
                         intermediate_size=24576, max_seq_len=2048,
                         vocab_size=50432, rope_dim=24),
}

_GPTJ_PRESETS = {
    "gptj-tiny": dict(num_layers=2, num_heads=4, hidden_size=64,
                      intermediate_size=256, max_seq_len=64, vocab_size=256,
                      rope_dim=8),
    "gpt-j-6b": dict(num_layers=28, num_heads=16, hidden_size=4096,
                     intermediate_size=16384, max_seq_len=2048,
                     vocab_size=50400, rope_dim=64),
}

_GPT_NEO_PRESETS = {
    "gpt-neo-tiny": dict(num_layers=2, num_heads=4, hidden_size=64,
                         intermediate_size=256, max_seq_len=64,
                         vocab_size=256, attn_windows=(0, 8)),
    "gpt-neo-1.3b": dict(num_layers=24, num_heads=16, hidden_size=2048,
                         intermediate_size=8192, max_seq_len=2048,
                         attn_windows=tuple(0 if i % 2 == 0 else 256
                                            for i in range(24))),
    "gpt-neo-2.7b": dict(num_layers=32, num_heads=20, hidden_size=2560,
                         intermediate_size=10240, max_seq_len=2048,
                         attn_windows=tuple(0 if i % 2 == 0 else 256
                                            for i in range(32))),
}


def bloom_config(preset: str = "bloom-7b1", dtype: torch.dtype = torch.bfloat16,
                 **overrides) -> TransformerConfig:
    base = dict(vocab_size=250880, max_seq_len=2048, activation="gelu",
                norm="layernorm", position="alibi", embedding_norm=True,
                tie_embeddings=True, dtype=dtype)
    base.update(_BLOOM_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def bloom_model(preset: str = "bloom-7b1", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(bloom_config(preset, **overrides), device=device)


def gpt_neox_config(preset: str = "gpt-neox-20b", dtype: torch.dtype = torch.bfloat16,
                    **overrides) -> TransformerConfig:
    # HF's default hidden_act "gelu" is the exact erf form
    base = dict(activation="gelu_exact", norm="layernorm", position="rope",
                parallel_block=True, parallel_norms=True,
                tie_embeddings=False, dtype=dtype)
    base.update(_NEOX_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def gpt_neox_model(preset: str = "gpt-neox-20b", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(gpt_neox_config(preset, **overrides), device=device)


def gpt_neo_config(preset: str = "gpt-neo-1.3b", dtype: torch.dtype = torch.bfloat16,
                   **overrides) -> TransformerConfig:
    base = dict(vocab_size=50257, activation="gelu", norm="layernorm",
                position="learned", attn_scale=1.0, attn_bias=False,
                attn_out_bias=True, tie_embeddings=True, dtype=dtype)
    base.update(_GPT_NEO_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def gpt_neo_model(preset: str = "gpt-neo-1.3b", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(gpt_neo_config(preset, **overrides), device=device)


def gptj_config(preset: str = "gpt-j-6b", dtype: torch.dtype = torch.bfloat16,
                **overrides) -> TransformerConfig:
    base = dict(activation="gelu", norm="layernorm", position="rope",
                rope_style="interleaved", parallel_block=True,
                attn_bias=False, tie_embeddings=False, lm_head_bias=True,
                dtype=dtype)
    base.update(_GPTJ_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def gptj_model(preset: str = "gpt-j-6b", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(gptj_config(preset, **overrides), device=device)
