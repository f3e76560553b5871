"""GPT-2 presets (counterpart of ``deepspeed_tpu/models/gpt2.py``; the port
keeps its own copy of the preset table): tanh GELU, LayerNorm with biases,
learned positions, a tied head."""

from __future__ import annotations

import torch

from .transformer import TransformerConfig, TransformerLM

_PRESETS = {
    "gpt2-tiny": dict(num_layers=2, num_heads=4, hidden_size=128, max_seq_len=256, vocab_size=1024),
    "gpt2-125m": dict(num_layers=12, num_heads=12, hidden_size=768, max_seq_len=1024),
    "gpt2-medium": dict(num_layers=24, num_heads=16, hidden_size=1024, max_seq_len=1024),
    "gpt2-large": dict(num_layers=36, num_heads=20, hidden_size=1280, max_seq_len=1024),
    "gpt2-xl": dict(num_layers=48, num_heads=25, hidden_size=1600, max_seq_len=1024),
}


def gpt2_config(preset: str = "gpt2-125m", dtype: torch.dtype = torch.float32,
                **overrides) -> TransformerConfig:
    base = dict(
        vocab_size=50257,
        activation="gelu",
        norm="layernorm",
        position="learned",
        tie_embeddings=True,
        dtype=dtype,
    )
    base.update(_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def gpt2_model(preset: str = "gpt2-125m", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``; on the meta device unless
    ``device`` is given (see ``TransformerLM.materialize``)."""
    return TransformerLM(gpt2_config(preset, **overrides), device=device)
