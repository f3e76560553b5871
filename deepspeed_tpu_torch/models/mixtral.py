"""Mixtral presets (counterpart of ``deepspeed_tpu/models/mixtral.py``; the
port keeps its own copy of the preset table)."""

from __future__ import annotations

import torch

from .transformer import MoEConfig, TransformerConfig, TransformerLM

_PRESETS = {
    "mixtral-tiny": dict(num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=128,
                         intermediate_size=256, max_seq_len=256, vocab_size=1024,
                         moe=MoEConfig(num_experts=4, top_k=2)),
    "mixtral-8x7b": dict(num_layers=32, num_heads=32, num_kv_heads=8, hidden_size=4096,
                         intermediate_size=14336, max_seq_len=8192, vocab_size=32000,
                         moe=MoEConfig(num_experts=8, top_k=2)),
}


def mixtral_config(preset: str = "mixtral-8x7b", dtype: torch.dtype = torch.bfloat16,
                   **overrides) -> TransformerConfig:
    base = dict(
        vocab_size=32000,
        activation="silu_gated",
        norm="rmsnorm",
        position="rope",
        tie_embeddings=False,
        dtype=dtype,
    )
    base.update(_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def mixtral_model(preset: str = "mixtral-8x7b", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``; on the meta device unless
    ``device`` is given (see ``TransformerLM.materialize``)."""
    return TransformerLM(mixtral_config(preset, **overrides), device=device)
