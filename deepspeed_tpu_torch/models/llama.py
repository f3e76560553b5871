"""Llama-2 presets (counterpart of ``deepspeed_tpu/models/llama.py``; the
port keeps its own copy of the preset table)."""

from __future__ import annotations

import torch

from .transformer import TransformerConfig, TransformerLM

_PRESETS = {
    "llama2-tiny": dict(num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=128,
                        intermediate_size=352, max_seq_len=256, vocab_size=1024),
    "tinyllama-1.1b": dict(num_layers=22, num_heads=32, num_kv_heads=4,
                           hidden_size=2048, intermediate_size=5632,
                           max_seq_len=2048),
    "open-llama-3b": dict(num_layers=26, num_heads=32, hidden_size=3200,
                          intermediate_size=8640, max_seq_len=2048),
    "llama2-7b": dict(num_layers=32, num_heads=32, hidden_size=4096,
                      intermediate_size=11008, max_seq_len=4096),
    "llama2-13b": dict(num_layers=40, num_heads=40, hidden_size=5120,
                       intermediate_size=13824, max_seq_len=4096),
    "llama2-70b": dict(num_layers=80, num_heads=64, num_kv_heads=8, hidden_size=8192,
                       intermediate_size=28672, max_seq_len=4096),
    "mistral-7b": dict(num_layers=32, num_heads=32, num_kv_heads=8, hidden_size=4096,
                       intermediate_size=14336, max_seq_len=8192, vocab_size=32000),
}


def llama_config(preset: str = "llama2-7b", dtype: torch.dtype = torch.bfloat16,
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


def llama_model(preset: str = "llama2-7b", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``; on the meta device unless
    ``device`` is given (see ``TransformerLM.materialize``)."""
    return TransformerLM(llama_config(preset, **overrides), device=device)
