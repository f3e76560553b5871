"""BERT-family encoder presets (BERT / RoBERTa).

Counterpart of ``deepspeed_tpu/models/bert.py`` (the port keeps its own
copy of the preset table). Expressed through ``TransformerConfig``:
bidirectional attention (``causal=False``), post-norm blocks, learned
positions + segment embeddings with an embedding LayerNorm, and the MLM
prediction head (dense -> activation -> LN -> tied decoder + bias).
RoBERTa is the same body with its +2 position-padding offset and HF's
pad-aware position ids.
"""

from __future__ import annotations

import torch

from .transformer import TransformerConfig, TransformerLM

_BERT_PRESETS = {
    "bert-tiny": dict(num_layers=2, num_heads=4, hidden_size=64,
                      intermediate_size=256, max_seq_len=64, vocab_size=256),
    "bert-base": dict(num_layers=12, num_heads=12, hidden_size=768,
                      intermediate_size=3072),
    "bert-large": dict(num_layers=24, num_heads=16, hidden_size=1024,
                       intermediate_size=4096),
}


def bert_config(preset: str = "bert-base", dtype: torch.dtype = torch.bfloat16,
                **overrides) -> TransformerConfig:
    base = dict(vocab_size=30522, max_seq_len=512, activation="gelu_exact",
                norm="layernorm", position="learned", causal=False,
                norm_style="post", embedding_norm=True, type_vocab_size=2,
                mlm_head=True, tie_embeddings=True, dtype=dtype)
    base.update(_BERT_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def bert_model(preset: str = "bert-base", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(bert_config(preset, **overrides), device=device)


def roberta_config(preset: str = "bert-base", dtype: torch.dtype = torch.bfloat16,
                   **overrides) -> TransformerConfig:
    """RoBERTa: the bert body, vocab 50265, ONE token type, and HF's
    pad-aware position ids (cumsum over non-pad tokens + padding_idx)."""
    base = dict(vocab_size=50265, max_seq_len=512, activation="gelu_exact",
                norm="layernorm", position="learned", position_offset=2,
                pad_based_positions=True, pad_token_id=1,
                causal=False, norm_style="post", embedding_norm=True,
                type_vocab_size=1, mlm_head=True, tie_embeddings=True,
                dtype=dtype)
    base.update(_BERT_PRESETS[preset])
    base.update(overrides)
    return TransformerConfig(**base)


def roberta_model(preset: str = "bert-base", device=None, **overrides) -> TransformerLM:
    """A ``TransformerLM`` for ``preset``, on the meta device unless
    ``device`` is given."""
    return TransformerLM(roberta_config(preset, **overrides), device=device)
