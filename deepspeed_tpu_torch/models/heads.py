"""Task heads over the shared encoder body.

Counterpart of ``deepspeed_tpu/models/heads.py``. Head shapes follow the HF
architectures:

- sequence classification: ``head.mid`` on [CLS] (bert's pooler, roberta's
  ``classifier.dense``: tanh; distilbert's ``pre_classifier``: relu), then
  ``head.classifier``;
- token classification: a per-token ``head.classifier``;
- question answering: a per-token ``head.classifier`` of 2 outputs ->
  ``(start, end)`` logits.

``EncoderTaskModel`` is an ``nn.Module`` whose parameters are the body's,
under the body's own names, plus ``head.*``: the JAX task model's tree
(``params_from_jax`` / ``params_to_jax`` and checkpoints map one onto the
other). ``load_hf_task_model`` needs ``runtime/state_dict_factory``, which
is not ported (ROADMAP A11).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..nn import layers as L
from .transformer import TransformerLM, masked_cross_entropy

TASKS = ("sequence_classification", "token_classification",
         "question_answering")


class EncoderTaskModel(nn.Module):
    """An encoder body + one task head."""

    def __init__(self, lm: TransformerLM, task: str, num_labels: int = 2,
                 head_style: str = "bert"):
        super().__init__()
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r} (one of {TASKS})")
        if lm.config.causal:
            raise ValueError("task heads expect a bidirectional encoder body")
        # the body's modules under their own names (not ``lm.*``), so the
        # state dict is the JAX tree's
        object.__setattr__(self, "lm", lm)
        for name, child in lm.named_children():
            self.add_module(name, child)
        self.config = lm.config
        self.task = task
        self.num_labels = 2 if task == "question_answering" else num_labels
        self.head_style = head_style
        H = lm.config.hidden_size
        device = lm.wte.weight.device
        kw = dict(device=device, dtype=lm.config.dtype)
        self.head = nn.Module()
        if task == "sequence_classification":
            self.head.mid = L.Linear(H, H, **kw)   # pooler / dense / pre_classifier
        self.head.classifier = L.Linear(H, self.num_labels, **kw)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """The body's init, then the head's linears."""
        self.lm.init_weights(generator)
        for m in self.head.children():
            m.reset_parameters(generator)

    def apply(self, input_ids: torch.Tensor,
              token_type_ids: Optional[torch.Tensor] = None,
              attention_mask: Optional[torch.Tensor] = None):
        """sequence_classification -> [B, num_labels];
        token_classification -> [B, S, num_labels];
        question_answering -> (start [B, S], end [B, S]); fp32."""
        hidden, _ = self.lm.apply(input_ids, token_type_ids=token_type_ids,
                                  attention_mask=attention_mask, return_hidden=True)
        if self.task == "sequence_classification":
            x = self.head.mid(hidden[:, 0])                   # [CLS]
            x = torch.relu(x) if self.head_style == "distilbert" else torch.tanh(x)
            return self.head.classifier(x).float()
        logits = self.head.classifier(hidden).float()
        if self.task == "question_answering":
            return logits[..., 0], logits[..., 1]
        return logits

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Cross-entropy per task; QA averages the start and end losses with
        HF's ignore convention (positions clamped to [0, S]; S is ignored)."""
        out = self.apply(batch["input_ids"], token_type_ids=batch.get("token_type_ids"),
                         attention_mask=batch.get("attention_mask"))
        if self.task == "question_answering":
            start, end = out
            S = start.shape[-1]

            def qa_labels(pos):
                clamped = torch.clamp(pos, 0, S)
                return torch.where(clamped == S, torch.full_like(clamped, -100), clamped)

            return 0.5 * (masked_cross_entropy(start, qa_labels(batch["start_positions"]))
                          + masked_cross_entropy(end, qa_labels(batch["end_positions"])))
        return masked_cross_entropy(out, batch["labels"])


def load_hf_task_model(model_path: str, task: str, dtype=None, **config_overrides):
    """HF ``*For{SequenceClassification, TokenClassification,
    QuestionAnswering}`` checkpoints: not ported."""
    raise NotImplementedError(
        "load_hf_task_model is not ported: it reads HF checkpoints through "
        "runtime/state_dict_factory (ROADMAP A11: HF checkpoint loading)")
