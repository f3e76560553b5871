"""The remat policies of the port (``runtime/activation_checkpointing/
checkpointing.py`` and ``TransformerLM.apply``), on the CPU.

As the JAX suite holds its policies (``tests/unit/models/
test_remat_policies.py``): remat changes what is recomputed, never the
math, so for bert-tiny (post-norm, a padding mask) and llama2-tiny every
policy's loss and gradients equal full remat's within 1e-6 (here they are
bitwise: the same ops on the same inputs), ``alternating`` at an odd depth
too. And each policy changes what is kept: the bytes the forward hands to
autograd's saved-tensor hooks (parameters aside) order
``everything_saveable`` > ``dots_saveable`` > ``full``, and the flash
forward runs twice a layer where it is recomputed (full,
``dots_with_no_batch_dims_saveable``) and once where it is kept
(``dots_saveable``, ``everything_saveable``). Unknown names raise
``ValueError``; the config's ``activation_checkpointing.policy`` is the
default of ``checkpointing.checkpoint`` once ``configure``d.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import bert_model, llama_model
from deepspeed_tpu_torch.ops.transformer import flash
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from tests.port_threads import torch_threads  # noqa: F401

POLICIES = ["nothing_saveable", "attention_only", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims",
            "everything_saveable", "alternating"]


def _model(family, policy, **kw):
    mk = bert_model if family == "bert" else llama_model
    preset = "bert-tiny" if family == "bert" else "llama2-tiny"
    m = mk(preset, dtype=torch.float32, max_seq_len=32, vocab_size=256, remat=True,
           remat_policy=policy, **kw).materialize("cpu", seed=0)
    for p in m.parameters():
        p.requires_grad_(True)
    return m


def _batch(family):
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 256, size=(4, 32))
    if family == "llama":
        return {"input_ids": torch.from_numpy(ids)}
    mask = (np.arange(32)[None, :] < np.asarray([32, 20, 9, 27])[:, None]).astype(np.int32)
    labels = np.where(rng.random((4, 32)) < 0.3, ids, -100) * mask - 100 * (1 - mask)
    return {k: torch.from_numpy(v) for k, v in
            dict(input_ids=ids * mask, attention_mask=mask, labels=labels).items()}


def _run(model, batch):
    """(loss, grads, bytes saved for the backward, flash forward calls)."""
    params = {p.data_ptr() for p in model.parameters()}
    saved, calls = [0], [0]

    def pack(t):
        if t.data_ptr() not in params:
            saved[0] += t.numel() * t.element_size()
        return t

    fwd = flash.flash_fwd

    def counting(*a):
        calls[0] += 1
        return fwd(*a)

    flash.flash_fwd = counting
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss(batch)
        loss.backward()
    finally:
        flash.flash_fwd = fwd
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, saved[0], calls[0]


@pytest.fixture(scope="module")
def full():
    return {f: _run(_model(f, "full"), _batch(f)) for f in ("bert", "llama")}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["bert", "llama"])
def test_policy_matches_full_remat(full, family, policy):
    l_full, g_full, _, _ = full[family]
    loss, grads, _, _ = _run(_model(family, policy), _batch(family))
    assert abs(loss - l_full) < 1e-6
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), g_full[name].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_alternating_at_an_odd_depth():
    """3 layers: the pair (0, 1) with layer 0 checkpointed, then the odd
    last layer checkpointed: two flash recomputes, and full remat's grads."""
    runs = {p: _run(_model("llama", p, num_layers=3), _batch("llama"))
            for p in ("full", "alternating")}
    (l_full, g_full, _, c_full), (l_alt, g_alt, _, c_alt) = runs["full"], runs["alternating"]
    assert abs(l_alt - l_full) < 1e-6 and (c_full, c_alt) == (6, 5)
    for name, g in g_alt.items():
        np.testing.assert_allclose(g.numpy(), g_full[name].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("family", ["bert", "llama"])
def test_policies_change_what_is_saved(full, family):
    _, _, b_full, c_full = full[family]
    runs = {p: _run(_model(family, p), _batch(family))
            for p in ("dots_saveable", "dots_with_no_batch_dims_saveable",
                      "everything_saveable")}
    b_every, b_dots = runs["everything_saveable"][2], runs["dots_saveable"][2]
    b_linear = runs["dots_with_no_batch_dims_saveable"][2]
    assert b_every > b_dots > b_linear > b_full > 0
    L = 2
    assert c_full == 2 * L and runs["dots_with_no_batch_dims_saveable"][3] == 2 * L
    assert runs["dots_saveable"][3] == L and runs["everything_saveable"][3] == L


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="dots_saveable.*alternating"):
        llama_model("llama2-tiny", remat_policy="offload_dots")
    llama_model("llama2-tiny", remat=False, remat_policy="offload_dots")  # unread
    with pytest.raises(ValueError, match="unknown remat policy"):
        checkpointing.checkpoint(torch.sin, torch.zeros(2), policy="alternating")


def test_configured_policy_is_the_default():
    """``configure(deepspeed_config=...)`` takes the config block's flags;
    only ``policy`` acts: ``checkpoint`` with no policy keeps the products
    of the configured one (an ``mm``'s output saved, so sin's input is not
    recomputed)."""
    cfg = DeepSpeedConfig({"activation_checkpointing": {
        "policy": "dots_saveable", "partition_activations": True, "number_checkpoints": 4}})
    assert cfg.activation_checkpointing_config.partition_activations
    before = dict(checkpointing._CONFIG)
    try:
        checkpointing.configure(deepspeed_config=cfg)
        assert checkpointing._CONFIG["policy"] == "dots_saveable"
        assert checkpointing._CONFIG["num_checkpoints"] == 4
        x = torch.randn(4, 4, requires_grad=True)
        w = torch.randn(4, 4, requires_grad=True)
        y = checkpointing.checkpoint(lambda a: torch.sin(a @ w), x)
        y.sum().backward()
        gx, gw = x.grad.clone(), w.grad.clone()
        x.grad = w.grad = None
        torch.sin(x @ w).sum().backward()
        assert torch.equal(gx, x.grad) and torch.equal(gw, w.grad)
        assert checkpointing.resolve_policy(None) is checkpointing.POLICIES["dots_saveable"]
    finally:
        checkpointing._CONFIG.update(before)
