"""The encoders of the port (``models/bert.py``, ``models/heads.py`` and the
encoder half of ``models/transformer.py``) against the JAX package's, on the
CPU: JAX parameter trees drawn with numpy from a seed (no bias zero and no
norm scale one), carried across by ``convert.params_from_jax``; the same
numpy batches on both sides, padded (lengths drawn per row, pads at the
end: 0 for BERT, RoBERTa's pad id 1 with its pad-based positions), with two
token types for BERT and 15% of the real positions labelled. The JAX side
runs ``apply`` / ``loss`` / its engine as its own tests do (XLA attention
on the CPU), the port its plain kernel versions (the flash pair with
``causal=False`` and the mask as segment ids).

- bert-tiny and a RoBERTa tiny config: logits, MLM loss and every
  parameter's gradient in fp32 (logits and gradients 1e-4 relative,
  gradients with an absolute floor of 1e-5 x the largest gradient, as
  ``test_torch_families.py`` holds them; loss 1e-5 relative), and the
  hidden states of ``return_hidden``;
- every task x head style of ``EncoderTaskModel`` (outputs, loss, grads),
  and the QA loss's clamp of positions to [0, S] with S ignored;
- ``initialize`` + ``train_batch``: 3-step trajectories against the JAX
  engine (micro 1 on the 8-device test mesh, global batch 8) for bert-tiny
  MLM with AdamW and a sequence classifier with MuAdamW, 1e-5 relative;
- a task model's tag loads in either package, params equal;
- the serving engine and the plain forward refuse an encoder, an encoder
  without labels raises, and ``load_hf_task_model`` names ROADMAP A11.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert_model as jbert
from deepspeed_tpu.models import roberta_model as jroberta
from deepspeed_tpu.models.heads import EncoderTaskModel as JaxTask
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig, build_engine
from deepspeed_tpu_torch.models import EncoderTaskModel, bert_model, roberta_model
from deepspeed_tpu_torch.models import heads as theads
from tests.port_threads import torch_threads  # noqa: F401

ROBERTA_TINY = dict(vocab_size=256, max_seq_len=64)   # bert-tiny's widths
MODELS = {
    "bert-tiny": (lambda **kw: jbert("bert-tiny", **kw),
                  lambda **kw: bert_model("bert-tiny", **kw)),
    "roberta-tiny": (lambda **kw: jroberta("bert-tiny", **ROBERTA_TINY, **kw),
                     lambda **kw: roberta_model("bert-tiny", **ROBERTA_TINY, **kw)),
}
B, S = 4, 32
ADAMW = {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}}


def _bodies(name, **kw):
    jfn, tfn = MODELS[name]
    return (jfn(dtype=jnp.float32, remat=False, **kw),
            tfn(dtype=torch.float32, remat=False, **kw))


def _params(jm, seed):
    """A JAX params tree of ``jm``'s shapes, its values from numpy: norm
    scales 1 + N(0, 0.05), every other leaf N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.float32))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(float(path[-1].key == "scale")
                                    + 0.05 * rng.standard_normal(s.shape), jnp.float32),
        shapes)


def _batch(name, seed, rows=B, vocab=256):
    """Padded rows (lengths in [S/4, S], the first full), token types, MLM
    labels on 15% of the real positions."""
    rng = np.random.default_rng(seed)
    pad = 1 if name.startswith("roberta") else 0
    ids = rng.integers(2, vocab, size=(rows, S))
    lens = np.concatenate([[S], rng.integers(S // 4, S + 1, size=rows - 1)])
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, pad)
    types = (rng.integers(0, 2, size=(rows, S)) if name.startswith("bert")
             else np.zeros((rows, S), np.int64)) * mask
    labels = np.where((rng.random((rows, S)) < 0.15) & (mask == 1), ids, -100)
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": types,
            "labels": labels}


def _load(tm, params):
    state = params_from_jax(jax.device_get(params))
    assert set(tm.state_dict()) == set(state)
    tm.to_empty(device="cpu").load_state_dict(state)
    for p in tm.parameters():
        p.requires_grad_(True)


def _check_grads(tm, want_grads):
    want = params_from_jax(jax.device_get(want_grads))
    floor = 1e-5 * max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        # a task loss never reaches the body's MLM head: no gradient here,
        # zeros in JAX
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=floor, err_msg=name)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -- the MLM models against JAX apply / loss / grad ------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_mlm_logits_loss_and_grads_match_jax(name):
    jm, tm = _bodies(name)
    assert tm.ln_f is None and tm.mlm is not None and tm.wtt is not None
    params = _params(jm, seed=1)
    _load(tm, params)
    batch = _batch(name, seed=2)
    jb = _jax(batch)
    (want_loss, want_logits), want_grads = jax.value_and_grad(
        lambda p: (jm.loss(p, jb), jm.apply(p, jb["input_ids"], token_type_ids=jb[
            "token_type_ids"], attention_mask=jb["attention_mask"])[0]), has_aux=True)(params)
    tb = _torch(batch)
    got_logits, _ = tm.apply(tb["input_ids"], token_type_ids=tb["token_type_ids"],
                             attention_mask=tb["attention_mask"])
    got_loss = tm.loss(tb)
    got_loss.backward()
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _check_grads(tm, want_grads)


@pytest.mark.parametrize("name", list(MODELS))
def test_return_hidden_matches_jax(name):
    """The post-norm body's last block output (no ``ln_f``) as JAX returns
    it; without token types (BERT's default: type 0) and without a mask."""
    jm, tm = _bodies(name)
    params = _params(jm, seed=3)
    _load(tm, params)
    ids = _batch(name, seed=4)["input_ids"]
    want, _ = jm.apply(params, jnp.asarray(ids), return_hidden=True)
    got, _ = tm.apply(torch.from_numpy(ids), return_hidden=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_encoders_do_not_serve_and_need_labels():
    _, tm = _bodies("bert-tiny")
    with pytest.raises(ValueError, match="bidirectional encoders"):
        build_engine(tm, RaggedInferenceEngineConfig(kv_cache_dtype=torch.float32),
                     device="cpu")
    tm.materialize("cpu", seed=0)
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="bidirectional encoders"):
        tm(ids)
    with pytest.raises(ValueError, match="explicit labels"):
        tm.loss({"input_ids": ids})


# -- the task heads ---------------------------------------------------------------------

HEADS = [("sequence_classification", "bert"), ("sequence_classification", "roberta"),
         ("sequence_classification", "distilbert"), ("token_classification", "bert"),
         ("token_classification", "roberta"), ("question_answering", "bert")]


def _task_models(task, style, num_labels=3):
    name = "roberta-tiny" if style == "roberta" else "bert-tiny"
    jbody, tbody = _bodies(name)
    return (name, JaxTask(jbody, task, num_labels=num_labels, head_style=style),
            EncoderTaskModel(tbody, task, num_labels=num_labels, head_style=style))


def _task_batch(name, task, seed):
    batch = _batch(name, seed)
    rng = np.random.default_rng(seed + 1)
    if task == "sequence_classification":
        batch["labels"] = rng.integers(0, 3, size=B)
    elif task == "token_classification":
        batch["labels"] = np.where(batch["attention_mask"] == 1,
                                   rng.integers(0, 3, size=(B, S)), -100)
    else:
        del batch["labels"]
        batch["start_positions"] = rng.integers(0, S, size=B)
        batch["end_positions"] = rng.integers(0, S, size=B)
    return batch


@pytest.mark.parametrize("task,style", HEADS)
def test_task_heads_match_jax(task, style):
    name, jm, tm = _task_models(task, style)
    assert set(dict(tm.named_children())) >= {"wte", "blocks", "head"}
    params = _params(jm, seed=5)
    _load(tm, params)
    batch = _task_batch(name, task, seed=6)
    jb = _jax(batch)
    (want_loss, want_out), want_grads = jax.value_and_grad(
        lambda p: (jm.loss(p, jb), jm.apply(p, jb["input_ids"], token_type_ids=jb[
            "token_type_ids"], attention_mask=jb["attention_mask"])), has_aux=True)(params)
    tb = _torch(batch)
    got_out = tm.apply(tb["input_ids"], token_type_ids=tb["token_type_ids"],
                       attention_mask=tb["attention_mask"])
    got_loss = tm.loss(tb)
    got_loss.backward()
    for got, want in zip(got_out if isinstance(got_out, tuple) else (got_out,),
                         want_out if isinstance(want_out, tuple) else (want_out,)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _check_grads(tm, want_grads)


def test_qa_loss_clamps_positions():
    """Positions clamp to [0, S]; S (past the end, or at it) is ignored and
    contributes no loss; a negative position clamps onto 0. Equal to the
    JAX loss on the same positions."""
    name, jm, tm = _task_models("question_answering", "bert")
    params = _params(jm, seed=7)
    _load(tm, params)
    batch = _task_batch(name, "question_answering", seed=8)
    batch["start_positions"] = np.asarray([2, S + 7, -3, S])
    batch["end_positions"] = np.asarray([4, S, 5, 1])
    want = float(jm.loss(params, _jax(batch)))
    got = tm.loss(_torch(batch)).item()
    assert abs(got - want) <= 1e-5 * abs(want)
    kept = dict(batch, start_positions=np.asarray([2, 2, 0, 2]),
                end_positions=np.asarray([4, 4, 5, 1]))
    start, end = tm.apply(torch.from_numpy(batch["input_ids"]),
                          token_type_ids=torch.from_numpy(batch["token_type_ids"]),
                          attention_mask=torch.from_numpy(batch["attention_mask"]))
    ce = lambda logits, pos: torch.nn.functional.cross_entropy(logits, torch.tensor(pos),
                                                               reduction="none")
    s_loss, e_loss = ce(start, kept["start_positions"]), ce(end, kept["end_positions"])
    want_by_hand = 0.5 * (s_loss[[0, 2]].mean() + e_loss[[0, 2, 3]].mean())
    assert abs(got - want_by_hand.item()) <= 1e-5 * abs(got)


def test_task_model_refusals():
    _, tbody = _bodies("bert-tiny")
    with pytest.raises(ValueError, match="unknown task"):
        EncoderTaskModel(tbody, "fill_mask")
    from deepspeed_tpu_torch.models import llama_model
    with pytest.raises(ValueError, match="bidirectional encoder"):
        EncoderTaskModel(llama_model("llama2-tiny"), "token_classification")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        theads.load_hf_task_model("/nonexistent", "sequence_classification")


# -- training and checkpoints against the JAX engine ----------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """bert-tiny MLM (AdamW) and a bert-tiny sequence classifier (MuAdamW):
    the JAX engine (micro 1 on the 8-device mesh) and the port (micro 8)
    from the same params, 3 steps on one padded batch; the classifier's
    port tag loaded by the JAX engine, and the MLM model's JAX tag by a
    port engine of another seed."""
    out = {}
    for case in ("mlm", "classifier"):
        d = tmp_path_factory.mktemp(case)
        if case == "mlm":
            jm, tm = _bodies("bert-tiny")
            make_port = lambda: _bodies("bert-tiny")[1]
            batch = _batch("bert-tiny", seed=9, rows=8)
            opt = ADAMW
        else:
            _, jm, tm = _task_models("sequence_classification", "bert")
            make_port = lambda: _task_models("sequence_classification", "bert")[2]
            batch = _task_batch("bert-tiny", "sequence_classification", seed=9)
            batch = {k: np.concatenate([v, v]) for k, v in batch.items()}   # 8 rows
            opt = {"type": "MuAdamW", "params": {"lr": 3e-3, "weight_decay": 0.1}}
        cfg = {"optimizer": opt, "gradient_clipping": 1.0}
        params = _params(jm, seed=10)
        jeng, *_ = deepspeed_tpu.initialize(
            model=jm, config=dict(cfg, train_micro_batch_size_per_gpu=1),
            model_parameters=params)
        peng, *_ = deepspeed_tpu_torch.initialize(
            model=tm, config=dict(cfg, train_micro_batch_size_per_gpu=8),
            model_parameters=params_from_jax(jax.device_get(params)), device="cpu")
        r = out[case] = dict(jax=[float(jeng.train_batch(batch)) for _ in range(3)],
                             port=[float(peng.train_batch(batch)) for _ in range(3)])
        if case == "classifier":
            peng.save_checkpoint(str(d))
            jeng.load_checkpoint(str(d))
            r["saved"] = {k: v.clone() for k, v in peng.module_state_dict().items()}
            r["loaded"] = params_from_jax(jax.device_get(jeng.state["params"]))
        else:
            jeng.save_checkpoint(str(d))
            other, *_ = deepspeed_tpu_torch.initialize(
                model=make_port(), config=dict(cfg, train_micro_batch_size_per_gpu=8),
                device="cpu", seed=5)
            other.load_checkpoint(str(d))
            r["saved"] = params_from_jax(jax.device_get(jeng.state["params"]))
            r["loaded"] = {k: v.clone() for k, v in other.module_state_dict().items()}
    return out


@pytest.mark.parametrize("case", ["mlm", "classifier"])
def test_train_trajectory_matches_the_jax_engine(trained, case):
    r = trained[case]
    np.testing.assert_allclose(r["port"], r["jax"], rtol=1e-5, atol=0)
    assert r["port"][-1] < r["port"][0]


@pytest.mark.parametrize("case", ["mlm", "classifier"])
def test_tags_load_in_the_other_package(trained, case):
    """classifier: port -> JAX (the ``head`` leaves among them); mlm: JAX
    -> port (``wtt``, ``ln_emb``, ``mlm.*``). Params equal, leaf for leaf."""
    r = trained[case]
    assert r["saved"].keys() == r["loaded"].keys()
    assert any(k.startswith("head." if case == "classifier" else "mlm.") for k in r["saved"])
    for k in r["saved"]:
        assert torch.equal(r["saved"][k], r["loaded"][k]), k
