"""MoE training in the port against the JAX package, on the CPU: the port's
wrappers run their plain versions there, the JAX side runs the Pallas MoE
kernels in interpret mode (as ``tests/unit/ops/test_pallas_moe.py`` does)
or, inside its engine, the XLA expert path (its own choice on the CPU).

- the op's gradient: ``make_moe_forward`` with a cotangent on ``out`` and a
  nonzero one on ``aux``, differentiated by autograd (the reference VJP),
  against ``jax.grad`` of ``pallas_moe.make_moe_forward(interpret=True)``
  and ``jax.vjp`` of the JAX ``moe_reference_forward``: fp32 within 1e-5
  relative plus 1e-5 x the largest |gradient| of any leaf (sums over the
  tokens in other orders; at top_k 1 the router's gradient through the
  normalised weights, ``g / g``, is zero but for rounding, the k_proj-bias
  case of ROADMAP C), top_k 1 and 2, ``silu_gated`` and ``gelu``, a
  capacity that drops choices and one that does not, the fused and the
  split form; bf16 within 2e-2 + 2e-2 |ref| of the JAX kernel path's bf16
  gradient, with the routes of both sides equal (the bf16 products round
  in each framework's own order);
- mixtral-tiny through ``initialize`` + ``train_batch`` against the JAX
  engine (micro 1 on the 8-device test mesh, a global batch of 8, the
  port at micro 8; capacity 1.25 drops choices at every step): the first
  loss with its aux term within 1e-5; 4 steps fp32 with clipping, losses
  within 1e-5 relative and final params within 1e-4 + 1e-4 |ref|; 4 steps
  bf16 with clipping, losses within 2e-2 relative; ``aux_loss_coef`` 1.0,
  fp32, losses within 1e-5 relative;
- ``apply``'s aux and logits against the JAX ``apply``, with a
  ``layer_mask`` (PLD) that scales each layer's aux;
- every remat policy's losses and gradients equal full's (bitwise), and
  the MoE operator recomputed where the policy recomputes (twice a layer)
  and run once where it keeps everything;
- a mixtral-tiny tag saved by either package loads in the other: the next
  3 losses within 1e-5 relative of the saver's own;
- ``moe/utils.py`` against ``deepspeed_tpu/moe/utils.py``, leaf for leaf;
- ``DataParallelEngine`` on a gloo world of 2 raises naming A7;
- the DeepSpeed config's ``moe`` key and ``moe_layer_freq`` 2 are accepted,
  as in JAX.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import mixtral_model as jax_mixtral
from deepspeed_tpu.models.transformer import MoEConfig as JaxMoEConfig
from deepspeed_tpu.moe import utils as jax_utils
from deepspeed_tpu.moe.layer import moe_reference_forward as jax_reference_forward
from deepspeed_tpu.ops.transformer import pallas_moe as pm
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.convert import jax_leaf, params_from_jax
from deepspeed_tpu_torch.models import mixtral_model
from deepspeed_tpu_torch.models.transformer import MoEConfig
from deepspeed_tpu_torch.moe import utils
from deepspeed_tpu_torch.ops.transformer import moe
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 180   # seconds for the two-rank run, rendezvous included
T, E, H, F = 32, 4, 16, 32
V, S = 1024, 32
FP32 = 1e-5
ADAMW = {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}}
CFG = {"optimizer": ADAMW, "gradient_clipping": 1.0}
BF16 = dict(CFG, bf16={"enabled": True})


# -- the op's gradient ------------------------------------------------------------------


def _np_params(activation, seed=0):
    """JAX-layout weights: gate [H, E], wi* [E, H, F], wo [E, F, H]."""
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    p = {"gate": w(H, E), "wo": w(E, F, H)}
    if activation == "silu_gated":
        p["wi_gate"], p["wi_up"] = w(E, H, F), w(E, H, F)
    else:
        p["wi"] = w(E, H, F)
    return p


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, H)).astype(np.float32),
            rng.standard_normal((T, H)).astype(np.float32), np.float32(0.7))


def _round_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_grads(activation, top_k, cap, dtype):
    """(kernel path's grads, reference VJP's grads) of ``sum(out * ct) + ca *
    aux``, each a (params, tokens) pair of host arrays."""
    p, (x, ct, ca) = _np_params(activation), _inputs()
    jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    jx, jct = jnp.asarray(x, dtype), jnp.asarray(ct, dtype)
    fwd = pm.make_moe_forward(top_k=top_k, capacity=cap, activation=activation,
                              mask_pad=False, interpret=True)

    def objective(pp, xx):
        o, a = fwd(pp, xx)
        return jnp.sum((o * jct).astype(jnp.float32)) + ca * a

    kernel = jax.jit(jax.grad(objective, argnums=(0, 1)))(jp, jx)
    _, vjp = jax.vjp(lambda pp, xx: jax_reference_forward(
        pp, xx, top_k=top_k, capacity=cap, activation=activation, mask_pad=False), jp, jx)
    reference = vjp((jct, jnp.asarray(ca, jnp.float32)))
    return tuple(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), g)
                 for g in (kernel, reference))


def _port_grads(activation, top_k, cap, dtype):
    """The port's (out, aux, {leaf: grad in the JAX layout}, tokens grad)."""
    p, (x, ct, ca) = _np_params(activation), _inputs()
    tree = params_from_jax({"blocks": {"moe": {k: v[None] for k, v in p.items()}}})
    tp = {k.rpartition(".")[2]: v.to(dtype).requires_grad_(True) for k, v in tree.items()}
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out, aux = moe.make_moe_forward(top_k=top_k, capacity=cap, activation=activation)(tp, tx)
    ((out * torch.from_numpy(ct).to(dtype)).float().sum() + float(ca) * aux).backward()
    grads = {k: (v.grad.float() if k == "gate" else v.grad.float().transpose(-1, -2)).numpy()
             for k, v in tp.items()}
    return out, aux, grads, tx.grad.float().numpy()


def _close(got, want, rtol, scale):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("form", ["fused", "split"])
@pytest.mark.parametrize("cap", [6, 2 * T], ids=["drops", "dropless"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("activation", ["silu_gated", "gelu"])
def test_op_gradient_matches_jax_fp32(activation, top_k, cap, form, monkeypatch):
    """Each gradient leaf against both JAX gradients, 1e-5 (relative and x
    the largest |gradient| of any leaf); a dropping capacity is checked to
    drop."""
    monkeypatch.setattr(moe, "MOE_FUSED_COMBINE_MAX_TOKENS", T if form == "fused" else T - 1)
    forms = []
    for name in ("moe_ffn_combine", "moe_ffn"):
        orig = getattr(moe, name)
        monkeypatch.setattr(moe, name, lambda *a, _o=orig, _n=name, **k: (
            forms.append(_n), _o(*a, **k))[1])
    out, aux, grads, gx = _port_grads(activation, top_k, cap, torch.float32)
    assert forms == ["moe_ffn_combine" if form == "fused" else "moe_ffn"]
    x = torch.from_numpy(_inputs()[0])
    src = moe.moe_route(x @ torch.from_numpy(_np_params(activation)["gate"]), top_k=top_k,
                        capacity=cap)[0]
    assert (int((src > 0).sum()) < top_k * T) == (cap < T)
    kernel, reference = _jax_grads(activation, top_k, cap, jnp.float32)
    for jp, jx in (kernel, reference):
        scale = max(np.abs(a).max() for a in [jx, *jp.values()])
        assert grads.keys() == jp.keys()
        for got, want in [(gx, jx)] + [(grads[k], jp[k]) for k in jp]:
            _close(got, want, FP32, scale)


@pytest.mark.parametrize("activation", ["silu_gated", "gelu"])
def test_op_gradient_matches_jax_bf16(activation):
    """bf16 on both sides from the same bf16-rounded inputs: the routes are
    equal, and every gradient leaf is within 2e-2 + 2e-2 |ref| of the JAX
    kernel path's, in units of the leaf's largest |gradient|."""
    p, (x, _, _) = _np_params(activation), _inputs()
    logits = _round_bf16(_round_bf16(x) @ _round_bf16(p["gate"]))
    want = pm.moe_route(jnp.asarray(logits), top_k=2, capacity=6, interpret=True)
    got = moe.moe_route(torch.from_numpy(x).bfloat16() @ torch.from_numpy(p["gate"]).bfloat16(),
                        top_k=2, capacity=6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _, _, grads, gx = _port_grads(activation, 2, 6, torch.bfloat16)
    jp, jx = _jax_grads(activation, 2, 6, jnp.bfloat16)[0]
    for g, w in [(gx, jx)] + [(grads[k], jp[k]) for k in jp]:
        scale = np.abs(w).max()
        np.testing.assert_array_less(np.abs(g - w) / scale, 2e-2 + 2e-2 * np.abs(w) / scale)


def test_op_saves_only_its_inputs_and_gives_contiguous_grads():
    """The operator's backward reads the tokens and the weights alone (no
    activation of the forward is saved), and the expert weights' gradients
    land contiguous in ``[E, F, H]`` / ``[E, H, F]``."""
    p, (x, _, _) = _np_params("silu_gated"), _inputs()
    tree = params_from_jax({"blocks": {"moe": {k: v[None] for k, v in p.items()}}})
    tp = {k.rpartition(".")[2]: torch.nn.Parameter(v) for k, v in tree.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: (saved.append(t), t)[1],
                                                  lambda t: t):
        out, aux = moe.make_moe_forward(top_k=2, capacity=6, activation="silu_gated")(tp, tx)
    assert {t.data_ptr() for t in saved} == {t.data_ptr() for t in [tx, *tp.values()]}
    (out.sum() + aux).backward()
    for k, v in tp.items():
        assert v.grad.shape == v.shape and v.grad.is_contiguous(), k


def test_op_without_gradients_runs_no_operator(monkeypatch):
    """Forwards without gradients (``no_grad``; serving's ``inference_mode``
    with ``with_aux=False``) run the kernels directly, with the operator's
    output bits; with gradients, ``with_aux=False`` still differentiates."""
    p, (x, _, _) = _np_params("silu_gated"), _inputs()
    tree = params_from_jax({"blocks": {"moe": {k: v[None] for k, v in p.items()}}})
    tp = {k.rpartition(".")[2]: v.requires_grad_(True) for k, v in tree.items()}
    tx = torch.from_numpy(x)
    grad_out, grad_aux = moe.make_moe_forward(top_k=2, capacity=6,
                                              activation="silu_gated")(tp, tx)
    assert grad_out.grad_fn is not None
    no_aux, none = moe.make_moe_forward(top_k=2, capacity=6, activation="silu_gated",
                                        with_aux=False)(tp, tx)
    assert none is None and no_aux.grad_fn is not None
    calls = []
    monkeypatch.setattr(moe, "_moe_fwd_op", lambda *a: calls.append(a))
    with torch.no_grad():
        out, aux = moe.make_moe_forward(top_k=2, capacity=6, activation="silu_gated")(tp, tx)
    with torch.inference_mode():
        served, none = moe.make_moe_forward(top_k=2, capacity=6, activation="silu_gated",
                                            with_aux=False)(tp, tx)
    assert calls == [] and none is None
    assert torch.equal(out, grad_out.detach()) and torch.equal(served, out)
    assert torch.equal(aux, grad_aux.detach())


# -- mixtral-tiny against the JAX engine -----------------------------------------------


def _batch(seed=0, B=8):
    return {"input_ids": np.random.default_rng(seed).integers(0, V, size=(B, S))}


def _overrides(dtype, coef):
    return dict(dtype=dtype, max_seq_len=2 * S) if coef is None else dict(
        dtype=dtype, max_seq_len=2 * S, moe=JaxMoEConfig(num_experts=4, top_k=2,
                                                         aux_loss_coef=coef))


def _jax_engine(cfg, coef=None, seed=7):
    dt = jnp.bfloat16 if cfg.get("bf16") else jnp.float32
    eng, *_ = deepspeed_tpu.initialize(model=jax_mixtral("mixtral-tiny", **_overrides(dt, coef)),
                                       config=dict(cfg, train_micro_batch_size_per_gpu=1),
                                       seed=seed)
    return eng


def _port_model(dtype, coef=None):
    kw = dict(dtype=dtype, max_seq_len=2 * S)
    if coef is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, aux_loss_coef=coef)
    return mixtral_model("mixtral-tiny", **kw)


def _port_engine(cfg, init=None, coef=None, seed=11):
    dt = torch.bfloat16 if cfg.get("bf16") else torch.float32
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_port_model(dt, coef), config=dict(cfg, train_micro_batch_size_per_gpu=8),
        model_parameters=init, device="cpu", seed=seed)
    return eng


def test_first_loss_and_aux_match_jax():
    """``loss`` (cross-entropy + coef x aux / layers) and ``apply``'s aux and
    logits against the JAX model on the same params, fp32, at a capacity
    that drops choices; a ``layer_mask`` scales each layer's aux."""
    jm = jax_mixtral("mixtral-tiny", dtype=jnp.float32, max_seq_len=2 * S)
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    ids = _batch(1)["input_ids"]
    tm = _port_model(torch.float32).materialize("cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    want = float(jm.loss(params, {"input_ids": jnp.asarray(ids)}))
    got = float(tm.loss({"input_ids": torch.from_numpy(ids)}))
    assert abs(got - want) <= FP32 * abs(want)
    auxes = []
    for mask in (None, [1.0, 0.0], [0.5, 1.0]):
        jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
        wl, wa = jm.apply(params, jnp.asarray(ids), layer_mask=jmask)
        gl, ga = tm.apply(torch.from_numpy(ids),
                          layer_mask=None if mask is None else torch.tensor(mask))
        np.testing.assert_allclose(gl.detach().numpy(), np.asarray(wl), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(ga), float(wa), rtol=FP32)
        auxes.append(float(ga))
    assert auxes[0] > auxes[1] > 0 and auxes[1] != auxes[2]


@pytest.mark.parametrize("case", ["fp32", "bf16", "aux_coef_1"])
def test_train_trajectory_matches_jax(case):
    cfg = BF16 if case == "bf16" else CFG
    coef = 1.0 if case == "aux_coef_1" else None
    batch = _batch(2)
    jeng = _jax_engine(cfg, coef)
    init = params_from_jax(jax.device_get(jeng.state["params"]))
    want = [float(jeng.train_batch(batch)) for _ in range(4)]
    eng = _port_engine(cfg, init, coef)
    got = [float(eng.train_batch(batch)) for _ in range(4)]
    rtol = 2e-2 if case == "bf16" else FP32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    assert got[-1] < got[0]
    if case == "fp32":
        final = params_from_jax(jax.device_get(jeng.state["params"]))
        for name, p in eng.module_state_dict().items():
            np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)


# -- remat -----------------------------------------------------------------------------


POLICIES = ["full", "nothing_saveable", "attention_only", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims",
            "everything_saveable", "alternating"]
RECOMPUTED = {"full", "nothing_saveable", "dots_saveable", "checkpoint_dots",
              "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims"}


def _remat_run(policy, monkeypatch):
    """(loss, aux, grads, MoE operator calls) of one forward and backward."""
    m = mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=S, remat=True,
                      remat_policy=policy).materialize("cpu", seed=0)
    for p in m.parameters():
        p.requires_grad_(True)
    calls = [0]
    orig = moe._kernel_forward
    monkeypatch.setattr(moe, "_kernel_forward", lambda *a: (
        calls.__setitem__(0, calls[0] + 1), orig(*a))[1])
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, V, size=(4, S)))
    logits, aux = m.apply(ids)
    loss = m.combine_aux(torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, V), ids[:, 1:].reshape(-1)), aux)
    loss.backward()
    monkeypatch.setattr(moe, "_kernel_forward", orig)
    return loss.detach(), aux.detach(), {n: p.grad for n, p in m.named_parameters()}, calls[0]


def test_every_remat_policy_gives_full_remat_losses(monkeypatch):
    full = _remat_run("full", monkeypatch)
    L = 2
    for policy in POLICIES:
        loss, aux, grads, calls = _remat_run(policy, monkeypatch)
        assert torch.equal(loss, full[0]) and torch.equal(aux, full[1]), policy
        assert all(torch.equal(grads[n], full[2][n]) for n in grads), policy
        want = 2 * L if policy in RECOMPUTED else (3 if policy == "alternating" else L)
        assert calls == want, (policy, calls)


# -- checkpoints -----------------------------------------------------------------------


def test_mixtral_tags_load_in_either_package(tmp_path):
    batch = _batch(3)
    jeng = _jax_engine(CFG)
    init = params_from_jax(jax.device_get(jeng.state["params"]))
    peng = _port_engine(CFG, init)
    for eng in (jeng, peng):
        for _ in range(2):
            eng.train_batch(batch)
    jeng.save_checkpoint(str(tmp_path / "jax"))
    peng.save_checkpoint(str(tmp_path / "port"))
    jnext = [float(jeng.train_batch(batch)) for _ in range(3)]
    pnext = [float(peng.train_batch(batch)) for _ in range(3)]

    fresh = _port_engine(CFG, seed=5)
    assert fresh.load_checkpoint(str(tmp_path / "jax"))[0] == "global_step2"
    got = [float(fresh.train_batch(batch)) for _ in range(3)]
    np.testing.assert_allclose(got, jnext, rtol=FP32, atol=0)

    jfresh = _jax_engine(CFG, seed=9)
    tag, client = jfresh.load_checkpoint(str(tmp_path / "port"))
    assert tag == "global_step2" and client["global_steps"] == 2
    got = [float(jfresh.train_batch(batch)) for _ in range(3)]
    np.testing.assert_allclose(got, pnext, rtol=FP32, atol=0)


# -- moe/utils.py ----------------------------------------------------------------------


def test_moe_utils_match_jax_leaf_for_leaf():
    jm = jax_mixtral("mixtral-tiny", dtype=jnp.float32)
    mask = jax_utils.expert_param_mask(jm.specs())
    params = dict(_port_model(torch.float32).named_parameters())
    got = utils.expert_param_mask(params)
    assert got.keys() == params.keys()
    for name, p in params.items():
        node = mask
        for part in jax_leaf(name, p.ndim).path.split("/"):
            node = node[part]
        assert got[name] == node == utils.is_moe_param(name), name
    assert sum(got.values()) == 2 * 3   # wi_gate, wi_up, wo a layer; never the router
    shared, expert = utils.split_params_into_shared_and_expert_params(params)
    assert shared.keys() == expert.keys() == params.keys()
    for name, p in params.items():
        assert (expert[name] is p and shared[name] is None) if got[name] else (
            shared[name] is p and expert[name] is None), name
    gelu = {"blocks.0.moe.wi": None, "blocks.0.moe.gate": None, "blocks.0.mlp.wo": None}
    assert utils.expert_param_mask(gelu) == {"blocks.0.moe.wi": True,
                                             "blocks.0.moe.gate": False,
                                             "blocks.0.mlp.wo": False}


# -- what stays refused, and the config -------------------------------------------------


CHILD = r"""
import sys
import torch
rank, workdir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.models import mixtral_model
dist.init_distributed("gloo", rank=rank, world_size=2,
                      init_method="file://" + workdir + "/rendezvous", timeout=60)
try:
    deepspeed_tpu_torch.initialize(
        model=mixtral_model("mixtral-tiny", dtype=torch.float32, max_seq_len=64),
        config={"train_micro_batch_size_per_gpu": 1,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}, device="cpu")
    print("NO RAISE")
except NotImplementedError as e:
    print("RAISED", e)
dist.barrier()
dist.destroy_process_group()
"""


def test_data_parallel_world_of_two_raises_naming_a7(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the gloo world did not finish within {WORLD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
        assert "RAISED MoE training on a world of more than one rank" in log, log[-2000:]
        assert "ROADMAP A7" in log, log[-2000:]


def test_moe_config_key_and_layer_freq_are_accepted():
    cfg = {"train_micro_batch_size_per_gpu": 1, "moe": {"enabled": True, "ep_size": 1}}
    JaxConfig(dict(cfg))
    DeepSpeedConfig(dict(cfg))
    jm = jax_mixtral("mixtral-tiny", dtype=jnp.float32, moe_layer_freq=2)
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.float32))
    assert tree["blocks"]["moe"]["wo"].shape[0] == 2   # every layer a MoE
    m = mixtral_model("mixtral-tiny", dtype=torch.float32, moe_layer_freq=2)
    assert all(b.moe is not None for b in m.blocks)
