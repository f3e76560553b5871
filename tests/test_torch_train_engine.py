"""The port's training step against the JAX engine: llama2-tiny, the JAX
engine's initial parameters carried across by ``convert.params_from_jax``,
the same numpy batch on both sides, the port on the CPU (its plain flash
and Adam paths).

The JAX engine runs with its Pallas kernels forced (``DSTPU_ATTN=pallas``,
``DSTPU_OPT_KERNEL=pallas``; interpret mode on the CPU) on the 8-device
test mesh at micro-batch 1, a global batch of 8: the same mean loss as the
port's single device at micro-batch 8.

- ``masked_cross_entropy`` and ``loss`` at the ``__graft_entry__.entry()``
  shape ([2, 64]): fp32, 1e-5;
- 5 ``train_batch`` steps, fp32 with a WarmupLR schedule: every loss within
  1e-5 relative, final parameters within 1e-4; bf16 with clipping 1.0:
  every loss within 2e-2 relative, and per parameter the mean distance of
  the final values under 5% of the mean distance the JAX engine moved
  them, the largest under 2 x lr x steps (an Adam update whose sign flips
  every step: tiny gradients, bf16 rounding on two sides);
- the gas=2 split path (``forward`` / ``backward`` / ``step``), fp32;
- fp16 with a loss scale of 2**32: the gradients overflow, both engines
  skip the updates and halve the scale;
- a start mid-run from the JAX optimizer state (``opt_state_from_jax``);
- ``WarmupLR`` and ``WarmupDecayLR`` values, and the config keys that
  raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.models.transformer import masked_cross_entropy as jax_mce
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.convert import opt_state_from_jax, params_from_jax
from deepspeed_tpu_torch.models import llama_model
from deepspeed_tpu_torch.models.transformer import masked_cross_entropy
from deepspeed_tpu_torch.runtime import lr_schedules as tlr

V = 1024
ADAMW = {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}}


@pytest.fixture(scope="module")
def pallas_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DSTPU_ATTN", "pallas")
        mp.setenv("DSTPU_OPT_KERNEL", "pallas")
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        yield


def _batch(seed=0, B=8, S=64):
    return {"input_ids": np.random.default_rng(seed).integers(0, V, size=(B, S))}


def _dtype(cfg):
    return "bfloat16" if cfg.get("bf16", {}).get("enabled") else (
        "float16" if cfg.get("fp16", {}).get("enabled") else "float32")


def _jax_run(cfg, steps, batch, *, gas=1):
    """The JAX engine at micro 1 on the 8-device mesh: (initial params,
    losses, final params, engine)."""
    dt = _dtype(cfg)
    model = jax_llama("llama2-tiny", dtype=getattr(jnp, dt))
    jcfg = dict(cfg, train_micro_batch_size_per_gpu=1, gradient_accumulation_steps=gas)
    eng, *_ = deepspeed_tpu.initialize(model=model, config=jcfg, seed=7)
    init = params_from_jax(jax.device_get(eng.state["params"]))
    losses = [float(eng.train_batch(batch)) for _ in range(steps)]
    return init, losses, params_from_jax(jax.device_get(eng.state["params"])), eng


def _port(cfg, init, *, gas=1):
    dt = _dtype(cfg)
    model = llama_model("llama2-tiny", dtype=getattr(torch, dt))
    tcfg = dict(cfg, train_micro_batch_size_per_gpu=8, gradient_accumulation_steps=gas)
    eng, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=model, config=tcfg, model_parameters=init, device="cpu")
    assert opt is eng.optimizer and sched is eng.lr_scheduler and loader is None
    return eng


def _close_losses(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


def test_loss_matches_jax_at_entry_shape():
    jm = jax_llama("llama2-tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    ids = np.random.default_rng(1).integers(0, V, size=(2, 64))
    want = float(jm.loss(params, {"input_ids": jnp.asarray(ids)}))
    tm = llama_model("llama2-tiny", dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    got = float(tm.loss({"input_ids": torch.from_numpy(ids)}))
    assert abs(got - want) <= 1e-5 * abs(want)

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 64, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, size=(2, 64))
    labels[:, -5:] = -100
    extra = (rng.random((2, 64)) > 0.3).astype(np.float32)
    want = float(jax_mce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(extra)))
    got = float(masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                     torch.from_numpy(extra)))
    assert abs(got - want) <= 1e-6 * abs(want)


FP32_CFG = {"optimizer": ADAMW, "gradient_clipping": 1.0,
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": 3e-3, "warmup_num_steps": 3,
                "warmup_type": "linear"}}}


def test_train_trajectory_fp32(pallas_env):
    batch = _batch()
    init, want, jfinal, _ = _jax_run(FP32_CFG, 5, batch)
    eng = _port(FP32_CFG, init)
    got = [float(eng.train_batch(batch)) for _ in range(5)]
    _close_losses(got, want, 1e-5)
    assert eng.global_steps == 5 and eng.opt_state["step"] == 5
    for name, p in eng.module_state_dict().items():
        np.testing.assert_allclose(p.numpy(), jfinal[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_train_trajectory_bf16_with_clipping(pallas_env):
    cfg = {"optimizer": ADAMW, "gradient_clipping": 1.0, "bf16": {"enabled": True}}
    batch = _batch(1)
    init, want, jfinal, _ = _jax_run(cfg, 5, batch)
    eng = _port(cfg, init)
    got = [float(eng.train_batch(batch)) for _ in range(5)]
    _close_losses(got, want, 2e-2)
    assert got[-1] < got[0]
    lr = ADAMW["params"]["lr"]
    for name, p in eng.module_state_dict().items():
        assert p.dtype == torch.bfloat16
        diff = (p.float() - jfinal[name].float()).abs()
        moved = (jfinal[name].float() - init[name].float()).abs().mean()
        assert float(diff.mean()) <= 0.05 * float(moved), name
        assert float(diff.max()) <= 2 * lr * 5, name


def test_split_path_at_gas_2(pallas_env):
    cfg = {"optimizer": ADAMW, "gradient_clipping": 1.0}
    batch = _batch(2)
    init, want, _, jeng = _jax_run(cfg, 3, batch, gas=2)
    eng = _port(cfg, init, gas=2)
    got = [float(eng.train_batch(batch)) for _ in range(3)]
    _close_losses(got, want, 1e-5)
    assert eng.micro_steps == jeng.micro_steps == 6
    assert eng.global_steps == jeng.global_steps == 3


def test_fp16_overflow_skips_the_step_and_halves_the_scale(pallas_env):
    cfg = {"optimizer": ADAMW, "fp16": {"enabled": True, "initial_scale_power": 32,
                                        "hysteresis": 1}}
    batch = _batch(3)
    init, _, jfinal, jeng = _jax_run(cfg, 2, batch)
    eng = _port(cfg, init)
    for _ in range(2):
        eng.train_batch(batch)
    assert eng.skipped_steps == jeng.skipped_steps == 2
    assert eng.loss_scale() == float(jeng.loss_scale()) == 2.0 ** 30
    for name, p in eng.module_state_dict().items():   # nothing was applied
        torch.testing.assert_close(p, init[name], rtol=0, atol=0)
        torch.testing.assert_close(p, jfinal[name], rtol=0, atol=0)
    assert eng.opt_state["step"] == 0 and eng.lr_scheduler.last_batch_iteration == 0


def test_start_mid_run_from_the_jax_optimizer_state(pallas_env):
    cfg = {"optimizer": ADAMW, "gradient_clipping": 1.0}
    batch = _batch(4)
    _, _, mid, jeng = _jax_run(cfg, 2, batch)
    opt = opt_state_from_jax(jax.device_get(jeng.state["opt"]))
    want = [float(jeng.train_batch(batch)) for _ in range(2)]
    eng = _port(cfg, mid)
    eng.load_opt_state(opt)
    assert eng.opt_state["step"] == 2
    got = [float(eng.train_batch(batch)) for _ in range(2)]
    _close_losses(got, want, 1e-5)


def test_lr_schedules_match_jax():
    kinds = [(tlr.warmup_lr, jlr.warmup_lr, dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2,
                                                 warmup_num_steps=10)),
             (tlr.warmup_lr, jlr.warmup_lr, dict(warmup_max_lr=1e-3, warmup_num_steps=7,
                                                 warmup_type="linear")),
             (tlr.warmup_decay_lr, jlr.warmup_decay_lr,
              dict(total_num_steps=50, warmup_max_lr=1e-3, warmup_num_steps=5))]
    for tf, jf, kw in kinds:
        ts, js = tf(**kw), jf(**kw)
        for _ in range(60):
            assert ts.get_lr() == js.get_lr()
            ts.step()
            js.step()


@pytest.mark.parametrize("key,value,item", [
    ("zero_optimization", {"stage": 2, "offload_optimizer": {"device": "cpu"}}, "A9"),
    ("pipeline", {"stages": 2}, "A10"),
    ("topology", {"model": 2}, "A6"),
    ("hybrid_engine", {"enabled": True}, "A12"),
])
def test_unported_config_raises(key, value, item):
    with pytest.raises(NotImplementedError, match=item):
        deepspeed_tpu_torch.DeepSpeedConfig({key: value})


def test_initialize_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=llama_model("llama2-tiny"), config={})
