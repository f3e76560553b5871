"""Parity of the port's fused Lion step (``deepspeed_tpu_torch/ops/lion/lion.py``
and the Lion branch of ``runtime/optimizers.py``) with the JAX Pallas kernel
run in interpret mode (``lion_bucket_update(..., interpret=True)``), on the
same numpy inputs. On the CPU the port runs its plain version;
``chip_smoke.py`` holds the CUDA kernel to that plain version bit for bit on
the GPU.

How the sign is dealt with. The port computes ``b1 * m + (1 - b1) * g`` as
written; XLA's CPU backend, which runs the Pallas kernel in interpret mode,
contracts it into a fused multiply-add. The two differ by an ulp, and where
the two terms cancel to within that ulp the sign flips and the master moves
by ``2 * lr``. So:

- the bitwise case starts from a zero moment (``c = (1 - b1) * g``, one
  product, no sum to contract): master, cast, fp32 moment and the
  stochastically rounded bf16 moment equal the kernel's bits; without weight
  decay ``p - lr * sign`` has an exact product, so the master stays bitwise
  even from random moments whose terms share a sign (no cancellation);
- on random inputs a flipped element is one whose master differs by more
  than ``lr``: at most 0.1% of the elements may flip (none does at these
  sizes), the rest agree to rtol 1e-6 (weight decay's ``sign + wd * p`` is
  contracted too), fp32 moments to rtol 1e-6, and the port's bf16 moments
  equal the kernel's wherever the fp32 values before rounding do;
- the engine trajectory (5 steps, fp32): losses within 1e-4 relative (a
  flipped sign moves one weight by 2 lr = 2e-3 of 3e5), at most 0.1% of the
  final weights further than ``lr`` from JAX's, none further than
  ``2 * lr * steps``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.ops.adam import pallas_adam as jadam
from deepspeed_tpu.ops.lion import pallas_lion as jlion
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu_torch.convert import opt_state_from_jax, params_from_jax
from deepspeed_tpu_torch.models import llama_model
from deepspeed_tpu_torch.ops.adam import adam as tadam
from deepspeed_tpu_torch.ops.lion import lion as tlion
from deepspeed_tpu_torch.runtime import optimizers as topt
from tests.port_threads import torch_threads  # noqa: F401

V = 1024
TOL = dict(rtol=1e-6, atol=1e-7)
FLIP_SHARE = 1e-3
LR = 1e-2
N = 3 * 128 + 77          # no multiple of 128: the Pallas wrapper pads the bucket


def _np(x):
    """A JAX array as numpy, bf16 kept as its raw bits."""
    a = np.asarray(jax.device_get(x))
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _t(a):
    """A numpy or JAX array as a torch tensor, bf16 bits kept."""
    a = np.asarray(jax.device_get(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


def _bucket(g_dtype, m_dtype, seed, moment="random"):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=N).astype(np.float32)
    p = rng.normal(size=N).astype(np.float32)
    m = (rng.normal(size=N) * 0.1).astype(np.float32)
    if moment == "zero":
        m = np.zeros_like(m)
    elif moment == "same-sign":
        m = np.abs(m) * np.sign(g)
    cast = lambda a, dt: jnp.asarray(a).astype(dt)
    return cast(g, g_dtype), jnp.asarray(p), cast(m, m_dtype)


def _both(g, p, m, m_dtype, wd, seed):
    kw = dict(lr=LR, beta1=0.9, beta2=0.99, weight_decay=wd)
    jout = jlion.lion_bucket_update(
        g, p, m, grad_scale=jnp.float32(0.37), m_dtype=getattr(jnp, m_dtype),
        param_dtype=jnp.bfloat16, seed_m=jnp.uint32(seed), interpret=True, **kw)
    tout = tlion.lion_bucket_update(
        _t(g), _t(p), _t(m), grad_scale=torch.tensor(0.37),
        m_dtype=getattr(torch, m_dtype), param_dtype=torch.bfloat16, seed_m=seed, **kw)
    return jout, tout


def _flipped(t_master, j_master):
    return np.abs(t_master - j_master) > LR


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("g_dtype,m_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_bucket_update_matches_pallas(g_dtype, m_dtype, wd):
    seed = int(jadam.sr_seed(3, 1, 4))
    g, p, m = _bucket(getattr(jnp, g_dtype), getattr(jnp, m_dtype), seed=1)
    jout, tout = _both(g, p, m, m_dtype, wd, seed)
    flipped = _flipped(tout[0].numpy(), _np(jout[0]))
    assert flipped.mean() <= FLIP_SHARE
    np.testing.assert_allclose(tout[0].numpy()[~flipped], _np(jout[0])[~flipped], **TOL)
    np.testing.assert_allclose(tout[1].float().numpy()[~flipped],
                               np.asarray(jout[1]).astype(np.float32)[~flipped], rtol=1e-2)
    if m_dtype == "float32":
        np.testing.assert_allclose(tout[2].numpy(), _np(jout[2]), **TOL)
        return
    # bf16: the SR of the kernel's own fp32 moment gives the kernel's bits, and
    # the port's stores equal the kernel's wherever its fp32 values do
    j32, t32 = _both(g, p, m.astype(jnp.float32), "float32", wd, seed)
    want = _np(jout[2])
    sr = tadam._store(_t(j32[2]), torch.bfloat16, seed, True)
    np.testing.assert_array_equal(_bits(sr), want)
    same = t32[2].numpy() == _np(j32[2])
    assert same.mean() > 0.5
    np.testing.assert_array_equal(_bits(tout[2])[same], want[same])


@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_first_step_from_a_zero_moment_is_bitwise(m_dtype, wd):
    """No sum for XLA to contract in the sign or the moment: every output
    has the kernel's bits, the stochastic rounding included. (With weight
    decay ``sign + wd * p`` is contracted: the master is then held to an
    ulp.)"""
    seed = int(jadam.sr_seed(1, 1, 0))
    g, p, m = _bucket(jnp.bfloat16, getattr(jnp, m_dtype), seed=2, moment="zero")
    jout, tout = _both(g, p, m, m_dtype, wd, seed)
    np.testing.assert_array_equal(_bits(tout[2]), _np(jout[2]))
    if wd:
        np.testing.assert_allclose(tout[0].numpy(), _np(jout[0]), **TOL)
    else:
        np.testing.assert_array_equal(tout[0].numpy(), _np(jout[0]))
        np.testing.assert_array_equal(_bits(tout[1]), _np(jout[1]))


def test_no_cancellation_gives_the_kernels_master_bits():
    """Moments with their gradient's sign: the contracted sum cannot change
    sign, and without weight decay the master is bitwise."""
    g, p, m = _bucket(jnp.float32, jnp.float32, seed=3, moment="same-sign")
    jout, tout = _both(g, p, m, "float32", 0.0, 0)
    np.testing.assert_array_equal(tout[0].numpy(), _np(jout[0]))
    assert set(np.unique(np.round((_np(jout[0]) - np.asarray(p)) / LR))) <= {-1.0, 1.0}


def test_sign_of_zero_is_zero_and_decay_is_decoupled():
    z = torch.zeros(256)
    p = torch.linspace(-1, 1, 256)
    out, _, m = tlion.lion_bucket_update(z, p, z.clone(), lr=0.5, weight_decay=0.1)
    torch.testing.assert_close(out, p - 0.5 * (0.1 * p), rtol=0, atol=0)
    assert not m.any()
    out, _, _ = tlion.lion_bucket_update(z, p, z.clone(), lr=0.5)
    torch.testing.assert_close(out, p, rtol=0, atol=0)


def test_inplace_update_writes_the_state():
    g, p, m = _bucket(jnp.float32, jnp.bfloat16, seed=4)
    tp, tm = _t(p), _t(m)
    kw = dict(lr=1e-3, m_dtype=torch.bfloat16, seed_m=5)
    want = tlion.lion_bucket_update(_t(g), tp, tm, **kw)
    out = torch.empty(N, dtype=torch.bfloat16)
    got = tlion.lion_bucket_update(_t(g), tp, tm, param_dtype=torch.bfloat16, inplace=True,
                                   param_out=out, **kw)
    assert got[0] is tp and got[2] is tm and got[1] is out
    torch.testing.assert_close(tp, want[0], rtol=0, atol=0)
    torch.testing.assert_close(tm, want[2], rtol=0, atol=0)
    torch.testing.assert_close(out, want[0].to(torch.bfloat16), rtol=0, atol=0)
    with pytest.raises(ValueError, match="flat"):
        tlion.lion_bucket_update(tp.view(1, -1), tp, tm, lr=1e-3)
    with pytest.raises(ValueError, match="stored"):
        tlion.lion_bucket_update(tp, tp, tm, lr=1e-3)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_optimizer_buckets_match_pallas(moments):
    """Leaves named so that JAX's sorted flattening keeps their order: the
    two sides build the same buckets (lane-padded small leaves, one leaf at
    the cap standing alone), so even the SR draws agree. bf16 moments run
    one step, from zero, where they are bitwise."""
    shapes = {"a0": (3, 100), "a1": (128,), "a2": (7, 7), "a3": (40, 64), "a4": (5,),
              "a5": (300,)}
    cap = 2560
    rng = np.random.default_rng(4)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(name="lion", lr=LR, betas=(0.9, 0.99), weight_decay=0.1)
    jo = jopt.Optimizer(moment_dtype=getattr(jnp, moments), **kw)
    to = topt.Optimizer(moment_dtype=getattr(torch, moments), **kw)
    jstate = jo.init({k: jnp.asarray(a) for k, a in params.items()})
    tparams = {k: torch.from_numpy(a.copy()) for k, a in params.items()}
    tstate = to.init(tparams, bucket_elems=cap)
    assert "exp_avg_sq" not in tstate and "exp_avg_sq" not in jstate
    assert [b.names for b in tstate["buckets"]] == [["a0", "a1", "a2"], ["a3"], ["a4", "a5"]]
    assert all(b.exp_avg_sq is None for b in tstate["buckets"])
    for step in range(1 if moments == "bfloat16" else 3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jmaster, jstate = jo.update({k: jnp.asarray(a) for k, a in grads.items()}, jstate,
                                    LR, grad_scale=jnp.float32(0.5), kernel="pallas",
                                    bucket_elems=cap)
        to.update({k: torch.from_numpy(a) for k, a in grads.items()}, tstate, LR,
                  grad_scale=torch.tensor(0.5), params_out=tparams)
        for k in shapes:
            flipped = _flipped(tstate["master"][k].numpy(), _np(jstate["master"][k]))
            assert not flipped.any(), k
            np.testing.assert_allclose(tstate["master"][k].numpy(), _np(jstate["master"][k]),
                                       **TOL)
            np.testing.assert_allclose(tparams[k].numpy(), _np(jmaster[k]), **TOL)
            if moments == "bfloat16":
                np.testing.assert_array_equal(_bits(tstate["exp_avg"][k]),
                                              _np(jstate["exp_avg"][k]))
            else:
                np.testing.assert_allclose(tstate["exp_avg"][k].numpy(),
                                           _np(jstate["exp_avg"][k]), **TOL)
    assert tstate["step"] == int(jstate["step"])


def test_lion_builds_from_a_config_block():
    block = type("C", (), {"type": "FusedLion", "params": {
        "lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.1}})()
    opt = topt.build_optimizer(block)
    assert (opt.name, opt.lr, opt.betas, opt.weight_decay) == ("lion", 1e-4, (0.9, 0.99), 0.1)
    assert topt.build_optimizer(type("C", (), {"type": "Lion", "params": {}})()).name == "lion"


# ---------------------------------------------------------------------------
# the training engine with Lion against the JAX engine
# ---------------------------------------------------------------------------

LION = {"type": "Lion", "params": {"lr": 1e-3, "betas": [0.9, 0.99], "weight_decay": 0.1}}
CFG = {"optimizer": LION, "gradient_clipping": 1.0}


@pytest.fixture(scope="module")
def pallas_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DSTPU_ATTN", "pallas")
        mp.setenv("DSTPU_OPT_KERNEL", "pallas")
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        yield


def _jax_engine(batch, steps):
    """The JAX engine with its kernels forced, at micro-batch 1 on the
    8-device mesh (a global batch of 8)."""
    model = jax_llama("llama2-tiny", dtype=jnp.float32)
    eng, *_ = deepspeed_tpu.initialize(
        model=model, config=dict(CFG, train_micro_batch_size_per_gpu=1), seed=7)
    init = params_from_jax(jax.device_get(eng.state["params"]))
    losses = [float(eng.train_batch(batch)) for _ in range(steps)]
    return init, losses, eng


def _port_engine(init):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=llama_model("llama2-tiny", dtype=torch.float32),
        config=dict(CFG, train_micro_batch_size_per_gpu=8), model_parameters=init,
        device="cpu")
    return eng


def test_train_trajectory_matches_the_jax_engine(pallas_env):
    batch = {"input_ids": np.random.default_rng(0).integers(0, V, size=(8, 64))}
    steps, lr = 5, LION["params"]["lr"]
    init, want, jeng = _jax_engine(batch, steps)
    eng = _port_engine(init)
    assert eng.optimizer.name == "lion" and "exp_avg_sq" not in eng.opt_state
    got = [float(eng.train_batch(batch)) for _ in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert got[-1] < got[0]
    jfinal = params_from_jax(jax.device_get(jeng.state["params"]))
    far = total = 0
    for name, p in eng.module_state_dict().items():
        diff = (p - jfinal[name]).abs()
        assert float(diff.max()) <= 2 * lr * steps * (1 + 1e-3), name
        far += int((diff > lr).sum())
        total += diff.numel()
    assert far <= FLIP_SHARE * total, (far, total)


def test_start_mid_run_from_a_jax_lion_state(pallas_env):
    batch = {"input_ids": np.random.default_rng(1).integers(0, V, size=(8, 64))}
    _, _, jeng = _jax_engine(batch, 2)
    mid = params_from_jax(jax.device_get(jeng.state["params"]))
    opt = opt_state_from_jax(jax.device_get(jeng.state["opt"]))
    assert set(opt) == {"step", "master", "exp_avg"}
    want = [float(jeng.train_batch(batch)) for _ in range(2)]
    eng = _port_engine(mid)
    eng.load_opt_state(opt)
    assert eng.opt_state["step"] == 2
    for name, m in eng.opt_state["exp_avg"].items():
        torch.testing.assert_close(m, opt["exp_avg"][name], rtol=0, atol=0)
    got = [float(eng.train_batch(batch)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
