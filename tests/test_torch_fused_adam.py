"""Parity of the port's fused Adam step (``deepspeed_tpu_torch/ops/adam/adam.py``
and the fused path of ``runtime/optimizers.py``) with the JAX Pallas kernel
run in interpret mode (``adam_bucket_update(..., interpret=True)``), on the
same numpy inputs:

- the counter hash and the (step, slot, bucket) seeds: bitwise;
- one bucket in modes adam / adamw / lamb, fp32 and bf16 grads, fp32 and
  stochastically rounded bf16 moments, a grad scale, a param cast and a
  length that is no multiple of 128: fp32 moments, masters and the cast
  within rtol 1e-6; the stochastic rounding of the same fp32 moment gives
  the Pallas kernel's bf16 bits, and the port's bf16 moments equal the
  kernel's wherever the fp32 values before rounding agree.
  The port computes the kernel's chain as written, with no fused
  multiply-add; XLA's CPU backend, which runs the Pallas kernel in
  interpret mode, contracts ``b1 * m + (1 - b1) * g`` into one, so fp32
  moments differ by an ulp in places (an SR bit flips only if that ulp
  carries into bit 16), and ``1 - b**t`` is an fp32 pow on both sides;
- ``_plan_opt_buckets`` and ``bucket_geometry``: the same plans;
- the optimizer (adamw, lamb, muadam, muadamw) over a dict of small
  leaves (fused buckets with lane padding) and one leaf at the cap: three steps with fp32 moments within
  rtol 1e-6; a first step from zero bf16 moments, where the fp32 chain is
  exact on both sides, with the SR bits equal.

On the CPU the port runs its plain version; ``chip_smoke.py`` holds the CUDA
kernel to that plain version on the GPU, the SR moments bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam import pallas_adam as jadam
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu_torch.ops.adam import adam as tadam
from deepspeed_tpu_torch.runtime import optimizers as topt
from tests.port_threads import torch_threads  # noqa: F401

MASTER_TOL = dict(rtol=1e-6, atol=1e-7)


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


def _same_moments(t, j):
    """bf16 (stochastically rounded) moments bitwise, fp32 ones to an ulp."""
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), _np(j))
    else:
        np.testing.assert_allclose(t.numpy(), _np(j), **MASTER_TOL)


def test_hash_and_seeds_are_bitwise():
    idx = np.concatenate([np.arange(4096), np.random.default_rng(0).integers(
        0, 2 ** 32, size=4096)]).astype(np.uint32)
    want = _np(jadam._hash32(jnp.asarray(idx)))
    got = tadam._hash32(torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    for step in (1, 2, 7, 1000, 2 ** 31 + 5):
        for slot in (1, 2, 3):
            for bucket in (0, 1, 17):
                assert tadam.sr_seed(step, slot, bucket) == int(jadam.sr_seed(step, slot, bucket))


def _bucket(n, g_dtype, m_dtype, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=n).astype(np.float32)
    p = rng.normal(size=n).astype(np.float32)
    m = (rng.normal(size=n) * 0.1).astype(np.float32)
    v = np.abs(rng.normal(size=n) * 0.01).astype(np.float32)
    cast = lambda a, dt: jnp.asarray(a).astype(dt)
    return (cast(g, g_dtype), jnp.asarray(p), cast(m, m_dtype), cast(v, m_dtype))


def _pallas(g, p, m, v, mdt, seeds, **kw):
    return jadam.adam_bucket_update(
        g, p, m, v, grad_scale=jnp.float32(0.37), m_dtype=mdt, v_dtype=mdt,
        param_dtype=jnp.bfloat16, seed_m=jnp.uint32(seeds["seed_m"]),
        seed_v=jnp.uint32(seeds["seed_v"]), interpret=True, **kw)


@pytest.mark.parametrize("mode", ["adam", "adamw", "lamb"])
@pytest.mark.parametrize("g_dtype,m_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_bucket_update_matches_pallas(mode, g_dtype, m_dtype):
    n = 3 * 128 + 77
    step = 3
    g, p, m, v = _bucket(n, getattr(jnp, g_dtype), getattr(jnp, m_dtype), seed=1)
    seeds = dict(seed_m=int(jadam.sr_seed(step, 1, 4)), seed_v=int(jadam.sr_seed(step, 2, 4)))
    kw = dict(step=step, lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.1,
              mode=mode)
    jout = _pallas(g, p, m, v, getattr(jnp, m_dtype), seeds, **kw)
    tdt = getattr(torch, m_dtype)
    tout = tadam.adam_bucket_update(
        _t(g), _t(p), _t(m), _t(v), grad_scale=torch.tensor(0.37),
        m_dtype=tdt, v_dtype=tdt, param_dtype=torch.bfloat16, **seeds, **kw)
    np.testing.assert_allclose(tout[0].numpy(), _np(jout[0]), **MASTER_TOL)
    if mode == "lamb":
        assert tout[1] is None and jout[1] is None
    else:
        np.testing.assert_allclose(tout[1].float().numpy(),
                                   np.asarray(jout[1]).astype(np.float32), rtol=1e-2)
    if m_dtype == "float32":
        for i in (2, 3):
            np.testing.assert_allclose(tout[i].numpy(), _np(jout[i]), **MASTER_TOL)
        return
    # bf16: the fp32 moments before rounding, from the same inputs, on both
    # sides; the SR of the same fp32 value gives the same bits, and the
    # port's own stores equal the kernel's wherever its fp32 values do
    j32 = _pallas(g, p, m.astype(jnp.float32), v.astype(jnp.float32), jnp.float32,
                  seeds, **kw)
    t32 = tadam.adam_bucket_update(
        _t(g), _t(p), _t(m).float(), _t(v).float(), grad_scale=torch.tensor(0.37),
        param_dtype=torch.bfloat16, **seeds, **kw)
    for i, seed in ((2, seeds["seed_m"]), (3, seeds["seed_v"])):
        want = _np(jout[i])
        sr = tadam._store(_t(j32[i]), torch.bfloat16, seed, True)
        np.testing.assert_array_equal(sr.view(torch.int16).numpy().view(np.uint16), want)
        same = t32[i].numpy() == _np(j32[i])
        assert same.mean() > 0.5
        got = tout[i].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got[same], want[same])


def test_inplace_update_writes_the_state():
    g, p, m, v = _bucket(300, jnp.float32, jnp.bfloat16, seed=2)
    tp, tm, tv = _t(p), _t(m), _t(v)
    want = tadam.adam_bucket_update(_t(g), tp, tm, tv, step=1, lr=1e-3,
                                    m_dtype=torch.bfloat16, v_dtype=torch.bfloat16,
                                    seed_m=5, seed_v=6)
    out = torch.empty(300, dtype=torch.bfloat16)
    got = tadam.adam_bucket_update(_t(g), tp, tm, tv, step=1, lr=1e-3,
                                   m_dtype=torch.bfloat16, v_dtype=torch.bfloat16,
                                   seed_m=5, seed_v=6, param_dtype=torch.bfloat16,
                                   inplace=True, param_out=out)
    assert got[0] is tp and got[2] is tm and got[3] is tv and got[1] is out
    torch.testing.assert_close(tp, want[0], rtol=0, atol=0)
    torch.testing.assert_close(tm, want[2], rtol=0, atol=0)
    torch.testing.assert_close(out, want[0].to(torch.bfloat16), rtol=0, atol=0)


def test_bucket_plans_match():
    rng = np.random.default_rng(3)
    for _ in range(20):
        sizes = [int(s) for s in rng.integers(1, 3000, size=int(rng.integers(1, 30)))]
        keys = [str(k) for k in rng.integers(0, 2, size=len(sizes))]
        cap = int(rng.integers(100, 5000))
        assert topt._plan_opt_buckets(sizes, keys, cap) == \
            jopt._plan_opt_buckets(sizes, keys, cap)
    for n in (1, 127, 128, 129, 512 * 128, 512 * 128 + 1, 11534336):
        assert tadam.bucket_geometry(n) == jadam.bucket_geometry(n)


@pytest.mark.parametrize("name,moments", [("adamw", "float32"), ("adamw", "bfloat16"),
                                          ("lamb", "float32"), ("muadam", "float32"),
                                          ("muadamw", "float32")])
def test_optimizer_buckets_match_pallas(name, moments):
    """Leaves named so that JAX's sorted flattening keeps their order: the
    two sides build the same buckets (lane-padded small leaves, one leaf at
    the cap standing alone), so even the SR draws agree."""
    shapes = {"a0": (3, 100), "a1": (128,), "a2": (7, 7), "a3": (40, 64), "a4": (5,),
              "a5": (300,)}
    cap = 2560
    rng = np.random.default_rng(4)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mdt = getattr(jnp, moments)
    jo = jopt.Optimizer(name=name, lr=1e-2, weight_decay=0.1, moment_dtype=mdt,
                        moment_sq_dtype=mdt)
    to = topt.Optimizer(name=name, lr=1e-2, weight_decay=0.1,
                        moment_dtype=getattr(torch, moments),
                        moment_sq_dtype=getattr(torch, moments))
    jstate = jo.init({k: jnp.asarray(a) for k, a in params.items()})
    tparams = {k: torch.from_numpy(a.copy()) for k, a in params.items()}
    tstate = to.init(tparams, bucket_elems=cap)
    assert [b.names for b in tstate["buckets"]] == [["a0", "a1", "a2"], ["a3"], ["a4", "a5"]]
    for step in range(1 if moments == "bfloat16" else 3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jmaster, jstate = jo.update({k: jnp.asarray(a) for k, a in grads.items()}, jstate,
                                    1e-2, grad_scale=jnp.float32(0.5), kernel="pallas",
                                    bucket_elems=cap)
        to.update({k: torch.from_numpy(a) for k, a in grads.items()}, tstate, 1e-2,
                  grad_scale=torch.tensor(0.5), params_out=tparams)
        for k in shapes:
            np.testing.assert_allclose(tstate["master"][k].numpy(), _np(jstate["master"][k]),
                                       **MASTER_TOL)
            np.testing.assert_allclose(tparams[k].numpy(), _np(jmaster[k]), **MASTER_TOL)
            for slot in ("exp_avg", "exp_avg_sq"):
                _same_moments(tstate[slot][k], jstate[slot][k])
    assert tstate["step"] == int(jstate["step"])


def test_unported_optimizers_raise():
    """muadam / muadamw build (as adam / adamw on the fused kernel, and
    musgd as sgd); unknown names still raise; the 1-bit family builds its
    own optimizers (``runtime/fp16/onebit``) with the JAX defaults."""
    C = lambda t: type("C", (), {"type": t, "params": {"lr": 1e-3}})()
    assert [topt.build_optimizer(C(t)).name for t in ("MuAdam", "MuAdamW", "MuSGD")] == \
        ["muadam", "muadamw", "sgd"]
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.Optimizer(name="lion8bit")
    onebit = topt.build_optimizer(type("C", (), {"type": "OneBitAdam", "params": {}})())
    assert (onebit.name, onebit.freeze_step, onebit.lr) == ("onebit_adam", 100, 1e-3)
