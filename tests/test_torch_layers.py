"""Parity of the port's layers (``deepspeed_tpu_torch/nn/layers.py``) with
``deepspeed_tpu/nn/layers.py``: the same numpy-seeded inputs and weights
through both, fp32, tolerance 1e-6 (both sides compute in fp32; the gap is
summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.nn import layers as jl
from deepspeed_tpu_torch.nn import layers as tl
from tests.port_threads import torch_threads  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return t.detach().numpy()


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_rmsnorm():
    x, scale = _x(0, (3, 5, 32)), _x(1, (32,)) + 1.0
    want = jl.RMSNorm(32)({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    m = tl.RMSNorm(32, device="cpu", dtype=torch.float32)
    m.weight.copy_(torch.from_numpy(scale))
    np.testing.assert_allclose(_np(m(torch.from_numpy(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_layernorm(bias):
    x, scale, b = _x(2, (4, 48), 3.0), _x(3, (48,)), _x(4, (48,))
    params = {"scale": jnp.asarray(scale)}
    m = tl.LayerNorm(48, bias=bias, device="cpu", dtype=torch.float32)
    m.weight.copy_(torch.from_numpy(scale))
    if bias:
        params["bias"] = jnp.asarray(b)
        m.bias.copy_(torch.from_numpy(b))
    want = jl.LayerNorm(48, use_bias=bias)(params, jnp.asarray(x))
    np.testing.assert_allclose(_np(m(torch.from_numpy(x))), np.asarray(want), **TOL)


def test_rmsnorm_bf16_casts_back():
    x = torch.from_numpy(_x(5, (2, 16))).to(torch.bfloat16)
    m = tl.RMSNorm(16, device="cpu", dtype=torch.bfloat16)
    m.reset_parameters()
    assert m(x).dtype == torch.bfloat16


@pytest.mark.parametrize("style", ["half", "interleaved"])
def test_rotary_embedding(style):
    x = _x(6, (2, 9, 4, 16))
    pos = np.stack([np.arange(9), np.arange(9) + 40]).astype(np.int32)
    want = jl.rotary_embedding(jnp.asarray(x), jnp.asarray(pos), 10000.0, style)
    got = tl.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos),
                              10000.0, style)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_layout(bias):
    """JAX kernel [in, out] == the port's weight [out, in] transposed."""
    x, kernel, b = _x(7, (5, 24)), _x(8, (24, 40), 0.02), _x(9, (40,), 0.02)
    params = {"kernel": jnp.asarray(kernel)}
    m = tl.Linear(24, 40, bias=bias, device="cpu", dtype=torch.float32)
    m.weight.copy_(torch.from_numpy(kernel.T.copy()))
    if bias:
        params["bias"] = jnp.asarray(b)
        m.bias.copy_(torch.from_numpy(b))
    want = jl.Linear(24, 40, use_bias=bias)(params, jnp.asarray(x))
    np.testing.assert_allclose(_np(m(torch.from_numpy(x))), np.asarray(want), **TOL)


def test_embedding_clamps_and_attends():
    """Out-of-range ids read the nearest row (``jnp.take(mode='clip')``)."""
    table = _x(10, (11, 8))
    ids = np.array([[0, 3, 10, -4, 25]], np.int32)
    want = jl.Embedding(11, 8)({"embedding": jnp.asarray(table)}, jnp.asarray(ids))
    m = tl.Embedding(11, 8, device="cpu", dtype=torch.float32)
    m.weight.copy_(torch.from_numpy(table))
    np.testing.assert_allclose(_np(m(torch.from_numpy(ids))), np.asarray(want), **TOL)
    x = _x(11, (3, 8))
    want_logits = jl.Embedding(11, 8).attend({"embedding": jnp.asarray(table)},
                                             jnp.asarray(x))
    np.testing.assert_allclose(_np(m.attend(torch.from_numpy(x))),
                               np.asarray(want_logits), **TOL)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activations(name):
    x = _x(12, (64,), 4.0)
    want = getattr(jl, name)(jnp.asarray(x))
    got = getattr(tl, name)(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_init_is_seeded():
    """reset_parameters draws from the given generator: same seed, same
    weights; normal(0, 0.02) like the JAX init."""
    a = tl.Linear(64, 64, device="cpu", dtype=torch.float32)
    b = tl.Linear(64, 64, device="cpu", dtype=torch.float32)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight) and not a.bias.any()
    assert abs(a.weight.std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("rate,deterministic", [(0.0, False), (0.3, True), (0.0, True)])
def test_dropout_is_identity_where_jax_is(rate, deterministic):
    """Bitwise the input, as the JAX layer returns it, at rate 0 or when
    deterministic (no draw is made: the generator does not move)."""
    import jax
    x = _x(5, (6, 40))
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    got = tl.dropout(g, torch.from_numpy(x), rate, deterministic)
    want = jl.dropout(jax.random.PRNGKey(0), jnp.asarray(x), rate, deterministic)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert torch.equal(g.get_state(), state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keeps_its_share_and_the_mean(dtype):
    """Torch cannot draw JAX's bits: held by the kept share (1 - rate, within
    4 standard deviations of a binomial) and the mean (kept elements scaled
    by 1 / (1 - rate)); dropped elements are exactly 0, kept ones x / (1 -
    rate); the same generator seed gives the same mask."""
    rate, n = 0.25, 200_000
    x = torch.ones(n, dtype=dtype)
    out = tl.dropout(torch.Generator().manual_seed(7), x, rate, False)
    assert out.dtype == dtype
    kept = out != 0
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) < 4 * (rate * (1 - rate) / n) ** 0.5
    assert torch.equal(out[kept], (x / (1 - rate))[kept])
    assert abs(out.float().mean().item() - 1.0) < 4 * (rate / (1 - rate) / n) ** 0.5
    again = tl.dropout(torch.Generator().manual_seed(7), x, rate, False)
    assert torch.equal(out, again)
