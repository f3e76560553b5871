"""The port's mixture of experts (``moe/sharded_moe.py``, ``moe/layer.py``,
``ops/transformer/moe.py``) against the JAX package on the same numpy
inputs, on the CPU: the port's wrappers run their plain versions there, the
JAX side runs the Pallas kernels in interpret mode, as
``tests/unit/ops/test_pallas_moe.py`` does. ``chip_smoke.py`` holds the CUDA
kernels to these plain versions on the GPU.

- routing: ``top_k_gating_indices`` and ``moe_route`` against the JAX
  gating and the Pallas route kernel: picks, positions, keep flags,
  ``src``, ``slot_tk`` and ``ce`` bitwise; the weights bitwise or within
  ``W_ULPS`` fp32 ulp (XLA's CPU ``exp`` and torch's may differ by an ulp);
  ``me`` and ``aux`` to 1e-5 relative (sums over the tokens in other
  orders); top_k 1 and 2, tight capacities that drop choices, dead experts,
  ties, bf16 logits (routed as their fp32 cast), and the token counts
  where the CUDA route changes form (1, 32, 33, 1025);
- the MoE module without aux (serving): the same output, no aux;
- the dispatch gather byte-identical, with and without the wire cast;
- the grouped FFN with its fused combine, the split FFN and the combine
  against the Pallas kernels, and the whole forward against
  ``make_moe_forward`` and ``moe_reference_forward``: fp32 to 1e-5
  (silu_gated and gelu), aux to 1e-5 relative; bf16 to 5e-2 (the JAX
  suite's bounds); the split FFN's rows of empty slots are zeros (the JAX
  kernel computes them from token 0's row; nothing reads them with a
  non-zero weight);
- the fused and split forms bit-identical;
- the combine's plain version against the Pallas combine at top_k 1 and 2,
  with dropped choices (slot 0, weight 0) and more than 256 tokens (the
  split form's waves), and its kernel's launch plan (``plan_combine``) at T
  8 to 4096: every unit of a row held by exactly one thread of its token's
  group, no block without a token;
- what is not served raises ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.moe.layer import MoE as JaxMoE
from deepspeed_tpu.moe.layer import moe_reference_forward as jax_reference_forward
from deepspeed_tpu.moe.sharded_moe import capacity as jax_capacity
from deepspeed_tpu.moe.sharded_moe import top_k_gating_indices as jax_gating
from deepspeed_tpu.ops.transformer import pallas_moe as pm
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.moe import MoE, capacity, moe_reference_forward, top_k_gating_indices
from deepspeed_tpu_torch.ops.transformer import moe
from tests.port_threads import torch_threads  # noqa: F401

T, E, H, F = 32, 4, 16, 32
W_ULPS = 4
FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)


def _np_params(activation="silu_gated", seed=0, e=E, h=H, f=F):
    """JAX-layout MoE params from numpy: gate [H, E], wi* [E, H, F], wo [E, F, H]."""
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    p = {"gate": w(h, e), "wo": w(e, f, h)}
    if activation == "silu_gated":
        p["wi_gate"], p["wi_up"] = w(e, h, f), w(e, h, f)
    else:
        p["wi"] = w(e, h, f)
    return p


def _port_params(p, dtype=torch.float32):
    """The same weights in the port's layout (the convert transposes)."""
    tree = params_from_jax({"blocks": {"moe": {k: v[None] for k, v in p.items()}}})
    return {k.rpartition(".")[2]: v.to(dtype) for k, v in tree.items()}


def _jax_params(p, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


def _tokens(seed=1, t=T, h=H):
    return np.random.default_rng(seed).standard_normal((t, h)).astype(np.float32)


def _logits(seed=2, t=T, e=E):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _assert_ulps(got, want, ulps=W_ULPS):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_less(np.abs(got - want), ulps * 2.0 ** -23 * np.abs(want) + 1e-38)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,cf,mn", [(32, 1.25, 4), (5, 1.25, 4), (512, 8.0, 1), (8, 8.0, 1),
                                     (3, 0.5, 1)])
def test_capacity_matches_jax(n, cf, mn):
    assert capacity(n, 8, cf, mn) == jax_capacity(n, 8, cf, mn)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cap", [6, 32])
def test_gating_indices_match_jax(top_k, cap):
    logits = _logits()
    want = jax_gating(jnp.asarray(logits), top_k, cap)
    got = top_k_gating_indices(torch.from_numpy(logits), top_k, cap)
    for i, name in enumerate(("expert_idx", "pos", "keep")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=name)
    _assert_ulps(got[3].numpy(), want[3])
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]), rtol=1e-5)


def _route_both(logits, top_k, cap):
    got = moe.moe_route(torch.from_numpy(np.array(logits)), top_k=top_k, capacity=cap)
    want = pm.moe_route(jnp.asarray(logits), top_k=top_k, capacity=cap, interpret=True)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_route_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0], err_msg="src")
    np.testing.assert_array_equal(got[2], want[2], err_msg="slot_tk")
    np.testing.assert_array_equal(got[5], want[5], err_msg="ce")
    _assert_ulps(got[1], want[1])
    _assert_ulps(got[3], want[3])
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cap", [6, 10, 32])
def test_route_matches_pallas_kernel(top_k, cap):
    """cap 6 and 10 drop choices, 32 is dropless."""
    _assert_route_equal(*_route_both(_logits(), top_k, cap))


def test_route_dead_experts_and_overflow():
    """Every token wants expert 0 first: it overflows, experts 2 and 3 are
    dead."""
    logits = np.tile(np.array([[9.0, 1.0, 0.5, 0.0]], np.float32), (T, 1))
    got, want = _route_both(logits, 2, 4)
    _assert_route_equal(got, want)
    assert (got[0][:8] > 0).all() and not (got[0][8:] > 0).any()


@pytest.mark.parametrize("t,e,cf,dead", [(40, 4, None, None), (300, 8, None, None),
                                         (257, 8, None, 3), (300, 8, 1.0, None),
                                         (100, 6, 1.25, 0), (1030, 8, None, 5)])
def test_wave_tiles_name_every_filled_tile_once(t, e, cf, dead):
    """The FFN kernel's wave form (``csrc/moe_ffn.cu`` ``moe_wave``, above 16
    slots an expert) has each (column tile, expert) block find one past the
    expert's last filled slot in ``src`` and walk the 64-slot row tiles
    below it. On the route's ``src`` that names every (expert, row tile,
    column tile) holding a filled slot once and no empty one, with a dead
    expert, capacity-dropped routes, and more than the 256 rows one weight
    stream covers."""
    logits = _logits(seed=7, t=t, e=e)
    if dead is not None:
        logits[:, dead] = -100.0
    cap = capacity(t, e, cf if cf else float(e), 4 if cf else 1)
    src = moe.moe_route(torch.from_numpy(logits), top_k=2, capacity=cap)[0]
    slots = src.view(e, cap) > 0
    pos = torch.arange(1, cap + 1)
    rows = torch.where(slots, pos, 0).amax(dim=1)   # the kernel's count, block by block
    tile, col_tiles = 64, 3
    walked = [(x, r, c) for x in range(e) for r in range(-(-int(rows[x]) // tile))
              for c in range(col_tiles)]
    filled = {(x, r, c) for x in range(e) for r in range(-(-cap // tile))
              for c in range(col_tiles) if bool(slots[x, r * tile:(r + 1) * tile].any())}
    assert len(walked) == len(set(walked)) and set(walked) == filled
    assert int(slots.sum()) == int(rows.sum())   # the route fills each expert from slot 0
    if dead is not None:
        assert int(rows[dead]) == 0
    if cf is not None:
        assert int(slots.sum()) < 2 * t          # choices were dropped
    assert cap > 16                               # the kernel takes its wave form here


def test_route_ties_pick_the_lowest_index():
    """Equal logits give equal gates: the lowest index wins, on both sides."""
    logits = np.zeros((T, E), np.float32)
    logits[::2, 1] = logits[::2, 3] = 1.0
    got, want = _route_both(logits, 2, T)
    _assert_route_equal(got, want)
    idx = top_k_gating_indices(torch.from_numpy(logits), 2, T)[0].numpy()
    np.testing.assert_array_equal(idx[0], [1, 3])
    np.testing.assert_array_equal(idx[1], [0, 1])


def test_route_aux_matches_gating():
    logits = _logits(seed=5)
    src, slot_w, slot_tk, w_tk, me, ce = moe.moe_route(torch.from_numpy(logits), top_k=2,
                                                       capacity=10)
    aux = float((me * ce).sum() * E)
    np.testing.assert_allclose(aux, float(jax_gating(jnp.asarray(logits), 2, 10)[4]), rtol=1e-5)


def test_route_bf16_router_product_ties():
    """bf16 router logits (equal values are common) route the same way."""
    p = _np_params()
    x = _bf16_np(_tokens())
    logits = np.asarray((jnp.asarray(x, jnp.bfloat16)
                         @ jnp.asarray(p["gate"], jnp.bfloat16)).astype(jnp.float32))
    _assert_route_equal(*_route_both(logits, 2, 12))


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_bf16_logits_match_pallas_kernel(top_k):
    """bf16 logits go to the route uncast (the kernel casts them as it loads
    them, as the JAX kernel's body does): the route of the bf16 tensor is
    the route of its fp32 cast, and matches the Pallas kernel fed the same
    bf16 array."""
    logits = jnp.asarray(_logits(seed=3), jnp.bfloat16)
    bf = torch.from_numpy(np.array(logits.astype(jnp.float32))).to(torch.bfloat16)
    got = moe.moe_route(bf, top_k=top_k, capacity=10)
    for g, w in zip(got, moe.moe_route(bf.float(), top_k=top_k, capacity=10)):
        assert torch.equal(g, w)
    want = pm.moe_route(logits, top_k=top_k, capacity=10, interpret=True)
    _assert_route_equal([g.numpy() for g in got], [np.asarray(w) for w in want])


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("t", [1, 32, 33, 1025])
def test_route_matches_pallas_kernel_where_the_forms_change(t, top_k):
    """Token counts where the CUDA route changes hands: one warp up to 32
    tokens, one block above, chunks of 1024 tokens past 1024; capacities
    from the training rule (factor 1.25, at least 4), which drop choices
    at the larger counts."""
    cap = capacity(t, E, 1.25, 4)
    _assert_route_equal(*_route_both(_logits(seed=4, t=t), top_k, cap))


# ---------------------------------------------------------------------------
# dispatch gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,wire", [(torch.float32, None), (torch.bfloat16, None),
                                        (torch.float32, torch.bfloat16)])
def test_gather_byte_identical(dtype, wire):
    x = _bf16_np(_tokens()) if dtype == torch.bfloat16 else _tokens()
    src = pm.moe_route(jnp.asarray(_logits()), top_k=2, capacity=10, interpret=True)[0]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    want = pm.moe_dispatch_gather(jnp.asarray(x, jdt[dtype]), src,
                                  wire_dtype=None if wire is None else jdt[wire],
                                  interpret=True)
    got = moe.moe_dispatch_gather(torch.from_numpy(x).to(dtype),
                                  torch.from_numpy(np.asarray(src)), wire_dtype=wire)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert got.dtype == (wire or dtype)


# ---------------------------------------------------------------------------
# grouped FFN, combine, forward
# ---------------------------------------------------------------------------


def _jax_route_payload(p, x, top_k, cap):
    """The JAX route and payload of one case, fed to both sides' FFNs."""
    jp = _jax_params(p)
    logits = jnp.asarray(x) @ jp["gate"]
    src, slot_w, slot_tk, w_tk, _, _ = pm.moe_route(logits, top_k=top_k, capacity=cap,
                                                    interpret=True)
    payload = pm.moe_dispatch_gather(jnp.asarray(x), src, interpret=True).reshape(E, cap, H)
    return jp, (src, slot_w, slot_tk, w_tk), payload


def _ffn_args(tp, activation):
    gated = activation == "silu_gated"
    return (tp["wi_gate"] if gated else tp["wi"], tp["wi_up"] if gated else None, tp["wo"])


def _jax_ffn_args(jp, activation):
    gated = activation == "silu_gated"
    return (jp["wi_gate"] if gated else jp["wi"], jp.get("wi_up"), jp["wo"])


@pytest.mark.parametrize("activation", ["silu_gated", "gelu"])
@pytest.mark.parametrize("top_k,cap", [(1, 10), (2, 10), (2, 6)])
def test_ffn_combine_matches_pallas(activation, top_k, cap):
    p, x = _np_params(activation), _tokens()
    jp, (src, slot_w, _, _), payload = _jax_route_payload(p, x, top_k, cap)
    want = pm.moe_ffn_combine(payload, *_jax_ffn_args(jp, activation), src, slot_w, T,
                              activation=activation, interpret=True)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = moe.moe_ffn_combine(t(payload), *_ffn_args(_port_params(p), activation), t(src),
                              t(slot_w), T, activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("activation", ["silu_gated", "gelu"])
@pytest.mark.parametrize("top_k,cap", [(2, 10), (2, 6), (1, 4)])
def test_split_ffn_and_combine_match_pallas(activation, top_k, cap):
    p, x = _np_params(activation), _tokens()
    jp, (src, _, slot_tk, w_tk), payload = _jax_route_payload(p, x, top_k, cap)
    y_want = np.asarray(pm.moe_ffn(payload, *_jax_ffn_args(jp, activation),
                                   activation=activation, interpret=True))
    t = lambda a: torch.from_numpy(np.asarray(a))
    y = moe.moe_ffn(t(payload), *_ffn_args(_port_params(p), activation), t(src),
                    activation=activation).numpy()
    filled = np.asarray(src).reshape(E, cap) > 0
    np.testing.assert_allclose(y[filled], y_want[filled], **FP32)
    assert not y[~filled].any()
    # the combine of the same y: one product a term, no FMA on either side
    # is promised (XLA may contract), so to an ulp of the sum
    want = pm.moe_combine(jnp.asarray(y.reshape(E * cap, H)), slot_tk, w_tk, interpret=True)
    got = moe.moe_combine(t(y.reshape(E * cap, H)), t(slot_tk), t(w_tk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("activation", ["silu_gated", "gelu"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("limit", [T, T - 1])
def test_forward_matches_jax(activation, top_k, limit, monkeypatch):
    """The port's forward, in the fused form (``limit`` T) and the split one
    (T - 1), against the Pallas composition and the JAX reference forward,
    fp32, with drops (capacity 10 of 32 tokens)."""
    monkeypatch.setattr(moe, "MOE_FUSED_COMBINE_MAX_TOKENS", limit)
    p, x = _np_params(activation), _tokens()
    jp = _jax_params(p)
    cap = 10
    ref, aux_r = jax_reference_forward(jp, jnp.asarray(x), top_k=top_k, capacity=cap,
                                       activation=activation, mask_pad=False)
    kern, aux_k = jax.jit(pm.make_moe_forward(top_k=top_k, capacity=cap, activation=activation,
                                              mask_pad=False, interpret=True))(jp, jnp.asarray(x))
    fwd = moe.make_moe_forward(top_k=top_k, capacity=cap, activation=activation)
    out, aux = fwd(_port_params(p), torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), **FP32)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_k), rtol=1e-5)


@pytest.mark.parametrize("activation", ["silu_gated", "gelu"])
def test_forward_bf16_matches_jax(activation):
    p, x = _np_params(activation, seed=3), _bf16_np(_tokens(seed=4))
    jp = _jax_params(p, jnp.bfloat16)
    ref, _ = jax_reference_forward(jp, jnp.asarray(x, jnp.bfloat16), top_k=2, capacity=T,
                                   activation=activation, mask_pad=False)
    fwd = moe.make_moe_forward(top_k=2, capacity=T, activation=activation)
    out, _ = fwd(_port_params(p, torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **BF16)


@pytest.mark.parametrize("activation", ["silu_gated", "gelu"])
@pytest.mark.parametrize("cap", [6, 32])
def test_port_reference_forward_matches_jax(activation, cap):
    p, x = _np_params(activation, seed=7), _tokens(seed=8)
    ref, aux_r = jax_reference_forward(_jax_params(p), jnp.asarray(x), top_k=2, capacity=cap,
                                       activation=activation, mask_pad=False)
    out, aux = moe_reference_forward(_port_params(p), torch.from_numpy(x), top_k=2,
                                     capacity=cap, activation=activation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)


@pytest.mark.parametrize("top_k,cap", [(2, 32), (2, 6), (1, 10)])
def test_fused_and_split_bitwise(top_k, cap, monkeypatch):
    p, x = _np_params(seed=9), torch.from_numpy(_tokens(seed=10))
    fwd = moe.make_moe_forward(top_k=top_k, capacity=cap, activation="silu_gated")
    outs = []
    for limit in (T, T - 1):
        monkeypatch.setattr(moe, "MOE_FUSED_COMBINE_MAX_TOKENS", limit)
        outs.append(fwd(_port_params(p), x))
    (fused, aux_f), (split, aux_s) = outs
    assert torch.equal(fused, split) and torch.equal(aux_f, aux_s)


def test_threshold_chooses_the_form(monkeypatch):
    p, x = _np_params(seed=11), torch.from_numpy(_tokens(seed=12))
    tp = _port_params(p)
    fwd = moe.make_moe_forward(top_k=2, capacity=T, activation="silu_gated")
    for limit, form in ((T, "moe_ffn_combine"), (T - 1, "moe_ffn")):
        monkeypatch.setattr(moe, "MOE_FUSED_COMBINE_MAX_TOKENS", limit)
        calls = []
        for name in ("moe_ffn_combine_reference", "moe_ffn_reference"):
            orig = getattr(moe, name)
            monkeypatch.setattr(moe, name, lambda *a, _o=orig, _n=name, **k: (
                calls.append(_n), _o(*a, **k))[1])
        fwd(tp, x)
        assert calls[0] == form + "_reference", calls


@pytest.mark.parametrize("activation", ["silu_gated", "gelu"])
@pytest.mark.parametrize("dropless", [False, True])
def test_module_matches_jax_layer(activation, dropless):
    """``MoE.forward`` against the JAX ``MoE.__call__`` (its XLA path on the
    CPU) over [2, 16, H] inputs, with the JAX layer's capacity rule, or the
    serving engine's dropless one."""
    cf, mn = (float(E), 1) if dropless else (1.25, 4)
    jm = JaxMoE(hidden_size=H, intermediate_size=F, num_experts=E, top_k=2,
                capacity_factor=cf, min_capacity=mn, activation=activation)
    jp = jm.init(jax.random.PRNGKey(3), jnp.float32)
    x = _tokens(seed=13).reshape(2, 16, H)
    want, aux_w = jm(jp, jnp.asarray(x))
    m = MoE(H, F, num_experts=E, top_k=2, activation=activation)
    m.load_state_dict(_port_params({k: np.asarray(v) for k, v in jp.items()}))
    got, aux = m(torch.from_numpy(x), dropless=dropless)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(float(aux), float(aux_w), rtol=1e-5)


def test_module_without_aux_gives_the_same_output(monkeypatch):
    """``with_aux=False`` (serving's ``Block.mlp``) builds the forward
    without aux and returns the same output bits and no aux."""
    m = MoE(H, F, num_experts=E, top_k=2)
    m.load_state_dict(_port_params(_np_params(seed=14)))
    x = torch.from_numpy(_tokens(seed=15))
    asked = []
    orig = moe.make_moe_forward
    monkeypatch.setattr(moe, "make_moe_forward",
                        lambda **kw: (asked.append(kw["with_aux"]), orig(**kw))[1])
    out, aux = m(x)
    out_none, none = m(x, with_aux=False)
    assert asked == [True, False]
    assert none is None and aux.dtype == torch.float32 and aux.ndim == 0
    assert torch.equal(out, out_none)


def test_module_init_is_normal_and_seeded():
    m = MoE(64, 96, num_experts=4, top_k=2, device="meta")
    m.to_empty(device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    first = {k: v.clone() for k, v in m.state_dict().items()}
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(first[k], v) for k, v in m.state_dict().items())
    assert {k: tuple(v.shape) for k, v in first.items()} == {
        "gate": (64, 4), "wi_gate": (4, 96, 64), "wi_up": (4, 96, 64), "wo": (4, 64, 96)}
    std = torch.cat([v.flatten() for v in first.values()]).std().item()
    assert abs(std - 0.02) < 2e-3


# ---------------------------------------------------------------------------
# the split combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
def test_combine_with_dropped_choices_matches_pallas(top_k):
    """300 tokens (above the fused form's 256), a third of the choices
    dropped as the route drops them: slot 0, weight 0. One product a term on
    the port's side; XLA may contract the Pallas body's multiply-add, so to
    an ulp of the sum, as the split test above."""
    rng = np.random.default_rng(top_k)
    t, s, h = 300, 640, 64
    y = rng.standard_normal((s, h)).astype(np.float32)
    slot_tk = rng.permutation(s)[:t * top_k].reshape(t, top_k).astype(np.int32)
    w_tk = rng.random((t, top_k)).astype(np.float32)
    slot_tk[::3, -1] = 0
    w_tk[::3, -1] = 0.0
    want = pm.moe_combine(jnp.asarray(y), jnp.asarray(slot_tk), jnp.asarray(w_tk), interpret=True)
    got = moe.moe_combine(torch.from_numpy(y), torch.from_numpy(slot_tk), torch.from_numpy(w_tk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=1e-6)
    # the rows of dropped choices add 0 * y[0]: each token is its kept terms
    kept = sum(w_tk[:, k, None] * y[slot_tk[:, k]] for k in range(top_k - 1))
    last = np.where(w_tk[:, -1:] != 0, w_tk[:, -1:] * y[slot_tk[:, -1]], 0.0)
    np.testing.assert_allclose(got.numpy(), kept + last, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("h", [4096, 14336, 72, 40, 7])
@pytest.mark.parametrize("t", [8, 16, 32, 64, 128, 256, 257, 512, 1024, 2048, 4096])
def test_combine_plan_holds_every_unit_once(t, h, sms):
    for vec in (True, False) if h % 4 == 0 else (False,):
        lanes, units, blocks = moe.plan_combine(t, h, vec, sms)
        n = h // 4 if vec else h
        assert lanes & (lanes - 1) == 0 and lanes <= moe.COMBINE_THREADS
        assert units in (1, 2, 4) and units <= moe.COMBINE_UNITS
        span = lanes * units
        tiles = -(-n // span)
        held = sorted(u for u in (tile * span + j + c * lanes for tile in range(tiles)
                                  for j in range(lanes) for c in range(units)) if u < n)
        assert held == list(range(n))
        assert lanes == 1 or tiles > 1 or (lanes // 2) * units < n
        groups = moe.COMBINE_THREADS // lanes
        assert 1 <= blocks <= moe.COMBINE_BLOCKS_PER_SM * sms
        assert (blocks - 1) * groups < t * tiles        # every block has a token
    if h == 4096 and sms == 132:   # Mixtral: a block a token, 4 units a thread and pick
        assert moe.plan_combine(t, h, True, sms) == (256, 4, min(t, 528))


def test_combine_takes_top_k_1_or_2():
    y = torch.zeros(8, H)
    with pytest.raises(NotImplementedError, match="top_k 3"):
        moe.moe_combine(y, torch.zeros(4, 3, dtype=torch.int32), torch.zeros(4, 3))


# ---------------------------------------------------------------------------
# what is not served
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(top_k=3), "top_k 3"),
    (dict(dtype=torch.float16), "float16"),
    (dict(activation="relu"), "relu"),
    (dict(num_experts=128), "128 experts"),
])
def test_unsupported_raises(kw, match):
    args = dict(num_experts=8, top_k=2, activation="silu_gated", dtype=torch.float32)
    args.update(kw)
    with pytest.raises(NotImplementedError, match=match) as err:
        MoE(16, 32, **args)
    assert "ROADMAP A7" in str(err.value)


def test_wrappers_raise_on_unsupported_inputs():
    x = torch.zeros(4, H, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float16"):
        moe.moe_dispatch_gather(x, torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="fp32 or bf16 logits"):
        moe.moe_route(torch.zeros(4, E, dtype=torch.float16), top_k=2, capacity=4)
    with pytest.raises(NotImplementedError, match="top_k 3"):
        moe.moe_route(torch.zeros(4, E), top_k=3, capacity=4)
