"""Parity of the port's flash attention
(``deepspeed_tpu_torch/ops/transformer/flash.py``, through
``flash_attention_with_lse`` and its autograd Function) with the JAX Pallas
kernel pair run in interpret mode, as the JAX suite runs it on the CPU
(``flash_attention_with_lse(..., interpret=True)``), on the same numpy
inputs: O, LSE and the gradients of q, k and v (through dO and a cotangent
on the LSE) across every mask feature (causal, non-causal, window, segment
ids, ALiBi, negative ``q_offset`` with fully masked rows, Sq != Sk), GQA
g in {1, 2, 4} and head_dim in {32, 64}; then every head_dim class the
CUDA kernels added (16, 48, 112, open-llama-3b's 100, an odd 33, 384 and
512) in fp32 and bf16, and every mask feature at head_dim 100. Tolerances
are the JAX suite's
(``tests/unit/ops/test_pallas_flash.py:30-33``): fp32 at ``FP32_TOL`` /
``GRAD_TOL``, bf16 at ``BF16_TOL`` / ``BF16_GRAD_TOL``.

Lengths that are no multiple of the tile, which the Pallas kernel does not
take, are held against the port's ``attention_reference``, itself held
against the JAX ``_xla_attention``.

On the CPU the port runs its plain versions; ``chip_smoke.py`` holds the
CUDA kernels to them on the GPU."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepspeed_tpu.ops.transformer import pallas_flash as jflash
from deepspeed_tpu.ops.transformer.attention import _xla_attention, alibi_slopes
from deepspeed_tpu_torch.ops.transformer import attention as tattn
from deepspeed_tpu_torch.ops.transformer import flash as tflash
from tests.port_threads import torch_threads  # noqa: F401

FP32_TOL = dict(rtol=2e-5, atol=5e-6)
GRAD_TOL = dict(rtol=5e-5, atol=5e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_GRAD_TOL = dict(rtol=6e-2, atol=6e-2)
BLOCK = 32   # Pallas tiles at these small lengths


@pytest.fixture(autouse=True)
def _pallas_compiler_params(monkeypatch):
    """The JAX kernel names ``pltpu.TPUCompilerParams``, which newer JAX
    releases call ``pltpu.CompilerParams``; alias it for these tests so the
    reference runs unchanged under the installed JAX."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


CASES = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window": dict(causal=True, window=24),
    "segids": dict(causal=False, segids=True),
    "segids_causal": dict(causal=True, segids=True),
    "alibi": dict(causal=True, alibi=True),
    "alibi_window": dict(causal=True, alibi=True, window=40),
    "neg_offset": dict(causal=True, q_offset=-40),
    "short_q": dict(causal=True, Sq=32),
}


def _inputs(case, g, D, seed, B=2, S=64, kvH=2):
    rng = np.random.default_rng(seed)
    Sq = case.get("Sq", S)
    H = kvH * g
    arr = lambda *shape: (rng.normal(size=shape) * 0.3).astype(np.float32)
    x = dict(q=arr(B, Sq, H, D), k=arr(B, S, kvH, D), v=arr(B, S, kvH, D),
             do=rng.normal(size=(B, Sq, H, D)).astype(np.float32),
             dlse=rng.normal(size=(B, H, Sq)).astype(np.float32))
    mask = dict(causal=case["causal"])
    if case.get("segids"):
        mask["segment_ids"] = rng.integers(0, 3, (B, S)).astype(np.int32)
    if case.get("alibi"):
        mask["alibi_slopes"] = alibi_slopes(H)
    if "window" in case:
        mask["window"] = case["window"]
    if "q_offset" in case:
        mask["q_offset"] = case["q_offset"]
    return x, mask


def _tile(n):
    """``BLOCK``, or at a length it does not divide the largest divisor up
    to 128 (the Pallas kernel takes no ragged tile)."""
    return BLOCK if n % BLOCK == 0 else max(d for d in range(1, 129) if n % d == 0)


def _jax(x, mask, dtype):
    """O, LSE, dQ, dK, dV of the Pallas pair in interpret mode, the forward
    and its VJP traced into one jitted program (the eager form gives the
    same values and compiles each piece on its own, at twice the cost)."""
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in mask.items()}
    if "window" in kw:
        kw["window"] = jnp.asarray(kw["window"], jnp.int32)
    bq, bk = _tile(x["q"].shape[1]), _tile(x["k"].shape[1])

    def run(q, k, v, do, dlse):
        f = lambda q, k, v: jflash.flash_attention_with_lse(
            q, k, v, block_q=bq, block_k=bk, interpret=True, **kw)
        (o, lse), vjp = jax.vjp(f, q, k, v)
        return (o, lse) + vjp((do, dlse))

    out = jax.jit(run)(*(jnp.asarray(x[n], dtype) for n in ("q", "k", "v", "do")),
                       jnp.asarray(x["dlse"]))
    return [np.asarray(a.astype(jnp.float32)) for a in out]


def _port(x, mask, dtype):
    q, k, v = (torch.tensor(x[n], dtype=dtype, requires_grad=True) for n in "qkv")
    kw = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
          for k_, v_ in mask.items()}
    o, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
    torch.autograd.backward([o, lse], [torch.tensor(x["do"], dtype=dtype),
                                       torch.from_numpy(x["dlse"])])
    f32 = lambda t: t.detach().float().numpy()
    return [f32(o), f32(lse), f32(q.grad), f32(k.grad), f32(v.grad)]


def _check(got, want, tol, grad_tol):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, err_msg=["o", "lse", "dq", "dk", "dv"][i],
                                   **(tol if i < 2 else grad_tol))


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_feature_matrix(case):
    x, mask = _inputs(CASES[case], g=2, D=32, seed=0)
    _check(_port(x, mask, torch.float32), _jax(x, mask, jnp.float32), FP32_TOL, GRAD_TOL)


# (g, D, S): GQA groups and head dims at S 64, then lengths on both sides of
# the CUDA kernels' 64-row tiles and 128-key blocks and of the forward's
# 192-row blocks at the training step's group (g 8, D 64) and at MHA with
# D 128 (190 and 194, not 191 and 193: the Pallas reference takes no
# ragged tile, and a prime length would leave it tiles of one row)
GQA_CASES = ([pytest.param(g, D, 64, id=f"{D}-{g}") for D in (32, 64) for g in (1, 2, 4)]
             + [pytest.param(g, D, S, id=f"g{g}-D{D}-S{S}") for g, D in ((8, 64), (1, 128))
                for S in (63, 64, 65, 127, 128, 129, 190, 192, 194)])


@pytest.mark.parametrize("g,D,S", GQA_CASES)
def test_fp32_gqa_groups_and_head_dims(g, D, S):
    """O, LSE and the gradients (through dO and a cotangent on the LSE)."""
    x, mask = _inputs(CASES["causal"], g=g, D=D, seed=1, S=S)
    _check(_port(x, mask, torch.float32), _jax(x, mask, jnp.float32), FP32_TOL, GRAD_TOL)


@pytest.mark.parametrize("case", ["causal", "window", "segids_causal", "alibi"])
def test_bf16(case):
    x, mask = _inputs(CASES[case], g=4, D=64, seed=2)
    _check(_port(x, mask, torch.bfloat16), _jax(x, mask, jnp.bfloat16), BF16_TOL,
           BF16_GRAD_TOL)


# head dims the kernels take beyond the ones above: the tiny presets' 16, 48
# and 112 (16-column steps of the wgmma tiles), open-llama-3b's 100 and an
# odd 33 (padded to a multiple of 8 for the kernels), 384 and 512 (the
# CUDA-core forms past 256)
NEW_HEAD_DIMS = (16, 48, 100, 112, 33, 384, 512)


@pytest.mark.parametrize("D", NEW_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_head_dims(D, dtype):
    """O, LSE and the gradients at each head_dim the kernels added, GQA 2,
    causal, against the Pallas kernels in interpret mode."""
    x, mask = _inputs(CASES["causal"], g=2, D=D, seed=8, S=32 if D > 128 else 64)
    if dtype == "fp32":
        _check(_port(x, mask, torch.float32), _jax(x, mask, jnp.float32), FP32_TOL, GRAD_TOL)
    else:
        _check(_port(x, mask, torch.bfloat16), _jax(x, mask, jnp.bfloat16), BF16_TOL,
               BF16_GRAD_TOL)


@pytest.mark.parametrize("case", ["noncausal", "window", "segids_causal", "alibi",
                                  "alibi_window", "neg_offset", "short_q"])
def test_open_llama_head_dim_masks(case):
    """Every mask feature at open-llama-3b's head_dim 100, fp32."""
    x, mask = _inputs(CASES[case], g=2, D=100, seed=9)
    _check(_port(x, mask, torch.float32), _jax(x, mask, jnp.float32), FP32_TOL, GRAD_TOL)


@pytest.mark.parametrize("D", [100, 33, 12])
def test_padding_to_eight_leaves_the_function_unchanged(D):
    """The kernels' wrappers zero-pad a head_dim that is no multiple of 8
    (``_pad8``) and cut the outputs back. Through the plain versions, at the
    unpadded head_dim's scale: O, LSE, dQ, dK and dV of the padded inputs
    cut to D equal those of the inputs themselves, and the padded columns
    of O and the gradients are zero."""
    x, _ = _inputs(CASES["alibi_window"], g=2, D=D, seed=10)
    q, k, v, do = (torch.from_numpy(x[n]) for n in ("q", "k", "v", "do"))
    spec = tflash.mask_spec(q, k, causal=True, window=24,
                            alibi_slopes=torch.from_numpy(alibi_slopes(q.shape[2])))
    o, lse = tflash.flash_fwd_reference(q, k, v, spec=spec)
    grads = tflash.flash_bwd_reference(q, k, v, o, lse, do, None, spec=spec)
    qp, kp, vp, op, dop = tflash._pad8(q, k, v, o, do)
    assert qp.shape[-1] % 8 == 0 and qp.shape[-1] - D < 8 and qp.is_contiguous()
    o2, lse2 = tflash.flash_fwd_reference(qp, kp, vp, spec=spec)
    grads2 = tflash.flash_bwd_reference(qp, kp, vp, op, lse2, dop, None, spec=spec)
    torch.testing.assert_close(o2[..., :D], o, **FP32_TOL)
    torch.testing.assert_close(lse2, lse, **FP32_TOL)
    for a, b in zip(grads2, grads):
        torch.testing.assert_close(a[..., :D], b, **GRAD_TOL)
        assert not a[..., D:].any()
    assert not o2[..., D:].any()
    assert tflash._pad8(qp)[0] is qp   # a multiple of 8 is passed through


@pytest.mark.parametrize("D,dtype,H,form", [
    (100, torch.bfloat16, 4, "packed"), (100, torch.float32, 4, "in place"),
    (64, torch.bfloat16, 4, "in place"), (33, torch.bfloat16, 4, "padded"),
    (102, torch.bfloat16, 2, "padded"), (102, torch.bfloat16, 4, "packed"),
    (124, torch.bfloat16, 4, "padded"), (90, torch.float32, 4, "padded"),
    (100, torch.bfloat16, "gqa", "padded")])
def test_kernel_inputs_form(D, dtype, H, form):
    """What the kernels read at each head_dim: rows in place (a multiple of
    8, or fp32 rows of whole 16 bytes), bf16 packed heads of an even
    head_dim (contiguous, the same tensor when it already is), or copies
    zero-padded to the next multiple of 8 (odd head dims, GQA, a head_dim
    past 122, or a token's H x D columns no multiple of 8)."""
    x = torch.randn(2, 8, 4, D).to(dtype)
    kv = x[:, :, :2].contiguous() if H == "gqa" else x[:, :, :H].clone()
    x = x if H == "gqa" else x[:, :, :H].clone()
    got = tflash._kernel_inputs(x, kv)
    assert got[0].shape[-1] == (-(-D // 8) * 8 if form == "padded" else D)
    if form != "padded":
        assert got[0] is x
    else:
        assert torch.equal(got[0][..., :D], x) and not got[0][..., D:].any()


def test_head_dim_gate_follows_pallas_supports():
    """The port's head_dim rule is the Pallas shape gate's: every head_dim
    up to 128 and the multiples of 128 past it (to the kernels' 512)."""
    for D in list(range(1, 130)) + [136, 200, 256, 384, 512, 520]:
        want = jflash.supports((1, 32, 2, D), (1, 32, 2, D), compiled=False)
        assert tflash.head_dim_ok(D) == want, D
    with pytest.raises(NotImplementedError, match="ROADMAP B10"):
        tflash.check_head_dim(640)


def _c_fields(path):
    """(name, ctypes type) of every member of ``struct FlashParams``."""
    body = re.search(r"struct FlashParams \{(.*?)\};", path.read_text(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    ctype = {"void*": ctypes.c_void_p, "float*": ctypes.c_void_p, "int*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float}
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.fullmatch(r"(?:const\s+)?(void\s*\*|float\s*\*|int\s*\*|long long|int|float)"
                         r"\s*(\w+(?:\s*,\s*\w+)*)", " ".join(decl.split()))
        assert m, f"unparsed member {decl!r}"
        fields += [(n.strip(), ctype[m.group(1).replace(" ", "")
                                     if "*" in m.group(1) else m.group(1)])
                   for n in m.group(2).split(",")]
    return fields


def test_flash_params_match_the_c_struct():
    """The ctypes mirror has the C struct's members, in order, with
    matching types: a mismatch would shift every field a launch reads."""
    src = Path(tflash.__file__).resolve().parents[2] / "csrc" / "flash_common.cuh"
    want = _c_fields(src)
    assert [n for n, _ in want][:8] == ["q", "k", "v", "o", "dout", "lse", "dlse", "di"]
    assert [(n, t) for n, t in tflash.FlashParams._fields_] == want


def test_fully_masked_rows_give_zero_and_the_sentinel():
    """q_offset -40: the first 40 query rows see no key. O is 0 there, LSE
    the finite MASK_VALUE, and no gradient is NaN."""
    x, mask = _inputs(CASES["neg_offset"], g=2, D=32, seed=3)
    o, lse, dq, dk, dv = _port(x, mask, torch.float32)
    assert np.all(o[:, :40] == 0.0)
    assert np.all(lse[:, :, :40] == tflash.MASK_VALUE)
    assert all(np.isfinite(a).all() for a in (o, lse, dq, dk, dv))
    assert np.all(dq[:, :40] == 0.0)


@pytest.mark.parametrize("S,Sk,case", [(50, 50, "causal"), (37, 70, "window"),
                                       (45, 45, "segids_causal"), (70, 70, "alibi")])
def test_ragged_lengths_against_the_attention_reference(S, Sk, case):
    """Lengths that are no multiple of the tile: the output against the
    whole-matrix reference, and the gradients against autograd through it."""
    rng = np.random.default_rng(4)
    B, kvH, g, D = 2, 2, 2, 32
    q = torch.tensor(rng.normal(size=(B, S, kvH * g, D)) * 0.3, dtype=torch.float32,
                     requires_grad=True)
    k = torch.tensor(rng.normal(size=(B, Sk, kvH, D)) * 0.3, dtype=torch.float32,
                     requires_grad=True)
    v = torch.tensor(rng.normal(size=(B, Sk, kvH, D)) * 0.3, dtype=torch.float32,
                     requires_grad=True)
    seg = torch.from_numpy(rng.integers(0, 3, (B, Sk)).astype(np.int32)) \
        if case == "segids_causal" else None
    slopes = torch.from_numpy(alibi_slopes(kvH * g)) if case == "alibi" else None
    window = 20 if case == "window" else None
    do = torch.tensor(rng.normal(size=(B, S, kvH * g, D)), dtype=torch.float32)
    want = tattn.attention_reference(q, k, v, True, None, seg, alibi=slopes, window=window)
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    got = tflash.flash_attention_kernel(q, k, v, causal=True, segment_ids=seg,
                                        alibi_slopes=slopes, window=window)
    got_grads = torch.autograd.grad(got, (q, k, v), do)
    torch.testing.assert_close(got, want, **FP32_TOL)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.parametrize("case", ["causal", "window", "segids_causal", "alibi", "short_q"])
def test_attention_reference_matches_xla(case):
    x, mask = _inputs(CASES[case], g=2, D=32, seed=5)
    seg = mask.get("segment_ids")
    sl = mask.get("alibi_slopes")
    w = mask.get("window")
    want = _xla_attention(*(jnp.asarray(x[n]) for n in "qkv"), mask["causal"], None,
                          None if seg is None else jnp.asarray(seg),
                          alibi=None if sl is None else jnp.asarray(sl),
                          window=None if w is None else jnp.asarray(w, jnp.int32))
    got = tattn.attention_reference(
        *(torch.from_numpy(x[n]) for n in "qkv"), mask["causal"], None,
        None if seg is None else torch.from_numpy(seg),
        alibi=None if sl is None else torch.from_numpy(sl), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_merge_partials_matches_jax():
    """Two disjoint key halves merged by their LSEs give the whole; one side
    fully masked (the sentinel) stays NaN-free."""
    x, mask = _inputs(CASES["noncausal"], g=2, D=32, seed=6)
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    oa, la = tflash.flash_fwd_reference(q, k[:, :32], v[:, :32], causal=False)
    ob, lb = tflash.flash_fwd_reference(q, k[:, 32:], v[:, 32:], causal=True, q_offset=-64)
    got = tflash.merge_partials(oa, la, ob, lb)
    want = jflash.merge_partials(*(jnp.asarray(t.numpy()) for t in (oa, la, ob, lb)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32_TOL)
    np.testing.assert_allclose(got[0].numpy(), oa.numpy(), **FP32_TOL)


def test_attention_entry_dispatches_to_flash():
    x, _ = _inputs(CASES["causal"], g=2, D=32, seed=7)
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    before = dict(tflash.launches)
    got = tattn.flash_attention(q, k, v, causal=True)
    want, _ = tflash.flash_fwd_reference(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tflash.launches == before   # the CPU path launches no kernel
