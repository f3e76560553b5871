"""The port's ZeRO++ wire quantizer and int8 dispatch gather against the JAX
package, on the CPU (the wrappers run their plain versions there).

Contract: bit for bit. The JAX side is jitted, as every JAX wire path runs:
XLA compiles a divide by a constant into a multiply by its fp32 reciprocal
and keeps ``x / scale`` a true divide, and the port computes exactly that
(``quant.INV_QMAX_INT8``, ``quantizer._recip``). Checked against:

- ``jax.jit(quantize_blockwise)``: symmetric int8 (fp32 and bf16 inputs,
  group sizes 1 ... 4096, zero rows, exact .5 ties, -0.0), int4 and
  asymmetric int8 / int4, the dequantizers, fp8 (``float8_e4m3fn``);
- the Pallas kernel ``quantize_rows_int8`` in interpret mode, jitted, with
  ``DSTPU_QUANT_KERNEL=pallas`` (through ``quantize_blockwise`` too);
- ``moe_dispatch_gather_int8``'s Pallas kernel in interpret mode, mask_pad
  off and on, at a row of the lanes form, at Mixtral's H 4096 (the block
  form) and over a table of empty slots, and against ``quantize_rows_int8`` of
  the gathered rows.

The row kernel's launch plan (``quant.plan_rows``) is pure arithmetic over
the shape and the SM count, checked here at every ``[quant]`` case of
``chip_smoke.py``: each unit of a row is held by exactly one lane or
thread, a lane holds at most ``UNITS`` units at once, and the grid neither
exceeds the resident blocks nor holds a block with no row. The int8
dispatch gather runs the same row forms over its slots; its plan
(``moe.plan_gather_int8``) is checked at every int8 gather case of
``chip_smoke.py``'s ``[moe]``: each slot is taken by exactly one walker (a
lane group, a block or a warp), each unit of its row by one lane or thread,
and no block is left with no slot.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import quantizer as jq
from deepspeed_tpu.ops.quantizer.pallas_quant import quantize_rows_int8 as jax_rows
from deepspeed_tpu.ops.transformer import pallas_moe as jpm
from deepspeed_tpu_torch.ops.quantizer import quant, quantizer as tq
from deepspeed_tpu_torch.ops.transformer import moe
from tests.port_threads import torch_threads  # noqa: F401

GROUP_SIZES = (1, 7, 100, 255, 256, 4096)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _rows(seed, G, gs, kind="randn"):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((G, gs)) * rng.choice([1e-3, 0.02, 3.0], size=(G, 1))
         ).astype(np.float32)
    if kind == "edge":
        x[0::4] = 0.0
        ties = (np.arange(gs) % 254 - 127).astype(np.float32) + 0.5
        for r in range(1, G, 4):
            k = np.float32(2.0 ** (r % 7 - 3))
            x[r] = ties * k
            x[r, 0] = 127 * k   # absmax 127 * 2**k: the scale is exactly 2**k
        x[2::4, ::3] = -0.0
    return x


def _to_torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_jax(a, dtype):
    return jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy() if got.dtype not in (torch.float8_e4m3fn, torch.bfloat16) \
        else got.view(torch.uint8 if got.dtype == torch.float8_e4m3fn else torch.int16).numpy()
    if want.dtype.name in ("float8_e4m3fn", "bfloat16"):
        want = want.view(np.uint8 if want.dtype.name == "float8_e4m3fn" else np.int16)
    assert got.dtype.itemsize == want.dtype.itemsize and got.shape == want.shape
    np.testing.assert_array_equal(got.view(f"u{got.dtype.itemsize}"),
                                  want.view(f"u{want.dtype.itemsize}"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gs", GROUP_SIZES)
@pytest.mark.parametrize("kind", ["randn", "edge"])
def test_int8_rows_bitwise_against_the_jitted_jax_wire(gs, dtype, kind):
    x = _rows(gs, 64, gs, kind)
    q, s = quant.quantize_rows_int8(_to_torch(x, dtype))
    jf = jax.jit(lambda a: jq.quantize_blockwise(a, 8, gs))
    wq, ws, wz = jf(_to_jax(x, dtype))
    _equal(q, wq)
    _equal(s, ws)
    # the same through the port's quantize_blockwise (flattened, no padding)
    tq_, ts, tz = tq.quantize_blockwise(_to_torch(x, dtype), 8, gs)
    _equal(tq_, wq)
    _equal(ts, ws)
    _equal(tz, wz)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gs", [128, 256, 384])
def test_int8_rows_bitwise_against_the_pallas_kernel(monkeypatch, gs, dtype):
    """The Pallas kernel (interpret mode, jitted) on the groups, directly and
    through ``quantize_blockwise`` with the kernel forced (lane-aligned
    group sizes only, its ``quant_kernel_enabled`` rule)."""
    monkeypatch.setenv("DSTPU_QUANT_KERNEL", "pallas")
    x = _rows(gs + 1, 70, gs, "edge")
    q, s = quant.quantize_rows_int8(_to_torch(x, dtype))
    wq, ws = jax.jit(lambda a: jax_rows(a, interpret=True))(_to_jax(x, dtype))
    _equal(q, wq)
    _equal(s, ws)
    bq, bs, _ = jax.jit(lambda a: jq.quantize_blockwise(a, 8, gs))(_to_jax(x, dtype))
    _equal(q, bq)
    _equal(s, bs)


@pytest.mark.parametrize("num_bits,symmetric", [(4, True), (4, False), (8, False)])
@pytest.mark.parametrize("gs", [2, 16, 256])
def test_blockwise_int4_and_asymmetric_bitwise(num_bits, symmetric, gs):
    x = _rows(7 * gs + num_bits, 1, 40 * gs + 6).reshape(-1)   # pads the last group
    q, s, z = tq.quantize_blockwise(torch.from_numpy(x), num_bits, gs, symmetric)
    jf = jax.jit(lambda a: jq.quantize_blockwise(a, num_bits, gs, symmetric))
    wq, ws, wz = jf(jnp.asarray(x))
    _equal(q, wq)
    _equal(s, ws)
    _equal(z, wz)
    out = tq.dequantize_blockwise(q, s, z, num_bits, gs, out_size=x.size)
    want = jax.jit(lambda a, b, c: jq.dequantize_blockwise(a, b, c, num_bits, gs,
                                                           out_size=x.size))(wq, ws, wz)
    _equal(out, want)


@pytest.mark.parametrize("gs", [7, 256])
def test_fp8_wire_bitwise(gs):
    x = _rows(gs, 1, 30 * gs + 5).reshape(5, -1)
    q, s = tq.quantize_blockwise_fp8(torch.from_numpy(x), gs)
    wq, ws = jax.jit(lambda a: jq.quantize_blockwise_fp8(a, gs))(jnp.asarray(x))
    _equal(q, wq)
    _equal(s, ws)
    out = tq.dequantize_blockwise_fp8(q, s, out_size=x.size, out_shape=x.shape)
    want = jax.jit(lambda a, b: jq.dequantize_blockwise_fp8(a, b, out_size=x.size,
                                                            out_shape=x.shape))(wq, ws)
    _equal(out, want)


def test_int8_dequantize_bitwise_and_bf16_out():
    x = _rows(3, 8, 256)
    q, s, z = tq.quantize_blockwise(torch.from_numpy(x), 8, 256)
    got = tq.dequantize_blockwise(q, s, z, 8, 256, out_shape=x.shape, dtype=torch.bfloat16)
    want = jax.jit(lambda a, b, c: jq.dequantize_blockwise(
        a, b, c, 8, 256, out_shape=x.shape, dtype=jnp.bfloat16))(
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), jnp.asarray(z.numpy()))
    _equal(got, want)


# (T, H, S, every slot empty): a row of 96 (the lanes form), mixtral's H
# 4096 (the block form) over a few slots, and a table of empty slots
GATHER_INT8_CASES = ((13, 96, 40, False), (5, 4096, 6, False), (4, 96, 24, True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_pad", [False, True])
def test_int8_dispatch_gather_against_the_pallas_kernel(dtype, mask_pad):
    rng = np.random.default_rng(4)

    @jax.jit
    def jax_side(tk, sr):
        kq, ks = jpm.moe_dispatch_gather_int8(tk, sr, mask_pad=mask_pad, interpret=True)
        rows = tk[jnp.maximum(sr - 1, 0)]
        if mask_pad:
            rows = jnp.where((sr > 0)[:, None], rows, 0)
        rq, rs = jax_rows(rows, interpret=True)
        return kq, ks, rq, rs

    for T, H, S, empty in GATHER_INT8_CASES:
        tokens = (rng.standard_normal((T, H)) * 0.5).astype(np.float32)
        tokens[3] = 0.0
        src = rng.integers(0, T + 1, size=S).astype(np.int32)
        src[:3] = (0, 4, 0)   # empty slots, and one reading the all-zero row
        if empty:
            src[:] = 0
        q, s = moe.moe_dispatch_gather_int8(_to_torch(tokens, dtype), torch.from_numpy(src),
                                            mask_pad=mask_pad)
        kq, ks, rq, rs = jax_side(_to_jax(tokens, dtype), jnp.asarray(src))
        _equal(q, kq)
        _equal(s, ks)
        _equal(q, rq)
        _equal(s, rs)
        if mask_pad:
            assert not q[src == 0].any() and bool((s[src == 0] == 1).all())
        if empty and not mask_pad:   # every slot reads token 0's row
            assert bool((q == q[0]).all())


def test_quantizer_wrapper_checks():
    with pytest.raises(ValueError, match="group_size"):
        quant.quantize_rows_int8(torch.zeros(4))
    before = quant.launches
    quant.quantize_rows_int8(torch.ones(2, 3))
    assert quant.launches == before   # the CPU takes the plain version
    with pytest.raises(NotImplementedError, match="bf16 and fp32"):
        moe.moe_dispatch_gather_int8(torch.zeros(2, 4, dtype=torch.float16),
                                     torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_row_chunk_layouts_match_jax(n_chunks):
    """The chunked gather / scatter layouts, with a stand-in collective over
    n = 3 members (member m's data is the shard plus 100 m)."""
    n = 3
    x = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    t_gather = lambda c: torch.cat([c + 100 * m for m in range(n)])
    j_gather = lambda c: jnp.concatenate([c + 100 * m for m in range(n)])
    got = tq.gather_in_row_chunks(t_gather, torch.from_numpy(x), n, n_chunks)
    want = jq.gather_in_row_chunks(j_gather, jnp.asarray(x), n, n_chunks)
    _equal(got, want)
    y = np.arange(n * 4 * 3, dtype=np.float32).reshape(n * 4, 3)
    if 4 % n_chunks:
        return
    t_scatter = lambda c: c.reshape(n, -1, 3).sum(0)
    j_scatter = lambda c: c.reshape(n, -1, 3).sum(0)
    got = tq.scatter_in_row_chunks(t_scatter, torch.from_numpy(y), n, n_chunks)
    want = jq.scatter_in_row_chunks(j_scatter, jnp.asarray(y), n, n_chunks)
    _equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_rows_keep_subnormal_inputs(dtype):
    """Subnormal inputs, as ``chip_smoke.py``'s edge rows hold them (the
    kernel is held to this plain version there): a row of them, whose scale
    underflows to a subnormal, and subnormal values in rows of normal ones;
    against numpy's IEEE fp32 arithmetic, bitwise. The jitted JAX wire is
    not the yardstick here: XLA's CPU backend flushes subnormals to zero
    (a row of them gets scale 1 and q 0 there), the port keeps them."""
    x = _rows(11, 16, 256)
    x[3::8] *= np.float32(1e-40)
    x[7::8, ::5] *= np.float32(1e-40)
    t = _to_torch(x, dtype)
    xf = t.float().numpy()
    assert (np.abs(xf[3::8]) < np.finfo(np.float32).tiny).all()
    q, s = quant.quantize_rows_int8(t)
    amax = np.abs(xf).max(axis=1)
    want_s = amax * np.float32(quant.INV_QMAX_INT8)
    want_s = np.where(want_s == 0, np.float32(1), want_s).astype(np.float32)
    want_q = np.clip(np.rint(xf / want_s[:, None]), -128, 127).astype(np.int8)
    _equal(s, want_s)
    _equal(q, want_q)
    assert q[3::8].any()   # the subnormal rows quantize to their own scale


def _units_held(lanes: int, units: int, n: int):
    """The unit indices of one row that lanes 0 .. lanes-1 hold (units
    j, j + lanes, ... a lane), in the order the kernel loads them."""
    return sorted(j + c * lanes for j in range(lanes) for c in range(units)
                  if j + c * lanes < n)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("case", sorted(chip_smoke.QUANT_CASES))
def test_row_plan_holds_every_unit_once(case, vec, sms):
    G, gs, dt, _ = chip_smoke.QUANT_CASES[case]
    isz = 2 if dt == "bfloat16" else 4
    vec = vec and (gs * isz) % 16 == 0   # the wrapper's rule: whole 16-byte units a row
    form, lanes, units, blocks = quant.plan_rows(G, gs, isz, vec, sms)
    n = gs * isz // 16 if vec else gs
    warps = quant.THREADS // 32
    assert 1 <= blocks <= quant.BLOCKS_PER_SM * sms
    if form == "lanes":
        assert n <= 32 * quant.UNITS and lanes & (lanes - 1) == 0 and lanes <= 32
        assert units <= quant.UNITS and _units_held(lanes, units, n) == list(range(n))
        assert lanes == 1 or (lanes // 2) * units < n   # no lane group wider than the row needs
        assert (blocks - 1) * (32 // lanes) * warps < G   # every block has a row
    elif form == "block":
        assert lanes == quant.THREADS and 32 * quant.UNITS < n <= quant.THREADS * quant.UNITS
        assert units <= quant.UNITS and _units_held(lanes, units, n) == list(range(n))
        assert blocks <= G
    else:
        assert form == "warp" and n > quant.THREADS * quant.UNITS
        assert (blocks - 1) * warps < G


@pytest.mark.parametrize("case,plan", [
    # (form, lanes, units, blocks); the wire's main case: a row of 512 bytes
    # a warp at a time, one 16-byte unit a lane; 8 blocks on each of 132 SMs
    ("mlp-shard-2816x2048-bf16", ("lanes", 32, 1, 1056)),
    ("mlp-shard-2816x2048-fp32", ("lanes", 32, 2, 1056)),
    ("embed-shard-16000x2048-bf16", ("lanes", 32, 1, 1056)),
    ("gs100-fp32", ("lanes", 32, 1, 250)),   # 400-byte rows: 25 units
    ("edge-gs256-fp32", ("lanes", 32, 2, 8)),
    ("gs1-fp32", ("lanes", 1, 1, 16)),       # a row a lane
    ("gs7-bf16", ("lanes", 8, 1, 94)),       # 4 rows a pass, lanes of 8
    ("gs255-bf16", ("lanes", 32, 8, 250)),   # 510-byte rows: value by value
    ("gs4096-bf16", ("block", 256, 2, 512)),
    ("gs4096-fp32", ("block", 256, 4, 512)),
])
def test_row_plan_at_the_wire_cases(case, plan):
    G, gs, dt, _ = chip_smoke.QUANT_CASES[case]
    isz = 2 if dt == "bfloat16" else 4
    assert quant.plan_rows(G, gs, isz, (gs * isz) % 16 == 0, 132) == plan


def test_row_plan_takes_long_rows_to_the_warp_form():
    # 32 KB of 16-byte units is the block form's most; past it, a warp a row
    assert quant.plan_rows(10, 8192, 4, True, 132)[:3] == ("block", 256, 8)
    assert quant.plan_rows(10, 8196, 4, True, 132)[0] == "warp"
    assert quant.plan_rows(10, 2049, 4, False, 132)[0] == "warp"


def _gather_int8_shapes():
    """(tag, S, H) of every int8 gather case of ``chip_smoke.py``'s ``[moe]``:
    mixtral's H 4096 at T 8 ... 4096 (dropless: S = E * T), the fp32 small
    cases, the edge cases (H 1, 7, 96, 4100, 16392)."""
    from deepspeed_tpu_torch.moe import capacity
    cs = chip_smoke
    out = [(f"T{t}-H{cs.MOE_H}", cs.MOE_E * t, cs.MOE_H)
           for t in cs.MOE_TOKENS + tuple(t for t, _ in cs.MOE_GATHER_INT8_TIMED)]
    for t, e, h, _, _, _, cf, _ in cs.MOE_FP32_CASES:
        out.append((f"fp32-T{t}-E{e}-H{h}", e * capacity(t, e, cf if cf else float(e),
                                                         4 if cf else 1), h))
    out += [(f"edge-T{t}-H{h}-{layout}", cs.MOE_E * t, h)
            for t, h, _, layout in cs.MOE_GATHER_INT8_EDGE]
    return dict.fromkeys(out)   # each shape once, in order


def _walkers(form, lanes, blocks, S):
    """The slots each walker of a plan takes, in the kernel's order, and the
    block each walker belongs to: a lane group of a warp (``lanes``), a
    block (``block``) or a warp (``warp``)."""
    warps = quant.THREADS // 32
    if form == "lanes":
        per_pass = 32 // lanes
        stride = blocks * warps * per_pass
        starts = [(w * per_pass + k, w // warps) for w in range(blocks * warps)
                  for k in range(per_pass)]
    elif form == "block":
        stride, starts = blocks, [(b, b) for b in range(blocks)]
    else:
        stride = blocks * warps
        starts = [(w, w // warps) for w in range(blocks * warps)]
    return [(np.arange(start, S, stride), block) for start, block in starts]


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", list(_gather_int8_shapes()), ids=lambda shape: shape[0])
def test_gather_int8_plan_takes_every_slot_once(shape, itemsize, vec, sms):
    _, S, H = shape
    vec = vec and (H * itemsize) % 16 == 0   # the wrapper's rule: whole 16-byte units a row
    form, lanes, units, blocks = moe.plan_gather_int8(S, H, itemsize, vec, sms)
    n = H * itemsize // 16 if vec else H
    assert 1 <= blocks <= quant.BLOCKS_PER_SM * sms
    walkers = _walkers(form, lanes, blocks, S)
    taken = np.concatenate([slots for slots, _ in walkers])
    np.testing.assert_array_equal(np.bincount(taken, minlength=S), np.ones(S, np.int64))
    busy = {block for slots, block in walkers if len(slots)}
    assert busy == set(range(blocks))   # no block is left with no slot
    if form == "lanes":
        assert n <= 32 * quant.UNITS and lanes & (lanes - 1) == 0 and lanes <= 32
        assert units <= quant.UNITS and _units_held(lanes, units, n) == list(range(n))
    elif form == "block":
        assert lanes == quant.THREADS and 32 * quant.UNITS < n <= quant.THREADS * quant.UNITS
        assert units <= quant.UNITS and _units_held(lanes, units, n) == list(range(n))
    else:
        assert form == "warp" and n > quant.THREADS * quant.UNITS and units == 0


@pytest.mark.parametrize("S,H,itemsize,vec,plan", [
    # (form, lanes, units, blocks) on 132 SMs; Mixtral's H 4096: a block a
    # slot's row, 2 bf16 or 4 fp32 units a thread, the grid at 8 blocks an SM
    (64, 4096, 2, True, ("block", 256, 2, 64)),         # T 8
    (2048, 4096, 2, True, ("block", 256, 2, 1056)),     # T 256
    (4096, 4096, 2, True, ("block", 256, 2, 1056)),     # T 512
    (32768, 4096, 2, True, ("block", 256, 2, 1056)),    # T 4096
    (4096, 4096, 4, True, ("block", 256, 4, 1056)),     # T 512, fp32 tokens
    (64, 4100, 2, False, ("warp", 32, 0, 8)),           # rows off the 16-byte unit
    (64, 4096, 2, False, ("warp", 32, 0, 8)),           # rows that start unaligned
    (296, 96, 2, True, ("lanes", 16, 1, 19)),           # 12 units: two slots a warp
])
def test_gather_int8_plan_at_the_moe_cases(S, H, itemsize, vec, plan):
    assert moe.plan_gather_int8(S, H, itemsize, vec, 132) == plan
