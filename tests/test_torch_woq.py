"""Weight-only quantization of the port (``inference/quantization``,
``ops/quantizer/woq_matmul.py``, the quantized ``nn.Linear`` and the
engine's quantized placement) against the JAX package, on the same numpy
inputs. On the CPU ``woq_matmul`` runs its plain version; ``chip_smoke.py``
holds the CUDA kernel to that plain version on the GPU.

- ``host_quantize_kernel``: bitwise against the JAX one (int8, packed int4,
  bf16 and fp32 model dtype, stacked leaves, a K that forces the group size
  to shrink, slabs smaller than a leaf);
- ``quantize_kernel``: bitwise against the JAX function run op by op. Under
  ``jax.jit`` XLA rewrites ``absmax / qmax`` into a product with the
  reciprocal, which moves a scale by an ulp and, where ``w / scale`` lies
  on a rounding boundary, a weight by one step: there the scales are held
  to 2 ulp, every weight to one step and 99% of them to equality;
- ``quantized_matmul``: against the JAX ``quantized_matmul`` and the Pallas
  ``woq_matmul(interpret=True)``; fp32 within 1e-5 of the largest output
  (sums of K terms in another order), bf16 within 2e-2 (the JAX suite's
  bf16 bound), also in the large-row (non-kernel) form and its chunked
  variant;
- llama2-tiny served with ``quantization_mode`` int8 and int4 through
  ``build_engine`` + ``generate`` against the JAX engine
  (``kv_pool_sharding="replicated"``), from the JAX engine's own integers
  (``params_from_jax`` of its quantized tree): first-wave logits within
  1e-4 (fp32), greedy tokens identical through a decode burst.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.quantization import quantization as jq
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2 import generate as jax_generate
from deepspeed_tpu.inference.v2.config_v2 import DeepSpeedTPStateManagerConfig as JaxSM
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.ops.quantizer.pallas_woq_matmul import woq_matmul as jax_woq_matmul
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.inference.quantization import quantization as tq
from deepspeed_tpu_torch.inference.v2 import (DeepSpeedTPStateManagerConfig,
                                              RaggedInferenceEngineConfig,
                                              build_engine, generate)
from deepspeed_tpu_torch.models import llama_model
from deepspeed_tpu_torch.nn.layers import Linear
from deepspeed_tpu_torch.ops.quantizer import woq_matmul as twoq
from tests.port_threads import torch_threads  # noqa: F401

V = 1024
FP32_RTOL = 1e-5     # of the largest |output|
BF16_TOL = 2e-2
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE_KW = dict(kv_block_size=4, max_prefill_chunk=16)
SM_KW = dict(max_ragged_batch_size=64, max_ragged_sequence_count=8, max_context=64)


def _t(a):
    a = np.asarray(jax.device_get(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _weights(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.02).astype(np.float32)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

SHAPES = [(256, 64), (2, 192, 40), (3, 100, 24), (64, 8)]   # 192, 100: gs shrinks


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bits", [8, 4])
def test_host_quantize_kernel_is_bitwise(bits, dtype, shape):
    w = _weights(shape, seed=bits + len(shape))
    jqq, js = jq.host_quantize_kernel(w, jq.QuantizationConfig(bits=bits),
                                      np.dtype(getattr(jnp, dtype)))
    for slab in (1 << 27, 1000):
        tqq, ts = tq.host_quantize_kernel(w, tq.QuantizationConfig(bits=bits),
                                          getattr(torch, dtype), slab_elems=slab)
        assert tqq.dtype == jqq.dtype == (np.uint8 if bits == 4 else np.int8)
        np.testing.assert_array_equal(tqq, jqq)
        np.testing.assert_array_equal(ts, js)
    # a CPU tensor in the model dtype is taken as it is
    tqq, ts = tq.host_quantize_kernel(torch.from_numpy(w).to(getattr(torch, dtype)),
                                      tq.QuantizationConfig(bits=bits), getattr(torch, dtype))
    np.testing.assert_array_equal(tqq, jqq)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kernel_matches_jax(bits, dtype, shape):
    w = _weights(shape, seed=7)
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    jcfg = jq.QuantizationConfig(bits=bits)
    got = tq.quantize_kernel(_t(jw), tq.QuantizationConfig(bits=bits))
    with jax.disable_jit():
        eager = jq.quantize_kernel(jw, jcfg)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(eager["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(eager["scale"]))
    # and the host quantizer gives the device quantizer's bits
    hq, hs = tq.host_quantize_kernel(w, tq.QuantizationConfig(bits=bits), getattr(torch, dtype))
    np.testing.assert_array_equal(got["q"].numpy(), hq)
    np.testing.assert_array_equal(got["scale"].numpy(), hs)
    jitted = jax.jit(lambda a: jq.quantize_kernel(a, jcfg))(jw)
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(jitted["scale"]),
                               rtol=2.4e-7, atol=0)
    unpack = lambda a: tq._unpack_int4(torch.from_numpy(np.array(a))).numpy() \
        if bits == 4 else np.asarray(a)
    step = np.abs(unpack(got["q"].numpy()).astype(np.int32) - unpack(jitted["q"]))
    assert step.max() <= 1 and (step == 0).mean() >= 0.99


def test_int4_pack_and_unpack_match_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, size=(2, 3, 16, 10)).astype(np.int8)
    packed = tq._pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq._pack_int4(jnp.asarray(q))))
    assert packed.dtype == torch.uint8 and packed.shape == (2, 3, 8, 10)
    np.testing.assert_array_equal(tq._unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(np.asarray(jq._unpack_int4(jnp.asarray(packed.numpy()))), q)
    # an odd group size cannot pack: int4 values in int8 storage
    odd = tq.quantize_kernel(torch.from_numpy(_weights((7, 12), 1)),
                             tq.QuantizationConfig(bits=4, group_size=7))
    assert odd["q"].dtype == torch.int8 and odd["q"].shape == (1, 7, 12)
    assert int(odd["q"].abs().max()) <= 8


def test_config_modes_match_jax():
    for mode in ("int8", "wint8", "int4", "wint4", None, "none"):
        a, b = tq.QuantizationConfig.from_mode(mode), jq.QuantizationConfig.from_mode(mode)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.bits, a.group_size, tuple(a.targets)) == \
                (b.bits, b.group_size, tuple(b.targets))
    with pytest.raises(ValueError, match="unknown quantization_mode"):
        tq.QuantizationConfig.from_mode("wf6af16")
    with pytest.raises(ValueError, match="4 or 8"):
        tq.QuantizationConfig(bits=6)
    assert tq.DEFAULT_TARGETS == jq.DEFAULT_TARGETS


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,gs", [(8, 512, 256, 128), (3, 256, 384, 64), (1, 128, 128, 128),
                                      (16, 1376, 128, 16), (32, 256, 256, 128)])
def test_woq_matmul_matches_jax_and_pallas(m, k, n, gs, dtype):
    """The decode-shaped form: the port's plain version, the JAX
    ``quantized_matmul`` and the Pallas kernel in interpret mode, from the
    same integers."""
    rng = np.random.default_rng(m + k)
    q, scale = tq.host_quantize_kernel(_weights((k, n), 3),
                                       tq.QuantizationConfig(group_size=gs), torch.float32)
    x = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32)).astype(getattr(jnp, dtype))
    jqp = {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}
    tqp = {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}
    got = tq.quantized_matmul(_t(x), tqp)
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    torch.testing.assert_close(got, twoq.woq_matmul(_t(x), tqp["q"], tqp["scale"]),
                               rtol=0, atol=0)
    _close(got.float().numpy(), np.asarray(jq.quantized_matmul(x, jqp).astype(jnp.float32)),
           dtype)
    pallas = jax_woq_matmul(x, jqp["q"], jqp["scale"], interpret=True)
    _close(got.float().numpy(), np.asarray(pallas.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_row_form_matches_jax(bits, dtype, monkeypatch):
    """More rows than the kernel takes, and packed int4 at any row count,
    take the non-kernel form (whole-leaf and in chunks of groups); few rows
    on int8 storage take ``woq_matmul``; leading dims pass through."""
    rng = np.random.default_rng(bits)
    k, n = 256, 96
    q, scale = tq.host_quantize_kernel(_weights((k, n), 5), tq.QuantizationConfig(bits=bits),
                                       torch.float32)
    jqp = {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}
    tqp = {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}
    for lead in ((2, tq.WOQ_KERNEL_MAX_ROWS), (5,)):
        x = jnp.asarray(rng.normal(size=lead + (k,)).astype(np.float32)).astype(
            getattr(jnp, dtype))
        want = np.asarray(jq.quantized_matmul(x, jqp).astype(jnp.float32))
        called = []
        monkeypatch.setattr(tq, "woq_matmul",
                            lambda *a: called.append(a) or twoq.woq_matmul(*a))
        got = tq.quantized_matmul(_t(x), tqp)
        decode_shaped = bits == 8 and int(np.prod(lead)) <= tq.WOQ_KERNEL_MAX_ROWS
        assert bool(called) == decode_shaped and got.shape == lead + (n,)
        _close(got.float().numpy(), want, dtype)
        monkeypatch.setattr(tq, "_DEQUANT_CHUNK_ELEMS", 128 * n)   # one group a chunk
        _close(tq.quantized_matmul(_t(x), tqp).float().numpy(), want, dtype)
        monkeypatch.undo()
    # and the dense kernel of the pair
    np.testing.assert_allclose(tq.dequantize_kernel(tqp).numpy(),
                               np.asarray(jq.dequantize_kernel(jqp)), rtol=0, atol=0)


def test_woq_matmul_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8)
    q, s = torch.zeros(2, 4, 4, dtype=torch.int8), torch.ones(2, 1, 4)
    assert twoq.woq_matmul(x, q, s).shape == (2, 4)
    with pytest.raises(ValueError, match="K must equal"):
        twoq.woq_matmul(torch.zeros(2, 9), q, s)
    with pytest.raises(NotImplementedError, match="int8"):
        twoq.woq_matmul(x, q.to(torch.uint8), s)
    with pytest.raises(NotImplementedError, match="dtype"):
        twoq.woq_matmul(x.half(), q, s)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        twoq.woq_matmul(x[None], q, s)


# the llama2-7b widths of chip_smoke.py's WOQ_CASES (N, groups of 128), an N
# off the tensor-core kernel's 256-column tile, and groups of 64 and 256
_WOQ_WIDTHS = [(4096, 32), (11008, 32), (4096, 86), (32000, 32), (4112, 32), (11008, 64),
               (4096, 16), (65536, 172)]


_PLAN_CASES = [(1, 4096, 32), (8, 11008, 32), (8, 4096, 86), (32, 32000, 32), (5, 200, 86),
               (1, 128, 1)]


@pytest.mark.parametrize("m,n,g", _PLAN_CASES + [(m, n, g) for m in (1, 8, 13, 16, 32, 33, 64)
                                                 for n, g in _WOQ_WIDTHS])
def test_split_plan_covers_every_group_once(m, n, g):
    # the CUDA-core plan (fp32 x) and the launch plan of bf16 x, whose rows
    # up to 64 take the tensor-core plan: split s walks the groups
    # [s * per, min(G, (s + 1) * per)); together they name each group once
    x = torch.empty(m, g * 128, dtype=torch.bfloat16, device="meta")
    q = torch.empty(g, 128, n, dtype=torch.int8, device="meta")
    plans = {"cuda cores": twoq.plan_splits(m, n, g, 132),
             "launch": twoq.launch_plan(x, q, 132)[1:]}
    for what, (per, splits) in plans.items():
        walked = [gi for s in range(splits) for gi in range(s * per, min(g, (s + 1) * per))]
        assert sorted(walked) == list(range(g)), what
        assert all(s * per < g for s in range(splits)), what   # no split is empty
    per, splits = plans["cuda cores"]
    if (m, n, g) in _PLAN_CASES and -(-n // 128) * -(-m // 8) >= 2 * 132:
        assert splits == 1     # the column tiles alone fill the card
    mma, per, splits = twoq.launch_plan(x, q, 132)
    assert mma == (n % 16 == 0)
    assert not mma or per <= twoq._TC_MAX_GROUPS   # the split's scales fit shared memory
    tiles = -(-n // 256)
    if mma and tiles <= 132:
        assert tiles * splits <= 132   # one wave of the one-block-an-SM kernel


def test_tensor_core_kernel_takes_bf16_decode_shapes_only():
    q = lambda gs, n: torch.zeros(2, gs, n, dtype=torch.int8)
    x = lambda m, dt: torch.zeros(m, 1, dtype=dt)
    assert twoq.tensor_core_shape(x(8, torch.bfloat16), q(128, 4096))
    assert twoq.tensor_core_shape(x(64, torch.bfloat16), q(16, 11008))
    assert not twoq.tensor_core_shape(x(65, torch.bfloat16), q(128, 4096))   # too many rows
    assert not twoq.tensor_core_shape(x(8, torch.float32), q(128, 4096))     # the tight check
    assert not twoq.tensor_core_shape(x(8, torch.bfloat16), q(8, 4096))      # no 16-row step
    assert not twoq.tensor_core_shape(x(8, torch.bfloat16), q(128, 200))     # rows of q off 16 B
    # one block takes all 64 rows and 256 columns, one block an SM: the tensor-core
    # plan does not depend on the rows, and fills the card in one wave of blocks
    for m in (1, 8, 33, 64):
        assert twoq.launch_plan(x(m, torch.bfloat16), q(128, 4096), 132) == (True, 1, 2)
    assert twoq.plan_tc_splits(4096, 32, 132) == (4, 8)      # qkvo: 16 tiles x 8 splits
    assert twoq.plan_tc_splits(11008, 32, 132) == (11, 3)    # gate/up: 43 x 3
    assert twoq.plan_tc_splits(4096, 86, 132) == (11, 8)     # down: 86 groups in 8 splits
    assert twoq.plan_tc_splits(32000, 32, 132) == (32, 1)    # the head: 125 tiles
    # the CUDA-core plan counts 8-row tiles: 32 rows split K less than 8
    assert twoq.plan_splits(32, 4096, 32, 132) != twoq.plan_splits(8, 4096, 32, 132)


# ---------------------------------------------------------------------------
# the layer, the tree and the engine
# ---------------------------------------------------------------------------


def test_quantized_linear_adds_the_bias_after():
    torch.manual_seed(0)
    lin = Linear(256, 64, bias=True, device="cpu", dtype=torch.float32)
    lin.reset_parameters(torch.Generator().manual_seed(0))
    lin.bias.data.normal_()
    x = torch.randn(3, 5, 256)
    dense = lin(x)
    lin.quantize_(tq.QuantizationConfig())
    assert lin.weight is None and lin.q.dtype == torch.int8
    assert lin.q.is_contiguous() and lin.scale.is_contiguous()
    assert sorted(lin.state_dict()) == ["bias", "q", "scale"]
    got = lin(x)
    want = tq.quantized_matmul(x, {"q": lin.q, "scale": lin.scale}) + lin.bias
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float((got - dense).abs().max()) < 0.02 * float(dense.abs().max())
    with pytest.raises(ValueError, match="does not fit"):
        lin.set_quantized(lin.q[:1], lin.scale[:1])


@pytest.mark.parametrize("bits", [8, 4])
def test_param_tree_round_trip_and_bytes(bits):
    cfg = tq.QuantizationConfig(bits=bits)
    model = llama_model("llama2-tiny", dtype=torch.float32, device="cpu")
    model.init_weights(torch.Generator().manual_seed(1))
    dense = model.state_dict()
    tree = tq.quantize_param_tree(dense, cfg)
    assert "blocks.0.q_proj.q" in tree and "blocks.0.q_proj.weight" not in tree
    assert "lm_head.q" in tree and tree["wte.weight"] is dense["wte.weight"]
    assert tree["blocks.0.ln_1.weight"] is dense["blocks.0.ln_1.weight"]
    back = tq.dequantize_param_tree(tree)
    assert sorted(back) == sorted(dense)
    w, w0 = back["blocks.1.down_proj.weight"], dense["blocks.1.down_proj.weight"]
    assert w.shape == w0.shape
    assert float((w - w0).abs().max()) <= float(w0.abs().max()) / (2 ** (bits - 1) - 1)
    dense_bytes, q_bytes = tq.quantized_tree_bytes(dense), tq.quantized_tree_bytes(tree)
    assert dense_bytes == sum(t.numel() * 4 for t in dense.values())
    assert q_bytes < dense_bytes * (0.5 if bits == 8 else 0.4)


def _jax_engine(mode, dense):
    model = jax_llama("llama2-tiny", dtype=jnp.float32, remat=False, max_seq_len=64)
    cfg = JaxConfig(num_kv_blocks=257, kv_cache_dtype=jnp.float32,
                    kv_pool_sharding="replicated", state_manager=JaxSM(**SM_KW),
                    quantization_mode=mode, **ENGINE_KW)
    return JaxEngine(model, config=cfg, params=dense)


def _port_engine(mode, params, **kw):
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=257, kv_cache_dtype=torch.float32, quantization_mode=mode,
        state_manager=DeepSpeedTPStateManagerConfig(**SM_KW), **ENGINE_KW)
    model = llama_model("llama2-tiny", dtype=torch.float32, max_seq_len=64)
    return build_engine(model, cfg, params=params, device="cpu", **kw)


@pytest.fixture(scope="module", params=["int8", "int4"])
def engines(request):
    """(mode, JAX engine, port engine from the JAX engine's quantized tree,
    the dense tree both started from)."""
    mode = request.param
    jm = jax_llama("llama2-tiny", dtype=jnp.float32, remat=False, max_seq_len=64)
    dense = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.float32))
    jeng = _jax_engine(mode, dense)
    qtree = params_from_jax(jax.device_get(jeng.params))
    return mode, jeng, _port_engine(mode, qtree), dense, qtree


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=n).astype(np.int32) for n in lengths]


def test_params_from_jax_carries_the_quantized_tree(engines):
    mode, jeng, peng, _, qtree = engines
    jtree = jax.device_get(jeng.params)
    jq_ = np.asarray(jtree["blocks"]["down_proj"]["q"])
    assert "blocks.0.down_proj.weight" not in qtree
    for l in range(jq_.shape[0]):
        np.testing.assert_array_equal(qtree[f"blocks.{l}.down_proj.q"].numpy(), jq_[l])
        np.testing.assert_array_equal(
            qtree[f"blocks.{l}.down_proj.scale"].numpy(),
            np.asarray(jtree["blocks"]["down_proj"]["scale"])[l])
    np.testing.assert_array_equal(qtree["lm_head.q"].numpy(), np.asarray(jtree["lm_head"]["q"]))
    assert qtree["blocks.0.q_proj.q"].dtype == (torch.uint8 if mode == "int4" else torch.int8)
    # norms keep their name: ``scale`` outside a quantized subtree is a weight
    assert "blocks.0.ln_1.weight" in qtree and "ln_f.weight" in qtree
    assert peng.linear_impl == f"woq_{mode}" == jeng._impls["linear"].name
    torch.testing.assert_close(peng.model.blocks[1].up_proj.q, qtree["blocks.1.up_proj.q"],
                               rtol=0, atol=0)
    assert peng.model.blocks[1].up_proj.weight is None and peng.model.wte.weight is not None


def test_first_wave_logits_agree(engines):
    """A mixed first wave: one prompt longer than the prefill chunk (two
    waves), one shorter; then a decode step."""
    _, jeng, peng, _, _ = engines
    prompts = _prompts(0, (23, 9))
    np.testing.assert_allclose(peng.put([1, 2], prompts),
                               np.asarray(jeng.put([1, 2], prompts)), **LOGIT_TOL)
    nxt = _prompts(1, (1, 1))
    np.testing.assert_allclose(peng.put([1, 2], nxt),
                               np.asarray(jeng.put([1, 2], nxt)), **LOGIT_TOL)
    for uid in (1, 2):
        jeng.flush(uid)
        peng.flush(uid)


def test_generate_greedy_tokens_identical(engines, monkeypatch):
    """Chunked prefill, mixed waves, then a decode burst."""
    _, jeng, peng, _, _ = engines
    prompts = [list(p) for p in _prompts(3, (5, 11, 7, 20))]
    want = jax_generate(jeng, prompts, max_new_tokens=10)
    bursts = []
    burst = peng.decode_burst
    monkeypatch.setattr(peng, "decode_burst",
                        lambda *a, **k: bursts.append(a[2]) or burst(*a, **k))
    assert generate(peng, prompts, max_new_tokens=10) == want
    assert bursts and sum(bursts) >= 8
    assert peng.state_manager.free_blocks == jeng.state_manager.free_blocks


def test_host_quantized_placement_equals_the_jax_engines(engines):
    """From the DENSE tree: the port quantizes on the host, leaf by leaf,
    and uploads the same integers the JAX engine serves; a seeded model is
    quantized where it lies and equals ``quantize_param_tree`` of the dense
    engine's weights."""
    mode, _, peng, dense, _ = engines
    host = _port_engine(mode, params_from_jax(dense))
    want = peng.model.state_dict()
    got = host.model.state_dict()
    assert list(got) == list(want)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)
    seeded = _port_engine(mode, None, seed=5)
    ref = _port_engine(None, None, seed=5)
    tree = tq.quantize_param_tree(ref.model.state_dict(), tq.QuantizationConfig.from_mode(mode))
    got = seeded.model.state_dict()
    assert sorted(got) == sorted(tree)
    for name in tree:
        torch.testing.assert_close(got[name], tree[name], rtol=0, atol=0, msg=name)
    prompts = [list(p) for p in _prompts(4, (6, 13))]
    assert generate(seeded, prompts, max_new_tokens=4) == \
        generate(_port_engine(mode, got), prompts, max_new_tokens=4)
    with pytest.raises(KeyError, match="does not fit"):
        _port_engine(mode, {k: v for k, v in got.items() if k != "ln_f.weight"})
