"""Error feedback on the ZeRO overlap schedule's int8 reduce-scatter
(``ops/quantizer/quantizer.py`` ``quantize_with_feedback`` /
``ef_quantized_reduce_scatter``, ``TreeComm.err_struct`` and ``scatter(...,
err=)``, ``scan_blocks_pipelined(scatter_err=)``, the engine's carry)
against the JAX package.

In this process:
- ``quantize_with_feedback`` against the jitted JAX function on the same
  input and residual, fp32 and bf16, a padded tail and a tiny tensor: the
  int8 payload and the scales bit for bit; the new residual within 2 ulp
  of the compensated value (XLA's CPU backend fuses ``comp - q * scale``
  into an FMA, the port rounds the product first);
- the schedule's residual slots: JAX's ``scan_blocks_pipelined`` and the
  port's on the same weights and input, with a scatter whose new residual
  is the old plus the sum of the step's gradients and slot s starting at
  1000 s, at 4 layers with prefetch depth 1 and 2 and with two-layer steps
  (``alternating``): every slot's new value within 1e-4 relative of JAX's,
  which a slot given another step's gradients would miss by 1000.

One module-scoped gloo world of 2 (``world``: two child processes that
import only the port, a ``file://`` rendezvous in ``tmp_path``, a time
limit on the run) computes the rest; the JAX side runs here on a 2-device
CPU mesh:
- ``ef_quantized_reduce_scatter`` against the JAX function in
  ``shard_map`` (jitted): the output within 2 ulp of the sum of the
  sources' compensated magnitudes in fp32 (one bf16 rounding step for a
  bf16 input), the residual within 2 ulp of the compensated value, on a
  padded chunk, a tiny leaf and a bf16 input;
- llama2-tiny at stage 3 on the overlap schedule (persistence threshold 0,
  JAX ``test_overlap_plan_engine.py``'s config), 8 accumulated micro steps
  of distinct batches, fp32: the block and rest residual slots equal to
  the JAX engine's ``_ef_struct`` slot for slot; the telescoping property
  of JAX's ``test_error_feedback_carry_telescopes`` on the port (the error
  feedback gradients against the full-width wire ``comm_transport.enabled:
  false`` beat the plain int8 wire by 1.3x and sit within 0.01 x the
  gradients' scale); the port's error-feedback gradients within 0.05 x
  that scale of JAX's error-feedback engine (the ZeRO++ bound of
  ``test_zeropp.py:113``, on the gradients' scale);
- the carry survives ``step()`` bit for bit (JAX
  ``test_ef_state_survives_optimizer_step``); ``overlap_plan: false`` and
  the barrier schedule carry nothing and log JAX's warning.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.ops.quantizer import quantizer as jq
from deepspeed_tpu.runtime import topology as jtopo
from deepspeed_tpu.runtime.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.comm import comm as tcomm
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.models import llama_model
from deepspeed_tpu_torch.ops.quantizer import quantizer as tq
from deepspeed_tpu_torch.runtime.engine import EF_NOT_CARRIED
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240   # seconds for the whole two-rank run, rendezvous included
N = 2
V, B, S = 1024, 8, 16
N_MICROS = 8
ZEROPP_BOUND = 0.05   # test_zeropp.py:113, here times the gradients' scale

# the JAX overlap-plan engine test's config, with llama2-tiny
ZERO = {"stage": 3, "stage3_param_persistence_threshold": 0, "overlap_comm": True}


def _config(transport, gas=N_MICROS, zero=ZERO, **extra):
    return {"train_micro_batch_size_per_gpu": B // N, "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "zero_optimization": zero, "comm_transport": transport, **extra}


ENGINES = {"full": _config({"enabled": False}), "plain": _config({}),
           "ef": _config({"error_feedback": True})}
# name: (reduce-scatter input shape a rank, dtype)
SCATTER_CASES = {"padded": ((8, 300), "float32"), "tiny": ((2, 5), "float32"),
                 "even": ((4, 256), "float32"), "bf16": ((8, 300), "bfloat16")}


# -- quantize_with_feedback against the jitted JAX function ---------------------------


def _spacing(a):
    return np.spacing(np.abs(np.asarray(a, np.float32)))


def _within(diff, tol, msg=""):
    bad = ~(diff <= tol)
    assert not bad.any(), (msg, int(bad.sum()), float((diff / tol)[bad].max()))


@pytest.mark.parametrize("shape,gs,dtype", [((3, 300), 256, "float32"), ((7,), 256, "float32"),
                                            ((4, 64), 64, "float32"),
                                            ((3, 300), 256, "bfloat16")])
def test_quantize_with_feedback_matches_jax(shape, gs, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    err = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = jax.jit(lambda a, e: jq.quantize_with_feedback(a, e, 8, gs))(jx, jnp.asarray(err))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tq.quantize_with_feedback(tx, torch.from_numpy(err), 8, gs)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    comp = tx.float().numpy() + err
    assert got[3].shape == tx.shape and got[3].dtype == torch.float32
    _within(np.abs(got[3].numpy() - np.asarray(want[3])), 2 * _spacing(comp))


# -- the schedule's residual slots against JAX's scan ---------------------------------


@pytest.mark.parametrize("depth,policy", [(1, None), (2, None), (1, "alternating")])
def test_scatter_err_slots_follow_the_step(depth, policy):
    """Step s's reduction takes slot s and its new residual lands in slot s,
    in the JAX reverse scan (xs ``scatter_err[1:]``, the epilogue slot 0)
    and in the port's eager loop: each slot's new value is its old value
    (1000 s) plus the sum of the step's gradients."""
    L = 4
    jm = jax_llama("llama2-tiny", dtype=jnp.float32, num_layers=L)
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    lps = 2 if policy == "alternating" else 1
    n_steps = L // lps
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, jm.config.hidden_size)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    slots = np.arange(n_steps, dtype=np.float32) * 1000

    positions = jnp.arange(x.shape[1])[None, :]

    @jax.jit
    def new_slots(blocks, xx, dyy, err):
        _, _, pullback = jm.scan_blocks_pipelined(
            blocks, xx, positions, gather=lambda t: t,
            scatter=lambda t, err: (t, err + sum(jnp.sum(a) for a in jax.tree.leaves(t))),
            layers_per_step=lps, prefetch_depth=depth, scatter_err=err)
        return pullback(dyy, 0.0)[2]

    want = np.asarray(new_slots(params["blocks"], jnp.asarray(x), jnp.asarray(dy),
                                jnp.asarray(slots)))

    tm = llama_model("llama2-tiny", dtype=torch.float32, num_layers=L, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    for p in tm.parameters():
        p.requires_grad_(True)
    rope = tm.embed_inputs(torch.zeros((2, 8), dtype=torch.long))[1]

    def gather(s):
        return tcomm.ready([{n: p.data for n, p in tm.blocks[l].named_parameters()}
                            for l in range(s * lps, (s + 1) * lps)])

    def scatter(s, grads, err):
        return tcomm.ready(err + sum(float(g.sum()) for step in grads for g in step.values()))

    _, _, pb = tm.scan_blocks_pipelined(torch.from_numpy(x), rope, gather=gather,
                                        scatter=scatter, layers_per_step=lps,
                                        prefetch_depth=depth,
                                        scatter_err=[torch.tensor(v) for v in slots])
    _, new_err = pb(torch.from_numpy(dy))
    got = np.array([float(t) for t in new_err])
    assert got.shape == want.shape == (n_steps,)
    np.testing.assert_allclose(got - slots, want - slots, rtol=1e-4, atol=1e-3)


# -- the gloo world ------------------------------------------------------------------

CHILD = r"""
import logging
import sys
import numpy as np
import torch
rank, workdir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(2)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.models import llama_model
from deepspeed_tpu_torch.ops.quantizer import quantizer as q
dist.init_distributed("gloo", rank=rank, world_size=2,
                      init_method="file://" + workdir + "/rendezvous", timeout=120)
spec = eval(open(workdir + "/spec.py").read())
inputs = dict(np.load(workdir + "/inputs.npz"))
out = {}

warnings = []
handler = logging.Handler()
handler.emit = lambda record: warnings.append(record.getMessage())
logging.getLogger("deepspeed_tpu_torch.runtime.engine").addHandler(handler)

for name, (shape, dtype) in spec["scatter"].items():
    x = torch.from_numpy(inputs["x::" + name][rank]).to(getattr(torch, dtype))
    err = torch.from_numpy(inputs["err::" + name][rank])
    r, new_err = q.ef_quantized_reduce_scatter(x, err)
    out["out::" + name] = r.float().numpy()
    out["new_err::" + name] = new_err.numpy()


def build(config):
    init = {k.split("::", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
            if k.startswith("init::")}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=llama_model("llama2-tiny", dtype=torch.float32), config=config,
        model_parameters=init, device="cpu")
    return engine


batches = [{"input_ids": inputs["batches"][i]} for i in range(len(inputs["batches"]))]
for name, config in spec["engines"].items():
    engine = build(config)
    for b in batches:
        engine.forward(b)
        engine.backward()
    for k, g in engine.grad_acc.items():
        d = engine.grad_dims[k]
        out[name + "::gacc::" + k] = (g if d is None else
                                      dist.all_gather(g.movedim(d, 0)).movedim(0, d)).numpy()
    out[name + "::carry"] = np.array(engine._ef_carry_active)
    if engine._ef_carry_active:
        st = engine._sched.ef_struct
        out[name + "::blocks_struct"] = np.array([repr(s) for s in st["blocks"]])
        out[name + "::rest_struct"] = np.array(repr({k: v for k, v in st.items()
                                                     if k != "blocks"}))
        out[name + "::res_abs"] = np.array(sum(float(t.abs().sum()) for slots in (
            *engine._ef_state["blocks"], *(v for k, v in engine._ef_state.items()
                                           if k != "blocks")) for t in slots if t is not None))
    del engine

# the carry across an optimizer step (gas 2, four micro steps)
engine = build(spec["survives"])
same = []
for i, b in enumerate(batches[:4]):
    engine.forward(b)
    engine.backward()
    if (i + 1) % 2 == 0:
        flat = lambda: [t.clone() for slots in (*engine._ef_state["blocks"], *(
            v for k, v in engine._ef_state.items() if k != "blocks")) for t in slots
            if t is not None]
        before = flat()
        engine.step()
        same.append(all(torch.equal(a, b) for a, b in zip(before, flat())))
out["survives"] = np.array(same + [engine._ef_carry_active, engine.global_steps])
del engine

for name, config in spec["no_carry"].items():
    warnings.clear()
    engine = build(config)
    engine.forward(batches[0])
    out[name + "::no_carry"] = np.array([engine._ef_carry_active, engine._ef_state is None,
                                         engine._overlap_active])
    out[name + "::warned"] = np.array(spec["warning"] in warnings)
    del engine
np.savez(workdir + f"/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _jax_engine(config):
    jtopo.reset()
    jcomm.reset_transport()
    topo = MeshTopology(TopologyConfig(data=N), devices=jax.devices()[:N])
    eng, *_ = deepspeed_tpu.initialize(model=jax_llama("llama2-tiny", dtype=jnp.float32),
                                       config=config, topology=topo, seed=7)
    return eng


def _jax_scatter(x, err):
    """The JAX ``ef_quantized_reduce_scatter`` in ``shard_map`` over
    ``jax.devices()[:2]``, jitted: each member's ``(out, new_err)``."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("data",))

    def body(a, e):
        r, ne = jq.ef_quantized_reduce_scatter(a[0], e[0], "data")
        return r[None], ne[None]

    sm = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")), check_vma=False)
    r, ne = jax.jit(sm)(x, jnp.asarray(err))
    return np.asarray(r.astype(jnp.float32)), np.asarray(ne)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gloo ranks start once the JAX engine gives their weights, and run
    beside its eight micro steps."""
    rng = np.random.default_rng(0)
    inputs = {"batches": rng.integers(0, V, size=(N_MICROS, B, S))}
    for name, (shape, _) in SCATTER_CASES.items():
        inputs["x::" + name] = rng.standard_normal((N,) + shape).astype(np.float32)
        inputs["err::" + name] = (rng.standard_normal((N,) + shape) * 0.01).astype(np.float32)
    spec = {"scatter": SCATTER_CASES, "engines": ENGINES, "warning": EF_NOT_CARRIED,
            "survives": _config({"error_feedback": True}, gas=2),
            "no_carry": {"plan-off": _config({"error_feedback": True}, gas=1,
                                             overlap_plan=False),
                         "barrier": _config({"error_feedback": True}, gas=1,
                                            zero=dict(ZERO, overlap_comm=False))}}
    workdir = tmp_path_factory.mktemp("error_feedback_world")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="2")
    jax_out, procs, logs = {}, [], []
    try:
        eng = _jax_engine(ENGINES["ef"])
        for k, v in params_from_jax(jax.device_get(eng.state["params"])).items():
            inputs["init::" + k] = v.numpy()
        np.savez(workdir / "inputs.npz", **inputs)
        (workdir / "spec.py").write_text(repr(spec))
        procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(workdir)],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(N)]
        for i in range(N_MICROS):
            eng.forward({"input_ids": inputs["batches"][i]})
            eng.backward()
        assert eng._overlap_active and eng._ef_carry_active
        jax_out["gacc"] = {k: v.numpy() for k, v in
                           params_from_jax(jax.device_get(eng.state["grad_acc"])).items()}
        jax_out["ef_struct"] = eng._ef_struct
        jtopo.reset()
        jcomm.reset_transport()
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the gloo world did not finish within {WORLD_TIMEOUT} s")
    finally:
        jtopo.reset()
        jcomm.reset_transport()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return inputs, jax_out, [dict(np.load(workdir / f"out{r}.npz")) for r in range(N)]


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_ef_quantized_reduce_scatter_matches_jax(world, case):
    inputs, _, ranks = world
    shape, dtype = SCATTER_CASES[case]
    x, err = inputs["x::" + case], inputs["err::" + case]
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want, want_err = _jax_scatter(jx, err)
    comp = np.asarray(jx.astype(jnp.float32)) + err          # each member's compensated input
    rows = shape[0] // N
    for r in range(N):
        got, got_err = ranks[r]["out::" + case], ranks[r]["new_err::" + case]
        assert got.shape == want[r].shape and got_err.shape == shape
        mag = np.abs(comp[:, r * rows:(r + 1) * rows]).sum(0)
        tol = (np.spacing(np.abs(want[r]).astype(np.float32)) * 2 ** 16 if dtype == "bfloat16"
               else 2 * _spacing(mag))
        _within(np.abs(got - want[r]), tol, f"rank {r}")
        _within(np.abs(got_err - want_err[r]), 2 * _spacing(comp[r]), f"rank {r}")
        assert np.abs(got_err).max() > 0


def _slots(struct):
    return [None if s is None else tuple(s) for s in struct]


def test_err_struct_matches_the_jax_engine(world):
    """Every residual slot of the port's carry against the JAX engine's
    ``_ef_struct`` (a leading data axis, the block slots stacked over the
    steps): the same slots in the same order, the same shapes."""
    _, jax_out, ranks = world
    js = jax_out["ef_struct"]
    shape = lambda s, lead: None if s is None else tuple(s.shape)[lead:]
    for r in ranks:
        blocks = [eval(b) for b in r["ef::blocks_struct"]]
        n_steps = {s.shape[1] for s in js["blocks"] if s is not None}
        assert n_steps == {len(blocks)}
        for step in blocks:
            assert _slots(step) == [shape(s, 2) for s in js["blocks"]]
        rest = eval(str(r["ef::rest_struct"]))
        assert sorted(rest) == sorted(k for k in js if k != "blocks")
        for k, slots in rest.items():
            assert _slots(slots) == [shape(s, 1) for s in js[k]], k
        assert any(s is not None for s in blocks[0])


def _max_err(a, ref):
    return max(float(np.max(np.abs(a[k] - ref[k]))) for k in ref)


def test_error_feedback_carry_telescopes(world):
    """JAX's telescoping test on the port: after 8 accumulated micro steps
    the compensated int8 wire's gradients beat the plain wire against the
    full-width run by 1.3x and sit within 0.01 x the gradients' scale; the
    carried residuals are live."""
    _, _, ranks = world
    for r in ranks:
        assert bool(r["ef::carry"]) and not bool(r["plain::carry"])
        assert float(r["ef::res_abs"]) > 0
        gacc = lambda name: {k[len(name) + 8:]: v for k, v in r.items()
                             if k.startswith(name + "::gacc::")}
        full, plain, ef = gacc("full"), gacc("plain"), gacc("ef")
        assert full.keys() == ef.keys() and len(full) > 0
        scale = max(float(np.abs(v).max()) for v in full.values())
        ef_err, plain_err = _max_err(ef, full), _max_err(plain, full)
        assert ef_err < plain_err / 1.3, (ef_err, plain_err)
        assert ef_err <= 0.01 * scale, (ef_err, scale)


def test_error_feedback_gradients_match_the_jax_engine(world):
    _, jax_out, ranks = world
    want = jax_out["gacc"]
    scale = max(float(np.abs(v).max()) for v in want.values())
    for r in ranks:
        for k, w in want.items():
            np.testing.assert_allclose(r["ef::gacc::" + k], w, rtol=ZEROPP_BOUND,
                                       atol=ZEROPP_BOUND * scale, err_msg=k)
    for k in want:   # the shards gathered: the same on both ranks
        np.testing.assert_array_equal(ranks[0]["ef::gacc::" + k], ranks[1]["ef::gacc::" + k])


def test_ef_state_survives_optimizer_step(world):
    _, _, ranks = world
    for r in ranks:
        assert list(r["survives"]) == [True, True, True, 2]


@pytest.mark.parametrize("name", ["plan-off", "barrier"])
def test_no_carry_without_the_planned_schedule(world, name):
    """``overlap_plan: false`` (the identity plan) and the barrier schedule
    carry no residual and log JAX's warning; the plan-off run still takes
    the overlap schedule."""
    _, _, ranks = world
    for r in ranks:
        carry, state_none, overlap = r[name + "::no_carry"]
        assert not carry and state_none and overlap == (name == "plan-off")
        assert bool(r[name + "::warned"])
