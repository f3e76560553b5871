"""The 1-bit optimizers of the port (``runtime/comm/compressed.py``,
``runtime/fp16/onebit/``, the engine's 1-bit step and its tags) against
the JAX package.

- ``compressed_allreduce`` against the JAX function in ``shard_map``
  (jitted), on a world of 2 and of 1: each worker's scale (read back from
  its residual) within 1e-5 relative of JAX's (the two sides sum
  ``mean(|x|)`` in other orders), the worker errors within that and 4 ulp
  of the value and of the scale, the server errors likewise, the results within 1e-5
  relative with equal signs, outside the band of 4 ulp of the server scale
  around zero where a sign may flip; the wire's bytes.
- Each optimizer's ``update`` against JAX's over warm-up and compressed
  steps (``freeze_step`` 2; 0/1 Adam at ``var_freeze_step`` 4,
  ``local_step_scaler`` 2, the JAX suite's params), one rank in this
  process and a world of 2: after every step the master, the moments,
  both errors, ``lamb_coeff`` within fp32 ``rtol = atol = 1e-5`` of the JAX
  device of the same rank, the counts equal. 1-bit Adam and LAMB keep the
  ranks bitwise equal; 0/1 Adam's momentum is bitwise equal over the
  ranks exactly on its sync steps, and its masters part at the first
  local step and stay apart (the JAX package syncs no parameters).
- The engines (gpt2-tiny as the JAX suite runs it, fp32, world 2 against
  JAX's 2-device engine
  from the same weights and batch, JAX ``test_trains_through_both_stages``'s
  params): six losses finite and falling, the same on both ranks, within
  1e-4 of JAX's until the first compressed update lands, and after it
  within the gap that JAX opens from itself over the same steps when only
  the order of the batch's rows within each rank changes (the witness,
  ``test_jax_parts_from_itself_after_the_first_compressed_step``); the
  state after that update against JAX's engine (the bounds in
  ``test_engine_state_after_the_first_compressed_step``).
- A topology that is not pure data parallelism raises JAX's
  ``ValueError``; ZeRO++ with a 1-bit optimizer raises as in JAX.
- Tags: a port 1-bit tag's keys, shapes and dtypes are the JAX engine's;
  the port loads the JAX tag into its state bit for bit; port tags of
  1-bit LAMB and of 0/1 Adam (whose ranks differ) saved on a world of 2
  load back bit for bit (``test_a_onebit_tag_round_trips_bitwise``).

The gloo world (``world``: two child processes that import only the port,
a ``file://`` rendezvous in ``tmp_path``, a time limit on the run) is one
module-scoped run; the JAX side runs here.
"""

import json
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
import deepspeed_tpu_torch
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.models import gpt2_model as jax_gpt2
from deepspeed_tpu.runtime import topology as jtopo
from deepspeed_tpu.runtime.comm import compressed as jcompressed
from deepspeed_tpu.runtime.fp16 import onebit as jonebit
from deepspeed_tpu.runtime.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240   # seconds for the whole two-rank run, rendezvous included
N = 2
# the JAX suite's engine test (test_onebit.py ``_onebit_engine``): gpt2-tiny,
# 16 positions, a vocabulary of 128, batches of 8 x 8
GPT2 = dict(max_seq_len=16, vocab_size=128, remat=False)
V, B, S = 128, 8, 8
LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_ATOL = 1e-4
ULPS = 4
SUM_RTOL = 1e-5   # a mean of ~1000 fp32 values summed in two orders

# name: (port class, JAX class, params), JAX test_onebit.py's params
OPTIMIZERS = {
    "onebit_adam": ("OnebitAdam", {"freeze_step": 2}),
    "onebit_lamb": ("OnebitLamb", {"freeze_step": 2}),
    "zero_one_adam": ("ZeroOneAdam", {"var_freeze_step": 4, "local_step_scaler": 2}),
}
UPDATE_STEPS = 6
LEAVES = {"a": (33, 7), "b/c": (64,), "d": (3, 5, 4)}   # JAX paths and shapes
ENGINE_STEPS = 6
# the engines' state is compared after the first compressed update (1-bit
# Adam and LAMB: freeze_step + 1; 0/1 Adam compresses from its first step)
STATE_AT = {"onebit_adam": 3, "onebit_lamb": 3, "zero_one_adam": 1}
# the witness: each JAX engine replayed from its first state on the batch with
# its rows permuted within each rank's shard (the same losses in exact
# arithmetic, other fp32 summation orders), WITNESS_ORDERS random orders
WITNESS_ORDERS = 8
TAG_OPT = "onebit_lamb"


def _engine_config(name):
    return {"train_micro_batch_size_per_gpu": B // N,
            "optimizer": {"type": name, "params": {"lr": LR, **OPTIMIZERS[name][1]}}}


# what the port runs, on one rank here and on each rank of the world
UPDATES = r"""
import numpy as np
import torch
from deepspeed_tpu_torch.runtime.fp16 import onebit


def run_updates(rank, inputs, spec, out):
    for name, (cls, params) in spec["optimizers"].items():
        opt = getattr(onebit, cls)(lr=spec["lr"], **params)
        master = {p: torch.from_numpy(inputs["param::" + p]) for p in spec["leaves"]}
        state = opt.init(master)
        for t in range(spec["steps"]):
            grads = {p: torch.from_numpy(inputs[f"grad::{p}"][rank, t]) for p in spec["leaves"]}
            opt.update(grads, state, spec["lr"])
            for slot, v in state.items():
                if isinstance(v, dict):
                    for p, x in v.items():
                        out[f"{name}::{t}::{slot}::{p}"] = x.numpy().copy()
                else:
                    out[f"{name}::{t}::{slot}"] = np.array(v)
"""

CHILD = r"""
import os
import sys
import time
import numpy as np
import torch
rank, workdir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(2)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.models import gpt2_model, llama_model
from deepspeed_tpu_torch.runtime.comm.compressed import compressed_allreduce
dist.init_distributed("gloo", rank=rank, world_size=2,
                      init_method="file://" + workdir + "/rendezvous", timeout=120)
spec = eval(open(workdir + "/spec.py").read())
inputs = dict(np.load(workdir + "/inputs.npz"))
out = {}

x, we, se = (torch.from_numpy(inputs[k][rank]) for k in ("car::x", "car::we", "car::se"))
ledger = dist.CollectiveLedger()
with dist.record_into(ledger):
    res = compressed_allreduce(x, we, se)
for k, v in zip(("out", "we", "se"), res):
    out["car::" + k] = v.numpy()
out["car::wire"] = np.array([r["wire_bytes"] for r in ledger.records])

scope = {}
exec(spec["updates"], scope)
scope["run_updates"](rank, inputs, spec, out)

init = {k.split("::", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
        if k.startswith("init::")}
batch = {"input_ids": inputs["batch"]}


def build(name, seed=3):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_model("gpt2-tiny", dtype=torch.float32, **spec["gpt2"]),
        config=spec["engines"][name],
        model_parameters=init if seed == 3 else None, device="cpu", seed=seed)
    return engine


def opt_arrays(engine, prefix):
    for slot, v in engine.opt_state.items():
        if isinstance(v, dict):
            for p, t in v.items():
                out[f"{prefix}::{slot}::{p}"] = t.numpy().copy()
        else:
            out[f"{prefix}::{slot}"] = np.array(v)
    for k, v in engine.module_state_dict().items():
        out[f"{prefix}::param::{k}"] = v.numpy().copy()


for name in spec["engines"]:
    engine = build(name)
    assert type(engine).__name__ == "OnebitDataParallelEngine" and not engine._overlap_active
    losses = []
    for t in range(spec["engine_steps"]):
        losses.append(float(engine.train_batch(batch)))
        if t + 1 == spec["state_at"][name]:
            opt_arrays(engine, name + "-state")
    out[name + "::losses"] = np.array(losses)
    out[name + "::gnorm"] = np.array(engine.get_global_grad_norm())
    if name in spec["round_trip"]:
        engine.save_checkpoint(workdir + "/port_" + name, tag="t")
        opt_arrays(engine, name + "-saved")
        out[name + "-saved::next"] = np.array(float(engine.train_batch(batch)))
    del engine

# the port's tags, and the JAX tag, into fresh engines of another seed
for name in spec["round_trip"]:
    engine = build(name, seed=11)
    engine.load_checkpoint(workdir + "/port_" + name, tag="t")
    opt_arrays(engine, name + "-loaded")
    out[name + "-loaded::next"] = np.array(float(engine.train_batch(batch)))
    del engine
deadline = time.monotonic() + 200
while not os.path.exists(workdir + "/jax_tag_ready"):   # written beside this run
    if time.monotonic() > deadline:
        raise RuntimeError("the JAX tag was not written")
    time.sleep(0.2)
engine = build(spec["tag_opt"], seed=11)
engine.load_checkpoint(workdir + "/jax_tag", tag="t")
opt_arrays(engine, "jax-loaded")
del engine

try:
    deepspeed_tpu_torch.initialize(model=llama_model("llama2-tiny", dtype=torch.float32),
                                   config=dict(spec["engines"]["onebit_adam"],
                                               topology={"data": 1, "seq": 2}), device="cpu")
    out["seq::raised"] = np.array("")
except ValueError as e:
    out["seq::raised"] = np.array(str(e))
np.savez(workdir + f"/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _spec():
    return {"optimizers": OPTIMIZERS, "lr": LR, "leaves": list(LEAVES), "steps": UPDATE_STEPS}


def _update_inputs(n):
    rng = np.random.default_rng(4)
    inputs = {}
    for p, shape in LEAVES.items():
        inputs["param::" + p] = rng.standard_normal(shape).astype(np.float32)
        inputs["grad::" + p] = (rng.standard_normal((n, UPDATE_STEPS) + shape)
                                * 0.1).astype(np.float32)
    return inputs


def _jax_paths(tree, prefix=""):
    """``{"/"-joined path: array}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_paths(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat):
    out = {}
    for path, a in flat.items():
        *head, last = path.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = jnp.asarray(a)
    return out


def _jax_updates(name, inputs, n):
    """JAX's optimizer in ``shard_map`` over ``n`` devices, each device's
    whole state its own (a leading device axis in and out, so ranks that
    part stay visible): ``[step][slot] -> {path: [n, ...]}``."""
    cls, params = OPTIMIZERS[name]
    opt = getattr(jonebit, cls)(lr=LR, axis="data", axis_size=n, **params)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    state = opt.init(_nest({p: inputs["param::" + p] for p in LEAVES}))
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape), state)

    def body(st, g):
        st = jax.tree.map(lambda a: a[0], st)
        g = jax.tree.map(lambda a: a[0], g)
        _, new = opt.update(g, st, LR)
        return jax.tree.map(lambda a: a[None], new)

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                             out_specs=P("data"), check_vma=False))
    history = []
    for t in range(UPDATE_STEPS):
        state = step(state, _nest({p: inputs["grad::" + p][:, t] for p in LEAVES}))
        history.append({slot: (_jax_paths(v) if isinstance(v, dict) else np.asarray(v))
                        for slot, v in jax.device_get(state).items()})
    return history


def _check_updates(name, got, want, n):
    """The port's state after each step (``got[rank]``) against the JAX
    device of the same rank."""
    for t in range(UPDATE_STEPS):
        for slot, w in want[t].items():
            for r in range(n):
                if isinstance(w, dict):
                    for p in LEAVES:
                        g = got[r][f"{name}::{t}::{slot}::{p}"]
                        np.testing.assert_allclose(g, w[p][r], **TOL,
                                                   err_msg=f"{name} step {t} {slot} {p} rank {r}")
                else:
                    assert int(got[r][f"{name}::{t}::{slot}"]) == int(w[r]), (name, t, slot)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_update_on_one_rank_matches_jax(name):
    inputs = _update_inputs(1)
    out = {}
    scope = {}
    exec(UPDATES, scope)
    scope["run_updates"](0, inputs, dict(_spec(), optimizers={name: OPTIMIZERS[name]}), out)
    _check_updates(name, [out], _jax_updates(name, inputs, 1), 1)


# -- the gloo world ----------------------------------------------------------------------


def _car_inputs(rng):
    numel = 1001                   # padded to 1002 over 2 workers
    return {"car::x": rng.standard_normal((N, numel)).astype(np.float32),
            "car::we": (rng.standard_normal((N, numel + 1)) * 0.1).astype(np.float32),
            "car::se": (rng.standard_normal((N, (numel + 1) // N)) * 0.1).astype(np.float32)}


def _jax_compressed(x, we, se, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

    def body(a, w, s):
        out, nw, ns = jcompressed.compressed_allreduce(a[0], w[0], s[0], "data")
        return out[None], nw[None], ns[None]

    sm = shard_map(body, mesh=mesh, in_specs=(P("data"),) * 3, out_specs=(P("data"),) * 3,
                   check_vma=False)
    return [np.asarray(a) for a in jax.jit(sm)(jnp.asarray(x), jnp.asarray(we),
                                                jnp.asarray(se))]


def _jax_engine(name):
    jtopo.reset()
    jcomm.reset_transport()
    topo = MeshTopology(TopologyConfig(data=N), devices=jax.devices()[:N])
    eng, *_ = deepspeed_tpu.initialize(model=jax_gpt2("gpt2-tiny", dtype=jnp.float32, **GPT2),
                                       config=_engine_config(name), topology=topo, seed=7)
    return eng


def _witness(eng, first_state, counters, batch):
    """The JAX engine's six losses from ``first_state`` again, on the batch
    in its own order (row 0) and in WITNESS_ORDERS orders of the rows within
    each rank's shard: ``[1 + WITNESS_ORDERS, ENGINE_STEPS]``."""
    rng = np.random.default_rng(1)
    rows = len(batch) // N
    orders = [np.arange(len(batch))] + [
        np.concatenate([r * rows + rng.permutation(rows) for r in range(N)])
        for _ in range(WITNESS_ORDERS)]
    out = []
    for order in orders:
        eng.state = jax.tree.map(lambda a, h: jax.device_put(h, a.sharding), eng.state,
                                 first_state)
        eng.global_steps, eng.micro_steps, eng.skipped_steps = counters
        out.append([float(eng.train_batch({"input_ids": batch[order]}))
                    for _ in range(ENGINE_STEPS)])
    return np.array(out)


def _witness_gap(jax_out, name):
    """How far JAX's losses part from its own after the first compressed
    update under another order of the rows: the largest gap over those
    steps and the orders."""
    w = jax_out["witness::" + name]
    return float(np.abs(w[1:] - w[0])[:, STATE_AT[name]:].max())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gloo ranks start as soon as the first JAX engine gives their
    weights, and run beside the JAX side; they read the JAX tag once
    ``jax_tag_ready`` marks it written."""
    rng = np.random.default_rng(0)
    workdir = tmp_path_factory.mktemp("onebit_world")
    inputs = {"batch": rng.integers(0, V, size=(B, S)), **_car_inputs(rng),
              **_update_inputs(N)}
    jax_out = {"updates": {}, "engines": {}}
    spec = dict(_spec(), updates=UPDATES, engine_steps=ENGINE_STEPS, tag_opt=TAG_OPT,
                round_trip=(TAG_OPT, "zero_one_adam"), state_at=STATE_AT, gpt2=GPT2,
                engines={name: _engine_config(name) for name in OPTIMIZERS})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="2")
    procs, logs = [], []
    try:
        for i, name in enumerate(OPTIMIZERS):
            eng = _jax_engine(name)
            if i == 0:
                for k, v in params_from_jax(jax.device_get(eng.state["params"])).items():
                    inputs["init::" + k] = v.numpy()
                np.savez(workdir / "inputs.npz", **inputs)
                (workdir / "spec.py").write_text(repr(spec))
                procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(workdir)],
                                          cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
                         for r in range(N)]
            first_state = jax.device_get(eng.state)
            counters = (eng.global_steps, eng.micro_steps, eng.skipped_steps)
            losses = []
            for t in range(ENGINE_STEPS):
                losses.append(float(eng.train_batch({"input_ids": inputs["batch"]})))
                if t + 1 == STATE_AT[name]:
                    jax_out["state::" + name] = {
                        slot: (_jax_paths(v) if isinstance(v, dict) else np.asarray(v))
                        for slot, v in jax.device_get(eng.state["opt"]).items()}
            jax_out["engines"][name] = losses
            if name == TAG_OPT:
                eng.save_checkpoint(str(workdir / "jax_tag"), tag="t")
                (workdir / "jax_tag_ready").write_text("")
                jax_out["tag_state"] = {slot: (_jax_paths(v) if isinstance(v, dict)
                                               else np.asarray(v))
                                        for slot, v in jax.device_get(eng.state["opt"]).items()}
            jax_out["witness::" + name] = _witness(eng, first_state, counters, inputs["batch"])
        jtopo.reset()
        jcomm.reset_transport()
        for name in OPTIMIZERS:
            jax_out["updates"][name] = _jax_updates(name, inputs, N)
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
    return inputs, jax_out, workdir, [dict(np.load(workdir / f"out{r}.npz")) for r in range(N)]


def _within(diff, tol):
    bad = ~(diff <= tol)
    assert not bad.any(), (int(bad.sum()), float((diff / tol)[bad].max()))


def _server_values(x, we, se, n):
    """Each server's compensated chunk ``[n, chunk]`` and scale, computed in
    float64 from the inputs (the signs do not depend on the summation
    order; the scales differ from either side's by an ulp or so)."""
    padded = we.shape[1]
    comp = np.pad(x, ((0, 0), (0, padded - x.shape[1]))).astype(np.float32) + we
    scales = np.abs(comp.astype(np.float64)).mean(axis=1)
    signs = np.where(comp >= 0, 1.0, -1.0)
    avg = (scales[:, None] * signs).mean(axis=0).reshape(n, -1)
    server = avg + se
    return comp, server, np.abs(server).mean(axis=1)


@pytest.mark.parametrize("n", [1, 2])
def test_compressed_allreduce_matches_jax(world, n):
    inputs, _, _, ranks = world
    x, we, se = inputs["car::x"], inputs["car::we"], inputs["car::se"]
    if n == 1:
        from deepspeed_tpu_torch.runtime.comm.compressed import compressed_allreduce, error_state
        we1, se1 = error_state(x.shape[1], 1)
        x, we, se = x[:1], we1.numpy()[None], se1.numpy()[None]
        assert we.shape == se.shape == x.shape
        got = [[t.numpy() for t in compressed_allreduce(torch.from_numpy(x[0]), we1, se1)]]
    else:
        got = [[r["car::" + k] for k in ("out", "we", "se")] for r in ranks]
    want = _jax_compressed(x, we, se, n)
    numel, padded = x.shape[1], we.shape[1]
    chunk = padded // n
    comp, server, s_scales = _server_values(x, we, se, n)
    ulp = lambda a: ULPS * np.spacing(np.abs(np.asarray(a, np.float32)))
    # outside the band a sign cannot flip
    band = np.abs(server) <= ulp(s_scales)[:, None]
    keep = ~band.reshape(-1)[:numel]
    assert keep.mean() > 0.99
    sign = lambda a: np.where(a >= 0, 1.0, -1.0)
    for r in range(n):
        g_out, g_we, g_se = got[r]
        # each side's worker scale, from its residual: comp - scale * sign(comp)
        scales = [np.median((comp[r] - e) * sign(comp[r])) for e in (g_we, want[1][r])]
        ds = abs(scales[0] - scales[1])
        assert ds <= SUM_RTOL * scales[1], (scales, ds)
        _within(np.abs(g_we - want[1][r]), ds + ulp(comp[r]) + ulp(scales[1]))
        ok = ~band[r]
        _within(np.abs(g_se - want[2][r])[ok], (SUM_RTOL * s_scales[r] + ulp(server[r]))[ok])
        np.testing.assert_allclose(g_out[keep], want[0][r][keep], rtol=1e-5, atol=0)
        assert (np.sign(g_out[keep]) == np.sign(want[0][r][keep])).all()
    if n == 2:
        np.testing.assert_array_equal(got[0][0], got[1][0])
        # the wire: the int8 sign chunks' all-to-all, this rank's scale, its
        # server chunk's int8 signs and its scale
        for r in ranks:
            assert r["car::wire"].tolist() == [padded, 4, chunk, 4]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_update_on_a_world_of_two_matches_jax(world, name):
    _, jax_out, _, ranks = world
    _check_updates(name, ranks, jax_out["updates"][name], N)
    cls, params = OPTIMIZERS[name]
    for t in range(UPDATE_STEPS):
        same = lambda slot: all(np.array_equal(ranks[0][f"{name}::{t}::{slot}::{p}"],
                                               ranks[1][f"{name}::{t}::{slot}::{p}"])
                                for p in LEAVES)
        if name != "zero_one_adam":
            assert same("master") and same("exp_avg"), (name, t)
            continue
        step = t + 1
        sync = step % (2 ** min(step // params["local_step_scaler"], 10)) == 0
        # the synchronized momentum is every rank's; a local step parts the ranks
        assert same("exp_avg") == sync, (t, sync)
        first_local = 3       # steps 1, 2 sync, 3 is local at local_step_scaler 2
        assert same("master") == (step < first_local), t


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_jax_parts_from_itself_after_the_first_compressed_step(world, name):
    """The witness behind the engines' loss bound: JAX replayed from the
    same state on the same rows gives its losses bit for bit; in other
    orders of the rows within each rank, its losses agree within LOSS_ATOL
    until the first compressed update lands, and then 1-bit Adam's and
    LAMB's part by more (the frozen variance of an element whose gradient
    is tiny is known to a few ulp of its gradient's noise, and ``lr * m /
    sqrt(v)`` multiplies that by up to 1e4), while 0/1 Adam's, whose
    variance keeps its bias correction and its refreshes, stay within it."""
    _, jax_out, _, _ = world
    w = jax_out["witness::" + name]
    first = STATE_AT[name]
    np.testing.assert_array_equal(w[0], jax_out["engines"][name])
    np.testing.assert_allclose(w[1:, :first], np.broadcast_to(w[0, :first], w[1:, :first].shape),
                               rtol=0, atol=LOSS_ATOL)
    assert (_witness_gap(jax_out, name) > LOSS_ATOL) == (name != "zero_one_adam"), \
        _witness_gap(jax_out, name)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_engines_train_through_both_stages(world, name):
    """Six losses, finite and falling, the same on both ranks; within
    LOSS_ATOL of JAX's until the first compressed update lands, and after it
    within the larger of LOSS_ATOL and the gap JAX opens from itself over
    those steps under another order of the rows
    (``test_jax_parts_from_itself_after_the_first_compressed_step``;
    ``test_engine_state_after_the_first_compressed_step`` holds the state
    after that update)."""
    _, jax_out, _, ranks = world
    want = jax_out["engines"][name]
    first = STATE_AT[name]
    after = max(LOSS_ATOL, _witness_gap(jax_out, name))
    for r in ranks:
        got = r[name + "::losses"]
        assert np.all(np.isfinite(got)) and got[-1] < got[0], got
        np.testing.assert_allclose(got[:first], want[:first], rtol=0, atol=LOSS_ATOL)
        np.testing.assert_allclose(got[first:], want[first:], rtol=0, atol=after)
        assert float(r[name + "::gnorm"]) > 0
    np.testing.assert_array_equal(ranks[0][name + "::losses"], ranks[1][name + "::losses"])


def _flips(d, a, limit):
    """Elements off TOL: at most ``limit`` of the leaf (sign flips of
    values within an ulp or so of zero)."""
    off = d > TOL["atol"] + TOL["rtol"] * np.abs(a)
    return int(off.sum()) <= max(1, int(limit * a.size)), int(off.sum())


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_engine_state_after_the_first_compressed_step(world, name):
    """The engine's state after its first compressed update against the
    JAX engine's (each rank's errors against the JAX device of the same
    rank): the moments within TOL, the errors and the synchronized
    momentum within TOL but for sign flips (at most 1 in 10^4 of a leaf);
    the master within TOL plus what the two sides' moments give it, ``lr
    * coeff * (|m| * |1 / (sqrt(v) + eps) - 1 / (sqrt(v') + eps)| + |m -
    m'| / (sqrt(min(v, v')) + eps))``, which is large only where ``v`` is
    tiny, but for at most one element in 10^4 of a leaf, which stays within
    2 x lr x steps more (``test_torch_zero.py``'s rule: a warm-up step
    moves an element whose gradient is at the fp32 noise level by +-lr
    whatever its sign)."""
    _, jax_out, _, ranks = world
    want = jax_out["state::" + name]
    eps = 1e-8
    for rank, r in enumerate(ranks):
        got = lambda slot, p: r[f"{name}-state::{slot}::{p}"]
        for slot, w in want.items():
            if not isinstance(w, dict):
                assert int(r[f"{name}-state::{slot}"]) == int(w), slot
                continue
            for p, a in w.items():
                a = a[rank] if slot in ("worker_error", "server_error") else a
                d = np.abs(got(slot, p) - a)
                if slot == "master":
                    m, mj = got("exp_avg", p), want["exp_avg"][p]
                    v, vj = got("exp_avg_sq", p), want["exp_avg_sq"][p]
                    coeff = want["lamb_coeff"][p] if "lamb_coeff" in want else 1.0
                    moved = LR * np.abs(coeff) * (
                        np.abs(mj) * np.abs(1 / (np.sqrt(v) + eps) - 1 / (np.sqrt(vj) + eps))
                        + np.abs(m - mj) / (np.sqrt(np.minimum(v, vj)) + eps))
                    bound = TOL["atol"] + TOL["rtol"] * np.abs(a) + 2 * moved
                    off = d > bound
                    assert off.sum() <= max(1, a.size // 10 ** 4), (p, int(off.sum()))
                    assert (d[off] <= 2 * LR * STATE_AT[name] + 2 * moved[off]).all(), p
                elif slot in ("exp_avg_sq", "lamb_coeff"):
                    np.testing.assert_allclose(got(slot, p), a, **TOL, err_msg=f"{slot} {p}")
                else:
                    ok, off = _flips(d, a, 1e-4)
                    assert ok, (slot, p, off, a.size)


def test_a_topology_that_is_not_pure_data_raises(world):
    for r in world[3]:
        assert "pure data parallelism" in str(r["seq::raised"])


def test_zeropp_and_onebit_are_exclusive():
    with pytest.raises(DeepSpeedConfigError, match="mutually exclusive"):
        deepspeed_tpu_torch.DeepSpeedConfig({
            "optimizer": {"type": "onebit_adam"},
            "zero_optimization": {"stage": 3, "zero_quantized_weights": True}})


def test_the_port_tag_has_the_jax_layout(world):
    _, _, workdir, _ = world
    meta = lambda d: json.loads((workdir / d / "t" / "meta.json").read_text())
    got, want = meta("port_" + TAG_OPT), meta("jax_tag")
    assert sorted(got["keys"]) == sorted(want["keys"])
    for k in want["keys"]:
        assert got["shapes"][k] == want["shapes"][k], k
        assert got["dtypes"][k] == want["dtypes"][k], k
    assert any(k.startswith("opt/worker_error/") for k in want["keys"])
    assert any(k.startswith("opt/lamb_coeff/") for k in want["keys"])


def test_the_port_loads_the_jax_tag_bitwise(world):
    _, jax_out, _, ranks = world
    want = jax_out["tag_state"]
    for rank, r in enumerate(ranks):
        for slot, w in want.items():
            if not isinstance(w, dict):
                assert int(r[f"jax-loaded::{slot}"]) == int(w)
                continue
            for p, a in w.items():
                if slot in ("worker_error", "server_error"):
                    a = a[rank]
                np.testing.assert_array_equal(r[f"jax-loaded::{slot}::{p}"], a,
                                              err_msg=f"{slot} {p}")


@pytest.mark.parametrize("name", [TAG_OPT, "zero_one_adam"])
def test_a_onebit_tag_round_trips_bitwise(world, name):
    """Each rank loads its own rows of the errors and the shared leaves,
    bit for bit. 0/1 Adam's ranks differ after a local step, and a tag holds
    one copy of a replicated leaf, rank 0's (as JAX's tag holds device
    0's): rank 1 loads rank 0's master, moments and params, and its own
    errors; with 1-bit LAMB, whose ranks agree, the next step's loss is the
    saver's."""
    ranks = world[3]
    for rank, r in enumerate(ranks):
        saved = {k[len(name) + 8:]: v for k, v in r.items() if k.startswith(name + "-saved::")}
        errs = sorted(k for k in saved if k.startswith("worker_error::blocks/"))
        assert errs and "step" in saved
        assert ("var_counter" in saved) == (name == "zero_one_adam")
        for k, v in saved.items():
            if k == "next":
                continue
            own = k.split("::")[0] in ("worker_error", "server_error", "step", "var_counter")
            src = v if own else ranks[0][f"{name}-saved::{k}"]
            np.testing.assert_array_equal(r[f"{name}-loaded::{k}"], src, err_msg=f"{k} {rank}")
        if name == TAG_OPT:
            assert float(r[name + "-loaded::next"]) == float(r[name + "-saved::next"])
    key = f"{name}-saved::{errs[0]}"
    assert not np.array_equal(ranks[0][key], ranks[1][key])
    if name == "zero_one_adam":
        key = key.replace("worker_error", "master")
        assert not np.array_equal(ranks[0][key], ranks[1][key])
