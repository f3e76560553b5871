"""The port's data-parallel ZeRO engine against the JAX package.

- the partition plan: each leaf's shard dim against ``add_axes_to_spec`` /
  ``ZeroPartitionPlan`` on the same shapes, over world sizes, stages and the
  persistence threshold;
- the config: the ZeRO++ rules, the batch resolution with a data-parallel
  size, every configuration outside the slice raising with its ROADMAP
  item, and the overlap schedule's keys routed as the JAX engine routes
  them (the schedule itself: ``test_torch_zero_overlap.py``);
- the engine at world 2 on gloo (two child processes that import only the
  port; a fresh ``file://`` rendezvous in ``tmp_path`` and a timeout on the
  run) against the JAX engine on a 2-device mesh (``MeshTopology(
  TopologyConfig(data=2), devices=jax.devices()[:2])``), llama2-tiny, the
  JAX engine's initial parameters carried across by ``params_from_jax``, the
  same global batch, AdamW with clipping 1.0, fp32, 3 steps:
  1. plain stages 1, 2 and 3 (stage 3 with some leaves sharded and some
     persistent): losses within 1e-5 relative; final parameters within 1e-5
     absolute plus 1e-5 relative, except at most one element in 10^4 of a
     leaf, which stays within 2 x lr x steps. The two sides sum gradients in
     other orders (fp32 noise ~1e-7 relative), and Adam's normalised step
     (m / sqrt(v), about +-lr whatever |g|) turns that noise into an
     lr-sized difference where a gradient is itself that small: an element
     whose gradient is ~1e-8 beside a leaf maximum of ~1e-2 (the port on one
     device shows the same few elements against this JAX engine);
  2. stage 3 with qwZ + qgZ on the barrier schedule: losses within the JAX
     suite's ZeRO++ tolerance of the JAX ZeRO++ engine (rtol 0.05, atol
     0.05, ``tests/unit/runtime/zero/test_zeropp.py:113``), falling, and the
     port's collective ledger shows int8 gathers and int8 all-to-alls. Not
     bitwise: the port's per-layer ``[out, in]`` leaves form other
     quantization groups than JAX's stacked ``[L, in, out]`` leaves (the
     collectives themselves are bitwise, ``test_torch_comm.py``);
  3. the same ZeRO++ run held to the int8 rounding bound, port only: its
     first micro step's gathered params against the two ranks' shards, and
     its reduce-scattered gradients against the exact mean of the two
     ranks' local gradients, each element within half an int8 step of its
     group of 256 per source (plus 1e-4 of that step for fp32 rounding).
     The loss tolerance of 2. is too loose to see a fault in the engine's
     wiring around the collectives; this bound is not.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.runtime import topology as jtopo
from deepspeed_tpu.runtime.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JaxZeroConfig
from deepspeed_tpu.runtime.zero.partition import ZeroPartitionPlan as JaxPlan
from deepspeed_tpu.runtime.zero.partition import add_axes_to_spec, dp_axes_in
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.runtime.topology import MeshTopology as TorchTopology
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartitionPlan, shard_dim
from deepspeed_tpu_torch.runtime.zero.partition import dp_axes_in as torch_dp_axes_in
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 300   # seconds for the whole two-rank run, rendezvous included
V, B, S = 1024, 8, 32

SHAPES = [(2048,), (5632, 2048), (2048, 5632), (2048, 2048), (256, 2048), (32000, 2048),
          (3, 5), (7,), (4, 6), (6, 4), (1, 8), (12, 12), (6, 10, 4)]


# -- the partition plan ------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("min_size", [0, 100, int(1e5)])
def test_shard_dims_match_add_axes_to_spec(n, min_size):
    for shape in SHAPES:
        spec = add_axes_to_spec(None, shape, ("data", "mics"), {"data": n, "mics": 1},
                                min_size)
        assert shard_dim(shape, n, min_size) == dp_axes_in(spec)[0], (shape, n, min_size)
        assert torch_dp_axes_in(tuple(spec)) == dp_axes_in(spec)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_partition_plan_matches_jax_by_stage(stage):
    jtopo.reset()
    topo = MeshTopology(TopologyConfig(data=2), devices=jax.devices()[:2])
    shapes = {f"leaf{i}": s for i, s in enumerate(SHAPES)}
    zc = {"stage": stage, "stage3_param_persistence_threshold": 1000}
    jplan = JaxPlan(topo, JaxZeroConfig(**zc), {k: P(*([None] * len(s)))
                                                for k, s in shapes.items()}, shapes)
    plan = ZeroPartitionPlan(DeepSpeedZeroConfig.from_dict(zc), shapes, 2)
    for mine, theirs in ((plan.param_dims(), jplan.param_spec_tree()),
                         (plan.grad_dims(), jplan.grad_spec_tree()),
                         (plan.optimizer_dims(), jplan.optimizer_spec_tree())):
        assert mine == {k: dp_axes_in(v)[0] for k, v in theirs.items()}
    jtopo.reset()


def test_topology_rows_and_axes():
    t = TorchTopology({"data": 4}, world_size=4, rank=2)
    assert t.data_parallel_size == 4 and t.axis_size(("data", "mics")) == 4
    assert t.batch_rows(8) == slice(4, 6)
    with pytest.raises(ValueError, match="does not split"):
        t.batch_rows(6)
    with pytest.raises(ValueError, match="world of 4 ranks"):
        TorchTopology({"data": 4}, world_size=2, rank=0)
    with pytest.raises(NotImplementedError, match="A6"):
        TorchTopology({"data": 2, "model": 2}, world_size=2, rank=0)


# -- the config -------------------------------------------------------------------


@pytest.mark.parametrize("key,value,item", [
    ("zero_optimization", {"stage": 3, "zero_hpz_partition_size": 2, "overlap_comm": False},
     "A6 \\(hpZ"),
    ("zero_optimization", {"stage": 3, "mics_shard_size": 2}, "A6 \\(MiCS"),
    ("zero_optimization", {"stage": 3, "offload_param": {"device": "cpu"}}, "A9"),
    ("zero_optimization", {"stage": 2, "offload_optimizer": {"device": "cpu"}}, "A9"),
    ("comm_transport", {"hierarchical": False}, "A6 \\(the algorithm"),
    ("topology", {"data": 2, "model": 2}, "A6 \\(tensor"),
    ("topology", {"expert": 2}, "A7"),
    ("topology", {"mics": 2}, "A6 \\(hpZ"),
    ("topology", {"pipe": 2}, "A10"),
])
def test_configs_outside_the_slice_raise(key, value, item):
    with pytest.raises(NotImplementedError, match=item):
        deepspeed_tpu_torch.DeepSpeedConfig({key: value})


# keys that raised until the error-feedback and 1-bit slice
@pytest.mark.parametrize("key,value", [
    ("comm_transport", {"error_feedback": True}),
    ("optimizer", {"type": "onebit_adam", "params": {"lr": 1e-3}}),
    ("optimizer", {"type": "OneBitLamb", "params": {"lr": 1e-3}}),
    ("optimizer", {"type": "zero_one_adam", "params": {"lr": 1e-3}}),
])
def test_error_feedback_and_the_onebit_optimizers_are_accepted(key, value):
    """The config takes them and ``initialize`` builds an engine that
    trains a step on one rank (the 1-bit optimizers as the JAX engine builds
    them, on the JAX tree's leaves)."""
    import torch
    from deepspeed_tpu_torch.models import llama_model
    config = {"train_micro_batch_size_per_gpu": 2, key: value}
    deepspeed_tpu_torch.DeepSpeedConfig(config)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=llama_model("llama2-tiny", dtype=torch.float32, num_layers=1), config=config,
        device="cpu")
    loss = float(engine.train_batch({"input_ids": np.zeros((2, 8), dtype=np.int64)}))
    assert np.isfinite(loss)
    if key == "optimizer":
        assert engine.optimizer.name in ("onebit_adam", "onebit_lamb", "zero_one_adam")
        assert engine.opt_state["step"] == 1 and "worker_error" in engine.opt_state


# keys that raised until the overlap schedule's slice, and what they do now
@pytest.mark.parametrize("zero", [{"stage": 3, "zero_quantized_weights": True},
                                  {"stage": 2, "zero_quantized_gradients": True,
                                   "overlap_comm": True},
                                  {"stage": 3, "overlap_comm": True}])
def test_overlap_slice_keys_are_accepted(zero):
    """The JAX default ZeRO++ config, ZeRO++ at stage 2 with ``overlap_comm``
    and plain stage 3 with ``overlap_comm: true`` written build, and route
    a world of 2 to the overlap schedule as the JAX engine does: its
    ``_explicit_micro``, ``overlap_comm`` and eligibility (the micro step it
    builds at the first step takes the schedule when all three hold)."""
    from deepspeed_tpu_torch.models import llama_model
    from deepspeed_tpu_torch.runtime.engine import overlap_route
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({"zero_optimization": zero,
                                              "topology": {"data": 2}})
    model = llama_model("llama2-tiny")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    stage3_overlap, active, reason = overlap_route(cfg.zero_config, model, shapes, 2)
    jtopo.reset()
    try:
        topo = MeshTopology(TopologyConfig(data=2), devices=jax.devices()[:2])
        eng, *_ = deepspeed_tpu.initialize(model=jax_llama("llama2-tiny"), topology=topo, config={
            "zero_optimization": zero, "train_micro_batch_size_per_gpu": 1})
        jreason = eng._zero_overlap_eligibility(eng.zero_plan.grad_spec_tree())
        want = eng._explicit_micro and eng.config.zero_config.overlap_comm and not jreason
        assert (stage3_overlap, active, reason) == (eng._stage3_overlap, want, jreason)
        assert active
    finally:
        jtopo.reset()
        jcomm.reset_transport()


# keys that raised until the sequence-parallel slice, and what they do now
@pytest.mark.parametrize("key,value", [
    ("comm_transport", {"activation_width": "full"}),
    ("comm_transport", {"permute_width": "bf16"}),
    ("topology", {"data": 1, "seq": 2}),
])
def test_sequence_slice_keys_are_accepted(key, value):
    """``comm_transport.activation_width`` steers the Ulysses all-to-all and
    ``.permute_width`` the ring's hops through the planner, as in JAX;
    ``topology.seq`` counts in the data-parallel size of the batch
    resolution."""
    from deepspeed_tpu_torch.comm import comm as tcomm
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({key: value})
    if key == "topology":
        assert cfg.data_parallel_size == 2 and cfg.train_batch_size == 2
        return
    tcomm.reset_transport()
    jcomm.reset_transport()
    try:
        tcomm.configure_transport(**cfg.comm_transport)
        jcomm.configure_transport(**value)
        op = "ppermute" if "permute_width" in value else "all_to_all"
        got = tcomm.resolve_transport("activation", op, 1 << 20, "seq")
        want = jcomm.resolve_transport("activation", op, 1 << 20, "seq",
                                       axis_sizes={"seq": 2})
        assert got.width == want.width == next(iter(value.values()))
    finally:
        tcomm.reset_transport()
        jcomm.reset_transport()


@pytest.mark.parametrize("zero", [{"stage": 1, "zero_quantized_gradients": True},
                                  {"stage": 2, "zero_quantized_weights": True,
                                   "overlap_comm": False}])
def test_zeropp_stage_rules(zero):
    with pytest.raises(deepspeed_tpu_torch.DeepSpeedConfigError, match="stage"):
        deepspeed_tpu_torch.DeepSpeedConfig({"zero_optimization": zero})
    with pytest.raises(ValueError, match="stage"):
        deepspeed_tpu.initialize(model=jax_llama("llama2-tiny"), config={
            "zero_optimization": zero, "train_micro_batch_size_per_gpu": 1})
    jtopo.reset()


@pytest.mark.parametrize("batch,want", [
    ({"train_micro_batch_size_per_gpu": 4}, (16, 4, 1)),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4}, (32, 4, 2)),
    ({"train_batch_size": 32, "gradient_accumulation_steps": 2}, (32, 4, 2)),
    ({"train_batch_size": 8}, (8, 2, 1)),
    ({}, (4, 1, 1)),
])
def test_batch_resolution_with_data_parallel_size(batch, want):
    cfg = deepspeed_tpu_torch.DeepSpeedConfig(dict(batch, topology={"data": 4}))
    assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
            cfg.gradient_accumulation_steps) == want
    with pytest.raises(deepspeed_tpu_torch.DeepSpeedConfigError):
        deepspeed_tpu_torch.DeepSpeedConfig({"train_batch_size": 30,
                                             "train_micro_batch_size_per_gpu": 4,
                                             "topology": {"data": 4}})


def test_a_data_axis_larger_than_the_world_raises():
    from deepspeed_tpu_torch.models import llama_model
    with pytest.raises(ValueError, match="needs as many ranks"):
        deepspeed_tpu_torch.initialize(model=llama_model("llama2-tiny"),
                                       config={"topology": {"data": 2}}, device="cpu")


# -- the engine at world 2 against the JAX engine on a 2-device mesh -----------------

ADAMW = {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}}
ENGINES = {
    "stage1": {"stage": 1},
    "stage2": {"stage": 2},
    "stage3": {"stage": 3, "stage3_param_persistence_threshold": 1000},
    "stage3-zeropp": {"stage": 3, "stage3_param_persistence_threshold": 1000,
                      "zero_quantized_weights": True, "zero_quantized_gradients": True,
                      "overlap_comm": False},
    # qwZ alone: the gradients take the planner's default wire, here fp8
    "stage3-qwz-fp8-grads": {"stage": 3, "stage3_param_persistence_threshold": 1000,
                             "zero_quantized_weights": True, "overlap_comm": False},
}
TRANSPORT = {"stage3-qwz-fp8-grads": {"grad_width": "fp8"}}
STEPS = 3


def _config(name):
    cfg = {"train_micro_batch_size_per_gpu": B // 2, "gradient_clipping": 1.0,
           "optimizer": ADAMW, "zero_optimization": ENGINES[name]}
    if name in TRANSPORT:
        cfg["comm_transport"] = TRANSPORT[name]
    return cfg


CHILD = r"""
import sys
import numpy as np
import torch
rank, workdir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(2)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.models import llama_model
dist.init_distributed("gloo", rank=rank, world_size=2,
                      init_method="file://" + workdir + "/rendezvous", timeout=120)
spec = eval(open(workdir + "/spec.py").read())


# the first micro step's wire: each stage-3 shard and the full param
# gathered from it; each leaf's local gradient and the shard that the
# reduce-scatter returned; the shard dims
def capture_first_wire(engine, name, out):
    gather, scatter = engine._gather_params, engine._scatter_grad

    def gather_first():
        first = name + "::gathered_done" not in out
        if first:
            for k, s in engine.param_shards.items():
                out[name + "::shard::" + k] = s.numpy().copy()
                out[name + "::pdim::" + k] = np.array(engine.param_dims[k])
        gather()
        if first:
            out[name + "::gathered_done"] = np.array(1)
            for k in engine.param_shards:
                out[name + "::gathered::" + k] = engine.params[k].detach().numpy().copy()

    def scatter_first(k, g):
        res = scatter(k, g)
        if name + "::grad::" + k not in out and engine.grad_dims[k] is not None:
            out[name + "::grad::" + k] = g.numpy().copy()
            out[name + "::scattered::" + k] = res.numpy().copy()
            out[name + "::gdim::" + k] = np.array(engine.grad_dims[k])
        return res

    engine._gather_params, engine._scatter_grad = gather_first, scatter_first


inputs = dict(np.load(workdir + "/inputs.npz"))
out = {}
for name, config in spec["engines"].items():
    init = {k.split("::", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
            if k.startswith(name + "::")}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=llama_model("llama2-tiny", dtype=torch.float32), config=config,
        model_parameters=init, device="cpu")
    assert type(engine).__name__ == "DataParallelEngine"
    if name in spec["wire"]:
        capture_first_wire(engine, name, out)
    ledger = dist.CollectiveLedger()
    with dist.record_into(ledger):
        losses = [float(engine.train_batch({"input_ids": inputs["batch"]}))
                  for _ in range(spec["steps"])]
    out[name + "::losses"] = np.array(losses)
    out[name + "::eval"] = np.array(float(engine.eval_batch({"input_ids": inputs["batch"]})))
    out[name + "::narrow_gathers"] = np.array(sum(
        r["op"] == "all_gather" and r["wire_bytes"] < r["bytes"] for r in ledger.records))
    out[name + "::narrow_all_to_alls"] = np.array(sum(
        r["op"] == "all_to_all" and r["wire_bytes"] < r["bytes"] for r in ledger.records))
    out[name + "::narrow_bytes"] = np.array(sum(
        r["wire_bytes"] for r in ledger.records if r["wire_bytes"] < r["bytes"]))
    out[name + "::records"] = np.array(len(ledger.records))
    for k, v in engine.module_state_dict().items():
        out[name + "::param::" + k] = v.numpy()
    out[name + "::opt_elems"] = np.array(sum(t.numel() for t in engine.opt_state["master"].values()))
np.savez(workdir + f"/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _jax_engine(name):
    jtopo.reset()
    jcomm.reset_transport()
    model = jax_llama("llama2-tiny", dtype=jnp.float32)
    topo = MeshTopology(TopologyConfig(data=2), devices=jax.devices()[:2])
    eng, *_ = deepspeed_tpu.initialize(model=model, config=_config(name), topology=topo,
                                       seed=7)
    return eng


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The JAX engines' initial params, losses and final params, and the
    port's two ranks' results, for every ENGINES config."""
    batch = np.random.default_rng(0).integers(0, V, size=(B, S))
    inputs, jax_out = {"batch": batch}, {}
    for name in ENGINES:
        eng = _jax_engine(name)
        init = params_from_jax(jax.device_get(eng.state["params"]))
        for k, v in init.items():
            inputs[f"{name}::{k}"] = v.numpy()
        losses = [float(eng.train_batch({"input_ids": batch})) for _ in range(STEPS)]
        jax_out[name] = (losses, params_from_jax(jax.device_get(eng.state["params"])),
                         float(eng.eval_batch({"input_ids": batch})))
    jtopo.reset()
    jcomm.reset_transport()
    workdir = tmp_path_factory.mktemp("zero_world")
    np.savez(workdir / "inputs.npz", **inputs)
    (workdir / "spec.py").write_text(repr({"engines": {k: _config(k) for k in ENGINES},
                                           "steps": STEPS, "wire": ["stage3-zeropp"]}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(workdir)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the gloo world did not finish within {WORLD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return jax_out, [dict(np.load(workdir / f"out{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("name", ["stage1", "stage2", "stage3"])
def test_plain_data_parallel_matches_jax(worlds, name):
    jax_out, ranks = worlds
    want_losses, want_params, want_eval = jax_out[name]
    for r in ranks:
        np.testing.assert_allclose(r[name + "::losses"], want_losses, rtol=1e-5, atol=0)
        np.testing.assert_allclose(r[name + "::eval"], want_eval, rtol=1e-5, atol=0)
        assert int(r[name + "::narrow_gathers"]) == int(r[name + "::narrow_all_to_alls"]) == 0
        for k, v in want_params.items():
            want = v.numpy()
            d = np.abs(r[f"{name}::param::{k}"] - want)
            off = int((d > 1e-5 + 1e-5 * np.abs(want)).sum())
            assert off <= max(1, want.size // 10 ** 4), (name, k, off, d.max())
            assert d.max() <= 2 * ADAMW["params"]["lr"] * STEPS, (name, k, d.max())
    # the two ranks hold the same params; each holds half the optimizer state
    for k in want_params:
        np.testing.assert_array_equal(ranks[0][f"{name}::param::{k}"],
                                      ranks[1][f"{name}::param::{k}"])
    total = sum(v.numel() for v in want_params.values())
    assert int(ranks[0][name + "::opt_elems"]) == total // 2


def test_zeropp_int8_wire_matches_jax_within_its_tolerance(worlds):
    jax_out, ranks = worlds
    want_losses, _, _ = jax_out["stage3-zeropp"]
    for r in ranks:
        got = r["stage3-zeropp::losses"]
        np.testing.assert_allclose(got, want_losses, rtol=0.05, atol=0.05)
        assert got[-1] < got[0]
        # every stage-3 shard gathered int8, every gradient reduced int8
        assert int(r["stage3-zeropp::narrow_gathers"]) > 0
        assert int(r["stage3-zeropp::narrow_all_to_alls"]) > 0
    np.testing.assert_array_equal(ranks[0]["stage3-zeropp::losses"],
                                  ranks[1]["stage3-zeropp::losses"])
    # the int8 wire moves the training off the full-width trajectory, a little
    plain = ranks[0]["stage3::losses"]
    assert not np.array_equal(ranks[0]["stage3-zeropp::losses"], plain)
    np.testing.assert_allclose(ranks[0]["stage3-zeropp::losses"], plain, rtol=0.05, atol=0.05)


def test_qwz_alone_sends_gradients_on_the_planners_wire(worlds):
    """qwZ without qgZ: the gradients still travel narrow, on the planner's
    default grad width (fp8 here, ``comm_transport.grad_width``), as in
    the JAX barrier schedule; the losses hold the ZeRO++ tolerance."""
    jax_out, ranks = worlds
    name = "stage3-qwz-fp8-grads"
    want_losses, _, want_eval = jax_out[name]
    for r in ranks:
        np.testing.assert_allclose(r[name + "::losses"], want_losses, rtol=0.05, atol=0.05)
        np.testing.assert_allclose(r[name + "::eval"], want_eval, rtol=0.05, atol=0.05)
        assert int(r[name + "::narrow_gathers"]) > 0
        # fp8 all-to-alls carry 1 byte a value plus a 4-byte scale a group
        assert int(r[name + "::narrow_all_to_alls"]) > 0
        assert int(r[name + "::narrow_bytes"]) < int(r["stage3-zeropp::narrow_bytes"])


# -- the ZeRO++ engine's wire against the int8 rounding bound ------------------------

GROUP = 256       # the planner's default group size, which qwZ and qgZ use
SLACK = 1e-4      # relative: fp32 rounding of x / scale and of q * scale


def _half_steps(x, gs):
    """Half the int8 step of the group of every element of ``x`` (flat),
    groups of ``gs`` along it (zero-padded at the tail): absmax / 254, or
    1/2 for an all-zero group (scale 1)."""
    pad = (-x.size) % gs
    groups = np.abs(np.pad(x.astype(np.float64), (0, pad))).reshape(-1, gs)
    scale = groups.max(axis=1) / 127
    scale[scale == 0] = 1.0
    return np.repeat(scale / 2, gs)[:x.size]


def _rows(a, d, n):
    """``a`` with dim ``d`` first, cut into ``n`` flat destination chunks."""
    return np.moveaxis(a, int(d), 0).reshape(n, -1)


def test_zeropp_gradient_reduce_scatter_within_the_int8_bound(worlds):
    """Each rank's int8 reduce-scattered gradient shard of the first micro
    step against the exact mean of both ranks' local gradients (captured
    before the wire): every element within the mean of the two sources'
    half int8 steps of its group of 256, the bound of one rounding per
    source. It catches a source chunk dropped, a sum left undivided by the
    world or a group size other than 256; the loss tolerance above does not.
    The wire must also have rounded something (not a full-width path)."""
    _, ranks = worlds
    name, n = "stage3-zeropp", 2
    leaves = [k.split("::", 2)[2] for k in ranks[0] if k.startswith(name + "::grad::")]
    assert leaves
    rounded = 0
    for k in leaves:
        d = ranks[0][f"{name}::gdim::{k}"]
        local = [_rows(r[f"{name}::grad::{k}"], d, n) for r in ranks]
        gs = min(GROUP, local[0].shape[1])
        for t, r in enumerate(ranks):
            exact = (local[0][t].astype(np.float64) + local[1][t]) / n
            bound = (sum(_half_steps(g[t], gs) for g in local) / n * (1 + SLACK)
                     + 1e-6 * np.abs(exact))
            got = _rows(r[f"{name}::scattered::{k}"], d, 1)[0]
            err = np.abs(got - exact)
            assert (err <= bound).all(), (k, t, float((err / bound).max()))
            rounded += int((err > 1e-6 * np.abs(exact)).sum())
    assert rounded > 0


def test_zeropp_param_gather_within_the_int8_bound(worlds):
    """The first qwZ gather of each stage-3 leaf against the two ranks'
    shards laid side by side: both ranks gather the same bytes, and each
    source segment is within half an int8 step of its group of 256."""
    _, ranks = worlds
    name, n = "stage3-zeropp", 2
    leaves = [k.split("::", 2)[2] for k in ranks[0] if k.startswith(name + "::shard::")]
    assert leaves
    rounded = 0
    for k in leaves:
        d = ranks[0][f"{name}::pdim::{k}"]
        np.testing.assert_array_equal(ranks[0][f"{name}::gathered::{k}"],
                                      ranks[1][f"{name}::gathered::{k}"])
        got = _rows(ranks[0][f"{name}::gathered::{k}"], d, n)
        for src, r in enumerate(ranks):
            shard = _rows(r[f"{name}::shard::{k}"], d, 1)[0]
            err = np.abs(got[src].astype(np.float64) - shard)
            bound = _half_steps(shard, min(GROUP, shard.size)) * (1 + SLACK)
            assert (err <= bound).all(), (k, src, float((err / bound).max()))
            rounded += int((err > 0).sum())
    assert rounded > 0
