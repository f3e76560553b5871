"""The layer-pipelined ZeRO overlap schedule of the port
(``runtime/zero/overlap.py``, ``runtime/overlap_planner.py``,
``TransformerLM.scan_blocks_pipelined``, ``DataParallelEngine._micro_overlap``)
against the JAX package's overlap engine and against the port's own
barrier schedule.

The planners, in this process: ``plan_comm_buckets`` against JAX's on the
same sizes, keys, extents and buckets (fusion, the bucket edge, splits,
oversize, replicated leaves), and the port's block plan leaf for leaf
against the plan the JAX engine builds (through the JAX leaf names);
``plan_for`` against JAX's on the committed map, and ``overlap_plan:
false`` giving the identity plan in both.

One module-scoped gloo world of 2 (``world``: two child processes that
import only the port, a ``file://`` rendezvous in ``tmp_path``, a time limit
on the run) trains every port engine; the JAX engines run once in this
process on a 2-device CPU mesh (``jax.devices()[:2]``), llama2-tiny in fp32,
their initial parameters carried across by ``params_from_jax``, the same
global batch, AdamW with clipping 1.0, 3 steps. Each JAX engine must have
taken its overlap schedule (``_overlap_active``). Persistence threshold
1000 (JAX ``test_zero_overlap.py`` runs 0): llama2-tiny's matrices are
sharded, its norms held whole.

- plain stage 3, ``overlap_comm: true``, ``comm_transport.enabled`` false
  (the config side of JAX's ``transport_off``): losses and parameters
  within ``test_torch_zero.py``'s plain-stage tolerance of JAX's overlap
  engine (losses rtol 1e-5; parameters 1e-5 absolute plus 1e-5 relative but
  for at most one element in 10^4 of a leaf, within 2 x lr x steps);
  bitwise the port's barrier schedule, at gas 1 and gas 2; at 4 layers,
  prefetch depth 2 and ``alternating`` remat (two-layer steps) bitwise the
  depth-1 run, itself bitwise the barrier;
- the JAX default ZeRO++ config (``zero_quantized_weights``, with the
  gradients on the planner's default int8 wire) and ``{"stage": 2,
  "zero_quantized_gradients": true, "overlap_comm": true}``: losses within
  the JAX suite's ZeRO++ tolerance of JAX's overlap engine (rtol 0.05, atol
  0.05, ``tests/unit/runtime/zero/test_zeropp.py:113``); the first micro
  step's gathered block params and reduce-scattered block gradients within
  the int8 rounding bound (``test_torch_zero.py``'s: half an int8 step of
  the element's group of 256 per source, plus 1e-4 of it); each micro
  step's launches by op, bytes, wire bytes and schedule class equal to
  JAX's ``CommsLogger`` records less the two gathers the JAX scan issues
  only to keep one body shape, per block gather launch;
- ``overlap_plan: false``: the identity plan (the hand schedule: no edge
  split, every rest launch exposed), trained within the ZeRO++ tolerance;
- ``EncoderTaskModel`` under ZeRO++ falls back to the barrier schedule
  with JAX's reason, and trains there.
"""

import dataclasses
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu import comm as jdist
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.models import bert_model as jax_bert
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.models.heads import EncoderTaskModel as JaxTask
from deepspeed_tpu.runtime import overlap_planner as jplanner
from deepspeed_tpu.runtime import topology as jtopo
from deepspeed_tpu.runtime.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.zero.overlap import build_tree_comm as jax_build_tree_comm
from deepspeed_tpu.runtime.zero.partition import plan_comm_buckets as jax_plan_comm_buckets
from deepspeed_tpu.utils.comms_logging import CommsLogger
from deepspeed_tpu_torch.convert import jax_leaf, params_from_jax
from deepspeed_tpu_torch.runtime import overlap_planner as tplanner
from deepspeed_tpu_torch.runtime.zero.partition import plan_comm_buckets
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240   # seconds for the whole two-rank run, rendezvous included
V, B, S = 1024, 8, 32
STEPS = 3
LR = 3e-3
ADAMW = {"type": "adamw", "params": {"lr": LR, "weight_decay": 0.1}}
ZEROPP_TOL = dict(rtol=0.05, atol=0.05)   # test_zeropp.py:113
GROUP = 256     # the planner's group size, which qwZ and qgZ use
SLACK = 1e-4    # relative: fp32 rounding of x / scale and of q * scale
OFF = {"enabled": False}
THRESHOLD = 1000

S3 = {"stage": 3, "stage3_param_persistence_threshold": THRESHOLD}
ZEROPP = {"stage": 3, "stage3_param_persistence_threshold": THRESHOLD,
          "zero_quantized_weights": True}
S2_QGZ = {"stage": 2, "zero_quantized_gradients": True, "overlap_comm": True}


def _config(zero, transport=None, gas=1, **extra):
    cfg = {"train_micro_batch_size_per_gpu": B // 2, "gradient_accumulation_steps": gas,
           "gradient_clipping": 1.0, "optimizer": ADAMW, "zero_optimization": zero, **extra}
    if transport is not None:
        cfg["comm_transport"] = transport
    return cfg


# port engines: name -> (config, model overrides, init source, options); "jax" inits
# come from the JAX engine of that name, "seed" from the port's own seeded init
ENGINES = {
    "s3-barrier": (_config(dict(S3, overlap_comm=False), OFF), {}, "s3", {}),
    "s3-overlap": (_config(dict(S3, overlap_comm=True), OFF), {}, "s3", {}),
    "s3-barrier-gas2": (_config(dict(S3, overlap_comm=False), OFF, gas=2), {}, "s3", {}),
    "s3-overlap-gas2": (_config(dict(S3, overlap_comm=True), OFF, gas=2), {}, "s3", {}),
    "l4-barrier": (_config(dict(S3, overlap_comm=False), OFF), {"num_layers": 4}, "seed", {}),
    "l4-depth1": (_config(dict(S3, overlap_comm=True), OFF), {"num_layers": 4}, "seed", {}),
    "l4-depth2": (_config(dict(S3, overlap_comm=True), OFF), {"num_layers": 4}, "seed",
                  {"depth": 2}),
    "l4-alternating": (_config(dict(S3, overlap_comm=True), OFF),
                       {"num_layers": 4, "remat_policy": "alternating"}, "seed", {}),
    "zeropp": (_config(ZEROPP), {}, "zeropp", {"capture": True}),
    "s2-qgz": (_config(S2_QGZ), {}, "s2-qgz", {"capture": True}),
    "zeropp-plan-off": (_config(ZEROPP, overlap_plan=False), {}, "zeropp", {}),
}
JAX_ENGINES = {"s3": _config(dict(S3, overlap_comm=True), OFF), "zeropp": _config(ZEROPP),
               "s2-qgz": _config(S2_QGZ)}
ENCODER_CONFIG = dict(_config(dict(ZEROPP)), train_micro_batch_size_per_gpu=2)


CHILD = r"""
import dataclasses
import sys
import numpy as np
import torch
rank, workdir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(2)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.models import bert_model, llama_model
from deepspeed_tpu_torch.models.heads import EncoderTaskModel
from deepspeed_tpu_torch.runtime import engine as engine_mod
from deepspeed_tpu_torch.runtime.zero import overlap
dist.init_distributed("gloo", rank=rank, world_size=2,
                      init_method="file://" + workdir + "/rendezvous", timeout=120)
spec = eval(open(workdir + "/spec.py").read())
inputs = dict(np.load(workdir + "/inputs.npz"))
batch = {"input_ids": inputs["batch"]}
plan_for = engine_mod.plan_for
out = {}


def capture_first(comm, tag):
    # each launch set's first gather and scatter: inputs and results, by leaf
    gather, scatter = comm.gather, comm.scatter

    def wrap(fn, kind):
        def call(xs):
            h = fn(xs)
            if tag + "::" + kind not in out:
                out[tag + "::" + kind] = np.array(1)
                res = h.wait()
                for name, x, r in zip(comm.names, xs, res):
                    out[f"{tag}::{kind}::in::{name}"] = x.detach().numpy().copy()
                    out[f"{tag}::{kind}::out::{name}"] = r.detach().numpy().copy()
            return h
        return call
    comm.gather, comm.scatter = wrap(gather, "gather"), wrap(scatter, "scatter")


def launches(records):
    return np.array([[r["op"] == o for o in ("all_gather", "all_to_all", "reduce_scatter",
                                             "all_reduce")] + [r["bytes"], r["wire_bytes"],
                                                               int(bool(r["overlapped"]))]
                     for r in records], dtype=np.int64).reshape(-1, 7)


for name, (config, model_kw, init_from, opts) in spec["engines"].items():
    engine_mod.plan_for = plan_for
    if opts.get("depth"):
        engine_mod.plan_for = lambda entry, config_flag=None: dataclasses.replace(
            plan_for(entry, config_flag), prefetch_depth=opts["depth"])
    init = None
    if init_from != "seed":
        init = {k.split("::", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
                if k.startswith(init_from + "::")}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=llama_model("llama2-tiny", dtype=torch.float32, **model_kw), config=config,
        model_parameters=init, device="cpu", seed=3)
    assert type(engine).__name__ == "DataParallelEngine"
    out[name + "::active"] = np.array(engine._overlap_active)
    if engine._sched is not None:
        s = engine._sched
        out[name + "::plan"] = np.array([s.depth, s.lps, int(s.split),
                                         int(s.plan.defer_replicated)])
        out[name + "::rest_overlapped"] = np.array([int(c.overlapped) for c in s.rest_comms])
        # the bytes each block gather launch records (a fused buffer pads its
        # leaves on a quantized wire)
        out[name + "::blk_gather_bytes"] = np.array(
            [4 * sum(overlap._pad_rows(int(np.prod(s.blk_comm.gcomms[i].shape)) // 2,
                                       tp.quantized and len(e.leaves) > 1) for i in e.leaves)
             if s.blk_comm.gcomms[e.leaves[0]].dim is not None else -1
             for e, tp in zip(s.blk_comm.gather_plan, s.blk_comm.gather_tp)])
        out[name + "::blk_names"] = np.array(s.blk_names)
        out[name + "::blk_gather_plan"] = np.array(
            [",".join(map(str, e.leaves)) + f"x{e.chunks}" for e in s.blk_comm.gather_plan])
        out[name + "::blk_scatter_plan"] = np.array(
            [",".join(map(str, e.leaves)) + f"x{e.chunks}" for e in s.blk_comm.scatter_plan])
        out[name + "::blk_widths"] = np.array(
            [tp.width for tp in s.blk_comm.gather_tp + s.blk_comm.scatter_tp])
        if opts.get("capture"):
            capture_first(s.blk_comm, name)
    losses = [float(engine.train_batch(batch)) for _ in range(spec["steps"])]
    out[name + "::losses"] = np.array(losses)
    for k, v in engine.module_state_dict().items():
        out[name + "::param::" + k] = v.numpy()
    ledger = dist.CollectiveLedger()
    with dist.record_into(ledger):
        engine.forward(batch)
    out[name + "::launches"] = launches(ledger.records)
    del engine

# a task head has none of the schedule's hooks: the barrier schedule, and why
rng = np.random.default_rng(1)
model = EncoderTaskModel(bert_model("bert-tiny", dtype=torch.float32),
                         "sequence_classification", num_labels=3)
engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=spec["encoder_config"],
                                            device="cpu", seed=3)
out["encoder::active"] = np.array(engine._overlap_active)
out["encoder::reason"] = np.array(engine._overlap_fallback)
out["encoder::loss"] = np.array(float(engine.train_batch(
    {"input_ids": rng.integers(0, 256, size=(4, 16)), "labels": rng.integers(0, 3, size=4)})))
np.savez(workdir + f"/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _jax_engine(config, model=None):
    jtopo.reset()
    jcomm.reset_transport()
    topo = MeshTopology(TopologyConfig(data=2), devices=jax.devices()[:2])
    eng, *_ = deepspeed_tpu.initialize(model=model or jax_llama("llama2-tiny", dtype=jnp.float32),
                                       config=config, topology=topo, seed=7)
    return eng


def _jax_block_comm(eng):
    """The block launch sets the JAX engine builds (``_build_zeropp_micro_overlap``:
    one layer's bundle of the stacked specs and leaves)."""
    zc, all_dp, n_dp, _, grad_specs, src_specs = eng._zeropp_micro_env()
    is_p = lambda s: isinstance(s, P)
    spec = lambda tree: jax.tree.map(lambda s: P(*((None,) + tuple(s)[1:])), tree, is_leaf=is_p)
    struct = jax.tree.map(lambda l: jax.ShapeDtypeStruct((1,) + tuple(l.shape)[1:], l.dtype),
                          eng._param_struct["blocks"])
    return jax_build_tree_comm(
        spec(src_specs["blocks"]), spec(grad_specs["blocks"]), struct,
        axis_sizes=dict(eng.topology.mesh.shape), all_dp=all_dp, n_dp=n_dp,
        quant_weights=zc.zero_quantized_weights, quant_grads=zc.zero_quantized_gradients,
        allgather_bucket=zc.allgather_bucket_size, reduce_bucket=zc.reduce_bucket_size,
        overlapped=True, name="blocks", defer_replicated=True)


def _jax_counts(logger):
    """The JAX micro step's records: ``(op, bytes, wire, overlapped) -> launches``."""
    return Counter({(op, size, wire, int(bool(ov))): c
                    for op, entries in logger.comms_dict.items()
                    for (size, wire, _axes, ov), c in entries.items()})


def _port_counts(rows):
    ops = ("all_gather", "all_to_all", "reduce_scatter", "all_reduce")
    return Counter((ops[int(np.argmax(r[:4]))], int(r[4]), int(r[5]), int(r[6])) for r in rows)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    batch = np.random.default_rng(0).integers(0, V, size=(B, S))
    inputs, jax_out = {"batch": batch}, {}
    off = CommsLogger(config=type("C", (), {"enabled": False, "verbose": False,
                                            "prof_ops": []})())
    try:
        for name, config in JAX_ENGINES.items():
            eng = _jax_engine(config)
            for k, v in params_from_jax(jax.device_get(eng.state["params"])).items():
                inputs[f"{name}::{k}"] = v.numpy()
            logger = CommsLogger()
            jdist.configure(comms_logger=logger)
            losses = [float(eng.train_batch({"input_ids": batch})) for _ in range(STEPS)]
            jdist.configure(comms_logger=off)
            assert eng._overlap_active, (name, eng._overlap_fallback)
            jax_out[name] = dict(losses=losses, counts=_jax_counts(logger),
                                 params=params_from_jax(jax.device_get(eng.state["params"])),
                                 blk_comm=_jax_block_comm(eng))
        task = JaxTask(jax_bert("bert-tiny", dtype=jnp.float32), "sequence_classification",
                       num_labels=3)
        eng = _jax_engine(ENCODER_CONFIG, model=task)
        jax_out["encoder_reason"] = eng._zero_overlap_eligibility(
            eng.zero_plan.grad_spec_tree())
    finally:
        jdist.configure(comms_logger=off)
        jtopo.reset()
        jcomm.reset_transport()
    workdir = tmp_path_factory.mktemp("zero_overlap_world")
    np.savez(workdir / "inputs.npz", **inputs)
    (workdir / "spec.py").write_text(repr({"engines": ENGINES, "steps": STEPS,
                                           "encoder_config": ENCODER_CONFIG}))
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


def _params(r, name):
    pre = name + "::param::"
    return {k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}


# -- the planners ----------------------------------------------------------------------

PLAN_CASES = {
    "fuse": ([10, 20, 30, 40], ["a"] * 4, [5, 10, 15, 20], 64),
    "bucket-edge": ([32, 32, 1, 31], ["a"] * 4, [16, 16, 1, 31], 64),
    "keys-apart": ([10, 10, 10, 10], ["a", "b", "a", "b"], [5, 5, 5, 5], 25),
    "split": ([100, 10, 256], ["a"] * 3, [50, 5, 128], 64),
    "oversize": ([100, 10], ["a"] * 2, [7, 5], 16),
    "replicated": ([10, 20, 30], ["a"] * 3, [5, None, 15], 64),
    "bucket-0": ([10, 20], ["a"] * 2, [5, 10], 0),
    "max-chunks": ([4096], ["a"], [1024], 100),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_comm_buckets_matches_jax(case):
    sizes, keys, extents, bucket = PLAN_CASES[case]
    got_entries, got_over = plan_comm_buckets(sizes, keys, extents, bucket)
    want_entries, want_over = jax_plan_comm_buckets(sizes, keys, extents, bucket)
    assert [(e.leaves, e.chunks) for e in got_entries] == \
        [(e.leaves, e.chunks) for e in want_entries]
    assert got_over == want_over


@pytest.mark.parametrize("flag", [None, True, False])
def test_plan_for_matches_jax(flag):
    """The committed ``zeropp-micro-overlap`` map gives the same plan in
    both packages; ``overlap_plan: false`` the identity plan in both."""
    jplanner.reset_plans()
    try:
        want = jplanner.plan_for(tplanner.ZEROPP_ENTRY, config_flag=flag)
    finally:
        jplanner.reset_plans()
    got = tplanner.plan_for(tplanner.ZEROPP_ENTRY, config_flag=flag)
    assert dataclasses.asdict(got) == {**dataclasses.asdict(want), "notes": tuple(want.notes)}
    assert got.summary() == want.summary()
    if flag is False:
        assert got.placement == tplanner.PLACEMENT_INLINE and not got.split_edge_leaves
    else:
        assert got.source == "map" and got.prefetch_depth == 1 and got.split_edge_leaves


def test_plan_without_a_map_is_jax_default(tmp_path):
    got = tplanner.plan_for(tplanner.ZEROPP_ENTRY, maps_dir=str(tmp_path))
    want = jplanner.plan_entry(tplanner.ZEROPP_ENTRY, maps_dir=str(tmp_path))
    assert got.summary() == want.summary() and got.source == want.source == "default"


@pytest.mark.parametrize("name,ref", [("zeropp", "zeropp"), ("s2-qgz", "s2-qgz"),
                                      ("s3-overlap", "s3")])
def test_block_plan_matches_the_jax_engine(world, name, ref):
    """The port's block launch plan against the one the JAX engine builds,
    leaf for leaf through the JAX names (``blocks/<layer>/<leaf>``, the JAX
    tree's sorted order): the fused and the lone leaves of every gather and
    reduction, their chunks and wire widths."""
    jax_out, ranks = world
    jc = jax_out[ref]["blk_comm"]
    r = ranks[0]
    names = [jax_leaf("blocks.0." + str(n), 2 if "proj" in str(n) else 1).path
             for n in r[name + "::blk_names"]]
    assert names == ["blocks/" + n for n in jc.names]
    plan = lambda entries: [",".join(map(str, e.leaves)) + f"x{e.chunks}" for e in entries]
    assert [str(e) for e in r[name + "::blk_gather_plan"]] == plan(jc.gather_plan)
    assert [str(e) for e in r[name + "::blk_scatter_plan"]] == plan(jc.scatter_plan)
    assert [str(w) for w in r[name + "::blk_widths"]] == \
        [tp.width for tp in jc.gather_tp + jc.scatter_tp]


# -- plain stage 3 on the schedule: JAX's overlap engine and the barrier, bitwise ----------


def test_plain_stage3_overlap_matches_jax(world):
    jax_out, ranks = world
    want = jax_out["s3"]
    for r in ranks:
        assert bool(r["s3-overlap::active"]) and not bool(r["s3-barrier::active"])
        np.testing.assert_allclose(r["s3-overlap::losses"], want["losses"], rtol=1e-5, atol=0)
        for k, v in want["params"].items():
            w = v.numpy()
            d = np.abs(r["s3-overlap::param::" + k] - w)
            off = int((d > 1e-5 + 1e-5 * np.abs(w)).sum())
            assert off <= max(1, w.size // 10 ** 4), (k, off, d.max())
            assert d.max() <= 2 * LR * STEPS, (k, d.max())


@pytest.mark.parametrize("schedule,reference", [
    ("s3-overlap", "s3-barrier"), ("s3-overlap-gas2", "s3-barrier-gas2"),
    ("l4-depth1", "l4-barrier"), ("l4-depth2", "l4-depth1"), ("l4-alternating", "l4-depth1")])
def test_overlap_schedule_is_bitwise(world, schedule, reference):
    """Full width, the schedule moves no value: losses and final params bit
    for bit those of the reference run, on both ranks."""
    _, ranks = world
    for r in ranks:
        assert bool(r[schedule + "::active"])
        np.testing.assert_array_equal(r[schedule + "::losses"], r[reference + "::losses"])
        got, want = _params(r, schedule), _params(r, reference)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    plans = {"l4-depth2": (2, 1), "l4-alternating": (1, 2), "l4-depth1": (1, 1)}
    if schedule in plans:
        assert tuple(ranks[0][schedule + "::plan"][:2]) == plans[schedule]


# -- ZeRO++ on the schedule ------------------------------------------------------------


@pytest.mark.parametrize("name", ["zeropp", "s2-qgz"])
def test_zeropp_overlap_matches_jax(world, name):
    jax_out, ranks = world
    for r in ranks:
        assert bool(r[name + "::active"])
        got = r[name + "::losses"]
        np.testing.assert_allclose(got, jax_out[name]["losses"], **ZEROPP_TOL)
        assert got[-1] < got[0]
    np.testing.assert_array_equal(ranks[0][name + "::losses"], ranks[1][name + "::losses"])


@pytest.mark.parametrize("name", ["zeropp", "s2-qgz", "s3-overlap"])
def test_launches_match_jax_less_its_redundant_gathers(world, name):
    """Each micro step's launches by op, logical bytes, wire bytes and
    class against JAX's records of its micro step: the same, but the JAX
    scan's forward last slot and backward slot 0, two overlapped gathers a
    block gather launch (the JAX overlap micro step takes 1 exposed and 4
    overlapped gathers of the fused block bucket here; the port 1 and 2)."""
    jax_out, ranks = world
    ref = "s3" if name == "s3-overlap" else name
    want = Counter(jax_out[ref]["counts"])
    for r in ranks:
        for b in r[name + "::blk_gather_bytes"]:
            if b < 0:
                continue
            keys = [k for k in want if k[0] == "all_gather" and k[1] == b and k[3] == 1]
            assert len(keys) == 1, (b, want)
            want[keys[0]] -= 2
        got = _port_counts(r[name + "::launches"])
        assert got == +want, (got, want)
        break
    np.testing.assert_array_equal(ranks[0][name + "::launches"], ranks[1][name + "::launches"])


def _half_steps(x, gs):
    """Half the int8 step of the group of every element of flat ``x``
    (groups of ``gs``, zero-padded tail): absmax / 254, or 1/2 for an
    all-zero group (scale 1)."""
    pad = (-x.size) % gs
    groups = np.abs(np.pad(x.astype(np.float64), (0, pad))).reshape(-1, gs)
    scale = groups.max(axis=1) / 127
    scale[scale == 0] = 1.0
    return np.repeat(scale / 2, gs)[:x.size]


def _rows(a, d, n):
    return np.moveaxis(a, int(d), 0).reshape(n, -1)


def _dims(r, name, kind):
    """The shard dim of each captured block leaf (in the step's ``[1,
    *leaf]`` view), from the captured shapes: the dim whose extent
    changed."""
    out = {}
    for k in r:
        if k.startswith(f"{name}::{kind}::in::"):
            leaf = k.split("::")[-1]
            a, b = r[k].shape, r[f"{name}::{kind}::out::{leaf}"].shape
            diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            out[leaf] = diff[0] if diff else None
    return out


@pytest.mark.parametrize("name", ["zeropp", "s2-qgz"])
def test_overlap_gradient_reduce_scatter_within_the_int8_bound(world, name):
    """The first block reduction of the ZeRO++ schedule (the last layer's
    fused int8 bucket) against the exact mean of both ranks' local
    gradients: every element within the mean of the two sources' half int8
    steps of its group of 256. The fused buffer pads each leaf to a group
    multiple, so a leaf's groups are those of its own destination rows."""
    _, ranks = world
    n, rounded = 2, 0
    dims = _dims(ranks[0], name, "scatter")
    assert dims and all(d is not None for d in dims.values())
    for k, d in dims.items():
        local = [_rows(r[f"{name}::scatter::in::{k}"], d, n) for r in ranks]
        gs = min(GROUP, local[0].shape[1])
        for t, r in enumerate(ranks):
            exact = (local[0][t].astype(np.float64) + local[1][t]) / n
            bound = (sum(_half_steps(g[t], gs) for g in local) / n * (1 + SLACK)
                     + 1e-6 * np.abs(exact))
            got = _rows(r[f"{name}::scatter::out::{k}"], d, 1)[0]
            err = np.abs(got - exact)
            assert (err <= bound).all(), (k, t, float((err / bound).max()))
            rounded += int((err > 1e-6 * np.abs(exact)).sum())
    assert rounded > 0


def test_overlap_param_gather_within_the_int8_bound(world):
    """The first block gather (layer 0's fused qwZ bucket) against the two
    ranks' shards: both ranks gather the same bytes, each source segment
    within half an int8 step of its group of 256."""
    _, ranks = world
    n, rounded = 2, 0
    dims = {k: d for k, d in _dims(ranks[0], "zeropp", "gather").items() if d is not None}
    assert len(dims) == 7
    for k, d in dims.items():
        np.testing.assert_array_equal(ranks[0][f"zeropp::gather::out::{k}"],
                                      ranks[1][f"zeropp::gather::out::{k}"])
        got = _rows(ranks[0][f"zeropp::gather::out::{k}"], d, n)
        for src, r in enumerate(ranks):
            shard = _rows(r[f"zeropp::gather::in::{k}"], d, 1)[0]
            err = np.abs(got[src].astype(np.float64) - shard)
            bound = _half_steps(shard, min(GROUP, shard.size)) * (1 + SLACK)
            assert (err <= bound).all(), (k, src, float((err / bound).max()))
            rounded += int((err > 0).sum())
    assert rounded > 0


def test_overlap_plan_false_is_the_hand_schedule(world):
    """``overlap_plan: false``: depth 1, no edge split (the rest leaves one
    exposed launch set), no deferred flush; trained within the ZeRO++
    tolerance of the planned run."""
    _, ranks = world
    for r in ranks:
        assert bool(r["zeropp-plan-off::active"])
        assert list(r["zeropp-plan-off::plan"]) == [1, 1, 0, 0]
        assert list(r["zeropp-plan-off::rest_overlapped"]) == [0]
        assert list(r["zeropp::plan"]) == [1, 1, 1, 1]
        assert list(r["zeropp::rest_overlapped"]) == [0, 1]
        np.testing.assert_allclose(r["zeropp-plan-off::losses"], r["zeropp::losses"],
                                   **ZEROPP_TOL)


def test_encoder_task_model_falls_back_with_jax_reason(world):
    jax_out, ranks = world
    want = jax_out["encoder_reason"]
    assert want == "model EncoderTaskModel lacks .embed (TransformerLM family required)"
    for r in ranks:
        assert not bool(r["encoder::active"])
        assert str(r["encoder::reason"]) == want
        assert np.isfinite(float(r["encoder::loss"]))
