"""Sequence parallelism of the port (``deepspeed_tpu_torch/sequence``,
``runtime/topology.py``'s ``seq`` axis, the engine's sequence split) on a
gloo world of 2 on the CPU, against the JAX package on a 2-device mesh at
``seq=2`` (``MeshTopology(TopologyConfig(seq=2, data=1), devices=
jax.devices()[:2])``, data 1 on both sides) and against the port's own
single-rank run.

One module-scoped world (``world``) runs every port case in two child
processes that import only the port (a ``file://`` rendezvous in
``tmp_path``, a time limit on the run); the JAX references and the port's
single-rank runs are computed once in this process. The cases:

- ``ulysses_attention`` and ``ring_attention``: outputs and the gradients of
  q, k and v through one cotangent, causal and not, GQA, at full width
  (``comm_transport.enabled`` false on the port, ``DSTPU_COMM_QUANT=0`` on
  the JAX side) within the JAX suite's ring tolerance (2e-5, its
  ``test_ring_matches_dense``); Ulysses bitwise the port's single-process
  flash over the whole sequence (a layout change, heads never mix);
- the default int8 hops against dense attention, within the tolerance of
  JAX's ``TestQuantizedHops`` (``rtol`` 0.1, ``atol`` 5e-2 of the largest
  value; 0.2 for gradients);
- the port's ring (its flash body, plain flash on the CPU) against JAX's
  ``_ring_local_flash`` (``DSTPU_ATTN=pallas``, the Pallas kernel in
  interpret mode) and against ``ring_local_reference`` below, JAX's XLA body
  ``_ring_local`` written in torch;
- ``quantized_ppermute``: the wire's int8 payload and scales bitwise those
  of the jitted JAX quantizer, the arrivals bitwise the JAX hop's;
- llama2-tiny trained 3 steps at ``seq_parallel`` ulysses and ring, fp32,
  full width: losses and final params against the JAX engine at ``seq=2``
  (the ZeRO engine test's tolerance, ``test_torch_zero.py``) and against the
  port's single-rank run; the default wires (bf16 all-to-all, int8 hops)
  within 5e-3 of that run's losses;
- a tiny BLOOM (ALiBi) with a padding mask (segment ids) through Ulysses, a
  llama whose one kv head does not divide by sp (Ulysses' gather form), and
  a tiny RoBERTa MLM on padded rows (bidirectional; its pad-based positions
  count the real tokens of the earlier slice) against the single-rank run;
- the label shift across the shard boundary and the global token mean with
  shards of unequal label counts (a ``loss_mask``);
- the collective records (bf16 all-to-alls, int8 hops), the tag of a
  seq-sharded engine loading into one device, batch resolution at seq 2, the
  JAX validation errors, the topology's coordinates and groups.
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
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.ops.quantizer import quantizer as jquant
from deepspeed_tpu.ops.transformer.attention import _xla_attention
from deepspeed_tpu.ops.transformer.attention import flash_attention as jflash_attention
from deepspeed_tpu.runtime import topology as jtopo
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.sequence.layer import DistributedAttention as JaxDistributedAttention
from deepspeed_tpu.sequence.layer import ulysses_attention as jax_ulysses
from deepspeed_tpu.sequence.ring_attention import ring_attention as jax_ring
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.ops.quantizer import quantizer as tquant
from deepspeed_tpu_torch.runtime.topology import MeshTopology as TorchTopology
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240   # seconds for the whole two-rank run, rendezvous included
SP = 2
RING_TOL = dict(rtol=2e-5, atol=2e-5)        # test_ring_attention.py: ring vs dense
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)        # its gradients
ATTN = {"causal": dict(causal=True, kvH=4), "noncausal": dict(causal=False, kvH=4),
        "gqa": dict(causal=True, kvH=2)}
B, S, H, D = 2, 32, 4, 16
V = 256
STEPS = 3
LR = 3e-3
ADAMW = {"type": "adamw", "params": {"lr": LR, "weight_decay": 0.1}}


def _attn_inputs(kvH, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(q=f(B, S, H, D), k=f(B, S, kvH, D), v=f(B, S, kvH, D), do=f(B, S, H, D))


def _config(form_wire, stage=1):
    cfg = {"train_micro_batch_size_per_gpu": 1, "gradient_clipping": 1.0,
           "optimizer": ADAMW, "zero_optimization": {"stage": stage}}
    if form_wire == "full":
        cfg["comm_transport"] = {"enabled": False}
    return cfg


# engine runs of the world: name -> (model kind, seq_parallel, wire, extra batch keys)
ENGINES = {
    "ulysses-full": ("llama", "ulysses", "full"),
    "ring-full": ("llama", "ring", "full"),
    "ulysses-default": ("llama", "ulysses", "default"),
    "ring-default": ("llama", "ring", "default"),
    "bloom-alibi-mask": ("bloom", "ulysses", "full"),
    "llama-kv1": ("llama-kv1", "ulysses", "full"),
    "loss-mask": ("llama", "ulysses", "full"),
    "roberta-mlm": ("roberta", "ulysses", "full"),
}


# the port models of the engine runs; the child processes run this source too
MODEL_SRC = """
def _port_model(kind, form):
    import torch
    from deepspeed_tpu_torch.models import bloom_model, llama_model, roberta_model
    if kind == "bloom":
        return bloom_model("bloom-tiny", dtype=torch.float32, seq_parallel=form)
    if kind == "roberta":
        return roberta_model("bert-tiny", dtype=torch.float32, vocab_size=256,
                             seq_parallel=form)
    kw = dict(num_kv_heads=1) if kind == "llama-kv1" else {}
    return llama_model("llama2-tiny", dtype=torch.float32, max_seq_len=64, vocab_size=256,
                       seq_parallel=form, **kw)
"""
exec(MODEL_SRC)


def _batches():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, size=(B, S))
    mask = np.ones((B, S), np.int64)
    mask[0, 20:] = 0                    # a padded tail: pads attend among pads
    loss_mask = np.ones((B, S), np.float32)
    loss_mask[:, :10] = 0.0             # rank 0's slice holds fewer labels than rank 1's
    # an MLM batch: RoBERTa's pads (id 1) at a row's tail, labels on a few
    # real positions
    mlm_ids = np.where(mask == 1, np.maximum(ids, 2), 1)
    mlm_labels = np.where((rng.random((B, S)) < 0.3) & (mask == 1), mlm_ids, -100)
    return {"plain": {"input_ids": ids},
            "mask": {"input_ids": ids, "attention_mask": mask},
            "loss_mask": {"input_ids": ids, "loss_mask": loss_mask},
            "mlm": {"input_ids": mlm_ids, "attention_mask": mask, "labels": mlm_labels}}


def _batch_of(name):
    return {"bloom-alibi-mask": "mask", "loss-mask": "loss_mask",
            "roberta-mlm": "mlm"}.get(name, "plain")


CHILD = MODEL_SRC + r"""
import sys
import numpy as np
import torch
rank, workdir = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.ops.quantizer.quantizer import quantized_ppermute
from deepspeed_tpu_torch.ops.transformer.attention import flash_attention
from deepspeed_tpu_torch.runtime import topology as topo
from deepspeed_tpu_torch.sequence import DistributedAttention, ring_attention, ulysses_attention
spec = eval(open(workdir + "/spec.py").read())
dist.init_distributed("gloo", rank=rank, world_size=2,
                      init_method="file://" + workdir + "/rendezvous", timeout=120)
inputs = dict(np.load(workdir + "/inputs.npz"))
out = {}
S = inputs["batch::plain::input_ids"].shape[1]
sl = slice(rank * S // 2, (rank + 1) * S // 2)

# -- the functions, on a published seq axis of 2
topo.set_topology(topo.MeshTopology({"seq": 2}))
for wire in ("full", "default"):
    dist.reset_transport()
    if wire == "full":
        dist.configure_transport(enabled=False)
    for case, causal in spec["attn"].items():
        for form, fn in (("ulysses", lambda q, k, v: ulysses_attention(
                flash_attention, q, k, v, causal=causal)),
                         ("ring", lambda q, k, v: ring_attention(q, k, v, causal=causal))):
            if form == "ulysses" and not causal and wire == "default":
                continue
            q, k, v = (torch.from_numpy(inputs[case + "::" + n][:, sl]).requires_grad_(True)
                       for n in "qkv")
            o = fn(q, k, v)
            o.backward(torch.from_numpy(inputs[case + "::do"][:, sl]))
            tag = f"{form}::{wire}::{case}"
            for n, t in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
                out[f"{tag}::{n}"] = t.detach().numpy()
dist.reset_transport()
# the explicit wrapper, on the seq axis named and on the seq group passed
seq_group = dist.new_group([0, 1])
for case, causal in spec["attn"].items():
    for how, group in (("axis", "seq"), ("group", seq_group)):
        da = DistributedAttention(lambda q, k, v: flash_attention(q, k, v, causal=causal),
                                  group)
        q, k, v = (torch.from_numpy(inputs[case + "::" + n][:, sl]).requires_grad_(True)
                   for n in "qkv")
        ledger = dist.CollectiveLedger()
        with dist.record_into(ledger):
            o = da(q, k, v)
            o.backward(torch.from_numpy(inputs[case + "::do"][:, sl]))
        tag = f"distributed::{how}::{case}"
        for n, t in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            out[f"{tag}::{n}"] = t.detach().numpy()
        out[tag + "::records"] = np.array([[r["bytes"], r["wire_bytes"]] for r in ledger.records
                                           if r["op"] == "all_to_all" and r["axes"] == ("seq",)
                                           ]).reshape(-1, 2)
hop = quantized_ppermute(torch.from_numpy(inputs["hop"][rank]), [(0, 1), (1, 0)])
out["hop"] = hop.numpy()
topo.reset()

# -- engines
for name, (kind, form, config, batch_name) in spec["engines"].items():
    init = {k.split("::", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
            if k.startswith("init-" + kind + "::")}
    engine, *_ = deepspeed_tpu_torch.initialize(model=_port_model(kind, form), config=config,
                                                model_parameters=init, device="cpu")
    assert type(engine).__name__ == "DataParallelEngine" and engine.sp == 2
    batch = {k.split("::")[2]: v for k, v in inputs.items()
             if k.startswith("batch::" + batch_name + "::")}
    ledger = dist.CollectiveLedger()
    with dist.record_into(ledger):
        losses = [float(engine.train_batch(batch)) for _ in range(spec["steps"])]
    out[name + "::losses"] = np.array(losses)
    out[name + "::eval"] = np.array(float(engine.eval_batch(batch)))
    for op in ("all_to_all", "ppermute"):
        recs = [r for r in ledger.records if r["op"] == op]
        out[f"{name}::{op}::n"] = np.array(sum(r["count"] for r in recs))
        out[f"{name}::{op}::narrow"] = np.array(sum(
            r["count"] for r in recs if r["wire_bytes"] < r["bytes"]))
    if name == "loss-mask":
        local = engine._prepare_batch(batch)
        out["labels"] = local["labels"].numpy()
        out["denominator"] = np.array(engine._denominator)
    for k, v in engine.module_state_dict().items():
        out[name + "::param::" + k] = v.numpy()
    if name == "ulysses-full":
        engine.save_checkpoint(workdir + "/ckpt")
dist.barrier()
dist.destroy_process_group()

# -- a world of one in the same process, after the seq engines
out["topology-after-destroy"] = np.array(topo.get_topology() is not None)
name = "ulysses-full"
kind, form, config, batch_name = spec["engines"][name]
config = {k: v for k, v in config.items() if k != "topology"}
init = {k.split("::", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
        if k.startswith("init-" + kind + "::")}
engine, *_ = deepspeed_tpu_torch.initialize(model=_port_model(kind, form), config=config,
                                            model_parameters=init, device="cpu")
batch = {k.split("::")[2]: v for k, v in inputs.items()
         if k.startswith("batch::" + batch_name + "::")}
out["after::losses"] = np.array([float(engine.train_batch(batch))
                                 for _ in range(spec["steps"])])
np.savez(workdir + f"/out{rank}.npz", **out)
"""


# -- the JAX side ---------------------------------------------------------------------


def _jax_topology():
    jtopo.reset()
    topo = MeshTopology(TopologyConfig(seq=SP, data=1), devices=jax.devices()[:SP])
    jtopo.set_topology(topo)
    return topo


def _jax_attention(fn, x, causal, env):
    """(out, dq, dk, dv) of ``fn`` on the seq mesh under ``env``."""
    topo = _jax_topology()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        if not hasattr(pltpu, "TPUCompilerParams"):
            # the Pallas flash names pltpu.TPUCompilerParams, which newer JAX
            # releases call CompilerParams (restored as the context closes)
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        jcomm.reset_transport()

        def run(q, k, v, do):
            o, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal), q, k, v)
            return (o,) + vjp(do)

        with topo.mesh:
            res = jax.jit(run)(*(jnp.asarray(x[n]) for n in ("q", "k", "v", "do")))
    jtopo.reset()
    return [np.asarray(r) for r in res]


def _jax_distributed(q, k, v, causal):
    """JAX's ``DistributedAttention`` over plain XLA attention, under
    ``shard_map`` on the published seq mesh."""
    da = JaxDistributedAttention(lambda q, k, v: _xla_attention(q, k, v, causal=causal,
                                                                scale=None, segment_ids=None))
    spec = P(None, "seq")
    return shard_map(da, mesh=jtopo.get_topology().mesh, in_specs=(spec,) * 3,
                     out_specs=spec, check_vma=False)(q, k, v)


def _dense(x, causal):
    def run(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: _xla_attention(q, k, v, causal=causal, scale=None,
                                                        segment_ids=None), q, k, v)
        return (o,) + vjp(do)
    return [np.asarray(r) for r in jax.jit(run)(*(jnp.asarray(x[n]) for n in
                                                  ("q", "k", "v", "do")))]


def _jax_engine(kind, form, config, seed=7):
    jtopo.reset()
    jcomm.reset_transport()
    kw = dict(num_kv_heads=1) if kind == "llama-kv1" else {}
    model = jax_llama("llama2-tiny", dtype=jnp.float32, max_seq_len=64, vocab_size=V,
                      seq_parallel=form, **kw)
    topo = MeshTopology(TopologyConfig(seq=SP, data=1), devices=jax.devices()[:SP])
    eng, *_ = deepspeed_tpu.initialize(model=model, config=config, topology=topo, seed=seed)
    return eng


def _port_single(name, init):
    """The port's single-rank run of an ENGINES entry: losses, eval, params."""
    kind, form, wire = ENGINES[name]
    eng, *_ = deepspeed_tpu_torch.initialize(model=_port_model(kind, form),
                                             config=_config(wire), model_parameters=init,
                                             device="cpu")
    batch = _batches()[_batch_of(name)]
    losses = [float(eng.train_batch(batch)) for _ in range(STEPS)]
    return losses, float(eng.eval_batch(batch)), eng.module_state_dict()


def _run_world(workdir, inputs):
    """Start the two ranks on ``inputs``; returns the processes."""
    for bname, b in _batches().items():
        inputs.update({f"batch::{bname}::{k}": v for k, v in b.items()})
    np.savez(workdir / "inputs.npz", **inputs)
    (workdir / "spec.py").write_text(repr({
        "attn": {case: c["causal"] for case, c in ATTN.items()}, "steps": STEPS,
        "engines": {name: (kind, form, dict(_config(wire), topology={"seq": SP}),
                           _batch_of(name)) for name, (kind, form, wire) in ENGINES.items()}}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(workdir)], cwd=ROOT,
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(SP)]


def _join_world(procs, workdir):
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
    return [dict(np.load(workdir / f"out{r}.npz")) for r in range(SP)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's two ranks' results for every case, and the references.
    The ranks start once their inputs exist (the JAX engine's initial
    params among them) and run while this process computes the rest."""
    inputs, ref = {}, {}
    batch = _batches()["plain"]
    engines = {}
    for form in ("ulysses", "ring"):
        engines[form] = _jax_engine("llama", form, _config("full"))
        init = params_from_jax(jax.device_get(engines[form].state["params"]))
        if form == "ulysses":
            inputs.update({f"init-llama::{k}": v.numpy() for k, v in init.items()})
    for kind in ("bloom", "llama-kv1", "roberta"):
        m = _port_model(kind, "ulysses").materialize("cpu", seed=4)
        inputs.update({f"init-{kind}::{k}": v.detach().numpy() for k, v in m.state_dict().items()})
    for i, (case, c) in enumerate(ATTN.items()):
        inputs.update({f"{case}::{n}": a for n, a in _attn_inputs(c["kvH"], seed=i).items()})
    hop = np.random.default_rng(5).normal(size=(SP, 7, 45)).astype(np.float32)
    inputs["hop"] = hop
    workdir = tmp_path_factory.mktemp("seq_world")
    procs = _run_world(workdir, dict(inputs))
    try:
        # the JAX engines at seq 2, full width
        for form, eng in engines.items():
            init = params_from_jax(jax.device_get(eng.state["params"]))
            losses = [float(eng.train_batch(batch)) for _ in range(STEPS)]
            ref["jax", form] = (init, losses,
                                params_from_jax(jax.device_get(eng.state["params"])))
        del engines
        jtopo.reset()
        jcomm.reset_transport()
        full_width = {"DSTPU_COMM_QUANT": "0"}
        for i, (case, c) in enumerate(ATTN.items()):
            x = _attn_inputs(c["kvH"], seed=i)
            ref[case, "ulysses"] = _jax_attention(
                lambda q, k, v, causal: jax_ulysses(jflash_attention, q, k, v, causal=causal),
                x, c["causal"], full_width)
            ring = lambda q, k, v, causal: jax_ring(q, k, v, causal=causal)
            ref[case, "ring"] = _jax_attention(ring, x, c["causal"], full_width)
            ref[case, "ring-int8"] = _jax_attention(ring, x, c["causal"], {})
            ref[case, "ring-pallas"] = _jax_attention(ring, x, c["causal"],
                                                      dict(full_width, DSTPU_ATTN="pallas"))
            ref[case, "dense"] = _dense(x, c["causal"])
            ref[case, "distributed"] = _jax_attention(_jax_distributed, x, c["causal"], {})
        topo = _jax_topology()
        hop_fn = shard_map(lambda t: jquant.quantized_ppermute(t[0], [(0, 1), (1, 0)],
                                                               "seq")[None],
                           mesh=topo.mesh, in_specs=P("seq"), out_specs=P("seq"),
                           check_vma=False)
        ref["hop"] = np.asarray(jax.jit(hop_fn)(jnp.asarray(hop)))
        jtopo.reset()
        # the port's single-rank runs
        for name, (kind, _, _) in ENGINES.items():
            init = {k.split("::", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
                    if k.startswith(f"init-{kind}::")}
            ref["init", kind] = init
            ref["single", name] = _port_single(name, init)
    finally:
        ranks = _join_world(procs, workdir)
    return ref, ranks, workdir


def _joined(ranks, key):
    """The two ranks' sequence slices of ``key`` side by side (dim 1)."""
    return np.concatenate([r[key] for r in ranks], axis=1)


def ring_local_reference(q, k, v, sp, causal, scale=None):
    """JAX's XLA ring body ``_ring_local`` in torch, every rank at once:
    rank r's queries meet each rank's K/V block in ring order with an fp32
    online softmax (running max floored at ``NEG_INF / 10``)."""
    NEG_INF = -1e30
    Bq, S_, H_, D_ = q.shape
    s, kvH = S_ // sp, k.shape[2]
    G = H_ // kvH
    scale = scale if scale is not None else D_ ** -0.5
    outs = []
    for r in range(sp):
        qg = q[:, r * s:(r + 1) * s].reshape(Bq, s, kvH, G, D_)
        m = torch.full((Bq, kvH, G, s, 1), NEG_INF)
        l_ = torch.zeros((Bq, kvH, G, s, 1))
        acc = torch.zeros((Bq, kvH, G, s, D_))
        q_pos = r * s + torch.arange(s)
        for i in range(sp):
            owner = (r - i) % sp
            kc, vc = k[:, owner * s:(owner + 1) * s], v[:, owner * s:(owner + 1) * s]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc) * scale
            if causal:
                ok = q_pos[:, None] >= (owner * s + torch.arange(s))[None, :]
                logits = torch.where(ok, logits, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            m_safe = torch.maximum(m_new, torch.tensor(NEG_INF / 10))
            p = torch.exp(logits - m_safe)
            corr = torch.exp(m - m_safe)
            l_ = l_ * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
            m = m_new
        out = acc / l_.clamp_min(1e-37)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(Bq, s, H_, D_))
    return torch.cat(outs, dim=1)


# -- the functions against JAX ----------------------------------------------------------

NAMES = ("o", "dq", "dk", "dv")


@pytest.mark.parametrize("form", ["ulysses", "ring"])
@pytest.mark.parametrize("case", list(ATTN))
def test_attention_matches_jax_at_full_width(world, form, case):
    """Output and input gradients of the port's form against the JAX form
    on the seq mesh, both at full width."""
    ref, ranks, _ = world
    for name, want in zip(NAMES, ref[case, form]):
        got = _joined(ranks, f"{form}::full::{case}::{name}")
        np.testing.assert_allclose(got, want, err_msg=name,
                                   **(RING_TOL if name == "o" else GRAD_TOL))


@pytest.mark.parametrize("case", list(ATTN))
def test_ulysses_is_the_whole_sequence_flash_bitwise(world, case):
    """Ulysses is a layout change: the port's output and gradients equal
    its single-process flash (plain version) over the whole sequence, bit
    for bit."""
    from deepspeed_tpu_torch.ops.transformer.attention import flash_attention
    _, ranks, _ = world
    x = _attn_inputs(ATTN[case]["kvH"], seed=list(ATTN).index(case))
    q, k, v = (torch.from_numpy(x[n]).requires_grad_(True) for n in "qkv")
    o = flash_attention(q, k, v, causal=ATTN[case]["causal"])
    o.backward(torch.from_numpy(x["do"]))
    for name, t in zip(NAMES, (o, q.grad, k.grad, v.grad)):
        np.testing.assert_array_equal(_joined(ranks, f"ulysses::full::{case}::{name}"),
                                      t.detach().numpy(), err_msg=name)


@pytest.mark.parametrize("case", list(ATTN))
def test_ring_flash_body_matches_jax_pallas_body(world, case):
    """The port's ring (the flash body; the plain flash on the CPU) against
    JAX's ``_ring_local_flash`` with the Pallas kernel in interpret mode."""
    ref, ranks, _ = world
    for name, want in zip(NAMES, ref[case, "ring-pallas"]):
        np.testing.assert_allclose(_joined(ranks, f"ring::full::{case}::{name}"), want,
                                   err_msg=name, **(RING_TOL if name == "o" else GRAD_TOL))


@pytest.mark.parametrize("case", list(ATTN))
def test_ring_matches_the_xla_body_reference(world, case):
    """The port's ring output against ``ring_local_reference`` (JAX's
    ``_ring_local``), and its gradients against autograd of it."""
    _, ranks, _ = world
    x = _attn_inputs(ATTN[case]["kvH"], seed=list(ATTN).index(case))
    q, k, v = (torch.from_numpy(x[n]).requires_grad_(True) for n in "qkv")
    o = ring_local_reference(q, k, v, SP, ATTN[case]["causal"])
    o.backward(torch.from_numpy(x["do"]))
    for name, t in zip(NAMES, (o, q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(_joined(ranks, f"ring::full::{case}::{name}"),
                                   t.detach().numpy(), err_msg=name,
                                   **(RING_TOL if name == "o" else GRAD_TOL))


@pytest.mark.parametrize("case", list(ATTN))
def test_default_int8_hops_within_the_quantized_hop_tolerance(world, case):
    """The ring on its default wire (int8 K/V hops) against dense attention
    and against the JAX ring on its int8 wire, at ``TestQuantizedHops``'
    tolerance; the K/V gradients flow (straight-through)."""
    ref, ranks, _ = world
    dense = ref[case, "dense"]
    for name, d, j in zip(NAMES, dense, ref[case, "ring-int8"]):
        got = _joined(ranks, f"ring::default::{case}::{name}")
        rtol = 0.1 if name == "o" else 0.2
        assert np.abs(got).max() > 0
        for want in (d, j):
            np.testing.assert_allclose(got, want, rtol=rtol, atol=5e-2 * np.abs(want).max(),
                                       err_msg=name)
    # the int8 wire moved the result off the full-width one, a little
    assert not np.array_equal(_joined(ranks, f"ring::default::{case}::o"),
                              _joined(ranks, f"ring::full::{case}::o"))


def test_ulysses_default_wire_is_bf16_within_its_rounding(world):
    """On the default wire the Ulysses exchange moves fp32 activations as
    bf16: the output within bf16 rounding of the full-width one, not equal."""
    _, ranks, _ = world
    got = _joined(ranks, "ulysses::default::causal::o")
    full = _joined(ranks, "ulysses::full::causal::o")
    assert not np.array_equal(got, full)
    np.testing.assert_allclose(got, full, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("how", ["axis", "group"])
@pytest.mark.parametrize("case", list(ATTN))
def test_distributed_attention_matches_jax(world, case, how):
    """The explicit wrapper, given the seq axis by name or its process
    group, against JAX's ``DistributedAttention`` under ``shard_map``:
    output and input gradients; by name its 4 exchanges and their 4
    inverses are recorded on the seq axis at full width."""
    ref, ranks, _ = world
    for name, want in zip(NAMES, ref[case, "distributed"]):
        np.testing.assert_allclose(_joined(ranks, f"distributed::{how}::{case}::{name}"), want,
                                   err_msg=name, **(RING_TOL if name == "o" else GRAD_TOL))
    for r in ranks:
        recs = r[f"distributed::{how}::{case}::records"]
        assert len(recs) == (8 if how == "axis" else 0), recs
        assert (recs[:, 0] == recs[:, 1]).all()


def test_quantized_ppermute_wire_and_arrivals_match_jax(world):
    """The hop's int8 payload and fp32 scales are the jitted JAX
    quantizer's bytes, and each rank receives what the JAX hop delivers, bit
    for bit."""
    ref, ranks, _ = world
    x = np.random.default_rng(5).normal(size=(SP, 7, 45)).astype(np.float32)
    for r in range(SP):
        gs = min(256, x[r].size)
        q, scale, zero = tquant.quantize_blockwise(torch.from_numpy(x[r]), 8, gs)
        jq, jscale, jzero = jax.jit(lambda t: jquant.quantize_blockwise(t, 8, gs))(x[r])
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq).reshape(q.shape))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale).reshape(-1))
        np.testing.assert_array_equal(ranks[r]["hop"], ref["hop"][r])
    # a hop delivers the neighbour's block, rounded on the int8 grid
    np.testing.assert_allclose(ranks[1]["hop"], x[0], atol=np.abs(x[0]).max() / 127)


# -- training ---------------------------------------------------------------------------


def _params_close(got, want, name):
    """``test_torch_zero.py``'s rule: within 1e-5 abs + 1e-5 rel but for at
    most one element in 10^4 of a leaf, which stays within 2 x lr x steps."""
    for k, v in want.items():
        w = v.numpy() if torch.is_tensor(v) else v
        d = np.abs(got[f"{name}::param::{k}"] - w)
        off = int((d > 1e-5 + 1e-5 * np.abs(w)).sum())
        assert off <= max(1, w.size // 10 ** 4), (name, k, off, d.max())
        assert d.max() <= 2 * LR * STEPS, (name, k, d.max())


@pytest.mark.parametrize("form", ["ulysses", "ring"])
def test_training_matches_the_jax_engine_at_seq_2(world, form):
    ref, ranks, _ = world
    _, want_losses, want_params = ref["jax", form]
    name = f"{form}-full"
    for r in ranks:
        np.testing.assert_allclose(r[name + "::losses"], want_losses, rtol=1e-5, atol=0)
        _params_close(r, want_params, name)
    assert ranks[0][name + "::losses"][-1] < ranks[0][name + "::losses"][0]


@pytest.mark.parametrize("name", list(ENGINES))
def test_training_matches_the_single_rank_run(world, name):
    """Every sp=2 run against the port's single-rank run of the same model,
    batch and init: the ranks' losses equal, losses and eval within 1e-5
    relative at full width (5e-3 on the default wires), params by
    ``_params_close`` at full width."""
    ref, ranks, _ = world
    losses, ev, params = ref["single", name]
    np.testing.assert_array_equal(ranks[0][name + "::losses"], ranks[1][name + "::losses"])
    rtol = 1e-5 if ENGINES[name][2] == "full" else 5e-3
    for r in ranks:
        np.testing.assert_allclose(r[name + "::losses"], losses, rtol=rtol, atol=0)
        np.testing.assert_allclose(r[name + "::eval"], ev, rtol=rtol, atol=0)
        if ENGINES[name][2] == "full":
            _params_close(r, params, name)


def test_labels_shift_across_the_shard_boundary(world):
    """Labels come from the global batch before the split: rank 0's last
    label is rank 1's first token, only rank 1 ends in -100; the loss's
    denominator is the global count of kept labels, though the two slices
    hold 6 and 15 a row."""
    _, ranks, _ = world
    b = _batches()["loss_mask"]
    ids, half = b["input_ids"], S // SP
    np.testing.assert_array_equal(ranks[0]["labels"], ids[:, 1:half + 1])
    np.testing.assert_array_equal(ranks[1]["labels"][:, :-1], ids[:, half + 1:])
    assert (ranks[1]["labels"][:, -1] == -100).all()
    want = float(((np.pad(ids[:, 1:], ((0, 0), (0, 1)), constant_values=-100) >= 0)
                  * b["loss_mask"]).sum())
    assert float(ranks[0]["denominator"]) == float(ranks[1]["denominator"]) == want
    counts = [int(((r["labels"] >= 0) * b["loss_mask"][:, s]).sum())
              for r, s in zip(ranks, (slice(0, half), slice(half, S)))]
    assert counts == [12, 30] and sum(counts) == want


@pytest.mark.parametrize("name,ops", [
    ("ulysses-default", {"all_to_all": True, "ppermute": False}),
    ("ring-default", {"all_to_all": False, "ppermute": True}),
    ("ulysses-full", {"all_to_all": False, "ppermute": False}),
    ("ring-full", {"all_to_all": False, "ppermute": False}),
])
def test_collective_records_carry_the_wire_width(world, name, ops):
    """Ulysses records its all-to-alls (4 a layer: q, k, v, out; forward,
    remat replay and backward), narrow (bf16) on the default wire; the ring
    records sp - 1 hops of K and V a layer in the forward and the remat
    replay, narrow (int8) on the default wire, and as many inverse hops in
    the backward, which carry the cotangents at full width."""
    _, ranks, _ = world
    L = 2
    for r in ranks:
        form = name.split("-")[0]
        n_a2a = int(r[f"{name}::all_to_all::n"])
        n_hop = int(r[f"{name}::ppermute::n"])
        if form == "ulysses":
            assert n_a2a == 4 * L * 3 * STEPS, n_a2a
            assert n_hop == 0
        else:
            assert n_a2a == 0
            assert n_hop == 2 * (SP - 1) * L * 3 * STEPS, n_hop
        narrow = {"all_to_all": n_a2a, "ppermute": 2 * (SP - 1) * L * 2 * STEPS}
        for op, is_narrow in ops.items():
            assert int(r[f"{name}::{op}::narrow"]) == (narrow[op] if is_narrow else 0), op


def test_a_one_rank_run_after_the_seq_engines_is_the_one_rank_run(world):
    """In a rank's process, after its seq-sharded engines and the end of
    the process group, the published topology is gone and a world-of-one
    engine trains as the single-rank run does."""
    ref, ranks, _ = world
    for r in ranks:
        assert not bool(r["topology-after-destroy"])
        np.testing.assert_allclose(r["after::losses"], ref["single", "ulysses-full"][0],
                                   rtol=1e-5, atol=0)


def test_a_one_rank_engine_publishes_no_seq_axis(world):
    """A world-of-one engine publishes its own topology (none), so a stale
    seq axis left by an earlier engine changes neither its training nor
    its eval."""
    from deepspeed_tpu_torch.runtime import topology as ttopo
    ref, _, _ = world
    ttopo.set_topology(TorchTopology({"seq": SP}, world_size=SP, rank=1))
    try:
        losses, ev, _ = _port_single("ulysses-full", ref["init", "llama"])
        assert ttopo.get_topology() is None
    finally:
        ttopo.reset()
    want_losses, want_ev, _ = ref["single", "ulysses-full"]
    assert losses == want_losses and ev == want_ev


def test_a_seq_sharded_tag_loads_into_one_device(world):
    """The sp=2 engine's tag holds one file a rank, as a data-parallel
    engine's does, and loads into a single-rank port engine whose params
    are the saver's, bit for bit."""
    _, ranks, workdir = world
    tag_dir = workdir / "ckpt" / "global_step3"
    assert sorted(p.name for p in tag_dir.glob("*.npz")) == ["state.rank0.npz",
                                                             "state.rank1.npz"]
    kind, form, wire = ENGINES["ulysses-full"]
    eng, *_ = deepspeed_tpu_torch.initialize(model=_port_model(kind, form),
                                             config=_config(wire), device="cpu", seed=9)
    assert eng.load_checkpoint(str(workdir / "ckpt"))[0] == "global_step3"
    for k, v in eng.module_state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ranks[0]["ulysses-full::param::" + k])


# -- config, validation, topology -------------------------------------------------------


@pytest.mark.parametrize("batch,want", [
    ({"train_micro_batch_size_per_gpu": 1}, (2, 1, 1)),
    ({"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2}, (8, 2, 2)),
    ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2}, (8, 2, 2)),
    ({"train_batch_size": 4}, (4, 2, 1)),
])
def test_batch_resolution_at_seq_2_matches_jax(batch, want):
    """``data_parallel_size`` counts seq, as JAX's ``_resolve_batch`` does."""
    cfg = deepspeed_tpu_torch.DeepSpeedConfig(dict(batch, topology={"data": 1, "seq": 2}))
    got = (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
           cfg.gradient_accumulation_steps)
    jtopo.reset()
    topo = MeshTopology(TopologyConfig(seq=2, data=1), devices=jax.devices()[:2])
    j = JaxConfig(dict(batch), mesh_topology=topo)
    assert got == want == (j.train_batch_size, j.train_micro_batch_size_per_gpu,
                           j.gradient_accumulation_steps)
    assert cfg.data_parallel_size == topo.data_parallel_size == 2


@pytest.mark.parametrize("overrides,match", [
    (dict(causal=False, position="learned"), "causal-only"),
    (dict(attn_windows=8), "windows are not supported"),
    (dict(position="alibi"), "alibi positions are not supported"),
])
def test_ring_validation_errors_match_jax(overrides, match):
    from deepspeed_tpu.models.transformer import TransformerConfig as JaxTC
    from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
    base = dict(vocab_size=64, max_seq_len=32, num_layers=2, num_heads=2, hidden_size=16,
                seq_parallel="ring")
    with pytest.raises(ValueError, match=match):
        JaxLM(JaxTC(**base, **overrides))
    with pytest.raises(ValueError, match=match):
        TransformerLM(TransformerConfig(**base, **overrides))


def test_ring_refuses_a_padding_mask_as_jax_does():
    from deepspeed_tpu.models.transformer import TransformerConfig as JaxTC
    from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
    base = dict(vocab_size=64, max_seq_len=32, num_layers=1, num_heads=2, hidden_size=16,
                seq_parallel="ring", remat=False)
    ids, mask = np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32)
    jm = JaxLM(JaxTC(**base))
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.float32))
    with pytest.raises(ValueError, match="padding masks"):   # raised as it traces
        jax.eval_shape(lambda p: jm.apply(p, jnp.asarray(ids), attention_mask=jnp.asarray(mask)),
                       params)
    tm = TransformerLM(TransformerConfig(**base, dtype=torch.float32)).materialize("cpu")
    with pytest.raises(ValueError, match="padding masks"):
        tm.apply(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))


def test_topology_coordinates_follow_the_jax_mesh_order():
    """Rank r of a world of data x seq sits where device r sits in the JAX
    mesh (seq inside data); its groups, rows and sequence slice follow."""
    jm = MeshTopology(TopologyConfig(data=2, seq=2), devices=jax.devices()[:4])
    grid = jm.mesh.devices
    for r in range(4):
        t = TorchTopology({"data": 2, "seq": 2}, world_size=4, rank=r)
        idx = tuple(int(i[0]) for i in np.nonzero(np.vectorize(lambda d: d.id)(grid) ==
                                                  jax.devices()[r].id))
        assert tuple(t.coords.values()) == idx
        assert t.axis_ranks("seq") == [2 * (r // 2), 2 * (r // 2) + 1]
        assert t.axis_ranks("data") == [r % 2, r % 2 + 2]
        assert t.batch_rows(4) == slice(2 * (r // 2), 2 * (r // 2) + 2)
        assert t.seq_slice(8) == slice(4 * (r % 2), 4 * (r % 2) + 4)
        assert t.data_parallel_size == jm.data_parallel_size == 4
        assert t.sequence_parallel_size == jm.sequence_parallel_size == 2
    one = TorchTopology({"seq": 2}, world_size=2, rank=1)
    assert one.group("seq") is None and one.axis_ranks("data") == [1]
    with pytest.raises(ValueError, match="does not divide"):
        TorchTopology({"seq": 3}, world_size=4, rank=0)
    for axis, item in (("model", "A6"), ("expert", "A7"), ("pipe", "A10")):
        with pytest.raises(NotImplementedError, match=item):
            TorchTopology({axis: 2}, world_size=2, rank=0)
