"""The port's communication frontend and quantized collectives against the
JAX package.

- ``resolve_transport`` and ``TransportPlan.wire_bytes`` against the JAX
  planner over a table of kinds, ops, sizes, axes and requests, under the
  default and three non-default policies: equal plans and equal bytes;
- on a gloo world of 2 (two child processes that import only the port, a
  fresh ``file://`` rendezvous in ``tmp_path``, a timeout on the whole run):
  the plain collectives against numpy, exactly; ``quantized_all_gather``,
  ``quantized_reduce_scatter`` (int8 and int4, ``n_chunks`` 1 and 2), the
  fp8 pair against the JAX functions inside
  ``shard_map`` over ``jax.devices()[:2]`` (jitted). The gathers are bit for
  bit. A reduce-scatter's wire payloads are the jitted JAX quantizer's bit
  for bit, and its output is their dequantized sum: in the port
  ``fp32(d0 + d1)``; on the JAX side XLA's CPU backend contracts member 1's
  dequantize multiply into the sum, ``fp32(d0 + (q1 - z1) * s1)`` rounded
  once (an FMA). Both are checked bit for bit against those two forms
  computed from the JAX payloads (the FMA in float64, where the product is
  exact). ``quantized_all_reduce`` is the port's reduce-scatter, then the
  gather leg, which is the JAX ``quantized_all_gather`` of the port's
  reduced shards bit for bit.
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

from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.ops.quantizer import quantizer as jq
from deepspeed_tpu.runtime import topology as jtopo
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.comm import comm as tcomm
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 180   # seconds for a whole two-rank run, rendezvous included

# one rank: joins the gloo world, runs task.py's run(rank) and saves what it
# returns; imports only the port
CHILD = r"""
import sys
import numpy as np
import torch
rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(2)
from deepspeed_tpu_torch.comm import comm as dist
dist.init_distributed("gloo", rank=rank, world_size=world,
                      init_method="file://" + workdir + "/rendezvous", timeout=120)
scope = {}
exec(open(workdir + "/task.py").read(), scope)
out = scope["run"](rank, dict(np.load(workdir + "/inputs.npz")))
np.savez(workdir + f"/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def run_world(workdir: Path, task: str, inputs, world: int = 2):
    """Run ``task`` (source defining ``run(rank, inputs) -> {name: array}``)
    on ``world`` gloo ranks; returns each rank's outputs. Fails the test if
    a rank fails or the run outlasts WORLD_TIMEOUT."""
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    (workdir / "task.py").write_text(task)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(world), str(workdir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
    return [dict(np.load(workdir / f"out{r}.npz")) for r in range(world)]


# -- the planner ----------------------------------------------------------------

POLICIES = [{}, {"enabled": False}, {"min_bytes": 1 << 20, "group_size": 128},
            {"grad_width": "fp8", "activation_width": "full", "hierarchical": False}]
KINDS = [None, "param", "grad", "activation"]
OPS = ["all_reduce", "reduce_scatter", "all_gather", "all_to_all", "ppermute"]
REQUESTS = [None, "int8", "fp8", "bf16", "full"]
AXES = [("data", {"data": 2}), (("data", "mics"), {"data": 2, "mics": 4}),
        (("data", "model"), {"data": 1, "model": 2}), ("model", {"model": 2})]


@pytest.fixture
def planners():
    jtopo.reset()
    jcomm.reset_transport()
    tcomm.reset_transport()
    yield
    jcomm.reset_transport()
    tcomm.reset_transport()


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: ",".join(p) or "default")
def test_transport_plans_match_jax(planners, policy):
    jcomm.configure_transport(**policy)
    tcomm.configure_transport(**policy)
    checked = 0
    for kind in KINDS:
        for op in OPS:
            for req in REQUESTS:
                for nbytes in (0, 1000, 1024, 4 << 20):
                    for axes, sizes in AXES:
                        want = jcomm.resolve_transport(kind, op, nbytes, axes,
                                                       axis_sizes=sizes, requested=req)
                        got = tcomm.resolve_transport(kind, op, nbytes, axes,
                                                      axis_sizes=sizes, requested=req)
                        assert (got.width, got.algo, got.inner, got.outer, got.group_size,
                                got.error_feedback) == (
                            want.width, want.algo, want.inner, want.outer,
                            want.group_size, want.error_feedback), (kind, op, req, axes)
                        for n, isz in ((1, 4), (1000, 2), (4097, 4)):
                            assert got.wire_bytes(n, isz) == want.wire_bytes(n, isz)
                        checked += 1
    assert checked == len(KINDS) * len(OPS) * len(REQUESTS) * 4 * len(AXES)


def test_transport_config_rejects_what_jax_rejects(planners):
    for bad in ({"nope": 1}, {"grad_width": "int4"}):
        with pytest.raises(ValueError):
            jcomm.configure_transport(**bad)
        with pytest.raises(ValueError):
            tcomm.configure_transport(**bad)
    assert tcomm.transport_config() == jcomm.transport_config()
    assert tcomm.FULL_FLAT_PLAN == tcomm.TransportPlan()
    assert tcomm.resolve_transport(None, "all_gather", 1 << 30, "data") is tcomm.FULL_FLAT_PLAN


def test_ledger_records_and_split():
    ledger = tcomm.CollectiveLedger()
    tcomm.record_collective("all_gather", 100, "data", overlapped=False)   # no ledger: dropped
    with tcomm.record_into(ledger):
        tcomm.record_collective("all_gather", 100, "data", overlapped=False, wire_bytes=58)
        tcomm.record_collective("all_to_all", 40, ("data",), overlapped=True, count=3)
        tcomm.record_collective("all_reduce", 8, "data")
    assert [r["op"] for r in ledger.records] == ["all_gather", "all_to_all", "all_reduce"]
    assert ledger.split() == {"overlapped_bytes": 120, "exposed_bytes": 58}
    assert ledger.split(wire=False) == {"overlapped_bytes": 120, "exposed_bytes": 100}
    assert "all_gather 100 B" in ledger.tail()


def test_world_of_one_collectives_are_the_identity():
    x = torch.arange(6.0).reshape(3, 2)
    assert tcomm.get_world_size() == 1 and tcomm.get_rank() == 0
    for fn in (tcomm.all_gather, tcomm.all_reduce, tcomm.reduce_scatter, tcomm.all_to_all,
               tcomm.broadcast):
        assert torch.equal(fn(x), x)


# -- collectives on a gloo world of 2 ---------------------------------------------

N = 2
S0 = 12       # leading rows of a member's shard (chunks of 6 at n_chunks 2)
COLS = 45     # a shard of 540 values: groups of 256 pad at the tail
CASES = {
    # name: (JAX function, port function, kind: "gather" or "scatter", kwargs)
    "qag-int8": ("quantized_all_gather", "gather", dict(num_bits=8, group_size=256)),
    "qag-int8-gs7": ("quantized_all_gather", "gather", dict(num_bits=8, group_size=7)),
    "qag-int4": ("quantized_all_gather", "gather", dict(num_bits=4, group_size=64)),
    "qag-int8-chunks2": ("quantized_all_gather", "gather",
                         dict(num_bits=8, group_size=256, n_chunks=2)),
    "qrs-int8": ("quantized_reduce_scatter", "scatter", dict(num_bits=8, group_size=256)),
    "qrs-int8-gs100": ("quantized_reduce_scatter", "scatter", dict(num_bits=8, group_size=100)),
    "qrs-int4": ("quantized_reduce_scatter", "scatter", dict(num_bits=4, group_size=64)),
    "qrs-int8-chunks2": ("quantized_reduce_scatter", "scatter",
                         dict(num_bits=8, group_size=256, n_chunks=2)),
    "fp8-ag": ("fp8_all_gather", "gather", dict(group_size=256)),
    "fp8-rs": ("fp8_reduce_scatter", "scatter", dict(group_size=256)),
}

TASK = r"""
import numpy as np
import torch
from deepspeed_tpu_torch.comm import comm as dist
from deepspeed_tpu_torch.ops.quantizer import quantizer as q

CASES = %r


def run(rank, inputs):
    out = {}
    for name, (fn, kind, kw) in CASES.items():
        x = torch.from_numpy(inputs[kind][rank])
        out[name] = getattr(q, fn)(x, **kw).numpy()
    x = torch.from_numpy(inputs["gather"][rank])
    out["all_gather"] = dist.all_gather(x).numpy()
    out["reduce_scatter"] = dist.reduce_scatter(torch.from_numpy(inputs["scatter"][rank])).numpy()
    out["all_to_all"] = dist.all_to_all(x).numpy()
    out["all_reduce_avg"] = dist.all_reduce(x, dist.ReduceOp.AVG).numpy()
    out["all_reduce_max"] = dist.all_reduce(x, "max").numpy()
    out["broadcast"] = dist.broadcast(x, src=1).numpy()
    out["bf16_gather"] = dist.all_gather(x.to(torch.bfloat16)).float().numpy()
    y = torch.from_numpy(inputs["allreduce"][rank])
    out["qar"] = q.quantized_all_reduce(y, group_size=16).numpy()
    flat = torch.nn.functional.pad(y.reshape(-1), (0, (-y.numel()) %% dist.get_world_size()))
    out["qar-shard"] = q.quantized_reduce_scatter(flat, group_size=16).numpy()
    return out
"""


def _inputs():
    rng = np.random.default_rng(11)
    scale = rng.choice([1e-3, 0.05, 2.0], size=(N, 1, COLS))
    return {
        "gather": (rng.standard_normal((N, S0, COLS)) * scale).astype(np.float32),
        "scatter": (rng.standard_normal((N, N * S0, COLS))).astype(np.float32),
        "allreduce": (rng.standard_normal((N, 7, 13))).astype(np.float32),
    }


@pytest.fixture(scope="module")
def world_results(tmp_path_factory):
    inputs = _inputs()
    task = TASK % {k: (fn, kind, kw) for k, (fn, kind, kw) in CASES.items()}
    return inputs, run_world(tmp_path_factory.mktemp("comm_world"), task, inputs)


def _jax_member_outputs(fn_name, kind, kw, x):
    """The JAX function inside shard_map over jax.devices()[:2]: each
    member's output, in member order."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
    fn = getattr(jq, fn_name)
    kw = dict(kw)
    body = lambda a: fn(a[0], "data", **kw)[None]
    sm = shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                   check_vma=False)
    return np.asarray(jax.jit(sm)(jnp.asarray(x)))


def _dequantized_products(x, kw, fp8):
    """Each member's dequantized destination chunks from the jitted JAX
    quantizer: ``(fp32 [N, N, chunk], exact float64 [N, N, chunk])``, member
    m's chunk for destination r at [m, r]."""
    n, chunk = N, x[0].size // N
    bits = 8 if fp8 else kw.get("num_bits", 8)
    gs = max(1, min(kw["group_size"], chunk))
    if bits == 4:
        gs = max(2, gs - gs % 2)
    pad = (-chunk) % gs
    f32, f64 = [], []
    for m in range(n):
        xr = jnp.pad(jnp.asarray(x[m]).reshape(n, chunk), ((0, 0), (0, pad)))
        if fp8:
            q, s = jax.jit(lambda a: jq.quantize_blockwise_fp8(a, gs))(xr)
            vals, z = np.asarray(q).astype(np.float64), np.zeros(np.asarray(s).shape)
        else:
            q, s, z = jax.jit(lambda a: jq.quantize_blockwise(a, bits, gs))(xr)
            q, z = np.asarray(q), np.asarray(z)
            if bits == 4:
                b = q.astype(np.int16)
                lo, hi = b & 0x0F, (b >> 4) & 0x0F
                vals = np.stack([np.where(lo >= 8, lo - 16, lo),
                                 np.where(hi >= 8, hi - 16, hi)], -1).reshape(q.shape[0], -1)
            else:
                vals = q
        s = np.asarray(s)
        f32.append(((vals.astype(np.float32) - z[:, None].astype(np.float32))
                    * s[:, None]).reshape(n, -1)[:, :chunk])
        f64.append(((vals.astype(np.float64) - z[:, None]) * s[:, None].astype(np.float64)
                    ).reshape(n, -1)[:, :chunk])
    return np.stack(f32), np.stack(f64)


def _scatter_forms(x, kw, fp8):
    """The reduce-scatter output of each destination in the port's form
    (``d0 + d1`` in fp32) and in XLA CPU's (member 1's product fused into
    the sum), chunk by chunk as ``scatter_in_row_chunks`` splits it."""
    chunks = kw.get("n_chunks", 1)
    rows, cols = x.shape[1] // N, x.shape[2]
    ck = rows // chunks
    plain, fused = [[] for _ in range(N)], [[] for _ in range(N)]
    for c in range(chunks):
        sub = x.reshape(N, N, rows, cols)[:, :, c * ck:(c + 1) * ck].reshape(N, -1)
        d32, d64 = _dequantized_products(sub, kw, fp8)
        for r in range(N):
            plain[r].append((d32[0, r] + d32[1, r]).reshape(ck, cols))
            fused[r].append((d32[0, r].astype(np.float64) + d64[1, r]).astype(np.float32)
                            .reshape(ck, cols))
    return [np.concatenate(p) for p in plain], [np.concatenate(f) for f in fused]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_collectives_bitwise_against_jax(world_results, case):
    inputs, outs = world_results
    fn, kind, kw = CASES[case]
    want = _jax_member_outputs(fn, kind, kw, inputs[kind])
    if kind == "scatter":
        plain, fused = _scatter_forms(inputs[kind], kw, fp8=fn.startswith("fp8"))
    for rank in range(N):
        got = outs[rank][case]
        assert got.shape == want[rank].shape, (got.shape, want[rank].shape)
        if kind == "scatter":
            np.testing.assert_array_equal(_bits(want[rank]), _bits(fused[rank]),
                                          err_msg=f"{case} rank {rank}: JAX vs its FMA form")
            want_rank = plain[rank]
        else:
            want_rank = want[rank]
        np.testing.assert_array_equal(_bits(got), _bits(want_rank),
                                      err_msg=f"{case} rank {rank}")


def test_plain_collectives_on_gloo(world_results):
    inputs, outs = world_results
    g, s = inputs["gather"], inputs["scatter"]
    for rank in range(N):
        o = outs[rank]
        np.testing.assert_array_equal(o["all_gather"], np.concatenate(list(g)))
        np.testing.assert_array_equal(o["reduce_scatter"],
                                      (s[0] + s[1])[rank * S0:(rank + 1) * S0])
        np.testing.assert_array_equal(o["all_to_all"], np.concatenate(
            [g[m][rank * S0 // N:(rank + 1) * S0 // N] for m in range(N)]))
        np.testing.assert_array_equal(o["all_reduce_avg"], (g[0] + g[1]) / 2)
        np.testing.assert_array_equal(o["all_reduce_max"], np.maximum(g[0], g[1]))
        np.testing.assert_array_equal(o["broadcast"], g[1])
        want = torch.from_numpy(np.concatenate(list(g))).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(o["bf16_gather"], want)


def test_quantized_all_reduce_is_scatter_then_the_jax_gather(world_results):
    inputs, outs = world_results
    shards = np.stack([outs[r]["qar-shard"] for r in range(N)])
    gathered = _jax_member_outputs("quantized_all_gather", "gather", dict(group_size=16),
                                   shards)
    size = inputs["allreduce"][0].size
    for rank in range(N):
        want = gathered[rank][:size].reshape(inputs["allreduce"][0].shape)
        np.testing.assert_array_equal(_bits(outs[rank]["qar"]), _bits(want))
    np.testing.assert_allclose(outs[0]["qar"], inputs["allreduce"].sum(0), rtol=0.05, atol=0.05)
