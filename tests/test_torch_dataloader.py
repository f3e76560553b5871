"""The training front door's dataloader (``runtime/dataloader.py``) against
the JAX package's.

``initialize(..., training_data=...)`` in both packages on the same 10
samples, llama2-tiny, micro batch 4: the port's loader yields JAX's batches
(order, count, values, dtypes) over one epoch and after ``set_epoch``, on
one rank (the JAX engine on one device) and on a gloo world of 2 (two child
processes that import only the port; the JAX engine on a 2-device mesh),
where a batch is the micro batch times the data ranks. ``RepeatingLoader``
restarts a loader that runs out, as the JAX one does.
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

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.runtime import topology as jtopo
from deepspeed_tpu.runtime.dataloader import RepeatingLoader as JaxRepeatingLoader
from deepspeed_tpu.runtime.topology import MeshTopology, TopologyConfig
from deepspeed_tpu_torch.models import llama_model
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 120
MICRO, N = 4, 10
CONFIG = {"train_micro_batch_size_per_gpu": MICRO,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
EPOCHS = (0, 3)


def _samples():
    rng = np.random.default_rng(4)
    return [{"input_ids": np.full(8, i, np.int64),
             "loss_mask": rng.random(8).astype(np.float32)} for i in range(N)]


def _epochs(loader):
    """Every batch of each epoch in ``EPOCHS``: ``{epoch: [batch, ...]}``."""
    out = {}
    for e in EPOCHS:
        loader.set_epoch(e)
        out[e] = list(loader)
        assert len(out[e]) == len(loader)
    return out


def _jax_loader(n_dev):
    jtopo.reset()
    try:
        topo = MeshTopology(TopologyConfig(data=n_dev), devices=jax.devices()[:n_dev])
        _, _, loader, _ = deepspeed_tpu.initialize(
            model=jax_llama("llama2-tiny", dtype=jnp.float32), config=CONFIG, topology=topo,
            training_data=_samples())
    finally:
        jtopo.reset()
    return loader


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for e in want:
        assert len(got[e]) == len(want[e]), e
        for g, w in zip(got[e], want[e]):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_one_rank_yields_jax_batches():
    _, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=llama_model("llama2-tiny", dtype=torch.float32), config=CONFIG,
        training_data=_samples(), device="cpu")
    assert isinstance(loader, DeepSpeedDataLoader)
    got, want = _epochs(loader), _epochs(_jax_loader(1))
    _assert_same(got, want)
    # 10 samples, batches of 4, the short last batch dropped: the order JAX's
    # default seed 0 gives
    assert [b["input_ids"][:, 0].tolist() for b in got[0]] == [[4, 6, 2, 7], [3, 5, 9, 0]]
    assert got[3][0]["input_ids"][:, 0].tolist() != got[0][0]["input_ids"][:, 0].tolist()


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
                      init_method="file://" + workdir + "/rendezvous", timeout=60)
spec = eval(open(workdir + "/spec.py").read())
inputs = dict(np.load(workdir + "/samples.npz"))
samples = [{k: inputs[k][i] for k in ("input_ids", "loss_mask")}
           for i in range(len(inputs["input_ids"]))]
engine, _, loader, _ = deepspeed_tpu_torch.initialize(
    model=llama_model("llama2-tiny", dtype=torch.float32), config=spec["config"],
    training_data=samples, device="cpu")
out = {"len": np.array(len(loader)), "engine": np.array(type(engine).__name__)}
for e in spec["epochs"]:
    loader.set_epoch(e)
    for i, b in enumerate(loader):
        for k, v in b.items():
            out[f"{e}::{i}::{k}"] = v
    loader.set_epoch(e)
# a step from the loader: each rank takes its rows of the global batch
out["loss"] = np.array(float(engine.train_batch(iter(loader))))
np.savez(workdir + f"/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def test_world_of_two_yields_jax_batches(tmp_path):
    samples = _samples()
    np.savez(tmp_path / "samples.npz", input_ids=np.stack([s["input_ids"] for s in samples]),
             loss_mask=np.stack([s["loss_mask"] for s in samples]))
    (tmp_path / "spec.py").write_text(repr({"config": CONFIG, "epochs": list(EPOCHS)}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(tmp_path)], cwd=ROOT,
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
    want = _epochs(_jax_loader(2))
    assert len(want[0]) == 1 and want[0][0]["input_ids"].shape[0] == 2 * MICRO
    for r in range(2):
        out = dict(np.load(tmp_path / f"out{r}.npz"))
        assert str(out["engine"]) == "DataParallelEngine" and int(out["len"]) == 1
        got = {e: [{k: out[f"{e}::{i}::{k}"] for k in ("input_ids", "loss_mask")}
                   for i in range(len(want[e]))] for e in EPOCHS}
        assert not any(k.startswith(f"{e}::{len(want[e])}::") for e in EPOCHS for k in out)
        _assert_same(got, want)
        assert np.isfinite(float(out["loss"]))


@pytest.mark.parametrize("drop_last", [True, False])
def test_repeating_loader_restarts_as_jax(drop_last):
    mine = RepeatingLoader(DeepSpeedDataLoader(_samples(), batch_size=3, drop_last=drop_last))
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JaxLoader
    theirs = JaxRepeatingLoader(JaxLoader(_samples(), batch_size=3, drop_last=drop_last))
    per_epoch = 3 if drop_last else 4
    for _ in range(2 * per_epoch + 1):
        g, w = next(mine), next(theirs)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert iter(mine) is mine
