"""The port's checkpoints against the JAX package's: the same on-disk
format, leaf for leaf, loadable by either package.

llama2-tiny, AdamW with clipping 1.0, fp32 unless a case says bf16; the
JAX engine at micro-batch 1 on the 8-device test mesh (its XLA attention),
the port at micro-batch 8 on the CPU (its plain kernels), the same numpy
batch; the port starts from the JAX engine's initial params
(``params_from_jax``).

(a) ``params_to_jax`` / ``opt_state_to_jax`` invert ``params_from_jax`` /
    ``opt_state_from_jax`` bitwise (llama2-tiny fp32 and bf16, mixtral-tiny).
(b) after 2 steps the port's tag has the JAX tag's keys, shapes and dtypes
    (gas 1 and gas 2, where both write ``grad_acc/...``); params and master
    within the JAX trajectory's tolerance of ``test_torch_zero.py``: 1e-5
    absolute plus 1e-5 relative, except at most one element in 10^4 of a
    leaf, within 2 x lr x steps (Adam's normalised step turns fp32 noise in
    a gradient near zero into an lr-sized move).
(c) a JAX tag loads into the port: its next 3 losses within 1e-5 relative
    of the JAX engine's own; a bf16 JAX tag loads with every leaf bitwise.
(d) a port tag loads into the JAX engine, fp32 (the JAX engine cannot
    reload a single-process bf16 tag of its own: ``|V2`` has no cast to
    bfloat16 in ``store.py:670``).
(e) a save and load mid-run resumes the port's trajectory bitwise, fp32
    and bf16; ``load_optimizer_states=False`` starts the optimizer afresh
    from the loaded weights (the JAX engine keeps its own master there).
(f) durability, reaching the windows through ``os.replace`` / ``np.savez``.
(g) the async engine's commit fence.
(h) the ``checkpoint`` config block.
(i) ``zero_to_fp32`` and ``ds_to_universal`` of both packages agree on
    tags of both.
ZeRO: a stage-3 world of 2 (gloo, two child processes that import only
the port, a ``file://`` rendezvous, ``WORLD_TIMEOUT``) writes rank files in
the JAX multi-host form, which load at world 2 stage 1, in a single-device
port engine and in the JAX engine with equal params; a single-device tag
loads at world 2 stage 3.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint.ds_to_universal import ds_to_universal as jax_universal
from deepspeed_tpu.checkpoint.ds_to_universal import load_universal as jax_load_universal
from deepspeed_tpu.models import llama_model as jax_llama
from deepspeed_tpu.models import mixtral_model as jax_mixtral
from deepspeed_tpu.utils import zero_to_fp32 as jax_fp32
from deepspeed_tpu_torch.checkpoint.ds_to_universal import ds_to_universal as port_universal
from deepspeed_tpu_torch.checkpoint.ds_to_universal import load_universal as port_load_universal
from deepspeed_tpu_torch.checkpoint import store
from deepspeed_tpu_torch.convert import (jax_leaf, opt_state_from_jax, opt_state_to_jax,
                                         params_from_jax, params_to_jax)
from deepspeed_tpu_torch.models import llama_model
from deepspeed_tpu_torch.runtime.engine import _TagLeaf
from deepspeed_tpu_torch.runtime.zero.partition import shard_dim
from deepspeed_tpu_torch.utils import zero_to_fp32 as port_fp32
from tests.port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 300   # seconds for the whole two-rank run, rendezvous included
V = 1024
ADAMW = {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}}
CFG = {"optimizer": ADAMW, "gradient_clipping": 1.0}
BF16 = dict(CFG, bf16={"enabled": True})
TOL = 1e-5


def _batch(seed=0, B=8, S=32):
    """B 8 where the JAX engine runs (micro 1 on 8 devices); the port-only
    cases take B 2."""
    return {"input_ids": np.random.default_rng(seed).integers(0, V, size=(B, S))}


def _jax_engine(cfg, gas=1, seed=7):
    dt = jnp.bfloat16 if cfg.get("bf16") else jnp.float32
    eng, *_ = deepspeed_tpu.initialize(
        model=jax_llama("llama2-tiny", dtype=dt),
        config=dict(cfg, train_micro_batch_size_per_gpu=1, gradient_accumulation_steps=gas),
        seed=seed)
    return eng


def _port_engine(cfg, init=None, gas=1, seed=11):
    dt = torch.bfloat16 if cfg.get("bf16") else torch.float32
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=llama_model("llama2-tiny", dtype=dt),
        config=dict(cfg, train_micro_batch_size_per_gpu=8, gradient_accumulation_steps=gas),
        model_parameters=init, device="cpu", seed=seed)
    return eng


def _meta(d, tag):
    with open(os.path.join(d, tag, "meta.json")) as f:
        return json.load(f)


def _leaves(d, tag):
    """``{key: array}`` of a single-file tag, as stored."""
    meta = _meta(d, tag)
    with np.load(os.path.join(d, tag, "state.npz")) as z:
        return {k: z[f"leaf_{i}"] for i, k in enumerate(meta["keys"])}


def _headers(d, tag):
    """``{npz member: (shape, fortran order, dtype descr)}`` as stored."""
    import zipfile
    out = {}
    with zipfile.ZipFile(os.path.join(d, tag, "state.npz")) as z:
        for name in z.namelist():
            with z.open(name) as f:
                read = {(1, 0): np.lib.format.read_array_header_1_0,
                        (2, 0): np.lib.format.read_array_header_2_0}[np.lib.format.read_magic(f)]
                shape, fortran, dtype = read(f)
                out[name] = (shape, fortran, dtype.str)
    return out


def _params(eng):
    return {k: v.detach().clone() for k, v in eng.module_state_dict().items()}


def _same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- (a) the inverse of the conversion ------------------------------------------------


@pytest.mark.parametrize("model", ["llama2-tiny-fp32", "llama2-tiny-bf16", "mixtral-tiny"])
def test_conversion_round_trip_is_bitwise(model):
    if model == "mixtral-tiny":
        jm, dt = jax_mixtral("mixtral-tiny"), jnp.float32
    else:
        dt = jnp.bfloat16 if model.endswith("bf16") else jnp.float32
        jm = jax_llama("llama2-tiny", dtype=dt)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(3), dt))
    rng = np.random.default_rng(4)
    noisy = lambda t: jax.tree.map(
        lambda a: (rng.normal(size=a.shape).astype(np.float32)), t)
    opt = {"step": np.asarray(5, np.int32), "master": noisy(tree), "exp_avg": noisy(tree),
           "exp_avg_sq": noisy(tree)}
    for want, got in ((tree, params_to_jax(params_from_jax(tree))),
                      (opt, opt_state_to_jax(opt_state_from_jax(opt)))):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            w, g = np.asarray(w), np.asarray(g)
            assert w.shape == g.shape and w.dtype.itemsize == g.dtype.itemsize, path
            assert w.tobytes() == g.tobytes(), path


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("shape", [(2048,), (5632, 2048), (7, 6), (5,), (3, 5), (6, 10)])
def test_shard_spans_tile_the_jax_leaf(shape, n):
    """The ranks' spans of a port leaf in its stacked JAX leaf (layers 0..2 of
    a kernel or a norm, and the same leaf unstacked) cover every element
    once, for the shard dim the plan picks (None on odd sizes: one whole
    piece on every rank, written by rank 0 alone)."""
    name = {1: "blocks.{}.ln_1.weight", 2: "blocks.{}.q_proj.weight"}[len(shape)]
    top = {1: "ln_f.weight", 2: "lm_head.weight"}[len(shape)]
    d = shard_dim(shape, n)
    for names in ([name.format(l) for l in range(3)], [top]):
        leaves = [jax_leaf(m, len(shape)) for m in names]
        e = _TagLeaf(leaves, [None] * len(leaves), d, shape)
        count = np.zeros(e.jax_shape, np.int64)
        for r in range(n if d is not None else 1):
            count[tuple(slice(a, b) for a, b in e.spans(r, n))] += 1
        assert (count == 1).all(), (names[0], shape, n, d)


# -- a JAX tag and a port tag from the same start, fp32 --------------------------------


@pytest.fixture(scope="module")
def twin_tags(tmp_path_factory):
    """The JAX engine and the port from the JAX engine's initial params, 2
    steps, a tag each, at gas 1 and gas 2; at gas 1 then the JAX engine's
    next 3 losses and the port's, and the JAX engine's 3 losses after it
    loaded the port's tag (the load replaces all of its state)."""
    out = {}
    batch = _batch()
    for gas in (1, 2):
        d = tmp_path_factory.mktemp(f"twins_gas{gas}")
        jeng = _jax_engine(CFG, gas=gas)
        init = params_from_jax(jax.device_get(jeng.state["params"]))
        for _ in range(2):
            jeng.train_batch(batch)
        jeng.save_checkpoint(str(d / "jax"))
        peng = _port_engine(CFG, init, gas=gas)
        for _ in range(2):
            peng.train_batch(batch)
        peng.save_checkpoint(str(d / "port"))
        out[gas] = dict(dir=d)
        if gas == 1:
            out[gas]["jnext"] = [float(jeng.train_batch(batch)) for _ in range(3)]
            out[gas]["pnext"] = [float(peng.train_batch(batch)) for _ in range(3)]
            out[gas]["jload"] = jeng.load_checkpoint(str(d / "port"))
            out[gas]["jsteps"] = jeng.global_steps
            out[gas]["jfromport"] = [float(jeng.train_batch(batch)) for _ in range(3)]
    return out


@pytest.mark.parametrize("gas", [1, 2])
def test_port_tag_matches_the_jax_tag(twin_tags, gas):
    d = twin_tags[gas]["dir"]
    jm, pm = _meta(d / "jax", "global_step2"), _meta(d / "port", "global_step2")
    assert pm["keys"] == jm["keys"]
    assert pm["shapes"] == jm["shapes"] and pm["dtypes"] == jm["dtypes"]
    assert pm["num_shard_files"] == jm["num_shard_files"] == 0
    assert pm["client_state"] == jm["client_state"]
    assert any(k.startswith("grad_acc/") for k in jm["keys"]) == (gas > 1)
    assert _headers(d / "port", "global_step2") == _headers(d / "jax", "global_step2")
    jl, pl = _leaves(d / "jax", "global_step2"), _leaves(d / "port", "global_step2")
    for k in jm["keys"]:
        assert jl[k].dtype == pl[k].dtype and jl[k].shape == pl[k].shape, k
        if k.startswith(("params/", "opt/master/")):
            d = np.abs(pl[k] - jl[k])
            off = int((d > TOL + TOL * np.abs(jl[k])).sum())
            assert off <= max(1, jl[k].size // 10 ** 4), (k, off, d.max())
            assert d.max() <= 2 * ADAMW["params"]["lr"] * 2, (k, d.max())


def test_jax_tag_loads_into_the_port(twin_tags):
    t = twin_tags[1]
    eng = _port_engine(CFG, seed=5)
    tag, client = eng.load_checkpoint(str(t["dir"] / "jax"))
    assert tag == "global_step2" and client["global_steps"] == 2
    assert eng.global_steps == 2 and eng.opt_state["step"] == 2
    got = [float(eng.train_batch(_batch())) for _ in range(3)]
    np.testing.assert_allclose(got, t["jnext"], rtol=TOL, atol=0)


def test_port_tag_loads_into_jax(twin_tags):
    t = twin_tags[1]
    tag, client = t["jload"]
    assert tag == "global_step2" and client["global_steps"] == 2 and t["jsteps"] == 2
    np.testing.assert_allclose(t["jfromport"], t["pnext"], rtol=TOL, atol=0)


def test_bf16_jax_tag_loads_bitwise(tmp_path):
    jeng = _jax_engine(BF16)
    jeng.train_batch(_batch(1))
    jeng.save_checkpoint(str(tmp_path / "jax"))
    eng = _port_engine(BF16, seed=5)
    eng.load_checkpoint(str(tmp_path / "jax"))
    # the port's own tag of what it loaded holds the same bytes, leaf for leaf
    eng.save_checkpoint(str(tmp_path / "port"))
    want, got = _leaves(tmp_path / "jax", "global_step1"), _leaves(tmp_path / "port",
                                                                    "global_step1")
    meta = _meta(tmp_path / "port", "global_step1")
    assert want.keys() == got.keys()
    assert "bfloat16" in meta["dtypes"].values()
    assert _headers(tmp_path / "port", "global_step1") == _headers(tmp_path / "jax",
                                                                   "global_step1")
    for k in want:
        assert want[k].dtype.str == got[k].dtype.str and want[k].tobytes() == got[k].tobytes(), k
    sd = params_from_jax({"wte": {"embedding": want["params/wte/embedding"]}})
    assert torch.equal(eng.module_state_dict()["wte.weight"], sd["wte.weight"])


# -- (e) resume in the port ---------------------------------------------------------------


@pytest.mark.parametrize("cfg", [CFG, BF16], ids=["fp32", "bf16"])
def test_resume_in_the_port_is_bitwise(tmp_path, cfg):
    batch = _batch(2, B=2)
    a = _port_engine(cfg, seed=1)
    for _ in range(2):
        a.train_batch(batch)
    a.save_checkpoint(str(tmp_path))
    want = [float(a.train_batch(batch)) for _ in range(2)]
    b = _port_engine(cfg, seed=2)
    assert b.load_checkpoint(str(tmp_path))[0] == "global_step2"
    got = [float(b.train_batch(batch)) for _ in range(2)]
    assert got == want
    _same_params(_params(a), _params(b))

    c = _port_engine(cfg, seed=3)
    c.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert c.opt_state["step"] == 0 and c.global_steps == 2
    for n, p in c.module_state_dict().items():
        assert torch.equal(c.opt_state["master"][n], p.float()), n
        assert not c.opt_state["exp_avg"][n].any() and not c.opt_state["exp_avg_sq"][n].any()


# -- (f) durability ------------------------------------------------------------------------


def _tiny_staged(value=1.0):
    a = np.full((4, 3), value, np.float32)
    return store.Staged(["params/w"], {"params/w": "float32"}, {"params/w": [4, 3]},
                        {"leaf_0": a})


def test_a_failed_write_leaves_the_old_bytes_and_no_temp_file(tmp_path, monkeypatch):
    store.write_staged(str(tmp_path), "t", _tiny_staged(1.0), {})
    old = (tmp_path / "t" / "state.npz").read_bytes()

    def refuse(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(store.os, "replace", refuse)
    monkeypatch.setattr(store.time, "sleep", lambda s: None)
    with pytest.raises(OSError, match="after 4 attempts"):
        store.write_staged(str(tmp_path), "t", _tiny_staged(2.0), {})
    assert (tmp_path / "t" / "state.npz").read_bytes() == old
    assert not [p for p in tmp_path.rglob("*") if ".tmp" in p.name]


def test_writes_retry_with_backoff(tmp_path, monkeypatch):
    calls, delays = [], []
    savez = np.savez

    def flaky(path, **arrays):
        calls.append(path)
        if len(calls) <= 2:
            raise OSError("transient")
        savez(path, **arrays)

    monkeypatch.setattr(store.np, "savez", flaky)
    monkeypatch.setattr(store.time, "sleep", delays.append)
    store.write_staged(str(tmp_path), "t", _tiny_staged(3.0), {})
    assert len(calls) == 3 and delays == [store.BACKOFF_S, 2 * store.BACKOFF_S]
    assert all(c.endswith(".tmp.npz") for c in calls)
    assert store.verify_tag(str(tmp_path / "t")) == (True, "ok")
    with np.load(tmp_path / "t" / "state.npz") as z:
        assert (z["leaf_0"] == 3.0).all()


def _flip_a_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def _three_tags(d):
    for i, tag in enumerate(("t1", "t2", "t3")):
        store.write_staged(str(d), tag, _tiny_staged(float(i)), {"global_steps": i})
        time.sleep(0.01)   # distinct commit times order the fallback


def test_a_torn_state_fails_verification(tmp_path):
    _three_tags(tmp_path)
    _flip_a_byte(tmp_path / "t3" / "state.npz")
    ok, reason = store.verify_tag(str(tmp_path / "t3"))
    assert not ok and "checksum mismatch" in reason
    (tmp_path / "t2" / "state.npz").unlink()
    assert store.verify_tag(str(tmp_path / "t2")) == (False, "missing data file state.npz")


def test_a_corrupt_latest_falls_back_to_the_pin_then_the_newest(tmp_path):
    _three_tags(tmp_path)
    _flip_a_byte(tmp_path / "t3" / "state.npz")
    store.pin_known_good(str(tmp_path), "t1")
    assert store.resolve_tag(str(tmp_path), None) == ("t1", False)
    (tmp_path / store.KNOWN_GOOD_FILE).unlink()
    assert store.resolve_tag(str(tmp_path), None) == ("t2", False)
    _flip_a_byte(tmp_path / "t2" / "state.npz")
    _flip_a_byte(tmp_path / "t1" / "state.npz")
    with pytest.raises(RuntimeError, match="refusing to re-initialize"):
        store.resolve_tag(str(tmp_path), None)


def test_rollback_repoints_latest_at_a_verified_pin(tmp_path):
    _three_tags(tmp_path)
    assert store.rollback_to_known_good(str(tmp_path)) is None   # nothing pinned
    store.pin_known_good(str(tmp_path), "t1")
    assert store.rollback_to_known_good(str(tmp_path)) == "t1"
    assert (tmp_path / "latest").read_text() == "t1"
    store.write_latest(str(tmp_path), "t3")
    _flip_a_byte(tmp_path / "t1" / "state.npz")
    assert store.rollback_to_known_good(str(tmp_path)) is None   # the pin no longer verifies
    assert (tmp_path / "latest").read_text() == "t3"


@pytest.mark.parametrize("engine", ["npz", "async"])
def test_checkpoint_engines_save_and_load(tmp_path, engine):
    from deepspeed_tpu_torch.checkpoint import AsyncCheckpointEngine, NpzCheckpointEngine
    eng = NpzCheckpointEngine() if engine == "npz" else AsyncCheckpointEngine()
    a = {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "s": np.asarray(3, np.int32)}
    eng.save(a, str(tmp_path / "sub" / "part"))
    a["x"][0, 0] = 99.0   # the async engine copied the arrays when save returned
    assert eng.commit("t")
    got = eng.load(str(tmp_path / "sub" / "part.npz"))
    assert got["x"][0, 0] == 0.0 and int(got["s"]) == 3
    assert not [p for p in tmp_path.rglob("*") if ".tmp" in p.name]
    if engine == "async":
        eng.close()


def test_an_explicit_corrupt_tag_raises(tmp_path):
    _three_tags(tmp_path)
    _flip_a_byte(tmp_path / "t2" / "state.npz")
    with pytest.raises(ValueError, match="t2' failed verification"):
        store.resolve_tag(str(tmp_path), "t2")
    assert store.resolve_tag(str(tmp_path), "never") == (None, True)
    assert store.resolve_tag(str(tmp_path / "empty"), None) == (None, True)


def test_keep_last_n_never_retires_latest_the_pin_or_the_new_tag(tmp_path):
    eng = _port_engine(dict(CFG, checkpoint={"keep_last_n": 1}), seed=1)
    d = str(tmp_path)
    eng.save_checkpoint(d, tag="a")
    store.pin_known_good(d, "a")
    for tag in ("b", "c"):
        time.sleep(0.01)
        eng.save_checkpoint(d, tag=tag)
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == ["a", "c"]
    time.sleep(0.01)
    eng.save_checkpoint(d, tag="d", save_latest=False)
    # latest (c), the pin (a) and the tag just written (d) all stay
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == ["a", "c", "d"]
    assert (tmp_path / "latest").read_text() == "c"


# -- (g) the async commit fence ------------------------------------------------------------


def test_async_save_commits_latest_last_and_a_load_waits(tmp_path, monkeypatch):
    eng = _port_engine(dict(CFG, checkpoint={"async_save": True}), seed=1)
    batch = _batch(3, B=2)
    eng.train_batch(batch)
    gate, order = threading.Event(), []
    savez, replace = np.savez, os.replace

    def gated(path, **arrays):
        assert gate.wait(60)
        savez(path, **arrays)

    def recorded(src, dst):
        order.append(os.path.basename(dst))
        replace(src, dst)

    monkeypatch.setattr(store.np, "savez", gated)
    monkeypatch.setattr(store.os, "replace", recorded)
    saved = _params(eng)
    eng.save_checkpoint(str(tmp_path))
    # save_checkpoint returned with every tensor staged in host memory: a
    # step now does not reach the tag, which is not committed yet
    eng.train_batch(batch)
    assert not (tmp_path / "latest").exists()
    result = {}
    loader = _port_engine(dict(CFG, checkpoint={"async_save": True}), seed=2)
    # the same engine's load commits its own pending save first
    t = threading.Thread(target=lambda: result.update(tag=eng.load_checkpoint(str(tmp_path))))
    t.start()
    time.sleep(0.3)
    assert t.is_alive()
    gate.set()
    t.join(60)
    assert not t.is_alive() and result["tag"][0] == "global_step1"
    assert order == ["state.npz", "meta.json", "latest"]
    loader.load_checkpoint(str(tmp_path))
    _same_params(_params(loader), saved)
    _same_params(_params(eng), saved)
    eng.checkpoint_engine.close()
    loader.checkpoint_engine.close()


# -- (h) config ----------------------------------------------------------------------------


def test_checkpoint_config_block():
    cfg = deepspeed_tpu_torch.DeepSpeedConfig({"checkpoint": {"async_save": True,
                                                              "keep_last_n": 3}})
    assert cfg.checkpoint_config == {"async_save": True, "keep_last_n": 3}


@pytest.mark.parametrize("key,value", [("escalation_dir", "/ckpt"),
                                       ("escalation_save_timeout_s", 30.0)])
def test_checkpoint_escalation_keys_raise(key, value):
    with pytest.raises(NotImplementedError, match="A12"):
        deepspeed_tpu_torch.DeepSpeedConfig({"checkpoint": {key: value}})


# -- (i) the offline tools ------------------------------------------------------------------


@pytest.mark.parametrize("source", ["jax", "port"])
def test_offline_tools_agree(twin_tags, tmp_path, source):
    d = str(twin_tags[1]["dir"] / source)
    want, got = (jax_fp32.get_fp32_state_dict_from_zero_checkpoint(d),
                 port_fp32.get_fp32_state_dict_from_zero_checkpoint(d))
    assert want.keys() == got.keys() and len(got) == 12
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_j = jax_universal(d, str(tmp_path / "jax"))
    n_p = port_universal(d, str(tmp_path / "port"))
    assert n_j == n_p == 48
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npy"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.npy"))
    for f in files:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f))
    want, got = (jax_load_universal(str(tmp_path / "jax")),
                 port_load_universal(str(tmp_path / "port")))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port_fp32.main([d, str(tmp_path / "fp32.npz")])
    with np.load(tmp_path / "fp32.npz") as z:
        np.testing.assert_array_equal(z["wte.embedding"], want["wte.embedding"])


# -- ZeRO: rank files at world 2 ----------------------------------------------------------

ZERO3 = {"stage": 3, "stage3_param_persistence_threshold": 1000}

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
inputs = dict(np.load(workdir + "/inputs.npz"))
batch = {"input_ids": inputs["batch"]}


def engine(zero, seed):
    cfg = dict(spec["config"], zero_optimization=zero)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=llama_model("llama2-tiny", dtype=torch.float32), config=cfg,
        device="cpu", seed=seed)
    assert type(eng).__name__ == "DataParallelEngine"
    return eng


out = {}
saver = engine(spec["zero3"], 0)
for _ in range(2):
    saver.train_batch(batch)
saver.save_checkpoint(workdir + "/zero3")
for k, v in saver.module_state_dict().items():
    out["saved::" + k] = v.numpy().copy()
out["shards"] = np.array(len(saver.param_shards))
stage1 = engine({"stage": 1}, 5)
out["stage1_tag"] = np.array(stage1.load_checkpoint(workdir + "/zero3")[0])
for k, v in stage1.module_state_dict().items():
    out["stage1::" + k] = v.numpy().copy()
stage3 = engine(spec["zero3"], 6)
stage3.load_checkpoint(workdir + "/single")
for k, v in stage3.module_state_dict().items():
    out["from_single::" + k] = v.numpy().copy()
out["from_single_losses"] = np.array([float(stage3.train_batch(batch)) for _ in range(2)])
np.savez(workdir + f"/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def zero_world(tmp_path_factory):
    """A stage-3 world of 2 saves rank files (2 steps) and loads them at
    stage 1; it also loads a single-device tag at stage 3. The single
    device's tag and next losses come from the parent."""
    workdir = tmp_path_factory.mktemp("ckpt_world")
    batch = _batch(5)
    single = _port_engine(CFG, seed=1)
    for _ in range(3):
        single.train_batch(batch)
    single.save_checkpoint(str(workdir / "single"))
    single_params = _params(single)
    single_next = [float(single.train_batch(batch)) for _ in range(2)]
    np.savez(workdir / "inputs.npz", batch=batch["input_ids"])
    (workdir / "spec.py").write_text(repr({"config": dict(CFG, train_micro_batch_size_per_gpu=4),
                                           "zero3": ZERO3}))
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
    ranks = [dict(np.load(workdir / f"out{r}.npz")) for r in range(2)]
    return dict(dir=workdir, ranks=ranks, single_params=single_params, single_next=single_next)


def _group(out, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in out.items() if k.startswith(prefix)}


def test_zero3_rank_files_follow_the_jax_multi_host_form(zero_world):
    d = zero_world["dir"] / "zero3" / "global_step2"
    with open(d / "meta.json") as f:
        meta = json.load(f)
    assert meta["num_shard_files"] == 2 and set(meta["checksums"]) == {"state.rank0.npz",
                                                                        "state.rank1.npz"}
    assert not list(d.glob("*.crc")) and not (d / "state.npz").exists()
    assert store.verify_tag(str(d)) == (True, "ok")
    pieces = []
    for r in range(2):
        with np.load(d / f"state.rank{r}.npz") as z:
            pieces += [(r, k, z[k].shape) for k in z.files]
    count = {k: np.zeros(s, np.int64) for k, s in meta["shapes"].items()}
    sharded = set()
    for r, key, shape in pieces:
        head, _, spans = key.partition("__")
        leaf = meta["keys"][int(head[len("leaf_"):])]
        if spans == "full":
            assert r == 0 and meta["shapes"][leaf] == [] and shape == ()
            count[leaf] += 1
            continue
        bounds = [tuple(map(int, s.split("_"))) for s in spans.split("__")]
        assert [b - a for a, b in bounds] == list(shape), key
        if any(b - a != n for (a, b), n in zip(bounds, meta["shapes"][leaf])):
            sharded.add(leaf)
        else:
            assert r == 0, key   # a whole leaf lives in rank 0's file alone
        count[leaf][tuple(slice(a, b) for a, b in bounds)] += 1
    assert all((c == 1).all() for c in count.values())
    # stage 3: the large params, the master and the moments are sharded
    assert "params/blocks/gate_proj/kernel" in sharded
    assert "opt/exp_avg_sq/wte/embedding" in sharded
    assert "params/ln_f/scale" not in sharded   # below the persistence threshold
    assert int(zero_world["ranks"][0]["shards"]) > 0


def test_zero3_tag_loads_at_stage1_in_one_device_and_in_jax(zero_world):
    ranks = zero_world["ranks"]
    saved = _group(ranks[0], "saved::")
    _same_params(_group(ranks[1], "saved::"), saved)
    for r in ranks:
        assert str(r["stage1_tag"]) == "global_step2"
        _same_params(_group(r, "stage1::"), saved)
    one = _port_engine(CFG, seed=3)
    one.load_checkpoint(str(zero_world["dir"] / "zero3"))
    _same_params(_params(one), saved)
    jeng = _jax_engine(CFG, seed=8)
    assert jeng.load_checkpoint(str(zero_world["dir"] / "zero3"))[0] == "global_step2"
    _same_params(params_from_jax(jax.device_get(jeng.state["params"])), saved)


def test_single_device_tag_loads_at_world2_stage3(zero_world):
    for r in zero_world["ranks"]:
        _same_params(_group(r, "from_single::"), zero_world["single_params"])
        np.testing.assert_allclose(r["from_single_losses"], zero_world["single_next"],
                                   rtol=TOL, atol=0)
