"""Boundaries of the port: ``deepspeed_tpu_torch`` imports neither JAX,
``deepspeed_tpu`` nor ``ml_dtypes`` (bf16 travels as its bits), its entry
points default to CUDA and raise without it, and ``chip_smoke.py`` fails
(no result line) without a GPU or outside a checkout, as ``kernel_ab.py``
fails without a GPU."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu", "ml_dtypes")


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_import_pulls_in_no_jax():
    """Every module of the package, imported in a fresh interpreter, adds no
    JAX and no ``deepspeed_tpu`` module to ``sys.modules``."""
    names = [n for n, _ in _modules()]
    code = ("import sys, importlib\n"
            "before = set(sys.modules)\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "new = set(sys.modules) - before\n"
            f"bad = sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_scans_cover_the_sequence_parallel_modules():
    """The two scans above walk the whole package; the sequence-parallel
    modules (and the topology and collectives they run on) are among the
    modules they import and read."""
    names = {n for n, _ in _modules()}
    assert {"deepspeed_tpu_torch.sequence", "deepspeed_tpu_torch.sequence.layer",
            "deepspeed_tpu_torch.sequence.ring_attention",
            "deepspeed_tpu_torch.runtime.topology", "deepspeed_tpu_torch.comm.comm",
            "deepspeed_tpu_torch.ops.quantizer.quantizer"} <= names


def test_no_jax_import_in_source():
    """AST scan: no ``import jax`` / ``from deepspeed_tpu...`` anywhere in
    the package, ``chip_smoke.py`` or ``kernel_ab.py`` (relative imports
    stay inside)."""
    files = [p for _, p in _modules()] + [REPO / "chip_smoke.py",
                                          REPO / "kernel_ab.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad = [a.name for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                bad = [node.module] if _forbidden(node.module or "") else []
            else:
                continue
            assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_build_engine_without_gpu_raises(monkeypatch):
    from deepspeed_tpu_torch import resolve_device
    from deepspeed_tpu_torch.inference.v2 import build_engine
    from deepspeed_tpu_torch.models import llama_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine(llama_model("llama2-tiny", dtype=torch.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_is_not_imported_on_the_cpu_path():
    """The CPU path never loads the nvcc builder: a fresh interpreter that
    serves a wave and takes a training step on the CPU has no
    ``op_builder.builder`` module afterwards."""
    code = (
        "import sys, numpy as np, torch\n"
        "from deepspeed_tpu_torch.inference.v2 import build_engine, "
        "RaggedInferenceEngineConfig\n"
        "from deepspeed_tpu_torch.models import llama_model\n"
        "cfg = RaggedInferenceEngineConfig(num_kv_blocks=9, "
        "kv_cache_dtype=torch.float32)\n"
        "eng = build_engine(llama_model('llama2-tiny', dtype=torch.float32), "
        "cfg, device='cpu')\n"
        "eng.put([1], [np.arange(5)])\n"
        "import deepspeed_tpu_torch as dst\n"
        "t, *_ = dst.initialize(model=llama_model('llama2-tiny', dtype=torch.float32), "
        "config={'train_micro_batch_size_per_gpu': 2}, device='cpu')\n"
        "t.train_batch({'input_ids': np.arange(32).reshape(2, 16)})\n"
        "mod = 'deepspeed_tpu_torch.ops.op_builder.builder'\n"
        "sys.exit(1 if mod in sys.modules else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_checkout(tmp_path, alone):
    """Without a GPU, and in a directory holding only the script, the run
    exits non-zero and prints no result line."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_ab_fails_without_gpu():
    csrc = str(PACKAGE / "csrc")
    out = subprocess.run([sys.executable, "kernel_ab.py", csrc, csrc], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_kernel_library_is_keyed_by_its_sources(tmp_path):
    """An edited kernel source gets a new library name, so a stale build is
    never loaded; an identical copy of the sources shares the library."""
    from deepspeed_tpu_torch.ops.op_builder import builder as _build
    copy = tmp_path / "csrc"
    shutil.copytree(PACKAGE / "csrc", copy)
    name = "ragged_paged_attention"
    assert _build.library_path(name, copy) == _build.library_path(name)
    (copy / "paged_attention_common.cuh").write_text(
        (copy / "paged_attention_common.cuh").read_text() + "\n")
    assert _build.library_path(name, copy) != _build.library_path(name)
    assert _build.library_path(name).parent == _build.BUILD_DIR
    assert all((PACKAGE / "csrc" / f"{k}.cu").exists() for k in _build.KERNELS)
