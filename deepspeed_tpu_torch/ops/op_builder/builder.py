"""Build registry of the port's CUDA kernels: compile the sources in
``deepspeed_tpu_torch/csrc`` and load them with ``ctypes``.

Counterpart of ``deepspeed_tpu/ops/op_builder/builder.py``. ``KERNELS`` lists
every kernel source; each ``csrc/<name>.cu`` compiles on its own, with
``nvcc`` for ``sm_90a``, into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds):
``build/deepspeed_tpu_torch/lib<name>-<hash>.so`` at the root of the
checkout. The hash covers every source in ``csrc`` and the compiler flags,
so an edited source never loads a stale library. Builds happen at first
use; ``build()`` compiles several sources at once, one ``nvcc`` process
each.

Nothing here runs at import time, and nothing imports this module until a
kernel is launched on a CUDA tensor: the CPU tests never touch it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT.parent / "build" / "deepspeed_tpu_torch"
KERNELS = ("ragged_paged_attention", "paged_decode", "flash_fwd", "flash_bwd",
           "fused_adam", "fused_lion", "woq_matmul", "moe_route", "moe_dispatch",
           "moe_ffn", "quant_rows")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "toolkit is needed to build the port's kernels")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS, csrc: Path = CSRC) -> Dict[str, dict]:
    """Compile every named kernel of ``csrc`` whose library is missing, all
    ``nvcc`` processes started together. Returns ``{name: {"seconds", "log"}}`` for
    the ones compiled (``-Xptxas -v`` register and shared-memory report in
    ``log``); raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done: Dict[str, dict] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the launch plans
    size their grids by it."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
