"""Pluggable checkpoint engines.

Counterpart of ``deepspeed_tpu/checkpoint/checkpoint_engine.py``: the
synchronous npz engine, and a write-behind engine whose saves run on a
worker thread while training goes on; ``commit`` is the fence that waits
for them.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class CheckpointEngine:
    """Interface: create / save / load / commit."""

    def create(self, tag: str) -> None:
        """Signal the start of a new checkpoint under ``tag``."""

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        """Make ``tag`` durable; returns success."""
        return True

    def submit(self, tag: str, fn) -> Optional[Future]:
        """Run a whole checkpoint-write task. A synchronous engine runs it
        inline; the async engine queues it on its worker, where the task's
        own order (data, meta, ``latest``) is the commit fence."""
        fn()
        return None


class NpzCheckpointEngine(CheckpointEngine):
    """Synchronous npz persistence through the store's durable write (temp
    name, fsync, ``os.replace``, retries with backoff)."""

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        from .store import _atomic_savez
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not path.endswith(".npz"):
            path += ".npz"   # np.savez's own naming, kept
        _atomic_savez(path, state_dict)

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}


class AsyncCheckpointEngine(NpzCheckpointEngine):
    """Write-behind checkpoints: ``save`` copies the arrays and returns; the
    IO runs on a worker thread. ``commit`` blocks until every pending write
    has landed and reports whether all of them succeeded."""

    def __init__(self, num_threads: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        staged = {k: np.array(v, copy=True) for k, v in state_dict.items()}
        fut = self._pool.submit(super().save, staged, path)
        with self._lock:
            self._pending.append(fut)

    def submit(self, tag: str, fn) -> Future:
        """Queue a whole checkpoint-write task; the caller has staged every
        tensor in host memory already."""
        fut = self._pool.submit(fn)
        with self._lock:
            self._pending.append(fut)
        return fut

    def commit(self, tag: str) -> bool:
        with self._lock:
            pending, self._pending = self._pending, []
        ok = True
        for f in pending:
            try:
                f.result()
            except Exception:   # every pending write is waited for; the failure is reported
                logger.exception("async checkpoint write failed")
                ok = False
        return ok

    def close(self) -> None:
        self.commit("")
        self._pool.shutdown()
