"""The decode burst as a CUDA graph of one decode step.

Counterpart of the JAX engine's ``_burst_fns`` cache
(``deepspeed_tpu/inference/v2/engine_v2.py:746-777``), which jits the whole
burst, a ``lax.scan`` of K steps, once per key ``(B, mp, num_steps)``.
Here the unit is ONE step (``RaggedInferenceModel.decode_step``), captured
into a ``torch.cuda.CUDAGraph`` once per key ``(B_bucket, mp, sampled)``
and replayed K times a burst. K is not in the key: the scheduler picks K
from the powers of two up to ``decode_burst`` (``scheduler.py``
``_try_decode_burst``), and a graph a K would multiply the captures. The
step carries the tokens, the positions and the step index on the device
and writes each step's token into the state's history, so the host copies
the burst's tokens back once, as the JAX burst does.

- **Capture at first use** of a key, as ``jax.jit`` compiles at first use,
  on one capture stream that the ``DecodeGraphs`` owns. The step is first
  run once eagerly on that stream: that run is the burst's real first step
  (it builds the kernels, sets their attributes and allocates their
  scratch outside the capture), and the capture, which executes nothing,
  follows it; the graph then replays steps 2..K. No dummy step ever writes
  into live pages.
- **Memory.** All graphs of one ``DecodeGraphs`` share one memory pool
  (``torch.cuda.graph_pool_handle``); they replay one at a time, in one
  stream's order. Each graph reads and writes its key's ``DecodeState``,
  allocated outside the pool and kept alive with it, the KV pool and the
  weights, which never move. The kernels' scratch that a graph captured is
  never freed or moved while the process lives (``paged_decode._scratch``,
  ``woq_matmul._tile_counters``).
- **Sampling.** One ``torch.Generator`` a ``DecodeGraphs``, reseeded every
  burst and registered with every sampled graph
  (``CUDAGraph.register_generator_state``), so each replay draws fresh
  uniforms from the seed's stream.
- **Launch accounting.** The kernels' Python ``launches`` counters move
  only where Python launches a kernel, and a replay runs no Python. A
  capture records the counters' deltas and undoes them (the captured
  launches have not run); each replay adds the deltas (``LaunchCounts``).
- **ALiBi and windows.** A step reads the model's ALiBi slopes from one
  device tensor that never moves (``TransformerLM.alibi``) and passes each
  layer's window as a launch argument; a capture keeps both as they are.
- **No fallback.** A capture or a replay that fails raises; there is no
  switch that turns graphs off. On the CPU the same ``decode_step`` runs
  eagerly K times (``StepGraph`` raises for a device other than CUDA).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.quantizer import woq_matmul
from ...ops.transformer import moe
from .kernels import paged_decode
from .model import DecodeState, RaggedInferenceModel

Counter = Tuple[object, str]
#: the ``launches`` counters of the kernels a decode step can launch, as
#: (holder, attribute name) pairs: an int or a dict of ints
DECODE_STEP_COUNTERS: List[Counter] = [(paged_decode, "launches"), (woq_matmul, "launches"),
                                       (moe, "launches")]


class LaunchCounts:
    """Reads, diffs and adds to a set of launch counters. A dict counter is
    updated in place, so a reader holding the dict sees every change."""

    def __init__(self, counters: Sequence[Counter]):
        self.counters = list(counters)

    def snapshot(self) -> list:
        return [dict(v) if isinstance(v, dict) else v
                for v in (getattr(o, a) for o, a in self.counters)]

    def delta(self, before: list) -> list:
        """The change of every counter since ``before``."""
        out = []
        for now, was in zip(self.snapshot(), before):
            out.append({k: v - was.get(k, 0) for k, v in now.items()}
                       if isinstance(now, dict) else now - was)
        return out

    def add(self, delta: list, times: int = 1) -> None:
        for (obj, attr), d in zip(self.counters, delta):
            value = getattr(obj, attr)
            if isinstance(value, dict):
                for k, v in d.items():
                    value[k] = value.get(k, 0) + times * v
            else:
                setattr(obj, attr, value + times * d)


class StepGraph:
    """One captured call of ``step`` on CUDA, replayed on the current
    stream. ``counts``' deltas over the capture are undone at once and
    added back at every replay. A ``generator`` the step draws from is
    registered with the graph."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 stream: "torch.cuda.Stream", pool, counts: LaunchCounts,
                 generator: Optional[torch.Generator] = None):
        if device.type != "cuda":
            raise RuntimeError(f"a CUDA graph captures work on a CUDA device, not {device}")
        self.counts = counts
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:       # each replay draws from its current state
            self.graph.register_generator_state(generator)
        before = counts.snapshot()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            step()
        self.delta = counts.delta(before)
        counts.add(self.delta, times=-1)

    def replay(self) -> None:
        self.graph.replay()
        self.counts.add(self.delta)


class DecodeGraphs:
    """The engine's decode bursts: one ``DecodeState`` and, on CUDA, one
    ``StepGraph`` of ``model.decode_step`` a key ``(B, mp, sampled)``.
    ``width`` is the history a state holds: a burst of more steps runs in
    chunks of ``width`` replays, each chunk's tokens gathered on the
    device. Counts its ``captures`` (and their host seconds,
    ``capture_s``, the eager first step included) and ``replays``."""

    def __init__(self, model: RaggedInferenceModel, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, width: int):
        self.model, self.k_pages, self.v_pages = model, k_pages, v_pages
        self.device = k_pages.device
        self.width = max(1, width)
        self.generator = torch.Generator(device=self.device)
        self.counts = LaunchCounts(DECODE_STEP_COUNTERS)
        self._states: Dict[tuple, DecodeState] = {}
        self._graphs: Dict[tuple, StepGraph] = {}
        self._graphed = self.device.type == "cuda"
        if self._graphed:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        self.captures, self.capture_s, self.replays = 0, 0.0, 0

    def _step(self, state: DecodeState, sampled: bool) -> None:
        self.model.decode_step(self.k_pages, self.v_pages, state, sampled, self.generator)

    def _capture(self, key: tuple, state: DecodeState) -> None:
        """The first step of a key's first burst, run eagerly on the capture
        stream, then captured there."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            self._step(state, key[2])
        self._graphs[key] = StepGraph(
            lambda: self._step(state, key[2]), self.device, self._stream, self._pool,
            self.counts, self.generator if key[2] else None)
        cur.wait_stream(self._stream)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    @torch.inference_mode()
    def run(self, tokens: np.ndarray, positions: np.ndarray, tables: np.ndarray,
            temperatures: np.ndarray, num_steps: int, seed: int) -> np.ndarray:
        """``num_steps`` decode steps of the rows of ``tables [B, mp]`` from
        the host arrays of the burst; returns the tokens ``[B, num_steps]``
        (int64) after one copy to the host."""
        B, mp = tables.shape
        sampled = bool((np.asarray(temperatures) > 0).any())
        key = (B, mp, sampled)
        state = self._states.get(key)
        if state is None:
            state = self._states[key] = DecodeState.empty(B, mp, self.width, self.device)
        state.load(tokens, positions, tables, temperatures)
        self.generator.manual_seed(seed)
        out = torch.empty(B, num_steps, dtype=torch.int64, device=self.device)
        for start in range(0, num_steps, self.width):
            n = min(self.width, num_steps - start)
            state.k.zero_()
            for _ in range(n):
                graph = self._graphs.get(key)
                if not self._graphed:
                    self._step(state, sampled)
                elif graph is None:
                    self._capture(key, state)
                else:
                    graph.replay()
                    self.replays += 1
            out[:, start:start + n] = state.hist[:, :n]
        return out.cpu().numpy()
