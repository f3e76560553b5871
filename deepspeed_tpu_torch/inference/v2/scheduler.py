"""Disaggregated continuous-batching scheduler with SLA-aware admission.

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py``, with the same
admission, disaggregation, burst and preemption logic:

- every wave is composed from decode tokens of running sequences (first)
  and prefill chunks of queued requests (remaining token budget);
  ``mode="disaggregated"`` alternates decode-only and prefill-only waves at
  a share set by SLA pressure;
- when only decodes are pending, K tokens per sequence are fused into one
  ``engine.decode_burst`` (K a power of two chosen to maximize fused
  tokens);
- KV pressure preempts a running sequence: its KV is offloaded to host
  memory and restored when blocks free up, or (``kv_host_offload=False``)
  dropped and re-prefilled.

The JAX scheduler's telemetry records are not ported (ROADMAP A5); its
admission policy reads a local latency reservoir, copied here, with
``time.perf_counter`` as the clock.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class LatencyHistogram:
    """Bounded reservoir of the newest ``cap`` latency samples."""

    def __init__(self, cap: int = 4096):
        self._samples: deque = deque(maxlen=cap)

    def record(self, seconds: float) -> None:
        self._samples.append(float(seconds))

    def __len__(self) -> int:
        return len(self._samples)

    def percentiles(self, ps=(50, 90, 99)) -> Dict[str, float]:
        vals = sorted(self._samples)
        return {f"p{p}": _percentile(vals, p) for p in ps}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    # state
    prompt_consumed: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # how many generated tokens have been folded into `prompt` by preemption
    folded: int = 0
    # latency attribution (time.perf_counter() stamps; None = not yet)
    submit_s: float = 0.0
    first_sched_s: Optional[float] = None
    first_token_s: Optional[float] = None

    @property
    def prefill_remaining(self) -> int:
        return len(self.prompt) - self.prompt_consumed

    @property
    def queue_wait_s(self) -> float:
        return (self.first_sched_s - self.submit_s) \
            if self.first_sched_s is not None else 0.0


class ContinuousBatchingScheduler:

    def __init__(self, engine, token_budget: Optional[int] = None, seed: int = 0,
                 max_prefills_per_wave: Optional[int] = None,
                 kv_host_offload: bool = True,
                 mode: str = "auto",
                 ttft_sla_s: Optional[float] = None,
                 gen_sla_tok_s: Optional[float] = None):
        self.engine = engine
        self.token_budget = token_budget or engine.config.state_manager.max_ragged_batch_size
        self.kv_host_offload = kv_host_offload
        self._offloaded: List[Request] = []
        self.max_prefills_per_wave = max_prefills_per_wave or (1 << 30)
        if mode not in ("auto", "mixed", "disaggregated"):
            raise ValueError(f"mode must be auto|mixed|disaggregated, "
                             f"got {mode!r}")
        self.ttft_sla_s = ttft_sla_s
        self.gen_sla_tok_s = gen_sla_tok_s
        self.mode = ("disaggregated" if (ttft_sla_s or gen_sla_tok_s)
                     else "mixed") if mode == "auto" else mode
        # rolling wave-EXECUTE reservoir driving admission
        self._exec_hist = LatencyHistogram(cap=128)
        self._pf_credit = 0.0   # disaggregated prefill-wave accumulator
        self._uid_gen = itertools.count(1)
        self._queue: List[Request] = []       # waiting for / mid prefill
        self._running: List[Request] = []     # generating
        self._rng = np.random.default_rng(seed)

    # -- client API ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature: float = 0.0, eos_token_id: Optional[int] = None) -> Request:
        if len(prompt) >= self.engine.max_context:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit the "
                             f"engine's max context of {self.engine.max_context}")
        req = Request(uid=next(self._uid_gen), prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_token_id=eos_token_id, submit_s=time.perf_counter())
        self._queue.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._running or self._offloaded)

    def _sample(self, req: Request, logits: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits / max(req.temperature, 1e-6)
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self._rng.choice(len(p), p=p))

    def _finish(self, req: Request) -> None:
        req.done = True
        self.engine.flush(req.uid)

    def _preempt(self, req: Request) -> None:
        """KV pressure: page the sequence's KV to host memory and resume it
        later; with ``kv_host_offload=False`` drop it and requeue prompt +
        generated tokens for a re-prefill."""
        if self.kv_host_offload:
            ctx = len(req.prompt) + len(req.generated) - req.folded
            if ctx + 1 >= self.engine.max_context:
                # context capacity reached: no further token can ever fit
                self._finish(req)
                self._running.remove(req)
                return
            self.engine.offload_sequence(req.uid)
            self._running.remove(req)
            self._offloaded.append(req)
            return
        self.engine.flush(req.uid)
        self._running.remove(req)
        # fold only the not-yet-folded tail
        fresh = req.generated[req.folded:]
        req.prompt = np.concatenate([req.prompt, np.asarray(fresh, np.int32)])
        req.folded = len(req.generated)
        req.prompt_consumed = 0
        if len(req.prompt) >= self.engine.max_context:
            req.done = True
            return
        self._queue.insert(0, req)

    def _restore_offloaded(self) -> int:
        """Re-place stashed sequences whose KV fits again; returns how
        many. Headroom 1 block prevents restore->preempt thrash; with
        nothing else holding blocks, restore unconditionally."""
        n = 0
        for req in list(self._offloaded):
            headroom = 1 if (self._running or self._queue) else 0
            if self.engine.can_restore(req.uid, headroom=headroom):
                self.engine.restore_sequence(req.uid)
                self._offloaded.remove(req)
                self._running.append(req)
                n += 1
        return n

    # -- SLA policy ---------------------------------------------------------
    def _exec_p50(self) -> float:
        if not len(self._exec_hist):
            return 0.0
        return self._exec_hist.percentiles((50,))["p50"]

    def _gen_pressure(self) -> bool:
        """Generation SLA at risk: rolling p50 wave execute above the
        per-token latency the SLA allows."""
        if not self.gen_sla_tok_s or not self._running:
            return False
        p50 = self._exec_p50()
        return p50 > 0.0 and p50 > 1.0 / self.gen_sla_tok_s

    def _ttft_pressure(self, now: float) -> bool:
        """TTFT SLA at risk: the oldest not-yet-scheduled request has
        burned half its budget waiting."""
        if not self.ttft_sla_s:
            return False
        waits = [now - r.submit_s for r in self._queue
                 if r.first_sched_s is None]
        return bool(waits) and max(waits) > 0.5 * self.ttft_sla_s

    def _admit_new(self, now: float) -> bool:
        """Gen pressure freezes admission of NEW requests; TTFT pressure
        overrides the freeze."""
        if not self._gen_pressure():
            return True
        return self._ttft_pressure(now)

    def _wave_kind(self, now: float) -> str:
        """'mixed' | 'decode' | 'prefill'."""
        has_p = bool(self._queue)
        has_d = bool(self._running)
        if self.mode != "disaggregated" or not (has_p and has_d):
            return "mixed"
        share = 0.5
        if self._ttft_pressure(now):
            share = 1.0
        elif self._gen_pressure():
            share = 0.25
        self._pf_credit += share
        if self._pf_credit >= 1.0:
            self._pf_credit -= 1.0
            return "prefill"
        return "decode"

    # -- one engine step ----------------------------------------------------
    def _try_decode_burst(self):
        """When ONLY decodes are pending, fuse K tokens per sequence into
        one ``decode_burst``. Returns (tokens processed, K); (0, 0) = not
        applicable."""
        k_cfg = self.engine.config.decode_burst
        if self._queue or not self._running or k_cfg <= 1:
            return 0, 0
        remaining = {r.uid: r.max_new_tokens - len(r.generated)
                     for r in self._running}
        # powers of two, maximizing fused tokens k * |{remaining >= k}|
        candidates = []
        k = 2
        while k <= k_cfg:
            n = sum(1 for v in remaining.values() if v >= k)
            if n:
                candidates.append((k * n, k))
            k *= 2
        reqs, uids, k = [], [], 0
        for _, cand_k in sorted(candidates, reverse=True):
            cand_reqs = [r for r in self._running
                         if remaining[r.uid] >= cand_k]
            cand_uids = [r.uid for r in cand_reqs]
            if self.engine.can_burst(cand_uids, cand_k):
                reqs, uids, k = cand_reqs, cand_uids, cand_k
                break
        if k < 2:
            return 0, 0
        toks = self.engine.decode_burst(
            uids, [r.generated[-1] for r in reqs], k,
            temperatures=[r.temperature for r in reqs],
            seed=int(self._rng.integers(1 << 31)))
        for r, row in zip(reqs, toks):
            for tok in row:
                r.generated.append(int(tok))
                if ((r.eos_token_id is not None and tok == r.eos_token_id)
                        or len(r.generated) >= r.max_new_tokens):
                    self._finish(r)
                    self._running.remove(r)
                    break
        return len(reqs) * k, k

    def step(self, _retry: bool = True) -> int:
        """Run one composed wave; returns tokens processed."""
        w0 = time.perf_counter()
        self._restore_offloaded()
        burst, burst_k = self._try_decode_burst()
        if burst:
            # the reservoir reads as time per decode token per sequence
            self._exec_hist.record((time.perf_counter() - w0) / max(burst_k, 1))
            return burst
        kind_plan = self._wave_kind(w0)
        uids: List[int] = []
        tokens: List[np.ndarray] = []
        decode_reqs: List[Request] = []
        budget = self.token_budget

        # 1. decode tokens for running sequences, budgeted through
        #    can_schedule: crossing a block boundary with no free block
        #    preempts instead of failing put()
        if kind_plan != "prefill":
            for req in list(self._running):
                if budget <= 0:
                    break
                if not self.engine.can_schedule(uids + [req.uid],
                                                [len(t) for t in tokens] + [1]):
                    self._preempt(req)
                    continue
                uids.append(req.uid)
                tokens.append(np.asarray([req.generated[-1]], np.int32))
                decode_reqs.append(req)
                budget -= 1

        # 2. remaining budget -> prefill chunks, FIFO
        prefill_reqs: List[Request] = []
        if kind_plan != "decode":
            admit_new = self._admit_new(w0)
            for req in self._queue:
                if budget <= 0 or len(prefill_reqs) >= self.max_prefills_per_wave:
                    break
                if req.first_sched_s is None and not admit_new:
                    break  # FIFO: later arrivals must not jump the freeze
                take = min(budget, req.prefill_remaining)
                chunk = req.prompt[req.prompt_consumed:req.prompt_consumed + take]
                if not self.engine.can_schedule(uids + [req.uid],
                                                [len(t) for t in tokens] + [take]):
                    break
                if req.first_sched_s is None:
                    req.first_sched_s = time.perf_counter()
                uids.append(req.uid)
                tokens.append(chunk)
                prefill_reqs.append(req)
                budget -= take

        if not uids:
            # a disaggregated single-class wave may compose empty: fall
            # back to ONE mixed wave so the other class still drains
            if kind_plan != "mixed" and (self._running or self._queue
                                         or self._offloaded):
                self._pf_credit = 0.0
                return self._step_mixed_fallback(_retry)
            # a preempt may just have freed blocks an offloaded sequence
            # needs: retry once after a restore pass (0 means deadlock)
            if _retry and self._offloaded and self._restore_offloaded():
                return self.step(_retry=False)
            return 0

        logits = self.engine.put(uids, tokens)
        self._exec_hist.record(time.perf_counter() - w0)
        by_uid: Dict[int, np.ndarray] = dict(zip(uids, logits))

        for req in decode_reqs:
            tok = self._sample(req, by_uid[req.uid])
            req.generated.append(tok)
            if ((req.eos_token_id is not None and tok == req.eos_token_id)
                    or len(req.generated) >= req.max_new_tokens):
                self._finish(req)
                self._running.remove(req)

        for req in prefill_reqs:
            req.prompt_consumed += len(tokens[uids.index(req.uid)])
            if req.prefill_remaining == 0:
                tok = self._sample(req, by_uid[req.uid])
                req.generated.append(tok)
                if req.first_token_s is None:
                    req.first_token_s = time.perf_counter()
                self._queue.remove(req)
                if ((req.eos_token_id is not None and tok == req.eos_token_id)
                        or len(req.generated) >= req.max_new_tokens):
                    self._finish(req)
                else:
                    self._running.append(req)

        return sum(len(t) for t in tokens)

    def _step_mixed_fallback(self, _retry: bool) -> int:
        """One forced-mixed step (a disaggregated wave composed empty)."""
        mode, self.mode = self.mode, "mixed"
        try:
            return self.step(_retry=_retry)
        finally:
            self.mode = mode


def generate(engine, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
             temperature: float = 0.0, token_budget: Optional[int] = None,
             return_requests: bool = False):
    """Batch generation over the continuous-batching loop. Returns the
    generated token lists, or with ``return_requests`` the ``Request``
    objects (tokens in ``.generated``, ``submit_s`` / ``first_token_s``
    timestamps for time to first token)."""
    sched = ContinuousBatchingScheduler(engine, token_budget=token_budget)
    reqs = [sched.submit(p, max_new_tokens=max_new_tokens, temperature=temperature)
            for p in prompts]
    while sched.has_work:
        if sched.step() == 0:
            break
    return reqs if return_requests else [r.generated for r in reqs]
