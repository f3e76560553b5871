#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. card: the device's name and ``nvidia-smi`` name / power limit;
2. build: compile every kernel of the serving path from ``deepspeed_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) into ``build/``;
3. kernels vs plain: each CUDA kernel against its plain PyTorch version on
   the card, bf16, at llama2-7b shapes (prefill, mixed and decode waves from
   the port's own wave builder) and at GQA shapes, with its time, the plain
   version's time and the card's lower bound for the same work;
4. engine: llama2-7b at full width and depth, random bf16 weights from a
   seed, served through ``build_engine`` + ``generate`` (8 prompts, chunked
   prefill, mixed waves and decode bursts); the launch counters must show
   that the path ran through both kernels, every request must get its
   tokens, and one prompt's prefill logits must match the plain
   full-sequence ``TransformerLM.forward``; a second engine over the same
   weights with a small pool must preempt, offload to host memory and
   restore, and still produce every token;
5. profile: the same ``generate`` under ``torch.profiler``, device time by
   kernel and the device's busy share.

The output ends with a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line
and the result line ``{"ok": true, "device": {...}}``. Imports nothing of
JAX or ``deepspeed_tpu``; needs one CUDA device.
"""

import json
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
BF16_TOL = 2e-2      # bf16 atol = rtol, the JAX suite's bf16 kernel bound
FP32_TOL = 2e-5      # fp32 atol = rtol, the JAX suite's fp32 kernel bound
LOGIT_ERR_RATIO = 2.0  # serving vs plain-bf16 error, both against fp32
PROMPT_LENS = (512, 384, 300, 200, 130, 77, 33, 17)
NEW_TOKENS = 32
NUM_LAYERS = 32       # llama2-7b full depth
# preemption run: 4 requests that end at 8 blocks each against a pool of 20
PREEMPT_REQUESTS, PREEMPT_PROMPT, PREEMPT_NEW_TOKENS, PREEMPT_BLOCKS = 4, 64, 64, 21
SPIN_CYCLES = 400_000_000  # ~0.2 s of device spin behind each timing loop
PAGE_SIZE = 16
# kernel cases at llama2-7b shapes (kvH 32, g 1, D 128) and GQA shapes
WAVE_CASES = {
    # name: (seqs [(q_len, seen)], kvH, g, D)
    "prefill-2x256": ([(256, 0), (256, 0)], 32, 1, 128),
    "prefill-chunked": ([(256, 256), (44, 256), (256, 0)], 32, 1, 128),
    "mixed": ([(1, 543), (1, 416), (1, 331), (256, 256), (77, 0), (5, 11)], 32, 1, 128),
    "decode-8": ([(1, c) for c in (512, 384, 300, 200, 130, 77, 33, 17)], 32, 1, 128),
    "straddle": ([(6, 3), (5, 4), (9, 0), (1, 7), (20, 13)], 32, 1, 128),
    "gqa-g4-d128": ([(1, 543), (256, 256), (77, 0), (6, 3)], 8, 4, 128),
    "gqa-g8-d64": ([(1, 543), (256, 256), (77, 0), (6, 3)], 4, 8, 64),
}
DECODE_CASES = {
    # name: (context lengths, kvH, g, D)
    "decode-8-first-burst": ([513, 385, 301, 201, 131, 78, 34, 18], 32, 1, 128),
    "decode-8-straddle": ([1, 15, 16, 17, 33, 100, 257, 1000], 32, 1, 128),
    "gqa-g4-d128": ([513, 385, 301, 201, 131, 78, 34, 18], 8, 4, 128),
    "gqa-g8-d64": ([513, 385, 301, 201, 131, 78, 34, 18], 4, 8, 64),
}
MAIN_WAVE = "prefill-2x256"          # the shape of the engine run's first wave
MAIN_DECODE = "decode-8-first-burst"  # the engine run's first burst step


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_ms(torch, fn, iters, flush):
    """(device ms, host ms) per call of ``fn``, L2 flushed before each call.

    A spin kernel keeps the device busy while the host enqueues every
    (flush, event, fn, event) group, so each event pair brackets the
    device time of ``fn`` alone and none of the host time it takes to
    launch it; that host time is returned separately. Fails if the host
    outran the spin (the device would have idled between events)."""
    flush.zero_()   # first launches load their modules: keep them out
    fn()
    torch.cuda.synchronize()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    spin0, spin1 = ev(), ev()
    pairs = [(ev(), ev()) for _ in range(iters)]
    spin0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    spin1.record()
    t0 = time.perf_counter()
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= spin0.elapsed_time(spin1):
        fail(f"timing: host enqueue {host_ms:.1f} ms outlasted the device spin")
    return (sum(s.elapsed_time(e) for s, e in pairs) / iters, host_ms / iters)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, tol=BF16_TOL):
    err = (got.float() - want.float()).abs()
    lim = tol + tol * want.float().abs()
    if not bool(got.float().isfinite().all()) or bool((err > lim).any()):
        fail(f"{name}: kernel vs plain max |err| {err.max().item():.4g} "
             f"beyond {tol} + {tol}*|ref|")
    return err.max().item()


def as_fp32(args):
    return tuple(a.float() if a.is_floating_point() else a for a in args)


def wave_case(torch, build_wave, WaveEntry, seqs, kvH, g, D, ps, gen):
    """Inputs of one ragged wave: seqs [(q_len, seen)], disjoint pages per
    sequence, descriptors from the port's wave builder."""
    entries, nxt = [], 1
    for uid, (q_len, seen) in enumerate(seqs):
        nb = -(-(seen + q_len) // ps)
        entries.append(WaveEntry(uid, [0] * q_len, seen, list(range(nxt, nxt + nb))))
        nxt += nb
    desc = build_wave(entries, block_q=8, block_size=ps)
    dev, bf16 = "cuda", torch.bfloat16
    H = kvH * g
    P = nxt + 1
    k = torch.randn(kvH, P, ps, D, generator=gen, device=dev).to(bf16)
    v = torch.randn(kvH, P, ps, D, generator=gen, device=dev).to(bf16)
    q = torch.randn(len(desc.tokens), H, D, generator=gen, device=dev).to(bf16)
    t = lambda a: torch.from_numpy(a).to(dev)
    args = (q, k, v, t(desc.kv_lens), t(desc.page_indices), t(desc.cu_q_lens))
    n = desc.n_tokens
    kv_tokens = sum(seen + q_len for q_len, seen in seqs)
    pairs = sum(seen + t_ + 1 for q_len, seen in seqs for t_ in range(q_len))
    nbytes = (2 * n * H * D + 2 * kvH * kv_tokens * D) * 2 \
        + 4 * (desc.kv_lens.size * 2 + 1 + desc.page_indices.size)
    flops = 4 * pairs * H * D
    return args, n, nbytes, flops


def decode_case(torch, ctxs, kvH, g, D, ps, gen):
    dev, bf16 = "cuda", torch.bfloat16
    mp = max(-(-c // ps) for c in ctxs)
    tables, nxt = [], 1
    for c in ctxs:
        nb = -(-c // ps)
        tables.append(list(range(nxt, nxt + nb)) + [0] * (mp - nb))
        nxt += nb
    H = kvH * g
    k = torch.randn(kvH, nxt, ps, D, generator=gen, device=dev).to(bf16)
    v = torch.randn(kvH, nxt, ps, D, generator=gen, device=dev).to(bf16)
    q = torch.randn(len(ctxs), H, D, generator=gen, device=dev).to(bf16)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    tab = torch.tensor(tables, dtype=torch.int32, device=dev)
    nbytes = (2 * len(ctxs) * H * D + 2 * kvH * sum(ctxs) * D) * 2 \
        + 4 * (len(ctxs) + len(ctxs) * mp)
    flops = 4 * sum(ctxs) * H * D
    return (q, k, v, ctx, tab), nbytes, flops


def preemption_smoke(torch, build_engine, generate, config, model, seed=2):
    """A second engine over the same weights whose pool is too small for its
    batch: the scheduler preempts sequences, their KV goes to pinned host
    memory and comes back, and every request still gets all its tokens.
    Returns (offloads, restores)."""
    import numpy as np
    engine = build_engine(model, config, device=next(model.parameters()).device)
    offloads, restores = [], []
    off, res = engine.offload_sequence, engine.restore_sequence
    engine.offload_sequence = lambda uid: (offloads.append(uid), off(uid))[1]
    engine.restore_sequence = lambda uid: (restores.append(uid), res(uid))[1]
    rng = np.random.default_rng(seed)
    vocab = model.config.vocab_size
    prompts = [rng.integers(0, vocab, size=PREEMPT_PROMPT) for _ in range(PREEMPT_REQUESTS)]
    out = generate(engine, prompts, max_new_tokens=PREEMPT_NEW_TOKENS)
    if [len(o) for o in out] != [PREEMPT_NEW_TOKENS] * PREEMPT_REQUESTS:
        fail(f"preemption run token counts {[len(o) for o in out]}")
    if not offloads or sorted(restores) != sorted(offloads):
        fail(f"preemption run offloaded {offloads}, restored {restores}")
    return offloads, restores


def profile_generate(torch, generate, engine, prompts, wall):
    """Device time by kernel over one more ``generate`` of the same
    prompts, and the device's busy share of the unprofiled run's wall
    time (the profiler slows the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        generate(engine, prompts, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("[profile] device time not measured: the profiler recorded no "
              "CUDA kernels", flush=True)
        return
    print(f"[profile] device busy {busy_ms:.1f} ms of the unprofiled "
          f"generate's {wall * 1e3:.1f} ms wall: busy share "
          f"{busy_ms / (wall * 1e3):.3f}, idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"[profile]   {ms:9.2f} ms {ms / busy_ms:6.1%} x{e.count:6d} "
              f"{e.key[:90]}", flush=True)


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig,
        build_engine, generate)
    from deepspeed_tpu_torch.inference.v2.kernels import _build
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_decode_attention_reference
    from deepspeed_tpu_torch.inference.v2.ragged.wave import WaveEntry, build_wave
    from deepspeed_tpu_torch.models import llama_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {len(built)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 3. kernels vs plain
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for name, (seqs, kvH, g, D) in WAVE_CASES.items():
        args, n, nbytes, flops = wave_case(torch, build_wave, WaveEntry, seqs,
                                           kvH, g, D, PAGE_SIZE, gen)
        got = rpa.ragged_paged_attention(*args)
        want = rpa.ragged_paged_attention_reference(*args)
        torch.cuda.synchronize()
        err = check_close(f"ragged/{name}", got[:n], want[:n])
        f32 = as_fp32(args)
        err32 = check_close(f"ragged/{name} fp32", rpa.ragged_paged_attention(*f32)[:n],
                            rpa.ragged_paged_attention_reference(*f32)[:n], FP32_TOL)
        ms, host = device_ms(torch, lambda: rpa.ragged_paged_attention(*args), 20, flush)
        plain, _ = device_ms(torch, lambda: rpa.ragged_paged_attention_reference(*args),
                             5, flush)
        b_ms, b_by = bound(nbytes, flops, args[0].dtype)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                          bound_by=b_by)
        print(f"[ragged] {name}: tokens {n} max_abs_err {err:.3e} (fp32 "
              f"{err32:.3e}) kernel_ms {ms:.4f} "
              f"plain_ms {plain:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms null "
              f"wrapper_host_ms {host:.4f}",
              flush=True)
    drows = {}
    for name, (ctxs, kvH, g, D) in DECODE_CASES.items():
        args, nbytes, flops = decode_case(torch, ctxs, kvH, g, D, PAGE_SIZE, gen)
        got = pdk.paged_gqa_decode(*args)
        want = paged_decode_attention_reference(*args)
        torch.cuda.synchronize()
        err = check_close(f"decode/{name}", got, want)
        f32 = as_fp32(args)
        err32 = check_close(f"decode/{name} fp32", pdk.paged_gqa_decode(*f32),
                            paged_decode_attention_reference(*f32), FP32_TOL)
        ms, host = device_ms(torch, lambda: pdk.paged_gqa_decode(*args), 20, flush)
        plain, _ = device_ms(torch, lambda: paged_decode_attention_reference(*args), 5,
                             flush)
        b_ms, b_by = bound(nbytes, flops, args[0].dtype)
        drows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by)
        print(f"[decode] {name}: max_abs_err {err:.3e} (fp32 {err32:.3e}) "
              f"kernel_ms {ms:.4f} "
              f"plain_ms {plain:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms null "
              f"wrapper_host_ms {host:.4f}",
              flush=True)
    print("[kernels] library_ms is null: no single PyTorch call computes "
          "attention over a paged (block-table) KV pool")
    del flush

    # 4. engine: llama2-7b, full width and depth, random weights from a seed
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=2049,
        state_manager=DeepSpeedTPStateManagerConfig(max_context=4096))
    t0 = time.perf_counter()
    model = llama_model("llama2-7b", num_layers=NUM_LAYERS)
    engine = build_engine(model, cfg, seed=0)
    torch.cuda.synchronize()
    print(f"[engine] llama2-7b layers {NUM_LAYERS}/32 hidden 4096 bf16 on "
          f"{engine.device}, {cfg.num_kv_blocks} KV blocks x {cfg.kv_block_size} "
          f"({engine.kv_cache.mem_bytes() / 2**30:.2f} GiB), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32000, size=n) for n in PROMPT_LENS]
    generate(engine, [prompts[-1]], max_new_tokens=2)       # warm-up
    waves, burst_steps, wave_s, burst_s = [0], [0], [0.0], [0.0]
    run_wave, run_burst = engine._run_wave, engine.decode_burst

    # both end in a copy of their result to the host, so the host clock
    # around them spans their device work
    def counted_wave(wave):
        waves[0] += 1
        t = time.perf_counter()
        out = run_wave(wave)
        wave_s[0] += time.perf_counter() - t
        return out

    def counted_burst(uids, last, k, **kw):
        burst_steps[0] += k
        t = time.perf_counter()
        out = run_burst(uids, last, k, **kw)
        burst_s[0] += time.perf_counter() - t
        return out

    engine._run_wave, engine.decode_burst = counted_wave, counted_burst
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rpa.launches = 0
    pdk.launches = 0
    t0 = time.perf_counter()
    reqs = generate(engine, prompts, max_new_tokens=NEW_TOKENS,
                    return_requests=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ragged_paged_attention": rpa.launches, "paged_decode": pdk.launches}
    engine._run_wave, engine.decode_burst = run_wave, run_burst
    n_tok = sum(len(r.generated) for r in reqs)
    ttft = [r.first_token_s - r.submit_s for r in reqs]
    print(f"[engine] generate: {len(reqs)} requests, prompts {list(PROMPT_LENS)}, "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s; waves "
          f"{waves[0]}, burst steps {burst_steps[0]}; TTFT mean "
          f"{sum(ttft) / len(ttft) * 1e3:.1f} ms max {max(ttft) * 1e3:.1f} ms; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    print(f"[engine] host clock: waves {wave_s[0] * 1e3:.1f} ms, bursts "
          f"{burst_s[0] * 1e3:.1f} ms, scheduler and the rest "
          f"{(wall - wave_s[0] - burst_s[0]) * 1e3:.1f} ms", flush=True)
    if any(len(r.generated) != NEW_TOKENS for r in reqs):
        fail(f"token counts {[len(r.generated) for r in reqs]} != {NEW_TOKENS}")
    if launches["ragged_paged_attention"] != NUM_LAYERS * waves[0] or waves[0] == 0:
        fail(f"ragged launches {launches['ragged_paged_attention']} != "
             f"{NUM_LAYERS} x {waves[0]} waves")
    if launches["paged_decode"] != NUM_LAYERS * burst_steps[0] or burst_steps[0] == 0:
        fail(f"decode launches {launches['paged_decode']} != "
             f"{NUM_LAYERS} x {burst_steps[0]} burst steps")

    # prefill logits of one chunked prompt: the bf16 serving path and the
    # plain bf16 full-sequence forward, each against the plain forward of
    # the same weights in fp32; the serving path may carry at most
    # LOGIT_ERR_RATIO times the plain bf16 forward's own rounding error
    prompt = prompts[2]
    got = torch.from_numpy(engine.put([10_000], [prompt])[0])
    engine.flush(10_000)
    ids = torch.as_tensor(prompt, device="cuda")[None]
    plain = engine.model(ids)[0, -1].cpu()
    ref32 = llama_model("llama2-7b", num_layers=NUM_LAYERS, dtype=torch.float32)
    ref32.to_empty(device="cuda").load_state_dict(engine.model.state_dict())
    want = ref32(ids)[0, -1].cpu()
    del ref32
    rel = lambda a: ((a - want).norm() / want.norm()).item()
    print(f"[engine] prefill logits ({len(prompt)} tokens, 2 chunks) vs fp32 plain "
          f"forward: serving bf16 relative L2 {rel(got):.3e} (max |err| "
          f"{(got - want).abs().max().item():.3e}), plain bf16 forward relative L2 "
          f"{rel(plain):.3e}, serving vs plain bf16 {((got - plain).norm() / plain.norm()).item():.3e}; "
          f"max |ref| {want.abs().max().item():.3e}; argmax serving "
          f"{int(got.argmax())} plain-bf16 {int(plain.argmax())} fp32 "
          f"{int(want.argmax())}", flush=True)
    if not bool(got.isfinite().all()) or rel(got) > LOGIT_ERR_RATIO * rel(plain):
        fail(f"serving logits relative L2 error {rel(got):.3e} > "
             f"{LOGIT_ERR_RATIO} x the plain bf16 forward's {rel(plain):.3e}")

    # preemption under KV pressure, the same weights: offload and restore
    small = RaggedInferenceEngineConfig(
        num_kv_blocks=PREEMPT_BLOCKS,
        state_manager=DeepSpeedTPStateManagerConfig(max_context=4096))
    t0 = time.perf_counter()
    offloads, restores = preemption_smoke(torch, build_engine, generate, small,
                                          engine.model)
    print(f"[engine] preemption: {PREEMPT_REQUESTS} requests x "
          f"{PREEMPT_PROMPT}+{PREEMPT_NEW_TOKENS} tokens in a pool of "
          f"{PREEMPT_BLOCKS - 1} blocks: {len(offloads)} offloads to pinned host "
          f"memory, {len(restores)} restores, all tokens produced, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 5. where the time goes: the same generate under the profiler
    profile_generate(torch, generate, engine, prompts, wall)

    # 6. kernels line
    kernels = []
    for name, route_src, replaces, row in (
            ("ragged_paged_attention", "deepspeed_tpu_torch/csrc/ragged_paged_attention.cu",
             "deepspeed_tpu/inference/v2/kernels/ragged_paged_attention.py:78",
             rows[MAIN_WAVE]),
            ("paged_decode", "deepspeed_tpu_torch/csrc/paged_decode.cu",
             "deepspeed_tpu/inference/v2/kernels/pallas_paged_decode.py:54",
             drows[MAIN_DECODE])):
        errs = [r["max_abs_err"] for r in (rows if name.startswith("ragged")
                                           else drows).values()]
        kernels.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(errs), "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
