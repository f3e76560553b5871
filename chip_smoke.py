#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. card: the device's name and ``nvidia-smi`` name / power limit;
2. build: compile every kernel of ``deepspeed_tpu_torch/csrc`` (the
   ``op_builder`` registry: one ``nvcc`` per source, all at once) into
   ``build/``, and print ptxas's register and spill lines and every note
   that it serialized a kernel's ``wgmma`` pipeline;
3. serving kernels vs plain: each paged-attention kernel against its plain
   PyTorch version on the card, bf16 and fp32, at llama2-7b shapes
   (prefill, mixed and decode waves from the port's own wave builder), at
   GQA shapes and at the served families' (Falcon-7B's 71 heads on one kv
   head, head_dim 80, 96 and 256; fp32 too up to 256), at head dims whose
   rows are no multiple of 16 bytes (open-llama-3b's 100, an odd 33) and the
   tiny presets' 16, with shuffled block tables, chunks about the 64-row
   query tile's edges, a 40-sequence decode wave, a page size the
   tensor-core wave kernel does not take, decode contexts of 1 to 4133
   keys, and ALiBi and windows in both kernels and both wave forms
   (BLOOM-7b1's and bloom-560m's slopes, GPT-Neo-2.7b's window of 256 with
   decode splits that start inside the context, both at once on GQA,
   windows crossing pages, the NARROW forms at D 100; the bound counts the
   keys the queries see); two runs bit-identical, the wave's padding rows zero; with its
   time, the plain version's time and the card's lower bound for the same
   work, and at the main shapes the time after a clean L2 flush and, as
   context, ``scaled_dot_product_attention`` over the same K/V gathered
   into contiguous tensors;
4. training kernels vs plain (TF32 off for matmuls and cuDNN): flash
   forward, dQ and dK/dV in bf16 and fp32 at the training shape
   (tinyllama-1.1b: S 2048, 32 heads, 4 kv heads, head_dim 64), at the
   llama2-7b shape (MHA, head_dim 128), at the decoder families' shapes
   (Phi-2's head_dim 80, GPT-NeoX-20B's 96, GPT-J-6B's 256, Falcon-7B's 71
   heads on one kv head, BLOOM-7B1's ALiBi, GPT-Neo-2.7B's window 256
   unscaled; each twice for equal bits), at every head_dim class
   ``pallas_flash.supports`` takes (16, 48, 112, open-llama-3b's 100 at its
   training shape and with every mask input, 8, 24, an odd 33, 30 and 122
   as packed heads, 120, and the CUDA-core forms at 384 and 512; the timed
   ones twice for equal bits; at D 100 the packed heads the wrappers read
   in place timed beside the zero-padded design, its kernels and its
   copies; the forward's time is the wrapper call's, its kernel's alone
   printed beside it), at the tiny presets' own attention (head_dim 16, S
   64: one kv head, ALiBi, window 8 unscaled; twice for equal bits), at
   bert-large's (B 32, S 512, 16 heads of 64, bidirectional, padded rows
   as segment ids; timed beside SDPA with the same boolean mask) and at small
   cases (negative q_offset with fully masked rows, window, segment ids,
   ALiBi, Sq != Sk, lengths off the tile); the fused Adam kernel on a 2048 x 5632 leaf and
   on a fused bucket of lane-padded small leaves, adamw and lamb, fp32
   moments and stochastically rounded bf16 ones, moments bitwise; each
   with its time, bound, plain time and the time of PyTorch's own call for
   the same function (``scaled_dot_product_attention``, fused AdamW), which
   the port never calls; the fused Lion kernel on the same leaf and bucket,
   with and without weight decay, moments, master and cast bitwise; the
   weight-only-quantized matmul at the four llama2-7b shapes and the head,
   1, 8 and 32 rows, bf16 (also timed after a clean L2 flush), and in fp32
   at small shapes (86 groups, a ragged N, groups longer than the staged
   chunk), two runs bit-identical, with a sweep over the rows timed against
   the non-kernel form (dequantize, then ``torch.matmul``; each form held
   to the plain version at its own tolerance) and the dense bf16
   ``F.linear`` beside it as context, then bf16 edge cases of the
   tensor-core kernel (1 to 64 rows, groups of 64 and 256, N off its
   256-column tile) on a generator of their own;
   at the training shape two runs of the bf16 flash forward, and two of
   its backward, give the same bits;
5. serving: llama2-7b at full width and depth, random bf16 weights from a
   seed, served through ``build_engine`` + ``generate`` (8 prompts, chunked
   prefill, mixed waves and decode bursts, each burst K replays of a
   captured decode step), twice: cold (the decode graphs are captured
   inside it) and warm; in both the launch counters (a burst's through the
   graphs' replay accounting) must show that the path ran through both
   kernels (every ragged launch in the tensor-core form) and every request
   must get its tokens; ``[decode-graph]``: a 16-step burst of 8 prefilled
   sequences through the engine's graphs, cold and warm, must give the
   eager burst's tokens and KV pages byte for byte, sampled rows the same
   tokens for one seed and others for another (host ms a step of each, and
   device ms a step of the replays at batch buckets 1 to 16);
   ``[engine-sweep]``: ``decode_burst`` 8 / 16 / 32 at 128 new tokens;
   one prompt's prefill logits must match the plain
   full-sequence ``TransformerLM.forward``; a second engine over the same
   weights with a small pool must preempt, offload to host memory and
   restore, and still produce every token; the warm ``generate`` under
   ``torch.profiler``;
6. int8 weight-only-quantized serving: the same model, seed and requests
   with ``quantization_mode="int8"``; every request must get its tokens,
   the WOQ kernel must have run once per quantized linear in every decode
   step and in every wave of at most ``WOQ_KERNEL_MAX_ROWS`` rows (the head
   in every wave) beside the two attention kernels, the weights must take
   about half the dense model's bytes, and a short prompt's logits through
   the kernels must be as close to the fp32 plain forward of the same
   integers as twice the plain bf16 path's own error; ``[decode-graph]``
   as in phase 5; then packed int4 at the same width and 2 layers: tokens
   come out through the non-kernel form alone, its bursts through captured
   graphs, and the logits hold the same bound;
7. training: tinyllama-1.1b at full width and depth, sequence 2048,
   micro-batch 8, bf16 with fp32 master and moments, AdamW, clipping 1.0,
   through ``deepspeed_tpu_torch.initialize`` + ``train_batch``: 2 warm-up
   and 5 timed steps on one seeded batch (step time, tokens/s, MFU, peak
   memory), the losses finite, the first near ln(32000) and falling; the
   launch counters must show 44 flash forwards (remat reruns each block's
   forward), 22 dQ, 22 dK/dV and one Adam launch per bucket a step; one
   more step under ``torch.profiler``; then ``[checkpoint]`` on the same
   engine: the disk's free bytes, a synchronous save (the tag's bytes, its
   seconds, and ``verify_tag``'s crc read-back apart), 2 more steps, the
   same 2 steps from an engine of another seed that loaded the tag (its
   load seconds; losses and every param after them bit for bit), an async
   save (the seconds it blocked, the seconds to its commit; ``latest`` names
   the tag only after the commit), and on 2 layers of the same width
   ``keep_last_n`` 2 over three tags, a flipped byte in the newest making
   ``load_checkpoint()`` fall back to the one before and the bad tag by
   name raise (the depth is cut, and the cut printed, only where the disk
   cannot hold a tag); then a 2-layer model of the same
   width trained 3 steps through the kernels and 3 steps through their
   plain versions from the same weights, the losses within 2e-2;
8. Lion training: the same model, batch and config with ``optimizer: Lion``
   (lr 1e-4, betas 0.9 / 0.99, weight decay 0.1): 1 warm-up and 3 timed
   steps, one Lion launch per bucket a step and no Adam launch, a profiled
   step, and the 2-layer kernels-vs-plain comparison;
9. data-parallel ZeRO (``[zero]``): two ranks, processes of their own on
   the one card (backend ``ZERO_BACKEND``, gloo: NCCL refuses two ranks on
   one device), each through ``comm.init_distributed`` +
   ``deepspeed_tpu_torch.initialize`` + ``train_batch``: tinyllama-1.1b at
   full width and depth, S 2048, micro 4 a rank, bf16, AdamW, clipping 1.0,
   ZeRO-3 with the ZeRO++ int8 wire (qwZ + qgZ) on the barrier schedule; 1
   warm-up and 3 timed steps on one seeded global batch: losses finite, the
   first near ln(32000), falling and equal on both ranks; a step's
   quantizer launches equal to its int8 all-gathers plus int8 all-to-alls
   in the collective ledger; every stage-3 shard gathered int8 and no
   full-width gather but those of the persistent small leaves; each rank's
   master and moments about half of phase 7's; step time, tokens/s, MFU,
   peak memory per rank, the wire bytes by width and, over one more step,
   the share of the step spent in collectives, and over one more step rank
   0's row quantizer under ``torch.profiler`` (its device ms and launches,
   their bytes bound, rows a launch as a histogram); then a 2-layer model of the
   same width for 3 steps through the kernels, through their plain versions
   (losses within 2e-2) and at full width without ZeRO++ (int8 losses
   within the JAX suite's ZeRO++ tolerance, rtol = atol = 0.05); then the
   2-layer ZeRO-3 + ZeRO++ engine after a step saves one rank file a rank,
   which both ranks load at stage 1 and this process into a single-device
   engine, every param equal to the saver's (sha256 of its bytes). In the
   same ranks, after the barrier run, ``[zero-overlap]``: the layer-pipelined
   overlap schedule under the JAX package's default ZeRO++ config
   (``ZERO_OVERLAP_CONFIG``, ``overlap_comm`` unset) at full width and
   depth, 1 warm-up and 2 timed steps on the same batch: the engine took the
   schedule, losses equal on both ranks, falling and within the ZeRO++
   tolerance of the barrier run's; each step's launches by op, width and
   class (overlapped / exposed) equal to the count the schedule states
   (``overlap_expected``), quantizer launches equal to its int8 collectives,
   the flash and Adam launches a step; step ms, peak memory, the host's
   time blocked in ``wait()`` and the overlapped / exposed wire bytes
   beside the barrier's, and one more step with every collective
   synchronized (an upper bound of the collectives' share on this
   schedule); then at 2 layers, plain stage 3 at full width on the schedule
   against two barrier runs (bitwise, or within the two barrier runs' gap,
   printed beside it) and the ZeRO++ schedule's first block reduce-scatter
   within the int8 rounding bound of the two ranks' exact mean. A rank
   that fails or hangs past ``ZERO_TIMEOUT`` fails the run;
10. Mixtral serving (``[moe-engine]``): mixtral-8x7b at full width (8
   experts, top-2, FFN 14336), depth cut to 24 of 32 layers, random bf16
   weights from a seed, the requests of phase 5 through ``build_engine`` +
   ``generate``: every request gets its tokens; the MoE route, gather and
   FFN ran once a layer in every wave and decode step, the split form's FFN
   and combine in exactly the waves of more than
   ``MOE_FUSED_COMBINE_MAX_TOKENS`` rows, both attention kernels once a
   layer (cold and warm, as in phase 5); ``[decode-graph]`` as in phase
   5, and the edges of a captured route -> dispatch gather by type (the
   gather's programmatic launch kept as a programmatic edge); tokens/s, TTFT, peak memory, weight bytes and a profile (its
   launch count; the route and gather rows wherever they rank); then a
   2-layer model of the same width: a prompt's logits through the kernels
   within twice the plain bf16 path's error against the fp32 plain
   dropless forward;
11. the decoder families (``[families]``): Phi-2 at full width and depth
   (32 layers, head_dim 80, parallel blocks, partial rotary, a biased
   untied head) trained through ``initialize`` + ``train_batch`` (S 2048,
   micro 8, bf16, AdamW, clipping 1.0; 2 warm-up and 5 timed steps: losses
   finite, the first near its expected value and falling; 64 flash
   forwards, 32 dQ and 32 dK/dV a step, all at head_dim 80); Falcon-7B at
   full width and depth (71 heads on one kv head), BLOOM-7b1 (ALiBi, vocab
   250880) and GPT-Neo-2.7b (window 256 on alternate layers) served through
   ``build_engine`` + ``generate`` with phase 5's requests, cold and warm
   (both paged kernels once a layer a wave and decode step, the waves in
   the CUDA-core form for Falcon, the tensor-core form for the others),
   one prompt's prefill logits against the plain forward, a profile; then
   each of gpt2-xl, opt-6.7b, phi-2, falcon-7b, bloom-7b1, gpt-neox-20b,
   gpt-neo-2.7b and gpt-j-6b at full width and 2 layers: 3 steps through
   the kernels and 3 through their plain versions (losses within 2e-2), a
   prompt's logits through the serving engine within twice the plain bf16
   path's error; then each tiny decoder preset (head_dim 16): 3 training
   steps through the kernels and 3 through their plain versions (losses
   within 2e-2), one served request;
12. open-llama-3b (``[open-llama]``): 26 layers, hidden 3200, 32 heads of
   head_dim 100 (3.43e9 params), random weights from a seed, trained
   through ``initialize`` + ``train_batch`` in phase 7's configuration
   (micro ``OPEN_LLAMA_MICRO``; 2 warm-up and 3 timed steps: losses finite,
   the first near ln 32000 and falling; 52 flash forwards, 26 dQ and 26
   dK/dV a step, all at head_dim 100; step time, tokens/s, MFU, peak
   memory, a profiled step; then steps with the flash inputs read as
   packed heads and zero-padded to 104, in turns A B B A), then served through ``build_engine`` +
   ``generate`` with phase 5's requests, cold and warm (both paged kernels
   once a layer a wave and decode step, the waves in the CUDA-core form,
   the pool ~333 KB a token), one prompt's prefill logits within twice the
   plain bf16 path's error against the fp32 plain forward; the phase's
   seconds;
13. the encoders (``[encoders]``): bert-large MLM at full width and depth
   (24 layers, hidden 1024, 16 heads of 64, FFN 4096, vocab 30522), S 512,
   micro 32, bf16, AdamW, remat full, through ``initialize`` +
   ``train_batch`` on padded rows (lengths drawn in 128-512, two token
   types, 15% of the real positions labelled): 2 warm-up and 5 timed steps
   (losses finite and falling; 48 flash forwards, 24 dQ and 24 dK/dV a
   step, non-causal with the padding as segment ids; step time, tokens/s,
   MFU counting S^2 pairs and the tied MLM decoder, peak memory, a
   profiled step); every remat policy at the same shape (step time, peak
   memory, flash forwards a step, the losses equal to full remat's); a
   2-layer bert-large through the kernels and through their plain
   versions (losses within 2e-2); the task heads through ``initialize``:
   bert-base sequence and token classification (S 128) and question
   answering (S 384), roberta-base sequence classification with MuAdamW,
   on padded batches; the phase's seconds;
14. MoE training (``[moe-train]``): the MoE operator (``make_moe_forward``
   with gradients; its backward the reference VJP) at mixtral-8x7b's widths
   in bf16 and fp32, at the training step's call, T 8192 with capacity
   1280 (the split form; 10240 of 16384 choices kept), and T 256 with
   capacity 40 (the fused form), a cotangent on its output and on aux:
   output, aux and every gradient (tokens, router, each expert weight)
   through the kernels against the same call on the plain versions, and
   the backward's router logits and routes bitwise the forward's; each MoE
   kernel timed at T 8192, capacity 1280 beside its plain version, its
   bound and the library call; then
   mixtral-8x7b at full width and 2 of its 32 layers (3.16e9 params)
   trained through ``initialize`` + ``train_batch`` (micro 4 x S 2048, a
   MoE call of T 8192 at capacity 1280 a layer, bf16, AdamW lr 3e-4, wd
   0.1, clipping 1.0, remat per block, aux_loss_coef 0.01; a warm-up and 3
   timed steps: losses and the summed aux of every step, losses finite, the
   first near its expected value and falling; launches a step: route,
   gather, split FFN and combine twice a layer, flash forward twice, dQ
   and dK/dV once, Adam once a bucket; step time, tokens/s, MFU over the
   active parameters counting top-2 choices and counting the kept ones,
   peak memory, a profiled step), and the same 2 layers through the kernels
   and through their plain versions, 3 steps at lr 3e-5 (losses within
   2e-2) and at lr 3e-4 (the first two steps within 2e-2; the third within
   3x the largest of four witnesses: the plain path again, with one router
   element one ulp off, and with the MoE or the flash and Adam kernels
   alone on their plain versions); the phase's and the command's seconds;
15. sequence parallelism (``[seq-parallel]``): first the forms' kernel
   calls at their shapes against the plain versions, timed beside their
   bounds: flash forward and backward (bf16, a cotangent on the LSE) at a
   ring hop's shape (8192 queries against 8192 keys, 32 / 4 heads of 64)
   at ``q_offset`` +8192, 0 and -8192 (O all 0 and LSE all ``MASK_VALUE``
   there, its bound the bytes of the outputs alone), at Ulysses' (S 16384, 16 / 2 heads), and the row quantizer on a
   hop's K block, byte for byte; then two ranks on the one card (gloo, as
   ``[zero]``) train tinyllama-1.1b at full width, depth cut to
   ``SEQ_LAYERS`` (11 of 22), max_seq_len raised to 16384, global S 16384
   at micro 1 (8192 tokens a rank), bf16,
   AdamW, clipping 1.0, ZeRO-1 over data x seq, remat per block, through
   ``initialize`` + ``train_batch`` with ``topology.seq`` 2: Ulysses, the
   ring at the default int8 hop width and at full width, each a warm-up
   and 1 timed step (losses finite, the first near ln(32000), falling and
   equal on both ranks; flash and quantizer launches a step; step time,
   tokens/s, MFU over the global causal pairs, peak memory a rank, one
   more step's collective share, the wire bytes by op and width, each
   seq-axis exchange of the forward, the remat replay and the backward
   counted); then
   each form at 2 layers through the kernels against one process's plain
   single-rank path on the whole sequence (losses within 2e-2); the
   phase's seconds.

Phase 4 also holds the ZeRO++ wire quantizer (``[quant]``) against its
plain version, q and scale byte-identical: fp32 and bf16 rows of the
tinyllama-1.1b shards at world 2 and group 256 (an MLP shard's gather, the
embedding shard's, an MLP gradient's reduce-scatter rows), group sizes 1,
7, 100, 255 and 4096, zero rows, exact .5 ties, -0.0 and subnormal inputs,
each timed beside its bound and its plain version (the main case also
after a clean L2 flush), then 10^8 (x, scale) pairs at and near the
half-integers of x / scale (the divide sweep); and the six MoE kernels (``[moe]``: route,
dispatch gather, int8 dispatch gather, fused FFN + combine, split FFN,
combine) against their plain versions: fp32
at small shapes (top_k 1, gelu, dead experts, dropped choices, T off every
tile size, a route over 3000 tokens), then bf16 at mixtral-8x7b's widths for
T = 8, 256 and 512 (dropless, S = 8 T): route indices bitwise, gather
byte-identical, the int8 gather (mask_pad off and on) byte-identical to its
plain version and to the quantizer kernel on the gathered rows, FFN within
5e-2 and twice bit-identical, combine and fused-vs-split bitwise; each
timed with its bound, its plain version, ``index_select`` for the
gather and ``F.embedding_bag`` (mode sum, the route's weights as
per-sample weights) for the combine; ``torch.bmm`` over all slots as
context; the split FFN -> combine as one call at T 512; the combine alone
at T 4096 (bitwise, timed beside ``F.embedding_bag``); then the fused-vs-split
sweep over T = 8 ... 4096 (``[moe-sweep]``) that sets
``MOE_FUSED_COMBINE_MAX_TOKENS``; then edge cases of the FFN's wave form
(T 17, 300 and 4096, a dead expert, capacity factor 1.0, small gelu and
top-1 shapes off its tiles); then the route's edge cases (T 1, 32, 33, 1024
and 1025, E 4, 8 and 40, top-1 and top-2, dropped choices, dead experts),
from fp32 logits and from their bf16 rounding (the route of bf16 logits
bitwise the route of their fp32 cast). The bf16 cases route the bf16
router product, as the forward does; every route and gather runs twice for
equal bits. Beside the route and gather rows: an empty kernel's time under
the same timing (the launch floor), route -> gather timed as one call, the
gather after a clean L2 flush, and the device operations of one MoE
forward call at T 8 as serving builds it (no aux) and asked for aux.

The output ends with a ``{"kernels": [...]}`` line (15 kernels), the
``nvidia-smi`` line and the result line ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or ``deepspeed_tpu``; needs one CUDA device.
"""

import contextlib
import json
import os
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
INT4_LAYERS = 2       # the packed-int4 check runs at full width, depth cut
# [decode-graph]: one prefilled batch of 8 (block tables of 8 blocks, a key
# no generate uses), a K-step burst eagerly and through the engine's graphs;
# device ms a step of the replays at these batch buckets
DECODE_GRAPH_PROMPTS = (100, 90, 80, 70, 60, 50, 40, 30)
DECODE_GRAPH_K = 16
DECODE_GRAPH_BATCHES = (1, 2, 4, 8, 16)
DECODE_GRAPH_SAMPLED_ROWS, DECODE_GRAPH_TEMP = (1, 4, 6), 0.8
# [engine-sweep]: decode_burst K, each twice (order 8 16 32 32 16 8), over the
# requests of [engine] with more new tokens, so that bursts of 32 happen
BURST_SWEEP, BURST_SWEEP_NEW_TOKENS = (8, 16, 32), 128
# preemption run: 4 requests that end at 8 blocks each against a pool of 20
PREEMPT_REQUESTS, PREEMPT_PROMPT, PREEMPT_NEW_TOKENS, PREEMPT_BLOCKS = 4, 64, 64, 21
SPIN_CYCLES = 400_000_000  # ~0.2 s of device spin behind each timing loop
PLAIN_SPIN = 10 * SPIN_CYCLES  # the plain versions enqueue hundreds of ops a call
PAGE_SIZE = 16
# kernel cases at llama2-7b shapes (kvH 32, g 1, D 128) and GQA shapes; an
# optional last element {"shuffle": True} draws each sequence's pages from a
# seeded permutation of the pool (else consecutive pages), {"ps": n} sets
# another page size
WAVE_CASES = {
    # name: (seqs [(q_len, seen)], kvH, g, D[, options])
    "prefill-2x256": ([(256, 0), (256, 0)], 32, 1, 128),
    "prefill-chunked": ([(256, 256), (44, 256), (256, 0)], 32, 1, 128),
    "mixed": ([(1, 543), (1, 416), (1, 331), (256, 256), (77, 0), (5, 11)], 32, 1, 128),
    "decode-8": ([(1, c) for c in (512, 384, 300, 200, 130, 77, 33, 17)], 32, 1, 128),
    "straddle": ([(6, 3), (5, 4), (9, 0), (1, 7), (20, 13)], 32, 1, 128),
    "gqa-g4-d128": ([(1, 543), (256, 256), (77, 0), (6, 3)], 8, 4, 128),
    "gqa-g8-d64": ([(1, 543), (256, 256), (77, 0), (6, 3)], 4, 8, 64),
    # shuffled block tables; chunks about the 64-row query tile's edges
    # (64 / g tokens: 64 at g 1, 16 at g 4); a wave of 40 decode atoms of
    # different sequences; a page size the tensor-core kernel does not take
    "shuffled": ([(256, 0), (1, 543), (77, 0), (44, 256), (1, 17)], 32, 1, 128,
                 {"shuffle": True}),
    "tile-edges-g1": ([(63, 0), (64, 0), (65, 17), (129, 64)], 32, 1, 128, {"shuffle": True}),
    "tile-edges-g4": ([(15, 0), (16, 3), (17, 0), (33, 16)], 8, 4, 128, {"shuffle": True}),
    "decode-40": ([(1, 17 + 29 * i) for i in range(40)], 32, 1, 128, {"shuffle": True}),
    "page-8-cuda-cores": ([(256, 0), (1, 300), (20, 5)], 32, 1, 128, {"ps": 8}),
    # the decoder families the engine serves beside Llama: Falcon-7B's 71
    # query heads on one kv head and head_dims 80, 96 and 256 take the
    # CUDA-core form (the tensor-core form takes g <= 64 and D 64 / 128)
    "falcon-7b-g71": ([(16, 0), (8, 100), (1, 300), (3, 7)], 1, 71, 64, {"shuffle": True}),
    "phi-2-d80": ([(256, 0), (1, 300), (20, 5)], 32, 1, 80),
    "gpt-neox-20b-d96": ([(256, 0), (1, 300), (20, 5)], 64, 1, 96),
    "gpt-j-6b-d256": ([(256, 0), (1, 300), (20, 5)], 16, 1, 256),
    # head dims that are no multiple of 8 or 16 bytes: open-llama-3b's 100
    # (rows of 200 bf16 bytes: 8-byte copies), the tiny presets' 16, an odd
    # one (2-byte copies, rows of 8 columns staged past it)
    "open-llama-3b-d100": ([(256, 0), (1, 300), (20, 5)], 32, 1, 100),
    "tiny-d16": ([(64, 0), (1, 100), (7, 3)], 4, 1, 16),
    "odd-d33-g2": ([(40, 0), (1, 77), (9, 5)], 2, 2, 33, {"shuffle": True}),
    # ALiBi (BLOOM's slopes) and windows in both forms: BLOOM-7b1 and
    # bloom-560m (tensor cores, D 128 / 64), GPT-Neo-2.7b's local layers
    # (window 256: chunks whose window starts mid-page and mid-step, a
    # chunk longer than the window), both at once on GQA in both forms (a
    # window of 37 crossing pages of 16), and the CUDA-core form at D 100
    "bloom-7b1-alibi": ([(256, 0), (1, 300), (20, 5), (64, 640)], 32, 1, 128,
                        {"alibi": True}),
    "bloom-560m-alibi": ([(256, 0), (1, 300), (20, 5)], 16, 1, 64, {"alibi": True}),
    "gpt-neo-2.7b-window": ([(256, 0), (1, 300), (20, 301), (300, 100), (1, 1000)], 20, 1,
                            128, {"window": 256, "shuffle": True}),
    "alibi-window-g4-d128": ([(100, 0), (1, 300), (17, 60), (64, 37)], 8, 4, 128,
                             {"alibi": True, "window": 37, "shuffle": True}),
    "alibi-window-g4-d100": ([(64, 0), (1, 200), (30, 50)], 8, 4, 100,
                             {"alibi": True, "window": 40, "shuffle": True}),
}
DECODE_CASES = {
    # name: (context lengths, kvH, g, D[, options])
    "decode-8-first-burst": ([513, 385, 301, 201, 131, 78, 34, 18], 32, 1, 128),
    "decode-8-straddle": ([1, 15, 16, 17, 33, 100, 257, 1000], 32, 1, 128),
    "gqa-g4-d128": ([513, 385, 301, 201, 131, 78, 34, 18], 8, 4, 128),
    "gqa-g8-d64": ([513, 385, 301, 201, 131, 78, 34, 18], 4, 8, 64),
    # shuffled block tables; a context of 4096+ keys beside short ones (the
    # split count and the balance), contexts of 1, 16 and 17
    "shuffled": ([513, 385, 301, 201, 131, 78, 34, 18], 32, 1, 128, {"shuffle": True}),
    "long-4133": ([4133, 1, 16, 17, 513, 64, 65, 2000], 32, 1, 128, {"shuffle": True}),
    "gqa-g4-long": ([4133, 1, 16, 17], 8, 4, 128, {"shuffle": True}),
    # the families' decode shapes: 71 heads in row groups of 8, head_dims
    # 80, 96 and 256 (rows of 160, 192 and 512 bf16 bytes)
    "falcon-7b-g71": ([513, 385, 301, 201, 131, 78, 34, 18], 1, 71, 64),
    "phi-2-d80": ([513, 385, 301, 201], 32, 1, 80),
    "gpt-neox-20b-d96": ([513, 385, 301, 201], 64, 1, 96),
    "gpt-j-6b-d256": ([513, 385, 301, 201], 16, 1, 256),
    # rows that are no multiple of 16 bytes (the NARROW form): open-llama's
    # 100 (8-byte loads), an odd head_dim (2-byte loads); the tiny presets' 16
    "open-llama-3b-d100": ([513, 385, 301, 201], 32, 1, 100),
    "tiny-d16": ([513, 385, 301, 201], 4, 1, 16),
    "odd-d33-g2": ([77, 1, 300], 2, 2, 33, {"shuffle": True}),
    # ALiBi and windows: BLOOM-7b1's decode shape; GPT-Neo-2.7b's local
    # layers, whose splits start inside the context at ctx - 256 (mid-page:
    # 1000 - 256 = 744), contexts at and about the window; both at once on
    # GQA, and the NARROW form at D 100 with a window crossing pages
    "bloom-7b1-alibi": ([513, 385, 301, 201, 131, 78, 34, 18], 32, 1, 128, {"alibi": True}),
    "gpt-neo-2.7b-window": ([1000, 300, 257, 256, 255, 130, 17, 1], 20, 1, 128,
                            {"window": 256, "shuffle": True}),
    "alibi-window-g8-d64": ([4133, 1, 16, 300], 4, 8, 64,
                            {"alibi": True, "window": 300, "shuffle": True}),
    "alibi-window-g4-d100": ([700, 77, 1, 300], 8, 4, 100,
                             {"alibi": True, "window": 200, "shuffle": True}),
}
# the fp32 checks of both paged kernels run up to head_dim 256 (decode rows
# of 1024 bytes take 32 lanes a row; serving is bf16)
PAGED_FP32_MAX_D = 256
MAIN_WAVE = "prefill-2x256"          # the shape of the engine run's first wave
MAIN_DECODE = "decode-8-first-burst"  # the engine run's first burst step
# flash-attention cases: (B, Sq, Sk, H, kvH, D, mask); fp32 runs B <= 2
FLASH_CASES = {
    "tinyllama-b8": (8, 2048, 2048, 32, 4, 64, {}),    # the training step's shape
    "llama2-7b-mha": (1, 2048, 2048, 32, 32, 128, {}),
    "neg-offset": (2, 256, 256, 8, 2, 64, {"q_offset": -100, "dlse": True}),
    "window": (2, 300, 300, 8, 2, 64, {"window": 64}),
    "segments": (2, 256, 256, 8, 4, 32, {"segments": True, "dlse": True}),
    "alibi": (2, 256, 256, 8, 8, 128, {"alibi": True}),
    "sq-ne-sk": (2, 100, 333, 8, 2, 64, {}),
    "noncausal-ragged": (2, 77, 200, 4, 2, 64, {"causal": False}),
    # lengths about the 64-row tiles and 128-key blocks of both passes and
    # the forward's 192-row blocks (three 64-row warpgroups)
    "s127-g8": (2, 127, 127, 16, 2, 64, {}),
    "s129-g8": (2, 129, 129, 16, 2, 64, {}),
    "s191-g8": (2, 191, 191, 16, 2, 64, {}),
    "s193-g8": (2, 193, 193, 16, 2, 64, {}),
    "s129-g4-d128-dlse": (2, 129, 129, 8, 2, 128, {"dlse": True}),
    "s191-mha-d128": (1, 191, 191, 8, 8, 128, {}),
    "s193-mha-d128": (1, 193, 193, 8, 8, 128, {}),
    # a window wide enough for whole tiles to lie inside it (interior tiles)
    "window-interior": (1, 1024, 1024, 16, 2, 64, {"window": 512}),
    # the decoder families' training shapes at full width: head_dim 80 and
    # 96 (the 128-column tiles, zero past D), 256 (the CUDA-core kernels in
    # bf16 too), multi-query, ALiBi, GPT-Neo's local layers (unscaled)
    "phi-2-b4": (4, 2048, 2048, 32, 32, 80, {}),
    "gpt-neox-20b": (1, 2048, 2048, 64, 64, 96, {}),
    "gpt-j-6b": (1, 2048, 2048, 16, 16, 256, {}),
    "falcon-7b-mqa": (1, 2048, 2048, 71, 1, 64, {}),
    "bloom-7b1-alibi": (1, 2048, 2048, 32, 32, 128, {"alibi": True}),
    # unscaled logits (scale 1.0) of q drawn at std D^-1/2: the logits'
    # spread of the scaled cases, as GPT-Neo's weights keep it. At std 1
    # they spread to ~11, |dS| reaches ~10 and one bf16 ulp of it (0.0625)
    # passes the bf16 bound (dQ off by 0.25 against the plain version on an
    # NVIDIA H100 80GB HBM3 at 700.00 W)
    "gpt-neo-2.7b-window": (1, 2048, 2048, 20, 20, 128,
                            {"window": 256, "scale": 1.0, "q_std": 128 ** -0.5}),
    # the new head dims off the tiles, with every mask input
    "s129-g4-d80-dlse": (2, 129, 129, 8, 2, 80, {"dlse": True}),
    "s193-mha-d96-window": (1, 193, 193, 8, 8, 96, {"window": 100}),
    "s77-sk100-g4-d256-dlse": (2, 77, 100, 8, 2, 256, {"dlse": True}),
    "segments-alibi-d256": (2, 256, 256, 4, 4, 256, {"segments": True, "alibi": True}),
    "neg-offset-d96": (2, 256, 256, 8, 2, 96, {"q_offset": -100}),
    # every head_dim pallas_flash.supports takes: the tiny presets' 16, 48
    # and 112 (the tiles of 16-column steps), open-llama-3b's 100 (packed
    # heads) at its training shape and with every mask input (GQA: padded),
    # small and odd dims (33: padded), and the CUDA-core forms at 384 and
    # 512 (small: no preset uses them)
    "d16": (4, 1024, 1024, 8, 8, 16, {}),
    "d48": (2, 1024, 1024, 16, 4, 48, {"dlse": True}),
    "d112": (2, 1024, 1024, 16, 16, 112, {}),
    "open-llama-3b-b8": (8, 2048, 2048, 32, 32, 100, {}),
    "d100-segments-alibi": (2, 300, 300, 8, 8, 100, {"segments": True, "alibi": True,
                                                      "dlse": True}),
    "d100-window-neg-offset": (2, 256, 256, 8, 2, 100, {"window": 64, "q_offset": -30}),
    "d8-s77-sk100": (2, 77, 100, 4, 2, 8, {"dlse": True}),
    "d24-noncausal": (2, 129, 129, 4, 4, 24, {"causal": False}),
    "d33-odd": (2, 129, 129, 4, 2, 33, {"dlse": True}),
    # packed heads at every shift in the tile (2, 4, 6 columns) on the
    # 32-column tiles (64-byte swizzle) and at the widest packed head_dim;
    # D 100 with one kv head (GQA: zero-padded copies)
    "d30-packed": (2, 129, 129, 8, 8, 30, {"dlse": True}),
    "d122-packed-window": (1, 193, 193, 4, 4, 122, {"window": 100}),
    "d100-mqa-padded": (2, 256, 256, 8, 1, 100, {}),
    "d120-window": (1, 193, 193, 8, 8, 120, {"window": 100}),
    "d384": (1, 256, 256, 4, 4, 384, {"dlse": True}),
    "d512": (1, 200, 256, 4, 2, 512, {}),
    # the tiny presets' own attention at head_dim 16 (S 64, 4 heads):
    # falcon-tiny's one kv head, bloom-tiny's ALiBi, gpt-neo-tiny's local
    # layer (window 8, unscaled, q at std D^-1/2 as for GPT-Neo above)
    "falcon-tiny-mqa": (1, 64, 64, 4, 1, 16, {}),
    "bloom-tiny-alibi": (1, 64, 64, 4, 4, 16, {"alibi": True}),
    "gpt-neo-tiny-window": (1, 64, 64, 4, 4, 16, {"window": 8, "scale": 1.0,
                                                  "q_std": 16 ** -0.5}),
    # bert-large's training shape: bidirectional, the padding mask of
    # padded rows (lengths drawn in 128-512) as segment ids, pads among pads
    "bert-large-b32": (32, 512, 512, 16, 16, 64, {"causal": False, "padding": True}),
    # the Mixtral training step's shape (``[moe-train]``: micro 4, 32 / 8
    # heads of 128)
    "mixtral-8x7b-b4": (4, 2048, 2048, 32, 8, 128, {}),
}
MAIN_FLASH = "tinyllama-b8"
FAMILY_FLASH = ("phi-2-b4", "gpt-neox-20b", "gpt-j-6b", "falcon-7b-mqa", "bloom-7b1-alibi",
                "gpt-neo-2.7b-window")
HEAD_DIM_FLASH = ("d16", "d48", "d112", "open-llama-3b-b8", "d384", "d512")
FLASH_TIMED = ("tinyllama-b8", "llama2-7b-mha") + FAMILY_FLASH + HEAD_DIM_FLASH + (
    "bert-large-b32", "mixtral-8x7b-b4")
FLASH_BITWISE = (MAIN_FLASH,) + FAMILY_FLASH + HEAD_DIM_FLASH + ("bert-large-b32",) + (
    "d100-segments-alibi", "d33-odd", "d30-packed", "d122-packed-window",
    "d100-mqa-padded", "falcon-tiny-mqa", "bloom-tiny-alibi",
    "gpt-neo-tiny-window")   # two runs, the same bits
FLASH_GRAD_FP32_TOL = 1e-4   # fp32 sums over 2048 keys x 8 heads, two orders
# Adam cases: (leaf sizes, mode, moment dtype); grads bf16, master fp32
ADAM_CASES = {
    "leaf-2048x5632-adamw-fp32": ([2048 * 5632], "adamw", "float32"),
    "leaf-2048x5632-adamw-bf16sr": ([2048 * 5632], "adamw", "bfloat16"),
    "leaf-2048x5632-lamb-fp32": ([2048 * 5632], "lamb", "float32"),
    "bucket-adamw-bf16sr": ([2048, 300, 777, 524288, 5], "adamw", "bfloat16"),
    "bucket-lamb-bf16sr": ([2048, 300, 777, 524288, 5], "lamb", "bfloat16"),
    "bucket-adamw-fp32": ([2048, 300, 777, 524288, 5], "adamw", "float32"),
}
MAIN_ADAM = "leaf-2048x5632-adamw-fp32"
MASTER_RTOL = 1e-6   # fp32 master: same IEEE ops on both sides
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": 8, "bf16": {"enabled": True},
                "gradient_clipping": 1.0,
                "optimizer": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.1}}}
LION_CONFIG = dict(TRAIN_CONFIG, optimizer={"type": "Lion", "params": {
    "lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.1}})
TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 2048, 2, 5
LION_WARMUP, LION_STEPS = 1, 3
# Lion cases: (leaf sizes, weight decay, moment dtype); grads bf16, master fp32
LION_CASES = {
    "leaf-2048x5632-wd-fp32": ([2048 * 5632], 0.1, "float32"),
    "leaf-2048x5632-nowd-bf16sr": ([2048 * 5632], 0.0, "bfloat16"),
    "bucket-wd-bf16sr": ([2048, 300, 777, 524288, 5], 0.1, "bfloat16"),
    "bucket-nowd-fp32": ([2048, 300, 777, 524288, 5], 0.0, "float32"),
}
MAIN_LION = "leaf-2048x5632-wd-fp32"
# WOQ matmul cases: (K, N, group size) of llama2-7b's quantized linears
WOQ_CASES = {
    "qkvo-4096x4096": (4096, 4096, 128),
    "gate-up-4096x11008": (4096, 11008, 128),
    "down-11008x4096": (11008, 4096, 128),
    "head-4096x32000": (4096, 32000, 128),
}
WOQ_ROWS = (1, 8, 32)
MAIN_WOQ, MAIN_WOQ_ROWS = "gate-up-4096x11008", 8   # a decode step of the 8 requests
WOQ_SWEEP_ROWS = (1, 8, 16, 32, 64, 128)
# fp32 cases: (M, K, N, group size): 86 groups, N off the column tile,
# groups longer than the 128 rows staged at a time, one row, 13 rows
WOQ_FP32_CASES = ((5, 1376, 200, 16), (3, 512, 384, 128), (2, 512, 132, 256),
                  (1, 256, 128, 64), (13, 384, 260, 128))
WOQ_FP32_RTOL = 1e-5   # of the largest |out|: fp32 sums of K terms in two orders
# bf16 edge cases of the tensor-core kernel, (M, K, N, group size): one row,
# rows off its 8/16/32/64-row forms, 64 rows, groups of 64 and 256, and an N
# that is a multiple of 16 but not of its 256-column tile
WOQ_EDGE_CASES = ((1, 4096, 4112, 64), (13, 4096, 11008, 64), (33, 4096, 4112, 256),
                  (64, 11008, 4096, 128), (64, 4096, 11024, 256), (1, 11008, 4096, 256))
# the non-kernel form of the row sweep (dequantize to bf16, one torch.matmul
# with a bf16 result) against the plain version's exact sum: atol = rtol,
# looser than the kernel's BF16_TOL because each weight is rounded to bf16
# before cuBLAS's product ([woq-sweep] prints both forms' errors)
WOQ_NON_KERNEL_TOL = 5e-2
# the edge cases of the WOQ and MoE kernels draw from a generator of their
# own, so the cases before and after them see the draws they always saw
EDGE_SEED = 2
PATH_LAYERS, PATH_STEPS, PATH_RTOL = 2, 3, 2e-2   # kernel vs plain training path
# MoE kernel cases at mixtral-8x7b's widths: E 8, top_k 2, H 4096, F 14336,
# dropless (capacity T, S = 8 T slots): a decode step and two prefill waves
MOE_E, MOE_K, MOE_H, MOE_F = 8, 2, 4096, 14336
MOE_TOKENS = (8, 256, 512)
MOE_DECODE_T, MOE_WAVE_T = 8, 512   # the kernels line: fused form at a decode step, split at a wave
MOE_COMBINE_WIDE_T = 4096   # the combine alone at the sweep's largest wave (201 MB moved)
# the int8 dispatch gather beyond MOE_TOKENS, its own generator: timed at
# mixtral's H 4096, top-2, dropless, mask_pad on: (T, dtype); then checked
# at edge cases (T, H, dtype, layout), layout "routed" (the route of seeded
# logits), "empty" (every slot empty) or "offset" (the tokens start 2 or 4
# bytes past a 16-byte boundary): rows off the 16-byte unit (H 4100, value by
# value, a warp a row), unaligned rows, rows past the block form (H 16392, a
# warp a row, read twice), the lanes form's short rows (H 1, 7, 96)
MOE_GATHER_INT8_TIMED = ((4096, "bfloat16"), (512, "float32"))
MOE_GATHER_INT8_EDGE = ((8, 4100, "bfloat16", "routed"), (8, 4096, "bfloat16", "offset"),
                        (8, 16392, "bfloat16", "routed"), (8, 4096, "bfloat16", "empty"),
                        (37, 1, "float32", "routed"), (37, 7, "bfloat16", "routed"),
                        (37, 96, "bfloat16", "routed"), (45, 96, "float32", "offset"),
                        (300, 4100, "float32", "routed"))
MOE_BF16_TOL = 5e-2   # atol = rtol, the JAX suite's MoE bound (test_pallas_moe.py:140-142)
MOE_FP32_TOL = 1e-5
MOE_W_ULPS = 4        # route weights: within 4 fp32 ulp when not bitwise (two exp builds)
# fp32 cases, TF32 off: (T, E, H, F, top_k, activation, capacity factor or None
# for dropless, dead expert or None)
MOE_FP32_CASES = (
    (37, 4, 64, 96, 1, "silu_gated", None, None),    # top_k 1; T off every tile
    (45, 6, 72, 136, 2, "gelu", 1.25, None),         # capacity overflow: choices dropped
    (33, 4, 64, 128, 2, "silu_gated", None, 2),      # a dead expert
    (70, 8, 40, 200, 2, "silu_gated", 1.25, 0),      # expert 0 dead (slot 0 empty), drops
    (3000, 8, 64, 64, 2, "silu_gated", 1.25, None),  # the route over 3 chunks of 1024 tokens
)
# bf16 edge cases at mixtral-8x7b's widths, (T, capacity factor or None for
# dropless, dead expert or None): the first capacity of the wave form, a
# split-form wave, many row tiles an expert, a dead expert, and capacity
# factor 1.0, which drops choices
MOE_EDGE_CASES = ((17, None, None), (300, None, None), (4096, None, None), (512, None, 3),
                  (512, 1.0, None))
# bf16 cases of the wave form at small widths, off its tiles (H and F off
# 64 and 128, T off 64), as MOE_FP32_CASES
MOE_BF16_SMALL_CASES = (
    (40, 4, 136, 200, 2, "gelu", None, None),
    (37, 4, 64, 96, 1, "silu_gated", None, None),
    (150, 8, 72, 136, 2, "silu_gated", 1.25, 0),
)
# route edge cases, (T, E, top_k, capacity factor or None for dropless,
# dead expert or None), fp32 logits and their bf16 rounding: both forms of the
# kernel (one warp up to 32 tokens, a block above, chunks of 1024 tokens),
# Mixtral's E 8, the generic form's E 4 and 40, dropped choices and dead
# experts
MOE_ROUTE_EDGE_CASES = (
    (1, 8, 2, None, None), (1, 40, 1, None, None), (32, 8, 2, 1.25, 3), (32, 4, 1, 1.0, None),
    (33, 8, 2, None, None), (33, 40, 2, 1.25, None), (1024, 8, 2, 1.0, None),
    (1024, 4, 1, None, 2), (1025, 8, 2, None, 5), (1025, 40, 1, None, None),
    (1025, 40, 2, 1.0, 7),
)
# the FFN kernel's decode form serves up to 16 slots an expert, its wave
# form more (csrc/moe_ffn.cu launch_pass): read here only to count each
MOE_DECODE_FORM_SLOTS = 16
MOE_SWEEP_T = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# two sweeps on one card moved split / fused at one T by up to 1.7% (PERF.md):
# a lead under 2% counts as a tie
MOE_SWEEP_MARGIN = 0.02
# ZeRO++ wire quantizer cases: (groups, group size, dtype, values); the
# tinyllama-1.1b shards at world 2 and group 256: the qwZ gather of an MLP
# shard (gate_proj [5632, 2048] split on dim 0) and of the embedding shard,
# the qgZ reduce-scatter of the MLP gradient ([2, chunk] rows); the short and
# long group sizes; zero rows, exact .5 ties, -0.0 and subnormal inputs
QUANT_CASES = {
    "mlp-shard-2816x2048-bf16": (2816 * 2048 // 256, 256, "bfloat16", "randn"),
    "mlp-shard-2816x2048-fp32": (2816 * 2048 // 256, 256, "float32", "randn"),
    "embed-shard-16000x2048-bf16": (16000 * 2048 // 256, 256, "bfloat16", "randn"),
    "mlp-grad-rs-2x5767168-bf16": (2 * 5767168 // 256, 256, "bfloat16", "randn"),
    "gs1-fp32": (4096, 1, "float32", "randn"),
    "gs7-bf16": (3000, 7, "bfloat16", "randn"),
    "gs100-fp32": (2000, 100, "float32", "randn"),
    "gs255-bf16": (2000, 255, "bfloat16", "randn"),
    "gs4096-fp32": (512, 4096, "float32", "randn"),
    "gs4096-bf16": (512, 4096, "bfloat16", "randn"),
    "edge-gs256-fp32": (64, 256, "float32", "edge"),
    "edge-gs255-bf16": (64, 255, "bfloat16", "edge"),
}
MAIN_QUANT = "mlp-shard-2816x2048-bf16"
# the divide sweep: (x, scale) pairs through the row kernel's quantize (a
# multiply by the scale's reciprocal; the divide near half-integers) against
# the plain version's correctly rounded divide
QUANT_SWEEP_PAIRS, QUANT_SWEEP_ROWS = 10 ** 8, 65536
# [zero]: two ranks on the one card train tinyllama-1.1b (full width and
# depth, S 2048) with ZeRO-3 and the ZeRO++ int8 wire on the barrier
# schedule, micro 4 a rank: the 8 x 2048 tokens a step of [train]. The
# backend is named here: NCCL refuses two ranks on one device (found on the
# card), so the ranks use gloo, which moves every CUDA tensor through host
# memory; NCCL between separate cards waits for a machine with more than one
# card
ZERO_BACKEND = "gloo"
ZERO_WORLD, ZERO_WARMUP, ZERO_STEPS = 2, 1, 3
ZERO_TIMEOUT = 900     # seconds for the ranks: a hung rank fails the run
ZERO_CONFIG = {"train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True},
               "gradient_clipping": 1.0,
               "optimizer": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.1}},
               "zero_optimization": {"stage": 3, "zero_quantized_weights": True,
                                     "zero_quantized_gradients": True, "overlap_comm": False}}
ZERO_PLAIN_CONFIG = dict(ZERO_CONFIG, zero_optimization={"stage": 3, "overlap_comm": False})
ZERO_ZEROPP_TOL = 0.05   # rtol = atol: the JAX suite's ZeRO++ bound (test_zeropp.py:113)
# [zero-overlap]: in the same ranks, after the barrier run, the layer-pipelined
# overlap schedule at full width and depth under the JAX package's default
# ZeRO++ config (overlap_comm unset: true at stage 3), 1 warm-up and 2 timed
# steps on the same seeded batch; then at 2 layers, same width, plain stage 3
# on the schedule at full width (overlap_comm written true, the transport's
# defaults off) against two barrier runs, and the ZeRO++ schedule's first
# block reduce-scatter against the int8 rounding bound
ZERO_OVERLAP_CONFIG = dict(ZERO_CONFIG, zero_optimization={
    "stage": 3, "zero_quantized_weights": True, "zero_quantized_gradients": True})
ZERO_OVERLAP_WARMUP, ZERO_OVERLAP_STEPS = 1, 2
ZERO_S3_BARRIER_CONFIG = dict(ZERO_CONFIG, zero_optimization={"stage": 3, "overlap_comm": False},
                              comm_transport={"enabled": False})
ZERO_S3_OVERLAP_CONFIG = dict(ZERO_CONFIG, zero_optimization={"stage": 3, "overlap_comm": True},
                              comm_transport={"enabled": False})
INT8_GROUP, INT8_SLACK = 256, 1e-4   # the wire's group; fp32 rounding of x / scale, q * scale
# [checkpoint]: phase 7's engine saves a tag, an engine from another seed
# loads it, and both take CKPT_STEPS more steps, which must agree bit for
# bit; an async save; keep-last-CKPT_KEEP over three tags of a 2-layer model
# of the same width. [zero] saves rank files of its 2-layer ZeRO-3 engine and
# loads them at stage 1 (ZERO_STAGE1_CONFIG) and on one device
CKPT_STEPS, CKPT_KEEP, CKPT_DISK_MARGIN = 2, 2, 1.05
ZERO_STAGE1_CONFIG = dict(ZERO_CONFIG, zero_optimization={"stage": 1})
# [zero-ef]: in the same ranks, after the checkpoint: the overlap schedule at
# full width and depth under ZERO_OVERLAP_CONFIG with error feedback, 1
# warm-up and 2 timed steps on [zero-overlap]'s batch. Then at 2 layers, same
# width: JAX's telescoping test (EF_MICROS accumulated micro steps of
# distinct batches on plain stage 3 on the schedule, the full-width wire,
# the plain int8 wire and error feedback; EF_SEQ tokens a row, since the
# wire's bytes follow the params), and the error-feedback engine through the
# kernels and through their plain versions
ZERO_EF_CONFIG = dict(ZERO_OVERLAP_CONFIG, comm_transport={"error_feedback": True})
EF_MICROS, EF_SEQ = 8, 512
EF_S3 = dict(ZERO_CONFIG, gradient_accumulation_steps=EF_MICROS, zero_optimization={
    "stage": 3, "overlap_comm": True, "stage3_param_persistence_threshold": 0})
EF_RUNS = {"full": dict(EF_S3, comm_transport={"enabled": False}), "plain": EF_S3,
           "ef": dict(EF_S3, comm_transport={"error_feedback": True})}
EF_GAIN, EF_SCALE = 1.3, 0.01   # JAX test_error_feedback_carry_telescopes's bounds
# [onebit]: then the 1-bit optimizers in the same ranks, pure data
# parallelism (params replicated, local gradients), each at full width and
# ONEBIT_LAYERS: onebit_adam and onebit_lamb at freeze_step 1 (one warm-up
# step on the full-width all-reduce and two compressed steps), zero_one_adam
# at its defaults (it syncs each of its first 3 steps). 1-bit Adam ran at
# full depth until a whole run of this script took 1127.9 s of command
# (its 22 layers: 18.8 s of it, a peak of 29.34 GiB a rank); the depth is
# cut to keep the script inside its limit on a slow host. At
# freeze_step 1 the frozen variance is one step's, so a compressed step moves
# an element by lr x scale / sqrt(v), large where the gradient was small: at
# lr 1e-4 a CPU rehearsal (llama2-tiny, two ranks) saw the loss rise after
# the first compressed step, at 1e-5 fall
ONEBIT_LR, ONEBIT_STEPS = 1e-5, 3
# each run's last step, a compressed one whose errors carry the steps before,
# is held against a plain fp32 transcription of the JAX formulas on the same
# local gradients and state (``onebit_reference``), on every leaf of at most
# ONEBIT_CHECK_NUMEL elements (the attention projections and the norms):
# master, moments, worker and
# server errors within ONEBIT_TOL, but for at most ONEBIT_FLIPS of a leaf
# (the CPU test's rule: a sign flips where a compensated value lies within an
# ulp or so of zero)
ONEBIT_CHECK_NUMEL, ONEBIT_TOL, ONEBIT_FLIPS = 2 ** 24, 1e-5, 1e-4
ONEBIT_LAYERS = PATH_LAYERS
ONEBIT_RUNS = (("onebit_adam", {"freeze_step": 1}), ("onebit_lamb", {"freeze_step": 1}),
               ("zero_one_adam", {}))
# Mixtral serving: mixtral-8x7b at full width, depth cut to 24 of 32 layers
# (65.4 GiB of bf16 weights; 32 layers would need 87 GiB); the logits check
# at 2 layers of the same width, against an fp32 copy
MIXTRAL_LAYERS, MIXTRAL_LOGIT_LAYERS = 24, 2
# [families]: the decoder families of models/gpt2.py, opt_phi_falcon.py and
# bloom_neox_gptj.py, each at its named preset's full width; Phi-2 trains at
# full depth (micro 8: ~37 GiB of bf16 params, fp32 master, moments and
# grads, 49.24 GiB at peak on an NVIDIA H100 80GB HBM3 at 700.00 W),
# Falcon-7B serves at full depth, and every family runs 2 layers through
# the kernels and through their plain versions
FAMILY_MODELS = {"gpt2-xl": "gpt2", "opt-6.7b": "opt", "phi-2": "phi", "falcon-7b": "falcon",
                 "bloom-7b1": "bloom", "gpt-neox-20b": "gpt_neox",
                 "gpt-neo-2.7b": "gpt_neo", "gpt-j-6b": "gptj"}
# the families served at full width and depth, and the form their waves take
FAMILY_SERVED = {"falcon-7b": "cuda_cores", "bloom-7b1": "tensor_cores",
                 "gpt-neo-2.7b": "tensor_cores"}
PHI2_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=8)
# the tiny decoder presets, all at head_dim 16: one training step through the
# kernels and one through their plain versions, and one served request
TINY_FAMILIES = {"opt-tiny": "opt", "phi-tiny": "phi", "falcon-tiny": "falcon",
                 "bloom-tiny": "bloom", "gpt-neox-tiny": "gpt_neox",
                 "gpt-neo-tiny": "gpt_neo", "gptj-tiny": "gptj"}
TINY_PROMPT, TINY_NEW_TOKENS = 20, 8
# [open-llama]: open-llama-3b (26 layers, hidden 3200, 32 heads of head_dim
# 100, 3.43e9 params) at full width and depth, phase 7's configuration
OPEN_LLAMA_MICRO, OPEN_LLAMA_STEPS = 8, 3
HEAD_DIM_AB_ROUNDS = 3   # packed heads against zero-padded copies, A B B A
FAMILY_PATH_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=1)
# [encoders]: bert-large MLM at full width and depth (24 layers, hidden
# 1024, 16 heads of 64, FFN 4096, vocab 30522), S 512, bf16, AdamW, remat
# full; padded rows (lengths drawn in 128-512), two token types, 15% of the
# real positions labelled
BERT_SEQ, BERT_MICRO, BERT_STEPS = 512, 32, 5
BERT_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=BERT_MICRO)
REMAT_STEPS = 2   # timed steps a policy, after one warm-up
REMAT_POLICIES = ("full", "nothing_saveable", "attention_only", "dots_saveable",
                  "checkpoint_dots", "dots_with_no_batch_dims_saveable",
                  "checkpoint_dots_with_no_batch_dims", "everything_saveable", "alternating")
# the task heads through initialize: (preset, body, task, head style, S, micro, optimizer)
TASK_CASES = (("bert-base", "bert", "sequence_classification", "bert", 128, 32, "AdamW"),
              ("bert-base", "bert", "token_classification", "bert", 128, 32, "AdamW"),
              ("bert-base", "bert", "question_answering", "bert", 384, 16, "AdamW"),
              ("roberta-base", "roberta", "sequence_classification", "roberta", 128, 32,
               "MuAdamW"))
TASK_STEPS = 3
FAMILY_LOGIT_PROMPT = 300    # tokens of the 2-layer serving logits check (2 chunks)
# MoE training (``[moe-train]``): the MoE operator with its backward at
# mixtral-8x7b's widths at the training step's call and at
# MOE_TRAIN_FUSED_T tokens (``moe_train_cases``); then mixtral-8x7b at full
# width, 2 of its 32 layers, trained
MOE_TRAIN_FUSED_T = 256
MOE_TRAIN_GRAD_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}   # atol = rtol
# the operator's output: bf16 at the [moe] bound; fp32 at 1e-4, not [moe]'s
# 1e-5 (set at its small shapes): the kernel and the plain version add 4096
# and 14336 fp32 products in two orders (8.7e-5 at T 4096, the first run),
# as FLASH_GRAD_FP32_TOL's sums over 2048 keys
MOE_TRAIN_FWD_TOL = {"torch.bfloat16": MOE_BF16_TOL, "torch.float32": 1e-4}
MOE_TRAIN_D_AUX = 0.7   # the cotangent on aux
MOE_TRAIN_SEED = 3      # the phase's own generator: the earlier draws stay as they were
MOE_TRAIN_LAYERS, MOE_TRAIN_WARMUP, MOE_TRAIN_STEPS = 2, 1, 3
# micro 4 (T 8192 a MoE call, capacity 1280): micro 2 peaked at 50.72 GiB
# beside 41.33 GiB of state (a probe run of this phase)
MOE_TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True},
                    "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.1}},
                    "gradient_clipping": 1.0}
# kernels against plain: at lr 3e-4 the 2-layer full-width model's repeated
# batch is memorised in one Adam step (11.19 -> 3.81) and the loss then
# rises (4.24), and the two paths part at the third step (4.9e-2, 9.6e-2 at
# micro 2): all three steps are held to PATH_RTOL at lr 3e-5, the first two
# at lr 3e-4; the third at lr 3e-4 within MOE_TRAIN_WITNESS_RATIO times the
# largest step-3 gap of witnesses that change only rounding
# (MOE_TRAIN_WITNESSES: one router element one ulp off moved it 1.9e-2,
# one component on its plain version at a time 2.2e-2 and 2.8e-2, the plain
# path again 0, in the first run)
MOE_TRAIN_PATH_LR = 3e-5
MOE_TRAIN_WITNESS_RATIO = 3
# the witnesses at lr 3e-4, each against the plain path: the plain path
# again; the plain path with one element of layer 0's router one bf16 ulp
# off; the kernels with the MoE kernels on their plain versions; the
# kernels with flash and Adam on theirs. (name, plain flash + Adam, plain
# MoE, nudged router)
MOE_TRAIN_WITNESSES = (("plain again", True, True, False),
                       ("plain, router 1 ulp off", True, True, True),
                       ("kernels, plain MoE", False, True, False),
                       ("kernels, plain flash and Adam", True, False, False))
# [seq-parallel]: two ranks on the one card (gloo, as [zero]) train
# tinyllama-1.1b at full width over a seq axis of 2, depth cut to SEQ_LAYERS
# of its 22 layers so that the script, grown by [zero-overlap], ends well
# inside its time limit (the witness over the whole sequence on one rank at
# the same depth), max_seq_len
# raised to SEQ_LEN (no width changes): global S 16384, micro 1, so a rank
# holds 8192 tokens; bf16, AdamW, clipping 1.0, ZeRO stage 1 over data x
# seq, remat per block, lr 1e-4 (at 3e-4 the fourth step's loss rises above
# the first on this repeated batch, for one rank over the whole sequence as
# for the two ranks). Forms: Ulysses, the ring at the default int8 hop
# width, the ring at full width. A form takes a warm-up, SEQ_STEPS timed
# steps and one with its collectives timed: one timed step, not three,
# since gloo moves 3.7-3.9 GB a step (8.3 with Ulysses' all-to-alls) through
# host memory, 10-20 s a step on an NVIDIA H100 80GB HBM3 at 700.00 W, and
# the whole script has to end inside its time limit
SEQ_LEN, SEQ_WORLD, SEQ_WARMUP, SEQ_STEPS, SEQ_LAYERS = 16384, 2, 1, 1, 11
SEQ_TIMEOUT = 600      # seconds for the ranks: a hung rank fails the run
SEQ_CONFIG = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": True},
              "gradient_clipping": 1.0,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.1}},
              "zero_optimization": {"stage": 1}, "topology": {"seq": SEQ_WORLD}}
# form: (seq_parallel, comm_transport)
SEQ_FORMS = {"ulysses": ("ulysses", {}), "ring-int8": ("ring", {}),
             "ring-full": ("ring", {"permute_width": "full"})}
# the flash calls of the forms at their shapes: a ring hop's (a rank's
# 8192 queries against another rank's 8192 keys, 32 / 4 heads of 64, a
# cotangent on the LSE as the merge gives it) at q_offset +8192 (keys all
# in the past), 0 (the diagonal) and -8192 (all in the future: O = 0, LSE =
# MASK_VALUE), and Ulysses' (the whole sequence, 16 / 2 heads a rank)
SEQ_FLASH_CASES = {
    "ring-hop-past": (1, 8192, 8192, 32, 4, 64, {"q_offset": 8192, "dlse": True}),
    "ring-hop-diagonal": (1, 8192, 8192, 32, 4, 64, {"q_offset": 0, "dlse": True}),
    "ring-hop-future": (1, 8192, 8192, 32, 4, 64, {"q_offset": -8192, "dlse": True}),
    "ulysses-s16384": (1, 16384, 16384, 16, 2, 64, {}),
}
# a hop's K (or V) block: [1, 8192, 4, 64] bf16 in groups of 256
SEQ_HOP_GROUPS = (8192 * 4 * 64 // 256, 256)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_ms(torch, fn, iters, flush, spin=SPIN_CYCLES, clean=False):
    """(device ms, host ms) per call of ``fn``, L2 flushed before each call:
    by writing the 64 MB ``flush`` buffer, which leaves the L2 full of
    dirty lines that the call's own reads evict to HBM (every timed row), or
    with ``clean`` by reading it (clean lines: a streaming kernel's reads
    then have HBM to themselves).

    A spin kernel keeps the device busy while the host enqueues every
    (flush, event, fn, event) group, so each event pair brackets the
    device time of ``fn`` alone and none of the host time it takes to
    launch it; that host time is returned separately. Fails if the host
    outran the spin (the device would have idled between events)."""
    wipe = (lambda: flush.view(torch.int64).sum()) if clean else flush.zero_
    wipe()   # first launches load their modules: keep them out
    fn()
    torch.cuda.synchronize()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    spin0, spin1 = ev(), ev()
    pairs = [(ev(), ev()) for _ in range(iters)]
    spin0.record()
    torch.cuda._sleep(spin)
    spin1.record()
    t0 = time.perf_counter()
    for start, end in pairs:
        wipe()
        start.record()
        fn()
        end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= spin0.elapsed_time(spin1):
        fail(f"timing: host enqueue {host_ms:.1f} ms outlasted the device spin")
    return (sum(s.elapsed_time(e) for s, e in pairs) / iters, host_ms / iters)


def synced_ms(torch, fn, iters):
    """ms per call of ``fn`` between events recorded around each call, the
    device synchronized before each: for functions that make the host wait
    (allocator calls of the plain flash versions), which ``device_ms``
    cannot hide behind its spin; host stalls inside a call count."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


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


def page_lists(torch, counts, shuffle, seed=0):
    """Disjoint pages of the pool for sequences of ``counts`` pages, page 0
    left out (the null block): consecutive, or with ``shuffle`` drawn from a
    seeded permutation. Returns (lists, pages in the pool)."""
    total = sum(counts)
    order = (torch.randperm(total, generator=torch.Generator().manual_seed(seed)) + 1
             if shuffle else torch.arange(1, total + 1)).tolist()
    lists, at = [], 0
    for n in counts:
        lists.append(order[at:at + n])
        at += n
    return lists, total + 2


def visible(pos, window):
    """Keys a query at ``pos`` sees: all before it, or its window's."""
    return pos + 1 if window <= 0 else min(pos + 1, window)


def wave_case(torch, build_wave, WaveEntry, seqs, kvH, g, D, ps, gen, shuffle=False,
              window=0):
    """Inputs of one ragged wave: seqs [(q_len, seen)], disjoint pages per
    sequence, descriptors from the port's wave builder. The bound counts
    the keys the queries see (under a window, from the first query's window
    on)."""
    tables, P = page_lists(torch, [-(-(seen + q_len) // ps) for q_len, seen in seqs], shuffle)
    entries = [WaveEntry(uid, [0] * q_len, seen, tables[uid])
               for uid, (q_len, seen) in enumerate(seqs)]
    desc = build_wave(entries, block_q=8, block_size=ps)
    dev, bf16 = "cuda", torch.bfloat16
    H = kvH * g
    k = torch.randn(kvH, P, ps, D, generator=gen, device=dev).to(bf16)
    v = torch.randn(kvH, P, ps, D, generator=gen, device=dev).to(bf16)
    q = torch.randn(len(desc.tokens), H, D, generator=gen, device=dev).to(bf16)
    t = lambda a: torch.from_numpy(a).to(dev)
    args = (q, k, v, t(desc.kv_lens), t(desc.page_indices), t(desc.cu_q_lens))
    n = desc.n_tokens
    kv_tokens = sum(seen + q_len - (seen + 1 - visible(seen, window)) for q_len, seen in seqs)
    pairs = sum(visible(seen + t_, window) for q_len, seen in seqs for t_ in range(q_len))
    nbytes = (2 * n * H * D + 2 * kvH * kv_tokens * D) * 2 \
        + 4 * (desc.kv_lens.size * 2 + 1 + desc.page_indices.size)
    flops = 4 * pairs * H * D
    return args, n, nbytes, flops


def decode_case(torch, ctxs, kvH, g, D, ps, gen, shuffle=False, window=0):
    dev, bf16 = "cuda", torch.bfloat16
    mp = max(-(-c // ps) for c in ctxs)
    lists, P = page_lists(torch, [-(-c // ps) for c in ctxs], shuffle)
    tables = [pages + [0] * (mp - len(pages)) for pages in lists]
    H = kvH * g
    k = torch.randn(kvH, P, ps, D, generator=gen, device=dev).to(bf16)
    v = torch.randn(kvH, P, ps, D, generator=gen, device=dev).to(bf16)
    q = torch.randn(len(ctxs), H, D, generator=gen, device=dev).to(bf16)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    tab = torch.tensor(tables, dtype=torch.int32, device=dev)
    keys = sum(visible(c - 1, window) for c in ctxs)
    nbytes = (2 * len(ctxs) * H * D + 2 * kvH * keys * D) * 2 \
        + 4 * (len(ctxs) + len(ctxs) * mp)
    flops = 4 * keys * H * D
    return (q, k, v, ctx, tab), nbytes, flops


def case_options(case):
    """(seqs or contexts, kvH, g, D, page size, shuffle, window) of a
    WAVE_CASES or DECODE_CASES entry."""
    first, kvH, g, D, *opt = case
    opt = opt[0] if opt else {}
    return (first, kvH, g, D, opt.get("ps", PAGE_SIZE), opt.get("shuffle", False),
            opt.get("window", 0))


def case_masks(torch, case):
    """The keyword arguments of a case's ALiBi slopes (BLOOM's, fp32 on the
    card) and window, for the wrappers and their plain versions alike."""
    _, kvH, g, _, *opt = case
    opt = opt[0] if opt else {}
    kw = {}
    if opt.get("alibi"):
        from deepspeed_tpu_torch.ops.transformer.attention import alibi_slopes
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes(kvH * g)).cuda()
    if opt.get("window"):
        kw["window"] = opt["window"]
    return kw


def masks_note(kw):
    """How a paged case's print names its ALiBi slopes and window."""
    return "".join([", ALiBi" if "alibi_slopes" in kw else "",
                    f", window {kw['window']}" if "window" in kw else ""])


def sdpa_context_ms(torch, flush, q, k_pages, v_pages, tables, q_lens, ctxs):
    """Device ms of one ``scaled_dot_product_attention`` over the same
    attention with the K/V pages gathered into contiguous [B, kvH, C, D]
    tensors first (the gather not timed): causal from the bottom right for
    a wave of B equal fresh chunks (q [B * T, H, D]), a key mask by context
    for a decode batch (q [B, H, D]). A context time, not the same
    function: it needs its K/V contiguous."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import _gather_pages
    B, T = len(ctxs), q_lens[0]
    C = max(ctxs)
    k = _gather_pages(k_pages, tables)[:, :, :C].contiguous()
    v = _gather_pages(v_pages, tables)[:, :, :C].contiguous()
    qs = q[:B * T].view(B, T, q.shape[1], q.shape[2]).transpose(1, 2).contiguous()
    if T > 1:
        fn = lambda: F.scaled_dot_product_attention(qs, k, v, is_causal=True)
    else:
        mask = (torch.arange(C, device=q.device)[None, :] <
                torch.as_tensor(ctxs, device=q.device)[:, None])[:, None, None, :]
        fn = lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask)
    return device_ms(torch, fn, 20, flush)[0]


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


def device_ops(torch, fn):
    """Kernels and memsets one call of ``fn`` puts on the device, as the
    profiler records them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


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
    print(f"[profile] {sum(e.count for e in kernels)} launches", flush=True)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the twelve longest, and the paged-attention and MoE route and gather
    # kernels wherever they rank
    always = ("wave_wgmma", "ragged_wave_kernel", "decode_split", "moe_route_",
              "moe_gather_kernel", "combine_kernel")
    for e in ranked[:12] + [e for e in ranked[12:] if any(n in e.key for n in always)]:
        ms = e.self_device_time_total / 1e3
        print(f"[profile]   {ms:9.2f} ms {ms / busy_ms:6.1%} x{e.count:6d} "
              f"{e.key[:90]}", flush=True)


# ---------------------------------------------------------------------------
# training kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_case(torch, flash, B, Sq, Sk, H, kvH, D, mask, dtype, gen):
    """Inputs, mask spec and the card's bound inputs of one flash case."""
    dev = "cuda"
    rnd = lambda *shape, std=1.0: (torch.randn(*shape, generator=gen, device=dev)
                                   * std).to(dtype)
    q = rnd(B, Sq, H, D, std=mask.get("q_std", 1.0))
    k, v, do = rnd(B, Sk, kvH, D), rnd(B, Sk, kvH, D), rnd(B, Sq, H, D)
    seg = (torch.randint(0, 3, (B, Sk), generator=gen, device=dev).to(torch.int32)
           if mask.get("segments") else None)
    if mask.get("padding"):
        lens = torch.randint(Sk // 4, Sk + 1, (B, 1), generator=gen, device=dev)
        seg = (torch.arange(Sk, device=dev)[None, :] < lens).to(torch.int32)
    slopes = None
    if mask.get("alibi"):
        slopes = 2.0 ** (-8.0 * torch.arange(1, H + 1, device=dev, dtype=torch.float32) / H)
    spec = flash.mask_spec(q, k, causal=mask.get("causal", True), scale=mask.get("scale"),
                           segment_ids=seg,
                           q_segment_ids=None if seg is None else seg[:, :Sq],
                           alibi_slopes=slopes, window=mask.get("window"),
                           q_offset=mask.get("q_offset"))
    dlse = (torch.randn(B, H, Sq, generator=gen, device=dev) if mask.get("dlse") else None)
    # visible (query, key) pairs: the work the data needs
    qp = torch.arange(Sq, device=dev)[:, None] + spec.q_offset
    kp = torch.arange(Sk, device=dev)[None, :]
    vis = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
    if spec.causal:
        vis = qp >= kp
        if spec.window > 0:
            vis = vis & (qp - kp < spec.window)
    vis = vis[None].expand(B, Sq, Sk)
    if seg is not None:
        vis = vis & (spec.qseg[:, :, None] == spec.kseg[:, None, :])
    pairs = int(vis.sum()) * H
    return (q, k, v, do, dlse, spec), pairs


def sdpa_mask(torch, spec, Sq, Sk, H, dtype):
    """``scaled_dot_product_attention``'s mask arguments for ``spec``: a
    bidirectional call with segment ids (a padding mask) takes the same
    mask as a boolean [B, 1, Sq, Sk]; a causal call ``is_causal``, or with
    ALiBi or a window the same mask as an explicit ``attn_mask`` (an
    additive [H, Sq, Sk] bias for ALiBi, a boolean [Sq, Sk] for a window)."""
    if not spec.causal:
        if spec.qseg is None:
            return {}
        return {"attn_mask": (spec.qseg[:, :, None] == spec.kseg[:, None, :])[:, None]}
    if spec.slopes is None and spec.window <= 0:
        return {"is_causal": True}
    qp = torch.arange(Sq, device="cuda")[:, None] + spec.q_offset
    kp = torch.arange(Sk, device="cuda")[None, :]
    vis = qp >= kp
    if spec.window > 0:
        vis = vis & (qp - kp < spec.window)
    if spec.slopes is None:
        return {"attn_mask": vis}
    bias = spec.slopes[:, None, None] * (kp - qp).float()
    return {"attn_mask": bias.masked_fill(~vis, float("-inf")).to(dtype)}


def flash_bounds(B, Sq, Sk, H, kvH, D, pairs, isz):
    """(bytes, flops) of forward, dQ and dK/dV: each input read once, each
    output written once; 2 flops per multiply-add of the products the
    visible pairs need (forward S, PV; dQ S, dP, dQ; dK/dV S, dP, dV, dK).
    With no visible pair the outputs do not depend on the inputs (O = 0,
    LSE = MASK_VALUE, dQ = dK = dV = 0): the bound is writing them."""
    qn, kn, rows = B * Sq * H * D, B * Sk * kvH * D, B * H * Sq * 4
    if pairs == 0:
        return {"flash_fwd": (qn * isz + rows, 0), "flash_dq": (qn * isz, 0),
                "flash_dkv": (2 * kn * isz, 0)}
    return {"flash_fwd": ((2 * qn + 2 * kn) * isz + rows, 4 * D * pairs),
            "flash_dq": ((3 * qn + 2 * kn) * isz + 2 * rows, 6 * D * pairs),
            "flash_dkv": ((2 * qn + 4 * kn) * isz + 2 * rows, 8 * D * pairs)}


def flash_single_launchers(torch, flash, q, k, v, o, lse, do, spec, prep=None):
    """The forward, the dQ and the dK/dV kernel launched alone, for timing
    (no counts), on the inputs as ``prep`` hands them over: the wrappers'
    ``flash._kernel_inputs`` by default, ``flash._pad8`` for the zero-padded
    design. The dQ launch writes di, which the dK/dV launch reads: it runs
    once here, so the dK/dV launch reads the di of these inputs."""
    from deepspeed_tpu_torch.ops.op_builder.builder import launch_check
    q, k, v, o, do = (prep or flash._kernel_inputs)(q, k, v, o, do)
    B, Sq, H, _ = q.shape
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    p = flash._params(q, k, v, spec)
    p.o, p.dout, p.lse, p.di = o.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr()
    fwd_fn, dq_fn, dkv_fn = flash._kernels()
    bf16 = int(q.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    out, lse_out = torch.empty_like(q), torch.empty_like(lse)
    keep = (di, dq, dk, dv, out, lse_out)

    def run_fwd():
        p.out0, p.out1 = keep[4].data_ptr(), keep[5].data_ptr()
        launch_check(fwd_fn(p, bf16, stream), "flash_fwd")

    def run_dq():
        p.out0 = keep[1].data_ptr()
        launch_check(dq_fn(p, bf16, stream), "flash_dq")

    def run_dkv():
        p.out0, p.out1 = keep[2].data_ptr(), keep[3].data_ptr()
        launch_check(dkv_fn(p, bf16, stream), "flash_dkv")
    run_dq()
    return run_fwd, run_dq, run_dkv


def flash_kernels_vs_plain(torch, flash, gen, flush):
    """Every flash case in bf16 and fp32: forward (O, LSE) and backward
    (dQ, dK, dV, from the plain forward's O and LSE) against the plain
    versions; the timed cases also against ``scaled_dot_product_attention``.
    Returns {kernel: row of the main case} and the max errors."""
    import torch.nn.functional as F
    rows, errs = {}, {"flash_fwd": [], "flash_dq": [], "flash_dkv": []}
    for name, (B, Sq, Sk, H, kvH, D, mask) in FLASH_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            b = B if dtype == torch.bfloat16 else min(B, 2)
            (q, k, v, do, dlse, spec), pairs = flash_case(torch, flash, b, Sq, Sk, H, kvH,
                                                          D, mask, dtype, gen)
            bf = dtype == torch.bfloat16
            tol, gtol = (BF16_TOL, BF16_TOL) if bf else (FP32_TOL, FLASH_GRAD_FP32_TOL)
            o, lse = flash.flash_fwd(q, k, v, spec)
            o_ref, lse_ref = flash.flash_fwd_reference(q, k, v, spec=spec)
            torch.cuda.synchronize()
            tag = f"flash/{name} {str(dtype)[6:]}"
            e_fwd = max(check_close(f"{tag} O", o, o_ref, tol),
                        check_close(f"{tag} LSE", lse, lse_ref, tol))
            if spec.q_offset < 0:
                dead = -spec.q_offset
                if bool(o[:, :dead].any()) or bool((lse[:, :, :dead] != flash.MASK_VALUE).any()):
                    fail(f"{tag}: rows with no visible key must give O = 0, LSE = MASK_VALUE")
            grads = flash.flash_bwd(q, k, v, o_ref, lse_ref, do, dlse, spec)
            want = flash.flash_bwd_reference(q, k, v, o_ref, lse_ref, do, dlse, spec=spec)
            torch.cuda.synchronize()
            if name in FLASH_BITWISE and bf:
                again = flash.flash_fwd(q, k, v, spec)
                if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
                    fail(f"{tag}: two runs of the forward gave different O or LSE bits")
                again = flash.flash_bwd(q, k, v, o_ref, lse_ref, do, dlse, spec)
                if not all(bool(torch.equal(a, b_)) for a, b_ in zip(grads, again)):
                    fail(f"{tag}: two runs of the backward gave different dQ, dK or dV bits")
                print(f"[flash] {name} bf16: two runs of the forward give the same O and LSE "
                      f"bits, two of the backward the same dQ, dK and dV bits", flush=True)
                del again
            e_dq = check_close(f"{tag} dQ", grads[0], want[0], gtol)
            e_dkv = max(check_close(f"{tag} dK", grads[1], want[1], gtol),
                        check_close(f"{tag} dV", grads[2], want[2], gtol))
            if bf:
                errs["flash_fwd"].append(e_fwd)
                errs["flash_dq"].append(e_dq)
                errs["flash_dkv"].append(e_dkv)
            print(f"[flash] {name} {str(dtype)[6:]} B{b} Sq{Sq} Sk{Sk} H{H} kvH{kvH} D{D} "
                  f"{sorted(k_ for k_ in mask)}: max_abs_err fwd {e_fwd:.3e} dQ {e_dq:.3e} "
                  f"dK/dV {e_dkv:.3e}", flush=True)
            if bf and name in FLASH_TIMED:
                run_fwd, run_dq, run_dkv = flash_single_launchers(torch, flash, q, k, v, o_ref,
                                                                  lse_ref, do, spec)
                # the forward as a caller runs it (the wrapper call, as in
                # every earlier slice), and its kernel alone beside it
                ms = {"flash_fwd": device_ms(torch, lambda: flash.flash_fwd(q, k, v, spec),
                                             10, flush)[0],
                      "flash_dq": device_ms(torch, run_dq, 10, flush)[0],
                      "flash_dkv": device_ms(torch, run_dkv, 10, flush)[0]}
                fwd_alone = device_ms(torch, run_fwd, 10, flush)[0]
                if D % 8:
                    # the design the wrappers do not take at this head_dim:
                    # zero-padded copies (the forward's q, k, v; the
                    # backward's q, k, v, O, dO) into the kernels at the
                    # next multiple of 8, against packed heads read in place
                    pad = [device_ms(torch, f, 10, flush)[0] for f in flash_single_launchers(
                        torch, flash, q, k, v, o_ref, lse_ref, do, spec, flash._pad8)]
                    pad_fwd = device_ms(torch, lambda: flash._pad8(q, k, v), 10, flush)[0]
                    pad_bwd = device_ms(torch, lambda: flash._pad8(q, k, v, o_ref, do), 10,
                                        flush)[0]
                    print(f"[flash]   {name} head_dim {D}: packed heads read in place (the "
                          f"wrappers' form) kernels fwd {fwd_alone:.4f} dQ {ms['flash_dq']:.4f} "
                          f"dK/dV {ms['flash_dkv']:.4f} ms; zero-padded to {D + 8 - D % 8}: "
                          f"kernels fwd {pad[0]:.4f} dQ {pad[1]:.4f} dK/dV {pad[2]:.4f} ms, "
                          f"copies of the forward's q, k, v {pad_fwd:.4f} ms, of the "
                          f"backward's q, k, v, O, dO {pad_bwd:.4f} ms", flush=True)
                # the whole backward as a caller runs it: di and both launches
                bwd_ms = device_ms(torch, lambda: flash.flash_bwd(
                    q, k, v, o_ref, lse_ref, do, None, spec), 10, flush)[0]
                plain_fwd = synced_ms(torch, lambda: flash.flash_fwd_reference(
                    q, k, v, spec=spec), 3)
                plain_bwd = synced_ms(torch, lambda: flash.flash_bwd_reference(
                    q, k, v, o_ref, lse_ref, do, None, spec=spec), 3)
                qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                              for x in (q, k, v))
                dot = do.transpose(1, 2).contiguous()
                sdpa_kw = sdpa_mask(torch, spec, Sq, Sk, H, q.dtype)
                sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=spec.scale,
                                                              enable_gqa=kvH != H, **sdpa_kw)
                lib_fwd = device_ms(torch, sdpa, 10, flush)[0]
                lib_fb = device_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                                      dot), 10, flush)[0]
                print(f"[flash]   {name} whole backward (flash_bwd: di, dQ, dK/dV): "
                      f"{bwd_ms:.4f} ms; scaled_dot_product_attention backward "
                      f"{lib_fb - lib_fwd:.4f} ms", flush=True)
                bnd = flash_bounds(b, Sq, Sk, H, kvH, D, pairs, q.element_size())
                lib = {"flash_fwd": lib_fwd, "flash_dq": lib_fb - lib_fwd,
                       "flash_dkv": lib_fb - lib_fwd}
                plain = {"flash_fwd": plain_fwd, "flash_dq": plain_bwd, "flash_dkv": plain_bwd}
                for kname in ms:
                    b_ms, b_by = bound(*bnd[kname], dtype)
                    row = dict(ms=ms[kname], plain_ms=plain[kname], bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib[kname])
                    if name == MAIN_FLASH:
                        rows[kname] = row
                    alone = (f" (the wrapper call; the kernel alone {fwd_alone:.4f})"
                             if kname == "flash_fwd" else "")
                    print(f"[flash]   {name} {kname}: kernel_ms {ms[kname]:.4f}{alone} plain_ms "
                          f"{plain[kname]:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms "
                          f"{lib[kname]:.4f} (bound / kernel {b_ms / ms[kname]:.1%})",
                          flush=True)
            del q, k, v, do, o, lse, o_ref, lse_ref, grads, want
    print("[flash] plain_ms: events around each synchronized call of the plain "
          "version; for dQ and dK/dV the plain backward, which computes "
          "both; library_ms is scaled_dot_product_attention (is_causal, enable_gqa; "
          "ALiBi, windows and bert-large's padding mask as an explicit attn_mask): "
          "forward, and for dQ and dK/dV its backward (forward+backward less forward), "
          "which also computes both", flush=True)
    return rows, {k: max(v) for k, v in errs.items()}


def adam_bucket(torch, sizes, m_dtype, gen):
    """A flat bucket of leaves: one leaf as it is, several leaves each
    zero-padded to a multiple of 128 elements (the optimizer's layout)."""
    from deepspeed_tpu_torch.ops.adam.adam import lane_padded
    segs = sizes if len(sizes) == 1 else [lane_padded(n) for n in sizes]
    dev = "cuda"
    parts = {"g": [], "p": [], "m": [], "v": []}
    for n, seg in zip(sizes, segs):
        vals = {"g": torch.randn(n, generator=gen, device=dev),
                "p": torch.randn(n, generator=gen, device=dev) * 0.02,
                "m": torch.randn(n, generator=gen, device=dev) * 1e-3,
                "v": torch.rand(n, generator=gen, device=dev) * 1e-6}
        for key, x in vals.items():
            parts[key].append(torch.nn.functional.pad(x, (0, seg - n)))
    cat = {key: torch.cat(xs) for key, xs in parts.items()}
    return (cat["g"].to(torch.bfloat16), cat["p"], cat["m"].to(m_dtype),
            cat["v"].to(m_dtype))


def adam_kernel_vs_plain(torch, adam, gen, flush):
    """Each Adam case: the kernel against the plain version on the same
    bucket, moments bitwise (the SR bits included), master and cast within
    MASTER_RTOL; the main case timed with torch's fused AdamW beside it."""
    rows, errs = {}, []
    step, lr, wd = 5, 3e-4, 0.1
    gscale = torch.full((), 0.37, dtype=torch.float32, device="cuda")
    bcd1, bcd2 = adam._bias_corrections(step, 0.9, 0.999)
    for b_idx, (name, (sizes, mode, mdt)) in enumerate(ADAM_CASES.items()):
        m_dtype = getattr(torch, mdt)
        g, p, m, v = adam_bucket(torch, sizes, m_dtype, gen)
        seeds = dict(seed_m=adam.sr_seed(step, 1, b_idx), seed_v=adam.sr_seed(step, 2, b_idx))
        pdt = None if mode == "lamb" else torch.bfloat16
        kernel = lambda: adam.adam_bucket_update(
            g, p, m, v, step=step, lr=lr, weight_decay=wd, mode=mode, grad_scale=gscale,
            m_dtype=m_dtype, v_dtype=m_dtype, param_dtype=pdt, **seeds)
        plain = lambda: adam.adam_bucket_reference(
            g, p, m, v, lr=lr, bcd1=bcd1, bcd2=bcd2, gscale=gscale, beta1=0.9, beta2=0.999,
            eps=1e-8, weight_decay=wd, mode=mode, m_dtype=m_dtype, v_dtype=m_dtype,
            param_dtype=pdt, sr=True, **seeds)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for i, part in ((2, "exp_avg"), (3, "exp_avg_sq")):
            if not torch.equal(got[i].view(torch.int16) if m_dtype == torch.bfloat16
                               else got[i], want[i].view(torch.int16)
                               if m_dtype == torch.bfloat16 else want[i]):
                fail(f"adam/{name}: {part} differs from the plain version")
        err = (got[0] - want[0]).abs().max().item()
        if bool(((got[0] - want[0]).abs() > MASTER_RTOL * want[0].abs()).any()):
            fail(f"adam/{name}: master max |err| {err:.3e} beyond rtol {MASTER_RTOL}")
        if pdt is not None and not torch.equal(got[1].float(), want[1].float()):
            fail(f"adam/{name}: param cast differs from the plain version")
        errs.append(err)
        line = (f"[adam] {name}: {sum(sizes)} elements in {len(sizes)} leaves, moments "
                f"bitwise, master max_abs_err {err:.3e} (bitwise "
                f"{bool(torch.equal(got[0], want[0]))})")
        if name == MAIN_ADAM:
            n = g.numel()
            nbytes = n * (2 + 4 + 4 + 4) + n * (4 + 4 + 4 + 2)
            flops = 18 * n
            ms = device_ms(torch, kernel, 20, flush)[0]
            plain_ms = device_ms(torch, plain, 5, flush, PLAIN_SPIN)[0]
            p32 = torch.nn.Parameter(p.clone())
            p32.grad = g.float()
            opt = torch.optim.AdamW([p32], lr=lr, weight_decay=wd, fused=True)
            opt.step()   # creates its state
            lib = device_ms(torch, opt.step, 20, flush)[0]
            b_ms, b_by = bound(nbytes, flops, torch.float32)
            rows = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib)
            line += (f"\n[adam]   kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
                     f"{b_ms:.4f} ({b_by}) library_ms {lib:.4f} (torch.optim.AdamW "
                     f"fused, fp32 grads) ({b_ms / ms:.1%} of bound)")
            del opt, p32
        print(line, flush=True)
    return rows, max(errs)


def lion_kernel_vs_plain(torch, lion, adam, gen, flush):
    """Each Lion case: the kernel against the plain version on the same
    bucket: moment (the SR bits included), master and cast bitwise; the main
    case timed. PyTorch has no Lion: no library time."""
    rows, errs = {}, []
    step, lr = 5, 1e-4
    gscale = torch.full((), 0.37, dtype=torch.float32, device="cuda")
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for b_idx, (name, (sizes, wd, mdt)) in enumerate(LION_CASES.items()):
        m_dtype = getattr(torch, mdt)
        g, p, m, _ = adam_bucket(torch, sizes, m_dtype, gen)
        seed = adam.sr_seed(step, 1, b_idx)
        kernel = lambda: lion.lion_bucket_update(
            g, p, m, lr=lr, beta1=0.9, beta2=0.99, weight_decay=wd, grad_scale=gscale,
            seed_m=seed, m_dtype=m_dtype, param_dtype=torch.bfloat16)
        plain = lambda: lion.lion_bucket_reference(
            g, p, m, lr=lr, gscale=gscale, beta1=0.9, beta2=0.99, weight_decay=wd,
            seed_m=seed, m_dtype=m_dtype, param_dtype=torch.bfloat16, sr=True)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for i, part in ((0, "master"), (1, "param cast"), (2, "exp_avg")):
            if not torch.equal(bits(got[i]), bits(want[i])):
                fail(f"lion/{name}: {part} differs from the plain version")
        moved = (got[0] - p).abs().max().item()
        if not moved > 0:
            fail(f"lion/{name}: the step moved nothing")
        errs.append((got[0] - want[0]).abs().max().item())
        line = (f"[lion] {name}: {sum(sizes)} elements in {len(sizes)} leaves, wd {wd}, "
                f"master, cast and moment bitwise (largest step {moved:.3e})")
        if name == MAIN_LION:
            n = g.numel()
            nbytes = n * (2 + 4 + 4) + n * (4 + 4 + 2)
            ms = device_ms(torch, kernel, 20, flush)[0]
            plain_ms = device_ms(torch, plain, 5, flush, PLAIN_SPIN)[0]
            b_ms, b_by = bound(nbytes, 10 * n, torch.float32)
            rows = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None)
            line += (f"\n[lion]   kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
                     f"{b_ms:.4f} ({b_by}) library_ms null (PyTorch has no Lion) "
                     f"({b_ms / ms:.1%} of bound)")
        print(line, flush=True)
    return rows, max(errs)


def woq_inputs(torch, M, K, N, gs, dtype, gen):
    """Random int8 weights in the ``quantize_kernel`` layout, scales of the
    size a 0.02-normal kernel gives, and activations."""
    G = K // gs
    q = torch.randint(-127, 128, (G, gs, N), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    scale = (torch.rand(G, 1, N, generator=gen, device="cuda") + 0.5) * 5e-4
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    return x, q, scale


def woq_kernel_vs_plain(torch, woq, quantization, gen, flush):
    """The WOQ matmul kernel against its plain version: bf16 at the llama2-7b
    shapes, fp32 at small ones, every case run twice for equal bits; times
    at every bf16 case, and the row sweep against the non-kernel form."""
    import torch.nn.functional as F
    rows, errs = {}, []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M, K, N, gs in WOQ_FP32_CASES:
        x, q, scale = woq_inputs(torch, M, K, N, gs, torch.float32, gen)
        got, again = woq.woq_matmul(x, q, scale), woq.woq_matmul(x, q, scale)
        want = woq.woq_matmul_reference(x, q, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, again):
            fail(f"woq fp32 M{M} K{K} N{N} gs{gs}: two runs differ")
        if not bool(got.isfinite().all()) or err > WOQ_FP32_RTOL * want.abs().max().item():
            fail(f"woq fp32 M{M} K{K} N{N} gs{gs}: max |err| {err:.3e} beyond "
                 f"{WOQ_FP32_RTOL} x max |ref| {want.abs().max().item():.3e}")
        print(f"[woq] fp32 M{M} K{K} N{N} gs{gs} (G {K // gs}): max_abs_err {err:.3e} "
              f"(max |ref| {want.abs().max().item():.3e}), two runs bit-identical",
              flush=True)
    for name, (K, N, gs) in WOQ_CASES.items():
        for M in WOQ_ROWS:
            x, q, scale = woq_inputs(torch, M, K, N, gs, torch.bfloat16, gen)
            got, again = woq.woq_matmul(x, q, scale), woq.woq_matmul(x, q, scale)
            want = woq.woq_matmul_reference(x, q, scale)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
                fail(f"woq/{name} M{M}: two runs differ")
            err = check_close(f"woq/{name} M{M}", got, want)
            errs.append(err)
            G = K // gs
            nbytes = K * N + G * N * 4 + (M * K + M * N) * 2
            b_ms, b_by = bound(nbytes, 2 * M * K * N, torch.bfloat16)
            ms, host = device_ms(torch, lambda: woq.woq_matmul(x, q, scale), 20, flush)
            clean_ms = device_ms(torch, lambda: woq.woq_matmul(x, q, scale), 20, flush,
                                 clean=True)[0]
            plain_ms = device_ms(torch, lambda: woq.woq_matmul_reference(x, q, scale), 5,
                                 flush)[0]
            w = torch.randn(N, K, generator=gen, device="cuda").to(torch.bfloat16)
            dense_ms, dense_host = device_ms(torch, lambda: F.linear(x, w), 20, flush)
            del w
            if (name, M) == (MAIN_WOQ, MAIN_WOQ_ROWS):
                rows = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None)
            mma, _, splits = woq.launch_plan(x, q, sms)
            print(f"[woq] {name} M{M} {'tensor' if mma else 'CUDA'} cores, splits {splits}: "
                  f"max_abs_err {err:.3e}, two runs bit-identical; kernel_ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms null "
                  f"dense_bf16_linear_ms {dense_ms:.4f} ({b_ms / ms:.1%} of bound; after a "
                  f"clean L2 flush kernel_ms {clean_ms:.4f}, {b_ms / clean_ms:.1%}) "
                  f"wrapper_host_ms {host:.4f} (F.linear's {dense_host:.4f})",
                  flush=True)
    K, N, gs = WOQ_CASES[MAIN_WOQ]
    for M in WOQ_SWEEP_ROWS:
        x, q, scale = woq_inputs(torch, M, K, N, gs, torch.bfloat16, gen)
        qp = {"q": q, "scale": scale}
        want = woq.woq_matmul_reference(x, q, scale)
        k_err = check_close(f"woq sweep M{M}", woq.woq_matmul(x, q, scale), want)
        n_err = check_close(f"woq sweep M{M} non-kernel form",
                            quantization.dequant_matmul(x, qp), want, WOQ_NON_KERNEL_TOL)
        k_ms = device_ms(torch, lambda: woq.woq_matmul(x, q, scale), 20, flush)[0]
        n_ms = device_ms(torch, lambda: quantization.dequant_matmul(x, qp), 10, flush)[0]
        print(f"[woq-sweep] {MAIN_WOQ} M{M}: kernel_ms {k_ms:.4f} non_kernel_ms "
              f"{n_ms:.4f} (dequantize the leaf to bf16, then torch.matmul); max_abs_err "
              f"from the plain version: kernel {k_err:.3e} (tol {BF16_TOL}), non-kernel "
              f"{n_err:.3e} (tol {WOQ_NON_KERNEL_TOL}); WOQ_KERNEL_MAX_ROWS is "
              f"{quantization.WOQ_KERNEL_MAX_ROWS}", flush=True)
    edge = torch.Generator(device="cuda").manual_seed(EDGE_SEED)   # gen's draws stay as they were
    for M, K, N, gs in WOQ_EDGE_CASES:
        x, q, scale = woq_inputs(torch, M, K, N, gs, torch.bfloat16, edge)
        got, again = woq.woq_matmul(x, q, scale), woq.woq_matmul(x, q, scale)
        want = woq.woq_matmul_reference(x, q, scale)
        torch.cuda.synchronize()
        tag = f"woq edge M{M} K{K} N{N} gs{gs}"
        if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
            fail(f"{tag}: two runs differ")
        errs.append(check_close(tag, got, want))
        mma, per, splits = woq.launch_plan(x, q, sms)
        if not mma:
            fail(f"{tag}: not on the tensor cores")
        print(f"[woq] {tag}: tensor cores, {splits} splits of {per} groups, max_abs_err "
              f"{errs[-1]:.3e}, two runs bit-identical", flush=True)
    print("[woq] library_ms is null: no single PyTorch call computes a groupwise-int8 "
          "matmul; dense_bf16_linear_ms is F.linear on bf16 weights of the same "
          "(M, K, N), context only", flush=True)
    return rows, max(errs)


# ---------------------------------------------------------------------------
# the ZeRO++ int8 wire quantizer against its plain version
# ---------------------------------------------------------------------------


def quant_inputs(torch, case, gen):
    """The groups of one [quant] case, [G, gs] in the case's dtype."""
    G, gs, dt, kind = case
    x = torch.randn(G, gs, generator=gen, device="cuda") * 0.02
    if kind == "edge":
        # zero rows; rows whose scale is exactly 2**k (absmax 127 * 2**k) with
        # exact .5 ties between the integers; -0.0
        x[0::4] = 0.0
        ties = (torch.arange(gs, device="cuda") % 254 - 127).float() + 0.5
        for r in range(1, G, 4):
            k = float(2.0 ** (r % 7 - 3))
            x[r] = ties * k
            x[r, 0] = 127.0 * k
        x[2::4, ::3] = -0.0
        # subnormal inputs: rows of them (the scale underflows and its
        # reciprocal overflows), and subnormal values in rows of normal ones
        x[3::8] *= 1e-38
        x[7::8, ::5] *= 1e-38
    return x.to(getattr(torch, dt))


def quant_divide_sweep(torch, quant):
    """QUANT_SWEEP_PAIRS or more (x, scale) pairs through the row kernel
    against the plain version, q and scale bitwise: fp32 rows of 256 whose
    scales span 2^-60 ... 2^60 (the first value of a row pins its absmax at
    127 scales), half the values at or within 1e-4 of a half-integer of x /
    scale, half anywhere between. Returns (pairs, pairs within 2^-12 of a
    half-integer, where the kernel divides)."""
    gen = torch.Generator(device="cuda").manual_seed(EDGE_SEED + 2)   # the phase's own draws
    rows, gs = QUANT_SWEEP_ROWS, 256
    eps = torch.tensor([0.0, 1e-7, -1e-7, 3e-6, -3e-6, 2e-5, -2e-5, 1e-4], device="cuda",
                       dtype=torch.float64)
    done = near = 0
    while done < QUANT_SWEEP_PAIRS:
        s = torch.exp2(torch.rand(rows, 1, generator=gen, device="cuda", dtype=torch.float64)
                       * 120 - 60)
        k = torch.randint(-127, 127, (rows, gs), generator=gen, device="cuda").double()
        tie = torch.rand(rows, gs, generator=gen, device="cuda") < 0.5
        pick = eps[torch.randint(0, len(eps), (rows, gs), generator=gen, device="cuda")]
        off = torch.rand(rows, gs, generator=gen, device="cuda", dtype=torch.float64)
        x = ((k + torch.where(tie, 0.5 + pick, off)) * s).float()
        x[:, 0] = (127 * s[:, 0]).float() * torch.where(tie[:, 0], 1.0, -1.0)
        q, sc = quant.quantize_rows_int8(x)
        qp, sp = quant.quantize_rows_int8_reference(x)
        torch.cuda.synchronize()
        if not (torch.equal(q, qp) and torch.equal(sc.view(torch.int32), sp.view(torch.int32))):
            bad = (q != qp).nonzero()[:4].tolist()
            fail(f"quant divide sweep: the kernel differs from the plain version at {bad}")
        z = x.double() / sp.double()[:, None]
        near += int(((z - z.floor() - 0.5).abs() < 2.0 ** -12).sum())
        done += rows * gs
    return done, near


def quant_bounds(G, gs, isz):
    """Bytes of one row-quantize: each input read once, q and scale written
    once; ~3 operations an element (abs and max, divide, round and clip)."""
    return G * gs * isz + G * gs + 4 * G, 3 * G * gs


def quant_kernel_vs_plain(torch, quant, gen, flush):
    """Each [quant] case: the kernel against the plain version on the same
    groups, q and scale byte-identical; every case timed beside its bound
    and the plain version. Returns the main case's row and the largest
    difference from the plain version over every case, q and scale."""
    row, err = None, 0.0
    for name, case in QUANT_CASES.items():
        G, gs, dt, _ = case
        x = quant_inputs(torch, case, gen)
        q, s = quant.quantize_rows_int8(x)
        qp, sp = quant.quantize_rows_int8_reference(x)
        torch.cuda.synchronize()
        if not torch.equal(q, qp):
            d = (q != qp).nonzero()[:4].tolist()
            fail(f"quant {name}: q differs from the plain version at {d}")
        if not torch.equal(s.view(torch.int32), sp.view(torch.int32)):
            fail(f"quant {name}: scale differs from the plain version "
                 f"({int((s != sp).sum())} rows)")
        err = max(err, (q.int() - qp.int()).abs().max().item(), (s - sp).abs().max().item())
        nbytes, ops = quant_bounds(G, gs, x.element_size())
        ms = device_ms(torch, lambda: quant.quantize_rows_int8(x), 10, flush)[0]
        plain_ms = synced_ms(torch, lambda: quant.quantize_rows_int8_reference(x), 3)
        b_ms, b_by = bound(nbytes, ops, torch.float32)
        isz = x.element_size()
        plan = quant.plan_rows(G, gs, isz, (gs * isz) % 16 == 0 and x.data_ptr() % 16 == 0,
                               torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"[quant] {name}: groups {G} x {gs} {dt} (plan {plan}), q and scale byte-identical; "
              f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}, "
              f"{nbytes} bytes) ({b_ms / ms:.1%} of bound)", flush=True)
        if name == MAIN_QUANT:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
            clean_ms = device_ms(torch, lambda: quant.quantize_rows_int8(x), 10, flush,
                                 clean=True)[0]
            print(f"[quant] {name}: after a clean L2 flush kernel_ms {clean_ms:.4f} "
                  f"({b_ms / clean_ms:.1%} of bound)", flush=True)
    pairs, near = quant_divide_sweep(torch, quant)
    print(f"[quant] divide sweep: {pairs} (x, scale) pairs, scales 2^-60 ... 2^60, {near} of them "
          f"within 2^-12 of a half-integer of x / scale (the kernel divides there): q and scale "
          f"bitwise the plain version's correctly rounded divide", flush=True)
    print("[quant] library_ms: no single PyTorch call computes a groupwise absmax int8 "
          "quantize (torch.quantize_per_channel takes the scales as given)", flush=True)
    return row, err


# ---------------------------------------------------------------------------
# mixture-of-experts kernels against their plain versions
# ---------------------------------------------------------------------------


def moe_weights(torch, E, H, F, activation, dtype, gen):
    """Router and expert weights, normal(0, 0.02), in the port's layout."""
    rnd = lambda *s: (torch.randn(*s, generator=gen, device="cuda") * 0.02).to(dtype)
    w = {"gate": rnd(H, E), "wo": rnd(E, H, F)}
    if activation == "silu_gated":
        w["wi_gate"], w["wi_up"] = rnd(E, F, H), rnd(E, F, H)
    else:
        w["wi"] = rnd(E, F, H)
    return w


def moe_ffn_args(w, activation):
    gated = activation == "silu_gated"
    return (w["wi_gate"] if gated else w["wi"], w["wi_up"] if gated else None, w["wo"])


def moe_route_vs_plain(torch, moe, logits, top_k, cap, tag):
    """The route kernel against its plain version (bf16 logits: the plain
    route of their fp32 cast): src and slot_tk (picks, positions and keep
    flags of the kept choices) and ce bitwise, the weights bitwise or within
    MOE_W_ULPS ulp, me to MOE_FP32_TOL; a second run bit-identical. Returns
    the kernel's outputs, whether the weights were bitwise and their max abs
    error."""
    got = moe.moe_route(logits, top_k=top_k, capacity=cap)
    again = moe.moe_route(logits, top_k=top_k, capacity=cap)
    want = moe.moe_route_reference(logits.float(), top_k=top_k, capacity=cap)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"moe_route {tag}: two runs differ")
    for i, name in ((0, "src"), (2, "slot_tk"), (5, "ce")):
        if not torch.equal(got[i], want[i]):
            d = (got[i] != want[i]).nonzero()[:4].flatten().tolist()
            fail(f"moe_route {tag}: {name} differs from the plain version at {d}: "
                 f"{got[i].flatten()[d].tolist()} != {want[i].flatten()[d].tolist()}")
    err = 0.0
    for i, name in ((1, "slot_w"), (3, "w_tk")):
        d = (got[i] - want[i]).abs()
        if bool((d > MOE_W_ULPS * 2.0 ** -23 * want[i].abs()).any()):
            fail(f"moe_route {tag}: {name} beyond {MOE_W_ULPS} ulp (max |err| {d.max():.3e})")
        err = max(err, d.max().item())
    if bool(((got[4] - want[4]).abs() > MOE_FP32_TOL * want[4].abs()).any()):
        fail(f"moe_route {tag}: me beyond rtol {MOE_FP32_TOL}")
    bitwise = torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    return got, bitwise, err


def moe_case_vs_plain(torch, moe, w, tokens, top_k, cap, activation, tol, tag):
    """Route, gather, fused FFN + combine, split FFN and combine of one case
    against their plain versions, each FFN form run twice for equal bits,
    and fused against split bitwise. Returns
    (route outputs, payload, errors by kernel, route weights bitwise)."""
    T, H = tokens.shape
    E = w["gate"].shape[1]
    logits = tokens @ w["gate"]   # bf16 for bf16 tokens, as the forward routes them
    (src, slot_w, slot_tk, w_tk, _, _), wbits, werr = moe_route_vs_plain(
        torch, moe, logits, top_k, cap, tag)
    payload = moe.moe_dispatch_gather(tokens, src)
    again = moe.moe_dispatch_gather(tokens, src)
    want = tokens.index_select(0, (src.long() - 1).clamp_min(0))
    torch.cuda.synchronize()
    if not torch.equal(payload.view(torch.uint8), want.view(torch.uint8)):
        fail(f"moe_dispatch_gather {tag}: payload not byte-identical to index_select")
    if not torch.equal(payload.view(torch.uint8), again.view(torch.uint8)):
        fail(f"moe_dispatch_gather {tag}: two runs differ")
    del again
    p3 = payload.view(E, cap, H)
    wg, wu, wo = moe_ffn_args(w, activation)
    fused = moe.moe_ffn_combine(p3, wg, wu, wo, src, slot_w, T, activation=activation)
    y = moe.moe_ffn(p3, wg, wu, wo, src, activation=activation)
    y_plain = moe.moe_ffn_reference(p3, wg, wu, wo, src, activation=activation)
    fused_plain = moe.moe_ffn_combine_reference(p3, wg, wu, wo, src, slot_w, T,
                                                activation=activation)
    fused_again = moe.moe_ffn_combine(p3, wg, wu, wo, src, slot_w, T, activation=activation)
    y_again = moe.moe_ffn(p3, wg, wu, wo, src, activation=activation)
    split = moe.moe_combine(y.view(E * cap, H), slot_tk, w_tk)
    comb = moe.moe_combine(y_plain.view(E * cap, H), slot_tk, w_tk)
    comb_plain = moe.moe_combine_reference(y_plain.view(E * cap, H), slot_tk, w_tk)
    torch.cuda.synchronize()
    if not (torch.equal(fused, fused_again) and torch.equal(y, y_again)):
        fail(f"moe_ffn {tag}: two runs differ")
    del fused_again, y_again
    empty = (src.view(E, cap) == 0)
    if bool(y[empty].any()):
        fail(f"moe_ffn {tag}: rows of empty slots are not zero")
    errs = {"moe_route": werr,
            "moe_dispatch_gather": (payload.float() - want.float()).abs().max().item(),
            "moe_ffn_combine": check_close(f"moe_ffn_combine {tag}", fused, fused_plain, tol),
            "moe_ffn": check_close(f"moe_ffn {tag}", y, y_plain, tol)}
    if not torch.equal(comb, comb_plain):
        fail(f"moe_combine {tag}: differs from the plain version on the same y")
    errs["moe_combine"] = (comb - comb_plain).abs().max().item()
    if not torch.equal(fused, split):
        fail(f"moe {tag}: fused and split outputs differ (max |d| "
             f"{(fused - split).abs().max().item():.3e})")
    return (src, slot_w, slot_tk, w_tk), payload, errs, wbits


def gather_int8_vs_plain(torch, moe, tokens, src, tag):
    """The int8 dispatch gather, mask_pad off and on, against its plain
    version and against the row-quantizer kernel on the gathered rows: q and
    scale byte-identical to both and to a second run. Returns the largest
    difference from the plain version, q and scale."""
    from deepspeed_tpu_torch.ops.quantizer import quant
    err = 0.0
    for mask in (False, True):
        q, sc = moe.moe_dispatch_gather_int8(tokens, src, mask_pad=mask)
        q2, s2 = moe.moe_dispatch_gather_int8(tokens, src, mask_pad=mask)
        qp, sp = moe.moe_dispatch_gather_int8_reference(tokens, src, mask_pad=mask)
        rows = tokens.index_select(0, (src.long() - 1).clamp_min(0))
        if mask:
            rows = torch.where((src > 0)[:, None], rows, torch.zeros_like(rows))
        q1, s1 = quant.quantize_rows_int8(rows)
        torch.cuda.synchronize()
        for other, what in (((q2, s2), "a second run"), ((qp, sp), "its plain version"),
                            ((q1, s1), "quantize_rows_int8 of the gathered rows")):
            if not (torch.equal(q, other[0])
                    and torch.equal(sc.view(torch.int32), other[1].view(torch.int32))):
                fail(f"moe_dispatch_gather_int8 {tag} mask_pad {mask}: q / scale differ "
                     f"from {what}")
        err = max(err, (q.int() - qp.int()).abs().max().item(), (sc - sp).abs().max().item())
    return err


def moe_bounds(torch, src, E, cap, T, H, F, top_k, activation, isz):
    """(bytes, flops) of each MoE kernel on these inputs: each input read
    once, each output written once; the FFN counts the filled slots' flops
    (6 H F a slot gated, 4 H F gelu) and the weights of the experts that
    received a token; the combine the rows of the kept choices (a dropped
    one weighs 0: the row it reads adds nothing; dropless, all T x k)."""
    S = E * cap
    filled = int((src > 0).sum())
    live = int((src.view(E, cap)[:, 0] > 0).sum())
    nmat = 3 if activation == "silu_gated" else 2
    flops = filled * 2 * nmat * H * F
    weights = live * nmat * H * F * isz
    return {"moe_route": (T * E * isz + S * 8 + T * top_k * 8 + E * 8, 0),
            "moe_dispatch_gather": (T * H * isz + S * 4 + S * H * isz, 0),
            "moe_dispatch_gather_int8": (T * H * isz + S * 4 + S * H + S * 4, 3 * S * H),
            "moe_ffn_combine": (weights + filled * H * isz + S * 8 + T * H * 4, flops),
            "moe_ffn": (weights + filled * H * isz + S * 4 + S * H * 4, flops),
            "moe_combine": (filled * H * 4 + T * top_k * 8 + T * H * 4, 0)}


def moe_calls(torch, moe, tokens, logits, route, p3, y, w, k, cap, act, int8=False):
    """{kernel: (kernel call, plain call, library call or None)} of the MoE
    kernels on one routed case: the route of ``logits``, the gather of
    ``tokens`` by the route's ``src`` (and with ``int8`` the int8 gather,
    mask_pad on), both FFN forms over the payload ``p3``, the combine of
    ``y``; the library calls are ``index_select`` for the gather and
    ``F.embedding_bag`` (mode sum, the route's weights as per-sample
    weights) for the combine."""
    src, slot_w, slot_tk, w_tk = route
    T = tokens.shape[0]
    wg, wu, wo = moe_ffn_args(w, act)
    slot_l = slot_tk.long()
    calls = {
        "moe_route": (lambda: moe.moe_route(logits, top_k=k, capacity=cap),
                      lambda: moe.moe_route_reference(logits, top_k=k, capacity=cap), None),
        "moe_dispatch_gather": (lambda: moe.moe_dispatch_gather(tokens, src),
                                lambda: moe.moe_dispatch_gather_reference(tokens, src),
                                lambda: tokens.index_select(0, (src.long() - 1).clamp_min(0)))}
    if int8:
        calls["moe_dispatch_gather_int8"] = (
            lambda: moe.moe_dispatch_gather_int8(tokens, src, mask_pad=True),
            lambda: moe.moe_dispatch_gather_int8_reference(tokens, src, mask_pad=True), None)
    return {
        **calls,
        "moe_ffn_combine": (
            lambda: moe.moe_ffn_combine(p3, wg, wu, wo, src, slot_w, T, activation=act),
            lambda: moe.moe_ffn_combine_reference(p3, wg, wu, wo, src, slot_w, T,
                                                  activation=act), None),
        "moe_ffn": (lambda: moe.moe_ffn(p3, wg, wu, wo, src, activation=act),
                    lambda: moe.moe_ffn_reference(p3, wg, wu, wo, src, activation=act), None),
        "moe_combine": (lambda: moe.moe_combine(y, slot_tk, w_tk),
                        lambda: moe.moe_combine_reference(y, slot_tk, w_tk),
                        lambda: torch.nn.functional.embedding_bag(
                            slot_l, y, per_sample_weights=w_tk, mode="sum"))}


def moe_kernels_vs_plain(torch, moe, gen, flush):
    """The five MoE kernels against their plain versions: fp32 at small
    shapes (TF32 off), then bf16 at mixtral-8x7b's widths for a decode step
    and two prefill waves, timed; then the fused-vs-split sweep. Returns
    {kernel: row} (fused-form kernels at the decode step, split-form ones at
    the 512-token wave) and the max errors in bf16."""
    from deepspeed_tpu_torch.moe.sharded_moe import capacity
    for T, E, H, F, top_k, act, cf, dead in MOE_FP32_CASES:
        w = moe_weights(torch, E, H, F, act, torch.float32, gen)
        tokens = torch.randn(T, H, generator=gen, device="cuda")
        if dead is not None:   # a constant feature that pushes one logit 100 below the rest
            tokens[:, 0] = 1.0
            w["gate"][0, dead] = -100.0
        cap = capacity(T, E, cf if cf else float(E), 4 if cf else 1)
        tag = f"fp32 T{T} E{E} H{H} F{F} k{top_k} {act} cap {cap}"
        (src, *_), _, errs, wbits = moe_case_vs_plain(torch, moe, w, tokens, top_k, cap, act,
                                                      MOE_FP32_TOL, tag)
        gather_int8_vs_plain(torch, moe, tokens, src, tag)
        filled = int((src > 0).sum())
        print(f"[moe] {tag}: slots filled {filled}/{E * cap} of {T * top_k} choices; route "
              f"bitwise (weights {'bitwise' if wbits else 'within ulp'}), payload "
              f"byte-identical, fused {errs['moe_ffn_combine']:.3e} split "
              f"{errs['moe_ffn']:.3e} from plain, combine bitwise, fused == split bitwise, "
              f"int8 gather byte-identical (mask_pad off and on)", flush=True)
    rows, errs_all = {}, {}
    E, H, F, k, act = MOE_E, MOE_H, MOE_F, MOE_K, "silu_gated"
    w = moe_weights(torch, E, H, F, act, torch.bfloat16, gen)
    wg, wu, wo = moe_ffn_args(w, act)
    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0), 10, flush)[0]
    print(f"[moe] launch floor: an empty kernel (torch.cuda._sleep(0)) takes {floor_ms:.4f} ms "
          f"between device_ms's events", flush=True)
    for T in MOE_TOKENS:
        tokens = torch.randn(T, H, generator=gen, device="cuda").to(torch.bfloat16)
        cap = capacity(T, E, float(E), 1)
        tag = f"bf16 T{T} cap {cap}"
        (src, slot_w, slot_tk, w_tk), payload, errs, wbits = moe_case_vs_plain(
            torch, moe, w, tokens, k, cap, act, MOE_BF16_TOL, tag)
        errs["moe_dispatch_gather_int8"] = gather_int8_vs_plain(torch, moe, tokens, src, tag)
        for name, e in errs.items():
            errs_all[name] = max(errs_all.get(name, 0.0), e)
        logits = tokens @ w["gate"]
        p3 = payload.view(E, cap, H)
        y = moe.moe_ffn(p3, wg, wu, wo, src, activation=act).view(E * cap, H)
        calls = moe_calls(torch, moe, tokens, logits, (src, slot_w, slot_tk, w_tk), p3, y, w,
                          k, cap, act, int8=True)
        bag = calls["moe_combine"][2]
        bnd = moe_bounds(torch, src, E, cap, T, H, F, k, act, 2)
        if T == MOE_DECODE_T:
            # counted before any profiled phase: in this process, after the
            # serving profiles, the profiler records no short window
            ops = {aux: device_ops(torch, lambda: moe.make_moe_forward(
                top_k=k, capacity=cap, activation=act, with_aux=aux)(w, tokens))
                for aux in (False, True)}
            print(f"[moe] eager launches a MoE forward call at T {T}: {ops[False]} as serving "
                  f"builds it (bf16 router logits to the route, no aux), {ops[True]} asked for "
                  f"aux", flush=True)
        filled = int((src > 0).sum())
        print(f"[moe] {tag}: slots filled {filled}/{E * cap}, experts with a token "
              f"{int((src.view(E, cap)[:, 0] > 0).sum())}; route bitwise (weights "
              f"{'bitwise' if wbits else 'within ulp'}), payload byte-identical, max_abs_err "
              f"fused {errs['moe_ffn_combine']:.3e} split {errs['moe_ffn']:.3e}, combine "
              f"bitwise, fused == split bitwise, int8 gather byte-identical to its plain version "
              f"and to quantize_rows_int8 of the gathered rows", flush=True)
        times = {}
        for name, (kern, plain, lib) in calls.items():
            ms = times[name] = device_ms(torch, kern, 10, flush)[0]
            plain_ms = synced_ms(torch, plain, 3)
            lib_ms = device_ms(torch, lib, 10, flush)[0] if lib is not None else None
            b_ms, b_by = bound(*bnd[name], torch.bfloat16)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            # the int8 gather has no path: its row is at the prefill wave, mask_pad on
            fused_form = name in ("moe_route", "moe_dispatch_gather", "moe_ffn_combine")
            if T == (MOE_DECODE_T if fused_form else MOE_WAVE_T):
                rows[name] = row
            floor = (f"; launch floor {floor_ms:.4f}"
                     if name in ("moe_route", "moe_dispatch_gather") else "")
            print(f"[moe]   T{T} {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
                  f"{b_ms:.4f} ({b_by}) library_ms "
                  f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"({b_ms / ms:.1%} of bound){floor}", flush=True)
        gather_int8_times(torch, moe, tokens, src, f"T{T}", bnd["moe_dispatch_gather_int8"],
                          times["moe_dispatch_gather_int8"], flush)
        pair_ms = device_ms(torch, lambda: moe.moe_dispatch_gather(
            tokens, moe.moe_route(logits, top_k=k, capacity=cap)[0]), 10, flush)[0]
        clean_ms = device_ms(torch, calls["moe_dispatch_gather"][0], 10, flush, clean=True)[0]
        print(f"[moe]   T{T} route -> gather as one call: {pair_ms:.4f} ms (alone: route "
              f"{times['moe_route']:.4f} + gather {times['moe_dispatch_gather']:.4f} = "
              f"{times['moe_route'] + times['moe_dispatch_gather']:.4f}); gather after a clean "
              f"L2 flush {clean_ms:.4f}", flush=True)
        bag_err = (bag() - moe.moe_combine(y, slot_tk, w_tk)).abs().max().item()
        print(f"[moe]   T{T} F.embedding_bag against the combine: max_abs_diff {bag_err:.3e} "
              f"(it fuses each multiply and add; the combine rounds them apart)", flush=True)
        if T == MOE_WAVE_T:
            clean_ms = device_ms(torch, calls["moe_combine"][0], 10, flush, clean=True)[0]
            print(f"[moe]   T{T} moe_combine after a clean L2 flush: {clean_ms:.4f} ms", flush=True)
            pair_ms = device_ms(torch, lambda: moe.moe_combine(
                moe.moe_ffn(p3, wg, wu, wo, src, activation=act).view(E * cap, H), slot_tk,
                w_tk), 10, flush)[0]
            print(f"[moe]   T{T} split FFN -> combine as one call: {pair_ms:.4f} ms (alone: FFN "
                  f"{times['moe_ffn']:.4f} + combine {times['moe_combine']:.4f} = "
                  f"{times['moe_ffn'] + times['moe_combine']:.4f}; the combine waits for the "
                  f"FFN by programmatic dependent launch)", flush=True)
        mid = torch.empty(E, cap, F, dtype=torch.bfloat16, device="cuda")
        bmm = (device_ms(torch, lambda: torch.bmm(p3, wg.mT), 10, flush)[0],
               device_ms(torch, lambda: torch.bmm(p3, wu.mT), 10, flush)[0],
               device_ms(torch, lambda: torch.bmm(mid, wo.mT), 10, flush)[0])
        print(f"[moe]   T{T} context: torch.bmm over all {E * cap} slots, gate {bmm[0]:.4f} "
              f"up {bmm[1]:.4f} down {bmm[2]:.4f} ms (sum {sum(bmm):.4f})", flush=True)
        del mid, y, payload, p3
    combine_wide(torch, moe, flush)
    errs_all["moe_dispatch_gather_int8"] = max(errs_all["moe_dispatch_gather_int8"],
                                               gather_int8_wide(torch, moe, flush))
    print("[moe] library_ms: index_select for the dispatch gather, F.embedding_bag (mode sum, "
          "per-sample weights) for the slot-table combine; no single PyTorch call computes the "
          "route, the int8 gather (index_select of the same slots is timed beside it as "
          "context: it does not quantize) or the grouped FFN with its combine", flush=True)
    moe_sweep(torch, moe, w, gen, flush)
    edge = torch.Generator(device="cuda").manual_seed(EDGE_SEED)   # gen's draws stay as they were
    for T, cf, dead in MOE_EDGE_CASES:
        tokens = torch.randn(T, H, generator=edge, device="cuda").to(torch.bfloat16)
        wt = w
        if dead is not None:   # a constant feature that pushes one logit 100 below the rest
            tokens[:, 0] = 1.0
            wt = dict(w, gate=w["gate"].clone())
            wt["gate"][0, dead] = -100.0
        cap = capacity(T, E, cf if cf else float(E), 4 if cf else 1)
        tag = f"bf16 T{T} cap {cap}" + (f" cf {cf}" if cf else "") + (
            f" dead expert {dead}" if dead is not None else "")
        (src, *_), _, errs, _ = moe_case_vs_plain(torch, moe, wt, tokens, k, cap, act,
                                                  MOE_BF16_TOL, tag)
        for name in ("moe_ffn_combine", "moe_ffn"):
            errs_all[name] = max(errs_all.get(name, 0.0), errs[name])
        filled = int((src > 0).sum())
        per_expert = (src.view(E, cap) > 0).sum(dim=1).tolist()
        if dead is not None and per_expert[dead]:
            fail(f"moe {tag}: the dead expert received {per_expert[dead]} slots")
        print(f"[moe] {tag}: slots filled {filled}/{E * cap} of {T * k} choices, filled "
              f"slots an expert {per_expert}; max_abs_err fused "
              f"{errs['moe_ffn_combine']:.3e} split {errs['moe_ffn']:.3e}, two runs "
              f"bit-identical, fused == split bitwise", flush=True)
        del tokens, src
    for T, E, H, F, top_k, act, cf, dead in MOE_BF16_SMALL_CASES:
        w = moe_weights(torch, E, H, F, act, torch.bfloat16, edge)
        tokens = torch.randn(T, H, generator=edge, device="cuda").to(torch.bfloat16)
        if dead is not None:
            tokens[:, 0] = 1.0
            w["gate"][0, dead] = -100.0
        cap = capacity(T, E, cf if cf else float(E), 4 if cf else 1)
        tag = f"bf16 T{T} E{E} H{H} F{F} k{top_k} {act} cap {cap}"
        if cap <= MOE_DECODE_FORM_SLOTS:
            fail(f"moe {tag}: not a case of the wave form")
        (src, *_), _, errs, _ = moe_case_vs_plain(torch, moe, w, tokens, top_k, cap, act,
                                                  MOE_BF16_TOL, tag)
        print(f"[moe] {tag}: slots filled {int((src > 0).sum())}/{E * cap}; fused "
              f"{errs['moe_ffn_combine']:.3e} split {errs['moe_ffn']:.3e} from plain, "
              f"two runs bit-identical, fused == split bitwise", flush=True)
    for T, E, top_k, cf, dead in MOE_ROUTE_EDGE_CASES:
        logits = torch.randn(T, E, generator=edge, device="cuda")
        if dead is not None:
            logits[:, dead] = -100.0
        cap = capacity(T, E, cf if cf else float(E), 4 if cf else 1)
        tag = (f"route T{T} E{E} k{top_k} cap {cap}" + (f" cf {cf}" if cf else "")
               + (f" dead expert {dead}" if dead is not None else ""))
        (src, *_), wbits, _ = moe_route_vs_plain(torch, moe, logits, top_k, cap, tag)
        bf = logits.to(torch.bfloat16)
        got, bbits, _ = moe_route_vs_plain(torch, moe, bf, top_k, cap, tag + " bf16")
        if not all(torch.equal(a, b) for a, b in
                   zip(got, moe.moe_route(bf.float(), top_k=top_k, capacity=cap))):
            fail(f"moe_route {tag}: the route of bf16 logits differs from the route of "
                 f"their fp32 cast")
        per_expert = (src.view(E, cap) > 0).sum(dim=1).tolist()
        if dead is not None and per_expert[dead]:
            fail(f"moe_route {tag}: the dead expert received {per_expert[dead]} slots")
        print(f"[moe] {tag}: slots filled {sum(per_expert)} of {T * top_k} choices; fp32 and "
              f"bf16 logits bitwise the plain route (weights "
              f"{'bitwise' if wbits and bbits else 'within ulp'}), two runs bit-identical, "
              f"bf16 route == route of the fp32 cast", flush=True)
    return rows, errs_all


def gather_int8_times(torch, moe, tokens, src, tag, bnd, ms, flush):
    """The int8 gather's time (``ms``, under the write flush) beside its
    time after a clean flush, its bound and index_select of the same slots
    (context: it does not quantize), mask_pad on."""
    clean_ms = device_ms(torch, lambda: moe.moe_dispatch_gather_int8(tokens, src, mask_pad=True),
                         10, flush, clean=True)[0]
    idx = (src.long() - 1).clamp_min(0)
    sel_ms = device_ms(torch, lambda: tokens.index_select(0, idx), 10, flush)[0]
    b_ms, b_by = bound(*bnd, torch.float32)
    print(f"[moe]   {tag} moe_dispatch_gather_int8 {str(tokens.dtype)[6:]}: kernel_ms {ms:.4f} "
          f"({b_ms / ms:.1%} of bound), after a clean L2 flush {clean_ms:.4f} "
          f"({b_ms / clean_ms:.1%}); bound_ms {b_ms:.4f} ({b_by}, {bnd[0]} bytes); "
          f"index_select of the same slots {sel_ms:.4f} (context)", flush=True)


def gather_int8_wide(torch, moe, flush):
    """The int8 dispatch gather past MOE_TOKENS, from a generator of its own:
    MOE_GATHER_INT8_TIMED (mixtral widths, top-2, dropless), checked and
    timed, then MOE_GATHER_INT8_EDGE, checked: q and scale byte-identical to
    the plain version, to quantize_rows_int8 of the gathered rows and to a
    second run, mask_pad off and on. Returns the largest difference from the
    plain version."""
    g = torch.Generator(device="cuda").manual_seed(EDGE_SEED + 3)   # gen's draws stay as they were
    E, k, err = MOE_E, MOE_K, 0.0
    cases = [(T, MOE_H, dt, "routed", True) for T, dt in MOE_GATHER_INT8_TIMED]
    cases += [(T, H, dt, layout, False) for T, H, dt, layout in MOE_GATHER_INT8_EDGE]
    for T, H, dt, layout, timed in cases:
        dtype = getattr(torch, dt)
        buf = torch.randn(T * H + 1, generator=g, device="cuda").to(dtype)
        tokens = buf[1:].view(T, H) if layout == "offset" else buf[:T * H].view(T, H)
        tokens[T // 2] = 0.0   # a token row of zeros: scale 1 in every slot that reads it
        src = moe.moe_route(torch.randn(T, E, generator=g, device="cuda"), top_k=k,
                            capacity=T)[0]
        if layout == "empty":
            src = torch.zeros_like(src)
        tag = f"T{T} H{H} {dt} {layout}"
        err = max(err, gather_int8_vs_plain(torch, moe, tokens, src, tag))
        isz = tokens.element_size()
        vec = (H * isz) % 16 == 0 and tokens.data_ptr() % 16 == 0
        plan = moe.plan_gather_int8(src.numel(), H, isz, vec,
                                    torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"[moe] int8 gather {tag}: slots filled {int((src > 0).sum())}/{src.numel()} "
              f"(plan {plan}), q and scale byte-identical to its plain version, to "
              f"quantize_rows_int8 of the gathered rows and to a second run, mask_pad off and on",
              flush=True)
        if timed:
            ms = device_ms(torch, lambda: moe.moe_dispatch_gather_int8(tokens, src, mask_pad=True),
                           10, flush)[0]
            plain_ms = synced_ms(torch, lambda: moe.moe_dispatch_gather_int8_reference(
                tokens, src, mask_pad=True), 3)
            bnd = moe_bounds(torch, src, E, T, T, H, 0, k, "silu_gated", isz)
            print(f"[moe]   T{T} {dt} moe_dispatch_gather_int8: plain_ms {plain_ms:.4f}",
                  flush=True)
            gather_int8_times(torch, moe, tokens, src, f"T{T}",
                              bnd["moe_dispatch_gather_int8"], ms, flush)
        del buf, tokens, src
    return err


def combine_wide(torch, moe, flush):
    """The split combine alone at MOE_COMBINE_WIDE_T tokens (H 4096, top-2,
    dropless, S = 8 T; routed by the route kernel from seeded logits, y
    seeded): bitwise its plain version, timed beside F.embedding_bag and its
    bound."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(EDGE_SEED + 1)   # gen's draws stay as they were
    T, E, H, k = MOE_COMBINE_WIDE_T, MOE_E, MOE_H, MOE_K
    logits = torch.randn(T, E, generator=g, device="cuda")
    src, _, slot_tk, w_tk, _, _ = moe.moe_route(logits, top_k=k, capacity=T)
    y = torch.randn(E * T, H, generator=g, device="cuda")
    got = moe.moe_combine(y, slot_tk, w_tk)
    want = moe.moe_combine_reference(y, slot_tk, w_tk)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"moe_combine T{T}: not bitwise its plain version")
    slot_l = slot_tk.long()
    bag = lambda: F.embedding_bag(slot_l, y, per_sample_weights=w_tk, mode="sum")
    ms = device_ms(torch, lambda: moe.moe_combine(y, slot_tk, w_tk), 10, flush)[0]
    plain_ms = synced_ms(torch, lambda: moe.moe_combine_reference(y, slot_tk, w_tk), 3)
    lib_ms = device_ms(torch, bag, 10, flush)[0]
    b_ms, b_by = bound(*moe_bounds(torch, src, E, T, T, H, 0, k, "silu_gated", 2)["moe_combine"],
                       torch.float32)
    print(f"[moe]   T{T} moe_combine (bitwise): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"bound_ms {b_ms:.4f} ({b_by}) library_ms {lib_ms:.4f} (F.embedding_bag) "
          f"({b_ms / ms:.1%} of bound)", flush=True)


def moe_sweep(torch, moe, w, gen, flush):
    """Fused FFN + combine against split FFN -> combine at mixtral widths,
    T = 8 ... 4096 dropless tokens: the two forms' times, which set
    MOE_FUSED_COMBINE_MAX_TOKENS, and their outputs bitwise."""
    from deepspeed_tpu_torch.moe.sharded_moe import capacity
    E, H, k, act = MOE_E, MOE_H, MOE_K, "silu_gated"
    wg, wu, wo = moe_ffn_args(w, act)
    ahead = []   # the T at which the fused form leads by more than MOE_SWEEP_MARGIN
    for T in MOE_SWEEP_T:
        tokens = torch.randn(T, H, generator=gen, device="cuda").to(torch.bfloat16)
        cap = capacity(T, E, float(E), 1)
        src, slot_w, slot_tk, w_tk, _, _ = moe.moe_route(tokens @ w["gate"], top_k=k,
                                                         capacity=cap)
        p3 = moe.moe_dispatch_gather(tokens, src).view(E, cap, H)
        fused = lambda: moe.moe_ffn_combine(p3, wg, wu, wo, src, slot_w, T, activation=act)
        split = lambda: moe.moe_combine(
            moe.moe_ffn(p3, wg, wu, wo, src, activation=act).view(E * cap, H), slot_tk, w_tk)
        if not torch.equal(fused(), split()):
            fail(f"moe sweep T{T}: fused and split outputs differ")
        f_ms, s_ms = device_ms(torch, fused, 5, flush)[0], device_ms(torch, split, 5, flush)[0]
        if s_ms > f_ms * (1 + MOE_SWEEP_MARGIN):
            ahead.append(T)
        print(f"[moe-sweep] T{T}: fused_ms {f_ms:.4f} split_ms {s_ms:.4f} (split / fused "
              f"{s_ms / f_ms:.3f}); MOE_FUSED_COMBINE_MAX_TOKENS is "
              f"{moe.MOE_FUSED_COMBINE_MAX_TOKENS}", flush=True)
    print(f"[moe-sweep] the fused form leads by more than {MOE_SWEEP_MARGIN:.0%} at T "
          f"{ahead}; the rule (fused up to the largest such T) gives "
          f"{max(ahead) if ahead else None}", flush=True)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def serving_kernels_vs_plain(torch, gen, flush):
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_decode_attention_reference
    from deepspeed_tpu_torch.inference.v2.ragged.wave import WaveEntry, build_wave
    rows = {}
    for name, case in WAVE_CASES.items():
        seqs, kvH, g, D, ps, shuffle, window = case_options(case)
        kw = case_masks(torch, case)
        args, n, nbytes, flops = wave_case(torch, build_wave, WaveEntry, seqs, kvH, g, D,
                                           ps, gen, shuffle, window)
        before = dict(rpa.form_launches)
        got, again = (rpa.ragged_paged_attention(*args, **kw),
                      rpa.ragged_paged_attention(*args, **kw))
        form = [f for f, c in rpa.form_launches.items() if c > before[f]]
        want = rpa.ragged_paged_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        err = check_close(f"ragged/{name}", got[:n], want[:n])
        if not torch.equal(got, again):
            fail(f"ragged/{name}: two runs differ")
        if bool(got[n:].ne(0).any()):
            fail(f"ragged/{name}: stream padding rows are not zero")
        f32 = as_fp32(args)
        err32 = (check_close(f"ragged/{name} fp32", rpa.ragged_paged_attention(*f32, **kw)[:n],
                             rpa.ragged_paged_attention_reference(*f32, **kw)[:n], FP32_TOL)
                 if D <= PAGED_FP32_MAX_D else float("nan"))
        ms, host = device_ms(torch, lambda: rpa.ragged_paged_attention(*args, **kw), 20,
                             flush)
        plain, _ = device_ms(
            torch, lambda: rpa.ragged_paged_attention_reference(*args, **kw), 5, flush)
        kw_note = ""
        if kw:   # the same wave without its slopes and window, as context
            bare = device_ms(torch, lambda: rpa.ragged_paged_attention(*args), 20, flush)[0]
            kw_note = f"; the same wave unmasked {bare:.4f} ms"
        b_ms, b_by = bound(nbytes, flops, args[0].dtype)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                          bound_by=b_by)
        context = ""
        if name == MAIN_WAVE:
            first_atoms = [sum(-(-q // 8) for q, _ in seqs[:i]) for i in range(len(seqs))]
            cms = sdpa_context_ms(torch, flush, args[0], args[1], args[2],
                                  args[4][first_atoms], [q for q, _ in seqs],
                                  [q + s_ for q, s_ in seqs])
            clean = device_ms(torch, lambda: rpa.ragged_paged_attention(*args), 20, flush,
                              clean=True)[0]
            context = (f" after a clean L2 flush {clean:.4f} ms; context: SDPA over the "
                       f"gathered K/V {cms:.4f} ms (gather not timed)")
        print(f"[ragged] {name}: tokens {n} ({'/'.join(form)}{masks_note(kw)}) max_abs_err "
              f"{err:.3e} (fp32 "
              f"{err32:.3e}), two runs bit-identical; kernel_ms {ms:.4f} "
              f"plain_ms {plain:.4f} bound_ms {b_ms:.4f} ({b_by}, {100 * b_ms / ms:.1f}% "
              f"of it) library_ms null wrapper_host_ms {host:.4f}{context}{kw_note}",
              flush=True)
    drows = {}
    for name, case in DECODE_CASES.items():
        ctxs, kvH, g, D, ps, shuffle, window = case_options(case)
        kw = case_masks(torch, case)
        args, nbytes, flops = decode_case(torch, ctxs, kvH, g, D, ps, gen, shuffle, window)
        got, again = pdk.paged_gqa_decode(*args, **kw), pdk.paged_gqa_decode(*args, **kw)
        want = paged_decode_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        err = check_close(f"decode/{name}", got, want)
        if not torch.equal(got, again):
            fail(f"decode/{name}: two runs differ")
        f32 = as_fp32(args)
        err32 = (check_close(f"decode/{name} fp32", pdk.paged_gqa_decode(*f32, **kw),
                             paged_decode_attention_reference(*f32, **kw), FP32_TOL)
                 if D <= PAGED_FP32_MAX_D else float("nan"))
        ms, host = device_ms(torch, lambda: pdk.paged_gqa_decode(*args, **kw), 20, flush)
        plain, _ = device_ms(torch, lambda: paged_decode_attention_reference(*args, **kw), 5,
                             flush)
        kw_note = ""
        if kw:   # the same step without its slopes and window, as context
            bare = device_ms(torch, lambda: pdk.paged_gqa_decode(*args), 20, flush)[0]
            kw_note = f"; the same step unmasked {bare:.4f} ms"
        b_ms, b_by = bound(nbytes, flops, args[0].dtype)
        drows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by)
        context = ""
        if name == MAIN_DECODE:
            cms = sdpa_context_ms(torch, flush, args[0], args[1], args[2], args[4],
                                  [1] * len(ctxs), ctxs)
            clean = device_ms(torch, lambda: pdk.paged_gqa_decode(*args), 20, flush,
                              clean=True)[0]
            context = (f" after a clean L2 flush {clean:.4f} ms; context: SDPA over the "
                       f"gathered K/V {cms:.4f} ms (gather not timed)")
        print(f"[decode] {name}{masks_note(kw)}: max_abs_err {err:.3e} (fp32 {err32:.3e}), "
              f"two runs bit-identical; splits {pdk.max_splits(args[4].shape[1], ps, window)} "
              f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b_ms:.4f} ({b_by}, "
              f"{100 * b_ms / ms:.1f}% of it) library_ms null wrapper_host_ms "
              f"{host:.4f}{context}{kw_note}", flush=True)
    print("[kernels] library_ms is null: no single PyTorch call computes "
          "attention over a paged (block-table) KV pool; the SDPA context times "
          "need the K/V gathered into contiguous tensors first")
    return rows, drows


def build_llama2_7b(torch, quantization_mode=None):
    """llama2-7b at full width and depth from seed 0, with the serving
    config of both serving phases."""
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig, build_engine)
    from deepspeed_tpu_torch.models import llama_model
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=2049, quantization_mode=quantization_mode,
        state_manager=DeepSpeedTPStateManagerConfig(max_context=4096))
    t0 = time.perf_counter()
    engine = build_engine(llama_model("llama2-7b", num_layers=NUM_LAYERS), cfg, seed=0)
    torch.cuda.synchronize()
    print(f"[engine] llama2-7b layers {NUM_LAYERS}/32 hidden 4096 bf16 on "
          f"{engine.device}, linear {engine.linear_impl}, {cfg.num_kv_blocks} KV blocks x "
          f"{cfg.kv_block_size} ({engine.kv_cache.mem_bytes() / 2**30:.2f} GiB), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return engine


class DictCount:
    """One entry of a module's ``launches`` dict, read and set to 0 as a
    module's ``launches`` count is."""

    def __init__(self, counts, key):
        self.counts, self.key = counts, key

    @property
    def launches(self):
        return self.counts[self.key]

    @launches.setter
    def launches(self, value):
        self.counts[self.key] = value


def timed_generate(torch, np, engine, counters, num_layers=NUM_LAYERS, form="tensor_cores",
                   label="engine"):
    """Two ``generate`` runs of the 8 requests: cold (the engine's decode
    graphs are captured inside it) and warm, every module of ``counters``
    (``{name: module with a launches count}``) set to 0 just before each
    and read just after. Fails unless, in both, every request got its
    tokens, the two attention kernels ran once a layer in every wave and
    burst step (the burst's launches counted through the graphs' replay
    accounting), and every ragged launch took the ``form`` the model's
    shapes give (the tensor-core form at bf16, pages of 16, head_dim 64 or
    128 and at most 64 query heads a kv head). Prints under ``[label]``.
    Returns the warm run's (prompts, wall s, wave token counts, burst
    steps, launches)."""
    from deepspeed_tpu_torch.inference.v2 import generate
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32000, size=n) for n in PROMPT_LENS]
    generate(engine, [prompts[-1]], max_new_tokens=2)       # warm-up: no burst
    run_wave, run_burst = engine._run_wave, engine.decode_burst
    graphs = engine.decode_graphs
    rpa = counters["ragged_paged_attention"]
    for run in ("cold", "warm"):
        waves, burst_steps, wave_s, burst_s = [], [0], [0.0], [0.0]

        # both end in a copy of their result to the host, so the host clock
        # around them spans their device work
        def counted_wave(wave):
            waves.append(sum(len(chunk) for _, chunk in wave))
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
        for mod in counters.values():
            mod.launches = 0
        rpa.form_launches.update({form: 0 for form in rpa.form_launches})
        captures, capture_s, replays = graphs.captures, graphs.capture_s, graphs.replays
        t0 = time.perf_counter()
        reqs = generate(engine, prompts, max_new_tokens=NEW_TOKENS,
                        return_requests=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in counters.items()}
        forms = dict(rpa.form_launches)
        engine._run_wave, engine.decode_burst = run_wave, run_burst
        captures, capture_s = graphs.captures - captures, graphs.capture_s - capture_s
        n_tok = sum(len(r.generated) for r in reqs)
        ttft = [r.first_token_s - r.submit_s for r in reqs]
        print(f"[{label}] {run} generate: {len(reqs)} requests, prompts {list(PROMPT_LENS)}, "
              f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s; waves "
              f"{len(waves)}, burst steps {burst_steps[0]}; TTFT mean "
              f"{sum(ttft) / len(ttft) * 1e3:.1f} ms max {max(ttft) * 1e3:.1f} ms; "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {launches}; ragged launches by form {forms}", flush=True)
        print(f"[{label}] {run} host clock: waves {wave_s[0] * 1e3:.1f} ms, bursts "
              f"{burst_s[0] * 1e3:.1f} ms ({burst_s[0] * 1e3 / max(burst_steps[0], 1):.2f} ms "
              f"a step; decode graph captures {captures} taking {capture_s * 1e3:.1f} ms, "
              f"replays {graphs.replays - replays}), scheduler and the rest "
              f"{(wall - wave_s[0] - burst_s[0]) * 1e3:.1f} ms", flush=True)
        if any(len(r.generated) != NEW_TOKENS for r in reqs):
            fail(f"token counts {[len(r.generated) for r in reqs]} != {NEW_TOKENS}")
        if launches["ragged_paged_attention"] != num_layers * len(waves) or not waves:
            fail(f"ragged launches {launches['ragged_paged_attention']} != "
                 f"{num_layers} x {len(waves)} waves")
        if forms[form] != launches["ragged_paged_attention"]:
            fail(f"ragged launches by form {forms}: the serving waves must all take the "
                 f"{form} form")
        if launches["paged_decode"] != num_layers * burst_steps[0] or burst_steps[0] == 0:
            fail(f"decode launches {launches['paged_decode']} != "
                 f"{num_layers} x {burst_steps[0]} burst steps")
        if run == "warm" and captures:
            fail(f"the warm generate captured {captures} decode graphs")
    return prompts, wall, waves, burst_steps[0], launches


def decode_graph_phase(torch, np, engine, tag):
    """``[decode-graph]``: one prefilled batch of 8, its pages saved; a
    ``DECODE_GRAPH_K``-step greedy burst eagerly (``model.decode_burst``)
    and through the engine's ``DecodeGraphs`` twice (cold: the key's capture
    and K - 1 replays; warm: K replays), each from the saved pages: the
    tokens and the pages of every block the bursts touch must be identical,
    byte for byte. Then the sampled rows: one seed twice gives the same
    tokens, another seed others. Prints the host ms a step of each run and
    the device ms a step of K replays (CUDA events) at the batch buckets
    ``DECODE_GRAPH_BATCHES``. Returns ``{B: device ms a step}``."""
    from deepspeed_tpu_torch.inference.v2.engine_v2 import BURST_BUCKET_LO
    graphs, kv, model = engine.decode_graphs, engine.kv_cache, engine._model
    vocab = engine.model.config.vocab_size
    rng = np.random.default_rng(5)
    uids = list(range(20_000, 20_000 + len(DECODE_GRAPH_PROMPTS)))
    prompts = [rng.integers(0, vocab, size=n) for n in DECODE_GRAPH_PROMPTS]
    last = engine.put(uids, prompts).argmax(-1)
    K = DECODE_GRAPH_K
    seqs, inputs = engine.burst_inputs(uids, last, K)
    B, mp = inputs[2].shape
    blocks = torch.as_tensor(sorted({0} | {b for s in seqs for b in s.blocks}),
                             device=kv.k_pages.device)
    pages = lambda: (kv.k_pages[:, :, blocks].clone(), kv.v_pages[:, :, blocks].clone())
    saved = pages()

    def restore():
        kv.k_pages[:, :, blocks] = saved[0]
        kv.v_pages[:, :, blocks] = saved[1]
        torch.cuda.synchronize()

    def same_pages(a, b):          # byte for byte: bf16 pages seen as int16
        return all(torch.equal(x.view(torch.int16), y.view(torch.int16)) for x, y in zip(a, b))

    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(kv.k_pages.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev[0].record()
    eager = model.decode_burst(kv.k_pages, kv.v_pages, *map(dev, inputs), K,
                               sampled=False).cpu().numpy()
    ev[1].record()
    torch.cuda.synchronize()
    eager_host = (time.perf_counter() - t) * 1e3 / K
    eager_span = ev[0].elapsed_time(ev[1]) / K
    eager_pages = pages()
    new_key = (B, mp, False) not in graphs._graphs
    runs = {}
    for run in ("cold", "warm"):
        restore()
        c0, s0, r0 = graphs.captures, graphs.capture_s, graphs.replays
        t = time.perf_counter()
        toks = graphs.run(*inputs, K, seed=0)
        host = (time.perf_counter() - t) * 1e3 / K
        runs[run] = (graphs.captures - c0, (graphs.capture_s - s0) * 1e3,
                     graphs.replays - r0, host)
        if not np.array_equal(toks, eager) or not same_pages(pages(), eager_pages):
            fail(f"[decode-graph] {tag}: the {run} graph burst differs from the eager one: "
                 f"tokens equal {np.array_equal(toks, eager)}, pages byte-identical "
                 f"{same_pages(pages(), eager_pages)}")
    if runs["cold"][0] != int(new_key) or runs["warm"][0] or runs["warm"][2] != K:
        fail(f"[decode-graph] {tag}: captures / replays {runs} (cold: {int(new_key)} "
             f"capture, warm: {K} replays)")
    print(f"[decode-graph] {tag}: B {B}, mp {mp}, K {K} greedy: eager host "
          f"{eager_host:.3f} ms a step (events around it {eager_span:.3f}); graph cold: "
          f"{runs['cold'][0]} capture in {runs['cold'][1]:.1f} ms (its eager first step "
          f"included), {runs['cold'][2]} replays, host {runs['cold'][3]:.3f} ms a step; "
          f"warm: {runs['warm'][2]} replays, host {runs['warm'][3]:.3f} ms a step; tokens "
          f"and the KV pages of {len(blocks)} blocks byte-identical to eager in both",
          flush=True)

    # sampled rows: seed 7 twice, seed 8
    temps = np.zeros(B, np.float32)
    temps[list(DECODE_GRAPH_SAMPLED_ROWS)] = DECODE_GRAPH_TEMP
    drawn = {}
    for name, seed in (("a", 7), ("b", 7), ("c", 8)):
        restore()
        drawn[name] = graphs.run(inputs[0], inputs[1], inputs[2], temps, K, seed)
    rows = list(DECODE_GRAPH_SAMPLED_ROWS)
    greedy_rows = [r for r in range(len(uids)) if r not in rows]
    differ = int((drawn["a"][rows] != drawn["c"][rows]).sum())
    print(f"[decode-graph] {tag}: sampled rows {rows} at T {DECODE_GRAPH_TEMP}: seed 7 "
          f"twice identical {np.array_equal(drawn['a'], drawn['b'])}, seed 8 differs in "
          f"{differ} of {len(rows) * K} tokens; the greedy rows equal the eager burst's "
          f"{np.array_equal(drawn['a'][greedy_rows], eager[greedy_rows])}", flush=True)
    if not np.array_equal(drawn["a"], drawn["b"]) or not differ:
        fail(f"[decode-graph] {tag}: sampled bursts not seeded as they must be")

    # device ms a step: events around K replays of each bucket's graph
    step_ms = {}
    for b in DECODE_GRAPH_BATCHES:
        sub = [np.zeros((b,) + a.shape[1:], a.dtype) for a in inputs]
        for dst, src in zip(sub, inputs):
            dst[:min(b, B)] = src[:min(b, B)]
        restore()
        graphs.run(*sub, K, seed=0)                  # captures the bucket's graph
        restore()
        key = (b, mp, False)
        with torch.inference_mode():     # the state's tensors are inference tensors
            graphs._states[key].load(*sub)
        ev[0].record()
        for _ in range(K):
            graphs._graphs[key].replay()
        ev[1].record()
        torch.cuda.synchronize()
        step_ms[b] = ev[0].elapsed_time(ev[1]) / K
    restore()
    for uid in uids:
        engine.flush(uid)
    print(f"[decode-graph] {tag}: device ms a step, K {K} replays at mp {mp}: "
          + ", ".join(f"B {b} {ms:.4f}" for b, ms in step_ms.items())
          + f" (the engine's smallest bucket: {BURST_BUCKET_LO}); captures so far "
          f"{graphs.captures}, {graphs.capture_s * 1e3:.1f} ms", flush=True)
    return step_ms


def programmatic_edges(torch, moe):
    """``[decode-graph]``: the edges of a captured route -> dispatch gather
    (one MoE call's first two launches at a decode step, T 8, E 8, H 4096,
    bf16), by type, read from the graph with the driver's
    ``cuGraphGetEdges_v2``: the gather launches with programmatic stream
    serialization, which a capture keeps as a programmatic edge (type 1) or
    turns into a full dependency (type 0). Returns ``{type: count}``, or None
    where this torch cannot keep the captured graph."""
    import ctypes
    T, E, H = 8, 8, 4096
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randn(T, H, generator=gen, device="cuda").to(torch.bfloat16)
    logits = torch.randn(T, E, generator=gen, device="cuda").to(torch.bfloat16)

    def step():
        src = moe.moe_route(logits, top_k=2, capacity=T)[0]
        return moe.moe_dispatch_gather(tokens, src)

    want = step()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    with torch.cuda.graph(graph):
        got = step()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("[decode-graph] the replayed route -> gather differs from the eager pair")
    cuda = ctypes.CDLL("libcuda.so.1")
    fn = cuda.cuGraphGetEdges_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    handle = graph.raw_cuda_graph()
    if fn(handle, None, None, None, ctypes.byref(n)) != 0:
        fail("[decode-graph] cuGraphGetEdges_v2 failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    nodes_to = (ctypes.c_void_p * max(n.value, 1))()
    data = (ctypes.c_ubyte * (8 * max(n.value, 1)))()    # CUgraphEdgeData: 8 bytes
    if fn(handle, nodes, nodes_to, data, ctypes.byref(n)) != 0:
        fail("[decode-graph] cuGraphGetEdges_v2 failed")
    types = {}
    for e in range(n.value):
        types[data[8 * e + 2]] = types.get(data[8 * e + 2], 0) + 1
    return types


def burst_sweep(torch, engine, prompts):
    """``[engine-sweep]``: warm ``generate`` runs of the 8 requests with
    ``BURST_SWEEP_NEW_TOKENS`` new tokens at each ``decode_burst`` of
    ``BURST_SWEEP``, in the order 8 16 32 32 16 8: tok/s, TTFT and the
    bursts' host ms a step. The engine's own setting is restored. The
    engine's decode graphs hold the history of ``decode_burst`` steps it was
    built with, so a longer K runs as chunks of that many replays (one
    device copy of the tokens a chunk)."""
    from deepspeed_tpu_torch.inference.v2 import generate
    own = engine.config.decode_burst
    order = BURST_SWEEP + BURST_SWEEP[::-1]
    graphs = engine.decode_graphs
    for K in order:
        engine.config.decode_burst = K
        torch.cuda.synchronize()
        captures = graphs.captures
        t0 = time.perf_counter()
        reqs = generate(engine, prompts, max_new_tokens=BURST_SWEEP_NEW_TOKENS,
                        return_requests=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = sum(len(r.generated) for r in reqs)
        ttft = [r.first_token_s - r.submit_s for r in reqs]
        print(f"[engine-sweep] decode_burst {K}: {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.2f} tok/s, TTFT mean {sum(ttft) / len(ttft) * 1e3:.1f} ms, "
              f"captures {graphs.captures - captures}", flush=True)
        if n_tok != BURST_SWEEP_NEW_TOKENS * len(prompts):
            fail(f"[engine-sweep] decode_burst {K}: {n_tok} tokens")
    engine.config.decode_burst = own


def serve(torch, np):
    """llama2-7b served at full width and depth; returns the serving
    kernels' launch counts over one ``generate``, the weights' bytes and
    the peak device memory of that ``generate``."""
    from deepspeed_tpu_torch.inference.quantization import quantized_tree_bytes
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig,
        build_engine, generate)
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.models import llama_model

    engine = build_llama2_7b(torch)
    prompts, wall, _, _, launches = timed_generate(
        torch, np, engine, {"ragged_paged_attention": rpa, "paged_decode": pdk})
    memory = {"weight_bytes": quantized_tree_bytes(engine.model),
              "peak_bytes": torch.cuda.max_memory_allocated()}
    decode_graph_phase(torch, np, engine, "llama2-7b")
    burst_sweep(torch, engine, prompts)

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

    # where the time goes: the same generate under the profiler
    profile_generate(torch, generate, engine, prompts, wall)
    return launches, memory


class plain_serving_kernels:
    """Route the WOQ matmul and the ragged attention wrappers to their
    plain versions on the card, and back afterwards."""

    def __init__(self, woq, rpa):
        self.woq, self.rpa = woq, rpa

    def __enter__(self):
        woq, rpa = self.woq, self.rpa
        self.saved = (woq._woq_cuda, rpa._ragged_paged_attention_cuda)
        woq._woq_cuda = woq.woq_matmul_reference
        rpa._ragged_paged_attention_cuda = rpa.ragged_paged_attention_reference

    def __exit__(self, *exc):
        self.woq._woq_cuda, self.rpa._ragged_paged_attention_cuda = self.saved


def serve_woq(torch, np, woq, dense_memory):
    """llama2-7b served from int8 weights at full width and depth; returns
    the launch counts of the WOQ kernel and the two attention kernels over
    one ``generate``."""
    from deepspeed_tpu_torch.inference.quantization import quantization, quantized_tree_bytes
    from deepspeed_tpu_torch.inference.v2 import generate
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import _next_bucket
    from deepspeed_tpu_torch.models import llama_model
    from deepspeed_tpu_torch.nn.layers import Linear

    engine = build_llama2_7b(torch, quantization_mode="int8")
    if engine.linear_impl != "woq_int8":
        fail(f"the engine chose linear {engine.linear_impl}")
    linears = [m for m in engine.model.modules() if isinstance(m, Linear)]
    if any(m.q is None or m.q.dtype != torch.int8 or m.weight is not None for m in linears):
        fail("a linear of the quantized engine still holds a dense weight")
    prompts, wall, waves, burst_steps, launches = timed_generate(
        torch, np, engine, {"woq_matmul": woq, "ragged_paged_attention": rpa,
                            "paged_decode": pdk})
    # the head runs the kernel in every wave (one row a request), the other
    # linears when the wave's padded token count is within the kernel's rows
    rows = quantization.WOQ_KERNEL_MAX_ROWS
    small = sum(_next_bucket(n, lo=16) <= rows for n in waves)
    want = len(linears) * burst_steps + len(waves) + (len(linears) - 1) * small
    if launches["woq_matmul"] != want or not launches["woq_matmul"]:
        fail(f"WOQ launches {launches['woq_matmul']} != {want} ({len(linears)} linears x "
             f"{burst_steps} burst steps + {len(waves)} waves' heads + {small} small waves)")
    peak = torch.cuda.max_memory_allocated()
    weight_bytes = quantized_tree_bytes(engine.model)
    print(f"[woq-engine] weights {weight_bytes / 2**30:.3f} GiB (dense "
          f"{dense_memory['weight_bytes'] / 2**30:.3f} GiB, ratio "
          f"{weight_bytes / dense_memory['weight_bytes']:.3f}); generate peak "
          f"{peak / 2**30:.2f} GiB (dense {dense_memory['peak_bytes'] / 2**30:.2f} GiB); "
          f"WOQ launches {launches['woq_matmul']} = {len(linears)} linears x {burst_steps} "
          f"burst steps + {len(waves)} heads + {len(linears) - 1} x {small} waves of "
          f"<= {rows} rows", flush=True)
    if not 0.45 < weight_bytes / dense_memory["weight_bytes"] < 0.6:
        fail(f"int8 weights take {weight_bytes} bytes against the dense {dense_memory}")

    # logits of a short prompt (one wave of 16 rows: every linear through the
    # WOQ kernel): the kernels, and the same engine through the plain
    # versions, each against the plain fp32 forward over the same integers
    prompt = prompts[-1][:13]
    got = torch.from_numpy(engine.put([10_000], [prompt])[0])
    engine.flush(10_000)
    if woq.launches != want + len(linears):
        fail(f"the logits wave launched {woq.launches - want} WOQ kernels, not {len(linears)}")
    ids = torch.as_tensor(prompt, device="cuda")[None]
    ref32 = llama_model("llama2-7b", num_layers=NUM_LAYERS, dtype=torch.float32)
    ref_linears = [m for m in ref32.modules() if isinstance(m, Linear)]
    for m in ref_linears:
        m.weight = None
    ref32.to_empty(device="cuda")
    for m, src in zip(ref_linears, linears):
        m.set_quantized(src.q, src.scale)   # the engine's own tensors, not copies
    ref32.load_state_dict(engine.model.state_dict())
    with plain_serving_kernels(woq, rpa):
        plain = torch.from_numpy(engine.put([10_001], [prompt])[0])
        engine.flush(10_001)
        want32 = ref32(ids)[0, -1].cpu()
    del ref32
    if woq.launches != want + len(linears):
        fail("the plain path launched the WOQ kernel")
    rel = lambda a: ((a - want32).norm() / want32.norm()).item()
    print(f"[woq-engine] logits ({len(prompt)} tokens, one wave) vs fp32 plain forward "
          f"over the same int8 weights: kernels bf16 relative L2 {rel(got):.3e}, plain "
          f"versions bf16 {rel(plain):.3e}, kernels vs plain "
          f"{((got - plain).norm() / plain.norm()).item():.3e}; argmax kernels "
          f"{int(got.argmax())} plain {int(plain.argmax())} fp32 {int(want32.argmax())}",
          flush=True)
    if not bool(got.isfinite().all()) or rel(got) > LOGIT_ERR_RATIO * rel(plain):
        fail(f"WOQ serving logits relative L2 error {rel(got):.3e} > "
             f"{LOGIT_ERR_RATIO} x the plain versions' {rel(plain):.3e}")
    decode_graph_phase(torch, np, engine, "llama2-7b int8")
    profile_generate(torch, generate, engine, prompts, wall)
    del engine, linears
    torch.cuda.empty_cache()
    serve_int4(torch, np, woq)
    return launches


def serve_int4(torch, np, woq):
    """Packed int4 at llama2-7b's width, depth cut to INT4_LAYERS: every
    linear takes the non-kernel form (unpack, dequantize, ``torch.matmul``)
    at every row count, so the WOQ kernel must not launch; tokens must come
    out and a prompt's logits must be as close to the fp32 plain forward of
    the same integers as twice the plain bf16 forward's own error."""
    from deepspeed_tpu_torch.inference.quantization import quantized_tree_bytes
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig, build_engine, generate)
    from deepspeed_tpu_torch.models import llama_model
    from deepspeed_tpu_torch.nn.layers import Linear
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=257, quantization_mode="int4",
        state_manager=DeepSpeedTPStateManagerConfig(max_context=4096))
    engine = build_engine(llama_model("llama2-7b", num_layers=INT4_LAYERS), cfg, seed=0)
    linears = [m for m in engine.model.modules() if isinstance(m, Linear)]
    if engine.linear_impl != "woq_int4" or any(m.q.dtype != torch.uint8 for m in linears):
        fail(f"the int4 engine chose linear {engine.linear_impl}")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 32000, size=n) for n in (77, 17)]
    woq.launches = 0
    out = generate(engine, prompts, max_new_tokens=8)
    if [len(o) for o in out] != [8, 8] or woq.launches:
        fail(f"int4 generate: token counts {[len(o) for o in out]}, WOQ kernel launches "
             f"{woq.launches} (packed int4 never takes the kernel)")
    if not engine.decode_graphs.captures or not engine.decode_graphs.replays:
        fail(f"int4 generate: its bursts captured {engine.decode_graphs.captures} decode "
             f"graphs and replayed {engine.decode_graphs.replays} steps")
    got = torch.from_numpy(engine.put([10_000], [prompts[0]])[0])
    engine.flush(10_000)
    ids = torch.as_tensor(prompts[0], device="cuda")[None]
    plain = engine.model(ids)[0, -1].cpu()
    ref32 = llama_model("llama2-7b", num_layers=INT4_LAYERS, dtype=torch.float32)
    ref_linears = [m for m in ref32.modules() if isinstance(m, Linear)]
    for m in ref_linears:
        m.weight = None
    ref32.to_empty(device="cuda")
    for m, src in zip(ref_linears, linears):
        m.set_quantized(src.q, src.scale)
    ref32.load_state_dict(engine.model.state_dict())
    want = ref32(ids)[0, -1].cpu()
    rel = lambda a: ((a - want).norm() / want.norm()).item()
    dense_bytes = 2 * sum(m.in_features * m.out_features for m in linears)
    q_bytes = sum(m.q.numel() + 4 * m.scale.numel() for m in linears)
    print(f"[woq-engine] int4, {INT4_LAYERS} layers at llama2-7b's width: 16 tokens served, "
          f"no WOQ kernel launch, bursts through {engine.decode_graphs.captures} captured "
          f"decode graphs ({engine.decode_graphs.replays} replays); linears {q_bytes / 2**20:.1f} MiB packed against "
          f"{dense_bytes / 2**20:.1f} MiB bf16 (ratio {q_bytes / dense_bytes:.3f}; model "
          f"{quantized_tree_bytes(engine.model) / 2**30:.3f} GiB); logits ({len(prompts[0])} "
          f"tokens) vs fp32 plain forward over the same nibbles: serving bf16 relative L2 "
          f"{rel(got):.3e}, plain bf16 forward {rel(plain):.3e}", flush=True)
    if not bool(got.isfinite().all()) or rel(got) > LOGIT_ERR_RATIO * rel(plain):
        fail(f"int4 serving logits relative L2 error {rel(got):.3e} > {LOGIT_ERR_RATIO} x "
             f"the plain bf16 forward's {rel(plain):.3e}")
    if not 0.25 < q_bytes / dense_bytes < 0.3:
        fail(f"packed int4 linears take {q_bytes} bytes against {dense_bytes} in bf16")


class plain_moe_kernels:
    """Route the MoE wrappers to their plain versions on the card, and back
    afterwards."""

    def __init__(self, moe):
        self.moe = moe

    def __enter__(self):
        moe = self.moe
        self.saved = (moe._route_cuda, moe._gather_cuda, moe._ffn_cuda, moe._combine_cuda)
        moe._route_cuda = lambda logits, top_k, capacity: moe.moe_route_reference(
            logits, top_k=top_k, capacity=capacity)
        moe._gather_cuda = moe.moe_dispatch_gather_reference

        def ffn(payload, wi_gate, wi_up, wo, src, slot_w, n_tokens, activation, fused):
            if fused:
                return moe.moe_ffn_combine_reference(payload, wi_gate, wi_up, wo, src, slot_w,
                                                     n_tokens, activation=activation)
            return moe.moe_ffn_reference(payload, wi_gate, wi_up, wo, src,
                                         activation=activation)
        moe._ffn_cuda = ffn
        moe._combine_cuda = moe.moe_combine_reference

    def __exit__(self, *exc):
        (self.moe._route_cuda, self.moe._gather_cuda, self.moe._ffn_cuda,
         self.moe._combine_cuda) = self.saved


def build_mixtral(torch, num_layers):
    """mixtral-8x7b at full width and ``num_layers`` deep from seed 0, with
    the serving config of the dense phase."""
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig, build_engine)
    from deepspeed_tpu_torch.models import mixtral_model
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=2049, state_manager=DeepSpeedTPStateManagerConfig(max_context=4096))
    t0 = time.perf_counter()
    engine = build_engine(mixtral_model("mixtral-8x7b", num_layers=num_layers), cfg, seed=0)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in engine.model.parameters())
    print(f"[moe-engine] mixtral-8x7b layers {num_layers}/32 hidden 4096 experts 8 top-2 "
          f"ffn 14336 bf16 on {engine.device}: {n} params, "
          f"{sum(p.numel() * p.element_size() for p in engine.model.parameters()) / 2**30:.2f} "
          f"GiB; {cfg.num_kv_blocks} KV blocks x {cfg.kv_block_size} "
          f"({engine.kv_cache.mem_bytes() / 2**30:.2f} GiB); built in "
          f"{time.perf_counter() - t0:.2f} s; allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    return engine


def serve_mixtral(torch, np, moe):
    """mixtral-8x7b served at full width, 24 layers: every request gets its
    tokens through the MoE kernels and both attention kernels (route, gather
    and the FFN once a layer in every wave and decode step, the split form's
    FFN and combine in exactly the waves above MOE_FUSED_COMBINE_MAX_TOKENS);
    then a 2-layer model's logits against an fp32 forward. Returns the MoE
    launch counts over one ``generate``, the int8 dispatch gather's among
    them, which must be 0: no serving path quantizes its dispatch."""
    import gc

    from deepspeed_tpu_torch.inference.v2 import generate
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import _next_bucket
    from deepspeed_tpu_torch.models import mixtral_model

    engine = build_mixtral(torch, MIXTRAL_LAYERS)
    weight_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    counters = {"ragged_paged_attention": rpa, "paged_decode": pdk,
                **{k: DictCount(moe.launches, k) for k in moe.launches}}
    prompts, wall, waves, burst_steps, launches = timed_generate(
        torch, np, engine, counters, num_layers=MIXTRAL_LAYERS)
    peak = torch.cuda.max_memory_allocated()
    L, thr = MIXTRAL_LAYERS, moe.MOE_FUSED_COMBINE_MAX_TOKENS
    rows = [_next_bucket(n, lo=16) for n in waves]   # a wave's MoE runs over its padded rows
    big = sum(r > thr for r in rows)
    steps = len(waves) + burst_steps
    want = {"moe_route": L * steps, "moe_dispatch_gather": L * steps,
            "moe_ffn_combine": L * (steps - big), "moe_ffn": L * big, "moe_combine": L * big}
    moe_launches = {k: launches[k] for k in want}
    print(f"[moe-engine] waves of {rows} padded rows (threshold {thr}: {big} split), "
          f"{burst_steps} decode steps; MoE launches {moe_launches}; weights "
          f"{weight_bytes / 2**30:.2f} GiB, generate peak {peak / 2**30:.2f} GiB", flush=True)
    if moe_launches != want or not all(want.values()):
        fail(f"MoE launches {moe_launches} != {want} (every kernel must run on this path)")
    wave = L * sum(r > MOE_DECODE_FORM_SLOTS for r in rows)   # dropless: C = the padded rows
    print(f"[moe-engine] FFN calls by tile form: decode form (at most {MOE_DECODE_FORM_SLOTS} "
          f"slots an expert, moe_gemm_tc) {L * steps - wave}, wave form (moe_wave) {wave}: "
          f"fused {wave - L * big}, split {L * big}", flush=True)
    moe_launches["moe_dispatch_gather_int8"] = launches["moe_dispatch_gather_int8"]
    if moe_launches["moe_dispatch_gather_int8"]:
        fail(f"the int8 dispatch gather launched {moe_launches['moe_dispatch_gather_int8']} "
             f"times in Mixtral serving, which has no int8 dispatch")
    decode_graph_phase(torch, np, engine, "mixtral-8x7b")
    edges = programmatic_edges(torch, moe)
    print(f"[decode-graph] route -> dispatch gather captured (T 8, bf16), replay "
          f"byte-identical to eager; its graph's edges by type (0 full dependency, 1 "
          f"programmatic): {'not available in this torch' if edges is None else edges}",
          flush=True)
    profile_generate(torch, generate, engine, prompts, wall)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # logits of one chunked prompt at 2 layers of the same width: the kernel
    # path, and the plain versions in bf16, each against the plain dropless
    # forward of the same weights in fp32
    engine = build_mixtral(torch, MIXTRAL_LOGIT_LAYERS)
    prompt = prompts[2]
    got = torch.from_numpy(engine.put([10_000], [prompt])[0])
    engine.flush(10_000)
    ids = torch.as_tensor(prompt, device="cuda")[None]
    before = dict(moe.launches)
    with plain_moe_kernels(moe):
        plain = engine.model(ids, dropless=True)[0, -1].cpu()
        ref32 = mixtral_model("mixtral-8x7b", num_layers=MIXTRAL_LOGIT_LAYERS,
                              dtype=torch.float32)
        ref32.to_empty(device="cuda").load_state_dict(engine.model.state_dict())
        want32 = ref32(ids, dropless=True)[0, -1].cpu()
    del ref32, engine
    if moe.launches != before:
        fail("the plain MoE path launched a MoE kernel")
    rel = lambda a: ((a - want32).norm() / want32.norm()).item()
    print(f"[moe-engine] logits ({len(prompt)} tokens, 2 chunks, {MIXTRAL_LOGIT_LAYERS} "
          f"layers) vs fp32 plain dropless forward: kernels bf16 relative L2 {rel(got):.3e} "
          f"(max |err| {(got - want32).abs().max().item():.3e}), plain bf16 forward "
          f"{rel(plain):.3e}, kernels vs plain {((got - plain).norm() / plain.norm()).item():.3e}; "
          f"argmax kernels {int(got.argmax())} plain {int(plain.argmax())} fp32 "
          f"{int(want32.argmax())}", flush=True)
    if not bool(got.isfinite().all()) or rel(got) > LOGIT_ERR_RATIO * rel(plain):
        fail(f"Mixtral logits relative L2 error {rel(got):.3e} > {LOGIT_ERR_RATIO} x the "
             f"plain bf16 forward's {rel(plain):.3e}")
    gc.collect()
    torch.cuda.empty_cache()
    return moe_launches


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_engine(torch, config, num_layers=None, seed=0):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama_model
    kw = {} if num_layers is None else {"num_layers": num_layers}
    engine, *_ = deepspeed_tpu_torch.initialize(model=llama_model("tinyllama-1.1b", **kw),
                                                config=config, seed=seed)
    return engine


def training_flops(c, n_params, tokens):
    """6 * N * tokens (N: the ``n_params`` of model config ``c`` without the
    input embedding, a lookup) plus the causal attention: 4 * D * visible
    pairs a head and layer for the forward, three times that for forward
    and backward."""
    n = n_params - c.vocab_size * c.hidden_size
    B = tokens // TRAIN_SEQ
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = 3 * 4 * c.head_dim * pairs * c.num_heads * B * c.num_layers
    return 6 * n * tokens + attn, n


class plain_kernels:
    """Route the flash, Adam and Lion wrappers (and the int8 row quantizer's
    when ``quant`` is given) to their plain versions on the card for the
    kernel-vs-plain training comparison, and back afterwards."""

    def __init__(self, flash, adam, lion, quant=None):
        self.flash, self.adam, self.lion, self.quant = flash, adam, lion, quant

    def __enter__(self):
        flash, adam, lion = self.flash, self.adam, self.lion
        self.saved = (flash._fwd_cuda, flash._bwd_cuda, adam._adam_cuda, lion._lion_cuda)
        if self.quant is not None:
            self.saved_quant = self.quant._quant_cuda
            self.quant._quant_cuda = self.quant.quantize_rows_int8_reference

        def adam_plain(grads, master, exp_avg, exp_avg_sq, outs, *, gscale, sr_m, sr_v, **kw):
            p_out, cast_out, m_out, v_out = outs
            res = adam.adam_bucket_reference(
                grads, master, exp_avg, exp_avg_sq, gscale=1.0 if gscale is None else gscale,
                m_dtype=m_out.dtype, v_dtype=v_out.dtype,
                param_dtype=None if cast_out is None else cast_out.dtype, sr=True, **kw)
            for dst, src in zip(outs, res):
                if dst is not None:
                    dst.copy_(src)
        def lion_plain(grads, master, exp_avg, outs, *, gscale, sr_m, **kw):
            p_out, cast_out, m_out = outs
            res = lion.lion_bucket_reference(
                grads, master, exp_avg, gscale=1.0 if gscale is None else gscale,
                m_dtype=m_out.dtype,
                param_dtype=None if cast_out is None else cast_out.dtype, sr=True, **kw)
            for dst, src in zip(outs, res):
                if dst is not None:
                    dst.copy_(src)
        flash._fwd_cuda = lambda q, k, v, spec: flash.flash_fwd_reference(q, k, v, spec=spec)
        flash._bwd_cuda = lambda q, k, v, o, lse, do, dlse, spec: flash.flash_bwd_reference(
            q, k, v, o, lse, do, dlse, spec=spec)
        adam._adam_cuda = adam_plain
        lion._lion_cuda = lion_plain

    def __exit__(self, *exc):
        (self.flash._fwd_cuda, self.flash._bwd_cuda, self.adam._adam_cuda,
         self.lion._lion_cuda) = self.saved
        if self.quant is not None:
            self.quant._quant_cuda = self.saved_quant


def zero_counts(flash, adam, lion):
    flash.launches.update(dict.fromkeys(flash.launches, 0))
    adam.launches = 0
    lion.launches = 0


def profile_step(torch, engine, batch, step_s, tag):
    """Where a training step's time goes: one more step under the
    profiler, its device busy share of the unprofiled step ``step_s`` and
    its 15 longest kernels, printed under ``[tag]``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.train_batch(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print(f"[{tag}] device time not measured: the profiler recorded no "
              f"CUDA kernels", flush=True)
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[{tag}] device busy {busy:.1f} ms of the unprofiled step's "
          f"{step_s * 1e3:.1f} ms: busy share {busy / (step_s * 1e3):.3f}, idle share "
          f"{1 - busy / (step_s * 1e3):.3f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        ms = e.self_device_time_total / 1e3
        print(f"[{tag}]   {ms:9.2f} ms {ms / busy:6.1%} x{e.count:5d} "
              f"{e.key[:90]}", flush=True)


def train(torch, np, flash, adam, lion, config, warmup, steps, after=None):
    """tinyllama-1.1b trained at full width and depth under ``config``
    (AdamW or Lion); returns the training kernels' launch counts over the
    timed steps and the bytes of the optimizer's master and moments.
    ``after(engine, batch)`` runs on the trained engine before it is freed."""
    opt_name = config["optimizer"]["type"].lower()
    opt_kernel, other = (("fused_lion", "fused_adam") if opt_name == "lion"
                         else ("fused_adam", "fused_lion"))
    t0 = time.perf_counter()
    engine = train_engine(torch, config)
    torch.cuda.synchronize()
    c = engine.model.config
    buckets = len(engine.opt_state["buckets"])
    opt_bytes = sum(t.numel() * t.element_size() for b in engine.opt_state["buckets"]
                    for t in (b.master, b.exp_avg, b.exp_avg_sq) if t is not None)
    n_all = sum(p.numel() for p in engine.params.values())
    print(f"[train] tinyllama-1.1b layers {c.num_layers} hidden {c.hidden_size} heads "
          f"{c.num_heads}/{c.kv_heads} ffn {c.ffn_size} vocab {c.vocab_size}: {n_all} "
          f"params bf16, {opt_name}, fp32 master and moments in {buckets} buckets, built in "
          f"{time.perf_counter() - t0:.2f} s; state "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.default_rng(0)
    B = config["train_micro_batch_size_per_gpu"]
    batch = {"input_ids": rng.integers(0, c.vocab_size, size=(B, TRAIN_SEQ))}
    tokens = B * TRAIN_SEQ
    losses = [float(engine.train_batch(batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash, adam, lion)
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        times.append(time.perf_counter() - t)
    launches = dict(flash.launches, fused_adam=adam.launches, fused_lion=lion.launches)
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times) / len(times)
    flops, n = training_flops(c, n_all, tokens)
    mfu = flops / step_s / PEAK_FLOPS["torch.bfloat16"]
    print(f"[train] losses {[round(x, 4) for x in losses]} (ln {c.vocab_size} = "
          f"{np.log(c.vocab_size):.4f}); step ms {[round(x * 1e3, 1) for x in times]} mean "
          f"{step_s * 1e3:.1f}; tokens/s {tokens / step_s:.0f}; MFU {mfu:.4f} "
          f"({flops:.4e} flops a step: 6 x {n} non-embedding params x {tokens} tokens "
          f"+ causal attention, at 989 TFLOP/s); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; launches over {steps} steps {launches}",
          flush=True)
    if not all(np.isfinite(losses)):
        fail(f"training losses {losses}")
    if abs(losses[0] - np.log(c.vocab_size)) > 0.5:
        fail(f"first loss {losses[0]:.4f} not within 0.5 of ln({c.vocab_size})")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall on the repeated batch: {losses}")
    want = {"flash_fwd": 2 * c.num_layers * steps, "flash_dq": c.num_layers * steps,
            "flash_dkv": c.num_layers * steps, opt_kernel: buckets * steps, other: 0}
    if launches != want:
        fail(f"training launches {launches} != {want}")

    profile_step(torch, engine, batch, step_s, "train-profile")
    if after is not None:
        after(engine, batch)
    del engine
    torch.cuda.empty_cache()

    # the same width at 2 layers: 3 steps through the kernels, 3 through
    # their plain versions, from the same weights
    path = {}
    for name in ("kernels", "plain"):
        eng = train_engine(torch, config, PATH_LAYERS)
        zero_counts(flash, adam, lion)
        if name == "plain":
            with plain_kernels(flash, adam, lion):
                path[name] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
            if any(flash.launches.values()) or adam.launches or lion.launches:
                fail(f"the plain path launched kernels: {flash.launches}, adam "
                     f"{adam.launches}, lion {lion.launches}")
        else:
            path[name] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
        del eng
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(path["kernels"], path["plain"])]
    print(f"[train] {opt_name}, {PATH_LAYERS} layers, same width, {PATH_STEPS} steps: kernels "
          f"{path['kernels']} plain {path['plain']}, relative difference "
          f"{max(rel):.3e} (limit {PATH_RTOL}, bf16)", flush=True)
    if max(rel) > PATH_RTOL:
        fail(f"kernel and plain training paths differ by {max(rel):.3e}")
    return launches, opt_bytes


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def state_bytes(engine):
    """Bytes of the params and the optimizer's master and moments."""
    slots = [v for k, v in engine.opt_state.items() if k not in ("step", "buckets")]
    return sum(t.numel() * t.element_size()
               for tree in [engine.params] + slots for t in tree.values())


def param_digests(torch, params):
    """sha256 of each tensor's bytes: bitwise equality across processes."""
    import hashlib
    return {k: hashlib.sha256(v.detach().contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
            for k, v in params.items()}


def flip_a_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def read_latest(d):
    path = os.path.join(d, "latest")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip()


def checkpoint_phase(torch, np, engine, batch, config, smi):
    """The [checkpoint] phase on phase 7's trained engine: a synchronous save
    (tag bytes, seconds, the crc read-back apart), CKPT_STEPS more steps,
    the same steps from an engine of another seed that loaded the tag (losses
    and params bit for bit), an async save (the seconds it blocked, the
    seconds to the commit, ``latest`` repointed only at the commit), then
    keep-last-CKPT_KEEP and the corrupt-tag fallback on a 2-layer model of
    the same width. The depth is cut only where the disk cannot hold a tag."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.checkpoint import store
    root = tempfile.mkdtemp(prefix="dstpu-ckpt-")
    try:
        c = engine.model.config
        need, free = state_bytes(engine), shutil.disk_usage(root).free
        layers, cut = c.num_layers, ""
        if free < CKPT_DISK_MARGIN * need:
            n = sum(p.numel() for p in engine.params.values())
            per_layer = sum(p.numel() for k, p in engine.params.items()
                            if k.startswith("blocks.0."))
            fit = int((free / CKPT_DISK_MARGIN * n / need - (n - c.num_layers * per_layer))
                      // per_layer)
            if fit < 1:
                fail(f"[checkpoint] {free} bytes free at {root} hold no layer of the tag")
            layers, cut = fit, f"; depth cut to {fit} of {c.num_layers} layers to fit the disk"
            engine = train_engine(torch, config, layers)
            engine.train_batch(batch)
            need = state_bytes(engine)
        print(f"[checkpoint] {smi} | disk free {free} bytes at {root}; tinyllama-1.1b "
              f"{layers} layers, {need} bytes of params, master and moments{cut}", flush=True)
        d = os.path.join(root, "full")
        t = time.perf_counter()
        engine.save_checkpoint(d)
        save_s = time.perf_counter() - t
        tag = read_latest(d)
        nbytes = dir_bytes(os.path.join(d, tag))
        t = time.perf_counter()
        ok, why = store.verify_tag(os.path.join(d, tag))
        verify_s = time.perf_counter() - t
        if not ok:
            fail(f"[checkpoint] {tag} fails verification: {why}")
        print(f"[checkpoint] {smi} | sync save {tag}: {nbytes} bytes in {save_s:.3f} s "
              f"({nbytes / save_s / 1e9:.3f} GB/s, staging and the crc of the write included); "
              f"verify_tag (crc32 read-back) {verify_s:.3f} s "
              f"({nbytes / verify_s / 1e9:.3f} GB/s)", flush=True)
        want = [float(engine.train_batch(batch)) for _ in range(CKPT_STEPS)]
        other = train_engine(torch, dict(config, checkpoint={"async_save": True}), layers, seed=1)
        t = time.perf_counter()
        got_tag = other.load_checkpoint(d)[0]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        got = [float(other.train_batch(batch)) for _ in range(CKPT_STEPS)]
        differ = [k for k, p in engine.params.items() if not torch.equal(p, other.params[k])]
        print(f"[checkpoint] {smi} | load {got_tag} into an engine of another seed: {load_s:.3f} "
              f"s ({nbytes / load_s / 1e9:.3f} GB/s, verification included); {CKPT_STEPS} more "
              f"steps: saver {want}, loader {got}; params differing after them: {len(differ)} "
              f"of {len(engine.params)}", flush=True)
        if got_tag != tag or got != want or differ:
            fail(f"[checkpoint] the resume is not bitwise: losses {want} vs {got}, "
                 f"params differing {differ[:8]}")
        shutil.rmtree(os.path.join(d, tag))   # one full tag on the disk at a time
        t = time.perf_counter()
        other.save_checkpoint(d)
        blocked_s = time.perf_counter() - t
        tag2, before = f"global_step{other.global_steps}", read_latest(d)
        other.checkpoint_engine.commit(tag2)
        commit_s = time.perf_counter() - t
        after = read_latest(d)
        ok, why = store.verify_tag(os.path.join(d, tag2))
        print(f"[checkpoint] {smi} | async save {tag2}: save_checkpoint blocked {blocked_s:.3f} s "
              f"(every tensor staged in host memory), committed after {commit_s:.3f} s; latest "
              f"{before!r} on return, {after!r} after the commit; verify {ok}", flush=True)
        if before == tag2 or after != tag2 or not ok:
            fail(f"[checkpoint] async commit fence: latest {before!r} then {after!r}, verify "
                 f"{why}")
        other.checkpoint_engine.close()
        del other
        torch.cuda.empty_cache()

        small = train_engine(torch, dict(config, checkpoint={"keep_last_n": CKPT_KEEP}),
                             PATH_LAYERS)
        d2 = os.path.join(root, "keep")
        for _ in range(3):
            small.train_batch(batch)
            small.save_checkpoint(d2)
        tags = sorted(x for x in os.listdir(d2) if os.path.isdir(os.path.join(d2, x)))
        flip_a_byte(os.path.join(d2, "global_step3", "state.npz"))
        fell_back = small.load_checkpoint(d2)[0]
        try:
            small.load_checkpoint(d2, tag="global_step3")
            named = "loaded"
        except ValueError as e:
            named = f"raised ValueError ({str(e)[:60]}...)"
        print(f"[checkpoint] {smi} | {PATH_LAYERS} layers, keep_last_n {CKPT_KEEP}, three "
              f"saves: tags {tags}; a byte flipped in global_step3/state.npz: "
              f"load_checkpoint() took {fell_back}, the bad tag by name {named}", flush=True)
        if tags != ["global_step2", "global_step3"] or fell_back != "global_step2" \
                or not named.startswith("raised"):
            fail("[checkpoint] retention or the corrupt-tag fallback failed")
        del small
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# data-parallel ZeRO-3 training with the ZeRO++ int8 wire, two ranks
# ---------------------------------------------------------------------------


def zero_steps(torch, engine, batch, steps, quant):
    """``steps`` train_batch calls, each under its own collective ledger;
    per step: loss, seconds, quant launches and the ledger's records."""
    from deepspeed_tpu_torch.comm import comm as dist
    out = []
    for _ in range(steps):
        ledger = dist.CollectiveLedger()
        before = quant.launches
        t = time.perf_counter()
        with dist.record_into(ledger):
            loss = float(engine.train_batch(batch))
        torch.cuda.synchronize()
        out.append(dict(loss=loss, s=time.perf_counter() - t,
                        quant=quant.launches - before, records=ledger.records))
    return out


def collective_share(torch, engine, batch):
    """One more step with every collective of ``comm`` timed on the host
    clock (the device synchronized before and after each): ``(seconds in
    collectives, seconds of the step, collectives, the step's loss)``. A
    launched collective (the overlap schedule's ``*_async`` forms) is timed
    at its launch and at its ``wait()``, each synchronized, so on that
    schedule the share is an upper bound: the synchronizations take away the
    overlap they measure. On gloo a collective's time includes the copies
    of its tensors to and from host memory."""
    from deepspeed_tpu_torch.comm import comm as dist
    names = ("all_gather", "all_to_all", "all_reduce", "reduce_scatter", "ppermute",
             "all_gather_async", "all_reduce_async", "reduce_scatter_async",
             "all_to_all_rows_async")
    saved = {n: getattr(dist, n) for n in names}
    saved_wait = dist.Work.wait
    acc = [0.0, 0, 0]   # seconds, launches, nesting depth

    def timed(fn, launch=True):
        def call(*args, **kw):
            if acc[2]:
                return fn(*args, **kw)
            acc[2] += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                acc[2] -= 1
            acc[0] += time.perf_counter() - t
            acc[1] += int(launch)
            return out
        return call

    for n in names:
        setattr(dist, n, timed(saved[n]))
    dist.Work.wait = timed(saved_wait, launch=False)
    try:
        t = time.perf_counter()
        loss = float(engine.train_batch(batch))
        step = time.perf_counter() - t
    finally:
        for n in names:
            setattr(dist, n, saved[n])
        dist.Work.wait = saved_wait
    return acc[0], step, acc[1], loss


def quant_step_profile(torch, engine, batch, quant, profiled):
    """One more step with every row-quantizer call recorded: calls, rows a
    call (a histogram by powers of two), the calls' summed bytes bound and,
    where ``profiled``, the quantizer kernels' device ms and launches from
    ``torch.profiler`` (kernels whose name holds ``GroupRows``: the row forms
    of ``csrc/quant_common.cuh`` over the wire's groups, not the int8 gather's
    ``SlotRows``)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile
    calls = []
    launch = quant._quant_cuda

    def recorded(groups):
        calls.append((groups.shape[0], groups.shape[1], groups.element_size()))
        return launch(groups)

    quant._quant_cuda = recorded
    try:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                float(engine.train_batch(batch))
                torch.cuda.synchronize()
        else:
            float(engine.train_batch(batch))
    finally:
        quant._quant_cuda = launch
    hist = Counter(1 << (G.bit_length() - 1) for G, _, _ in calls)
    out = {"calls": len(calls), "rows": dict(sorted(hist.items())),
           "bound_ms": sum(bound(*quant_bounds(G, gs, isz), torch.float32)[0]
                           for G, gs, isz in calls)}
    if profiled:
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "GroupRows" in e.key]
        out["device_ms"] = sum(e.self_device_time_total for e in ev) / 1e3 if ev else None
        out["launches"] = sum(e.count for e in ev)
    return out


def wire_summary(records):
    """Launches and bytes of one step's records by (op, width)."""
    out = {}
    for r in records:
        width = "int8" if r["wire_bytes"] < r["bytes"] else "full"
        e = out.setdefault(f"{r['op']}/{width}", {"launches": 0, "bytes": 0, "wire_bytes": 0})
        e["launches"] += r["count"]
        e["bytes"] += r["bytes"] * r["count"]
        e["wire_bytes"] += r["wire_bytes"] * r["count"]
    return out


def schedule_class(r):
    """A ledger record's ``(op, width, class)``: int8 where fewer bytes
    travel than the logical ones."""
    return (r["op"], "int8" if r["wire_bytes"] < r["bytes"] else "full",
            "overlapped" if r["overlapped"] else "exposed")


def class_counts(records):
    """Launches by ``schedule_class``."""
    out = {}
    for r in records:
        k = schedule_class(r)
        out[k] = out.get(k, 0) + r["count"]
    return out


def ledger_split(dist, records):
    """The overlapped and exposed wire bytes of ``records``."""
    ledger = dist.CollectiveLedger()
    ledger.records = records
    return ledger.split()


def overlap_expected(engine):
    """The launches a training step of the overlap schedule states, by
    ``(op, width, class)``, from the engine's plan: for ``n`` steps of layers,
    each block gather launch ``n`` times forward (the first exposed) and
    ``n - 1`` times backward, each block reduction ``n`` times (the last
    exposed), a flush a dtype of deferred leaves (exposed), the rest leaves'
    launches once (the head side's overlapped under the edge split), and the
    optimizer step's full-width refresh of each persistent leaf (exposed)."""
    from collections import Counter
    sch = engine._sched
    n = engine.model.config.num_layers // sch.lps
    out = Counter()

    def launches(op, entries, tps, comms, counts):
        for e, tp in zip(entries, tps):
            if comms[e.leaves[0]].dim is None:
                continue
            o = "all_to_all" if op == "reduce_scatter" and tp.quantized else op
            for cls, k in counts.items():
                out[(o, "int8" if tp.quantized else "full", cls)] += k

    blk = sch.blk_comm
    ahead = sch.depth if n > 2 else 1   # the prologue's gathers
    launches("all_gather", blk.gather_plan, blk.gather_tp, blk.gcomms,
             {"exposed": ahead, "overlapped": 2 * n - 1 - ahead})
    launches("reduce_scatter", blk.scatter_plan, blk.scatter_tp, blk.scomms,
             {"exposed": 1, "overlapped": n - 1})
    dtypes = {blk.scomms[i].dtype for i in blk.deferred_leaves}
    if dtypes:
        out[("all_reduce", "full", "exposed")] += len(dtypes)
    for cm in sch.rest_comms:
        cls = "overlapped" if cm.overlapped else "exposed"
        launches("all_gather", cm.gather_plan, cm.gather_tp, cm.gcomms, {cls: 1})
        launches("reduce_scatter", cm.scatter_plan, cm.scatter_tp, cm.scomms, {cls: 1})
        reps = sum(1 for e in cm.scatter_plan if cm.scomms[e.leaves[0]].dim is None)
        if reps:
            out[("all_reduce", "full", cls)] += reps
    out[("all_gather", "full", "exposed")] += len(engine._cast_shards)
    return +out


def host_waits(dist):
    """Wraps ``comm.Work.wait`` to add up the host's seconds blocked in it
    (no synchronization added); returns ``(restore, seconds)``."""
    saved, acc = dist.Work.wait, [0.0]

    def wait(self):
        t = time.perf_counter()
        try:
            return saved(self)
        finally:
            acc[0] += time.perf_counter() - t

    dist.Work.wait = wait
    return (lambda: setattr(dist.Work, "wait", saved)), acc


def half_steps(torch, x):
    """Half the int8 step of each element's group of INT8_GROUP along flat
    ``x`` (zero-padded tail): absmax / 254, or 1/2 for an all-zero group."""
    pad = (-x.numel()) % INT8_GROUP
    g = torch.nn.functional.pad(x.abs().double(), (0, pad)).reshape(-1, INT8_GROUP)
    scale = g.amax(dim=1) / 127
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return (scale / 2).repeat_interleave(INT8_GROUP)[:x.numel()]


def scatter_within_int8_bound(torch, dist, comm, grads, shards, rank):
    """The first block reduce-scatter of a ZeRO++ overlap step against the
    exact mean of both ranks' local gradients (each rank's rows for this
    destination arrive by an all-to-all): ``(worst err / bound, rounded
    elements)``; the bound is the mean of the sources' half int8 steps of
    each element's group, plus INT8_SLACK of it and 1e-6 of the value."""
    n, worst, rounded = comm.n_dp, 0.0, 0
    for g, got, lc in zip(grads, shards, comm.scomms):
        if lc.dim is None:
            continue
        rows = g.movedim(lc.dim, 0).reshape(n, -1).contiguous()
        src = dist.all_to_all(rows).double()             # [source, this rank's row]
        exact = src.sum(dim=0) / n
        bound = (sum(half_steps(torch, src[s]) for s in range(n)) / n * (1 + INT8_SLACK)
                 + 1e-6 * exact.abs())
        err = (got.movedim(lc.dim, 0).reshape(-1).double() - exact).abs()
        worst = max(worst, float((err / bound).max()))
        rounded += int((err > 1e-6 * exact.abs()).sum())
    return worst, rounded


def zero_overlap_rank(torch, np, batch, flash, adam, lion, quant):
    """[zero-overlap] in a rank of [zero], after the barrier run: the
    overlap schedule at full width and depth under ZERO_OVERLAP_CONFIG, then
    the 2-layer checks. Returns what it measured."""
    from deepspeed_tpu_torch.comm import comm as dist
    t0 = time.perf_counter()
    eng = train_engine(torch, ZERO_OVERLAP_CONFIG)
    if not eng._overlap_active:
        raise RuntimeError(f"[zero-overlap] the ZeRO++ config did not take the overlap "
                           f"schedule: {eng._overlap_fallback!r}")
    res = {"plan": eng._sched.plan.summary(), "plans": [
        cm.plan_summary() for cm in (eng._sched.blk_comm,) + eng._sched.rest_comms],
        "expected": dict(overlap_expected(eng))}
    warm = zero_steps(torch, eng, batch, ZERO_OVERLAP_WARMUP, quant)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash, adam, lion)
    quant.launches = 0
    restore, waited = host_waits(dist)
    try:
        timed = zero_steps(torch, eng, batch, ZERO_OVERLAP_STEPS, quant)
    finally:
        restore()
    res.update(
        losses=[x["loss"] for x in warm + timed], step_s=[x["s"] for x in timed],
        quant_per_step=[x["quant"] for x in timed], peak=torch.cuda.max_memory_allocated(),
        launches=dict(flash.launches, fused_adam=adam.launches, quant_rows=quant.launches),
        wait_s=waited[0] / ZERO_OVERLAP_STEPS,
        classes=[class_counts(x["records"]) for x in timed],
        split=[ledger_split(dist, x["records"]) for x in timed],
        wire=[wire_summary(x["records"]) for x in timed])
    res["comm_s"], res["comm_step_s"], res["comm_launches"], _ = collective_share(
        torch, eng, batch)
    # one more step, rank 0 under the profiler: the device's busy share of
    # the unprofiled step, and its kernels (both ranks take the step)
    if dist.get_rank() == 0:
        profile_step(torch, eng, batch, sum(res["step_s"]) / len(res["step_s"]),
                     "zero-overlap-profile")
        print("[zero-overlap-profile] rank 0's kernels only: rank 1 runs as many on the same "
              "card, so the card's busy share is about twice rank 0's", flush=True)
    else:
        float(eng.train_batch(batch))
    del eng
    gc_cuda(torch)
    # 2 layers: plain stage 3 on the schedule at full width against two barrier runs
    runs = {}
    for name, cfg in (("barrier", ZERO_S3_BARRIER_CONFIG), ("barrier-again",
                                                            ZERO_S3_BARRIER_CONFIG),
                      ("overlap", ZERO_S3_OVERLAP_CONFIG)):
        e = train_engine(torch, cfg, PATH_LAYERS)
        if e._overlap_active != (name == "overlap"):
            raise RuntimeError(f"[zero-overlap] {name} run: overlap active {e._overlap_active}")
        losses = [float(e.train_batch(batch)) for _ in range(PATH_STEPS)]
        runs[name] = (losses, {k: v.float().clone() for k, v in e.module_state_dict().items()})
        del e
        gc_cuda(torch)

    def gap(a, b):
        return max([abs(x - y) for x, y in zip(runs[a][0], runs[b][0])]
                   + [float((runs[a][1][k] - runs[b][1][k]).abs().max()) for k in runs[a][1]])

    res["s3"] = dict(losses={k: v[0] for k, v in runs.items()},
                     witness=gap("barrier", "barrier-again"), gap=gap("overlap", "barrier"),
                     bitwise=all(torch.equal(runs["overlap"][1][k], runs["barrier"][1][k])
                                 for k in runs["barrier"][1])
                     and runs["overlap"][0] == runs["barrier"][0])
    del runs
    gc_cuda(torch)
    # 2 layers: the ZeRO++ schedule's first block reduce-scatter (the last
    # layer's fused bucket) against the int8 bound
    e = train_engine(torch, ZERO_OVERLAP_CONFIG, PATH_LAYERS)
    blk, seen = e._sched.blk_comm, []
    scatter = blk.scatter

    def first(gs):
        h = scatter(gs)
        if not seen:
            seen.append(([g.detach().clone() for g in gs], [r.clone() for r in h.wait()]))
        return h

    blk.scatter = first
    float(e.train_batch(batch))
    blk.scatter = scatter
    res["bound"] = scatter_within_int8_bound(torch, dist, blk, *seen[0], dist.get_rank())
    res["bound_widths"] = sorted({tp.width for tp in blk.scatter_tp})
    del e, seen
    gc_cuda(torch)
    res["s"] = time.perf_counter() - t0
    return res


def ef_residual_sum(engine):
    """The summed magnitude of every error-feedback residual slot."""
    st = engine._ef_state
    return sum(float(t.abs().sum()) for slots in (*st["blocks"], *(
        v for k, v in st.items() if k != "blocks")) for t in slots if t is not None)


def full_grads(engine):
    """The accumulated gradient shards of a ZeRO engine gathered whole."""
    from deepspeed_tpu_torch.comm import comm as dist
    out = {}
    for k, g in engine.grad_acc.items():
        d = engine.grad_dims[k]
        out[k] = g if d is None else dist.all_gather(g.movedim(d, 0)).movedim(0, d)
    return out


def zero_ef_rank(torch, np, batch, vocab, flash, adam, lion, quant):
    """[zero-ef] in a rank of [zero]: error feedback on the overlap schedule
    at full width and depth, then the 2-layer checks. Returns what it
    measured."""
    t0 = time.perf_counter()
    eng = train_engine(torch, ZERO_EF_CONFIG)
    if not (eng._overlap_active and eng._ef_carry_active):
        raise RuntimeError(f"[zero-ef] no error-feedback carry: overlap {eng._overlap_active}, "
                           f"carry {eng._ef_carry_active}")
    st = eng._sched.ef_struct
    slots = [s for step in st["blocks"] for s in step] + [s for k, v in st.items()
                                                         if k != "blocks" for s in v]
    res = {"slots": sum(s is not None for s in slots), "slot_bytes": 4 * sum(
        int(np.prod(s)) for s in slots if s is not None)}
    warm = zero_steps(torch, eng, batch, ZERO_OVERLAP_WARMUP, quant)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash, adam, lion)
    quant.launches = 0
    timed = zero_steps(torch, eng, batch, ZERO_OVERLAP_STEPS, quant)
    res.update(losses=[x["loss"] for x in warm + timed], step_s=[x["s"] for x in timed],
               quant_per_step=[x["quant"] for x in timed],
               peak=torch.cuda.max_memory_allocated(),
               launches=dict(flash.launches, fused_adam=adam.launches, quant_rows=quant.launches),
               residual=ef_residual_sum(eng), wire=wire_summary(timed[-1]["records"]))
    del eng
    gc_cuda(torch)
    # 2 layers: JAX's telescoping test, on distinct batches
    rng = np.random.default_rng(5)
    rows = len(batch["input_ids"])
    micros = [{"input_ids": rng.integers(0, vocab, size=(rows, EF_SEQ))}
              for _ in range(EF_MICROS)]
    grads = {}
    for name, cfg in EF_RUNS.items():
        e = train_engine(torch, cfg, PATH_LAYERS)
        for b in micros:
            e.forward(b)
            e.backward()
        grads[name] = full_grads(e)
        if name == "ef":
            res["tele_carry"] = (e._ef_carry_active, ef_residual_sum(e))
        del e
        gc_cuda(torch)
    err = lambda name: max(float((grads[name][k] - grads["full"][k]).abs().max())
                           for k in grads["full"])
    res["tele"] = dict(ef=err("ef"), plain=err("plain"), scale=max(
        float(v.abs().max()) for v in grads["full"].values()))
    del grads
    gc_cuda(torch)
    # 2 layers: the error-feedback engine through the kernels and the plain versions
    path = {}
    for name in ("kernels", "plain"):
        e = train_engine(torch, ZERO_EF_CONFIG, PATH_LAYERS)
        zero_counts(flash, adam, lion)
        quant.launches = 0
        if name == "plain":
            with plain_kernels(flash, adam, lion, quant):
                path[name] = [float(e.train_batch(batch)) for _ in range(PATH_STEPS)]
            if any(flash.launches.values()) or adam.launches or quant.launches:
                raise RuntimeError(f"[zero-ef] the plain path launched kernels: "
                                   f"{flash.launches}, adam {adam.launches}, quant "
                                   f"{quant.launches}")
        else:
            path[name] = [float(e.train_batch(batch)) for _ in range(PATH_STEPS)]
        del e
        gc_cuda(torch)
    res["path"] = path
    res["s"] = time.perf_counter() - t0
    return res


class onebit_capture:
    """A 1-bit optimizer whose next ``update`` keeps, for the leaves of at
    most ONEBIT_CHECK_NUMEL elements, the state before it and the local
    gradients it was given (``before``), and its step and lr."""

    SLOTS = ("master", "exp_avg", "exp_avg_sq", "worker_error", "server_error", "lamb_coeff")

    def __init__(self, opt):
        self.opt, self.before = opt, None

    def __getattr__(self, k):
        return getattr(self.opt, k)

    def update(self, grads, state, lr, write_back=None):
        self.lr, self.step, self.var_counter = lr, state["step"], state.get("var_counter")
        self.before = {
            p: dict({k: state[k][p].clone() for k in self.SLOTS if k in state}, grad=grads[p])
            for p, t in state["master"].items() if t.numel() <= ONEBIT_CHECK_NUMEL}
        return self.opt.update(grads, state, lr, write_back)


def onebit_reference(torch, name, opt, cap, rank):
    """This rank's state after the captured update, from the JAX formulas
    (``runtime/comm/compressed.py``, ``runtime/fp16/onebit/{adam,lamb,
    zoadam}.py``) transcribed in plain fp32 torch on every rank's captured
    gradients, momentum and errors (gathered on the host by
    ``torch.distributed``): ``{path: {slot: tensor}}``."""
    import torch.distributed as tdist
    n = tdist.get_world_size()
    b1, b2 = opt.betas
    step = cap.step + 1
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    sign = lambda x: torch.where(x >= 0, 1.0, -1.0)

    def every_rank(t):
        got = [torch.empty_like(t, device="cpu") for _ in range(n)]
        tdist.all_gather(got, t.cpu())
        return [g.to(t.device) for g in got]

    if name == "zero_one_adam":
        sync = step % (2 ** min(step // opt.local_step_scaler, 10)) == 0
        var_update = (step <= opt.var_freeze_step
                      and step % (2 ** min(step // opt.var_update_scaler, 10)) == 0)
    else:
        sync, var_update = step > opt.freeze_step, False
    if not sync:
        raise RuntimeError(f"[onebit] {name}: the checked step {step} does not compress")
    out = {}
    for path, b in cap.before.items():
        p, m, v = b["master"], b["exp_avg"], b["exp_avg_sq"]
        grads, moms = every_rank(b["grad"]), every_rank(m)
        wes, ses = every_rank(b["worker_error"]), every_rank(b["server_error"])
        numel, padded = p.numel(), wes[0].numel()
        chunk = padded // n
        # the workers: compensate, a sign a value and a scale
        comps = [torch.nn.functional.pad((b1 * mk + (1 - b1) * gk).reshape(-1),
                                         (0, padded - numel)) + we
                 for mk, gk, we in zip(moms, grads, wes)]
        scales = [c.abs().mean() for c in comps]
        signs = [sign(c) for c in comps]
        new_we = comps[rank] - scales[rank] * signs[rank]
        # the servers: average each chunk, compress again
        synced, new_se = [], None
        for j in range(n):
            avg = torch.stack([sc * sg[j * chunk:(j + 1) * chunk]
                               for sc, sg in zip(scales, signs)]).mean(dim=0)
            comp_s = avg + ses[j]
            scale_s, sign_s = comp_s.abs().mean(), sign(comp_s)
            synced.append(scale_s * sign_s)
            if j == rank:
                new_se = comp_s - scale_s * sign_s
        m_new = torch.cat(synced)[:numel].reshape(p.shape)
        want = {"exp_avg": m_new, "worker_error": new_we, "server_error": new_se}
        if name == "zero_one_adam":
            v_new = b2 * v + (1 - b2) * m_new * m_new if var_update else v
            counter = cap.var_counter + int(var_update)
            bc1 = 1.0 - f32(b1) ** f32(step)
            bc2 = 1.0 - f32(b2) ** f32(max(counter, 1))
            want["exp_avg_sq"] = v_new
            want["master"] = p - cap.lr * ((m_new / bc1.to(p.device))
                                           / (torch.sqrt(v_new / bc2.to(p.device)) + opt.eps)
                                           + opt.weight_decay * p)
        else:
            update = m_new / (torch.sqrt(v) + opt.eps) + opt.weight_decay * p
            coeff = b["lamb_coeff"] if name == "onebit_lamb" else 1.0
            want["master"] = p - cap.lr * coeff * update
            want["exp_avg_sq"] = v
            if name == "onebit_lamb":
                want["lamb_coeff"] = coeff
        out[path] = want
    return out


def onebit_check(torch, name, eng, cap, rank):
    """The engine's state after the captured update against
    ``onebit_reference``: per slot, the largest absolute difference, the
    elements off ONEBIT_TOL, the elements checked and the leaves with more
    elements off than ONEBIT_FLIPS of them (or one)."""
    want = onebit_reference(torch, name, eng.optimizer.opt, cap, rank)
    res = {}
    for path, slots in want.items():
        for slot, w in slots.items():
            got = eng.opt_state[slot][path]
            d = (got - w).abs()
            off = int((d > ONEBIT_TOL + ONEBIT_TOL * w.abs()).sum())
            r = res.setdefault(slot, {"max_abs_err": 0.0, "off": 0, "numel": 0, "bad": 0})
            r["max_abs_err"] = max(r["max_abs_err"], float(d.max()))
            r["off"] += off
            r["numel"] += w.numel()
            r["bad"] += off > max(1, int(ONEBIT_FLIPS * w.numel()))
    return {"leaves": len(want), "slots": res}


def onebit_config(name, params):
    return {"train_micro_batch_size_per_gpu": ZERO_CONFIG["train_micro_batch_size_per_gpu"],
            "bf16": {"enabled": True},
            "optimizer": {"type": name, "params": {"lr": ONEBIT_LR, **params}}}


def onebit_rank(torch, np, batch, flash, adam, lion, quant):
    """[onebit] in a rank of [zero]: each 1-bit optimizer of ONEBIT_RUNS
    through ``initialize`` + ``train_batch``. Returns, for each, what it
    measured."""
    from deepspeed_tpu_torch.comm import comm as dist
    out = {}
    for name, params in ONEBIT_RUNS:
        t0 = time.perf_counter()
        gc_cuda(torch)
        torch.cuda.reset_peak_memory_stats()
        eng = train_engine(torch, onebit_config(name, params), ONEBIT_LAYERS)
        if type(eng).__name__ != "OnebitDataParallelEngine" or eng._overlap_active:
            raise RuntimeError(f"[onebit] {name}: {type(eng).__name__} is not the 1-bit "
                               "engine, or it took a ZeRO schedule")
        n = dist.get_world_size()
        numel = [int(t.numel()) for t in eng.opt_state["master"].values()]
        padded = [-(-k // n) * n for k in numel]
        zero_counts(flash, adam, lion)
        quant.launches = 0
        steps = zero_steps(torch, eng, batch, ONEBIT_STEPS - 1, quant)
        eng.optimizer = cap = onebit_capture(eng.optimizer)   # the last step
        steps += zero_steps(torch, eng, batch, 1, quant)
        torch.cuda.synchronize()
        check = onebit_check(torch, name, eng, cap, dist.get_rank())
        del cap.before
        out[name] = dict(
            check=check,
            layers=eng.model.config.num_layers, losses=[x["loss"] for x in steps],
            step_s=[x["s"] for x in steps],
            wire=[sum(r["wire_bytes"] for r in x["records"]) for x in steps],
            full_bytes=4 * sum(numel),
            compressed_bytes=sum(p + p // n + 8 for p in padded),
            launches=dict(flash.launches, fused_adam=adam.launches, quant_rows=quant.launches),
            digests=param_digests(torch, eng.module_state_dict()),
            state_bytes=sum(t.numel() * t.element_size() for slot in eng.opt_state.values()
                            if isinstance(slot, dict) for t in slot.values()),
            peak=torch.cuda.max_memory_allocated(), s=time.perf_counter() - t0)
        del eng
        gc_cuda(torch)
    return out


def zero_rank(rank, init_method, results, ckpt_dir):
    """One rank of the [zero] phase (a process of its own): tinyllama-1.1b
    at full width and depth through ``initialize`` + ``train_batch`` under
    ZERO_CONFIG, then the 2-layer kernels / plain / full-width runs, then a
    2-layer ZeRO-3 engine's rank files saved into ``ckpt_dir`` and loaded at
    stage 1. Puts its measurements on ``results``."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.comm import comm as dist
    from deepspeed_tpu_torch.ops.adam import adam
    from deepspeed_tpu_torch.ops.lion import lion
    from deepspeed_tpu_torch.ops.quantizer import quant
    from deepspeed_tpu_torch.ops.transformer import flash
    dist.init_distributed(ZERO_BACKEND, rank=rank, world_size=ZERO_WORLD,
                          init_method=init_method, timeout=ZERO_TIMEOUT)
    res = {"rank": rank, "backend": dist.get_backend()}
    engine = train_engine(torch, ZERO_CONFIG)
    torch.cuda.synchronize()
    c = engine.model.config
    opt_bytes = sum(t.numel() * t.element_size() for b in engine.opt_state["buckets"]
                    for t in (b.master, b.exp_avg, b.exp_avg_sq))
    n_params = sum(int(np.prod(s)) for s in engine.zero_plan.shapes.values())
    rng = np.random.default_rng(0)
    rows = ZERO_CONFIG["train_micro_batch_size_per_gpu"] * ZERO_WORLD
    batch = {"input_ids": rng.integers(0, c.vocab_size, size=(rows, TRAIN_SEQ))}
    warm = zero_steps(torch, engine, batch, ZERO_WARMUP, quant)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash, adam, lion)
    quant.launches = 0
    timed = zero_steps(torch, engine, batch, ZERO_STEPS, quant)
    res.update(
        losses=[x["loss"] for x in warm + timed], step_s=[x["s"] for x in timed],
        quant_per_step=[x["quant"] for x in timed],
        launches=dict(flash.launches, fused_adam=adam.launches, quant_rows=quant.launches),
        peak=torch.cuda.max_memory_allocated())
    comm_s, step_s, n_coll, _ = collective_share(torch, engine, batch)
    res["quant_profile"] = quant_step_profile(torch, engine, batch, quant, rank == 0)
    res.update(
        comm_s=comm_s, comm_step_s=step_s, comm_launches=n_coll, opt_bytes=opt_bytes,
        flops=training_flops(c, n_params, rows * TRAIN_SEQ)[0], vocab=c.vocab_size,
        layers=c.num_layers,
        buckets=len(engine.opt_state["buckets"]),
        param_shards=len(engine.param_shards), refreshed=len(engine._cast_shards),
        refresh_bytes=sum(t.numel() * t.element_size() for t in engine._cast_shards.values()),
        wire=[wire_summary(x["records"]) for x in timed])
    del engine
    torch.cuda.empty_cache()
    res["overlap"] = zero_overlap_rank(torch, np, batch, flash, adam, lion, quant)
    # 2 layers, same width: kernels, plain versions, full width (no ZeRO++)
    path = {}
    for name, cfg in (("kernels", ZERO_CONFIG), ("plain", ZERO_CONFIG),
                      ("full-width", ZERO_PLAIN_CONFIG)):
        eng = train_engine(torch, cfg, PATH_LAYERS)
        zero_counts(flash, adam, lion)
        quant.launches = 0
        if name == "plain":
            with plain_kernels(flash, adam, lion, quant):
                path[name] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
            if any(flash.launches.values()) or adam.launches or quant.launches:
                raise RuntimeError(f"the plain path launched kernels: {flash.launches}, "
                                   f"adam {adam.launches}, quant {quant.launches}")
        else:
            path[name] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
        if name == "full-width" and quant.launches:
            raise RuntimeError(f"the full-width run launched the quantizer {quant.launches} times")
        del eng
        torch.cuda.empty_cache()
    res["path"] = path
    eng = train_engine(torch, ZERO_CONFIG, PATH_LAYERS)
    eng.train_batch(batch)
    t = time.perf_counter()
    eng.save_checkpoint(ckpt_dir)
    save_s = time.perf_counter() - t
    saved = param_digests(torch, eng.module_state_dict())
    del eng
    torch.cuda.empty_cache()
    eng = train_engine(torch, ZERO_STAGE1_CONFIG, PATH_LAYERS, seed=1)
    t = time.perf_counter()
    tag = eng.load_checkpoint(ckpt_dir)[0]
    torch.cuda.synchronize()
    res["ckpt"] = dict(tag=tag, saved=saved, stage1=param_digests(torch, eng.module_state_dict()),
                       save_s=save_s, load_s=time.perf_counter() - t)
    del eng
    torch.cuda.empty_cache()
    res["ef"] = zero_ef_rank(torch, np, batch, c.vocab_size, flash, adam, lion, quant)
    res["onebit"] = onebit_rank(torch, np, batch, flash, adam, lion, quant)
    results.put(res)
    dist.barrier()
    dist.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_zero_ranks(ckpt_dir):
    """Spawn ZERO_WORLD ranks of ``zero_rank`` and collect their results;
    fails if a rank fails or the ranks outlast ZERO_TIMEOUT (the ranks are
    then killed)."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=zero_rank, args=(r, init, results, ckpt_dir))
             for r in range(ZERO_WORLD)]
    for p in procs:
        p.start()
    out, deadline = [], time.monotonic() + ZERO_TIMEOUT
    try:
        while len(out) < ZERO_WORLD:
            try:
                out.append(results.get(timeout=5))
            except queue.Empty:
                bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if bad:
                    fail(f"[zero] a rank exited with {bad}")
                if time.monotonic() > deadline:
                    fail(f"[zero] the ranks did not finish within {ZERO_TIMEOUT} s")
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5))
            if p.exitcode != 0:
                fail(f"[zero] rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return sorted(out, key=lambda r: r["rank"])


def zero_checkpoint(torch, ranks, ckpt_dir, smi):
    """[zero]'s rank files: the saver's params on both ranks, after the load
    at world 2 stage 1, and after a load in this process into a single-device
    engine, bit for bit."""
    ck = [r["ckpt"] for r in ranks]
    saved = ck[0]["saved"]
    t = time.perf_counter()
    one = train_engine(torch, TRAIN_CONFIG, PATH_LAYERS, seed=2)
    tag = one.load_checkpoint(ckpt_dir)[0]
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    single = param_digests(torch, one.module_state_dict())
    del one
    torch.cuda.empty_cache()
    files = sorted(f for f in os.listdir(os.path.join(ckpt_dir, tag)) if f.endswith(".npz"))
    print(f"[zero] {smi} | checkpoint of the {PATH_LAYERS}-layer ZeRO-3 + ZeRO++ engine: {tag}, "
          f"{files}, {dir_bytes(os.path.join(ckpt_dir, tag))} bytes; save s a rank "
          f"{[round(c['save_s'], 3) for c in ck]}; load at world 2 stage 1 s a rank "
          f"{[round(c['load_s'], 3) for c in ck]}; load into one device {one_s:.3f} s (engine "
          f"build included); params equal to the saver's: stage 1 "
          f"{[c['stage1'] == saved for c in ck]}, one device {single == saved}", flush=True)
    if files != [f"state.rank{r}.npz" for r in range(ZERO_WORLD)]:
        fail(f"[zero] rank files {files}")
    if any(c["saved"] != saved or c["stage1"] != saved for c in ck) or single != saved:
        fail("[zero] the params after a load differ from the saver's")


def train_zero(torch, np, single_opt_bytes, smi):
    """The [zero] phase: two ranks on one card train tinyllama-1.1b with
    ZeRO-3 and the ZeRO++ int8 wire; checks and prints what they measured;
    then the rank files of a 2-layer engine (``zero_checkpoint``). Returns
    the quantizer's launches over the timed steps, both ranks."""
    import shutil
    import tempfile
    print(f"[zero] backend {ZERO_BACKEND} (given; two ranks share cuda:0, so every "
          f"collective crosses host memory on this card), world {ZERO_WORLD}, config "
          f"{json.dumps(ZERO_CONFIG['zero_optimization'])}", flush=True)
    t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="dstpu-zero-ckpt-")
    try:
        ranks = run_zero_ranks(ckpt_dir)
        zero_checkpoint(torch, ranks, ckpt_dir, smi)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    r0 = ranks[0]
    losses = r0["losses"]
    print(f"[zero] ranks done in {time.perf_counter() - t0:.1f} s; backend reported "
          f"{[r['backend'] for r in ranks]}", flush=True)
    if any(r["losses"] != losses for r in ranks):
        fail(f"[zero] losses differ between ranks: {[r['losses'] for r in ranks]}")
    if not all(np.isfinite(losses)):
        fail(f"[zero] losses {losses}")
    if abs(losses[0] - np.log(r0["vocab"])) > 0.5:
        fail(f"[zero] first loss {losses[0]:.4f} not within 0.5 of ln({r0['vocab']})")
    if not losses[-1] < losses[0]:
        fail(f"[zero] loss did not fall on the repeated batch: {losses}")
    for r in ranks:
        for i, (nq, wire) in enumerate(zip(r["quant_per_step"], r["wire"])):
            n_int8 = sum(v["launches"] for k, v in wire.items() if k.endswith("/int8"))
            full_gathers = wire.get("all_gather/full", {"launches": 0, "bytes": 0})
            if nq != n_int8:
                fail(f"[zero] rank {r['rank']} step {i}: {nq} quantizer launches, "
                     f"{n_int8} int8 collectives")
            if wire.get("all_gather/int8", {}).get("launches") != r["param_shards"]:
                fail(f"[zero] rank {r['rank']} step {i}: int8 gathers {wire} for "
                     f"{r['param_shards']} stage-3 shards")
            if (full_gathers["launches"] != r["refreshed"]
                    or full_gathers["bytes"] != r["refresh_bytes"]):
                fail(f"[zero] rank {r['rank']} step {i}: a full-width all-gather of a "
                     f"stage-3 shard: {full_gathers} beside {r['refreshed']} persistent "
                     f"leaves of {r['refresh_bytes']} bytes")
        ratio = r["opt_bytes"] / single_opt_bytes
        if not 0.45 <= ratio <= 0.55:
            fail(f"[zero] rank {r['rank']} master + moments {r['opt_bytes']} bytes, "
                 f"{ratio:.3f} of the one-device engine's {single_opt_bytes}")
    step_s = sum(r0["step_s"]) / len(r0["step_s"])
    tokens = ZERO_CONFIG["train_micro_batch_size_per_gpu"] * ZERO_WORLD * TRAIN_SEQ
    mfu = r0["flops"] / step_s / PEAK_FLOPS["torch.bfloat16"]
    print(f"[zero] tinyllama-1.1b layers {r0['layers']}: losses {[round(x, 4) for x in losses]} "
          f"(equal on both ranks); step ms {[round(x * 1e3, 1) for x in r0['step_s']]} mean "
          f"{step_s * 1e3:.1f}; tokens/s {tokens / step_s:.0f} ({tokens} tokens a step over "
          f"both ranks, on the one card); MFU {mfu:.4f}; max_memory_allocated per rank "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB; master + moments per rank "
          f"{[round(r['opt_bytes'] / 2**30, 3) for r in ranks]} GiB vs one device "
          f"{single_opt_bytes / 2**30:.3f} GiB; {r0['param_shards']} stage-3 shards, "
          f"{r0['refreshed']} persistent leaves, {r0['buckets']} optimizer buckets", flush=True)
    for r in ranks:
        print(f"[zero] rank {r['rank']} where the time goes: one more step of "
              f"{r['comm_step_s'] * 1e3:.1f} ms, {r['comm_launches']} collectives timed "
              f"(device synchronized around each) {r['comm_s'] * 1e3:.1f} ms: share "
              f"{r['comm_s'] / r['comm_step_s']:.3f}", flush=True)
    qp = r0["quant_profile"]
    if qp["device_ms"] is None:
        print(f"[zero] rank 0 row quantizer in one more step: {qp['calls']} calls; device ms not "
              f"measured (the profiler recorded no GroupRows kernel)", flush=True)
    else:
        print(f"[zero] rank 0 row quantizer in one more step, profiled: {qp['calls']} calls, "
              f"{qp['launches']} kernel launches, device {qp['device_ms']:.4f} ms, bound "
              f"{qp['bound_ms']:.4f} ms, lost {qp['device_ms'] - qp['bound_ms']:.4f} ms a step "
              f"and rank; rows a call (power-of-two floor: calls) {qp['rows']}", flush=True)
    for r in ranks:
        print(f"[zero] rank {r['rank']} launches over {ZERO_STEPS} steps {r['launches']}; "
              f"quantizer launches a step {r['quant_per_step']}; wire a step "
              f"{json.dumps(r['wire'][-1])}", flush=True)
        want = {"flash_fwd": 2 * r["layers"] * ZERO_STEPS, "flash_dq": r["layers"] * ZERO_STEPS,
                "flash_dkv": r["layers"] * ZERO_STEPS, "fused_adam": r["buckets"] * ZERO_STEPS}
        got = {k: r["launches"][k] for k in want}
        if got != want:
            fail(f"[zero] rank {r['rank']} training launches {got} != {want}")
        if r["launches"]["quant_rows"] == 0:
            fail(f"[zero] rank {r['rank']}: the int8 path did not run")
    path = r0["path"]
    rel = [abs(a - b) / abs(b) for a, b in zip(path["kernels"], path["plain"])]
    print(f"[zero] {PATH_LAYERS} layers, same width, {PATH_STEPS} steps: kernels "
          f"{path['kernels']} plain {path['plain']} (relative difference {max(rel):.3e}, "
          f"limit {PATH_RTOL}); full width {path['full-width']} (int8 within rtol "
          f"{ZERO_ZEROPP_TOL} atol {ZERO_ZEROPP_TOL} of it)", flush=True)
    if max(rel) > PATH_RTOL:
        fail(f"[zero] kernel and plain paths differ by {max(rel):.3e}")
    if not np.allclose(path["kernels"], path["full-width"], rtol=ZERO_ZEROPP_TOL,
                       atol=ZERO_ZEROPP_TOL):
        fail(f"[zero] int8 wire losses {path['kernels']} beyond the ZeRO++ tolerance of the "
             f"full-width {path['full-width']}")
    zero_overlap_report(np, ranks, smi)
    zero_ef_report(np, ranks, smi)
    onebit_report(np, ranks, smi)
    return sum(r["launches"]["quant_rows"] for r in ranks)


def zero_overlap_report(np, ranks, smi):
    """[zero-overlap]: checks and prints what the ranks measured on the
    overlap schedule, beside the barrier run of the same ranks."""
    ov = [r["overlap"] for r in ranks]
    o0, r0 = ov[0], ranks[0]
    losses = o0["losses"]
    print(f"[zero-overlap] {smi} | config {json.dumps(ZERO_OVERLAP_CONFIG['zero_optimization'])}"
          f" (overlap_comm unset: true at stage 3); plan {o0['plan']}; "
          f"{'; '.join(o0['plans'])}", flush=True)
    if any(o["losses"] != losses for o in ov):
        fail(f"[zero-overlap] losses differ between ranks: {[o['losses'] for o in ov]}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"[zero-overlap] losses {losses} not finite and falling")
    barrier = r0["losses"][:len(losses)]
    if not np.allclose(losses, barrier, rtol=ZERO_ZEROPP_TOL, atol=ZERO_ZEROPP_TOL):
        fail(f"[zero-overlap] losses {losses} beyond the ZeRO++ tolerance of the barrier "
             f"run's {barrier}")
    for r, o in zip(ranks, ov):
        for i, got in enumerate(o["classes"]):
            if got != o["expected"]:
                fail(f"[zero-overlap] rank {r['rank']} step {i}: launches by (op, width, "
                     f"class) {sorted(got.items())} != the schedule's "
                     f"{sorted(o['expected'].items())}")
        n_int8 = sum(k for (op, w, _), k in o["classes"][-1].items() if w == "int8")
        if any(q != n_int8 for q in o["quant_per_step"]):
            fail(f"[zero-overlap] rank {r['rank']}: quantizer launches "
                 f"{o['quant_per_step']} a step against {n_int8} int8 collectives")
        want = {"flash_fwd": r["layers"] * ZERO_OVERLAP_STEPS,
                "flash_dq": r["layers"] * ZERO_OVERLAP_STEPS,
                "flash_dkv": r["layers"] * ZERO_OVERLAP_STEPS,
                "fused_adam": r["buckets"] * ZERO_OVERLAP_STEPS}
        want["flash_fwd"] *= 2     # the forward, and the recompute of each step
        got = {k: o["launches"][k] for k in want}
        if got != want:
            fail(f"[zero-overlap] rank {r['rank']} training launches {got} != {want}")
    step = sum(o0["step_s"]) / len(o0["step_s"])
    bstep = sum(r0["step_s"]) / len(r0["step_s"])
    print(f"[zero-overlap] tinyllama-1.1b layers {r0['layers']}: losses "
          f"{[round(x, 4) for x in losses]} (equal on both ranks; barrier "
          f"{[round(x, 4) for x in barrier]}, within rtol = atol {ZERO_ZEROPP_TOL}); step ms "
          f"{[round(x * 1e3, 1) for x in o0['step_s']]} mean {step * 1e3:.1f} beside the "
          f"barrier's {bstep * 1e3:.1f}; max_memory_allocated per rank "
          f"{[round(o['peak'] / 2**30, 2) for o in ov]} GiB beside the barrier's "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks]}", flush=True)
    for r, o in zip(ranks, ov):
        sp = o["split"][-1]
        print(f"[zero-overlap] rank {r['rank']} a step: wire bytes overlapped "
              f"{sp['overlapped_bytes']} exposed {sp['exposed_bytes']}; launches by (op, width, "
              f"class) {json.dumps({'/'.join(k): v for k, v in sorted(o['classes'][-1].items())})}"
              f" (the schedule's count); quantizer launches a step {o['quant_per_step']}; host "
              f"blocked in wait() {o['wait_s'] * 1e3:.1f} ms a step (no synchronization added); "
              f"training launches {o['launches']}", flush=True)
        print(f"[zero-overlap] rank {r['rank']} one more step of {o['comm_step_s'] * 1e3:.1f} ms, "
              f"{o['comm_launches']} collectives each synchronized at launch and at wait(): "
              f"{o['comm_s'] * 1e3:.1f} ms, share {o['comm_s'] / o['comm_step_s']:.3f} (an upper "
              f"bound on this schedule: the synchronizations take away the overlap)", flush=True)
    s3 = o0["s3"]
    print(f"[zero-overlap] {PATH_LAYERS} layers, same width, plain stage 3 at full width "
          f"(comm_transport off), {PATH_STEPS} steps: overlap {s3['losses']['overlap']} barrier "
          f"{s3['losses']['barrier']} again {s3['losses']['barrier-again']}; bitwise "
          f"{[o['s3']['bitwise'] for o in ov]}; largest difference overlap vs barrier "
          f"{[o['s3']['gap'] for o in ov]} beside the two barrier runs' "
          f"{[o['s3']['witness'] for o in ov]} (losses and every param)", flush=True)
    for o in ov:
        if not (o["s3"]["bitwise"] or o["s3"]["gap"] <= o["s3"]["witness"]):
            fail(f"[zero-overlap] the schedule moved plain stage 3 by {o['s3']['gap']} beyond "
                 f"the barrier's run-to-run {o['s3']['witness']}")
    print(f"[zero-overlap] {PATH_LAYERS} layers, ZeRO++ on the schedule: the first block "
          f"reduce-scatter (widths {o0['bound_widths']}) within the int8 bound: worst err / bound "
          f"per rank {[round(o['bound'][0], 4) for o in ov]}, elements rounded "
          f"{[o['bound'][1] for o in ov]}", flush=True)
    if any(o["bound"][0] > 1 or o["bound"][1] == 0 for o in ov):
        fail(f"[zero-overlap] the int8 reduce-scatter left its bound or rounded nothing: "
             f"{[o['bound'] for o in ov]}")
    print(f"[zero-overlap] phase {max(o['s'] for o in ov):.1f} s (in the ranks)", flush=True)


def zero_ef_report(np, ranks, smi):
    """[zero-ef]: checks and prints what the ranks measured with error
    feedback on the overlap schedule, beside [zero-overlap]."""
    ef = [r["ef"] for r in ranks]
    e0 = ef[0]
    losses, ov = e0["losses"], ranks[0]["overlap"]
    print(f"[zero-ef] {smi} | config {json.dumps(ZERO_EF_CONFIG['zero_optimization'])} + "
          f"comm_transport {json.dumps(ZERO_EF_CONFIG['comm_transport'])}; {e0['slots']} residual "
          f"slots of {e0['slot_bytes']} bytes a rank", flush=True)
    if any(e["losses"] != losses for e in ef):
        fail(f"[zero-ef] losses differ between ranks: {[e['losses'] for e in ef]}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"[zero-ef] losses {losses} not finite and falling")
    if not np.allclose(losses, ov["losses"], rtol=ZERO_ZEROPP_TOL, atol=ZERO_ZEROPP_TOL):
        fail(f"[zero-ef] losses {losses} beyond the ZeRO++ tolerance of [zero-overlap]'s "
             f"{ov['losses']}")
    for r, e in zip(ranks, ef):
        if not e["residual"] > 0:
            fail(f"[zero-ef] rank {r['rank']}: the residual slots are all zero")
        if e["quant_per_step"] != r["overlap"]["quant_per_step"]:
            fail(f"[zero-ef] rank {r['rank']}: quantizer launches a step {e['quant_per_step']} "
                 f"against [zero-overlap]'s {r['overlap']['quant_per_step']}")
        want = {"flash_fwd": 2 * r["layers"] * ZERO_OVERLAP_STEPS,
                "flash_dq": r["layers"] * ZERO_OVERLAP_STEPS,
                "flash_dkv": r["layers"] * ZERO_OVERLAP_STEPS,
                "fused_adam": r["buckets"] * ZERO_OVERLAP_STEPS}
        got = {k: e["launches"][k] for k in want}
        if got != want or e["launches"]["quant_rows"] == 0:
            fail(f"[zero-ef] rank {r['rank']} launches {e['launches']} against {want} and "
                 f"some quant_rows")
    step = sum(e0["step_s"]) / len(e0["step_s"])
    ostep = sum(ov["step_s"]) / len(ov["step_s"])
    print(f"[zero-ef] tinyllama-1.1b layers {ranks[0]['layers']}: losses "
          f"{[round(x, 4) for x in losses]} (equal on both ranks; [zero-overlap] "
          f"{[round(x, 4) for x in ov['losses']]}, within rtol = atol {ZERO_ZEROPP_TOL}); step ms "
          f"{[round(x * 1e3, 1) for x in e0['step_s']]} mean {step * 1e3:.1f} beside "
          f"[zero-overlap]'s {ostep * 1e3:.1f}; max_memory_allocated per rank "
          f"{[round(e['peak'] / 2**30, 2) for e in ef]} GiB beside [zero-overlap]'s "
          f"{[round(r['overlap']['peak'] / 2**30, 2) for r in ranks]}; quantizer launches a step "
          f"{e0['quant_per_step']} ([zero-overlap] {ov['quant_per_step']}); launches over "
          f"{ZERO_OVERLAP_STEPS} steps {e0['launches']}; residual magnitude per rank "
          f"{[round(e['residual'], 3) for e in ef]}; wire a step {json.dumps(e0['wire'])}",
          flush=True)
    for r, e in zip(ranks, ef):
        t = e["tele"]
        print(f"[zero-ef] rank {r['rank']} {PATH_LAYERS} layers, {EF_MICROS} accumulated micro "
              f"steps of distinct batches, plain stage 3 on the schedule: largest gradient error "
              f"against the full-width wire: error feedback {t['ef']:.4e}, plain int8 "
              f"{t['plain']:.4e} (ratio {t['plain'] / max(t['ef'], 1e-30):.2f}, need "
              f">= {EF_GAIN}); gradient scale {t['scale']:.4e} (error feedback within "
              f"{EF_SCALE} x: {t['ef'] <= EF_SCALE * t['scale']}); carry {e['tele_carry']}",
              flush=True)
        if not (t["ef"] < t["plain"] / EF_GAIN and t["ef"] <= EF_SCALE * t["scale"]):
            fail(f"[zero-ef] rank {r['rank']}: error feedback does not telescope: {t}")
        if not (e["tele_carry"][0] and e["tele_carry"][1] > 0):
            fail(f"[zero-ef] rank {r['rank']}: no live carry in the telescoping run")
    path = e0["path"]
    rel = [abs(a - b) / abs(b) for a, b in zip(path["kernels"], path["plain"])]
    print(f"[zero-ef] {PATH_LAYERS} layers, same width, {PATH_STEPS} steps: kernels "
          f"{path['kernels']} plain {path['plain']} (relative difference {max(rel):.3e}, limit "
          f"{PATH_RTOL})", flush=True)
    if max(rel) > PATH_RTOL or any(e["path"] != path for e in ef):
        fail(f"[zero-ef] kernel and plain paths differ by {max(rel):.3e}, or the ranks do")
    print(f"[zero-ef] phase {max(e['s'] for e in ef):.1f} s (in the ranks)", flush=True)


def onebit_report(np, ranks, smi):
    """[onebit]: checks and prints what the ranks measured with the 1-bit
    optimizers."""
    for name, params in ONEBIT_RUNS:
        runs = [r["onebit"][name] for r in ranks]
        o = runs[0]
        losses = o["losses"]
        warm = params.get("freeze_step", 0)
        print(f"[onebit] {smi} | {name} {json.dumps(params)} lr {ONEBIT_LR}, tinyllama-1.1b "
              f"layers {o['layers']}: losses {[round(x, 4) for x in losses]}; step ms "
              f"{[round(x * 1e3, 1) for x in o['step_s']]}; wire bytes a step and rank "
              f"{o['wire']} (the full-width all-reduce {o['full_bytes']}, compressed "
              f"{o['compressed_bytes']}: {o['compressed_bytes'] / o['full_bytes']:.4f} of it); "
              f"optimizer state a rank {o['state_bytes'] / 2**30:.2f} GiB; "
              f"max_memory_allocated per rank {[round(x['peak'] / 2**30, 2) for x in runs]} GiB; "
              f"launches {o['launches']}; {o['s']:.1f} s", flush=True)
        if any(x["losses"] != losses for x in runs):
            fail(f"[onebit] {name}: losses differ between ranks: {[x['losses'] for x in runs]}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"[onebit] {name}: losses {losses} not finite and falling")
        # every step here synchronizes, so the ranks hold the same params
        if any(x["digests"] != o["digests"] for x in runs):
            fail(f"[onebit] {name}: the ranks' params differ")
        want = [o["full_bytes"]] * warm + [o["compressed_bytes"]] * (ONEBIT_STEPS - warm)
        for r, x in zip(ranks, runs):
            if x["wire"] != want:
                fail(f"[onebit] {name} rank {r['rank']}: wire bytes {x['wire']} != {want}")
            L = x["layers"]
            lw = {"flash_fwd": 2 * L * ONEBIT_STEPS, "flash_dq": L * ONEBIT_STEPS,
                  "flash_dkv": L * ONEBIT_STEPS, "fused_adam": 0, "quant_rows": 0}
            if {k: x["launches"][k] for k in lw} != lw:
                fail(f"[onebit] {name} rank {r['rank']}: launches {x['launches']} != {lw}")
        for r, x in zip(ranks, runs):
            c = x["check"]
            print(f"[onebit] {name} rank {r['rank']}: the last step's update against the plain "
                  f"fp32 transcription of the JAX formulas on {c['leaves']} leaves: " + "; ".join(
                      f"{slot} max_abs_err {v['max_abs_err']:.3e}, {v['off']} of {v['numel']} "
                      f"off {ONEBIT_TOL}" for slot, v in c["slots"].items()), flush=True)
            bad = [slot for slot, v in c["slots"].items() if v["bad"]]
            if not c["leaves"] or bad:
                fail(f"[onebit] {name} rank {r['rank']}: the compressed update is off its "
                     f"reference in {bad} (or no leaf was checked)")
        if o["compressed_bytes"] / o["full_bytes"] > 0.4:
            fail(f"[onebit] {name}: the compressed wire is {o['compressed_bytes']} bytes against "
                 f"{o['full_bytes']} at full width")


# ---------------------------------------------------------------------------
# [families]: the decoder families beside Llama
# ---------------------------------------------------------------------------


def family_model(torch, preset, num_layers=None, dtype=None):
    """``<family>_model(preset)`` of the port in ``dtype`` (bf16), on the meta
    device; at ``num_layers`` a per-layer window pattern keeps its first
    ``num_layers`` entries."""
    from deepspeed_tpu_torch import models
    fam = FAMILY_MODELS[preset]
    kw = {"dtype": dtype or torch.bfloat16}
    if num_layers is not None:
        kw["num_layers"] = num_layers
        windows = getattr(models, f"{fam}_config")(preset).attn_windows
        if isinstance(windows, tuple):
            kw["attn_windows"] = windows[:num_layers]
    return getattr(models, f"{fam}_model")(preset, **kw)


class flash_head_dims:
    """Counts the flash launches of a run by head_dim: the wrappers' CUDA
    launchers wrapped, and restored afterwards."""

    def __init__(self, flash):
        import collections
        self.flash, self.dims = flash, collections.Counter()

    def __enter__(self):
        f = self.flash
        self.saved = fwd, bwd = f._fwd_cuda, f._bwd_cuda

        def fwd_dims(q, k, v, spec):
            self.dims[("flash_fwd", q.shape[-1])] += 1
            return fwd(q, k, v, spec)

        def bwd_dims(q, k, v, o, lse, do, dlse, spec):
            self.dims[("flash_dq+dkv", q.shape[-1])] += 1
            return bwd(q, k, v, o, lse, do, dlse, spec)
        f._fwd_cuda, f._bwd_cuda = fwd_dims, bwd_dims
        return self

    def __exit__(self, *exc):
        self.flash._fwd_cuda, self.flash._bwd_cuda = self.saved


def first_loss(c):
    """The expected first loss of a seeded model: logits of N(0, 0.02^2 *
    hidden) a vocabulary entry (normal(0, 0.02) head over a normed hidden
    state) give ln V + 0.02^2 * hidden / 2."""
    import math
    return math.log(c.vocab_size) + 0.02 ** 2 * c.hidden_size / 2


def train_full_depth(torch, np, flash, adam, lion, tag, model, config, steps, features,
                     after=None):
    """``model`` at full width and depth through ``initialize`` +
    ``train_batch``: S 2048, bf16 with fp32 master and moments, AdamW,
    clipping 1.0, remat per block (``config``); 2 warm-up and ``steps``
    timed steps, then a profiled one. Fails unless the losses are finite,
    the first near its expected value and falling, and each step launched
    2 x L flash forwards, L dQ and L dK/dV, all at the model's head_dim, and
    one Adam launch a bucket. ``after(engine, batch, step_s)``, if given,
    runs on the trained engine last. Prints under ``[tag]``."""
    import deepspeed_tpu_torch
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, seed=0)
    torch.cuda.synchronize()
    c = engine.model.config
    buckets = len(engine.opt_state["buckets"])
    n_all = sum(p.numel() for p in engine.params.values())
    B = config["train_micro_batch_size_per_gpu"]
    print(f"[{tag}] layers {c.num_layers} hidden {c.hidden_size} heads {c.num_heads}/"
          f"{c.kv_heads} head_dim {c.head_dim} ffn {c.ffn_size} vocab {c.vocab_size} "
          f"{features}: {n_all} params bf16, adamw, fp32 master and moments in {buckets} "
          f"buckets, micro {B} x S {TRAIN_SEQ}, built in {time.perf_counter() - t0:.2f} s; "
          f"state {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, c.vocab_size, size=(B, TRAIN_SEQ))}
    tokens = B * TRAIN_SEQ
    losses = [float(engine.train_batch(batch)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash, adam, lion)
    times = []
    with flash_head_dims(flash) as dims:
        for _ in range(steps):
            t = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            times.append(time.perf_counter() - t)
    launches = dict(flash.launches, fused_adam=adam.launches, fused_lion=lion.launches)
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times) / len(times)
    flops, n = training_flops(c, n_all, tokens)
    print(f"[{tag}] losses {[round(x, 4) for x in losses]} (expected first "
          f"{first_loss(c):.4f}: ln {c.vocab_size} + 0.02^2 x {c.hidden_size} / 2); step ms "
          f"{[round(x * 1e3, 1) for x in times]} mean {step_s * 1e3:.1f}; tokens/s "
          f"{tokens / step_s:.0f}; MFU {flops / step_s / PEAK_FLOPS['torch.bfloat16']:.4f} "
          f"({flops:.4e} flops a step: 6 x {n} non-embedding params x {tokens} tokens + "
          f"causal attention, at 989 TFLOP/s); max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"launches over {steps} steps {launches}; flash calls by head_dim "
          f"{dict(dims.dims)}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"{tag} training losses {losses}")
    if abs(losses[0] - first_loss(c)) > 0.5:
        fail(f"{tag} first loss {losses[0]:.4f} not within 0.5 of {first_loss(c):.4f}")
    if not losses[-1] < losses[0]:
        fail(f"{tag} loss did not fall on the repeated batch: {losses}")
    L = c.num_layers
    want = {"flash_fwd": 2 * L * steps, "flash_dq": L * steps,
            "flash_dkv": L * steps, "fused_adam": buckets * steps, "fused_lion": 0}
    if launches != want:
        fail(f"{tag} training launches {launches} != {want}")
    want_dims = {("flash_fwd", c.head_dim): 2 * L * steps,
                 ("flash_dq+dkv", c.head_dim): L * steps}
    if dict(dims.dims) != want_dims:
        fail(f"{tag} flash calls by head_dim {dict(dims.dims)} != {want_dims}")
    profile_step(torch, engine, batch, step_s, f"{tag}-profile")
    if after is not None:
        after(engine, batch, step_s)
    del engine
    torch.cuda.empty_cache()
    return launches


def train_phi2(torch, np, flash, adam, lion):
    """Phi-2 (head_dim 80, a parallel block, partial rotary, a biased untied
    head) through ``train_full_depth``: micro 8, 5 timed steps."""
    return train_full_depth(torch, np, flash, adam, lion, "families",
                            family_model(torch, "phi-2"), PHI2_CONFIG, TRAIN_STEPS,
                            "(phi-2: rope_dim 32, parallel block, biased untied head)")


def train_open_llama(torch, np, flash, adam, lion):
    """``[open-llama]``: open-llama-3b (head_dim 100, which the flash
    kernels read in place as packed heads) through ``train_full_depth``:
    micro ``OPEN_LLAMA_MICRO``, 3 timed steps, 52 flash forwards, 26 dQ and
    26 dK/dV a step at head_dim 100; then ``packed_vs_padded`` on the
    trained engine."""
    from deepspeed_tpu_torch.models import llama_model
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=OPEN_LLAMA_MICRO)
    return train_full_depth(torch, np, flash, adam, lion, "open-llama",
                            llama_model("open-llama-3b"), config, OPEN_LLAMA_STEPS,
                            "(open-llama-3b, MHA)",
                            after=lambda e, b, s: packed_vs_padded(torch, flash, e, b))


def packed_vs_padded(torch, flash, engine, batch):
    """The end-to-end A/B of the two forms of a head_dim that is no multiple
    of 8 (open-llama-3b's 100), in one engine: training steps with the
    wrappers' packed heads, read in place (A), and with every flash call's
    inputs zero-padded to the next multiple of 8 and its outputs cut back
    (B: ``flash._pad8``, the form odd head dims take), in turns A B B A for
    ``HEAD_DIM_AB_ROUNDS`` rounds after a warm-up step of B. Prints each
    form's step times, their means and the spread."""
    packed = flash._kernel_inputs
    forms = {"packed": packed,
             "padded": lambda *xs: tuple(flash._rows(x) for x in flash._pad8(*xs))}
    times = {"packed": [], "padded": []}
    losses = []

    def step(form, keep=True):
        flash._kernel_inputs = forms[form]
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        if keep:
            times[form].append(time.perf_counter() - t)
    try:
        step("padded", keep=False)
        for _ in range(HEAD_DIM_AB_ROUNDS):
            for form in ("packed", "padded", "padded", "packed"):
                step(form)
    finally:
        flash._kernel_inputs = packed
    mean = {f: sum(t) / len(t) for f, t in times.items()}
    print(f"[open-llama] packed heads (A) against zero-padded copies (B), steps A B B A x "
          f"{HEAD_DIM_AB_ROUNDS} after a warm-up step of B: A ms "
          f"{[round(x * 1e3, 1) for x in times['packed']]} mean {mean['packed'] * 1e3:.1f} "
          f"(spread {(max(times['packed']) - min(times['packed'])) * 1e3:.1f}); B ms "
          f"{[round(x * 1e3, 1) for x in times['padded']]} mean {mean['padded'] * 1e3:.1f} "
          f"(spread {(max(times['padded']) - min(times['padded'])) * 1e3:.1f}); B / A "
          f"{mean['padded'] / mean['packed']:.4f}; losses {[round(x, 4) for x in losses]}",
          flush=True)
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"open-llama A/B losses {losses}")


def serve_open_llama(torch, np):
    """``[open-llama]`` serving: open-llama-3b at full width and depth,
    random bf16 weights from a seed, through ``build_engine`` + ``generate``
    with the requests of phase 5, cold and warm: every request gets its
    tokens and both paged kernels run once a layer in every wave and decode
    step (the waves in the CUDA-core form: head_dim 100); then one prompt's
    prefill logits against the plain forward."""
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig, build_engine)
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.models import llama_model
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=2049, state_manager=DeepSpeedTPStateManagerConfig(max_context=2048))
    t0 = time.perf_counter()
    model = llama_model("open-llama-3b")
    engine = build_engine(model, cfg, seed=0)
    torch.cuda.synchronize()
    c = model.config
    print(f"[open-llama] serving: layers {c.num_layers} hidden {c.hidden_size} heads "
          f"{c.num_heads}/{c.kv_heads} head_dim {c.head_dim} bf16 on {engine.device}, "
          f"{cfg.num_kv_blocks} KV blocks x {cfg.kv_block_size} "
          f"({engine.kv_cache.mem_bytes() / 2**30:.2f} GiB, "
          f"{engine.kv_cache.mem_bytes() / (cfg.num_kv_blocks * cfg.kv_block_size):.0f} bytes "
          f"a token), weights "
          f"{sum(p.numel() * p.element_size() for p in engine.model.parameters()) / 2**30:.2f} "
          f"GiB, built in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts, *_ = timed_generate(torch, np, engine,
                                 {"ragged_paged_attention": rpa, "paged_decode": pdk},
                                 num_layers=c.num_layers, form="cuda_cores",
                                 label="open-llama")
    prefill_logits_check(torch, engine, lambda: llama_model("open-llama-3b",
                                                            dtype=torch.float32),
                         prompts[2], "open-llama-3b", phase="open-llama")
    del engine, model
    torch.cuda.empty_cache()


def families_tiny(torch, np, flash, adam, lion):
    """Each tiny decoder preset (head_dim 16) on the card: ``PATH_STEPS``
    training steps through the kernels (2 x L flash forwards, L dQ and L
    dK/dV a step at head_dim 16) and as many through their plain versions
    from the same weights, losses within ``PATH_RTOL`` at every step (the
    gradients of a step reach the next one's loss); then one request through ``build_engine`` +
    ``generate``, through both paged kernels (BLOOM's ALiBi and GPT-Neo's
    window of 8 among them)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import models
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig, build_engine, generate)
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    rng = np.random.default_rng(0)
    for preset, fam in TINY_FAMILIES.items():
        make = lambda: getattr(models, f"{fam}_model")(preset, dtype=torch.bfloat16)
        c = make().config
        L, S = c.num_layers, c.max_seq_len
        batch = {"input_ids": rng.integers(0, c.vocab_size, size=(1, S))}
        loss = {}
        for name in ("kernels", "plain"):
            eng, *_ = deepspeed_tpu_torch.initialize(model=make(), config=FAMILY_PATH_CONFIG,
                                                     seed=0)
            zero_counts(flash, adam, lion)
            if name == "plain":
                with plain_kernels(flash, adam, lion):
                    loss[name] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
                if any(flash.launches.values()) or adam.launches or lion.launches:
                    fail(f"{preset}: the plain path launched kernels: {flash.launches}")
            else:
                with flash_head_dims(flash) as dims:
                    loss[name] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
                n = PATH_STEPS
                want = {("flash_fwd", c.head_dim): 2 * L * n,
                        ("flash_dq+dkv", c.head_dim): L * n}
                counts = {"flash_fwd": 2 * L * n, "flash_dq": L * n, "flash_dkv": L * n}
                if dict(dims.dims) != want or flash.launches != counts:
                    fail(f"{preset}: flash calls {dict(dims.dims)}, launches "
                         f"{flash.launches} != {want}, {counts}")
            del eng
        rel = max(abs(a - b) / abs(b) for a, b in zip(loss["kernels"], loss["plain"]))
        if not all(np.isfinite(loss["kernels"])):
            fail(f"{preset}: training losses {loss['kernels']}")
        cfg = RaggedInferenceEngineConfig(
            num_kv_blocks=33, state_manager=DeepSpeedTPStateManagerConfig(max_context=S))
        engine = build_engine(make(), cfg, seed=0)
        rpa.launches = pdk.launches = 0
        reqs = generate(engine, [rng.integers(0, c.vocab_size, size=TINY_PROMPT)],
                        max_new_tokens=TINY_NEW_TOKENS, return_requests=True)
        torch.cuda.synchronize()
        n_tok = len(reqs[0].generated)
        served = (f"one request of {TINY_PROMPT} prompt tokens: {n_tok} tokens, ragged "
                  f"launches {rpa.launches}, decode launches {pdk.launches}")
        if n_tok != TINY_NEW_TOKENS or rpa.launches < L or pdk.launches < L:
            fail(f"{preset}: {served}")
        del engine
        print(f"[families] {preset} head_dim {c.head_dim}, S {S}, {PATH_STEPS} steps: "
              f"kernels {[round(x, 5) for x in loss['kernels']]}, plain versions "
              f"{[round(x, 5) for x in loss['plain']]}, relative difference {rel:.3e} "
              f"(limit {PATH_RTOL}); {served}", flush=True)
        if rel > PATH_RTOL:
            fail(f"{preset}: kernel and plain training paths differ by {rel:.3e}")
    torch.cuda.empty_cache()


def prefill_logits_check(torch, engine, make_ref32, prompt, tag, phase="families"):
    """One prompt's prefill logits through the serving engine and through
    the plain bf16 ``TransformerLM.forward``, each against the plain fp32
    forward of the same weights (``make_ref32()``: the model in fp32 on the
    meta device); fails unless the serving path's relative L2 error is at
    most ``LOGIT_ERR_RATIO`` times the plain bf16 path's. Prints under
    ``[phase]``."""
    got = torch.from_numpy(engine.put([10_000], [prompt])[0])
    engine.flush(10_000)
    ids = torch.as_tensor(prompt, device="cuda")[None]
    plain = engine.model(ids)[0, -1].cpu()
    ref32 = make_ref32()
    ref32.to_empty(device="cuda").load_state_dict(engine.model.state_dict())
    want = ref32(ids)[0, -1].cpu()
    del ref32
    torch.cuda.empty_cache()
    rel = lambda a: ((a - want).norm() / want.norm()).item()
    print(f"[{phase}] {tag}: prefill logits ({len(prompt)} tokens) vs the fp32 plain "
          f"forward: serving bf16 relative L2 {rel(got):.3e}, plain bf16 forward "
          f"{rel(plain):.3e} (limit {LOGIT_ERR_RATIO} x); argmax serving "
          f"{int(got.argmax())} plain-bf16 {int(plain.argmax())} fp32 {int(want.argmax())}",
          flush=True)
    if not bool(got.isfinite().all()) or rel(got) > LOGIT_ERR_RATIO * rel(plain):
        fail(f"{tag}: serving logits relative L2 error {rel(got):.3e} > "
             f"{LOGIT_ERR_RATIO} x the plain bf16 forward's {rel(plain):.3e}")


def serve_family(torch, np, preset):
    """``preset`` at full width and depth, random bf16 weights from a seed,
    through ``build_engine`` + ``generate`` with the requests of phase 5,
    cold and warm: every request gets its tokens and both paged kernels run
    once a layer in every wave and decode step, the waves in the form
    ``FAMILY_SERVED`` names (Falcon-7B's 71 query heads a kv head pass the
    tensor-core tile: CUDA cores; BLOOM-7b1's ALiBi and GPT-Neo-2.7b's
    windows on the tensor cores); then one prompt's prefill logits against
    the plain forward, and a profile of a warm ``generate``."""
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig, build_engine, generate)
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    cfg = RaggedInferenceEngineConfig(
        num_kv_blocks=2049, state_manager=DeepSpeedTPStateManagerConfig(max_context=2048))
    t0 = time.perf_counter()
    model = family_model(torch, preset)
    engine = build_engine(model, cfg, seed=0)
    torch.cuda.synchronize()
    c = model.config
    feats = f" position {c.position}" + (" windows" if c.attn_windows else "")
    print(f"[families] {preset} layers {c.num_layers} hidden {c.hidden_size} heads "
          f"{c.num_heads}/{c.kv_heads} ffn {c.ffn_size} vocab {c.vocab_size}{feats} bf16 on "
          f"{engine.device}, {cfg.num_kv_blocks} KV blocks x {cfg.kv_block_size} "
          f"({engine.kv_cache.mem_bytes() / 2**30:.2f} GiB), weights "
          f"{sum(p.numel() * p.element_size() for p in engine.model.parameters()) / 2**30:.2f} "
          f"GiB, built in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts, wall, *_ = timed_generate(torch, np, engine,
                                       {"ragged_paged_attention": rpa, "paged_decode": pdk},
                                       num_layers=c.num_layers, form=FAMILY_SERVED[preset],
                                       label=f"families {preset}")
    prefill_logits_check(torch, engine,
                         lambda: family_model(torch, preset, dtype=torch.float32),
                         prompts[2], preset)
    profile_generate(torch, generate, engine, prompts, wall)
    del engine, model
    torch.cuda.empty_cache()


def families_two_layers(torch, np, flash, adam, lion):
    """Each family at its preset's full width and 2 layers: 3 steps through
    the kernels and 3 through their plain versions from the same weights
    (micro 1, S 2048 or the preset's context), losses within ``PATH_RTOL``;
    then a prompt's logits (300 tokens: two prefill chunks, past GPT-Neo's
    window) through the serving engine against the fp32 plain forward."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import (
        DeepSpeedTPStateManagerConfig, RaggedInferenceEngineConfig, build_engine)
    rng = np.random.default_rng(0)
    for preset in FAMILY_MODELS:
        c = family_model(torch, preset, PATH_LAYERS).config
        S = min(TRAIN_SEQ, c.max_seq_len)
        batch = {"input_ids": rng.integers(0, c.vocab_size, size=(1, S))}
        path, t0 = {}, time.perf_counter()
        for name in ("kernels", "plain"):
            eng, *_ = deepspeed_tpu_torch.initialize(
                model=family_model(torch, preset, PATH_LAYERS), config=FAMILY_PATH_CONFIG,
                seed=0)
            zero_counts(flash, adam, lion)
            if name == "plain":
                with plain_kernels(flash, adam, lion):
                    path[name] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
                if any(flash.launches.values()) or adam.launches or lion.launches:
                    fail(f"{preset}: the plain path launched kernels: {flash.launches}")
            else:
                path[name] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
                want = {"flash_fwd": 2 * PATH_LAYERS * PATH_STEPS,
                        "flash_dq": PATH_LAYERS * PATH_STEPS,
                        "flash_dkv": PATH_LAYERS * PATH_STEPS}
                if flash.launches != want:
                    fail(f"{preset}: flash launches {flash.launches} != {want}")
            del eng
            torch.cuda.empty_cache()
        rel = [abs(a - b) / abs(b) for a, b in zip(path["kernels"], path["plain"])]
        feats = [f for f in ("parallel_block", "parallel_norms", "embedding_norm")
                 if getattr(c, f)] + [f"position {c.position}"] + (
            ["windows"] if c.attn_windows else []) + (
            [f"scale {c.attn_scale}"] if c.attn_scale else [])
        print(f"[families] {preset} {PATH_LAYERS} layers, hidden {c.hidden_size} heads "
              f"{c.num_heads}/{c.kv_heads} head_dim {c.head_dim} vocab {c.vocab_size} "
              f"({', '.join(feats)}), S {S}, {PATH_STEPS} steps: kernels "
              f"{[round(x, 5) for x in path['kernels']]} plain "
              f"{[round(x, 5) for x in path['plain']]}, relative difference {max(rel):.3e} "
              f"(limit {PATH_RTOL}, bf16); {time.perf_counter() - t0:.1f} s", flush=True)
        if max(rel) > PATH_RTOL:
            fail(f"{preset}: kernel and plain training paths differ by {max(rel):.3e}")
        cfg = RaggedInferenceEngineConfig(
            num_kv_blocks=257, state_manager=DeepSpeedTPStateManagerConfig(max_context=S))
        engine = build_engine(family_model(torch, preset, PATH_LAYERS), cfg, seed=0)
        prompt = rng.integers(0, c.vocab_size, size=FAMILY_LOGIT_PROMPT)
        prefill_logits_check(
            torch, engine,
            lambda: family_model(torch, preset, PATH_LAYERS, dtype=torch.float32), prompt,
            f"{preset} {PATH_LAYERS} layers")
        del engine
        torch.cuda.empty_cache()


def mlm_batch(np, rng, B, S, vocab, pad=0, types=2):
    """A padded MLM batch: row lengths drawn in [S/4, S] (pads past them),
    token types in [0, types) on the real positions, labels on 15% of them
    (-100 elsewhere)."""
    ids = rng.integers(5, vocab, size=(B, S))
    lens = rng.integers(S // 4, S + 1, size=B)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return {"input_ids": np.where(mask == 1, ids, pad), "attention_mask": mask,
            "token_type_ids": rng.integers(0, types, size=(B, S)) * mask,
            "labels": np.where((rng.random((B, S)) < 0.15) & (mask == 1), ids, -100)}


def encoder_flops(c, n_params, B, S):
    """Training FLOPs of a step of an encoder: 6 x N x tokens, N the params
    without the position and token-type tables (lookups; the tied word
    embedding counts once, as the MLM decoder's product, 6 V H a token),
    plus bidirectional attention, S^2 pairs a head and layer (4 D a pair
    forward, three times that for forward and backward)."""
    n = n_params - (c.max_seq_len + c.position_offset + c.type_vocab_size) * c.hidden_size
    attn = 3 * 4 * c.head_dim * S * S * c.num_heads * B * c.num_layers
    return 6 * n * B * S + attn, n


def bert_engine(torch, model, config, seed=0):
    import deepspeed_tpu_torch
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, seed=seed)
    return engine


def train_bert_large(torch, np, flash, adam, lion):
    """bert-large MLM at full width and depth through ``initialize`` +
    ``train_batch`` (``BERT_CONFIG``: micro 32, S 512, remat full), on a
    padded batch: 2 warm-up and ``BERT_STEPS`` timed steps, then a profiled
    one. Fails unless the losses are finite and falling and each step ran
    2 x 24 flash forwards, 24 dQ and 24 dK/dV (non-causal, the mask as
    segment ids) and one Adam launch a bucket. Returns the step's seconds."""
    from deepspeed_tpu_torch.models import bert_model
    t0 = time.perf_counter()
    engine = bert_engine(torch, bert_model("bert-large"), BERT_CONFIG)
    torch.cuda.synchronize()
    c = engine.model.config
    buckets = len(engine.opt_state["buckets"])
    n_all = sum(p.numel() for p in engine.params.values())
    B, S = BERT_MICRO, BERT_SEQ
    batch = mlm_batch(np, np.random.default_rng(0), B, S, c.vocab_size)
    real, labelled = int(batch["attention_mask"].sum()), int((batch["labels"] >= 0).sum())
    print(f"[encoders] bert-large layers {c.num_layers} hidden {c.hidden_size} heads "
          f"{c.num_heads} head_dim {c.head_dim} ffn {c.ffn_size} vocab {c.vocab_size} "
          f"(post-norm, bidirectional, token types, MLM head): {n_all} params bf16, adamw, "
          f"fp32 master and moments in {buckets} buckets, remat {c.remat_policy}, micro {B} "
          f"x S {S} ({real} real tokens, {labelled} labelled), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    losses = [float(engine.train_batch(batch)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash, adam, lion)
    times = []
    for _ in range(BERT_STEPS):
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        times.append(time.perf_counter() - t)
    launches = dict(flash.launches, fused_adam=adam.launches)
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times) / len(times)
    flops, n = encoder_flops(c, n_all, B, S)
    print(f"[encoders] bert-large losses {[round(x, 4) for x in losses]}; step ms "
          f"{[round(x * 1e3, 1) for x in times]} mean {step_s * 1e3:.1f}; tokens/s "
          f"{B * S / step_s:.0f} ({real / step_s:.0f} real); MFU "
          f"{flops / step_s / PEAK_FLOPS['torch.bfloat16']:.4f} ({flops:.4e} flops a step: 6 x "
          f"{n} params without the position and type tables x {B * S} tokens + S^2 "
          f"bidirectional attention, at 989 TFLOP/s); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; launches over {BERT_STEPS} steps {launches}", flush=True)
    L = c.num_layers
    want = {"flash_fwd": 2 * L * BERT_STEPS, "flash_dq": L * BERT_STEPS,
            "flash_dkv": L * BERT_STEPS, "fused_adam": buckets * BERT_STEPS}
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bert-large training losses {losses}")
    if launches != want:
        fail(f"bert-large training launches {launches} != {want}")
    profile_step(torch, engine, batch, step_s, "encoders-profile")
    del engine
    torch.cuda.empty_cache()
    return step_s


def remat_policies(torch, np, flash, adam, lion):
    """Every remat policy at bert-large's full width and depth, micro 32,
    the same weights and padded batch: a warm-up and ``REMAT_STEPS`` timed
    steps each, step ms, peak memory and flash forwards a step (2 x 24
    where attention is recomputed, 24 where the flash op is kept: dots,
    everything, attention_only; 36 alternating); the losses of every step
    equal across policies (relative 1e-6; bitwise where the kernels give
    the same bits)."""
    from deepspeed_tpu_torch.models import bert_model
    batch = mlm_batch(np, np.random.default_rng(1), BERT_MICRO, BERT_SEQ, 30522)
    L = 24
    fwd_per_step = {"full": 2 * L, "nothing_saveable": 2 * L, "attention_only": L,
                    "dots_saveable": L, "checkpoint_dots": L,
                    "dots_with_no_batch_dims_saveable": 2 * L,
                    "checkpoint_dots_with_no_batch_dims": 2 * L,
                    "everything_saveable": L, "alternating": L + L // 2}
    ref = None
    for policy in REMAT_POLICIES:
        engine = bert_engine(torch, bert_model("bert-large", remat_policy=policy), BERT_CONFIG)
        losses = [float(engine.train_batch(batch))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(flash, adam, lion)
        times = []
        for _ in range(REMAT_STEPS):
            t = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        fwd = flash.launches["flash_fwd"] / REMAT_STEPS
        ref = losses if ref is None else ref
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        print(f"[encoders] remat {policy}: losses {[round(x, 6) for x in losses]} "
              f"(relative difference to full {rel:.3e}, {'bitwise' if losses == ref else 'not bitwise'}); "
              f"step ms {[round(x * 1e3, 1) for x in times]} mean "
              f"{sum(times) / len(times) * 1e3:.1f}; max_memory_allocated "
              f"{peak / 2**30:.2f} GiB; flash forwards a step {fwd:g} (dQ "
              f"{flash.launches['flash_dq'] / REMAT_STEPS:g})", flush=True)
        if rel > 1e-6 or fwd != fwd_per_step[policy]:
            fail(f"remat {policy}: losses {losses} against {ref}, flash forwards a step {fwd} "
                 f"(want {fwd_per_step[policy]})")
        del engine
        torch.cuda.empty_cache()


def encoders_two_layers(torch, np, flash, adam, lion):
    """bert-large at full width and 2 layers, micro 1 on a padded row: 3
    steps through the kernels and 3 through their plain versions from the
    same weights, losses within ``PATH_RTOL``."""
    from deepspeed_tpu_torch.models import bert_model
    batch = mlm_batch(np, np.random.default_rng(2), 1, BERT_SEQ, 30522)
    path = {}
    for name in ("kernels", "plain"):
        engine = bert_engine(torch, bert_model("bert-large", num_layers=PATH_LAYERS),
                             FAMILY_PATH_CONFIG)
        zero_counts(flash, adam, lion)
        if name == "plain":
            with plain_kernels(flash, adam, lion):
                path[name] = [float(engine.train_batch(batch)) for _ in range(PATH_STEPS)]
            if any(flash.launches.values()) or adam.launches:
                fail(f"bert-large: the plain path launched kernels: {flash.launches}")
        else:
            path[name] = [float(engine.train_batch(batch)) for _ in range(PATH_STEPS)]
            want = {"flash_fwd": 2 * PATH_LAYERS * PATH_STEPS,
                    "flash_dq": PATH_LAYERS * PATH_STEPS, "flash_dkv": PATH_LAYERS * PATH_STEPS}
            if flash.launches != want:
                fail(f"bert-large 2 layers: flash launches {flash.launches} != {want}")
        del engine
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(path["kernels"], path["plain"]))
    print(f"[encoders] bert-large {PATH_LAYERS} layers, micro 1, S {BERT_SEQ} "
          f"({int(batch['attention_mask'].sum())} real), {PATH_STEPS} steps: kernels "
          f"{[round(x, 5) for x in path['kernels']]} plain {[round(x, 5) for x in path['plain']]}, "
          f"relative difference {rel:.3e} (limit {PATH_RTOL}, bf16)", flush=True)
    if rel > PATH_RTOL:
        fail(f"bert-large: kernel and plain training paths differ by {rel:.3e}")


def train_task_heads(torch, np, flash, adam, lion):
    """The task heads through ``initialize`` + ``train_batch``
    (``TASK_CASES``: bert-base sequence classification and token
    classification at S 128, QA at S 384, roberta-base sequence
    classification with MuAdamW), padded batches, ``TASK_STEPS`` steps each:
    finite losses and 2 x 12 flash forwards a step (whether the loss fell
    in so few steps of bf16 weights is printed, not held: MLM above holds
    the falling loss)."""
    from deepspeed_tpu_torch import models
    rng = np.random.default_rng(3)
    for preset, body, task, style, S, B, opt in TASK_CASES:
        lm = getattr(models, f"{body}_model")(preset.replace("roberta", "bert"),
                                              mlm_head=False)
        model = models.EncoderTaskModel(lm, task, num_labels=3, head_style=style)
        c = lm.config
        config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=B,
                      optimizer={"type": opt, "params": {"lr": 5e-5, "weight_decay": 0.01}})
        t0 = time.perf_counter()
        engine = bert_engine(torch, model, config)
        batch = mlm_batch(np, rng, B, S, c.vocab_size, pad=c.pad_token_id or 0,
                          types=c.type_vocab_size)
        del batch["labels"]
        if task == "sequence_classification":
            batch["labels"] = rng.integers(0, 3, size=B)
        elif task == "token_classification":
            batch["labels"] = np.where(batch["attention_mask"] == 1,
                                       rng.integers(0, 3, size=(B, S)), -100)
        else:
            lens = batch["attention_mask"].sum(1)
            batch["start_positions"] = rng.integers(0, lens // 2)
            batch["end_positions"] = batch["start_positions"] + rng.integers(0, lens // 2)
        zero_counts(flash, adam, lion)
        losses = [float(engine.train_batch(batch)) for _ in range(TASK_STEPS)]
        torch.cuda.synchronize()
        print(f"[encoders] {preset} {task} ({style} head) {opt}, micro {B} x S {S}: losses "
              f"{[round(x, 4) for x in losses]} ({'fell' if losses[-1] < losses[0] else 'did not fall'}), {TASK_STEPS} steps in "
              f"{time.perf_counter() - t0:.1f} s with the build; flash launches "
              f"{flash.launches}", flush=True)
        L = c.num_layers
        if not all(np.isfinite(losses)) or flash.launches["flash_fwd"] != 2 * L * TASK_STEPS:
            fail(f"{preset} {task}: losses {losses}, launches {flash.launches}")
        del engine
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# MoE training
# ---------------------------------------------------------------------------


class record_routes:
    """Record the router logits and the outputs of every route the forward
    takes (``moe.moe_route``) and the logits every reference forward of the
    backward routes (``moe/layer.py``'s ``top_k_gating_indices``), to hold
    the backward's routes to the forward's; a check of this phase, not code
    on the path."""

    def __init__(self, moe):
        from deepspeed_tpu_torch.moe import layer
        self.moe, self.layer, self.fwd, self.bwd = moe, layer, [], []

    def __enter__(self):
        route, gating = self.saved = (self.moe.moe_route, self.layer.top_k_gating_indices)

        def recorded_route(logits, **kw):
            out = route(logits, **kw)
            self.fwd.append((logits.detach().clone(), out))
            return out

        def recorded_gating(logits, *args):
            self.bwd.append(logits.detach().clone())
            return gating(logits, *args)

        self.moe.moe_route, self.layer.top_k_gating_indices = recorded_route, recorded_gating
        return self

    def __exit__(self, *exc):
        self.moe.moe_route, self.layer.top_k_gating_indices = self.saved

    def check(self, torch, moe, top_k, cap, tag):
        """Each backward's router logits bitwise its forward's, and the
        forward's route (src, slot_tk) bitwise the plain route of those
        logits, its weights within MOE_W_ULPS: the backward differentiates
        the routes the forward took. Returns the number of calls checked."""
        if len(self.fwd) != len(self.bwd) or not self.fwd:
            fail(f"{tag}: {len(self.fwd)} forward routes, {len(self.bwd)} backward ones")
        for (logits, got), again in zip(self.fwd, self.bwd):
            if not torch.equal(logits, again):
                fail(f"{tag}: the backward's router logits differ from the forward's")
            want = moe.moe_route_reference(again.float(), top_k=top_k, capacity=cap)
            for i, name in ((0, "src"), (2, "slot_tk")):
                if not torch.equal(got[i], want[i]):
                    fail(f"{tag}: the backward's route differs from the forward's ({name})")
            for i in (1, 3):
                if bool(((got[i] - want[i]).abs() > MOE_W_ULPS * 2.0 ** -23
                         * want[i].abs()).any()):
                    fail(f"{tag}: route weights beyond {MOE_W_ULPS} ulp of the backward's")
        return len(self.fwd)


def moe_train_cases():
    """(T, capacity) of the operator checks, each at the training capacity
    (factor 1.25, at least 4): the training step's MoE call
    (``MOE_TRAIN_CONFIG``'s micro x ``TRAIN_SEQ`` tokens: T 8192 at
    capacity int(8192 x 1.25 / 8) = 1280, the split form, 10240 slots for
    16384 choices) and ``MOE_TRAIN_FUSED_T`` tokens (T 256 at capacity 40,
    the fused form)."""
    from deepspeed_tpu_torch.moe.sharded_moe import capacity
    step_t = MOE_TRAIN_CONFIG["train_micro_batch_size_per_gpu"] * TRAIN_SEQ
    return tuple((T, capacity(T, MOE_E, 1.25, 4)) for T in (step_t, MOE_TRAIN_FUSED_T))


def moe_op_vs_plain(torch, moe, gen, flush):
    """The MoE operator (``make_moe_forward`` with gradients) at
    mixtral-8x7b's widths, bf16 and fp32, at ``moe_train_cases()``: its
    output, aux and gradients (tokens, router, each expert weight; a
    cotangent on out and on aux) through the kernels against the same call
    with the wrappers on their plain versions (``plain_moe_kernels``), the
    forward at ``MOE_TRAIN_FWD_TOL``, the gradients at
    ``MOE_TRAIN_GRAD_TOL``; the backward's routes bitwise the forward's.
    Then each MoE kernel timed at the training step's call (T 8192,
    capacity 1280, bf16) beside its plain version, its bound and the
    library call."""
    E, H, F, k, act = MOE_E, MOE_H, MOE_F, MOE_K, "silu_gated"
    cases = moe_train_cases()
    for dtype in (torch.bfloat16, torch.float32):
        w = moe_weights(torch, E, H, F, act, dtype, gen)
        fwd_tol = MOE_TRAIN_FWD_TOL[str(dtype)]
        grad_tol = MOE_TRAIN_GRAD_TOL[str(dtype)]
        for T, cap in cases:
            tokens = torch.randn(T, H, generator=gen, device="cuda").to(dtype)
            d_out = torch.randn(T, H, generator=gen, device="cuda").to(dtype)
            d_aux = torch.full((), MOE_TRAIN_D_AUX, device="cuda")
            fused = T <= moe.MOE_FUSED_COMBINE_MAX_TOKENS
            tag = (f"{str(dtype)[6:]} T{T} cap {cap} ({'fused' if fused else 'split'} form)")
            res = {}
            for path in ("kernels", "plain"):
                p = {n: t.detach().requires_grad_(True) for n, t in w.items()}
                x = tokens.detach().requires_grad_(True)
                before = dict(moe.launches)
                t0 = time.perf_counter()
                rec = record_routes(moe)
                with plain_moe_kernels(moe) if path == "plain" else rec:
                    out, aux = moe.make_moe_forward(top_k=k, capacity=cap, activation=act)(p, x)
                    torch.autograd.backward([out, aux], [d_out, d_aux])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                ran = {n: moe.launches[n] - before[n] for n in before if moe.launches[n] > before[n]}
                if path == "kernels":
                    want = (["moe_route", "moe_dispatch_gather"]
                            + (["moe_ffn_combine"] if fused else ["moe_ffn", "moe_combine"]))
                    if ran != dict.fromkeys(want, 1):
                        fail(f"[moe-train] {tag}: launches {ran}, want one each of {want}")
                    checked = rec.check(torch, moe, k, cap, f"[moe-train] {tag}")
                    filled = int((rec.fwd[0][1][0] > 0).sum())
                elif ran:
                    fail(f"[moe-train] {tag}: the plain path launched {ran}")
                res[path] = (out.detach(), aux.detach(), x.grad,
                             {n: t.grad for n, t in p.items()}, secs)
            (out, aux, gx, gw, secs), (pout, paux, pgx, pgw, psecs) = res["kernels"], res["plain"]
            if not filled < k * T:
                fail(f"[moe-train] {tag}: no choice dropped ({filled} of {k * T} kept)")
            errs = {"out": check_close(f"[moe-train] {tag} out", out, pout, fwd_tol),
                    "aux": check_close(f"[moe-train] {tag} aux", aux, paux, MOE_FP32_TOL),
                    "d tokens": check_close(f"[moe-train] {tag} d tokens", gx, pgx, grad_tol)}
            for n in gw:
                errs[f"d {n}"] = check_close(f"[moe-train] {tag} d {n}", gw[n], pgw[n], grad_tol)
            print(f"[moe-train] op {tag}: {filled} of {k * T} choices kept in {E * cap} slots; "
                  f"max_abs_err against plain "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (forward at {fwd_tol}, gradients at {grad_tol} + {grad_tol}|ref|, aux "
                  f"{float(aux):.6f}); backward routes bitwise the forward's ({checked} call); "
                  f"forward + backward {secs * 1e3:.1f} ms kernels, {psecs * 1e3:.1f} ms plain "
                  f"(host clock, first calls)", flush=True)
            del res, out, aux, gx, gw, pout, paux, pgx, pgw, tokens, d_out
        del w
        torch.cuda.empty_cache()

    # each kernel at the training step's call, bf16 (the fused FFN too,
    # which the step leaves to the split form at this T)
    T, cap = cases[0]
    w = moe_weights(torch, E, H, F, act, torch.bfloat16, gen)
    wg, wu, wo = moe_ffn_args(w, act)
    tokens = torch.randn(T, H, generator=gen, device="cuda").to(torch.bfloat16)
    logits = tokens @ w["gate"]
    src, slot_w, slot_tk, w_tk, _, _ = moe.moe_route(logits, top_k=k, capacity=cap)
    p3 = moe.moe_dispatch_gather(tokens, src).view(E, cap, H)
    y = moe.moe_ffn(p3, wg, wu, wo, src, activation=act).view(E * cap, H)
    calls = moe_calls(torch, moe, tokens, logits, (src, slot_w, slot_tk, w_tk), p3, y, w, k,
                      cap, act)
    bnd = moe_bounds(torch, src, E, cap, T, H, F, k, act, 2)
    per_expert = (src.view(E, cap) > 0).sum(dim=1).tolist()
    print(f"[moe-train] kernels at a training call, T {T} cap {cap} bf16: slots filled "
          f"{sum(per_expert)}/{E * cap} of {k * T} choices, filled slots an expert "
          f"{per_expert} (a full expert's capacity tiles are all full)", flush=True)
    for name, (kern, plain, lib) in calls.items():
        ms = device_ms(torch, kern, 10, flush)[0]
        plain_ms = synced_ms(torch, plain, 3)
        lib_ms = device_ms(torch, lib, 10, flush)[0] if lib is not None else None
        b_ms, b_by = bound(*bnd[name], torch.bfloat16)
        print(f"[moe-train]   T{T} cap {cap} {name}: kernel_ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms "
              f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} ({b_ms / ms:.1%} of bound)",
              flush=True)
    del w, wg, wu, wo, tokens, logits, p3, y, calls
    torch.cuda.empty_cache()


def mixtral_train_engine(torch, np, config, seed=0, nudge=False):
    """mixtral-8x7b at full width, ``MOE_TRAIN_LAYERS`` of its 32 layers,
    through ``initialize``: bf16 params, fp32 master and moments, remat per
    block, aux_loss_coef 0.01 (the preset's). ``nudge`` moves the first
    element of layer 0's router one bf16 ulp away from zero after the
    seeded init."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import mixtral_model
    model = mixtral_model("mixtral-8x7b", num_layers=MOE_TRAIN_LAYERS, max_seq_len=TRAIN_SEQ)
    if nudge:
        init = model.init_weights

        def nudged(generator=None):
            init(generator)
            with torch.no_grad():
                w = model.blocks[0].moe.gate.view(-1)
                v = w[:1].to(torch.bfloat16)
                w[:1] = (v.view(torch.int16) + 1).view(torch.bfloat16).to(w.dtype)
        model.init_weights = nudged
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, seed=seed)
    return engine


class count_kept:
    """Sum, on the card, the filled slots of every route the forward takes
    (``moe.moe_route``'s src > 0): the choices the experts compute, for the
    MFU over kept choices; one reduction a route, a measurement of this
    phase, not code on the path."""

    def __init__(self, moe):
        self.moe, self.calls, self.filled = moe, 0, 0

    def __enter__(self):
        route = self.saved = self.moe.moe_route

        def counted(logits, **kw):
            out = route(logits, **kw)
            self.filled = self.filled + (out[0] > 0).sum()
            self.calls += 1
            return out

        self.moe.moe_route = counted
        return self

    def __exit__(self, *exc):
        self.moe.moe_route = self.saved


def active_params(c, n_params):
    """The parameters a token passes through, the input embedding aside:
    ``n_params`` less the embedding and, in each layer, the experts it is
    not routed to (``E - top_k`` of E gated FFNs)."""
    m = c.moe
    per_expert = 3 * c.hidden_size * c.ffn_size
    return (n_params - c.vocab_size * c.hidden_size
            - c.num_layers * (m.num_experts - m.top_k) * per_expert)


def train_mixtral(torch, np, flash, adam, lion, moe):
    """``[moe-train]``: mixtral-8x7b at full width and ``MOE_TRAIN_LAYERS``
    layers, trained through ``initialize`` + ``train_batch``
    (``MOE_TRAIN_CONFIG``: micro 4 x S 2048, a MoE call of T 8192 a layer,
    capacity 1280): a warm-up and ``MOE_TRAIN_STEPS`` timed steps, then a
    profiled one; the loss and the summed aux of every step, step ms,
    tokens/s, MFU over the active parameters, peak memory, launches a step
    (per layer a step: route, gather, split FFN and combine twice each, the
    forward and its remat replay; flash forward twice, dQ and dK/dV once;
    Adam once a bucket). MFU twice: counting top_k expert FFNs a token, and
    counting the choices the routes kept (the filled slots of the timed
    steps), which is the work the card did. Fails unless the losses are
    finite, the first near its expected value, and falling. Then the same
    model from the same seed through the plain versions of every kernel
    (``plain_kernels`` and ``plain_moe_kernels``) for the first
    ``PATH_STEPS`` steps: at lr 3e-4 against the run above (the first two
    steps held to ``PATH_RTOL``, the third to ``MOE_TRAIN_WITNESS_RATIO``
    times the largest gap of ``MOE_TRAIN_WITNESSES``), and both paths at
    ``MOE_TRAIN_PATH_LR``, every step held to ``PATH_RTOL``."""
    t0 = time.perf_counter()
    engine = mixtral_train_engine(torch, np, MOE_TRAIN_CONFIG)
    torch.cuda.synchronize()
    c = engine.model.config
    buckets = len(engine.opt_state["buckets"])
    n_all = sum(p.numel() for p in engine.params.values())
    B = MOE_TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    tokens = B * TRAIN_SEQ
    cap = engine.model.blocks[0].moe.capacity(tokens)
    if (tokens, cap) != moe_train_cases()[0]:
        fail(f"[moe-train] the step's MoE call (T {tokens}, capacity {cap}) is not the "
             f"operator check's {moe_train_cases()[0]}")
    print(f"[moe-train] mixtral-8x7b layers {c.num_layers}/32 hidden {c.hidden_size} heads "
          f"{c.num_heads}/{c.kv_heads} experts {c.moe.num_experts} top-{c.moe.top_k} ffn "
          f"{c.ffn_size} vocab {c.vocab_size}: {n_all} params bf16, AdamW, fp32 master and "
          f"moments in {buckets} buckets, micro {B} x S {TRAIN_SEQ} (T {tokens} a MoE call, "
          f"capacity {cap}), remat per block, aux_loss_coef {c.moe.aux_loss_coef}; built in "
          f"{time.perf_counter() - t0:.2f} s; state {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    auxes = []
    combine = engine.model.combine_aux
    engine.model.combine_aux = lambda loss, aux: (auxes.append(aux.detach()),
                                                  combine(loss, aux))[1]
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, c.vocab_size, size=(B, TRAIN_SEQ))}
    losses = [float(engine.train_batch(batch)) for _ in range(MOE_TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash, adam, lion)
    moe.launches.update(dict.fromkeys(moe.launches, 0))
    times = []
    with count_kept(moe) as kept:
        for _ in range(MOE_TRAIN_STEPS):
            t = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            times.append(time.perf_counter() - t)
    steps = MOE_TRAIN_STEPS
    launches = {**{n: v / steps for n, v in moe.launches.items()},
                **{n: v / steps for n, v in flash.launches.items()},
                "fused_adam": adam.launches / steps, "fused_lion": lion.launches / steps}
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times) / len(times)
    n_act = active_params(c, n_all)
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = 3 * 4 * c.head_dim * pairs * c.num_heads * B * c.num_layers
    flops = 6 * n_act * tokens + attn
    # the routes of the timed steps, the forward's and the remat replay's
    # (the same routes): the kept choices a layer, and the FLOPs with only
    # those through the expert FFNs
    L, k = c.num_layers, c.moe.top_k
    if kept.calls != 2 * L * steps:
        fail(f"[moe-train] {kept.calls} routes in {steps} steps, want {2 * L * steps}")
    filled = float(kept.filled) / kept.calls
    flops_kept = flops - 6 * 3 * c.hidden_size * c.ffn_size * L * (k * tokens - filled)
    mfu, mfu_kept = (f / step_s / PEAK_FLOPS["torch.bfloat16"] for f in (flops, flops_kept))
    aux_vals = [float(a) for a in auxes]
    print(f"[moe-train] losses {[round(x, 4) for x in losses]} (expected first "
          f"{first_loss(c):.4f} + {c.moe.aux_loss_coef} x aux / {c.num_layers}); aux (sum over "
          f"the layers) {[round(a, 5) for a in aux_vals]}; step ms "
          f"{[round(x * 1e3, 1) for x in times]} mean {step_s * 1e3:.1f}; tokens/s "
          f"{tokens / step_s:.0f}; MFU {mfu:.4f} over active parameters counting top-{k} "
          f"choices ({flops:.4e} flops a step: 6 x {n_act} active non-embedding params "
          f"(top-{k} of {c.moe.num_experts} experts and the router) x {tokens} tokens + causal "
          f"attention, at 989 TFLOP/s); MFU {mfu_kept:.4f} over the kept choices "
          f"({flops_kept:.4e} flops a step: {filled:.0f} of {k * tokens} choices kept a layer, "
          f"in {c.moe.num_experts * cap} slots); max_memory_allocated {peak / 2**30:.2f} GiB",
          flush=True)
    print(f"[moe-train] launches a step {launches}", flush=True)
    if not all(np.isfinite(losses + aux_vals)):
        fail(f"[moe-train] losses {losses}, aux {aux_vals}")
    first = first_loss(c) + c.moe.aux_loss_coef * aux_vals[0] / c.num_layers
    if abs(losses[0] - first) > 0.5:
        fail(f"[moe-train] first loss {losses[0]:.4f} not within 0.5 of {first:.4f}")
    if not losses[-1] < losses[0]:
        fail(f"[moe-train] loss did not fall on the repeated batch: {losses}")
    want = {"moe_route": 2 * L, "moe_dispatch_gather": 2 * L, "moe_dispatch_gather_int8": 0,
            "moe_ffn_combine": 0, "moe_ffn": 2 * L, "moe_combine": 2 * L,
            "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L, "fused_adam": buckets,
            "fused_lion": 0}
    if launches != want:
        fail(f"[moe-train] launches a step {launches} != {want}")
    profile_step(torch, engine, batch, step_s, "moe-train-profile")
    engine.model.combine_aux = combine
    del engine
    gc_cuda(torch)

    t0 = time.perf_counter()
    low = dict(MOE_TRAIN_CONFIG, optimizer={"type": "AdamW", "params": {
        "lr": MOE_TRAIN_PATH_LR, "weight_decay": 0.1}})
    paths = {("kernels", "3e-4"): losses[:PATH_STEPS]}
    runs = ((("plain", "3e-4"), True, True, False), (("kernels", "low"), False, False, False),
            (("plain", "low"), True, True, False))
    runs += tuple(((name, "3e-4"), *how) for name, *how in MOE_TRAIN_WITNESSES)
    for key, plain_dense, plain_moe, nudge in runs:
        engine = mixtral_train_engine(torch, np, MOE_TRAIN_CONFIG if key[1] == "3e-4" else low,
                                      nudge=nudge)
        zero_counts(flash, adam, lion)
        moe.launches.update(dict.fromkeys(moe.launches, 0))
        with contextlib.ExitStack() as swaps:
            if plain_dense:
                swaps.enter_context(plain_kernels(flash, adam, lion))
            if plain_moe:
                swaps.enter_context(plain_moe_kernels(moe))
            paths[key] = [float(engine.train_batch(batch)) for _ in range(PATH_STEPS)]
        dense = [*flash.launches.values(), adam.launches]
        moe_n = [moe.launches[n] for n in ("moe_route", "moe_dispatch_gather", "moe_ffn",
                                            "moe_combine")]
        if any(any(n) if plain else not all(n)
               for plain, n in ((plain_dense, dense), (plain_moe, moe_n))):
            fail(f"[moe-train] {key[0]}: launches flash {flash.launches}, adam {adam.launches}, "
                 f"moe {moe.launches}")
        del engine
        gc_cuda(torch)

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(paths[a], paths[b])]
    held = {"3e-4": rel(("kernels", "3e-4"), ("plain", "3e-4"))[:2],
            "low": rel(("kernels", "low"), ("plain", "low"))}
    step3 = rel(("kernels", "3e-4"), ("plain", "3e-4"))[2]
    witness3 = max(rel((name, "3e-4"), ("plain", "3e-4"))[2] for name, *_ in MOE_TRAIN_WITNESSES)
    for lr, note in (("3e-4", f"steps 1-2 held to {PATH_RTOL}, step 3 to "
                              f"{MOE_TRAIN_WITNESS_RATIO} x the witnesses' largest, "
                              f"{witness3:.3e}"),
                     ("low", f"limit {PATH_RTOL}, bf16")):
        diff = rel(("kernels", lr), ("plain", lr))
        print(f"[moe-train] {MOE_TRAIN_LAYERS} layers, full width, {PATH_STEPS} steps at lr "
              f"{MOE_TRAIN_PATH_LR if lr == 'low' else 3e-4}: kernels {paths['kernels', lr]} "
              f"plain {paths['plain', lr]}, relative difference by step "
              f"{[float(f'{r:.3e}') for r in diff]} ({note})", flush=True)
    for name, *_ in MOE_TRAIN_WITNESSES:
        diff = rel((name, "3e-4"), ("plain", "3e-4"))
        print(f"[moe-train] witness at lr 3e-4, {name}: {paths[name, '3e-4']}, relative "
              f"difference from plain by step {[float(f'{r:.3e}') for r in diff]}", flush=True)
    print(f"[moe-train] kernels against plain and the witnesses: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    worst = max(held["3e-4"] + held["low"])
    if worst > PATH_RTOL:
        fail(f"[moe-train] kernel and plain training paths differ by {worst:.3e}")
    if step3 > MOE_TRAIN_WITNESS_RATIO * witness3:
        fail(f"[moe-train] at lr 3e-4 the kernel and plain paths differ by {step3:.3e} at "
             f"step 3, past {MOE_TRAIN_WITNESS_RATIO} x the witnesses' {witness3:.3e}")


# ---------------------------------------------------------------------------
# [seq-parallel]: sequence parallelism, two ranks on the one card
# ---------------------------------------------------------------------------


def seq_engine(torch, form, num_layers=None, seed=0):
    """tinyllama-1.1b at SEQ_LEN context through ``initialize`` under
    SEQ_CONFIG, as a ``SEQ_FORMS`` form (its ``seq_parallel`` and
    transport); ``topology`` is dropped in a world of one."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm as dist
    from deepspeed_tpu_torch.models import llama_model
    sp_form, transport = SEQ_FORMS[form]
    kw = {} if num_layers is None else {"num_layers": num_layers}
    config = dict(SEQ_CONFIG, comm_transport=transport)
    if dist.get_world_size() == 1:
        config.pop("topology")
    model = llama_model("tinyllama-1.1b", max_seq_len=SEQ_LEN, seq_parallel=sp_form, **kw)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, seed=seed)
    return engine


def seq_batch(np, vocab):
    return {"input_ids": np.random.default_rng(0).integers(0, vocab, size=(1, SEQ_LEN))}


def seq_wire(records):
    """A step's collectives by op and width: launches, logical and wire
    bytes. A ppermute whose wire is narrower than its tensor travelled
    int8; the all-to-alls move bf16 activations as they are (bf16, the
    planner's activation width)."""
    out = {}
    for r in records:
        if r["op"] == "ppermute":
            width = "int8" if r["wire_bytes"] < r["bytes"] else "full"
        elif r["op"] == "all_to_all":
            width = "bf16"
        else:
            width = "full"
        e = out.setdefault(f"{r['op']}/{width}", {"launches": 0, "bytes": 0, "wire_bytes": 0})
        e["launches"] += r["count"]
        e["bytes"] += r["bytes"] * r["count"]
        e["wire_bytes"] += r["wire_bytes"] * r["count"]
    return out


def seq_flops(c, n_params):
    """6 x non-embedding params x tokens plus causal attention over the
    global sequence's pairs (``training_flops``' count at S = SEQ_LEN)."""
    n = n_params - c.vocab_size * c.hidden_size
    pairs = SEQ_LEN * (SEQ_LEN + 1) // 2
    return 6 * n * SEQ_LEN + 3 * 4 * c.head_dim * pairs * c.num_heads * c.num_layers


def seq_rank(rank, init_method, results):
    """One rank of [seq-parallel] (a process of its own): each SEQ_FORMS
    form at full width and SEQ_LAYERS layers, a warm-up and SEQ_STEPS timed steps, one
    more with the collectives timed; then each form at PATH_LAYERS layers
    through the kernels. Puts its measurements on ``results``."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.comm import comm as dist
    from deepspeed_tpu_torch.ops.adam import adam
    from deepspeed_tpu_torch.ops.lion import lion
    from deepspeed_tpu_torch.ops.quantizer import quant
    from deepspeed_tpu_torch.ops.transformer import flash
    t0 = time.perf_counter()
    dist.init_distributed(ZERO_BACKEND, rank=rank, world_size=SEQ_WORLD,
                          init_method=init_method, timeout=SEQ_TIMEOUT)
    res = {"rank": rank, "backend": dist.get_backend(), "forms": {}, "path": {}}
    for form in SEQ_FORMS:
        t = time.perf_counter()
        engine = seq_engine(torch, form, SEQ_LAYERS)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        c = engine.model.config
        n_params = sum(int(np.prod(s)) for s in engine.zero_plan.shapes.values())
        batch = seq_batch(np, c.vocab_size)
        warm = zero_steps(torch, engine, batch, SEQ_WARMUP, quant)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(flash, adam, lion)
        quant.launches = 0
        timed = zero_steps(torch, engine, batch, SEQ_STEPS, quant)
        launches = dict(flash.launches, fused_adam=adam.launches, quant_rows=quant.launches)
        peak = torch.cuda.max_memory_allocated()
        comm_s, step_s, n_coll, last = collective_share(torch, engine, batch)
        if rank == 0:
            print(f"[seq-parallel] rank 0 {form}: engine {build_s:.1f} s, losses "
                  f"{[round(x['loss'], 4) for x in warm + timed] + [round(last, 4)]}, step s "
                  f"{[round(x['s'], 2) for x in warm + timed]}, collectives {comm_s:.2f} of "
                  f"{step_s:.2f} s", flush=True)
        res["forms"][form] = dict(
            losses=[x["loss"] for x in warm + timed] + [last], step_s=[x["s"] for x in timed],
            launches=launches, peak=peak, build_s=build_s, comm_s=comm_s,
            comm_step_s=step_s, comm_launches=n_coll, wire=seq_wire(timed[-1]["records"]),
            buckets=len(engine.opt_state["buckets"]), flops=seq_flops(c, n_params),
            layers=c.num_layers, heads=(c.num_heads, c.kv_heads, c.head_dim),
            vocab=c.vocab_size, tokens=SEQ_LEN // SEQ_WORLD)
        del engine
        torch.cuda.empty_cache()
    for form in SEQ_FORMS:
        t = time.perf_counter()
        eng = seq_engine(torch, form, PATH_LAYERS)
        res["path"][form] = [float(eng.train_batch(batch)) for _ in range(PATH_STEPS)]
        if rank == 0:
            print(f"[seq-parallel] rank 0 {form} at {PATH_LAYERS} layers: "
                  f"{res['path'][form]} in {time.perf_counter() - t:.1f} s", flush=True)
        del eng
        torch.cuda.empty_cache()
    res["ranks_s"] = time.perf_counter() - t0
    results.put(res)
    dist.barrier()
    dist.destroy_process_group()


def run_seq_ranks():
    """Spawn SEQ_WORLD ranks of ``seq_rank`` and collect their results;
    fails if a rank fails or the ranks outlast SEQ_TIMEOUT."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=seq_rank, args=(r, init, results)) for r in range(SEQ_WORLD)]
    for p in procs:
        p.start()
    out, deadline = [], time.monotonic() + SEQ_TIMEOUT
    try:
        while len(out) < SEQ_WORLD:
            try:
                out.append(results.get(timeout=5))
            except queue.Empty:
                bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if bad:
                    fail(f"[seq-parallel] a rank exited with {bad}")
                if time.monotonic() > deadline:
                    fail(f"[seq-parallel] the ranks did not finish within {SEQ_TIMEOUT} s")
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5))
            if p.exitcode != 0:
                fail(f"[seq-parallel] rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return sorted(out, key=lambda r: r["rank"])


def seq_kernels_vs_plain(torch, flash, quant, smi):
    """The forms' kernel calls at their shapes against the plain versions,
    each timed beside its bound: flash forward and backward at
    SEQ_FLASH_CASES (bf16; the future hop's O all 0 and LSE all
    MASK_VALUE), the row quantizer on a hop's K block, byte for byte."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEQ_WORLD)   # the phase's own draws
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for name, (B, Sq, Sk, H, kvH, D, mask) in SEQ_FLASH_CASES.items():
        (q, k, v, do, dlse, spec), pairs = flash_case(torch, flash, B, Sq, Sk, H, kvH, D,
                                                      mask, torch.bfloat16, gen)
        o, lse = flash.flash_fwd(q, k, v, spec)
        o_ref, lse_ref = flash.flash_fwd_reference(q, k, v, spec=spec)
        torch.cuda.synchronize()
        tag = f"[seq-parallel] flash {name}"
        e_fwd = max(check_close(f"{tag} O", o, o_ref), check_close(f"{tag} LSE", lse, lse_ref))
        dead = min(Sq, max(0, -spec.q_offset))
        if dead and (bool(o[:, :dead].any())
                     or bool((lse[:, :, :dead] != flash.MASK_VALUE).any())):
            fail(f"{tag}: rows with no visible key must give O = 0, LSE = MASK_VALUE")
        grads = flash.flash_bwd(q, k, v, o_ref, lse_ref, do, dlse, spec)
        want = flash.flash_bwd_reference(q, k, v, o_ref, lse_ref, do, dlse, spec=spec)
        torch.cuda.synchronize()
        e_dq = check_close(f"{tag} dQ", grads[0], want[0])
        e_dkv = max(check_close(f"{tag} dK", grads[1], want[1]),
                    check_close(f"{tag} dV", grads[2], want[2]))
        _, run_dq, run_dkv = flash_single_launchers(torch, flash, q, k, v, o_ref, lse_ref, do,
                                                    spec)
        ms = {"flash_fwd": device_ms(torch, lambda: flash.flash_fwd(q, k, v, spec), 5,
                                     flush)[0],
              "flash_dq": device_ms(torch, run_dq, 5, flush)[0],
              "flash_dkv": device_ms(torch, run_dkv, 5, flush)[0]}
        plain_fwd = synced_ms(torch, lambda: flash.flash_fwd_reference(q, k, v, spec=spec), 1)
        plain_bwd = synced_ms(torch, lambda: flash.flash_bwd_reference(
            q, k, v, o_ref, lse_ref, do, dlse, spec=spec), 1)
        lib = "null (no single PyTorch call: every key is masked)"
        lib_fwd = lib_bwd = None
        if pairs:
            # the past hop sees every key (no mask); the diagonal and Ulysses
            # are causal from position 0
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            causal = pairs < B * Sq * Sk * H
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=spec.scale,
                                                          is_causal=causal, enable_gqa=True)
            lib_fwd = device_ms(torch, sdpa, 5, flush)[0]
            lib_bwd = device_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                                5, flush)[0] - lib_fwd
            lib = f"fwd {lib_fwd:.4f} bwd {lib_bwd:.4f} (SDPA, is_causal {causal})"
            del qt, kt, vt, dot
        bnd = flash_bounds(B, Sq, Sk, H, kvH, D, pairs, q.element_size())
        parts = []
        for kname in ms:
            b_ms, b_by = bound(*bnd[kname], torch.bfloat16)
            parts.append(f"{kname} {ms[kname]:.4f} ms (bound {b_ms:.4f} {b_by}, "
                         f"{b_ms / ms[kname]:.1%})")
        print(f"{tag} bf16 B{B} Sq{Sq} Sk{Sk} H{H} kvH{kvH} D{D} q_offset {spec.q_offset}"
              f"{' dlse' if dlse is not None else ''}: {pairs} visible pairs; max_abs_err fwd "
              f"{e_fwd:.3e} dQ {e_dq:.3e} dK/dV {e_dkv:.3e}; " + "; ".join(parts)
              + f"; plain fwd {plain_fwd:.4f} bwd {plain_bwd:.4f} ms; library {lib} | {smi}",
              flush=True)
        del q, k, v, do, dlse, o, lse, o_ref, lse_ref, grads, want
        torch.cuda.empty_cache()
    G, gs = SEQ_HOP_GROUPS
    x = (torch.randn(G, gs, generator=gen, device="cuda")).to(torch.bfloat16)
    q8, s8 = quant.quantize_rows_int8(x)
    qp, sp = quant.quantize_rows_int8_reference(x)
    torch.cuda.synchronize()
    if not (torch.equal(q8, qp) and torch.equal(s8.view(torch.int32), sp.view(torch.int32))):
        fail("[seq-parallel] quant_rows on a hop's K block differs from the plain version")
    ms = device_ms(torch, lambda: quant.quantize_rows_int8(x), 10, flush)[0]
    plain_ms = synced_ms(torch, lambda: quant.quantize_rows_int8_reference(x), 3)
    b_ms, b_by = bound(*quant_bounds(G, gs, 2), torch.float32)
    print(f"[seq-parallel] quant_rows on a hop's K block ({G} x {gs} bf16, "
          f"{G * gs * 2} bytes): q and scale byte-identical to the plain version; kernel_ms "
          f"{ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}, {b_ms / ms:.1%}); "
          f"library null | {smi}", flush=True)
    del flush


def train_seq_parallel(torch, np, flash, adam, lion, quant, smi):
    """The [seq-parallel] phase: the kernel calls at the forms' shapes, the
    ranks' runs (``seq_rank``), and one process's plain single-rank path on
    the whole sequence at PATH_LAYERS layers against the forms' kernel
    runs."""
    seq_kernels_vs_plain(torch, flash, quant, smi)
    gc_cuda(torch)
    # one rank over the whole sequence at SEQ_LAYERS layers, through the kernels:
    # the trajectory the forms' steps must follow
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = seq_engine(torch, "ulysses", SEQ_LAYERS)
    batch = seq_batch(np, engine.model.config.vocab_size)
    one = [float(engine.train_batch(batch)) for _ in range(SEQ_WARMUP + SEQ_STEPS + 1)]
    one_peak = torch.cuda.max_memory_allocated()
    layers = engine.model.config.num_layers
    del engine
    gc_cuda(torch)
    print(f"[seq-parallel] one rank, the whole sequence (S {SEQ_LEN}), {layers} layers, through the "
          f"kernels: losses {[round(x, 4) for x in one]}, max_memory_allocated "
          f"{one_peak / 2**30:.2f} GiB, {time.perf_counter() - t:.1f} s", flush=True)
    print(f"[seq-parallel] backend {ZERO_BACKEND}, world {SEQ_WORLD} (seq {SEQ_WORLD}, data 1; "
          f"both ranks on cuda:0), config {json.dumps(SEQ_CONFIG['zero_optimization'])}, "
          f"S {SEQ_LEN}, micro 1", flush=True)
    ranks = run_seq_ranks()
    r0 = ranks[0]
    print(f"[seq-parallel] ranks done in {max(r['ranks_s'] for r in ranks):.1f} s; backend "
          f"reported {[r['backend'] for r in ranks]}", flush=True)
    failures = []
    for form, f0 in r0["forms"].items():
        losses = f0["losses"]
        L = f0["layers"]
        H, kvH, D = f0["heads"]
        step_s = sum(f0["step_s"]) / len(f0["step_s"])
        mfu = f0["flops"] / step_s / PEAK_FLOPS["torch.bfloat16"]
        hops = 2 if form.startswith("ring") else 1     # flash calls a layer and pass
        want = {"flash_fwd": 2 * hops * L * SEQ_STEPS, "flash_dq": hops * L * SEQ_STEPS,
                "flash_dkv": hops * L * SEQ_STEPS, "fused_adam": f0["buckets"] * SEQ_STEPS,
                "quant_rows": (2 * (SEQ_WORLD - 1) * 2 * L * SEQ_STEPS
                               if form == "ring-int8" else 0)}
        print(f"[seq-parallel] {form}: tinyllama-1.1b layers {L} heads {H}/{kvH} D {D}, "
              f"{f0['tokens']} tokens a rank: losses {[round(x, 4) for x in losses]}; engine "
              f"built in {f0['build_s']:.1f} s; step ms "
              f"{[round(x * 1e3, 1) for x in f0['step_s']]} mean {step_s * 1e3:.1f}; tokens/s "
              f"{SEQ_LEN / step_s:.0f}; MFU {mfu:.4f} ({f0['flops']:.4e} flops a step: 6 x "
              f"non-embedding params x {SEQ_LEN} tokens + causal attention over the global "
              f"pairs, at 989 TFLOP/s); max_memory_allocated per rank "
              f"{[round(r['forms'][form]['peak'] / 2**30, 2) for r in ranks]} GiB | {smi}",
              flush=True)
        if any(r["forms"][form]["losses"] != losses for r in ranks):
            failures.append(f"{form}: losses differ between ranks: "
                            f"{[r['forms'][form]['losses'] for r in ranks]}")
        if not all(np.isfinite(losses)):
            failures.append(f"{form}: losses {losses}")
        elif abs(losses[0] - np.log(f0["vocab"])) > 0.5:
            failures.append(f"{form}: first loss {losses[0]:.4f} not within 0.5 of "
                            f"ln({f0['vocab']})")
        elif not losses[-1] < losses[0]:
            failures.append(f"{form}: loss did not fall on the repeated batch: {losses}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one))
        print(f"[seq-parallel] {form}: losses against the one-rank run's, relative difference "
              f"{rel:.3e} (limit {PATH_RTOL})", flush=True)
        if rel > PATH_RTOL:
            failures.append(f"{form}: losses {losses} part from the one-rank run's {one} by "
                            f"{rel:.3e}")
        for r in ranks:
            fr = r["forms"][form]
            got = {k: fr["launches"][k] for k in want}
            print(f"[seq-parallel] {form} rank {r['rank']}: launches a step "
                  f"{ {k: v / SEQ_STEPS for k, v in got.items()} }; one more step of {fr['comm_step_s'] * 1e3:.1f} ms, "
                  f"{fr['comm_launches']} collectives timed (device synchronized around each) "
                  f"{fr['comm_s'] * 1e3:.1f} ms: share {fr['comm_s'] / fr['comm_step_s']:.3f}; "
                  f"wire a step {json.dumps(fr['wire'])}", flush=True)
            if got != want:
                failures.append(f"{form} rank {r['rank']} launches {got} != {want}")
            # each layer's exchanges, recorded in the forward, its remat
            # replay and the backward: Ulysses' 4 all-to-alls (q, k, v, out),
            # the ring's sp - 1 hops of K and V (the backward's inverse hops
            # at full width)
            hop_n = 2 * (SEQ_WORLD - 1) * L
            seq_ops = {"ulysses": {"all_to_all/bf16": 12 * L},
                       "ring-int8": {"ppermute/int8": 2 * hop_n, "ppermute/full": hop_n},
                       "ring-full": {"ppermute/full": 3 * hop_n}}[form]
            got_ops = {k: v["launches"] for k, v in fr["wire"].items()
                       if k.split("/")[0] in ("all_to_all", "ppermute")}
            if got_ops != seq_ops:
                failures.append(f"{form}: seq-axis launches a step {got_ops} != {seq_ops}")
    t = time.perf_counter()
    engine = seq_engine(torch, "ulysses", PATH_LAYERS)
    batch = seq_batch(np, engine.model.config.vocab_size)
    zero_counts(flash, adam, lion)
    with plain_kernels(flash, adam, lion):
        plain = [float(engine.train_batch(batch)) for _ in range(PATH_STEPS)]
    if any(flash.launches.values()) or adam.launches:
        fail(f"[seq-parallel] the plain path launched kernels: {flash.launches}, "
             f"adam {adam.launches}")
    del engine
    gc_cuda(torch)
    for form, got in r0["path"].items():
        rel = [abs(a - b) / abs(b) for a, b in zip(got, plain)]
        print(f"[seq-parallel] {PATH_LAYERS} layers, same width, S {SEQ_LEN}, {PATH_STEPS} "
              f"steps: {form} at sp {SEQ_WORLD} through the kernels {got}; one process, the "
              f"whole sequence, the plain versions {plain}: relative difference "
              f"{max(rel):.3e} (limit {PATH_RTOL})", flush=True)
        if max(rel) > PATH_RTOL:
            failures.append(f"{form}: kernels at sp {SEQ_WORLD} and the plain single-rank "
                            f"path differ by {max(rel):.3e}")
    print(f"[seq-parallel] the plain single-rank path: {time.perf_counter() - t:.1f} s",
          flush=True)
    if failures:
        fail("[seq-parallel] " + "; ".join(failures))


def gc_cuda(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def main():
    import gc

    import numpy as np
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.inference.quantization import quantization
    from deepspeed_tpu_torch.ops.adam import adam
    from deepspeed_tpu_torch.ops.lion import lion
    from deepspeed_tpu_torch.ops.op_builder import builder
    from deepspeed_tpu_torch.ops.quantizer import quant
    from deepspeed_tpu_torch.ops.quantizer import woq_matmul as woq
    from deepspeed_tpu_torch.ops.transformer import flash
    from deepspeed_tpu_torch.ops.transformer import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | TF32 off (matmul and cuDNN)", flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = builder.build()
    print(f"[build] {len(built)} kernel libraries ({', '.join(builder.KERNELS)}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            # register use, spills, and ptxas's notes that it serialized a
            # kernel's wgmma pipeline ("(C75xx) Potential Performance Loss")
            if any(w in line for w in ("registers", "spill", "Performance Loss")):
                print(f"[build] {name}: {line.strip()}")

    # 3-4. kernels vs plain
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows, drows = serving_kernels_vs_plain(torch, gen, flush)
    frows, ferrs = flash_kernels_vs_plain(torch, flash, gen, flush)
    arow, aerr = adam_kernel_vs_plain(torch, adam, gen, flush)
    lrow, lerr = lion_kernel_vs_plain(torch, lion, adam, gen, flush)
    wrow, werr = woq_kernel_vs_plain(torch, woq, quantization, gen, flush)
    qrow, qerr = quant_kernel_vs_plain(torch, quant, gen, flush)
    mrows, merrs = moe_kernels_vs_plain(torch, moe, gen, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    # 5. serving
    launches, dense_memory = serve(torch, np)
    gc.collect()
    torch.cuda.empty_cache()

    # 6. int8 weight-only-quantized serving
    launches["woq_matmul"] = serve_woq(torch, np, woq, dense_memory)["woq_matmul"]
    gc.collect()
    torch.cuda.empty_cache()

    # 7. training
    adamw, adamw_opt_bytes = train(
        torch, np, flash, adam, lion, TRAIN_CONFIG, TRAIN_WARMUP, TRAIN_STEPS,
        after=lambda engine, batch: checkpoint_phase(torch, np, engine, batch, TRAIN_CONFIG, smi))
    launches.update({k: v for k, v in adamw.items() if k != "fused_lion"})
    gc.collect()
    torch.cuda.empty_cache()

    # 8. Lion training
    launches["fused_lion"] = train(torch, np, flash, adam, lion, LION_CONFIG, LION_WARMUP,
                                   LION_STEPS)[0]["fused_lion"]
    gc.collect()
    torch.cuda.empty_cache()

    # 9. data-parallel ZeRO-3 with the ZeRO++ int8 wire, two ranks
    launches["quant_rows"] = train_zero(torch, np, adamw_opt_bytes, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. Mixtral serving; its count of the int8 dispatch gather is the one
    # in the kernels line (no path calls that kernel, as in the JAX package;
    # its checks in [moe] do not count)
    launches.update(serve_mixtral(torch, np, moe))
    print(f"[kernels] moe_dispatch_gather_int8: {launches['moe_dispatch_gather_int8']} "
          f"launches in Mixtral serving (no path calls it; the int8 expert exchange waits "
          f"for a live expert axis); checked and timed in [moe]", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 11. the decoder families: Phi-2 training and Falcon-7B serving at full
    # depth, each family at 2 layers (their launches check themselves; the
    # kernels line keeps the counts of the paths above)
    train_phi2(torch, np, flash, adam, lion)
    gc.collect()
    torch.cuda.empty_cache()
    for preset in FAMILY_SERVED:
        serve_family(torch, np, preset)
        gc.collect()
        torch.cuda.empty_cache()
    families_two_layers(torch, np, flash, adam, lion)
    gc.collect()
    torch.cuda.empty_cache()
    families_tiny(torch, np, flash, adam, lion)
    gc.collect()
    torch.cuda.empty_cache()

    # 12. open-llama-3b (head_dim 100) trained and served at full width and
    # depth
    t0 = time.perf_counter()
    train_open_llama(torch, np, flash, adam, lion)
    gc.collect()
    torch.cuda.empty_cache()
    serve_open_llama(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[open-llama] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. the encoders: bert-large MLM at full width and depth, every remat
    # policy at its shape, 2 layers kernels against plain, the task heads
    t0 = time.perf_counter()
    train_bert_large(torch, np, flash, adam, lion)
    gc.collect()
    torch.cuda.empty_cache()
    remat_policies(torch, np, flash, adam, lion)
    encoders_two_layers(torch, np, flash, adam, lion)
    train_task_heads(torch, np, flash, adam, lion)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[encoders] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 14. MoE training: the MoE operator and its backward against the plain
    # versions, each MoE kernel at the training call, and mixtral-8x7b at
    # full width and 2 layers trained through the kernels and through their
    # plain versions (its launches check themselves; the kernels line keeps
    # the counts of the paths above)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(MOE_TRAIN_SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    moe_op_vs_plain(torch, moe, gen, flush)
    del flush
    gc_cuda(torch)
    train_mixtral(torch, np, flash, adam, lion, moe)
    print(f"[moe-train] phase {time.perf_counter() - t0:.1f} s", flush=True)
    gc_cuda(torch)

    # 15. sequence parallelism: the forms' kernel calls at their shapes,
    # tinyllama-1.1b at 16384 tokens over two ranks in each form, the
    # 2-layer kernels-vs-plain runs (their launches check themselves; the
    # kernels line keeps the counts of the paths above)
    t0 = time.perf_counter()
    train_seq_parallel(torch, np, flash, adam, lion, quant, smi)
    print(f"[seq-parallel] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 16. kernels line
    kernels = []
    for name, src, replaces, row, err in (
            ("ragged_paged_attention", "ragged_paged_attention.cu",
             "inference/v2/kernels/ragged_paged_attention.py:78", rows[MAIN_WAVE],
             max(r["max_abs_err"] for r in rows.values())),
            ("paged_decode", "paged_decode.cu",
             "inference/v2/kernels/pallas_paged_decode.py:54", drows[MAIN_DECODE],
             max(r["max_abs_err"] for r in drows.values())),
            ("flash_fwd", "flash_fwd.cu", "ops/transformer/pallas_flash.py:144",
             frows["flash_fwd"], ferrs["flash_fwd"]),
            ("flash_dq", "flash_bwd.cu", "ops/transformer/pallas_flash.py:261",
             frows["flash_dq"], ferrs["flash_dq"]),
            ("flash_dkv", "flash_bwd.cu", "ops/transformer/pallas_flash.py:296",
             frows["flash_dkv"], ferrs["flash_dkv"]),
            ("fused_adam", "fused_adam.cu", "ops/adam/pallas_adam.py:152", arow, aerr),
            ("fused_lion", "fused_lion.cu", "ops/lion/pallas_lion.py:22", lrow, lerr),
            ("woq_matmul", "woq_matmul.cu", "ops/quantizer/pallas_woq_matmul.py:51", wrow,
             werr),
            ("moe_route", "moe_route.cu", "ops/transformer/pallas_moe.py:192",
             mrows["moe_route"], merrs["moe_route"]),
            ("moe_dispatch_gather", "moe_dispatch.cu", "ops/transformer/pallas_moe.py:284",
             mrows["moe_dispatch_gather"], merrs["moe_dispatch_gather"]),
            ("moe_ffn_combine", "moe_ffn.cu", "ops/transformer/pallas_moe.py:392",
             mrows["moe_ffn_combine"], merrs["moe_ffn_combine"]),
            ("moe_ffn", "moe_ffn.cu", "ops/transformer/pallas_moe.py:434",
             mrows["moe_ffn"], merrs["moe_ffn"]),
            ("moe_combine", "moe_dispatch.cu", "ops/transformer/pallas_moe.py:455",
             mrows["moe_combine"], merrs["moe_combine"]),
            ("quant_rows", "quant_rows.cu", "ops/quantizer/pallas_quant.py:55", qrow, qerr),
            ("moe_dispatch_gather_int8", "moe_dispatch.cu", "ops/transformer/pallas_moe.py:292",
             mrows["moe_dispatch_gather_int8"], merrs["moe_dispatch_gather_int8"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"deepspeed_tpu_torch/csrc/{src}",
                        "replaces": f"deepspeed_tpu/{replaces}", "launches": launches[name],
                        "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row.get("library_ms")})
    print(f"[total] {time.perf_counter() - t_start:.1f} s of command before the kernels "
          f"line", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
