#!/usr/bin/env python3
"""Interleaved A/B of two versions of the port's CUDA kernel sources on one GPU.

    python3 kernel_ab.py A_CSRC_DIR B_CSRC_DIR [--rounds N]

Builds both source directories' kernels with the package's own ``nvcc``
flags (``deepspeed_tpu_torch/ops/op_builder/builder.py``), holds each
version against the plain PyTorch versions in bf16 at every kernel case of
``chip_smoke.py``, then times both at those cases in the order A, B, B, A
(``--rounds`` times), one line per pass, so the two are compared on one
card within one run. The paged-attention group (``paged``: the ragged
wave at every ``WAVE_CASES`` case, paged decode at every ``DECODE_CASES``
case, but those with ALiBi slopes or a window, which ``chip_smoke.py``
times and which the wrappers of a tree from before them do not take) drives each version through the wrappers of the tree that holds its
``csrc`` (``inference/v2/kernels/ragged_paged_attention.py``,
``paged_decode.py``), since a redesign changes what a wrapper passes its
kernel. The weight-only-quantized matmul joins in (at the
``WOQ_CASES`` x ``WOQ_ROWS`` of ``chip_smoke.py``) when both directories
hold its source, and so does the grouped expert FFN (``moe_ffn.cu``: both
forms at mixtral-8x7b's widths, a decode step of T = 8 and a prefill wave
of T = 512 dropless tokens, routed by the plain route on the card), and so
does flash attention (``flash_bwd.cu``: the whole backward through
``flash.flash_bwd``, di and both launches, and the forward, at the
``FLASH_TIMED`` shapes; each version is held to the plain versions, and
when both directories hold the same forward source, ``flash_fwd.cu`` and
the headers it includes (``FLASH_FWD_SOURCES``), the two forwards must
also give the same bits), and so does the fused Adam kernel
(``fused_adam.cu``: ``MAIN_ADAM``, moments bitwise against the plain
version, timed beside ``torch.optim.AdamW(fused=True)`` on the same leaf
with fp32 gradients in every pass), and so do the MoE route and dispatch
gather (``moe_route``: both need ``moe_route.cu`` and ``moe_dispatch.cu``;
mixtral-8x7b's E 8, top-2, H 4096 in bf16, dropless, T 8, 256, 512 and
4096: the route of fp32 logits in both versions, of bf16 logits where the
version takes them, the gather, and route -> gather as one call fed what
each version's forward feeds it, also after the router product; each
version's route bitwise its plain version, weights within
``MOE_W_ULPS``, its payload byte-identical to ``index_select``, both
bit-identical on a second run; and the device operations of one call of
each version's MoE forward at T 8, as serving builds it), and so does the
ZeRO++ wire quantizer (``quant``: ``quant_rows.cu`` at every
``QUANT_CASES`` case, each version's q and scale byte-identical to the
plain version, an elementwise ``x.to(torch.int8)`` of the large cases timed
beside it as context (the same bytes, scales aside); ``moe_dispatch.cu`` is
built too, so the SASS comparison
shows the int8 dispatch gather, which shares the row arithmetic), and so
does the split combine (``moe_combine``: ``moe_dispatch.cu`` at T 512 and
4096, H 4096, top-2, dropless, routed by the plain route on the card, y
seeded, each version bitwise its plain version, timed beside
``F.embedding_bag`` (mode sum, per-sample weights) in every pass; when both
hold ``moe_ffn.cu`` also the split FFN -> combine as one call at T 512,
which shows the combine's programmatic dependent launch), and so does the
int8 dispatch gather (``gather_int8``: ``moe_dispatch.cu`` and
``quant_rows.cu`` at ``GATHER_INT8_CASES``, mixtral-8x7b's H 4096, top-2,
dropless, routed by the plain route on the card, mask_pad on; each version's
q and scale byte-identical to its plain version, to its own
``quantize_rows_int8`` of the gathered rows and to a second run, mask_pad off
and on; ``index_select`` of the same slots timed beside it in every pass, as
context). ``--only`` names the groups to run (``paged``, ``woq``,
``moe_ffn``, ``flash``, ``adam``, ``moe_route``, ``quant``,
``moe_combine``, ``gather_int8``). A tile-shape
sweep point is a copy of ``csrc`` with one constant edited, passed as B
against the unedited ``csrc`` as A. To compare a change with its parent,
unpack the parent's ``deepspeed_tpu_torch`` with ``git archive`` into a
directory that ``.gitignore`` lists and pass its ``csrc`` as A: the paged,
WOQ and grouped-FFN kernels are then driven through the wrappers of the
tree that holds each ``csrc`` (the two paged-attention modules,
``ops/quantizer/woq_matmul.py``, ``ops/quantizer/quant.py``,
``ops/transformer/moe.py``); a ``csrc``
alone is driven through the checkout's. ``--rounds 0`` builds, compares
the SASS and checks both versions without timing them.
The SASS of every kernel that both builds hold is compared first, names
and whitespace aside (``cuobjdump``), so a change that leaves a kernel
alone shows as identical code; a kernel of A that B names otherwise is
matched to a B kernel with the same code, if one has it. Exits non-zero without a GPU or when a
version disagrees with the plain versions.
"""

import argparse
import ctypes
import importlib
import importlib.util
import inspect
import sys
from pathlib import Path

import chip_smoke as cs


def flash_version(flash, lib):
    """(forward, backward) of the flash kernels built from one source
    directory, called as ``flash.flash_fwd`` / ``flash.flash_bwd`` are."""
    fns = flash.bind(lib("flash_fwd"), lib("flash_bwd"))

    def with_fns(fn):
        def call(*args):
            saved = flash._kernels
            flash._kernels = lambda: fns
            try:
                return fn(*args)
            finally:
                flash._kernels = saved
        return call
    return with_fns(flash._fwd_cuda), with_fns(flash._bwd_cuda)


FLASH_FWD_SOURCES = ("flash_fwd.cu", "flash_common.cuh", "hopper.cuh")


def sass(build, lib):
    """``{kernel name: SASS lines}`` of a built library (``cuobjdump`` beside
    ``nvcc``), with the per-build namespace hash and the listing's spacing
    taken out."""
    import re
    import subprocess
    tool = Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1)), [])
        elif cur is not None:
            cur.append(" ".join(re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split()))
    return funcs


def wrapper(csrc, rel, name, tag):
    """The wrapper module ``name`` of the version at ``csrc``: loaded from
    the file ``rel`` of the package tree around ``csrc`` when that tree has
    one, else the checkout's own module."""
    path = csrc.parent / rel
    if not path.exists():
        return importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(f"{name}_ab_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROUTE_TOKENS = (8, 256, 512, 4096)   # the moe_route group: dropless, capacity T
COMBINE_TOKENS = (512, 4096)         # the moe_combine group: dropless, capacity T
# the gather_int8 group: (T, token dtype), dropless, capacity T
GATHER_INT8_CASES = ((8, "bfloat16"), (256, "bfloat16"), (512, "bfloat16"),
                     (4096, "bfloat16"), (512, "float32"))


def takes_bf16_logits(moe_v):
    """Whether a version's route takes bf16 logits (its params carry the
    flag)."""
    return "bf16" in dict(moe_v.MoeRouteParams._fields_)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only",
                    default="paged,woq,moe_ffn,flash,adam,moe_route,quant,moe_combine,gather_int8",
                    help="comma-separated groups: paged, woq, moe_ffn, flash, adam, moe_route, "
                         "quant, moe_combine, gather_int8")
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops.op_builder import builder as _build
    from deepspeed_tpu_torch.inference.v2.kernels import paged_decode as pdk
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import \
        paged_decode_attention_reference
    from deepspeed_tpu_torch.inference.v2.ragged.wave import WaveEntry, build_wave
    from deepspeed_tpu_torch.ops.adam import adam
    from deepspeed_tpu_torch.ops.quantizer import quant
    from deepspeed_tpu_torch.ops.quantizer import woq_matmul as woq
    from deepspeed_tpu_torch.ops.transformer import moe

    from deepspeed_tpu_torch.ops.transformer import flash

    both = lambda src: all((d / src).exists() for d in (args.a, args.b))
    has_paged = "paged" in only
    has_woq = "woq" in only and both("woq_matmul.cu")
    has_moe = "moe_ffn" in only and both("moe_ffn.cu")
    has_flash = "flash" in only and both("flash_bwd.cu")
    has_adam = "adam" in only and both("fused_adam.cu")
    has_route = "moe_route" in only and both("moe_route.cu") and both("moe_dispatch.cu")
    has_quant = "quant" in only and both("quant_rows.cu")
    has_combine = "moe_combine" in only and both("moe_dispatch.cu")
    has_pair = has_combine and both("moe_ffn.cu")
    has_g8 = "gather_int8" in only and both("moe_dispatch.cu") and both("quant_rows.cu")
    same_fwd = all((args.a / f).read_bytes() == (args.b / f).read_bytes()
                   for f in FLASH_FWD_SOURCES) if has_flash else False
    names = ((("ragged_paged_attention", "paged_decode") if has_paged else ())
             + (("woq_matmul",) if has_woq else ()) + (("moe_ffn",) if has_moe else ())
             + (("flash_fwd", "flash_bwd") if has_flash else ())
             + (("fused_adam",) if has_adam else ())
             + (("moe_route", "moe_dispatch", "moe_ffn") if has_route else ())
             + (("quant_rows", "moe_dispatch") if has_quant else ())
             + ((("moe_dispatch",) + (("moe_ffn",) if has_pair else ())) if has_combine else ())
             + (("moe_dispatch", "quant_rows") if has_g8 else ()))
    names = tuple(dict.fromkeys(names))   # each library once
    versions = {}
    for tag, csrc in (("A", args.a), ("B", args.b)):
        csrc = csrc.resolve()
        _build.build(names, csrc=csrc)
        lib = lambda name: ctypes.CDLL(str(_build.library_path(name, csrc)))
        woq_v = moe_v = rpa_v = pdk_v = quant_v = None
        if has_paged:
            rpa_v = wrapper(csrc, "inference/v2/kernels/ragged_paged_attention.py",
                            rpa.__name__, tag)
            rpa_v._kernel = (lambda f: lambda: f)(rpa_v.bind(lib("ragged_paged_attention")))
            pdk_v = wrapper(csrc, "inference/v2/kernels/paged_decode.py", pdk.__name__, tag)
            pdk_v._kernel = (lambda f: lambda: f)(pdk_v.bind(lib("paged_decode")))
        if has_woq:
            woq_v = wrapper(csrc, "ops/quantizer/woq_matmul.py", woq.__name__, tag)
            woq_v._kernel = (lambda f: lambda: f)(woq_v.bind(lib("woq_matmul")))
        if has_moe or has_route or has_combine or has_g8:
            moe_v = wrapper(csrc, "ops/transformer/moe.py", moe.__name__, tag)
        if has_moe or has_route or has_pair:
            moe_v._ffn_kernel = (lambda f: lambda: f)(moe_v.bind_ffn(lib("moe_ffn")))
        if has_route:
            moe_v._route_kernel = (lambda f: lambda: f)(moe_v.bind_route(lib("moe_route")))
        if has_route or has_combine or has_g8:
            moe_v._dispatch_kernels = (lambda f: lambda: f)(
                moe_v.bind_dispatch(lib("moe_dispatch")))
        if has_quant or has_g8:
            quant_v = wrapper(csrc, "ops/quantizer/quant.py", quant.__name__, tag)
            quant_v._kernel = (lambda f: lambda: f)(quant_v.bind(lib("quant_rows")))
        versions[tag] = (rpa_v, pdk_v, woq_v, moe_v,
                         flash_version(flash, lib) if has_flash else None,
                         adam.bind(lib("fused_adam")) if has_adam else None, quant_v)
        print(f"[ab] {tag} = {csrc} (wrappers: "
              + ", ".join(m.__file__ if m else "-"
                          for m in (rpa_v, pdk_v, woq_v, moe_v, quant_v)) + ")", flush=True)

    cur = {}   # the wrapper modules of the version in use
    for lib_name in names:   # kernels that both builds hold
        fa, fb = (sass(_build, _build.library_path(lib_name, c.resolve()))
                  for c in (args.a, args.b))
        for name in sorted(set(fa) & set(fb)):
            print(f"[ab] {lib_name} SASS {name[:80]}: "
                  + ("identical in A and B" if fa[name] == fb[name] else
                     f"differs in A and B ({len(fa[name])} and {len(fb[name])} lines)"),
                  flush=True)
        for name in sorted(set(fa) - set(fb)):   # renamed, e.g. a template parameter gone
            same = [n for n in sorted(set(fb) - set(fa)) if fb[n] == fa[name]]
            print(f"[ab] {lib_name} SASS {name[:80]}: only in A"
                  + (f"; identical to B's {same[0][:80]}" if same else ""), flush=True)

    def use(tag):
        cur["rpa"], cur["pdk"], cur["woq"], cur["moe"] = versions[tag][:4]
        cur["quant"] = versions[tag][6]
        adam._kernel = lambda: versions[tag][5]

    gen = torch.Generator(device="cuda").manual_seed(1)
    unmasked = lambda cases: {name: case for name, case in cases.items()
                              if not cs.case_masks(torch, case)}
    waves = {name: cs.wave_case(torch, build_wave, WaveEntry, *cs.case_options(case)[:5], gen,
                                cs.case_options(case)[5])[:2]
             for name, case in unmasked(cs.WAVE_CASES).items()} if has_paged else {}
    decodes = {name: cs.decode_case(torch, *cs.case_options(case)[:5], gen,
                                    cs.case_options(case)[5])[0]
               for name, case in unmasked(cs.DECODE_CASES).items()} if has_paged else {}
    flashes = {}
    if has_flash:
        for name in cs.FLASH_TIMED:
            B, Sq, Sk, H, kvH, D, mask = cs.FLASH_CASES[name]
            (q, k, v, do, dlse, spec), _ = cs.flash_case(torch, flash, B, Sq, Sk, H, kvH, D,
                                                         mask, torch.bfloat16, gen)
            o, lse = flash.flash_fwd_reference(q, k, v, spec=spec)
            flashes[name] = (q, k, v, o, lse, do, spec)
    woqs = {f"{name}-M{M}": cs.woq_inputs(torch, M, K, N, gs, torch.bfloat16, gen)
            for name, (K, N, gs) in cs.WOQ_CASES.items() for M in cs.WOQ_ROWS} if has_woq else {}
    ffns = {}
    if has_moe:
        w = cs.moe_weights(torch, cs.MOE_E, cs.MOE_H, cs.MOE_F, "silu_gated", torch.bfloat16,
                           gen)
        wg, wu, wo = cs.moe_ffn_args(w, "silu_gated")
        for T in (cs.MOE_DECODE_T, cs.MOE_WAVE_T):
            tokens = torch.randn(T, cs.MOE_H, generator=gen, device="cuda").to(torch.bfloat16)
            src, slot_w, *_ = moe.moe_route_reference((tokens @ w["gate"]).float(),
                                                      top_k=cs.MOE_K, capacity=T)
            p3 = moe.moe_dispatch_gather_reference(tokens, src).view(cs.MOE_E, T, cs.MOE_H)
            ffns[f"T{T}"] = (p3, wg, wu, wo, src, slot_w, T)
    adam_fns = {}
    if has_adam:
        sizes, mode, mdt = cs.ADAM_CASES[cs.MAIN_ADAM]
        m_dtype = getattr(torch, mdt)
        bucket = cs.adam_bucket(torch, sizes, m_dtype, gen)   # grads, master, moments
        gscale = torch.full((), 0.37, dtype=torch.float32, device="cuda")
        bcd1, bcd2 = adam._bias_corrections(5, 0.9, 0.999)
        kw = dict(lr=3e-4, weight_decay=0.1, mode=mode, m_dtype=m_dtype, v_dtype=m_dtype,
                  param_dtype=torch.bfloat16, seed_m=adam.sr_seed(5, 1, 0),
                  seed_v=adam.sr_seed(5, 2, 0))
        adam_fns["kernel"] = lambda: adam.adam_bucket_update(*bucket, step=5,
                                                             grad_scale=gscale, **kw)
        adam_fns["plain"] = lambda: adam.adam_bucket_reference(
            *bucket, bcd1=bcd1, bcd2=bcd2, gscale=gscale, beta1=0.9, beta2=0.999, eps=1e-8,
            sr=True, **kw)
        p32 = torch.nn.Parameter(bucket[1].clone())
        p32.grad = bucket[0].float()
        opt = torch.optim.AdamW([p32], lr=3e-4, weight_decay=0.1, fused=True)
        opt.step()   # creates its state
        adam_fns["library"] = opt.step
    routes = {}   # T -> (tokens, bf16 logits, src of the plain route)
    if has_route:
        w = cs.moe_weights(torch, cs.MOE_E, cs.MOE_H, cs.MOE_F, "silu_gated", torch.bfloat16,
                           gen)
        gate = w["gate"]
        for T in ROUTE_TOKENS:
            tokens = torch.randn(T, cs.MOE_H, generator=gen, device="cuda").to(torch.bfloat16)
            logits = tokens @ gate
            src = moe.moe_route_reference(logits.float(), top_k=cs.MOE_K, capacity=T)[0]
            routes[T] = (tokens, logits, src)
        for tag in versions:
            mv = versions[tag][3]
            bf16_in = takes_bf16_logits(mv)
            fwd = mv.make_moe_forward(top_k=cs.MOE_K, capacity=cs.MOE_DECODE_T,
                                      activation="silu_gated",
                                      **({"with_aux": False} if "with_aux" in inspect.signature(
                                          mv.make_moe_forward).parameters else {}))
            x = routes[cs.MOE_DECODE_T][0]
            print(f"[ab] {tag} MoE forward at T {cs.MOE_DECODE_T} as serving builds it: "
                  f"{cs.device_ops(torch, lambda: fwd(w, x))} device operations a call "
                  f"(router logits {'bf16' if bf16_in else 'cast to fp32'})", flush=True)

    # drawn after every other group's inputs, so theirs stay as they were
    quants = {name: cs.quant_inputs(torch, case, gen)
              for name, case in cs.QUANT_CASES.items()} if has_quant else {}
    combines = {}   # T -> (y, slot_tk, w_tk, its int64 slot table)
    pair = None     # the split FFN's inputs at T 512 and its route's slot table
    if has_combine:
        gate = (torch.randn(cs.MOE_H, cs.MOE_E, generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        for T in COMBINE_TOKENS:
            tokens = torch.randn(T, cs.MOE_H, generator=gen, device="cuda").to(torch.bfloat16)
            _, _, slot_tk, w_tk, _, _ = moe.moe_route_reference((tokens @ gate).float(),
                                                                top_k=cs.MOE_K, capacity=T)
            y = torch.randn(cs.MOE_E * T, cs.MOE_H, generator=gen, device="cuda")
            combines[T] = (y, slot_tk, w_tk, slot_tk.long())
        if has_pair:
            w = cs.moe_weights(torch, cs.MOE_E, cs.MOE_H, cs.MOE_F, "silu_gated",
                               torch.bfloat16, gen)
            T = cs.MOE_WAVE_T
            tokens = torch.randn(T, cs.MOE_H, generator=gen, device="cuda").to(torch.bfloat16)
            src, _, slot_tk, w_tk, _, _ = moe.moe_route_reference(
                (tokens @ w["gate"]).float(), top_k=cs.MOE_K, capacity=T)
            p3 = moe.moe_dispatch_gather_reference(tokens, src).view(cs.MOE_E, T, cs.MOE_H)
            pair = (p3, *cs.moe_ffn_args(w, "silu_gated"), src, slot_tk, w_tk)

    gathers8 = {}   # case name -> (tokens, src, its int64 row indices)
    if has_g8:
        gate = torch.randn(cs.MOE_H, cs.MOE_E, generator=gen, device="cuda") * 0.02
        for T, dt in GATHER_INT8_CASES:
            tokens = torch.randn(T, cs.MOE_H, generator=gen, device="cuda").to(getattr(torch, dt))
            src = moe.moe_route_reference(tokens.float() @ gate, top_k=cs.MOE_K, capacity=T)[0]
            gathers8[f"T{T}-{dt}"] = (tokens, src, (src.long() - 1).clamp_min(0))

    def pair_call():
        p3, wg, wu, wo, src, slot_tk, w_tk = pair
        y = cur["moe"].moe_ffn(p3, wg, wu, wo, src, activation="silu_gated")
        return cur["moe"].moe_combine(y.view(-1, cs.MOE_H), slot_tk, w_tk)

    def combine_cells():
        bag = torch.nn.functional.embedding_bag
        cells = []
        for T, (y, slot_tk, w_tk, slot_l) in combines.items():
            cells.append(f"combine/T{T} {cs.device_ms(torch, lambda: cur['moe'].moe_combine(y, slot_tk, w_tk), 20, flush)[0]:.4f}")
            cells.append(f"embedding_bag/T{T} {cs.device_ms(torch, lambda: bag(slot_l, y, per_sample_weights=w_tk, mode='sum'), 20, flush)[0]:.4f}")
        if pair is not None:
            cells.append(f"ffn_combine/T{cs.MOE_WAVE_T} {cs.device_ms(torch, pair_call, 10, flush)[0]:.4f}")
        return cells

    def route_cells():
        mv = cur["moe"]
        bf16_in = takes_bf16_logits(mv)
        timed = lambda name, fn: f"{name} {cs.device_ms(torch, fn, 20, flush)[0]:.4f}"
        route = lambda lg, T: mv.moe_route(lg, top_k=cs.MOE_K, capacity=T)
        cells = []
        for T, (tokens, logits, src) in routes.items():
            f32 = logits.float()
            cells.append(timed(f"route/T{T}", lambda: route(f32, T)))
            if bf16_in:
                cells.append(timed(f"route_bf16/T{T}", lambda: route(logits, T)))
            cells.append(timed(f"gather/T{T}", lambda: mv.moe_dispatch_gather(tokens, src)))
            # as the forward calls them: a version without bf16 routes casts first
            cells.append(timed(f"pair/T{T}", lambda: mv.moe_dispatch_gather(
                tokens, route(logits if bf16_in else logits.float(), T)[0])))
            # and after the router product, which the route follows in the forward
            chain = lambda: mv.moe_dispatch_gather(tokens, route(
                tokens @ gate if bf16_in else (tokens @ gate).float(), T)[0])
            cells.append(timed(f"chain/T{T}", chain))
        return cells

    fused = lambda p3, wg, wu, wo, src, slot_w, T: cur["moe"].moe_ffn_combine(
        p3, wg, wu, wo, src, slot_w, T, activation="silu_gated")
    split = lambda p3, wg, wu, wo, src, slot_w, T: cur["moe"].moe_ffn(
        p3, wg, wu, wo, src, activation="silu_gated")
    flash_a = {}
    for tag in versions:
        use(tag)
        for name, (a, n) in waves.items():
            want = rpa.ragged_paged_attention_reference(*a)
            cs.check_close(f"{tag} ragged/{name}", cur["rpa"].ragged_paged_attention(*a)[:n],
                           want[:n])
        for name, a in decodes.items():
            cs.check_close(f"{tag} decode/{name}", cur["pdk"].paged_gqa_decode(*a),
                           paged_decode_attention_reference(*a))
        for name, a in woqs.items():
            got, again = cur["woq"].woq_matmul(*a), cur["woq"].woq_matmul(*a)
            cs.check_close(f"{tag} woq/{name}", got, woq.woq_matmul_reference(*a))
            if not torch.equal(got, again):
                cs.fail(f"{tag} woq/{name}: two runs differ")
        for name, (p3, wg, wu, wo, src, slot_w, T) in ffns.items():
            cs.check_close(f"{tag} moe_ffn_combine/{name}", fused(p3, wg, wu, wo, src, slot_w, T),
                           moe.moe_ffn_combine_reference(p3, wg, wu, wo, src, slot_w, T,
                                                         activation="silu_gated"),
                           cs.MOE_BF16_TOL)
            cs.check_close(f"{tag} moe_ffn/{name}", split(p3, wg, wu, wo, src, slot_w, T),
                           moe.moe_ffn_reference(p3, wg, wu, wo, src, activation="silu_gated"),
                           cs.MOE_BF16_TOL)
        fwd_out = {}
        for name, (q, k, v, o, lse, do, spec) in flashes.items():
            fwd, bwd = versions[tag][4]
            fwd_out[name] = fwd(q, k, v, spec)
            for x, want, what in zip((*fwd_out[name], *bwd(q, k, v, o, lse, do, None, spec)),
                                     (o, lse, *flash.flash_bwd_reference(q, k, v, o, lse, do,
                                                                         spec=spec)),
                                     ("O", "LSE", "dQ", "dK", "dV")):
                cs.check_close(f"{tag} flash/{name} {what}", x, want)
            if same_fwd and tag == "B" and not all(bool(torch.equal(x, y)) for x, y in
                                                   zip(fwd_out[name], flash_a[name])):
                cs.fail(f"flash/{name}: the forwards of A and B give different bits")
        flash_a = fwd_out
        for T, (tokens, logits, src) in routes.items():
            for lg in (logits.float(),) + ((logits,) if takes_bf16_logits(cur["moe"]) else ()):
                cs.moe_route_vs_plain(torch, cur["moe"], lg, cs.MOE_K, T,
                                      f"{tag} T{T} {str(lg.dtype)[6:]} logits")
            got = cur["moe"].moe_dispatch_gather(tokens, src)
            again = cur["moe"].moe_dispatch_gather(tokens, src)
            want = tokens.index_select(0, (src.long() - 1).clamp_min(0))
            if not (torch.equal(got.view(torch.int16), want.view(torch.int16))
                    and torch.equal(got.view(torch.int16), again.view(torch.int16))):
                cs.fail(f"{tag} gather T{T}: not byte-identical to index_select on two runs")
        for name, x in quants.items():
            q, sc = cur["quant"].quantize_rows_int8(x)
            qp, sp = quant.quantize_rows_int8_reference(x)
            if not (torch.equal(q, qp) and torch.equal(sc.view(torch.int32), sp.view(torch.int32))):
                cs.fail(f"{tag} quant/{name}: q / scale differ from the plain version")
        for T, (y, slot_tk, w_tk, _) in combines.items():
            got = cur["moe"].moe_combine(y, slot_tk, w_tk)
            want = moe.moe_combine_reference(y, slot_tk, w_tk)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                cs.fail(f"{tag} combine/T{T}: not bitwise its plain version")
        if pair is not None:
            p3, wg, wu, wo, src, slot_tk, w_tk = pair
            y = moe.moe_ffn_reference(p3, wg, wu, wo, src, activation="silu_gated")
            cs.check_close(f"{tag} ffn_combine/T{cs.MOE_WAVE_T}", pair_call(),
                           moe.moe_combine_reference(y.view(-1, cs.MOE_H), slot_tk, w_tk),
                           cs.MOE_BF16_TOL)
        for name, (tokens, src, _) in gathers8.items():
            for mask in (False, True):
                q, sc = cur["moe"].moe_dispatch_gather_int8(tokens, src, mask_pad=mask)
                q2, s2 = cur["moe"].moe_dispatch_gather_int8(tokens, src, mask_pad=mask)
                rows = moe.moe_dispatch_gather_reference(tokens, src)
                if mask:
                    rows = torch.where((src > 0)[:, None], rows, torch.zeros_like(rows))
                for want_q, want_s, what in (
                        (q2, s2, "a second run"),
                        (*moe.moe_dispatch_gather_int8_reference(tokens, src, mask_pad=mask),
                         "the plain version"),
                        (*cur["quant"].quantize_rows_int8(rows),
                         "quantize_rows_int8 of the gathered rows")):
                    if not (torch.equal(q, want_q)
                            and torch.equal(sc.view(torch.int32), want_s.view(torch.int32))):
                        cs.fail(f"{tag} gather_int8/{name} mask_pad {mask}: q / scale differ "
                                f"from {what}")
        if has_adam:
            got, want = adam_fns["kernel"](), adam_fns["plain"]()
            if not (torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])):
                cs.fail(f"{tag} adam/{cs.MAIN_ADAM}: moments differ from the plain version")
        print(f"[ab] {tag} agrees with the plain versions (bf16, {cs.BF16_TOL}; the "
              f"grouped FFN {cs.MOE_BF16_TOL})", flush=True)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for tag in ["A", "B", "B", "A"] * args.rounds:
        use(tag)
        cells = [f"ragged/{name} {cs.device_ms(torch, lambda: cur['rpa'].ragged_paged_attention(*a), 20, flush)[0]:.4f}"
                 for name, (a, _) in waves.items()]
        cells += [f"decode/{name} {cs.device_ms(torch, lambda: cur['pdk'].paged_gqa_decode(*a), 20, flush)[0]:.4f}"
                  for name, a in decodes.items()]
        cells += [f"woq/{name} {cs.device_ms(torch, lambda: cur['woq'].woq_matmul(*a), 20, flush)[0]:.4f}"
                  for name, a in woqs.items()]
        cells += [f"{form}/{name} {cs.device_ms(torch, lambda: fn(*a), 5, flush)[0]:.4f}"
                  for name, a in ffns.items()
                  for form, fn in (("moe_ffn_combine", fused), ("moe_ffn", split))]
        for name, (q, k, v, o, lse, do, spec) in flashes.items():
            fwd, bwd = versions[tag][4]
            cells += [f"flash_bwd/{name} {cs.device_ms(torch, lambda: bwd(q, k, v, o, lse, do, None, spec), 10, flush)[0]:.4f}",
                      f"flash_fwd/{name} {cs.device_ms(torch, lambda: fwd(q, k, v, spec), 10, flush)[0]:.4f}"]
        if has_adam:
            cells += [f"adam/{name} {cs.device_ms(torch, adam_fns[name], 20, flush)[0]:.4f}"
                      for name in ("kernel", "library")]
        cells += route_cells() if has_route else []
        cells += [f"quant/{name} {cs.device_ms(torch, lambda: cur['quant'].quantize_rows_int8(x), 20, flush)[0]:.4f}"
                  for name, x in quants.items()]
        # context: an elementwise cast moves the same bytes (scales aside)
        cells += [f"int8_cast/{name} {cs.device_ms(torch, lambda: x.to(torch.int8), 20, flush)[0]:.4f}"
                  for name, x in quants.items() if x.numel() >= 1 << 22]
        cells += combine_cells()
        for name, (tokens, src, idx) in gathers8.items():
            cells.append(f"gather_int8/{name} {cs.device_ms(torch, lambda: cur['moe'].moe_dispatch_gather_int8(tokens, src, mask_pad=True), 20, flush)[0]:.4f}")
            cells.append(f"index_select/{name} {cs.device_ms(torch, lambda: tokens.index_select(0, idx), 20, flush)[0]:.4f}")
        print(f"[ab] {tag} ms: " + " | ".join(cells), flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
