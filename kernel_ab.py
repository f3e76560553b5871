#!/usr/bin/env python3
"""Interleaved A/B of two versions of the port's CUDA kernel sources on one GPU.

    python3 kernel_ab.py A_CSRC_DIR B_CSRC_DIR [--rounds N]

Builds both source directories' kernels with the package's own ``nvcc``
flags (``deepspeed_tpu_torch/ops/op_builder/builder.py``), holds each
version against the plain PyTorch versions in bf16 at every kernel case of
``chip_smoke.py``, then times both at those cases in the order A, B, B, A
(``--rounds`` times), one line per pass, so the two are compared on one
card within one run. The weight-only-quantized matmul joins in (at the
``WOQ_CASES`` x ``WOQ_ROWS`` of ``chip_smoke.py``) when both directories
hold its source, and so does the grouped expert FFN (``moe_ffn.cu``: both
forms at mixtral-8x7b's widths, a decode step of T = 8 and a prefill wave
of T = 512 dropless tokens, routed by the plain route on the card), and so
does flash attention (``flash_bwd.cu``: the whole backward through
``flash.flash_bwd``, di and both launches, and the forward, at the
``FLASH_TIMED`` shapes; a version whose ``FlashParams`` has no ``dlse``
computes di in PyTorch before its launches, as its wrapper did, and the
two versions' forwards must give the same bits). ``--only`` names the
groups to run (``paged``, ``woq``, ``moe_ffn``, ``flash``). A tile-shape
sweep point is a copy of ``csrc`` with one constant edited, passed as B
against the unedited ``csrc`` as A. To compare a change with its parent,
unpack the parent's ``deepspeed_tpu_torch/csrc`` with ``git archive`` into
a directory that ``.gitignore`` lists and pass it as A. Exits non-zero without a GPU or
when a version disagrees with the plain versions.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import chip_smoke as cs


def flash_version(flash, csrc, lib):
    """(forward, backward) of the flash kernels built from ``csrc``, called
    as ``flash.flash_fwd`` / ``flash.flash_bwd`` are. A version whose
    ``FlashParams`` has no ``dlse`` member gets the struct it was built
    with and its wrapper's di: rowsum(dO * O) - dLSE in PyTorch before the
    two launches."""
    fwd_lib, bwd_lib = lib("flash_fwd"), lib("flash_bwd")
    header = (csrc / "flash_common.cuh").read_text()
    if "dlse;" in header[header.index("struct FlashParams"):]:
        fns = flash.bind(fwd_lib, bwd_lib)

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

    import torch
    from deepspeed_tpu_torch.ops.op_builder.builder import launch_check

    class Params(ctypes.Structure):
        _fields_ = [f for f in flash.FlashParams._fields_ if f[0] != "dlse"]
    fwd_fn, dq_fn, dkv_fn = (fwd_lib.dstt_flash_fwd, bwd_lib.dstt_flash_dq,
                             bwd_lib.dstt_flash_dkv)
    for fn in (fwd_fn, dq_fn, dkv_fn):
        fn.argtypes = [Params, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def params(q, k, v, spec):
        base = flash._params(q, k, v, spec)
        return Params(**{n: getattr(base, n) for n, _ in Params._fields_})

    def fwd(q, k, v, spec):
        q, k, v = flash._rows(q), flash._rows(k), flash._rows(v)
        B, Sq, H, D = q.shape
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        p = params(q, k, v, spec)
        p.out0, p.out1 = out.data_ptr(), lse.data_ptr()
        launch_check(fwd_fn(p, int(q.dtype == torch.bfloat16), flash._stream(q)), "flash_fwd")
        return out, lse

    def bwd(q, k, v, o, lse, do, dlse, spec):
        q, k, v = flash._rows(q), flash._rows(k), flash._rows(v)
        o = o.contiguous()
        do = do.to(q.dtype).contiguous()
        di = (do.float() * o.float()).sum(-1).transpose(1, 2)
        if dlse is not None:
            di = di - dlse.float()
        di = di.contiguous()
        lse = lse.float().contiguous()
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty_like(dk)
        p = params(q, k, v, spec)
        p.o, p.dout, p.lse, p.di = o.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr()
        bf16 = int(q.dtype == torch.bfloat16)
        p.out0 = dq.data_ptr()
        launch_check(dq_fn(p, bf16, flash._stream(q)), "flash_dq")
        p.out0, p.out1 = dk.data_ptr(), dv.data_ptr()
        launch_check(dkv_fn(p, bf16, flash._stream(q)), "flash_dkv")
        return dq, dk, dv
    return fwd, bwd


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", default="paged,woq,moe_ffn,flash",
                    help="comma-separated groups: paged, woq, moe_ffn, flash")
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
    from deepspeed_tpu_torch.ops.quantizer import woq_matmul as woq
    from deepspeed_tpu_torch.ops.transformer import moe

    from deepspeed_tpu_torch.ops.transformer import flash

    both = lambda src: all((d / src).exists() for d in (args.a, args.b))
    has_paged = "paged" in only
    has_woq = "woq" in only and both("woq_matmul.cu")
    has_moe = "moe_ffn" in only and both("moe_ffn.cu")
    has_flash = "flash" in only and both("flash_bwd.cu")
    names = ((("ragged_paged_attention", "paged_decode") if has_paged else ())
             + (("woq_matmul",) if has_woq else ()) + (("moe_ffn",) if has_moe else ())
             + (("flash_fwd", "flash_bwd") if has_flash else ()))
    versions = {}
    for tag, csrc in (("A", args.a), ("B", args.b)):
        csrc = csrc.resolve()
        _build.build(names, csrc=csrc)
        lib = lambda name: ctypes.CDLL(str(_build.library_path(name, csrc)))
        versions[tag] = (rpa.bind(lib("ragged_paged_attention")) if has_paged else None,
                         pdk.bind(lib("paged_decode")) if has_paged else None,
                         woq.bind(lib("woq_matmul")) if has_woq else None,
                         moe.bind_ffn(lib("moe_ffn")) if has_moe else None,
                         flash_version(flash, csrc, lib) if has_flash else None)
        print(f"[ab] {tag} = {csrc}", flush=True)

    def use(tag):
        rpa._kernel = lambda: versions[tag][0]
        pdk._kernel = lambda: versions[tag][1]
        woq._kernel = lambda: versions[tag][2]
        moe._ffn_kernel = lambda: versions[tag][3]

    gen = torch.Generator(device="cuda").manual_seed(1)
    waves = {name: cs.wave_case(torch, build_wave, WaveEntry, seqs, kvH, g, D,
                                cs.PAGE_SIZE, gen)[:2]
             for name, (seqs, kvH, g, D) in cs.WAVE_CASES.items()} if has_paged else {}
    decodes = {name: cs.decode_case(torch, ctxs, kvH, g, D, cs.PAGE_SIZE, gen)[0]
               for name, (ctxs, kvH, g, D) in cs.DECODE_CASES.items()} if has_paged else {}
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
    fused = lambda p3, wg, wu, wo, src, slot_w, T: moe.moe_ffn_combine(
        p3, wg, wu, wo, src, slot_w, T, activation="silu_gated")
    split = lambda p3, wg, wu, wo, src, slot_w, T: moe.moe_ffn(
        p3, wg, wu, wo, src, activation="silu_gated")
    flash_a = {}
    for tag in versions:
        use(tag)
        for name, (a, n) in waves.items():
            want = rpa.ragged_paged_attention_reference(*a)
            cs.check_close(f"{tag} ragged/{name}", rpa.ragged_paged_attention(*a)[:n],
                           want[:n])
        for name, a in decodes.items():
            cs.check_close(f"{tag} decode/{name}", pdk.paged_gqa_decode(*a),
                           paged_decode_attention_reference(*a))
        for name, a in woqs.items():
            cs.check_close(f"{tag} woq/{name}", woq.woq_matmul(*a),
                           woq.woq_matmul_reference(*a))
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
            if tag == "B" and not all(bool(torch.equal(x, y))
                                      for x, y in zip(fwd_out[name], flash_a[name])):
                cs.fail(f"flash/{name}: the forwards of A and B give different bits")
        flash_a = fwd_out
        print(f"[ab] {tag} agrees with the plain versions (bf16, {cs.BF16_TOL}; the "
              f"grouped FFN {cs.MOE_BF16_TOL})", flush=True)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for tag in ["A", "B", "B", "A"] * args.rounds:
        use(tag)
        cells = [f"ragged/{name} {cs.device_ms(torch, lambda: rpa.ragged_paged_attention(*a), 20, flush)[0]:.4f}"
                 for name, (a, _) in waves.items()]
        cells += [f"decode/{name} {cs.device_ms(torch, lambda: pdk.paged_gqa_decode(*a), 20, flush)[0]:.4f}"
                  for name, a in decodes.items()]
        cells += [f"woq/{name} {cs.device_ms(torch, lambda: woq.woq_matmul(*a), 20, flush)[0]:.4f}"
                  for name, a in woqs.items()]
        cells += [f"{form}/{name} {cs.device_ms(torch, lambda: fn(*a), 5, flush)[0]:.4f}"
                  for name, a in ffns.items()
                  for form, fn in (("moe_ffn_combine", fused), ("moe_ffn", split))]
        for name, (q, k, v, o, lse, do, spec) in flashes.items():
            fwd, bwd = versions[tag][4]
            cells += [f"flash_bwd/{name} {cs.device_ms(torch, lambda: bwd(q, k, v, o, lse, do, None, spec), 10, flush)[0]:.4f}",
                      f"flash_fwd/{name} {cs.device_ms(torch, lambda: fwd(q, k, v, spec), 10, flush)[0]:.4f}"]
        print(f"[ab] {tag} ms: " + " | ".join(cells), flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
