"""Weight-only quantized inference (int8 / int4).

Counterpart of ``deepspeed_tpu/inference/quantization/quantization.py``:
weights live in device memory at 8 or 4 bits and are expanded inside the
matmul, halving or quartering the weight bytes that bound decode.

SYMMETRIC groupwise quantization over the contraction dim, in the JAX
package's storage layout. A quantized kernel is the pair ``q`` /
``scale`` in place of a dense ``[in, out]`` kernel:

    q      int8  [..., G, gs, out]          (int8)
           uint8 [..., G, gs / 2, out]      (int4: two bias-8 nibbles a byte
                                             along gs, low nibble first)
    scale  fp32  [..., G, 1, out]

with ``in = G * gs`` and ``out`` contiguous. The matmul factors the scale
out of each group's contraction, ``y = sum_g (x_g @ q_g) * scale[g]``, so
no dense copy of the kernel is kept.

``quantized_matmul`` dispatches on shape and type, as the JAX function
does: int8 storage with bf16 or fp32 activations and at most
``WOQ_KERNEL_MAX_ROWS`` rows goes to ``ops/quantizer/woq_matmul.py`` (the
hand-written kernel on a GPU, its plain version on the CPU); more rows, and
packed int4 at any row count, take the non-kernel form: the leaf is
dequantized into scratch, a chunk of groups at a time, and multiplied by
``torch.matmul``.

The port's ``Linear.weight`` is ``[out, in]``; the functions here keep the
JAX ``[in, out]`` kernel layout, and ``quantize_param_tree`` /
``dequantize_param_tree`` transpose at the boundary of a state dict.

Left out: ``quantize_specs`` and the sharding half of ``quantize_placed``
(partition specs of a quantized tree over a device mesh) have no meaning on
one device; the engine quantizes a placed model leaf by leaf instead
(``inference/v2/engine_v2.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.quantizer.woq_matmul import woq_matmul

# block-tree kernel names eligible for WOQ (projections; embeddings and norms
# are excluded)
DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "fc_in", "fc_out",
                   "gate_proj", "up_proj", "down_proj", "lm_head")

#: most activation rows the WOQ kernel takes; above it the non-kernel form
#: is faster. Set from the row sweep of ``chip_smoke.py`` on an H100 (PERF.md).
WOQ_KERNEL_MAX_ROWS = 64

#: the non-kernel form dequantizes at most this many weight elements at a time
_DEQUANT_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """'int8' | 'int4', groupwise over in-features."""
    bits: int = 8               # 8 | 4
    group_size: int = 128       # contraction elements sharing one scale
    targets: Sequence[str] = DEFAULT_TARGETS

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"weight-only quantization supports 4 or 8 bits, "
                             f"got {self.bits}")
        if self.group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {self.group_size}")

    @staticmethod
    def from_mode(mode) -> Optional["QuantizationConfig"]:
        if mode in (None, "none", False):
            return None
        if isinstance(mode, QuantizationConfig):
            return mode
        table = {"int8": 8, "wint8": 8, "int4": 4, "wint4": 4}
        if mode not in table:
            raise ValueError(f"unknown quantization_mode {mode!r} "
                             f"(supported: {sorted(table)})")
        return QuantizationConfig(bits=table[mode])


def _group_size(cfg: QuantizationConfig, d_in: int) -> int:
    """The configured group size, halved until it divides ``d_in``."""
    gs = min(cfg.group_size, d_in)
    while d_in % gs:
        gs //= 2
    return gs


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], ``[..., G, gs, out]`` -> biased nibbles packed
    two a byte along gs: uint8 ``[..., G, gs / 2, out]``."""
    b = (q + 8).to(torch.uint8)
    return b[..., 0::2, :] | (b[..., 1::2, :] << 4)


def _unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., G, gs / 2, out]`` -> int8 ``[..., G, gs, out]``."""
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    *lead, G, gsp, d_out = p.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, G, 2 * gsp, d_out)


def quantize_kernel(kernel: torch.Tensor, cfg: QuantizationConfig) -> Dict[str, torch.Tensor]:
    """``[..., in, out]`` -> ``{"q": int [..., G, gs, out], "scale": fp32
    [..., G, 1, out]}`` on the kernel's device. Leading dims pass through.
    int4 with an odd group size degrades to int8 storage."""
    *lead, d_in, d_out = kernel.shape
    gs = _group_size(cfg, d_in)
    G = d_in // gs
    # contiguous: a transposed ``Linear.weight`` would hand its strides on to q
    w = kernel.to(torch.float32).reshape(*lead, G, gs, d_out).contiguous()
    qmax = float(2 ** (cfg.bits - 1) - 1)
    absmax = w.abs().amax(dim=-2, keepdim=True)             # [..., G, 1, out]
    scale = absmax.clamp_min(1e-12) / qmax
    q = torch.round(w / scale).clamp_(-qmax - 1, qmax).to(torch.int8)
    if cfg.bits == 4 and gs % 2 == 0:
        q = _pack_int4(q)
    return {"q": q, "scale": scale}


def host_quantize_kernel(kernel, cfg: QuantizationConfig, model_dtype: torch.dtype,
                         slab_elems: int = 1 << 27) -> Tuple[np.ndarray, np.ndarray]:
    """``quantize_kernel`` in numpy on the host, bit for bit: ``kernel`` (a
    numpy array or a CPU tensor, ``[..., in, out]``) is cast to the model
    dtype first (the dense path would serve those bits), then fp32 group
    math with round-half-even. Returns ``(q, scale)`` as host arrays, so an
    engine uploads the int payload and never the dense kernel.

    Computes in slabs along the leading dim and of at most ``slab_elems``
    elements into preallocated outputs, which bounds the fp32 temporaries."""
    w = kernel if torch.is_tensor(kernel) else torch.from_numpy(np.asarray(kernel))
    *lead, d_in, d_out = w.shape
    gs = _group_size(cfg, d_in)
    G = d_in // gs
    qmax = np.float32(2 ** (cfg.bits - 1) - 1)
    pack4 = cfg.bits == 4 and gs % 2 == 0
    n_rows = math.prod(lead)
    wr = w.reshape(n_rows, G, gs, d_out)
    q = np.empty((n_rows, G, gs // 2 if pack4 else gs, d_out),
                 np.uint8 if pack4 else np.int8)
    scale = np.empty((n_rows, G, 1, d_out), np.float32)
    # slabs of whole groups: the group math never crosses a slab
    g_step = max(1, slab_elems // max(gs * d_out, 1))
    for r in range(n_rows):
        for g0 in range(0, G, g_step):
            g1 = min(g0 + g_step, G)
            # numpy has no bf16: the model-dtype rounding runs in torch
            c = wr[r, g0:g1].to(model_dtype).to(torch.float32).numpy()
            absmax = np.max(np.abs(c), axis=-2, keepdims=True)
            s = np.maximum(absmax, np.float32(1e-12)) / qmax
            qc = np.clip(np.rint(c / s), -qmax - 1, qmax).astype(np.int8)
            scale[r, g0:g1] = s
            if pack4:
                b = (qc + 8).astype(np.uint8)
                q[r, g0:g1] = b[..., 0::2, :] | (b[..., 1::2, :] << 4)
            else:
                q[r, g0:g1] = qc
    return (q.reshape(*lead, G, q.shape[-2], d_out),
            scale.reshape(*lead, G, 1, d_out))


def _stored_int8(qp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    q = qp["q"]
    return _unpack_int4(q) if q.dtype == torch.uint8 else q


def quantized_matmul(x: torch.Tensor, qp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``x [..., in] @`` quantized kernel ``-> [..., out]`` in ``x``'s dtype.

    Decode-shaped calls on int8 storage (see the module docstring) run
    ``woq_matmul``; the rest dequantize chunks of groups into scratch and
    accumulate ``torch.matmul`` products in fp32."""
    q, scale = qp["q"], qp["scale"]
    d_out = q.shape[-1]
    lead = x.shape[:-1]
    rows = math.prod(lead)
    x2 = x.reshape(rows, x.shape[-1])
    if (q.dtype == torch.int8 and q.dim() == 3 and rows <= WOQ_KERNEL_MAX_ROWS
            and x.dtype in (torch.bfloat16, torch.float32)):
        return woq_matmul(x2, q, scale).reshape(*lead, d_out)
    return dequant_matmul(x2, qp).reshape(*lead, d_out)


def dequant_matmul(x: torch.Tensor, qp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The non-kernel form, ``x [M, in] -> [M, out]``: chunks of groups are
    dequantized into scratch in ``x``'s dtype and multiplied by
    ``torch.matmul``, the chunks' products added in fp32. A leaf of up to
    ``_DEQUANT_CHUNK_ELEMS`` elements is one chunk and one product."""
    q, scale = _stored_int8(qp), qp["scale"]
    G, gs, d_out = q.shape
    gc = max(1, min(G, _DEQUANT_CHUNK_ELEMS // max(gs * d_out, 1)))
    w = torch.empty(gc, gs, d_out, dtype=x.dtype, device=x.device)
    if gc >= G:
        # one pass: the fp32 product q * scale, rounded once on the store
        torch.mul(q, scale, out=w)
        return torch.matmul(x, w.reshape(G * gs, d_out))
    acc = torch.zeros(x.shape[0], d_out, dtype=torch.float32, device=x.device)
    for g0 in range(0, G, gc):
        g1 = min(g0 + gc, G)
        torch.mul(q[g0:g1], scale[g0:g1], out=w[:g1 - g0])
        acc += torch.matmul(x[:, g0 * gs:g1 * gs], w[:g1 - g0].reshape(-1, d_out)).float()
    return acc.to(x.dtype)


def dequantize_kernel(qp: Mapping[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """The dense ``[..., in, out]`` kernel of a quantized pair."""
    q = _stored_int8(qp)
    *lead, G, gs, d_out = q.shape
    w = q.to(torch.float32) * qp["scale"]
    return w.reshape(*lead, G * gs, d_out).to(dtype)


def _targeted(name: str, cfg_targets: Sequence[str]) -> bool:
    return any(part in cfg_targets for part in name.split("."))


def quantize_param_tree(params: Mapping[str, torch.Tensor],
                        cfg: QuantizationConfig) -> Dict[str, torch.Tensor]:
    """A state dict with each targeted ``<layer>.weight`` (``[out, in]``)
    replaced by ``<layer>.q`` and ``<layer>.scale``; biases, norms and
    embeddings pass through."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        layer, _, leaf = name.rpartition(".")
        if leaf == "weight" and _targeted(layer, cfg.targets):
            qp = quantize_kernel(t.transpose(-1, -2), cfg)
            out[f"{layer}.q"], out[f"{layer}.scale"] = qp["q"], qp["scale"]
        else:
            out[name] = t
    return out


def dequantize_param_tree(params: Mapping[str, torch.Tensor],
                          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The inverse layout change: every ``<layer>.q`` / ``<layer>.scale``
    pair becomes a dense ``<layer>.weight`` (``[out, in]``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        layer, _, leaf = name.rpartition(".")
        if leaf == "q" and f"{layer}.scale" in params:
            w = dequantize_kernel({"q": t, "scale": params[f"{layer}.scale"]}, dtype)
            out[f"{layer}.weight"] = w.transpose(-1, -2).contiguous()
        elif not (leaf == "scale" and f"{layer}.q" in params):
            out[name] = t
    return out


def quantized_tree_bytes(params: Any) -> int:
    """Bytes of every tensor of a state dict (or a module's parameters and
    buffers): packed int4 is uint8, so plain itemsize accounting is exact."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return sum(t.numel() * t.element_size() for t in params.values())
