"""Layer library of the port.

Counterpart of ``deepspeed_tpu/nn/layers.py``. There every layer is a frozen
dataclass that initializes a params pytree and applies itself purely; here
every layer is an ``nn.Module`` that owns its parameters. Numerics follow
the JAX layers: norm statistics and rotary angles in fp32, the result cast
back to the input's dtype.

Layout difference: the JAX ``Linear`` stores its kernel ``[in, out]``; the
port's ``Linear.weight`` is ``[out, in]`` as ``torch.nn.functional.linear``
takes it (``deepspeed_tpu_torch/convert.py`` transposes). A weight-only-
quantized ``Linear`` keeps the JAX storage instead (``q [G, gs, out]``,
``scale [G, 1, out]``, out contiguous), the layout the WOQ matmul reads.

Every layer is built with explicit ``device`` and ``dtype``; on the ``meta``
device it holds no storage until ``to_empty`` gives it some, and
``reset_parameters(generator)`` then fills it from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

INIT_SCALE = 0.02


class Linear(nn.Module):
    """Dense layer ``y = x @ weight.T + bias`` with ``weight [out, in]``.

    In its weight-only-quantized form (``set_quantized`` / ``quantize_``)
    the buffers ``q`` (int8, or uint8 for packed int4) and ``scale`` (fp32)
    stand in place of ``weight``, and ``forward`` runs ``quantized_matmul``
    (``inference/quantization``); the bias is added after, as in the JAX
    layer."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device, dtype=dtype),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_features, device=device,
                                              dtype=dtype), requires_grad=False)
                     if bias else None)
        self.register_buffer("q", None)
        self.register_buffer("scale", None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        if self.weight is not None:
            self.weight.normal_(0.0, INIT_SCALE, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def set_quantized(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Take a quantized kernel (the ``quantize_kernel`` layout) in place
        of the dense weight, which is dropped."""
        G, rows, d_out = q.shape
        gs = 2 * rows if q.dtype == torch.uint8 else rows
        if G * gs != self.in_features or d_out != self.out_features \
                or tuple(scale.shape) != (G, 1, d_out):
            raise ValueError(f"quantized kernel q {tuple(q.shape)} {q.dtype} / scale "
                             f"{tuple(scale.shape)} does not fit a Linear of "
                             f"{self.in_features} -> {self.out_features}")
        self.weight = None
        self.q, self.scale = q, scale

    @torch.no_grad()
    def quantize_(self, cfg) -> None:
        """Quantize the dense weight where it lies and free it."""
        from ..inference.quantization.quantization import quantize_kernel
        qp = quantize_kernel(self.weight.detach().T, cfg)
        self.set_quantized(qp["q"], qp["scale"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        if self.q is not None:
            from ..inference.quantization.quantization import quantized_matmul
            y = quantized_matmul(x, {"q": self.q, "scale": self.scale})
            return y if bias is None else y + bias
        return F.linear(x, self.weight.to(x.dtype), bias)


class Embedding(nn.Module):
    """Token embedding with a CLAMPED lookup: ids outside ``[0, V)`` read
    the nearest valid row, as ``jnp.take(mode="clip")`` does."""

    def __init__(self, num_embeddings: int, features: int, device=None,
                 dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.weight = nn.Parameter(torch.empty(num_embeddings, features,
                                               device=device, dtype=dtype),
                                   requires_grad=False)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.normal_(0.0, INIT_SCALE, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.clamp(0, self.num_embeddings - 1), self.weight)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-unembedding logits ``x @ weight.T``."""
        return x @ self.weight.to(x.dtype).T


class LayerNorm(nn.Module):

    def __init__(self, features: int, eps: float = 1e-5, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device,
                                               dtype=dtype), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(features, device=device,
                                              dtype=dtype), requires_grad=False)
                     if bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """Llama pre-norm: fp32 statistics, then a cast back to x's dtype."""

    def __init__(self, features: int, eps: float = 1e-6, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device,
                                               dtype=dtype), requires_grad=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def rotary_tables(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """fp32 ``(cos, sin)`` of the rotary angles for ``positions [..., seq]``
    and a rotated width ``dim``, shaped ``[..., seq, 1, dim // 2]`` to
    broadcast over heads. A forward computes them once and every layer's
    ``apply_rotary`` reuses them."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[..., :, None].float() * freqs       # [..., seq, half]
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 style: str = "half") -> torch.Tensor:
    """Rotate ``x [..., seq, heads, head_dim]`` by ``rotary_tables``.
    ``style='half'`` pairs dim i with dim i+half (llama "rotate half");
    ``style='interleaved'`` pairs adjacent dims (2i, 2i+1)."""
    if style == "interleaved":
        x1, x2 = x[..., 0::2], x[..., 1::2]
        y = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return y.reshape(x.shape).to(x.dtype)
    if style != "half":
        raise ValueError(f"rope style must be 'half' or 'interleaved', got {style!r}")
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     theta: float = 10000.0, style: str = "half") -> torch.Tensor:
    """Rotary position embedding with fp32 angles (the JAX layer's
    signature). x: ``[..., seq, heads, head_dim]``; positions:
    ``[..., seq]``."""
    return apply_rotary(x, *rotary_tables(positions, x.shape[-1], theta), style)


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (the JAX layer's signature, the key replaced by an
    explicit ``torch.Generator`` on ``x``'s device): ``x`` itself when
    ``deterministic`` or ``rate == 0``, else each element kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, zero
    otherwise. The draws are the generator's, not JAX's."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
