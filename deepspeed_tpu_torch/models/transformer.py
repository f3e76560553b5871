"""Transformer of the port: the Llama family, Mixtral, the decoder families
of ``gpt2.py``, ``opt_phi_falcon.py`` and ``bloom_neox_gptj.py`` (learned,
rotary or ALiBi positions, sequential or parallel blocks with one norm or
two, an embedding norm, per-layer causal windows) and the encoders of
``bert.py`` (bidirectional, post-norm blocks, token-type embeddings,
RoBERTa's pad-based positions, the MLM head, padding masks).

Counterpart of ``deepspeed_tpu/models/transformer.py``. The JAX model is a
stateless description whose block parameters are stacked on a leading
layer axis and run under ``lax.scan``; here ``TransformerLM`` is an
``nn.Module`` holding one ``Block`` per layer in an ``nn.ModuleList``. The
per-block layer names (``ln_1``, ``q_proj`` ... ``down_proj``) are the JAX
block's keys, so ``convert.params_from_jax`` maps one tree onto the other
by name.

The overlap schedule of the data-parallel engine runs the blocks through
``scan_blocks_pipelined`` (JAX ``:506-750``): one step of layers at a time,
each step's parameters gathered a step ahead and its gradients reduced while
the step before it runs backward (``runtime/zero/overlap.py``).

A model is built on the ``meta`` device by default: it holds no storage
until ``materialize`` (or the serving engine) places it on a device and
fills it from a ``torch.Generator``.

``forward`` is the plain full-sequence causal forward. Serving does not run
it: tests and ``chip_smoke.py`` hold the serving path's logits against it.

The training half is ``apply`` (logits through the flash attention of
``ops/transformer/attention.py``, each block under the config's remat
policy, ``runtime/activation_checkpointing/checkpointing.py``),
``derive_labels``, ``head_loss`` and ``loss``
(``models/transformer.py:757-882``), with ``masked_cross_entropy``. An
``attention_mask [B, S]`` (1 = a real token) goes to the flash kernels as
int32 segment ids, so pad rows attend among pads, as in JAX.

A block of a ``moe`` configuration holds a ``MoE`` (``moe/layer.py``) in
place of its MLP, in every layer, as the JAX block does
(``models/transformer.py:259-275``), whatever ``moe_layer_freq`` says, as
the JAX model never reads it; ``forward(..., dropless=True)`` routes it
with capacity = the token count, the function the serving engine
computes. In training every block returns ``(x, aux)`` (a dense block's
aux is 0): ``apply`` sums ``keep * aux`` over the layers as the JAX scan
carries it, and ``loss``
adds ``aux_loss_coef * aux / num_layers`` (``combine_aux``).

A parallel block (Phi, Falcon, GPT-NeoX, GPT-J) adds attention and MLP to
the block's input, both read through ``ln_1`` or, with ``parallel_norms``,
the MLP through its own ``ln_2``; without ``parallel_norms`` the block has
no ``ln_2``, as the JAX block has none (``models/transformer.py:254-258``),
so the state dict's keys stay the JAX tree's. ALiBi slopes and the
per-layer windows are normalized once, as the JAX model does
(``:202-231``), and go to the flash kernels with every call.

A post-norm block (BERT) applies its norms after each residual add and
mixes the PLD gate outside them (``keep * y + (1 - keep) * x``); a post-norm
model has no ``ln_f``. The MLM head is dense -> activation -> LN -> the tied
decoder plus ``mlm.bias``.

The plain serving ``forward`` is causal-only: an encoder raises
``ValueError``, as the JAX serving model does.

Sequence parallelism (``seq_parallel``, read where the published topology
has a ``seq`` axis above 1, ``runtime/topology.py``): ``apply`` then takes
this rank's slice of the sequence, its positions starting at the slice's
offset (rotary and learned; RoBERTa's pad-based positions count the real
tokens of the earlier slices), and each block's attention is
``ulysses_attention`` (``sequence/layer.py``) or ``ring_attention``
(``sequence/ring_attention.py``), the JAX dispatch (``:374-387``) with its
``ValueError`` s: ring is causal-only, without windows, ALiBi or a padding
mask.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..moe.layer import MoE
from ..nn import layers as L
from ..ops.transformer.attention import alibi_slopes, flash_attention
from ..comm import comm as dist
from ..runtime import topology as topo_mod
from ..runtime.activation_checkpointing import checkpointing
from ..sequence.layer import ulysses_attention
from ..sequence.ring_attention import ring_attention

ENCODER_SERVING = ("the ragged serving engine generates autoregressively; "
                   "bidirectional encoders (bert/roberta) have no decode semantics "
                   "- use the model's apply() for MLM scoring")

ACTIVATIONS = {
    "gelu": L.gelu,  # tanh approximation
    "gelu_exact": lambda x: torch.nn.functional.gelu(x),
    "relu": torch.relu,
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The JAX ``MoEConfig`` (``deepspeed_tpu/models/transformer.py:75-81``)."""
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    min_capacity: int = 4
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The port's copy of the JAX ``TransformerConfig``
    (``deepspeed_tpu/models/transformer.py:85-132``), every field."""
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None   # None => MHA
    hidden_size: int = 768
    intermediate_size: Optional[int] = None  # None => 4*hidden
    activation: str = "gelu"        # 'gelu' | 'gelu_exact' | 'relu' | 'silu_gated'
    norm: str = "layernorm"          # 'layernorm' | 'rmsnorm'
    norm_eps: float = 1e-5
    position: str = "learned"        # 'learned' | 'rope' | 'alibi'
    position_offset: int = 0
    rope_theta: float = 10000.0
    rope_dim: Optional[int] = None   # partial rotary; None => head_dim
    rope_style: str = "half"         # 'half' | 'interleaved'
    # per-layer causal windows (gpt-neo's local layers, mistral's sliding
    # window): 0 = global, w > 0 = the last w keys; an int for every layer
    attn_windows: Any = None         # Optional[int | Tuple[int, ...]]
    attn_scale: Optional[float] = None  # gpt-neo: 1.0; None => 1/sqrt(head_dim)
    embedding_norm: bool = False     # bloom: LayerNorm right after wte
    linear_bias: Optional[bool] = None  # None => biases iff layernorm
    attn_bias: Optional[bool] = None
    attn_out_bias: Optional[bool] = None
    lm_head_bias: bool = False
    tie_embeddings: bool = True
    causal: bool = True              # False: a bidirectional encoder (bert)
    parallel_block: bool = False     # falcon/phi: x + attn(ln(x)) + mlp(ln(x))
    parallel_norms: bool = False     # falcon-40b/neox: a norm per parallel branch
    norm_style: str = "pre"          # 'pre' | 'post' (bert-era encoders)
    type_vocab_size: int = 0         # bert segment (token-type) embeddings
    mlm_head: bool = False           # bert cls.predictions transform + bias
    # roberta: position ids cumsum(real) * real + pad_token_id
    pad_based_positions: bool = False
    pad_token_id: Optional[int] = None
    seq_parallel: str = "ulysses"    # 'ulysses' | 'ring' (long-context SP)
    moe: Optional[MoEConfig] = None  # every layer's MLP is a MoE when set
    moe_layer_freq: int = 1          # kept as in JAX, whose model never reads it
    dtype: torch.dtype = torch.float32
    remat: bool = True               # recompute each block in the backward
    remat_policy: str = "nothing_saveable"

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


def check_supported(c: TransformerConfig) -> None:
    """Raise for configurations the JAX model refuses (``ValueError``) and
    for those the port does not cover yet (``NotImplementedError``)."""
    if c.position not in ("rope", "learned", "alibi"):
        raise ValueError(f"unknown position style {c.position!r}")
    if c.norm_style not in ("pre", "post"):
        raise ValueError(f"unknown norm_style {c.norm_style!r}")
    if not c.causal and c.position != "learned":
        raise ValueError("bidirectional encoders use learned positions")
    if not c.causal and c.seq_parallel == "ring":
        raise ValueError("ring attention is causal-only")
    if c.attn_windows is not None:
        if not c.causal:
            raise ValueError("attention windows are causal-only")
        if c.seq_parallel == "ring":
            raise ValueError("attention windows are not supported with ring sequence "
                             "parallelism")
    if c.position == "alibi" and c.seq_parallel == "ring":
        raise ValueError("alibi positions are not supported with ring sequence "
                         "parallelism (K/V rotation loses absolute key positions)")
    if c.pad_based_positions and c.pad_token_id is None:
        raise ValueError("pad_based_positions requires pad_token_id")
    if c.remat:
        checkpointing.check_model_policy(c.remat_policy)


def layer_windows(c: TransformerConfig) -> Optional[Tuple[int, ...]]:
    """Each layer's causal window (0 = global), or None when no layer's
    window binds: the JAX model's normalization
    (``deepspeed_tpu/models/transformer.py:202-221``). An int applies to
    every layer, a window of at least ``max_seq_len`` is global."""
    w = c.attn_windows
    if w is None:
        return None
    windows = tuple([int(w)] * c.num_layers if isinstance(w, int) else map(int, w))
    if len(windows) != c.num_layers:
        raise ValueError(f"attn_windows has {len(windows)} entries for "
                         f"{c.num_layers} layers")
    windows = tuple(0 if wi >= c.max_seq_len else wi for wi in windows)
    return windows if any(windows) else None


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         extra_mask: Optional[torch.Tensor] = None,
                         denominator: Optional[float] = None) -> torch.Tensor:
    """Mean cross-entropy over positions where ``labels >= 0`` (-100 = HF
    ignore). ``log_softmax`` and a gather: the same sum as the JAX one-hot
    contraction, which exists there only for GSPMD's sake. ``denominator``
    replaces the local count of such positions (a sequence shard's share of
    a global mean)."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    mask = valid.float()
    if extra_mask is not None:
        mask = mask * extra_mask.float()
    if denominator is not None:
        return (nll * mask).sum() / max(float(denominator), 1.0)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


class Block(nn.Module):
    """One block; attribute names match the JAX block's parameter keys
    (``models/transformer.py:247-280``). A parallel block with one norm has
    no ``ln_2``."""

    def __init__(self, c: TransformerConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=c.dtype)
        norm = (lambda: L.RMSNorm(c.hidden_size, eps=c.norm_eps, **kw)) \
            if c.norm == "rmsnorm" else \
            (lambda: L.LayerNorm(c.hidden_size, eps=c.norm_eps, **kw))
        use_bias = (c.linear_bias if c.linear_bias is not None
                    else c.norm == "layernorm")
        attn_bias = c.attn_bias if c.attn_bias is not None else use_bias
        attn_out_bias = (c.attn_out_bias if c.attn_out_bias is not None
                         else attn_bias)
        h, kv_out = c.hidden_size, c.kv_heads * c.head_dim
        self.ln_1 = norm()
        self.q_proj = L.Linear(h, h, bias=attn_bias, **kw)
        self.k_proj = L.Linear(h, kv_out, bias=attn_bias, **kw)
        self.v_proj = L.Linear(h, kv_out, bias=attn_bias, **kw)
        self.o_proj = L.Linear(h, h, bias=attn_out_bias, **kw)
        self.ln_2 = norm() if not c.parallel_block or c.parallel_norms else None
        self.gated = c.activation == "silu_gated"
        self.moe = None
        if c.moe is not None:
            m = c.moe
            self.moe = MoE(h, c.ffn_size, num_experts=m.num_experts, top_k=m.top_k,
                           capacity_factor=m.capacity_factor, min_capacity=m.min_capacity,
                           activation=c.activation, **kw)
        elif self.gated:
            self.gate_proj = L.Linear(h, c.ffn_size, bias=False, **kw)
            self.up_proj = L.Linear(h, c.ffn_size, bias=False, **kw)
            self.down_proj = L.Linear(c.ffn_size, h, bias=False, **kw)
        else:
            self.act = ACTIVATIONS[c.activation]
            self.fc_in = L.Linear(h, c.ffn_size, bias=use_bias, **kw)
            self.fc_out = L.Linear(c.ffn_size, h, bias=use_bias, **kw)

    def mlp(self, h: torch.Tensor, dropless: bool = False, with_aux: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """MLP over the PRE-NORMED input h: ``(out, aux)``. A MoE block's aux
        loss when asked for (training), else None (serving: not computed);
        the MoE routed dropless when asked (capacity = the token count). A
        dense block's aux is None."""
        if self.moe is not None:
            return self.moe(h, dropless=dropless, with_aux=with_aux)
        if self.gated:
            return self.down_proj(L.silu(self.gate_proj(h)) * self.up_proj(h)), None
        return self.fc_out(self.act(self.fc_in(h))), None


class TransformerLM(nn.Module):
    #: the modules ``embed`` reads (JAX ``embed_param_keys``, the same top-level
    #: names): a parameter ``<module>.<leaf>`` whose module is one of them is
    #: embed-side, every other one outside the blocks head-side (the overlap
    #: schedule's edge split)
    embed_param_keys = ("wte", "wpe", "ln_emb", "wtt")

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        check_supported(config)
        c = self.config = config
        device = torch.device("meta") if device is None else device
        kw = dict(device=device, dtype=c.dtype)
        self.wte = L.Embedding(c.vocab_size, c.hidden_size, **kw)
        self.wpe = (L.Embedding(c.max_seq_len + c.position_offset,
                                c.hidden_size, **kw)
                    if c.position == "learned" else None)
        self.blocks = nn.ModuleList(Block(c, device) for _ in range(c.num_layers))
        norm = (lambda: L.RMSNorm(c.hidden_size, eps=c.norm_eps, **kw)) \
            if c.norm == "rmsnorm" else \
            (lambda: L.LayerNorm(c.hidden_size, eps=c.norm_eps, **kw))
        # post-norm: the last block's output norm already normalizes
        self.ln_f = norm() if c.norm_style == "pre" else None
        self.lm_head = (None if c.tie_embeddings else
                        L.Linear(c.hidden_size, c.vocab_size,
                                 bias=c.lm_head_bias, **kw))
        self.ln_emb = norm() if c.embedding_norm else None
        self.wtt = (L.Embedding(c.type_vocab_size, c.hidden_size, **kw)
                    if c.type_vocab_size else None)
        self.mlm = None
        if c.mlm_head:
            self.mlm = nn.Module()
            self.mlm.dense = L.Linear(c.hidden_size, c.hidden_size, **kw)
            self.mlm.ln = norm()
            self.mlm.bias = nn.Parameter(torch.empty(c.vocab_size, **kw),
                                         requires_grad=False)
        #: each layer's causal window (0 = global), or None
        self.windows = layer_windows(c)
        #: ALiBi slopes [num_heads] (fp32, host), or None
        self.alibi_slopes = (torch.from_numpy(alibi_slopes(c.num_heads))
                             if c.position == "alibi" else None)
        self._alibi_on: Dict[torch.device, torch.Tensor] = {}

    # -- weights -------------------------------------------------------------
    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Fill every parameter in module order: normal(0, 0.02) for linear
        and embedding weights, zero biases, unit norm scales (the JAX
        layers' init distribution; the draws differ, as two generators do)."""
        for m in self.modules():
            if isinstance(m, (L.Linear, L.Embedding, MoE)):
                m.reset_parameters(generator)
            elif isinstance(m, (L.RMSNorm, L.LayerNorm)):
                m.reset_parameters()
        if self.mlm is not None:
            self.mlm.bias.zero_()

    def materialize(self, device, seed: int = 0) -> "TransformerLM":
        """Give a meta-device model storage on ``device`` and fill it from
        ``torch.Generator(device).manual_seed(seed)``."""
        device = torch.device(device)
        self.to_empty(device=device)
        self.init_weights(torch.Generator(device=device).manual_seed(seed))
        return self

    # -- pieces serving reads ------------------------------------------------
    def rope(self, positions: torch.Tensor):
        """The rotary tables of ``positions``, computed once per forward and
        shared by every layer's ``rotate``."""
        c = self.config
        return L.rotary_tables(positions, min(c.rope_dim or c.head_dim, c.head_dim),
                               c.rope_theta)

    def rotate(self, x: torch.Tensor, rope) -> torch.Tensor:
        """Rotary embedding by the tables ``rope``, possibly PARTIAL (only
        the first ``rope_dim`` dims of each head rotate)."""
        c = self.config
        rd = c.rope_dim or c.head_dim
        if rd >= c.head_dim:
            return L.apply_rotary(x, *rope, c.rope_style)
        rot = L.apply_rotary(x[..., :rd], *rope, c.rope_style)
        return torch.cat([rot, x[..., rd:]], dim=-1)

    def embed(self, tokens: torch.Tensor, positions: torch.Tensor,
              token_type_ids: Optional[torch.Tensor] = None,
              real_before: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token + position (+ token-type) embeddings, the embedding norm,
        the cast to the compute dtype (JAX ``embed``). With
        ``pad_based_positions`` a token's position id is
        ``cumsum(real) * real + pad_token_id`` along the sequence (HF
        RoBERTa's), ``positions`` unread, the cumsum starting at
        ``real_before [B, 1]`` (the real tokens of the earlier sequence
        slices) where given; token types default to 0."""
        c = self.config
        x = self.wte(tokens)
        if self.wpe is not None:
            if c.pad_based_positions:
                real = (tokens != c.pad_token_id).long()
                run = torch.cumsum(real, dim=-1)
                if real_before is not None:
                    run = run + real_before
                pos = run * real + c.pad_token_id
            else:
                pos = positions.clamp(0, c.max_seq_len - 1) + c.position_offset
            x = x + self.wpe(pos)
        if self.wtt is not None:
            x = x + self.wtt(token_type_ids if token_type_ids is not None
                             else torch.zeros_like(tokens))
        if self.ln_emb is not None:
            x = self.ln_emb(x)
        return x.to(c.dtype)

    def alibi(self, device: torch.device) -> Optional[torch.Tensor]:
        """The ALiBi slopes on ``device`` (None without ALiBi), copied there
        once, at an address that stays (a captured decode graph reads it);
        a normal tensor even when first asked for under inference mode, so
        training can save it for the backward."""
        if self.alibi_slopes is None:
            return None
        t = self._alibi_on.get(device)
        if t is None:
            with torch.inference_mode(False):
                t = self._alibi_on[device] = self.alibi_slopes.to(device)
        return t

    def window(self, layer: int) -> Optional[int]:
        return None if self.windows is None else self.windows[layer]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm (pre-norm models), the MLM transform (dense ->
        activation -> LN) and the LM / MLM head; fp32 logits."""
        if self.ln_f is not None:
            x = self.ln_f(x)
        if self.mlm is not None:
            x = self.mlm.ln(ACTIVATIONS[self.config.activation](self.mlm.dense(x)))
        logits = self.wte.attend(x) if self.lm_head is None else self.lm_head(x)
        if self.mlm is not None:
            logits = logits + self.mlm.bias.to(logits.dtype)
        return logits.float()

    def _qkv(self, blk: Block, h: torch.Tensor, rope):
        """q [..., H, D], k / v [..., kvH, D] of the normed input ``h [...,
        hidden]`` (``[B, S]`` tokens in training, a flat ``[N]`` stream in
        serving), rotated by the tables ``rope`` unless it is None."""
        c = self.config
        lead = h.shape[:-1]
        q = blk.q_proj(h).view(*lead, c.num_heads, c.head_dim)
        k = blk.k_proj(h).view(*lead, c.kv_heads, c.head_dim)
        v = blk.v_proj(h).view(*lead, c.kv_heads, c.head_dim)
        if rope is not None:
            q, k = self.rotate(q, rope), self.rotate(k, rope)
        return q, k, v

    def _residual(self, blk: Block, x: torch.Tensor, h1: torch.Tensor, attn: torch.Tensor,
                  keep, dropless: bool = False, with_aux: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block's output from its input ``x``, ``h1 = ln_1(x)`` and the
        attention before ``o_proj``: sequential, or parallel (``x + attn +
        mlp``, the MLP reading ``h1`` or ``ln_2(x)``), each branch gated by
        ``keep`` (PLD) unless it is None; with the MLP's aux (``Block.mlp``)."""
        a = blk.o_proj(attn.reshape(*x.shape[:-1], -1))
        if self.config.parallel_block:
            hm = blk.ln_2(x) if blk.ln_2 is not None else h1
            m, aux = blk.mlp(hm, dropless=dropless, with_aux=with_aux)
            y = a + m
            return x + (y if keep is None else keep * y), aux
        x = x + (a if keep is None else keep * a)
        m, aux = blk.mlp(blk.ln_2(x), dropless=dropless, with_aux=with_aux)
        return x + (m if keep is None else keep * m), aux

    # -- training forward ----------------------------------------------------
    def embed_inputs(self, input_ids: torch.Tensor,
                     token_type_ids: Optional[torch.Tensor] = None,
                     attention_mask: Optional[torch.Tensor] = None):
        """What every block of a training forward reads: ``(x, rope, seg)``,
        the embedded tokens (their positions this rank's slice under
        sequence parallelism), the rotary tables or None, and the int32
        segment ids of the padding mask or None."""
        c = self.config
        if c.seq_parallel == "ring" and attention_mask is not None:
            raise ValueError("ring attention does not support padding masks (attention_mask)")
        S = input_ids.shape[1]
        sp, r, group = topo_mod.sequence_parallel()
        positions = torch.arange(r * S, (r + 1) * S, device=input_ids.device)[None, :]
        real_before = None
        if sp > 1 and c.pad_based_positions:
            real = (input_ids != c.pad_token_id).sum(dim=1).to(torch.int64)
            counts = dist.all_gather(real[None], group=group)       # [sp, B]
            real_before = counts[:r].sum(dim=0)[:, None]
        x = self.embed(input_ids, positions, token_type_ids, real_before)
        rope = self.rope(positions) if c.position == "rope" else None
        seg = None if attention_mask is None else attention_mask.to(torch.int32)
        return x, rope, seg

    def _block(self, blk: Block, x: torch.Tensor, rope, keep, window,
               seg: Optional[torch.Tensor]):
        """One block (``_block_fn``) through the flash kernels; ``keep``
        gates it (PLD) or is None, ``window`` is the layer's, ``seg`` the
        int32 segment ids of the padding mask or None. Post-norm: LN after
        each residual add, the gate mixed outside the norms. Returns
        ``(output, aux)``: a MoE block's aux loss, a dense block's a zero
        fp32 scalar."""
        c = self.config
        post = c.norm_style == "post"
        h1 = x if post else blk.ln_1(x)
        q, k, v = self._qkv(blk, h1, rope)
        if c.seq_parallel == "ring":
            attn = ring_attention(q, k, v, causal=True, scale=c.attn_scale)
        else:
            attn = ulysses_attention(flash_attention, q, k, v, causal=c.causal,
                                     scale=c.attn_scale, segment_ids=seg,
                                     alibi_slopes=self.alibi(x.device), window=window)
        if not post:
            y, aux = self._residual(blk, x, h1, attn, keep, with_aux=True)
        else:
            h = blk.ln_1(x + blk.o_proj(attn.reshape(*x.shape[:-1], -1)))
            m, aux = blk.mlp(h, with_aux=True)
            y = blk.ln_2(h + m)
            y = y if keep is None else keep * y + (1 - keep) * x
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return y, aux

    def block_apply(self, layer: int, x: torch.Tensor, rope=None, keep=None,
                    seg: Optional[torch.Tensor] = None):
        """Block ``layer`` alone over ``x`` (JAX ``block_apply``: the unit of
        the overlap schedule), with whatever tensors its parameters hold
        now; ``(x', aux)``."""
        return self._block(self.blocks[layer], x, rope, keep, self.window(layer), seg)

    def _layer_params(self, layers) -> List[Tuple[str, nn.Parameter]]:
        return [(name, p) for l in layers for name, p in self.blocks[l].named_parameters()]

    def scan_blocks_pipelined(self, x: torch.Tensor, rope=None,
                              seg: Optional[torch.Tensor] = None, *, gather, scatter,
                              keep: Optional[torch.Tensor] = None, layers_per_step: int = 1,
                              prefetch_depth: int = 1, comm_edge=None, scatter_err=None):
        """The layer-pipelined ZeRO schedule over the blocks (JAX
        ``scan_blocks_pipelined``, ``deepspeed_tpu/models/transformer.py:
        506-750``), as an eager loop; the engine's
        ``DataParallelEngine._micro_overlap`` drives it.

        The blocks run in steps of ``layers_per_step`` layers (2 for the
        ``alternating`` remat policy). ``gather(s)`` launches step s's
        parameter gathers and returns a handle whose ``wait()`` gives, for
        each layer of the step, ``{parameter name: full tensor}``;
        ``scatter(s, grads)`` launches the reductions of step s's gradients
        (the same form) and returns a handle whose ``wait()`` completes them.
        A step's full tensors are bound to its blocks' parameters
        (``.data``) while it runs and unbound after, so their storage goes
        as soon as the step is done.

        Forward (under ``no_grad``): step s+1's gathers are launched before
        step s computes, so they move while it runs; at most two steps' full
        parameters are live (three at ``prefetch_depth`` 2, which gathers two
        steps ahead; a depth of 2 needs at least 3 steps and is clamped to 1
        below that). Only each step's input is kept. The last step's
        parameters stay bound for the backward.

        Backward (``pullback(dx_out, daux)``, returning the gradient of the
        blocks' input): steps in reverse, re-gathering one step ahead (two
        at depth 2), each step recomputed from its saved input under
        ``enable_grad`` and differentiated with ``torch.autograd.grad`` (the
        schedule is the remat; no ``checkpointing.checkpoint`` around it).
        Step s's reductions are launched when its backward is queued and
        waited after step s-1's is, so they move while it runs.

        ``keep`` ``[num_layers]`` gates each layer (PLD), ``rope`` and
        ``seg`` are those of ``embed_inputs``, each layer keeps its window.
        ``comm_edge(overlapped)`` (the engine's ``TreeComm.schedule_class``)
        is entered around the edge launches: the prologue gathers and the
        last reduction.

        ``scatter_err`` (the engine's error-feedback carry): a list with one
        residual slot a step. Step s's reduction is then launched as
        ``scatter(s, grads, err=scatter_err[s])``, whose handle's ``wait()``
        gives that step's new residual, and ``pullback`` returns ``(dx,
        new_err)``, the list with each step's slot replaced. The JAX reverse
        scan carries ``scatter_err[1:]`` in its xs and flushes slot 0 in its
        epilogue; keyed by step, both give step s's slot to step s's
        reduction.

        Launches a micro step: the JAX scan gathers each step's parameters
        twice more than needed to keep one scan body shape (the forward's
        last slot re-gathers the final step, the backward's slot 0 is dead;
        two more of each at depth 2). This loop issues neither: ``n`` steps
        take ``n`` gathers forward, ``n - 1`` backward and ``n``
        reductions, against JAX's ``n + 1``, ``n`` and ``n`` at depth 1.

        Returns ``(x_out, aux_sum, pullback)``; ``x_out`` and ``aux_sum``
        carry no graph."""
        c = self.config
        L = c.num_layers
        lps = int(layers_per_step)
        if lps < 1 or L % lps:
            raise ValueError(f"layers_per_step={lps} must divide num_layers={L}")
        n = L // lps
        depth = int(prefetch_depth)
        if depth < 1:
            raise ValueError(f"prefetch_depth={depth} must be >= 1")
        depth = 1 if n <= 2 else min(depth, 2)
        edge = comm_edge or (lambda overlapped: contextlib.nullcontext())
        layers = lambda s: range(s * lps, (s + 1) * lps)

        def bind(s, fulls):
            saved = []
            for j, l in enumerate(layers(s)):
                for name, p in self.blocks[l].named_parameters():
                    saved.append((p, p.data))
                    p.data = fulls[j][name]
            return saved

        def unbind(saved):
            for p, d in saved:
                p.data = d

        def unit(s, xx, aux):
            for l in layers(s):
                k = None if keep is None else keep[l].to(c.dtype)
                xx, a = self.block_apply(l, xx, rope, k, seg)
                aux = aux + (a if k is None else k * a)
            return xx, aux

        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        pend = {}
        with edge(False):   # the prologue: nothing runs yet to hide it
            for s in range(min(depth, n)):
                pend[s] = gather(s)
        acts, aux_sum, last = [], zero, None
        with torch.no_grad():
            for s in range(n):
                full = pend.pop(s).wait()
                if s + depth < n:
                    pend[s + depth] = gather(s + depth)
                acts.append(x)
                saved = bind(s, full)
                del full
                x, aux_sum = unit(s, x, aux_sum)
                if s < n - 1:
                    unbind(saved)
                else:
                    last = saved

        new_err = None if scatter_err is None else list(scatter_err)

        def finish(waiting):
            s, h = waiting
            got = h.wait()
            if new_err is not None:
                new_err[s] = got

        def pullback(dx: torch.Tensor, daux: Optional[torch.Tensor] = None):
            pend = {s: gather(s) for s in range(n - 2, max(n - 2 - depth, -1), -1)}
            waiting = None
            for s in range(n - 1, -1, -1):
                if s == n - 1:
                    saved = last
                else:
                    full = pend.pop(s).wait()
                    if s - depth >= 0:
                        pend[s - depth] = gather(s - depth)
                    saved = bind(s, full)
                    del full
                named = self._layer_params(layers(s))
                xin = acts[s].detach().requires_grad_(True)
                acts[s] = None
                with torch.enable_grad():
                    y, a = unit(s, xin, zero)
                outs, cots = [y], [dx]
                if daux is not None and a.requires_grad:
                    outs.append(a)
                    cots.append(daux)
                got = torch.autograd.grad(outs, [xin] + [p for _, p in named], cots,
                                          allow_unused=True)
                dx = got[0]
                grads = [{} for _ in range(lps)]
                for i, ((name, p), g) in enumerate(zip(named, got[1:])):
                    grads[i * lps // len(named)][name] = torch.zeros_like(p) if g is None else g
                unbind(saved)
                del got, named, saved
                with edge(False) if s == 0 else contextlib.nullcontext():
                    h = (scatter(s, grads) if new_err is None
                         else scatter(s, grads, err=new_err[s]))
                del grads
                if waiting is not None:
                    finish(waiting)
                waiting = (s, h)
            finish(waiting)
            return dx if new_err is None else (dx, new_err)

        return x, aux_sum, pullback

    def apply(self, input_ids: torch.Tensor,
              layer_mask: Optional[torch.Tensor] = None,
              token_type_ids: Optional[torch.Tensor] = None,
              attention_mask: Optional[torch.Tensor] = None,
              return_hidden: bool = False):
        """``(logits [B, S, V] fp32, moe_aux_loss)``, differentiable
        (``apply``). ``layer_mask`` [num_layers] gates each block;
        ``token_type_ids [B, S]`` select the segment embeddings;
        ``attention_mask [B, S]`` (1 = real) masks padding;
        ``return_hidden`` returns the final hidden states (after ``ln_f``
        where the model has one) instead of the logits.

        Remat (when grad is on): each block under ``remat_policy``
        (``checkpointing.checkpoint``), or, for ``alternating``, layer
        pairs with the first of each pair checkpointed in full and the
        second not (an odd last layer checkpointed).

        ``moe_aux_loss`` is the sum over the layers of each MoE layer's aux
        gated by ``keep`` (fp32; 0 for a model without MoE layers).

        Under sequence parallelism ``input_ids`` (and the other ``[B, S]``
        inputs) are this rank's slice of the sequence."""
        c = self.config
        x, rope, seg = self.embed_inputs(input_ids, token_type_ids, attention_mask)
        remat = c.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, blk in enumerate(self.blocks):
            keep = None if layer_mask is None else layer_mask[i].to(c.dtype)
            args = (blk, x, rope, keep, self.window(i), seg)
            if not remat:
                x, layer_aux = self._block(*args)
            elif c.remat_policy == "alternating":
                x, layer_aux = checkpointing.checkpoint(self._block, *args, policy=(
                    "full" if i % 2 == 0 else "everything_saveable"))
            else:
                x, layer_aux = checkpointing.checkpoint(self._block, *args,
                                                        policy=c.remat_policy)
            aux = aux + (layer_aux if keep is None else keep * layer_aux)
        if return_hidden:
            return (x if self.ln_f is None else self.ln_f(x)), aux
        return self.head(x), aux

    def derive_labels(self, batch) -> torch.Tensor:
        """Explicit labels, or the causal next-token shift (-100 = ignore);
        an encoder needs explicit labels."""
        labels = batch.get("labels")
        if labels is not None:
            return labels
        if not self.config.causal:
            raise ValueError("encoder (MLM) training requires explicit labels - "
                             "next-token shift is meaningless bidirectionally")
        ids = batch["input_ids"]
        return torch.nn.functional.pad(ids[:, 1:], (0, 1), value=-100)

    def head_loss(self, x: torch.Tensor, labels: torch.Tensor,
                  extra_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final norm + LM head + masked cross-entropy over the last block's
        output."""
        return masked_cross_entropy(self.head(x), labels, extra_mask=extra_mask)

    def combine_aux(self, loss: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        """Fold the summed MoE aux loss into the objective (JAX
        ``combine_aux``): ``loss + aux_loss_coef * aux / num_layers``."""
        if self.config.moe is not None:
            loss = loss + self.config.moe.aux_loss_coef * aux / self.config.num_layers
        return loss

    def loss(self, batch, denominator: Optional[float] = None) -> torch.Tensor:
        """Cross-entropy of ``batch`` (``input_ids [B, S]``, optional
        ``labels``, ``loss_mask``, ``layer_mask``, ``token_type_ids``,
        ``attention_mask``): next-token for causal models, masked-LM for
        encoders (labels required, -100 = ignore), plus the MoE aux term
        (``combine_aux``). ``denominator`` divides the summed loss in place
        of the batch's own label count (a sequence shard: the global
        count)."""
        labels = self.derive_labels(batch)
        logits, aux = self.apply(batch["input_ids"], layer_mask=batch.get("layer_mask"),
                                 token_type_ids=batch.get("token_type_ids"),
                                 attention_mask=batch.get("attention_mask"))
        loss = masked_cross_entropy(logits, labels, extra_mask=batch.get("loss_mask"),
                                    denominator=denominator)
        return self.combine_aux(loss, aux)

    # -- plain reference forward ---------------------------------------------
    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, dropless: bool = False) -> torch.Tensor:
        """Full-sequence causal forward: ``input_ids [B, S]`` -> fp32 logits
        ``[B, S, V]``. Attention is the plain chunk reference with no
        history, one sequence at a time, with the ALiBi slopes and each
        layer's window. ``dropless`` routes MoE
        layers with capacity = the token count (the serving engine's
        function); else with the config's capacity factor, over all ``B *
        S`` tokens at once, as the JAX ``apply``."""
        from ..inference.v2.kernels.paged_attention import chunk_prefill_attention

        c = self.config
        if not c.causal:
            raise ValueError(ENCODER_SERVING)
        B, S = input_ids.shape
        positions = torch.arange(S, device=input_ids.device)[None, :].expand(B, S)
        x = self.embed(input_ids, positions)
        zero = torch.zeros((), dtype=torch.int64, device=input_ids.device)
        rope = self.rope(positions) if c.position == "rope" else None
        slopes = self.alibi(x.device)
        for i, blk in enumerate(self.blocks):
            h1 = blk.ln_1(x)
            q, k, v = self._qkv(blk, h1, rope)
            attn = torch.stack([
                chunk_prefill_attention(q[b], k[b].transpose(0, 1), v[b].transpose(0, 1),
                                        zero, scale=c.attn_scale, alibi_slopes=slopes,
                                        window=self.window(i))
                for b in range(B)])
            x, _ = self._residual(blk, x, h1, attn, None, dropless=dropless)
        return self.head(x)
