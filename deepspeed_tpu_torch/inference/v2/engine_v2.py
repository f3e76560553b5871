"""Continuous-batching inference engine.

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py`` for one device:
``put`` schedules new tokens for a set of UIDs and returns their
next-token logits, ``query`` / ``can_schedule`` expose the KV budget to the
scheduler, ``flush`` retires sequences, ``offload_sequence`` /
``restore_sequence`` move a preempted sequence's KV to host memory and
back, ``decode_burst`` fuses K decode steps.

A decode burst pads its batch to a power-of-two bucket of at least
``BURST_BUCKET_LO`` rows, as the JAX engine does (padded rows: token 0,
position 0, a table of null blocks, temperature 0; they write only into the
null block 0) and runs through ``DecodeGraphs`` (``decode_graph.py``): on
CUDA one captured decode step a key ``(B_bucket, mp, sampled)``, captured
at the key's first burst and replayed K times a burst, the tokens carried
and sampled on the device and copied to the host once; on the CPU the same
``decode_step`` runs eagerly. One generator an engine, reseeded with each
burst's ``seed``, draws the sampled rows.

Every ``put`` runs as ragged waves: the host builder (``ragged/wave.py``)
flattens each wave into one token stream plus atom descriptors, and the
model runs one ``ragged_paged_attention`` launch per layer over it.
Prompts longer than ``max_prefill_chunk`` take one wave per chunk.

With ``quantization_mode`` set (int8 / int4) the targeted linears are
served from quantized storage (``_place_quantized``): host weights are
quantized on the host, leaf by leaf, and only the int payload and the scales
are uploaded, so the device never holds the dense tree; a seeded model is
quantized on the device one leaf at a time. ``linear_impl`` names the
linear the engine chose (``dense`` / ``woq_int8`` / ``woq_int4``).

ALiBi models (BLOOM) and windowed ones (GPT-Neo, a windowed Mistral) serve
through the same two kernels, which take the slopes and each layer's
window. An encoder raises ``ValueError``, as the JAX engine does: it has no
decode semantics.

A MoE model (``models/mixtral.py``) is placed and seeded the same way: a
meta-device model gets its storage and its weights on the device, nothing
twice.

The engine runs on ``cuda`` unless given ``device="cpu"``; with neither it
raises. Not ported (ROADMAP A5): the legacy two-class dispatch, the
data-sharded pool, tensor parallelism, the quantization cache on disk and
``build_hf_engine``, the slabbed host->device upload, ``update_params``, the
module registry and the telemetry records.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ...accelerator import DeviceLike, resolve_device
from ...models.transformer import ENCODER_SERVING, TransformerLM
from ...nn.layers import Linear
from ..quantization.quantization import QuantizationConfig, host_quantize_kernel
from .config_v2 import RaggedInferenceEngineConfig
from .decode_graph import DecodeGraphs
from .model import RaggedInferenceModel
from .ragged.kv_cache import BlockedKVCache
from .ragged.ragged_manager import DSStateManager
from .ragged.ragged_wrapper import _next_bucket
from .ragged.wave import WaveEntry, build_wave

logger = logging.getLogger(__name__)

#: host threads that quantize leaves while earlier ones upload
_QUANT_WORKERS = 4
#: smallest batch bucket of a decode burst (the JAX engine's is 16, a TPU
#: choice). 1: a burst pads its batch to the next power of two only. On the
#: H100 (chip_smoke.py [decode-graph], PERF.md) a Mixtral step at B 1 / 2 / 4
#: takes 0.43 / 0.60 / 0.81 of one at B 8 (fewer experts' weights streamed),
#: a dense llama2-7b step 0.91-0.98, an int8 one 0.92-0.96: padding a small
#: batch to 8 would pay the difference
BURST_BUCKET_LO = 1


def _place_model(model: TransformerLM, params: Optional[Mapping[str, Any]],
                 device: torch.device, seed: int) -> TransformerLM:
    """Put the model's weights on ``device``: from ``params`` (a state dict,
    e.g. ``convert.params_from_jax``) when given; else a meta-device model
    is filled from a generator seeded with ``seed``; else the model's own
    weights are moved."""
    on_meta = any(p.is_meta for p in model.parameters())
    if params is not None:
        if on_meta:
            model.to_empty(device=device)
        else:
            model.to(device)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    elif on_meta:
        model.materialize(device, seed)
    else:
        model.to(device)
    return model.eval()


def _host_tensor(a: Any) -> torch.Tensor:
    return a.cpu() if torch.is_tensor(a) else torch.as_tensor(a)


def _place_quantized(model: TransformerLM, params: Optional[Mapping[str, Any]],
                     device: torch.device, seed: int,
                     qcfg: QuantizationConfig) -> TransformerLM:
    """``_place_model`` for weight-only quantization: every ``Linear`` whose
    name is a target of ``qcfg`` ends up in its quantized form on ``device``.

    With ``params`` (a host state dict): the targeted linears drop their
    dense weight before the model is given storage, so the device never
    holds the dense tree. A ``<layer>.q`` / ``<layer>.scale`` pair uploads
    as it is; a dense ``<layer>.weight`` is quantized on the host in the
    model dtype (``host_quantize_kernel``, bit for bit the device
    quantizer), a few leaves ahead of the upload in a small thread pool, and
    only its int payload and scales are uploaded. Without ``params`` the
    model is materialized on the device (from ``seed`` when it is on the meta
    device, the same weights the dense engine would draw) and quantized
    there one leaf at a time, each dense leaf freed as its ``q`` replaces
    it."""
    targets = {name: m for name, m in model.named_modules()
               if isinstance(m, Linear) and name.rpartition(".")[2] in qcfg.targets}
    on_meta = any(p.is_meta for p in model.parameters())
    if params is None:
        if on_meta:
            model.materialize(device, seed)
        else:
            model.to(device)
        for lin in targets.values():
            if lin.q is None:
                lin.quantize_(qcfg)
        return model.eval()

    dtype = model.config.dtype
    for lin in targets.values():
        lin.weight = None
    if on_meta:
        model.to_empty(device=device)
    else:
        model.to(device)

    def prepare(name: str):
        if f"{name}.q" in params:
            return _host_tensor(params[f"{name}.q"]), _host_tensor(params[f"{name}.scale"])
        kernel = _host_tensor(params[f"{name}.weight"]).transpose(-1, -2)   # [in, out]
        q, scale = host_quantize_kernel(kernel, qcfg, dtype)
        return torch.from_numpy(q), torch.from_numpy(scale)

    with ThreadPoolExecutor(max_workers=_QUANT_WORKERS) as pool:
        names = list(targets)
        ahead = 2 * _QUANT_WORKERS   # leaves prepared but not yet uploaded
        futures = {n: pool.submit(prepare, n) for n in names[:ahead]}
        for i, name in enumerate(names):
            q, scale = futures.pop(name).result()
            if i + ahead < len(names):
                futures[names[i + ahead]] = pool.submit(prepare, names[i + ahead])
            targets[name].set_quantized(q.to(device), scale.to(device))
    placed = lambda k: (k.rpartition(".")[0] in targets
                        and k.rpartition(".")[2] in ("weight", "q", "scale"))
    rest = {k: torch.as_tensor(v) for k, v in params.items() if not placed(k)}
    missing, unexpected = model.load_state_dict(rest, strict=False)
    missing = [k for k in missing if not placed(k)]
    if missing or unexpected:
        raise KeyError(f"state dict does not fit the model: missing {missing}, "
                       f"unexpected {list(unexpected)}")
    return model.eval()


class InferenceEngineV2:

    def __init__(self, model: TransformerLM,
                 config: Optional[RaggedInferenceEngineConfig] = None,
                 params: Optional[Mapping[str, Any]] = None,
                 device: DeviceLike = None, seed: int = 0):
        self.config = config or RaggedInferenceEngineConfig()
        self.device = resolve_device(device)
        c = model.config
        self.config.check_supported(c.dtype)
        if not c.causal:
            raise ValueError(ENCODER_SERVING)
        sm = self.config.state_manager
        block_size = self.config.kv_block_size
        max_ctx = min(sm.max_context, c.max_seq_len)
        self.max_blocks_per_seq = -(-max_ctx // block_size)
        num_blocks = self.config.num_kv_blocks
        if num_blocks is None:
            # enough for max_ragged_sequence_count sequences at half context
            num_blocks = 1 + sm.max_ragged_sequence_count * max(
                1, self.max_blocks_per_seq // 2)
        self.kv_cache = BlockedKVCache(c.num_layers, c.kv_heads, c.head_dim,
                                       num_blocks, block_size,
                                       dtype=self.config.kv_cache_dtype,
                                       device=self.device)
        self.state_manager = DSStateManager(sm, self.kv_cache)
        self._qcfg = QuantizationConfig.from_mode(self.config.quantization_mode)
        if self._qcfg is not None and c.moe is not None:
            raise NotImplementedError(
                "weight-only quantization of a MoE model is not ported (ROADMAP A5: "
                "MoE under WOQ)")
        #: the linear this engine serves through (the module registry's
        #: ``linear`` slot in the JAX engine)
        self.linear_impl = "dense" if self._qcfg is None else f"woq_int{self._qcfg.bits}"
        if self._qcfg is None:
            self.model = _place_model(model, params, self.device, seed)
        else:
            self.model = _place_quantized(model, params, self.device, seed, self._qcfg)
        logger.info("InferenceEngineV2: %d KV blocks x %d tokens (%.0f MiB), linear=%s",
                    num_blocks, block_size, self.kv_cache.mem_bytes() / 2**20,
                    self.linear_impl)
        self._model = RaggedInferenceModel(self.model, block_size,
                                           self.max_blocks_per_seq,
                                           self.config.ragged_block_q)
        self.decode_graphs = DecodeGraphs(self._model, self.kv_cache.k_pages,
                                          self.kv_cache.v_pages, self.config.decode_burst)

    # -- scheduling queries -------------------------------------------------
    def query(self, uid: int) -> Dict[str, int]:
        seq = self.state_manager.get_sequence(uid)
        return {
            "seen_tokens": 0 if seq is None else seq.seen_tokens,
            "cur_allocated_blocks": 0 if seq is None else seq.cur_allocated_blocks,
            "free_blocks": self.state_manager.free_blocks,
        }

    @property
    def max_context(self) -> int:
        """Longest sequence the KV layout can hold."""
        return self.max_blocks_per_seq * self.state_manager.block_size

    def can_schedule(self, uids: Sequence[int], lengths: Sequence[int]) -> bool:
        """Dry-run KV block budgeting for a batch."""
        return self._plan_shards(uids, lengths) is not None

    def _plan_shards(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> Optional[Dict[int, int]]:
        """The placement rule ``can_schedule`` and ``put`` both evaluate,
        in its one-shard form (the JAX engine's ``_plan_shards`` with a
        single pool): the aggregate free-block check. Returns ``{uid: 0}``
        or None if the batch does not fit."""
        sm = self.config.state_manager
        if len(uids) > sm.max_ragged_sequence_count:
            return None
        if sum(lengths) > sm.max_ragged_batch_size:
            return None
        free = self.state_manager.free_blocks
        for uid, n in zip(uids, lengths):
            seq = self.state_manager.get_sequence(uid)
            seen = 0 if seq is None else seq.seen_tokens
            have = 0 if seq is None else seq.cur_allocated_blocks
            if seen + n > self.max_context:
                # growing past the block table would overwrite live KV
                return None
            need = max(0, -(-(seen + n) // self.state_manager.block_size) - have)
            if need > free:
                return None
            free -= need
        return {uid: 0 for uid in uids}

    def flush(self, uid: int) -> None:
        self.state_manager.flush_sequence(uid)

    # -- KV host offload / restore -----------------------------------------
    def offload_sequence(self, uid: int) -> None:
        self.state_manager.offload_sequence(uid)

    def can_restore(self, uid: int, headroom: int = 0) -> bool:
        return (self.state_manager.is_offloaded(uid)
                and self.state_manager.can_restore(uid, headroom))

    def is_offloaded(self, uid: int) -> bool:
        return self.state_manager.is_offloaded(uid)

    def restore_sequence(self, uid: int) -> None:
        self.state_manager.restore_sequence(uid)

    # -- forward ------------------------------------------------------------
    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[np.ndarray]) -> np.ndarray:
        """Schedule new tokens for each UID; returns fp32 last-token logits
        ``[len(uids), vocab]``. Mixed prefill chunks and decodes share each
        wave; prompts longer than ``max_prefill_chunk`` take one extra wave
        per extra chunk."""
        if self._plan_shards(batch_uids, [len(t) for t in batch_tokens]) is None:
            raise RuntimeError("batch does not fit KV/budget; call can_schedule first")
        work: List[Tuple[int, np.ndarray]] = []
        for uid, tokens in zip(batch_uids, batch_tokens):
            tokens = np.asarray(tokens, np.int32)
            seq = self.state_manager.get_or_create_sequence(uid)
            self.state_manager.allocate_blocks(seq, len(tokens))
            work.append((uid, tokens))

        cap = self.config.max_prefill_chunk
        out_logits: Dict[int, np.ndarray] = {}
        offset = {uid: 0 for uid, _ in work}
        while True:
            wave = [(uid, toks[offset[uid]:offset[uid] + cap])
                    for uid, toks in work if offset[uid] < len(toks)]
            if not wave:
                break
            logits = self._run_wave(wave)
            for i, (uid, chunk) in enumerate(wave):
                offset[uid] += len(chunk)
                out_logits[uid] = logits[i]
        return np.stack([out_logits[u] for u in batch_uids])

    def _device(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    def _run_wave(self, wave: List[Tuple[int, np.ndarray]]) -> np.ndarray:
        """One ragged wave: [(uid, chunk)], any composition of decode
        tokens and prefill chunks. Returns logits [len(wave), V]."""
        sm = self.state_manager
        entries = []
        for uid, chunk in wave:
            seq = sm.get_sequence(uid)
            entries.append(WaveEntry(uid, chunk, seq.seen_tokens, list(seq.blocks)))
        desc = build_wave(entries, block_q=self.config.ragged_block_q,
                          block_size=sm.block_size)
        i32 = torch.int32
        logits = self._model.wave_forward(
            self.kv_cache.k_pages, self.kv_cache.v_pages,
            self._device(desc.tokens, i32), self._device(desc.positions, i32),
            self._device(desc.write_idx, torch.int64),
            self._device(desc.cu_q_lens, i32), self._device(desc.kv_lens, i32),
            self._device(desc.page_indices, i32),
            self._device(desc.last_rows, torch.int64))
        for uid, chunk in wave:
            sm.get_sequence(uid).post_forward(len(chunk))
        logits = logits.cpu().numpy()
        return np.stack([logits[desc.row_of_uid[uid]] for uid, _ in wave])

    def can_burst(self, batch_uids: Sequence[int], num_steps: int) -> bool:
        """Burst feasibility: ``len(uids)`` tokens per step against the
        token budget, ``num_steps`` KV slots per sequence allocated up
        front."""
        sm = self.config.state_manager
        n = len(batch_uids)
        if n > sm.max_ragged_sequence_count or n > sm.max_ragged_batch_size:
            return False
        need = 0
        for uid in batch_uids:
            seq = self.state_manager.get_sequence(uid)
            if seq is None or seq.seen_tokens == 0:
                return False
            if seq.seen_tokens + num_steps > self.max_context:
                return False
            total = -(-(seq.seen_tokens + num_steps)
                      // self.state_manager.block_size)
            need += max(0, total - seq.cur_allocated_blocks)
        return need <= self.state_manager.free_blocks

    def decode_burst(self, batch_uids: Sequence[int],
                     last_tokens: Sequence[int], num_steps: int,
                     temperatures: Optional[Sequence[float]] = None,
                     seed: int = 0) -> np.ndarray:
        """Generate ``num_steps`` tokens for every (already prefilled) UID
        in one call with sampling on the device; returns ``[len(uids),
        num_steps]``. The batch is padded to its bucket
        (``burst_inputs``); on CUDA the burst replays the bucket's captured
        decode step (``DecodeGraphs``)."""
        if not self.can_burst(batch_uids, num_steps):
            raise RuntimeError("burst does not fit KV budget; call can_burst")
        seqs, (tokens, positions, tables, temps) = self.burst_inputs(
            batch_uids, last_tokens, num_steps, temperatures)
        toks = self.decode_graphs.run(tokens, positions, tables, temps, num_steps, seed)
        for seq in seqs:
            seq.post_forward(num_steps)
        return toks[:len(batch_uids)]

    def burst_inputs(self, batch_uids: Sequence[int], last_tokens: Sequence[int],
                     num_steps: int, temperatures: Optional[Sequence[float]] = None):
        """Allocate the blocks of ``num_steps`` more tokens for every UID and
        build the burst's padded host inputs: ``(seqs, (tokens [B],
        positions [B], tables [B, mp], temperatures [B]))`` with B the
        power-of-two bucket of ``len(uids)`` (at least ``BURST_BUCKET_LO``)
        and ``mp`` ``_bucket_blocks``. Padded rows hold token 0, position 0,
        a table of the null block 0 and temperature 0. Allocating twice for
        the same tokens allocates nothing more."""
        sm = self.state_manager
        seqs = []
        for uid in batch_uids:
            seq = sm.get_sequence(uid)
            sm.allocate_blocks(seq, num_steps)
            seqs.append(seq)
        B = _next_bucket(len(batch_uids), lo=BURST_BUCKET_LO)
        mp = self._bucket_blocks(batch_uids)
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, mp), np.int32)
        temps = np.zeros((B,), np.float32)
        tokens[:len(seqs)] = np.asarray(last_tokens, np.int32)
        for i, seq in enumerate(seqs):
            positions[i] = seq.seen_tokens
            bt = seq.blocks[:mp]
            tables[i, :len(bt)] = bt
        if temperatures is not None:
            temps[:len(seqs)] = np.asarray(temperatures, np.float32)
        return seqs, (tokens, positions, tables, temps)

    def _bucket_blocks(self, uids) -> int:
        need = max((len(self.state_manager.get_sequence(u).blocks) for u in uids),
                   default=1)
        return min(self.max_blocks_per_seq, _next_bucket(max(need, 1), lo=4))


def build_engine(model: TransformerLM,
                 config: Optional[RaggedInferenceEngineConfig] = None,
                 params: Optional[Mapping[str, Any]] = None,
                 device: DeviceLike = None, seed: int = 0) -> InferenceEngineV2:
    """Engine from an in-memory model. ``params``: a state dict such as
    ``convert.params_from_jax`` returns; without it a meta-device model is
    filled from ``seed``. ``device``: ``cuda`` by default (raises without
    a GPU); ``"cpu"`` runs the plain PyTorch path."""
    return InferenceEngineV2(model, config=config, params=params,
                             device=device, seed=seed)
