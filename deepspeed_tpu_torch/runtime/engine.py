"""Training engine of the port.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``) on
one GPU, stepping eagerly:

- precision policy (``engine.py:97-150``): params in fp16 / bf16 / fp32 by
  the config, fp32 gradient accumulation unless ``data_types.
  grad_accum_dtype`` narrows it, fp32 master and moments unless the
  ``data_types`` / ``fp16_master_weights_and_grads`` knobs narrow them;
- ``train_batch`` (``:2848``): at ``gradient_accumulation_steps == 1`` the
  fused step (``_train_step_fn``): one forward and backward, then the update
  straight from the parameters' gradients, with no accumulation buffer; at
  gas > 1 the split ``forward`` / ``backward`` / ``step`` path with an fp32
  accumulation buffer;
- the apply boundary (``_apply_from_grads``): the fp16 overflow check,
  unscale and clip folded into one ``grad_scale`` device scalar that the
  optimizer folds into each gradient's fp32 cast (the gradient norm is
  taken over the gradients as they are, never pre-scaled), the skipped step
  on overflow and the loss-scale update;
- ``global_steps``, ``skipped_steps``, ``lr_scheduler``, ``optimizer``.

A gradient in the parameter dtype (bf16) is handed to the optimizer
kernel as it is: its cast to fp32 is exact and happens in the kernel's
load, so the fp32 gradient tree of the JAX step never exists in memory.

On a world of more than one rank, ``DataParallelEngine`` (below) runs the
same step data-parallel with ZeRO stages 0-3 and the ZeRO++ int8 wire, on
the barrier schedule or the layer-pipelined overlap schedule as the JAX
engine routes it (``overlap_route``), and sequence-parallel over a ``seq``
axis (Ulysses or ring attention).

``save_checkpoint`` / ``load_checkpoint`` (``:3135``, ``:3557``) write and
read the JAX engine's tags (``checkpoint/store.py``): the same keys,
shapes and dtypes, the port's per-layer ``[out, in]`` tensors stacked into
the JAX ``[L, in, out]`` leaves (``convert.JaxLeaf``); one file a rank on
a world of more than one, each rank writing the pieces it owns.
``checkpoint.async_save`` stages every tensor in host memory and writes on
a worker thread; ``checkpoint.keep_last_n`` retires old tags after each
commit.

Error feedback (``comm_transport.error_feedback``) rides the overlap
schedule's micro-step carry (``DataParallelEngine._micro_overlap``). The
1-bit optimizers (``onebit_adam``, ``onebit_lamb``, ``zero_one_adam``)
step in ``OnebitEngine`` / ``OnebitDataParallelEngine`` (below), which
``initialize`` builds for them: pure data parallelism, replicated params,
local gradients, the compressed momentum all-reduce inside ``update``.

Not ported yet: hpZ / MiCS and meshes with other axes (A6), offload (A9),
pipeline (A10); ``runtime/config.py`` raises for them. A model with MoE
layers trains on one rank (its expert weights ``[E, F, H]`` / ``[E, H, F]``
are leaves like any other, bucketed, clipped and stepped whole); on a world
of more than one rank it raises (``MOE_DATA_PARALLEL``).
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..accelerator import resolve_device
from ..checkpoint import store
from ..checkpoint.checkpoint_engine import AsyncCheckpointEngine, NpzCheckpointEngine
from ..comm import comm as dist
from ..convert import JaxLeaf, from_host, host_array, jax_leaf, to_jax_leaf
from ..ops.quantizer.quantizer import (fp8_reduce_scatter, quantized_all_gather,
                                       quantized_reduce_scatter)
from .config import DeepSpeedConfig
from .fp16.loss_scaler import (dynamic_loss_scale_state, has_overflow,
                               static_loss_scale_state, update_scale)
from .lr_schedules import build_lr_schedule
from .optimizers import build_optimizer, is_onebit
from ..utils.groups import DATA_AXIS
from .topology import MeshTopology, set_topology
from .overlap_planner import PLACEMENT_SCAN_CARRY, ZEROPP_ENTRY, plan_for
from .zero.overlap import build_tree_comm
from .zero.partition import ZeroPartitionPlan, shard_dim, shard_of

logger = logging.getLogger(__name__)

MOE_DATA_PARALLEL = (
    "MoE training on a world of more than one rank is not ported (ROADMAP A7: MoE under "
    "data parallelism, with the expert exchange of A6). The JAX engine is one SPMD "
    "program over the global batch: its capacity, its cumsum ranks and its me / ce "
    "means span every rank's tokens. Per-rank programs differ from it as soon as a "
    "choice drops, and the aux loss is not linear in the split of the batch")
SEQ_TASK_HEADS = (
    "sequence parallelism trains the language models (TransformerLM): a task head's pooled "
    "token and span labels need the whole sequence on a rank (ROADMAP A8)")

_NARROW = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp16": torch.float16, "float16": torch.float16,
           None: None, "fp32": None, "float32": None}


def _state_dtype(value, key: str):
    if value not in _NARROW:
        raise ValueError(f"data_types.{key} must be bf16/fp16/fp32, got {value!r}")
    return _NARROW[value]


# the loss-scale leaves of a tag and their dtypes (the JAX state's scalars)
_LOSS_SCALE = {"cur_hysteresis": np.int32, "cur_scale": np.float32, "dynamic": np.bool_,
               "iter": np.int32, "last_overflow_iter": np.int32}


@dataclasses.dataclass
class _TagLeaf:
    """One tensor leaf of a tag as this rank holds it: the port leaves
    stacked into it (or the one), this rank's tensor of each,
    the ZeRO shard dim of those tensors on the port leaf (None: whole) and
    the whole port leaf's shape. ``ranks`` > 0: per-rank state (the 1-bit
    optimizers' errors and local gradients), a leading axis of ``ranks``
    rows of which this rank holds its own."""
    leaves: List[JaxLeaf]
    tensors: List[torch.Tensor]
    dim: Optional[int]
    port_shape: Tuple[int, ...]
    ranks: int = 0

    @property
    def jax_shape(self) -> Tuple[int, ...]:
        shape = self.leaves[0].shape(self.port_shape, len(self.leaves))
        return ((self.ranks,) if self.ranks else ()) + shape

    @property
    def whole(self) -> bool:
        """Held whole and the same on every rank (rank 0 writes it)."""
        return self.dim is None and not self.ranks

    def spans(self, rank: int, n: int) -> List[Tuple[int, int]]:
        """This rank's span of the JAX leaf: all its layers, the shard's
        rows ``[rank * s, (rank + 1) * s)`` of dim ``dim`` (s = size / n,
        ``zero/partition.py`` ``shard_of``), every other dim whole; a
        per-rank leaf's row ``rank`` first."""
        region = [(0, d) for d in self.port_shape]
        if self.dim is not None:
            s = self.port_shape[self.dim] // n
            region[self.dim] = (rank * s, (rank + 1) * s)
        spans = self.leaves[0].span(region)
        if self.leaves[0].layer is not None:
            spans[0] = (0, len(self.leaves))
        return ([(rank, rank + 1)] if self.ranks else []) + spans

    def host(self) -> np.ndarray:
        """This rank's piece on the host, as the tag holds it."""
        a = host_array(to_jax_leaf(list(zip(self.leaves, self.tensors))))
        return a[None] if self.ranks else a

    def load(self, a: torch.Tensor) -> None:
        """Copy this rank's piece ``a`` (read at ``spans``) into the tensors."""
        a = a[0] if self.ranks else a
        for jl, t in zip(self.leaves, self.tensors):
            src = jl.swap_layout(a[jl.layer] if jl.layer is not None else a)
            t.copy_(src.reshape(()) if t.dim() == 0 else src)   # a scalar reads back 1-d


class _JaxGrads(Mapping):
    """Port gradients seen as the JAX tree's leaves, by path: each leaf
    built when read (the layers stacked, in the JAX axis order), in fp32,
    times ``inv``."""

    def __init__(self, groups: Dict[str, List[Tuple[JaxLeaf, str]]],
                 grads: Dict[str, torch.Tensor], inv: torch.Tensor):
        self.groups, self.grads, self.inv = groups, grads, inv

    def __getitem__(self, path: str) -> torch.Tensor:
        leaf = to_jax_leaf([(jl, self.grads[n]) for jl, n in self.groups[path]])
        return leaf.to(torch.float32, copy=True).mul_(self.inv)

    def __iter__(self):
        return iter(self.groups)

    def __len__(self) -> int:
        return len(self.groups)


class DeepSpeedEngine:
    # the topology the engine publishes (``set_topology``) at construction
    # and before each forward, as the JAX engine does: none on one rank, so
    # a model run here never sees an axis that an earlier engine published
    topology: Optional[MeshTopology] = None
    # whether micro steps run the layer-pipelined overlap schedule, and why
    # not where it was asked for (``DataParallelEngine``; one rank has no
    # collectives to overlap)
    _overlap_active = False
    _overlap_fallback = ""

    def __init__(self, model, config: Optional[DeepSpeedConfig] = None,
                 config_dict: Optional[Dict[str, Any]] = None, seed: int = 42,
                 init_params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None):
        self.config = config = config or DeepSpeedConfig(config_dict or {})
        if config.data_parallel_size != dist.get_world_size():
            raise ValueError(f"a data-parallel size of {config.data_parallel_size} needs as "
                             f"many ranks; the world has {dist.get_world_size()}")
        set_topology(self.topology)
        self.device = resolve_device(device)
        self.model = model

        # -- precision policy ------------------------------------------------
        if config.fp16.enabled:
            self.param_dtype = torch.float16
        elif config.bf16.enabled:
            self.param_dtype = torch.bfloat16
        else:
            self.param_dtype = torch.float32
        self.grad_dtype = _state_dtype(config.data_types_grad_accum_dtype,
                                       "grad_accum_dtype") or torch.float32

        # -- optimizer + schedule ---------------------------------------------
        self.optimizer = self._build_optimizer(config)
        self.lr_scheduler = build_lr_schedule(config.scheduler, self.optimizer.lr)

        # -- parameters and state ---------------------------------------------
        self.grad_acc: Dict[str, torch.Tensor] = {}   # split path only, lazily
        self._init_state(seed, init_params)
        self.loss_scale_state = self._loss_scale_state()

        self.global_steps = 0
        self.skipped_steps = 0
        self.micro_steps = 0
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_micro_batch_size_per_gpu = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size
        self.gradient_clipping = config.gradient_clipping
        self._last_grad_norm = None
        self._cached_loss = None

        # -- checkpoints: synchronous npz writes, or write-behind ----------------
        self._ckpt_async = bool(config.checkpoint_config.get("async_save", False))
        if self._ckpt_async and dist.get_world_size() > 1:
            logger.info("checkpoint.async_save: a world of more than one rank saves "
                        "synchronously (its rank files need the barriers of the commit)")
            self._ckpt_async = False
        self.checkpoint_engine = (AsyncCheckpointEngine() if self._ckpt_async
                                  else NpzCheckpointEngine())

    def _build_optimizer(self, config: DeepSpeedConfig):
        """The config's optimizer, its state at the ``data_types`` dtypes."""
        if is_onebit(config.optimizer):
            raise ValueError(f"optimizer {config.optimizer.type!r} steps in OnebitEngine / "
                             "OnebitDataParallelEngine, which initialize builds for it")
        opt_dtypes = {}
        if config.fp16_master_weights_and_grads:
            opt_dtypes["master_dtype"] = self.param_dtype
        mdt = _state_dtype(config.data_types_optimizer_moment_dtype, "optimizer_moment_dtype")
        sqdt = _state_dtype(config.data_types_optimizer_moment_sq_dtype,
                            "optimizer_moment_sq_dtype")
        if mdt is not None:
            opt_dtypes["moment_dtype"] = mdt
        if sqdt is not None:
            opt_dtypes["moment_sq_dtype"] = sqdt
        return dataclasses.replace(build_optimizer(config.optimizer), **opt_dtypes)

    def _init_state(self, seed: int, init_params) -> None:
        self._place_model(seed, init_params)
        self.params = dict(self.model.named_parameters())
        self.opt_state = self.optimizer.init({n: p.detach() for n, p in self.params.items()})

    def _place_model(self, seed: int, init_params) -> None:
        """Give the model storage on the engine's device, its weights from
        ``init_params`` (a state_dict) or from a seeded generator, in the
        param dtype, trainable."""
        model = self.model
        on_meta = any(p.is_meta for p in model.parameters())
        if on_meta:
            model.to_empty(device=self.device)
        else:
            model.to(self.device)
        if init_params is not None:
            model.load_state_dict({k: torch.as_tensor(v) for k, v in init_params.items()})
        elif on_meta:
            model.init_weights(torch.Generator(device=self.device).manual_seed(seed))
        for p in model.parameters():
            p.data = p.data.to(self.param_dtype)
            p.requires_grad_(True)

    def _loss_scale_state(self):
        fp16 = self.config.fp16
        if fp16.enabled and fp16.loss_scale == 0:
            return dynamic_loss_scale_state(fp16.initial_scale_power, fp16.hysteresis)
        return static_loss_scale_state(fp16.loss_scale if fp16.enabled else 1.0)

    # -- data --------------------------------------------------------------
    def _prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Check the token ids, as the JAX engine does, and move every key
        of the batch to the device (``input_ids``, ``labels``, and an
        encoder's ``token_type_ids``, ``attention_mask`` or a QA head's
        ``start_positions`` / ``end_positions``)."""
        ids = batch.get("input_ids")
        vocab = getattr(getattr(self.model, "config", None), "vocab_size", None)
        if ids is not None and vocab is not None:
            arr = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids)
            if int(arr.max()) >= vocab or int(arr.min()) < 0:
                raise ValueError(f"input_ids out of range for vocab_size={vocab}: min id "
                                 f"{int(arr.min())}, max id {int(arr.max())}")
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # -- apply boundary ----------------------------------------------------------
    def _scalar(self, x: float) -> torch.Tensor:
        return torch.full((), x, dtype=torch.float32, device=self.device)

    def _overflow(self, grads: Dict[str, torch.Tensor]) -> bool:
        return bool(has_overflow(grads.values()))

    def _grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.sqrt(torch.stack([g.float().square().sum() for g in grads.values()]).sum())

    def _update(self, grads: Dict[str, torch.Tensor], lr: float, factor) -> None:
        self.optimizer.update(grads, self.opt_state, lr, grad_scale=factor,
                              params_out=self.params)

    def _update_loss_scale(self, overflow: bool) -> None:
        fp16 = self.config.fp16
        self.loss_scale_state = update_scale(
            self.loss_scale_state, overflow, scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis,
            consecutive_hysteresis=fp16.consecutive_hysteresis)

    def _apply_from_grads(self, grads: Dict[str, torch.Tensor], lr: float):
        """Unscale, clip, update, loss-scale bookkeeping. Returns
        ``(overflow, gnorm)``; ``gnorm`` is a device scalar."""
        scale = self.loss_scale_state["cur_scale"]
        overflow = self._overflow(grads) if self.config.fp16.enabled else False
        inv = self._scalar(0.0 if overflow else float(np.float32(1.0) / np.float32(scale)))
        gnorm = self._scalar(0.0) if overflow else self._grad_norm(grads) * inv
        factor = inv
        if self.gradient_clipping > 0:
            clip = torch.clamp(self._scalar(self.gradient_clipping) / (gnorm + 1e-6), max=1.0)
            factor = inv * clip
        if not overflow:
            with torch.no_grad():
                self._update(grads, lr, factor)
        self._update_loss_scale(overflow)
        return overflow, gnorm

    def _grads(self) -> Dict[str, torch.Tensor]:
        """The parameters' gradients at ``grad_dtype`` (a widening cast is
        left to the optimizer kernel, where it is exact)."""
        out = {}
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if torch.finfo(g.dtype).bits > torch.finfo(self.grad_dtype).bits:
                g = g.to(self.grad_dtype)
            out[n] = g
        return out

    def _post_step(self, overflow: bool, gnorm) -> None:
        self.global_steps += 1
        if overflow:
            # a skipped update does not consume the schedule
            self.skipped_steps += 1
        else:
            self.lr_scheduler.step()
        self._last_grad_norm = gnorm

    def _zero_param_grads(self) -> None:
        for p in self.params.values():
            p.grad = None

    # -- fused gas == 1 step --------------------------------------------------------
    def _train_batch_fused(self, batch) -> torch.Tensor:
        set_topology(self.topology)
        batch = self._prepare_batch(batch)
        scale = self.loss_scale_state["cur_scale"]
        loss = self.model.loss(batch)
        (loss * scale).backward()
        overflow, gnorm = self._apply_from_grads(self._grads(), self.lr_scheduler.get_lr())
        self._zero_param_grads()
        self.micro_steps += 1
        self._post_step(overflow, gnorm)
        return self._global_loss(loss)

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The reported loss: this rank's (one rank is the world)."""
        return loss.detach()

    # -- split path ------------------------------------------------------------------
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Loss of one micro-batch; its gradients (of the loss scaled by
        ``loss_scale / gas``) are added to the fp32 accumulation buffer."""
        set_topology(self.topology)
        batch = self._prepare_batch(batch)
        self._ensure_grad_acc()
        scale = float(np.float32(self.loss_scale_state["cur_scale"])
                      / np.float32(self.gradient_accumulation_steps))
        loss = self.model.loss(batch)
        (loss * scale).backward()
        with torch.no_grad():
            for n, p in self.params.items():
                if p.grad is not None:
                    self.grad_acc[n] += p.grad.to(self.grad_dtype)
        self._zero_param_grads()
        self._cached_loss = self._global_loss(loss)
        return self._cached_loss

    def backward(self, loss=None):
        """Gradients were produced in ``forward``; this marks the micro-step
        boundary."""
        self.micro_steps += 1
        return self._cached_loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps == 0

    def step(self) -> None:
        """Apply the optimizer at accumulation boundaries."""
        if not self.is_gradient_accumulation_boundary():
            return
        overflow, gnorm = self._apply_from_grads(self.grad_acc, self.lr_scheduler.get_lr())
        for g in self.grad_acc.values():
            g.zero_()
        self._post_step(overflow, gnorm)

    def train_batch(self, data_iter_or_batch) -> torch.Tensor:
        """One optimizer step: ``gradient_accumulation_steps`` micro-steps
        and the update. A dict is replayed for every micro-step; an
        iterator yields one batch per micro-step."""
        gas = self.gradient_accumulation_steps
        if isinstance(data_iter_or_batch, dict):
            batches = [data_iter_or_batch] * gas
        else:
            batches = [next(data_iter_or_batch) for _ in range(gas)]
        if gas == 1 and not self.grad_acc:
            return self._train_batch_fused(batches[0])
        losses = []
        for batch in batches:
            losses.append(self.forward(batch))
            self.backward()
        self.step()
        return torch.stack(losses).mean()

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any]) -> torch.Tensor:
        set_topology(self.topology)
        return self.model.loss(self._prepare_batch(batch))

    # -- state and introspection ---------------------------------------------------
    def load_opt_state(self, state: Dict[str, Any]) -> None:
        """Copy an optimizer state (``step`` and per-parameter ``master`` /
        moment tensors by name, e.g. from ``convert.opt_state_from_jax``)
        into the engine's buffers."""
        with torch.no_grad():
            for key, leaves in state.items():
                if key == "step":
                    self.opt_state["step"] = int(leaves)
                    continue
                for n, t in leaves.items():
                    self.opt_state[key][n].copy_(torch.as_tensor(t))

    def get_lr(self):
        return [self.lr_scheduler.get_lr()]

    def get_global_grad_norm(self) -> float:
        return float(self._last_grad_norm) if self._last_grad_norm is not None else 0.0

    def loss_scale(self) -> float:
        return float(self.loss_scale_state["cur_scale"])

    def zero_optimization_stage(self) -> int:
        return self.config.zero_stage

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.params.items()}

    # -- checkpoints ---------------------------------------------------------------
    def _ensure_grad_acc(self) -> None:
        """The split path's fp32 accumulation buffer, made at first use."""
        if not self.grad_acc:
            self.grad_acc = {n: torch.zeros(p.shape, dtype=self.grad_dtype, device=self.device)
                             for n, p in self.params.items()}

    def _tag_has_grad_acc(self) -> bool:
        """Whether the tag holds ``grad_acc/...`` leaves: where the JAX engine
        keeps a gradient buffer in its state (gas > 1, the ZeRO++ explicit
        micro step, a split path taken); its fused gas == 1 step keeps none."""
        return (self.gradient_accumulation_steps > 1 or self.config.zero_config.zeropp
                or bool(self.grad_acc))

    def _rank_and_world(self) -> Tuple[int, int]:
        return 0, 1

    def _port_shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.params[name].shape)

    def _local(self, group: str, name: str) -> Tuple[torch.Tensor, Optional[int]]:
        """This rank's tensor of a port leaf of ``group`` (``params``,
        ``grad_acc`` or ``opt/<slot>``) and its shard dim (None: whole)."""
        if group == "params":
            return self.params[name].detach(), None
        if group == "grad_acc":
            return self.grad_acc[name], None
        return self.opt_state[group[len("opt/"):]][name], None

    def _tag_leaves(self) -> Dict[str, _TagLeaf]:
        """Every tensor leaf of this engine's tag, by key (``params/...``,
        ``grad_acc/...``, ``opt/<slot>/...``: the JAX state's paths)."""
        groups = ["params"]
        if self._tag_has_grad_acc():
            self._ensure_grad_acc()
            groups.append("grad_acc")
        groups += [f"opt/{slot}" for slot in self.opt_state if slot not in ("step", "buckets")]
        out: Dict[str, _TagLeaf] = {}
        for group in groups:
            for name in self.params:
                shape = self._port_shape(name)
                jl = jax_leaf(name, len(shape))
                t, dim = self._local(group, name)
                e = out.setdefault(f"{group}/{jl.path}", _TagLeaf([], [], dim, shape))
                e.leaves.append(jl)
                e.tensors.append(t)
        return out

    def _tag_scalars(self) -> Dict[str, np.ndarray]:
        out = {f"opt/{k}": np.asarray(v, np.int32) for k, v in self.opt_state.items()
               if k in ("step", "var_counter")}
        for k, dt in _LOSS_SCALE.items():
            out[f"loss_scale/{k}"] = np.asarray(self.loss_scale_state[k], dt)
        return out

    def _stage(self) -> store.Staged:
        """The tag in host memory, leaf by leaf: every leaf whole on one
        rank; on a world of more than one, the pieces this rank owns (its
        shards at their global spans, and the whole leaves and scalars on
        rank 0 alone: the JAX ``replica_id == 0`` rule)."""
        rank, n = self._rank_and_world()
        leaves, scalars = self._tag_leaves(), self._tag_scalars()
        keys = sorted([*leaves, *scalars])
        staged = store.Staged(keys, {}, {}, {}, rank_files=n > 1)
        for i, key in enumerate(keys):
            if key in scalars:
                a = scalars[key]
                staged.dtypes[key], staged.shapes[key] = str(a.dtype), []
                spans = []
            else:
                e = leaves[key]
                staged.dtypes[key] = str(e.tensors[0].dtype).replace("torch.", "")
                staged.shapes[key] = list(e.jax_shape)
                if n > 1 and e.whole and rank != 0:
                    continue
                spans = e.spans(rank, n)
                a = e.host()
            if n == 1:
                staged.arrays[f"leaf_{i}"] = a
            elif rank == 0 or spans:
                staged.arrays[store.piece_key(i, spans)] = a
        return staged

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict[str, Any]] = None,
                        save_latest: bool = True) -> None:
        """Save a tag under ``save_dir`` (``global_step{N}`` by default) with
        ``client_state`` and the engine's counters and schedule; repoint
        ``latest`` last. With ``checkpoint.async_save`` it returns once every
        tensor is in host memory and writes on a worker thread, ``latest``
        last in the same task."""
        tag = tag or f"global_step{self.global_steps}"
        client_state = dict(client_state or {})
        client_state.update({
            "global_steps": self.global_steps,
            "skipped_steps": self.skipped_steps,
            "micro_steps": self.micro_steps,
            "lr_scheduler": self.lr_scheduler.state_dict(),
        })
        # a save still in flight would interleave its writes with this one's
        self.checkpoint_engine.commit(tag)
        with torch.no_grad():
            staged = self._stage()
        rank = self._rank_and_world()[0]

        def write():
            store.save_checkpoint(save_dir, tag, staged, client_state, save_latest=save_latest)
            if rank == 0:
                self._retire_old_checkpoints(save_dir, tag)

        self.checkpoint_engine.submit(tag, write)

    def _retire_old_checkpoints(self, save_dir: str, tag: str) -> None:
        """Keep-last-N retention (``checkpoint.keep_last_n``; 0 keeps all):
        after the commit, never the tag ``latest`` names, the pinned one nor
        the tag just written; it never fails a save."""
        keep = int(self.config.checkpoint_config.get("keep_last_n", 0))
        if keep > 0:
            store.retire_old_tags(save_dir, keep, protect=(tag,))

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True
                        ) -> Tuple[Optional[str], Dict[str, Any]]:
        """Load a tag (``latest`` by default, with the store's fallback
        rules) into the engine; returns ``(tag, client_state)``, or ``(None,
        {})`` when there is none. Pending async saves commit first. Each rank
        reads only its own slices. Without ``load_optimizer_states`` the
        optimizer starts afresh from the loaded weights: master copies of the
        params, zero moments, step 0. A leaf the tag lacks keeps the engine's
        value (as in the JAX engine), except the accumulation buffer, zeroed."""
        self.checkpoint_engine.commit(tag or "")
        reader, client_state, tag = store.load_checkpoint(load_dir, tag)
        if reader is None:
            return None, {}
        rank, n = self._rank_and_world()
        with reader, torch.no_grad():
            for key, e in self._tag_leaves().items():
                src = key
                if key.startswith("opt/") and not load_optimizer_states:
                    if not key.startswith("opt/master/"):
                        for t in e.tensors:
                            t.zero_()
                        continue
                    src = "params/" + key[len("opt/master/"):]
                if src not in reader:
                    if key.startswith("grad_acc/"):
                        for t in e.tensors:
                            t.zero_()
                    continue
                if reader.shape(src) != e.jax_shape:
                    raise ValueError(f"checkpoint leaf '{src}' shape {reader.shape(src)} != "
                                     f"expected {e.jax_shape}")
                # up to the device whole, so that the transposes run there
                idx = tuple(slice(lo, hi) for lo, hi in e.spans(rank, n))
                e.load(from_host(reader.read(src, idx), reader.dtype(src)).to(e.tensors[0].device))
            for key, like in self._tag_scalars().items():
                if key.startswith("opt/"):
                    self.opt_state[key[len("opt/"):]] = (
                        int(reader.read(key)) if load_optimizer_states and key in reader else 0)
                elif key in reader:
                    self.loss_scale_state[key.split("/")[1]] = like.dtype.type(
                        reader.read(key)).item()
        self.global_steps = client_state.get("global_steps", 0)
        self.skipped_steps = client_state.get("skipped_steps", 0)
        self.micro_steps = client_state.get("micro_steps", 0)
        if "lr_scheduler" in client_state:
            self.lr_scheduler.load_state_dict(client_state["lr_scheduler"])
        return tag, client_state


# what a model needs for the overlap schedule (JAX ``_zero_overlap_eligibility``)
OVERLAP_MODEL_HOOKS = ("embed", "block_apply", "head", "scan_blocks_pipelined",
                       "derive_labels", "head_loss", "combine_aux")


def overlap_route(zc, model, shapes: Dict[str, Tuple[int, ...]], n_dp: int,
                  pure_data: bool = True) -> Tuple[bool, bool, str]:
    """``(stage3_overlap, active, fallback)``: the JAX engine's dispatch of
    a micro step (``engine.py:280-289``, ``_build_zeropp_micro`` and
    ``_zero_overlap_eligibility``, ``:1338-1380``). ZeRO++ takes the overlap
    schedule when ``overlap_comm`` is true (the stage-3 default); plain
    stage 3 only when ``overlap_comm: true`` is written and the topology is
    pure data parallelism (``pure_data``); everything else keeps the barrier
    schedule. A model without the schedule's hooks, or a block leaf that
    JAX's stacked ``[L, ...]`` leaf would shard over its layer dim, falls
    back to the barrier schedule with JAX's reason."""
    stage3_overlap = (not zc.zeropp and zc.stage == 3 and zc.overlap_comm
                      and zc.overlap_comm_explicit and pure_data)
    if not (zc.zeropp or stage3_overlap) or not zc.overlap_comm:
        return stage3_overlap, False, ""
    for attr in OVERLAP_MODEL_HOOKS:
        if not hasattr(model, attr):
            return stage3_overlap, False, (f"model {type(model).__name__} lacks .{attr} "
                                           "(TransformerLM family required)")
    L = model.config.num_layers
    for name, shape in shapes.items():
        if not name.startswith("blocks.0."):
            continue
        stacked = jax_leaf(name, len(shape)).shape(shape, L)
        for dim in (shard_dim(stacked, n_dp) if zc.stage >= 2 else None,
                    shard_dim(stacked, n_dp, zc.stage3_param_persistence_threshold)
                    if zc.stage >= 3 else None):
            if dim == 0:
                spec = ", ".join(["'data'"] + ["None"] * (len(stacked) - 1))
                return stage3_overlap, False, (f"block leaf sharded over the layer dim "
                                               f"(PartitionSpec({spec}))")
    return stage3_overlap, True, ""


def _jax_order(shapes: Dict[str, Tuple[int, ...]]) -> List[str]:
    """The names of ``shapes`` in the flatten order of their JAX tree (its
    sorted keys)."""
    return sorted(shapes, key=lambda k: tuple(jax_leaf(k, len(shapes[k])).path.split("/")))


@dataclasses.dataclass
class _OverlapSchedule:
    """What ``DataParallelEngine._build_overlap`` sets up once."""
    plan: Any
    lps: int
    depth: int
    blk_names: List[str]      # a block's parameter names, in JAX flatten order
    blk_comm: Any
    rest_comms: Tuple[Any, ...]   # (embed, head) under the edge split, else (rest,)
    split: bool
    # the error-feedback carry's slot shapes (``_ef_zeros``), None without one
    ef_struct: Optional[Dict[str, Any]] = None


# JAX's warning where error feedback is asked for and the schedule cannot
# carry the residual (``engine.py:512-517``)
EF_NOT_CARRIED = ("comm_transport.error_feedback: this engine's schedule does not carry "
                  "the residual state (pipelined micro + overlap planner required); error "
                  "feedback is active only for explicit TreeComm.scatter(err=...) callers")


class DataParallelEngine(DeepSpeedEngine):
    """Data-parallel training over the ``torch.distributed`` world, ZeRO
    stages 0-3 and the ZeRO++ int8 wire, on the barrier schedule (below)
    or, where ``overlap_route`` sends it, on the layer-pipelined overlap
    schedule (``_micro_overlap``).

    Counterpart of the JAX engine's explicit micro step
    (``_zeropp_micro_env:1319``, ``_build_zeropp_micro_barrier:1383``) and
    its sharded apply step. The partition plan (``zero/partition.py``) gives
    each leaf's shard dim for params, grads and optimizer state; each rank
    holds its shard (rank r: slice r along that dim):

    - stage 3: the param shards, at the param dtype, between steps (a leaf
      below ``stage3_param_persistence_threshold`` stays whole);
    - stage >= 1: the fp32 master and moments of its shard, bucketed and
      stepped by the fused Adam / Lion kernels as on one device;
    - stage >= 2: an fp32 gradient-accumulation shard.

    A micro step (``forward``) gathers the full params at stage 3
    (``quantized_all_gather`` at group 256 under qwZ, else a full-width
    all-gather), runs the forward and backward on them, reduce-scatters each
    leaf's gradient (``resolve_transport(KIND_GRAD, "reduce_scatter")``:
    ``quantized_reduce_scatter`` at the plan's group size on the int8 wire,
    else full width; a leaf with no shard dim is all-reduced), divides by
    the world size, adds the result to the accumulation buffer and releases
    the gathered params. Under ZeRO++ the gradients take the int8 wire by
    the planner's default even when only qwZ is set, and leaves under
    ``comm_transport.min_bytes`` stay full width; plain data parallelism
    runs the same schedule at full width (``kind=None``), the function the
    JAX package's declarative path computes. The loss is averaged over the
    ranks.

    The apply step (``step``) takes the global gradient norm (an all-reduce
    of the local sums of squares), the fp16 overflow flag over all ranks
    and the clip factor, updates the optimizer shards, and all-gathers at
    full width every updated shard whose param is held whole (all of them
    at stages 1-2; the persistent small leaves at stage 3), so every rank
    again holds its params. Every launch is recorded with
    ``comm.record_collective`` (logical and wire bytes, on the critical
    path).

    With a ``seq`` axis (``topology.seq`` > 1) each rank takes the rows of
    its data coordinate and the sequence slice of its seq coordinate
    (``_prepare_batch``). Three things follow the global sequence, not the
    slice: the next-token labels are derived from the global batch before
    the split, so a slice's last label is the next slice's first token and
    only the last slice ends in -100; the loss is the global token mean, each
    rank's summed loss over the global batch's count of labels, and the
    reported loss their sum over the ranks; the gradients are summed over
    data x seq, which is the world, so they equal those of one rank running
    the whole batch. ZeRO partitions over data x seq, as JAX's dp set does
    (``zero/partition.py``), so the tags are those of a data-parallel
    engine of the same world. ZeRO++ with ``seq`` > 1 raises, as in JAX.

    Without a ``device``, a rank runs on ``cuda:(local rank mod cards)``:
    its own card under torchrun, the one card for every rank of a machine
    with one.
    """

    def __init__(self, model, config: Optional[DeepSpeedConfig] = None,
                 config_dict: Optional[Dict[str, Any]] = None, seed: int = 42,
                 init_params: Optional[Dict[str, torch.Tensor]] = None, device=None,
                 topology: Optional[MeshTopology] = None):
        config = config or DeepSpeedConfig(config_dict or {})
        self.topology = topology if topology is not None else MeshTopology(config.topology)
        self.n_dp = n = self.topology.data_parallel_size
        self.rank = self.topology.rank
        self.sp = self.topology.sequence_parallel_size
        if getattr(model.config, "moe", None) is not None and n > 1:
            raise NotImplementedError(MOE_DATA_PARALLEL)
        if self.sp > 1:
            from ..models.transformer import TransformerLM
            if not isinstance(model, TransformerLM):
                raise NotImplementedError(SEQ_TASK_HEADS)
            if config.zero_config.zeropp:
                raise ValueError("ZeRO++ (zero_quantized_weights/gradients, hpZ) requires a "
                                 f"pure data-parallel mesh; got {self.topology}")
        if dist.get_world_size() != n or config.data_parallel_size != n:
            raise ValueError(f"the topology's data axis ({n}), the config's data-parallel "
                             f"size ({config.data_parallel_size}) and the world "
                             f"({dist.get_world_size()}) must agree")
        dist.reset_transport()
        dist.configure_transport(**config.comm_transport)
        self._denominator = None
        if device is None and torch.cuda.is_available():
            # a card a local rank; ranks beyond the cards share them
            device = torch.device("cuda", dist.get_local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(device)
        super().__init__(model, config=config, seed=seed, init_params=init_params,
                         device=device)
        self._stage3_overlap, self._overlap_active, self._overlap_fallback = self._route()
        if self._overlap_fallback and self.rank == 0:
            logger.info(f"zero overlap_comm: falling back to the barrier schedule "
                        f"({self._overlap_fallback})")
        self._sched = self._build_overlap() if self._overlap_active else None
        # the error-feedback residuals, carried from micro step to micro step
        # (optimizer steps included) where the schedule carries them
        self._ef_carry_active = self._sched is not None and self._sched.ef_struct is not None
        self._ef_state = None
        if dist.transport_config()["error_feedback"] and not self._ef_carry_active:
            logger.warning(EF_NOT_CARRIED)

    def _route(self) -> Tuple[bool, bool, str]:
        """``overlap_route`` of this engine's micro step."""
        return overlap_route(self.config.zero_config, self.model, self.zero_plan.shapes,
                             self.n_dp, pure_data=self.sp == 1)

    def _build_overlap(self) -> _OverlapSchedule:
        """The overlap schedule's plan and launch sets (JAX
        ``_build_zeropp_micro_overlap``, ``engine.py:1548-1640``): the
        planner's plan, the block ``TreeComm`` over one step's bundle of
        layers, and the rest leaves in one ``TreeComm``, or split into an
        embed side and a head side when the plan says ``split_edge_leaves``."""
        zc, c = self.config.zero_config, self.model.config
        plan = plan_for(ZEROPP_ENTRY, config_flag=self.config.overlap_plan)
        planned = plan.placement == PLACEMENT_SCAN_CARRY
        ag_bucket = plan.allgather_bucket or zc.allgather_bucket_size
        rs_bucket = plan.reduce_bucket or zc.reduce_bucket_size
        L = c.num_layers
        lps = 2 if c.remat_policy == "alternating" and L % 2 == 0 and L >= 2 else 1
        shapes = self.zero_plan.shapes
        dt = self.param_dtype

        def tree_comm(names, shape_of, dim_of, overlapped, name, defer=False):
            return build_tree_comm(
                names, [dim_of(self.param_dims, k) for k in names],
                [dim_of(self.grad_dims, k) for k in names], [shape_of(k) for k in names],
                [dt] * len(names), n_dp=self.n_dp, quant_weights=zc.zero_quantized_weights,
                quant_grads=zc.zero_quantized_gradients, allgather_bucket=ag_bucket,
                reduce_bucket=rs_bucket, overlapped=overlapped, name=name,
                defer_replicated=defer)

        blk = "blocks.0."
        blk_names = [k[len(blk):] for k in _jax_order({k: s for k, s in shapes.items()
                                                       if k.startswith(blk)})]
        # a bundle leaf is [lps, *leaf]: its shard dim one further in
        bundle_dim = lambda dims, k: None if dims[blk + k] is None else dims[blk + k] + 1
        blk_comm = tree_comm(blk_names, lambda k: (lps,) + shapes[blk + k], bundle_dim, True,
                             "blocks", defer=planned and plan.defer_replicated)
        rest = _jax_order({k: s for k, s in shapes.items() if not k.startswith("blocks.")})
        embed_keys = getattr(self.model, "embed_param_keys", None)
        head = ([k for k in rest if k.split(".")[0] not in embed_keys]
                if embed_keys is not None else [])
        split = planned and plan.split_edge_leaves and bool(head)
        leaf = lambda dims, k: dims[k]
        if split:
            rest_comms = (tree_comm([k for k in rest if k not in head], shapes.get, leaf, False,
                                    "rest-embed"),
                          tree_comm(head, shapes.get, leaf, True, "rest-head"))
        else:
            rest_comms = (tree_comm(rest, shapes.get, leaf, False, "rest"),)
        oversize = blk_comm.oversize + sum((cm.oversize for cm in rest_comms), [])
        if oversize:
            logger.warning(f"zero bucket plan: {len(oversize)} leaves exceed allgather/reduce "
                           f"bucket sizes even after splitting (first: {oversize[0]}); raise "
                           f"the bucket knobs or accept single oversized launches")
        if self.rank == 0:
            logger.info(f"zero overlap schedule ({'plan: ' + plan.summary() if planned else 'hand'}"
                        f"): {L} layers x {lps}/step; {blk_comm.plan_summary()}; "
                        + "; ".join(cm.plan_summary() for cm in rest_comms))
        # the error-feedback carry (JAX ``engine.py:1656-1693``): a residual a
        # block reduction launch for each step, and one a rest launch
        ef_struct = None
        if planned and plan.carry_error_feedback and dist.transport_config()["error_feedback"]:
            keys = ("rest_embed", "rest_head") if split else ("rest",)
            ef_struct = {"blocks": [blk_comm.err_struct() for _ in range(L // lps)],
                         **{k: cm.err_struct() for k, cm in zip(keys, rest_comms)}}
            n_slots = sum(s is not None for slots in [*ef_struct["blocks"], *(
                ef_struct[k] for k in keys)] for s in slots)
            if not n_slots:
                ef_struct = None   # no int8 bucket with a shard dim
            elif self.rank == 0:
                logger.info(f"zero overlap schedule: error-feedback residuals ride the "
                            f"micro-step carry ({n_slots} slots)")
        return _OverlapSchedule(plan=plan, lps=lps, depth=plan.prefetch_depth if planned else 1,
                                blk_names=blk_names, blk_comm=blk_comm, rest_comms=rest_comms,
                                split=split, ef_struct=ef_struct)

    def _ef_zeros(self) -> Dict[str, Any]:
        """The error-feedback carry's first state: a zero residual a slot
        (fp32 on the engine's device), None where feedback does not apply."""
        zeros = lambda slots: [None if s is None else torch.zeros(
            s, dtype=torch.float32, device=self.device) for s in slots]
        return {k: ([zeros(slots) for slots in v] if k == "blocks" else zeros(v))
                for k, v in self._sched.ef_struct.items()}

    # -- state -------------------------------------------------------------------
    def _init_state(self, seed: int, init_params) -> None:
        zc = self.config.zero_config
        if self.optimizer.name == "lamb" and zc.stage >= 1:
            raise NotImplementedError("LAMB over sharded optimizer state needs each leaf's "
                                      "global norm: ROADMAP A6")
        n, r = self.n_dp, self.rank
        self._place_model(seed, init_params)
        self.params = dict(self.model.named_parameters())
        self.zero_plan = ZeroPartitionPlan(zc, {k: p.shape for k, p in self.params.items()}, n)
        self.param_dims = self.zero_plan.param_dims()
        self.grad_dims = self.zero_plan.grad_dims()
        self.opt_dims = self.zero_plan.optimizer_dims()
        full = {k: p.detach() for k, p in self.params.items()}
        self.opt_state = self.optimizer.init(
            {k: shard_of(t, self.opt_dims[k], r, n) for k, t in full.items()})
        self.param_shards = {k: shard_of(full[k], d, r, n)
                             for k, d in self.param_dims.items() if d is not None}
        # the param-dtype output of an optimizer shard whose param is held whole
        self._cast_shards = {k: torch.empty_like(shard_of(full[k], d, r, n))
                             for k, d in self.opt_dims.items()
                             if d is not None and self.param_dims[k] is None}
        self.grad_acc = {k: torch.zeros(shard_of(t, self.grad_dims[k], r, n).shape,
                                        dtype=self.grad_dtype, device=self.device)
                         for k, t in full.items()}
        del full
        self._release_params()

    def _release_params(self) -> None:
        """Drop the full copies of the stage-3 sharded params."""
        for k in self.param_shards:
            self.params[k].data = torch.empty(0, dtype=self.param_dtype, device=self.device)

    def _gather_params(self) -> None:
        """Rebuild the full params of the stage-3 sharded leaves
        (``gather_full``)."""
        zc = self.config.zero_config
        for k, shard in self.param_shards.items():
            d = self.param_dims[k]
            nbytes = shard.numel() * shard.element_size()
            tp = dist.resolve_transport(
                dist.KIND_PARAM if zc.zeropp else None, "all_gather", nbytes, DATA_AXIS,
                requested=dist.WIDTH_INT8 if zc.zero_quantized_weights else None)
            dist.record_collective("all_gather", nbytes, DATA_AXIS, overlapped=False,
                                   wire_bytes=tp.wire_bytes(shard.numel(), shard.element_size()))
            xm = shard.movedim(d, 0)
            g = quantized_all_gather(xm) if tp.width == dist.WIDTH_INT8 else dist.all_gather(xm)
            self.params[k].data = g.movedim(0, d).contiguous()

    def _scatter_grad(self, k: str, g: torch.Tensor) -> torch.Tensor:
        """A leaf's gradient reduced over the ranks and divided by their
        number: this rank's shard of it, or all of it for a leaf with no
        grad shard dim."""
        zc = self.config.zero_config
        d = self.grad_dims[k]
        if d is None:
            dist.record_collective("all_reduce", g.numel() * g.element_size(), DATA_AXIS,
                                   overlapped=False)
            return dist.all_reduce(g) / self._grad_div
        tp = dist.resolve_transport(
            dist.KIND_GRAD if zc.zeropp else None, "reduce_scatter", g.numel() * 4, DATA_AXIS,
            requested=dist.WIDTH_INT8 if zc.zero_quantized_gradients else None)
        dist.record_collective("all_to_all" if tp.quantized else "reduce_scatter",
                               g.numel() * 4, DATA_AXIS, overlapped=False,
                               wire_bytes=tp.wire_bytes(g.numel(), 4))
        gm = g.movedim(d, 0)
        if tp.width == dist.WIDTH_INT8:
            res = quantized_reduce_scatter(gm, group_size=tp.group_size, out_dtype=torch.float32)
        elif tp.width == dist.WIDTH_FP8:
            res = fp8_reduce_scatter(gm.float(), group_size=tp.group_size)
        else:
            res = dist.reduce_scatter(gm.float())
        return res.movedim(0, d) / self._grad_div

    @property
    def _grad_div(self) -> int:
        """What the summed gradients are divided by: the world for data
        parallelism (each rank's loss is its rows' mean), 1 with a seq axis
        (each rank's loss is its share of the global mean)."""
        return self.n_dp if self.sp == 1 else 1

    # -- data --------------------------------------------------------------------
    _REPLICATED_BATCH_KEYS = ("layer_mask",)   # per-layer inputs, not per row

    def _prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch (and, with a seq axis, its
        slice of the sequence), on the device. With a seq axis the labels
        are derived from the global batch first and ``_denominator`` is set
        to the global batch's count of labels >= 0 (under ``loss_mask``)."""
        self._denominator = None
        if self.sp > 1:
            batch = {k: (v if k in self._REPLICATED_BATCH_KEYS else torch.as_tensor(v))
                     for k, v in batch.items()}
            batch["labels"] = self.model.derive_labels(batch)
            mask = (batch["labels"] >= 0).double()
            if "loss_mask" in batch:
                mask = mask * batch["loss_mask"].double()
            self._denominator = float(mask.sum())
        rows = cols = None
        local = {}
        for k, v in batch.items():
            if k in self._REPLICATED_BATCH_KEYS:
                local[k] = v
                continue
            rows = rows or self.topology.batch_rows(len(v))
            local[k] = v[rows]
            if self.sp > 1:
                cols = cols or self.topology.seq_slice(v.shape[1])
                local[k] = local[k][:, cols]
        return super()._prepare_batch(local)

    def _local_loss(self, batch) -> torch.Tensor:
        if self._denominator is None:
            return self.model.loss(batch)
        return self.model.loss(batch, denominator=self._denominator)

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss over the world: the ranks' mean (data parallelism) or
        sum (shares of the global mean)."""
        op = dist.ReduceOp.AVG if self.sp == 1 else dist.ReduceOp.SUM
        return dist.all_reduce(loss.detach().float(), op)

    # -- micro step ---------------------------------------------------------------
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One micro step over the global batch: this rank's rows (and
        sequence slice) forward and backward on the gathered params, the
        gradients reduced into the accumulation shards. Returns the loss
        over the world (``_global_loss``)."""
        set_topology(self.topology)
        batch = self._prepare_batch(batch)
        scale = float(np.float32(self.loss_scale_state["cur_scale"])
                      / np.float32(self.gradient_accumulation_steps))
        if self._overlap_active:
            loss = self._micro_overlap(batch, scale)
        else:
            self._gather_params()
            loss = self._local_loss(batch)
            (loss * scale).backward()
            with torch.no_grad():
                for k, p in self.params.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    self.grad_acc[k] += self._scatter_grad(k, g).to(self.grad_dtype)
        self._zero_param_grads()
        self._release_params()
        self._cached_loss = self._global_loss(loss)
        return self._cached_loss

    def _held(self, k: str) -> torch.Tensor:
        """What this rank holds of leaf ``k``: its stage-3 shard, or the
        whole param."""
        return self.param_shards[k] if k in self.param_shards else self.params[k].detach()

    def _bind_rest(self, comm, handle) -> None:
        for k, full in zip(comm.names, handle.wait()):
            self.params[k].data = full

    def _accumulate(self, names, grads) -> None:
        with torch.no_grad():
            for k, g in zip(names, grads):
                self.grad_acc[k] += g.to(self.grad_dtype)

    def _micro_overlap(self, batch: Dict[str, torch.Tensor], scale: float) -> torch.Tensor:
        """One micro step on the layer-pipelined overlap schedule (JAX
        ``_build_zeropp_micro_overlap``'s ``local_micro``, ``engine.py:
        1680-1800``); returns this rank's loss.

        The rest leaves are gathered first (head side, then embed side,
        under the edge split), the embedding runs with its graph, the blocks
        run through ``TransformerLM.scan_blocks_pipelined`` with the block
        ``TreeComm`` gathering and reducing one step's bundle at a time,
        then the head's loss and its backward; the head side's gradients
        are reduced before the blocks' backward (which hides them), the
        embed side's after the embedding's backward, and the deferred
        replicated block gradients in one fused all-reduce at the end. Each
        reduced shard is added to the accumulation buffer, as the barrier
        schedule does; the loss scale is applied to the loss, as there.

        With the error-feedback carry, every reduction takes its residual
        slot of ``_ef_state`` (zeros at the first micro step) and the new
        residuals replace the state after the step; no optimizer step resets
        it, so the quantization error telescopes over accumulation windows."""
        sch, model = self._sched, self.model
        if self._ef_carry_active and self._ef_state is None:
            self._ef_state = self._ef_zeros()
        ef = self._ef_state if self._ef_carry_active else None
        new_ef = {}
        lps, blk, names = sch.lps, sch.blk_comm, sch.blk_names
        labels = model.derive_labels(batch)
        rest_comms = sch.rest_comms
        handles = [cm.gather([self._held(k) for k in cm.names]) for cm in rest_comms[::-1]]
        self._bind_rest(rest_comms[0], handles[-1])   # the embed side (or all the rest)
        deferred = []

        def gather(s):
            layers = range(s * lps, (s + 1) * lps)
            held = [[self._held(f"blocks.{l}.{k}") for l in layers] for k in names]
            h = blk.gather([t[0].unsqueeze(0) if lps == 1 else torch.stack(t) for t in held])
            return dist.Pending([h], lambda r: [{k: r[0][i][j] for i, k in enumerate(names)}
                                                for j in range(lps)])

        def scatter(s, grads, err=None):
            gs = [grads[0][k].unsqueeze(0) if lps == 1 else torch.stack([g[k] for g in grads])
                  for k in names]
            h = blk.scatter(gs) if err is None else blk.scatter(gs, err=err)

            def accumulate(r):
                shards, new_err = r[0] if err is not None else (r[0], None)
                for i, k in enumerate(names):
                    for j, l in enumerate(range(s * lps, (s + 1) * lps)):
                        if i in blk.deferred_leaves:
                            deferred.append((f"blocks.{l}.{k}", shards[i][j]))
                        else:
                            self._accumulate([f"blocks.{l}.{k}"], [shards[i][j]])
                return new_err
            return dist.Pending([h], accumulate)

        def scatter_rest(comm, key, grads):
            # a rest launch set's reduction: ``(shards, new residuals)`` when carried
            if ef is None:
                return dist.Pending([comm.scatter(grads)], lambda r: (r[0], None))
            return comm.scatter(grads, err=ef[key])

        x0, rope, seg = model.embed_inputs(batch["input_ids"], batch.get("token_type_ids"),
                                           batch.get("attention_mask"))
        x_out, aux_sum, pullback = model.scan_blocks_pipelined(
            x0.detach(), rope, seg, gather=gather, scatter=scatter,
            keep=batch.get("layer_mask"), layers_per_step=lps, prefetch_depth=sch.depth,
            comm_edge=blk.schedule_class, scatter_err=None if ef is None else ef["blocks"])
        if sch.split:
            self._bind_rest(rest_comms[1], handles[0])
        x_out.requires_grad_(True)
        loss = model.combine_aux(model.head_loss(x_out, labels, extra_mask=batch.get("loss_mask")),
                                 aux_sum)
        (loss * scale).backward()
        # d(objective)/d(aux), from combine_aux itself (None: the aux is unused)
        a = torch.zeros((), dtype=torch.float32, device=x0.device, requires_grad=True)
        objective = model.combine_aux(torch.zeros_like(a), a)
        daux = (torch.autograd.grad(objective, a)[0] * scale if objective.requires_grad
                else None)
        grad_of = lambda k: (self.params[k].grad if self.params[k].grad is not None
                             else torch.zeros_like(self.params[k]))
        if sch.split:   # the head side's reductions hide under the blocks' backward
            head_comm = rest_comms[1]
            head_red = scatter_rest(head_comm, "rest_head",
                                    [grad_of(k) for k in head_comm.names])
        dx0 = pullback(x_out.grad, daux)
        if ef is not None:
            dx0, new_ef["blocks"] = dx0
        x0.backward(dx0)
        last = rest_comms[0]
        shards, new_ef["rest_embed" if sch.split else "rest"] = scatter_rest(
            last, "rest_embed" if sch.split else "rest",
            [grad_of(k) for k in last.names]).wait()
        self._accumulate(last.names, shards)
        if sch.split:
            shards, new_ef["rest_head"] = head_red.wait()
            self._accumulate(head_comm.names, shards)
        if ef is not None:
            self._ef_state = new_ef
        if deferred:
            with blk.schedule_class(False):
                self._accumulate([k for k, _ in deferred],
                                 blk.flush_deferred([g for _, g in deferred]))
        return loss

    # -- apply step ---------------------------------------------------------------
    def _overflow(self, grads: Dict[str, torch.Tensor]) -> bool:
        local = torch.tensor(float(super()._overflow(grads)), device=self.device)
        return bool(dist.all_reduce(local, dist.ReduceOp.MAX) > 0)

    def _grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm: each sharded leaf's local sum of squares summed
        over the ranks, each whole leaf counted once."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        sharded = [g.float().square().sum() for k, g in grads.items()
                   if self.grad_dims[k] is not None]
        whole = [g.float().square().sum() for k, g in grads.items()
                 if self.grad_dims[k] is None]
        local = torch.stack(sharded).sum() if sharded else zero
        return torch.sqrt(dist.all_reduce(local) + (torch.stack(whole).sum() if whole else zero))

    def _update(self, grads: Dict[str, torch.Tensor], lr: float, factor) -> None:
        n, r = self.n_dp, self.rank
        shard_grads, params_out = {}, {}
        for k, g in grads.items():
            od = self.opt_dims[k]
            shard_grads[k] = g if od is None or self.grad_dims[k] is not None \
                else shard_of(g, od, r, n)
            params_out[k] = (self.params[k] if od is None else
                             self.param_shards.get(k, self._cast_shards.get(k)))
        self.optimizer.update(shard_grads, self.opt_state, lr, grad_scale=factor,
                              params_out=params_out)
        for k, shard in self._cast_shards.items():
            d = self.opt_dims[k]
            dist.record_collective("all_gather", shard.numel() * shard.element_size(),
                                   DATA_AXIS, overlapped=False)
            self.params[k].data.copy_(dist.all_gather(shard.movedim(d, 0)).movedim(0, d))

    # -- state and introspection ---------------------------------------------------
    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any]) -> torch.Tensor:
        set_topology(self.topology)
        batch = self._prepare_batch(batch)
        self._gather_params()
        loss = self._local_loss(batch)
        self._release_params()
        return self._global_loss(loss)

    # -- checkpoints: each rank writes and reads the pieces it owns --------------------
    def _tag_has_grad_acc(self) -> bool:
        return (self.gradient_accumulation_steps > 1 or self.config.zero_config.zeropp
                or self._stage3_overlap)

    def _rank_and_world(self) -> Tuple[int, int]:
        return self.rank, self.n_dp

    def _port_shape(self, name: str) -> Tuple[int, ...]:
        return self.zero_plan.shapes[name]

    def _local(self, group: str, name: str) -> Tuple[torch.Tensor, Optional[int]]:
        if group == "params":
            if name in self.param_shards:
                return self.param_shards[name], self.param_dims[name]
            return self.params[name].detach(), None
        if group == "grad_acc":
            return self.grad_acc[name], self.grad_dims[name]
        return self.opt_state[group[len("opt/"):]][name], self.opt_dims[name]

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The full params on every rank (stage-3 shards gathered at full
        width)."""
        out = {}
        for k, p in self.params.items():
            d = self.param_dims[k]
            out[k] = (p.detach() if d is None else
                      dist.all_gather(self.param_shards[k].movedim(d, 0)).movedim(0, d))
        return out


class _OnebitStep:
    """The engine of the 1-bit optimizers (JAX ``_build_onebit_jits``,
    ``engine.py:1213-1300``), over ``DeepSpeedEngine`` on one rank
    (``OnebitEngine``) or ``DataParallelEngine`` on a world
    (``OnebitDataParallelEngine``): pure data parallelism, whatever the
    ZeRO stage (JAX ``_onebit_state_shardings``, ``:675-695``): params, the
    fp32 master and the moments replicated, the gradients and the worker /
    server errors a rank's own. A micro step keeps its gradients local (the
    one-rank step on this rank's rows; the reported loss the mean over the
    ranks); the apply step unscales them, takes the fp16 overflow flag as a
    max over the ranks, reports the gradient norm as ``sqrt(mean over ranks
    of the local sums of squares)``, clips nothing (as in JAX), and
    ``update`` steps the state on the JAX tree's leaves (``_onebit_leaves``:
    each path's port parameters and layers), each leaf's new master cast
    back into its params at once."""

    def _build_optimizer(self, config: DeepSpeedConfig):
        # fp32 state whatever data_types says, as in JAX
        return build_optimizer(config.optimizer)

    def _init_state(self, seed: int, init_params) -> None:
        if self.topology is not None and self.topology.sequence_parallel_size > 1:
            raise ValueError("1-bit optimizers support pure data parallelism (the reference's "
                             f"supported regime); got {self.topology}")
        self._place_model(seed, init_params)
        self.params = dict(self.model.named_parameters())
        groups: Dict[str, List[Tuple[JaxLeaf, str]]] = {}
        for n, p in self.params.items():
            jl = jax_leaf(n, p.dim())
            groups.setdefault(jl.path, []).append((jl, n))
        self._onebit_leaves = {path: sorted(groups[path], key=lambda m: m[0].layer or 0)
                               for path in sorted(groups)}
        self._init_opt_state()

    def _init_opt_state(self) -> None:
        """The optimizer's state from the params as they are."""
        self.opt_state = self.optimizer.init(
            {path: to_jax_leaf([(jl, self.params[n]) for jl, n in members])
             for path, members in self._onebit_leaves.items()})

    def _route(self) -> Tuple[bool, bool, str]:
        return False, False, ""   # local gradients: no ZeRO schedule

    def _apply_from_grads(self, grads: Dict[str, torch.Tensor], lr: float):
        scale = self.loss_scale_state["cur_scale"]
        overflow = self._overflow(grads) if self.config.fp16.enabled else False
        inv = self._scalar(0.0 if overflow else float(np.float32(1.0) / np.float32(scale)))
        local = torch.stack([(g.float() * inv).square().sum() for g in grads.values()]).sum()
        gnorm = torch.sqrt(dist.all_reduce(local, dist.ReduceOp.AVG))
        if not overflow:
            def write_back(path, master):
                for jl, n in self._onebit_leaves[path]:
                    self.params[n].data.copy_(
                        jl.swap_layout(master[jl.layer] if jl.layer is not None else master))

            with torch.no_grad():
                self.optimizer.update(_JaxGrads(self._onebit_leaves, grads, inv), self.opt_state,
                                      lr, write_back=write_back)
        self._update_loss_scale(overflow)
        return overflow, gnorm

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        return DeepSpeedEngine.forward(self, batch)

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any]) -> torch.Tensor:
        set_topology(self.topology)
        return self._global_loss(self.model.loss(self._prepare_batch(batch)))

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.params.items()}

    def _tag_leaves(self) -> Dict[str, _TagLeaf]:
        """The tag of JAX's ``_onebit_state_shardings``: the params, the
        optimizer's master, moments and ``lamb_coeff`` whole (rank 0 writes
        them), and per rank, as rows of a leading axis of the data ranks,
        the local gradient accumulators (zeros between steps at one micro
        step a step, where the port keeps none) and the worker and server
        errors."""
        _, n = self._rank_and_world()
        out: Dict[str, _TagLeaf] = {}
        for path, members in self._onebit_leaves.items():
            leaves = [jl for jl, _ in members]
            shape = tuple(self.params[members[0][1]].shape)
            out[f"params/{path}"] = _TagLeaf(
                leaves, [self.params[k].detach() for _, k in members], None, shape)
            acc = [self.grad_acc[k] if self.grad_acc else
                   torch.zeros(shape, dtype=self.grad_dtype, device=self.device)
                   for _, k in members]
            out[f"grad_acc/{path}"] = _TagLeaf(leaves, acc, None, shape, ranks=n)
        for slot, leaves in self.opt_state.items():
            if not isinstance(leaves, dict):
                continue
            for path, t in leaves.items():
                out[f"opt/{slot}/{path}"] = _TagLeaf(
                    [JaxLeaf(path, None, False)], [t], None, tuple(t.shape),
                    ranks=n if slot in ("worker_error", "server_error") else 0)
        return out

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True
                        ) -> Tuple[Optional[str], Dict[str, Any]]:
        tag, client_state = super().load_checkpoint(load_dir, tag, load_optimizer_states)
        if tag is not None and not load_optimizer_states:
            self._init_opt_state()   # afresh from the loaded params
        return tag, client_state


class OnebitEngine(_OnebitStep, DeepSpeedEngine):
    """A 1-bit optimizer's engine on one rank (``_OnebitStep``)."""


class OnebitDataParallelEngine(_OnebitStep, DataParallelEngine):
    """A 1-bit optimizer's engine on a data-parallel world (``_OnebitStep``)."""
