"""Built-in optimizers of the port.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py``. ``Optimizer`` is
the same frozen descriptor (name, lr, betas, eps, weight_decay, LAMB
coefficients, momentum, stored precision of master / first / second
moments); its state is a dict ``{"step": int, "master": {name: tensor},
"exp_avg": {...}, "exp_avg_sq": {...}}`` keyed by parameter name (lion
keeps one moment and has no ``exp_avg_sq``).

adam, adamw and lamb step through the fused Adam bucket kernel
(``ops/adam/adam.py``) and lion through the fused Lion bucket kernel
(``ops/lion/lion.py``; the JAX ``_update_fused`` path): parameters are
packed in order into flat buckets of at most ``1 << 20`` elements (a leaf at
or above the cap stands alone), small leaves each padded to a multiple of
128 elements. Unlike the JAX state, whose leaves are concatenated into a
bucket every step, the port's master and moments live in the flat bucket
buffers themselves (each leaf a view), so the kernel updates them in place
with no copy; only a fused bucket's gradients are gathered, and its param
casts scattered, per step. sgd and adagrad are plain tensor code, as in
JAX. ``muadam`` / ``muadamw`` step as adam / adamw on the fused Adam
kernel, as in JAX (whose mu variants keep adam's moments and its update;
``musgd`` is sgd). ``onebit_adam``, ``onebit_lamb`` and ``zero_one_adam``
build the 1-bit optimizers of ``runtime/fp16/onebit/`` (``build_onebit``),
which ``OnebitEngine`` steps on the JAX tree's leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.adam.adam import (_store, adam_bucket_update, lamb_trust_epilogue,
                             lane_padded, sr_seed)
from ..ops.lion.lion import lion_bucket_update

OptState = Dict[str, Any]

#: fused-bucket cap in elements (the JAX ``_OPT_BUCKET_ELEMS``)
_OPT_BUCKET_ELEMS = 1 << 20

_FUSED = ("adam", "adamw", "muadam", "muadamw", "lamb", "lion")
# the fused Adam kernel's mode of each Adam-family optimizer
_ADAM_MODE = {"adam": "adam", "muadam": "adam", "adamw": "adamw", "muadamw": "adamw",
              "lamb": "lamb"}
ONEBIT = ("onebit_adam", "onebit_lamb", "zero_one_adam")


def _plan_opt_buckets(sizes: List[int], keys: List[str],
                      cap: int) -> List[List[int]]:
    """Greedy in-order packing of leaf indices into flat buckets: leaves
    sharing a grad dtype fuse until the bucket reaches ``cap`` elements;
    an oversize leaf forms its own bucket."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_key, cur_n = None, 0
    for i, (n, key) in enumerate(zip(sizes, keys)):
        if n >= cap:
            if cur:
                buckets.append(cur)
                cur, cur_key, cur_n = [], None, 0
            buckets.append([i])
            continue
        if cur and (key != cur_key or cur_n + n > cap):
            buckets.append(cur)
            cur, cur_n = [], 0
        cur.append(i)
        cur_key, cur_n = key, cur_n + n
    if cur:
        buckets.append(cur)
    return buckets


@dataclasses.dataclass
class _Bucket:
    """One flat bucket: leaf names, sizes and offsets, and its flat
    buffers (for a single leaf, the leaf's own tensors flattened)."""
    names: List[str]
    sizes: List[int]
    offsets: List[int]
    master: torch.Tensor
    exp_avg: torch.Tensor
    exp_avg_sq: Optional[torch.Tensor] = None   # lion keeps one moment
    grad: Optional[torch.Tensor] = None   # fused buckets: gather buffer
    cast: Optional[torch.Tensor] = None   # fused buckets: param-cast buffer

    @property
    def single(self) -> bool:
        return self.grad is None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A frozen descriptor; state lives in the dict ``init`` returns."""
    name: str = "adamw"
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_coeff: float = 10.0
    min_coeff: float = 0.01
    momentum: float = 0.0
    master_dtype: Optional[torch.dtype] = None
    moment_dtype: Optional[torch.dtype] = None
    moment_sq_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.name not in _FUSED + ("sgd", "adagrad"):
            raise ValueError(f"Unknown optimizer '{self.name}'")

    # -- state ---------------------------------------------------------------
    def init(self, params: Dict[str, torch.Tensor],
             bucket_elems: int = _OPT_BUCKET_ELEMS) -> OptState:
        """Master copies (at ``master_dtype``, fp32 by default) and zero
        moments of ``params``; for the fused optimizers, in flat buckets."""
        f32 = torch.float32
        mdt = self.master_dtype or f32
        sdt = self.moment_dtype or f32
        sqdt = self.moment_sq_dtype or f32
        state: OptState = {"step": 0, "master": {}}
        if self.name not in _FUSED:
            state["master"] = {n: p.detach().to(mdt).clone() for n, p in params.items()}
            slot = {"sgd": ("exp_avg", sdt) if self.momentum > 0 else None,
                    "adagrad": ("sum_sq", sqdt)}[self.name]
            if slot is not None:
                state[slot[0]] = {n: torch.zeros(p.shape, dtype=slot[1], device=p.device)
                                  for n, p in params.items()}
            return state
        names = [n for n, p in params.items() if p.numel() > 0]
        sizes = [params[n].numel() for n in names]
        keys = [str(params[n].dtype) for n in names]
        slots = ("exp_avg",) if self.name == "lion" else ("exp_avg", "exp_avg_sq")
        slot_dtypes = {"exp_avg": sdt, "exp_avg_sq": sqdt}
        for slot in slots:
            state[slot] = {}
        state["buckets"] = []
        for idxs in _plan_opt_buckets(sizes, keys, bucket_elems):
            bn = [names[i] for i in idxs]
            bs = [sizes[i] for i in idxs]
            single = len(bn) == 1
            segs = bs if single else [lane_padded(n) for n in bs]
            offs = [sum(segs[:j]) for j in range(len(segs))]
            total = sum(segs)
            dev = params[bn[0]].device
            flat = lambda dt: torch.zeros(total, dtype=dt, device=dev)
            b = _Bucket(bn, bs, offs, flat(mdt),
                        **{slot: flat(slot_dtypes[slot]) for slot in slots})
            if not single:
                b.grad = flat(params[bn[0]].dtype)
                b.cast = flat(params[bn[0]].dtype)
            for n, k, off in zip(bn, bs, offs):
                shape = params[n].shape
                b.master[off:off + k].copy_(params[n].detach().reshape(-1))
                state["master"][n] = b.master[off:off + k].view(shape)
                for slot in slots:
                    state[slot][n] = getattr(b, slot)[off:off + k].view(shape)
            state["buckets"].append(b)
        for n, p in params.items():   # zero-size leaves ride outside the buckets
            if p.numel() == 0:
                state["master"][n] = p.detach().to(mdt).clone()
                for slot in slots:
                    state[slot][n] = torch.zeros(p.shape, dtype=slot_dtypes[slot],
                                                 device=p.device)
        return state

    # -- step ----------------------------------------------------------------
    def update(self, grads: Dict[str, torch.Tensor], state: OptState, lr: float,
               grad_scale=None,
               params_out: Optional[Dict[str, torch.Tensor]] = None) -> OptState:
        """One step on the master params, in place: computed in fp32,
        stored at the state's dtypes. ``grad_scale`` (a float or a 0-d
        device tensor) is folded into each gradient's fp32 cast
        (unscale x clip). ``params_out`` (the model's parameters) receive
        the new values cast to their dtype."""
        step = state["step"] + 1
        if self.name in _FUSED:
            self._update_fused(grads, state, step, lr, grad_scale, params_out)
        else:
            self._update_plain(grads, state, step, lr, grad_scale, params_out)
        state["step"] = step
        return state

    def _update_fused(self, grads, state, step, lr, grad_scale, params_out):
        """One kernel launch per bucket (the Lion kernel for lion, else the
        Adam kernel); LAMB applies the per-leaf trust ratio after the kernel
        (norms are per-leaf reductions)."""
        f32 = torch.float32
        lamb = self.name == "lamb"
        kmode = _ADAM_MODE.get(self.name)
        sdt = self.moment_dtype or f32
        sqdt = self.moment_sq_dtype or f32
        for b_idx, b in enumerate(state["buckets"]):
            if b.single:
                g = grads[b.names[0]].reshape(-1)
            else:
                for n, k, off in zip(b.names, b.sizes, b.offsets):
                    b.grad[off:off + k].copy_(grads[n].reshape(-1))
                g = b.grad
            pdt = None
            param_out = None
            if params_out is not None:
                pdt = params_out[b.names[0]].dtype
                if b.single:
                    out = params_out[b.names[0]]
                    param_out = out.view(-1) if out.is_contiguous() else None
                else:
                    param_out = b.cast if b.cast.dtype == pdt else None
            if self.name == "lion":
                pm, pc, _ = lion_bucket_update(
                    g, b.master, b.exp_avg, lr=lr, beta1=self.betas[0],
                    beta2=self.betas[1], weight_decay=self.weight_decay,
                    grad_scale=grad_scale, seed_m=sr_seed(step, 1, b_idx),
                    m_dtype=sdt, param_dtype=pdt, inplace=True, param_out=param_out)
            else:
                pm, pc, _, _ = adam_bucket_update(
                    g, b.master, b.exp_avg, b.exp_avg_sq, step=step, lr=lr,
                    beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
                    weight_decay=self.weight_decay, mode=kmode, grad_scale=grad_scale,
                    seed_m=sr_seed(step, 1, b_idx), seed_v=sr_seed(step, 2, b_idx),
                    m_dtype=sdt, v_dtype=sqdt, param_dtype=None if lamb else pdt,
                    inplace=True, param_out=param_out)
            for n, k, off in zip(b.names, b.sizes, b.offsets):
                if lamb:
                    leaf = state["master"][n]
                    new = lamb_trust_epilogue(leaf.reshape(-1).to(f32), pm[off:off + k],
                                              lr=lr, min_coeff=self.min_coeff,
                                              max_coeff=self.max_coeff)
                    leaf.copy_(new.view(leaf.shape))
                    if params_out is not None:
                        params_out[n].copy_(new.view(leaf.shape))
                elif params_out is not None and pc.data_ptr() != params_out[n].data_ptr():
                    # a fused bucket's cast buffer (a single leaf's cast was
                    # written into the parameter itself)
                    params_out[n].copy_(pc[off:off + k].view(params_out[n].shape))

    def _update_plain(self, grads, state, step, lr, grad_scale, params_out):
        """sgd and adagrad, leaf by leaf in torch (the JAX XLA tree);
        narrowed slots are stored with the hash stochastic rounding."""
        f32 = torch.float32
        gs = 1.0 if grad_scale is None else grad_scale
        for i, (n, g) in enumerate(grads.items()):
            p = state["master"][n]
            pf = p.to(f32)
            gf = g.to(f32) * gs
            if self.name == "adagrad":
                s = state["sum_sq"][n].to(f32) + gf * gf
                new = pf - lr * gf / (torch.sqrt(s) + self.eps)
                state["sum_sq"][n].copy_(_store(s, state["sum_sq"][n].dtype,
                                                sr_seed(step, 3, i), True))
            elif self.momentum > 0:
                m = self.momentum * state["exp_avg"][n].to(f32) + gf
                new = pf - lr * m
                state["exp_avg"][n].copy_(_store(m, state["exp_avg"][n].dtype,
                                                 sr_seed(step, 1, i), True))
            else:
                new = pf - lr * gf
            p.copy_(new)
            if params_out is not None:
                params_out[n].copy_(new)


_ALIASES = {
    "adam": "adam", "adamw": "adamw", "torchadam": "adam", "fusedadam": "adam",
    "fusedadamw": "adamw", "fusedlamb": "lamb", "lamb": "lamb", "lion": "lion",
    "fusedlion": "lion", "adagrad": "adagrad", "sgd": "sgd",
    "onebit_adam": "onebit_adam", "onebitadam": "onebit_adam",
    "zero_one_adam": "zero_one_adam", "zerooneadam": "zero_one_adam",
    "onebit_lamb": "onebit_lamb", "onebitlamb": "onebit_lamb",
    "muadam": "muadam", "muadamw": "muadamw", "musgd": "sgd",
}

_PARAM_KEYS = ("lr", "eps", "weight_decay", "momentum", "max_coeff", "min_coeff")


def is_onebit(opt_config) -> bool:
    """Whether a config ``optimizer`` block names a 1-bit optimizer."""
    return opt_config is not None and \
        _ALIASES.get(opt_config.type.lower().replace("-", "_")) in ONEBIT


def build_onebit(name: str, p: Dict[str, Any]):
    """A 1-bit optimizer from its config params, with the JAX engine's
    defaults (``_build_onebit_optimizer``)."""
    from .fp16.onebit import OnebitAdam, OnebitLamb, ZeroOneAdam
    common = dict(lr=p.get("lr", 1e-3), betas=tuple(p.get("betas", (0.9, 0.999))),
                  eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0))
    if name == "onebit_adam":
        return OnebitAdam(freeze_step=p.get("freeze_step", 100), **common)
    if name == "onebit_lamb":
        return OnebitLamb(freeze_step=p.get("freeze_step", 100),
                          max_coeff=p.get("max_coeff", 10.0), min_coeff=p.get("min_coeff", 0.01),
                          **common)
    return ZeroOneAdam(var_freeze_step=p.get("var_freeze_step", 100),
                       var_update_scaler=p.get("var_update_scaler", 16),
                       local_step_scaler=p.get("local_step_scaler", 4), **common)


def build_optimizer(opt_config):
    """Map a config ``optimizer`` block (``type``, ``params``) to an
    ``Optimizer`` (the JAX ``build_optimizer``), or to a 1-bit optimizer."""
    if opt_config is None:
        return Optimizer(name="adamw")
    name = _ALIASES.get(opt_config.type.lower().replace("-", "_"))
    if name is None:
        raise ValueError(f"Unknown optimizer type '{opt_config.type}'")
    p = dict(opt_config.params)
    if name in ONEBIT:
        return build_onebit(name, p)
    kwargs: Dict[str, Any] = {k: p[k] for k in _PARAM_KEYS if k in p}
    if "betas" in p:
        kwargs["betas"] = tuple(p["betas"])
    return Optimizer(name=name, **kwargs)
