"""Activation checkpointing: the remat policies.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py``, where a policy is a ``jax.checkpoint`` policy. Here a
policy names what a checkpointed function keeps from its forward for the
backward; the rest is recomputed:

- ``full`` / ``nothing_saveable``: nothing but the function's inputs
  (``torch.utils.checkpoint``, non-reentrant);
- ``dots_saveable`` / ``checkpoint_dots``: the outputs of every product,
  the linears' (``aten.mm`` / ``addmm``), batched ones (``bmm`` /
  ``baddbmm``) and the flash attention forward, a batched product, kept as
  one operator (``flash.FLASH_FWD_OP``: its kernels launch through ctypes,
  which no dispatch mode sees, so the policy decides about the whole op).
  The MoE forward (``ops/transformer/moe.py`` ``MOE_FWD_OP``, one operator
  too) is not among them: it is recomputed whole. Its JAX counterpart is a
  ``custom_vjp`` whose outputs come from Pallas calls, not from a
  ``dot_general``, so ``dots_saveable`` does not save them; the one product
  in its body, the router's, is read by no backward (the VJP recomputes it
  from the saved tokens and weights);
- ``dots_with_no_batch_dims_saveable`` / ``checkpoint_dots_with_no_batch_dims``:
  the linears' outputs only; attention is recomputed;
- ``everything_saveable``: everything, i.e. no recomputation;
- ``attention_only``: everything but the attention's S x S buffers. Under
  the flash kernels no such buffer exists (the forward keeps O and the row
  LSE, O(S)), so it keeps everything, as the JAX policy does under its
  Pallas flash kernel.

The selective policies run through ``_Selective``, a reentrant autograd
Function (DeepSpeed's ``CheckpointFunction`` form): its forward runs the
function with a dispatch mode that keeps the outputs of the policy's ops
and hands them to ``save_for_backward`` with the inputs, so they are saved
tensors like any other (``torch.autograd.graph.saved_tensors_hooks`` sees
them); its backward re-runs the function with a mode that returns the kept
outputs in place of those ops, and back-propagates through the re-run.
The model-level ``alternating`` policy is ``TransformerLM.apply``'s (layer
pairs, the first checkpointed in full).

``configure`` stores the reference's module-level flags. As in JAX, only
``policy`` acts (the default policy of ``checkpoint``);
``partition_activations``, ``contiguous_memory_optimization``,
``cpu_checkpointing``, ``num_checkpoints``, ``synchronize`` and ``profile``
are stored and read by nothing.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from ...ops.transformer.flash import FLASH_FWD_OP

aten = torch.ops.aten

_CONFIG = {
    "partition_activations": False,
    "contiguous_memory_optimization": False,
    "cpu_checkpointing": False,
    "num_checkpoints": None,
    "synchronize": False,
    "profile": False,
    "policy": "full",
}

#: what a policy keeps: None = the inputs only, SAVE_ALL = everything, else
#: the ops whose outputs are kept
SAVE_ALL = "everything"
_LINEAR_DOTS = frozenset({aten.mm.default, aten.addmm.default})
_DOTS = _LINEAR_DOTS | {aten.bmm.default, aten.baddbmm.default, FLASH_FWD_OP}

POLICIES = {
    "full": None,
    "nothing_saveable": None,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _LINEAR_DOTS,
    "checkpoint_dots_with_no_batch_dims": _LINEAR_DOTS,
    "everything_saveable": SAVE_ALL,
    "attention_only": SAVE_ALL,
}
#: the policies a model's ``remat_policy`` may name
MODEL_POLICIES = tuple(POLICIES) + ("alternating",)


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              policy: Optional[str] = None) -> None:
    """Reference ``checkpointing.configure``: stores the module-level flags,
    from a ``DeepSpeedConfig``'s ``activation_checkpointing_config`` and
    the keywords."""
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing_config", None)
        if ac is not None:
            _CONFIG.update(
                partition_activations=ac.partition_activations,
                contiguous_memory_optimization=ac.contiguous_memory_optimization,
                cpu_checkpointing=ac.cpu_checkpointing,
                num_checkpoints=ac.number_checkpoints,
                synchronize=ac.synchronize_checkpoint_boundary,
                profile=ac.profile,
                policy=ac.policy,
            )
    for key, value in (("partition_activations", partition_activations),
                       ("contiguous_memory_optimization", contiguous_checkpointing),
                       ("num_checkpoints", num_checkpoints),
                       ("cpu_checkpointing", checkpoint_in_cpu),
                       ("synchronize", synchronize),
                       ("profile", profile),
                       ("policy", policy)):
        if value is not None:
            _CONFIG[key] = value


def is_configured() -> bool:
    return True


def resolve_policy(name: Optional[str]):
    """What the policy ``name`` (the configured one when empty) keeps: None,
    ``SAVE_ALL`` or a set of ops. Raises ``ValueError`` for other names."""
    name = name or _CONFIG["policy"]
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; the port's policies are "
                         f"{', '.join(POLICIES)}")
    return POLICIES[name]


def check_model_policy(name: str) -> None:
    """Raise ``ValueError`` unless a model's ``remat_policy`` may be ``name``."""
    if name not in MODEL_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; the port's policies are "
                         f"{', '.join(MODEL_POLICIES)}")


def _outputs(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


class _Keep(TorchDispatchMode):
    """Runs every op and records, in order, the outputs of ``ops``."""

    def __init__(self, ops, kept: list):
        super().__init__()
        self.ops, self.kept = ops, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            self.kept.append((func, isinstance(out, (tuple, list)),
                              [t.detach() for t in _outputs(out)]))
        return out


class _Replay(TorchDispatchMode):
    """Returns the recorded outputs in place of the ops of ``ops``, in the
    order they were recorded; runs every other op."""

    def __init__(self, ops, kept: list):
        super().__init__()
        self.ops, self.kept, self.i = ops, kept, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        if self.i >= len(self.kept) or self.kept[self.i][0] is not func:
            raise RuntimeError(f"remat replay: {func} does not match the forward's "
                               f"op sequence")
        _, is_tuple, outs = self.kept[self.i]
        self.i += 1
        return tuple(outs) if is_tuple else outs[0]


def _discard(_):
    return None


class _Selective(torch.autograd.Function):
    """Reentrant checkpoint keeping the outputs of ``ops`` (module doc)."""

    @staticmethod
    def forward(ctx, run_function: Callable, ops, *args):
        records: List[Tuple[Any, bool, List[torch.Tensor]]] = []
        # the forward with grad on, as the re-run will be (so both see the
        # same op sequence), its own graph's saved tensors dropped
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(_discard, _discard), \
                _Keep(ops, records):
            out = run_function(*args)
        ctx.run_function, ctx.ops = run_function, ops
        ctx.tensor_at = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        ctx.args = [None if torch.is_tensor(a) else a for a in args]
        ctx.records = [(f, is_tuple, len(outs)) for f, is_tuple, outs in records]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at),
                              *(t for _, _, outs in records for t in outs))
        return tuple(o.detach() for o in out) if isinstance(out, tuple) else out.detach()

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        n = len(ctx.tensor_at)
        args = list(ctx.args)
        for j, i in enumerate(ctx.tensor_at):
            args[i] = saved[j].detach().requires_grad_(saved[j].requires_grad)
        kept, at = [], n
        for f, is_tuple, count in ctx.records:
            kept.append((f, is_tuple, list(saved[at:at + count])))
            at += count
        with torch.enable_grad(), _Replay(ctx.ops, kept):
            out = ctx.run_function(*args)
        outs = _outputs(out)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        return (None, None, *(a.grad if torch.is_tensor(a) and a.requires_grad else None
                              for a in args))


def checkpoint(function: Callable, *args, policy: Optional[str] = None, **kwargs) -> Any:
    """Reference ``checkpointing.checkpoint`` (:989): ``function(*args,
    **kwargs)`` under the remat policy ``policy`` (the configured one when
    None)."""
    keep = resolve_policy(policy)
    if keep == SAVE_ALL:
        return function(*args, **kwargs)
    if keep is None:
        return torch.utils.checkpoint.checkpoint(function, *args, use_reentrant=False,
                                                 **kwargs)
    run = (lambda *a: function(*a, **kwargs)) if kwargs else function
    return _Selective.apply(run, keep, *args)


def checkpoint_wrapper(function: Callable, policy: Optional[str] = None) -> Callable:
    """Decorator form used by models."""
    return lambda *args, **kwargs: checkpoint(function, *args, policy=policy, **kwargs)


class CheckpointFunction:
    """API-parity shim for code importing the autograd class (reference
    :484); ``apply`` delegates to :func:`checkpoint`."""

    @staticmethod
    def apply(run_function, *args):
        return checkpoint(run_function, *args)
