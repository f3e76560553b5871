"""Error-compensated 1-bit compressed all-reduce.

Counterpart of ``deepspeed_tpu/runtime/comm/compressed.py`` over a
``torch.distributed`` group: sign compression with worker and server error
feedback, two rounds on the wire as in JAX:

1. each worker compensates its tensor with its carried error, keeps one
   sign a value and one scale (the mean absolute value), and remembers the
   residual; the int8 sign chunks go to their servers by an all-to-all, the
   scales by an all-gather;
2. each rank serves one chunk: it averages the workers' signs times their
   scales, compresses the average again against its own carried error, and
   the int8 signs and the server scales are all-gathered.

Signs travel as int8, one byte a value, as in the JAX package (the
reference's bit packing is not part of it). On a world of one rank the
tensor is still compressed, as on a JAX axis of size 1. Each launch is
recorded with ``comm.record_collective``: the logical fp32 bytes and the
bytes that travel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...comm import comm as dist
from ...utils.groups import DATA_AXIS


def error_state(numel: int, world: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero ``(worker_error, server_error)`` for a flat tensor of ``numel``
    values reduced over ``world`` workers: the tensor padded to a multiple
    of ``world``, and one chunk of it."""
    padded = -(-numel // world) * world
    return (torch.zeros(padded, dtype=torch.float32, device=device),
            torch.zeros(padded // world, dtype=torch.float32, device=device))


def _signs(x: torch.Tensor) -> torch.Tensor:
    """int8 +1 where ``x >= 0``, else -1 (a byte a value, not an fp32 copy)."""
    return (x >= 0).to(torch.int8).mul_(2).sub_(1)


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The approximate mean of ``x`` over the group: ``(result,
    new_worker_error, new_server_error)``, the result in ``x``'s shape and
    dtype. The worker's arithmetic runs in place on one padded fp32 buffer
    (the JAX function's values: ``x`` padded plus the error, less the
    scale times the signs), so a leaf the size of a stacked MLP weight
    costs one fp32 copy, not five."""
    n = dist.get_world_size(group)
    numel = x.numel()
    padded = worker_error.numel()
    if padded != -(-numel // n) * n:
        raise ValueError(f"worker_error size {padded} does not match tensor {numel} over "
                         f"{n} workers")
    chunk = padded // n

    # the worker: compensate, one sign a value and one scale
    compensated = worker_error.clone()
    compensated[:numel].add_(x.reshape(-1).float())
    scale = compensated.abs().mean()
    signs = _signs(compensated)
    new_worker_error = compensated.sub_(signs * scale)
    dist.record_collective("all_to_all", padded * 4, DATA_AXIS, overlapped=False,
                           wire_bytes=padded)
    recv = dist.all_to_all_rows_async(signs.reshape(n, chunk), group)
    dist.record_collective("all_gather", 4, DATA_AXIS, overlapped=False)
    scales = dist.all_gather(scale.reshape(1), group)                       # [n]
    del signs
    recv = recv.wait()                                                      # [n, chunk]

    # the server: average its chunk, compress again against its own error
    server_avg = (scales[:, None] * recv.float()).mean(dim=0)
    compensated_s = server_avg + server_error
    scale_s = compensated_s.abs().mean()
    signs_s = _signs(compensated_s)
    new_server_error = compensated_s.sub_(signs_s * scale_s)
    dist.record_collective("all_gather", chunk * 4, DATA_AXIS, overlapped=False,
                           wire_bytes=chunk)
    out_signs = dist.all_gather_async(signs_s, group)                       # [padded]
    dist.record_collective("all_gather", 4, DATA_AXIS, overlapped=False)
    out_scales = dist.all_gather(scale_s.reshape(1), group)                 # [n]
    out = out_signs.wait()[:numel].reshape(x.shape).float()
    out.mul_(out_scales.repeat_interleave(chunk)[:numel].reshape(x.shape))
    return out.to(x.dtype), new_worker_error, new_server_error
