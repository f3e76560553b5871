"""Communication frontend of the port: ``torch.distributed``, one process a
rank.

Counterpart of ``deepspeed_tpu/comm/comm.py``. There, collectives are
``jax.lax`` primitives over named mesh axes inside ``shard_map``; here they
are ``torch.distributed`` calls over a process group (``group=None`` is the
world), called eagerly. The port's live axes are ``data`` and ``seq``
(``runtime/topology.py`` gives each its group).

- bootstrap: ``init_distributed`` (torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT`` when no arguments are given; NCCL for
  CUDA and gloo for the CPU unless a backend is named), ``is_initialized``,
  ``get_rank``, ``get_world_size``, ``get_local_rank``, ``barrier``,
  ``new_group``;
- collectives returning new tensors, tiled along dim 0 as the JAX
  ``tiled=True`` forms are: ``all_reduce``, ``all_gather``,
  ``reduce_scatter``, ``all_to_all`` (along any ``split_axis`` /
  ``concat_axis``, with the JAX signature ``comm.py:662``; ``kind=
  "activation"`` narrows its wire to bf16 and records the launch),
  ``broadcast``, and ``ppermute`` (a permutation of the group's members,
  ``isend`` / ``irecv``: the ring hop). On a gloo group a CUDA tensor is
  staged through host memory (what gloo does with CUDA tensors anyway,
  made explicit so every op works on every gloo build). Without an
  initialized process group the world is one rank and every collective is
  the identity;
- the transport planner (``TransportPlan``, ``resolve_transport``,
  ``configure_transport``; JAX ``comm.py:63-252``, line for line) that picks
  each launch's wire width (full / bf16 / int8 / fp8) from the tensor kind
  and bucket bytes, and its algorithm (flat / hierarchical) from the live
  axes. The JAX ``DSTPU_COMM_QUANT`` / ``DSTPU_COMM_HIER`` switches are not
  carried over: ``comm_transport.enabled`` and ``.hierarchical`` do their
  work. Axis sizes come from the published topology
  (``runtime/topology.py``), as the JAX planner reads its mesh. The
  hierarchical algorithm needs two live data axes (hpZ / MiCS, ROADMAP A6),
  so on the port's axes it never fires, and the engine's config accepts
  ``hierarchical`` only at its default;
- ``record_collective``, ``CollectiveLedger`` and ``record_into``
  (``comm.py:352-445``): the engine records each launch with its logical and
  wire bytes, and a ledger installed with ``record_into`` collects them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import enum
import os
import queue
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

from ..utils.groups import DATA_AXIS

AxisNames = Union[str, Sequence[str]]


class ReduceOp(enum.Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "product"


# -- transport planner --------------------------------------------------------

WIDTH_FULL = "full"
WIDTH_BF16 = "bf16"
WIDTH_INT8 = "int8"
WIDTH_FP8 = "fp8"
ALGO_FLAT = "flat"
ALGO_HIERARCHICAL = "hierarchical"

KIND_PARAM = "param"
KIND_GRAD = "grad"
KIND_ACTIVATION = "activation"

_WIDTHS = (WIDTH_FULL, WIDTH_BF16, WIDTH_INT8, WIDTH_FP8)
_KINDS = (KIND_PARAM, KIND_GRAD, KIND_ACTIVATION)

#: process-global transport policy; the engine's ``comm_transport`` config
#: block lands here through :func:`configure_transport`
TRANSPORT_DEFAULTS = dict(
    enabled=True,
    grad_width=WIDTH_INT8,          # gradient reductions
    activation_width=WIDTH_BF16,    # MoE dispatch / sequence all-to-all
    permute_width=WIDTH_INT8,       # ring KV hops
    hierarchical=True,
    group_size=256,
    min_bytes=1024,                 # buckets below this stay full width
    error_feedback=False,
)
_TRANSPORT = dict(TRANSPORT_DEFAULTS)

#: widths each collective op can move; an unsupported request degrades to
#: the nearest supported width
_OP_WIDTHS = {
    "all_reduce": (WIDTH_FULL, WIDTH_INT8, WIDTH_FP8),
    "reduce_scatter": (WIDTH_FULL, WIDTH_INT8, WIDTH_FP8),
    "all_gather": (WIDTH_FULL, WIDTH_BF16, WIDTH_INT8, WIDTH_FP8),
    "all_to_all": (WIDTH_FULL, WIDTH_BF16),
    "ppermute": (WIDTH_FULL, WIDTH_BF16, WIDTH_INT8),
}
_WIDTH_FALLBACK = {
    ("all_reduce", WIDTH_BF16): WIDTH_FULL,
    ("reduce_scatter", WIDTH_BF16): WIDTH_FULL,
    ("all_to_all", WIDTH_INT8): WIDTH_BF16,
    ("all_to_all", WIDTH_FP8): WIDTH_BF16,
    ("ppermute", WIDTH_FP8): WIDTH_INT8,
}


def configure_transport(**kwargs) -> None:
    """Set the process-global transport policy. Unknown keys or widths
    raise."""
    for key, val in kwargs.items():
        if key not in TRANSPORT_DEFAULTS:
            raise ValueError(f"unknown comm_transport key {key!r} "
                             f"(known: {', '.join(sorted(TRANSPORT_DEFAULTS))})")
        if key.endswith("_width") and val not in _WIDTHS:
            raise ValueError(f"comm_transport.{key}={val!r} not in {_WIDTHS}")
        _TRANSPORT[key] = val


def transport_config() -> dict:
    return dict(_TRANSPORT)


def reset_transport() -> None:
    _TRANSPORT.clear()
    _TRANSPORT.update(TRANSPORT_DEFAULTS)


@dataclasses.dataclass(frozen=True)
class TransportPlan:
    """How one collective launch moves its bytes; ``inner`` / ``outer`` are
    the hierarchical tiers, empty under the flat algorithm."""
    width: str = WIDTH_FULL
    algo: str = ALGO_FLAT
    inner: Tuple[str, ...] = ()
    outer: Tuple[str, ...] = ()
    group_size: int = 256
    error_feedback: bool = False

    @property
    def quantized(self) -> bool:
        return self.width in (WIDTH_INT8, WIDTH_FP8)

    def wire_bytes(self, n_elems: int, itemsize: int) -> int:
        """Bytes on the wire for an ``n_elems`` payload of logical element
        width ``itemsize``: sideband scales / zero points charged, the
        hierarchical outer leg's full-width 1/n_inner shard added."""
        groups = -(-n_elems // max(self.group_size, 1))
        if self.width == WIDTH_INT8:
            base = n_elems + groups * 8       # int8 payload + f32 scale/zero
        elif self.width == WIDTH_FP8:
            base = n_elems + groups * 4       # fp8 payload + f32 scale
        elif self.width == WIDTH_BF16:
            base = n_elems * min(2, itemsize)
        else:
            base = n_elems * itemsize
        if self.algo == ALGO_HIERARCHICAL and self.inner:
            ni = 1
            for a in self.inner:
                ni *= _transport_axis_size(a)
            base += (n_elems // max(ni, 1)) * 4   # full-width outer leg
        return int(base)


FULL_FLAT_PLAN = TransportPlan()


def _transport_axis_size(axis) -> int:
    """The size of a mesh axis for planning: the published topology's
    (``runtime/topology.py``); without one the world for ``data`` and 1
    for every other axis."""
    from ..runtime import topology as topo_mod
    t = topo_mod.get_topology()
    if t is not None:
        return t.axis_size(axis)
    return get_world_size() if axis == DATA_AXIS else 1


def resolve_transport(kind: Optional[str], op: str, nbytes: int,
                      axes: AxisNames, axis_sizes: Optional[dict] = None,
                      requested: Optional[str] = None) -> TransportPlan:
    """One launch's :class:`TransportPlan`.

    ``kind`` is the tensor kind (``param`` / ``grad`` / ``activation``;
    ``None`` is unclassified traffic, always full and flat); ``requested``
    an explicit width (the ZeRO++ qwZ / qgZ knobs), which holds even with
    ``comm_transport.enabled`` false, where the planner's defaults fall
    back to full width. ``axis_sizes`` gives the axes' sizes; otherwise
    they come from the world."""
    if kind is None and requested is None:
        return FULL_FLAT_PLAN
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
    size_of = (axis_sizes.get if axis_sizes is not None
               else lambda a, _=None: _transport_axis_size(a))
    live = tuple(a for a in axes_t if (size_of(a, 1) or 1) > 1)

    quant_defaults = _TRANSPORT["enabled"]
    width = requested if requested in _WIDTHS else WIDTH_FULL
    if (requested is None and kind in _KINDS and quant_defaults
            and nbytes >= _TRANSPORT["min_bytes"]):
        if kind == KIND_GRAD:
            width = _TRANSPORT["grad_width"]
        elif kind == KIND_ACTIVATION:
            width = (_TRANSPORT["permute_width"] if op == "ppermute"
                     else _TRANSPORT["activation_width"])
        # KIND_PARAM stays full: the parameter all-gather's width is the
        # user's qwZ contract (zero_quantized_weights -> requested="int8")
    while width not in _OP_WIDTHS.get(op, (WIDTH_FULL,)):
        width = _WIDTH_FALLBACK.get((op, width), WIDTH_FULL)

    algo, inner, outer = ALGO_FLAT, (), ()
    if (op in ("all_reduce", "reduce_scatter", "all_gather")
            and quant_defaults and _TRANSPORT["hierarchical"]):
        out_axes = tuple(a for a in live if a == DATA_AXIS)
        in_axes = tuple(a for a in live if a != DATA_AXIS)
        if out_axes and in_axes:
            algo, inner, outer = ALGO_HIERARCHICAL, in_axes, out_axes
    return TransportPlan(width=width, algo=algo, inner=inner, outer=outer,
                         group_size=_TRANSPORT["group_size"],
                         error_feedback=(bool(_TRANSPORT["error_feedback"])
                                         and kind == KIND_GRAD))


# -- collective records ---------------------------------------------------------

_LEDGER = None   # set by record_into


def record_collective(op_name: str, nbytes: int, axis: AxisNames,
                      overlapped: Optional[bool] = None, count: int = 1,
                      wire_bytes: Optional[int] = None) -> None:
    """Record one collective launch: its logical bytes, the bytes that
    travel (``wire_bytes``, default ``nbytes``) and its schedule class
    (``overlapped=False``: on the critical path, as every launch of the
    barrier schedule is). A no-op unless a ledger is installed."""
    if _LEDGER is not None:
        _LEDGER.append(op_name, int(nbytes), axis, overlapped=overlapped, count=count,
                       wire_bytes=int(nbytes) if wire_bytes is None else int(wire_bytes))


class CollectiveLedger:
    """Collects ``record_collective`` calls as dicts."""

    def __init__(self):
        self.records = []

    def append(self, op_name: str, nbytes: int, axis,
               overlapped: Optional[bool] = None, count: int = 1,
               wire_bytes: Optional[int] = None) -> None:
        self.records.append({"op": op_name, "bytes": int(nbytes),
                             "wire_bytes": int(nbytes if wire_bytes is None else wire_bytes),
                             "axes": tuple(axis) if isinstance(axis, (tuple, list)) else (axis,),
                             "overlapped": overlapped, "count": int(count)})

    def split(self, wire: bool = True) -> dict:
        """``{"overlapped_bytes", "exposed_bytes"}``, count-scaled, at wire
        bytes unless ``wire=False``; untagged records excluded."""
        key = "wire_bytes" if wire else "bytes"
        out = {"overlapped_bytes": 0, "exposed_bytes": 0}
        for r in self.records:
            if r["overlapped"] is True:
                out["overlapped_bytes"] += r[key] * r["count"]
            elif r["overlapped"] is False:
                out["exposed_bytes"] += r[key] * r["count"]
        return out

    def tail(self, n: int = 12) -> str:
        return "\n".join(f"{r['op']} {r['bytes']} B axes={r['axes']} "
                         f"overlapped={r['overlapped']} x{r['count']}"
                         for r in self.records[-n:])


@contextlib.contextmanager
def record_into(ledger):
    """Route ``record_collective`` into ``ledger`` for the duration."""
    global _LEDGER
    old = _LEDGER
    _LEDGER = ledger
    try:
        yield ledger
    finally:
        _LEDGER = old


# -- bootstrap and process queries ----------------------------------------------


def init_distributed(dist_backend: Optional[str] = None, rank: int = -1, world_size: int = -1,
                     init_method: Optional[str] = None, distributed_port: int = 29500,
                     timeout: Optional[float] = None) -> None:
    """Join the process group (reference ``comm.py:604``). ``rank`` /
    ``world_size`` default to ``RANK`` / ``WORLD_SIZE``; ``init_method`` to
    ``env://`` over ``MASTER_ADDR`` (localhost) and ``MASTER_PORT``
    (``distributed_port``). The backend is ``dist_backend`` as given, else
    NCCL when CUDA is available and gloo otherwise. ``timeout`` in seconds
    bounds every collective. A no-op when already initialized."""
    if tdist.is_initialized():
        return
    rank = int(os.environ.get("RANK", 0)) if rank < 0 else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size < 0 else world_size
    if init_method is None:
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", str(distributed_port))
        init_method = "env://"
    backend = dist_backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    tdist.init_process_group(backend, init_method=init_method, rank=rank,
                             world_size=world_size, **kw)


def is_initialized() -> bool:
    return tdist.is_initialized()


def get_rank(group=None) -> int:
    return tdist.get_rank(group) if tdist.is_initialized() else 0


def get_world_size(group=None) -> int:
    return tdist.get_world_size(group) if tdist.is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", get_rank()))


def get_backend(group=None) -> Optional[str]:
    return str(tdist.get_backend(group)) if tdist.is_initialized() else None




# -- launches: one comm thread a process, in issue order ---------------------------
#
# Every call on a process group runs on one worker thread of this process, in
# the order the caller issued it: the ranks of a group then meet in the same
# order whichever thread asked, as gloo and NCCL need. A blocking collective
# is its asynchronous form waited at once; an asynchronous one (``*_async``)
# returns a ``Work`` at once and the caller computes on until ``wait()``.
#
# On gloo a CUDA tensor is staged through host memory without blocking the
# caller: its copy to pinned host memory runs on a side stream that waits for
# the work queued so far on the current stream (the producer is in there, the
# compute queued after the launch is not), the comm thread waits for that copy
# and then runs gloo, and ``wait()`` queues the copy back on the current
# stream. So a launch issued before a layer's kernels moves its bytes while
# they run. The caller must not write a launch's input until it has waited.
# NCCL reads CUDA tensors in place: its ops, issued from the comm thread,
# order against the device's default stream, where the port computes.


class Work:
    """A launched collective. ``wait()`` blocks until it is done and returns
    its result (once computed, the same object on every call)."""

    def __init__(self, finish=None):
        self._done = threading.Event()
        self._finish = finish
        self._host = self._error = self._result = None
        self._waited = False

    def _run(self, fn, ready) -> None:
        try:
            if ready is not None:
                ready.synchronize()
            self._host = fn()
        except BaseException as e:   # re-raised in the caller's wait()
            self._error = e
        finally:
            self._done.set()

    def wait(self):
        if not self._waited:
            self._done.wait()
            if self._error is not None:
                raise self._error
            self._result = self._finish(self._host) if self._finish else self._host
            self._host, self._waited = None, True
        return self._result


class Pending:
    """Several launches and what makes one result of theirs:
    ``wait()`` waits each part in order and returns ``combine(results)``.
    ``Pending([], lambda _: x)`` is a result that needs no launch."""

    def __init__(self, parts: Sequence, combine):
        self._parts, self._combine = list(parts), combine
        self._waited, self._result = False, None

    def wait(self):
        if not self._waited:
            self._result = self._combine([p.wait() for p in self._parts])
            self._parts, self._waited = [], True
        return self._result


def ready(value) -> Pending:
    """A result that needs no launch, as a handle."""
    return Pending([], lambda _: value)


_WORKER = {"queue": None, "thread": None}
_WORKER_LOCK = threading.Lock()


def _worker_loop(q: "queue.Queue") -> None:
    while True:
        item = q.get()
        if item is None:
            return
        work, fn, ready_event = item
        work._run(fn, ready_event)


def _submit(fn, ready_event=None, finish=None) -> Work:
    """Queue ``fn`` (which runs the process-group calls and returns host
    results) on the comm thread, after ``ready_event`` (a staging copy)."""
    with _WORKER_LOCK:
        if _WORKER["thread"] is None or not _WORKER["thread"].is_alive():
            _WORKER["queue"] = queue.Queue()
            _WORKER["thread"] = threading.Thread(target=_worker_loop, args=(_WORKER["queue"],),
                                                 name="dstpu-comm", daemon=True)
            _WORKER["thread"].start()
        work = Work(finish)
        _WORKER["queue"].put((work, fn, ready_event))
    return work


def _drain() -> None:
    """Wait for every launch queued so far."""
    if _WORKER["thread"] is not None and _WORKER["thread"].is_alive():
        _submit(lambda: None).wait()


def _stop_worker() -> None:
    with _WORKER_LOCK:
        thread, q = _WORKER["thread"], _WORKER["queue"]
        _WORKER["thread"] = _WORKER["queue"] = None
    if thread is not None and thread.is_alive():
        q.put(None)
        thread.join()


_SIDE_STREAMS = {}


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` must go through host memory: a CUDA tensor on gloo."""
    return t.is_cuda and get_backend(group) == "gloo"


def _to_host(group, t: torch.Tensor, copy: bool = False):
    """``(src, ready)``: ``t`` as the process group reads it (contiguous; for
    a CUDA tensor on gloo a pinned host copy made on a side stream, with
    ``ready`` the event of that copy), fp8 as its bytes (which gloo moves; it
    has no fp8 type). ``copy`` makes ``src`` a tensor of its own even when
    nothing is staged (for collectives that write their input)."""
    src, ready_event = t.detach().contiguous(), None
    if _staged(group, t):
        dev = src.device
        side = _SIDE_STREAMS.get(dev)
        if side is None:
            side = _SIDE_STREAMS[dev] = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            ready_event = torch.cuda.Event()
            ready_event.record(side)
        src.record_stream(side)
        src = host
    elif copy and src.data_ptr() == t.data_ptr():
        src = src.clone()
    if src.is_floating_point() and src.element_size() == 1:
        src = src.view(torch.uint8)
    return src, ready_event


def _host_empty(shape, like: torch.Tensor, pinned: bool) -> torch.Tensor:
    """An output buffer beside the input ``like`` as the group reads it;
    ``pinned`` (a staged launch) so that the copy back does not block."""
    return torch.empty(shape, dtype=like.dtype, device=like.device, pin_memory=pinned)


def _back(out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A result buffer as ``t``'s dtype on ``t``'s device (queued on the
    current stream)."""
    return out.view(t.dtype).to(t.device, non_blocking=True)


def barrier(group=None) -> None:
    if tdist.is_initialized():
        _submit(lambda: tdist.barrier(group)).wait()


def new_group(ranks: Sequence[int]):
    """A process group of the world ranks ``ranks``; every rank of the world
    must make the same calls in the same order."""
    _drain()
    return tdist.new_group(list(ranks))


def destroy_process_group() -> None:
    """Leave the process group; the published topology, whose axis groups
    die with it, is cleared, and the comm thread stops."""
    from ..runtime import topology as topo_mod
    topo_mod.reset()
    _drain()
    _stop_worker()
    if tdist.is_initialized():
        tdist.destroy_process_group()


# -- collectives ------------------------------------------------------------------

_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM", ReduceOp.MAX: "MAX",
              ReduceOp.MIN: "MIN", ReduceOp.PRODUCT: "PRODUCT"}


def _reduce_op(op) -> "tdist.ReduceOp":
    op = ReduceOp(op) if not isinstance(op, ReduceOp) else op
    return getattr(tdist.ReduceOp, _TORCH_OPS[op])


def all_reduce_async(t: torch.Tensor, op=ReduceOp.SUM, group=None):
    """:func:`all_reduce`, launched: a handle whose ``wait()`` returns it."""
    n = get_world_size(group)
    if n == 1:
        return ready(t.clone())
    buf, ready_event = _to_host(group, t, copy=True)
    avg = ReduceOp(op) == ReduceOp.AVG

    def run():
        tdist.all_reduce(buf, op=_reduce_op(op), group=group)
        return buf

    def finish(out):
        out = _back(out, t)
        return out / n if avg else out

    return _submit(run, ready_event, finish)


def all_reduce(t: torch.Tensor, op=ReduceOp.SUM, group=None) -> torch.Tensor:
    """The reduction of ``t`` over the group (a new tensor); ``AVG``
    divides the sum by the group size."""
    return all_reduce_async(t, op, group).wait()


def all_gather_async(t: torch.Tensor, group=None):
    """:func:`all_gather`, launched: a handle whose ``wait()`` returns it."""
    n = get_world_size(group)
    if n == 1:
        return ready(t.clone())
    src, ready_event = _to_host(group, t)
    out = _host_empty((n * src.shape[0],) + tuple(src.shape[1:]), src, ready_event is not None)

    def run():
        tdist.all_gather_into_tensor(out, src, group=group)
        return out

    return _submit(run, ready_event, lambda o: _back(o, t))


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every member's ``t`` concatenated along dim 0, in rank order."""
    return all_gather_async(t, group).wait()


def reduce_scatter_async(t: torch.Tensor, op=ReduceOp.SUM, group=None):
    """:func:`reduce_scatter`, launched: a handle whose ``wait()`` returns
    it."""
    n = get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce-scatter of leading dim {t.shape[0]} over {n} members")
    if n == 1:
        return ready(t.clone())
    src, ready_event = _to_host(group, t)
    out = _host_empty((src.shape[0] // n,) + tuple(src.shape[1:]), src, ready_event is not None)
    avg = ReduceOp(op) == ReduceOp.AVG

    def run():
        tdist.reduce_scatter_tensor(out, src, op=_reduce_op(op), group=group)
        return out

    def finish(o):
        o = _back(o, t)
        return o / n if avg else o

    return _submit(run, ready_event, finish)


def reduce_scatter(t: torch.Tensor, op=ReduceOp.SUM, group=None) -> torch.Tensor:
    """Member r's rows ``[r * s0, (r + 1) * s0)`` of the reduction of
    ``t [n * s0, ...]`` over the group."""
    return reduce_scatter_async(t, op, group).wait()


def all_to_all_rows_async(t: torch.Tensor, group=None):
    """Row block j of ``t [n * c, ...]`` to member j; member i's block
    received lands at rows ``[i * c, (i + 1) * c)`` (``all_to_all_single``),
    launched: a handle whose ``wait()`` returns the result."""
    n = get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"all-to-all of leading dim {t.shape[0]} over {n} members")
    if n == 1:
        return ready(t.clone())
    src, ready_event = _to_host(group, t)
    out = _host_empty(tuple(src.shape), src, ready_event is not None)

    def run():
        tdist.all_to_all_single(out, src, group=group)
        return out

    return _submit(run, ready_event, lambda o: _back(o, t))


def all_to_all(t: torch.Tensor, group=None, split_axis: int = 0, concat_axis: int = 0,
               kind: Optional[str] = None, axis: Optional[AxisNames] = None) -> torch.Tensor:
    """Split ``t`` along ``split_axis`` into n equal blocks, send block j to
    member j, and concatenate the blocks received along ``concat_axis`` in
    rank order (``lax.all_to_all(..., tiled=True)``). ``kind`` is the
    tensor kind the transport planner reads (``activation``: a bf16 wire
    for a wider dtype, a pure-movement cast restored on receive). A launch
    on a named mesh ``axis`` (the axis ``group`` spans) is recorded there
    with its wire bytes."""
    n = get_world_size(group)
    if t.shape[split_axis] % n:
        raise ValueError(f"all-to-all of dim {split_axis} of {t.shape[split_axis]} over "
                         f"{n} members")
    nbytes = t.numel() * t.element_size()
    plan = (resolve_transport(kind, "all_to_all", nbytes, () if axis is None else axis)
            if kind is not None else FULL_FLAT_PLAN)
    if axis is not None:
        record_collective("all_to_all", nbytes, axis, overlapped=False,
                          wire_bytes=plan.wire_bytes(t.numel(), t.element_size()))
    wire = t
    if plan.width == WIDTH_BF16 and t.element_size() > 2:
        wire = t.to(torch.bfloat16)
    if split_axis == 0 and concat_axis == 0:
        out = all_to_all_rows_async(wire, group).wait()
    else:
        blocks = wire.movedim(split_axis, 0)
        c = blocks.shape[0] // n
        got = all_to_all_rows_async(blocks.reshape((n * c,) + tuple(blocks.shape[1:])),
                                    group).wait()
        got = got.reshape((n, c) + tuple(blocks.shape[1:]))
        out = torch.cat([got[j].movedim(0, split_axis) for j in range(n)], dim=concat_axis)
    return out.to(t.dtype) if wire is not t else out


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Member ``src``'s ``t`` on every member (a new tensor)."""
    if get_world_size(group) == 1:
        return t.clone()
    buf, ready_event = _to_host(group, t, copy=True)

    def run():
        tdist.broadcast(buf, src=src, group=group)
        return buf

    return _submit(run, ready_event, lambda o: _back(o, t)).wait()


def ppermute(t: torch.Tensor, perm: Sequence[Tuple[int, int]], group=None) -> torch.Tensor:
    """Point-to-point permutation over the group (``lax.ppermute``):
    ``perm`` lists ``(source, destination)`` pairs of group ranks; each
    member sends ``t`` to its destination and returns what its source sent,
    zeros where no pair sends to it. ``isend`` / ``irecv``; on gloo a CUDA
    tensor is staged through host memory, as every collective here is."""
    me, n = get_rank(group), get_world_size(group)
    dst = [d for s_, d in perm if s_ == me]
    src = [s_ for s_, d in perm if d == me]
    if n == 1:
        return t.clone() if src else torch.zeros_like(t)
    send, ready_event = _to_host(group, t)
    recv = _host_empty(tuple(send.shape), send, ready_event is not None)
    peer = (lambda r: r) if group is None else (lambda r: tdist.get_global_rank(group, r))

    def run():
        reqs = []
        if dst:
            reqs.append(tdist.isend(send, dst=peer(dst[0]), group=group))
        if src:
            reqs.append(tdist.irecv(recv, src=peer(src[0]), group=group))
        for r in reqs:
            r.wait()
        if not src:
            recv.zero_()
        return recv

    return _submit(run, ready_event, lambda o: _back(o, t)).wait()
