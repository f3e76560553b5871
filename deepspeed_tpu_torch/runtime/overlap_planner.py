"""The overlap planner, for the ZeRO overlap schedule.

Counterpart of ``deepspeed_tpu/runtime/overlap_planner.py``, reduced to what
the ZeRO entry needs: ``OverlapPlan`` and ``IDENTITY_PLAN``, the placement
names, the committed collective map read as data (``load_map``, the
records, ``_loop_exposed_bytes``), the ``zeropp-micro-overlap`` derivation
(``_plan_zeropp``) and ``plan_for``. The map is the JAX package's
``tools/collective_maps/zeropp-micro-overlap.json``, read and never
written; with no map the plan is the same default JAX derives.

``plan_for(entry, config_flag)`` is the entry's plan, or the identity plan
(the hand schedule: prefetch depth 1, no edge split, no deferred flush)
when the engine config says ``overlap_plan: false``. There is no
environment switch. The MoE, Ulysses and serving derivations wait for their
consumers in the port, so those entries get the identity plan.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

PLACEMENT_SCAN_CARRY = "scan-carry"
PLACEMENT_STRAIGHT_LINE = "straight-line"
PLACEMENT_INLINE = "inline"

ZEROPP_ENTRY = "zeropp-micro-overlap"


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """One entry point's overlap decision, the JAX fields. The ZeRO
    schedule reads ``placement`` (scan-carry: the plan applies),
    ``prefetch_depth`` (1 or 2 layers ahead), the bucket overrides
    (None: the config's), ``split_edge_leaves`` (head-side leaves gathered
    before the forward blocks and scattered before the backward blocks) and
    ``defer_replicated`` (replicated block leaves reduced once, fused, at the
    micro-step boundary). ``carry_error_feedback``: the error-feedback
    residuals ride the micro-step carry where ``comm_transport.
    error_feedback`` asks for them (``DataParallelEngine._build_overlap``);
    the identity plan carries none."""
    entry: str
    placement: str = PLACEMENT_INLINE
    prefetch_depth: int = 0
    n_chunks: int = 1
    allgather_bucket: Optional[int] = None
    reduce_bucket: Optional[int] = None
    transport_kind: Optional[str] = None
    carry_error_feedback: bool = False
    split_edge_leaves: bool = False
    defer_replicated: bool = False
    source: str = "default"
    notes: Tuple[str, ...] = ()

    def summary(self) -> str:
        bits = [self.placement]
        if self.placement == PLACEMENT_SCAN_CARRY:
            bits.append(f"prefetch={self.prefetch_depth}")
        if self.n_chunks > 1:
            bits.append(f"chunks={self.n_chunks}")
        if self.transport_kind:
            bits.append(f"kind={self.transport_kind}")
        if self.carry_error_feedback:
            bits.append("ef-carry")
        if self.split_edge_leaves:
            bits.append("edge-split")
        if self.defer_replicated:
            bits.append("defer-repl")
        return "/".join(bits)


IDENTITY_PLAN = OverlapPlan(entry="", placement=PLACEMENT_INLINE)


def default_maps_dir() -> str:
    """``tools/collective_maps`` of the checkout that holds this package."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "tools", "collective_maps")


_MAP_CACHE: Dict[str, Optional[Dict[str, Any]]] = {}


def load_map(entry: str, maps_dir: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The committed collective map of ``entry``, or None where there is
    none (or it does not parse): the plan then takes its defaults."""
    path = os.path.join(maps_dir or default_maps_dir(), f"{entry}.json")
    if path not in _MAP_CACHE:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                _MAP_CACHE[path] = json.load(fh)
        except (OSError, ValueError):
            _MAP_CACHE[path] = None
    return _MAP_CACHE[path]


def _records(mp: Optional[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return list(mp.get("collectives", [])) if mp else []


def _moved(rec: Dict[str, Any]) -> int:
    return int(rec.get("operand_bytes", 0)) * int(rec.get("executions", 1))


def _loop_exposed_bytes(mp: Optional[Dict[str, Any]]) -> int:
    """Exposed bytes of the collectives inside a compiled loop: what a
    deeper prefetch could still hide."""
    return sum(_moved(r) for r in _records(mp)
               if r.get("loop") and r.get("classification") != "overlapped")


def _plan_zeropp(entry: str, mp: Optional[Dict[str, Any]]) -> OverlapPlan:
    """The pipelined ZeRO micro step: prefetch depth 1 while the map shows
    the in-loop collectives overlapped, 2 where it shows exposed in-loop
    bytes; the edge split, the deferred replicated flush and the
    error-feedback carry on."""
    notes: List[str] = []
    depth = 1
    loop_exposed = _loop_exposed_bytes(mp)
    if loop_exposed:
        depth = 2
        notes.append(f"map shows {loop_exposed} exposed in-loop bytes at "
                     f"depth 1; deriving prefetch depth 2 (triple-buffered "
                     f"carry, executed by scan_blocks_pipelined)")
    return OverlapPlan(
        entry=entry, placement=PLACEMENT_SCAN_CARRY, prefetch_depth=depth,
        carry_error_feedback=True, split_edge_leaves=True,
        defer_replicated=True, source="map" if mp else "default",
        notes=tuple(notes))


PLAN_DERIVATIONS = {ZEROPP_ENTRY: _plan_zeropp}


def plan_for(entry: str, config_flag: Optional[bool] = None,
             maps_dir: Optional[str] = None) -> OverlapPlan:
    """``entry``'s plan from its committed map, or the identity plan when
    ``config_flag`` is false (``overlap_plan: false``) or the entry has no
    derivation here."""
    derive = PLAN_DERIVATIONS.get(entry)
    if derive is None or (config_flag is not None and not config_flag):
        return dataclasses.replace(IDENTITY_PLAN, entry=entry)
    return derive(entry, load_map(entry, maps_dir))
