"""Device scratch that kernel wrappers keep between launches, safe under
CUDA graph capture.

A wrapper keeps a buffer per (device, stream, name) and grows it when a
launch needs more. A CUDA graph bakes the address of every buffer its
launches read into the graph, so a buffer handed out while a capture is
underway is HELD for the life of the process: a later growth of its key
allocates a new buffer and leaves the held one where the graph points. A
buffer is never allocated inside a capture (that growth raises): the eager
run of a step on the capture stream, before the capture, allocates it
(``inference/v2/decode_graph.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List

import torch


class Scratch:

    def __init__(self):
        self._live: Dict[Hashable, torch.Tensor] = {}
        #: every buffer handed out under a capture, alive as long as this
        self.held: List[torch.Tensor] = []

    def get(self, key: Hashable, numel: int, make: Callable[[int], torch.Tensor],
            capturing: bool) -> torch.Tensor:
        """The buffer of ``key`` with at least ``numel`` elements, made by
        ``make(numel)`` when there is none that large; ``capturing``: a
        CUDA graph capture is underway on the caller's stream."""
        buf = self._live.get(key)
        if buf is None or buf.numel() < numel:
            if capturing:
                raise RuntimeError(
                    f"kernel scratch {key!r} must grow to {numel} elements during a CUDA "
                    f"graph capture: run the captured step once on the capture stream "
                    f"first, so that its scratch is allocated outside the capture")
            buf = self._live[key] = make(numel)
        if capturing and not any(h is buf for h in self.held):
            self.held.append(buf)
        return buf
