"""Bucket helper of ``deepspeed_tpu/inference/v2/ragged/ragged_wrapper.py``.

The wave builder pads its shapes to these power-of-two buckets; the port
keeps them so its wave descriptors are the JAX builder's, bit for bit.
"""

from __future__ import annotations


def _next_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b
