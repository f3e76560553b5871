"""Device resolution for the port's entry points.

Counterpart of ``deepspeed_tpu/accelerator/real_accelerator.py``, reduced
to what serving needs: the port runs on ``cuda`` by default, runs on the
CPU only when the caller asks for it (``device="cpu"``, as the tests do),
and raises rather than falling back to the CPU when no GPU is present.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; raises without one. An explicit
    device is taken as given, except that a CUDA device needs CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
