"""PyTorch + CUDA port of ``deepspeed_tpu``, for one NVIDIA H100.

The package mirrors ``deepspeed_tpu``'s module paths so every module has an
obvious counterpart there. It imports ``torch`` and numpy only: nothing of
JAX and nothing of ``deepspeed_tpu``. The slice ported so far is the
ragged-wave serving path (``inference/v2``) with its two hand-written
Hopper kernels (``csrc/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that argument they raise.
"""

from .accelerator import resolve_device  # noqa: F401
