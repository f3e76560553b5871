"""Attention for the serving path: plain PyTorch versions and the wrappers of
the hand-written CUDA kernels in ``deepspeed_tpu_torch/csrc``."""
