"""Quantized-weight kernels of the port (counterpart of
``deepspeed_tpu/ops/quantizer``): ``woq_matmul``, the weight-only-quantized
matmul."""
