"""Quantizer kernels of the port (counterpart of
``deepspeed_tpu/ops/quantizer``): ``woq_matmul``, the weight-only-quantized
matmul; ``quant``, the symmetric int8 row quantizer of the ZeRO++ wire; and
``quantizer``, blockwise quantization and the quantized collectives built
on it."""
