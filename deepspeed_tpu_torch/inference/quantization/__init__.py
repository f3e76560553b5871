from .quantization import (QuantizationConfig, dequantize_kernel,  # noqa: F401
                           dequantize_param_tree, host_quantize_kernel,
                           quantize_kernel, quantize_param_tree,
                           quantized_matmul, quantized_tree_bytes)
