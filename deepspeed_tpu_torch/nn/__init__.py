"""Layer library of the port (counterpart of ``deepspeed_tpu/nn``)."""
