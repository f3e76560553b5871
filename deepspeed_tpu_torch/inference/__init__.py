"""Inference of the port (counterpart of ``deepspeed_tpu/inference``)."""
