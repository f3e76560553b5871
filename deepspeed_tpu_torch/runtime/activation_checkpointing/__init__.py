"""Activation checkpointing of the port (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing``)."""
