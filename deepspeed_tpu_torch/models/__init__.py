"""Model family of the port (counterpart of ``deepspeed_tpu/models``)."""

from .llama import llama_config, llama_model  # noqa: F401
from .mixtral import mixtral_config, mixtral_model  # noqa: F401
from .transformer import MoEConfig, TransformerConfig, TransformerLM  # noqa: F401
