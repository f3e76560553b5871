"""Checkpoints of the port, in the JAX package's on-disk format
(``deepspeed_tpu/checkpoint``)."""

from .checkpoint_engine import (AsyncCheckpointEngine, CheckpointEngine,  # noqa: F401
                                NpzCheckpointEngine)
from .ds_to_universal import ds_to_universal, load_universal  # noqa: F401
from .store import (load_checkpoint, resolve_tag, retire_old_tags,  # noqa: F401
                    save_checkpoint, verify_tag)
