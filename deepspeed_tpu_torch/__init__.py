"""PyTorch + CUDA port of ``deepspeed_tpu``, for one NVIDIA H100.

The package mirrors ``deepspeed_tpu``'s module paths so every module has an
obvious counterpart there. It imports ``torch`` and numpy only: nothing of
JAX and nothing of ``deepspeed_tpu``. The slices ported so far are the
ragged-wave serving path (``inference/v2``), dense, from int8 / int4
weight-only-quantized weights (``inference/quantization``) or through
mixture-of-experts layers (``moe``, Mixtral), the
single-device training step (``initialize`` +
``DeepSpeedEngine.train_batch``) with the Adam family or Lion, and
data-parallel training over ``torch.distributed`` with ZeRO stages 0-3, the
ZeRO++ int8 wire and the layer-pipelined overlap schedule
(``DataParallelEngine``: ``comm``, ``runtime/zero``),
with their hand-written Hopper kernels (``csrc/``).

Front door (``deepspeed_tpu/__init__.py:67``):

    engine, optimizer, dataloader, lr_scheduler = deepspeed_tpu_torch.initialize(
        model=model, config=config_dict)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that argument they raise. A world of more than
one rank (``comm.init_distributed`` first, or ``dist_init_required=True``)
gets the data-parallel engine; every rank calls ``initialize`` and
``train_batch`` with the same global batch and trains on its own rows.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from .accelerator import resolve_device  # noqa: F401
from .comm import comm
from .runtime.config import DeepSpeedConfig, DeepSpeedConfigError  # noqa: F401
from .runtime.engine import (DataParallelEngine, DeepSpeedEngine,  # noqa: F401
                             OnebitDataParallelEngine, OnebitEngine)
from .runtime.optimizers import is_onebit


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, distributed_port: int = 29500,
               topology=None, dist_init_required: Optional[bool] = None, collate_fn=None,
               config: Optional[Any] = None,
               config_params: Optional[Dict[str, Any]] = None, seed: int = 42,
               device=None):
    """Build a ready-to-train engine; returns ``(engine, optimizer,
    dataloader, lr_scheduler)`` as the JAX ``initialize`` does.

    ``model`` is a ``TransformerLM`` or an ``EncoderTaskModel`` (on the meta
    device it is given storage and seeded weights, the same on every rank); ``model_parameters`` an
    optional state_dict of full weights to start from; ``config`` a dict, a
    JSON path or a ``DeepSpeedConfig``. The optimizer and schedule come from
    the config: client optimizer and scheduler objects are not taken.
    ``dist_init_required=True`` joins the process group from torchrun's
    variables (``comm.init_distributed``); ``topology`` (a
    ``runtime.topology.MeshTopology``) defaults to the world. A world of
    more than one rank builds a ``DataParallelEngine``; a 1-bit optimizer
    (``onebit_adam``, ``onebit_lamb``, ``zero_one_adam``) an ``OnebitEngine``
    or ``OnebitDataParallelEngine``. ``training_data``
    (an indexable of sample dicts) comes back as the JAX loader
    (``runtime/dataloader.py`` ``DeepSpeedDataLoader``: shuffled, the short
    last batch dropped, samples stacked by ``collate_fn`` or ``np.stack``)
    over batches of the micro batch times the data ranks."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if optimizer is not None or lr_scheduler is not None:
        raise ValueError("configure 'optimizer' and 'scheduler' in the config; "
                         "client optimizer / scheduler objects are not taken")
    config = config if config is not None else config_params
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if dist_init_required:
        comm.init_distributed(distributed_port=distributed_port)
    if not isinstance(config, DeepSpeedConfig):
        config = DeepSpeedConfig(config or {})
    kw = dict(model=model, config=config, seed=seed, init_params=model_parameters,
              device=device)
    onebit = is_onebit(config.optimizer)
    if comm.get_world_size() > 1:
        engine = (OnebitDataParallelEngine if onebit else DataParallelEngine)(
            topology=topology, **kw)
    else:
        engine = (OnebitEngine if onebit else DeepSpeedEngine)(**kw)
    dataloader = None
    topo = getattr(engine, "topology", None)
    # a global batch's rows split over the data ranks only (a seq axis splits
    # the sequence)
    rows_split = comm.get_world_size() // (1 if topo is None else topo.sequence_parallel_size)
    if training_data is not None:
        from .runtime.dataloader import DeepSpeedDataLoader
        dataloader = DeepSpeedDataLoader(
            training_data,
            batch_size=engine.train_micro_batch_size_per_gpu * rows_split,
            collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler
