"""Offline fp32 weight consolidation.

Counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py``: full-precision
model weights from a checkpoint, without building an engine. The tags hold
leaves by logical path, whole (``state.npz``) or in pieces a rank
(``state.rank{r}.npz``, reassembled by global span), so consolidation takes
the fp32 master of each param where the optimizer saved one, else the
param widened (bf16 by its bits). Tags with an offloaded optimizer's
sidecar raise (ROADMAP A9). Run it as

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint dir> <out.npz> [--tag T]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

import numpy as np

from ..checkpoint.store import _reassemble_rank_shards


def _fp32(a: np.ndarray, dtype: str) -> np.ndarray:
    """fp32 values of a leaf whose meta dtype is ``dtype`` (bf16 by its bits)."""
    if dtype == "bfloat16":
        return (np.asarray(a).view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str, tag: Optional[str] = None
                                             ) -> Dict[str, np.ndarray]:
    """``{param path: fp32 array}`` (paths without ``params/``)."""
    if tag is None:
        with open(os.path.join(ckpt_dir, "latest")) as f:
            tag = f.read().strip()
    path = os.path.join(ckpt_dir, tag)
    if os.path.exists(os.path.join(path, "offload_optimizer.npz")) or glob.glob(
            os.path.join(path, "offload_optimizer.rank*.npz")):
        raise NotImplementedError(f"{path} holds an offloaded optimizer's state: "
                                  f"offload is not ported, ROADMAP A9")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if int(meta.get("num_shard_files") or 0) > 0:
        by_key = _reassemble_rank_shards(path, meta)
    else:
        with np.load(os.path.join(path, "state.npz")) as data:
            by_key = {k: data[f"leaf_{i}"] for i, k in enumerate(meta["keys"])}
    out: Dict[str, np.ndarray] = {}
    for key in by_key:
        if key.startswith("params/"):
            name = key[len("params/"):]
            src = f"opt/master/{name}" if f"opt/master/{name}" in by_key else key
            out[name] = _fp32(by_key[src], meta["dtypes"][src])
    return out


def convert_zero_checkpoint_to_fp32_state_dict(ckpt_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> None:
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    np.savez(output_file, **{k.replace("/", "."): v for k, v in sd.items()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Extract consolidated fp32 weights from a "
                                            "checkpoint")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)
    print(f"saved fp32 state dict to {args.output_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
