"""Universal checkpoint conversion.

Counterpart of ``deepspeed_tpu/checkpoint/ds_to_universal.py``: explodes a
single-file tag into one directory a parameter, ``zero/<param.path>/``,
holding ``fp32.npy`` (the master), ``exp_avg.npy`` and ``exp_avg_sq.npy``
(``sum_sq`` for adagrad), and ``bit16.npy`` (the model's params, whose bf16
leaves keep their bits), plus ``universal_meta.json``. The tags hold leaves
by logical path, so the conversion is a re-keying. Run it as

    python -m deepspeed_tpu_torch.checkpoint.ds_to_universal <tag dir> <out dir> [--tag T]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

_SLOT_MAP = {
    "master": "fp32",
    "exp_avg": "exp_avg",
    "exp_avg_sq": "exp_avg_sq",
    "sum_sq": "exp_avg_sq",
}


def _load_state(ckpt_dir: str, tag: Optional[str]):
    if tag is None:
        with open(os.path.join(ckpt_dir, "latest")) as f:
            tag = f.read().strip()
    path = os.path.join(ckpt_dir, tag)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "state.npz")) as data:
        return {k: data[f"leaf_{i}"] for i, k in enumerate(meta["keys"])}, meta, tag


def ds_to_universal(ckpt_dir: str, out_dir: str, tag: Optional[str] = None) -> int:
    """Write the universal layout; returns the number of slots written."""
    by_key, meta, tag = _load_state(ckpt_dir, tag)
    count = 0
    for key, value in by_key.items():
        parts = key.split("/")
        if parts[0] == "opt" and len(parts) >= 3 and parts[1] in _SLOT_MAP:
            slot, param_path = _SLOT_MAP[parts[1]], "/".join(parts[2:])
        elif parts[0] == "params":
            # the model's bit16 weights: authoritative only without an fp32 master
            slot, param_path = "bit16", "/".join(parts[1:])
        else:
            continue
        pdir = os.path.join(out_dir, "zero", param_path.replace("/", "."))
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, f"{slot}.npy"), value)
        count += 1
    with open(os.path.join(out_dir, "universal_meta.json"), "w") as f:
        json.dump({"source_tag": tag, "format": "dstpu_universal_v1"}, f)
    return count


def _fp32(a: np.ndarray) -> np.ndarray:
    """fp32 values of an array; a bf16 one (2-byte void) by its bits."""
    if a.dtype.kind == "V":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def load_universal(out_dir: str) -> Dict[str, np.ndarray]:
    """``{param.path: fp32 weights}``: the master where there is one, else
    the bit16 weights widened."""
    zero_dir = os.path.join(out_dir, "zero")
    out = {}
    for name in sorted(os.listdir(zero_dir)):
        pdir = os.path.join(zero_dir, name)
        fp32 = os.path.join(pdir, "fp32.npy")
        bit16 = os.path.join(pdir, "bit16.npy")
        if os.path.exists(fp32):
            out[name] = np.load(fp32)
        elif os.path.exists(bit16):
            out[name] = _fp32(np.load(bit16))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Convert a checkpoint to the universal format")
    p.add_argument("input_folder")
    p.add_argument("output_folder")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    n = ds_to_universal(args.input_folder, args.output_folder, args.tag)
    print(f"wrote {n} parameter slots to {args.output_folder}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
