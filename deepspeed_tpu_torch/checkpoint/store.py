"""Checkpoint persistence of the port, in the JAX package's on-disk format.

Counterpart of ``deepspeed_tpu/checkpoint/store.py``, writing and reading
the same files leaf for leaf, so a tag written by either package loads in
the other:

    <dir>/<tag>/state.npz        # leaves ``leaf_{i}``, i indexing the sorted keys
    <dir>/<tag>/meta.json        # keys, dtypes, shapes, num_shard_files,
                                 # checksums (crc32 a data file), client_state
    <dir>/latest                 # text file naming the newest tag
    <dir>/known_good             # the pinned tag, if any

The keys are the JAX state tree's ``/``-joined paths (``params/...``,
``opt/...``, ``grad_acc/...``, ``loss_scale/...``): the engine maps the
port's per-layer ``[out, in]`` tensors to the stacked ``[L, in, out]`` JAX
leaves (``convert.JaxLeaf``). A bf16 leaf is stored as its bits (2-byte
void, what ``np.savez`` makes of an ``ml_dtypes`` bfloat16 array) with
``"bfloat16"`` in ``meta.json``, and read back by its bits; numpy has no bf16.

A world of more than one rank writes ``state.rank{r}.npz`` a rank instead of
``state.npz``: the pieces the rank owns, keyed by their global span in the
JAX leaf, ``leaf_{i}__{start}_{stop}__...``, or ``leaf_{i}__full`` for a
scalar (the JAX ``_owned_pieces``). Every byte of a leaf lies in exactly
one rank file. A load at any world size reads only the slices it needs
(``_PieceReader``).

Durability contract (the JAX store's):

- every data file lands via temp name, fsync, crc32 and ``os.replace``; a
  kill at any instruction leaves the old bytes or the new, never a torn
  file under a committed name; a transient ``OSError`` retries with
  exponential backoff (``RETRIES``, ``BACKOFF_S``);
- ``meta.json`` is the commit record, written after the data it describes
  and carrying each data file's crc32; ``latest`` is repointed after it;
- a load verifies the checksums (always: the port has no switch to skip
  it); when ``latest`` names a tag that fails, it falls back to the pinned
  tag, then to the newest tag that verifies, and raises rather than
  re-initialize silently; an explicitly named tag that fails raises;
- ``retire_old_tags`` keeps the last N tags and never removes the tag
  ``latest`` names, the pinned one, nor a protected one.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import shutil
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..comm import comm as dist

logger = logging.getLogger(__name__)

#: retries of a failed write, and the first backoff (doubled each retry)
RETRIES = 3
BACKOFF_S = 0.05
KNOWN_GOOD_FILE = "known_good"


@dataclasses.dataclass
class Staged:
    """A checkpoint in host memory, ready to write: every leaf of the tag
    (sorted JAX paths, their dtype names and shapes) and the npz members
    this rank writes, keyed ``leaf_{i}`` (every leaf whole, the single-file
    form) or by piece (``rank_files``: this rank's pieces)."""
    keys: List[str]
    dtypes: Dict[str, str]
    shapes: Dict[str, List[int]]
    arrays: Dict[str, np.ndarray]
    rank_files: bool = False


def piece_key(i: int, spans) -> str:
    """The npz member of leaf ``i``'s piece at ``spans`` (a ``(start, stop)``
    an axis; none for a scalar)."""
    spans = "__".join(f"{a}_{b}" for a, b in spans)
    return f"leaf_{i}__{spans}" if spans else f"leaf_{i}__full"


# ---------------------------------------------------------------------------
# durable-write primitives
# ---------------------------------------------------------------------------
def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _crc32_file(path: str, chunk: int = 1 << 24) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def _atomic_write(path: str, payload: Callable[[str], None], suffix: str = ".tmp") -> int:
    """Write ``path`` crash-consistently: payload to a temp name, fsync,
    crc, rename. An ``OSError`` retries with exponential backoff; the temp
    file of a failed attempt is removed. Returns the crc32 of the durable
    bytes."""
    last: Optional[BaseException] = None
    for attempt in range(RETRIES + 1):
        tmp = f"{path}.{os.getpid()}{suffix}"
        try:
            payload(tmp)
            _fsync_file(tmp)
            crc = _crc32_file(tmp)
            os.replace(tmp, path)
            return crc
        except OSError as e:
            last = e
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            if attempt >= RETRIES:
                break
            delay = BACKOFF_S * (2 ** attempt)
            logger.warning(f"checkpoint write of {os.path.basename(path)} failed ({e}); "
                           f"retry {attempt + 1}/{RETRIES} in {delay:.3f}s")
            time.sleep(delay)
    raise OSError(f"checkpoint write of {path} failed after {RETRIES + 1} attempts") from last


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> int:
    # np.savez appends '.npz' to a name without it: the temp suffix keeps
    # the extension or the rename's source would not exist
    return _atomic_write(path, lambda tmp: np.savez(tmp, **arrays), suffix=".tmp.npz")


def _atomic_json(path: str, obj: Any) -> int:
    def payload(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=2, default=str)
    return _atomic_write(path, payload)


def _atomic_text(path: str, text: str) -> int:
    def payload(tmp: str) -> None:
        with open(tmp, "w") as f:
            f.write(text)
    return _atomic_write(path, payload)


def write_latest(save_dir: str, tag: str) -> None:
    """Repoint ``latest`` atomically: the commit point of a checkpoint,
    called only once every data file of ``tag`` and its meta are durable."""
    _atomic_text(os.path.join(save_dir, "latest"), tag)


# ---------------------------------------------------------------------------
# the pinned last-known-good tag
# ---------------------------------------------------------------------------
def pin_known_good(save_dir: str, tag: str) -> None:
    """Pin ``tag`` as the last known-good checkpoint (atomically)."""
    _atomic_text(os.path.join(save_dir, KNOWN_GOOD_FILE), tag)


def read_known_good(save_dir: str) -> Optional[str]:
    """The pinned tag, or None when nothing is pinned or the pin file is
    unreadable (a torn pin must not fail a load)."""
    path = os.path.join(save_dir, KNOWN_GOOD_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            tag = f.read().strip()
    except OSError:
        return None
    return tag or None


def rollback_to_known_good(save_dir: str) -> Optional[str]:
    """Repoint ``latest`` at the pinned tag so that the next resume loads
    it. Returns the tag, or None when nothing is pinned or the pinned bytes
    no longer verify (``latest`` is then left alone)."""
    tag = read_known_good(save_dir)
    if tag is None:
        return None
    ok, reason = verify_tag(os.path.join(save_dir, tag))
    if not ok:
        logger.error(f"rollback: pinned tag '{tag}' fails verification ({reason}); "
                     f"leaving `latest` alone")
        return None
    write_latest(save_dir, tag)
    logger.warning(f"rollback: `latest` repointed to the pinned tag '{tag}'")
    return tag


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------
def _meta(staged: Staged, num_shard_files: int, checksums: Dict[str, int],
          client_state: Dict[str, Any]) -> Dict[str, Any]:
    return {"keys": staged.keys, "dtypes": staged.dtypes, "shapes": staged.shapes,
            "num_shard_files": num_shard_files, "checksums": checksums,
            "client_state": client_state}


def write_staged(save_dir: str, tag: str, staged: Staged, client_state: Dict[str, Any],
                 save_latest: bool = True) -> None:
    """Write a staged single-file checkpoint: data, then ``meta.json`` (the
    commit record, with the data file's checksum), then, optionally,
    ``latest``."""
    path = os.path.join(save_dir, tag)
    os.makedirs(path, exist_ok=True)
    crc = _atomic_savez(os.path.join(path, "state.npz"), staged.arrays)
    # a tag saved before at another world size: its rank files (and their
    # checksum sidecars) must not shadow this one
    for f in glob.glob(os.path.join(path, "state.rank*.npz*")):
        os.remove(f)
    _atomic_json(os.path.join(path, "meta.json"), _meta(staged, 0, {"state.npz": crc},
                                                        client_state))
    if save_latest:
        write_latest(save_dir, tag)


def _write_rank_files(save_dir: str, tag: str, staged: Staged, client_state: Dict[str, Any],
                      save_latest: bool) -> None:
    """This rank's ``state.rank{r}.npz`` and its ``.crc`` sidecar; a barrier;
    rank 0 folds the sidecars into ``meta.json`` and repoints ``latest``; a
    second barrier, so that no rank returns (and perhaps loads) before the
    commit."""
    rank, world = dist.get_rank(), dist.get_world_size()
    path = os.path.join(save_dir, tag)
    os.makedirs(path, exist_ok=True)
    fname = f"state.rank{rank}.npz"
    crc = _atomic_savez(os.path.join(path, fname), staged.arrays)
    # the checksum handoff without a collective: rank 0 reads the sidecars
    # (the directory is shared storage, as the piece reader requires)
    _atomic_text(os.path.join(path, fname + ".crc"), str(crc))
    # commit fence: every rank's file is on disk before rank 0 commits
    dist.barrier()
    if rank == 0:
        single = os.path.join(path, "state.npz")
        if os.path.exists(single):   # a stale single-file tag
            os.remove(single)
        checksums = {}
        for p in range(world):
            fn = f"state.rank{p}.npz"
            with open(os.path.join(path, fn + ".crc")) as f:
                checksums[fn] = int(f.read().strip())
            os.remove(os.path.join(path, fn + ".crc"))
        _atomic_json(os.path.join(path, "meta.json"),
                     _meta(staged, world, checksums, client_state))
        if save_latest:
            write_latest(save_dir, tag)
    # second fence: the other ranks wait for the commit record and `latest`
    dist.barrier()


def save_checkpoint(save_dir: str, tag: str, staged: Staged, client_state: Dict[str, Any],
                    save_latest: bool = True) -> None:
    """Write a staged checkpoint in its form: ``state.npz``, or one rank
    file a rank with the two barriers around rank 0's commit."""
    if staged.rank_files:
        _write_rank_files(save_dir, tag, staged, client_state, save_latest)
    else:
        write_staged(save_dir, tag, staged, client_state, save_latest)


# ---------------------------------------------------------------------------
# verification / retention / fallback
# ---------------------------------------------------------------------------
def verify_tag(path: str) -> Tuple[bool, str]:
    """Is the tag directory ``path`` a complete, uncorrupted checkpoint? Its
    commit record parses, every data file it names exists, and each file
    with a recorded crc32 has it."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return False, "no meta.json (tag never committed)"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (ValueError, OSError) as e:
        return False, f"meta.json unreadable: {e}"
    n = int(meta.get("num_shard_files") or 0)
    files = [f"state.rank{p}.npz" for p in range(n)] if n else ["state.npz"]
    checksums = meta.get("checksums") or {}
    # sidecar data files in the commit record (a JAX offload tag's) count too
    sidecars = [fn for fn in checksums if fn not in files]
    for fn in files + sidecars:
        fp = os.path.join(path, fn)
        if not os.path.exists(fp):
            return False, f"missing data file {fn}"
        if fn in checksums:
            actual = _crc32_file(fp)
            if actual != int(checksums[fn]):
                return False, (f"checksum mismatch on {fn} "
                               f"(recorded {checksums[fn]}, found {actual})")
    return True, "ok"


def _committed_tags(save_dir: str) -> List[Tuple[float, int, str]]:
    """Tags under ``save_dir`` with a commit record, as ``(meta mtime,
    client global_steps, tag)``, oldest first."""
    out = []
    try:
        entries = os.listdir(save_dir)
    except OSError:
        return []
    for name in entries:
        meta_path = os.path.join(save_dir, name, "meta.json")
        if not os.path.isfile(meta_path):
            continue
        try:
            with open(meta_path) as f:
                steps = int(json.load(f).get("client_state", {}).get("global_steps", 0) or 0)
        except (ValueError, OSError, TypeError):
            steps = 0
        out.append((os.path.getmtime(meta_path), steps, name))
    out.sort()
    return out


def find_fallback_tag(load_dir: str, exclude: str) -> Optional[str]:
    """The newest committed tag other than ``exclude`` that verifies."""
    for _, _, tag in reversed(_committed_tags(load_dir)):
        if tag == exclude:
            continue
        ok, reason = verify_tag(os.path.join(load_dir, tag))
        if ok:
            return tag
        logger.warning(f"checkpoint fallback: tag {tag} also fails verification "
                       f"({reason}); continuing search")
    return None


def retire_old_tags(save_dir: str, keep_last: int, protect: Tuple[str, ...] = ()) -> List[str]:
    """Keep-last-N retention: remove the oldest committed tags beyond
    ``keep_last``, never the tag ``latest`` names, the pinned tag, nor one
    in ``protect`` (these count toward the N). Returns the removed tags;
    ``keep_last <= 0`` keeps everything."""
    if keep_last <= 0:
        return []
    keep = set(protect)
    latest_path = os.path.join(save_dir, "latest")
    if os.path.exists(latest_path):
        try:
            with open(latest_path) as f:
                keep.add(f.read().strip())
        except OSError:
            pass
    pinned = read_known_good(save_dir)
    if pinned is not None:
        keep.add(pinned)
    tags = [t for _, _, t in _committed_tags(save_dir)]
    removable = [t for t in tags if t not in keep]
    excess = len(removable) - max(0, keep_last - (len(tags) - len(removable)))
    removed = []
    for tag in removable[:max(0, excess)]:
        try:
            shutil.rmtree(os.path.join(save_dir, tag))
            removed.append(tag)
        except OSError as e:   # retention never fails a save
            logger.warning(f"checkpoint retention: could not remove {tag}: {e}")
    if removed:
        logger.info(f"checkpoint retention: retired {removed} (keep_last={keep_last})")
    return removed


def resolve_tag(load_dir: str, tag: Optional[str]) -> Tuple[Optional[str], bool]:
    """The tag to load, verified: ``(tag, fresh)``, ``fresh`` meaning that
    no checkpoint exists (start from scratch). An explicit tag that fails
    verification raises; a failing tag named by ``latest`` falls back to the
    pinned tag when it verifies, else to the newest tag that does, and
    raises when none does."""
    explicit = tag is not None
    if tag is None:
        latest_path = os.path.join(load_dir, "latest")
        if not os.path.exists(latest_path):
            return None, True
        with open(latest_path) as f:
            tag = f.read().strip()
    path = os.path.join(load_dir, tag)
    ok, reason = verify_tag(path)
    if ok:
        return tag, False
    if explicit:
        if not os.path.exists(os.path.join(path, "meta.json")):
            # a tag that was never committed means "no checkpoint"
            return None, True
        raise ValueError(f"checkpoint tag '{tag}' failed verification: {reason}")
    pinned = read_known_good(load_dir)
    if pinned is not None and pinned != tag and verify_tag(os.path.join(load_dir, pinned))[0]:
        logger.error(f"checkpoint 'latest' names tag '{tag}' which failed verification "
                     f"({reason}); falling back to the pinned tag '{pinned}'")
        return pinned, False
    fb = find_fallback_tag(load_dir, exclude=tag)
    if fb is not None:
        logger.error(f"checkpoint 'latest' names tag '{tag}' which failed verification "
                     f"({reason}); falling back to the newest verified tag '{fb}'")
        return fb, False
    if not os.path.exists(os.path.join(path, "meta.json")) and not _committed_tags(load_dir):
        return None, True   # nothing was ever committed here
    raise RuntimeError(
        f"checkpoint 'latest' names tag '{tag}' which failed verification ({reason}) and no "
        f"other tag under {load_dir} verifies; refusing to re-initialize silently: inspect or "
        f"delete the directory to start fresh")


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------
def _np_dtype(name: str) -> np.dtype:
    """The host dtype a leaf is read at: bf16 as its bits (``uint16``)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _bits(a: np.ndarray) -> np.ndarray:
    """A stored bf16 leaf (2-byte void) as ``uint16`` bits."""
    return a.view(np.uint16) if a.dtype.kind == "V" else a


class _PieceReader:
    """Span-addressed reader over the rank files: assembles a global slice
    of a leaf from only the pieces that intersect it, loading npz members
    lazily, so a rank touches about its share of the tag's bytes."""

    def __init__(self, path: str, meta: Dict[str, Any]):
        n = int(meta["num_shard_files"])
        self._files = [os.path.join(path, f"state.rank{p}.npz") for p in range(n)]
        missing = [f for f in self._files if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(f"checkpoint is missing shard files {missing}: all {n} "
                                    f"rank files are required")
        self._index: Dict[int, list] = {}
        for fi, f in enumerate(self._files):
            with np.load(f) as z:
                names = list(z.files)
            for key in names:
                head, _, spans = key.partition("__")
                i = int(head[len("leaf_"):])
                if spans == "full" or not spans:
                    bounds = tuple((0, d) for d in meta["shapes"][meta["keys"][i]])
                else:
                    bounds = tuple(tuple(map(int, s.split("_"))) for s in spans.split("__"))
                self._index.setdefault(i, []).append((bounds, fi, key))

    def read(self, i: int, shape, dtype, idx) -> np.ndarray:
        """The global slice ``idx`` (a tuple of slices) of leaf ``i``."""
        pieces = self._index.get(i, ())
        if not pieces:
            raise ValueError(f"leaf {i} has no pieces in any rank file: the checkpoint is "
                             f"inconsistent with its meta.json")
        req = tuple((sl.start or 0, sl.stop if sl.stop is not None else dim)
                    for sl, dim in zip(idx, shape)) if idx else ()
        if not req:   # a scalar
            _, fi, k = pieces[0]
            with np.load(self._files[fi]) as z:
                return np.asarray(_bits(z[k]), dtype)
        out = np.empty([b - a for a, b in req], dtype)
        covered = 0
        by_file: Dict[int, list] = {}
        for bounds, fi, k in pieces:
            inter = [(max(a, ba), min(b, bb)) for (a, b), (ba, bb) in zip(req, bounds)]
            if any(a >= b for a, b in inter):
                continue
            by_file.setdefault(fi, []).append((bounds, k, inter))
        for fi, items in by_file.items():
            with np.load(self._files[fi]) as z:
                for bounds, k, inter in items:
                    piece = _bits(z[k])
                    src = tuple(slice(a - ba, b - ba) for (a, b), (ba, _) in zip(inter, bounds))
                    dst = tuple(slice(a - ra, b - ra) for (a, b), (ra, _) in zip(inter, req))
                    out[dst] = piece[src]
                    covered += int(np.prod([b - a for a, b in inter]))
        if covered != out.size:
            raise ValueError(f"leaf {i}: assembled {covered} of {out.size} elements for slice "
                             f"{req}: the rank files are inconsistent")
        return out

    def read_full(self, i: int, shape, dtype) -> np.ndarray:
        return self.read(i, shape, dtype, tuple(slice(0, d) for d in shape))


def _reassemble_rank_shards(path: str, meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every leaf of a rank-file tag, whole (bf16 as ``uint16`` bits)."""
    reader = _PieceReader(path, meta)
    return {k: reader.read_full(i, tuple(meta["shapes"][k]), _np_dtype(meta["dtypes"][k]))
            for i, k in enumerate(meta["keys"])}


class TagReader:
    """Global slices of a committed tag's leaves, in either form (bf16 as
    ``uint16`` bits). A single-file tag's leaf is read from the npz once and
    kept until another leaf is read, so slicing one leaf many times costs one
    read."""

    def __init__(self, path: str, meta: Dict[str, Any]):
        self.meta = meta
        self.index = {k: i for i, k in enumerate(meta["keys"])}
        sharded = int(meta.get("num_shard_files") or 0) > 0
        self._pieces = _PieceReader(path, meta) if sharded else None
        self._npz = None if sharded else np.load(os.path.join(path, "state.npz"))
        self._cached: Tuple[Optional[str], Optional[np.ndarray]] = (None, None)

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def shape(self, key: str) -> Tuple[int, ...]:
        return tuple(self.meta["shapes"][key])

    def dtype(self, key: str) -> str:
        return self.meta["dtypes"][key]

    def read(self, key: str, idx: Optional[Tuple[slice, ...]] = None) -> np.ndarray:
        """Leaf ``key``, or its slice ``idx``."""
        i, shape = self.index[key], self.shape(key)
        if self._pieces is not None:
            idx = idx if idx is not None else tuple(slice(0, d) for d in shape)
            return self._pieces.read(i, shape, _np_dtype(self.dtype(key)), idx)
        if self._cached[0] != key:
            self._cached = (None, None)   # free the last leaf first
            self._cached = (key, _bits(self._npz[f"leaf_{i}"]))
        full = self._cached[1]
        return full if idx is None else full[idx]

    def close(self) -> None:
        self._cached = (None, None)
        if self._npz is not None:
            self._npz.close()

    def __enter__(self) -> "TagReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_checkpoint(load_dir: str, tag: Optional[str]
                    ) -> Tuple[Optional[TagReader], Dict[str, Any], Optional[str]]:
    """Resolve and verify the tag to load (``resolve_tag``): ``(reader,
    client_state, tag)``, or ``(None, {}, None)`` when there is no
    checkpoint. The caller closes the reader."""
    tag, fresh = resolve_tag(load_dir, tag)
    if fresh:
        return None, {}, None
    path = os.path.join(load_dir, tag)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return TagReader(path, meta), meta.get("client_state", {}), tag
