"""npz-based pytree checkpointing with step management, hardened for
preemption — port of ``repro.checkpoint.ckpt``, file format included.

Layout: ``<dir>/step_<N>.npz`` with leaves flattened to path-keyed
arrays plus a json-encoded dtype manifest (stored inside the npz under a
reserved key) so every leaf round-trips **bit-exactly**:

- dtypes numpy serializes natively (bool / ints / floats) are stored as
  they are;
- ``torch.bfloat16`` and the ``float8_*`` types, which numpy has no dtype
  for, are packed as raw bytes with the manifest entry
  ``{"dtype": "bfloat16", "packed": 1}`` and re-viewed on load through
  ``torch.frombuffer(...).view(dtype)``: no ``ml_dtypes`` is needed.

A pytree here is nested dicts, tuples, lists and NamedTuples of tensors
(numpy arrays and Python scalars are leaves too); ``None`` is an empty
subtree.  Leaf keys join the path with ``|`` as the reference renders
``jax.tree_util.tree_flatten_with_path``: a dict key, a sequence index, a
NamedTuple field name; dict entries are visited in sorted key order, as
JAX visits them.  So a file either package writes loads in the other.

Writes are preemption-safe: the payload goes to a pid-unique ``.tmp``
sibling, is fsync'd, and lands via atomic ``os.replace``, followed by an
fsync of the directory; a killed writer leaves only ``.tmp`` litter,
which ``latest_step`` ignores and the next ``save_pytree`` sweeps up.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

_SEP = "|"
# Reserved npz entry holding the json dtype/shape manifest ("__"-framed
# names never arise from a leaf path).
_META_KEY = "__ckpt_meta__"
_TMP_RE = re.compile(r"step_\d+\.npz\.tmp(?:\.(\d+))?$")

# Tensor dtypes numpy cannot hold, by the name the manifest gives them
# (ml_dtypes' names, as the reference writes them).
_PACKED = {
    name: getattr(torch, name)
    for name in ("bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                 "float8_e5m2fnuz")
    if hasattr(torch, name)
}
_PACKED_NAME = {dt: name for name, dt in _PACKED.items()}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A restore template leaf: the shape and dtype a leaf must have
    (``dtype`` a ``torch.dtype``, a numpy dtype or its name)."""

    shape: Tuple[int, ...]
    dtype: Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=()):
    """(path, leaf) pairs in the reference's order; None has no leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (k,))
        return out
    if _is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += _flatten(v, path + (name,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (i,))
        return out
    return [(path, tree)]


def _leaf_keys(tree):
    """(key, leaf) pairs using the stable path-joined key scheme."""
    return [(_SEP.join(str(p) for p in path), leaf) for path, leaf in _flatten(tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _dtype_name(dtype) -> str:
    """The manifest's name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype in _PACKED_NAME:
            return _PACKED_NAME[dtype]
        return torch.empty((), dtype=dtype).numpy().dtype.name
    if isinstance(dtype, str) and dtype in _PACKED:
        return dtype
    return np.dtype(dtype).name


def _torch_dtype(name: str) -> torch.dtype:
    if name in _PACKED:
        return _PACKED[name]
    try:
        return torch.from_numpy(np.empty((0,), dtype=np.dtype(name))).dtype
    except TypeError as e:
        raise TypeError(f"cannot resolve checkpoint dtype {name!r}") from e


def _pack(leaf):
    """Return (storable ndarray, meta dict) for one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        meta = {"dtype": _dtype_name(t.dtype), "shape": list(t.shape)}
        if t.dtype in _PACKED_NAME:
            # npz would reject these: store raw bytes
            meta["packed"] = 1
            return t.reshape(-1).view(torch.uint8).numpy(), meta
        return t.numpy(), meta
    arr = np.asarray(leaf)
    meta = {"dtype": arr.dtype.name, "shape": list(arr.shape)}
    if arr.dtype.isbuiltin != 1:  # a user-registered numpy dtype
        meta["packed"] = 1
        arr = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
    return arr, meta


def _unpack(arr: np.ndarray, meta: Optional[dict]) -> torch.Tensor:
    if meta and meta.get("packed"):
        raw = torch.frombuffer(bytearray(arr.tobytes()), dtype=torch.uint8)
        return raw.view(_torch_dtype(meta["dtype"])).reshape(meta["shape"])
    return torch.from_numpy(arr.copy())


def _sweep_stale_tmps(directory: str) -> None:
    """Remove ``.tmp`` litter from killed writers (best-effort).

    pid-suffixed tmps belonging to a *live* process are left alone so a
    concurrent writer is never sabotaged.
    """
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for f in names:
        m = _TMP_RE.search(f)
        if not m:
            continue
        pid = m.group(1)
        if pid is not None and int(pid) != os.getpid():
            try:
                os.kill(int(pid), 0)
                continue  # writer still alive; not ours to clean
            except OSError:
                pass  # dead writer
        elif pid is not None:
            continue  # our own in-flight tmp
        try:
            os.remove(os.path.join(directory, f))
        except OSError:
            pass


# Transient-OSError retry policy for save_pytree: shared filesystems
# (NFS, FUSE, overlay mounts on preemptible workers) throw spurious
# EIO/ESTALE under contention; a short bounded exponential backoff rides
# those out without masking a genuinely broken disk.
SAVE_RETRIES = 3
SAVE_BACKOFF_S = 0.1


def save_pytree(
    directory: str,
    tree: Any,
    step: int,
    *,
    retries: int = SAVE_RETRIES,
    backoff_s: float = SAVE_BACKOFF_S,
) -> str:
    """Atomically persist ``tree`` as ``<directory>/step_<step>.npz``.

    Transient ``OSError`` during the write/fsync/rename is retried up to
    ``retries`` times with exponential backoff (``backoff_s * 2**attempt``
    seconds); each attempt rewrites the tmp sibling from scratch, so a
    half-written file is never renamed in.  After the final attempt the
    original error propagates, chained under a message naming the path.
    """
    os.makedirs(directory, exist_ok=True)
    _sweep_stale_tmps(directory)
    flat, meta = {}, {}
    for key, leaf in _leaf_keys(tree):
        if key == _META_KEY:
            raise ValueError(f"leaf key collides with reserved {_META_KEY!r}")
        flat[key], meta[key] = _pack(leaf)
    flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = f"{path}.tmp.{os.getpid()}"
    for attempt in range(retries + 1):
        try:
            try:
                with open(tmp, "wb") as f:
                    np.savez(f, **flat)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):  # failed mid-write; no litter
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
            break
        except OSError as e:
            if attempt == retries:
                raise OSError(
                    f"save_pytree: writing {path!r} failed "
                    f"{retries + 1} times (last: {e}); check the snapshot "
                    f"filesystem"
                ) from e
            time.sleep(backoff_s * (2 ** attempt))
    try:  # make the rename durable too (best-effort on odd filesystems)
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return path


def _leaf_shape_dtype(leaf):
    """(shape, dtype) of a template leaf: a tensor, a ``TensorSpec``, or
    anything with ``.shape`` and ``.dtype`` (a numpy array); else its
    numpy conversion (Python scalars)."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        as_np = np.asarray(leaf)
        shape, dtype = as_np.shape, as_np.dtype
    return tuple(int(s) for s in shape), dtype


def load_pytree(
    directory: str, like: Any, step: Optional[int] = None, *, device=None
) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (shapes must match).

    ``like`` leaves only need ``.shape``/``.dtype``: tensors and
    ``TensorSpec`` templates both work.  Leaves come back as tensors on
    ``device`` (default: a tensor leaf's own device, else the CPU).  When
    the checkpoint carries a dtype manifest (everything written by this
    version), leaves are restored bit-exactly and a dtype mismatch with
    ``like`` is an error rather than a silent cast; manifest-less legacy
    files keep the cast-to-like behavior.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            detail = (
                "directory does not exist"
                if not os.path.isdir(directory)
                else "directory has no committed step_<N>.npz files"
            )
            raise FileNotFoundError(
                f"no checkpoints in {directory!r} ({detail}); point "
                f"resume_from at a directory written by save_snapshot/"
                f"save_pytree, or start a fresh run without resume_from"
            )
    path = os.path.join(directory, f"step_{step:08d}.npz")
    if not os.path.exists(path):
        committed = latest_step(directory)
        raise FileNotFoundError(
            f"checkpoint {path!r} does not exist"
            + (
                f"; latest committed step in {directory!r} is {committed}"
                if committed is not None
                else f"; {directory!r} has no committed snapshots"
            )
        )
    try:
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
        raise ValueError(
            f"checkpoint {path!r} is unreadable ({type(e).__name__}: {e}); "
            f"the file is corrupt or torn — delete it and resume from an "
            f"earlier committed step"
        ) from e
    meta = None
    if _META_KEY in flat:
        meta = json.loads(flat.pop(_META_KEY).tobytes().decode("utf-8"))
    pairs = _leaf_keys(like)
    missing = {k for k, _ in pairs} - set(flat)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    new_leaves = []
    for key, leaf in pairs:
        m = meta.get(key) if meta else None
        t = _unpack(flat[key], m)
        shape, dtype = _leaf_shape_dtype(leaf)
        if tuple(t.shape) != shape:
            raise ValueError(f"shape mismatch at {key}: {tuple(t.shape)} vs {shape}")
        want = _dtype_name(dtype)
        if meta is not None:
            if m["dtype"] != want:
                raise ValueError(
                    f"dtype mismatch at {key}: checkpoint has {m['dtype']}, "
                    f"template wants {want}"
                )
        else:
            t = t.to(_torch_dtype(want))
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else None)
        new_leaves.append(t if dev is None else t.to(dev))
    return _unflatten(like, iter(new_leaves)), step


def latest_step(directory: str) -> Optional[int]:
    """Largest committed step, ignoring ``.tmp`` litter from killed writers.

    Only fully-renamed ``step_<N>.npz`` files match; an interrupted
    writer's ``step_<N>.npz.tmp.<pid>`` never does, so a resume cannot
    pick up a torn file.
    """
    if not os.path.isdir(directory):
        return None
    steps = []
    for f in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)\.npz", f)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None
