"""Carry parameter stores into the port, and checkpoint them and training state.

The counterpart of ``cirkit_tpu/utils/checkpoint.py:31-168``, the npz half.
A compiled circuit's parameters are a flat mapping from slot name to an
``(F, ...)`` array, with the same slot names in the JAX package and in the
port, so a store moves between them by name:
``store_from_numpy({k: np.asarray(v) for k, v in jax_ctx.parameters.items()},
device=..., slots=...)``.

:func:`save_store` / :func:`load_store` write and read a tree of arrays
(nested dicts, lists and tuples of tensors or arrays) as one ``.npz`` file
with the JAX package's key encoding: each leaf's key is the JSON list of its
path entries, ``["d", key]`` for a dict key and ``["s", index]`` for a
sequence index. A flat store saved by either package therefore loads in the
other by slot name. bfloat16 leaves, which npz cannot hold, are widened to
float32 on save and cast back to ``like``'s dtype on load.

The orbax directory checkpoints of the JAX package (``save_checkpoint`` /
``load_checkpoint``) are not ported.
"""

from __future__ import annotations

import json
import os
import zlib
from collections.abc import Mapping
from os import PathLike
from typing import Any

import numpy as np
import torch


def store_from_numpy(
    arrays: Mapping[str, np.ndarray],
    *,
    device: torch.device | str,
    dtype: torch.dtype | None = None,
    slots: Mapping | None = None,
) -> dict[str, torch.Tensor]:
    """Tensors on ``device`` copied from a mapping of slot name to array.

    ``dtype`` casts every array (default: keep each array's dtype). With
    ``slots`` (slot name -> compiled tensor slot, e.g. ``cc.slots``), the
    names must be exactly the slots' names and every array must have its
    slot's ``(F, *shape)``; anything else raises.
    """
    if slots is not None:
        missing = sorted(set(slots) - set(arrays))
        unknown = sorted(set(arrays) - set(slots))
        if missing or unknown:
            raise KeyError(f"Store names do not match the slots: missing {missing}, "
                           f"unknown {unknown}")
        for name, node in slots.items():
            expected = (node.num_folds, *node.shape)
            if tuple(np.shape(arrays[name])) != expected:
                raise ValueError(
                    f"Slot {name} has shape {expected}, the array {np.shape(arrays[name])}"
                )
    return {
        name: torch.tensor(np.asarray(a), device=device, dtype=dtype)
        for name, a in arrays.items()
    }


def _leaves(tree: Any, path: tuple = ()):
    """(path entries, leaf) pairs in the order of ``jax.tree_util``: dicts by
    sorted key, sequences by index."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key], (*path, ["d", key]))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, (*path, ["s", i]))
    else:
        yield list(path), tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # not npz-native: lossless widening
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {json.dumps(path): _to_numpy(leaf) for path, leaf in _leaves(tree)}


def save_store(path: str | PathLike[str], tree: Any) -> None:
    """Serialize a tree of tensors or arrays (a parameter store, optimizer
    state, ...) to a single ``.npz`` file."""
    np.savez(path, **_flatten(tree))


def _restore_like(value: np.ndarray, like: Any) -> Any:
    """``value`` as ``like`` holds it: a tensor of its dtype on its device,
    or an array of its dtype."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(value).to(device=like.device, dtype=like.dtype)
    dtype = getattr(like, "dtype", None)
    return value if dtype is None or value.dtype == dtype else value.astype(dtype)


def _rebuild(like: Any, stored: dict[str, np.ndarray], path: tuple, file: str) -> Any:
    if isinstance(like, Mapping):
        return {k: _rebuild(v, stored, (*path, ["d", k]), file) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, stored, (*path, ["s", i]), file) for i, v in enumerate(like)]
        return type(like)(items) if isinstance(like, list) else tuple(items)
    key = json.dumps(list(path))
    if key not in stored:
        raise KeyError(f"Checkpoint {file} has no entry for path {key}")
    return _restore_like(stored[key], like)


def load_store(path: str | PathLike[str], like: Any | None = None) -> Any:
    """Load a tree saved by :func:`save_store` (or by the JAX package's).

    Without ``like``, leaves come back as numpy arrays and the structure is
    rebuilt from the stored key paths as plain dicts and lists. With ``like``
    (a tree of the desired structure), leaves are matched to its key paths:
    a tensor leaf of ``like`` comes back as a tensor of its dtype on its
    device, an array leaf as an array of its dtype."""
    with np.load(path, allow_pickle=False) as data:
        items = [(json.loads(k), data[k]) for k in data.files]

    if like is not None:
        stored = {json.dumps(p): v for p, v in items}
        return _rebuild(like, stored, (), str(path))

    def insert(container, path, value):
        kind, key = path[0]
        if kind == "s":
            key = int(key)
            while len(container) <= key:
                container.append(None)
        if len(path) == 1:
            container[key] = value
            return
        nxt = container[key] if isinstance(container, list) else container.get(key)
        if not isinstance(nxt, (dict, list)):
            nxt = [] if path[1][0] == "s" else {}
            container[key] = nxt
        insert(nxt, path[1:], value)

    if not items:
        return {}
    root: Any = [] if items[0][0] and items[0][0][0][0] == "s" else {}
    for path, value in items:
        if not path:
            return value
        insert(root, path, value)
    return root


def save_training_state(path: str | PathLike[str], tree: Any) -> None:
    """Atomically serialize a training-state tree to ``path`` (an ``.npz``
    file; the suffix is appended if missing): written to a temporary file
    first, then ``os.replace``d, so a run killed mid-write never corrupts the
    last good checkpoint. Used by ``fit``'s ``checkpoint_every``/``resume``."""
    file = training_state_path(path)
    tmp = file + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, file)


def training_state_path(path: str | PathLike[str]) -> str:
    """The canonical on-disk file for :func:`save_training_state`."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def load_training_state(path: str | PathLike[str], like: Any | None = None) -> Any | None:
    """Restore a :func:`save_training_state` checkpoint, or ``None`` when no
    file exists at (the canonicalized) ``path``; ``like`` as in
    :func:`load_store`."""
    file = training_state_path(path)
    if not os.path.exists(file):
        return None
    return load_store(file, like=like)


def data_fingerprint(data: np.ndarray) -> np.uint64:
    """A cheap identity check for trainer resume: shape/dtype plus a CRC of
    the first and last megabyte (the same value as the JAX package's).
    Exact-resume semantics require replaying the same batch schedule over
    the same data; this catches the honest mistakes (different file,
    different preprocessing, truncated array) without hashing multi-GB
    datasets."""
    data = np.ascontiguousarray(data)
    raw = data.view(np.uint8).reshape(-1)
    head = raw[: 1 << 20].tobytes()
    tail = raw[-(1 << 20):].tobytes()
    meta = f"{data.shape}{data.dtype}".encode()
    return np.uint64(zlib.crc32(tail, zlib.crc32(head, zlib.crc32(meta))))
