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

:func:`save_checkpoint` / :func:`load_checkpoint` write and read a tree of
tensors as a directory with ``torch.distributed.checkpoint`` (DCP), in place
of the JAX package's orbax directories: a ``DTensor`` leaf (a ZeRO-1 slice or
a tensor-parallel shard, wrapped by ``DTensor.from_local``) is written by
each rank for its own part, a plain tensor once; ``load_checkpoint(path,
like)`` reads into ``like``'s structure and placement, so a checkpoint
written by 2 ranks loads on 1 or on 4. Both run in one process with no
process group too. :func:`place_replicated` puts a restored tree on the
mesh's device, replicated.

:func:`save_circuit` / :func:`load_circuit` persist a symbolic circuit in the
JAX package's format, a versioned pickle. The port's symbolic classes are
copies of the JAX package's under the ``cirkit_tpu_torch.`` prefix, so the
loader reads a file written by either package: it maps the classes a JAX
file names (``cirkit_tpu.symbolic.*``, ``cirkit_tpu.utils.scope``) onto the
port's, and never imports ``cirkit_tpu`` or JAX.
"""

from __future__ import annotations

import json
import os
import pickle
import zlib
from collections.abc import Mapping
from os import PathLike
from typing import Any

import numpy as np
import torch

from cirkit_tpu_torch.backend.torch.utils import to_complex_dtype


def store_from_numpy(
    arrays: Mapping[str, np.ndarray],
    *,
    device: torch.device | str,
    dtype: torch.dtype | None = None,
    slots: Mapping | None = None,
) -> dict[str, torch.Tensor]:
    """Tensors on ``device`` copied from a mapping of slot name to array.

    ``dtype`` casts every array (default: keep each array's dtype); a complex
    array takes the complex type of ``dtype``'s precision, never losing its
    imaginary part. With
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
    def target(a: np.ndarray) -> torch.dtype | None:
        if dtype is not None and np.iscomplexobj(a):
            return to_complex_dtype(dtype)
        return dtype

    return {
        name: torch.tensor(np.asarray(a), device=device, dtype=target(np.asarray(a)))
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


def _rebuild(like: Any, path: tuple, leaf_fn) -> Any:
    """``like``'s structure with each leaf replaced by ``leaf_fn(key path,
    leaf)``."""
    if isinstance(like, Mapping):
        return {k: _rebuild(v, (*path, ["d", k]), leaf_fn) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, (*path, ["s", i]), leaf_fn) for i, v in enumerate(like)]
        return items if isinstance(like, list) else tuple(items)
    return leaf_fn(path, like)


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

        def leaf(p: tuple, v: Any) -> Any:
            key = json.dumps(list(p))
            if key not in stored:
                raise KeyError(f"Checkpoint {path} has no entry for path {key}")
            return _restore_like(stored[key], v)

        return _rebuild(like, (), leaf)
    return _unflatten(items)


def _unflatten(items: list[tuple[list, Any]]) -> Any:
    """The tree of (key path, leaf) pairs, as plain dicts and lists."""
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


def place_replicated(tree: Any, mesh: Any | None = None) -> Any:
    """Every array or tensor leaf of ``tree`` as a tensor: on the mesh's
    device when a ``mesh`` is given (each rank holds the whole leaf, the
    placement trainer checkpoints restore with), else as it is or on the
    CPU. Every rank reads the same file, so the leaves are already equal."""
    from cirkit_tpu_torch.parallel.mesh import mesh_device, tree_map

    dev = None if mesh is None else mesh_device(mesh)

    def place(leaf: Any) -> Any:
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        return t if dev is None else t.to(dev)

    return tree_map(place, tree)


def _dcp_state(tree: Any) -> dict[str, Any]:
    """The flat DCP state dict of a tree: the leaves by their JSON key path
    (the npz files' encoding), arrays and numbers as tensors."""
    def leaf(v: Any) -> Any:
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))

    return {json.dumps(path): leaf(v) for path, v in _leaves(tree)}


def save_checkpoint(path: str | PathLike[str], tree: Any) -> None:
    """Save a tree of tensors (nested dicts, lists and tuples; arrays and
    numbers become tensors) as a ``torch.distributed.checkpoint`` directory.
    With a process group every rank calls it: a ``DTensor`` leaf is written
    in parts, each rank its own; a plain tensor, which every rank holds
    whole, is written once."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_dcp_state(tree), checkpoint_id=os.fspath(path))


def load_checkpoint(path: str | PathLike[str], like: Any | None = None) -> Any:
    """Restore a :func:`save_checkpoint` directory.

    With ``like`` (a tree of tensors, ``DTensor``s, arrays or numbers, as
    saved) the leaves are read into fresh tensors of ``like``'s shapes,
    types, devices and placements, and returned in its structure: a
    ``DTensor`` leaf receives its local part of the saved leaf, whatever
    the number of ranks that wrote it; an array or number leaf comes back as
    an array or number of its type. Without ``like`` every leaf comes back
    whole as a CPU tensor, the structure rebuilt from the key paths as plain
    dicts and lists (one process, no process group)."""
    import torch.distributed.checkpoint as dcp

    path = os.fspath(path)
    if like is None:
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        state = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in meta.items()}
        dcp.load(state, checkpoint_id=path)
        return _unflatten([(json.loads(k), v) for k, v in state.items()])

    def fresh(v: Any) -> Any:
        if isinstance(v, torch.Tensor):
            from torch.distributed.tensor import DTensor

            if isinstance(v, DTensor):
                return DTensor.from_local(torch.empty_like(v.to_local()), v.device_mesh,
                                          v.placements, run_check=False)
            return torch.empty_like(v)
        return torch.as_tensor(np.asarray(v)).clone()

    template = {json.dumps(p): fresh(v) for p, v in _leaves(like)}
    dcp.load(template, checkpoint_id=path)

    def back(v: Any, loaded: torch.Tensor) -> Any:
        if isinstance(v, torch.Tensor):
            return loaded
        arr = loaded.numpy()
        return arr.astype(np.asarray(v).dtype) if np.ndim(v) else np.asarray(v).dtype.type(arr)

    return _rebuild(like, (), lambda p, v: back(v, template[json.dumps(list(p))]))


_CIRCUIT_FORMAT = "cirkit-tpu-circuit"


def save_circuit(path: str | PathLike[str], sc: Any) -> None:
    """Persist a symbolic circuit's structure and (constant) parameters: a
    versioned pickle of the layer graph, the format of the JAX package's
    ``save_circuit``. For circuits no template rebuilds (pruned, grown,
    distilled or hand-built ones); a template's trained parameters live in
    the store, persisted beside it with :func:`save_store`. Slot names are
    allocated in a fixed order per compile, so a reloaded circuit compiled
    first in a fresh context takes the saved store's slots.

    The usual pickle caveat holds: only load circuit files you trust."""
    with open(path, "wb") as f:
        pickle.dump({"format": _CIRCUIT_FORMAT, "version": 1, "circuit": sc}, f)


class _PortUnpickler(pickle.Unpickler):
    """Reads the JAX package's classes as the port's copies of them."""

    def find_class(self, module: str, name: str) -> Any:
        if module == "cirkit_tpu" or module.startswith("cirkit_tpu."):
            module = "cirkit_tpu_torch" + module[len("cirkit_tpu"):]
        return super().find_class(module, name)


def load_circuit(path: str | PathLike[str]) -> Any:
    """Load a symbolic circuit saved by :func:`save_circuit`, or by the JAX
    package's, as the port's symbolic classes."""
    try:
        with open(path, "rb") as f:
            blob = _PortUnpickler(f).load()
    except pickle.UnpicklingError as exc:
        raise ValueError(f"{path} is not a cirkit-tpu circuit file") from exc
    if not (isinstance(blob, dict) and blob.get("format") == _CIRCUIT_FORMAT):
        raise ValueError(f"{path} is not a cirkit-tpu circuit file")
    return blob["circuit"]
