"""Warm-start bundles: a process that serves a circuit without compiling it.

The counterpart of ``cirkit_tpu/backend/jax/warmstart.py``. In the JAX
package a warm bundle persists AOT-compiled executables, because compiling
a program through the TPU's remote compile service took 2-7 s. PyTorch runs
eagerly and the port's only compiled artifact is the kernel library, which
``ops/_build.py`` already keeps in ``build/`` keyed on a hash of its sources,
so a second process pays no ``nvcc``. What a bundle saves here is the rest:
building the circuit (``ctx.compile``: the symbolic passes, folding and the
layer rewrites) before the first batch.

On the card this saves nothing: loading the exported program takes longer
than the cold compile it replaces (``PERF.md``), so the module is kept for
the JAX package's API, not for speed. A bundle holds

- the ``evaluate`` program (and optionally ``integrate`` and any
  ``extra_programs``) as ``torch.export`` artifacts of
  :func:`~.serving.export_circuit`: the bundle's only forward;
- the compiled circuit itself, pickled without its compiled initializers
  (closures; :attr:`WarmBundle.circuit`), which the bundle does not
  evaluate: its slots keep their symbolic initializers, which
  :meth:`WarmBundle.init` compiles again with the default initializer rules
  to redraw the cold store bit for bit, and a warm process builds its
  training step on it (``data_parallel_step``) and takes the cold step's
  results bit for bit, with no compile;
- an npz of the constant slots;
- a manifest with the sha256 of every file above, the torch and package
  versions and the device's name and capability. :func:`load_bundle` raises
  :class:`WarmStartError` on a missing bundle, any mismatch or a corrupt
  file; it never falls back.

Programs traced on CUDA embed the ``cirkit_tpu_torch::`` kernel ops; this
package registers them on import.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import types
from collections.abc import Callable, Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.parameters import Store, TorchTensorSlot
from cirkit_tpu_torch.backend.torch.serving import _saved, export_circuit, load_exported

_MANIFEST = "manifest.json"
_CONSTS = "consts.npz"
_CIRCUIT = "circuit.pkl"
_FINGERPRINT = ("torch", "cirkit_tpu_torch", "platform", "device_kind", "capability")


class WarmStartError(RuntimeError):
    """The bundle cannot serve this process (missing / incompatible)."""


def _device_fingerprint(device: torch.device) -> dict[str, str]:
    import cirkit_tpu_torch

    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        capability = ".".join(map(str, torch.cuda.get_device_capability(device)))
    else:
        kind, capability = device.type, ""
    return {
        "torch": torch.__version__,
        # programs bake in the package's semantics: a bundle built by another
        # version must not serve this one
        "cirkit_tpu_torch": getattr(cirkit_tpu_torch, "__version__", "0"),
        "platform": device.type,
        "device_kind": kind,
        "capability": capability,
    }


def _split_const_slots(circuit: TorchCircuit) -> tuple[list[str], list[str]]:
    const, random = [], []
    for s in sorted(circuit.slots):
        node = circuit.slots[s]
        if all(getattr(init, "constant", None) is not None for init in node.inits):
            const.append(s)
        else:
            random.append(s)
    return const, random


def _drop_closure(name: str) -> Callable:
    def dropped(*args, **kwargs):
        raise WarmStartError(
            f"the bundled circuit does not carry its initializer {name}: draw stores with "
            "WarmBundle.init"
        )

    return dropped


class _CircuitPickler(pickle.Pickler):
    """Pickles a compiled circuit with its initializer closures (functions
    local to the compile rules) replaced by stubs that raise."""

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType) and "<locals>" in obj.__qualname__:
            return _drop_closure, (obj.__qualname__,)
        return NotImplemented


def _pickle_circuit(circuit: TorchCircuit) -> bytes:
    bound, circuit.default_store = circuit.default_store, None
    try:
        buf = io.BytesIO()
        _CircuitPickler(buf).dump(circuit)
        return buf.getvalue()
    finally:
        circuit.default_store = bound


class _Call(nn.Module):
    """An extra program's function as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export_fn(fn: Callable, args: tuple) -> bytes:
    with torch.no_grad():
        return _saved(torch.export.export(_Call(fn), tuple(args)))


def save_bundle(
    path: str | os.PathLike,
    circuit: TorchCircuit,
    *,
    store: Store,
    batch: int,
    x_dtype: torch.dtype = torch.int64,
    with_integrate: bool = False,
    extra_programs: Mapping[str, tuple[Callable, tuple]] | None = None,
) -> dict:
    """Persist a warm-start bundle for ``circuit`` at ``path``.

    Contents: the ``evaluate`` forward at batch size ``batch`` (traced on the
    store's device), optionally the masked ``integrate`` program, any
    ``extra_programs`` (``name -> (fn, example_args)``, exported with
    ``torch.export``), an npz of the constant slots, the pickled circuit and
    a manifest. ``store`` supplies the slot
    shapes and types the programs are traced against (values are not
    saved). Returns the manifest."""
    path = Path(path)
    external = set(circuit.used_slots) - set(circuit.slots)
    if external:
        # operator-derived circuits (e.g. multiply(sc, sc)) evaluate through
        # pointer slots whose tensors belong to the SOURCE circuit: this
        # circuit cannot redraw them, so a bundle's init() would hand evaluate
        # an incomplete store. Fail at save time, not in the warm process.
        raise WarmStartError(
            "save_bundle cannot bundle an operator-derived circuit: slots "
            f"{sorted(external)} are owned by its source circuit(s). Bundle the source "
            "circuit (and apply the operator in the warm process), or export with "
            "export_circuit, which takes the store at call time."
        )
    restricted = circuit.restrict_store(store)
    device = next(iter(restricted.values())).device
    const_slots, random_slots = _split_const_slots(circuit)
    for s in random_slots:  # init() recompiles the folds' symbolic initializers
        if any(getattr(o, "initializer", None) is None for o in circuit.slots[s].origins):
            raise WarmStartError(f"slot {s!r} has a fold without a symbolic initializer")

    path.mkdir(parents=True, exist_ok=True)
    consts = io.BytesIO()
    np.savez(
        consts,
        **{s: circuit.slots[s].initialize(None, torch.device("cpu")).numpy() for s in const_slots},
    )
    files = {_CONSTS: consts.getvalue(), _CIRCUIT: _pickle_circuit(circuit)}

    x = torch.zeros((batch, circuit.num_variables), dtype=x_dtype, device=device)
    blobs = {"evaluate": export_circuit(circuit, x, store=restricted)}
    if with_integrate:
        blobs["integrate"] = export_circuit(circuit, x, store=restricted, query="integrate")
    for name, (fn, args) in (extra_programs or {}).items():
        blobs[name] = _export_fn(fn, args)
    files.update({f"{name}.pt2": blob for name, blob in blobs.items()})
    for name, blob in files.items():
        (path / name).write_bytes(blob)

    manifest = {
        **_device_fingerprint(device),
        "batch": batch,
        "num_variables": circuit.num_variables,
        "x_dtype": str(x_dtype).removeprefix("torch."),
        "programs": list(blobs),
        "sha256": {name: hashlib.sha256(blob).hexdigest() for name, blob in files.items()},
        "const_slots": const_slots,
        "random_slots": random_slots,
        "store_spec": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype).removeprefix("torch.")}
            for k, v in restricted.items()
        },
    }
    (path / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


class WarmBundle:
    """A loaded warm-start bundle: exported programs, no circuit compile.

    ``init(seed)`` draws the full parameter store on the bundle's device;
    ``evaluate`` / ``integrate`` / any extra programs are exposed under
    :attr:`programs` and as attributes; :attr:`circuit` is the compiled
    circuit the bundle was saved from."""

    def __init__(self, manifest: dict, programs: dict[str, Callable], consts: dict,
                 circuit: TorchCircuit, device: torch.device):
        self.manifest = manifest
        self.programs = programs
        self.circuit = circuit
        self.device = device
        self._consts = consts
        for name, fn in programs.items():
            if not hasattr(self, name):
                setattr(self, name, fn)

    def init(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """A freshly-initialized full store: the random slots drawn from
        ``torch.Generator(device).manual_seed(seed)`` in the order and with
        the initializers of a cold ``PipelineContext(seed=seed)`` compile
        (so equal to its store bit for bit on the same device), the constant
        slots from the bundle."""
        from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler

        compiler = TorchCompiler(device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        store: dict[str, torch.Tensor] = {}
        for s in self.manifest["random_slots"]:  # sorted, as the cold compile draws
            node = self.circuit.slots[s]
            inits = [compiler.compile_initializer(o) for o in node.origins]
            fresh = TorchTensorSlot(s, node.shape, dtype=node.dtype, learnable=node.learnable,
                                    inits=inits, origins=node.origins, num_folds=node.num_folds)
            store[s] = fresh.initialize(gen, self.device)
        store.update({k: torch.as_tensor(v, device=self.device) for k, v in self._consts.items()})
        return store


def load_bundle(path: str | os.PathLike) -> WarmBundle:
    """Load a :func:`save_bundle` artifact. Raises :class:`WarmStartError`
    if the bundle is absent, was built for another torch or package version
    or another device, or holds a corrupt program: rebuild cold and re-save."""
    path = Path(path)
    mpath = path / _MANIFEST
    if not mpath.is_file():
        raise WarmStartError(f"No warm-start bundle at {path}")
    manifest = json.loads(mpath.read_text())
    device = torch.device(manifest.get("platform", "cpu"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise WarmStartError("Warm-start bundle was built for CUDA; this process has no card")
    fp = _device_fingerprint(device)
    for field in _FINGERPRINT:
        if manifest.get(field) != fp[field]:
            raise WarmStartError(
                f"Warm-start bundle {field} mismatch: bundle was built for "
                f"{manifest.get(field)!r}, this process runs {fp[field]!r}; rebuild cold and "
                "re-save."
            )

    def read(name: str) -> bytes:
        blob = (path / name).read_bytes()
        if hashlib.sha256(blob).hexdigest() != manifest.get("sha256", {}).get(name):
            raise WarmStartError(
                f"Warm-start file {name!r} is corrupt (sha256 mismatch: truncated write or "
                "modified file); rebuild cold and re-save."
            )
        return blob

    programs: dict[str, Callable] = {}
    for name in manifest["programs"]:
        blob = read(f"{name}.pt2")
        try:
            programs[name] = load_exported(blob)
        except Exception as exc:  # torch rejected the artifact
            raise WarmStartError(f"Warm-start program {name!r} failed to load: {exc}") from exc
    with np.load(io.BytesIO(read(_CONSTS))) as z:
        consts = {k: z[k] for k in z.files}
    circuit = pickle.loads(read(_CIRCUIT))
    return WarmBundle(manifest, programs, consts, circuit, device)
