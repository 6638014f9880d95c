"""The compiled circuit: an ``nn.Module`` that runs a static evaluation plan.

The counterpart of ``cirkit_tpu/backend/jax/circuit.py``. The folded
circuit is lowered to a static list of plan entries (layer, input gather
indices) executed in order. The gather indices are int64 tensors built
once, on the circuit's device, when the circuit is compiled; they are
buffers of the module, so ``.to(device)`` moves them.

Parameters live in a *store*, a mapping from slot name to an ``(F, ...)``
tensor (the pipeline context keeps it as an ``nn.ParameterDict``), with the
same slot names as the JAX package's store.

A value of the plan is a tensor, or under the signed semiring a
``(log|f|, sign)`` pair of tensors: every gather, concatenation and
transpose maps over the pair (:func:`tmap`), and the outputs are pairs too.
Constant input layers (the integrals of a circuit's leaves) take the batch
size instead of a data slice.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from cirkit_tpu_torch.backend.torch.layers import (
    TorchConstantInputLayer,
    TorchInnerLayer,
    TorchInputLayer,
    TorchLayer,
    tmap,
)
from cirkit_tpu_torch.backend.torch.parameters import (
    Store,
    TorchPointerSlot,
    TorchTensorSlot,
)
from cirkit_tpu_torch.backend.torch.semiring import Semiring
from cirkit_tpu_torch.symbolic.circuit import StructuralProperties
from cirkit_tpu_torch.utils.scope import Scope

# For every layer: per fold, the ordered (producer layer index, fold within
# producer) pairs feeding each operand slot. Input layers have no entries.
FoldInputs = list[list[tuple[int, int]]]
# A per-layer evaluation override: (layer, store, layer input) -> output.
ModuleFn = Callable[[TorchLayer, Store, torch.Tensor], torch.Tensor]
# A plan value: a tensor, or the signed semiring's (log|f|, sign) pair.
Value = torch.Tensor | tuple[torch.Tensor, torch.Tensor]


@dataclass
class PlanEntry:
    """One step of the evaluation plan.

    Inner layers read the fold-concatenation of their producers' outputs
    (``in_ids``) through the (F, H) gather buffer ``gather`` (None for the
    identity unsqueeze). Input layers read the data columns through the
    (F, D) buffer ``gather``, or with a plain transpose when ``identity``
    (the layer takes variable f at fold f) and the data has F columns;
    constant input layers read the batch size."""

    layer: TorchLayer
    in_ids: list[int]
    gather: str | None
    identity: bool = False


def _build_gather(
    producers: FoldInputs, layer_folds: Mapping[int, int]
) -> tuple[list[int], np.ndarray | None]:
    """Compute (in_ids, fold_idx) for a layer's fold-input spec."""
    in_ids: list[int] = []
    offsets: dict[int, int] = {}
    total = 0
    for per_fold in producers:
        for mod, _ in per_fold:
            if mod not in offsets:
                offsets[mod] = total
                total += layer_folds[mod]
                in_ids.append(mod)
    fold_idx = np.array(
        [[offsets[mod] + k for mod, k in per_fold] for per_fold in producers], dtype=np.int64
    )
    f, h = fold_idx.shape
    if len(in_ids) == 1 and h == 1 and np.array_equal(fold_idx[:, 0], np.arange(f)):
        if layer_folds[in_ids[0]] == f:
            return in_ids, None
    return in_ids, fold_idx


def _pad_rows(pad: int | None, x, *masks):
    """Round the batch up to a multiple of ``pad`` by repeating row 0 (2-D
    masks with a matching batch alike); returns ``(x, *masks,
    original_b_or_None)``, and callers slice outputs back to ``b`` with
    :func:`_slice_rows`. Single-``Scope`` specs pass through (they broadcast
    from the padded ``x``); per-row Scope lists cannot pad and raise."""
    if pad is None:
        return (x, *masks, None)
    if pad <= 0:
        raise ValueError("pad_batch_to must be a positive integer")
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    b = x.shape[0]
    bp = -(-b // pad) * pad
    if bp == b:
        return (x, *masks, None)

    def ext(a):
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a[:1].expand(bp - b, *a.shape[1:])], dim=0)
        a = np.asarray(a)
        return np.concatenate([a, np.broadcast_to(a[:1], (bp - b, *a.shape[1:]))], axis=0)

    padded = []
    for m in masks:
        if isinstance(m, (torch.Tensor, np.ndarray)) and m.ndim >= 2 and m.shape[0] == b:
            padded.append(ext(m))
        elif isinstance(m, (list, tuple)) and len(m) == b and b > 1:
            raise ValueError(
                "pad_batch_to cannot pad a per-row list of Scopes; pass the "
                "evidence as a boolean array (or a single broadcast Scope)"
            )
        else:
            padded.append(m)
    return (ext(x), *padded, b)


def _slice_rows(out, b: int | None):
    """Undo :func:`_pad_rows` on a tensor or a tuple of tensors."""
    if b is None:
        return out
    if isinstance(out, tuple):
        return tuple(o[:b] for o in out)
    return out[:b]


def _iter_param_nodes(layer: TorchLayer):
    """Every parameter node of a layer and of its nested layers (the leaves
    an evidence layer wraps)."""
    for p in layer.params.values():
        yield from p.nodes
    for sub in layer.sub_modules.values():
        yield from _iter_param_nodes(sub)


class TorchCircuit(nn.Module):
    """A compiled circuit: layers + static plan.

    ``cc(x)`` evaluates against the bound default store (set by the
    pipeline context), ``cc(store, x)`` against any store; both return
    (B, O, K) outputs for (B, D) integer inputs.
    """

    def __init__(
        self,
        scope: Scope,
        num_variables: int,
        layers: Sequence[TorchLayer],
        fold_inputs: Mapping[int, FoldInputs],
        fold_outputs: FoldInputs,
        *,
        properties: StructuralProperties,
        semiring: Semiring,
        device: torch.device | str,
    ):
        super().__init__()
        self.scope = scope
        self.num_variables = num_variables
        self.layers = nn.ModuleList(layers)
        self.properties = properties
        self.semiring = semiring
        self.default_store: nn.ParameterDict | None = None
        # symbolic layer -> (plan entry, fold), set by the compiler when it
        # did not optimize (``TorchCompiler._compile_circuit``)
        self._symbolic_fold: dict | None = None

        # -- build the plan ----------------------------------------------------
        def buffer(name: str, idx: np.ndarray) -> str:
            self.register_buffer(name, torch.as_tensor(idx, device=device), persistent=False)
            return name

        layer_folds = {i: l.num_folds for i, l in enumerate(self.layers)}
        self._entries: list[PlanEntry] = []
        for i, layer in enumerate(self.layers):
            if isinstance(layer, TorchConstantInputLayer):
                self._entries.append(PlanEntry(layer, [], None))
                continue
            if isinstance(layer, TorchInputLayer):
                si = layer.scope_idx
                identity = si.shape[1] == 1 and np.array_equal(si[:, 0], np.arange(len(si)))
                self._entries.append(PlanEntry(layer, [], buffer(f"_scope_idx_{i}", si), identity))
                continue
            in_ids, fold_idx = _build_gather(fold_inputs[i], layer_folds)
            gather = None if fold_idx is None else buffer(f"_fold_idx_{i}", fold_idx)
            self._entries.append(PlanEntry(layer, in_ids, gather))
        # flatten the (module, fold) output pairs into a single gather
        out_ids, out_fold = _build_gather([[p] for p in fold_outputs], layer_folds)
        self._out_ids = out_ids
        self._out_gather = (
            None if out_fold is None else buffer("_out_fold_idx", out_fold[:, 0])
        )
        self.num_outputs = len(fold_outputs)

        # -- collect the parameter store specification -------------------------
        self._slots: dict[str, TorchTensorSlot] = {}
        used: set[str] = set()
        ptr_learnable: set[str] = set()
        for layer in self.layers:
            for node in _iter_param_nodes(layer):
                if isinstance(node, TorchTensorSlot):
                    self._slots.setdefault(node.slot, node)
                    used.add(node.slot)
                elif isinstance(node, TorchPointerSlot):
                    used.add(node.slot)
                    if node.learnable:
                        ptr_learnable.add(node.slot)
        self._used_slots: tuple[str, ...] = tuple(sorted(used))
        # learnable slots this circuit only POINTS at (parameter sharing with
        # operand circuits): fit() on a derived circuit trains them
        self._shared_learnable: frozenset[str] = frozenset(ptr_learnable - set(self._slots))

    # -- parameter store -------------------------------------------------------
    @property
    def slots(self) -> Mapping[str, TorchTensorSlot]:
        """The parameter-store slot specification of this circuit."""
        return self._slots

    @property
    def learnable_slots(self) -> frozenset[str]:
        return (
            frozenset(s for s, n in self._slots.items() if n.learnable)
            | self._shared_learnable
        )

    @property
    def shared_learnable_slots(self) -> frozenset[str]:
        """Learnable slots this circuit only POINTS at: parameters shared
        with operand circuits. ``fit(..., freeze="shared")`` keeps exactly
        these fixed."""
        return self._shared_learnable

    @property
    def used_slots(self) -> tuple[str, ...]:
        """Every store slot this circuit reads (own tensors + shared pointers)."""
        return self._used_slots

    def restrict_store(self, store: Store) -> dict[str, torch.Tensor]:
        """Project a (possibly larger shared) store onto the used slots."""
        return {s: store[s] for s in self._used_slots}

    def initialize(
        self,
        generator: torch.Generator | None,
        device: torch.device | str,
        slots: Sequence[str] | None = None,
    ) -> dict[str, torch.Tensor]:
        """Freshly-initialized values of ``slots`` (default: all of this
        circuit's slots), drawn from ``generator`` on ``device``."""
        names = sorted(self._slots) if slots is None else sorted(slots)
        return {s: self._slots[s].initialize(generator, torch.device(device)) for s in names}

    def num_parameters(self, store: Store | None = None, *, learnable_only: bool = False) -> int:
        """The number of scalars in this circuit's own slots (``store`` is
        accepted for the JAX package's signature and not read)."""
        return sum(
            node.num_folds * int(np.prod(node.shape))
            for node in self._slots.values()
            if node.learnable or not learnable_only
        )

    # -- evaluation --------------------------------------------------------------
    def evaluate(
        self,
        store: Store,
        x: torch.Tensor | None = None,
        *,
        batch_size: int | None = None,
        module_fn: ModuleFn | None = None,
        plain: bool = False,
    ) -> Value:
        """Run the plan: (B, D) inputs -> (B, O, K) outputs (a pair of them
        under the signed semiring). ``module_fn(layer, store, xin)``
        overrides per-layer evaluation (the hook of the queries). A circuit
        with no variables (an integral) takes ``batch_size`` in place of
        ``x``; see :meth:`evaluate_raw`.

        ``plain=True`` contracts every sum-style layer through the semiring
        ops' plain compositions instead of the kernels, on any device: they
        are differentiable to any order, which the kernels are not (the
        covariance rows of ``ExpectationQuery`` take a Hessian-vector product
        this way). With ``module_fn`` the flag is passed on to it as
        ``module_fn(layer, store, xin, plain=True)``, and it evaluates its
        layers with :meth:`call_layer`."""
        out = self.evaluate_raw(store, x, batch_size=batch_size, module_fn=module_fn,
                                plain=plain)
        return tmap(lambda o: o.transpose(0, 1), out)

    @staticmethod
    def call_layer(layer: TorchLayer, store: Store, xin, *, plain: bool = False) -> Value:
        """A layer's own evaluation; with ``plain`` an inner layer contracts
        through the plain compositions (see :meth:`evaluate`)."""
        if plain and isinstance(layer, TorchInnerLayer):
            return layer(store, xin, plain=True)
        return layer(store, xin)

    def entry_input(self, entry: PlanEntry, x: torch.Tensor | None, outs: Sequence[Value],
                    batch_size: int | None = None):
        """What the plan hands ``entry``'s layer: the batch size for a
        constant input layer (``x``'s, else ``batch_size``), the (F, B, D)
        data slice of an input layer (None without ``x``), or the (F, H, B,
        K) gather of an inner layer's producers from the outputs ``outs`` of
        the entries before it."""
        if isinstance(entry.layer, TorchConstantInputLayer):
            return batch_size if x is None else x.shape[0]
        if isinstance(entry.layer, TorchInputLayer):
            if x is None:
                return None
            # (B, D_total) -> (F, B, D) via the static scope gather; a
            # plain transpose when the layer takes every column in order
            if entry.identity and x.shape[1] == entry.layer.num_folds:
                return x.t()[:, :, None]
            return x[:, getattr(self, entry.gather)].permute(1, 0, 2)
        cat = self._concat([outs[i] for i in entry.in_ids])
        if entry.gather is None:
            return tmap(lambda c: c[:, None], cat)
        idx = getattr(self, entry.gather)
        return tmap(lambda c: c[idx], cat)

    @staticmethod
    def _concat(ins: Sequence[Value]) -> Value:
        return ins[0] if len(ins) == 1 else tmap(lambda *a: torch.cat(a, dim=0), *ins)

    def output_stack(self, outs: Sequence[Value]) -> Value:
        """The (O, B, K) output stack from the entries' outputs."""
        cat = self._concat([outs[i] for i in self._out_ids])
        if self._out_gather is None:
            return cat
        idx = getattr(self, self._out_gather)
        return tmap(lambda c: c[idx], cat)

    def evaluate_raw(
        self,
        store: Store,
        x: torch.Tensor | None = None,
        *,
        batch_size: int | None = None,
        module_fn: ModuleFn | None = None,
        plain: bool = False,
    ) -> Value:
        """Run the plan returning the raw output stack (O, B, K). The batch
        size is ``x``'s if ``x`` is given, else ``batch_size``; with neither,
        ``module_fn`` is required, and input layers receive None and constant
        ones a batch size of None (the dense sampler's upward pass, which
        needs no data batch)."""
        if x is None and batch_size is None and module_fn is None:
            raise ValueError("Either an input batch or a batch size is required")
        outs: list[Value] = []
        for entry in self._entries:
            xin = self.entry_input(entry, x, outs, batch_size)
            layer = entry.layer
            if module_fn is None:
                outs.append(self.call_layer(layer, store, xin, plain=plain))
            elif plain:
                outs.append(module_fn(layer, store, xin, plain=True))
            else:
                outs.append(module_fn(layer, store, xin))
        return self.output_stack(outs)

    def forward(self, *args, batch_size: int | None = None) -> Value:
        """``cc(store, x)``, or ``cc(x)`` using the pipeline context's store;
        a circuit with no variables takes ``batch_size`` in place of ``x``:
        ``cc(batch_size=1)`` or ``cc(store, batch_size=1)``."""
        if args and isinstance(args[0], (Mapping, nn.ParameterDict)):
            store, *rest = args
        else:
            store, rest = self.default_store, list(args)
            if store is None:
                raise ValueError(
                    "No parameter store bound: call as cc(store, x) or compile "
                    "through a PipelineContext"
                )
        x = rest[0] if rest else None
        return self.evaluate(store, x, batch_size=batch_size)

    def extra_repr(self) -> str:
        return f"num_variables={self.num_variables}, semiring={self.semiring.__name__}"
