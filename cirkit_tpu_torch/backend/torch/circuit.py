"""The compiled circuit: an ``nn.Module`` that runs a static evaluation plan.

The counterpart of ``cirkit_tpu/backend/jax/circuit.py``. The folded
circuit is lowered to a static list of plan entries (layer, input gather
indices) executed in order. The gather indices are int64 tensors built
once, on the circuit's device, when the circuit is compiled; they are
buffers of the module, so ``.to(device)`` moves them.

Parameters live in a *store*, a mapping from slot name to an ``(F, ...)``
tensor (the pipeline context keeps it as an ``nn.ParameterDict``), with the
same slot names as the JAX package's store.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from cirkit_tpu_torch.backend.torch.layers import TorchInputLayer, TorchLayer
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


@dataclass
class PlanEntry:
    """One step of the evaluation plan.

    Inner layers read the fold-concatenation of their producers' outputs
    (``in_ids``) through the (F, H) gather buffer ``gather`` (None for the
    identity unsqueeze). Input layers read the data columns through the
    (F, D) buffer ``gather`` (None when the layer takes every variable in
    order, a plain transpose)."""

    layer: TorchLayer
    in_ids: list[int]
    gather: str | None


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
        device: torch.device | str = "cpu",
    ):
        super().__init__()
        self.scope = scope
        self.num_variables = num_variables
        self.layers = nn.ModuleList(layers)
        self.properties = properties
        self.semiring = semiring
        self.default_store: nn.ParameterDict | None = None

        # -- build the plan ----------------------------------------------------
        def buffer(name: str, idx: np.ndarray) -> str:
            self.register_buffer(name, torch.as_tensor(idx, device=device), persistent=False)
            return name

        layer_folds = {i: l.num_folds for i, l in enumerate(self.layers)}
        self._entries: list[PlanEntry] = []
        for i, layer in enumerate(self.layers):
            if isinstance(layer, TorchInputLayer):
                si = layer.scope_idx
                identity = si.shape[1] == 1 and np.array_equal(
                    si[:, 0], np.arange(num_variables)
                )
                gather = None if identity else buffer(f"_scope_idx_{i}", si)
                self._entries.append(PlanEntry(layer, [], gather))
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
            for p in layer.params.values():
                for node in p.nodes:
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

    def num_parameters(self) -> int:
        return sum(node.num_folds * int(np.prod(node.shape)) for node in self._slots.values())

    # -- evaluation --------------------------------------------------------------
    def evaluate(self, store: Store, x: torch.Tensor) -> torch.Tensor:
        """Run the plan: (B, D) inputs -> (B, O, K) outputs."""
        return self.evaluate_raw(store, x).transpose(0, 1)

    def evaluate_raw(self, store: Store, x: torch.Tensor) -> torch.Tensor:
        """Run the plan returning the raw output stack (O, B, K)."""
        outs: list[torch.Tensor] = []
        for entry in self._entries:
            if isinstance(entry.layer, TorchInputLayer):
                # (B, D_total) -> (F, B, D) via the static scope gather
                if entry.gather is None:
                    xin = x.t()[:, :, None]
                else:
                    xin = x[:, getattr(self, entry.gather)].permute(1, 0, 2)
            else:
                ins = [outs[i] for i in entry.in_ids]
                cat = ins[0] if len(ins) == 1 else torch.cat(ins, dim=0)
                # (F, H, B, K)
                xin = cat[:, None] if entry.gather is None else cat[getattr(self, entry.gather)]
            outs.append(entry.layer(store, xin))
        ins = [outs[i] for i in self._out_ids]
        cat = ins[0] if len(ins) == 1 else torch.cat(ins, dim=0)
        return cat if self._out_gather is None else cat[getattr(self, self._out_gather)]

    def forward(self, *args) -> torch.Tensor:
        """``cc(store, x)``, or ``cc(x)`` using the pipeline context's store."""
        if len(args) == 2:
            store, x = args
        else:
            (x,) = args
            store = self.default_store
            if store is None:
                raise ValueError(
                    "No parameter store bound: call as cc(store, x) or compile "
                    "through a PipelineContext"
                )
        return self.evaluate(store, x)

    def extra_repr(self) -> str:
        return f"num_variables={self.num_variables}, semiring={self.semiring.__name__}"
