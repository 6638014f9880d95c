"""The symbolic circuit IR.

Rebuild of ``cirkit/symbolic/circuit.py:20-576``: a DAG of symbolic layers
with per-layer scopes computed bottom-up, structural property checks
(smoothness, decomposability, compatibility), circuit blocks as the unit of
operator outputs, and operator provenance for pipeline recompilation.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from collections.abc import Iterator, Mapping, Sequence
from dataclasses import dataclass, field
from enum import IntEnum, auto
from functools import cached_property
from typing import Any

from cirkit_tpu_torch.symbolic.layers import InputLayer, Layer, ProductLayer, SumLayer
from cirkit_tpu_torch.utils.algorithms import (
    DiAcyclicGraph,
    RootedDiAcyclicGraph,
    bfs,
    subgraph,
    topological_ordering,
)
from cirkit_tpu_torch.utils.scope import Scope


class StructuralPropertyError(Exception):
    """Raised when a circuit operator's structural requirements are unmet."""


@dataclass(frozen=True)
class StructuralProperties:
    """The structural properties of a circuit."""

    smooth: bool
    decomposable: bool
    structured_decomposable: bool
    omni_compatible: bool


class CircuitOperator(IntEnum):
    """The symbolic operators defined over circuits."""

    CONCATENATE = auto()
    EVIDENCE = auto()
    INTEGRATION = auto()
    DIFFERENTIATION = auto()
    MULTIPLICATION = auto()
    CONJUGATION = auto()
    MIXTURE = auto()


@dataclass(frozen=True)
class CircuitOperation:
    """Provenance record: which operator produced a circuit, from which operands."""

    operator: CircuitOperator
    operands: tuple["Circuit", ...]
    metadata: dict[str, Any] = field(default_factory=dict)


class CircuitBlock(RootedDiAcyclicGraph[Layer]):
    """A rooted fragment of a circuit, the unit of operator rule outputs."""

    def __init__(
        self, layers: Sequence[Layer], in_layers: Mapping[Layer, list[Layer]], output: Layer
    ):
        super().__init__(layers, in_layers, [output])

    def layer_inputs(self, sl: Layer) -> Sequence[Layer]:
        return self.node_inputs(sl)

    def layer_outputs(self, sl: Layer) -> Sequence[Layer]:
        return self.node_outputs(sl)

    @property
    def layers_inputs(self) -> Mapping[Layer, Sequence[Layer]]:
        return self.nodes_inputs

    @property
    def layers_outputs(self) -> Mapping[Layer, Sequence[Layer]]:
        return self.nodes_outputs

    @property
    def layers(self) -> Sequence[Layer]:
        return self.nodes

    @property
    def inner_layers(self) -> Iterator[SumLayer | ProductLayer]:
        return (sl for sl in self.layers if isinstance(sl, (SumLayer, ProductLayer)))

    @property
    def sum_layers(self) -> Iterator[SumLayer]:
        return (sl for sl in self.layers if isinstance(sl, SumLayer))

    @property
    def product_layers(self) -> Iterator[ProductLayer]:
        return (sl for sl in self.layers if isinstance(sl, ProductLayer))

    @staticmethod
    def from_layer(sl: Layer) -> "CircuitBlock":
        return CircuitBlock([sl], {}, sl)

    @staticmethod
    def from_layer_composition(*layers: Layer) -> "CircuitBlock":
        if len(layers) <= 1:
            raise ValueError("Expected a composition of at least 2 layers")
        in_layers: dict[Layer, list[Layer]] = {
            sl: [layers[i - 1]] if i else [] for i, sl in enumerate(layers)
        }
        return CircuitBlock(list(layers), in_layers, layers[-1])

    @staticmethod
    def from_nary_layer(lout: Layer, *ls: InputLayer) -> "CircuitBlock":
        return CircuitBlock([lout, *ls], {lout: list(ls)}, lout)


class Circuit(DiAcyclicGraph[Layer]):
    """The symbolic circuit: a DAG of layers with designated outputs."""

    def __init__(
        self,
        layers: Sequence[Layer],
        in_layers: Mapping[Layer, Sequence[Layer]],
        outputs: Sequence[Layer],
        *,
        operation: CircuitOperation | None = None,
    ) -> None:
        super().__init__(layers, in_layers, outputs)
        self.operation = operation

        # Compute scopes bottom-up, validating arity and unit counts
        # (ref: cirkit/symbolic/circuit.py:245-269).
        self._scopes: dict[Layer, Scope] = {}
        for sl in self.topological_ordering():
            sl_ins = self.layer_inputs(sl)
            if isinstance(sl, InputLayer):
                if sl_ins:
                    raise ValueError(f"{sl}: input layers cannot have layer inputs")
                self._scopes[sl] = sl.scope
                continue
            self._scopes[sl] = Scope.union(*(self._scopes[sli] for sli in sl_ins))
            if sl.arity != len(sl_ins):
                raise ValueError(
                    f"{sl}: expected arity {sl.arity}, found {len(sl_ins)} input layers"
                )
            for sli in sl_ins:
                if sli.num_output_units != sl.num_input_units:
                    raise ValueError(
                        f"{sl}: expected {sl.num_input_units} input units, "
                        f"but an input layer has {sli.num_output_units} output units"
                    )
        self.scope = Scope.union(*(self._scopes[sl] for sl in self.outputs))

    @property
    def num_variables(self) -> int:
        return len(self.scope)

    @property
    def num_parameters(self) -> int:
        """Total learnable scalar parameters, counted once per shared tensor.

        Walks every layer's parameter graphs and sums ``prod(shape)`` over
        the distinct learnable :class:`TensorParameter` leaves (``ref()``
        sharing and pointer reuse dedupe by object identity;
        :class:`ReferenceParameter` pointers — operator-derived circuits —
        count their dereferenced target once). This is the
        ``k`` used by BIC/AIC model selection in
        :func:`cirkit_tpu.backend.jax.pruning.grow_prune_loop`; it counts
        raw tensor entries, not normalization-constrained degrees of
        freedom (a softmax row of width ``n`` counts ``n``, not ``n - 1``)
        — consistent across candidates, which is all a selection criterion
        needs."""
        import math

        from cirkit_tpu_torch.symbolic.parameters import ReferenceParameter, TensorParameter

        seen: set[int] = set()
        total = 0
        for sl in self.layers:
            for p in sl.params.values():
                for node in p.nodes:
                    if isinstance(node, ReferenceParameter):
                        node = node.deref()
                    if (
                        isinstance(node, TensorParameter)
                        and node.learnable
                        and id(node) not in seen
                    ):
                        seen.add(id(node))
                        total += math.prod(node.shape)
        return total

    def layer_scope(self, sl: Layer) -> Scope:
        return self._scopes[sl]

    def layer_inputs(self, sl: Layer) -> Sequence[Layer]:
        return self.node_inputs(sl)

    def layer_outputs(self, sl: Layer) -> Sequence[Layer]:
        return self.node_outputs(sl)

    @property
    def layers_inputs(self) -> Mapping[Layer, Sequence[Layer]]:
        return self.nodes_inputs

    @property
    def layers_outputs(self) -> Mapping[Layer, Sequence[Layer]]:
        return self.nodes_outputs

    @property
    def layers(self) -> Sequence[Layer]:
        return self.nodes

    @property
    def input_layers(self) -> Iterator[InputLayer]:
        return (sl for sl in self.layers if isinstance(sl, InputLayer))

    @property
    def inner_layers(self) -> Iterator[SumLayer | ProductLayer]:
        return (sl for sl in self.layers if isinstance(sl, (SumLayer, ProductLayer)))

    @property
    def sum_layers(self) -> Iterator[SumLayer]:
        return (sl for sl in self.layers if isinstance(sl, SumLayer))

    @property
    def product_layers(self) -> Iterator[ProductLayer]:
        return (sl for sl in self.layers if isinstance(sl, ProductLayer))

    def subgraph(self, *outputs: Layer) -> "Circuit":
        layers, in_layers = subgraph(outputs, self.layer_inputs)
        return Circuit(layers, in_layers, outputs=list(outputs))

    # -- structural properties ----------------------------------------------

    @cached_property
    def is_smooth(self) -> bool:
        """All sum layers' inputs share the sum layer's scope."""
        return all(
            self.layer_scope(sl) == self.layer_scope(sli)
            for sl in self.sum_layers
            for sli in self.layer_inputs(sl)
        )

    @cached_property
    def is_decomposable(self) -> bool:
        """All product layers partition their scope into disjoint input scopes."""
        for sl in self.product_layers:
            for a, b in itertools.combinations(self.layer_inputs(sl), 2):
                if self.layer_scope(a) & self.layer_scope(b):
                    return False
        return True

    @cached_property
    def is_structured_decomposable(self) -> bool:
        """Smooth, decomposable, and each scope factorized one way only."""
        if not (self.is_smooth and self.is_decomposable):
            return False
        return all(len(fs) == 1 for fs in _scope_factorizations(self).values())

    @cached_property
    def is_omni_compatible(self) -> bool:
        """Compatible with a fully-factorized circuit over the same scope."""
        if not (self.is_smooth and self.is_decomposable):
            return False
        vs = Scope(range(self.num_variables))
        return _are_compatible(
            _scope_factorizations(self), {vs: {tuple(Scope([v]) for v in vs)}}
        )

    @cached_property
    def properties(self) -> StructuralProperties:
        return StructuralProperties(
            self.is_smooth,
            self.is_decomposable,
            self.is_structured_decomposable,
            self.is_omni_compatible,
        )

    @classmethod
    def from_operation(
        cls,
        blocks: Sequence[CircuitBlock],
        in_blocks: Mapping[CircuitBlock, Sequence[CircuitBlock]],
        output_blocks: Sequence[CircuitBlock],
        *,
        operation: CircuitOperation,
    ) -> "Circuit":
        """Splice circuit blocks into a flat circuit, wiring block inputs to
        each block's unique entry layer (ref: ``symbolic/circuit.py:461-503``)."""
        layers = [sl for b in blocks for sl in b.layers]
        in_layers: dict[Layer, list[Layer]] = defaultdict(list)
        for b in blocks:
            entry_layers = list(b.inputs)
            feeds = in_blocks.get(b, [])
            if len(entry_layers) == 1:
                in_layers[entry_layers[0]].extend(bi.output for bi in feeds)
            elif feeds:
                raise ValueError(
                    "A circuit block with multiple entry layers cannot take block inputs"
                )
            for sl in b.layers:
                in_layers[sl].extend(b.layer_inputs(sl))
        outputs = [b.output for b in output_blocks]
        return cls(layers, in_layers, outputs, operation=operation)


def are_compatible(sc1: Circuit, sc2: Circuit) -> bool:
    """Whether two circuits factorize scopes identically (commutative)."""
    if not (sc1.is_smooth and sc1.is_decomposable):
        return False
    if not (sc2.is_smooth and sc2.is_decomposable):
        return False
    return _are_compatible(_scope_factorizations(sc1), _scope_factorizations(sc2))


def pipeline_topological_ordering(roots: Sequence[Circuit]) -> Iterator[Circuit]:
    """Topological ordering over the operator provenance DAG of circuits."""

    def _operands(sc: Circuit) -> tuple[Circuit, ...]:
        return () if sc.operation is None else sc.operation.operands

    return topological_ordering(bfs(roots, incomings_fn=_operands), incomings_fn=_operands)


_ScopeFactorizations = dict[Scope, set[tuple[Scope, ...]]]


def _scope_factorizations(sc: Circuit) -> _ScopeFactorizations:
    """Collect, per product-layer scope, the ways it gets factorized."""
    sfs: _ScopeFactorizations = defaultdict(set)
    for sl in sc.product_layers:
        parts = tuple(
            s
            for s in sorted(
                (sc.layer_scope(sli) for sli in sc.layer_inputs(sl)), key=tuple
            )
            if s
        )
        if len(parts) > 1:
            sfs[sc.layer_scope(sl)].add(parts)
    return sfs


def _are_compatible(sfs1: _ScopeFactorizations, sfs2: _ScopeFactorizations) -> bool:
    """Check that the common scopes factorize the same unique way."""
    for scope, fs1 in sfs1.items():
        fs2 = sfs2.get(scope)
        if fs2 is None:
            return False
        if len(fs1) != 1 or len(fs2) != 1:
            return False
        if next(iter(fs1)) != next(iter(fs2)):
            return False
    return True
