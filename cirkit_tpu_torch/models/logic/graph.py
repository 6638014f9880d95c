"""Logic circuits: boolean circuit DAGs lowered to symbolic circuits.

Rebuild of ``cirkit/templates/logic/graph.py:17-317``: a rooted DAG of
boolean gates (literals, negated literals, conjunctions, disjunctions plus
the Top/Bottom constants) with unit-propagation pruning, smoothing (every
disjunct covers the full disjunction scope, enabling tractable
marginalization) and lowering to a symbolic circuit whose default
parameterization makes evaluation compute the boolean function and
integration compute the (weighted) model count.
"""

from __future__ import annotations

import itertools
from abc import ABC
from collections.abc import Sequence

import numpy as np

from cirkit_tpu_torch.models.utils import InputLayerFactory
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.initializers import ConstantTensorInitializer
from cirkit_tpu_torch.symbolic.layers import CategoricalLayer, HadamardLayer, InputLayer, Layer, SumLayer
from cirkit_tpu_torch.symbolic.parameters import Parameter, ParameterFactory, TensorParameter
from cirkit_tpu_torch.utils.algorithms import RootedDiAcyclicGraph
from cirkit_tpu_torch.utils.scope import Scope


class LogicalCircuitNode(ABC):
    """A node of a boolean circuit DAG."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}@0x{id(self):x}"


class TopNode(LogicalCircuitNode):
    """The constant True."""


class BottomNode(LogicalCircuitNode):
    """The constant False."""


class LogicalInputNode(LogicalCircuitNode):
    """A (possibly negated) literal over a 0-indexed boolean variable."""

    def __init__(self, literal: int) -> None:
        self.literal = literal

    def __repr__(self) -> str:
        return f"{type(self).__name__}@0x{id(self):x}({self.literal})"


class LiteralNode(LogicalInputNode):
    """A positive literal: x_i."""


class NegatedLiteralNode(LogicalInputNode):
    """A negated literal: not x_i."""


class ConjunctionNode(LogicalCircuitNode):
    """An AND gate."""


class DisjunctionNode(LogicalCircuitNode):
    """An OR gate."""


def _default_literal_factory(negated: bool) -> InputLayerFactory:
    """Literal input: a Categorical over {False, True} constantly
    parameterized with [0, 1] (literal) or [1, 0] (negated literal), so the
    layer acts as an indicator (ref: ``templates/logic/utils.py:10-33``)."""

    def factory(scope: Scope, num_units: int) -> InputLayer:
        probs = np.array([1.0, 0.0]) if negated else np.array([0.0, 1.0])
        return CategoricalLayer(
            scope,
            num_units,
            num_categories=2,
            probs=Parameter.from_input(
                TensorParameter(
                    1, 2, initializer=ConstantTensorInitializer(probs), learnable=False
                )
            ),
        )

    return factory


def _unit_weight_factory(shape: tuple[int, ...]) -> Parameter:
    """Non-trainable all-ones sum weights: the circuit then computes the
    plain boolean semantics / unweighted model count."""
    return Parameter.from_input(
        TensorParameter(
            *shape, initializer=ConstantTensorInitializer(1.0), learnable=False
        )
    )


class LogicalCircuit(RootedDiAcyclicGraph[LogicalCircuitNode]):
    """A boolean circuit as a rooted DAG (single output)."""

    def __init__(
        self,
        nodes: Sequence[LogicalCircuitNode],
        in_nodes: dict[LogicalCircuitNode, Sequence[LogicalCircuitNode]],
        outputs: Sequence[LogicalCircuitNode],
    ) -> None:
        if len(outputs) != 1:
            raise ValueError("A logic circuit must have exactly one output")
        super().__init__(nodes, in_nodes, outputs)
        self._scopes: dict[int, Scope] | None = None

    # -- scopes ----------------------------------------------------------------
    @property
    def num_variables(self) -> int:
        return len({n.literal for n in self.nodes if isinstance(n, LogicalInputNode)})

    def node_scope(self, node: LogicalCircuitNode) -> Scope:
        """The set of variables the sub-circuit rooted at ``node`` mentions."""
        if self._scopes is None:
            scopes: dict[int, Scope] = {}
            for n in self.topological_ordering():
                if isinstance(n, LogicalInputNode):
                    scopes[id(n)] = Scope([n.literal])
                elif isinstance(n, (TopNode, BottomNode)):
                    scopes[id(n)] = Scope([])
                else:
                    scopes[id(n)] = Scope.union(
                        *(scopes[id(c)] for c in self.node_inputs(n))
                    )
            self._scopes = scopes
        return self._scopes[id(node)]

    # -- transformations ---------------------------------------------------------
    def prune(self) -> None:
        """Apply unit propagation in place: Bottom absorbs conjunctions and
        Top absorbs disjunctions; Top/Bottom are dropped from conjunction /
        disjunction inputs respectively; gates left with no inputs collapse
        to their neutral constant and single-input conjunctions collapse to
        their child. Unreachable nodes are removed
        (ref: ``templates/logic/graph.py:95-140``)."""
        replace: dict[int, LogicalCircuitNode] = {}

        def resolve(n: LogicalCircuitNode) -> LogicalCircuitNode:
            while id(n) in replace and replace[id(n)] is not n:
                n = replace[id(n)]
            return n

        in_nodes: dict[LogicalCircuitNode, list[LogicalCircuitNode]] = {}
        for n in self.topological_ordering():
            if not isinstance(n, (ConjunctionNode, DisjunctionNode)):
                continue
            absorbing = BottomNode if isinstance(n, ConjunctionNode) else TopNode
            neutral = TopNode if isinstance(n, ConjunctionNode) else BottomNode
            children = [resolve(c) for c in self.node_inputs(n)]
            if any(isinstance(c, absorbing) for c in children):
                replace[id(n)] = absorbing()
                continue
            children = [c for c in children if not isinstance(c, neutral)]
            if not children:
                replace[id(n)] = neutral()
            elif len(children) == 1 and isinstance(n, ConjunctionNode):
                replace[id(n)] = children[0]
            else:
                in_nodes[n] = children

        root = resolve(self.output)
        if isinstance(root, (TopNode, BottomNode)):
            self.__init__([root], {}, [root])
            return
        # keep only nodes reachable from the root
        reachable: list[LogicalCircuitNode] = []
        stack = [root]
        seen = {id(root)}
        while stack:
            n = stack.pop()
            reachable.append(n)
            for c in in_nodes.get(n, []):
                if id(c) not in seen:
                    seen.add(id(c))
                    stack.append(c)
        self.__init__(
            reachable, {n: in_nodes[n] for n in reachable if n in in_nodes}, [root]
        )

    def smooth(self) -> None:
        """Make every disjunction smooth in place: each disjunct is extended
        with fresh ``(x or not x)`` gadgets for the variables it is missing
        relative to the disjunction's scope
        (ref: ``templates/logic/graph.py:177-232``).

        A conjunction disjunct is only grown in place when this disjunction
        is its sole parent; a conjunction shared by several parents is
        wrapped in a fresh per-parent conjunction instead. Growing a shared
        node would change its scope under every other parent while scope
        queries still read the pre-mutation cache, leaving those parents
        non-smooth.
        """
        literal_map: dict[tuple[int, bool], LogicalCircuitNode] = {
            (n.literal, isinstance(n, LiteralNode)): n
            for n in self.nodes
            if isinstance(n, LogicalInputNode)
        }
        gadgets: dict[int, DisjunctionNode] = {}
        in_nodes: dict[LogicalCircuitNode, list[LogicalCircuitNode]] = {
            n: list(cs) for n, cs in self._in_nodes.items()
        }
        parent_refs: dict[int, int] = {}
        for cs in self._in_nodes.values():
            for c in cs:
                parent_refs[id(c)] = parent_refs.get(id(c), 0) + 1

        def gadget(var: int) -> DisjunctionNode:
            if var not in gadgets:
                g = DisjunctionNode()
                in_nodes[g] = [
                    literal_map.setdefault((var, True), LiteralNode(var)),
                    literal_map.setdefault((var, False), NegatedLiteralNode(var)),
                ]
                gadgets[var] = g
            return gadgets[var]

        for d in [n for n in self.nodes if isinstance(n, DisjunctionNode)]:
            d_scope = self.node_scope(d)
            for pos, child in enumerate(list(in_nodes[d])):
                missing = d_scope - self.node_scope(child)
                if not missing:
                    continue
                fillers = [gadget(v) for v in missing]
                if isinstance(child, ConjunctionNode) and parent_refs[id(child)] == 1:
                    in_nodes[child].extend(fillers)
                else:
                    wrapper = ConjunctionNode()
                    in_nodes[wrapper] = [child, *fillers]
                    in_nodes[d][pos] = wrapper

        nodes = list(set(itertools.chain(in_nodes.keys(), *in_nodes.values())))
        self.__init__(nodes, in_nodes, list(self._outputs))

    # -- lowering -----------------------------------------------------------------
    def _disjunction_weight(self, node: DisjunctionNode, shape) -> Parameter | None:
        """Hook for per-node disjunction weights: ``None`` (the default)
        defers to ``build_circuit``'s global ``weight_factory``; parameterized
        formats (PSDD) override this with each decision node's trained
        element distribution."""
        return None

    def build_circuit(
        self,
        literal_input_factory: InputLayerFactory | None = None,
        negated_literal_input_factory: InputLayerFactory | None = None,
        weight_factory: ParameterFactory | None = None,
        enforce_smoothness: bool = True,
    ) -> Circuit:
        """Lower to a symbolic circuit: conjunctions become Hadamard layers,
        disjunctions become sum layers, literals become (by default)
        indicator Categorical layers with unit sum weights — so circuit
        evaluation computes the boolean function and integration the model
        count; weighted literal factories give weighted model counting
        (ref: ``templates/logic/graph.py:234-317``)."""
        if (literal_input_factory is None) != (negated_literal_input_factory is None):
            raise ValueError(
                "Either both 'literal_input_factory' and "
                "'negated_literal_input_factory' must be provided, or neither"
            )
        if literal_input_factory is None:
            literal_input_factory = _default_literal_factory(negated=False)
            negated_literal_input_factory = _default_literal_factory(negated=True)
        if weight_factory is None:
            weight_factory = _unit_weight_factory

        if enforce_smoothness:
            self.smooth()
        self.prune()
        if isinstance(self.output, (TopNode, BottomNode)):
            raise ValueError(
                "The logic circuit reduced to a constant "
                f"{type(self.output).__name__}; there is nothing to compile"
            )

        node_to_layer: dict[int, Layer] = {}
        in_layers: dict[Layer, list[Layer]] = {}
        for node in self.topological_ordering():
            if isinstance(node, LiteralNode):
                layer = literal_input_factory(Scope([node.literal]), 1)
            elif isinstance(node, NegatedLiteralNode):
                layer = negated_literal_input_factory(Scope([node.literal]), 1)
            elif isinstance(node, ConjunctionNode):
                layer = HadamardLayer(1, arity=len(self.node_inputs(node)))
                in_layers[layer] = [node_to_layer[id(c)] for c in self.node_inputs(node)]
            elif isinstance(node, DisjunctionNode):
                weight = self._disjunction_weight(
                    node, (1, len(self.node_inputs(node)))
                )
                layer = SumLayer(
                    1,
                    1,
                    arity=len(self.node_inputs(node)),
                    weight=weight,
                    weight_factory=None if weight is not None else weight_factory,
                )
                in_layers[layer] = [node_to_layer[id(c)] for c in self.node_inputs(node)]
            else:
                raise ValueError(f"Cannot lower node of type {type(node).__name__}")
            node_to_layer[id(node)] = layer

        layers = [node_to_layer[id(n)] for n in self.nodes]
        return Circuit(layers, in_layers, [node_to_layer[id(self.output)]])
