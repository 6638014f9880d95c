"""Region graphs: the bipartite region/partition DAG and circuit construction.

Rebuild of ``cirkit/templates/region_graph/graph.py:46-588``: region graphs
validate that partitions exactly partition their parent scope, support JSON
(de)serialization, structural-property checks, and ``build_circuit`` turning
a region graph into a symbolic circuit using 'cp' / 'cp-t' / 'tucker'
sum-product blocks or explicit layer factories.
"""

from __future__ import annotations

import itertools
import json
from abc import ABC
from collections import defaultdict
from collections.abc import Callable, Iterable, Iterator, Mapping, Sequence
from functools import cached_property

import numpy as np

from cirkit_tpu_torch.models.utils import (
    InputLayerFactory,
    ProductLayerFactory,
    SumLayerFactory,
)
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.layers import HadamardLayer, KroneckerLayer, Layer, SumLayer
from cirkit_tpu_torch.symbolic.parameters import ParameterFactory
from cirkit_tpu_torch.utils.algorithms import DiAcyclicGraph
from cirkit_tpu_torch.utils.scope import Scope


class RegionGraphNode(ABC):
    """A node of a region graph, carrying a variable scope."""

    def __init__(self, scope: Iterable[int] | Scope) -> None:
        scope = Scope(scope)
        if not scope:
            raise ValueError("The scope of a region graph node must not be empty")
        self.scope = scope

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.scope})"


class RegionNode(RegionGraphNode):
    """A region node (a set of variables)."""


class PartitionNode(RegionGraphNode):
    """A partition node (one way of splitting a region's scope)."""


class RegionGraph(DiAcyclicGraph[RegionGraphNode]):
    """The region graph: regions alternate with partitions that exactly
    partition their parent region's scope."""

    def __init__(
        self,
        nodes: Sequence[RegionGraphNode],
        in_nodes: Mapping[RegionGraphNode, Sequence[RegionGraphNode]],
        outputs: Sequence[RegionGraphNode],
    ) -> None:
        super().__init__(nodes, in_nodes, outputs)
        self._check_structure()

    def _check_structure(self) -> None:
        for node in self.nodes:
            children = self.node_inputs(node)
            if isinstance(node, RegionNode):
                for ptn in children:
                    if not isinstance(ptn, PartitionNode):
                        raise ValueError(f"Expected partition children of '{node}', found '{ptn}'")
                    if ptn.scope != node.scope:
                        raise ValueError(
                            f"Expected partition with scope '{node.scope}', found '{ptn.scope}'"
                        )
            elif isinstance(node, PartitionNode):
                scopes = []
                for rgn in children:
                    if not isinstance(rgn, RegionNode):
                        raise ValueError(f"Expected region children of '{node}', found '{rgn}'")
                    scopes.append(rgn.scope)
                union = Scope.union(*scopes) if scopes else Scope()
                if union != node.scope or sum(len(s) for s in scopes) != len(union):
                    raise ValueError(
                        f"Expected a partitioning of '{node.scope}', found '{scopes}'"
                    )
            else:
                raise ValueError(f"Unexpected region graph node type '{type(node)}'")
        for ptn in self.partition_nodes:
            if len(self.node_outputs(ptn)) != 1:
                raise ValueError("Each partition node must have exactly one parent region")

    # -- typed accessors ---------------------------------------------------------
    def region_inputs(self, rgn: RegionNode) -> Sequence[PartitionNode]:
        return list(self.node_inputs(rgn))

    def partition_inputs(self, ptn: PartitionNode) -> Sequence[RegionNode]:
        return list(self.node_inputs(ptn))

    def region_outputs(self, rgn: RegionNode) -> Sequence[PartitionNode]:
        return list(self.node_outputs(rgn))

    def partition_outputs(self, ptn: PartitionNode) -> Sequence[RegionNode]:
        return list(self.node_outputs(ptn))

    @property
    def region_nodes(self) -> Iterator[RegionNode]:
        return (n for n in self.nodes if isinstance(n, RegionNode))

    @property
    def partition_nodes(self) -> Iterator[PartitionNode]:
        return (n for n in self.nodes if isinstance(n, PartitionNode))

    @property
    def inner_nodes(self) -> Iterator[RegionGraphNode]:
        return (n for n in self.nodes if self.node_inputs(n))

    @property
    def inner_region_nodes(self) -> Iterator[RegionNode]:
        return (
            n
            for n in self.region_nodes
            if self.node_inputs(n) and self.node_outputs(n)
        )

    @cached_property
    def scope(self) -> Scope:
        return Scope.union(*(n.scope for n in self.outputs))

    @cached_property
    def num_variables(self) -> int:
        return len(self.scope)

    # -- structural properties -----------------------------------------------------
    @cached_property
    def is_structured_decomposable(self) -> bool:
        decompositions: dict[Scope, tuple[Scope, ...]] = {}
        for ptn in self.partition_nodes:
            decomp = tuple(sorted((r.scope for r in self.node_inputs(ptn)), key=tuple))
            if ptn.scope in decompositions and decompositions[ptn.scope] != decomp:
                return False
            decompositions[ptn.scope] = decomp
        return True

    @cached_property
    def is_omni_compatible(self) -> bool:
        return all(
            len(r.scope) == 1
            for ptn in self.partition_nodes
            for r in self.node_inputs(ptn)
        )

    def is_compatible(self, other: "RegionGraph", /, *, scope: Iterable[int] | None = None) -> bool:
        """Compatibility over a scope via a connected-components check on the
        region-overlap graph (ref: ``region_graph/graph.py:200-252``)."""
        scope = Scope(scope) if scope is not None else self.scope & other.scope
        for ptn1, ptn2 in itertools.product(self.partition_nodes, other.partition_nodes):
            if ptn1.scope & scope != ptn2.scope & scope:
                continue
            ins1 = self.node_inputs(ptn1)
            ins2 = other.node_inputs(ptn2)
            if any(ptn1.scope <= r.scope for r in ins2) or any(
                ptn2.scope <= r.scope for r in ins1
            ):
                continue
            adj = np.zeros((len(ins1), len(ins2)), dtype=bool)
            for (i, r1), (j, r2) in itertools.product(enumerate(ins1), enumerate(ins2)):
                adj[i, j] = bool(r1.scope & r2.scope & scope)
            adj = adj @ adj.T
            laplacian = np.diag(adj.sum(axis=1)) - adj
            num_connected = int(np.isclose(np.linalg.eigvals(laplacian), 0).sum())
            if num_connected == 1:
                return False
        return True

    # -- (de)serialization ------------------------------------------------------------
    def dump(self, filename: str) -> None:
        """Serialize to the reference-compatible region graph JSON format."""
        region_idx = {n: i for i, n in enumerate(self.region_nodes)}
        regions = {str(i): {"scope": list(n.scope)} for n, i in region_idx.items()}
        roots = [str(region_idx[r]) for r in self.outputs]
        graph = [
            {
                "inputs": [region_idx[r] for r in self.node_inputs(ptn)],
                "output": region_idx[self.node_outputs(ptn)[0]],
            }
            for ptn in self.partition_nodes
        ]
        with open(filename, "w", encoding="utf-8") as f:
            json.dump({"regions": regions, "roots": roots, "graph": graph}, f, indent=4)

    @staticmethod
    def load(filename: str) -> "RegionGraph":
        """Deserialize from the region graph JSON format."""
        with open(filename, encoding="utf-8") as f:
            rg_json = json.load(f)
        nodes: list[RegionGraphNode] = []
        in_nodes: dict[RegionGraphNode, list[RegionGraphNode]] = defaultdict(list)
        region_idx: dict[int, RegionNode] = {}
        for idx, rgn_dict in rg_json["regions"].items():
            rgn = RegionNode(rgn_dict["scope"])
            nodes.append(rgn)
            region_idx[int(idx)] = rgn
        outputs = [region_idx[int(i)] for i in rg_json["roots"]]
        for part in rg_json["graph"]:
            out_rgn = region_idx[part["output"]]
            ptn = PartitionNode(out_rgn.scope)
            nodes.append(ptn)
            in_nodes[out_rgn].append(ptn)
            in_nodes[ptn] = [region_idx[int(i)] for i in part["inputs"]]
        return RegionGraph(nodes, in_nodes, outputs=outputs)

    # -- circuit construction ----------------------------------------------------------
    def build_circuit(
        self,
        *,
        input_factory: InputLayerFactory | Mapping[Scope, InputLayerFactory],
        sum_product: str | None = None,
        sum_weight_factory: ParameterFactory | None = None,
        nary_sum_weight_factory: ParameterFactory | None = None,
        sum_factory: SumLayerFactory | None = None,
        prod_factory: ProductLayerFactory | None = None,
        num_input_units: int = 1,
        num_sum_units: int = 1,
        num_classes: int = 1,
        factorize_multivariate: bool = True,
    ) -> Circuit:
        """Turn the region graph into a symbolic circuit.

        Either a ``sum_product`` block name ('cp', 'cp-t', 'tucker') or both
        explicit ``sum_factory``/``prod_factory`` must be given
        (ref: ``region_graph/graph.py:344-588``).
        """
        if (sum_factory is None) != (prod_factory is None):
            raise ValueError(
                "Both 'sum_factory' and 'prod_factory' must be specified or none of them"
            )
        if sum_product is None and sum_factory is None:
            raise ValueError(
                "Either 'sum_product' or the 'sum_factory'/'prod_factory' pair is required"
            )
        if sum_product is not None and sum_factory is not None:
            raise ValueError(
                "At most one between 'sum_product' and the factory pair can be given"
            )
        if nary_sum_weight_factory is None:
            nary_sum_weight_factory = sum_weight_factory

        layers: list[Layer] = []
        in_layers: dict[Layer, list[Layer]] = {}
        node_to_layer: dict[RegionGraphNode, Layer] = {}

        def units_for(rgn: RegionNode) -> int:
            return num_sum_units if self.region_outputs(rgn) else num_classes

        def build_cp(rgn: RegionNode, parts: Sequence[RegionNode]) -> Layer:
            # per-input dense sums, then a Hadamard product
            denses: list[Layer] = []
            for rgn_in in parts:
                d = SumLayer(
                    node_to_layer[rgn_in].num_output_units,
                    num_sum_units,
                    weight_factory=sum_weight_factory,
                )
                denses.append(d)
                layers.append(d)
                in_layers[d] = [node_to_layer[rgn_in]]
            hadamard = HadamardLayer(num_sum_units, arity=len(parts))
            layers.append(hadamard)
            in_layers[hadamard] = denses
            if self.region_outputs(rgn):
                node_to_layer[rgn] = hadamard
                return hadamard
            # root region: append a class-mixing sum so the output is a sum
            out = SumLayer(num_sum_units, num_classes, weight_factory=sum_weight_factory)
            layers.append(out)
            in_layers[out] = [hadamard]
            node_to_layer[rgn] = out
            return out

        def build_cp_transposed(rgn: RegionNode, parts: Sequence[RegionNode]) -> Layer:
            in_units = {node_to_layer[r].num_output_units for r in parts}
            if len(in_units) > 1:
                raise ValueError("CP-T requires equal input unit counts")
            (ki,) = in_units
            hadamard = HadamardLayer(ki, arity=len(parts))
            dense = SumLayer(ki, units_for(rgn), weight_factory=sum_weight_factory)
            layers.extend((hadamard, dense))
            in_layers[hadamard] = [node_to_layer[r] for r in parts]
            in_layers[dense] = [hadamard]
            node_to_layer[rgn] = dense
            return dense

        def build_tucker(rgn: RegionNode, parts: Sequence[RegionNode]) -> Layer:
            in_units = {node_to_layer[r].num_output_units for r in parts}
            if len(in_units) > 1:
                raise ValueError("Tucker requires equal input unit counts")
            (ki,) = in_units
            kronecker = KroneckerLayer(ki, arity=len(parts))
            dense = SumLayer(
                kronecker.num_output_units, units_for(rgn), weight_factory=sum_weight_factory
            )
            layers.extend((kronecker, dense))
            in_layers[kronecker] = [node_to_layer[r] for r in parts]
            in_layers[dense] = [kronecker]
            node_to_layer[rgn] = dense
            return dense

        builders: dict[str, Callable[[RegionNode, Sequence[RegionNode]], Layer]] = {
            "cp": build_cp,
            "cp-t": build_cp_transposed,
            "tucker": build_tucker,
        }
        if sum_product is None:
            sum_prod_builder = None
        elif sum_product in builders:
            sum_prod_builder = builders[sum_product]
        else:
            raise NotImplementedError(f"Unknown sum-product block called {sum_product}")

        for node in self.topological_ordering():
            if isinstance(node, PartitionNode):
                if sum_prod_builder is not None:
                    continue  # handled at the parent region
                assert prod_factory is not None
                prod_ins = [node_to_layer[r] for r in self.partition_inputs(node)]
                prod_sl = prod_factory(num_sum_units, len(prod_ins))
                layers.append(prod_sl)
                in_layers[prod_sl] = prod_ins
                node_to_layer[node] = prod_sl
                continue
            assert isinstance(node, RegionNode)
            region_ins = self.region_inputs(node)
            if not region_ins:
                # Input region: build (possibly factorized) input layers
                factory = (
                    input_factory[node.scope]
                    if isinstance(input_factory, Mapping)
                    else input_factory
                )
                input_sl: Layer
                if factorize_multivariate and len(node.scope) > 1:
                    factors: list[Layer] = [
                        factory(Scope([v]), num_input_units) for v in node.scope
                    ]
                    input_sl = HadamardLayer(num_input_units, arity=len(factors))
                    layers.extend(factors)
                    in_layers[input_sl] = factors
                else:
                    input_sl = factory(node.scope, num_input_units)
                layers.append(input_sl)
                if sum_factory is None:
                    node_to_layer[node] = input_sl
                    continue
                sum_sl = sum_factory(num_input_units, units_for(node))
                layers.append(sum_sl)
                in_layers[sum_sl] = [input_sl]
                node_to_layer[node] = sum_sl
            elif len(region_ins) == 1:
                (ptn,) = region_ins
                if sum_prod_builder is not None:
                    sum_prod_builder(node, self.partition_inputs(ptn))
                    continue
                assert sum_factory is not None
                sum_input = node_to_layer[ptn]
                sum_sl = sum_factory(sum_input.num_output_units, units_for(node))
                layers.append(sum_sl)
                in_layers[sum_sl] = [sum_input]
                node_to_layer[node] = sum_sl
            else:
                # Region partitioned multiple ways: mix with an n-ary sum
                num_units = units_for(node)
                mix_ins: list[Layer]
                if sum_prod_builder is not None:
                    mix_ins = [
                        sum_prod_builder(node, self.partition_inputs(ptn))
                        for ptn in region_ins
                    ]
                else:
                    assert sum_factory is not None
                    sum_ins = [node_to_layer[ptn] for ptn in region_ins]
                    mix_ins = [sum_factory(s.num_output_units, num_units) for s in sum_ins]
                    layers.extend(mix_ins)
                    for mix_sl, s in zip(mix_ins, sum_ins):
                        in_layers[mix_sl] = [s]
                mix_sl = SumLayer(
                    num_units,
                    num_units,
                    arity=len(mix_ins),
                    weight_factory=nary_sum_weight_factory,
                )
                layers.append(mix_sl)
                in_layers[mix_sl] = mix_ins
                node_to_layer[node] = mix_sl

        outputs = [node_to_layer[r] for r in self.outputs]
        return Circuit(layers, in_layers, outputs)
