"""Generic DAG containers and traversals.

TPU-native rebuild of the reference's graph substrate
(``cirkit/utils/algorithms.py:8-219``). These drive region graphs, symbolic
circuits, parameter graphs and the compiled evaluation plans alike. Everything
here is pure Python and trace-time only: nothing touches device arrays.
"""

from __future__ import annotations

from collections import deque
from collections.abc import Callable, Iterable, Iterator, Mapping, Sequence
from typing import Generic, TypeVar

N = TypeVar("N")

IncomingsFn = Callable[[N], Sequence[N]]


def node_outgoings(nodes: Iterable[N], incomings_fn: IncomingsFn) -> dict[N, list[N]]:
    """Invert an incoming-edge function into an outgoing adjacency dict."""
    out: dict[N, list[N]] = {}
    for n in nodes:
        for child in incomings_fn(n):
            out.setdefault(child, []).append(n)
    return out


def bfs(roots: Iterable[N], incomings_fn: IncomingsFn) -> Iterator[N]:
    """Breadth-first traversal from the roots following incoming edges."""
    roots = list(roots)
    visited = set(roots)
    queue = deque(roots)
    while queue:
        n = queue.popleft()
        yield n
        for child in incomings_fn(n):
            if child not in visited:
                visited.add(child)
                queue.append(child)


def subgraph(
    roots: Iterable[N], incomings_fn: IncomingsFn
) -> tuple[list[N], dict[N, Sequence[N]]]:
    """The set of nodes reachable from roots plus their incoming edges."""
    nodes = list(bfs(roots, incomings_fn))
    return nodes, {n: incomings_fn(n) for n in nodes}


def topological_ordering(
    nodes: Iterable[N],
    incomings_fn: IncomingsFn,
    outcomings_fn: IncomingsFn | None = None,
) -> Iterator[N]:
    """Kahn's algorithm over the given node set (inputs first)."""
    nodes = list(nodes)
    if outcomings_fn is None:
        outs = node_outgoings(nodes, incomings_fn)
        outcomings_fn = lambda n: outs.get(n, [])
    pending = {n: len(incomings_fn(n)) for n in nodes}
    frontier = deque(n for n in nodes if pending[n] == 0)
    emitted = 0
    while frontier:
        n = frontier.popleft()
        emitted += 1
        yield n
        for parent in outcomings_fn(n):
            pending[parent] -= 1
            if pending[parent] == 0:
                frontier.append(parent)
    if emitted != len(nodes):
        raise ValueError("The graph contains a cycle: no topological ordering exists")


def layerwise_topological_ordering(
    nodes: Iterable[N],
    incomings_fn: IncomingsFn,
    outcomings_fn: IncomingsFn | None = None,
) -> Iterator[list[N]]:
    """Frontier-by-frontier topological ordering (the basis of folding).

    Mirrors ``cirkit/utils/algorithms.py:71-97``: the first frontier is all
    nodes without inputs; each later frontier is every node whose last
    missing input was produced by the previous frontier.
    """
    nodes = list(nodes)
    if outcomings_fn is None:
        outs = node_outgoings(nodes, incomings_fn)
        outcomings_fn = lambda n: outs.get(n, [])
    pending = {n: len(incomings_fn(n)) for n in nodes}
    frontier = [n for n in nodes if pending[n] == 0]
    emitted = 0
    while frontier:
        emitted += len(frontier)
        yield frontier
        nxt: list[N] = []
        for n in frontier:
            for parent in outcomings_fn(n):
                pending[parent] -= 1
                if pending[parent] == 0:
                    nxt.append(parent)
        frontier = nxt
    if emitted != len(nodes):
        raise ValueError("The graph contains a cycle: no topological ordering exists")


def topologically_process_nodes(
    ordering: Iterable[N],
    outputs: Iterable[N],
    process_fn: Callable[[N], N],
    *,
    incomings_fn: IncomingsFn,
) -> tuple[list[N], dict[N, list[N]], list[N]]:
    """Map a function over nodes in topological order, rebuilding the edges."""
    replaced: dict[N, N] = {}
    in_nodes: dict[N, list[N]] = {}
    for n in ordering:
        new_n = process_fn(n)
        replaced[n] = new_n
        in_nodes[new_n] = [replaced[c] for c in incomings_fn(n)]
    return list(replaced.values()), in_nodes, [replaced[n] for n in outputs]


class Graph(Generic[N]):
    """A directed graph given by a node list and incoming-edge mapping."""

    def __init__(self, nodes: Sequence[N], in_nodes: Mapping[N, Sequence[N]]):
        self._nodes = nodes
        self._in_nodes = in_nodes
        self._out_nodes = node_outgoings(nodes, self.node_inputs)

    def node_inputs(self, n: N) -> Sequence[N]:
        return self._in_nodes.get(n, [])

    def node_outputs(self, n: N) -> Sequence[N]:
        return self._out_nodes.get(n, [])

    @property
    def nodes(self) -> Sequence[N]:
        return self._nodes

    @property
    def nodes_inputs(self) -> Mapping[N, Sequence[N]]:
        return self._in_nodes

    @property
    def nodes_outputs(self) -> Mapping[N, Sequence[N]]:
        return self._out_nodes

    @property
    def inputs(self) -> Iterator[N]:
        return (n for n in self._nodes if not self.node_inputs(n))

    def __len__(self) -> int:
        return len(self._nodes)


class DiAcyclicGraph(Graph[N]):
    """A DAG with designated output nodes."""

    def __init__(
        self,
        nodes: Sequence[N],
        in_nodes: Mapping[N, Sequence[N]],
        outputs: Sequence[N],
    ):
        super().__init__(nodes, in_nodes)
        self._outputs = outputs

    @property
    def outputs(self) -> Sequence[N]:
        return self._outputs

    def topological_ordering(self) -> Iterator[N]:
        return topological_ordering(self._nodes, self.node_inputs, self.node_outputs)

    def layerwise_topological_ordering(self) -> Iterator[list[N]]:
        return layerwise_topological_ordering(
            self._nodes, self.node_inputs, self.node_outputs
        )

    def subgraph(self, *roots: N) -> "DiAcyclicGraph[N]":
        nodes, in_nodes = subgraph(roots, self.node_inputs)
        return DiAcyclicGraph(nodes, in_nodes, outputs=list(roots))


class RootedDiAcyclicGraph(DiAcyclicGraph[N]):
    """A DAG with exactly one output node."""

    def __init__(
        self,
        nodes: Sequence[N],
        in_nodes: Mapping[N, Sequence[N]],
        outputs: Sequence[N],
    ):
        if len(outputs) != 1:
            raise ValueError("A rooted DAG must have exactly one output node")
        super().__init__(nodes, in_nodes, outputs)

    @property
    def output(self) -> N:
        return self._outputs[0]


L = TypeVar("L")
R = TypeVar("R")


class BiMap(Generic[L, R]):
    """A one-to-one mapping supporting lookups from both sides."""

    def __init__(self) -> None:
        self._fwd: dict[L, R] = {}
        self._bwd: dict[R, L] = {}

    def has_left(self, lhs: L) -> bool:
        return lhs in self._fwd

    def has_right(self, rhs: R) -> bool:
        return rhs in self._bwd

    def get_left(self, lhs: L) -> R:
        return self._fwd[lhs]

    def get_right(self, rhs: R) -> L:
        return self._bwd[rhs]

    def add(self, lhs: L, rhs: R) -> None:
        if lhs in self._fwd or rhs in self._bwd:
            raise ValueError("BiMap entries must be unique on both sides")
        self._fwd[lhs] = rhs
        self._bwd[rhs] = lhs
