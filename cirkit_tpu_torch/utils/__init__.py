from cirkit_tpu_torch.utils.algorithms import (
    BiMap,
    DiAcyclicGraph,
    Graph,
    RootedDiAcyclicGraph,
    bfs,
    layerwise_topological_ordering,
    subgraph,
    topological_ordering,
    topologically_process_nodes,
)
from cirkit_tpu_torch.utils.scope import Scope

__all__ = [
    "BiMap",
    "DiAcyclicGraph",
    "Graph",
    "RootedDiAcyclicGraph",
    "Scope",
    "bfs",
    "layerwise_topological_ordering",
    "subgraph",
    "topological_ordering",
    "topologically_process_nodes",
]
