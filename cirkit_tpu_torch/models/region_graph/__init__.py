from cirkit_tpu_torch.models.region_graph.algorithms import (
    ChowLiuTree,
    FullyFactorized,
    HyperCube,
    HypercubeToScope,
    LinearTree,
    PoonDomingos,
    QuadGraph,
    QuadTree,
    RandomBinaryTree,
    tree2rg,
)
from cirkit_tpu_torch.models.region_graph.graph import (
    PartitionNode,
    RegionGraph,
    RegionGraphNode,
    RegionNode,
)
