"""Logic circuits: boolean circuit DAGs, smoothing, SDD/PSDD loading, WMC."""

from cirkit_tpu_torch.models.logic.graph import (
    BottomNode,
    ConjunctionNode,
    DisjunctionNode,
    LiteralNode,
    LogicalCircuit,
    LogicalCircuitNode,
    LogicalInputNode,
    NegatedLiteralNode,
    TopNode,
)
from cirkit_tpu_torch.models.logic.psdd import PSDD
from cirkit_tpu_torch.models.logic.sdd import SDD

__all__ = [
    "BottomNode",
    "ConjunctionNode",
    "DisjunctionNode",
    "LiteralNode",
    "LogicalCircuit",
    "LogicalCircuitNode",
    "LogicalInputNode",
    "NegatedLiteralNode",
    "PSDD",
    "SDD",
    "TopNode",
]
