"""Loader for the standard ``.sdd`` file format.

Rebuild of ``cirkit/templates/logic/sdd.py:19-82``: parses the
Sentential-Decision-Diagram text format emitted by the UCLA SDD package.
Each line is one of::

    c   <comment>
    sdd <count-of-sdd-nodes>
    F   <id>                      (the constant False)
    T   <id>                      (the constant True)
    L   <id> <vtree-id> <literal> (a literal; negative = negated; 1-indexed)
    D   <id> <vtree-id> <n> {<prime-id> <sub-id>}*n

Nodes appear bottom-up (children before parents); node id 0 is the root.
A decomposition node is a disjunction of prime-and-sub conjunctions.
"""

from __future__ import annotations

import itertools
from collections import defaultdict

from cirkit_tpu_torch.models.logic.graph import (
    BottomNode,
    ConjunctionNode,
    DisjunctionNode,
    LiteralNode,
    LogicalCircuit,
    LogicalCircuitNode,
    NegatedLiteralNode,
    TopNode,
)


class SDD(LogicalCircuit):
    """A logic circuit loaded from a ``.sdd`` file (structured
    decomposability comes for free from the SDD's vtree)."""

    @staticmethod
    def load(filename: str) -> "SDD":
        """Parse ``filename`` (UTF-8 text in the SDD format above) into a
        logic circuit rooted at node id 0."""
        nodes_map: dict[int, LogicalCircuitNode] = {}
        in_nodes: dict[LogicalCircuitNode, list[LogicalCircuitNode]] = defaultdict(list)

        with open(filename, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                fields = line.split()
                if not fields or fields[0] in ("c", "sdd"):
                    continue
                tag, *args = fields
                try:
                    args = [int(a) for a in args]
                    if tag == "L":
                        n_id, _vtree, lit = args
                        # file literals are 1-indexed and signed
                        cls = LiteralNode if lit > 0 else NegatedLiteralNode
                        nodes_map[n_id] = cls(abs(lit) - 1)
                    elif tag == "T":
                        (n_id,) = args
                        nodes_map[n_id] = TopNode()
                    elif tag == "F":
                        (n_id,) = args
                        nodes_map[n_id] = BottomNode()
                    elif tag == "D":
                        n_id, _vtree, n_elems, *elems = args
                        if len(elems) != 2 * n_elems:
                            raise ValueError(
                                f"Expected {n_elems} (prime, sub) pairs, got {len(elems) // 2}"
                            )
                        disj = DisjunctionNode()
                        nodes_map[n_id] = disj
                        for prime, sub in zip(elems[0::2], elems[1::2]):
                            conj = ConjunctionNode()
                            in_nodes[conj] = [nodes_map[prime], nodes_map[sub]]
                            in_nodes[disj].append(conj)
                    else:
                        raise ValueError(f"Unknown SDD node tag {tag!r}")
                except (ValueError, KeyError) as e:
                    raise ValueError(f"{filename}:{lineno}: malformed SDD line: {e}") from e

        if 0 not in nodes_map:
            raise ValueError(f"{filename}: no root node (id 0) found")
        nodes = list(set(itertools.chain(in_nodes.keys(), *in_nodes.values())) | {nodes_map[0]})
        return SDD(nodes, dict(in_nodes), [nodes_map[0]])
