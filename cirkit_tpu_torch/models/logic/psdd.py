"""Loader for the standard ``.psdd`` file format.

An extension beyond the reference (which loads only unparameterized
``.sdd`` files, ref ``cirkit/templates/logic/sdd.py:19-82``): PSDDs —
probabilistic sentential decision diagrams (Kisa et al. 2014) — are the
parameterized SDDs emitted by the UCLA PSDD package and Juice.jl. Each
line is one of::

    c    <comment>
    psdd <count-of-nodes>
    T <id> <vtree-id> <var> <log-prob>    (true node over 1-indexed var;
                                           log-prob of the POSITIVE literal)
    L <id> <vtree-id> <literal>           (a literal; negative = negated)
    D <id> <vtree-id> <n> {<prime-id> <sub-id> <log-prob>}*n

Nodes appear bottom-up (children before parents); the LAST listed node is
the root. A decision node is a probability-weighted disjunction of
prime-and-sub conjunctions; element log-probabilities are normalized per
decision node, so the lowered circuit is a *normalized* distribution
(its partition function is exactly 1) and — PSDDs being deterministic —
MAP, sampling, and entropy queries on it are exact.

``T`` nodes lower as weighted disjunctions ``p * x_v + (1-p) * not x_v``,
which reuses the whole logic-circuit pipeline (indicator leaves + weighted
sums) unchanged.
"""

from __future__ import annotations

import itertools
import math
from collections import defaultdict

import numpy as np

from cirkit_tpu_torch.models.logic.graph import (
    ConjunctionNode,
    DisjunctionNode,
    LiteralNode,
    LogicalCircuit,
    LogicalCircuitNode,
    NegatedLiteralNode,
)
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.initializers import ConstantTensorInitializer
from cirkit_tpu_torch.symbolic.parameters import Parameter, TensorParameter


class PSDD(LogicalCircuit):
    """A probabilistic SDD loaded from a ``.psdd`` file: a logic-circuit
    DAG whose decision nodes carry normalized element distributions."""

    def __init__(self, nodes, in_nodes, outputs) -> None:
        super().__init__(nodes, in_nodes, outputs)
        # DisjunctionNode -> (arity,) linear-space element probabilities.
        # prune()/smooth() re-run __init__ on the SAME instance: preserve
        # the weight map across those rebuilds.
        if not hasattr(self, "_node_probs"):
            self._node_probs: dict[int, np.ndarray] = {}
            self._learnable = False

    @staticmethod
    def load(filename: str) -> "PSDD":
        """Parse ``filename`` (UTF-8 text in the PSDD format above) into a
        logic circuit rooted at the last listed node."""
        nodes_map: dict[int, LogicalCircuitNode] = {}
        probs: dict[int, np.ndarray] = {}
        in_nodes: dict[LogicalCircuitNode, list[LogicalCircuitNode]] = defaultdict(list)
        last_id: int | None = None

        def literal(lit: int) -> LogicalCircuitNode:
            cls = LiteralNode if lit > 0 else NegatedLiteralNode
            return cls(abs(lit) - 1)

        with open(filename, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                fields = line.split()
                if not fields or fields[0] in ("c", "psdd"):
                    continue
                tag, *args = fields
                try:
                    if tag == "L":
                        n_id, _vtree, lit = (int(a) for a in args)
                        nodes_map[n_id] = literal(lit)
                    elif tag == "T":
                        n_id, _vtree, var = (int(a) for a in args[:3])
                        log_p = float(args[3])
                        if not log_p <= 0.0:
                            raise ValueError(f"log-prob {log_p} > 0")
                        p = math.exp(log_p)
                        disj = DisjunctionNode()
                        pos, neg = literal(var), literal(-var)
                        in_nodes[disj] = [pos, neg]
                        probs[id(disj)] = np.array([p, 1.0 - p])
                        nodes_map[n_id] = disj
                    elif tag == "D":
                        n_id, _vtree, n_elems = (int(a) for a in args[:3])
                        elems = args[3:]
                        if len(elems) != 3 * n_elems:
                            raise ValueError(
                                f"Expected {n_elems} (prime, sub, log-prob) "
                                f"triples, got {len(elems) / 3:g}"
                            )
                        disj = DisjunctionNode()
                        nodes_map[n_id] = disj
                        ps = []
                        for prime, sub, log_p in zip(
                            elems[0::3], elems[1::3], elems[2::3]
                        ):
                            conj = ConjunctionNode()
                            in_nodes[conj] = [
                                nodes_map[int(prime)], nodes_map[int(sub)]
                            ]
                            in_nodes[disj].append(conj)
                            ps.append(math.exp(float(log_p)))
                        ps = np.asarray(ps)
                        if not math.isclose(float(ps.sum()), 1.0, abs_tol=1e-4):
                            raise ValueError(
                                f"element probabilities sum to {ps.sum():.6f}"
                            )
                        probs[id(disj)] = ps
                    else:
                        raise ValueError(f"Unknown PSDD node tag {tag!r}")
                    last_id = n_id
                except (ValueError, KeyError, IndexError) as e:
                    raise ValueError(
                        f"{filename}:{lineno}: malformed PSDD line: {e}"
                    ) from e

        if last_id is None:
            raise ValueError(f"{filename}: no PSDD nodes found")
        root = nodes_map[last_id]
        nodes = list(
            set(itertools.chain(in_nodes.keys(), *in_nodes.values())) | {root}
        )
        psdd = PSDD(nodes, dict(in_nodes), [root])
        psdd._node_probs = probs
        return psdd

    def _disjunction_weight(self, node: DisjunctionNode, shape) -> Parameter | None:
        ps = self._node_probs.get(id(node))
        if ps is None:  # a smoothing disjunction etc. — deterministic pass
            return None
        if ps.shape != (shape[1],):
            raise ValueError(
                f"Decision node arity changed during lowering: weight row has "
                f"{ps.shape[0]} entries, layer expects {shape[1]} — load a "
                "well-formed PSDD (no constants, structured-decomposable)"
            )
        return Parameter.from_input(
            TensorParameter(
                *shape,
                initializer=ConstantTensorInitializer(ps.reshape(shape)),
                learnable=self._learnable,
            )
        )

    def build_circuit(self, learnable: bool = False, **kwargs) -> Circuit:
        """Lower to a normalized symbolic circuit (partition function 1).

        ``learnable=True`` makes the decision distributions plain learnable
        slots, so the loaded PSDD is directly ``fit_em``-eligible (its
        structure stays frozen; the indicator leaves are constants). PSDDs
        are smooth by construction, so smoothing defaults off — a smoothing
        pass could change decision-node arities under their weight rows.
        """
        self._learnable = learnable
        kwargs.setdefault("enforce_smoothness", False)
        return super().build_circuit(**kwargs)
