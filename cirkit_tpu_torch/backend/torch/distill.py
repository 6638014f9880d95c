"""Tree distillation: project a trained circuit onto its optimal Chow-Liu
tree.

The counterpart of ``cirkit_tpu/backend/jax/distill.py``. The exact mutual
information matrix and the exact pairwise conditionals are read off the
*model* (:func:`mutual_information` and the same anchored-marginals
machinery of :class:`ExpectationQuery`), so the returned tree is the exact
I-projection of the circuit distribution onto directed trees, by the
Chow-Liu theorem the KL-optimal tree approximation:

    KL(p || q_tree) = -H(p) + sum_v H(x_v) - sum_(u,v in tree) I(x_u; x_v)

maximized by the maximum-MI spanning tree with p's own conditionals.
Distillation gives a small, fast, *deterministic* surrogate (exact
entropy, linear-time exact MAP) of an arbitrarily large circuit.

The distilled circuit encodes ``p(x_root) prod_v p(x_v | x_pa(v))`` in the
standard indicator construction: per tree node an indicator categorical
leaf (one unit per state, constant), a Hadamard with the children's
messages, and a sum layer whose weight row t is ``p(x_v = . | x_pa = t)``
(learnable plain constants, ``fit_em``-eligible for data fine-tuning,
while the indicator leaves compile to true constants EM never touches).
"""

from __future__ import annotations

import numpy as np
import torch

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.parameters import Store
from cirkit_tpu_torch.backend.torch.pruning import _const
from cirkit_tpu_torch.backend.torch.queries import (
    ExpectationQuery,
    _bound_store,
    _store_device,
    _variable_supports,
    mutual_information,
)
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.layers import CategoricalLayer, HadamardLayer, SumLayer
from cirkit_tpu_torch.symbolic.parameters import ConstantParameter, Parameter
from cirkit_tpu_torch.utils.scope import Scope

__all__ = ["distill_tree"]


def _prim(mi: np.ndarray, root: int) -> np.ndarray:
    """Prim's maximum spanning tree over the symmetric MI matrix: the
    parent array of the tree rooted at ``root`` (parent[root] = -1).
    Deterministic (ties break toward the lowest-index variable)."""
    d = mi.shape[0]
    parent = np.full(d, -1, dtype=np.int64)
    in_tree = np.zeros(d, dtype=bool)
    in_tree[root] = True
    best = mi[root].copy()
    best_from = np.full(d, root, dtype=np.int64)
    for _ in range(d - 1):
        cand = np.where(in_tree, -np.inf, best)
        nxt = int(np.argmax(cand))
        parent[nxt] = int(best_from[nxt])
        in_tree[nxt] = True
        upd = ~in_tree & (mi[nxt] > best)
        best = np.where(upd, mi[nxt], best)
        best_from = np.where(upd, nxt, best_from)
    return parent


def distill_tree(
    circuit: TorchCircuit,
    *,
    store: Store | None = None,
    root: int = 0,
    output: int = 0,
    unit: int = 0,
) -> tuple[Circuit, dict]:
    """Distill a compiled circuit into its KL-optimal Chow-Liu tree.

    Returns ``(tree circuit, report)``: a symbolic circuit encoding
    ``p(x_root) prod_v p(x_v | x_pa(v))`` with the model's own exact
    marginals/conditionals, structured by the maximum spanning tree of the
    model's exact pairwise mutual information. The report carries the
    rooted ``edges``, the captured dependence ``mi_objective``
    (``sum_edges I``: by the Chow-Liu identity, maximizing it minimizes
    ``KL(p || q_tree)``), and the per-variable entropies.

    Cost: one batched marginals backward per variable for the MI matrix,
    plus one per distinct tree parent for the conditional tables
    (~2 D calls of batch = support size), on the store's device; of each
    parent's (S_p, D, S) table only the children's columns are read back.
    Finite-support leaves only. The tree is smooth, decomposable, and
    deterministic (entropy / log-count queries on it are exact), and its
    sum weights are plain learnable constants, so ``fit_em`` can fine-tune
    it on data while the indicator leaves stay fixed (they compile to
    constants, not slots).
    """
    supports = _variable_supports(circuit)
    num_vars = supports.shape[0]
    covered = [v for v in range(num_vars) if supports[v] != -2]
    if not 0 <= root < num_vars or supports[root] == -2:
        raise ValueError(f"Root variable {root} is outside the circuit scope")
    if (supports[covered] == -1).any():
        bad = covered[int(np.argmax(supports[covered] == -1))]
        raise NotImplementedError(
            f"Tree distillation needs finite-support leaves; variable {bad} "
            "has a continuous input layer"
        )
    if len(covered) < 2:
        raise ValueError("Tree distillation needs at least two variables")

    dev = _store_device(_bound_store(circuit, store))
    q = ExpectationQuery(circuit)
    mi = mutual_information(
        circuit, store=store, variables=covered, output=output, unit=unit
    ).cpu().numpy().astype(np.float64)  # (k, k) over `covered`
    pos = {v: i for i, v in enumerate(covered)}
    parent_pos = _prim(mi, pos[root])
    parent = np.full(num_vars, -1, dtype=np.int64)
    for i, v in enumerate(covered):
        parent[v] = covered[int(parent_pos[i])] if parent_pos[i] >= 0 else -1
    children: dict[int, list[int]] = {v: [] for v in covered}
    for v in covered:
        if parent[v] >= 0:
            children[int(parent[v])].append(v)

    marg = q.marginals(
        torch.zeros((1, num_vars), dtype=torch.int64, device=dev),
        evidence_mask=torch.zeros((1, num_vars), dtype=torch.bool, device=dev),
        store=store, output=output, unit=unit,
    )[0].cpu().numpy().astype(np.float64)  # (D, S)

    # exact conditional tables p(x_c = s | x_p = t), one anchored
    # marginals call per distinct parent (batch = parent support)
    cond_w: dict[int, np.ndarray] = {}
    for p, cs in children.items():
        if not cs:
            continue
        s_p = int(supports[p])
        xs = torch.zeros((s_p, num_vars), dtype=torch.int64, device=dev)
        xs[:, p] = torch.arange(s_p, device=dev)
        mk = torch.zeros((s_p, num_vars), dtype=torch.bool, device=dev)
        mk[:, p] = True
        full = q.marginals(
            xs, evidence_mask=mk, store=store, output=output, unit=unit,
        )  # (S_p, D, S) on the device
        # read back only the children's columns: the full table is hundreds
        # of MB at image scale
        tab = full.index_select(1, torch.as_tensor(cs, device=dev)).cpu().numpy().astype(
            np.float64
        )  # (S_p, len(cs), S)
        del full
        for ci, c in enumerate(cs):
            w = tab[:, ci, : int(supports[c])].copy()
            # impossible parent states (p(x_p = t) = 0) backward to NaN:
            # any valid row works, so use the unconditional marginal
            bad = ~np.isfinite(w).all(axis=1) | (w.sum(axis=1) <= 0)
            w[bad] = marg[c, : int(supports[c])]
            w = np.clip(w, 0.0, None)
            cond_w[c] = w / w.sum(axis=1, keepdims=True)

    # ---- build the indicator tree circuit (children before parents) -----
    layers: list = []
    in_map: dict = {}
    msg: dict[int, SumLayer] = {}
    order: list[int] = []
    stack = [root]
    while stack:  # preorder, then reversed = postorder (children first)
        v = stack.pop()
        order.append(v)
        stack.extend(children[v])
    for v in reversed(order):
        s_v = int(supports[v])
        leaf = CategoricalLayer(
            Scope([v]), s_v, num_categories=s_v,
            probs=Parameter.from_input(
                ConstantParameter(s_v, s_v, value=np.eye(s_v))
            ),
        )
        layers.append(leaf)
        if children[v]:
            had = HadamardLayer(s_v, arity=1 + len(children[v]))
            layers.append(had)
            in_map[had] = [leaf] + [msg[c] for c in children[v]]
            inner = had
        else:
            inner = leaf
        if v == root:
            w = marg[root, :s_v][None, :]  # (1, S_root)
        else:
            w = cond_w[v]  # (S_p, S_v)
        sum_l = SumLayer(s_v, w.shape[0], weight=_const(w))
        layers.append(sum_l)
        in_map[sum_l] = [inner]
        msg[v] = sum_l

    tree = Circuit(layers, in_map, [msg[root]])
    edges = [(int(parent[v]), v) for v in covered if parent[v] >= 0]
    report = {
        "root": root,
        "edges": edges,
        "mi_objective": float(sum(mi[pos[p], pos[c]] for p, c in edges)),
        "entropies": np.array(np.diag(mi)),
        "units": sum(sl.num_output_units for sl in layers),
    }
    return tree, report
