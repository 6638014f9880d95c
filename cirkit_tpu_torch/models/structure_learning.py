"""LearnSPN-style structure learning: grow a circuit from data.

An extension beyond the reference, which ships only fixed region-graph
templates plus the data-driven ChowLiuTree (``templates/region_graph/
algorithms/chow_liu.py``) — it has no general structure learner. This is
the classic LearnSPN recursion (Gens & Domingos, "Learning the Structure
of Sum-Product Networks", ICML 2013):

- **variable split**: test pairwise independence on the current rows
  (G-test for categorical data, Fisher-z correlation test for Gaussian);
  the connected components of the dependency graph become the children
  of a product node;
- **instance split**: when the variables are mutually dependent, cluster
  the rows (k-means; one-hot encoded for categorical data) and mix the
  per-cluster recursions under a sum node weighted by the smoothed
  cluster proportions;
- **base cases**: single variables become maximum-likelihood leaves;
  small row sets (< ``min_instances``) are fully factorized.

Everything here is one-shot host-side numpy preprocessing (like
ChowLiuTree) producing a symbolic :class:`~cirkit_tpu.symbolic.Circuit`
with constant-initialized *learnable* parameters: plain normalized sum
weights and leaf probabilities, so the learned circuit is immediately
normalized, EM-eligible (``fit_em``) and fine-tunable (``fit``) on TPU.
"""

from __future__ import annotations

import numpy as np

from cirkit_tpu_torch.utils.lazy import LazyModule

# scipy.stats costs ~1.9 s to import and is only needed when an
# independence test actually runs: defer to first use
scipy_stats = LazyModule("scipy.stats", "scipy_stats", globals())

from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.initializers import ConstantTensorInitializer
from cirkit_tpu_torch.symbolic.layers import (
    CategoricalLayer,
    GaussianLayer,
    HadamardLayer,
    Layer,
    SumLayer,
)
from cirkit_tpu_torch.symbolic.parameters import Parameter, TensorParameter
from cirkit_tpu_torch.utils.scope import Scope


def _const(value: np.ndarray) -> Parameter:
    value = np.ascontiguousarray(value, dtype=np.float64)
    return Parameter.from_input(
        TensorParameter(
            *value.shape,
            initializer=ConstantTensorInitializer(value),
            learnable=True,
        )
    )


def _dependency_components(
    data: np.ndarray, *, categorical: bool, threshold: float
) -> list[list[int]]:
    """Connected components of the pairwise-dependency graph over the
    columns of ``data``: an edge where the independence test REJECTS at
    p < ``threshold`` (G-test for categorical, Fisher z for continuous)."""
    n, d = data.shape
    adj = np.zeros((d, d), dtype=bool)
    for i in range(d):
        for j in range(i + 1, d):
            if categorical:
                xi = data[:, i].astype(np.int64)
                xj = data[:, j].astype(np.int64)
                ci, cj = int(xi.max()) + 1, int(xj.max()) + 1
                table = np.zeros((ci, cj))
                np.add.at(table, (xi, xj), 1.0)
                expected = np.outer(table.sum(1), table.sum(0)) / n
                nz = table > 0
                g = 2.0 * float((table[nz] * np.log(table[nz] / expected[nz])).sum())
                dof = max((ci - 1) * (cj - 1), 1)
                p = float(scipy_stats.chi2.sf(g, dof))
            else:
                r = float(np.corrcoef(data[:, i], data[:, j])[0, 1])
                if not np.isfinite(r):
                    p = 1.0
                else:
                    r = np.clip(r, -0.999999, 0.999999)
                    z = abs(np.arctanh(r)) * np.sqrt(max(n - 3, 1))
                    p = 2.0 * float(scipy_stats.norm.sf(z))
            adj[i, j] = adj[j, i] = p < threshold
    # connected components by BFS
    comps: list[list[int]] = []
    seen = np.zeros(d, dtype=bool)
    for s in range(d):
        if seen[s]:
            continue
        comp, stack = [], [s]
        seen[s] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in np.where(adj[u] & ~seen)[0]:
                seen[v] = True
                stack.append(int(v))
        comps.append(sorted(comp))
    return comps


def _kmeans(
    x: np.ndarray, k: int, rng: np.random.Generator, iters: int = 25
) -> np.ndarray:
    """Plain Lloyd k-means labels over standardized features."""
    n = x.shape[0]
    std = x.std(axis=0)
    xs = (x - x.mean(axis=0)) / np.where(std > 0, std, 1.0)
    centers = xs[rng.choice(n, size=min(k, n), replace=False)]
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d2 = ((xs[:, None, :] - centers[None]) ** 2).sum(axis=2)
        new = d2.argmin(axis=1)
        if (new == labels).all():
            break
        labels = new
        for c in range(centers.shape[0]):
            pts = xs[labels == c]
            if len(pts):
                centers[c] = pts.mean(axis=0)
    return labels


def learn_spn(
    data: np.ndarray,
    *,
    input_type: str = "categorical",
    num_categories: int | None = None,
    min_instances: int = 64,
    num_clusters: int = 2,
    independence_threshold: float = 0.05,
    alpha: float = 0.1,
    min_stddev: float = 1e-2,
    seed: int = 0,
) -> Circuit:
    """Learn a smooth, decomposable, normalized circuit from data with the
    LearnSPN recursion (see the module docstring).

    ``data``: (N, D) integer matrix (``input_type="categorical"``) or
    float matrix (``"gaussian"``). ``independence_threshold`` is the
    p-value below which a variable pair counts as dependent; ``alpha``
    Laplace-smooths leaf probabilities and sum weights; ``min_stddev``
    floors Gaussian leaf scales. Returns a symbolic circuit with
    learnable constant-initialized parameters (plain normalized weights:
    EM-eligible and fine-tunable)."""
    data = np.asarray(data)
    if data.ndim != 2:
        raise ValueError("The data must be a (num_samples, num_features) matrix")
    if input_type not in ("categorical", "gaussian"):
        raise NotImplementedError(f"learn_spn does not support {input_type} inputs")
    categorical = input_type == "categorical"
    if categorical:
        data = data.astype(np.int64)
        if num_categories is None:
            num_categories = int(data.max()) + 1
    if num_clusters < 2:
        raise ValueError("num_clusters must be at least 2")
    rng = np.random.default_rng(seed)

    layers: list[Layer] = []
    in_layers: dict[Layer, list[Layer]] = {}

    def add(layer: Layer, children: list[Layer]) -> Layer:
        layers.append(layer)
        if children:
            in_layers[layer] = children
        return layer

    def leaf(rows: np.ndarray, var: int) -> Layer:
        if categorical:
            counts = np.bincount(data[rows, var], minlength=num_categories)
            probs = (counts + alpha) / (counts.sum() + num_categories * alpha)
            return add(
                CategoricalLayer(
                    Scope([var]), 1, num_categories=num_categories,
                    probs=_const(probs[None, :]),
                ),
                [],
            )
        x = data[rows, var].astype(np.float64)
        mean = float(x.mean()) if len(x) else 0.0
        std = float(x.std()) if len(x) > 1 else min_stddev
        return add(
            GaussianLayer(
                Scope([var]), 1,
                mean=_const(np.array([mean])),
                stddev=_const(np.array([max(std, min_stddev)])),
            ),
            [],
        )

    def factorize(rows: np.ndarray, vars_: list[int]) -> Layer:
        if len(vars_) == 1:
            return leaf(rows, vars_[0])
        children = [leaf(rows, v) for v in vars_]
        return add(HadamardLayer(1, arity=len(children)), children)

    def learn(rows: np.ndarray, vars_: list[int]) -> Layer:
        if len(vars_) == 1:
            return leaf(rows, vars_[0])
        if len(rows) < max(min_instances, num_clusters):
            return factorize(rows, vars_)
        comps = _dependency_components(
            data[np.ix_(rows, vars_)].astype(np.float64)
            if not categorical
            else data[np.ix_(rows, vars_)],
            categorical=categorical,
            threshold=independence_threshold,
        )
        if len(comps) > 1:
            children = [learn(rows, [vars_[i] for i in comp]) for comp in comps]
            return add(HadamardLayer(1, arity=len(children)), children)
        # instance split
        x = data[np.ix_(rows, vars_)]
        if categorical:
            feats = np.concatenate(
                [np.eye(num_categories)[x[:, c]] for c in range(x.shape[1])], axis=1
            )
        else:
            feats = x.astype(np.float64)
        labels = _kmeans(feats, num_clusters, rng)
        sizes = np.bincount(labels, minlength=num_clusters)
        nonempty = np.where(sizes > 0)[0]
        if len(nonempty) < 2:
            return factorize(rows, vars_)
        children = [learn(rows[labels == c], vars_) for c in nonempty]
        w = (sizes[nonempty] + alpha) / (sizes[nonempty].sum() + len(nonempty) * alpha)
        return add(
            SumLayer(1, 1, arity=len(children), weight=_const(w[None, :])),
            children,
        )

    root = learn(np.arange(data.shape[0]), list(range(data.shape[1])))
    if not isinstance(root, SumLayer):
        # a sum root keeps the circuit's output a proper mixture head and
        # gives downstream training a root weight slot to adapt
        root = add(SumLayer(1, 1, arity=1, weight=_const(np.ones((1, 1)))), [root])
    return Circuit(layers, in_layers, [root])
