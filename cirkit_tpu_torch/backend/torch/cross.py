"""Cross-circuit expectations and divergences via pairwise traversal.

The counterpart of ``cirkit_tpu/backend/jax/cross.py``: ``E_p[log q]`` and
``KL(p || q)`` between two DIFFERENT (but compatible) circuits, an exact
structural-determinism verifier, and Monte Carlo estimators for any pair
of same-scope circuits.

For a pair ``(n, m)`` of same-scope units (``n`` from ``p``, ``m`` from
``q``) define

    P(n, m) = int p~_n(x) * s_m(x) dx
    C(n, m) = int p~_n(x) * s_m(x) * log q~_m(x) dx

with ``s_m`` the support indicator of q's unit ``m``. When q is
DETERMINISTIC (every sum's positively-weighted inputs have pairwise
disjoint supports), ``log q~`` decomposes along q's parse tree and
``(P, C)`` close under the recursion (Vergari et al., "A Compositional
Atlas of Tractable Circuit Operations", NeurIPS 2021):

- input pair: closed form per leaf-family pair (tabular x tabular,
  Gaussian x Gaussian);
- product pair: ``P`` multiplies and ``C`` follows the Leibniz rule over
  the scope-matched child pairs (disjoint scopes);
- sum pair (p-side row ``A``, q-side row ``B``):
  ``P(o1, o2) = sum_a sum_{b: B_b > 0} A_a P(a, b)`` and
  ``C(o1, o2) = sum_a sum_{b: B_b > 0} A_a (C(a, b) + log B_b P(a, b))``.

Carried as ``(log P, r = C / P)``, every sum reduction is a two-stage
exp-weighted matmul after per-row max shifts. At the root, ``E_p[log q] =
r - log Z_q`` whenever ``P = Z_p`` and ``-inf`` otherwise; ``KL(p || q) =
-H(p) - E_p[log q]`` with ``H(p)`` from ``EntropyQuery``.

By default everything runs on the host in float64 over the SYMBOLIC
graphs, with the parameters read back through the pipeline context: a
sibling compiler that shares the context's slot state compiles the circuit
unoptimized and reads each symbolic layer's values at its ``(plan entry,
fold)`` placement (``TorchCircuit._symbolic_fold``) from the context's
store, which it neither extends nor re-initializes. ``device=True`` runs
the same recursion with the carrier math as torch ops on the store's
device and in its dtype: the traversal stays host Python and only the root
carriers are read back. Accuracy follows the dtype (float32: about 1e-4
nats; float64 matches the host path to 1e-9).

The pair recursion enumerates ``arity_p x arity_q`` child pairs per sum
pair, so it targets deterministic pairs of modest sum arity (logic/SDD
weighted-model-count distributions). Two parameterizations of ONE circuit
are served by ``KLDivergenceQuery``, and non-deterministic pairs by the
Monte Carlo estimators, which draw through ``SamplingQuery`` and evaluate
both circuits' forwards.
"""

from __future__ import annotations

import itertools
import math
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch

from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
from cirkit_tpu_torch.backend.torch.entropy import EntropyQuery
from cirkit_tpu_torch.backend.torch.queries import (
    IntegrateQuery,
    SamplingQuery,
    _generator,
    _store_device,
    _store_dtype,
)
from cirkit_tpu_torch.symbolic.circuit import Circuit, are_compatible
from cirkit_tpu_torch.symbolic.layers import (
    BinomialLayer,
    CategoricalLayer,
    EmbeddingLayer,
    GaussianLayer,
    HadamardLayer,
    InputLayer,
    KroneckerLayer,
    Layer,
    SumLayer,
)
from cirkit_tpu_torch.utils.scope import Scope

__all__ = [
    "cross_circuit_kl",
    "expected_loglikelihood",
    "expected_loglikelihood_mc",
    "is_deterministic",
    "kl_monte_carlo",
]


# --------------------------------------------------------------------------
# parameter readback: evaluation-consistent host tables
# --------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float64).cpu().numpy()


def _materialize_tables(sc: Circuit, ctx, store) -> dict[Layer, Any]:
    """Per-symbolic-layer host float64 values that match the compiled
    circuit's pointwise evaluation: sum layers map to their materialized
    weight rows, discrete leaves to the full ``(K, S)`` unnormalized state
    table ``p~(x = s)``, Gaussians to ``("gaussian", mean, stddev)``."""
    base = ctx._compiler
    if not base.is_compiled(sc):
        raise ValueError(
            "Compile the circuit through this context first (ctx.compile(sc)): "
            "cross-circuit queries read the trained parameters back through "
            "the context's slot state"
        )
    raw = TorchCompiler(semiring=base._flags["semiring"], fold=True, optimize=False,
                        device=base.device)
    raw.state = base.state
    cc = raw.compile(sc)
    placement = cc._symbolic_fold
    assert placement is not None  # an unoptimized compile always keeps it

    values: dict[Layer, Any] = {}
    with torch.no_grad():
        for sl, (pi, f) in placement.items():
            tl = cc._entries[pi].layer
            if isinstance(sl, SumLayer):
                w = _host(tl.weight(store))[f]
                if (w < 0).any():
                    raise NotImplementedError(
                        "Cross-circuit queries require nonnegative sum weights "
                        "(probability semantics); found negative entries"
                    )
                values[sl] = w
            elif isinstance(sl, CategoricalLayer):
                values[sl] = np.exp(_host(tl._log_probs(store))[f])
            elif isinstance(sl, EmbeddingLayer):
                t = _host(tl.weight(store))[f]
                if (t < 0).any():
                    raise NotImplementedError(
                        "Cross-circuit queries require nonnegative embedding "
                        "tables (probability semantics); found negative entries"
                    )
                values[sl] = t
            elif isinstance(sl, BinomialLayer):
                p = _host(torch.sigmoid(tl._logits(store)))[f]
                n = sl.total_count
                s = np.arange(n + 1, dtype=np.float64)
                comb = np.array([math.comb(n, int(i)) for i in range(n + 1)], np.float64)
                with np.errstate(divide="ignore", invalid="ignore"):
                    logt = (
                        np.log(comb)[None, :]
                        + s[None, :] * np.log(p)[:, None]
                        + (n - s)[None, :] * np.log1p(-p)[:, None]
                    )
                # p = 0 / 1 edges: the pmf is a point mass at 0 / n
                logt = np.where(np.isnan(logt), -np.inf, logt)
                values[sl] = np.exp(logt)
            elif isinstance(sl, GaussianLayer):
                if sl.log_partition is not None:
                    raise NotImplementedError(
                        "Cross-circuit queries over unnormalized (log-partition) "
                        "Gaussian layers are not supported"
                    )
                values[sl] = ("gaussian", _host(tl.mean(store))[f], _host(tl.stddev(store))[f])
            elif isinstance(sl, (HadamardLayer, KroneckerLayer)):
                pass  # parameterless
            else:
                raise NotImplementedError(
                    f"Cross-circuit queries are not supported for {type(sl).__name__}"
                )
    return values


def _is_gaussian(v: Any) -> bool:
    return isinstance(v, tuple) and v and v[0] == "gaussian"


def _log_partition(sc: Circuit, values: dict[Layer, Any]) -> dict[Layer, np.ndarray]:
    """Per-layer ``(K,)`` log partition vectors of the unnormalized
    measure, bottom-up on the host (float64, per-row max shifts)."""
    z: dict[Layer, np.ndarray] = {}
    for sl in sc.topological_ordering():
        if isinstance(sl, InputLayer):
            v = values[sl]
            if _is_gaussian(v):
                z[sl] = np.zeros(sl.num_output_units)
            else:
                with np.errstate(divide="ignore"):
                    z[sl] = np.log(v.sum(axis=1))
        elif isinstance(sl, HadamardLayer):
            z[sl] = sum(z[c] for c in sc.layer_inputs(sl))
        elif isinstance(sl, KroneckerLayer):
            out = np.zeros(1)
            for c in sc.layer_inputs(sl):  # first child most significant
                out = (out[:, None] + z[c][None, :]).reshape(-1)
            z[sl] = out
        elif isinstance(sl, SumLayer):
            comp = np.concatenate([z[c] for c in sc.layer_inputs(sl)])
            w = values[sl]  # (O, H*K)
            s = comp.max()
            s = s if np.isfinite(s) else 0.0
            with np.errstate(divide="ignore"):
                z[sl] = np.log(w @ np.exp(comp - s)) + s
        else:
            raise NotImplementedError(
                f"Cross-circuit queries are not supported for {type(sl).__name__}"
            )
    return z


# --------------------------------------------------------------------------
# the generic pairwise walker
# --------------------------------------------------------------------------

_Pair = tuple[Layer, Layer]
_Val = tuple[Any, ...]  # numpy arrays on the host path, tensors with device=True


def _assemble_sum_comp(vals: Sequence[_Val], a1: int, a2: int) -> _Val:
    """Child pair values (``itertools.product`` order, h1-major) into the
    flat sum composites: per carrier, ``(a1 * K1, a2 * K2)`` with the
    p-side flat index ``h1 * K1 + k`` (the concat-over-arity layout of
    ``SumLayer`` weights) and likewise on the q side."""
    out = []
    for c in range(len(vals[0])):
        k1, k2 = vals[0][c].shape
        if isinstance(vals[0][c], torch.Tensor):
            # device carriers: one stack and permute, no host reads
            x = torch.stack([v[c] for v in vals]).reshape(a1, a2, k1, k2)
            out.append(x.permute(0, 2, 1, 3).reshape(a1 * k1, a2 * k2))
            continue
        x = np.empty((a1, k1, a2, k2), dtype=vals[0][c].dtype)
        i = 0
        for h1 in range(a1):
            for h2 in range(a2):
                x[h1, :, h2, :] = vals[i][c]
                i += 1
        out.append(x.reshape(a1 * k1, a2 * k2))
    return tuple(out)


def _assemble_kron(
    vals_pos: Sequence[tuple[int, int, _Val]],
    h1: int,
    h2: int,
    k1: int,
    k2: int,
    ops: Sequence[Callable[[Any, Any], Any]],
    inits: Sequence[Any],
) -> _Val:
    """Scope-matched child pair values into Kronecker composite pairs:
    per carrier a ``(k1**h1, k2**h2)`` array where digit ``i`` of the
    p-side composite follows p's OWN child order (first most
    significant) and digit ``j`` of the q-side follows q's: the two
    orders may differ, hence the ``(i, j)`` position pairs."""
    first = vals_pos[0][2][0]
    outs = []
    for c, (op, init) in enumerate(zip(ops, inits)):
        shape = (k1,) * h1 + (k2,) * h2
        if isinstance(first, torch.Tensor):
            acc = torch.full(shape, init, dtype=first.dtype, device=first.device)
        else:
            acc = np.full(shape, init)
        for i, j, tup in vals_pos:
            b = [1] * (h1 + h2)
            b[i] = k1
            b[h1 + j] = k2
            acc = op(acc, tup[c].reshape(b))
        outs.append(acc.reshape(k1**h1, k2**h2))
    return tuple(outs)


def _pairwise_walk(
    sc1: Circuit,
    sc2: Circuit,
    input_fn: Callable[[Layer, Layer], _Val],
    sum_fn: Callable[[Layer, Layer, _Val], _Val],
    ops: Sequence[Callable[[Any, Any], Any]],
    inits: Sequence[Any],
) -> dict[_Pair, _Val]:
    """Bottom-up traversal over the product-operator unit pairing of two
    compatible circuits. ``input_fn`` seeds same-scope leaf pairs with a
    carrier tuple of ``(K1, K2)`` arrays; product pairs combine the
    scope-matched child pairs with ``ops``/``inits`` (elementwise for
    Hadamard, digit-tensorized for Kronecker); sum pairs get the
    assembled ``(A1*K1, A2*K2)`` composite tuple via ``sum_fn``."""
    pair_val: dict[_Pair, _Val] = {}
    stack: list[_Pair] = list(itertools.product(sc1.outputs, sc2.outputs))
    while stack:
        pair = stack[-1]
        if pair in pair_val:
            stack.pop()
            continue
        l1, l2 = pair
        if sc1.layer_scope(l1) != sc2.layer_scope(l2):
            raise NotImplementedError(
                "Cross-circuit queries require identically aligned scope "
                f"partitions; paired layers have scopes {sc1.layer_scope(l1)} "
                f"and {sc2.layer_scope(l2)}"
            )
        in1, in2 = isinstance(l1, InputLayer), isinstance(l2, InputLayer)
        if in1 and in2:
            pair_val[pair] = input_fn(l1, l2)
            stack.pop()
            continue
        # one side may be deeper than the other over the same scope (e.g.
        # a smoothing sum over literal indicators paired with a bare
        # leaf): treat the leaf side as an identity-weighted trivial sum
        if (in1 and isinstance(l2, SumLayer)) or (in2 and isinstance(l1, SumLayer)):
            ins1 = [l1] if in1 else list(sc1.layer_inputs(l1))
            ins2 = [l2] if in2 else list(sc2.layer_inputs(l2))
            children = list(itertools.product(ins1, ins2))
            missing = [p for p in children if p not in pair_val]
            if missing:
                stack.extend(missing)
                continue
            comp = _assemble_sum_comp(
                [pair_val[p] for p in children],
                1 if in1 else l1.arity,
                1 if in2 else l2.arity,
            )
            pair_val[pair] = sum_fn(l1, l2, comp)
            stack.pop()
            continue
        if in1 or in2:
            raise NotImplementedError(
                "Cross-circuit queries cannot pair an input layer with "
                f"a {type(l2 if in1 else l1).__name__}"
            )
        if isinstance(l1, SumLayer) and isinstance(l2, SumLayer):
            children = list(itertools.product(sc1.layer_inputs(l1), sc2.layer_inputs(l2)))
            missing = [p for p in children if p not in pair_val]
            if missing:
                stack.extend(missing)
                continue
            comp = _assemble_sum_comp([pair_val[p] for p in children], l1.arity, l2.arity)
            pair_val[pair] = sum_fn(l1, l2, comp)
            stack.pop()
            continue
        if type(l1) is not type(l2) or not isinstance(l1, (HadamardLayer, KroneckerLayer)):
            raise NotImplementedError(
                f"Cross-circuit queries cannot pair {type(l1).__name__} with "
                f"{type(l2).__name__}"
            )
        ins1 = list(sc1.layer_inputs(l1))
        ins2 = list(sc2.layer_inputs(l2))
        by_scope: dict[Any, tuple[int, Layer]] = {}
        for j, c2 in enumerate(ins2):
            key = tuple(sorted(sc2.layer_scope(c2)))
            if key in by_scope:
                raise NotImplementedError(
                    "Cross-circuit queries require distinct child scopes per product layer"
                )
            by_scope[key] = (j, c2)
        matched: list[tuple[int, int, _Pair]] = []
        for i, c1 in enumerate(ins1):
            key = tuple(sorted(sc1.layer_scope(c1)))
            if key not in by_scope:
                raise NotImplementedError(
                    "Cross-circuit queries require identically aligned scope "
                    f"partitions; no match for child scope {key}"
                )
            j, c2 = by_scope[key]
            matched.append((i, j, (c1, c2)))
        missing = [p for _, _, p in matched if p not in pair_val]
        if missing:
            stack.extend(missing)
            continue
        if isinstance(l1, HadamardLayer):
            acc: _Val | None = None
            for _, _, p in matched:
                v = pair_val[p]
                acc = v if acc is None else tuple(op(a, b) for op, a, b in zip(ops, acc, v))
            assert acc is not None
            pair_val[pair] = acc
        else:  # Kronecker
            pair_val[pair] = _assemble_kron(
                [(i, j, pair_val[p]) for i, j, p in matched],
                l1.arity,
                l2.arity,
                l1.num_input_units,
                l2.num_input_units,
                ops,
                inits,
            )
        stack.pop()
    return pair_val


# --------------------------------------------------------------------------
# the (log P, r) cross-expectation carriers, on the host
# --------------------------------------------------------------------------


def _cross_input(v1: Any, v2: Any, l1: Layer, l2: Layer) -> _Val:
    if _is_gaussian(v1) and _is_gaussian(v2):
        _, mp, sp = v1
        _, mq, sq = v2
        r = (
            -0.5 * np.log(2.0 * np.pi * sq[None, :] ** 2)
            - (sp[:, None] ** 2 + (mp[:, None] - mq[None, :]) ** 2)
            / (2.0 * sq[None, :] ** 2)
        )
        return np.zeros_like(r), r
    _check_input_pair(v1, v2, l1, l2)
    mq = v2 > 0
    with np.errstate(divide="ignore"):
        logt = np.where(mq, np.log(np.where(mq, v2, 1.0)), 0.0)
    p = v1 @ mq.T  # (K1, K2)
    c = v1 @ (mq * logt).T
    with np.errstate(divide="ignore"):
        lp = np.log(p)
    r = np.where(p > 0, c / np.maximum(p, np.finfo(np.float64).tiny), 0.0)
    return lp, r


def _check_input_pair(v1: Any, v2: Any, l1: Layer, l2: Layer) -> None:
    """Raise for leaf pairs the carriers have no closed form for."""
    if _is_gaussian(v1) or _is_gaussian(v2):
        raise NotImplementedError(
            "Cross-circuit queries cannot pair a Gaussian input with a "
            "finite-support input over the same variable"
        )
    if v1.shape[1] != v2.shape[1]:
        raise NotImplementedError(
            f"Paired {type(l1).__name__}/{type(l2).__name__} inputs disagree "
            f"on the state count: {v1.shape[1]} vs {v2.shape[1]}"
        )


def _cross_sum(a: np.ndarray, b: np.ndarray, lp: np.ndarray, r: np.ndarray) -> _Val:
    """Two-stage reduction of the ``(log P, r)`` composite ``(Ma, Mb)``
    under the p-side weights ``a`` ``(O1, Ma)`` and q-side support/log-
    weights from ``b`` ``(O2, Mb)``. Stage 1 sums q's supported branches
    per p-composite (per-row max shift); stage 2 mixes p's composites
    per output with an exactly-masked shift (a loop over p's output units;
    host-side circuits have modest widths)."""
    mb = b > 0
    with np.errstate(divide="ignore"):
        logb = np.where(mb, np.log(np.where(mb, b, 1.0)), 0.0)
    s1 = lp.max(axis=1, keepdims=True)  # (Ma, 1)
    s1 = np.where(np.isfinite(s1), s1, 0.0)
    e = np.exp(lp - s1)  # zeros where log P = -inf
    p1 = e @ mb.T  # (Ma, O2)
    n1 = (e * r) @ mb.T + e @ (mb * logb).T
    with np.errstate(divide="ignore"):
        lp1 = np.log(p1) + s1
    r1 = np.where(p1 > 0, n1 / np.maximum(p1, np.finfo(np.float64).tiny), 0.0)

    o1, o2 = a.shape[0], b.shape[0]
    lp_out = np.full((o1, o2), -np.inf)
    r_out = np.zeros((o1, o2))
    for i in range(o1):
        rowmask = a[i] > 0
        if not rowmask.any():
            continue
        aw = a[i][rowmask]
        sub_lp = lp1[rowmask]  # (na, O2)
        sub_r = r1[rowmask]
        s2 = sub_lp.max(axis=0)  # (O2,)
        s2f = np.where(np.isfinite(s2), s2, 0.0)
        e2 = np.exp(sub_lp - s2f[None, :])
        p2 = aw @ e2  # (O2,)
        n2 = aw @ (e2 * sub_r)
        with np.errstate(divide="ignore"):
            lp_out[i] = np.log(p2) + s2f
        r_out[i] = np.where(p2 > 0, n2 / np.maximum(p2, np.finfo(np.float64).tiny), 0.0)
    return lp_out, r_out


# --------------------------------------------------------------------------
# the device carriers (device=True): the same math as torch ops
# --------------------------------------------------------------------------
# The host walk is float64 and exact, but its numpy stage-2 loop is slow at
# wide units. ``device=True`` runs the same recursion with these functions
# on the store's device: the traversal stays host Python, every carrier op
# is a torch op, and only the root carriers are read back. Stage 2 of the
# sum reduction is vectorized over p's output units with a masked shift.


def _dev_cross_input_tab(v1: torch.Tensor, v2: torch.Tensor) -> _Val:
    mq = v2 > 0
    logt = torch.where(mq, torch.log(torch.where(mq, v2, 1.0)), 0.0)
    p = v1 @ mq.T.to(v1.dtype)
    c = v1 @ (mq * logt).T.to(v1.dtype)
    lp = torch.log(p)
    tiny = torch.finfo(p.dtype).tiny
    r = torch.where(p > 0, c / p.clamp_min(tiny), 0.0)
    return lp, r


def _dev_cross_input_gauss(mp, sp, mq, sq) -> _Val:
    r = (
        -0.5 * torch.log(2.0 * math.pi * sq[None, :] ** 2)
        - (sp[:, None] ** 2 + (mp[:, None] - mq[None, :]) ** 2) / (2.0 * sq[None, :] ** 2)
    )
    return torch.zeros_like(r), r


def _dev_cross_sum(a: torch.Tensor, b: torch.Tensor, lp: torch.Tensor,
                   r: torch.Tensor) -> _Val:
    tiny = torch.finfo(lp.dtype).tiny
    mb = b > 0
    logb = torch.where(mb, torch.log(torch.where(mb, b, 1.0)), 0.0)
    s1 = lp.amax(dim=1, keepdim=True)
    s1 = torch.where(torch.isfinite(s1), s1, 0.0)
    e = torch.exp(lp - s1)
    mbt = mb.T.to(e.dtype)
    p1 = e @ mbt
    n1 = (e * r) @ mbt + e @ (mb * logb).T.to(e.dtype)
    lp1 = torch.log(p1) + s1
    r1 = torch.where(p1 > 0, n1 / p1.clamp_min(tiny), 0.0)
    # stage 2, vectorized over p's output units with an exactly-masked shift
    am = a > 0  # (O1, Ma)
    lpm = torch.where(am[:, :, None], lp1[None], -math.inf)  # (O1, Ma, O2)
    s2 = lpm.amax(dim=1)
    s2f = torch.where(torch.isfinite(s2), s2, 0.0)
    e2 = torch.exp(lpm - s2f[:, None, :])  # masked rows: exp(-inf) = 0
    p2 = torch.einsum("om,omq->oq", a, e2)
    n2 = torch.einsum("om,omq->oq", a, e2 * torch.where(am[:, :, None], r1[None], 0.0))
    lp_out = torch.log(p2) + s2f
    r_out = torch.where(p2 > 0, n2 / p2.clamp_min(tiny), 0.0)
    return lp_out, r_out


def _device_tables(values: dict, device: torch.device, dtype: torch.dtype) -> dict:
    """The host float64 tables on ``device`` in ``dtype``, moved once."""
    out = {}
    for sl, v in values.items():
        if _is_gaussian(v):
            out[sl] = ("gaussian", torch.as_tensor(v[1], dtype=dtype, device=device),
                       torch.as_tensor(v[2], dtype=dtype, device=device))
        else:
            out[sl] = torch.as_tensor(v, dtype=dtype, device=device)
    return out


def _single_root(sc: Circuit, name: str) -> Layer:
    if len(sc.outputs) != 1:
        raise NotImplementedError(f"{name} supports single-output circuits only")
    return sc.outputs[0]


def _resolve_store(ctx, store) -> dict:
    full = dict(ctx.parameters)
    if store is not None:
        full.update(store)
    return full


def expected_loglikelihood(
    sc_p: Circuit,
    sc_q: Circuit,
    *,
    ctx,
    store_p=None,
    store_q=None,
    check: bool = True,
    device: bool = False,
) -> np.ndarray:
    """Exact ``E_{x ~ p}[log q(x)]`` between two compatible circuits.

    Both circuits must be compiled through ``ctx`` (their parameters are
    read back through its slot state; ``store_p`` / ``store_q`` merge over
    ``ctx.parameters``). Requires ``q`` DETERMINISTIC, verified by
    :func:`is_deterministic` when ``check`` is True (p may be any
    compatible circuit). Returns the ``(K_p, K_q)`` float64 matrix over
    root-unit pairs, each entry the expected log-likelihood of q's
    normalized unit distribution under p's; ``-inf`` where q's support
    misses p's mass. A support double-counting guard raises if q turns out
    non-deterministic at the numbers level even with ``check=False``.

    ``device=True`` runs the carrier recursion as torch ops on the store's
    device in the store's dtype; float64 matches the host path to 1e-9,
    float32 to about 1e-4 nats."""
    if not are_compatible(sc_p, sc_q):
        raise ValueError(
            "Cross-circuit queries require compatible circuits (identical "
            "hierarchical scope partitioning)"
        )
    if check and not is_deterministic(sc_q, ctx=ctx, store=store_q):
        raise ValueError(
            "E_p[log q] is tractable only for deterministic q (every sum's "
            "positively-weighted inputs with disjoint supports); pass "
            "check=False to skip this verification at your own risk"
        )
    # side-specific tables: a layer shared between the two circuits (or the
    # same circuit under two stores) reads p's values on the left, q's on
    # the right
    full_p = _resolve_store(ctx, store_p)
    vp = _materialize_tables(sc_p, ctx, full_p)
    vq = _materialize_tables(sc_q, ctx, _resolve_store(ctx, store_q))

    rel = 1e-6
    if device:
        dev, dt = _store_device(full_p), _store_dtype(full_p)
        # the support-coverage tolerance follows the dtype (float32
        # accumulates about 1e-5 relative)
        rel = 1e-6 if dt == torch.float64 else 1e-4
        dvp, dvq = _device_tables(vp, dev, dt), _device_tables(vq, dev, dt)
        eyes: dict[int, torch.Tensor] = {}

        def input_fn(l1: Layer, l2: Layer) -> _Val:
            v1, v2 = dvp[l1], dvq[l2]
            if _is_gaussian(v1) and _is_gaussian(v2):
                return _dev_cross_input_gauss(v1[1], v1[2], v2[1], v2[2])
            _check_input_pair(v1, v2, l1, l2)
            return _dev_cross_input_tab(v1, v2)

        def _eye(k: int) -> torch.Tensor:
            if k not in eyes:
                eyes[k] = torch.eye(k, dtype=dt, device=dev)
            return eyes[k]

        def sum_fn(l1: Layer, l2: Layer, comp: _Val) -> _Val:
            a = dvp[l1] if isinstance(l1, SumLayer) else _eye(l1.num_output_units)
            b = dvq[l2] if isinstance(l2, SumLayer) else _eye(l2.num_output_units)
            return _dev_cross_sum(a, b, *comp)

        ops = (torch.add, torch.add)
    else:

        def input_fn(l1: Layer, l2: Layer) -> _Val:
            return _cross_input(vp[l1], vq[l2], l1, l2)

        def sum_fn(l1: Layer, l2: Layer, comp: _Val) -> _Val:
            # a leaf paired against a (deeper) sum acts as an identity-
            # weighted trivial sum on its side
            a = vp[l1] if isinstance(l1, SumLayer) else np.eye(l1.num_output_units)
            b = vq[l2] if isinstance(l2, SumLayer) else np.eye(l2.num_output_units)
            return _cross_sum(a, b, *comp)

        ops = (np.add, np.add)

    pv = _pairwise_walk(sc_p, sc_q, input_fn, sum_fn, ops=ops, inits=(0.0, 0.0))
    rp = _single_root(sc_p, "expected_loglikelihood")
    rq = _single_root(sc_q, "expected_loglikelihood")
    lp_root, r_root = pv[(rp, rq)]
    if device:
        lp_root, r_root = _host(lp_root), _host(r_root)
    logzp = _log_partition(sc_p, vp)[rp]  # (K1,)
    logzq = _log_partition(sc_q, vq)[rq]  # (K2,)
    tol = rel * np.maximum(1.0, np.abs(logzp))[:, None]
    if (lp_root > logzp[:, None] + tol).any():
        raise ValueError(
            "Support double-counting detected (the restricted mass exceeds "
            "p's partition function): q is not deterministic, so E_p[log q] "
            "is intractable for this pair"
        )
    covered = lp_root >= logzp[:, None] - tol
    return np.where(covered, r_root - logzq[None, :], -np.inf)


def cross_circuit_kl(
    sc_p: Circuit,
    sc_q: Circuit,
    *,
    ctx,
    store_p=None,
    store_q=None,
    check: bool = True,
    device: bool = False,
) -> np.ndarray:
    """Exact ``KL(p || q)`` between two compatible DETERMINISTIC circuits
    with different structures: ``-H(p) - E_p[log q]``, the entropy from
    :class:`~cirkit_tpu_torch.backend.torch.entropy.EntropyQuery` (exact for
    deterministic p) and the cross term from :func:`expected_loglikelihood`.
    ``+inf`` where q's support misses p's. Returns the ``(K_p, K_q)``
    matrix over root-unit pairs. Both circuits must be compiled through
    ``ctx`` under the 'lse-sum' semiring. For two parameterizations of ONE
    circuit prefer ``KLDivergenceQuery`` (one device pass, batch evidence
    support)."""
    if check and not is_deterministic(sc_p, ctx=ctx, store=store_p):
        raise ValueError(
            "cross_circuit_kl is exact only for deterministic p (its "
            "entropy term); pass check=False to skip this verification"
        )
    ell = expected_loglikelihood(
        sc_p, sc_q, ctx=ctx, store_p=store_p, store_q=store_q, check=check, device=device,
    )
    cc_p = ctx.compile(sc_p)
    ent = _host(EntropyQuery(cc_p)(store=_resolve_store(ctx, store_p)))[0]  # (K1,)
    return -ent[:, None] - ell


# --------------------------------------------------------------------------
# determinism verification (exact for finite-support leaves)
# --------------------------------------------------------------------------


def is_deterministic(
    sc: Circuit,
    *,
    ctx,
    store=None,
    return_report: bool = False,
):
    """Whether the circuit is DETERMINISTIC under its current parameters:
    at every sum unit, the positively-weighted input composites have
    pairwise disjoint supports. Exact for circuits with finite-support
    leaves: the walker pairs the circuit with itself and carries boolean
    support-overlap matrices bottom-up (leaves overlap where both state
    tables are positive, Hadamard/Kronecker products overlap iff ALL
    scope-matched factor pairs do, sums union their positively-weighted
    branches). Gaussian leaves always overlap (full support), so sums over
    Gaussian-leaf scopes are deterministic only with at most one positive
    weight per row. ``return_report=True`` also returns the violating
    layers and unit rows."""
    values = _materialize_tables(sc, ctx, _resolve_store(ctx, store))
    violations: list[tuple[Layer, np.ndarray]] = []

    def input_fn(l1: Layer, l2: Layer) -> _Val:
        v1, v2 = values[l1], values[l2]
        if _is_gaussian(v1) and _is_gaussian(v2):
            return (np.ones((l1.num_output_units, l2.num_output_units), bool),)
        if _is_gaussian(v1) or _is_gaussian(v2):
            raise NotImplementedError(
                "Determinism verification cannot pair a Gaussian input with "
                "a finite-support input over the same variable"
            )
        if v1.shape[1] != v2.shape[1]:
            raise NotImplementedError(
                "Determinism verification requires same-scope inputs to "
                "agree on the state count"
            )
        return (((v1 > 0).astype(np.float64) @ (v2 > 0).T.astype(np.float64)) > 0,)

    def sum_fn(l1: Layer, l2: Layer, comp: _Val) -> _Val:
        (ov,) = comp  # (Ma, Mb) bool
        ma = (values[l1] > 0 if isinstance(l1, SumLayer)
              else np.eye(l1.num_output_units, dtype=bool))  # (O1, Ma)
        mb = (values[l2] > 0 if isinstance(l2, SumLayer)
              else np.eye(l2.num_output_units, dtype=bool))
        if l1 is l2:
            off = ov & ~np.eye(ov.shape[0], dtype=bool)
            hits = ma.astype(np.float64) @ off.astype(np.float64)  # (O, Mb)
            bad = ((hits > 0) & ma).any(axis=1)  # (O,)
            if bad.any():
                violations.append((l1, np.flatnonzero(bad)))
        out = (ma.astype(np.float64) @ ov.astype(np.float64) @ mb.T.astype(np.float64)) > 0
        return (out,)

    _pairwise_walk(sc, sc, input_fn, sum_fn, ops=(np.logical_and,), inits=(True,))
    ok = not violations
    return (ok, violations) if return_report else ok


# --------------------------------------------------------------------------
# Monte Carlo estimators: ANY same-scope pair, no determinism required
# --------------------------------------------------------------------------


def _mc_log_terms(cc_p, cc_q, store_p, store_q, num_samples, generator, batch_size):
    """Per-sample normalized (log p(x), log q(x)) for x ~ p, float64 on the
    host, drawn in fixed-size rounds, each round read back once."""
    if set(cc_p.scope) != set(cc_q.scope):
        raise ValueError(
            f"Monte Carlo cross-circuit estimators need identical scopes, "
            f"found {sorted(cc_p.scope)} vs {sorted(cc_q.scope)}"
        )
    if num_samples < 2:
        raise ValueError(f"num_samples must be >= 2, found {num_samples}")
    if store_p is None:
        store_p = cc_p.default_store
    if store_q is None:
        store_q = cc_q.default_store
    if store_p is None or store_q is None:
        raise ValueError("No parameter store bound; pass store_p=/store_q=")
    generator = _generator(generator)

    sq = SamplingQuery(cc_p)
    b = min(batch_size, num_samples)
    rounds: list[np.ndarray] = []
    drawn = 0
    probe = None
    with torch.inference_mode():
        while drawn < num_samples:
            x, _ = sq(b, generator=generator, store=store_p)
            if probe is None:
                probe = x[:1]
            lp = cc_p(store_p, x).reshape(b, -1)[:, 0]
            lq = cc_q(store_q, x).reshape(b, -1)[:, 0]
            rounds.append(_host(torch.stack([lp, lq])))
            drawn += b
        logz = [
            float(_host(IntegrateQuery(cc)(probe, integrate_vars=Scope(cc.scope),
                                            store=st)).reshape(-1)[0])
            for cc, st in ((cc_p, store_p), (cc_q, store_q))
        ]
    lp, lq = np.concatenate(rounds, axis=1)[:, :num_samples]
    return lp - logz[0], lq - logz[1]


def _support_violated(lq: np.ndarray) -> bool:
    """True when q assigned zero density to a drawn sample. Log-space
    forwards may floor ``log 0`` at a large negative value rather than
    ``-inf``, so "zero" means any value at or beyond -1e29, far below any
    real normalized log density."""
    return bool(np.any(~np.isfinite(lq)) or np.any(lq <= -1e29))


def expected_loglikelihood_mc(
    cc_p,
    cc_q,
    *,
    num_samples: int = 4096,
    generator: torch.Generator | None = None,
    store_p=None,
    store_q=None,
    batch_size: int = 1024,
) -> tuple[float, float]:
    """Monte Carlo ``E_{x ~ p}[log q(x)]`` for ANY same-scope compiled pair.

    Draws ``num_samples`` ancestral samples of ``p`` (``SamplingQuery``) in
    ``batch_size`` rounds, evaluates both NORMALIZED log densities (each log
    Z from ``IntegrateQuery``), and returns ``(estimate, standard_error)``.
    Returns ``(-inf, nan)`` when q assigns zero density to a drawn sample.
    Samples come from p's root distribution and both circuits are read at
    output unit 0. ``generator`` (a ``torch.Generator``) seeds the draws."""
    lp, lq = _mc_log_terms(cc_p, cc_q, store_p, store_q, num_samples, generator, batch_size)
    if _support_violated(lq):
        return float("-inf"), float("nan")
    return float(lq.mean()), float(lq.std(ddof=1) / math.sqrt(len(lq)))


def kl_monte_carlo(
    cc_p,
    cc_q,
    *,
    num_samples: int = 4096,
    generator: torch.Generator | None = None,
    store_p=None,
    store_q=None,
    batch_size: int = 1024,
) -> tuple[float, float]:
    """Monte Carlo ``KL(p || q)`` for ANY same-scope compiled pair:
    ``mean(log p(x) - log q(x))`` over ancestral samples ``x ~ p``, both
    terms normalized. Returns ``(estimate, standard_error)``; ``(+inf,
    nan)`` when q misses p's support at a drawn sample. Pairing a circuit
    and store with themselves gives exactly ``(0.0, 0.0)``."""
    lp, lq = _mc_log_terms(cc_p, cc_q, store_p, store_q, num_samples, generator, batch_size)
    if _support_violated(lq):
        return float("inf"), float("nan")
    d = lp - lq
    return float(d.mean()), float(d.std(ddof=1) / math.sqrt(len(d)))
