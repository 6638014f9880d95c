"""Exact Shannon entropy and KL divergence of (deterministic) circuits, and
the Rényi-2 entropy of any circuit the product operator takes.

The counterpart of ``cirkit_tpu/backend/jax/entropy.py``. For a smooth,
decomposable, deterministic circuit the entropy of the normalized
distribution follows in one bottom-up pass (Vergari et al., "A
Compositional Atlas of Tractable Circuit Operations", NeurIPS 2021): a leaf
unit contributes its closed-form entropy, a product adds its children's, and
a deterministic sum gives ``H_o = sum_m pi_m H_m - sum_m pi_m log pi_m``
with ``pi_m = w_om Z_m / Z_o``. On a non-deterministic circuit the same
recursion returns the joint entropy of (latent parse, x), an upper bound on
``H(x)``.

The pass carries per-unit statistics through the evaluation plan in (F, B,
K) layout, and every mixture reduction is an exp-weighted ``torch.bmm``
in the store's type (the JAX package's XLA einsums at HIGHEST precision),
so no (F, B, O, M) score tensor is formed. With evidence, observed leaves
contribute ``(log p(x_v), 0)`` and the result is the per-sample posterior
entropy ``H(X_free | x_obs)``. No kernel runs here, except through
:func:`renyi2_entropy`, whose product circuit's integrals run the sum
layers' forward kernels.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.layers import (
    TorchConstantInputLayer,
    TorchHadamardLayer,
    TorchInputLayer,
    TorchKroneckerLayer,
    TorchSumLayer,
)
from cirkit_tpu_torch.backend.torch.optimized import (
    TorchCPTLayer,
    TorchTensorDotLayer,
    TorchTuckerLayer,
)
from cirkit_tpu_torch.backend.torch.parameters import Store
from cirkit_tpu_torch.backend.torch.queries import (
    IntegrateQuery,
    Query,
    _bound_store,
    _evidence_to_mask,
    _num_vars,
    _scope_vars,
    _store_device,
    _to_device,
    _tucker_comb,
)
from cirkit_tpu_torch.backend.torch.semiring import LSESumSemiring
from cirkit_tpu_torch.backend.torch.utils import safelog


def _check_circuit(circuit: TorchCircuit, name: str) -> None:
    if not (circuit.properties.smooth and circuit.properties.decomposable):
        raise ValueError(
            f"The circuit must be smooth and decomposable, but found {circuit.properties}"
        )
    if circuit.semiring is not LSESumSemiring:
        raise ValueError(
            f"{name} requires a circuit compiled under the 'lse-sum' semiring, "
            f"found {circuit.semiring.__name__}"
        )


def _batch(cc: TorchCircuit, x, evidence_mask, device: torch.device):
    """The (B, D) data and evidence mask of a statistic pass: one all-free
    row without ``x``."""
    num_vars = _num_vars(cc)
    if x is None:
        if evidence_mask is not None:
            raise ValueError("evidence_mask requires x")
        return (torch.zeros((1, num_vars), dtype=torch.int64, device=device),
                torch.zeros((1, num_vars), dtype=torch.bool, device=device))
    if evidence_mask is None:
        raise ValueError("x requires an evidence_mask")
    x = _to_device(x, device)
    mask = _evidence_to_mask(cc, evidence_mask, x.shape[0], device)
    if mask.shape[1] != num_vars:
        raise ValueError(
            f"The circuit scope has {num_vars} variables, but the mask covers {mask.shape[1]}"
        )
    return x, mask


def _finite_max(x: torch.Tensor) -> torch.Tensor:
    """The (F, B, 1) max over the mixture axis, clamped to the finite range."""
    info = torch.finfo(x.dtype)
    return x.amax(dim=2, keepdim=True).clamp(info.min, info.max)


def _wsum(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_m a[f, b, m] w[f, o, m]``: (F, B, M) x (F, O, M) -> (F, B, O)."""
    return torch.bmm(a, w.transpose(1, 2))


class EntropyQuery(Query):
    """Shannon entropy (nats) of the circuit's normalized distribution:
    exact on deterministic circuits, the latent upper bound ``H(x) +
    H(parse | x)`` otherwise. With ``x`` and ``evidence_mask`` (True =
    observed; Scope specs accepted) it returns per-sample posterior
    entropies ``H(X_free | x_obs)``."""

    def __init__(self, circuit: TorchCircuit) -> None:
        _check_circuit(circuit, "EntropyQuery")
        self._circuit = circuit

    def __call__(self, x=None, *, evidence_mask=None, store: Store | None = None,
                 return_log_partition: bool = False):
        """Without ``x``: the (O, K) entropy of each root head. With ``x``
        (B, D) and ``evidence_mask``: the (B, O, K) posterior entropies.
        ``return_log_partition=True`` also returns the matching log
        normalizer ``log Z``, of the same shape."""
        cc = self._circuit
        with torch.inference_mode():
            store = _bound_store(cc, store)
            xx, mask = _batch(cc, x, evidence_mask, _store_device(store))
            runs = cc.__dict__.setdefault("_stat_runs", {})
            if "entropy" not in runs:
                runs["entropy"] = _build_stat_run(cc, "EntropyQuery", _entropy_leaf,
                                                  _entropy_mix)
            lz, hh = runs["entropy"](store, xx, mask)
            if x is None:
                hh, lz = hh[0], lz[0]
            return (hh, lz) if return_log_partition else hh


def _mix(lz: torch.Tensor, hh: torch.Tensor, w: torch.Tensor):
    """One deterministic-sum reduction: composite ``(log Z_m, H_m)`` pairs
    (F, B, M) and weight rows (F, O, M) -> output pairs (F, B, O).

    ``log Z_o = lse_m(log w_om + lz_m)`` and ``H_o = sum_m pi_m H_m - sum_m
    pi_m log pi_m`` with ``log pi_m = log w_om + lz_m - log Z_o``. After the
    per-(f, b) max shift, with ``e = exp(lz - shift)`` and ``A_o = sum_m
    w_om e_m``, every ``sum_m pi_m (...)`` is an exp-weighted matmul:
    ``H_o = (sum_m w e H - sum_m (w log w) e - sum_m w e lz) / A_o + log
    Z_o``."""
    shift = _finite_max(lz)
    e = torch.exp(lz - shift)  # zeros where lz = -inf
    elz = torch.where(e > 0, e * lz, 0.0)  # guards every 0 * (-inf)
    wlw = torch.where(w > 0, w * safelog(w), 0.0)
    a = _wsum(e, w)  # Z_o / exp(shift)
    lzo = safelog(a) + shift
    num = _wsum(e * hh, w) - _wsum(e, wlw) - _wsum(elz, w)
    safe_a = a.clamp_min(torch.finfo(a.dtype).tiny)
    return lzo, torch.where(a > 0, num / safe_a + lzo, 0.0)


def _entropy_leaf(layer: TorchInputLayer, st: Store, xin: torch.Tensor, mrow: torch.Tensor):
    obs = layer(st, xin)  # (F, B, K) log-likelihoods
    lz = torch.where(mrow, obs, layer.integrate(st)[:, None, :])
    hh = torch.where(mrow, torch.zeros_like(obs), layer.unit_entropy(st)[:, None, :])
    return lz, hh


def _entropy_mix(stats, layer, st: Store):
    return _mix(*stats, layer.weight(st))


def _build_stat_run(
    cc: TorchCircuit, name: str, leaf_fn: Callable, mix_fn: Callable
) -> Callable:
    """The bottom-up statistic pass over the evaluation plan.

    A statistic is a tuple of (F, B, K) tensors per plan entry that adds
    componentwise across product children and composite digits (log
    measures, entropies and KL terms alike, by disjoint scopes) and reduces
    at sum-style entries through ``mix_fn(stats, layer, st)`` over composite
    stats (F, B, M). ``leaf_fn(layer, st, xin, mrow)`` seeds the input
    entries (``mrow`` (F, B, 1), True = observed). TensorDot entries split
    into one dense mix per q block here, so ``mix_fn`` only meets plain (O,
    M) mixtures. Returns ``run(st, x, mask)`` -> the (B, O, K) root stats."""
    entries = cc._entries
    for entry in entries:
        layer = entry.layer
        if isinstance(layer, TorchConstantInputLayer) or not isinstance(
            layer, (TorchInputLayer, TorchHadamardLayer, TorchKroneckerLayer, TorchTuckerLayer,
                    TorchCPTLayer, TorchSumLayer, TorchTensorDotLayer)
        ):
            raise NotImplementedError(f"{name} is not supported for {type(layer).__name__}")
        if isinstance(layer, TorchInputLayer) and layer.num_variables != 1:
            raise NotImplementedError(f"{name} of multivariate input layers is not supported")

    def run(st, xx: torch.Tensor, mk: torch.Tensor):
        stats: list[tuple[torch.Tensor, ...]] = []
        for entry in entries:
            layer = entry.layer
            if isinstance(layer, TorchInputLayer):
                mrow = mk[:, _scope_vars(layer, mk.device)].t()[:, :, None]  # (F, B, 1)
                stats.append(leaf_fn(layer, st, cc.entry_input(entry, xx, stats), mrow))
                continue
            g = tuple(cc.entry_input(entry, xx, [s[i] for s in stats])
                      for i in range(len(stats[0])))  # each (F, H, B, K)
            if isinstance(layer, TorchHadamardLayer):
                stats.append(tuple(a.sum(dim=1) for a in g))
            elif isinstance(layer, TorchKroneckerLayer):
                stats.append(tuple(_tucker_comb(a) for a in g))
            elif isinstance(layer, TorchTuckerLayer):
                stats.append(mix_fn(tuple(_tucker_comb(a) for a in g), layer, st))
            elif isinstance(layer, TorchCPTLayer):
                stats.append(mix_fn(tuple(a.sum(dim=1) for a in g), layer, st))
            elif isinstance(layer, TorchSumLayer):
                f, h, b, k = g[0].shape
                stats.append(mix_fn(tuple(a.transpose(1, 2).reshape(f, b, h * k) for a in g),
                                    layer, st))
            else:  # TensorDot: the child composite index is j * Kq + q
                f, _, b, m = g[0].shape
                kj = layer._num_contract_units
                r = tuple(a[:, 0].reshape(f, b, kj, m // kj) for a in g)
                outs = [mix_fn(tuple(a[:, :, :, q] for a in r), layer, st)
                        for q in range(m // kj)]
                stats.append(tuple(torch.stack([o[i] for o in outs], dim=2).reshape(f, b, -1)
                                   for i in range(len(outs[0]))))
        return tuple(cc.output_stack([s[i] for s in stats]).transpose(0, 1)
                     for i in range(len(stats[0])))

    return run


class KLDivergenceQuery(Query):
    """KL(p || q) between two parameterizations of the same compiled
    circuit, in one bottom-up pass. Exact when the circuit is deterministic;
    otherwise the KL of the joint (parse, x) distributions, an upper bound
    on ``KL(p(x) || q(x))``. Where q's support misses p's the result is
    ``+inf``. With evidence it compares the posteriors ``KL(p(X_free |
    x_obs) || q(X_free | x_obs))`` per sample."""

    def __init__(self, circuit: TorchCircuit) -> None:
        _check_circuit(circuit, "KLDivergenceQuery")
        self._circuit = circuit

    def __call__(self, store_p: Store, store_q: Store, x=None, *, evidence_mask=None):
        """Without ``x``: the (O, K) KL per root head. With ``x`` (B, D) and
        ``evidence_mask``: the (B, O, K) posterior KL per sample."""
        cc = self._circuit
        with torch.inference_mode():
            store_p = cc.restrict_store(store_p)
            store_q = cc.restrict_store(store_q)
            xx, mask = _batch(cc, x, evidence_mask, _store_device(store_p))
            runs = cc.__dict__.setdefault("_stat_runs", {})
            if "kl" not in runs:
                runs["kl"] = _build_stat_run(cc, "KLDivergenceQuery", _kl_leaf, _kl_mix)
            kl = runs["kl"]((store_p, store_q), xx, mask)[2]
            return kl[0] if x is None else kl


def renyi2_entropy(cc: TorchCircuit, *, ctx, store: Store | None = None, x=None,
                   evidence_mask=None) -> torch.Tensor:
    """Collision (Rényi order-2) entropy ``H_2 = -log sum_x p(x)^2`` of the
    normalized circuit distribution, exact for any circuit the product
    operator takes (smooth, structured-decomposable, compatible with
    itself), deterministic or not: it integrates ``ctx.multiply(cc, cc)``,
    so it complements :class:`EntropyQuery` where the Shannon recursion is
    only a bound. With ``x``/``evidence_mask``, the per-sample posterior
    collision entropies ``-log sum p(x_free | x_obs)^2``. Returns (O, K)
    without ``x``, (B, O, K) with; nats."""
    sq = cc.__dict__.get("_squared_cc")
    if sq is None:
        sq = cc.__dict__["_squared_cc"] = ctx.multiply(cc, cc)
    full = {**ctx.parameters, **(store or {})}
    with torch.no_grad():
        xx, mask = _batch(cc, x, evidence_mask, _store_device(full))
    # integrate the free variables of p^2 and of p: H2 = -(log int p~^2 - 2
    # log int p~), per-sample masks
    l2 = IntegrateQuery(sq)(xx, integrate_vars=~mask, store=full)
    lz = IntegrateQuery(cc)(xx, integrate_vars=~mask, store=full)
    h2 = -(l2 - 2.0 * lz)
    return h2[0] if x is None else h2


def _kl_mix(stats, layer, st):
    """One sum reduction of the KL carrier: composite (log Z^p, log Z^q, KL)
    triples (F, B, M) under both weight rows (F, O, M) -> output triples.

    ``KL_o = sum_m pi^p_m [KL_m + log pi^p_m - log pi^q_m]`` with ``log pi_m
    = log w_om + lz_m - lz_o``: exp-weighted matmuls after the p-side max
    shift; ``- lz^p_o + lz^q_o`` leaves the sum since ``sum_m pi^p_m = 1``."""
    lzp, lzq, kl = stats
    wp, wq = layer.weight(st[0]), layer.weight(st[1])
    shift = _finite_max(lzp)
    e = torch.exp(lzp - shift)  # zeros where lzp = -inf
    a = _wsum(e, wp)
    lzpo = safelog(a) + shift
    shift_q = _finite_max(lzq)
    lzqo = safelog(_wsum(torch.exp(lzq - shift_q), wq)) + shift_q
    # e * (KL_m + lzp - lzq), 0 where the p-measure vanishes; a gap in q's
    # support (lzq = -inf where e > 0) gives +inf, as it should
    t1 = torch.where(e > 0, e * (kl + lzp - lzq), 0.0)
    wdiff = torch.where(wp > 0, wp * (safelog(wp) - safelog(wq)), 0.0)
    safe_a = a.clamp_min(torch.finfo(a.dtype).tiny)
    klo = torch.where(a > 0, (_wsum(t1, wp) + _wsum(e, wdiff)) / safe_a - lzpo + lzqo, 0.0)
    return lzpo, lzqo, klo


def _kl_leaf(layer: TorchInputLayer, st, xin: torch.Tensor, mrow: torch.Tensor):
    sp, sq = st
    obs_p = layer(sp, xin)
    lzp = torch.where(mrow, obs_p, layer.integrate(sp)[:, None, :])
    lzq = torch.where(mrow, layer(sq, xin), layer.integrate(sq)[:, None, :])
    kl = torch.where(mrow, torch.zeros_like(obs_p), layer.unit_kl(sp, sq)[:, None, :])
    return lzp, lzq, kl

