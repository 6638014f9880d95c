"""Queries over compiled circuits: marginals, expectations, MAP and sampling.

The counterpart of ``cirkit_tpu/backend/jax/queries.py`` (``:30-1240`` and
``:1382-1911``). Every query is a variant of the circuit's evaluation plan:

- :class:`IntegrateQuery` and :func:`masked_evaluate`: per-sample
  marginals, with input layers selecting their integral under a (B, D)
  mask (and :func:`soft_evaluate` for virtual evidence), under any ported
  semiring (under the signed one every value is a (log|f|, sign) pair);
- :class:`MAPQuery` and :class:`SamplingQuery`: the two-pass routing of
  :func:`_build_routing_run`, an upward pass of values and a downward pass
  that picks one composite index per (entry, fold, sample) at the selected
  output unit only. The arity-2 Tucker entries go through the hand-written
  kernels of :mod:`cirkit_tpu_torch.ops.routing` (``tropical_tucker2`` up,
  ``route_tucker2`` down); the dense mixing sums and CP layers use torch
  compositions. ``MAPQuery(top_k=)`` takes the k-best pass of
  :mod:`cirkit_tpu_torch.backend.torch.topk`. Off the lse-sum semiring,
  :class:`SamplingQuery` takes the dense bottom-up sampler
  (:func:`_sample_dense`: every layer's ``sample`` hook up, the selected
  rows down);
- :class:`ExpectationQuery` and :func:`mutual_information`: posterior
  statistics from the offset-gradient responsibilities, one forward and one
  backward through the kernels (the weights are not differentiated).

Randomness comes from an explicit ``torch.Generator`` (``generator=``,
where the JAX package takes ``key=``): a sampling call draws one int64 seed
per plan entry from it, so one generator seed reproduces the same draws.
MAP and sampling run under ``torch.inference_mode()``.

With a ``mesh`` (a ``torch.distributed`` DeviceMesh with a ``model`` axis)
MAP and the lse-sum sampling route on the ranks' unit shards of the store
(:mod:`cirkit_tpu_torch.parallel.tensor`): the kernels run on local widths,
each sharded entry's activations are all-gathered after it, and the
downward choice at a sharded entry is made by the shard that owns the
selected unit (a masked max of the choices, a masked sum of the selected
weight rows, over the model axis). Only MAP splits its batch over the
``data`` axis; sampling runs the whole batch on every rank, so its draws
are the single-device draws from the same seed.
"""

from __future__ import annotations

from abc import ABC
from collections.abc import Callable, Sequence
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed

from cirkit_tpu_torch.backend.torch.circuit import (
    ModuleFn,
    TorchCircuit,
    _pad_rows,
    _slice_rows,
)
from cirkit_tpu_torch.backend.torch.layers import (
    TorchBinomialLayer,
    TorchCategoricalLayer,
    TorchConstantInputLayer,
    TorchEmbeddingLayer,
    TorchHadamardLayer,
    TorchInputLayer,
    TorchKroneckerLayer,
    TorchLayer,
    TorchSumLayer,
    tmap,
)
from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer, TorchTuckerLayer
from cirkit_tpu_torch.backend.torch.parameters import (
    Store,
    TorchMatMulParameter,
    TorchParameter,
)
from cirkit_tpu_torch.backend.torch.semiring import LSESumSemiring
from cirkit_tpu_torch.backend.torch.utils import safelog
from cirkit_tpu_torch.ops.routing import (
    gumbel_argmax,
    max_plus,
    route_tucker2,
    tropical_tucker2,
    tucker_comb,
)
from cirkit_tpu_torch.utils.scope import Scope

MaskSpec = torch.Tensor | np.ndarray | Scope | Sequence[Scope]


class Query(ABC):
    """A query object over a compiled circuit."""


# --------------------------------------------------------------------------- #
# Helpers
# --------------------------------------------------------------------------- #


def _bound_store(cc: TorchCircuit, store: Store | None) -> dict[str, torch.Tensor]:
    if store is None:
        store = cc.default_store
        if store is None:
            raise ValueError("No parameter store bound; pass store=...")
    return cc.restrict_store(store)


def _store_device(store: Store) -> torch.device:
    return next(iter(store.values())).device


def _to_device(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device=device)


def _scope_vars(layer: TorchInputLayer, device: torch.device) -> torch.Tensor:
    """The (F,) variable of each fold of a univariate input layer."""
    return torch.as_tensor(layer.scope_idx[:, 0], device=device)


def _num_vars(cc: TorchCircuit) -> int:
    return max(cc.scope) + 1


def _generator(generator: torch.Generator | None) -> torch.Generator:
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    return generator


def _device_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _store_dtype(store: Store) -> torch.dtype:
    """The real dtype of a store's floating-point slots."""
    return next(v.dtype for v in store.values() if v.dtype.is_floating_point)


# --------------------------------------------------------------------------- #
# Masked and soft evaluation
# --------------------------------------------------------------------------- #


def masked_leaf_select(layer: TorchLayer, store: Store, out: torch.Tensor, mask: torch.Tensor):
    """``where(mask-at-scope, integral, out)`` for an input layer: the
    masked-integrate select shared by every marginalization consumer
    (IntegrateQuery, missing-data training). ``mask`` is (B, D) with True =
    marginalize this variable. Non-input (and empty-scope) layers pass
    through; multivariate input layers raise."""
    if not isinstance(layer, TorchInputLayer) or layer.num_variables == 0:
        return out
    if layer.num_variables > 1:
        raise NotImplementedError("Integration of multivariate input layers is not supported")
    m = mask[:, _scope_vars(layer, mask.device)].t()[:, :, None]  # (F, B, 1)
    # a tensor, or the signed semiring's (log|f|, sign) pair
    return tmap(lambda iz, o: torch.where(m, iz[:, None, :], o), layer.integrate(store), out)


def offset_module_fn(
    offsets: dict[int, torch.Tensor], missing: torch.Tensor | None = None
) -> ModuleFn:
    """The per-layer evaluation of the offset trick behind EM's E-step and
    :class:`ExpectationQuery`: each input layer's log-output, marginalized
    where ``missing`` (B, D) is True (:func:`masked_leaf_select`), plus the
    zero offset ``offsets[id(layer)]`` of that layer. The gradient of the
    root log-likelihood with respect to an offset is the posterior
    responsibility of each unit (its expected flow)."""

    def module_fn(layer: TorchLayer, st: Store, xin, *, plain: bool = False):
        out = TorchCircuit.call_layer(layer, st, xin, plain=plain)
        if missing is not None:
            out = masked_leaf_select(layer, st, out, missing)
        off = offsets.get(id(layer))
        return out if off is None else out + off

    return module_fn


def masked_evaluate(
    cc: TorchCircuit, store: Store, x: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """(B, O, K) log-likelihoods with the ``mask``-ed (True) variables
    marginalized out: the :class:`IntegrateQuery` evaluation as a plain
    function, differentiable, so training losses (missing-data MLE) compose
    it. ``mask`` is a (B, D) boolean tensor; entries of ``x`` under the mask
    are ignored."""

    def layer_fn(layer: TorchLayer, s: Store, xin: torch.Tensor) -> torch.Tensor:
        return masked_leaf_select(layer, s, layer(s, xin), mask)

    return cc.evaluate(store, x, module_fn=layer_fn)


def _leaf_support_size(layer: TorchLayer) -> int | None:
    """Finite-support size of an input layer, None if continuous."""
    if isinstance(layer, TorchCategoricalLayer):
        return layer.num_categories
    if isinstance(layer, TorchBinomialLayer):
        return layer.total_count + 1
    if isinstance(layer, TorchEmbeddingLayer):
        return layer.num_states
    return None


def _variable_supports(cc: TorchCircuit) -> np.ndarray:
    """Per-variable finite support sizes (D,): -1 for variables covered by a
    continuous leaf, -2 for variables with no input layer."""
    supports = np.full(_num_vars(cc), -2, dtype=np.int64)
    for entry in cc._entries:
        layer = entry.layer
        if not isinstance(layer, TorchInputLayer) or layer.num_variables == 0:
            continue
        s = _leaf_support_size(layer)
        for v in layer.scope_idx[:, 0]:
            supports[int(v)] = max(supports[int(v)], -1 if s is None else s)
    return supports


def soft_leaf_select(
    layer: TorchLayer, store: Store, out: torch.Tensor, soft_mask: torch.Tensor,
    logw: torch.Tensor,
):
    """Virtual (soft) evidence for an input layer: where ``soft_mask`` (B, D)
    is True at the layer's variable, the leaf contributes ``log sum_s w(s)
    f(s)`` for the per-state log-weights ``logw`` (B, D, S) (a shorter S pads
    with -inf, a longer one truncates). Computed as a max-shifted contraction
    against the leaf's normalized state table times its integral, so it is
    exact under both the lse-sum and sum-product semirings. Continuous
    leaves pass through (the query validates soft variables away from
    them)."""
    if not isinstance(layer, TorchInputLayer) or layer.num_variables == 0:
        return out
    if layer.num_variables > 1:
        raise NotImplementedError("Soft evidence on multivariate input layers is not supported")
    if _leaf_support_size(layer) is None:
        return out
    v = _scope_vars(layer, soft_mask.device)
    sm = soft_mask[:, v].t()[:, :, None]
    sd = layer.state_distribution(store)  # (F, K, S)
    iz = layer.integrate(store)  # (F, K)
    lw = logw[:, v, :].transpose(0, 1).to(sd.dtype)  # (F, B, S')
    s = sd.shape[2]
    if lw.shape[2] < s:
        lw = torch.nn.functional.pad(lw, (0, s - lw.shape[2]), value=-float("inf"))
    else:
        lw = lw[:, :, :s]
    # the finite floor keeps rows of zero weight everywhere from NaN
    m = lw.amax(dim=2).clamp_min(-1e30)  # (F, B)
    val = torch.einsum("fbs,fks->fbk", torch.exp(lw - m[:, :, None]), sd)
    logv = safelog(val) + m[:, :, None]
    sem = layer.semiring
    weighted = sem.mul(sem.map_from(logv, LSESumSemiring), tmap(lambda t: t[:, None, :], iz))
    return tmap(lambda w, o: torch.where(sm, w, o), weighted, out)


def soft_evaluate(
    cc: TorchCircuit,
    store: Store,
    x: torch.Tensor,
    mask: torch.Tensor,
    soft_mask: torch.Tensor,
    logw: torch.Tensor,
) -> torch.Tensor:
    """(B, O, K) log-likelihoods with the ``mask``-ed variables marginalized
    and the ``soft_mask``-ed variables observed as virtual evidence with
    per-state log-weights ``logw`` (B, D, S)."""

    def layer_fn(layer: TorchLayer, s: Store, xin: torch.Tensor) -> torch.Tensor:
        out = soft_leaf_select(layer, s, layer(s, xin), soft_mask, logw)
        return masked_leaf_select(layer, s, out, mask)

    return cc.evaluate(store, x, module_fn=layer_fn)


# --------------------------------------------------------------------------- #
# IntegrateQuery
# --------------------------------------------------------------------------- #


class IntegrateQuery(Query):
    """Per-sample marginalization: input layers select between their output
    and their integral under a (B, D) boolean mask given at call time."""

    def __init__(self, circuit: TorchCircuit) -> None:
        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                "The circuit to integrate must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        self._circuit = circuit

    def __call__(
        self,
        x,
        *,
        integrate_vars: MaskSpec | None = None,
        store: Store | None = None,
        pad_batch_to: int | None = None,
        soft_vars: MaskSpec | None = None,
        soft_weights: torch.Tensor | np.ndarray | None = None,
    ) -> torch.Tensor:
        """(B, O, K) marginal log-likelihoods. ``integrate_vars`` is a (B, D)
        or (D,) boolean mask (True = marginalized), a Scope, or a sequence of
        Scopes of length 1 or B. ``pad_batch_to`` rounds a ragged batch up to
        a multiple (the output is sliced back).

        ``soft_vars`` and ``soft_weights`` add virtual evidence: each soft
        variable contributes ``sum_s w(s) p(x=s)``. ``soft_vars`` takes the
        same specs as ``integrate_vars``; ``soft_weights`` is a (B, D, S) or
        (D, S) array of nonnegative linear-space weights. Soft variables must
        have finite support and be disjoint from ``integrate_vars``."""
        cc = self._circuit
        if (soft_vars is None) != (soft_weights is None):
            raise ValueError("soft_vars and soft_weights must be passed together")
        if integrate_vars is None and soft_vars is None:
            raise ValueError(
                "Pass integrate_vars (marginalization) and/or "
                "soft_vars + soft_weights (virtual evidence)"
            )
        with torch.inference_mode():
            store = _bound_store(cc, store)
            dev = _store_device(store)
            if soft_vars is None:
                x, integrate_vars, _b = _pad_rows(pad_batch_to, x, integrate_vars)
            else:
                # (B, D, S) before padding, so the padder treats the weights
                # like any per-row mask
                soft_weights = np.asarray(
                    soft_weights.cpu() if isinstance(soft_weights, torch.Tensor)
                    else soft_weights, dtype=np.float64,
                )
                if soft_weights.ndim == 2:
                    soft_weights = np.broadcast_to(
                        soft_weights[None], (len(x), *soft_weights.shape)
                    )
                x, integrate_vars, soft_vars, soft_weights, _b = _pad_rows(
                    pad_batch_to, x, integrate_vars, soft_vars, soft_weights
                )
            x = _to_device(x, dev)
            batch = x.shape[0]
            if integrate_vars is None:
                mask = torch.zeros((batch, _num_vars(cc)), dtype=torch.bool, device=dev)
            else:
                mask = self._as_mask(integrate_vars, batch, dev)
            if soft_vars is None:
                return _slice_rows(masked_evaluate(cc, store, x, mask), _b)

            soft_mask = self._as_mask(soft_vars, batch, dev)
            both = (mask & soft_mask).cpu().numpy()
            if both.any():
                raise ValueError(
                    "A variable cannot be both marginalized and soft-observed: overlap at "
                    f"variables {sorted(set(np.nonzero(both)[1].tolist()))}"
                )
            supports = _variable_supports(cc)
            used = soft_mask.any(dim=0).cpu().numpy()
            bad = [int(v) for v in np.nonzero(used)[0] if supports[v] <= 0]
            if bad:
                raise ValueError(
                    "Soft evidence requires finite-support leaves; variables "
                    f"{bad} are continuous or have no input layer"
                )
            w = np.asarray(soft_weights)
            if w.ndim != 3 or w.shape[0] != batch or w.shape[1] != _num_vars(cc):
                raise ValueError(
                    f"soft_weights must be (B, D, S) or (D, S) with B={batch}, "
                    f"D={_num_vars(cc)}; found {w.shape}"
                )
            if np.isnan(w).any() or (w < 0).any():
                raise ValueError("soft_weights must be nonnegative (linear space)")
            with np.errstate(divide="ignore"):
                logw = torch.as_tensor(np.log(w), device=dev)
            return _slice_rows(soft_evaluate(cc, store, x, mask, soft_mask, logw), _b)

    def _as_mask(self, spec, batch: int, device: torch.device) -> torch.Tensor:
        """A variable spec (mask, Scope or Scope list) as a (B, D) boolean
        mask broadcast to the batch."""
        cc = self._circuit
        if isinstance(spec, (torch.Tensor, np.ndarray)):
            mask = _to_device(spec, device)
            if mask.dtype != torch.bool:
                raise ValueError(f"Expected a boolean mask, found dtype {mask.dtype}")
            if mask.ndim == 1:
                mask = mask[None]
            if mask.shape[1] != _num_vars(cc):
                raise ValueError(
                    f"The circuit scope has {_num_vars(cc)} variables, but the mask "
                    f"covers {mask.shape[1]}"
                )
        else:
            mask = torch.as_tensor(IntegrateQuery.scopes_to_mask(cc, spec), device=device)
        if mask.shape[0] not in (1, batch):
            raise ValueError(
                "The number of integration scopes must be 1 (broadcast) or match the "
                f"batch size: found {mask.shape[0]} != {batch}"
            )
        return mask.expand(batch, -1)

    @staticmethod
    def scopes_to_mask(circuit: TorchCircuit, batch_integrate_vars) -> np.ndarray:
        """Scopes -> (B, num_vars) boolean mask."""
        if isinstance(batch_integrate_vars, Scope):
            batch_integrate_vars = [batch_integrate_vars]
        mask = np.zeros((len(batch_integrate_vars), _num_vars(circuit)), dtype=bool)
        for i, scope in enumerate(batch_integrate_vars):
            invalid = Scope(scope) - circuit.scope
            if invalid:
                raise ValueError(
                    "The variables to marginalize must be a subset of the circuit "
                    f"scope; invalid variables: {list(invalid)}"
                )
            mask[i, list(scope)] = True
        return mask


def _evidence_to_mask(cc: TorchCircuit, spec, batch: int, device: torch.device) -> torch.Tensor:
    """An evidence spec (boolean (B, D)/(D,) array, a Scope, or a sequence of
    Scopes of length 1 or B) as a (B, D) mask."""
    if isinstance(spec, (torch.Tensor, np.ndarray)):
        mask = _to_device(spec, device)
        if mask.dtype != torch.bool:
            raise ValueError(f"Expected a boolean mask, found dtype {mask.dtype}")
        if mask.ndim == 1:
            mask = mask[None]
    else:
        mask = torch.as_tensor(IntegrateQuery.scopes_to_mask(cc, spec), device=device)
    if mask.shape[0] == 1 and batch != 1:
        mask = mask.expand(batch, -1)
    if mask.shape[0] != batch:
        raise ValueError(f"The evidence mask covers {mask.shape[0]} samples, expected {batch}")
    return mask


# --------------------------------------------------------------------------- #
# Posterior expectations: ExpectationQuery and mutual_information
# --------------------------------------------------------------------------- #


class ExpectationQuery(Query):
    """Posterior expected states (soft imputation): ``E[x_v | x_obs]`` for
    every free variable, per sample, in one forward and one backward pass.

    The gradient of the root log-likelihood with respect to a zero offset on
    each input unit's log-output is that unit's posterior responsibility
    ``p(unit used | x_obs)`` (:func:`offset_module_fn`, the mechanism of
    EM's E-step), so a posterior statistic is the responsibility-weighted sum
    of the units' own (``mean_state``, ``second_moment_state``,
    ``state_distribution``, ``cdf_state``). The store is not differentiated:
    the backward of every kernel-bearing entry computes the input gradients
    only. Observed entries return their ``x`` value. Requires the
    ``lse-sum`` semiring."""

    def __init__(self, circuit: TorchCircuit) -> None:
        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                "The circuit must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        if circuit.semiring is not LSESumSemiring:
            raise ValueError(
                "ExpectationQuery requires a circuit compiled under the 'lse-sum' semiring, "
                f"found {circuit.semiring.__name__}"
            )
        self._circuit = circuit

    def __call__(
        self,
        x,
        *,
        evidence_mask: MaskSpec,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        return_variance: bool = False,
        pad_batch_to: int | None = None,
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        """(B, D) expected states: ``x`` where ``evidence_mask`` is True, the
        posterior mean of head (``output``, ``unit``) elsewhere. With
        ``return_variance=True`` also the (B, D) exact posterior variances
        (0 at observed entries), by the law of total variance over units."""
        mode = "mean_var" if return_variance else "mean"
        return self._dispatch(mode, x, evidence_mask, store, output, unit, pad=pad_batch_to)

    def marginals(
        self,
        x,
        *,
        evidence_mask: MaskSpec,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        dtype: torch.dtype | None = None,
        pad_batch_to: int | None = None,
    ) -> torch.Tensor:
        """Full posterior state distributions: (B, D, S) with ``out[b, v, s]
        = p(x_v = s | x_obs)``, S the largest leaf support (smaller supports
        pad with 0). Observed variables return the one-hot of their state.
        Every input layer must have finite support. ``dtype`` (e.g.
        ``torch.bfloat16``) is the type of the returned table; the
        responsibilities reduce in the store's type."""
        mode = "marginals" if dtype is None else ("marginals", dtype)
        return self._dispatch(mode, x, evidence_mask, store, output, unit, pad=pad_batch_to)

    def cdf(
        self,
        x,
        *,
        t,
        evidence_mask: MaskSpec,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        pad_batch_to: int | None = None,
    ) -> torch.Tensor:
        """Exact posterior CDFs: (B, D) with ``out[b, v] = p(x_v <= t_v |
        x_obs)``, ``t`` a scalar, (D,) or (B, D). The responsibilities
        contract with the leaves' per-unit CDFs (``cdf_state``), so
        continuous leaves work too. Observed entries return ``x_v <= t_v``."""
        tt = self._targets(x, t)
        return self._dispatch("cdf", x, evidence_mask, store, output, unit, extra=(tt,),
                              pad=pad_batch_to)

    def quantile(
        self,
        x,
        *,
        q,
        evidence_mask: MaskSpec,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        pad_batch_to: int | None = None,
    ) -> torch.Tensor:
        """Exact posterior quantiles: (B, D) with ``out[b, v] = inf{t :
        p(x_v <= t | x_obs) >= q_v}`` (the generalized inverse: a discrete
        leaf lands on the quantile state). ``q`` is a scalar, (D,) or (B, D)
        in (0, 1). The responsibilities are computed once; the inversion
        brackets the mean by 12 doublings and bisects 60 times through the
        leaf-CDF contraction. Observed entries return their ``x`` value."""
        qv = np.asarray(q.cpu() if isinstance(q, torch.Tensor) else q, dtype=np.float64)
        if ((qv <= 0.0) | (qv >= 1.0)).any():
            raise ValueError("Quantile targets must lie strictly in (0, 1)")
        qq = self._targets(x, qv)
        return self._dispatch("quantile", x, evidence_mask, store, output, unit, extra=(qq,),
                              pad=pad_batch_to)

    def covariance(
        self,
        x,
        *,
        evidence_mask: MaskSpec,
        variables: Sequence[int],
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        pad_batch_to: int | None = None,
    ) -> torch.Tensor:
        """Exact posterior covariances ``Cov[x_u, x_v | x_obs]`` of the
        queried ``variables``: (B, k, k).

        Row u is ``m_u^T H m`` with H the Hessian of the evidence
        log-likelihood with respect to the per-unit offsets and m the
        leaves' mean states: one Hessian-vector product per queried
        variable, a double backward. The kernels' backward is not
        differentiable, so these rows evaluate the circuit through the
        semiring ops' plain compositions (``TorchCircuit.evaluate(...,
        plain=True)``) on any device, as the JAX package traces this one
        program on its XLA path; the diagonal (the variances) and every
        other statistic run the kernels. Rows and columns of observed
        variables are 0."""
        cc = self._circuit
        variables = tuple(int(v) for v in variables)
        num_vars = _num_vars(cc)
        for v in variables:
            if not 0 <= v < num_vars:
                raise ValueError(f"variable {v} out of range for {num_vars} variables")
        _, var = self._dispatch("mean_var", x, evidence_mask, store, output, unit,
                                pad=pad_batch_to)
        rows = torch.stack([
            self._dispatch("cov_row", x, evidence_mask, store, output, unit, extra=(u,),
                           pad=pad_batch_to)
            for u in variables
        ], dim=1)  # (B, k, D)
        vidx = torch.as_tensor(variables, device=rows.device)
        cov = rows[:, :, vidx]
        eye = torch.eye(len(variables), dtype=torch.bool, device=rows.device)
        cov = torch.where(eye[None], var[:, vidx][:, :, None], cov)
        mask = _evidence_to_mask(cc, evidence_mask, cov.shape[0], rows.device)
        free = (~mask[:, vidx]).to(cov.dtype)  # observed variables are constants
        return cov * free[:, :, None] * free[:, None, :]

    def _targets(self, x, t) -> torch.Tensor:
        """Per-(sample, variable) thresholds or targets (B, D) in float64."""
        t = t.cpu() if isinstance(t, torch.Tensor) else t
        b = len(x)
        return torch.as_tensor(np.broadcast_to(np.asarray(t, dtype=np.float64),
                                               (b, _num_vars(self._circuit))).copy())

    def _dispatch(self, mode, x, evidence_mask, store, output, unit, extra=(), pad=None):
        cc = self._circuit
        padded = _pad_rows(pad, x, evidence_mask, *extra)
        x, evidence_mask, extra, _b = padded[0], padded[1], padded[2:-1], padded[-1]
        store = {k: v.detach() for k, v in _bound_store(cc, store).items()}
        dev = _store_device(store)
        # the responsibilities are gradients: autograd must record, also
        # under a caller's inference mode
        with torch.inference_mode(False), torch.no_grad():
            x = _to_device(x, dev)
            mask = _evidence_to_mask(cc, evidence_mask, x.shape[0], dev)
            num_vars = _num_vars(cc)
            if mask.shape[1] != num_vars:
                raise ValueError(
                    f"The circuit scope has {num_vars} variables, but the mask "
                    f"covers {mask.shape[1]}"
                )
            extra = tuple(_to_device(e, dev) if isinstance(e, torch.Tensor) else e
                          for e in extra)
            runs = cc.__dict__.setdefault("_expect_runs", {})
            key = (output, unit, mode)
            if key not in runs:
                runs[key] = _build_expectation_run(cc, output, unit, mode)
            return _slice_rows(runs[key](store, x, mask, *extra), _b)


def _build_expectation_run(cc: TorchCircuit, output: int, unit: int, mode) -> Callable:
    """The expectation program of one mode: "mean" -> (B, D) posterior
    means; "mean_var" -> the (means, variances) pair; "marginals" (or
    ("marginals", dtype)) -> (B, D, S) posterior state distributions;
    "cdf" and "quantile" -> (B, D) at the (B, D) thresholds or targets of
    the extra argument; "cov_row" -> the (B, D) covariance row of the
    variable given as the extra argument; "mi_row" -> one anchor's (D,)
    mutual-information row (extra arguments: the anchor and the (D, S)
    marginals of the base row). Every mode shares the responsibility pass
    and differs in the per-leaf statistic (and, for covariance rows, the
    second backward). ``run`` is called under ``torch.no_grad()``; its
    backward passes turn grad mode on for themselves."""
    num_vars = _num_vars(cc)
    inputs = [
        entry.layer for entry in cc._entries
        if isinstance(entry.layer, TorchInputLayer)
        and not isinstance(entry.layer, TorchConstantInputLayer)
    ]
    for layer in inputs:
        if layer.num_variables != 1:
            raise NotImplementedError("Expectations of multivariate input layers are not supported")
    out_dtype = None
    if isinstance(mode, tuple):
        mode, out_dtype = mode
    supp = 0
    if mode in ("marginals", "mi_row"):
        for layer in inputs:
            s = _leaf_support_size(layer)
            if s is None:
                raise NotImplementedError(
                    "Posterior marginals need finite-support input layers; "
                    f"{type(layer).__name__} is continuous"
                )
            supp = max(supp, s)
    plain = mode == "cov_row"

    def run(st: Store, xx: torch.Tensor, mk: torch.Tensor, uu=None, vv=None):
        dev = xx.device
        dt = _store_dtype(st)
        if mode == "mi_row":
            # one anchor's row: the (S, D) anchor-state evidence is built on
            # the device from the base row, and the KL reduce below runs
            # there too, so only the (D,) row is left to read
            colb = torch.arange(num_vars, device=dev) == uu
            states = torch.arange(supp, dtype=xx.dtype, device=dev)
            xx = torch.where(colb[None, :], states[:, None], xx[0][None, :])
            mk = mk[0][None, :] | colb[None, :]
        bsz = xx.shape[0]
        svars = [_scope_vars(layer, dev) for layer in inputs]
        offs = {
            id(layer): torch.zeros((layer.num_folds, bsz, layer.num_output_units), dtype=dt,
                                   device=dev, requires_grad=True)
            for layer in inputs
        }
        with torch.enable_grad():
            ll = cc.evaluate(st, xx, module_fn=offset_module_fn(offs, ~mk), plain=plain)
            total = ll[:, output, unit].sum()
            grads = torch.autograd.grad(total, list(offs.values()), create_graph=plain,
                                        allow_unused=True)
        # an offset the root does not reach has responsibility 0
        resp = [torch.zeros_like(o) if g is None else g for o, g in zip(offs.values(), grads)]

        def contract(rd, stat) -> torch.Tensor:
            """Scatter the ``rd``-weighted per-unit statistic (F, K) into (B,
            D) at each layer's variables."""
            acc = torch.zeros((bsz, num_vars), dtype=dt, device=dev)
            for layer, v, r in zip(inputs, svars, rd):
                val = torch.einsum("fbk,fk->fb", r, stat(layer).to(dt))
                acc.index_add_(1, v, val.t())
            return acc

        def cdf_at(tt: torch.Tensor) -> torch.Tensor:
            """The posterior CDF (B, D) at thresholds ``tt`` (B, D): the
            responsibilities sum to 1 per variable by smoothness, so the
            weighted per-unit CDFs are normalized."""
            acc = torch.zeros((bsz, num_vars), dtype=dt, device=dev)
            for layer, v, r in zip(inputs, svars, resp):
                c = layer.cdf_state(st, tt[:, v].t()).to(dt)  # (F, B, K)
                acc.index_add_(1, v, torch.einsum("fbk,fbk->fb", r, c).t())
            return acc

        if mode == "cov_row":
            # Cov(x_u, x_v | e) = m_u^T H_uv m_v: the second backward of the
            # responsibilities against the tangent of u's mean states gives
            # the whole row
            tang = []
            for layer, v in zip(inputs, svars):
                m = layer.mean_state(st).to(dt) * (v == uu).to(dt)[:, None]  # (F, K)
                tang.append(m[:, None, :].expand(-1, bsz, -1))
            with torch.enable_grad():
                live = [(o, g, t) for o, g, t in zip(offs.values(), grads, tang)
                        if g is not None and g.requires_grad]
                hv = torch.autograd.grad([g for _, g, _ in live], [o for o, _, _ in live],
                                         grad_outputs=[t for _, _, t in live],
                                         allow_unused=True)
            hvs = {id(o): h for (o, _, _), h in zip(live, hv) if h is not None}
            hvp = [hvs.get(id(o), torch.zeros_like(o)) for o in offs.values()]
            return contract(hvp, lambda l: l.mean_state(st))

        if mode in ("marginals", "mi_row"):
            out = torch.zeros((bsz, num_vars, supp), dtype=dt, device=dev)
            for layer, v, r in zip(inputs, svars, resp):
                pm = torch.einsum("fbk,fks->fbs", r, layer.state_distribution(st).to(dt))
                if pm.shape[2] < supp:
                    pm = torch.nn.functional.pad(pm, (0, supp - pm.shape[2]))
                out.index_add_(1, v, pm.transpose(0, 1))
            obs = torch.nn.functional.one_hot(
                xx.long().clamp(0, supp - 1), supp
            ).to(dt)
            res = torch.where(mk[:, :, None], obs, out)
            if mode == "mi_row":
                # anchor states with p(s) = 0 (impossible evidence, or
                # support padding past this anchor's state count) give
                # NaN rows: masked after nan_to_num, they add nothing
                marg = vv.to(dt)
                p_u = marg[uu]  # (S,)
                lcond = torch.where(res > 0, torch.log(res), 0.0)
                lmarg = torch.where(marg > 0, torch.log(marg), 0.0)
                kl = (res * (lcond - lmarg[None])).sum(dim=2)  # (S, D)
                kl = torch.where((p_u > 0)[:, None], torch.nan_to_num(kl), 0.0)
                return p_u @ kl
            return res if out_dtype is None else res.to(out_dtype)

        if mode == "cdf":
            tt = uu.to(dt)  # thresholds (B, D)
            obs = (xx.to(dt) <= tt).to(dt)
            return torch.where(mk, obs, cdf_at(tt))

        m1 = contract(resp, lambda l: l.mean_state(st))
        if mode == "quantile":
            qq = uu.to(dt)  # targets (B, D)
            m2 = contract(resp, lambda l: l.second_moment_state(st))
            sd = torch.sqrt(torch.clamp_min(m2 - torch.square(m1), 0.0))
            # bracket the generalized inverse around the mean: start at
            # +-(4 sd + 1) and double where q is still outside
            c = 4.0 * sd + 1.0
            for _ in range(12):
                outside = (cdf_at(m1 - c) > qq) | (cdf_at(m1 + c) < qq)
                c = torch.where(outside, 2.0 * c, c)
            lo, hi = m1 - c, m1 + c
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                below = cdf_at(mid) < qq
                lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
            # hi converges from above: inf{t : F(t) >= q}, on the jump of
            # a step CDF
            return torch.where(mk, xx.to(dt), hi)
        mean = torch.where(mk, xx.to(dt), m1)
        if mode == "mean":
            return mean
        m2 = contract(resp, lambda l: l.second_moment_state(st))
        # the law of total variance over the leaf units; cancellation can
        # leave tiny negative residuals
        var = torch.clamp_min(m2 - torch.square(m1), 0.0)
        return mean, torch.where(mk, torch.zeros((), dtype=dt, device=dev), var)

    return run


def mutual_information(
    circuit: TorchCircuit,
    *,
    store: Store | None = None,
    variables: Sequence[int] | None = None,
    x=None,
    evidence_mask=None,
    output: int = 0,
    unit: int = 0,
) -> torch.Tensor:
    """Exact pairwise mutual information under the circuit distribution: a
    (k, k) matrix over ``variables`` (default: every variable of the scope)
    with ``out[i, j] = I(x_ui ; x_uj)`` in nats and the marginal entropies
    on the diagonal. With ``x`` and ``evidence_mask`` (one assignment) every
    term conditions on the evidence, and rows and columns of observed
    variables are 0.

    One :meth:`ExpectationQuery.marginals` pass per anchor u whose batch
    enumerates u's states as evidence, so one backward gives ``p(x_v = t |
    x_u = s)`` for every v and t, reduced on the device with the
    unconditional marginals to ``I(u, v) = sum_s p(s) KL(p(x_v | s) ||
    p(x_v))``; only each anchor's (D,) row leaves the device. Requires
    finite-support leaves at the queried variables."""
    q = ExpectationQuery(circuit)
    supports = _variable_supports(circuit)
    num_vars = supports.shape[0]
    if variables is None:
        variables = [v for v in range(num_vars) if supports[v] != -2]
    variables = tuple(int(v) for v in variables)
    for v in variables:
        if not 0 <= v < num_vars or supports[v] == -2:
            raise ValueError(f"Variable {v} is outside the circuit scope")
        if supports[v] == -1:
            raise NotImplementedError(
                f"Mutual information needs finite-support leaves; variable {v} has a "
                "continuous input layer"
            )
    if x is None:
        x0 = np.zeros(num_vars, dtype=np.int64)
        m0 = np.zeros(num_vars, dtype=bool)
    else:
        if evidence_mask is None:
            raise ValueError("Passing x requires evidence_mask")
        x0 = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                        dtype=np.int64).reshape(num_vars)
        m0 = np.asarray(evidence_mask.cpu() if isinstance(evidence_mask, torch.Tensor)
                        else evidence_mask, dtype=bool).reshape(num_vars)
    marg = q.marginals(x0[None], evidence_mask=m0[None], store=store, output=output,
                       unit=unit)[0]  # (D, S)
    rows = [
        q._dispatch("mi_row", x0[None], m0[None], store, output, unit, extra=(u, marg))
        for u in variables if not m0[u]
    ]
    mat = np.zeros((len(variables), num_vars))
    if rows:
        mat[~m0[list(variables)]] = torch.stack(rows).cpu().double().numpy()
    cols = np.asarray(variables)
    mat = mat[:, cols]
    mat[:, m0[cols]] = 0.0  # observed columns: conditioning makes them constants
    return torch.as_tensor(mat, dtype=marg.dtype, device=marg.device)


# --------------------------------------------------------------------------- #
# MAP and sampling: the two-pass routing
# --------------------------------------------------------------------------- #


class MAPQuery(Query):
    """Max-product MPE (most-probable-explanation) through the plan: sum
    layers take the max over their mixture inputs, input layers contribute
    their per-unit mode, and observed variables their data likelihood, so
    the query completes partial assignments, ``argmax_{x_miss} p(x_miss,
    x_obs)`` per sample. Exact on deterministic circuits; otherwise the
    returned log-value is the weight of the best latent parse. Requires
    normalized nonnegative sum weights and the ``lse-sum`` semiring.

    The assignment maximizes ONE root output unit: flat output ``output``,
    unit ``unit`` (defaults (0, 0)), and ``log_values`` is that unit's
    max-product value.

    With a ``mesh`` the routing runs tensor-parallel over ``model_axis``:
    pass the rank's store from ``parallel.shard_store_tp`` (a full store is
    cut to the rank's shards), and every rank calls the query with the same
    arguments. The batch splits over ``data_axis`` when the mesh has it and
    it divides the batch; every rank returns the whole result."""

    def __init__(self, circuit: TorchCircuit, *, mesh=None, model_axis: str = "model",
                 data_axis: str | None = "data") -> None:
        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                "The circuit to maximize must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        if circuit.semiring is not LSESumSemiring:
            raise ValueError(
                "MAPQuery requires a circuit compiled under the 'lse-sum' semiring, "
                f"found {circuit.semiring.__name__}"
            )
        self._circuit = circuit
        self._tp = _TPQuery(circuit, mesh, model_axis, data_axis)

    def __call__(
        self,
        x=None,
        *,
        evidence_mask: MaskSpec | None = None,
        marginalize_vars: MaskSpec | None = None,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        top_k: int | None = None,
        pad_batch_to: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """MPE states: ``(assignments (B, D), log_values (B,))``.
        Unconditional when ``x`` is None (B=1); otherwise ``evidence_mask``
        (a (B, D)/(D,) boolean mask, a Scope, or Scopes) marks the observed
        entries of ``x`` and the free variables are maximized per sample.
        ``marginalize_vars`` (same specs) makes it a marginal MAP query: those
        variables are summed out at their input layers and come back as 0.

        ``top_k=T`` returns the T best parses instead, ``(assignments (B, T,
        D), log_values (B, T))`` with descending scores (the k-best pass of
        :mod:`cirkit_tpu_torch.backend.torch.topk`): the exact top-T
        assignments on deterministic circuits, the T best latent parses
        otherwise. Slots past the number of parses score ``-inf``. It cannot
        be combined with ``marginalize_vars``."""
        cc = self._circuit
        num_vars = _num_vars(cc)
        with torch.inference_mode():
            store = _bound_store(cc, store)
            dev = _store_device(store)
            if x is None:
                if evidence_mask is not None:
                    raise ValueError("evidence_mask requires an input batch x")
                x = torch.zeros((1, num_vars), dtype=torch.int64, device=dev)
                mask = torch.zeros((1, num_vars), dtype=torch.bool, device=dev)
                _b = None
            else:
                if evidence_mask is None:
                    raise ValueError(
                        "Pass evidence_mask marking the observed entries of x "
                        "(an all-False mask reproduces the unconditional query)"
                    )
                x, evidence_mask, marginalize_vars, _b = _pad_rows(
                    pad_batch_to, x, evidence_mask, marginalize_vars
                )
                x = _to_device(x, dev)
                mask = _evidence_to_mask(cc, evidence_mask, x.shape[0], dev)
            mg = None
            if marginalize_vars is not None:
                mg = _evidence_to_mask(cc, marginalize_vars, x.shape[0], dev)
                if bool((mask & mg).any()):
                    raise ValueError(
                        "A variable cannot be both observed (evidence_mask) and "
                        "marginalized (marginalize_vars)"
                    )
            if top_k is not None:
                if top_k < 1:
                    raise ValueError(f"top_k must be >= 1, found {top_k}")
                if mg is not None:
                    raise NotImplementedError("top_k cannot be combined with marginalize_vars")
                if self._tp.mesh is not None:
                    raise NotImplementedError("top_k is not supported on a tensor-parallel mesh")
                runs = cc.__dict__.setdefault("_topk_runs", {})
                key = (top_k, output, unit)
                if key not in runs:
                    from cirkit_tpu_torch.backend.torch.topk import build_topk_run

                    runs[key] = build_topk_run(cc, top_k, root_output=output, root_unit=unit)
                return _slice_rows(runs[key](store, x, mask), _b)  # (B, T, D), (B, T)
            asg, vals, _ = self._tp.run("max", output, unit, store, x, mask, mg)
            return _slice_rows((asg, vals[output, :, unit]), _b)


class SamplingQuery(Query):
    """Ancestral and posterior sampling. An lse-sum circuit takes the
    two-pass routing: the upward pass is the masked-integrate forward, and
    the downward pass draws one latent mixture index per (entry, fold,
    sample) at the selected unit only, and one state per selected input
    unit. Memory stays activation-sized. Any other semiring takes the dense
    bottom-up sampler (:func:`_sample_dense`), which reads the weights as
    probabilities and draws every unit's mixture index.

    With a ``mesh`` the lse-sum routing runs tensor-parallel over
    ``model_axis``, as :class:`MAPQuery`'s, on the whole batch on every rank
    (the batch is never split over ``data_axis``: the draws stay the
    single-device draws from the same generator); the dense sampler of the
    other semirings reads a full store and ignores the mesh."""

    def __init__(self, circuit: TorchCircuit, *, mesh=None, model_axis: str = "model",
                 data_axis: str | None = "data") -> None:
        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                "The circuit to sample from must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        self._circuit = circuit
        self._tp = _TPQuery(circuit, mesh, model_axis, data_axis)

    def __call__(
        self,
        num_samples: int = 1,
        *,
        generator: torch.Generator | None = None,
        store: Store | None = None,
    ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Draw ``num_samples`` samples: returns (samples (N, D) in the
        store's float type, the composite mixture index drawn at each
        sum-style entry). Under lse-sum an index is (F, N), -1 where the
        entry was not on the parse; under another semiring it is the dense
        sampler's (F, Ko, N), one per output unit, as the JAX package
        returns it."""
        if num_samples <= 0:
            raise ValueError("The number of samples must be a positive number")
        cc = self._circuit
        with torch.inference_mode():
            store = _bound_store(cc, store)
            if cc.semiring is not LSESumSemiring:
                return _sample_dense(cc, store, num_samples, _generator(generator))
            dev = _store_device(store)
            shape = (num_samples, _num_vars(cc))
            x = torch.zeros(shape, dtype=torch.int64, device=dev)
            mask = torch.zeros(shape, dtype=torch.bool, device=dev)
            samples, _, mixtures = self._tp.run("sample", 0, 0, store, x, mask, None,
                                                _generator(generator))
            return samples, list(mixtures)

    def conditional(
        self,
        x,
        *,
        evidence_mask: MaskSpec,
        generator: torch.Generator | None = None,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        pad_batch_to: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Posterior sampling given evidence: one completion per row, the
        free entries of ``x`` (where ``evidence_mask`` is False) drawn from
        ``p(x_free | x_obs)`` of root output ``output``, unit ``unit``.
        Returns ``(samples (B, D), log_evidence (B,))``, the value being
        ``log p(x_obs)``. Requires normalized sum weights and the ``lse-sum``
        semiring."""
        cc = self._circuit
        if cc.semiring is not LSESumSemiring:
            raise ValueError(
                "Conditional sampling requires a circuit compiled under the 'lse-sum' "
                f"semiring, found {cc.semiring.__name__}"
            )
        num_vars = _num_vars(cc)
        with torch.inference_mode():
            store = _bound_store(cc, store)
            dev = _store_device(store)
            x, evidence_mask, _b = _pad_rows(pad_batch_to, x, evidence_mask)
            x = _to_device(x, dev)
            mask = _evidence_to_mask(cc, evidence_mask, x.shape[0], dev)
            if mask.shape[1] != num_vars:
                raise ValueError(
                    f"The circuit scope has {num_vars} variables, but the mask "
                    f"covers {mask.shape[1]}"
                )
            asg, vals, _ = self._tp.run("sample", output, unit, store, x, mask, None,
                                        _generator(generator))
            return _slice_rows((asg, vals[output, :, unit]), _b)


def _routing_run(cc: TorchCircuit, kind: str, root_output: int, root_unit: int,
                 tp=None) -> Callable:
    """The routing closure for one (kind, root) choice (and tensor-parallel
    descriptor), built once and kept on the circuit."""
    runs = cc.__dict__.setdefault("_routing_runs", {})
    key = (kind, root_output, root_unit, None if tp is None else (tp.mesh, tp.axis))
    if key not in runs:
        runs[key] = _build_routing_run(cc, kind, root_output=root_output, root_unit=root_unit,
                                       tp=tp)
    return runs[key]


class TPRouting(NamedTuple):
    """What the routing passes need to run on one rank's unit shards (built
    by ``parallel.tensor.tp_routing_descriptor``): the mesh, its model axis,
    the shard count, this rank's shard index, and per plan entry whether
    the entry's own parameters are unit-sharded. The cross-shard
    combinations are explicit collectives outside the kernels: an
    all-gather of the small activations upward, a masked max or sum of the
    per-shard choices downward."""

    mesh: Any
    axis: str
    size: int
    rank: int
    entry_sharded: tuple[bool, ...]

    def gather(self, a: torch.Tensor, full: int | None = None) -> torch.Tensor:
        """The full unit axis of a local-width ``a``; an ``a`` already of
        width ``full`` (a hook that builds a full-width constant from static
        metadata) is returned as it is."""
        from cirkit_tpu_torch.parallel.mesh import gather_units

        if full is not None and a.shape[-1] == full:
            return a
        return gather_units(a, self.mesh, self.axis)

    def pmax(self, a: torch.Tensor) -> torch.Tensor:
        from cirkit_tpu_torch.parallel.mesh import all_reduce

        return all_reduce(a.contiguous(), self.mesh, self.axis, torch.distributed.ReduceOp.MAX)

    def psum(self, a: torch.Tensor) -> torch.Tensor:
        from cirkit_tpu_torch.parallel.mesh import all_reduce

        return all_reduce(a.contiguous(), self.mesh, self.axis)


class _TPQuery:
    """The mesh of a routing query (or none): the tensor-parallel descriptor
    over ``model_axis``, the store cut to the rank's shards, and MAP's batch
    split over ``data_axis``."""

    def __init__(self, cc: TorchCircuit, mesh, model_axis: str, data_axis: str | None):
        self.cc, self.mesh, self.data_axis = cc, mesh, data_axis
        self.model_axis = model_axis
        self.tp = None
        if mesh is not None:
            from cirkit_tpu_torch.parallel.tensor import tp_routing_descriptor

            self.tp = tp_routing_descriptor(cc, mesh, model_axis=model_axis)[0]

    def run(self, kind: str, output: int, unit: int, store: Store, x, mask, mg,
            generator=None):
        run = _routing_run(self.cc, kind, output, unit, self.tp)
        if self.mesh is None:
            return run(store, x, mask, mg, generator)
        from cirkit_tpu_torch.parallel.mesh import axis_size, gather_rows, local_rows
        from cirkit_tpu_torch.parallel.tensor import localize_store

        store = localize_store(self.cc, store, self.mesh, self.model_axis)
        dsz = axis_size(self.mesh, self.data_axis)
        if kind != "max" or dsz == 1 or x.shape[0] % dsz:
            return run(store, x, mask, mg, generator)
        # only the deterministic pass splits its batch over the data axis
        x, mask, mg = (None if a is None else local_rows(a, self.mesh, self.data_axis)
                       for a in (x, mask, mg))
        asg, vals, mixtures = run(store, x, mask, mg, generator)
        return (gather_rows(asg, self.mesh, self.data_axis),
                gather_rows(vals, self.mesh, self.data_axis, dim=1),
                tuple(gather_rows(m, self.mesh, self.data_axis, dim=1) for m in mixtures))


def _max_weight(param: TorchParameter, st: Store) -> torch.Tensor:
    """Evaluate a sum-layer weight plan under max-product semantics.

    The sum-collapse fusion replaces two stacked dense sums by one whose
    weight is ``MatMul(W1, W2)``, a SUM over the fused inner sum's latent
    units: sound for the (+, *) forward and for sampling, but MPE maxes over
    every latent, so the composite weight must be the tropical product
    ``max_j W2[o, j] * W1[j, i]``. Every other node of a weight plan is
    elementwise or layout-only over the unit axes and evaluates as usual,
    but only while nothing sits between a MatMul and the plan output except
    further MatMuls: a node applied to the maxed composite would see other
    values than the forward's, so that shape raises."""

    def tropical_matmul(plan, node, ins):
        if not isinstance(node, TorchMatMulParameter):
            return None
        for user in plan.node_outputs(node):
            if not isinstance(user, TorchMatMulParameter):
                raise NotImplementedError(
                    "MAP/MPE through a fused weight graph where a MatMul feeds "
                    f"{type(user).__name__} is not supported"
                )
        w1, w2 = ins  # (F, j, i) inner, (F, o, j) outer
        return (w2[:, :, :, None] * w1[:, None, :, :]).amax(dim=2)

    return param(st, node_override=tropical_matmul)


def _tucker_comb(v: torch.Tensor) -> torch.Tensor:
    """The log-space Kronecker composite of a Tucker entry's child values:
    (F, H, B, K) -> (F, B, K^H), row-major over the arity digits (the Tucker
    core weight's layout)."""
    comb = v[:, 0]
    for hh in range(1, v.shape[1]):
        comb = tucker_comb(comb, v[:, hh])
    return comb


def _comb(tag: str, v: torch.Tensor) -> torch.Tensor:
    """The (F, B, M) mixture inputs of a sum-style entry from its (F, H, B,
    K) child values."""
    if tag == "tucker":
        return _tucker_comb(v)
    if tag == "cpt":
        return v.sum(dim=1)
    f, h, b, k = v.shape  # sum: the arity operands side by side
    return v.transpose(1, 2).reshape(f, b, h * k)


def _digits(m: torch.Tensor, active: torch.Tensor, h: int, k: int) -> list[torch.Tensor]:
    """The H base-K digits of a row-major composite index, -1 where not
    active."""
    units = []
    for _ in range(h):
        units.append(torch.where(active, m % k, -1))
        m = m // k
    return units[::-1]


def _record(layer: TorchLayer, name: str) -> tuple:
    """The static routing record of an inner plan entry."""
    if isinstance(layer, TorchHadamardLayer):
        return ("hadamard",)
    if isinstance(layer, TorchKroneckerLayer):
        return ("kronecker", layer.arity, layer.num_input_units)
    if isinstance(layer, TorchTuckerLayer):
        return ("tucker", layer.arity, layer.num_input_units)
    if isinstance(layer, TorchCPTLayer):
        return ("cpt", layer.arity, layer.num_input_units)
    if isinstance(layer, TorchSumLayer):
        return ("sum", layer.arity, layer.num_input_units)
    raise NotImplementedError(f"{name} is not supported for {type(layer).__name__}")


def _root_position(cc: TorchCircuit, root_output: int, root_unit: int) -> tuple[int, int]:
    """The (plan entry, fold) of flat root output ``root_output``, checked
    with the unit ``root_unit`` against the circuit's outputs."""
    if not 0 <= root_output < cc.num_outputs:
        raise ValueError(
            f"root output {root_output} out of range for a circuit with {cc.num_outputs} outputs"
        )
    num_root_units = cc._entries[cc._out_ids[0]].layer.num_output_units
    if not 0 <= root_unit < num_root_units:
        raise ValueError(
            f"root unit {root_unit} out of range for {num_root_units} output units"
        )
    flat = root_output
    if cc._out_gather is not None:
        flat = int(getattr(cc, cc._out_gather)[root_output])
    off = 0
    for i in cc._out_ids:
        nf = cc._entries[i].layer.num_folds
        if flat < off + nf:
            return i, flat - off
        off += nf
    return cc._out_ids[0], flat


def _push_to_children(cc: TorchCircuit, e: int, units: list[torch.Tensor],
                      sels: list[torch.Tensor]) -> None:
    """Push entry ``e``'s per-operand (F, B) unit choices (-1 where
    inactive) through its fold gather into its producers' selections
    ``sels``: a scatter-max, since decomposability puts each (fold, sample)
    on at most one parse edge."""
    entry = cc._entries[e]
    if entry.gather is None:
        i = entry.in_ids[0]
        sels[i] = torch.maximum(sels[i], units[0])
        return
    idx = getattr(cc, entry.gather)  # (F, H)
    bsz = units[0].shape[1]
    folds = [sels[i].shape[0] for i in entry.in_ids]
    cat = torch.full((sum(folds), bsz), -1, dtype=torch.int64, device=units[0].device)
    for h, u in enumerate(units):
        cat.scatter_reduce_(0, idx[:, h : h + 1].expand(-1, bsz), u, reduce="amax")
    for i, part in zip(entry.in_ids, cat.split(folds)):
        sels[i] = torch.maximum(sels[i], part)


def _pad_samples(samples: torch.Tensor, scope_idx: np.ndarray, num_vars: int) -> torch.Tensor:
    """Scatter univariate per-unit samples (F, K, N) into zero-padded
    assignments (F, K, N, D) at the layer's variable positions (D =
    ``num_vars``, which may be 0)."""
    if scope_idx.shape[1] != 1:
        raise NotImplementedError("Padding is only implemented for univariate samples")
    var = torch.as_tensor(scope_idx[:, 0], device=samples.device)
    one_hot = (var[:, None] == torch.arange(num_vars, device=samples.device)).to(samples.dtype)
    return samples[:, :, :, None] * one_hot[:, None, None, :]


def _sample_dense(cc: TorchCircuit, store: Store, num_samples: int,
                  generator: torch.Generator) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The dense bottom-up sampler of ``cirkit_tpu/backend/jax/queries.py:
    381-409`` for circuits off the lse-sum semiring: the samples of root
    output 0, unit 0, and every sum-style entry's (F, Ko, N) mixture draw.

    The upward pass is ``evaluate_raw(store, None, module_fn=...)``: input
    layers draw (F, K, N) states (``sample``), inner layers draw their
    mixture indices and route their inputs' assignments (``sample``). The
    JAX package routes assignments padded to every variable, (F, K, N, D)
    an entry: 20 GB at the K=64 flagship's leaves for N = 128. Here they are
    routed with the variable axis cut to no column, which leaves the draws
    and the routing's index arithmetic; the downward pass then follows the
    drawn indices from the root unit to the leaves, as the lse-sum routing
    does, and gathers only the selected units' states. A sample is the sum
    of its parse's leaf states over disjoint variables, so it equals the
    padded route's to the bit. One int64 seed per plan entry comes from
    ``generator``."""
    entries = cc._entries
    dev = _store_device(store)
    dtype = _store_dtype(store)
    seeds = torch.randint(0, 2**62, (len(entries),), generator=generator,
                          device=generator.device).tolist()
    drawn: dict[int, torch.Tensor] = {}  # entry -> input states or mixture indices
    step = iter(range(len(entries)))

    def layer_fn(layer: TorchLayer, st: Store, xin):
        e = next(step)
        gen = _device_generator(seeds[e], dev)
        if isinstance(layer, TorchInputLayer):
            drawn[e] = layer.sample(st, gen, num_samples)  # (F, K, N)
            # padded to no variable: the selected units' states are gathered below
            return _pad_samples(drawn[e], layer.scope_idx, 0)
        out, mix = layer.sample(st, gen, xin)
        if mix is not None:
            drawn[e] = mix
        return out

    cc.evaluate_raw(store, None, module_fn=layer_fn)

    root_entry, root_fold = _root_position(cc, 0, 0)
    sels = [torch.full((entry.layer.num_folds, num_samples), -1, dtype=torch.int64, device=dev)
            for entry in entries]
    sels[root_entry][root_fold] = 0
    samples = torch.zeros((num_samples, _num_vars(cc)), dtype=dtype, device=dev)
    for e in range(len(entries) - 1, -1, -1):
        layer = entries[e].layer
        sel = sels[e]
        active = sel >= 0
        safe = sel.clamp_min(0)
        if isinstance(layer, TorchInputLayer):
            picked = torch.gather(drawn[e], 1, safe[:, None, :])[:, 0]  # (F, N)
            samples.index_add_(1, _scope_vars(layer, dev),
                               torch.where(active, picked.to(dtype), 0).t())
            continue
        tag, *shape = _record(layer, "Sampling")
        if tag == "hadamard":
            units = [sel] * layer.arity
        elif tag == "kronecker":
            units = _digits(safe, active, *shape)
        else:
            m = torch.gather(drawn[e], 1, safe[:, None, :])[:, 0]  # the index at sel
            h, k = shape
            if tag == "sum":
                units = [torch.where(active & (m // k == hh), m % k, -1) for hh in range(h)]
            elif tag == "cpt":
                units = [torch.where(active, m, -1)] * h
            else:
                units = _digits(m, active, h, k)
        _push_to_children(cc, e, units, sels)
    mixtures = [drawn[e] for e, entry in enumerate(entries)
                if e in drawn and not isinstance(entry.layer, TorchInputLayer)]
    return samples, mixtures


def _build_routing_run(cc: TorchCircuit, kind: str, *, root_output: int = 0,
                       root_unit: int = 0, tp=None) -> Callable:
    """The two-pass routing behind :class:`MAPQuery` (``kind="max"``) and
    sampling (``kind="sample"``).

    **Upward pass** over the plan: every entry produces log-space values (F,
    B, K). Observed variables contribute their data likelihood, free ones
    their mode (``max``) or their integral (``sample``); under ``max`` the
    sum-style entries take the max over their mixture scores (a tropical
    forward, the Tucker-2 entries through ``tropical_tucker2``), under
    ``sample`` every entry runs its own forward (the lse kernels). Nothing is
    chosen on the way up.

    **Downward pass** over the reversed plan: decomposability makes a parse
    visit each (entry, fold, sample) at most once, so the whole selection
    state is one int64 unit index per (fold, sample), -1 where inactive,
    combined across consumers by a scatter-max. At each sum-style entry the
    choice is made at the selected output unit only: the scores ``lw[sel, m]
    + comb[m]`` are recomputed from the child values and reduced to one
    argmax or one Gumbel draw per (fold, sample) (``route_tucker2`` for the
    Tucker-2 entries). The chosen index splits into per-operand units with
    integer arithmetic and goes down through the plan's fold gathers; the
    assignment takes the selected input units' states (the mode, or one
    draw of ``sample_selected``) and scatters them to their variables.

    The memory high-water mark is a few activation-sized tensors per entry.

    With ``tp`` (a ``parallel.tensor.TPRouting``) the run is one rank's part
    of a tensor-parallel routing: the store holds the rank's unit shards of
    the flagged entries' slots, so every kernel sees local widths. Each
    flagged entry's values are gathered to full width right after it, and
    the downward choice at a flagged sum-style entry is the owning shard's:
    the selected unit is shifted into the rank's rows (``rank * O_local``),
    the other ranks' choices are masked to -1 and the max over the model
    axis keeps the owner's, a weight row is summed over the axis from the
    owner's row and the others' zeros, and a flagged input layer's sampled
    state likewise. A Tucker-2 draw is keyed by (seed, fold, row), never by
    the unit, so the owner draws the single-device draw.
    """
    name = "MAP" if kind == "max" else "Conditional sampling"
    entries = cc._entries
    num_vars = _num_vars(cc)
    sum_style = (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer)
    recs_static = []
    for entry in entries:
        layer = entry.layer
        if isinstance(layer, TorchInputLayer):
            if layer.num_variables != 1:
                raise NotImplementedError(f"{name} of multivariate input layers is not supported")
            recs_static.append(("input",))
        else:
            recs_static.append(_record(layer, name))
    folds = [entry.layer.num_folds for entry in entries]

    root_entry, root_fold = _root_position(cc, root_output, root_unit)

    def run(st: Store, xx: torch.Tensor, mk: torch.Tensor, mg: torch.Tensor | None = None,
            generator: torch.Generator | None = None):
        dev = xx.device
        bsz = xx.shape[0]
        n = len(entries)
        seeds = None
        if kind == "sample":
            # seeds[e]: the downward draw of entry e; seeds[n + e]: the input
            # state draw of entry e
            seeds = torch.randint(0, 2**62, (2 * n,), generator=generator,
                                  device=generator.device).tolist()

        def full(e: int, a: torch.Tensor) -> torch.Tensor:
            """Entry ``e``'s values (or per-unit states) at full unit width."""
            if tp is None or not tp.entry_sharded[e]:
                return a
            return tp.gather(a, entries[e].layer.num_output_units)

        # ---- upward pass: values (F, B, K), no choices ---------------------
        vals: list[torch.Tensor] = []
        inputs: dict[int, tuple] = {}
        for e, entry in enumerate(entries):
            layer = entry.layer
            xin = cc.entry_input(entry, xx, vals)
            if isinstance(layer, TorchInputLayer):
                v = _scope_vars(layer, dev)
                obs_val = full(e, layer(st, xin))  # (F, B, K)
                mgrow = free_arg = None
                if kind == "max":
                    free_val, free_arg = layer.mpe(st)  # (F, K) each
                    fv, free_arg = full(e, free_val)[:, None, :], full(e, free_arg)
                    if mg is not None:
                        # marginal MAP: summed-out variables contribute their
                        # integral instead of their mode
                        mgrow = mg[:, v].t()  # (F, B)
                        fv = torch.where(mgrow[:, :, None],
                                         full(e, layer.integrate(st))[:, None, :], fv)
                else:
                    fv = full(e, layer.integrate(st))[:, None, :]  # states drawn at assembly
                mrow = mk[:, v].t()  # (F, B)
                vals.append(torch.where(mrow[:, :, None], obs_val, fv))
                inputs[e] = (xin[..., 0], mrow, free_arg, mgrow, v)
                continue
            if kind == "max" and isinstance(layer, sum_style):
                if isinstance(layer, TorchTuckerLayer) and layer.arity == 2:
                    ls = layer._logits_slot
                    th = st[ls] if ls is not None else _max_weight(layer.weight, st)
                    vals.append(full(e, tropical_tucker2(
                        xin[:, 0].contiguous(), xin[:, 1].contiguous(), th.contiguous(),
                        log_weights=ls is not None,
                    )))
                else:
                    w = _max_weight(layer.weight, st)
                    vals.append(full(e, max_plus(safelog(w), _comb(recs_static[e][0], xin))))
            else:
                vals.append(full(e, layer(st, xin)))
        root_vals = cc.output_stack(vals)  # (O, B, K)

        # ---- downward pass: the choice at the selected unit -----------------
        sels = [torch.full((nf, bsz), -1, dtype=torch.int64, device=dev) for nf in folds]
        sels[root_entry][root_fold] = root_unit

        def push_to_children(e: int, units: list[torch.Tensor]) -> None:
            _push_to_children(cc, e, units, sels)

        draws: dict[int, torch.Tensor] = {}
        for e in range(n - 1, -1, -1):
            rec = recs_static[e]
            if rec[0] == "input":
                continue
            sel = sels[e]
            active = sel >= 0
            safe = sel.clamp_min(0)
            layer = entries[e].layer
            if rec[0] == "hadamard":
                push_to_children(e, [sel] * layer.arity)
                continue
            if rec[0] == "kronecker":
                push_to_children(e, _digits(safe, active, rec[1], rec[2]))
                continue
            tag, h, k = rec
            # max scores with the tropical weight of the upward pass; sampling
            # with the summed weight, which is the marginalized draw's
            xin = cc.entry_input(entries[e], xx, vals)
            ls = getattr(layer, "_logits_slot", None)
            if tag == "tucker" and h == 2 and ls is not None:
                th = st[ls]  # raw logits: a row constant cannot change the choice
            else:
                th = _max_weight(layer.weight, st) if kind == "max" else layer.weight(st)
            owned = None
            if tp is not None and tp.entry_sharded[e]:
                # the selected unit lives on one shard: shift it into this
                # shard's rows and mark the rows this shard owns
                o_loc = th.shape[1]
                local = safe - tp.rank * o_loc
                owned = active & (local >= 0) & (local < o_loc)
                safe = local.clamp(0, o_loc - 1)
            if tag == "tucker" and h == 2:
                m = route_tucker2(
                    xin[:, 0].contiguous(), xin[:, 1].contiguous(), th.contiguous(), safe,
                    kind=kind, log_weights=ls is not None,
                    seed=None if seeds is None else seeds[e],
                )
                if owned is not None:  # the owner's choice survives the max
                    m = tp.pmax(torch.where(owned, m, -1))
            else:
                idx = safe[:, :, None].expand(-1, -1, th.shape[2])
                row = torch.gather(th, 1, idx)  # (F, B, M)
                if owned is not None:  # the owner's row plus the others' zeros
                    row = tp.psum(torch.where(owned[:, :, None], row, 0))
                scores = _comb(tag, xin) + safelog(row)
                m = (scores.argmax(dim=-1) if kind == "max"
                     else gumbel_argmax(scores, _device_generator(seeds[e], dev)))
            draws[e] = torch.where(active, m, -1)
            if tag == "sum":
                op, unit = m // k, m % k
                units = [torch.where(active & (op == hh), unit, -1) for hh in range(h)]
            elif tag == "cpt":
                units = [torch.where(active, m, -1)] * h
            else:
                units = _digits(m, active, h, k)
            push_to_children(e, units)

        # ---- assemble the assignment ---------------------------------------
        dtype = root_vals.dtype
        out_asg = torch.zeros((bsz, num_vars), dtype=dtype, device=dev)
        for e, (xi, mrow, free_arg, mgrow, v) in inputs.items():
            sel = sels[e]
            safe = sel.clamp_min(0)
            # the state of the SELECTED unit only: the mode for MAP, one draw
            # of sample_selected for sampling
            if kind == "max":
                free = torch.gather(free_arg, 1, safe)
                if mgrow is not None:
                    free = torch.where(mgrow, 0, free)  # marginalized: no MPE state
            elif tp is not None and tp.entry_sharded[e]:
                # the selected unit's parameters live on one shard: it draws
                # with the shifted index, the others add zeros
                k_loc = vals[e].shape[2] // tp.size
                local = safe - tp.rank * k_loc
                owned = (sel >= 0) & (local >= 0) & (local < k_loc)
                drawn = entries[e].layer.sample_selected(
                    st, _device_generator(seeds[n + e], dev), local.clamp(0, k_loc - 1)
                )
                free = tp.psum(torch.where(owned, drawn.to(dtype), 0))
            else:
                free = entries[e].layer.sample_selected(
                    st, _device_generator(seeds[n + e], dev), safe
                )
            picked = torch.where(mrow, xi.to(dtype), free.to(dtype))
            out_asg.index_add_(1, v, torch.where(sel >= 0, picked, 0).t())
        out_asg = torch.where(mk, xx.to(dtype), out_asg)
        mixtures = tuple(draws[e] for e in sorted(draws))
        return out_asg, root_vals, mixtures

    return run
