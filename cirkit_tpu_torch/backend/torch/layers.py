"""Compiled layers for the PyTorch backend.

The counterpart of ``cirkit_tpu/backend/jax/layers.py``: layers are
``nn.Module``s whose forward reads parameters from the store.

- inner layers:  ``forward(store, x)`` with ``x: (F, H, B, Ki) -> (F, B, Ko)``
- input layers:  ``forward(store, x)`` with ``x: (F, B, D)  -> (F, B, K)``
- constant layers: ``forward(store, batch_size)``

F is the fold axis (homogeneous layers vectorized into one kernel launch),
H the arity, B the batch. A semiring value is a tensor (a complex one under
the complex log semiring), or under the signed semiring a ``(log|f|, sign)``
pair of tensors; shape operations go through :func:`tmap`.

Input layers carry the hooks the queries and EM call: ``integrate``,
``mpe``, ``state_distribution`` and ``sample_selected``, and those of the
expectation, top-k and entropy queries, ``mean_state``,
``second_moment_state``, ``cdf_state``, ``topk_modes``, ``unit_entropy`` and
``unit_kl`` (``cirkit_tpu/backend/jax/layers.py:325-380``). A layer that
does not define one raises ``TypeError``, as in the JAX package.

The dense bottom-up sampler (``SamplingQuery`` off the lse-sum semiring)
calls ``sample``: an input layer draws (F, K, N) states, an inner layer
routes its inputs' (F, H, K, N, D) assignments to (F, Ko, N, D). A sum-style
layer's ``sample`` is two steps, a draw of one mixture index per (fold,
unit, sample) (``sample_mixture``, by the inverse CDF of each weight row:
one uniform a draw and ``torch.searchsorted`` over the row's running sums,
where the JAX package broadcasts the logits to (F, Ko, N, M)) and a
deterministic gather (``route``).
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

from cirkit_tpu_torch.backend.torch.parameters import (
    Store,
    TorchParameter,
    TorchSoftmaxParameter,
    TorchTensorSlot,
)
from cirkit_tpu_torch.backend.torch.semiring import (
    LSESumSemiring,
    Semiring,
    SumProductSemiring,
)
from cirkit_tpu_torch.backend.torch.utils import safelog, softplus
from cirkit_tpu_torch.ops.routing import gumbel_argmax


def tmap(fn, *vs):
    """``fn`` applied to semiring values: to the tensors themselves, or to
    each component of the signed semiring's (log-magnitude, sign) pairs."""
    if isinstance(vs[0], torch.Tensor):
        return fn(*vs)
    return tuple(fn(*parts) for parts in zip(*vs))


def _topk_states(lp: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-t over a per-state log-score table (F, K, S): (values
    (F, K, t), states (F, K, t)), descending, ``-inf``-padded when t > S.
    A stable descending sort keeps the lower state first among equal
    scores, the tie rule of ``jax.lax.top_k``."""
    tt = min(t, lp.shape[2])
    vals, idx = torch.sort(lp, dim=2, descending=True, stable=True)
    vals, idx = vals[..., :tt], idx[..., :tt]
    if tt < t:
        pad = torch.full((*vals.shape[:2], t - tt), -math.inf, dtype=vals.dtype,
                         device=vals.device)
        vals = torch.cat([vals, pad], dim=2)
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:2], t - tt)], dim=2)
    return vals, idx


def draw_rows(w: torch.Tensor, generator: torch.Generator, num_samples: int) -> torch.Tensor:
    """``num_samples`` draws from each row of the nonnegative (..., M)
    table ``w``, each column with probability ``w / w.sum(-1)``: (..., N)
    int64. The inverse CDF over the row's running sums with one uniform a
    draw: the first column whose running sum exceeds ``u`` times the row's
    total, so a column of zero weight is never drawn (where rounding leaves
    ``u`` times the total at the total, the last column with weight).
    Weights that are complex or negative are no probabilities and raise."""
    if w.is_complex() or bool((w < 0).any()):
        raise ValueError("Sampling reads the weights as probabilities: they must be real and "
                         "nonnegative")
    cw = w.cumsum(dim=-1)
    u = torch.rand((*w.shape[:-1], num_samples), generator=generator, dtype=w.dtype,
                   device=w.device)
    idx = torch.searchsorted(cw, u * cw[..., -1:], right=True)
    last = w.shape[-1] - 1 - (w > 0).flip(-1).to(torch.int8).argmax(dim=-1, keepdim=True)
    return torch.minimum(idx, last)


def gather_units(x: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """``x[f, mix[f, o, n], n]``: the (F, O, N, D) assignments of the units
    ``mix`` (F, O, N) selects from ``x`` (F, M, N, D)."""
    f, _, n = mix.shape
    folds = torch.arange(f, device=x.device)[:, None, None]
    rows = torch.arange(n, device=x.device)[None, None, :]
    return x[folds, mix, rows]


def _discrete_cdf(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P(x <= t | unit) from a per-unit state table: ``p`` (F, K, S),
    thresholds ``t`` (F, B) -> (F, B, K). Non-integer thresholds floor (a
    step CDF); below the support gives 0, above it 1."""
    states = torch.arange(p.shape[2], dtype=p.dtype, device=p.device)
    mask = (states[None, None, :] <= t[:, :, None]).to(p.dtype)  # (F, B, S)
    return torch.einsum("fks,fbs->fbk", p, mask)


def _entropy(lp: torch.Tensor) -> torch.Tensor:
    """The entropy of normalized log-probabilities over the last axis."""
    p = torch.exp(lp)
    return -torch.where(p > 0, p * lp, 0.0).sum(dim=2)


def _moment(p: torch.Tensor, power: int) -> torch.Tensor:
    """``sum_s p[..., s] s^power`` over a (F, K, S) state table."""
    states = torch.arange(p.shape[2], dtype=p.dtype, device=p.device)
    return torch.einsum("fks,s->fk", p, states**power)


def softmax_logits_slot(param: TorchParameter) -> str | None:
    """If ``param`` is exactly ``TensorSlot -> Softmax(last axis)``, return
    the slot name, else None. Layers use this to route the most common sum
    parameterization to the softmax-fused kernels, so the normalized weights
    are never materialized in device memory."""
    nodes = list(param.topological_ordering())
    if len(nodes) != 2:
        return None
    slot, sm = nodes
    if not isinstance(slot, TorchTensorSlot) or not isinstance(sm, TorchSoftmaxParameter):
        return None
    if sm.axis != len(slot.shape) - 1:
        return None
    return slot.slot


class TorchLayer(nn.Module, ABC):
    """The abstract compiled layer."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        *,
        arity: int = 1,
        num_folds: int = 1,
        semiring: Semiring | None = None,
    ):
        super().__init__()
        self.num_input_units = num_input_units
        self.num_output_units = num_output_units
        self.arity = arity
        self.num_folds = num_folds
        self.semiring: Semiring = SumProductSemiring if semiring is None else semiring

    @property
    @abstractmethod
    def config(self) -> Mapping[str, Any]:
        """Static hyperparameters (folding groups on these)."""

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        """Compiled parameter graphs by name."""
        return {}

    @property
    def sub_modules(self) -> Mapping[str, "TorchLayer"]:
        """Nested layers (the inner layer of an evidence layer)."""
        return {}

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        """Hashable key: layers fold together iff these match."""
        psig = tuple((n, p.fold_settings) for n, p in self.params.items())
        msig = tuple((n, m.fold_settings) for n, m in self.sub_modules.items())
        return (type(self).__name__, *sorted(self.config.items()), psig, msig)

    @abstractmethod
    def forward(self, store: Store, x) -> torch.Tensor: ...

    def extra_repr(self) -> str:
        return (
            f"F={self.num_folds}, arity={self.arity}, "
            f"Ki={self.num_input_units}, Ko={self.num_output_units}"
        )


# --------------------------------------------------------------------------- #
# Inner layers
# --------------------------------------------------------------------------- #


class TorchInnerLayer(TorchLayer, ABC):
    """A sum or product layer: (F, H, B, Ki) -> (F, B, Ko). ``forward``
    takes ``plain``: True contracts through the semiring ops' plain
    compositions instead of the kernels (see ``TorchCircuit.evaluate``)."""

    @abstractmethod
    def forward(self, store: Store, x, *, plain: bool = False) -> torch.Tensor: ...

    def sample(self, store: Store, generator: torch.Generator, x: torch.Tensor):
        """Route samples upward: ``x`` (F, H, K, N, D) holds per-unit
        variable assignments; returns ((F, Ko, N, D), the (F, Ko, N) mixture
        indices drawn, or None for a product layer)."""
        mix = self.sample_mixture(store, generator, x.shape[3])
        return self.route(x, mix), mix

    def sample_mixture(self, store: Store, generator: torch.Generator,
                       num_samples: int) -> torch.Tensor | None:
        """The draw of :meth:`sample`: one input index per (fold, output
        unit, sample), (F, Ko, N); None where the layer draws nothing."""
        return None

    def route(self, x: torch.Tensor, mix: torch.Tensor | None = None) -> torch.Tensor:
        """The deterministic half of :meth:`sample`: the (F, Ko, N, D)
        assignments of the output units from ``x`` and the drawn ``mix``."""
        raise TypeError(f"Sampling is not supported for {type(self).__name__}")


class TorchHadamardLayer(TorchInnerLayer):
    """Elementwise semiring product over the arity axis."""

    def __init__(self, num_input_units: int, *, arity: int = 2, num_folds: int = 1, semiring=None):
        super().__init__(
            num_input_units, num_input_units, arity=arity, num_folds=num_folds, semiring=semiring
        )

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_input_units": self.num_input_units, "arity": self.arity}

    def forward(self, store: Store, x, *, plain: bool = False) -> torch.Tensor:
        return self.semiring.prod(x, dim=1)

    def route(self, x, mix=None):
        # disjoint scopes: add the zero-padded per-operand assignments
        return x.sum(dim=1)


class TorchKroneckerLayer(TorchInnerLayer):
    """Iterated semiring outer product, flattened row-major (the unit for
    inputs (i_1, ..., i_H) sits at index i_1 * Ki^(H-1) + ... + i_H)."""

    def __init__(self, num_input_units: int, *, arity: int = 2, num_folds: int = 1, semiring=None):
        super().__init__(
            num_input_units,
            int(num_input_units**arity),
            arity=arity,
            num_folds=num_folds,
            semiring=semiring,
        )

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_input_units": self.num_input_units, "arity": self.arity}

    def forward(self, store: Store, x, *, plain: bool = False) -> torch.Tensor:
        out = tmap(lambda a: a[:, 0], x)  # (F, B, Ki)
        for h in range(1, self.arity):
            out = self.semiring.mul(
                tmap(lambda a: a[..., :, None], out),
                tmap(lambda a: a[:, h][..., None, :], x),
            )
            out = tmap(lambda a: a.reshape(a.shape[0], a.shape[1], -1), out)
        return out

    def route(self, x, mix=None):
        # every unit pairing, flattened row-major as the forward's
        out = x[:, 0]
        for h in range(1, self.arity):
            f, k, n, d = out.shape
            out = (out[:, :, None] + x[:, h][:, None]).reshape(f, k * x.shape[2], n, d)
        return out


class TorchSumLayer(TorchInnerLayer):
    """The dense sum layer: a semiring einsum contracting (H, Ki) against a
    (F, Ko, H*Ki) weight; the lse-sum semiring runs it through the fused
    log-einsum-exp kernel."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        *,
        arity: int = 1,
        weight: TorchParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(
            num_input_units, num_output_units, arity=arity, num_folds=num_folds, semiring=semiring
        )
        assert weight.shape == (num_output_units, arity * num_input_units), (
            weight.shape,
            (num_output_units, arity * num_input_units),
        )
        self.weight = weight
        self._logits_slot = softmax_logits_slot(weight)

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_input_units": self.num_input_units,
            "num_output_units": self.num_output_units,
            "arity": self.arity,
        }

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        return {"weight": self.weight}

    def forward(self, store: Store, x, *, plain: bool = False) -> torch.Tensor:
        def flat(a):
            f, h, b, ki = a.shape
            return a.transpose(1, 2).reshape(f, b, h * ki)

        x = tmap(flat, x)
        if self._logits_slot is not None:
            # Softmax-parameterized weights: the normalization runs inside
            # the contraction kernel; (F, Ko, H*Ki) is never materialized.
            return self.semiring.matmul_softmax(x, store[self._logits_slot], plain=plain)
        return self.semiring.matmul(x, self.weight(store), plain=plain)

    def sample_mixture(self, store, generator, num_samples):
        # latent-variable semantics: each output unit mixes over its H*Ki
        # inputs with its (nonnegative) weight row
        return draw_rows(self.weight(store), generator, num_samples)

    def route(self, x, mix=None):
        f, h, k, n, d = x.shape
        return gather_units(x.reshape(f, h * k, n, d), mix)


# --------------------------------------------------------------------------- #
# Input layers
# --------------------------------------------------------------------------- #


class TorchInputLayer(TorchLayer, ABC):
    """An input layer: consumes the gathered data slice (F, B, D)."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        num_folds: int = 1,
        semiring=None,
    ):
        scope_idx = np.atleast_2d(np.asarray(scope_idx, dtype=np.int64))
        assert scope_idx.shape[0] == num_folds, (scope_idx.shape, num_folds)
        super().__init__(
            scope_idx.shape[1], num_output_units, arity=1, num_folds=num_folds, semiring=semiring
        )
        self.scope_idx = scope_idx

    @property
    def num_variables(self) -> int:
        return self.num_input_units

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        return (self.num_variables, *super().fold_settings)

    # The query hooks (``backend/torch/queries.py``); a layer that does not
    # support one raises.
    def integrate(self, store: Store) -> torch.Tensor:
        """The layer's integral over its variables' domain: (F, K)."""
        raise TypeError(f"Integration is not supported for {type(self).__name__}")

    def sample(self, store: Store, generator: torch.Generator, num_samples: int) -> torch.Tensor:
        """``num_samples`` draws of each unit's distribution: (F, K, N)."""
        raise TypeError(f"Sampling is not supported for {type(self).__name__}")

    def mpe(self, store: Store) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-unit mode: the (max log-value (F, K), argmax state (F, K))
        pair under the same (possibly unnormalized) measure as ``forward``.
        Drives :class:`~cirkit_tpu_torch.backend.torch.queries.MAPQuery`."""
        raise TypeError(f"MPE is not supported for {type(self).__name__}")

    def state_distribution(self, store: Store) -> torch.Tensor:
        """Per-unit normalized finite-support state distribution
        p(x = s | unit): (F, K, S). Continuous layers raise."""
        raise TypeError(f"State distributions are not defined for {type(self).__name__}")

    def mean_state(self, store: Store) -> torch.Tensor:
        """Per-unit expected state E[x | unit]: (F, K). Drives the posterior
        expectations of :class:`~cirkit_tpu_torch.backend.torch.queries.ExpectationQuery`."""
        raise TypeError(f"Expected states are not defined for {type(self).__name__}")

    def second_moment_state(self, store: Store) -> torch.Tensor:
        """Per-unit second moment E[x^2 | unit]: (F, K); with
        :meth:`mean_state` it gives exact posterior variances."""
        raise TypeError(f"Second moments are not defined for {type(self).__name__}")

    def cdf_state(self, store: Store, t: torch.Tensor) -> torch.Tensor:
        """Per-unit CDF P(x <= t | unit) at per-(fold, sample) thresholds
        ``t`` (F, B): (F, B, K). Defined for continuous layers too."""
        raise TypeError(f"CDFs are not defined for {type(self).__name__}")

    def unit_entropy(self, store: Store) -> torch.Tensor:
        """Entropy (nats) of each unit's normalized distribution: (F, K)."""
        raise TypeError(f"Entropies are not defined for {type(self).__name__}")

    def unit_kl(self, store_p: Store, store_q: Store) -> torch.Tensor:
        """KL(p || q) (nats) between each unit's normalized distributions
        under two parameter stores: (F, K)."""
        raise TypeError(f"KL divergences are not defined for {type(self).__name__}")

    def topk_modes(self, store: Store, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The ``t`` best states per unit, descending: (values (F, K, t),
        states (F, K, t)). This base version is the mode followed by
        ``-inf``: exact for a continuous layer, whose maximizer is one
        point. Finite-support layers rank every state."""
        val, arg = self.mpe(store)
        pad = torch.full((*val.shape, t - 1), -math.inf, dtype=val.dtype, device=val.device)
        return torch.cat([val[..., None], pad], dim=-1), arg[..., None].expand(*arg.shape, t)

    def sample_selected(
        self, store: Store, generator: torch.Generator, sel: torch.Tensor
    ) -> torch.Tensor:
        """One draw per (fold, sample) from the SELECTED unit only: ``sel`` is
        an (F, B) int64 unit index; returns (F, B) states. The lazy draw of
        conditional sampling's downward pass: one unit per (fold, sample) is
        on the parse, so the other K - 1 units are never drawn."""
        raise TypeError(f"Sampling is not supported for {type(self).__name__}")


class TorchConstantInputLayer(TorchInputLayer, ABC):
    """An input layer over the empty scope: forward takes the batch size."""

    def __init__(self, num_output_units: int, *, num_folds: int = 1, semiring=None):
        super().__init__(
            np.empty((num_folds, 0), dtype=np.int64),
            num_output_units,
            num_folds=num_folds,
            semiring=semiring,
        )


class TorchConstantValueLayer(TorchConstantInputLayer):
    """A constant vector, possibly encoded in log-space."""

    def __init__(
        self,
        num_output_units: int,
        *,
        log_space: bool = False,
        value: TorchParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(num_output_units, num_folds=num_folds, semiring=semiring)
        self.value = value
        self.log_space = log_space
        self._source = LSESumSemiring if log_space else SumProductSemiring

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units, "log_space": self.log_space}

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        return {"value": self.value}

    def forward(self, store: Store, batch_size: int) -> torch.Tensor:
        v = self.value(store)  # (F, K)
        v = v[:, None, :].expand(v.shape[0], batch_size, v.shape[1])
        return self.semiring.map_from(v, self._source)


class TorchPolynomialLayer(TorchInputLayer):
    """Univariate polynomials evaluated by Horner's method."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        degree: int,
        coeff: TorchParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        self.degree = degree
        self.coeff = coeff

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units, "degree": self.degree}

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        return {"coeff": self.coeff}

    def forward(self, store: Store, x) -> torch.Tensor:
        coeff = self.coeff(store)  # (F, K, deg+1)
        xi = x[..., :1].to(coeff.dtype)  # (F, B, 1)
        out = torch.zeros(
            (xi.shape[0], xi.shape[1], coeff.shape[1]), dtype=coeff.dtype, device=coeff.device
        )
        for d in range(coeff.shape[-1] - 1, -1, -1):
            out = out * xi + coeff[:, None, :, d]
        return self.semiring.map_from(out, SumProductSemiring)


class TorchExpFamilyLayer(TorchInputLayer, ABC):
    """Exponential-family input layers: define the (possibly unnormalized)
    log likelihood and log partition function."""

    def forward(self, store: Store, x) -> torch.Tensor:
        ll = self.log_unnormalized_likelihood(store, x)
        return self.semiring.map_from(ll, LSESumSemiring)

    def integrate(self, store: Store) -> torch.Tensor:
        return self.semiring.map_from(self.log_partition_function(store), LSESumSemiring)

    @abstractmethod
    def log_unnormalized_likelihood(self, store: Store, x) -> torch.Tensor: ...

    @abstractmethod
    def log_partition_function(self, store: Store) -> torch.Tensor: ...


class TorchCategoricalLayer(TorchExpFamilyLayer):
    """Categorical units: normalized under probs, unnormalized under logits."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        num_categories: int,
        probs: TorchParameter | None = None,
        logits: TorchParameter | None = None,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        if (logits is None) == (probs is None):
            raise ValueError("Exactly one of 'logits' and 'probs' must be given")
        self.num_categories = num_categories
        self.probs = probs
        self.logits = logits
        # Softmax-parameterized probs (the image_data default): one fused
        # log_softmax over the raw logits instead of log(softmax(theta)).
        self._probs_logits_slot = None if probs is None else softmax_logits_slot(probs)

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_output_units": self.num_output_units,
            "num_categories": self.num_categories,
        }

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        if self.logits is None:
            return {"probs": self.probs}
        return {"logits": self.logits}

    def _log_probs(self, store: Store) -> torch.Tensor:
        if self.logits is None:
            if self._probs_logits_slot is not None:
                return torch.log_softmax(store[self._probs_logits_slot], dim=-1)
            return torch.log(self.probs(store))
        return self.logits(store)

    def log_unnormalized_likelihood(self, store, x):
        logits = self._log_probs(store)  # (F, K, C)
        # A gather with the clamping of the JAX package's one-hot matmul:
        # indices clip to the category range, and -inf log-probs become the
        # finite minimum.
        logits = logits.clamp_min(torch.finfo(logits.dtype).min)
        xi = x[..., 0].long().clamp(0, logits.shape[2] - 1)  # (F, B)
        # Advanced indexing, not torch.gather: its backward (index_put_ with
        # accumulate) sorts the indices and sums the rows that share a
        # category in a fixed order, where gather's scatter_add_ uses atomic
        # adds in whatever order they land, so training would not repeat.
        folds = torch.arange(logits.shape[0], device=logits.device)[:, None]
        return logits.transpose(1, 2)[folds, xi]  # (F, B, K)

    def log_partition_function(self, store):
        if self.logits is None:
            p = self.probs(store)
            return torch.zeros(
                (self.num_folds, self.num_output_units), dtype=p.dtype, device=p.device
            )
        return torch.logsumexp(self.logits(store), dim=2)

    def sample(self, store, generator, num_samples):
        return draw_rows(self.state_distribution(store), generator, num_samples)

    def mpe(self, store):
        lp = self._log_probs(store)  # (F, K, C), the measure of forward
        return lp.amax(dim=2), lp.argmax(dim=2)

    def state_distribution(self, store):
        # softmax normalizes the logits-parameterized (unnormalized) case
        return torch.softmax(self._log_probs(store), dim=2)  # (F, K, C)

    def mean_state(self, store):
        return _moment(self.state_distribution(store), 1)

    def second_moment_state(self, store):
        return _moment(self.state_distribution(store), 2)

    def cdf_state(self, store, t):
        return _discrete_cdf(self.state_distribution(store), t)

    def unit_entropy(self, store):
        return _entropy(torch.log_softmax(self._log_probs(store), dim=2))

    def unit_kl(self, store_p, store_q):
        lp = torch.log_softmax(self._log_probs(store_p), dim=2)
        lq = torch.log_softmax(self._log_probs(store_q), dim=2)
        p = torch.exp(lp)
        # p > 0 where q = 0 gives +inf (a support violation)
        return torch.where(p > 0, p * (lp - lq), 0.0).sum(dim=2)

    def topk_modes(self, store, t):
        return _topk_states(self._log_probs(store), t)

    def sample_selected(self, store, generator, sel):
        logits = self._log_probs(store)  # (F, K, C)
        c = logits.shape[2]
        lsel = torch.gather(logits, 1, sel[:, :, None].expand(-1, -1, c))  # (F, B, C)
        return gumbel_argmax(lsel, generator)  # -inf logits (zero probability) never win


class TorchEmbeddingLayer(TorchInputLayer):
    """Embedding units: one weight column per observed state."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        num_states: int = 2,
        weight: TorchParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        self.num_states = num_states
        self.weight = weight

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units, "num_states": self.num_states}

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        return {"weight": self.weight}

    def forward(self, store: Store, x) -> torch.Tensor:
        w = self.weight(store)  # (F, K, N)
        # states clip to the range, as the JAX package's one-hot matmul does;
        # indexed as the categorical layer is, so the backward sums in a
        # fixed order
        xi = x[..., 0].long().clamp(0, w.shape[2] - 1)  # (F, B)
        folds = torch.arange(w.shape[0], device=w.device)[:, None]
        return self.semiring.map_from(w.transpose(1, 2)[folds, xi], SumProductSemiring)

    def integrate(self, store):
        return self.semiring.map_from(self.weight(store).sum(dim=2), SumProductSemiring)

    def mpe(self, store):
        lw = safelog(self.weight(store))  # (F, K, S)
        return lw.amax(dim=2), lw.argmax(dim=2)

    def state_distribution(self, store):
        # the unit's weights normalized over the states (nonnegative weights)
        w = self.weight(store)  # (F, K, S)
        return w / w.sum(dim=2, keepdim=True).clamp_min(torch.finfo(w.dtype).tiny)

    def topk_modes(self, store, t):
        return _topk_states(safelog(self.weight(store)), t)

    def mean_state(self, store):
        return _moment(self.state_distribution(store), 1)

    def second_moment_state(self, store):
        return _moment(self.state_distribution(store), 2)

    def cdf_state(self, store, t):
        return _discrete_cdf(self.state_distribution(store), t)

    def unit_entropy(self, store):
        p = self.state_distribution(store)
        return -torch.where(p > 0, p * safelog(p), 0.0).sum(dim=2)

    def unit_kl(self, store_p, store_q):
        p = self.state_distribution(store_p)
        q = self.state_distribution(store_q)
        return torch.where(p > 0, p * (safelog(p) - safelog(q)), 0.0).sum(dim=2)


def _log_comb(n: int, k: torch.Tensor) -> torch.Tensor:
    """log C(n, k) for counts ``k`` of a float dtype."""
    return math.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)


class TorchBinomialLayer(TorchExpFamilyLayer):
    """Binomial units (always normalized)."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        total_count: int = 1,
        probs: TorchParameter | None = None,
        logits: TorchParameter | None = None,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        if (logits is None) == (probs is None):
            raise ValueError("Exactly one of 'logits' and 'probs' must be given")
        self.total_count = total_count
        self.probs = probs
        self.logits = logits

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units, "total_count": self.total_count}

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        if self.logits is None:
            return {"probs": self.probs}
        return {"logits": self.logits}

    def _logits(self, store) -> torch.Tensor:
        if self.logits is None:
            p = self.probs(store)
            return torch.log(p) - torch.log1p(-p)
        return self.logits(store)

    def log_unnormalized_likelihood(self, store, x):
        n = self.total_count
        logits = self._logits(store)[:, None, :]  # (F, 1, K)
        k = x[..., :1].to(logits.dtype)  # (F, B, 1) counts
        return _log_comb(n, k) + k * logits - n * softplus(logits)

    def log_partition_function(self, store):
        ref = self._logits(store)
        return torch.zeros((self.num_folds, self.num_output_units), dtype=ref.dtype,
                           device=ref.device)

    def _log_pmf_table(self, store) -> torch.Tensor:
        """The (F, K, n+1) log-pmf table over the counts 0..n."""
        logits = self._logits(store)[:, :, None]  # (F, K, 1)
        n = self.total_count
        counts = torch.arange(n + 1, dtype=logits.dtype, device=logits.device)
        return _log_comb(n, counts) + counts * logits - n * softplus(logits)

    def mpe(self, store):
        logits = self._logits(store)  # (F, K)
        n = self.total_count
        mode = torch.floor((n + 1) * torch.sigmoid(logits)).clamp(0, n)  # the binomial mode
        return _log_comb(n, mode) + mode * logits - n * softplus(logits), mode.long()

    def state_distribution(self, store):
        return torch.exp(self._log_pmf_table(store))  # (F, K, n+1)

    def sample(self, store, generator, num_samples):
        p = torch.sigmoid(self._logits(store))[:, :, None].expand(-1, -1, num_samples)
        count = torch.full_like(p, float(self.total_count))
        return torch.binomial(count, p.contiguous(), generator=generator)

    def mean_state(self, store):
        return self.total_count * torch.sigmoid(self._logits(store))  # (F, K)

    def second_moment_state(self, store):
        n = self.total_count
        p = torch.sigmoid(self._logits(store))
        return n * p * (1.0 - p) + torch.square(n * p)

    def cdf_state(self, store, t):
        return _discrete_cdf(self.state_distribution(store), t)

    def unit_entropy(self, store):
        return _entropy(self._log_pmf_table(store))

    def unit_kl(self, store_p, store_q):
        # KL(Bin(n, p1) || Bin(n, p2)) = n KL(Bern(p1) || Bern(p2)), in log
        # space through log sigmoid(l) = -softplus(-l)
        l1 = self._logits(store_p)
        l2 = self._logits(store_q)
        p1 = torch.sigmoid(l1)
        pos = -softplus(-l1) + softplus(-l2)  # log p1 - log p2
        neg = -softplus(l1) + softplus(l2)  # log(1 - p1) - log(1 - p2)
        return self.total_count * (p1 * pos + (1.0 - p1) * neg)

    def topk_modes(self, store, t):
        # the whole (n+1)-state log-pmf table, ranked exactly
        return _topk_states(self._log_pmf_table(store), t)

    def sample_selected(self, store, generator, sel):
        p = torch.sigmoid(self._logits(store))  # (F, K)
        psel = torch.gather(p, 1, sel)  # (F, B)
        u = torch.rand((self.total_count, *psel.shape), generator=generator, dtype=p.dtype,
                       device=p.device)
        return (u < psel[None]).sum(dim=0).to(p.dtype)


class TorchGaussianLayer(TorchExpFamilyLayer):
    """Gaussian units, unnormalized by an optional log-partition parameter."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        mean: TorchParameter,
        stddev: TorchParameter,
        log_partition: TorchParameter | None = None,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        self.mean = mean
        self.stddev = stddev
        self.log_partition = log_partition

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units}

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        p = {"mean": self.mean, "stddev": self.stddev}
        if self.log_partition is not None:
            p["log_partition"] = self.log_partition
        return p

    def log_unnormalized_likelihood(self, store, x):
        mean = self.mean(store)[:, None, :]  # (F, 1, K)
        stddev = self.stddev(store)[:, None, :]
        z = (x[..., :1].to(mean.dtype) - mean) / stddev  # (F, B, K)
        ll = -0.5 * torch.square(z) - torch.log(stddev) - 0.5 * math.log(2.0 * math.pi)
        if self.log_partition is not None:
            ll = ll + self.log_partition(store)[:, None, :]
        return ll

    def log_partition_function(self, store):
        if self.log_partition is None:
            ref = self.mean(store)
            return torch.zeros((self.num_folds, self.num_output_units), dtype=ref.dtype,
                               device=ref.device)
        return self.log_partition(store)

    def mpe(self, store):
        mean = self.mean(store)  # (F, K)
        val = -torch.log(self.stddev(store)) - 0.5 * math.log(2.0 * math.pi)  # density at mean
        if self.log_partition is not None:
            val = val + self.log_partition(store)
        return val, mean

    def sample(self, store, generator, num_samples):
        mean = self.mean(store)[:, :, None]  # (F, K, 1)
        eps = torch.randn((*mean.shape[:2], num_samples), generator=generator,
                          dtype=mean.dtype, device=mean.device)
        return mean + self.stddev(store)[:, :, None] * eps

    def mean_state(self, store):
        return self.mean(store)  # (F, K)

    def second_moment_state(self, store):
        return torch.square(self.mean(store)) + torch.square(self.stddev(store))

    def cdf_state(self, store, t):
        z = (t[:, :, None] - self.mean(store)[:, None, :]) / self.stddev(store)[:, None, :]
        return torch.special.ndtr(z)

    def unit_entropy(self, store):
        # the differential entropy of N(mu, sigma); a log_partition scaling
        # leaves the normalized distribution unchanged
        return 0.5 * (1.0 + math.log(2.0 * math.pi)) + torch.log(self.stddev(store))

    def unit_kl(self, store_p, store_q):
        mp, sp = self.mean(store_p), self.stddev(store_p)
        mq, sq = self.mean(store_q), self.stddev(store_q)
        return (torch.log(sq / sp) + (torch.square(sp) + torch.square(mp - mq))
                / (2.0 * torch.square(sq)) - 0.5)

    def sample_selected(self, store, generator, sel):
        mean = torch.gather(self.mean(store), 1, sel)  # (F, B)
        stddev = torch.gather(self.stddev(store), 1, sel)
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
        return mean + stddev * eps


class TorchEvidenceLayer(TorchConstantInputLayer):
    """A wrapped input layer evaluated on a stored observation."""

    def __init__(
        self,
        layer: TorchInputLayer,
        *,
        observation: TorchParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(layer.num_output_units, num_folds=num_folds, semiring=semiring)
        self.layer = layer
        self.observation = observation

    @property
    def config(self) -> Mapping[str, Any]:
        return {}

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        return {"observation": self.observation}

    @property
    def sub_modules(self) -> Mapping[str, TorchLayer]:
        return {"layer": self.layer}

    def forward(self, store: Store, batch_size: int) -> torch.Tensor:
        obs = self.observation(store)[:, None, :]  # (F, 1, D)
        out = self.layer(store, obs)  # (F, 1, K)
        return tmap(lambda o: o.expand(o.shape[0], batch_size, o.shape[2]), out)

    def sample(self, store: Store, generator, num_samples: int) -> torch.Tensor:
        """The observation, repeated: (F, K, N)."""
        obs = self.observation(store)  # (F, 1)
        return obs[:, :, None].expand(self.num_folds, self.num_output_units, num_samples)

    def sample_selected(self, store, generator, sel):
        return self.sample(store, generator, sel.shape[1])[:, 0, :]  # every unit alike
