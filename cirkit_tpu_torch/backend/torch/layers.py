"""Compiled layers for the PyTorch backend.

The counterpart of ``cirkit_tpu/backend/jax/layers.py:45-283, 395-504,
880-908``: layers are ``nn.Module``s whose forward reads parameters from the
store.

- inner layers:  ``forward(store, x)`` with ``x: (F, H, B, Ki) -> (F, B, Ko)``
- input layers:  ``forward(store, x)`` with ``x: (F, B, D)  -> (F, B, K)``
- constant layers: ``forward(store, batch_size)``

F is the fold axis (homogeneous layers vectorized into one kernel launch),
H the arity, B the batch. A semiring value is a tensor (a complex one under
the complex log semiring), or under the signed semiring a ``(log|f|, sign)``
pair of tensors; shape operations go through :func:`tmap`. The evidence
layer and the other input layers are not ported (see ROADMAP.md).
"""

from __future__ import annotations

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
from cirkit_tpu_torch.ops.routing import gumbel_argmax


def tmap(fn, *vs):
    """``fn`` applied to semiring values: to the tensors themselves, or to
    each component of the signed semiring's (log-magnitude, sign) pairs."""
    if isinstance(vs[0], torch.Tensor):
        return fn(*vs)
    return tuple(fn(*parts) for parts in zip(*vs))


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
    def fold_settings(self) -> tuple[Any, ...]:
        """Hashable key: layers fold together iff these match."""
        psig = tuple((n, p.fold_settings) for n, p in self.params.items())
        return (type(self).__name__, *sorted(self.config.items()), psig)

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
    """A sum or product layer: (F, H, B, Ki) -> (F, B, Ko)."""


class TorchHadamardLayer(TorchInnerLayer):
    """Elementwise semiring product over the arity axis."""

    def __init__(self, num_input_units: int, *, arity: int = 2, num_folds: int = 1, semiring=None):
        super().__init__(
            num_input_units, num_input_units, arity=arity, num_folds=num_folds, semiring=semiring
        )

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_input_units": self.num_input_units, "arity": self.arity}

    def forward(self, store: Store, x) -> torch.Tensor:
        return self.semiring.prod(x, dim=1)


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

    def forward(self, store: Store, x) -> torch.Tensor:
        out = tmap(lambda a: a[:, 0], x)  # (F, B, Ki)
        for h in range(1, self.arity):
            out = self.semiring.mul(
                tmap(lambda a: a[..., :, None], out),
                tmap(lambda a: a[:, h][..., None, :], x),
            )
            out = tmap(lambda a: a.reshape(a.shape[0], a.shape[1], -1), out)
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

    def forward(self, store: Store, x) -> torch.Tensor:
        def flat(a):
            f, h, b, ki = a.shape
            return a.transpose(1, 2).reshape(f, b, h * ki)

        x = tmap(flat, x)
        if self._logits_slot is not None:
            # Softmax-parameterized weights: the normalization runs inside
            # the contraction kernel; (F, Ko, H*Ki) is never materialized.
            return self.semiring.matmul_softmax(x, store[self._logits_slot])
        return self.semiring.matmul(x, self.weight(store))


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

    def mpe(self, store: Store) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-unit mode: the (max log-value (F, K), argmax state (F, K))
        pair under the same (possibly unnormalized) measure as ``forward``.
        Drives :class:`~cirkit_tpu_torch.backend.torch.queries.MAPQuery`."""
        raise TypeError(f"MPE is not supported for {type(self).__name__}")

    def state_distribution(self, store: Store) -> torch.Tensor:
        """Per-unit normalized finite-support state distribution
        p(x = s | unit): (F, K, S). Continuous layers raise."""
        raise TypeError(f"State distributions are not defined for {type(self).__name__}")

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

    def mpe(self, store):
        lp = self._log_probs(store)  # (F, K, C), the measure of forward
        return lp.amax(dim=2), lp.argmax(dim=2)

    def state_distribution(self, store):
        # softmax normalizes the logits-parameterized (unnormalized) case
        return torch.softmax(self._log_probs(store), dim=2)  # (F, K, C)

    def sample_selected(self, store, generator, sel):
        logits = self._log_probs(store)  # (F, K, C)
        c = logits.shape[2]
        lsel = torch.gather(logits, 1, sel[:, :, None].expand(-1, -1, c))  # (F, B, C)
        return gumbel_argmax(lsel, generator)  # -inf logits (zero probability) never win
