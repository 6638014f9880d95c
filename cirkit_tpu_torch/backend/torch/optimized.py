"""Fusion-target layers: Tucker, CP-transposed and TensorDot.

The counterpart of ``cirkit_tpu/backend/jax/optimized.py:23-211``: the
layers the optimizer rewrites into. Tucker contracts the arity inputs
against the core weight in one semiring einsum (never materializing the
Kronecker product); CP-T Hadamard-reduces then contracts; TensorDot is one
side of the two-sided contraction that the shatter rewrites split a
Kronecker-parameterized dense sum into (a squared circuit's sum layers).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from cirkit_tpu_torch.backend.torch.layers import (
    TorchInnerLayer,
    draw_rows,
    gather_units,
    softmax_logits_slot,
    tmap,
)
from cirkit_tpu_torch.backend.torch.parameters import Store, TorchParameter


class TorchTuckerLayer(TorchInnerLayer):
    """Fused sum-of-Kronecker: a multi-operand semiring einsum with the core
    weight reshaped to (F, Ko, Ki, ..., Ki)."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        arity: int = 2,
        *,
        weight: TorchParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        if arity < 2:
            raise ValueError("The arity should be at least 2")
        super().__init__(
            num_input_units, num_output_units, arity=arity, num_folds=num_folds, semiring=semiring
        )
        assert weight.shape == (num_output_units, num_input_units**arity)
        self.weight = weight
        self._logits_slot = softmax_logits_slot(weight)
        # int-axis einsum spec: inputs (f, b, k_h) each, weight (f, o, k_1..k_H)
        self._einsum = (
            tuple((0, 1, i + 2) for i in range(arity))
            + ((0, arity + 2, *(i + 2 for i in range(arity))),)
            + ((0, 1, arity + 2),)
        )

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
        if self.arity == 2:
            # The hot configuration: the fused contraction kernel, with the
            # softmax reparameterization folded into it.
            x1 = tmap(lambda a: a[:, 0], x)
            x2 = tmap(lambda a: a[:, 1], x)
            if self._logits_slot is not None:
                return self.semiring.tucker2_softmax(
                    x1, x2, store[self._logits_slot], plain=plain
                )
            return self.semiring.tucker2(x1, x2, self.weight(store), plain=plain)
        w = self.weight(store)  # (F, Ko, Ki^arity)
        w = w.reshape(-1, self.num_output_units, *(self.num_input_units,) * self.arity)
        inputs = tuple(tmap(lambda a, hh=h: a[:, hh], x) for h in range(self.arity))
        return self.semiring.einsum(
            self._einsum, inputs=inputs, operands=(w,), dim=-1, keepdim=True
        )

    def sample_mixture(self, store, generator, num_samples):
        # one composite index over the Ki^arity Kronecker inputs per (fold,
        # unit, sample), with the (normalized) core weight row
        return draw_rows(self.weight(store), generator, num_samples)

    def route(self, x, mix=None):
        # unravel the composite index row-major (the Kronecker flatten) and
        # add the chosen operands' assignments (disjoint scopes)
        f, h, k, n, d = x.shape
        out = x.new_zeros((f, mix.shape[1], n, d))
        rem = mix
        for hh in range(h - 1, -1, -1):
            out = out + gather_units(x[:, hh], rem % k)
            rem = rem // k
        return out


class TorchCPTLayer(TorchInnerLayer):
    """Fused sum-of-Hadamard (CP-transposed): semiring product over the arity
    axis followed by a dense contraction with a (F, Ko, Ki) weight."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        arity: int = 2,
        *,
        weight: TorchParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(
            num_input_units, num_output_units, arity=arity, num_folds=num_folds, semiring=semiring
        )
        assert weight.shape == (num_output_units, num_input_units)
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
        x = self.semiring.prod(x, dim=1)  # (F, B, Ki)
        if self._logits_slot is not None:
            return self.semiring.matmul_softmax(x, store[self._logits_slot], plain=plain)
        return self.semiring.matmul(x, self.weight(store), plain=plain)

    def sample_mixture(self, store, generator, num_samples):
        return draw_rows(self.weight(store), generator, num_samples)

    def route(self, x, mix=None):
        # a sum layer's routing over the Hadamard-combined inputs
        return gather_units(x.sum(dim=1), mix)


class TorchTensorDotLayer(TorchInnerLayer):
    """One side of the two-sided contraction: reshape (B, Ki) into (B, Kj,
    Kq) and contract Kj against a (F, Kk, Kj) weight, flattening (Kq, Kk)
    back into the unit axis."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        *,
        weight: TorchParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(
            num_input_units, num_output_units, arity=1, num_folds=num_folds, semiring=semiring
        )
        kk, kj = weight.shape
        if num_input_units % kj or num_output_units != kk * (num_input_units // kj):
            raise ValueError(
                f"Invalid TensorDot weight shape {weight.shape} for "
                f"Ki={num_input_units}, Ko={num_output_units}"
            )
        self.weight = weight
        self._num_contract_units = kj
        self._num_batch_units = num_input_units // kj

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_input_units": self.num_input_units,
            "num_output_units": self.num_output_units,
        }

    @property
    def params(self) -> Mapping[str, TorchParameter]:
        return {"weight": self.weight}

    def forward(self, store: Store, x, *, plain: bool = False) -> torch.Tensor:
        kq = self._num_batch_units

        def fold_in(a):
            a = a[:, 0]  # (F, B, Ki)
            f, b, _ = a.shape
            a = a.reshape(f, b, self._num_contract_units, kq).transpose(2, 3)  # (F, B, Kq, Kj)
            return a.reshape(f, b * kq, -1)

        b = (x if isinstance(x, torch.Tensor) else x[0]).shape[2]
        # Fold the Kq axis into the batch so the contraction is the fused
        # semiring matmul: (F, B*Kq, Kj) x (F, Kk, Kj) -> (F, B*Kq, Kk).
        y = self.semiring.matmul(tmap(fold_in, x), self.weight(store), plain=plain)
        return tmap(lambda a: a.reshape(a.shape[0], b, self.num_output_units), y)
