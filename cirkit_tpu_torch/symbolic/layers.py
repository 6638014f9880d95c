"""Symbolic layers: the node taxonomy of the circuit IR.

Rebuild of ``cirkit/symbolic/layers.py:19-757``. Symbolic layers carry only
metadata (unit counts, arity, scope, symbolic parameters) — the backend
decides precision, folding and kernels.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Mapping
from enum import IntEnum, auto
from typing import Any

from cirkit_tpu_torch.symbolic.initializers import NormalInitializer
from cirkit_tpu_torch.symbolic.parameters import (
    Parameter,
    ParameterFactory,
    ScaledSigmoidParameter,
    SigmoidParameter,
    SoftmaxParameter,
    TensorParameter,
)
from cirkit_tpu_torch.utils.scope import Scope


class LayerOperator(IntEnum):
    """The symbolic operators defined over layers."""

    INTEGRATION = auto()
    DIFFERENTIATION = auto()
    MULTIPLICATION = auto()
    CONJUGATION = auto()


def _default_parameter(
    shape: tuple[int, ...], factory: ParameterFactory | None
) -> Parameter:
    if factory is not None:
        return factory(shape)
    return Parameter.from_input(TensorParameter(*shape, initializer=NormalInitializer()))


def _check_param_shape(name: str, p: Parameter, shape: tuple[int, ...]) -> None:
    if p.shape != shape:
        raise ValueError(f"Expected {name} of shape {shape}, found {p.shape}")


class Layer(ABC):
    """The abstract symbolic layer: unit counts, arity, config and params."""

    def __init__(self, num_input_units: int, num_output_units: int, arity: int = 1):
        if num_input_units < 0:
            raise ValueError("The number of input units must be non-negative")
        if num_output_units <= 0:
            raise ValueError("The number of output units must be positive")
        if arity <= 0:
            raise ValueError("The arity must be positive")
        self.num_input_units = num_input_units
        self.num_output_units = num_output_units
        self.arity = arity

    @property
    @abstractmethod
    def config(self) -> Mapping[str, Any]:
        """Hyperparameters keyed by ``__init__`` argument names."""

    @property
    def params(self) -> Mapping[str, Parameter]:
        """Symbolic parameters keyed by ``__init__`` argument names."""
        return {}

    def copyref(self) -> "Layer":
        """A shallow copy sharing all parameters by reference."""
        kwargs: dict[str, Any] = {k: p.ref() for k, p in self.params.items()}
        kwargs.update(self.config)
        return type(self)(**kwargs)

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v}" for k, v in self.config.items())
        return f"{type(self).__name__}({cfg})"


class InputLayer(Layer, ABC):
    """A layer at the circuit frontier, defined over a variable scope."""

    def __init__(self, scope: Scope, num_output_units: int):
        if num_output_units <= 0:
            raise ValueError("The number of output units must be positive")
        super().__init__(len(scope), num_output_units)
        self.scope = scope

    @property
    def num_variables(self) -> int:
        return self.num_input_units


class ConstantLayer(InputLayer, ABC):
    """An input layer over the empty scope: a constant function."""

    def __init__(self, num_output_units: int):
        super().__init__(Scope([]), num_output_units)


class EvidenceLayer(ConstantLayer):
    """An input layer pinned to a complete observation of its variables."""

    def __init__(self, layer: InputLayer, *, observation: Parameter):
        if len(observation.shape) != 1:
            raise ValueError(
                f"Expected observation of shape (num_variables,), found {observation.shape}"
            )
        if observation.shape[0] != layer.num_variables:
            raise ValueError(
                f"Expected an observation over {layer.num_variables} variables, "
                f"found {observation.shape[0]}"
            )
        super().__init__(layer.num_output_units)
        self.layer = layer
        self.observation = observation

    @property
    def config(self) -> Mapping[str, Any]:
        return {"layer": self.layer}

    @property
    def params(self) -> Mapping[str, Parameter]:
        return {"observation": self.observation}


class EmbeddingLayer(InputLayer):
    """A univariate embedding over a finite-state variable: (K, N) weights."""

    def __init__(
        self,
        scope: Scope,
        num_output_units: int,
        *,
        num_states: int = 2,
        weight: Parameter | None = None,
        weight_factory: ParameterFactory | None = None,
    ):
        if len(scope) != 1:
            raise ValueError("The Embedding layer encodes univariate functions")
        if num_states <= 1:
            raise ValueError("The number of states must be at least 2")
        super().__init__(scope, num_output_units)
        self.num_states = num_states
        shape = (num_output_units, num_states)
        if weight is None:
            weight = _default_parameter(shape, weight_factory)
        _check_param_shape("weight", weight, shape)
        self.weight = weight

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "scope": self.scope,
            "num_output_units": self.num_output_units,
            "num_states": self.num_states,
        }

    @property
    def params(self) -> Mapping[str, Parameter]:
        return {"weight": self.weight}


class _DiscreteExpFamilyLayer(InputLayer, ABC):
    """Shared logits-XOR-probs plumbing for Categorical/Binomial layers."""

    def _init_probs_logits(
        self,
        shape: tuple[int, ...],
        logits: Parameter | None,
        probs: Parameter | None,
        logits_factory: ParameterFactory | None,
        probs_factory: ParameterFactory | None,
        default_probs_param: Parameter,
    ) -> None:
        if logits is not None and probs is not None:
            raise ValueError("At most one between 'logits' and 'probs' can be given")
        if logits_factory is not None and probs_factory is not None:
            raise ValueError(
                "At most one between 'logits_factory' and 'probs_factory' can be given"
            )
        if logits is None and probs is None:
            if logits_factory is not None:
                logits = logits_factory(shape)
            elif probs_factory is not None:
                probs = probs_factory(shape)
            else:
                probs = default_probs_param
        if logits is not None:
            _check_param_shape("logits", logits, shape)
        if probs is not None:
            _check_param_shape("probs", probs, shape)
        self.logits = logits
        self.probs = probs

    @property
    def params(self) -> Mapping[str, Parameter]:
        if self.logits is not None:
            return {"logits": self.logits}
        assert self.probs is not None
        return {"probs": self.probs}


class CategoricalLayer(_DiscreteExpFamilyLayer):
    """A univariate Categorical layer: probs (normalized) XOR logits."""

    def __init__(
        self,
        scope: Scope,
        num_output_units: int,
        *,
        num_categories: int,
        logits: Parameter | None = None,
        probs: Parameter | None = None,
        logits_factory: ParameterFactory | None = None,
        probs_factory: ParameterFactory | None = None,
    ):
        if len(scope) != 1:
            raise ValueError("The Categorical layer encodes a univariate distribution")
        if num_categories < 2:
            raise ValueError("At least two categories must be given")
        super().__init__(scope, num_output_units)
        self.num_categories = num_categories
        shape = (num_output_units, num_categories)
        default = Parameter.from_unary(
            SoftmaxParameter(shape),
            TensorParameter(*shape, initializer=NormalInitializer()),
        )
        self._init_probs_logits(shape, logits, probs, logits_factory, probs_factory, default)

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "scope": self.scope,
            "num_output_units": self.num_output_units,
            "num_categories": self.num_categories,
        }


class BinomialLayer(_DiscreteExpFamilyLayer):
    """A univariate Binomial layer with total_count trials."""

    def __init__(
        self,
        scope: Scope,
        num_output_units: int,
        *,
        total_count: int = 2,
        logits: Parameter | None = None,
        probs: Parameter | None = None,
        logits_factory: ParameterFactory | None = None,
        probs_factory: ParameterFactory | None = None,
    ):
        if total_count < 0:
            raise ValueError("The number of trials must be non-negative")
        super().__init__(scope, num_output_units)
        self.total_count = total_count
        shape = (num_output_units,)
        default = Parameter.from_unary(
            SigmoidParameter(shape),
            TensorParameter(*shape, initializer=NormalInitializer()),
        )
        self._init_probs_logits(shape, logits, probs, logits_factory, probs_factory, default)

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "scope": self.scope,
            "num_output_units": self.num_output_units,
            "total_count": self.total_count,
        }


class GaussianLayer(InputLayer):
    """A univariate Gaussian layer (optionally unnormalized via log_partition)."""

    def __init__(
        self,
        scope: Scope,
        num_output_units: int,
        *,
        mean: Parameter | None = None,
        stddev: Parameter | None = None,
        log_partition: Parameter | None = None,
        mean_factory: ParameterFactory | None = None,
        stddev_factory: ParameterFactory | None = None,
    ):
        if len(scope) != 1:
            raise ValueError("The Gaussian layer encodes a univariate distribution")
        super().__init__(scope, num_output_units)
        shape = (num_output_units,)
        if mean is None:
            mean = _default_parameter(shape, mean_factory)
        if stddev is None:
            if stddev_factory is None:
                stddev = Parameter.from_unary(
                    ScaledSigmoidParameter(shape, vmin=1e-5, vmax=1.0),
                    TensorParameter(*shape, initializer=NormalInitializer()),
                )
            else:
                stddev = stddev_factory(shape)
        _check_param_shape("mean", mean, shape)
        _check_param_shape("stddev", stddev, shape)
        if log_partition is not None:
            _check_param_shape("log_partition", log_partition, shape)
        self.mean = mean
        self.stddev = stddev
        self.log_partition = log_partition

    @property
    def config(self) -> Mapping[str, Any]:
        return {"scope": self.scope, "num_output_units": self.num_output_units}

    @property
    def params(self) -> Mapping[str, Parameter]:
        p = {"mean": self.mean, "stddev": self.stddev}
        if self.log_partition is not None:
            p["log_partition"] = self.log_partition
        return p


class PolynomialLayer(InputLayer):
    """A univariate polynomial layer with (K, degree + 1) coefficients."""

    def __init__(
        self,
        scope: Scope,
        num_output_units: int,
        *,
        degree: int,
        coeff: Parameter | None = None,
        coeff_factory: ParameterFactory | None = None,
    ):
        if len(scope) != 1:
            raise ValueError("The Polynomial layer encodes univariate functions")
        super().__init__(scope, num_output_units)
        self.degree = degree
        shape = (num_output_units, degree + 1)
        if coeff is None:
            coeff = _default_parameter(shape, coeff_factory)
        _check_param_shape("coeff", coeff, shape)
        self.coeff = coeff

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "scope": self.scope,
            "num_output_units": self.num_output_units,
            "degree": self.degree,
        }

    @property
    def params(self) -> Mapping[str, Parameter]:
        return {"coeff": self.coeff}


class ConstantValueLayer(ConstantLayer):
    """A constant function encoded by a parameter (optionally in log-space)."""

    def __init__(self, num_output_units: int, *, log_space: bool = False, value: Parameter):
        super().__init__(num_output_units)
        _check_param_shape("value", value, (num_output_units,))
        self.value = value
        self.log_space = log_space

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units, "log_space": self.log_space}

    @property
    def params(self) -> Mapping[str, Parameter]:
        return {"value": self.value}


class ProductLayer(Layer, ABC):
    """The abstract symbolic product layer (arity >= 2)."""

    def __init__(self, num_input_units: int, num_output_units: int, arity: int = 2):
        if arity < 2:
            raise ValueError("The arity must be at least 2")
        super().__init__(num_input_units, num_output_units, arity)


class HadamardLayer(ProductLayer):
    """Elementwise product of its input vectors: Ko = Ki."""

    def __init__(self, num_input_units: int, arity: int = 2):
        super().__init__(num_input_units, num_input_units, arity=arity)

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_input_units": self.num_input_units, "arity": self.arity}


class KroneckerLayer(ProductLayer):
    """Outer product of its input vectors flattened: Ko = Ki ** arity."""

    def __init__(self, num_input_units: int, arity: int = 2):
        super().__init__(num_input_units, int(num_input_units**arity), arity=arity)

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_input_units": self.num_input_units, "arity": self.arity}


class SumLayer(Layer):
    """A dense sum layer: W @ concat(inputs), W of shape (Ko, arity * Ki)."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        arity: int = 1,
        weight: Parameter | None = None,
        weight_factory: ParameterFactory | None = None,
    ):
        super().__init__(num_input_units, num_output_units, arity=arity)
        shape = (num_output_units, arity * num_input_units)
        if weight is None:
            weight = _default_parameter(shape, weight_factory)
        _check_param_shape("weight", weight, shape)
        self.weight = weight

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_input_units": self.num_input_units,
            "num_output_units": self.num_output_units,
            "arity": self.arity,
        }

    @property
    def params(self) -> Mapping[str, Parameter]:
        return {"weight": self.weight}
