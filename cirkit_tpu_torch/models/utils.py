"""Template helpers: named parameterizations and layer factories.

Rebuild of ``cirkit/templates/utils.py:35-268``.
"""

from __future__ import annotations

import functools
from collections.abc import Callable, Mapping
from dataclasses import dataclass, field
from typing import Any, Protocol

from cirkit_tpu_torch.symbolic.dtypes import DataType
from cirkit_tpu_torch.symbolic.initializers import (
    DirichletInitializer,
    Initializer,
    NormalInitializer,
    UniformInitializer,
)
from cirkit_tpu_torch.symbolic.layers import (
    BinomialLayer,
    CategoricalLayer,
    EmbeddingLayer,
    GaussianLayer,
    InputLayer,
    ProductLayer,
    SumLayer,
)
from cirkit_tpu_torch.symbolic.parameters import (
    ClampParameter,
    Parameter,
    ParameterFactory,
    SigmoidParameter,
    SoftmaxParameter,
    SoftplusParameter,
    TensorParameter,
    UnaryParameterOp,
)
from cirkit_tpu_torch.utils.scope import Scope


@dataclass(frozen=True)
class Parameterization:
    """Settings for a parameterization: init method, activation, dtype."""

    initialization: str = "normal"
    activation: str = "none"
    dtype: str = "real"
    initialization_kwargs: dict[str, Any] = field(default_factory=dict)
    activation_kwargs: dict[str, Any] = field(default_factory=dict)


class InputLayerFactory(Protocol):
    def __call__(self, scope: Scope, num_units: int) -> InputLayer: ...


class SumLayerFactory(Protocol):
    def __call__(self, num_input_units: int, num_output_units: int) -> SumLayer: ...


class ProductLayerFactory(Protocol):
    def __call__(self, num_input_units: int, arity: int) -> ProductLayer: ...


def named_parameterizations_to_factories(
    params: Mapping[str, Parameterization],
) -> Mapping[str, ParameterFactory]:
    """Map parameter names to symbolic parameter factories."""
    return {f"{name}_factory": parameterization_to_factory(p) for name, p in params.items()}


def name_to_input_layer_factory(name: str, **kwargs: Any) -> InputLayerFactory:
    """Input-layer factory by name: embedding/categorical/binomial/gaussian."""
    classes = {
        "embedding": EmbeddingLayer,
        "categorical": CategoricalLayer,
        "binomial": BinomialLayer,
        "gaussian": GaussianLayer,
    }
    if name not in classes:
        raise ValueError(f"Unknown input layer called {name}")
    return functools.partial(classes[name], **kwargs)


def parameterization_to_factory(param: Parameterization) -> ParameterFactory:
    """Build a symbolic-parameter factory from a parameterization."""
    unary_op_factory = name_to_parameter_activation(param.activation, **param.activation_kwargs)
    dtype = name_to_dtype(param.dtype)
    initializer = name_to_initializer(param.initialization, **param.initialization_kwargs)
    return functools.partial(
        _build_tensor_parameter,
        unary_op_factory=unary_op_factory,
        dtype=dtype,
        initializer=initializer,
    )


def name_to_parameter_activation(
    name: str, **kwargs: Any
) -> Callable[[tuple[int, ...]], UnaryParameterOp] | None:
    """Parameter activation by name: none/softmax/sigmoid/positive-clamp/softplus."""
    if name == "none":
        return None
    if name == "softmax":
        return functools.partial(SoftmaxParameter, **kwargs)
    if name == "sigmoid":
        return functools.partial(SigmoidParameter)
    if name == "positive-clamp":
        kwargs.setdefault("vmin", 1e-18)
        return functools.partial(ClampParameter, **kwargs)
    if name == "softplus":
        return functools.partial(SoftplusParameter, **kwargs)
    raise ValueError(f"Unknown parameter activation called {name}")


def name_to_dtype(name: str) -> DataType:
    """Symbolic dtype by name: integer/real/complex."""
    try:
        return DataType[name.upper()]
    except KeyError:
        raise ValueError(f"Unknown data type called {name}") from None


def name_to_initializer(name: str, **kwargs: Any) -> Initializer:
    """Symbolic initializer by name: uniform/normal/dirichlet."""
    kwargs = dict(kwargs)
    if name == "uniform":
        kwargs.setdefault("a", 0.0)
        kwargs.setdefault("b", 1.0)
        return UniformInitializer(**kwargs)
    if name == "normal":
        kwargs.setdefault("mean", 0.0)
        kwargs.setdefault("stddev", 1.0)
        return NormalInitializer(**kwargs)
    if name == "dirichlet":
        kwargs.setdefault("alpha", 1.0)
        return DirichletInitializer(**kwargs)
    raise ValueError(f"Unknown initializer called {name}")


def _build_tensor_parameter(
    shape: tuple[int, ...],
    unary_op_factory: Callable[[tuple[int, ...]], UnaryParameterOp] | None,
    dtype: DataType,
    initializer: Initializer,
) -> Parameter:
    tensor = TensorParameter(*shape, dtype=dtype, initializer=initializer)
    if unary_op_factory is None:
        return Parameter.from_input(tensor)
    return Parameter.from_unary(unary_op_factory(shape), tensor)
