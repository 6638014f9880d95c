"""Symbolic initializers.

Rebuild of ``cirkit/symbolic/initializers.py:7-163``. Symbolic initializers
never allocate tensors; the JAX backend lowers them to ``jax.random``-keyed
init functions (``cirkit_tpu/backend/jax/initializers.py``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import numpy as np


class Initializer(ABC):
    """The abstract symbolic initializer."""

    @property
    def config(self) -> dict[str, Any]:
        """The hyperparameters of the initializer."""
        return {}

    @abstractmethod
    def allows_shape(self, shape: tuple[int, ...]) -> bool:
        """Whether a parameter of the given shape can be initialized."""

    def __repr__(self) -> str:
        kv = ", ".join(f"{k}={v}" for k, v in self.config.items())
        return f"{type(self).__name__}({kv})"


class ElementwiseInitializer(Initializer, ABC):
    """An initializer that sets each entry independently: any shape works."""

    def allows_shape(self, shape: tuple[int, ...]) -> bool:
        return True


class ConstantTensorInitializer(Initializer):
    """Initialize with a constant scalar or a numpy array (broadcastable)."""

    def __init__(self, value: int | float | complex | np.number | np.ndarray) -> None:
        if not isinstance(value, (int, float, complex, np.number, np.ndarray)):
            raise ValueError("The value must be a number or a numpy array")
        self.value = value

    @property
    def config(self) -> dict[str, Any]:
        return {"value": self.value}

    def allows_shape(self, shape: tuple[int, ...]) -> bool:
        if not isinstance(self.value, np.ndarray):
            return True
        try:
            return np.broadcast_shapes(self.value.shape, shape) == shape
        except ValueError:
            return False


class UniformInitializer(ElementwiseInitializer):
    """I.i.d. uniform entries over [a, b)."""

    def __init__(self, a: float = 0.0, b: float = 1.0) -> None:
        if a >= b:
            raise ValueError("The minimum must be strictly less than the maximum")
        self.a = a
        self.b = b

    @property
    def config(self) -> dict[str, Any]:
        return {"a": self.a, "b": self.b}


class NormalInitializer(ElementwiseInitializer):
    """I.i.d. normal entries with the given mean and standard deviation."""

    def __init__(self, mean: float = 0.0, stddev: float = 1.0) -> None:
        if stddev <= 0.0:
            raise ValueError("The standard deviation must be positive")
        self.mean = mean
        self.stddev = stddev

    @property
    def config(self) -> dict[str, Any]:
        return {"mean": self.mean, "stddev": self.stddev}


class DirichletInitializer(Initializer):
    """Dirichlet-distributed slices along one axis (they sum to one)."""

    def __init__(self, alpha: float | list[float] = 1.0, *, axis: int = -1) -> None:
        if not isinstance(alpha, (float, list)):
            raise ValueError("The concentration must be a scalar or a list")
        alphas = alpha if isinstance(alpha, list) else [alpha]
        if any(a <= 0.0 for a in alphas):
            raise ValueError("The concentration parameters must be positive")
        self.alpha = alpha
        self.axis = axis

    @property
    def config(self) -> dict[str, Any]:
        return {"alpha": self.alpha, "axis": self.axis}

    def allows_shape(self, shape: tuple[int, ...]) -> bool:
        axis = self.axis if self.axis >= 0 else self.axis + len(shape)
        if not 0 <= axis < len(shape):
            return False
        if isinstance(self.alpha, list):
            return shape[axis] == len(self.alpha)
        return True
