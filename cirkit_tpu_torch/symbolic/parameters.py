"""Symbolic parameter computational graphs.

Rebuild of ``cirkit/symbolic/parameters.py:15-1044``. A :class:`Parameter` is a
rooted DAG of :class:`ParameterNode`s describing *how* a layer's parameter
tensor is computed (e.g. softmax of a learnable tensor). No arrays are ever
allocated here; the JAX backend lowers parameter graphs into jit-traced
functions over the parameter store, where they fuse into the consuming
layer's einsum under XLA.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Mapping, Sequence
from copy import copy
from typing import Any, Protocol, Union

import numpy as np

from cirkit_tpu_torch.symbolic.dtypes import DataType, dtype_value
from cirkit_tpu_torch.symbolic.initializers import ConstantTensorInitializer, Initializer
from cirkit_tpu_torch.utils.algorithms import RootedDiAcyclicGraph, topologically_process_nodes

Shape = tuple[int, ...]


def _norm_axis(axis: int, rank: int) -> int:
    axis = axis if axis >= 0 else axis + rank
    if not 0 <= axis < rank:
        raise ValueError(f"Axis {axis} out of range for rank {rank}")
    return axis


class ParameterNode(ABC):
    """A node of a symbolic parameter computational graph."""

    @property
    @abstractmethod
    def shape(self) -> Shape:
        """The output shape of this node."""

    @property
    @abstractmethod
    def config(self) -> dict[str, Any]:
        """Hyperparameters, keyed by ``__init__`` argument names."""

    def __copy__(self) -> "ParameterNode":
        return type(self)(**self.config)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape})"


class ParameterInput(ParameterNode, ABC):
    """A parameter node without inputs (a leaf of the parameter graph)."""


class TensorParameter(ParameterInput):
    """A dense tensor parameter: shape + initializer + learnability + dtype.

    The JAX backend allocates one slot in the parameter-store pytree per
    (folded group of) TensorParameter (ref: ``backend/torch/parameters/nodes.py:76``).
    """

    def __init__(
        self,
        *shape: int,
        initializer: Initializer,
        learnable: bool = True,
        dtype: DataType = DataType.REAL,
    ):
        if not shape or any(d <= 0 for d in shape):
            raise ValueError(f"Shape {shape} must be non-empty with positive sizes")
        if not initializer.allows_shape(shape):
            raise ValueError(f"Shape {shape} is invalid for initializer {initializer}")
        self._shape = tuple(shape)
        self.initializer = initializer
        self.learnable = learnable
        self.dtype = dtype

    @property
    def shape(self) -> Shape:
        return self._shape

    @property
    def config(self) -> dict[str, Any]:
        return {
            "shape": self._shape,
            "initializer": self.initializer,
            "learnable": self.learnable,
            "dtype": self.dtype,
        }

    def __copy__(self) -> "TensorParameter":
        cfg = self.config
        shape = cfg.pop("shape")
        return type(self)(*shape, **cfg)


class ConstantParameter(TensorParameter):
    """A non-learnable tensor parameter holding a constant value."""

    def __init__(self, *shape: int, value: int | float | complex | np.number | np.ndarray = 0.0):
        if isinstance(value, np.ndarray) and value.shape != tuple(shape):
            raise ValueError("The numpy array shape differs from the given shape")
        super().__init__(
            *shape,
            initializer=ConstantTensorInitializer(value),
            learnable=False,
            dtype=dtype_value(value),
        )
        self.value = value

    @property
    def config(self) -> dict[str, Any]:
        return {"shape": self.shape, "value": self.value}


class ReferenceParameter(ParameterInput):
    """A symbolic pointer to another circuit's TensorParameter.

    This is the parameter-sharing mechanism across operator-derived circuits:
    the backend compiles it into a read of the *same* parameter-store slot
    (ref: ``backend/torch/parameters/nodes.py:223``).
    """

    def __init__(self, parameter: TensorParameter):
        self._parameter = parameter

    @property
    def shape(self) -> Shape:
        return self._parameter.shape

    @property
    def config(self) -> dict[str, Any]:
        return {"parameter": self._parameter}

    def deref(self) -> TensorParameter:
        return self._parameter


class ParameterOp(ParameterNode, ABC):
    """An inner node of a parameter graph with one or more inputs."""

    def __init__(self, *in_shapes: Shape):
        self._in_shapes = tuple(tuple(s) for s in in_shapes)

    @property
    def in_shapes(self) -> tuple[Shape, ...]:
        return self._in_shapes


class UnaryParameterOp(ParameterOp, ABC):
    def __init__(self, in_shape: Shape):
        super().__init__(in_shape)

    @property
    def in_shape(self) -> Shape:
        return self._in_shapes[0]

    @property
    def config(self) -> dict[str, Any]:
        return {"in_shape": self.in_shape}


class BinaryParameterOp(ParameterOp, ABC):
    def __init__(self, in_shape1: Shape, in_shape2: Shape):
        super().__init__(in_shape1, in_shape2)

    @property
    def in_shape1(self) -> Shape:
        return self._in_shapes[0]

    @property
    def in_shape2(self) -> Shape:
        return self._in_shapes[1]

    @property
    def config(self) -> dict[str, Any]:
        return {"in_shape1": self.in_shape1, "in_shape2": self.in_shape2}


class EntrywiseParameterOp(UnaryParameterOp, ABC):
    """A unary op applied entrywise (shape-preserving)."""

    @property
    def shape(self) -> Shape:
        return self.in_shape


class ReduceParameterOp(UnaryParameterOp, ABC):
    """A reduction along one axis of the input."""

    def __init__(self, in_shape: Shape, *, axis: int = -1):
        super().__init__(in_shape)
        self._axis = _norm_axis(axis, len(in_shape))

    @property
    def axis(self) -> int:
        return self._axis

    @property
    def shape(self) -> Shape:
        s = self.in_shape
        return s[: self._axis] + s[self._axis + 1 :]

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "axis": self._axis}


class EntrywiseReduceParameterOp(EntrywiseParameterOp, ABC):
    """A shape-preserving op normalizing along one axis (softmax-like)."""

    def __init__(self, in_shape: Shape, *, axis: int = -1):
        super().__init__(in_shape)
        self._axis = _norm_axis(axis, len(in_shape))

    @property
    def axis(self) -> int:
        return self._axis

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "axis": self._axis}


class IndexParameter(UnaryParameterOp):
    """Static indexing of the input along one axis."""

    def __init__(self, in_shape: Shape, *, indices: list[int], axis: int = -1):
        super().__init__(in_shape)
        self._axis = _norm_axis(axis, len(in_shape))
        if any(not 0 <= i < in_shape[self._axis] for i in indices):
            raise ValueError("Indices out of bounds")
        self._indices = list(indices)

    @property
    def indices(self) -> list[int]:
        return self._indices

    @property
    def axis(self) -> int:
        return self._axis

    @property
    def shape(self) -> Shape:
        s = self.in_shape
        return s[: self._axis] + (len(self._indices),) + s[self._axis + 1 :]

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "indices": self._indices, "axis": self._axis}


class SumParameter(BinaryParameterOp):
    """Elementwise sum of two same-shape inputs."""

    def __init__(self, in_shape1: Shape, in_shape2: Shape):
        if tuple(in_shape1) != tuple(in_shape2):
            raise ValueError("SumParameter inputs must have equal shapes")
        super().__init__(in_shape1, in_shape2)

    @property
    def shape(self) -> Shape:
        return self.in_shape1


class HadamardParameter(BinaryParameterOp):
    """Elementwise product of two same-shape inputs."""

    def __init__(self, in_shape1: Shape, in_shape2: Shape):
        if tuple(in_shape1) != tuple(in_shape2):
            raise ValueError("HadamardParameter inputs must have equal shapes")
        super().__init__(in_shape1, in_shape2)

    @property
    def shape(self) -> Shape:
        return self.in_shape1


class KroneckerParameter(BinaryParameterOp):
    """Kronecker product of two equal-rank inputs."""

    def __init__(self, in_shape1: Shape, in_shape2: Shape):
        if len(in_shape1) != len(in_shape2):
            raise ValueError("KroneckerParameter inputs must have equal rank")
        super().__init__(in_shape1, in_shape2)

    @property
    def shape(self) -> Shape:
        return tuple(a * b for a, b in zip(self.in_shape1, self.in_shape2))


class OuterParameterOp(BinaryParameterOp, ABC):
    """A binary op over all pairs of entries along one axis."""

    def __init__(self, in_shape1: Shape, in_shape2: Shape, *, axis: int = -1):
        if len(in_shape1) != len(in_shape2):
            raise ValueError("Outer op inputs must have equal rank")
        axis_n = _norm_axis(axis, len(in_shape1))
        if (
            in_shape1[:axis_n] != in_shape2[:axis_n]
            or in_shape1[axis_n + 1 :] != in_shape2[axis_n + 1 :]
        ):
            raise ValueError("Outer op inputs must agree on all non-outer axes")
        super().__init__(in_shape1, in_shape2)
        self._axis = axis_n

    @property
    def axis(self) -> int:
        return self._axis

    @property
    def shape(self) -> Shape:
        s1, s2 = self.in_shape1, self.in_shape2
        a = self._axis
        return s1[:a] + (s1[a] * s2[a],) + s1[a + 1 :]

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "axis": self._axis}


class OuterProductParameter(OuterParameterOp):
    """Outer product along one axis."""


class OuterSumParameter(OuterParameterOp):
    """Outer sum along one axis."""


class ExpParameter(EntrywiseParameterOp):
    """Entrywise exponential."""


class LogParameter(EntrywiseParameterOp):
    """Entrywise logarithm."""


class SquareParameter(EntrywiseParameterOp):
    """Entrywise square."""


class SoftplusParameter(EntrywiseParameterOp):
    """Entrywise softplus."""


class SigmoidParameter(EntrywiseParameterOp):
    """Entrywise logistic sigmoid."""


class ScaledSigmoidParameter(EntrywiseParameterOp):
    """Sigmoid rescaled to (vmin, vmax): positivity parameterization."""

    def __init__(self, in_shape: Shape, vmin: float, vmax: float):
        if vmin >= vmax:
            raise ValueError("vmin must be strictly less than vmax")
        super().__init__(in_shape)
        self._vmin = vmin
        self._vmax = vmax

    @property
    def vmin(self) -> float:
        return self._vmin

    @property
    def vmax(self) -> float:
        return self._vmax

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "vmin": self._vmin, "vmax": self._vmax}


class ClampParameter(EntrywiseParameterOp):
    """Entrywise clamping to [vmin, vmax] (either bound optional)."""

    def __init__(self, in_shape: Shape, *, vmin: float | None = None, vmax: float | None = None):
        if vmin is None and vmax is None:
            raise ValueError("At least one of vmin/vmax must be given")
        super().__init__(in_shape)
        self._vmin = vmin
        self._vmax = vmax

    @property
    def vmin(self) -> float | None:
        return self._vmin

    @property
    def vmax(self) -> float | None:
        return self._vmax

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "vmin": self._vmin, "vmax": self._vmax}


class ConjugateParameter(EntrywiseParameterOp):
    """Entrywise complex conjugation."""


class ReduceSumParameter(ReduceParameterOp):
    """Sum reduction along one axis."""


class ReduceProductParameter(ReduceParameterOp):
    """Product reduction along one axis."""


class ReduceLSEParameter(ReduceParameterOp):
    """LogSumExp reduction along one axis."""


class SoftmaxParameter(EntrywiseReduceParameterOp):
    """Softmax along one axis."""


class LogSoftmaxParameter(EntrywiseReduceParameterOp):
    """LogSoftmax along one axis."""


class MixingWeightParameter(UnaryParameterOp):
    """Expand (K, H) mixing coefficients into a (K, K*H) block-diagonal
    sum-layer weight (Einsum-Networks-style mixing layers)."""

    def __init__(self, in_shape: Shape):
        if len(in_shape) != 2:
            raise ValueError(f"Expected shape (num_units, arity), found {in_shape}")
        super().__init__(in_shape)

    @property
    def shape(self) -> Shape:
        k, h = self.in_shape
        return (k, k * h)


class GaussianProductMean(ParameterOp):
    """Mean of the product of two univariate Gaussian vectors."""

    def __init__(
        self,
        in_mean1_shape: Shape,
        in_stddev1_shape: Shape,
        in_mean2_shape: Shape,
        in_stddev2_shape: Shape,
    ):
        if in_mean1_shape != in_stddev1_shape or in_mean2_shape != in_stddev2_shape:
            raise ValueError("Mean and stddev shapes must match per operand")
        super().__init__(in_mean1_shape, in_stddev1_shape, in_mean2_shape, in_stddev2_shape)

    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][0] * self.in_shapes[2][0],)

    @property
    def config(self) -> dict[str, Any]:
        return {
            "in_mean1_shape": self.in_shapes[0],
            "in_stddev1_shape": self.in_shapes[1],
            "in_mean2_shape": self.in_shapes[2],
            "in_stddev2_shape": self.in_shapes[3],
        }


class GaussianProductStddev(BinaryParameterOp):
    """Stddev of the product of two univariate Gaussian vectors."""

    def __init__(self, in_stddev1_shape: Shape, in_stddev2_shape: Shape):
        super().__init__(in_stddev1_shape, in_stddev2_shape)

    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][0] * self.in_shapes[1][0],)

    @property
    def config(self) -> dict[str, Any]:
        return {"in_stddev1_shape": self.in_shapes[0], "in_stddev2_shape": self.in_shapes[1]}


class GaussianProductLogPartition(ParameterOp):
    """Log-partition of the product of two univariate Gaussian vectors."""

    def __init__(
        self,
        in_mean1_shape: Shape,
        in_stddev1_shape: Shape,
        in_mean2_shape: Shape,
        in_stddev2_shape: Shape,
    ):
        if in_mean1_shape != in_stddev1_shape or in_mean2_shape != in_stddev2_shape:
            raise ValueError("Mean and stddev shapes must match per operand")
        super().__init__(in_mean1_shape, in_stddev1_shape, in_mean2_shape, in_stddev2_shape)

    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][0] * self.in_shapes[2][0],)

    @property
    def config(self) -> dict[str, Any]:
        return {
            "in_mean1_shape": self.in_shapes[0],
            "in_stddev1_shape": self.in_shapes[1],
            "in_mean2_shape": self.in_shapes[2],
            "in_stddev2_shape": self.in_shapes[3],
        }


class PolynomialProduct(BinaryParameterOp):
    """Coefficients of the product of two polynomials (via convolution)."""

    @property
    def shape(self) -> Shape:
        return (
            self.in_shape1[0] * self.in_shape2[0],
            self.in_shape1[1] + self.in_shape2[1] - 1,
        )


class PolynomialDifferential(UnaryParameterOp):
    """Coefficients of the derivative of a polynomial."""

    def __init__(self, in_shape: Shape, *, order: int = 1):
        if order <= 0:
            raise ValueError("The differentiation order must be positive")
        super().__init__(in_shape)
        self.order = order

    @property
    def shape(self) -> Shape:
        k, dp1 = self.in_shape
        return (k, dp1 - self.order if dp1 > self.order else 1)

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "order": self.order}


class Parameter(RootedDiAcyclicGraph[ParameterNode]):
    """A rooted DAG of parameter nodes computing one parameter tensor."""

    def __init__(
        self,
        nodes: Sequence[ParameterNode],
        in_nodes: Mapping[ParameterNode, Sequence[ParameterNode]],
        outputs: Sequence[ParameterNode],
    ):
        super().__init__(nodes, in_nodes, outputs)
        for node in nodes:
            ins = self.node_inputs(node)
            if isinstance(node, ParameterInput):
                if ins:
                    raise ValueError(f"{node}: parameter inputs cannot have inputs")
                continue
            assert isinstance(node, ParameterOp)
            in_shapes = tuple(n.shape for n in ins)
            if node.in_shapes != in_shapes:
                raise ValueError(
                    f"{node}: expected input shapes {node.in_shapes}, found {in_shapes}"
                )

    @property
    def shape(self) -> Shape:
        return self.output.shape

    @classmethod
    def from_input(cls, p: ParameterInput) -> "Parameter":
        return cls([p], {}, [p])

    @classmethod
    def from_sequence(
        cls, p: Union[ParameterInput, "Parameter"], *ns: ParameterNode
    ) -> "Parameter":
        if isinstance(p, ParameterInput):
            p = cls.from_input(p)
        nodes = list(p.nodes) + list(ns)
        in_nodes: dict[ParameterNode, Sequence[ParameterNode]] = dict(p.nodes_inputs)
        prev = p.output
        for n in ns:
            in_nodes[n] = [prev]
            prev = n
        return cls(nodes, in_nodes, [prev])

    @classmethod
    def from_nary(cls, n: ParameterOp, *ps: Union[ParameterInput, "Parameter"]) -> "Parameter":
        graphs = [cls.from_input(p) if isinstance(p, ParameterInput) else p for p in ps]
        nodes: list[ParameterNode] = [x for g in graphs for x in g.nodes] + [n]
        in_nodes: dict[ParameterNode, Sequence[ParameterNode]] = {}
        for g in graphs:
            in_nodes.update(g.nodes_inputs)
        in_nodes[n] = [g.output for g in graphs]
        return cls(nodes, in_nodes, [n])

    @classmethod
    def from_unary(cls, n: UnaryParameterOp, p: Union[ParameterInput, "Parameter"]) -> "Parameter":
        return cls.from_sequence(p, n)

    @classmethod
    def from_binary(
        cls,
        n: BinaryParameterOp,
        p1: Union[ParameterInput, "Parameter"],
        p2: Union[ParameterInput, "Parameter"],
    ) -> "Parameter":
        return cls.from_nary(n, p1, p2)

    def ref(self) -> "Parameter":
        """A shallow copy with TensorParameters replaced by references,
        establishing parameter sharing with this graph."""

        def _ref_or_copy(n: ParameterNode) -> ParameterNode:
            if isinstance(n, TensorParameter):
                return ReferenceParameter(n)
            return copy(n)

        return self._process_nodes(_ref_or_copy)

    def _process_nodes(
        self, process_fn: Callable[[ParameterNode], ParameterNode]
    ) -> "Parameter":
        nodes, in_nodes, outputs = topologically_process_nodes(
            self.topological_ordering(), self.outputs, process_fn, incomings_fn=self.node_inputs
        )
        return Parameter(nodes, in_nodes, outputs)

    def __repr__(self) -> str:
        return f"Parameter(shape={self.shape})"


class ParameterFactory(Protocol):
    """A callable building a symbolic Parameter for a requested shape."""

    def __call__(self, shape: Shape) -> Parameter: ...


def mixing_weight_factory(shape: Shape, *, param_factory: ParameterFactory) -> Parameter:
    """Build mixing-layer weights: a (K, H) coefficient matrix expanded to the
    (K, K*H) block-diagonal weight of a SumLayer (ref:
    ``cirkit/symbolic/parameters.py:1007-1044``)."""
    if len(shape) != 2 or shape[1] % shape[0]:
        raise ValueError(f"Expected shape (num_units, arity * num_units), found {shape}")
    num_units = shape[0]
    arity = shape[1] // num_units
    coeff_shape = (num_units, arity)
    return Parameter.from_unary(MixingWeightParameter(coeff_shape), param_factory(coeff_shape))
