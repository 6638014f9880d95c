"""Compiled parameter graphs for the PyTorch backend.

The counterpart of ``cirkit_tpu/backend/jax/parameters.py``: a compiled
parameter node is a function from the **parameter store** (a mapping from
slot name to an ``(F, ...)`` tensor) and its compiled inputs to an
``(F, ...)`` tensor. Every node carries a leading fold dimension F; folding
a group of structurally-identical graphs concatenates along F (see
``folding.py``).

This module carries every node of the JAX package: tensor and pointer
slots; the entrywise ops (sum, Hadamard, exp, log, square, softplus,
sigmoid, scaled sigmoid, clamp, conjugate) that leaf parameterizations
build; the axis ops (softmax, log-softmax, reduce sum, product and
log-sum-exp, outer product and sum, index); mixing weights; the Kronecker,
Gaussian-product and polynomial nodes the circuit operators emit; and the
matmul, einsum and flatten nodes the graph rewrites emit, on real and on
complex tensors.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Mapping, Sequence
from typing import Any

import math

import numpy as np
import torch

from cirkit_tpu_torch.backend.torch.utils import csafelog, safelog, softplus
from cirkit_tpu_torch.utils.algorithms import RootedDiAcyclicGraph

Shape = tuple[int, ...]
Store = Mapping[str, torch.Tensor]

# An initializer: (generator, shape, dtype, device) -> tensor. Constant
# initializers ignore the generator (and accept None).
InitFn = Callable[[torch.Generator | None, Shape, torch.dtype, torch.device], torch.Tensor]


class TorchParameterNode(ABC):
    """A node of a compiled parameter graph."""

    def __init__(self, *, num_folds: int = 1):
        self.num_folds = num_folds

    @property
    @abstractmethod
    def shape(self) -> Shape:
        """The per-fold output shape."""

    @property
    @abstractmethod
    def config(self) -> dict[str, Any]:
        """Constructor arguments (used by folding to rebuild the node)."""

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        """Hashable key: nodes fold together iff these match."""
        return (type(self).__name__, self.shape, *sorted(self.config.items()))

    @abstractmethod
    def __call__(self, store: Store, *ins: torch.Tensor) -> torch.Tensor:
        """Evaluate: inputs and output carry the leading fold axis."""

    def fold(self, group: Sequence["TorchParameterNode"]) -> "TorchParameterNode":
        """Build the folded node for a group (all with my fold_settings)."""
        return type(self)(**self.config, num_folds=sum(n.num_folds for n in group))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(F={self.num_folds}, shape={self.shape})"


class TorchParameterInput(TorchParameterNode, ABC):
    """A parameter node without graph inputs."""


class TorchTensorSlot(TorchParameterInput):
    """A read of a parameter-store slot: the compiled TensorParameter.

    ``origins`` tracks the symbolic TensorParameters stacked into this slot
    (one per fold) so the compiler state can resolve references after folding.
    """

    def __init__(
        self,
        slot: str,
        shape: Shape,
        *,
        dtype: torch.dtype,
        learnable: bool,
        inits: Sequence[InitFn],
        origins: Sequence[Any],
        num_folds: int = 1,
    ):
        super().__init__(num_folds=num_folds)
        assert len(inits) == num_folds and len(origins) == num_folds
        self.slot = slot
        self._shape = tuple(shape)
        self.dtype = dtype
        self.learnable = learnable
        self.inits = list(inits)
        self.origins = list(origins)

    @property
    def shape(self) -> Shape:
        return self._shape

    @property
    def config(self) -> dict[str, Any]:
        return {
            "slot": self.slot,
            "shape": self._shape,
            "dtype": self.dtype,
            "learnable": self.learnable,
            "inits": self.inits,
            "origins": self.origins,
        }

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        # Tensor slots fold together when shape/dtype/learnability agree; the
        # folding pass allocates a fresh stacked slot.
        return (type(self).__name__, self._shape, str(self.dtype), self.learnable)

    def initialize(
        self, generator: torch.Generator | None, device: torch.device
    ) -> torch.Tensor:
        """Materialize the (F, ...) initial value of this slot on ``device``.

        Constant initializers stack in numpy; folds sharing one elementwise
        initializer draw a single (F, ...) sample; otherwise each fold draws
        its own sample.
        """
        consts = [getattr(init, "constant", None) for init in self.inits]
        if all(c is not None for c in consts):
            stacked = np.stack([np.broadcast_to(np.asarray(c), self._shape) for c in consts])
            return torch.as_tensor(stacked, dtype=self.dtype, device=device)
        if generator is None:
            raise ValueError(
                "A torch.Generator is required to initialize randomly-initialized parameters"
            )
        batch_keys = {getattr(init, "batch_key", None) for init in self.inits}
        if len(batch_keys) == 1 and None not in batch_keys:
            return self.inits[0](generator, (self.num_folds, *self._shape), self.dtype, device)
        parts = [init(generator, self._shape, self.dtype, device) for init in self.inits]
        return torch.stack(parts, dim=0)

    def __call__(self, store: Store, *ins: torch.Tensor) -> torch.Tensor:
        return store[self.slot]


class TorchPointerSlot(TorchParameterInput):
    """A fold-indexed view into another tensor slot: the compiled
    ReferenceParameter (parameter sharing across circuits and layers)."""

    def __init__(
        self,
        slot: str,
        shape: Shape,
        *,
        fold_idx: np.ndarray | None,
        num_folds: int = 1,
        learnable: bool = False,
    ):
        super().__init__(num_folds=num_folds)
        self.slot = slot
        self._shape = tuple(shape)
        self.fold_idx = None if fold_idx is None else np.asarray(fold_idx, dtype=np.int64)
        # whether the POINTED-TO tensor slot is learnable
        self.learnable = bool(learnable)

    @property
    def shape(self) -> Shape:
        return self._shape

    @property
    def config(self) -> dict[str, Any]:
        return {"slot": self.slot, "shape": self._shape, "fold_idx": self.fold_idx}

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        return (type(self).__name__, self.slot, self._shape)

    def fold(self, group: Sequence[TorchParameterNode]) -> "TorchPointerSlot":
        idx = np.concatenate(
            [
                n.fold_idx if n.fold_idx is not None else np.arange(n.num_folds, dtype=np.int64)
                for n in group
            ]
        )
        return TorchPointerSlot(
            self.slot,
            self._shape,
            fold_idx=idx,
            num_folds=len(idx),
            learnable=any(getattr(n, "learnable", False) for n in group),
        )

    def __call__(self, store: Store, *ins: torch.Tensor) -> torch.Tensor:
        x = store[self.slot]
        if self.fold_idx is None:
            return x
        return x.index_select(0, torch.as_tensor(self.fold_idx, device=x.device))


class TorchParameterOp(TorchParameterNode, ABC):
    """An inner parameter-graph node; subclasses define ``_eval``."""

    def __init__(self, *in_shapes: Shape, num_folds: int = 1):
        super().__init__(num_folds=num_folds)
        self.in_shapes = tuple(tuple(s) for s in in_shapes)

    @property
    def config(self) -> dict[str, Any]:
        return {"in_shapes": self.in_shapes}

    def fold(self, group: Sequence[TorchParameterNode]) -> "TorchParameterOp":
        cfg = self.config
        in_shapes = cfg.pop("in_shapes")
        return type(self)(*in_shapes, **cfg, num_folds=sum(n.num_folds for n in group))

    def __call__(self, store: Store, *ins: torch.Tensor) -> torch.Tensor:
        return self._eval(*ins)

    @abstractmethod
    def _eval(self, *ins: torch.Tensor) -> torch.Tensor: ...


class _AxisOp(TorchParameterOp, ABC):
    """A parameter op configured by an axis (given in unfolded coordinates;
    the leading fold axis shifts it by one at evaluation time)."""

    def __init__(self, *in_shapes: Shape, axis: int = -1, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        rank = len(self.in_shapes[0])
        self.axis = axis if axis >= 0 else axis + rank

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "axis": self.axis}


class TorchIndexParameter(_AxisOp):
    """A selection (with repeats or reordering) of entries along an axis."""

    def __init__(self, *in_shapes, indices: Sequence[int], axis: int = -1, num_folds: int = 1):
        super().__init__(*in_shapes, axis=axis, num_folds=num_folds)
        self.indices = tuple(indices)

    @property
    def shape(self) -> Shape:
        s = self.in_shapes[0]
        return s[: self.axis] + (len(self.indices),) + s[self.axis + 1 :]

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "indices": self.indices}

    def _eval(self, x):
        idx = torch.as_tensor(self.indices, dtype=torch.int64, device=x.device)
        return x.index_select(self.axis + 1, idx)


class TorchKroneckerParameter(TorchParameterOp):
    """The fold-wise Kronecker product of two parameter tensors of one rank."""

    @property
    def shape(self) -> Shape:
        return tuple(a * b for a, b in zip(*self.in_shapes))

    def _eval(self, a, b):
        # interleave every axis pair: a's axes at even, b's at odd positions
        rank = len(self.in_shapes[0])
        out = a
        for ax in range(rank):
            out = out.unsqueeze(2 + 2 * ax)
        other = b
        for ax in range(rank):
            other = other.unsqueeze(1 + 2 * ax)
        out = out * other
        return out.reshape((out.shape[0], *self.shape))


class _EntrywiseOp(TorchParameterOp, ABC):
    """An op whose output has its (first) input's shape."""

    @property
    def shape(self) -> Shape:
        return self.in_shapes[0]


class TorchSumParameter(_EntrywiseOp):
    def _eval(self, a, b):
        return a + b


class TorchHadamardParameter(_EntrywiseOp):
    def _eval(self, a, b):
        return a * b


class TorchConjugateParameter(_EntrywiseOp):
    """Complex conjugation; the identity on real tensors."""

    def _eval(self, x):
        # written out: torch.conj alone returns a lazily conjugated view
        return x.conj().resolve_conj() if x.dtype.is_complex else x


class TorchExpParameter(_EntrywiseOp):
    def _eval(self, x):
        return torch.exp(x)


class TorchLogParameter(_EntrywiseOp):
    def _eval(self, x):
        # complex inputs take the complex safe log (phases kept)
        return csafelog(x) if x.dtype.is_complex else safelog(x)


class TorchSquareParameter(_EntrywiseOp):
    def _eval(self, x):
        return torch.square(x)


class TorchSoftplusParameter(_EntrywiseOp):
    def _eval(self, x):
        return softplus(x)


class TorchSigmoidParameter(_EntrywiseOp):
    def _eval(self, x):
        return torch.sigmoid(x)


class TorchScaledSigmoidParameter(_EntrywiseOp):
    """A sigmoid scaled into ``(vmin, vmax)``."""

    def __init__(self, *in_shapes, vmin: float, vmax: float, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        self.vmin = vmin
        self.vmax = vmax

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "vmin": self.vmin, "vmax": self.vmax}

    def _eval(self, x):
        return torch.sigmoid(x) * (self.vmax - self.vmin) + self.vmin


class TorchClampParameter(_EntrywiseOp):
    """Entries clipped into ``[vmin, vmax]`` (a bound of None is open)."""

    def __init__(self, *in_shapes, vmin=None, vmax=None, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        self.vmin = vmin
        self.vmax = vmax

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "vmin": self.vmin, "vmax": self.vmax}

    def _eval(self, x):
        if self.vmin is None and self.vmax is None:
            return x
        return torch.clamp(x, self.vmin, self.vmax)


class _OuterOp(_AxisOp, ABC):
    @property
    def shape(self) -> Shape:
        s1, s2 = self.in_shapes
        a = self.axis
        return s1[:a] + (s1[a] * s2[a],) + s1[a + 1 :]

    def _outer(self, a, b, combine):
        ax = self.axis + 1  # account for the fold axis
        out = combine(a.unsqueeze(ax + 1), b.unsqueeze(ax))
        return out.reshape((out.shape[0], *self.shape))


class TorchOuterProductParameter(_OuterOp):
    def _eval(self, a, b):
        return self._outer(a, b, torch.mul)


class TorchOuterSumParameter(_OuterOp):
    def _eval(self, a, b):
        return self._outer(a, b, torch.add)


class _ReduceOp(_AxisOp, ABC):
    @property
    def shape(self) -> Shape:
        s = self.in_shapes[0]
        return s[: self.axis] + s[self.axis + 1 :]


class TorchReduceSumParameter(_ReduceOp):
    def _eval(self, x):
        return x.sum(dim=self.axis + 1)


class TorchReduceProductParameter(_ReduceOp):
    def _eval(self, x):
        return x.prod(dim=self.axis + 1)


class TorchReduceLSEParameter(_ReduceOp):
    def _eval(self, x):
        if x.dtype.is_complex:  # torch.logsumexp takes real tensors only
            info = torch.finfo(x.real.dtype)
            m = x.real.amax(dim=self.axis + 1, keepdim=True).clamp(info.min, info.max)
            return torch.log(torch.exp(x - m).sum(dim=self.axis + 1)) + m.squeeze(self.axis + 1)
        return torch.logsumexp(x, dim=self.axis + 1)


class TorchSoftmaxParameter(_AxisOp):
    @property
    def shape(self) -> Shape:
        return self.in_shapes[0]

    def _eval(self, x):
        return torch.softmax(x, dim=self.axis + 1)


class TorchLogSoftmaxParameter(_AxisOp):
    @property
    def shape(self) -> Shape:
        return self.in_shapes[0]

    def _eval(self, x):
        return torch.log_softmax(x, dim=self.axis + 1)


class TorchMixingWeightParameter(TorchParameterOp):
    """(F, K, H) mixing coefficients -> (F, K, K*H) block-diagonal weight."""

    @property
    def shape(self) -> Shape:
        k, h = self.in_shapes[0]
        return (k, k * h)

    def _eval(self, x):
        k, h = self.in_shapes[0]
        # W[f, a, h*K + b] = [a == b] * x[f, a, h]
        eye = torch.eye(k, dtype=x.dtype, device=x.device)
        blocks = eye[None, :, :, None] * x[:, None, :, :]  # (F, K, K, H)
        return blocks.permute(0, 1, 3, 2).reshape(x.shape[0], k, k * h)


class TorchGaussianProductMean(TorchParameterOp):
    """The means of every pairwise product of two families of Gaussians
    (inputs: mean 1, stddev 1, mean 2, stddev 2)."""

    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][-1] * self.in_shapes[2][-1],)

    def _eval(self, m1, s1, m2, s2):
        v1, v2 = torch.square(s1), torch.square(s2)
        num = m1[:, :, None] * v2[:, None, :] + v1[:, :, None] * m2[:, None, :]
        den = v1[:, :, None] + v2[:, None, :]
        return (num / den).reshape(m1.shape[0], -1)


class TorchGaussianProductStddev(TorchParameterOp):
    """The standard deviations of every pairwise product of two families of
    Gaussians (inputs: stddev 1, stddev 2)."""

    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][-1] * self.in_shapes[1][-1],)

    def _eval(self, s1, s2):
        v1, v2 = torch.square(s1), torch.square(s2)
        var = (v1[:, :, None] * v2[:, None, :]) / (v1[:, :, None] + v2[:, None, :])
        return torch.sqrt(var).reshape(s1.shape[0], -1)


class TorchGaussianProductLogPartition(TorchParameterOp):
    """The log-normalizers of every pairwise product of two families of
    Gaussians (inputs: mean 1, stddev 1, mean 2, stddev 2)."""

    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][-1] * self.in_shapes[2][-1],)

    def _eval(self, m1, s1, m2, s2):
        v1, v2 = torch.square(s1), torch.square(s2)
        var = v1[:, :, None] + v2[:, None, :]
        diff = m1[:, :, None] - m2[:, None, :]
        logz = -0.5 * torch.square(diff) / var - 0.5 * torch.log(2.0 * math.pi * var)
        return logz.reshape(m1.shape[0], -1)


class TorchPolynomialProduct(TorchParameterOp):
    """The coefficients of every pairwise product of two families of
    polynomials: a convolution along the degree axis, through the FFT."""

    @property
    def shape(self) -> Shape:
        return (
            self.in_shapes[0][0] * self.in_shapes[1][0],
            self.in_shapes[0][1] + self.in_shapes[1][1] - 1,
        )

    def _eval(self, c1, c2):
        deg = self.shape[-1]
        if c1.dtype.is_complex or c2.dtype.is_complex:
            fft, ifft = torch.fft.fft, torch.fft.ifft
        else:
            fft, ifft = torch.fft.rfft, torch.fft.irfft
        f1 = fft(c1, n=deg, dim=-1)  # (F, K1, deg)
        f2 = fft(c2, n=deg, dim=-1)  # (F, K2, deg)
        out = ifft(f1[:, :, None, :] * f2[:, None, :, :], n=deg, dim=-1)  # (F, K1, K2, deg)
        return out.reshape(c1.shape[0], -1, deg)


class TorchPolynomialDifferential(TorchParameterOp):
    """The coefficients of the ``order``-th derivative of a family of
    polynomials (the zero polynomial once the degree is exhausted)."""

    def __init__(self, *in_shapes: Shape, order: int = 1, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        self.order = order

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "order": self.order}

    @property
    def shape(self) -> Shape:
        k, dp1 = self.in_shapes[0]
        return (k, dp1 - self.order if dp1 > self.order else 1)

    def _eval(self, c):
        if c.shape[-1] <= self.order:
            return torch.zeros((c.shape[0], c.shape[1], 1), dtype=c.dtype, device=c.device)
        for _ in range(self.order):
            powers = torch.arange(1, c.shape[-1], dtype=c.real.dtype, device=c.device)
            c = c[..., 1:] * powers
        return c


class TorchEinsumParameter(TorchParameterOp):
    """A generic folded einsum over parameter inputs, emitted by the
    ReduceSum-of-OuterProduct fusion."""

    def __init__(self, *in_shapes, equation: str, out_shape: Shape, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        self.equation = equation
        self.out_shape = tuple(out_shape)

    @property
    def shape(self) -> Shape:
        return self.out_shape

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "equation": self.equation, "out_shape": self.out_shape}

    def _eval(self, *ins):
        return torch.einsum(self.equation, *ins)


class TorchMatMulParameter(TorchParameterOp):
    """Matrix product of two parameter matrices (emitted by the sum-collapse
    fusion: two stacked dense sums fuse into one with W2 @ W1 weights)."""

    def __init__(self, *in_shapes: Shape, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        if in_shapes[0][0] != in_shapes[1][1]:
            raise ValueError(
                f"Cannot matrix-multiply parameter shapes {in_shapes[1]} @ {in_shapes[0]}"
            )

    @property
    def shape(self) -> Shape:
        # inputs are (inner sum weight, outer sum weight): W2 @ W1
        return (self.in_shapes[1][0], self.in_shapes[0][1])

    def _eval(self, w1, w2):
        return torch.bmm(w2, w1)


class TorchFlattenParameter(TorchParameterOp):
    """Flatten a contiguous range of axes of the input parameter."""

    def __init__(
        self, *in_shapes: Shape, start_dim: int = 0, end_dim: int = -1, num_folds: int = 1
    ):
        super().__init__(*in_shapes, num_folds=num_folds)
        rank = len(self.in_shapes[0])
        self.start_dim = start_dim if start_dim >= 0 else start_dim + rank
        self.end_dim = end_dim if end_dim >= 0 else end_dim + rank

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "start_dim": self.start_dim, "end_dim": self.end_dim}

    @property
    def shape(self) -> Shape:
        s = self.in_shapes[0]
        flat = 1
        for d in s[self.start_dim : self.end_dim + 1]:
            flat *= d
        return s[: self.start_dim] + (flat,) + s[self.end_dim + 1 :]

    def _eval(self, x):
        return x.reshape((x.shape[0], *self.shape))


class TorchParameter(RootedDiAcyclicGraph[TorchParameterNode]):
    """A compiled parameter computational graph: store -> (F, ...) tensor."""

    def __init__(self, nodes, in_nodes, outputs):
        super().__init__(nodes, in_nodes, outputs)
        self._ordering = list(self.topological_ordering())

    @property
    def num_folds(self) -> int:
        return self.output.num_folds

    @property
    def shape(self) -> Shape:
        return self.output.shape

    def __call__(self, store: Store, *, node_override=None) -> torch.Tensor:
        """Evaluate the plan. ``node_override(plan, node, ins)``, when given,
        may return a replacement value for ``node`` (or None to defer to the
        node's own evaluation): the one hook behind the routing-time
        reinterpretation of fused weights (``queries._max_weight``)."""
        values: dict[TorchParameterNode, torch.Tensor] = {}
        for node in self._ordering:
            ins = [values[n] for n in self.node_inputs(node)]
            out = node_override(self, node, ins) if node_override else None
            values[node] = node(store, *ins) if out is None else out
        return values[self.output]

    # -- canonicalization for folding -----------------------------------------
    def canonical_nodes(self) -> list[TorchParameterNode]:
        """A canonical post-order node sequence (inputs before outputs,
        deterministic), so structurally-identical graphs zip node-wise."""
        seq: list[TorchParameterNode] = []
        seen: set[int] = set()

        def visit(n: TorchParameterNode) -> None:
            if id(n) in seen:
                return
            seen.add(id(n))
            for c in self.node_inputs(n):
                visit(c)
            seq.append(n)

        visit(self.output)
        return seq

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        """Structural signature: graphs fold together iff these match."""
        seq = self.canonical_nodes()
        pos = {id(n): i for i, n in enumerate(seq)}
        return tuple(
            (n.fold_settings, tuple(pos[id(c)] for c in self.node_inputs(n))) for n in seq
        )

    def tensor_slots(self) -> list[TorchTensorSlot]:
        return [n for n in self._ordering if isinstance(n, TorchTensorSlot)]

    @classmethod
    def from_nary(cls, op: TorchParameterOp, *ps: "TorchParameter") -> "TorchParameter":
        nodes = [n for p in ps for n in p.nodes] + [op]
        in_nodes: dict = {}
        for p in ps:
            in_nodes.update(p.nodes_inputs)
        in_nodes[op] = [p.output for p in ps]
        return cls(nodes, in_nodes, [op])
