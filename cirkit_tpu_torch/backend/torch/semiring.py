"""Pluggable evaluation semirings.

The counterpart of ``cirkit_tpu/backend/jax/semiring.py:51-305, 381-561``:
a (⊕, ⊗) algebra the compiled plan evaluates under, with a string registry
and cross-semiring morphisms. The log-space semiring implements the
numerically-stable max-shift log-einsum-exp; its four fused hooks (dense or
Tucker, with or without a softmax of the weights) go to the ops of
``cirkit_tpu_torch/ops/lse_einsum.py``, which launch the CUDA kernel on
CUDA tensors. The signed log semiring (values are ``(log|f|, sign)`` pairs)
sends the same four hooks to the ops of ``cirkit_tpu_torch/ops/slse_einsum.py``.
The complex log semiring (values are single complex tensors ``log|f| + i
arg f``) sends its dense and Tucker hooks to the ops of
``cirkit_tpu_torch/ops/clse_einsum.py``; its softmax hooks normalize the
logits first and contract against the real weights, as in the JAX package.

Every fused hook takes ``plain``: True runs the op's plain composition of
PyTorch ops (its ``*_ref`` function) on any device instead of the kernel.
Those compositions are differentiable to any order and ``torch.func`` can
transform them, which the kernels' ``autograd.Function``s cannot; the
circuit threads the flag down from ``TorchCircuit.evaluate(..., plain=True)``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Sequence
from functools import reduce
from typing import ClassVar, Protocol

import torch

from cirkit_tpu_torch.backend.torch.utils import (
    csafelog,
    default_real_dtype,
    safelog,
    to_complex_dtype,
    to_real_dtype,
)
from cirkit_tpu_torch.ops.clse_einsum import (
    clse_matmul,
    clse_matmul_ref,
    clse_tucker2,
    clse_tucker2_ref,
)
from cirkit_tpu_torch.ops.lse_einsum import (
    lse_matmul,
    lse_matmul_ref,
    lse_matmul_softmax,
    lse_matmul_softmax_ref,
    lse_tucker2,
    lse_tucker2_ref,
    lse_tucker2_softmax,
    lse_tucker2_softmax_ref,
)
from cirkit_tpu_torch.ops.slse_einsum import (
    slse_matmul,
    slse_matmul_ref,
    slse_matmul_softmax,
    slse_matmul_softmax_ref,
    slse_tucker2,
    slse_tucker2_ref,
    slse_tucker2_softmax,
    slse_tucker2_softmax_ref,
)

Semiring = type["SemiringImpl"]


class EinsumFunc(Protocol):
    def __call__(self, *xs: torch.Tensor) -> torch.Tensor: ...


def _finfo_clamp(x: torch.Tensor) -> torch.Tensor:
    info = torch.finfo(x.dtype)
    return x.clamp(info.min, info.max)


class SemiringImpl(ABC):
    """Base class for semiring implementations over torch tensors."""

    _registry: ClassVar[dict[str, Semiring]] = {}
    _morphisms: ClassVar[dict[tuple[Semiring, Semiring], Callable]] = {}

    def __new__(cls) -> "SemiringImpl":
        raise TypeError("Semirings are static namespaces and cannot be instantiated")

    # -- registry -------------------------------------------------------------
    @staticmethod
    def register(name: str) -> Callable[[Semiring], Semiring]:
        def _decorator(cls: Semiring) -> Semiring:
            SemiringImpl._registry[name] = cls
            return cls

        return _decorator

    @classmethod
    def register_map_from(cls, other: Semiring) -> Callable[[Callable], Callable]:
        def _decorator(func: Callable) -> Callable:
            SemiringImpl._morphisms[(other, cls)] = func
            return func

        return _decorator

    @staticmethod
    def from_name(name: str) -> Semiring:
        if name not in SemiringImpl._registry:
            raise IndexError(
                f"Unknown semiring '{name}'; register one with "
                f"@SemiringImpl.register('{name}')"
            )
        return SemiringImpl._registry[name]

    @classmethod
    def map_from(cls, x: torch.Tensor, semiring: Semiring) -> torch.Tensor:
        """Map values represented in another semiring into this one."""
        if cls is semiring:
            return x
        func = SemiringImpl._morphisms.get((semiring, cls))
        if func is None:
            raise NotImplementedError(
                f"No morphism from '{semiring.__name__}' to '{cls.__name__}'"
            )
        return func(x)

    # -- generic einsum -------------------------------------------------------
    @classmethod
    def einsum(
        cls,
        equation: str | Sequence[Sequence[int]],
        *,
        inputs: tuple[torch.Tensor, ...] | None = None,
        operands: tuple[torch.Tensor, ...] | None = None,
        dim: int,
        keepdim: bool,
    ) -> torch.Tensor:
        """An einsum whose additions/multiplications follow this semiring.

        ``inputs`` are semiring-represented values (e.g. log-space); the extra
        ``operands`` (e.g. sum-layer weights) are linear-space and only cast.
        ``dim`` is the axis of the inputs that is contracted (used for the
        max-shift); ``keepdim`` keeps that axis as size 1 in the output.
        ``equation`` is an einsum string or per-operand integer axis lists
        (inputs, then operands, then the output).
        """
        inputs = () if inputs is None else inputs
        operands = () if operands is None else operands

        def func(*xs: torch.Tensor) -> torch.Tensor:
            all_ops = xs + tuple(cls.cast(o) for o in operands)
            if isinstance(equation, str):
                return torch.einsum(equation, *all_ops)
            args: list = []
            for op, spec in zip(all_ops, equation[:-1]):
                args.extend((op, list(spec)))
            args.append(list(equation[-1]))
            return torch.einsum(*args)

        return cls.apply_reduce(func, *inputs, dim=dim, keepdim=keepdim)

    # -- fused contractions (overridden with CUDA kernels where available;
    # the generic versions are plain compositions whatever ``plain`` says) --
    @classmethod
    def matmul(cls, x: torch.Tensor, w: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        """The dense sum-layer contraction: semiring values ``x`` (F, B, I)
        against linear-space weights ``w`` (F, O, I) -> (F, B, O)."""
        return cls.einsum("fbi,foi->fbo", inputs=(x,), operands=(w,), dim=-1, keepdim=True)

    @classmethod
    def tucker2(
        cls, x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, *, plain: bool = False
    ) -> torch.Tensor:
        """The arity-2 Tucker contraction: semiring values ``x1`` (F, B, K1)
        and ``x2`` (F, B, K2) against the linear-space core ``w``
        (F, O, K1*K2), flattened row-major -> (F, B, O)."""
        k1 = x1.shape[-1]
        k2 = x2.shape[-1]
        w3 = w.reshape(w.shape[0], w.shape[1], k1, k2)
        return cls.einsum(
            "fbi,fbj,foij->fbo", inputs=(x1, x2), operands=(w3,), dim=-1, keepdim=True
        )

    @classmethod
    def matmul_softmax(
        cls, x: torch.Tensor, theta: torch.Tensor, *, plain: bool = False
    ) -> torch.Tensor:
        """:meth:`matmul` with weights ``softmax(theta, axis=-1)``; the
        lse-sum override fuses the normalization into the kernel."""
        return cls.matmul(x, torch.softmax(theta, dim=-1), plain=plain)

    @classmethod
    def tucker2_softmax(
        cls, x1: torch.Tensor, x2: torch.Tensor, theta: torch.Tensor, *, plain: bool = False
    ) -> torch.Tensor:
        """:meth:`tucker2` with core weights ``softmax(theta, axis=-1)``."""
        return cls.tucker2(x1, x2, torch.softmax(theta, dim=-1), plain=plain)

    # -- abstract algebra ------------------------------------------------------
    @classmethod
    @abstractmethod
    def cast(cls, x: torch.Tensor) -> torch.Tensor:
        """Cast to the value dtype of this semiring."""

    @classmethod
    @abstractmethod
    def sum(cls, x: torch.Tensor, dim: int, *, keepdim: bool = False) -> torch.Tensor:
        """Semiring sum-reduce along an axis."""

    @classmethod
    @abstractmethod
    def add(cls, *xs: torch.Tensor) -> torch.Tensor:
        """Semiring addition of broadcastable tensors."""

    @classmethod
    @abstractmethod
    def prod(cls, x: torch.Tensor, dim: int, *, keepdim: bool = False) -> torch.Tensor:
        """Semiring product-reduce along an axis."""

    @classmethod
    @abstractmethod
    def mul(cls, *xs: torch.Tensor) -> torch.Tensor:
        """Semiring multiplication of broadcastable tensors."""

    @classmethod
    @abstractmethod
    def apply_reduce(
        cls, func: EinsumFunc, *xs: torch.Tensor, dim: int, keepdim: bool
    ) -> torch.Tensor:
        """Apply a linear-space sum-like function to semiring-space inputs."""


def _cast_real(cls: Semiring, x: torch.Tensor) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return x
    if x.dtype.is_complex:
        raise ValueError(f"Cannot cast dtype '{x.dtype}' to {cls.__name__}")
    return x.to(default_real_dtype())


@SemiringImpl.register("sum-product")
class SumProductSemiring(SemiringImpl):
    """Plain linear-space evaluation."""

    @classmethod
    def cast(cls, x):
        return _cast_real(cls, x)

    @classmethod
    def sum(cls, x, dim, *, keepdim=False):
        return x.sum(dim=dim, keepdim=keepdim)

    @classmethod
    def add(cls, *xs):
        return reduce(torch.add, xs)

    @classmethod
    def prod(cls, x, dim, *, keepdim=False):
        return x.prod(dim=dim, keepdim=keepdim)

    @classmethod
    def mul(cls, *xs):
        return reduce(torch.mul, xs)

    @classmethod
    def apply_reduce(cls, func, *xs, dim, keepdim):
        return func(*xs)


@SemiringImpl.register("lse-sum")
class LSESumSemiring(SemiringImpl):
    """Log-space evaluation: (logsumexp, +)."""

    @classmethod
    def cast(cls, x):
        return _cast_real(cls, x)

    @classmethod
    def sum(cls, x, dim, *, keepdim=False):
        m = _finfo_clamp(x.amax(dim=dim, keepdim=True))
        out = torch.log(torch.sum(torch.exp(x - m), dim=dim, keepdim=keepdim))
        return out + (m if keepdim else m.squeeze(dim))

    @classmethod
    def add(cls, *xs):
        return reduce(torch.logaddexp, xs)

    @classmethod
    def prod(cls, x, dim, *, keepdim=False):
        return x.sum(dim=dim, keepdim=keepdim)

    @classmethod
    def mul(cls, *xs):
        return reduce(torch.add, xs)

    @classmethod
    def apply_reduce(cls, func, *xs, dim, keepdim):
        # The max-shift trick: shift by the clamped max along the contracted
        # axis so exp() never overflows, contract in linear space, then log
        # and add the shifts back.
        maxs = [_finfo_clamp(x.amax(dim=dim, keepdim=True)) for x in xs]
        exps = [torch.exp(x - m) for x, m in zip(xs, maxs)]
        out = func(*exps)
        shift = reduce(torch.add, maxs)
        if not keepdim:
            shift = shift.squeeze(dim)
        return torch.log(out) + shift

    # The fused ops launch the CUDA kernel on CUDA tensors (which takes
    # contiguous operands) and run their plain versions on the CPU.
    @classmethod
    def matmul(cls, x, w, *, plain=False):
        op = lse_matmul_ref if plain else lse_matmul
        return op(x.contiguous(), cls.cast(w).contiguous())

    @classmethod
    def tucker2(cls, x1, x2, w, *, plain=False):
        op = lse_tucker2_ref if plain else lse_tucker2
        return op(x1.contiguous(), x2.contiguous(), cls.cast(w).contiguous())

    @classmethod
    def matmul_softmax(cls, x, theta, *, plain=False):
        op = lse_matmul_softmax_ref if plain else lse_matmul_softmax
        return op(x.contiguous(), cls.cast(theta).contiguous())

    @classmethod
    def tucker2_softmax(cls, x1, x2, theta, *, plain=False):
        op = lse_tucker2_softmax_ref if plain else lse_tucker2_softmax
        return op(x1.contiguous(), x2.contiguous(), cls.cast(theta).contiguous())


@SemiringImpl.register("complex-lse-sum")
class ComplexLSESumSemiring(SemiringImpl):
    """Complex log-space evaluation (for squared / sum-of-squares circuits
    with complex parameters): a value is one complex tensor ``log|f| + i arg
    f``, so shape operations apply to it as to a real one."""

    @classmethod
    def cast(cls, x):
        if x.dtype.is_complex:
            return x
        if x.dtype.is_floating_point:
            return x.to(to_complex_dtype(x.dtype))
        return x.to(to_complex_dtype(default_real_dtype()))

    @classmethod
    def _weight(cls, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """The weight as the fused ops take it: complex, or real at the
        values' precision (a real weight is never widened to a complex copy)."""
        if w.dtype.is_complex:
            return w.to(like.dtype)
        if w.dtype.is_floating_point:
            return w.to(to_real_dtype(like.dtype))
        return w.to(like.dtype)

    @classmethod
    def sum(cls, x, dim, *, keepdim=False):
        m = _finfo_clamp(x.real.amax(dim=dim, keepdim=True))
        out = csafelog(torch.sum(torch.exp(x - m), dim=dim, keepdim=keepdim))
        return out + (m if keepdim else m.squeeze(dim))

    @classmethod
    def add(cls, *xs):
        def _logaddexp(a, b):
            m = _finfo_clamp(torch.maximum(a.real, b.real))
            return csafelog(torch.exp(a - m) + torch.exp(b - m)) + m

        return reduce(_logaddexp, (cls.cast(x) for x in xs))

    @classmethod
    def prod(cls, x, dim, *, keepdim=False):
        return x.sum(dim=dim, keepdim=keepdim)

    @classmethod
    def mul(cls, *xs):
        return reduce(torch.add, xs)

    @classmethod
    def apply_reduce(cls, func, *xs, dim, keepdim):
        xs = tuple(cls.cast(x) for x in xs)
        maxs = [_finfo_clamp(x.real.amax(dim=dim, keepdim=True)) for x in xs]
        exps = [torch.exp(x - m) for x, m in zip(xs, maxs)]
        out = func(*exps)
        shift = reduce(torch.add, maxs)
        if not keepdim:
            shift = shift.squeeze(dim)
        return csafelog(out) + shift

    # The fused ops launch the complex CUDA kernels on CUDA tensors and run
    # their plain versions on the CPU; the logarithm is part of the op.
    @classmethod
    def matmul(cls, x, w, *, plain=False):
        x = cls.cast(x)
        return (clse_matmul_ref if plain else clse_matmul)(x, cls._weight(w, x))

    @classmethod
    def tucker2(cls, x1, x2, w, *, plain=False):
        x1, x2 = cls.cast(x1), cls.cast(x2)
        return (clse_tucker2_ref if plain else clse_tucker2)(x1, x2, cls._weight(w, x1))


@SemiringImpl.register("signed-lse-sum")
class SignedLSESemiring(SemiringImpl):
    """Signed log-space evaluation: values are ``(log|f|, sign)`` pairs of
    real tensors (sign in {-1, 0, +1}).

    For circuits whose parameters are real but whose values may go
    negative (squared / sum-of-squares circuits): with real parameters the
    phase of any value is 0 or pi, so carrying a sign is exact and the whole
    program stays real. Gradients of the sign component are zero (it is
    piecewise constant); magnitudes use :func:`safelog`, so an exact
    cancellation to 0 gives zeroed gradients."""

    @classmethod
    def cast(cls, x):
        if x.dtype.is_complex:
            raise ValueError(
                "The signed semiring supports only real parameters; compile "
                "complex-parameterized circuits under 'complex-lse-sum'"
            )
        if x.dtype.is_floating_point:
            return x
        return x.to(default_real_dtype())

    @staticmethod
    def _from_linear(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return safelog(v.abs()), torch.sign(v)

    @classmethod
    def sum(cls, x, dim, *, keepdim=False):
        a, s = x
        m = _finfo_clamp(a.amax(dim=dim, keepdim=True))
        v = torch.sum(s * torch.exp(a - m), dim=dim, keepdim=keepdim)
        a_out, s_out = cls._from_linear(v)
        return a_out + (m if keepdim else m.squeeze(dim)), s_out

    @classmethod
    def add(cls, *xs):
        def _signed_logaddexp(x, y):
            (a1, s1), (a2, s2) = x, y
            m = _finfo_clamp(torch.maximum(a1, a2))
            v = s1 * torch.exp(a1 - m) + s2 * torch.exp(a2 - m)
            a_out, s_out = cls._from_linear(v)
            return a_out + m, s_out

        return reduce(_signed_logaddexp, xs)

    @classmethod
    def prod(cls, x, dim, *, keepdim=False):
        a, s = x
        return a.sum(dim=dim, keepdim=keepdim), s.prod(dim=dim, keepdim=keepdim)

    @classmethod
    def mul(cls, *xs):
        return (
            reduce(torch.add, (a for a, _ in xs)),
            reduce(torch.mul, (s for _, s in xs)),
        )

    @classmethod
    def apply_reduce(cls, func, *xs, dim, keepdim):
        maxs = [_finfo_clamp(a.amax(dim=dim, keepdim=True)) for a, _ in xs]
        exps = [s * torch.exp(a - m) for (a, s), m in zip(xs, maxs)]
        out = func(*exps)
        shift = reduce(torch.add, maxs)
        if not keepdim:
            shift = shift.squeeze(dim)
        a_out, s_out = cls._from_linear(out)
        return a_out + shift, s_out

    # The fused ops launch the signed CUDA kernels on CUDA tensors (which
    # take contiguous operands) and run their plain versions on the CPU.
    @classmethod
    def matmul(cls, x, w, *, plain=False):
        a, s = x
        op = slse_matmul_ref if plain else slse_matmul
        return op(a.contiguous(), s.contiguous(), cls.cast(w).contiguous())

    @classmethod
    def matmul_softmax(cls, x, theta, *, plain=False):
        a, s = x
        op = slse_matmul_softmax_ref if plain else slse_matmul_softmax
        return op(a.contiguous(), s.contiguous(), cls.cast(theta).contiguous())

    @classmethod
    def tucker2(cls, x1, x2, w, *, plain=False):
        (a1, s1), (a2, s2) = x1, x2
        op = slse_tucker2_ref if plain else slse_tucker2
        return op(a1.contiguous(), s1.contiguous(), a2.contiguous(), s2.contiguous(),
                  cls.cast(w).contiguous())

    @classmethod
    def tucker2_softmax(cls, x1, x2, theta, *, plain=False):
        (a1, s1), (a2, s2) = x1, x2
        op = slse_tucker2_softmax_ref if plain else slse_tucker2_softmax
        return op(a1.contiguous(), s1.contiguous(), a2.contiguous(), s2.contiguous(),
                  cls.cast(theta).contiguous())


@SumProductSemiring.register_map_from(LSESumSemiring)
def _lse_to_sum_product(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


@LSESumSemiring.register_map_from(SumProductSemiring)
def _sum_product_to_lse(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x)


@SignedLSESemiring.register_map_from(LSESumSemiring)
def _lse_to_signed(x: torch.Tensor):
    return x, torch.ones_like(x)


@SignedLSESemiring.register_map_from(SumProductSemiring)
def _sum_product_to_signed(x: torch.Tensor):
    return SignedLSESemiring._from_linear(SignedLSESemiring.cast(x))


@LSESumSemiring.register_map_from(SignedLSESemiring)
def _signed_to_lse(x) -> torch.Tensor:
    # the sign is assumed non-negative at the conversion point
    return x[0]


@SumProductSemiring.register_map_from(SignedLSESemiring)
def _signed_to_sum_product(x) -> torch.Tensor:
    return x[1] * torch.exp(x[0])


@SumProductSemiring.register_map_from(ComplexLSESumSemiring)
def _complex_to_sum_product(x: torch.Tensor) -> torch.Tensor:
    # imaginary parts are assumed to cancel; keep the real exponential
    return torch.exp(x).real


@LSESumSemiring.register_map_from(ComplexLSESumSemiring)
def _complex_to_lse(x: torch.Tensor) -> torch.Tensor:
    return x.real


@ComplexLSESumSemiring.register_map_from(SumProductSemiring)
def _sum_product_to_complex(x: torch.Tensor) -> torch.Tensor:
    return csafelog(ComplexLSESumSemiring.cast(x))


@ComplexLSESumSemiring.register_map_from(LSESumSemiring)
def _lse_to_complex(x: torch.Tensor) -> torch.Tensor:
    return ComplexLSESumSemiring.cast(x)


@ComplexLSESumSemiring.register_map_from(SignedLSESemiring)
def _signed_to_complex(x) -> torch.Tensor:
    a, s = x
    # phase 0 for non-negative values, pi for negative ones
    return torch.complex(a, torch.pi * (s < 0).to(a.dtype))


@SignedLSESemiring.register_map_from(ComplexLSESumSemiring)
def _complex_to_signed(x: torch.Tensor):
    # valid when the phase is (numerically) 0 or pi: real-valued circuits
    return x.real, torch.sign(torch.cos(x.imag))
