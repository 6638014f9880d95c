"""Numerics helpers for the PyTorch backend.

The counterpart of ``cirkit_tpu/backend/jax/utils.py``: safe logarithms
whose gradient is 0 where ``1/x`` is not finite (the reference's
``SafeLog`` and ``ComplexSafeLog``, ``cirkit/backend/torch/utils.py:10-50``),
``jax.nn.softplus``'s softplus, and the ambient dtypes the compiler materializes parameters in.
"""

from __future__ import annotations

import torch


def default_real_dtype() -> torch.dtype:
    """The ambient real dtype: ``torch.get_default_dtype()``."""
    return torch.get_default_dtype()


def default_int_dtype() -> torch.dtype:
    """The ambient integer dtype (PyTorch indexes with int64)."""
    return torch.int64


def default_complex_dtype() -> torch.dtype:
    """The ambient complex dtype: the complex counterpart of the real one."""
    return to_complex_dtype(default_real_dtype())


def to_complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype matching a real dtype's precision (float64 ->
    complex128, every narrower float -> complex64); complex dtypes pass."""
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def to_real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of a complex dtype's parts; real dtypes pass."""
    if not dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.complex128 else torch.float32


class _SafeLog(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.log(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return torch.nan_to_num(g / x, nan=0.0, posinf=0.0, neginf=0.0)


def safelog(x: torch.Tensor) -> torch.Tensor:
    """log(x) whose gradient nan/inf values are zeroed."""
    return _SafeLog.apply(x)


class _ComplexSafeLog(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.log(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        # PyTorch carries the cotangent of a complex value as dL/dRe + i
        # dL/dIm, so the rule of the holomorphic log is g / conj(x) (the JAX
        # package's g / x under JAX's conjugated convention): for a real loss
        # the gradients of the real and imaginary parts equal real calculus.
        grad = g / x.conj()
        ok = torch.isfinite(grad.real) & torch.isfinite(grad.imag)
        return torch.where(ok, grad, torch.zeros_like(grad))


def csafelog(x: torch.Tensor) -> torch.Tensor:
    """Complex log(x) whose gradient is zeroed where it is not finite (an
    exact cancellation to 0 + 0j); ``log 0`` is ``-inf + 0j``."""
    return _ComplexSafeLog.apply(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``): exact at every x, where ``F.softplus`` returns x itself above its
    threshold."""
    return torch.logaddexp(x, x.new_zeros(()))
