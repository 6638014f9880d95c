"""Numerics helpers for the PyTorch backend.

The counterpart of ``cirkit_tpu/backend/jax/utils.py``: a safe logarithm
whose gradient is 0 where ``1/x`` is not finite (the reference's
``SafeLog``, ``cirkit/backend/torch/utils.py:10-30``), and the ambient
dtypes the compiler materializes parameters in.
"""

from __future__ import annotations

import torch


def default_real_dtype() -> torch.dtype:
    """The ambient real dtype: ``torch.get_default_dtype()``."""
    return torch.get_default_dtype()


def default_int_dtype() -> torch.dtype:
    """The ambient integer dtype (PyTorch indexes with int64)."""
    return torch.int64


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
