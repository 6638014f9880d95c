"""Fused signed log-einsum-exp ops: the sum layers of the signed semiring.

The counterpart of ``cirkit_tpu/ops/lse_einsum.py:925-1111`` (the kernels
``_s_fwd_kernel`` / ``_s_bwd_kernel`` behind ``slse_dispatch``). The signed
log semiring carries every value as a ``(log|v|, sign v)`` pair of real
tensors (signs are float32 in {-1, 0, +1}), so squared (sum-of-squares)
circuits with real, possibly negative parameters run in float32 with no
complex numbers. A sum layer is the max-shifted contraction of the signed
exponentials ``e = s * exp(a - m)`` against real weights:

- :func:`slse_matmul` / :func:`slse_matmul_softmax`: the dense folded
  contraction ``(F, B, I) x (F, O, I) -> (F, B, O)``, the ``_softmax``
  variant normalizing the rows of the logits inside the kernel;
- :func:`slse_tucker2` / :func:`slse_tucker2_softmax`: the arity-2 Tucker
  contraction against an (F, O, K1*K2) core.

Each returns ``(log|y| + shift, sign y)``; an exact cancellation ``y = 0``
gives ``(-inf, 0)``, never NaN. Each op is a ``torch.autograd.Function``
around two entries of the hand-written CUDA kernels (``csrc/lse_einsum.cu``
and ``csrc/lse_einsum_bwd.cu``, the lse kernels' ``SIGNED`` instances). The
sign output is piecewise constant: it is marked non-differentiable and its
cotangent is dropped, as the JAX package's ``_sfused_p_bwd`` does. The
gradients of the sign inputs are not computed (they come back as None): in
the JAX package they only ever reach ``jnp.sign``, a dropped sign output or a
constant, never a parameter.

Beside each kernel stands its plain PyTorch version (``*_ref``, mirroring
the JAX package's XLA composition, ``backend/jax/semiring.py:456-502``, and
``*_bwd_ref``, the backward kernel's math). An op takes the plain versions
only for tensors on the CPU; a CUDA tensor gets the kernel or an exception.
Launches count into :data:`cirkit_tpu_torch.ops.lse_einsum.LAUNCHES` under
the op names of :data:`SIGNED_OPS` and their ``_bwd``. The kernels take every
O and batch (the JAX dispatcher declines O < 8 and falls back to XLA) and
mask the ragged batch edge; the JAX dispatcher's padding (log-magnitudes
with -FLT_MAX, signs with +1) is not needed.
"""

from __future__ import annotations

import torch

from cirkit_tpu_torch.ops import _build
from cirkit_tpu_torch.ops.lse_einsum import (
    LAUNCHES,
    _BWD_DX_COLS,
    _BWD_ROWS,
    _MAX_GRID_YZ,
    _BM,
    _BN,
    _call,
    _check_dense,
    _check_single_pass,
    _check_tucker,
    _clamp_max,
    _on_cpu,
    _softmax_vjp,
)

SIGNED_OPS = ("slse_matmul", "slse_matmul_softmax", "slse_tucker2", "slse_tucker2_softmax")
LAUNCHES.update({name: 0 for op in SIGNED_OPS for name in (op, f"{op}_bwd")})

Pair = tuple[torch.Tensor, torch.Tensor]


# --------------------------------------------------------------------------- #
# Plain PyTorch versions
# --------------------------------------------------------------------------- #


def _signed_exp(a: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s * exp(a - m), m)`` with m the clamped row max of ``a``."""
    m = _clamp_max(a)
    return s * torch.exp(a - m), m


def _from_linear(y: torch.Tensor, shift: torch.Tensor) -> Pair:
    return torch.log(y.abs()) + shift, torch.sign(y)


def slse_matmul_ref(a: torch.Tensor, s: torch.Tensor, w: torch.Tensor) -> Pair:
    """``(log|e @ w^T| + m, sign(e @ w^T))`` with ``e = s * exp(a - m)``."""
    e, m = _signed_exp(a, s)
    return _from_linear(torch.bmm(e, w.transpose(1, 2)), m)


def slse_matmul_softmax_ref(a: torch.Tensor, s: torch.Tensor, theta: torch.Tensor) -> Pair:
    return slse_matmul_ref(a, s, torch.softmax(theta, dim=-1))


def slse_tucker2_ref(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor, w: torch.Tensor
) -> Pair:
    """The signed Tucker contraction with the (F, B, K1*K2) outer product
    materialized."""
    f, b, k1 = a1.shape
    k2 = a2.shape[2]
    e1, m1 = _signed_exp(a1, s1)
    e2, m2 = _signed_exp(a2, s2)
    e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
    return _from_linear(torch.bmm(e, w.transpose(1, 2)), m1 + m2)


def slse_tucker2_softmax_ref(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor,
    theta: torch.Tensor,
) -> Pair:
    return slse_tucker2_ref(a1, s1, a2, s2, torch.softmax(theta, dim=-1))


# The plain backward versions: the math of the backward kernel (and of the
# JAX package's ``_s_bwd_kernel``, ``cirkit_tpu/ops/lse_einsum.py:957-1006``)
# without the sign inputs' gradients. ``needs`` is ``ctx.needs_input_grad``
# over the forward's arguments; the sign inputs' entries are ignored and
# their gradients come back as None.


def _signed_gy(g: torch.Tensor, oa: torch.Tensor, os: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """``g / y = g * sign(y) * exp(shift - log|y|)``, non-finite values set
    to 0 (an exact cancellation and a row that is all -inf give 0)."""
    gy = g * os * torch.exp(shift - oa)
    return torch.where(torch.isfinite(gy), gy, torch.zeros_like(gy))


def slse_matmul_bwd_ref(
    a: torch.Tensor, s: torch.Tensor, w: torch.Tensor, oa: torch.Tensor, os: torch.Tensor,
    g: torch.Tensor, needs: tuple[bool, ...] = (True, False, True),
) -> tuple[torch.Tensor | None, None, torch.Tensor | None]:
    """``(da, None, dw)`` of :func:`slse_matmul`: ``da = e * (gy @ w)`` and
    ``dw = sum_b gy^T e`` with ``e = s * exp(a - m)``."""
    e, m = _signed_exp(a, s)
    gy = _signed_gy(g, oa, os, m)
    da = e * torch.bmm(gy, w) if needs[0] else None
    dw = torch.bmm(gy.transpose(1, 2), e) if needs[2] else None
    return da, None, dw


def slse_matmul_softmax_bwd_ref(
    a: torch.Tensor, s: torch.Tensor, theta: torch.Tensor, oa: torch.Tensor,
    os: torch.Tensor, g: torch.Tensor, needs: tuple[bool, ...] = (True, False, True),
) -> tuple[torch.Tensor | None, None, torch.Tensor | None]:
    """``(da, None, dtheta)`` of :func:`slse_matmul_softmax`."""
    w = torch.softmax(theta, dim=-1)
    da, _, dw = slse_matmul_bwd_ref(a, s, w, oa, os, g, needs)
    return da, None, None if dw is None else _softmax_vjp(w, dw)


def slse_tucker2_bwd_ref(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor, w: torch.Tensor,
    oa: torch.Tensor, os: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, ...] = (True, False, True, False, True),
) -> tuple[torch.Tensor | None, None, torch.Tensor | None, None, torch.Tensor | None]:
    """``(da1, None, da2, None, dw)`` of :func:`slse_tucker2`, with
    ``t = gy @ w``: ``da1[b,i] = e1[b,i] sum_j t[b,i*K2+j] e2[b,j]``,
    ``da2[b,j] = e2[b,j] sum_i t[b,i*K2+j] e1[b,i]`` and ``dw = sum_b gy^T e``
    over the signed exponentials."""
    f, b, k1 = a1.shape
    k2 = a2.shape[2]
    e1, m1 = _signed_exp(a1, s1)
    e2, m2 = _signed_exp(a2, s2)
    gy = _signed_gy(g, oa, os, m1 + m2)
    da1 = da2 = dw = None
    if needs[0] or needs[2]:
        t = torch.bmm(gy, w).reshape(f, b, k1, k2)
        if needs[0]:
            da1 = e1 * (t @ e2[..., None])[..., 0]
        if needs[2]:
            da2 = e2 * (e1[..., None, :] @ t)[..., 0, :]
    if needs[4]:
        e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
        dw = torch.bmm(gy.transpose(1, 2), e)
    return da1, None, da2, None, dw


def slse_tucker2_softmax_bwd_ref(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor,
    theta: torch.Tensor, oa: torch.Tensor, os: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, ...] = (True, False, True, False, True),
) -> tuple[torch.Tensor | None, None, torch.Tensor | None, None, torch.Tensor | None]:
    """``(da1, None, da2, None, dtheta)`` of :func:`slse_tucker2_softmax`."""
    w = torch.softmax(theta, dim=-1)
    da1, _, da2, _, dw = slse_tucker2_bwd_ref(a1, s1, a2, s2, w, oa, os, g, needs)
    return da1, None, da2, None, None if dw is None else _softmax_vjp(w, dw)


# --------------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------------- #


def _sizes(ins: tuple[torch.Tensor, ...]) -> tuple[int, ...]:
    """(F, B, I, O) of the dense ops, (F, B, K1, K2, O) of the Tucker ones;
    ``ins`` alternates log-magnitudes and signs, then the weight."""
    *xs, w = ins
    return (*xs[0].shape[:2], *(x.shape[2] for x in xs[::2]), w.shape[1])


def _launch_fwd(op: str, ins: tuple[torch.Tensor, ...]) -> Pair:
    """Check the operands, allocate both outputs and launch the forward entry
    of ``op`` on the current stream."""
    dev, suffix = _check_single_pass(op, ins)
    sizes = _sizes(ins)
    f, b, o = sizes[0], sizes[1], sizes[-1]
    width = ins[-1].shape[2]
    if max(*sizes, width) >= 2**31 or -(-o // _BN) > _MAX_GRID_YZ or -(-b // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"{op}: sizes {sizes} exceed the kernel's launch grid")
    oa = torch.empty((f, b, o), device=dev, dtype=ins[0].dtype)
    os = torch.empty_like(oa)
    if oa.numel() == 0:
        return oa, os
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*(t.data_ptr() for t in (*ins, oa, os)), *sizes, dev.index, stream)
    _call(_build.library(), _ENTRIES[op][0] + suffix, op, args)
    LAUNCHES[op] += 1
    return oa, os


def _launch_bwd(
    op: str, ins: tuple[torch.Tensor, ...], oa: torch.Tensor, os: torch.Tensor,
    g: torch.Tensor, needs: tuple[bool, ...],
) -> tuple[torch.Tensor | None, ...]:
    """Allocate the requested gradients (log-magnitude inputs and weight; the
    sign inputs' stay None) and the scratch, and launch the backward entry
    of ``op`` on the current stream."""
    dev, suffix = _check_single_pass(f"{op} backward", (*ins, oa, os, g))
    # the log-magnitudes and the weight sit at the even positions of ``ins``
    needs = tuple(need and i % 2 == 0 for i, need in enumerate(needs))
    grads = tuple(torch.empty_like(t) if need else None for t, need in zip(ins, needs))
    if not any(needs):
        return grads
    if oa.numel() == 0 or ins[0].numel() == 0:
        return tuple(None if d is None else d.zero_() for d in grads)
    sizes = _sizes(ins)
    f, b, o = sizes[0], sizes[1], sizes[-1]
    i = ins[-1].shape[2]
    tucker = op.startswith("slse_tucker2")
    if max(-(-b // _BWD_ROWS), -(-o // _BWD_ROWS), -(-i // _BWD_DX_COLS)) > _MAX_GRID_YZ:
        raise ValueError(f"{op} backward: sizes {sizes} exceed the kernel's launch grid")
    lib = _build.library()
    # scratch: the row shifts, gy with room for the partial sums of the
    # batch-split dw and of a Tucker dx split over K1 (lse_bwd_gy_size), and
    # for softmax the (F, O, I) weights
    k1, k2 = sizes[2:4] if tucker else (i, 1)
    scratch = [torch.empty((f, b), device=dev, dtype=ins[0].dtype)
               for _ in range(2 if tucker else 1)]
    n = getattr(lib, "lse_bwd_gy_size" + suffix)(1, int(tucker), f, b, k1, k2, o)
    scratch.append(torch.empty(n, device=dev, dtype=ins[0].dtype))
    if op.endswith("softmax"):
        scratch.append(torch.empty_like(ins[-1]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        *(t.data_ptr() for t in (*ins, oa, os, g)),
        *(None if d is None else d.data_ptr() for d in grads[::2]),
        *(t.data_ptr() for t in scratch),
        *sizes,
        dev.index,
        stream,
    )
    _call(lib, _ENTRIES[op][1] + suffix, f"{op} backward", args)
    LAUNCHES[f"{op}_bwd"] += 1
    return grads


# op -> (forward entry, backward entry, forward plain version, backward plain version)
_ENTRIES = {
    "slse_matmul": ("slse_fwd_dense", "slse_bwd_dense", slse_matmul_ref, slse_matmul_bwd_ref),
    "slse_matmul_softmax": ("slse_fwd_dense_softmax", "slse_bwd_dense_softmax",
                            slse_matmul_softmax_ref, slse_matmul_softmax_bwd_ref),
    "slse_tucker2": ("slse_fwd_tucker", "slse_bwd_tucker", slse_tucker2_ref,
                     slse_tucker2_bwd_ref),
    "slse_tucker2_softmax": ("slse_fwd_tucker_softmax", "slse_bwd_tucker_softmax",
                             slse_tucker2_softmax_ref, slse_tucker2_softmax_bwd_ref),
}


def backward(
    op: str,
    ins: tuple[torch.Tensor, ...],
    oa: torch.Tensor,
    os: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, ...] | None = None,
) -> tuple[torch.Tensor | None, ...]:
    """The gradients of ``op`` (one of :data:`SIGNED_OPS`) with respect to
    its arguments ``ins`` (log-magnitudes, signs, weight), given its outputs
    ``(oa, os)`` and the cotangent ``g`` of ``oa``; ``needs`` (default: all)
    selects which. The sign inputs' gradients are always None. The plain
    version on CPU tensors, the backward kernel on CUDA tensors."""
    needs = (True,) * len(ins) if needs is None else tuple(needs)
    if _on_cpu(*ins, oa, os, g):
        return _ENTRIES[op][3](*ins, oa, os, g, needs)
    return _launch_bwd(op, tuple(ins), oa, os, g, needs)


def _forward(ctx, op: str, *ins: torch.Tensor) -> Pair:
    oa, os = _ENTRIES[op][2](*ins) if _on_cpu(*ins) else _launch_fwd(op, ins)
    ctx.save_for_backward(*ins, oa, os)
    ctx.mark_non_differentiable(os)
    return oa, os


def _backward(ctx, op: str, g: torch.Tensor, _g_sign) -> tuple[torch.Tensor | None, ...]:
    # the sign output is piecewise constant: its cotangent is dropped
    *ins, oa, os = ctx.saved_tensors
    return backward(op, tuple(ins), oa, os, g.contiguous(), ctx.needs_input_grad)


# --------------------------------------------------------------------------- #
# The differentiable ops
# --------------------------------------------------------------------------- #


class SlseMatmul(torch.autograd.Function):
    """:func:`slse_matmul` with its backward kernel."""

    @staticmethod
    def forward(ctx, a, s, w):
        return _forward(ctx, "slse_matmul", a, s, w)

    @staticmethod
    def backward(ctx, g, gs):
        return _backward(ctx, "slse_matmul", g, gs)


class SlseMatmulSoftmax(torch.autograd.Function):
    """:func:`slse_matmul_softmax`; the backward returns the logits' gradient."""

    @staticmethod
    def forward(ctx, a, s, theta):
        return _forward(ctx, "slse_matmul_softmax", a, s, theta)

    @staticmethod
    def backward(ctx, g, gs):
        return _backward(ctx, "slse_matmul_softmax", g, gs)


class SlseTucker2(torch.autograd.Function):
    """:func:`slse_tucker2` with its backward kernel."""

    @staticmethod
    def forward(ctx, a1, s1, a2, s2, w):
        return _forward(ctx, "slse_tucker2", a1, s1, a2, s2, w)

    @staticmethod
    def backward(ctx, g, gs):
        return _backward(ctx, "slse_tucker2", g, gs)


class SlseTucker2Softmax(torch.autograd.Function):
    """:func:`slse_tucker2_softmax`; the backward returns the logits' gradient."""

    @staticmethod
    def forward(ctx, a1, s1, a2, s2, theta):
        return _forward(ctx, "slse_tucker2_softmax", a1, s1, a2, s2, theta)

    @staticmethod
    def backward(ctx, g, gs):
        return _backward(ctx, "slse_tucker2_softmax", g, gs)


def _check_pair(a: torch.Tensor, s: torch.Tensor) -> None:
    if a.shape != s.shape:
        raise ValueError(f"A signed value's log-magnitude {tuple(a.shape)} and sign "
                         f"{tuple(s.shape)} differ in shape")


def slse_matmul(a: torch.Tensor, s: torch.Tensor, w: torch.Tensor) -> Pair:
    """Fused signed ``(log|y|, sign y)`` of ``y = (s * exp(a - m)) @ w^T``
    (times ``exp(m)``) over the trailing axis.

    ``a``, ``s``: (F, B, I) log-magnitudes and signs; ``w``: (F, O, I) real
    weights, possibly negative. Returns two (F, B, O) tensors."""
    _check_pair(a, s)
    _check_dense(a, w)
    return SlseMatmul.apply(a, s, w)


def slse_matmul_softmax(a: torch.Tensor, s: torch.Tensor, theta: torch.Tensor) -> Pair:
    """:func:`slse_matmul` with ``w = softmax(theta, axis=-1)`` fused into
    the kernel: the normalized weights are never stored."""
    _check_pair(a, s)
    _check_dense(a, theta)
    return SlseMatmulSoftmax.apply(a, s, theta)


def slse_tucker2(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor, w: torch.Tensor
) -> Pair:
    """Fused arity-2 Tucker contraction under the signed semiring.

    ``(a1, s1)``: (F, B, K1) and ``(a2, s2)``: (F, B, K2) signed inputs;
    ``w``: (F, O, K1*K2) real core weight, flattened row-major over (K1,
    K2). Returns the (F, B, O) ``(log|y|, sign y)`` pair."""
    _check_pair(a1, s1)
    _check_pair(a2, s2)
    _check_tucker(a1, a2, w)
    return SlseTucker2.apply(a1, s1, a2, s2, w)


def slse_tucker2_softmax(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor,
    theta: torch.Tensor,
) -> Pair:
    """:func:`slse_tucker2` with ``w = softmax(theta, axis=-1)`` fused into
    the kernel."""
    _check_pair(a1, s1)
    _check_pair(a2, s2)
    _check_tucker(a1, a2, theta)
    return SlseTucker2Softmax.apply(a1, s1, a2, s2, theta)
