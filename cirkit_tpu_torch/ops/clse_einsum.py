"""Fused complex log-einsum-exp ops: the sum layers of the complex log semiring.

The counterpart of ``cirkit_tpu/ops/lse_einsum.py:1409-1582`` (the kernels
``_c_fwd_kernel`` / ``_c_bwd_kernel`` behind ``clse_matmul_parts``). The
complex log semiring carries every value as one complex tensor ``z = a + ib``
standing for ``exp(a) (cos b + i sin b)``, so squared (sum-of-squares)
circuits with complex parameters evaluate in log space. A sum layer is the
max-shifted contraction of the complex exponentials ``e = exp(z - m)``
(``m`` the clamped row max of the real parts) against linear-space weights:

- :func:`clse_matmul`: the dense folded contraction ``(F, B, I) x (F, O, I)
  -> (F, B, O)``;
- :func:`clse_tucker2`: the arity-2 Tucker contraction against an
  (F, O, K1*K2) core; the outer product of the two inputs never reaches
  device memory.

Each returns ``log(y) + m`` as a complex tensor: the real part is
``log|y| + m``, the imaginary part the phase ``atan2(Im y, Re y)`` in
(-pi, pi]. An exact cancellation ``y = 0`` and a row whose real parts are
all -inf give a real part of -inf, never NaN, and zero gradients. The weight
is complex, or real (the softmaxed logits of a monotonic circuit): a real
weight is read as it is, with no complex copy, and gets a real gradient.

Each op is a ``torch.autograd.Function`` around the hand-written CUDA
kernels of ``csrc/clse_einsum.cu``, forward and backward. Unlike the TPU
kernel, which returns the linear-space ``(Re y, Im y, m)`` and leaves the
logarithm to the caller, the CUDA forward writes ``log y + m`` itself and
the backward folds the logarithm's VJP into its first pass. The kernels read
and write PyTorch's interleaved complex layout; seen as (real, imaginary)
planes, a complex cotangent in PyTorch is ``dL/dRe + i dL/dIm``, so the
kernels compute plain real-calculus gradients of the planes and no
conjugation convention reaches the CUDA code.

Beside each kernel stands its plain PyTorch version (``*_ref`` mirroring the
JAX package's ``ComplexLSESumSemiring.apply_reduce``, and ``*_bwd_ref``, the
backward kernel's math). An op takes the plain versions only for tensors on
the CPU; a CUDA tensor gets the kernel or an exception. Launches count into
:data:`cirkit_tpu_torch.ops.lse_einsum.LAUNCHES` under the op names of
:data:`COMPLEX_OPS` and their ``_bwd``. The kernels take every O, batch and
K1 != K2 in complex64 and complex128 (the JAX dispatcher declines O < 8,
complex128 and large shapes and falls back to XLA).
"""

from __future__ import annotations

import torch

from cirkit_tpu_torch.ops import _build
from cirkit_tpu_torch.ops.lse_einsum import (
    LAUNCHES,
    _MAX_GRID_YZ,
    _call,
    _check_cuda,
    _check_dense,
    _check_tucker,
    _clamp_max,
    _on_cpu,
)

COMPLEX_OPS = ("clse_matmul", "clse_tucker2")
LAUNCHES.update({name: 0 for op in COMPLEX_OPS for name in (op, f"{op}_bwd")})

_TILE = 64  # rows and columns of a block's tile, in every kernel of the source
_PREP_ROWS = 8  # batch rows per block of the backward's first pass
_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}


# --------------------------------------------------------------------------- #
# Plain PyTorch versions
# --------------------------------------------------------------------------- #


def _cis(mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    return torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))


def _complex_exp(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(exp(x - m), m)`` with m the clamped row max of the real part."""
    m = _clamp_max(x.real)
    return _cis(torch.exp(x.real - m), x.imag), m


def _from_linear(y: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.log(y.abs()) + shift, torch.angle(y))


def _as(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return w if w.dtype == dtype else w.to(dtype)


def clse_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``log(exp(x - m) @ w^T) + m`` over complex values, composed from
    PyTorch ops."""
    e, m = _complex_exp(x)
    return _from_linear(torch.bmm(e, _as(w, e.dtype).transpose(1, 2)), m)


def clse_tucker2_ref(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The complex Tucker contraction with the (F, B, K1*K2) outer product
    materialized."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    e1, m1 = _complex_exp(x1)
    e2, m2 = _complex_exp(x2)
    e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
    return _from_linear(torch.bmm(e, _as(w, e.dtype).transpose(1, 2)), m1 + m2)


# The plain backward versions: the math of the backward kernel. With y the
# shifted linear-space sum (out = log y + shift) and g the cotangent of out,
# the logarithm's VJP is gy = g / conj(y), zeroed where it is not finite;
# then de = gy @ conj(w), dx = conj(e) * de and dw = sum_b gy^T conj(e) (its
# real part for a real weight): the JAX package's ``_c_bwd_kernel``
# (``cirkit_tpu/ops/lse_einsum.py:1439-1471``) written in complex numbers.


def _complex_gy(g: torch.Tensor, out: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``g / conj(y)`` from ``out = log y + shift``: ``1 / conj(y) =
    exp(shift - Re out) (cos Im out + i sin Im out)``."""
    gy = g * _cis(torch.exp(shift - out.real), out.imag)
    ok = torch.isfinite(gy.real) & torch.isfinite(gy.imag)
    return torch.where(ok, gy, torch.zeros_like(gy))


def _weight_grad(gy: torch.Tensor, e: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dw = torch.bmm(gy.transpose(1, 2), e.conj())
    return dw if w.dtype.is_complex else dw.real


def clse_matmul_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, bool] = (True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dw)`` of :func:`clse_matmul`."""
    e, m = _complex_exp(x)
    gy = _complex_gy(g, out, m)
    dx = e.conj() * torch.bmm(gy, _as(w, e.dtype).conj()) if needs[0] else None
    dw = _weight_grad(gy, e, w) if needs[1] else None
    return dx, dw


def clse_tucker2_bwd_ref(
    x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, bool, bool] = (True, True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """``(dx1, dx2, dw)`` of :func:`clse_tucker2`, with ``t = gy @ conj(w)``:
    ``dx1[b,i] = conj(e1[b,i]) sum_j t[b,i*K2+j] conj(e2[b,j])``,
    ``dx2[b,j] = conj(e2[b,j]) sum_i t[b,i*K2+j] conj(e1[b,i])``."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    e1, m1 = _complex_exp(x1)
    e2, m2 = _complex_exp(x2)
    gy = _complex_gy(g, out, m1 + m2)
    dx1 = dx2 = dw = None
    if needs[0] or needs[1]:
        t = torch.bmm(gy, _as(w, e1.dtype).conj()).reshape(f, b, k1, k2)
        if needs[0]:
            dx1 = e1.conj() * (t @ e2.conj()[..., None])[..., 0]
        if needs[1]:
            dx2 = e2.conj() * (e1.conj()[..., None, :] @ t)[..., 0, :]
    if needs[2]:
        e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
        dw = _weight_grad(gy, e, w)
    return dx1, dx2, dw


# --------------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------------- #


def _check_operands(op: str, ts: tuple[torch.Tensor, ...], n_complex: int) -> torch.device:
    """The device of a launch's operands: the first ``n_complex`` complex64 or
    complex128, the rest (the weight) of that type or of its real type."""
    dev = _check_cuda(op, ts, (torch.complex64, torch.complex128, torch.float32, torch.float64))
    ctype = ts[0].dtype
    if ctype not in _REAL_OF:
        raise TypeError(f"{op}: the kernel takes complex64 or complex128 values, found {ctype}")
    for i, t in enumerate(ts):
        allowed = (ctype,) if i < n_complex else (ctype, _REAL_OF[ctype])
        if t.dtype not in allowed:
            raise TypeError(f"{op}: operands of {ctype} and {t.dtype}")
        if t.is_conj() or t.is_neg():
            raise ValueError(f"{op}: the CUDA kernel takes resolved (not lazily conjugated) "
                             "operands")
    return dev


def _sizes(ins: tuple[torch.Tensor, ...]) -> tuple[int, int, int, int, int]:
    """(F, B, K1, K2, O); a dense op has K1 = I and K2 = 1."""
    *xs, w = ins
    f, b, k1 = xs[0].shape
    return f, b, k1, xs[1].shape[2] if len(xs) == 2 else 1, w.shape[1]


def _flags(ins: tuple[torch.Tensor, ...]) -> tuple[int, int, int]:
    """(tucker, complex weight, complex128) as the entries take them."""
    return int(len(ins) == 3), int(ins[-1].dtype.is_complex), int(ins[0].dtype == torch.complex128)


def _launch_fwd(op: str, ins: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Check the operands, allocate the output and launch the forward entry
    on the current stream."""
    dev = _check_operands(op, ins, len(ins) - 1)
    sizes = _sizes(ins)
    f, b, _, _, o = sizes
    width = ins[-1].shape[2]
    if (max(*sizes, width) >= 2**31 or -(-o // _TILE) > _MAX_GRID_YZ
            or -(-b // _TILE) > _MAX_GRID_YZ):
        raise ValueError(f"{op}: sizes {sizes} exceed the kernel's launch grid")
    out = torch.empty((f, b, o), device=dev, dtype=ins[0].dtype)
    if out.numel() == 0:
        return out
    xb = ins[1].data_ptr() if len(ins) == 3 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (ins[0].data_ptr(), xb, ins[-1].data_ptr(), out.data_ptr(), *sizes, *_flags(ins),
            dev.index, stream)
    _call(_build.library(), "clse_fwd", op, args)
    LAUNCHES[op] += 1
    return out


def _launch_bwd(
    op: str, ins: tuple[torch.Tensor, ...], out: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, ...],
) -> tuple[torch.Tensor | None, ...]:
    """Allocate the requested gradients and the scratch (the row shifts and
    gy), and launch the backward entry on the current stream."""
    name = f"{op} backward"
    dev = _check_operands(name, (*ins[:-1], out, g, ins[-1]), len(ins) + 1)
    grads = tuple(torch.empty_like(t) if need else None for t, need in zip(ins, needs))
    if not any(needs):
        return grads
    if out.numel() == 0 or ins[0].numel() == 0:
        return tuple(None if d is None else d.zero_() for d in grads)
    sizes = _sizes(ins)
    f, b, k1, k2, o = sizes
    tucker, w_complex, double = _flags(ins)
    width = ins[-1].shape[2]
    if max(-(-b // _PREP_ROWS), -(-o // _TILE), -(-width // _TILE)) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: sizes {sizes} exceed the kernel's launch grid")
    lib = _build.library()
    real = _REAL_OF[ins[0].dtype]
    shifts = [torch.empty((f, b), device=dev, dtype=real) for _ in range(2 if tucker else 1)]
    # gy, with room for the partial sums of the batch-split dw and of a
    # Tucker dx split over K1
    gy = torch.empty(lib.clse_bwd_gy_size(f, b, k1, k2, o, tucker, w_complex, double),
                     device=dev, dtype=out.dtype)
    dxs = [None if d is None else d.data_ptr() for d in grads[:-1]]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        ins[0].data_ptr(), ins[1].data_ptr() if tucker else None, ins[-1].data_ptr(),
        out.data_ptr(), g.data_ptr(),
        dxs[0], dxs[1] if tucker else None, None if grads[-1] is None else grads[-1].data_ptr(),
        shifts[0].data_ptr(), shifts[1].data_ptr() if tucker else None, gy.data_ptr(),
        *sizes, tucker, w_complex, double, dev.index, stream,
    )
    _call(lib, "clse_bwd", name, args)
    LAUNCHES[f"{op}_bwd"] += 1
    return grads


# op -> (forward plain version, backward plain version)
_ENTRIES = {
    "clse_matmul": (clse_matmul_ref, clse_matmul_bwd_ref),
    "clse_tucker2": (clse_tucker2_ref, clse_tucker2_bwd_ref),
}


def backward(
    op: str,
    ins: tuple[torch.Tensor, ...],
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, ...] | None = None,
) -> tuple[torch.Tensor | None, ...]:
    """The gradients of ``op`` (one of :data:`COMPLEX_OPS`) with respect to
    its arguments ``ins``, given its output ``out`` and the cotangent ``g``;
    ``needs`` (default: all) selects which. The plain version on CPU
    tensors, the backward kernel on CUDA tensors."""
    needs = (True,) * len(ins) if needs is None else tuple(needs)
    if _on_cpu(*ins, out, g):
        return _ENTRIES[op][1](*ins, out, g, needs)
    return _launch_bwd(op, tuple(ins), out, g, needs)


def _forward(ctx, op: str, *ins: torch.Tensor) -> torch.Tensor:
    out = _ENTRIES[op][0](*ins) if _on_cpu(*ins) else _launch_fwd(op, ins)
    ctx.save_for_backward(*ins, out)
    return out


def _backward(ctx, op: str, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
    *ins, out = ctx.saved_tensors
    return backward(op, tuple(ins), out, _resolved(g), ctx.needs_input_grad)


def _resolved(t: torch.Tensor) -> torch.Tensor:
    """``t`` in plain memory: contiguous, with a lazy conjugation or negation
    (``torch.conj`` returns a view) written out."""
    return t.resolve_conj().resolve_neg().contiguous()


# --------------------------------------------------------------------------- #
# The differentiable ops
# --------------------------------------------------------------------------- #


class ClseMatmul(torch.autograd.Function):
    """:func:`clse_matmul` with its backward kernel."""

    @staticmethod
    def forward(ctx, x, w):
        return _forward(ctx, "clse_matmul", x, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "clse_matmul", g)


class ClseTucker2(torch.autograd.Function):
    """:func:`clse_tucker2` with its backward kernel."""

    @staticmethod
    def forward(ctx, x1, x2, w):
        return _forward(ctx, "clse_tucker2", x1, x2, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "clse_tucker2", g)


def _check_complex(op: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if not x.dtype.is_complex:
            raise TypeError(f"{op}: the values are complex tensors, found {x.dtype}")


def clse_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused complex ``log(exp(x - max Re x) @ w^T) + max Re x`` over the
    trailing axis.

    ``x``: (F, B, I) complex log-space values; ``w``: (F, O, I) linear-space
    weights, complex or real. Returns (F, B, O) complex log-space values."""
    _check_complex("clse_matmul", x)
    _check_dense(x, w)
    return ClseMatmul.apply(_resolved(x), _resolved(w))


def clse_tucker2(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused arity-2 Tucker contraction under the complex log semiring.

    ``x1``: (F, B, K1) and ``x2``: (F, B, K2) complex log-space inputs;
    ``w``: (F, O, K1*K2) linear-space core weight, complex or real,
    flattened row-major over (K1, K2). Returns (F, B, O) complex values."""
    _check_complex("clse_tucker2", x1, x2)
    _check_tucker(x1, x2, w)
    return ClseTucker2.apply(_resolved(x1), _resolved(x2), _resolved(w))
