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
kernels of ``csrc/clse_einsum.cu``, forward and backward; the complex64
Tucker op against a real weight, the complex flagship's, runs kernels of its
own on the tensor cores (:func:`fwd_entry`, :func:`bwd_entry`). Unlike the TPU
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
:data:`COMPLEX_OPS` and their ``_bwd``, a fast instance's with its suffix
between (``clse_tucker2_sr_bwd``). The kernels take every O, batch and
K1 != K2 in complex64 and complex128 (the JAX dispatcher declines O < 8,
complex128 and large shapes and falls back to XLA).

Speed modes, as for kernels 1-7 (``ops/lse_einsum.py``; the JAX package's
``clse_matmul_parts``, ``cirkit_tpu/ops/lse_einsum.py:1570``):
``CIRKIT_TPU_FAST`` picks the ``_fast`` (round to the nearest bf16) or
``_sr`` (stochastic rounding) instances on complex64 values, which round
each real plane of the contraction operands to bf16 and sum their products
in float32; complex128 runs no fast mode. There is no bf16-weight instance:
the JAX package turns a bf16 real weight into complex64 before its kernel
(``ComplexLSESumSemiring.cast``, ``cirkit_tpu/backend/jax/semiring.py:312-317``),
and the port widens it to the real type of the values (:func:`_real_weight`).
The rounding points, which the plain versions share, with the bits of
:func:`~cirkit_tpu_torch.ops.lse_einsum.sr_bits` at each plane's flat index
in ``torch.view_as_real``'s layout of its operand (``2 k`` and ``2 k + 1``
for the value at flat index ``k``; a real weight's own flat index):

- forward: the real and imaginary planes of ``e = exp(x - m)``, after the
  ``sincos``, at their flat index in (F, B, I) (role ``ROLE_E``), and the
  weight's planes (``ROLE_W``); for Tucker against a complex weight the
  product ``e1 e2``, which the kernel forms one chunk at a time as
  ``exp((x1 - m1) + (x2 - m2))``, and against a real weight (the tensor-core
  kernels, as the unsigned and signed Tucker forwards) the planes of ``e2``
  at their flat index in (F, B, K2), ``e1`` kept complex64;
- backward: the planes of ``gy`` (``ROLE_GY``) and of the weights
  (``ROLE_WB``) of ``de = gy @ conj(w)``, and of ``gy`` and ``e``
  (``ROLE_EB``; for Tucker ``e1 e2``) of ``dw``; ``dx = conj(e) de`` and the
  Tucker dx folds stay float32.
"""

from __future__ import annotations

import torch

from cirkit_tpu_torch.ops import _build
from cirkit_tpu_torch.ops.lse_einsum import (
    LAUNCHES,
    MODE_SUFFIX,
    ROLE_E,
    ROLE_EB,
    ROLE_GY,
    ROLE_W,
    ROLE_WB,
    _MAX_GRID_YZ,
    _TC_TUCKER_TILE,
    _TUCKER_JC,
    _BWD_UNIT_GROUP,
    _call,
    _check_cuda,
    _check_dense,
    _check_tucker,
    _clamp_max,
    _no_graph_through_kernel,
    _on_cpu,
    _traced,
    fast_mode,
    launch_op,
    round_bf16,
)

COMPLEX_OPS = ("clse_matmul", "clse_tucker2")
INSTANCES = _build.COMPLEX_INSTANCES
"""The suffixes of the fast-mode instances (complex64) beside the f32-grade
ones (no suffix): ``clse_tucker2_sr_bwd`` is the Tucker backward in the
``sr`` mode."""
LAUNCHES.update({f"{op}{sfx}{tail}": 0 for op in COMPLEX_OPS for sfx in ("", *INSTANCES)
                 for tail in ("", "_bwd")})

_TILE = 64  # rows and columns of a block's tile, in the tiled kernels of the source
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


def round_planes(t: torch.Tensor, mode: str, role: int) -> torch.Tensor:
    """``t`` rounded as the kernels of ``mode`` round an operand of ``role``
    (:func:`~cirkit_tpu_torch.ops.lse_einsum.round_bf16`): a complex tensor
    plane by plane, at each plane's flat index in ``torch.view_as_real``'s
    layout, a real one at its own flat index."""
    if not mode:
        return t
    if not t.is_complex():
        return round_bf16(t, mode, role)
    return torch.view_as_complex(round_bf16(torch.view_as_real(t.contiguous()), mode, role))


# ``mode`` rounds the operands as the kernels of that mode do (module
# docstring).


def clse_matmul_ref(x: torch.Tensor, w: torch.Tensor, mode: str = "") -> torch.Tensor:
    """``log(exp(x - m) @ w^T) + m`` over complex values, composed from
    PyTorch ops."""
    e, m = _complex_exp(x)
    e, w = round_planes(e, mode, ROLE_E), round_planes(w, mode, ROLE_W)
    return _from_linear(torch.bmm(e, _as(w, e.dtype).transpose(1, 2)), m)


def clse_tucker2_ref(
    x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, mode: str = ""
) -> torch.Tensor:
    """The complex Tucker contraction with the (F, B, K1*K2) outer product
    materialized. In a fast mode, against a real weight (the kernel on the
    tensor cores) the planes of ``e2 = exp(x2 - m2)`` and the weight are
    rounded, ``e1`` kept complex64; against a complex weight each element of
    the outer product is formed as that kernel forms it, ``exp((x1 - m1) +
    (x2 - m2))``, and rounded."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    if mode and w.is_complex():
        m1, m2 = _clamp_max(x1.real), _clamp_max(x2.real)
        re = (x1.real - m1)[..., :, None] + (x2.real - m2)[..., None, :]
        e = _cis(torch.exp(re), x1.imag[..., :, None] + x2.imag[..., None, :])
        e = round_planes(e.reshape(f, b, k1 * k2), mode, ROLE_E)
        w = round_planes(w, mode, ROLE_W)
        return _from_linear(torch.bmm(e, _as(w, e.dtype).transpose(1, 2)), m1 + m2)
    e1, m1 = _complex_exp(x1)
    e2, m2 = _complex_exp(x2)
    if mode:
        e2, w = round_planes(e2, mode, ROLE_E), round_planes(w, mode, ROLE_W)
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
    needs: tuple[bool, bool] = (True, True), mode: str = "",
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dw)`` of :func:`clse_matmul`."""
    e, m = _complex_exp(x)
    gy = round_planes(_complex_gy(g, out, m), mode, ROLE_GY)
    wr = round_planes(w, mode, ROLE_WB)
    dx = e.conj() * torch.bmm(gy, _as(wr, e.dtype).conj()) if needs[0] else None
    dw = _weight_grad(gy, round_planes(e, mode, ROLE_EB), w) if needs[1] else None
    return dx, dw


def clse_tucker2_bwd_ref(
    x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, bool, bool] = (True, True, True), mode: str = "",
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """``(dx1, dx2, dw)`` of :func:`clse_tucker2`, with ``t = gy @ conj(w)``:
    ``dx1[b,i] = conj(e1[b,i]) sum_j t[b,i*K2+j] conj(e2[b,j])``,
    ``dx2[b,j] = conj(e2[b,j]) sum_i t[b,i*K2+j] conj(e1[b,i])``."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    e1, m1 = _complex_exp(x1)
    e2, m2 = _complex_exp(x2)
    gy = round_planes(_complex_gy(g, out, m1 + m2), mode, ROLE_GY)
    dx1 = dx2 = dw = None
    if needs[0] or needs[1]:
        wr = round_planes(w, mode, ROLE_WB)
        t = torch.bmm(gy, _as(wr, e1.dtype).conj()).reshape(f, b, k1, k2)
        if needs[0]:
            dx1 = e1.conj() * (t @ e2.conj()[..., None])[..., 0]
        if needs[1]:
            dx2 = e2.conj() * (e1.conj()[..., None, :] @ t)[..., 0, :]
    if needs[2]:
        e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
        dw = _weight_grad(gy, round_planes(e, mode, ROLE_EB), w)
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


def _instance(op: str, ins: tuple[torch.Tensor, ...], mode: str) -> str:
    """The suffix of the entries of ``mode``: complex128 runs no fast mode."""
    if mode and ins[0].dtype != torch.complex64:
        raise ValueError(f"{op}: {ins[0].dtype} runs no fast mode, found {mode!r}")
    return MODE_SUFFIX[mode]


def _launch_fwd(op: str, ins: tuple[torch.Tensor, ...], mode: str = "") -> torch.Tensor:
    """Check the operands, allocate the output and launch the forward entry
    (in ``mode``; :func:`fwd_entry`) on the current stream."""
    dev = _check_operands(op, ins, len(ins) - 1)
    inst = _instance(op, ins, mode)
    sizes = _sizes(ins)
    f, b, _, _, o = sizes
    width = ins[-1].shape[2]
    if (max(*sizes, width) >= 2**31 or -(-o // _TILE) > _MAX_GRID_YZ
            or -(-b // _TILE) > _MAX_GRID_YZ):
        raise ValueError(f"{op}: sizes {sizes} exceed the kernel's launch grid")
    out = torch.empty((f, b, o), device=dev, dtype=ins[0].dtype)
    if out.numel() == 0:
        return out
    entry = fwd_entry(op, ins[0].dtype, ins[-1].dtype, mode)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if entry.startswith("clse_fwd_tucker_rw"):
        args = (*(t.data_ptr() for t in (*ins, out)), *sizes, dev.index, stream)
    else:
        xb = ins[1].data_ptr() if len(ins) == 3 else None
        args = (ins[0].data_ptr(), xb, ins[-1].data_ptr(), out.data_ptr(), *sizes, *_flags(ins),
                dev.index, stream)
    _call(_build.library(), entry, op, args)
    LAUNCHES[op + inst] += 1
    return out


def _tucker_rw(op: str, dtype: torch.dtype, w_dtype: torch.dtype) -> bool:
    """Whether ``op`` on values of ``dtype`` and a weight of ``w_dtype`` is
    the complex64 Tucker contraction against a real weight (the complex
    flagship's), which has entries of its own on the tensor cores."""
    return op == "clse_tucker2" and dtype == torch.complex64 and not w_dtype.is_complex


def fwd_entry(op: str, dtype: torch.dtype, w_dtype: torch.dtype, mode: str) -> str:
    """The forward entry of ``op`` on values of ``dtype`` and a weight of
    ``w_dtype`` in ``mode``: ``clse_fwd_tucker_rw`` (``csrc/lse_einsum.cu``'s
    ``tucker_fwd_tc`` with ``CPLX``) and its ``_fast`` and ``_sr`` instances
    (``csrc/tucker_bf16.cu``'s ``tucker_fwd_bf16`` with ``CPLX``) for the
    complex64 Tucker op against a real weight; every other configuration
    ``clse_fwd`` (``csrc/clse_einsum.cu``)."""
    rw = _tucker_rw(op, dtype, w_dtype)
    return ("clse_fwd_tucker_rw" if rw else "clse_fwd") + MODE_SUFFIX[mode]


def bwd_entry(op: str, dtype: torch.dtype, w_dtype: torch.dtype, mode: str) -> str:
    """The backward entry of ``op`` on values of ``dtype`` and a weight of
    ``w_dtype`` in ``mode``: the complex64 Tucker backward against a real
    weight (the complex flagship's) has entries of its own on the tensor
    cores, ``clse_bwd_tucker_rw`` (``csrc/lse_einsum_bwd.cu``'s
    ``launch_cbwd_tc``) and its ``_fast`` and ``_sr`` instances
    (``csrc/tucker_bf16_bwd.cu``'s ``tucker_bwd_bf16`` with ``CPLX``); every
    other configuration ``clse_bwd`` (``csrc/clse_einsum.cu``)."""
    rw = _tucker_rw(op, dtype, w_dtype)
    return ("clse_bwd_tucker_rw" if rw else "clse_bwd") + MODE_SUFFIX[mode]


def _ctucker_tc_scratch(f: int, b: int, k1: int, k2: int, o: int) -> int:
    """The float32 scratch of ``clse_bwd_tucker_rw``: the planes of gy, e1 and
    e2 at the Bs = 2 Bp stacked rows (Bp the batch rounded up to 8), (F, Bs,
    O), (F, Bs, K1) and (F, Bs, K2); then the dx partials as complex values,
    a (F, B, K1) plane a column tile and a (F, B, K2) plane a row tile of the
    float32 Tucker dx kernel (``_TC_TUCKER_TILE``)."""
    bn, i_per = _TC_TUCKER_TILE
    bs = 2 * (-(-b // 8) * 8)
    return f * bs * (o + k1 + k2) + 2 * f * b * (-(-k2 // bn) * k1 + -(-k1 // i_per) * k2)


def _ctucker_bf16_scratch(f: int, b: int, k1: int, k2: int, o: int) -> int:
    """The float32 scratch of ``clse_bwd_tucker_rw_fast`` and ``_sr``: the
    planes of e1 and e2 transposed, (F, K1, Rs) and (F, K2, Rs), at the Rs =
    2 Bp stacked rows, and the rounded gy planes in bf16, (F, Rs, Op), with Bp
    and Op the batch and the units rounded up to 8; then the complex dx1
    partials, a (F, B, K1) plane a unit group and column chunk where there are
    more than one, and the complex dx2 partials, a (F, B, K2) plane a unit
    group where there are more than one (``lse_einsum``'s
    ``_tucker_bf16_bwd_scratch`` of the real route)."""
    n_ug, n_jc = -(-o // _BWD_UNIT_GROUP), -(-k2 // _TUCKER_JC)
    rs, op = 2 * (-(-b // 8) * 8), -(-o // 8) * 8
    p1 = n_ug * n_jc
    return (f * (k1 + k2) * rs + f * rs * op // 2 + (2 * p1 * f * b * k1 if p1 > 1 else 0)
            + (2 * n_ug * f * b * k2 if n_ug > 1 else 0))


def _launch_bwd(
    op: str, ins: tuple[torch.Tensor, ...], out: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, ...], mode: str = "",
) -> tuple[torch.Tensor | None, ...]:
    """Allocate the requested gradients and the scratch (the row shifts and
    gy), and launch the backward entry (in ``mode``; :func:`bwd_entry`) on
    the current stream."""
    name = f"{op} backward"
    dev = _check_operands(name, (*ins[:-1], out, g, ins[-1]), len(ins) + 1)
    inst = _instance(name, ins, mode)
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
    dxs = [None if d is None else d.data_ptr() for d in grads[:-1]]
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = bwd_entry(op, ins[0].dtype, ins[-1].dtype, mode)
    if entry.startswith("clse_bwd_tucker_rw"):
        n = (_ctucker_bf16_scratch if mode else _ctucker_tc_scratch)(f, b, k1, k2, o)
        ws = torch.empty(n, device=dev, dtype=torch.float32)
        args = (*(t.data_ptr() for t in (*ins, out, g)), *dxs,
                None if grads[-1] is None else grads[-1].data_ptr(),
                *(t.data_ptr() for t in (*shifts, ws)), *sizes, dev.index, stream)
        _call(lib, entry, name, args)
        LAUNCHES[f"{op}{inst}_bwd"] += 1
        return grads
    # gy, with room for the partial sums of the batch-split dw and of a
    # Tucker dx split over K1
    gy = torch.empty(lib.clse_bwd_gy_size(f, b, k1, k2, o, tucker, w_complex, double),
                     device=dev, dtype=out.dtype)
    args = (
        ins[0].data_ptr(), ins[1].data_ptr() if tucker else None, ins[-1].data_ptr(),
        out.data_ptr(), g.data_ptr(),
        dxs[0], dxs[1] if tucker else None, None if grads[-1] is None else grads[-1].data_ptr(),
        shifts[0].data_ptr(), shifts[1].data_ptr() if tucker else None, gy.data_ptr(),
        *sizes, tucker, w_complex, double, dev.index, stream,
    )
    _call(lib, entry, name, args)
    LAUNCHES[f"{op}{inst}_bwd"] += 1
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
    mode: str = "",
) -> tuple[torch.Tensor | None, ...]:
    """The gradients of ``op`` (one of :data:`COMPLEX_OPS`) with respect to
    its arguments ``ins``, given its output ``out`` and the cotangent ``g``;
    ``needs`` (default: all) selects which, ``mode`` is the forward's speed
    mode. The plain version on CPU tensors, the backward kernel on CUDA
    tensors."""
    needs = (True,) * len(ins) if needs is None else tuple(needs)
    if _on_cpu(*ins, out, g):
        plain = _ENTRIES[op][1]
        return plain(*ins, out, g, needs, mode) if mode else plain(*ins, out, g, needs)
    return _launch_bwd(op, tuple(ins), out, g, needs, mode)


def _fwd_op_fake(op: str, mode: str, ins: list[torch.Tensor]) -> torch.Tensor:
    f, b, _, _, o = _sizes(tuple(ins))
    return ins[0].new_empty((f, b, o))


# the forward launch as the operator ``cirkit_tpu_torch::clse_fwd``, which
# ``torch.export`` records as one node (``lse_einsum.launch_op``)
_fwd_op = launch_op("clse_fwd", "(str op, str mode, Tensor[] ins) -> Tensor",
                    lambda op, mode, ins: _launch_fwd(op, tuple(ins), mode), _fwd_op_fake)


def _forward(ctx, op: str, mode: str, *ins: torch.Tensor) -> torch.Tensor:
    if _on_cpu(*ins):
        # the plain version takes a mode only where one is set
        out = _ENTRIES[op][0](*ins, mode=mode) if mode else _ENTRIES[op][0](*ins)
    else:
        out = _fwd_op(op, mode, list(ins)) if _traced(ins[0]) else _launch_fwd(op, ins, mode)
    ctx.save_for_backward(*ins, out)
    ctx.mode = mode
    return out


def _backward(ctx, op: str, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
    *ins, out = ctx.saved_tensors
    _no_graph_through_kernel(op, *ins)
    needs = ctx.needs_input_grad[: len(ins)]
    return (*backward(op, tuple(ins), out, _resolved(g), needs, ctx.mode), None)


def _resolved(t: torch.Tensor) -> torch.Tensor:
    """``t`` in plain memory: contiguous, with a lazy conjugation or negation
    (``torch.conj`` returns a view) written out."""
    return t.resolve_conj().resolve_neg().contiguous()


# --------------------------------------------------------------------------- #
# The differentiable ops
# --------------------------------------------------------------------------- #
# Each takes its speed mode as a last, non-tensor argument.


class ClseMatmul(torch.autograd.Function):
    """:func:`clse_matmul` with its backward kernel."""

    @staticmethod
    def forward(ctx, x, w, mode):
        return _forward(ctx, "clse_matmul", mode, x, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "clse_matmul", g)


class ClseTucker2(torch.autograd.Function):
    """:func:`clse_tucker2` with its backward kernel."""

    @staticmethod
    def forward(ctx, x1, x2, w, mode):
        return _forward(ctx, "clse_tucker2", mode, x1, x2, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "clse_tucker2", g)


def _real_weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A bf16 weight widened to the real type of ``x``: the kernels have no
    bf16 instance, as the JAX package's have none (its semiring turns a bf16
    real weight into complex64 before the kernel,
    ``cirkit_tpu/backend/jax/semiring.py:312-317``)."""
    return w.to(_REAL_OF[x.dtype]) if w.dtype == torch.bfloat16 else w


def _op_mode(x: torch.Tensor) -> str:
    """The mode of an op on values ``x``: complex128 runs no fast mode."""
    return fast_mode() if x.dtype == torch.complex64 else ""


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
    return ClseMatmul.apply(_resolved(x), _resolved(_real_weight(w, x)), _op_mode(x))


def clse_tucker2(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused arity-2 Tucker contraction under the complex log semiring.

    ``x1``: (F, B, K1) and ``x2``: (F, B, K2) complex log-space inputs;
    ``w``: (F, O, K1*K2) linear-space core weight, complex or real,
    flattened row-major over (K1, K2). Returns (F, B, O) complex values."""
    _check_complex("clse_tucker2", x1, x2)
    _check_tucker(x1, x2, w)
    return ClseTucker2.apply(_resolved(x1), _resolved(x2), _resolved(_real_weight(w, x1)),
                             _op_mode(x1))
