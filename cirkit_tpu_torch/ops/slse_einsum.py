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
and ``csrc/lse_einsum_bwd.cu``, the lse kernels' ``SIGNED`` instances; the
float32 Tucker forward and backward run the lse Tucker kernels with the signs
folded in, on the tensor cores, and in a fast mode ``csrc/tucker_bf16.cu``'s
and ``csrc/tucker_bf16_bwd.cu``'s: :func:`bwd_route`). The
sign output is piecewise constant: it is marked non-differentiable and its
cotangent is dropped, as the JAX package's ``_sfused_p_bwd`` does. The
gradients of the sign inputs are not computed (they come back as None): in
the JAX package they only ever reach ``jnp.sign``, a dropped sign output or a
constant, never a parameter.

Beside each kernel stands its plain PyTorch version (``*_ref``, mirroring
the JAX package's XLA composition, ``backend/jax/semiring.py:456-502``, and
``*_bwd_ref``, the backward kernel's math). An op takes the plain versions
only for tensors on the CPU; a CUDA tensor gets the kernel or an exception
(under a tracer the forward launch goes through the operator
``cirkit_tpu_torch::slse_fwd``). Launches count into
:data:`cirkit_tpu_torch.ops.lse_einsum.LAUNCHES` under the op names of
:data:`SIGNED_OPS` and their ``_bwd``, an instance's with its suffix between
(``slse_tucker2_softmax_w16_fast_bwd``). The kernels take every O and batch
(the JAX dispatcher declines O < 8 and falls back to XLA) and mask the
ragged batch edge; the JAX dispatcher's padding (log-magnitudes with
-FLT_MAX, signs with +1) is not needed.

Weight stores and speed modes, as for kernels 1-5 (``ops/lse_einsum.py``;
the JAX package's ``slse_dispatch``, ``cirkit_tpu/ops/lse_einsum.py:1063-1098``):
a bf16 weight or logits operand beside float32 activations is read as it is
by the ``_w16`` instances and widened on chip, and its gradient is
accumulated in float32 and cast to bf16 at the boundary (``_sfused_p_bwd``);
``CIRKIT_TPU_FAST`` picks the ``_fast`` (round to the nearest bf16) or
``_sr`` (stochastic rounding) instances, which round the contraction
operands to bf16 and sum their products in float32. Float64 runs no fast
mode and takes a bf16 weight widened. The rounding points, which the plain
versions share, with the bits of :func:`~cirkit_tpu_torch.ops.lse_einsum.sr_bits`:

- forward: the staged signed exponentials ``e = s * exp(a - m)``, each at
  its flat index in (F, B, I) (role ``ROLE_E``), and the weights
  (``ROLE_W``), with logits ``exp(theta - row max)``, the normalizer summed
  unrounded in float32. The narrow dense kernel rounds each row's ``e`` as
  it writes it to shared memory and its staged weight tile. The Tucker
  forwards round as the unsigned ones do (``ops/lse_einsum.py``): ``e2 = s2
  exp(a2 - m2)`` at its flat index in (F, B, K2) and the weights, ``e1 = s1
  exp(a1 - m1)`` kept float32 (the kernel folds it in after the products),
  and with logits ``exp(theta - r)`` over each unit's running max ``r`` of
  the tiles so far;
- backward: ``gy`` (``ROLE_GY``, the flat index in (F, B, O)) and the
  weights (``ROLE_WB``) of ``t = gy @ w``, ``gy`` and ``e`` (``ROLE_EB``; for
  Tucker ``e1 * e2``) of ``dw = gy^T e``, as in kernel 2; ``dx = e * t``, the
  Tucker dx folds and the softmax VJP stay float32, and so do the softmax
  weights of ``t`` (kernel 2's reason: their last bits carry the row's
  normalizer).
"""

from __future__ import annotations

import torch

from cirkit_tpu_torch.ops import _build
from cirkit_tpu_torch.ops.lse_einsum import (
    INSTANCES,
    LAUNCHES,
    ROLE_E,
    ROLE_EB,
    ROLE_GY,
    ROLE_W,
    ROLE_WB,
    _BWD_DX_COLS,
    _BWD_ROWS,
    _MAX_GRID_YZ,
    _BM,
    _BN,
    _call,
    _check_dense,
    _check_tucker,
    _check_weighted,
    _clamp_max,
    _fast_softmax_weights,
    _no_graph_through_kernel,
    _on_cpu,
    _op_mode,
    _softmax_parts,
    _softmax_vjp,
    _traced,
    _tucker_bf16_bwd_scratch,
    _tucker_fast_numerators,
    _tucker_tc_scratch,
    _weight_for,
    bf16_pair,
    launch_op,
    round_bf16,
    softmax_vjp_from_g,
)

SIGNED_OPS = ("slse_matmul", "slse_matmul_softmax", "slse_tucker2", "slse_tucker2_softmax")
LAUNCHES.update({f"{op}{sfx}{tail}": 0 for op in SIGNED_OPS for sfx in ("", *INSTANCES)
                 for tail in ("", "_bwd")})

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


# ``mode`` rounds the operands as the kernels of that mode do (module
# docstring); a bf16 weight is widened to the activations' type, exactly.


def slse_matmul_ref(a: torch.Tensor, s: torch.Tensor, w: torch.Tensor, mode: str = "") -> Pair:
    """``(log|e @ w^T| + m, sign(e @ w^T))`` with ``e = s * exp(a - m)``."""
    e, m = _signed_exp(a, s)
    w = w.to(a.dtype)
    if mode:
        e, w = round_bf16(e, mode, ROLE_E), round_bf16(w, mode, ROLE_W)
    return _from_linear(torch.bmm(e, w.transpose(1, 2)), m)


def _softmax_ref(fn, theta: torch.Tensor, mode: str, *xs: torch.Tensor) -> Pair:
    """``fn`` on ``softmax(theta)``; in a fast mode on the rounded numerators
    ``exp(theta - row max)``, the log of their float32 normalizer subtracted."""
    theta = theta.to(xs[0].dtype)
    if not mode:
        return fn(*xs, torch.softmax(theta, dim=-1))
    num, lz = _softmax_parts(theta)
    la, sg = fn(*xs, num, mode)
    return la - lz.transpose(1, 2), sg


def slse_matmul_softmax_ref(
    a: torch.Tensor, s: torch.Tensor, theta: torch.Tensor, mode: str = ""
) -> Pair:
    return _softmax_ref(slse_matmul_ref, theta, mode, a, s)


def slse_tucker2_ref(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor, w: torch.Tensor,
    mode: str = "", *, round_w: bool = True,
) -> Pair:
    """The signed Tucker contraction with the (F, B, K1*K2) outer product
    materialized; in a fast mode with ``e2 = s2 exp(a2 - m2)`` and the
    weights rounded, ``e1`` in float32, as the kernel rounds them
    (``round_w=False`` takes ``w`` as already rounded)."""
    f, b, k1 = a1.shape
    k2 = a2.shape[2]
    w = w.to(a1.dtype)
    e1, m1 = _signed_exp(a1, s1)
    e2, m2 = _signed_exp(a2, s2)
    if mode:
        e2 = round_bf16(e2, mode, ROLE_E)
        w = round_bf16(w, mode, ROLE_W) if round_w else w
    e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
    return _from_linear(torch.bmm(e, w.transpose(1, 2)), m1 + m2)


def slse_tucker2_softmax_ref(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor,
    theta: torch.Tensor, mode: str = "",
) -> Pair:
    """:func:`slse_tucker2_ref` on ``softmax(theta)``; in a fast mode on the
    unsigned fast Tucker forwards' weights (``exp(theta - r)`` over each
    unit's running max of the tiles so far, rounded:
    :func:`~cirkit_tpu_torch.ops.lse_einsum._tucker_fast_numerators`), the
    log of their float32 normalizer subtracted."""
    if not mode:
        return _softmax_ref(slse_tucker2_ref, theta, mode, a1, s1, a2, s2)
    w, lz = _tucker_fast_numerators(theta.to(a1.dtype), a2.shape[2], mode)
    la, sg = slse_tucker2_ref(a1, s1, a2, s2, w, mode, round_w=False)
    return la - lz.transpose(1, 2), sg


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


def _rounded(gy: torch.Tensor, w: torch.Tensor, mode: str, round_w: bool):
    """``gy`` and the weights of ``t = gy @ w`` as the backward of ``mode``
    rounds them (``round_w=False``: the softmax weights, left float32)."""
    if not mode:
        return gy, w
    return round_bf16(gy, mode, ROLE_GY), round_bf16(w, mode, ROLE_WB) if round_w else w


def slse_matmul_bwd_ref(
    a: torch.Tensor, s: torch.Tensor, w: torch.Tensor, oa: torch.Tensor, os: torch.Tensor,
    g: torch.Tensor, needs: tuple[bool, ...] = (True, False, True), mode: str = "",
    *, round_w: bool = True,
) -> tuple[torch.Tensor | None, None, torch.Tensor | None]:
    """``(da, None, dw)`` of :func:`slse_matmul`: ``da = e * (gy @ w)`` and
    ``dw = sum_b gy^T e`` with ``e = s * exp(a - m)``; ``dw`` has the
    activations' type."""
    e, m = _signed_exp(a, s)
    gy, w = _rounded(_signed_gy(g, oa, os, m), w.to(a.dtype), mode, round_w)
    da = e * torch.bmm(gy, w) if needs[0] else None
    if needs[2]:
        dw = torch.bmm(gy.transpose(1, 2), round_bf16(e, mode, ROLE_EB) if mode else e)
    else:
        dw = None
    return da, None, dw


def slse_matmul_softmax_bwd_ref(
    a: torch.Tensor, s: torch.Tensor, theta: torch.Tensor, oa: torch.Tensor,
    os: torch.Tensor, g: torch.Tensor, needs: tuple[bool, ...] = (True, False, True),
    mode: str = "",
) -> tuple[torch.Tensor | None, None, torch.Tensor | None]:
    """``(da, None, dtheta)`` of :func:`slse_matmul_softmax`."""
    w = torch.softmax(theta.to(a.dtype), dim=-1)
    da, _, dw = slse_matmul_bwd_ref(a, s, w, oa, os, g, needs, mode, round_w=False)
    return da, None, None if dw is None else _softmax_vjp(w, dw)


def slse_tucker2_bwd_ref(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor, w: torch.Tensor,
    oa: torch.Tensor, os: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, ...] = (True, False, True, False, True), mode: str = "",
    *, round_w: bool = True,
) -> tuple[torch.Tensor | None, None, torch.Tensor | None, None, torch.Tensor | None]:
    """``(da1, None, da2, None, dw)`` of :func:`slse_tucker2`, with
    ``t = gy @ w``: ``da1[b,i] = e1[b,i] sum_j t[b,i*K2+j] e2[b,j]``,
    ``da2[b,j] = e2[b,j] sum_i t[b,i*K2+j] e1[b,i]`` and ``dw = sum_b gy^T e``
    over the signed exponentials; ``dw`` has the activations' type."""
    f, b, k1 = a1.shape
    k2 = a2.shape[2]
    e1, m1 = _signed_exp(a1, s1)
    e2, m2 = _signed_exp(a2, s2)
    gy, w = _rounded(_signed_gy(g, oa, os, m1 + m2), w.to(a1.dtype), mode, round_w)
    da1 = da2 = dw = None
    if needs[0] or needs[2]:
        t = torch.bmm(gy, w).reshape(f, b, k1, k2)
        if needs[0]:
            da1 = e1 * (t @ e2[..., None])[..., 0]
        if needs[2]:
            da2 = e2 * (e1[..., None, :] @ t)[..., 0, :]
    if needs[4]:
        e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
        dw = torch.bmm(gy.transpose(1, 2), round_bf16(e, mode, ROLE_EB) if mode else e)
    return da1, None, da2, None, dw


def slse_tucker2_softmax_bwd_ref(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor,
    theta: torch.Tensor, oa: torch.Tensor, os: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, ...] = (True, False, True, False, True), mode: str = "",
) -> tuple[torch.Tensor | None, None, torch.Tensor | None, None, torch.Tensor | None]:
    """``(da1, None, da2, None, dtheta)`` of :func:`slse_tucker2_softmax`. A
    fast mode forms the weights and the softmax VJP as the fast Tucker
    backward does (the unsigned :func:`~cirkit_tpu_torch.ops.lse_einsum.
    lse_tucker2_softmax_bwd_ref`'s): ``exp(theta - lse)``, their bf16 pair in
    ``t = gy @ w`` (:func:`~cirkit_tpu_torch.ops.lse_einsum.bf16_pair`), and
    the row dot ``sum_c w_c dw_c`` taken as ``sum_b g_b`` over the rows whose
    gy is nonzero (:func:`~cirkit_tpu_torch.ops.lse_einsum.softmax_vjp_from_g`)."""
    theta = theta.to(a1.dtype)
    w = _fast_softmax_weights(theta) if mode else torch.softmax(theta, dim=-1)
    da1, _, da2, _, dw = slse_tucker2_bwd_ref(a1, s1, a2, s2, bf16_pair(w) if mode else w,
                                              oa, os, g, needs, mode, round_w=False)
    if dw is not None:
        if mode:
            gy = _signed_gy(g, oa, os, _clamp_max(a1) + _clamp_max(a2))
            dw = softmax_vjp_from_g(w, dw, g, gy)
        else:
            dw = _softmax_vjp(w, dw)
    return da1, None, da2, None, dw


# --------------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------------- #


def _sizes(ins: tuple[torch.Tensor, ...]) -> tuple[int, ...]:
    """(F, B, I, O) of the dense ops, (F, B, K1, K2, O) of the Tucker ones;
    ``ins`` alternates log-magnitudes and signs, then the weight."""
    *xs, w = ins
    return (*xs[0].shape[:2], *(x.shape[2] for x in xs[::2]), w.shape[1])


def _launch_fwd(op: str, ins: tuple[torch.Tensor, ...], mode: str = "") -> Pair:
    """Check the operands, allocate both outputs and launch the forward entry
    of ``op`` (in ``mode``, on the weight's type) on the current stream."""
    dev, suffix, inst = _check_weighted(op, ins[:-1], ins[-1], mode)
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
    _call(_build.library(), _ENTRIES[op][0] + suffix + inst, op, args)
    LAUNCHES[op + inst] += 1
    return oa, os


def bwd_route(op: str, suffix: str, mode: str) -> str:
    """The kernels that the backward of ``op`` runs on activations of entry
    suffix ``suffix`` (``"_f64"`` or ``""``) in ``mode``: the float32 Tucker
    ops those of the lse Tucker backward with the signs folded in, on the
    tensor cores in the f32-grade mode (``"tc"``, also on a bf16 weight;
    ``csrc/lse_einsum_bwd.cu``'s ``launch_bwd_tc``) and on the bf16 tensor
    cores in a fast mode (``"bf16"``, ``tucker_bwd_bf16`` of
    ``csrc/tucker_bf16_bwd.cu``, which writes the weight's gradient in the
    weight's type); the dense ops and float64 the CUDA-core kernels
    (``"fma"``)."""
    if op.startswith("slse_tucker2") and not suffix:
        return "bf16" if mode else "tc"
    return "fma"


def bwd_scratch(op: str, route: str, f: int, b: int, k1: int, k2: int, o: int) -> int:
    """The float32 values of the scratch ``ws`` of a Tucker backward on
    ``route`` ("tc" or "bf16"; :func:`bwd_route`), beside gy (F, B, O) and
    the row shifts."""
    softmax = op.endswith("softmax")
    if route == "bf16":
        return _tucker_bf16_bwd_scratch(softmax, f, b, k1, k2, o)
    return _tucker_tc_scratch(softmax, f, b, k1, k2, o)


def _launch_bwd(
    op: str, ins: tuple[torch.Tensor, ...], oa: torch.Tensor, os: torch.Tensor,
    g: torch.Tensor, needs: tuple[bool, ...], mode: str = "",
) -> tuple[torch.Tensor | None, ...]:
    """Allocate the requested gradients (log-magnitude inputs and weight; the
    sign inputs' stay None) and the scratch, and launch the backward entry
    of ``op`` (in ``mode``, on the weight's type) on the current stream. The
    weight's gradient has the activations' type, or on the ``"bf16"`` route
    (:func:`bwd_route`) the weight's."""
    dev, suffix, inst = _check_weighted(f"{op} backward", (*ins[:-1], oa, os, g), ins[-1], mode)
    route = bwd_route(op, suffix, mode)
    # the log-magnitudes and the weight sit at the even positions of ``ins``
    needs = tuple(need and i % 2 == 0 for i, need in enumerate(needs))
    grads = tuple(
        torch.empty(t.shape, device=dev,
                    dtype=t.dtype if route == "bf16" and t is ins[-1] else ins[0].dtype)
        if need else None
        for t, need in zip(ins, needs)
    )
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
    k1, k2 = sizes[2:4] if tucker else (i, 1)
    scratch = [torch.empty((f, b), device=dev, dtype=ins[0].dtype)
               for _ in range(2 if tucker else 1)]
    if route != "fma":
        # the row shifts, gy and what the route's kernels ask for (bwd_scratch)
        scratch.append(torch.empty((f, b, o), device=dev, dtype=torch.float32))
        scratch.append(torch.empty(bwd_scratch(op, route, f, b, k1, k2, o), device=dev,
                                   dtype=torch.float32))
    else:
        # the row shifts, gy with room for the partial sums of the
        # batch-split dw and of a Tucker dx split over K1 (lse_bwd_gy_size),
        # and for softmax the (F, O, I) weights
        n = getattr(lib, "lse_bwd_gy_size" + suffix)(1, int(tucker), f, b, k1, k2, o)
        scratch.append(torch.empty(n, device=dev, dtype=ins[0].dtype))
        if op.endswith("softmax"):  # the softmax weights, in the activations' type
            scratch.append(torch.empty(ins[-1].shape, device=dev, dtype=ins[0].dtype))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        *(t.data_ptr() for t in (*ins, oa, os, g)),
        *(None if d is None else d.data_ptr() for d in grads[::2]),
        *(t.data_ptr() for t in scratch),
        *sizes,
        dev.index,
        stream,
    )
    _call(lib, _ENTRIES[op][1] + suffix + inst, f"{op} backward", args)
    LAUNCHES[f"{op}{inst}_bwd"] += 1
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
    mode: str = "",
) -> tuple[torch.Tensor | None, ...]:
    """The gradients of ``op`` (one of :data:`SIGNED_OPS`) with respect to
    its arguments ``ins`` (log-magnitudes, signs, weight), given its outputs
    ``(oa, os)`` and the cotangent ``g`` of ``oa``; ``needs`` (default: all)
    selects which, ``mode`` is the forward's speed mode. The sign inputs'
    gradients are always None. The plain version on CPU tensors, the
    backward kernel on CUDA tensors; the weight's gradient is accumulated in
    float32 and has the weight's type (cast here, or written so by the fast
    Tucker kernel)."""
    needs = (True,) * len(ins) if needs is None else tuple(needs)
    if _on_cpu(*ins, oa, os, g):
        plain = _ENTRIES[op][3]
        grads = plain(*ins, oa, os, g, needs, mode) if mode else plain(*ins, oa, os, g, needs)
    else:
        grads = _launch_bwd(op, tuple(ins), oa, os, g, needs, mode)
    dw = grads[-1]
    return (*grads[:-1], None if dw is None else dw.to(ins[-1].dtype))


def _fwd_op_fake(op: str, mode: str, ins: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    sizes = _sizes(tuple(ins))
    shape = (sizes[0], sizes[1], sizes[-1])
    return ins[0].new_empty(shape), ins[0].new_empty(shape)


# the forward launch as the operator ``cirkit_tpu_torch::slse_fwd``, which
# ``torch.export`` records as one node (``lse_einsum.launch_op``)
_fwd_op = launch_op("slse_fwd", "(str op, str mode, Tensor[] ins) -> (Tensor, Tensor)",
                    lambda op, mode, ins: _launch_fwd(op, tuple(ins), mode), _fwd_op_fake)


def _forward(ctx, op: str, mode: str, *ins: torch.Tensor) -> Pair:
    if _on_cpu(*ins):
        # the plain version takes a mode only where one is set
        oa, os = _ENTRIES[op][2](*ins, mode=mode) if mode else _ENTRIES[op][2](*ins)
    else:
        oa, os = (_fwd_op(op, mode, list(ins)) if _traced(ins[0])
                  else _launch_fwd(op, ins, mode))
    ctx.save_for_backward(*ins, oa, os)
    ctx.mark_non_differentiable(os)
    ctx.mode = mode
    return oa, os


def _backward(ctx, op: str, g: torch.Tensor, _g_sign) -> tuple[torch.Tensor | None, ...]:
    # the sign output is piecewise constant: its cotangent is dropped
    *ins, oa, os = ctx.saved_tensors
    _no_graph_through_kernel(op, *ins)
    needs = ctx.needs_input_grad[: len(ins)]
    return (*backward(op, tuple(ins), oa, os, g.contiguous(), needs, ctx.mode), None)


# --------------------------------------------------------------------------- #
# The differentiable ops
# --------------------------------------------------------------------------- #
# Each takes its speed mode as a last, non-tensor argument.


class SlseMatmul(torch.autograd.Function):
    """:func:`slse_matmul` with its backward kernel."""

    @staticmethod
    def forward(ctx, a, s, w, mode):
        return _forward(ctx, "slse_matmul", mode, a, s, w)

    @staticmethod
    def backward(ctx, g, gs):
        return _backward(ctx, "slse_matmul", g, gs)


class SlseMatmulSoftmax(torch.autograd.Function):
    """:func:`slse_matmul_softmax`; the backward returns the logits' gradient."""

    @staticmethod
    def forward(ctx, a, s, theta, mode):
        return _forward(ctx, "slse_matmul_softmax", mode, a, s, theta)

    @staticmethod
    def backward(ctx, g, gs):
        return _backward(ctx, "slse_matmul_softmax", g, gs)


class SlseTucker2(torch.autograd.Function):
    """:func:`slse_tucker2` with its backward kernel."""

    @staticmethod
    def forward(ctx, a1, s1, a2, s2, w, mode):
        return _forward(ctx, "slse_tucker2", mode, a1, s1, a2, s2, w)

    @staticmethod
    def backward(ctx, g, gs):
        return _backward(ctx, "slse_tucker2", g, gs)


class SlseTucker2Softmax(torch.autograd.Function):
    """:func:`slse_tucker2_softmax`; the backward returns the logits' gradient."""

    @staticmethod
    def forward(ctx, a1, s1, a2, s2, theta, mode):
        return _forward(ctx, "slse_tucker2_softmax", mode, a1, s1, a2, s2, theta)

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
    weights, possibly negative (bf16 beside float32 ``a``: the serving
    store). Returns two (F, B, O) tensors."""
    _check_pair(a, s)
    _check_dense(a, w)
    return SlseMatmul.apply(a, s, _weight_for(a, w), _op_mode(a))


def slse_matmul_softmax(a: torch.Tensor, s: torch.Tensor, theta: torch.Tensor) -> Pair:
    """:func:`slse_matmul` with ``w = softmax(theta, axis=-1)`` fused into
    the kernel: the normalized weights are never stored."""
    _check_pair(a, s)
    _check_dense(a, theta)
    return SlseMatmulSoftmax.apply(a, s, _weight_for(a, theta), _op_mode(a))


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
    return SlseTucker2.apply(a1, s1, a2, s2, _weight_for(a1, w), _op_mode(a1))


def slse_tucker2_softmax(
    a1: torch.Tensor, s1: torch.Tensor, a2: torch.Tensor, s2: torch.Tensor,
    theta: torch.Tensor,
) -> Pair:
    """:func:`slse_tucker2` with ``w = softmax(theta, axis=-1)`` fused into
    the kernel."""
    _check_pair(a1, s1)
    _check_pair(a2, s2)
    _check_tucker(a1, a2, theta)
    return SlseTucker2Softmax.apply(a1, s1, a2, s2, _weight_for(a1, theta), _op_mode(a1))
