"""Fused log-einsum-exp ops for the circuit hot path.

The counterpart of ``cirkit_tpu/ops/lse_einsum.py:1590-1687``. The log-space
(lse-sum) semiring evaluates every sum layer as a max-shifted
log-einsum-exp: shift each input row by its clamped max, exponentiate,
contract in linear space, take the log and add the shift back.

- :func:`lse_matmul` / :func:`lse_matmul_softmax`: the dense folded
  contraction ``(F, B, I) x (F, O, I) -> (F, B, O)``; the ``_softmax``
  variant takes raw logits and normalizes the weight rows inside the kernel.
- :func:`lse_tucker2` / :func:`lse_tucker2_softmax`: the arity-2 Tucker
  contraction ``(F, B, K1) x (F, B, K2) x (F, O, K1*K2) -> (F, B, O)``; the
  outer product of the two inputs never reaches device memory.

Each op is a ``torch.autograd.Function`` (the counterpart of the JAX
package's custom VJP ``_fused_p``, ``cirkit_tpu/ops/lse_einsum.py:447-463``)
around two entries of the hand-written CUDA kernels: the forward in
``csrc/lse_einsum.cu`` and the backward in ``csrc/lse_einsum_bwd.cu``.
Contractions of width ``WIDE_WIDTH`` or more (I, or K1*K2 for Tucker: the
K=128 circuits) take the wide kernels of ``csrc/lse_wide.cu`` instead, as
the JAX package takes its chunked and blocked kernels there:

- the Tucker ops launch the K1-chunked forward (``_ct_fwd_kernel``'s
  counterpart, with the online softmax) and the backward kernel above;
- :func:`lse_matmul` launches the blocked forward, which also returns the
  row max, and the blocked backward that reads it (``_blocked_*``);
- :func:`lse_matmul_softmax` normalizes the logits with ``torch.softmax``
  and calls the blocked :func:`lse_matmul`, as the JAX package does
  (``cirkit_tpu/ops/lse_einsum.py:1620-1622``); autograd takes the
  softmax's VJP.

Beside each kernel stands a plain PyTorch version: ``*_ref`` for the
forward, mirroring the JAX package's XLA fallbacks, and ``*_bwd_ref`` for
the backward, computing exactly the backward kernel's math. An op takes the
plain versions only for tensors on the CPU; a CUDA tensor gets the kernel
or an exception. ``LAUNCHES`` counts the op calls that launched a kernel,
one key per op and one per op's backward (``lse_matmul_bwd``, ...), and one
per wide forward entry (``WIDE_OPS``) and the blocked backward.
"""

from __future__ import annotations

import torch

from cirkit_tpu_torch.ops import _build

OPS = ("lse_matmul", "lse_matmul_softmax", "lse_tucker2", "lse_tucker2_softmax")
WIDE_OPS = ("lse_tucker2_chunked", "lse_tucker2_softmax_chunked", "lse_matmul_blocked")
"""The forward entries of the wide kernels (the blocked one also has a
backward, ``lse_matmul_blocked_bwd``)."""
LAUNCHES: dict[str, int] = {
    **{name: 0 for op in OPS for name in (op, f"{op}_bwd")},
    **{op: 0 for op in WIDE_OPS},
    "lse_matmul_blocked_bwd": 0,
}
"""Kernel launches per op and per op's backward; a count rises by one only
where its op launches its kernel."""

WIDE_WIDTH = 8192
"""The contraction width (I, or K1*K2 for Tucker) from which the ops take the
wide kernels: the K=128 circuits' 16384 does, the K=64 flagship's 4096 keeps
the single-pass kernels, as the JAX package chooses on both."""

_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
# the single-pass forward kernels' output-unit and batch-row tiles (the FMA
# kernel's and the float32 Tucker kernel's on the tensor cores)
_BN, _BM = 64, 128
# the blocked forward's (batch-row, output-unit) tiles by entry suffix: the
# float32 kernel on the tensor cores covers 128 units, the float64 one 64
_BLOCKED_TILES = {"": (128, 128), "_f64": (128, 64)}
# the backward kernels' grid tiles (csrc/lse_einsum_bwd.cu): rows per warp
# pass, and input columns of the dense dx kernel (the other grids are smaller)
_BWD_ROWS, _BWD_DX_COLS = 8, 64


def _clamp_max(x: torch.Tensor) -> torch.Tensor:
    """Trailing-axis max clamped to the finite range, so rows that are all
    -inf never produce NaNs via inf - inf."""
    info = torch.finfo(x.dtype)
    return x.amax(dim=-1, keepdim=True).clamp(info.min, info.max)


# --------------------------------------------------------------------------- #
# Plain PyTorch versions
# --------------------------------------------------------------------------- #


def lse_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``log(exp(x - m) @ w^T) + m``, composed from PyTorch ops."""
    m = _clamp_max(x)
    return torch.log(torch.bmm(torch.exp(x - m), w.transpose(1, 2))) + m


def lse_matmul_softmax_ref(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return lse_matmul_ref(x, torch.softmax(theta, dim=-1))


def lse_tucker2_ref(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The Tucker contraction with the (F, B, K1*K2) outer product
    materialized, composed from PyTorch ops."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    m1 = _clamp_max(x1)
    m2 = _clamp_max(x2)
    e = torch.exp(x1 - m1)[..., :, None] * torch.exp(x2 - m2)[..., None, :]
    y = torch.bmm(e.reshape(f, b, k1 * k2), w.transpose(1, 2))
    return torch.log(y) + m1 + m2


def lse_tucker2_softmax_ref(
    x1: torch.Tensor, x2: torch.Tensor, theta: torch.Tensor
) -> torch.Tensor:
    return lse_tucker2_ref(x1, x2, torch.softmax(theta, dim=-1))


def lse_matmul_blocked_ref(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the blocked forward: :func:`lse_matmul_ref` and
    the (F, B, 1) clamped row max of ``x`` that the blocked backward reads."""
    m = _clamp_max(x)
    return torch.log(torch.bmm(torch.exp(x - m), w.transpose(1, 2))) + m, m


# The plain backward versions: the math of the backward kernel (and of the
# JAX package's ``_bwd_kernel``, ``cirkit_tpu/ops/lse_einsum.py:350-396``).
# ``needs`` says which gradients to compute, in argument order; the others
# come back as None.


def _gy(g: torch.Tensor, out: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``g / y = g * exp(shift - out)``, with non-finite values set to 0, so
    a row that is all -inf gives zero gradients and no NaN."""
    gy = g * torch.exp(shift - out)
    return torch.where(torch.isfinite(gy), gy, torch.zeros_like(gy))


def _softmax_vjp(w: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """The softmax VJP on the logits: ``w * (dw - sum_c w_c dw_c)`` per row."""
    return w * (dw - (w * dw).sum(dim=-1, keepdim=True))


def softmax_vjp_from_g(
    w: torch.Tensor, dw: torch.Tensor, g: torch.Tensor, gy: torch.Tensor
) -> torch.Tensor:
    """The softmax VJP as the float32 backward kernel's dw epilogue forms it:
    ``w * (dw - r)`` with the row dot ``r_o = sum_c w_oc dw_oc`` taken as
    ``sum_b g_bo`` over the rows whose ``gy`` (:func:`_gy`) is nonzero. Since
    ``sum_c w_oc e_bc = exp(out_bo - shift_b)``, ``gy_bo`` times it is
    ``g_bo``; where gy was zeroed, or g is 0, the row adds nothing."""
    r = torch.where(gy != 0, g, torch.zeros_like(g)).sum(dim=1)[..., None]
    return w * (dw - r)


def lse_matmul_bwd_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool] = (True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dw)`` of :func:`lse_matmul`: ``dx = e * (gy @ w)`` and
    ``dw = sum_b gy^T e`` with ``e = exp(x - m)``."""
    m = _clamp_max(x)
    e = torch.exp(x - m)
    gy = _gy(g, out, m)
    dx = e * torch.bmm(gy, w) if needs[0] else None
    dw = torch.bmm(gy.transpose(1, 2), e) if needs[1] else None
    return dx, dw


def lse_matmul_softmax_bwd_ref(
    x: torch.Tensor,
    theta: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool] = (True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dtheta)`` of :func:`lse_matmul_softmax`."""
    w = torch.softmax(theta, dim=-1)
    dx, dw = lse_matmul_bwd_ref(x, w, out, g, needs)
    return dx, None if dw is None else _softmax_vjp(w, dw)


def lse_matmul_blocked_bwd_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    out: torch.Tensor,
    m: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool] = (True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dw)`` of the blocked :func:`lse_matmul` (the math of the JAX
    package's ``_blocked_bwd_kernel``, ``cirkit_tpu/ops/lse_einsum.py:572``),
    with the forward's row max ``m`` as the shift."""
    e = torch.exp(x - m)
    gy = _gy(g, out, m)
    dx = e * torch.bmm(gy, w) if needs[0] else None
    dw = torch.bmm(gy.transpose(1, 2), e) if needs[1] else None
    return dx, dw


def lse_tucker2_bwd_ref(
    x1: torch.Tensor,
    x2: torch.Tensor,
    w: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool, bool] = (True, True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """``(dx1, dx2, dw)`` of :func:`lse_tucker2`, with ``s = gy @ w``:
    ``dx1[b,i] = e1[b,i] sum_j s[b,i*K2+j] e2[b,j]``,
    ``dx2[b,j] = e2[b,j] sum_i s[b,i*K2+j] e1[b,i]`` and ``dw = sum_b gy^T e``
    over the (F, B, K1*K2) outer product ``e``, which this materializes."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    m1 = _clamp_max(x1)
    m2 = _clamp_max(x2)
    e1 = torch.exp(x1 - m1)
    e2 = torch.exp(x2 - m2)
    gy = _gy(g, out, m1 + m2)
    dx1 = dx2 = dw = None
    if needs[0] or needs[1]:
        s = torch.bmm(gy, w).reshape(f, b, k1, k2)
        if needs[0]:
            dx1 = e1 * (s @ e2[..., None])[..., 0]
        if needs[1]:
            dx2 = e2 * (e1[..., None, :] @ s)[..., 0, :]
    if needs[2]:
        e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
        dw = torch.bmm(gy.transpose(1, 2), e)
    return dx1, dx2, dw


def lse_tucker2_softmax_bwd_ref(
    x1: torch.Tensor,
    x2: torch.Tensor,
    theta: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool, bool] = (True, True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """``(dx1, dx2, dtheta)`` of :func:`lse_tucker2_softmax`."""
    w = torch.softmax(theta, dim=-1)
    dx1, dx2, dw = lse_tucker2_bwd_ref(x1, x2, w, out, g, needs)
    return dx1, dx2, None if dw is None else _softmax_vjp(w, dw)


# --------------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------------- #


def _check_dense(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[2]:
        raise ValueError(f"Expected x (F, B, I) and w (F, O, I), found {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def _check_tucker(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> None:
    if (
        x1.dim() != 3
        or x2.dim() != 3
        or w.dim() != 3
        or x1.shape[:2] != x2.shape[:2]
        or w.shape[0] != x1.shape[0]
        or w.shape[2] != x1.shape[2] * x2.shape[2]
    ):
        raise ValueError(
            f"Expected x1 (F, B, K1), x2 (F, B, K2) and w (F, O, K1*K2), found "
            f"{tuple(x1.shape)}, {tuple(x2.shape)} and {tuple(w.shape)}"
        )


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _no_graph_through_kernel(op: str, *ts: torch.Tensor) -> None:
    """Refuse a graph of the backward (``create_graph=True``, under which
    autograd runs ``backward`` with grad mode on) on CUDA tensors: the
    backward kernel's outputs carry no graph, so a second derivative through
    it would lose every term that passes through the kernel. The plain
    versions on the CPU stay differentiable; a caller that needs a second
    derivative on the card evaluates the circuit with ``plain=True``."""
    if torch.is_grad_enabled() and not _on_cpu(*ts):
        raise RuntimeError(
            f"{op}: the CUDA backward kernel is not differentiable; a second derivative "
            "(create_graph=True) needs the plain compositions (evaluate with plain=True)"
        )


def _check_cuda(
    op: str, ts: tuple[torch.Tensor, ...], dtypes: tuple[torch.dtype, ...] = (torch.float32,)
) -> torch.device:
    """The common device of a CUDA launch's operands, checked: one device,
    contiguous, each of a type in ``dtypes``."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: tensors on {dev}; the op runs on CPU or CUDA tensors")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{op}: operands on {dev} and {t.device}")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{op}: the CUDA kernel takes {names} operands, found {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: the CUDA kernel takes contiguous operands")
    return dev


def _check_single_pass(op: str, ts: tuple[torch.Tensor, ...]) -> tuple[torch.device, str]:
    """The device of a launch's real operands and the suffix of its entries:
    the real kernels (single-pass, wide and routing) are built for float32
    (no suffix) and float64 (``_f64``), and every operand has the type of
    the first."""
    double = ts[0].dtype == torch.float64
    dev = _check_cuda(op, ts, (torch.float64 if double else torch.float32,))
    return dev, "_f64" if double else ""


def _call(lib, entry: str, op: str, args) -> None:
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.cirkit_cuda_error_string(err).decode()
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {err} ({msg})")


def _sizes(ins: tuple[torch.Tensor, ...]) -> tuple[int, ...]:
    """(F, B, I, O) of the dense ops, (F, B, K1, K2, O) of the Tucker ones."""
    *xs, w = ins
    return (*xs[0].shape[:2], *(x.shape[2] for x in xs), w.shape[1])


def _launch_fwd(op: str, ins: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Check the operands, allocate the output and launch the forward entry
    of ``op`` on the current stream."""
    entry = _ENTRIES[op][0]
    dev, suffix = _check_single_pass(op, ins)
    sizes = _sizes(ins)
    f, b, o = sizes[0], sizes[1], sizes[-1]
    width = ins[-1].shape[2]  # the kernels index a weight row with an int
    if max(*sizes, width) >= 2**31 or -(-o // _BN) > _MAX_GRID_YZ or -(-b // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"{op}: sizes {sizes} exceed the kernel's launch grid")
    out = torch.empty((f, b, o), device=dev, dtype=ins[0].dtype)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*(t.data_ptr() for t in ins), out.data_ptr(), *sizes, dev.index, stream)
    _call(lib, entry + suffix, op, args)
    LAUNCHES[op] += 1
    return out


def _launch_bwd(
    op: str, ins: tuple[torch.Tensor, ...], out: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, ...],
) -> tuple[torch.Tensor | None, ...]:
    """Allocate the requested gradients and the scratch, and launch the
    backward entry of ``op`` on the current stream."""
    dev, suffix = _check_single_pass(f"{op} backward", (*ins, out, g))
    grads = tuple(torch.empty_like(t) if need else None for t, need in zip(ins, needs))
    if not any(needs):
        return grads
    if out.numel() == 0 or ins[0].numel() == 0:
        return tuple(None if d is None else d.zero_() for d in grads)
    sizes = _sizes(ins)
    f, b, o = sizes[0], sizes[1], sizes[-1]
    i = ins[-1].shape[2]
    tucker = op.startswith("lse_tucker2")
    if max(-(-b // _BWD_ROWS), -(-o // _BWD_ROWS), -(-i // _BWD_DX_COLS)) > _MAX_GRID_YZ:
        raise ValueError(f"{op} backward: sizes {sizes} exceed the kernel's launch grid")
    lib = _build.library()
    softmax = op.endswith("softmax")
    # scratch: the row shifts and gy; in float64 gy's buffer also holds the
    # partial sums of a Tucker dx split over K1 (lse_bwd_gy_size), and for
    # softmax the (F, O, I) weights follow; in float32 what the tensor-core
    # path asks for (the softmax statistics, the Tucker dx partials)
    k1, k2 = sizes[2:4] if tucker else (i, 1)
    scratch = [torch.empty((f, b), device=dev, dtype=ins[0].dtype)
               for _ in range(2 if tucker else 1)]
    if suffix:
        n = lib.lse_bwd_gy_size_f64(0, int(tucker), f, b, k1, k2, o)
        scratch.append(torch.empty(n, device=dev, dtype=ins[0].dtype))
        if softmax:
            scratch.append(torch.empty_like(ins[-1]))
    else:
        scratch.append(torch.empty((f, b, o), device=dev, dtype=ins[0].dtype))
        n = lib.lse_bwd_scratch(int(tucker), int(softmax), f, b, k1, k2, o)
        if n:
            scratch.append(torch.empty(n, device=dev, dtype=torch.float32))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        *(t.data_ptr() for t in (*ins, out, g)),
        *(None if d is None else d.data_ptr() for d in grads),
        *(t.data_ptr() for t in scratch),
        *sizes,
        dev.index,
        stream,
    )
    _call(lib, _ENTRIES[op][1] + suffix, f"{op} backward", args)
    LAUNCHES[f"{op}_bwd"] += 1
    return grads


def _launch_blocked_fwd(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the blocked dense forward: the output and the (F, B, 1) row max."""
    op = "lse_matmul_blocked"
    dev, suffix = _check_single_pass(op, (x, w))
    f, b, i = x.shape
    o = w.shape[1]
    # one block per (fold, batch tile, unit tile), counted in one grid axis
    tile_b, tile_o = _BLOCKED_TILES[suffix]
    if max(f, b, i, o) >= 2**31 or f * -(-b // tile_b) * -(-o // tile_o) >= 2**31:
        raise ValueError(f"{op}: sizes {(f, b, i, o)} exceed the kernel's launch grid")
    out = torch.empty((f, b, o), device=dev, dtype=x.dtype)
    m = torch.empty((f, b, 1), device=dev, dtype=x.dtype)
    if out.numel() == 0:
        return out, m
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), m.data_ptr(), f, b, i, o, dev.index,
            stream)
    _call(_build.library(), "lse_fwd_blocked" + suffix, op, args)
    LAUNCHES[op] += 1
    return out, m


def _blocked_gy_shape(f: int, b: int, o: int, suffix: str) -> tuple[int, ...]:
    """The shape of the blocked backward's gy scratch: (F, B, O), or for the
    float32 kernel, which keeps a plane of TF32 high parts and one of low
    parts, room for 2 F B O floats."""
    return (f, b, o) if suffix else (f, b, o, 2)


def _launch_blocked_bwd(
    x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, bool],
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Allocate the requested gradients and the gy scratch, and launch the
    blocked dense backward."""
    op = "lse_matmul_blocked"
    dev, suffix = _check_single_pass(f"{op} backward", (x, w, out, m, g))
    dx, dw = (torch.empty_like(t) if need else None for t, need in zip((x, w), needs))
    if not any(needs):
        return dx, dw
    if out.numel() == 0 or x.numel() == 0:
        return tuple(None if d is None else d.zero_() for d in (dx, dw))
    f, b, i = x.shape
    o = w.shape[1]
    # gy: one block per (fold, 8 rows); the rest: one per (fold, 64 columns)
    if (max(f, b, i, o) >= 2**31 or -(-b // _BWD_ROWS) > _MAX_GRID_YZ
            or f * -(-i // _BWD_DX_COLS) >= 2**31):
        raise ValueError(f"{op} backward: sizes {(f, b, i, o)} exceed the kernel's launch grid")
    gy = torch.empty(_blocked_gy_shape(f, b, o, suffix), device=dev, dtype=x.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        *(t.data_ptr() for t in (x, w, out, m, g)),
        *(None if d is None else d.data_ptr() for d in (dx, dw)),
        gy.data_ptr(), f, b, i, o, dev.index, stream,
    )
    _call(_build.library(), "lse_bwd_blocked" + suffix, f"{op} backward", args)
    LAUNCHES[f"{op}_bwd"] += 1
    return dx, dw


# op -> (forward entry, backward entry, forward plain version, backward plain
# version); the K1-chunked Tucker forwards share their op's backward
_ENTRIES = {
    "lse_matmul": ("lse_fwd_dense", "lse_bwd_dense", lse_matmul_ref, lse_matmul_bwd_ref),
    "lse_matmul_softmax": ("lse_fwd_dense_softmax", "lse_bwd_dense_softmax",
                           lse_matmul_softmax_ref, lse_matmul_softmax_bwd_ref),
    "lse_tucker2": ("lse_fwd_tucker", "lse_bwd_tucker", lse_tucker2_ref, lse_tucker2_bwd_ref),
    "lse_tucker2_softmax": ("lse_fwd_tucker_softmax", "lse_bwd_tucker_softmax",
                            lse_tucker2_softmax_ref, lse_tucker2_softmax_bwd_ref),
    "lse_tucker2_chunked": ("lse_fwd_ct", None, lse_tucker2_ref, None),
    "lse_tucker2_softmax_chunked": ("lse_fwd_ct_softmax", None, lse_tucker2_softmax_ref, None),
}


def _forward(ctx, op: str, *ins: torch.Tensor) -> torch.Tensor:
    out = _ENTRIES[op][2](*ins) if _on_cpu(*ins) else _launch_fwd(op, ins)
    ctx.save_for_backward(*ins, out)
    return out


def backward(
    op: str,
    ins: tuple[torch.Tensor, ...],
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, ...] | None = None,
) -> tuple[torch.Tensor | None, ...]:
    """The gradients of ``op`` (one of :data:`OPS`) with respect to its
    arguments ``ins``, given its output ``out`` and the cotangent ``g``;
    ``needs`` (default: all) selects which. The plain version on CPU
    tensors, the backward kernel on CUDA tensors."""
    needs = (True,) * len(ins) if needs is None else tuple(needs)
    if _on_cpu(*ins, out, g):
        return _ENTRIES[op][3](*ins, out, g, needs)
    return _launch_bwd(op, tuple(ins), out, g, needs)


def _backward(ctx, op: str, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
    *ins, out = ctx.saved_tensors
    _no_graph_through_kernel(op, *ins)
    return backward(op, tuple(ins), out, g.contiguous(), ctx.needs_input_grad)


# --------------------------------------------------------------------------- #
# The differentiable ops
# --------------------------------------------------------------------------- #


class LseMatmul(torch.autograd.Function):
    """:func:`lse_matmul` with its backward kernel."""

    @staticmethod
    def forward(ctx, x, w):
        return _forward(ctx, "lse_matmul", x, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_matmul", g)


class LseMatmulSoftmax(torch.autograd.Function):
    """:func:`lse_matmul_softmax`; the backward returns the logits' gradient."""

    @staticmethod
    def forward(ctx, x, theta):
        return _forward(ctx, "lse_matmul_softmax", x, theta)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_matmul_softmax", g)


class LseTucker2(torch.autograd.Function):
    """:func:`lse_tucker2` with its backward kernel."""

    @staticmethod
    def forward(ctx, x1, x2, w):
        return _forward(ctx, "lse_tucker2", x1, x2, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_tucker2", g)


class LseTucker2Softmax(torch.autograd.Function):
    """:func:`lse_tucker2_softmax`; the backward returns the logits' gradient."""

    @staticmethod
    def forward(ctx, x1, x2, theta):
        return _forward(ctx, "lse_tucker2_softmax", x1, x2, theta)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_tucker2_softmax", g)


class LseTucker2Chunked(torch.autograd.Function):
    """The wide :func:`lse_tucker2`: the K1-chunked forward kernel, the
    backward kernel of :class:`LseTucker2` (the same gradient as the JAX
    package's ``_ct_p_bwd``)."""

    @staticmethod
    def forward(ctx, x1, x2, w):
        return _forward(ctx, "lse_tucker2_chunked", x1, x2, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_tucker2", g)


class LseTucker2SoftmaxChunked(torch.autograd.Function):
    """The wide :func:`lse_tucker2_softmax`: the K1-chunked forward kernel
    with its online softmax, the backward kernel of :class:`LseTucker2Softmax`."""

    @staticmethod
    def forward(ctx, x1, x2, theta):
        return _forward(ctx, "lse_tucker2_softmax_chunked", x1, x2, theta)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_tucker2_softmax", g)


class LseMatmulBlocked(torch.autograd.Function):
    """The wide :func:`lse_matmul`: the blocked forward saves the row max it
    returns for the blocked backward."""

    @staticmethod
    def forward(ctx, x, w):
        out, m = lse_matmul_blocked_ref(x, w) if _on_cpu(x, w) else _launch_blocked_fwd(x, w)
        ctx.save_for_backward(x, w, out, m)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out, m = ctx.saved_tensors
        _no_graph_through_kernel("lse_matmul_blocked", x, w)
        g = g.contiguous()
        needs = tuple(ctx.needs_input_grad)
        if _on_cpu(x, w, out, m, g):
            return lse_matmul_blocked_bwd_ref(x, w, out, m, g, needs)
        return _launch_blocked_bwd(x, w, out, m, g, needs)


def _wide(width: int) -> bool:
    return width >= WIDE_WIDTH


def lse_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused ``log(exp(x - max) @ w^T) + max`` over the trailing axis.

    ``x``: (F, B, I) log-space values; ``w``: (F, O, I) linear-space weights.
    Returns (F, B, O) log-space values."""
    _check_dense(x, w)
    if _wide(x.shape[2]):
        return LseMatmulBlocked.apply(x, w)
    return LseMatmul.apply(x, w)


def lse_matmul_softmax(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """:func:`lse_matmul` with ``w = softmax(theta, axis=-1)`` fused into the
    kernel: the normalized weights are never stored. At wide I the weights
    are normalized first and go through the blocked kernels."""
    _check_dense(x, theta)
    if _wide(x.shape[2]):
        return lse_matmul(x, torch.softmax(theta, dim=-1))
    return LseMatmulSoftmax.apply(x, theta)


def lse_tucker2(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused arity-2 Tucker contraction under the lse-sum semiring.

    ``x1``: (F, B, K1) and ``x2``: (F, B, K2) log-space inputs; ``w``:
    (F, O, K1*K2) linear-space core weight, flattened row-major over (K1, K2).
    Returns (F, B, O) log-space values."""
    _check_tucker(x1, x2, w)
    if _wide(w.shape[2]):
        return LseTucker2Chunked.apply(x1, x2, w)
    return LseTucker2.apply(x1, x2, w)


def lse_tucker2_softmax(
    x1: torch.Tensor, x2: torch.Tensor, theta: torch.Tensor
) -> torch.Tensor:
    """:func:`lse_tucker2` with ``w = softmax(theta, axis=-1)`` fused into
    the kernel (see :func:`lse_matmul_softmax`)."""
    _check_tucker(x1, x2, theta)
    if _wide(theta.shape[2]):
        return LseTucker2SoftmaxChunked.apply(x1, x2, theta)
    return LseTucker2Softmax.apply(x1, x2, theta)
