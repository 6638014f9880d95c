"""Max-product and routing ops of the arity-2 Tucker layer, for MAP and
sampling.

The counterparts of ``tropical_tucker2`` and ``route_tucker2`` in
``cirkit_tpu/ops/lse_einsum.py:1231-1406``:

- :func:`tropical_tucker2`: MAP's upward (max, +) contraction
  ``out[f,b,o] = max_m lw[f,o,m] + x1[f,b,m//K2] + x2[f,b,m%K2]``, with
  ``lw = log_softmax(th)`` over m (``log_weights``) or ``log(th)``.
- :func:`route_tucker2`: the downward choice of one composite index ``m``
  per (fold, row) at the selected output unit ``sel[f,b]``, as an argmax
  (``"max"``) or a Gumbel-max draw (``"sample"``) over the scores
  ``lw[f,sel,m] + x1[f,b,m//K2] + x2[f,b,m%K2]``. With ``log_weights`` the
  raw logits serve as ``lw``: a row constant cannot change the choice.

On CUDA tensors each launches its hand-written kernel in
``csrc/tucker_route.cu``; on CPU tensors it runs its plain PyTorch version
(``*_ref``). ``LAUNCHES`` (shared with :mod:`.lse_einsum`) counts the
launches under the op's name.
"""

from __future__ import annotations

import torch

from cirkit_tpu_torch.ops import _build
from cirkit_tpu_torch.ops.lse_einsum import (
    _MAX_GRID_YZ,
    LAUNCHES,
    _call,
    _check_single_pass,
    _check_tucker,
    _on_cpu,
)

ROUTING_OPS = ("tropical_tucker2", "route_tucker2")
LAUNCHES.update({op: 0 for op in ROUTING_OPS})
KINDS = ("max", "sample")

_BN, _BM = 64, 128  # the tropical kernel's output-unit and batch-row tiles
# elements of the (F, B, O-chunk, M) broadcast the plain max-plus version
# forms at once: 1 GiB in f32
_CHUNK = 2**28


def tucker_comb(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The log-space Kronecker composite ``x1[..., i] + x2[..., j]`` of a
    Tucker entry, (F, B, K1*K2), row-major over (i, j)."""
    f, b, k1 = x1.shape
    return (x1[..., :, None] + x2[..., None, :]).reshape(f, b, k1 * x2.shape[2])


def max_plus(lw: torch.Tensor, comb: torch.Tensor) -> torch.Tensor:
    """``out[f,b,o] = max_m lw[f,o,m] + comb[f,b,m]``, (F, B, O), in chunks of
    output units so the (F, B, O, M) broadcast is never formed whole (105 GB
    in f32 at the Tucker flagship)."""
    f, b, m = comb.shape
    o = lw.shape[1]
    step = max(1, _CHUNK // max(1, f * b * m))
    out = comb.new_empty((f, b, o))
    for o0 in range(0, o, step):
        blk = lw[:, None, o0 : o0 + step, :] + comb[:, :, None, :]
        out[:, :, o0 : o0 + step] = blk.amax(dim=-1)
    return out


def tropical_tucker2_ref(
    x1: torch.Tensor, x2: torch.Tensor, th: torch.Tensor, *, log_weights: bool
) -> torch.Tensor:
    """The plain version of :func:`tropical_tucker2`."""
    lw = torch.log_softmax(th, dim=-1) if log_weights else torch.log(th)
    return max_plus(lw, tucker_comb(x1, x2))


def gumbel_argmax(scores: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A categorical draw over the last axis of the log-space ``scores`` by
    the Gumbel-max trick, with the kernel's uniforms ``k 2^-23 + 2^-24`` in
    [2^-24, 1): the noise is finite, so a -inf score never wins."""
    k = torch.randint(0, 2**23, scores.shape, generator=generator, device=scores.device)
    u = k.to(scores.dtype) * 2.0**-23 + 2.0**-24
    return (scores - torch.log(-torch.log(u))).argmax(dim=-1)


def route_scores(
    x1: torch.Tensor, x2: torch.Tensor, th: torch.Tensor, sel: torch.Tensor, *,
    log_weights: bool,
) -> torch.Tensor:
    """The (F, B, M) routing scores at the selected units (``sel`` clamped
    to the unit range), without noise."""
    o, m = th.shape[1:]
    idx = sel.long().clamp(0, o - 1)[:, :, None].expand(-1, -1, m)
    selw = torch.gather(th, 1, idx)
    return tucker_comb(x1, x2) + (selw if log_weights else torch.log(selw))


def route_tucker2_ref(
    x1: torch.Tensor,
    x2: torch.Tensor,
    th: torch.Tensor,
    sel: torch.Tensor,
    *,
    kind: str,
    log_weights: bool,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The plain version of :func:`route_tucker2`; the ``"sample"`` kind
    draws its Gumbel noise from ``generator``."""
    scores = route_scores(x1, x2, th, sel, log_weights=log_weights)
    return gumbel_argmax(scores, generator) if kind == "sample" else scores.argmax(dim=-1)


def _check(op: str, x1, x2, th, sel=None, kind="max") -> None:
    _check_tucker(x1, x2, th)
    if sel is not None:
        if sel.shape != x1.shape[:2] or sel.dtype.is_floating_point or sel.dtype.is_complex:
            raise ValueError(f"{op}: sel must be an integer (F, B) = {tuple(x1.shape[:2])} "
                             f"tensor, found {sel.dtype} {tuple(sel.shape)}")
    if kind not in KINDS:
        raise ValueError(f"{op}: kind must be one of {KINDS}, found {kind!r}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def tropical_tucker2(
    x1: torch.Tensor, x2: torch.Tensor, th: torch.Tensor, *, log_weights: bool
) -> torch.Tensor:
    """Max-product Tucker-2: (F, B, K1) x (F, B, K2) x (F, O, K1*K2) ->
    (F, B, O). ``th`` holds raw logits when ``log_weights`` (rows are
    log-softmax-normalized in the kernel) or linear nonnegative weights."""
    op = "tropical_tucker2"
    _check(op, x1, x2, th)
    if _on_cpu(x1, x2, th):
        return tropical_tucker2_ref(x1, x2, th, log_weights=log_weights)
    dev, suffix = _check_single_pass(op, (x1, x2, th))
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    o = th.shape[1]
    if max(f, b, k1 * k2, o) >= 2**31 or -(-o // _BN) > _MAX_GRID_YZ or \
            -(-b // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"{op}: sizes {(f, b, k1, k2, o)} exceed the kernel's launch grid")
    out = torch.empty((f, b, o), device=dev, dtype=x1.dtype)
    if out.numel() == 0:
        return out
    args = (x1.data_ptr(), x2.data_ptr(), th.data_ptr(), out.data_ptr(), f, b, k1, k2, o,
            int(log_weights), dev.index, _stream(dev))
    _call(_build.library(), "tropical_tucker" + suffix, op, args)
    LAUNCHES[op] += 1
    return out


def route_tucker2(
    x1: torch.Tensor,
    x2: torch.Tensor,
    th: torch.Tensor,
    sel: torch.Tensor,
    *,
    kind: str,
    log_weights: bool,
    seed: int | None = None,
) -> torch.Tensor:
    """The routing choice at the selected output unit of a Tucker-2 sum.

    ``x1``/``x2``: (F, B, K1)/(F, B, K2) log-space child values; ``th``:
    (F, O, K1*K2) raw logits (``log_weights``) or linear nonnegative
    weights; ``sel``: (F, B) int64 selected unit, clamped to [0, O-1] (the
    caller masks rows whose selection is negative). ``kind="sample"`` draws
    with Gumbel noise keyed by the integer ``seed`` and the (fold, row): one
    seed reproduces the same draws. Returns the (F, B) int64 composite
    index; on a tie the lower index wins."""
    op = "route_tucker2"
    _check(op, x1, x2, th, sel, kind)
    sample = kind == "sample"
    if sample and seed is None:
        raise ValueError(f"{op}: the sample kind needs a seed")
    if _on_cpu(x1, x2, th, sel):
        gen = torch.Generator().manual_seed(int(seed)) if sample else None
        return route_tucker2_ref(x1, x2, th, sel, kind=kind, log_weights=log_weights,
                                 generator=gen)
    dev, suffix = _check_single_pass(op, (x1, x2, th))
    if sel.device != dev or sel.dtype != torch.int64 or not sel.is_contiguous():
        raise TypeError(f"{op}: the CUDA kernel takes a contiguous int64 sel on {dev}, found "
                        f"{sel.dtype} on {sel.device}")
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    o = th.shape[1]
    if f * b >= 2**31 or k1 * k2 >= 2**31 or o >= 2**31:
        raise ValueError(f"{op}: sizes {(f, b, k1, k2, o)} exceed the kernel's launch grid")
    out = torch.empty((f, b), device=dev, dtype=torch.int64)
    if out.numel() == 0:
        return out
    args = (x1.data_ptr(), x2.data_ptr(), th.data_ptr(), sel.data_ptr(), out.data_ptr(),
            f, b, k1, k2, o, int(log_weights), int(sample),
            int(seed) % 2**64 if sample else 0, dev.index, _stream(dev))
    _call(_build.library(), "route_tucker" + suffix, op, args)
    LAUNCHES[op] += 1
    return out
