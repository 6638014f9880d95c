"""Max-product and routing ops of the arity-2 Tucker layer, for MAP and
sampling.

The counterparts of ``tropical_tucker2`` and ``route_tucker2`` in
``cirkit_tpu/ops/lse_einsum.py:1231-1406``:

- :func:`tropical_tucker2`: MAP's upward (max, +) contraction
  ``out[f,b,o] = max_m lw[f,o,m] + x1[f,b,m//K2] + x2[f,b,m%K2]``, with
  ``lw = log_softmax(th)`` over m (``log_weights``) or ``log(th)``. Where
  the fold, unit and batch tiles would leave SMs idle or unevenly loaded
  (:func:`_trop_splits`), the kernel splits m across blocks and a second
  pass takes the max of their partial maxima and merges their softmax
  normalizers (:func:`tropical_tucker2_split_ref` is that path's plain
  version).
- :func:`route_tucker2`: the downward choice of one composite index ``m``
  per (fold, row) at the selected output unit ``sel[f,b]`` over the scores
  ``lw[f,sel,m] + x1[f,b,m//K2] + x2[f,b,m%K2]``: an argmax (``"max"``) or
  a draw from ``softmax(scores)`` (``"sample"``). The kernel draws by the
  inverse CDF, one uniform per (fold, row) (:func:`inverse_cdf_draw` is its
  search rule), the plain version by Gumbel-max; with ``log_weights`` the
  raw logits serve as ``lw``: a row constant cannot change the choice.

On CUDA tensors each launches its hand-written kernels in
``csrc/tucker_route.cu``; on CPU tensors it runs its plain PyTorch version
(``*_ref``). ``LAUNCHES`` (shared with :mod:`.lse_einsum`) counts the
launches under the op's name, and those of the ``_w16`` instances, which
take a bf16 ``th`` beside float32 children (the serving store, as the JAX
kernels take one) and widen it exactly on chip, under the op's name with
``_w16``: their results equal the float32 instance's on the widened ``th``
to the bit. Beside float64 children a bf16 ``th`` is widened to float64
first; there is no fast mode. The plain versions widen a bf16 ``th`` to the
children's type.
"""

from __future__ import annotations

import torch

from cirkit_tpu_torch.ops import _build
from cirkit_tpu_torch.ops.lse_einsum import (
    _MAX_GRID_YZ,
    LAUNCHES,
    _call,
    _check_tucker,
    _check_weighted,
    _on_cpu,
    _weight_for,
)

ROUTING_OPS = ("tropical_tucker2", "route_tucker2")
LAUNCHES.update({name: 0 for op in ROUTING_OPS for name in (op, f"{op}_w16")})
KINDS = ("max", "sample")

_BN, _BM = 64, 128  # the tropical kernel's output-unit and batch-row tiles
# composite columns the tropical kernel stages a chunk, by type: a split
# covers whole chunks
_CHUNK_COLS = {torch.float32: 16, torch.float64: 8}
# the cost of a split of the tropical kernel's composite index, in the time
# an SM takes to reduce one chunk of a block (about 1.5 us on the H100;
# scripts/route_ab.py): the second pass's two launches, and the bytes of
# partial maxima moved in that time (at about 2.5 TB/s)
_SPLIT_FIXED, _SPLIT_BYTES = 4, 2**22
# the route kernel's warps a block; a row takes a team of 1, 2, 4 or 8
_ROUTE_WARPS = 8
# warps an SM should have in flight before a route row takes more than one
_ROUTE_FILL = 16
_MAX_SMEM = 232448  # shared memory a block may take (lse_common.cuh)
# elements of the (F, B, O-chunk, M) broadcast the plain max-plus version
# forms at once: 1 GiB in f32
_CHUNK = 2**28


def _normal_splits(splits: int, m: int, chunk: int) -> int:
    """The split count the kernel runs for ``splits`` ranges of whole
    chunks of ``m`` columns: ``ceil(m / chunk)`` chunks, ``per =
    ceil(chunks / splits)`` a range, so that no range is empty."""
    chunks = -(-m // chunk)
    per = -(-chunks // max(1, min(splits, chunks)))
    return -(-chunks // per)


def _trop_splits(f: int, b: int, o: int, m: int, sm_count: int, *, chunk: int = 16,
                 itemsize: int = 4) -> int:
    """The ranges the tropical kernel splits the composite index into.

    The grid has ``tiles = f ceil(o / 64) ceil(b / 128)`` blocks unsplit,
    each of ``chunks = ceil(m / chunk)`` chunks. One block keeps an SM's
    issue busy (a second one on it runs no faster), so the kernel's time
    goes as the chunks of the busiest SM, ``ceil(tiles S / sm_count)
    ceil(chunks / S)``; each split adds the second pass's launches
    (``_SPLIT_FIXED`` chunk-times) and its partial maxima, written and read
    again (``_SPLIT_BYTES`` bytes a chunk-time). S minimizes the sum, the
    fewest splits on a tie; past ``2 ceil(sm_count / tiles) + 2`` splits
    the busiest SM's chunks no longer fall."""
    tiles = f * -(-o // _BN) * -(-b // _BM)
    chunks = -(-m // chunk)
    best = None
    for s in range(1, min(chunks, 2 * -(-sm_count // tiles) + 2) + 1):
        per = -(-chunks // s)
        if s > 1 and per == -(-chunks // (s - 1)):
            continue  # the same ranges as s - 1, one of them empty
        cost = -(-tiles * s // sm_count) * per
        if s > 1:
            cost += _SPLIT_FIXED + 2 * s * f * b * o * itemsize / _SPLIT_BYTES
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


def _route_team(rows: int, m: int, stage: int, sm_count: int) -> int:
    """The warps (1, 2, 4 or 8) the route kernel gives a row of ``m``
    columns whose x1 and x2 take ``stage`` bytes of shared memory: doubled
    from 1 while ``rows`` would keep fewer than ``_ROUTE_FILL`` warps an SM
    busy and each lane would still take two groups of four columns or more,
    and while a block's rows would not fit its shared memory."""
    team = 1
    while team < _ROUTE_WARPS and (
        (rows * team < _ROUTE_FILL * sm_count and m >= 2 * 4 * 32 * 2 * team)
        or _ROUTE_WARPS // team * stage > _MAX_SMEM
    ):
        team *= 2
    return team


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
    th = th.to(x1.dtype)
    lw = torch.log_softmax(th, dim=-1) if log_weights else torch.log(th)
    return max_plus(lw, tucker_comb(x1, x2))


def _row_stats(th: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(max, sum of exp(th - max)) over the last axis; (-inf, 0) for a row
    that is all -inf."""
    mx = th.amax(dim=-1)
    shift = torch.where(torch.isneginf(mx), torch.zeros_like(mx), mx)
    return mx, torch.exp(th - shift[..., None]).sum(dim=-1)


def tropical_tucker2_split_ref(
    x1: torch.Tensor, x2: torch.Tensor, th: torch.Tensor, *, log_weights: bool, splits: int
) -> torch.Tensor:
    """The plain version of :func:`tropical_tucker2`'s split path: the
    max-plus of the raw logits (or log weights) over ``splits`` ranges of
    whole chunks of m, the ranges' maxima combined by max and, with logits,
    their (max, sum of exp) pairs by log-sum-exp into the normalizer that is
    subtracted after the max. With linear weights every term is the unsplit
    version's, so the result equals :func:`tropical_tucker2_ref` bit for
    bit."""
    th = th.to(x1.dtype)
    m = th.shape[2]
    chunk = _CHUNK_COLS.get(th.dtype, 16)
    chunks = -(-m // chunk)
    span = -(-chunks // _normal_splits(splits, m, chunk)) * chunk
    lw = th if log_weights else torch.log(th)
    comb = tucker_comb(x1, x2)
    out = torch.stack([max_plus(lw[..., a : a + span], comb[..., a : a + span])
                       for a in range(0, m, span)]).amax(dim=0)
    if not log_weights:
        return out
    mxs, sums = zip(*(_row_stats(th[..., a : a + span]) for a in range(0, m, span)))
    mx, sums = torch.stack(mxs), torch.stack(sums)  # (S, F, O)
    top = mx.amax(dim=0)
    shift = torch.where(torch.isneginf(top), torch.zeros_like(top), top)
    total = (sums * torch.exp(mx - shift)).sum(dim=0)
    lse = torch.where(total > 0, shift + torch.log(total), torch.zeros_like(total))
    return out - lse[:, None, :]


def gumbel_argmax(scores: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A categorical draw over the last axis of the log-space ``scores`` by
    the Gumbel-max trick, with the uniforms ``k 2^-23 + 2^-24`` in
    [2^-24, 1): the noise is finite, so a -inf score never wins."""
    k = torch.randint(0, 2**23, scores.shape, generator=generator, device=scores.device)
    u = k.to(scores.dtype) * 2.0**-23 + 2.0**-24
    return (scores - torch.log(-torch.log(u))).argmax(dim=-1)


def inverse_cdf_draw(scores: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A categorical draw over the last axis of the log-space ``scores``
    from the uniforms ``u`` in [0, 1) (one per row), by the route kernel's
    search rule, over the columns in the order given: with ``e = exp(scores
    - max)`` and ``S = sum(e)``, the first column with mass (``e > 0``)
    whose running sum reaches ``u S``; where rounding leaves ``u S`` past
    the running sums, the last column with mass; 0 where no column has mass.
    A -inf or NaN score has no mass. The kernel sums a row lane by lane and
    so visits its columns in another order; the law is ``softmax(scores)``
    either way."""
    s = torch.where(torch.isnan(scores), float("-inf"), scores)
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isneginf(mx), torch.zeros_like(mx), mx))
    cum = e.cumsum(dim=-1)
    mass = e > 0
    hit = mass & (cum >= u[..., None].to(s.dtype) * cum[..., -1:])
    n = s.shape[-1]
    first = hit.to(torch.int8).argmax(dim=-1)
    last = n - 1 - mass.flip(-1).to(torch.int8).argmax(dim=-1)
    zero = torch.zeros_like(first)
    return torch.where(hit.any(dim=-1), first, torch.where(mass.any(dim=-1), last, zero))


def route_scores(
    x1: torch.Tensor, x2: torch.Tensor, th: torch.Tensor, sel: torch.Tensor, *,
    log_weights: bool,
) -> torch.Tensor:
    """The (F, B, M) routing scores at the selected units (``sel`` clamped
    to the unit range), without noise."""
    o, m = th.shape[1:]
    idx = sel.long().clamp(0, o - 1)[:, :, None].expand(-1, -1, m)
    selw = torch.gather(th, 1, idx).to(x1.dtype)
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
    draws from the same law by Gumbel-max, its noise from ``generator``."""
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



_SM_COUNT: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    i = torch.cuda.current_device() if dev.index is None else dev.index
    if i not in _SM_COUNT:
        _SM_COUNT[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SM_COUNT[i]


def tropical_tucker2(
    x1: torch.Tensor, x2: torch.Tensor, th: torch.Tensor, *, log_weights: bool,
    splits: int | None = None,
) -> torch.Tensor:
    """Max-product Tucker-2: (F, B, K1) x (F, B, K2) x (F, O, K1*K2) ->
    (F, B, O). ``th`` holds raw logits when ``log_weights`` (rows are
    log-softmax-normalized in the kernel) or linear nonnegative weights.
    ``splits`` forces the number of ranges m is split into (rounded so that
    none is empty); by default :func:`_trop_splits` picks it for the card.
    On CPU tensors a given ``splits`` runs :func:`tropical_tucker2_split_ref`."""
    op = "tropical_tucker2"
    _check(op, x1, x2, th)
    th = _weight_for(x1, th)
    if splits is not None and splits < 1:
        raise ValueError(f"{op}: splits must be at least 1, found {splits}")
    if _on_cpu(x1, x2, th):
        if splits is None:
            return tropical_tucker2_ref(x1, x2, th, log_weights=log_weights)
        return tropical_tucker2_split_ref(x1, x2, th, log_weights=log_weights, splits=splits)
    dev, suffix, inst = _check_weighted(op, (x1, x2), th, "")  # no fast mode
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    o = th.shape[1]
    m = k1 * k2
    chunk = _CHUNK_COLS[x1.dtype]
    if splits is None:
        splits = _trop_splits(f, b, o, m, _sm_count(dev), chunk=chunk,
                              itemsize=x1.element_size())
    else:
        splits = _normal_splits(splits, m, chunk)
    if max(f * splits, f * b, o) >= 2**31 or m >= 2**31 - 2**16 \
            or -(-o // _BN) > _MAX_GRID_YZ or -(-b // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"{op}: sizes {(f, b, k1, k2, o)} exceed the kernel's launch grid")
    out = torch.empty((f, b, o), device=dev, dtype=x1.dtype)
    if out.numel() == 0:
        return out
    part = stats = None
    if splits > 1:
        part = torch.empty((splits, f, b, o), device=dev, dtype=x1.dtype)
        if log_weights:
            stats = torch.empty((2, splits, f, o), device=dev, dtype=x1.dtype)
    args = (x1.data_ptr(), x2.data_ptr(), th.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if stats is None else stats.data_ptr(), f, b, k1, k2, o, splits,
            int(log_weights), dev.index, _stream(dev))
    _call(_build.library(), "tropical_tucker" + suffix + inst, op, args)
    LAUNCHES[op + inst] += 1
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
    from ``softmax(scores)`` keyed by the integer ``seed``: one seed
    reproduces the same draws. The kernel draws by the inverse CDF with one
    uniform per (fold, row) from Philox keyed by the seed; on CPU tensors
    the plain version draws by Gumbel-max from a ``torch.Generator`` seeded
    with it. Returns the (F, B) int64 composite index; on a tie the max kind
    takes the lower index."""
    op = "route_tucker2"
    _check(op, x1, x2, th, sel, kind)
    th = _weight_for(x1, th)
    sample = kind == "sample"
    if sample and seed is None:
        raise ValueError(f"{op}: the sample kind needs a seed")
    if _on_cpu(x1, x2, th, sel):
        gen = torch.Generator().manual_seed(int(seed)) if sample else None
        return route_tucker2_ref(x1, x2, th, sel, kind=kind, log_weights=log_weights,
                                 generator=gen)
    dev, suffix, inst = _check_weighted(op, (x1, x2), th, "")  # no fast mode
    if sel.device != dev or sel.dtype != torch.int64 or not sel.is_contiguous():
        raise TypeError(f"{op}: the CUDA kernel takes a contiguous int64 sel on {dev}, found "
                        f"{sel.dtype} on {sel.device}")
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    o = th.shape[1]
    m = k1 * k2
    stage = (k1 + k2) * x1.element_size()
    team = _route_team(f * b, m, stage, _sm_count(dev))
    if f * b >= 2**31 or m >= 2**31 - 2**16 or o >= 2**31 \
            or _ROUTE_WARPS // team * stage > _MAX_SMEM:
        raise ValueError(f"{op}: sizes {(f, b, k1, k2, o)} exceed the kernel's launch grid "
                         "or shared memory")
    out = torch.empty((f, b), device=dev, dtype=torch.int64)
    if out.numel() == 0:
        return out
    args = (x1.data_ptr(), x2.data_ptr(), th.data_ptr(), sel.data_ptr(), out.data_ptr(),
            f, b, k1, k2, o, int(log_weights), int(sample),
            int(seed) % 2**64 if sample else 0, team, dev.index, _stream(dev))
    _call(_build.library(), "route_tucker" + suffix + inst, op, args)
    LAUNCHES[op + inst] += 1
    return out
