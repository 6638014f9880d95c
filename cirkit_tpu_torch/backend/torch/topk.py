"""Exact k-best parses (top-k MPE) over compiled circuits.

The counterpart of ``cirkit_tpu/backend/jax/topk.py``: the k-best semiring
lifted onto the evaluation plan, behind ``MAPQuery(top_k=)``.

**Upward pass**: every unit carries the descending vector of its T best
parse scores, (F, B, K, T). Input layers contribute their T best states per
unit (``topk_modes``; an observed variable pins its one observed state);
product layers combine their children's lists by a top-T of the pairwise
sums; sum-style layers take the top T over the (composite index m, rank t)
candidates ``log w[o, m] + comb[m, t]``.

**Downward pass**: the lazy selected-unit discipline of the 1-best routing
(``queries._build_routing_run``), with one (unit, rank) pair per (fold,
sample, slot) and T slots per sample (slot s extracts the s-th best parse).
At each entry the relevant top-T is recomputed at the selected unit only,
and its indices split the rank into per-child (unit, rank) pairs.

The downward recomputation must reproduce the upward choice to the bit, so
every top-T here follows one tie rule, that of ``jax.lax.top_k`` and of a
stable descending sort: among equal scores the lower index comes first.
``torch.topk`` documents no tie rule, so :func:`_top` never lets it see a
tie: a float32 score and its index pack into one int64 key, distinct,
ordered by score and then by index, and the top T of the keys are the
first T of ``torch.sort(descending=True, stable=True)`` on the CPU and on
CUDA alike (other dtypes take that sort). No kernel runs on this path: the
candidate tensors are built and reduced by PyTorch ops, a fold chunk at a
time (``_CHUNK_ELEMS``), as the JAX package runs them on XLA.

Semantics: the T best latent parses of the selected root unit. On
deterministic circuits parses biject with assignments (exact top-T MPE);
otherwise parse scores lower-bound assignment probabilities and distinct
parses may repeat an assignment. Continuous input layers contribute only
their mode. A unit with fewer than T parses fills the tail with ``-inf``
scores and arbitrary states.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.layers import (
    TorchConstantInputLayer,
    TorchHadamardLayer,
    TorchInputLayer,
    TorchKroneckerLayer,
    TorchSumLayer,
)
from cirkit_tpu_torch.backend.torch.optimized import (
    TorchCPTLayer,
    TorchTensorDotLayer,
    TorchTuckerLayer,
)
from cirkit_tpu_torch.backend.torch.parameters import Store, TorchMatMulParameter
from cirkit_tpu_torch.backend.torch.queries import (
    _digits,
    _num_vars,
    _root_position,
    _scope_vars,
)
from cirkit_tpu_torch.backend.torch.utils import safelog

_SORT_WIDTH = 64
"""Rows of at most this many float32 candidates are sorted whole (their
keys are distinct, so any sort orders them alike); wider rows go through
``torch.topk``."""

_CHUNK_ELEMS = 1 << 27
"""Candidates reduced at once: a top-T runs over chunks of folds of at most
this many candidates (at least one fold), which bounds the candidate tensor
and the selection's buffers."""


def _parse_weight(param, st: Store) -> torch.Tensor:
    """Evaluate a sum-layer weight plan under PARSE semantics: a collapsed
    ``MatMul`` weight sums over the fused inner sum's latent units, but two
    parses that differ in that latent are distinct candidates, so MatMul
    nodes evaluate to the expanded column space ``w[o, j * M + m] = W2[o, j]
    W1[j, m]`` (latent digits major, the real input minor; nested collapses
    compose). Consumers tile their child lists over the latent digits and
    recover the real input as ``column % M``. Raises if a MatMul feeds any
    other kind of parameter node."""

    def expand_matmul(plan, node, ins):
        if not isinstance(node, TorchMatMulParameter):
            return None
        for user in plan.node_outputs(node):
            if not isinstance(user, TorchMatMulParameter):
                raise NotImplementedError(
                    "Top-k MPE through a fused weight graph where a MatMul feeds "
                    f"{type(user).__name__} is not supported"
                )
        w1, w2 = ins  # (F, J, C1) inner (maybe expanded), (F, O, C2) outer
        jdim = node.in_shapes[0][0]
        j_of_c2 = torch.arange(w2.shape[2], device=w2.device) % jdim  # outer minor digit -> row
        w1g = w1[:, j_of_c2, :]  # (F, C2, C1)
        return (w2[:, :, :, None] * w1g[:, None, :, :]).reshape(w2.shape[0], w2.shape[1], -1)

    return param(st, node_override=expand_matmul)


def _top(cand: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The first t of ``torch.sort(cand, dim=-1, descending=True,
    stable=True)``, values and indices. A float32 score's bits map to an
    int32 of the same order (negative scores flip all but the sign bit); as
    the high half of an int64 over the reversed index it makes a key that no
    other candidate shares, so ``torch.topk`` (rows wider than
    ``_SORT_WIDTH``) or an unstable sort picks and orders exactly what the
    stable sort would."""
    n = cand.shape[-1]
    if cand.dtype != torch.float32:
        vals, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
        return vals[..., :t].contiguous(), idx[..., :t].contiguous()
    bits = cand.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64) << 32
    key |= torch.arange(n - 1, -1, -1, device=cand.device)
    if n > _SORT_WIDTH:
        idx = torch.topk(key, t, dim=-1).indices
    else:
        idx = torch.sort(key, dim=-1, descending=True).indices[..., :t].contiguous()
    return torch.gather(cand, -1, idx), idx


def _chunked(fn: Callable, ins: tuple[torch.Tensor, ...], per_fold: int):
    """``fn(*ins)``, a tuple of tensors, over chunks of the folds that ``ins``
    share as their leading axis, at most ``_CHUNK_ELEMS // per_fold`` folds a
    chunk (``per_fold``: the elements of ``fn``'s largest intermediate a
    fold), concatenated."""
    f = ins[0].shape[0]
    step = max(1, _CHUNK_ELEMS // max(per_fold, 1))
    if step >= f:
        return fn(*ins)
    parts = [fn(*(a[f0 : f0 + step] for a in ins)) for f0 in range(0, f, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _mix_topk(w: torch.Tensor, lists: torch.Tensor, t: int):
    """Top-t over the candidates ``w[..., c] + lists[..., c, r]``, flattened
    c-major (index ``c * T + r``), where each ``lists[..., c, :]`` descends:
    (values (..., t), flat indices). A candidate (c, r) in the top t brings
    every (c, r' < r) with it (they score at least as much and come first on
    a tie), so the top t lie in the (at most) t columns whose first
    candidates ``w + lists[..., 0]`` rank highest: a top-t of C scores, then
    one of t*T candidates. ``w`` and ``lists[..., 0]`` broadcast."""
    tt = lists.shape[-1]
    s0 = w + lists[..., 0]
    _, cols = _top(s0, min(t, s0.shape[-1]))
    cols = cols.sort(dim=-1).values  # ascending, so the candidates keep index order
    ws = torch.gather(w.expand(s0.shape), -1, cols)
    ls = torch.gather(lists.expand(*s0.shape, tt), -2, cols[..., None].expand(*cols.shape, tt))
    vals, j = _top((ws[..., None] + ls).reshape(*cols.shape[:-1], -1), t)
    return vals, torch.gather(cols, -1, j // tt) * tt + j % tt


def _tile_latents(comb: torch.Tensor, num_cols: int) -> torch.Tensor:
    """Tile composite top-T lists (F, B, M, T) over a collapsed weight's
    latent digits: column ``j * M + m`` pairs with child composite ``m``."""
    m = comb.shape[2]
    return comb if num_cols == m else comb.repeat(1, 1, num_cols // m, 1)


def _pair_topk(a: torch.Tensor, b: torch.Tensor, t: int):
    """Top-t of the pairwise sums ``a[..., i] + b[..., j]`` over the last
    axes: (values (..., t), flat indices i * Tb + j)."""
    return _chunked(
        lambda a, b: _top((a[..., :, None] + b[..., None, :]).reshape(*a.shape[:-1], -1), t),
        (a, b), a[0].numel() * b.shape[-1],
    )


def _cross_topk(a: torch.Tensor, b: torch.Tensor, t: int):
    """Kronecker combine of per-unit lists: ``a`` (F, B, Ka, Ta) x ``b``
    (F, B, Kb, Tb) -> top-t lists over the Ka*Kb composite units, candidate
    (ta, tb) flattened rank-major within each row-major unit pair."""

    def top(a, b):
        f, bb, ka, ta = a.shape
        kb, tb = b.shape[2], b.shape[3]
        cand = a[:, :, :, None, :, None] + b[:, :, None, :, None, :]
        return _top(cand.reshape(f, bb, ka * kb, ta * tb), t)

    return _chunked(top, (a, b), a[0].numel() * b[0].numel() // a.shape[1])


def _take_units(x: torch.Tensor, units: torch.Tensor) -> torch.Tensor:
    """Per-unit top-T lists ``x`` (F, B, K, T) at the units (F, B, S) -> (F,
    B, S, T)."""
    return torch.gather(x, 2, units[..., None].expand(*units.shape, x.shape[3]))


def _pick(idx: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """``idx[..., ranks]`` per row: the index list entry at each rank."""
    return torch.gather(idx, -1, ranks[..., None])[..., 0]


def _rank_decompose(lists: list[torch.Tensor], ranks: torch.Tensor, t: int) -> list:
    """Decompose final ranks through the left-to-right pairwise merges of
    ``lists`` (each (F, B, S, T)): recompute each merge's top-t and walk its
    indices backwards. Returns per-list ranks [(F, B, S), ...]."""
    prefixes = [lists[0]]
    for li in lists[1:]:
        prefixes.append(_pair_topk(prefixes[-1], li, t)[0])
    out: list = [None] * len(lists)
    r = ranks
    for h in range(len(lists) - 1, 0, -1):
        _, idx = _pair_topk(prefixes[h - 1], lists[h], t)
        pick = _pick(idx, r)
        tb = lists[h].shape[-1]
        out[h] = pick % tb
        r = pick // tb
    out[0] = r
    return out


def build_topk_run(cc: TorchCircuit, topk: int, *, root_output: int = 0,
                   root_unit: int = 0) -> Callable:
    """The top-k MPE program ``(store, x, mask) -> (assignments (B, T, D),
    scores (B, T))``; see the module docstring."""
    num_vars = _num_vars(cc)
    entries = cc._entries
    sum_style = (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer, TorchTensorDotLayer)
    folds = [entry.layer.num_folds for entry in entries]
    root_entry, root_fold = _root_position(cc, root_output, root_unit)
    t = topk

    def run(st: Store, xx: torch.Tensor, mk: torch.Tensor):
        dev = xx.device
        bsz = xx.shape[0]

        # ---- upward: per-unit sorted top-T parse scores (F, B, K, T) --------
        vals: list[torch.Tensor] = []
        recs: list[tuple] = []
        for entry in entries:
            layer = entry.layer
            if isinstance(layer, TorchConstantInputLayer):
                raise NotImplementedError(
                    f"Top-k MPE is not supported for {type(layer).__name__}"
                )
            if isinstance(layer, TorchInputLayer):
                if layer.num_variables != 1:
                    raise NotImplementedError(
                        "Top-k MPE of multivariate input layers is not supported"
                    )
                xin = cc.entry_input(entry, xx, vals)  # (F, B, 1)
                obs_val = layer(st, xin)  # (F, B, K)
                fvals, fstates = layer.topk_modes(st, t)  # (F, K, T)
                dt = obs_val.dtype
                # observed: the one observed state is the only parse
                obs_l = torch.cat(
                    [obs_val[..., None],
                     torch.full((*obs_val.shape, t - 1), -torch.inf, dtype=dt, device=dev)],
                    dim=-1,
                )
                v = _scope_vars(layer, dev)
                mrow = mk[:, v].t()  # (F, B)
                free_l = fvals[:, None].to(dt).expand(-1, bsz, -1, -1)
                vals.append(torch.where(mrow[:, :, None, None], obs_l, free_l))
                recs.append(("input", xin[..., 0].to(dt), mrow, fstates, v))
                continue

            g = cc.entry_input(entry, xx, vals)  # (F, H, B, K, T)
            if isinstance(layer, sum_style):
                lw = safelog(_parse_weight(layer.weight, st))
                if isinstance(layer, TorchTensorDotLayer):
                    kj, kq = layer._num_contract_units, layer._num_batch_units
                    kk = layer.num_output_units // kq
                    f, _, b, _, _ = g.shape
                    vvt = g[:, 0].reshape(f, b, kj, kq, t).transpose(2, 3)  # (F, B, Kq, Kj, T)
                    tv, _ = _chunked(
                        lambda lw, vvt: _mix_topk(lw[:, None, :, None, :], vvt[:, :, None], t),
                        (lw, vvt), b * kk * kq * kj,
                    )  # (F, B, Kk, Kq, T)
                    vals.append(tv.transpose(2, 3).reshape(f, b, kq * kk, t))
                    recs.append(("tensordot", kj, kq, kk))
                    continue
                if isinstance(layer, TorchTuckerLayer):
                    comb = g[:, 0]
                    for hh in range(1, layer.arity):
                        comb, _ = _cross_topk(comb, g[:, hh], t)
                    rec = ("tucker", layer.arity, layer.num_input_units)
                elif isinstance(layer, TorchCPTLayer):
                    comb = g[:, 0]
                    for hh in range(1, layer.arity):
                        comb, _ = _pair_topk(comb, g[:, hh], t)
                    rec = ("cpt", layer.arity, layer.num_input_units)
                else:  # mixing sum over (H, K)
                    f, h, b, k, _ = g.shape
                    comb = g.transpose(1, 2).reshape(f, b, h * k, t)
                    rec = ("sum", layer.arity, layer.num_input_units)
                # top-T over (m, t) candidates per output unit (collapsed
                # weights widen m by their latent digits: tiled copies)
                combx = _tile_latents(comb, lw.shape[2])
                tv, _ = _chunked(lambda lw, cx: _mix_topk(lw[:, None], cx[:, :, None], t),
                                 (lw, combx), combx.shape[1] * lw[0].numel())
                vals.append(tv)
                recs.append(rec)
            elif isinstance(layer, TorchHadamardLayer):
                out = g[:, 0]
                for hh in range(1, layer.arity):
                    out, _ = _pair_topk(out, g[:, hh], t)
                vals.append(out)
                recs.append(("hadamard", layer.arity, layer.num_input_units))
            elif isinstance(layer, TorchKroneckerLayer):
                out = g[:, 0]
                for hh in range(1, layer.arity):
                    out, _ = _cross_topk(out, g[:, hh], t)
                vals.append(out)
                recs.append(("kronecker", layer.arity, layer.num_input_units))
            else:
                raise NotImplementedError(
                    f"Top-k MPE is not supported for {type(layer).__name__}"
                )
        root_vals = cc.output_stack(vals)  # (O, B, K, T)

        # ---- downward: (unit, rank) selection per (fold, sample, slot) ------
        selu = [torch.full((nf, bsz, t), -1, dtype=torch.int64, device=dev) for nf in folds]
        selr = [torch.full((nf, bsz, t), -1, dtype=torch.int64, device=dev) for nf in folds]
        selu[root_entry][root_fold] = root_unit
        selr[root_entry][root_fold] = torch.arange(t, device=dev)[None, :]

        def push(e: int, per_op: list[tuple[torch.Tensor, torch.Tensor]]) -> None:
            """Push per-operand (units, ranks), both (F, B, S) with -1 on
            inactive slots, through entry e's fold gather (a scatter-max)."""
            entry = entries[e]
            per_op = [(u, torch.where(u >= 0, r, -1)) for u, r in per_op]
            if entry.gather is None:
                i0 = entry.in_ids[0]
                selu[i0] = torch.maximum(selu[i0], per_op[0][0])
                selr[i0] = torch.maximum(selr[i0], per_op[0][1])
                return
            idx = getattr(cc, entry.gather)  # (F, H)
            total = sum(folds[i] for i in entry.in_ids)
            cu = torch.full((total, bsz, t), -1, dtype=torch.int64, device=dev)
            cr = torch.full((total, bsz, t), -1, dtype=torch.int64, device=dev)
            for h, (u, r) in enumerate(per_op):
                where = idx[:, h, None, None].expand(-1, bsz, t)
                cu.scatter_reduce_(0, where, u, reduce="amax")
                cr.scatter_reduce_(0, where, r, reduce="amax")
            off = 0
            for i in entry.in_ids:
                selu[i] = torch.maximum(selu[i], cu[off : off + folds[i]])
                selr[i] = torch.maximum(selr[i], cr[off : off + folds[i]])
                off += folds[i]

        for e in range(len(entries) - 1, -1, -1):
            rec = recs[e]
            if rec[0] == "input":
                continue
            u, r = selu[e], selr[e]  # (F, B, S)
            active = u >= 0
            safeu, safer = u.clamp_min(0), r.clamp_min(0)
            entry = entries[e]
            layer = entry.layer
            g = cc.entry_input(entry, xx, vals)  # (F, H, B, K, T)

            if rec[0] == "hadamard":
                lists = [_take_units(g[:, h], safeu) for h in range(layer.arity)]
                push(e, [(u, rk) for rk in _rank_decompose(lists, safer, t)])
                continue
            if rec[0] == "kronecker":
                _, h, k = rec
                units = _digits(safeu, active, h, k)
                lists = [_take_units(g[:, hh], units[hh].clamp_min(0)) for hh in range(h)]
                push(e, list(zip(units, _rank_decompose(lists, safer, t))))
                continue

            # sum-style: recompute the candidate top-T at the selected unit
            lw = safelog(_parse_weight(layer.weight, st))
            if rec[0] == "tensordot":
                _, kj, kq, kk = rec
                f, _, b, _, _ = g.shape
                vvt = g[:, 0].reshape(f, b, kj, kq, t).transpose(2, 3)  # (F, B, Kq, Kj, T)
                q, kout = safeu // kk, safeu % kk
                w_sel = torch.gather(
                    lw[:, None].expand(-1, b, -1, -1), 2,
                    kout[..., None].expand(-1, -1, -1, kj),
                )  # (F, B, S, Kj)
                vvq = torch.gather(
                    vvt, 2, q[..., None, None].expand(-1, -1, -1, kj, t)
                )  # (F, B, S, Kj, T)
                _, idx = _chunked(lambda ws, vq: _mix_topk(ws, vq, t), (w_sel, vvq),
                                  w_sel[0].numel())
                pick = _pick(idx, safer)
                j, tr = pick // t, pick % t
                push(e, [(torch.where(active, j * kq + q, -1), tr)])
                continue

            tag, h, k = rec
            # comb: the composite top-T lists, recomputed as on the way up
            # (the stable sort reproduces the indices)
            if tag == "tucker":
                comb = g[:, 0]
                for hh in range(1, h):
                    comb, _ = _cross_topk(comb, g[:, hh], t)
            elif tag == "cpt":
                comb = g[:, 0]
                for hh in range(1, h):
                    comb, _ = _pair_topk(comb, g[:, hh], t)
            else:  # sum
                f_, hh_, b_, k_, _ = g.shape
                comb = g.transpose(1, 2).reshape(f_, b_, hh_ * k_, t)
            w_sel = torch.gather(
                lw[:, None].expand(-1, bsz, -1, -1), 2,
                safeu[..., None].expand(-1, -1, -1, lw.shape[2]),
            )  # (F, B, S, C)
            combx = _tile_latents(comb, lw.shape[2])
            _, idx = _chunked(lambda ws, cx: _mix_topk(ws, cx[:, :, None], t), (w_sel, combx),
                              w_sel[0].numel())
            pick = _pick(idx, safer)
            m, tcomb = pick // t, pick % t
            m = m % comb.shape[2]  # drop a collapsed weight's latent digits

            if tag == "sum":
                op, unit = m // k, m % k
                push(e, [(torch.where(active & (op == hh), unit, -1),
                          torch.where(active & (op == hh), tcomb, -1)) for hh in range(h)])
                continue
            if tag == "cpt":
                units = [torch.where(active, m, -1)] * h
            else:  # tucker: the composite is row-major over the arity digits
                units = _digits(m, active, h, k)
            lists = [_take_units(g[:, hh], units[hh].clamp_min(0)) for hh in range(h)]
            push(e, list(zip(units, _rank_decompose(lists, tcomb.clamp_min(0), t))))

        # ---- assemble the T assignments ------------------------------------
        dtype = root_vals.dtype
        out_asg = torch.zeros((bsz, t, num_vars), dtype=dtype, device=dev)
        for e, rec in enumerate(recs):
            if rec[0] != "input":
                continue
            _, xi, mrow, fstates, v = rec
            u = selu[e]
            safeu, safer = u.clamp_min(0), selr[e].clamp_min(0)
            st1 = _take_units(fstates[:, None].to(dtype).expand(-1, bsz, -1, -1), safeu)
            free = _pick(st1, safer)  # (F, B, S)
            picked = torch.where(mrow[:, :, None], xi[:, :, None], free)
            wv = torch.where(u >= 0, picked, torch.zeros((), dtype=dtype, device=dev))
            out_asg.index_add_(2, v, wv.permute(1, 2, 0))
        out_asg = torch.where(mk[:, None, :], xx[:, None, :].to(dtype), out_asg)
        return out_asg, root_vals[root_output, :, root_unit, :]

    return run
