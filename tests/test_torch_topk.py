"""The port's top-k MPE (``MAPQuery(top_k=)``,
``cirkit_tpu_torch.backend.torch.topk``) against the JAX package's
(``cirkit_tpu.backend.jax.topk``), on the CPU in float64.

The scores are held to JAX everywhere (rtol 1e-9, ``-inf`` tails alike).
The assignments are held where a slot's score is finite and apart from its
neighbours' by more than 1e-9: two parses of equal score may come in either
order only if the two packages' scores differ in the last bits, and there
the order is not a property of either. The circuits are those of
``tests/backend/test_topk.py``: the deep categorical circuit (folded and
not, optimized and not, with evidence), the two-variable Kronecker mixture
(a Tucker layer once optimized), two heads, the Gaussian mixture, a
product circuit whose sums the optimizer shatters into TensorDot pairs, a
collapsed sum chain (MatMul weights), a 4x4 ``image_data`` with ``cp`` and
``tucker``, and a circuit with fewer parses than slots. Top-1 equals the
port's ``MAPQuery``; the errors are the JAX package's.
"""

import numpy as np
import pytest
import torch

import cirkit_tpu.symbolic.functional as JSF
import cirkit_tpu_torch.symbolic.functional as TSF
from cirkit_tpu.backend.jax import queries as JQ
from cirkit_tpu_torch.backend.torch import MAPQuery
from cirkit_tpu_torch.backend.torch.optimized import TorchTensorDotLayer
from cirkit_tpu_torch.backend.torch.parameters import TorchMatMulParameter
from tests.test_torch_expectation import (
    JAX,
    assert_close,
    compile_both,
    const,
    deep_pc,
    gmm,
    image,
)


def kron_mixture(S, Sc, rng):
    """Two categorical variables under a Kronecker product and a sum."""
    leaves = []
    for v in range(2):
        raw = rng.uniform(0.1, 1.0, (2, 3))
        leaves.append(S.CategoricalLayer(Sc([v]), 2, num_categories=3,
                                         probs=const(S, raw / raw.sum(1, keepdims=True))))
    prod = S.KroneckerLayer(2, arity=2)
    root = S.SumLayer(4, 1, weight=const(S, rng.dirichlet(np.ones(4))[None]))
    return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def two_heads(S, Sc, rng):
    leaves = [S.CategoricalLayer(Sc([v]), 3, num_categories=3,
                                 probs=const(S, rng.dirichlet(np.ones(3), size=3)))
              for v in range(3)]
    prod = S.HadamardLayer(3, arity=3)
    root = S.SumLayer(3, 2, weight=const(S, rng.dirichlet(np.ones(3), size=2)))
    return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def collapsed_chain(S, Sc, rng):
    """A sum over a sum: the optimizer collapses them into one sum with a
    MatMul(W1, W2) weight."""
    k = 3
    leaves = [S.CategoricalLayer(Sc([v]), k, num_categories=4,
                                 probs=const(S, rng.dirichlet(np.ones(4), size=k)))
              for v in range(2)]
    prod = S.HadamardLayer(k, arity=2)
    mid = S.SumLayer(k, k, weight=const(S, rng.dirichlet(np.ones(k), size=k)))
    root = S.SumLayer(k, 1, weight=const(S, rng.dirichlet(np.ones(k), size=1)))
    return S.Circuit(leaves + [prod, mid, root], {prod: leaves, mid: [prod], root: [mid]},
                     [root])


def tensordot_product(S, Sc, rng):
    """The product of two deep circuits: with ``optimize=True`` its sums
    shatter into TensorDot pairs."""
    F = JSF if S is JAX[0] else TSF
    build = deep_pc(4, 3, 2)
    return F.multiply(build(S, Sc, np.random.default_rng(78)),
                      build(S, Sc, np.random.default_rng(79)))


def few_parses(S, Sc, rng):
    """One binary variable, one unit: two parses for five slots."""
    leaf = S.CategoricalLayer(Sc([0]), 1, num_categories=2, probs=const(S, [[0.3, 0.7]]))
    root = S.SumLayer(1, 1, weight=const(S, [[1.0]]))
    return S.Circuit([leaf, root], {root: [leaf]}, [root])


def _check(got, want):
    """Scores equal to rtol 1e-9; assignments equal where the score is
    finite and set apart from its neighbours by more than 1e-9."""
    (asg, scores), (jasg, jscores) = got, want
    jscores, jasg = np.asarray(jscores), np.asarray(jasg)
    assert scores.shape == jscores.shape and asg.shape == jasg.shape
    s = scores.numpy()
    assert (np.isneginf(s) == np.isneginf(jscores)).all()
    fin = np.isfinite(jscores)
    assert_close(s[fin], jscores[fin])
    gap = np.full(s.shape, np.inf)
    with np.errstate(invalid="ignore"):  # -inf - -inf in the padded tails
        assert (np.diff(s, axis=1)[np.isfinite(s[:, 1:])] <= 1e-12).all()  # descending
        d = np.abs(np.diff(jscores, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    sel = fin & (gap > 1e-9)
    assert sel.any()
    np.testing.assert_array_equal(asg.numpy()[sel], jasg[sel])


# name -> (circuit, seed, compile flags, T, (x, evidence) or None)
CASES = {
    "deep": (deep_pc(4, 3, 2), 80, {}, 5, None),
    "deep-unfolded": (deep_pc(4, 3, 2), 80, {"fold": False}, 5, None),
    "deep-optimized": (deep_pc(4, 3, 2), 81, {"optimize": True}, 6, None),
    "deep-evidence": (deep_pc(4, 3, 3), 82, {}, 4,
                      (np.array([[2, 0, 1, 0], [0, 1, 0, 2], [1, 1, 1, 1]]),
                       np.array([[True, False, True, False], [False, True, False, False],
                                 [False] * 4]))),
    "kronecker": (kron_mixture, 83, {}, 4, None),
    "kronecker-tucker": (kron_mixture, 83, {"optimize": True}, 4, None),
    "gaussian": (gmm, 76, {}, 2, None),
    "tensordot": (tensordot_product, 0, {"optimize": True}, 6, None),
    "collapsed": (collapsed_chain, 84, {"optimize": True}, 5, None),
    "image-cp": (image("cp"), 5, {"optimize": True}, 3,
                 (np.random.default_rng(1).integers(0, 256, (3, 16)),
                  np.random.default_rng(2).random((3, 16)) < 0.5)),
    "image-tucker": (image("tucker"), 5, {"optimize": True}, 3,
                     (np.random.default_rng(3).integers(0, 256, (3, 16)),
                      np.random.default_rng(4).random((3, 16)) < 0.5)),
    "few-parses": (few_parses, 0, {}, 5, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_topk_matches_jax(name):
    build, seed, flags, t, ev = CASES[name]
    jcc, jstore, ctx, cc = compile_both(build, seed, **flags)
    if name == "tensordot":
        assert any(isinstance(l, TorchTensorDotLayer) for l in cc.layers)
    if name == "collapsed":
        assert any(isinstance(n, TorchMatMulParameter) for l in cc.layers
                   for p in l.params.values() for n in p.nodes)
    args, kw = ((), {}) if ev is None else ((ev[0],), {"evidence_mask": ev[1]})
    got = MAPQuery(cc)(*args, top_k=t, **kw)
    _check(got, JQ.MAPQuery(jcc)(*args, store=jstore, top_k=t, **kw))
    if name == "few-parses":
        assert torch.isneginf(got[1][0, 2:]).all()


def test_topk_per_head():
    jcc, jstore, ctx, cc = compile_both(two_heads, 75)
    for h in range(2):
        _check(MAPQuery(cc)(top_k=4, unit=h), JQ.MAPQuery(jcc)(store=jstore, top_k=4, unit=h))


@pytest.mark.parametrize("name", ["deep-evidence", "image-tucker", "kronecker-tucker"])
def test_top1_equals_map(name):
    build, seed, flags, _, ev = CASES[name]
    _, _, ctx, cc = compile_both(build, seed, **flags)
    args, kw = ((), {}) if ev is None else ((ev[0],), {"evidence_mask": ev[1]})
    asg, scores = MAPQuery(cc)(*args, top_k=1, **kw)
    masg, mval = MAPQuery(cc)(*args, **kw)
    assert_close(scores[:, 0], mval.numpy())
    assert torch.equal(asg[:, 0], masg)


def test_topk_errors():
    _, _, ctx, cc = compile_both(deep_pc(4, 3, 2), 77)
    q = MAPQuery(cc)
    x = np.zeros((1, 4), dtype=np.int64)
    mask = np.array([[True, False, False, False]])
    mg = np.array([[False, True, False, False]])
    with pytest.raises(NotImplementedError, match="marginalize_vars"):
        q(x, evidence_mask=mask, marginalize_vars=mg, top_k=2)
    with pytest.raises(ValueError, match="top_k"):
        q(top_k=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,t", [((7, 50), 4), ((3, 5, 16), 16), ((4, 9), 1),
                                     ((2, 3, 300), 7), ((5, 70), 3)])
def test_top_selection_is_the_stable_sort(shape, t, dtype):
    """``topk._top`` gives the first t of a stable descending sort to the bit
    (the lower index first among equal scores, ``jax.lax.top_k``'s rule) on
    scores with many ties, negative and positive, and rows of -inf: float32
    through its int64 keys (sorted, or ``torch.topk`` past ``_SORT_WIDTH``),
    float64 through the stable sort itself."""
    from cirkit_tpu_torch.backend.torch.topk import _top

    g = torch.Generator().manual_seed(sum(shape) + t)
    x = (torch.randint(0, 9, shape, generator=g) - 4).to(dtype) * 0.75
    x[0] = -torch.inf
    x[..., 1, :] = torch.where(torch.rand(x[..., 1, :].shape, generator=g) < 0.5, -torch.inf,
                               x[..., 1, :])
    vals, idx = _top(x, t)
    want_vals, want_idx = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(vals, want_vals[..., :t]) and torch.equal(idx, want_idx[..., :t])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c,t", [(40, 4), (3, 5), (12, 1), (7, 7)])
def test_mix_selection_is_the_stable_sort_of_all_candidates(c, t, dtype):
    """``topk._mix_topk`` (the top t columns by their first candidates, then
    their t*T candidates) gives what the stable sort of every candidate
    ``w[c] + lists[c, r]`` gives, to the bit, with ties, -inf weights and
    -inf list tails, and with fewer columns than slots."""
    from cirkit_tpu_torch.backend.torch.topk import _mix_topk

    g = torch.Generator().manual_seed(c * 10 + t)
    w = (torch.randint(0, 4, (3, 6, c), generator=g) * 0.5).to(dtype)
    w[0, 0] = -torch.inf
    w[1, :, ::2] = -torch.inf
    lists = torch.randint(0, 4, (3, 1, c, t), generator=g).to(dtype).sort(dim=-1,
                                                                          descending=True)[0]
    lists[2, :, 1:, 1:] = -torch.inf
    vals, idx = _mix_topk(w, lists, t)
    cand = (w[..., None] + lists).reshape(3, 6, c * t)
    want_vals, want_idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    assert torch.equal(vals, want_vals[..., :t]) and torch.equal(idx, want_idx[..., :t])
