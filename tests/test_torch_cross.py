"""The port's cross-circuit queries (``cirkit_tpu_torch.backend.torch.cross``)
against the JAX package's (``cirkit_tpu.backend.jax.cross``), on the CPU in
float64.

Every test of ``tests/backend/test_cross.py`` is mirrored: both packages
build the same circuits from one numpy seed, the JAX store is carried into
the port's context by slot name in float64, and the exact queries
(``expected_loglikelihood``, ``cross_circuit_kl``, ``is_deterministic``, on
the host path and with ``device=True``) are held to JAX's values at rtol
1e-9 (an absolute 1e-12 where the value is 0), with JAX's infinities and
error types. The Monte Carlo estimators cannot match ``jax.random``: a
self-KL is exactly ``(0.0, 0.0)``, the estimates fall within 4 standard
errors of the enumerated value, and the validation errors have JAX's types.
The readback neither adds a slot to the context's store nor changes one.
"""

import itertools

import numpy as np
import pytest
import torch

import cirkit_tpu.models.logic as JL
import cirkit_tpu_torch.models.logic as TL
from cirkit_tpu.backend.jax import cross as JC
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch import EntropyQuery
from cirkit_tpu_torch.backend.torch import cross as TC
from cirkit_tpu_torch.pipeline import PipelineContext
from tests.reference_eval import enumerate_worlds, eval_circuit
from tests.test_torch_expectation import JAX, PORT, const

NUM_STATES = 4
RTOL, ATOL = 1e-9, 1e-12


def _groups(k: int) -> list[list[int]]:
    """Disjoint state groups per unit: K=2 -> {0,1},{2,3}; K=3 -> {0},{1},{2,3}."""
    return [[0, 1], [2, 3]] if k == 2 else [[0], [1], [2, 3]]


def det_pc(k, *, product="hadamard", reverse_children=False, dead_leaf_unit=None,
           dense=False):
    """``tests/backend/test_cross.py::_det_pc``: 3 variables, K units per
    leaf on disjoint supports (``dense``: full-support rows, not
    deterministic), a Hadamard or Kronecker pair over (0, 1), an inner sum,
    a Hadamard with variable 2 and a single-unit sum root; ``dead_leaf_unit``
    zeroes a unit of variable 2's leaf (a support gap)."""

    def build(S, Sc, rng):
        def leaf(v, dead_unit=None):
            if dense:
                probs = rng.uniform(0.2, 1.0, size=(k, NUM_STATES))
                probs /= probs.sum(axis=1, keepdims=True)
            else:
                probs = np.zeros((k, NUM_STATES))
                for u, g in enumerate(_groups(k)):
                    probs[u, g] = rng.uniform(0.2, 1.0, size=len(g))
                    probs[u] /= probs[u].sum()
            if dead_unit is not None:
                probs[dead_unit] = 0.0
            return S.CategoricalLayer(Sc([v]), k, num_categories=NUM_STATES,
                                      probs=const(S, probs))

        l0, l1 = leaf(0), leaf(1)
        l2 = leaf(2, dead_unit=dead_leaf_unit)
        ins01 = [l1, l0] if reverse_children else [l0, l1]
        if product == "hadamard":
            prod01, kin = S.HadamardLayer(k, arity=2), k
        else:
            prod01, kin = S.KroneckerLayer(k, arity=2), k * k
        s01 = S.SumLayer(kin, k, weight=const(S, rng.uniform(0.1, 1.0, size=(k, kin))))
        prod2 = S.HadamardLayer(k, arity=2)
        root = S.SumLayer(k, 1, weight=const(S, rng.uniform(0.1, 1.0, size=(1, k))))
        return S.Circuit([l0, l1, l2, prod01, s01, prod2, root],
                         {prod01: ins01, s01: [prod01], prod2: [s01, l2], root: [prod2]},
                         [root])

    return build


def factorized_gaussian(means, sds):
    def build(S, Sc, rng):
        leaves = [S.GaussianLayer(Sc([v]), 1, mean=const(S, [means[v]]),
                                  stddev=const(S, [sds[v]])) for v in range(2)]
        prod = S.HadamardLayer(1, arity=2)
        root = S.SumLayer(1, 1, weight=const(S, [[1.0]]))
        return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])

    return build


def multivariate_pc(num_variables=3, k=3, c=2):
    """``tests/fixtures.py::build_multivariate_categorical_pc``."""

    def build(S, Sc, rng):
        layers, in_layers = [], {}

        def rec(lo, hi):
            if hi - lo == 1:
                raw = rng.uniform(0.1, 1.0, size=(k, c))
                sl = S.CategoricalLayer(Sc([lo]), k, num_categories=c,
                                        probs=const(S, raw / raw.sum(axis=1, keepdims=True)))
                layers.append(sl)
                return sl
            mid = (lo + hi) // 2
            left, right = rec(lo, mid), rec(mid, hi)
            prod = S.HadamardLayer(k, arity=2)
            layers.append(prod)
            in_layers[prod] = [left, right]
            ko = 1 if (lo, hi) == (0, num_variables) else k
            s = S.SumLayer(k, ko, weight=const(S, rng.uniform(0.1, 1.0, (ko, k))))
            layers.append(s)
            in_layers[s] = [prod]
            return s

        root = rec(0, num_variables)
        return S.Circuit(layers, in_layers, [root])

    return build


def gaussian_mixture(num_units=2):
    """``tests/fixtures.py::build_bivariate_gaussian_pc``."""

    def build(S, Sc, rng):
        leaves = []
        for v in range(2):
            mean = rng.normal(size=(num_units,))
            std = rng.uniform(0.5, 1.5, size=(num_units,))
            leaves.append(S.GaussianLayer(Sc([v]), num_units, mean=const(S, mean),
                                          stddev=const(S, std)))
        prod = S.HadamardLayer(num_units, arity=2)
        w = rng.uniform(0.1, 1.0, size=(1, num_units))
        out = S.SumLayer(num_units, 1, weight=const(S, w / w.sum()))
        return S.Circuit(leaves + [prod, out], {prod: leaves, out: [prod]}, [out])

    return build


def logic_pc(weights):
    """``(x0 and x1) or (not x0 and x2)`` with weighted literals: the
    weighted-model-count distribution of ``test_cross.py:238``."""

    def build(S, Sc, rng):
        L = JL if S is JAX[0] else TL

        def lit_factory(negated):
            def factory(scope, num_units):
                (var,) = tuple(scope)
                w = weights[var, 1 - int(negated)]
                with np.errstate(divide="ignore"):
                    logits = np.log(np.array([w, 0.0]) if negated else np.array([0.0, w]))
                return S.CategoricalLayer(scope, num_units, num_categories=2, logits=(
                    S.Parameter.from_input(S.TensorParameter(
                        1, 2, initializer=S.ConstantTensorInitializer(logits),
                        learnable=False))))

            return factory

        x0, x1, x2 = L.LiteralNode(0), L.LiteralNode(1), L.LiteralNode(2)
        nx0 = L.NegatedLiteralNode(0)
        c1, c2, root = L.ConjunctionNode(), L.ConjunctionNode(), L.DisjunctionNode()
        lc = L.LogicalCircuit([x0, x1, x2, nx0, c1, c2, root],
                              {c1: [x0, x1], c2: [nx0, x2], root: [c1, c2]}, [root])
        return lc.build_circuit(literal_input_factory=lit_factory(False),
                                negated_literal_input_factory=lit_factory(True))

    return build


def compile_both(*builds, seed=0, compile_all=True):
    """Each circuit of ``builds`` in both packages, drawn in order from one
    ``default_rng(seed)``, compiled through one context per package
    (lse-sum, folded), the JAX store carried into the port in float64.
    Returns ``(jctx, jaxs, jscs, ctx, ports, scs)``."""
    out = []
    for S in (JAX, PORT):
        rng = np.random.default_rng(seed)
        scs = [b(*S, rng) for b in builds]
        if S is JAX:
            ctx = JaxPipelineContext(semiring="lse-sum", fold=True)
        else:
            ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu", seed=0)
        ccs = [ctx.compile(sc) for sc in (scs if compile_all else scs[:1])]
        out.append((ctx, ccs, scs))
    (jctx, jccs, jscs), (ctx, ccs, scs) = out
    ctx.load_parameters({s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()})
    return jctx, jccs, jscs, ctx, ccs, scs


def _enum_ell_kl(sc_p, sc_q, num_vars=3, states=NUM_STATES):
    worlds = enumerate_worlds(num_vars, states)
    p = eval_circuit(sc_p, worlds)[:, 0, 0]
    q = eval_circuit(sc_q, worlds)[:, 0, 0]
    p, q = p / p.sum(), q / q.sum()
    nz = p > 0
    if (q[nz] <= 0).any():
        return -np.inf, np.inf
    return (float((p[nz] * np.log(q[nz])).sum()),
            float((p[nz] * (np.log(p[nz]) - np.log(q[nz]))).sum()))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _exact_both(jctx, jscs, ctx, scs, fn, **kw):
    """``fn`` of both packages on the (p, q) pair, compared."""
    want = getattr(JC, fn)(jscs[0], jscs[-1], ctx=jctx, **kw)
    got = getattr(TC, fn)(scs[0], scs[-1], ctx=ctx, **kw)
    _same(got, want)
    return got


# --------------------------------------------------------------------------- #
# The exact queries
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("product", ["hadamard", "kronecker"])
@pytest.mark.parametrize("reverse", [False, True])
def test_cross_ell_kl_different_structures_match_jax(product, reverse):
    """p with K=2 and q with K=3 units (the reverse case lists q's product
    children in the other order: the Kronecker digit permutation)."""
    jctx, _, jscs, ctx, _, scs = compile_both(
        det_pc(2, product=product), det_pc(3, product=product, reverse_children=reverse),
        seed=90)
    ell = _exact_both(jctx, jscs, ctx, scs, "expected_loglikelihood")
    kl = _exact_both(jctx, jscs, ctx, scs, "cross_circuit_kl")
    want_ell, want_kl = _enum_ell_kl(*jscs)
    assert ell.shape == kl.shape == (1, 1) and kl[0, 0] >= -1e-12
    np.testing.assert_allclose([ell[0, 0], kl[0, 0]], [want_ell, want_kl], rtol=1e-9, atol=1e-12)


def test_cross_kl_self_is_zero_and_ell_is_negative_entropy():
    jctx, _, jscs, ctx, ccs, scs = compile_both(det_pc(2), seed=91)
    kl = _exact_both(jctx, jscs, ctx, scs, "cross_circuit_kl")
    np.testing.assert_allclose(kl[0, 0], 0.0, atol=1e-9)
    ell = _exact_both(jctx, jscs, ctx, scs, "expected_loglikelihood")
    h = float(EntropyQuery(ccs[0])(store=ctx.parameters)[0, 0])
    np.testing.assert_allclose(ell[0, 0], -h, rtol=1e-9)


def test_cross_support_gap_gives_inf():
    jctx, _, jscs, ctx, _, scs = compile_both(det_pc(2), det_pc(2, dead_leaf_unit=1), seed=92)
    assert _exact_both(jctx, jscs, ctx, scs, "expected_loglikelihood")[0, 0] == -np.inf
    assert _exact_both(jctx, jscs, ctx, scs, "cross_circuit_kl")[0, 0] == np.inf


def test_cross_gaussian_closed_form():
    rng = np.random.default_rng(93)
    mp, sp = rng.normal(size=2), rng.uniform(0.5, 2.0, size=2)
    mq, sq = rng.normal(size=2), rng.uniform(0.5, 2.0, size=2)
    jctx, _, jscs, ctx, _, scs = compile_both(factorized_gaussian(mp, sp),
                                              factorized_gaussian(mq, sq))
    assert TC.is_deterministic(scs[0], ctx=ctx) and JC.is_deterministic(jscs[0], ctx=jctx)
    ell = _exact_both(jctx, jscs, ctx, scs, "expected_loglikelihood")
    want = sum(-0.5 * np.log(2 * np.pi * sq[v] ** 2)
               - (sp[v] ** 2 + (mp[v] - mq[v]) ** 2) / (2 * sq[v] ** 2) for v in range(2))
    np.testing.assert_allclose(ell[0, 0], want, rtol=1e-9)
    kl = _exact_both(jctx, jscs, ctx, scs, "cross_circuit_kl")
    want_kl = sum(np.log(sq[v] / sp[v]) + (sp[v] ** 2 + (mp[v] - mq[v]) ** 2)
                  / (2 * sq[v] ** 2) - 0.5 for v in range(2))
    np.testing.assert_allclose(kl[0, 0], want_kl, rtol=1e-9)


@pytest.mark.parametrize("case", ["det-kronecker", "det-hadamard", "dense", "gaussian"])
def test_is_deterministic_verifier(case):
    build = {"det-kronecker": det_pc(2, product="kronecker"), "det-hadamard": det_pc(3),
             "dense": multivariate_pc(), "gaussian": gaussian_mixture(2)}[case]
    jctx, _, jscs, ctx, _, scs = compile_both(build, seed=94)
    ok, report = TC.is_deterministic(scs[0], ctx=ctx, return_report=True)
    jok, jreport = JC.is_deterministic(jscs[0], ctx=jctx, return_report=True)
    assert ok == jok == case.startswith("det")
    # the same violating layers (by position in the topological order) and rows
    jpos = {l: i for i, l in enumerate(jscs[0].topological_ordering())}
    pos = {l: i for i, l in enumerate(scs[0].topological_ordering())}
    assert [(pos[l], r.tolist()) for l, r in report] == [
        (jpos[l], r.tolist()) for l, r in jreport]


def test_cross_nondeterministic_q_raises():
    jctx, _, jscs, ctx, _, scs = compile_both(det_pc(2), det_pc(2, dense=True), seed=95)
    for mod, c, s in ((JC, jctx, jscs), (TC, ctx, scs)):
        with pytest.raises(ValueError, match="deterministic"):
            mod.expected_loglikelihood(s[0], s[1], ctx=c)
        # with check=False the support double-counting guard trips
        with pytest.raises(ValueError, match="double-counting"):
            mod.expected_loglikelihood(s[0], s[1], ctx=c, check=False)


def test_cross_kl_between_weighted_logic_circuits():
    rng = np.random.default_rng(97)
    wp, wq = rng.uniform(0.1, 1.0, size=(3, 2)), rng.uniform(0.1, 1.0, size=(3, 2))
    jctx, _, jscs, ctx, _, scs = compile_both(logic_pc(wp), logic_pc(wq))
    assert TC.is_deterministic(scs[0], ctx=ctx)
    kl = _exact_both(jctx, jscs, ctx, scs, "cross_circuit_kl")
    worlds = np.array(list(itertools.product([0, 1], repeat=3)))
    sat = np.array([(w[0] and w[1]) or ((not w[0]) and w[2]) for w in worlds])
    scores = [np.prod(w[np.arange(3)[None, :], worlds], axis=1) * sat for w in (wp, wq)]
    p, q = (s / s.sum() for s in scores)
    nz = p > 0
    want = float((p[nz] * (np.log(p[nz]) - np.log(q[nz]))).sum())
    np.testing.assert_allclose(kl[0, 0], want, rtol=1e-9, atol=1e-12)


def test_cross_requires_compiled_circuits():
    jctx, _, jscs, ctx, _, scs = compile_both(det_pc(2), det_pc(2), seed=96, compile_all=False)
    for mod, c, s in ((JC, jctx, jscs), (TC, ctx, scs)):
        with pytest.raises(ValueError, match="Compile the circuit"):
            mod.expected_loglikelihood(s[0], s[1], ctx=c)


@pytest.mark.parametrize("product", ["hadamard", "kronecker"])
@pytest.mark.parametrize("reverse", [False, True])
def test_cross_device_path_matches_host(product, reverse):
    """``device=True`` (torch carriers on the store's device, float64 here)
    against the host path within 1e-9, and against JAX's device path."""
    jctx, _, jscs, ctx, _, scs = compile_both(
        det_pc(2, product=product), det_pc(3, product=product, reverse_children=reverse),
        seed=91)
    for fn in ("expected_loglikelihood", "cross_circuit_kl"):
        host = getattr(TC, fn)(scs[0], scs[1], ctx=ctx)
        dev = _exact_both(jctx, jscs, ctx, scs, fn, device=True)
        np.testing.assert_allclose(dev, host, rtol=1e-9, atol=1e-12)


def test_cross_device_gaussian_and_support_gap():
    rng = np.random.default_rng(94)
    mp, sp = rng.normal(size=2), rng.uniform(0.5, 2.0, size=2)
    mq, sq = rng.normal(size=2), rng.uniform(0.5, 2.0, size=2)
    jctx, _, jscs, ctx, _, scs = compile_both(factorized_gaussian(mp, sp),
                                              factorized_gaussian(mq, sq))
    host = TC.expected_loglikelihood(scs[0], scs[1], ctx=ctx)
    dev = _exact_both(jctx, jscs, ctx, scs, "expected_loglikelihood", device=True)
    np.testing.assert_allclose(dev, host, rtol=1e-9)
    jctx, _, jscs, ctx, _, scs = compile_both(det_pc(2), det_pc(2, dead_leaf_unit=1), seed=95)
    host = TC.expected_loglikelihood(scs[0], scs[1], ctx=ctx)
    dev = _exact_both(jctx, jscs, ctx, scs, "expected_loglikelihood", device=True)
    np.testing.assert_array_equal(np.isneginf(dev), np.isneginf(host))


def test_readback_leaves_the_store_untouched():
    """The sibling compile of the readback reads the context's store: it
    adds no slot to it and changes no value, on either path."""
    _, _, _, ctx, _, scs = compile_both(det_pc(2), det_pc(3), seed=98)
    before = {s: v.detach().clone() for s, v in ctx.parameters.items()}
    TC.is_deterministic(scs[1], ctx=ctx)
    for device in (False, True):
        TC.cross_circuit_kl(scs[0], scs[1], ctx=ctx, device=device)
    assert list(ctx.parameters.keys()) == list(before)
    for s, v in before.items():
        assert torch.equal(ctx.parameters[s], v), s


# --------------------------------------------------------------------------- #
# The Monte Carlo estimators
# --------------------------------------------------------------------------- #


def test_mc_kl_nondeterministic_pair_matches_enumeration():
    """Dense-support circuits, where the exact walk refuses: the estimates
    within 4 standard errors of enumeration."""
    _, _, jscs, ctx, ccs, scs = compile_both(det_pc(2, dense=True),
                                             det_pc(3, dense=True, product="kronecker"),
                                             seed=140)
    with pytest.raises(ValueError, match="deterministic"):
        TC.expected_loglikelihood(scs[0], scs[1], ctx=ctx)
    want_ell, want_kl = _enum_ell_kl(*jscs)
    kw = dict(num_samples=8192, store_p=ctx.parameters, store_q=ctx.parameters,
              batch_size=2048)
    kl, se = TC.kl_monte_carlo(*ccs, generator=torch.Generator().manual_seed(0), **kw)
    assert se > 0.0 and abs(kl - want_kl) < 4 * se, (kl, want_kl, se)
    ell, se2 = TC.expected_loglikelihood_mc(*ccs, generator=torch.Generator().manual_seed(1),
                                            **kw)
    assert se2 > 0.0 and abs(ell - want_ell) < 4 * se2, (ell, want_ell, se2)


def test_mc_kl_self_is_exactly_zero():
    _, _, _, ctx, ccs, _ = compile_both(det_pc(2, dense=True), seed=141)
    cc = ccs[0]
    kl, se = TC.kl_monte_carlo(cc, cc, num_samples=64, store_p=ctx.parameters,
                               store_q=ctx.parameters)
    assert kl == 0.0 and se == 0.0


def test_mc_kl_support_gap_gives_inf():
    _, _, _, ctx, ccs, _ = compile_both(det_pc(2), det_pc(2, dead_leaf_unit=1), seed=142)
    kw = dict(num_samples=512, store_p=ctx.parameters, store_q=ctx.parameters)
    kl, se = TC.kl_monte_carlo(*ccs, generator=torch.Generator().manual_seed(7), **kw)
    assert kl == np.inf and np.isnan(se)
    ell, _ = TC.expected_loglikelihood_mc(*ccs, generator=torch.Generator().manual_seed(7),
                                          **kw)
    assert ell == -np.inf


def test_mc_kl_validation_errors():
    """A different scope and too few samples raise as JAX does."""

    def two_vars(S, Sc, rng):
        leaves = [S.CategoricalLayer(Sc([v]), 1, num_categories=NUM_STATES) for v in range(2)]
        prod = S.HadamardLayer(1, arity=2)
        return S.Circuit(leaves + [prod], {prod: leaves}, [prod])

    jctx, jccs, _, ctx, ccs, _ = compile_both(det_pc(2), two_vars, seed=143)
    for mod, c, (cc_p, cc_2) in ((JC, jctx, jccs), (TC, ctx, ccs)):
        kw = dict(store_p=c.parameters, store_q=c.parameters)
        with pytest.raises(ValueError, match="identical scopes"):
            mod.kl_monte_carlo(cc_p, cc_2, **kw)
        with pytest.raises(ValueError, match="num_samples"):
            mod.kl_monte_carlo(cc_p, cc_p, num_samples=1, **kw)
