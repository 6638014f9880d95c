"""The port's tree distillation (``cirkit_tpu_torch.backend.torch.distill``)
against the JAX package's (``cirkit_tpu.backend.jax.distill``), on the CPU
in float64.

Every case of ``tests/backend/test_distill.py`` is mirrored: the same source
circuit in both packages (carried into the port by pickle, the JAX store by
slot name), the rooted edges and Prim's tree equal exactly, ``mi_objective``
and the entropies at rtol 1e-9, and the tree's conditional weights at rtol
1e-9; then the distilled tree in the port against enumeration (normalized,
the source's univariate and edge marginals, the Chow-Liu identity, exact
entropy, EM fine-tuning with frozen indicator leaves) as in JAX's tests.
"""

import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax import distill as JD
from cirkit_tpu.backend.jax.entropy import KLDivergenceQuery as JaxKLDivergenceQuery
from cirkit_tpu_torch.backend.torch import (
    EntropyQuery,
    KLDivergenceQuery,
    distill_tree,
    is_deterministic,
)
from cirkit_tpu_torch.backend.torch.distill import _prim
from cirkit_tpu_torch.parallel import em_slots, fit_em
from cirkit_tpu_torch.pipeline import PipelineContext
from tests.fixtures import build_bivariate_gaussian_pc, build_multivariate_categorical_pc
from tests.reference_eval import enumerate_worlds, eval_circuit
from tests.test_torch_pruning import assert_same_circuit, pair, to_port

RTOL = 1e-9


@pytest.fixture(autouse=True)
def float64_default():
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _probs(cc, store, worlds):
    with torch.no_grad():
        return np.exp(cc(store, torch.as_tensor(worlds))[:, 0, 0].numpy())


def distill_both(jsc, *, seed=42, **kw):
    """Both packages' distillations of one source: ``(tree, report, jtree,
    jreport, ctx, cc)`` with the trees and reports held to each other."""
    jctx, jcc, psc, ctx, cc = pair(jsc, seed=seed)
    jtree, jrep = JD.distill_tree(jcc, store=jctx.parameters, **kw)
    tree, rep = distill_tree(cc, store=ctx.parameters, **kw)
    assert rep["edges"] == jrep["edges"] and rep["root"] == jrep["root"]
    assert rep["units"] == jrep["units"]
    np.testing.assert_allclose(rep["mi_objective"], jrep["mi_objective"], rtol=RTOL)
    np.testing.assert_allclose(rep["entropies"], jrep["entropies"], rtol=RTOL, atol=1e-12)
    assert_same_circuit(jtree, tree)
    return tree, rep, jtree, jrep, ctx, cc


@pytest.fixture(scope="module")
def distilled():
    torch.set_default_dtype(torch.float64)
    try:
        jsc = build_multivariate_categorical_pc(
            num_variables=5, num_units=4, num_categories=3, rng=np.random.default_rng(31)
        )
        worlds = enumerate_worlds(5, 3)
        vals = eval_circuit(jsc, worlds)[:, 0, 0]
        tree, rep, *_ = distill_both(jsc, root=2)
        ctx2 = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
        cc2 = ctx2.compile(tree)
        q = _probs(cc2, ctx2.parameters, worlds)
        return worlds, vals / vals.sum(), tree, rep, ctx2, cc2, q
    finally:
        torch.set_default_dtype(torch.float32)


def test_prim_matches_jax():
    rng = np.random.default_rng(0)
    for d in (2, 5, 9):
        a = rng.random((d, d))
        mi = a + a.T
        mi[:, 3 % d] = mi[3 % d, :] = mi[0, 1]  # ties: the lowest index wins
        for root in range(d):
            np.testing.assert_array_equal(_prim(mi, root), JD._prim(mi, root))


def test_distilled_is_normalized_and_preserves_marginals(distilled):
    worlds, p, tree, rep, ctx2, cc2, q = distilled
    np.testing.assert_allclose(q.sum(), 1.0, rtol=1e-9)
    for v in range(5):
        for s in range(3):
            keep = worlds[:, v] == s
            np.testing.assert_allclose(q[keep].sum(), p[keep].sum(), rtol=1e-7, atol=1e-12)
    for u, v in rep["edges"]:
        for s in range(3):
            for t in range(3):
                keep = (worlds[:, u] == s) & (worlds[:, v] == t)
                np.testing.assert_allclose(q[keep].sum(), p[keep].sum(), rtol=1e-6, atol=1e-12)


def test_chow_liu_identity_and_optimality(distilled):
    worlds, p, tree, rep, ctx2, cc2, q = distilled
    kl = (p * (np.log(p) - np.log(q))).sum()
    h_p = -(p * np.log(p)).sum()
    want = -h_p + rep["entropies"].sum() - rep["mi_objective"]
    np.testing.assert_allclose(kl, want, rtol=1e-6, atol=1e-9)
    assert kl >= -1e-12

    def pair_mi(u, v):
        joint = np.zeros((3, 3))
        for w, pw in zip(worlds, p):
            joint[w[u], w[v]] += pw
        pu, pv = joint.sum(1), joint.sum(0)
        nz = joint > 0
        return (joint[nz] * np.log(joint[nz] / np.outer(pu, pv)[nz])).sum()

    for hub in range(5):
        star = sum(pair_mi(hub, v) for v in range(5) if v != hub)
        assert rep["mi_objective"] >= star - 1e-9


def test_distill_recovers_tree_source_exactly():
    """An HMM is already a tree: distilling it is lossless, and the port's
    tree is JAX's."""
    from cirkit_tpu.models import hmm

    jsc = hmm(ordering=[0, 1, 2, 3], input_layer="categorical", num_latent_states=1,
              input_layer_kwargs={"num_categories": 3})
    tree, _, _, _, ctx, cc = distill_both(jsc, seed=11)
    worlds = enumerate_worlds(4, 3)
    p = _probs(cc, ctx.parameters, worlds)
    p = p / p.sum()
    ctx2 = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    q = _probs(ctx2.compile(tree), ctx2.parameters, worlds)
    np.testing.assert_allclose(q / q.sum(), p, rtol=1e-6, atol=1e-12)


def test_distilled_is_deterministic_with_exact_entropy(distilled):
    worlds, p, tree, rep, ctx2, cc2, q = distilled
    assert is_deterministic(tree, ctx=ctx2)
    h = EntropyQuery(cc2)(store=ctx2.parameters)
    np.testing.assert_allclose(float(h[0, 0]), -(q * np.log(q)).sum(), rtol=1e-6)


def test_distilled_is_em_finetunable(distilled):
    worlds, p, tree, rep, ctx2, cc2, q = distilled
    rng = np.random.default_rng(5)
    data = worlds[rng.choice(len(worlds), p=p, size=600)]
    _, losses = fit_em(cc2, data, store=dict(ctx2.parameters), num_epochs=4, batch_size=200)
    assert losses[-1] <= losses[0] + 1e-9
    assert set(em_slots(cc2).values()) == {"sum"}


def test_distill_rejects_continuous_and_bad_root():
    jsc = build_multivariate_categorical_pc(
        num_variables=5, num_units=4, num_categories=3, rng=np.random.default_rng(31))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    with pytest.raises(ValueError) as want:
        JD.distill_tree(jcc, store=jctx.parameters, root=99)
    with pytest.raises(ValueError) as got:
        distill_tree(cc, store=ctx.parameters, root=99)
    assert str(got.value) == str(want.value) and "outside the circuit scope" in str(got.value)
    jctx, jcc, psc, ctx, cc = pair(build_bivariate_gaussian_pc())
    with pytest.raises(NotImplementedError) as want:
        JD.distill_tree(jcc, store=jctx.parameters)
    with pytest.raises(NotImplementedError) as got:
        distill_tree(cc, store=ctx.parameters)
    assert str(got.value) == str(want.value) and "finite-support" in str(got.value)


def test_distill_non_contiguous_scope():
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, HadamardLayer, SumLayer
    from cirkit_tpu.utils.scope import Scope
    from tests.fixtures import const_param

    rng = np.random.default_rng(41)
    k = 3
    leaves = []
    for v in (0, 2, 5):
        raw = rng.uniform(0.1, 1.0, size=(k, 2))
        leaves.append(CategoricalLayer(Scope([v]), k, num_categories=2,
                                       probs=const_param(raw / raw.sum(1, keepdims=True))))
    prod = HadamardLayer(k, arity=3)
    root = SumLayer(k, 1, weight=const_param(rng.dirichlet(np.ones(k))[None]))
    jsc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    tree, rep, _, _, ctx, cc = distill_both(jsc, root=2)
    assert {u for e in rep["edges"] for u in e} <= {0, 2, 5} and len(rep["edges"]) == 2
    worlds = np.zeros((8, 6), np.int64)
    worlds[:, [0, 2, 5]] = enumerate_worlds(3, 2)
    p = _probs(cc, ctx.parameters, worlds)
    p = p / p.sum()
    ctx2 = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    q = _probs(ctx2.compile(tree), ctx2.parameters, worlds)
    for u, v in rep["edges"]:
        for s in range(2):
            for t in range(2):
                keep = (worlds[:, u] == s) & (worlds[:, v] == t)
                np.testing.assert_allclose(q[keep].sum(), p[keep].sum(), rtol=1e-6, atol=1e-12)


def test_distill_binomial_source():
    from cirkit_tpu.symbolic import BinomialLayer, Circuit, HadamardLayer, SumLayer
    from cirkit_tpu.utils.scope import Scope
    from tests.fixtures import const_param

    rng = np.random.default_rng(43)
    k, n = 3, 3
    leaves = [BinomialLayer(Scope([v]), k, total_count=n,
                            probs=const_param(rng.uniform(0.2, 0.8, size=k))) for v in range(2)]
    prod = HadamardLayer(k, arity=2)
    root = SumLayer(k, 1, weight=const_param(rng.dirichlet(np.ones(k))[None]))
    jsc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    tree, _, _, _, ctx, cc = distill_both(jsc)
    worlds = enumerate_worlds(2, n + 1)
    p = _probs(cc, ctx.parameters, worlds)
    ctx2 = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    q = _probs(ctx2.compile(tree), ctx2.parameters, worlds)
    np.testing.assert_allclose(q / q.sum(), p / p.sum(), rtol=1e-6, atol=1e-12)


def test_distill_softmax_template_matches_jax():
    """A softmax-weighted 4x4 CP template (256 states): MI anchors and
    conditional tables through the kernels' dx-only backward, the tree
    equal to JAX's."""
    from cirkit_tpu.models import image_data

    jsc = image_data((1, 4, 4), "quad-tree-4", input_layer="categorical", num_input_units=3,
                     sum_product_layer="cp", num_sum_units=3)
    distill_both(jsc, seed=7, root=5)


def test_kl_between_two_distilled_parameterizations(distilled):
    """Two parameterizations of one distilled skeleton through
    KLDivergenceQuery: the port's value equals JAX's on the same stores, and
    a self-KL is 0."""
    from tests.backend.test_entropy import _enum_kl, _normalized_leaf_slots, _perturb_store
    from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext

    worlds, p, tree, rep, ctx2, cc2, q = distilled
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True)
    jcc = jctx.compile(_jax_twin(tree))
    sp = jcc.restrict_store(jctx.parameters)
    sq = _perturb_store(sp, np.random.default_rng(77),
                        renorm_slots=_normalized_leaf_slots(jcc))
    want = float(JaxKLDivergenceQuery(jcc)(sp, sq)[0, 0])
    tp = {s: torch.tensor(np.asarray(v, np.float64)) for s, v in sp.items()}
    tq = {s: torch.tensor(np.asarray(v, np.float64)) for s, v in sq.items()}
    got = float(KLDivergenceQuery(cc2)(tp, tq)[0, 0])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert abs(float(KLDivergenceQuery(cc2)(tp, tp)[0, 0])) <= 1e-12
    pw = _probs(cc2, tp, worlds)
    qw = _probs(cc2, tq, worlds)
    np.testing.assert_allclose(got, _enum_kl(pw, qw), rtol=1e-6)


def _jax_twin(sc):
    """The port's symbolic circuit as the JAX package's, by pickle."""
    import io
    import pickle

    class _ToJax(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("cirkit_tpu_torch."):
                module = "cirkit_tpu." + module[len("cirkit_tpu_torch."):]
            return super().find_class(module, name)

    return _ToJax(io.BytesIO(pickle.dumps(sc))).load()


def test_to_port_round_trip_is_the_identity():
    """The pickle map both ways keeps the graph: the helpers above compare
    like with like."""
    jsc = build_multivariate_categorical_pc(num_variables=3, rng=np.random.default_rng(3))
    assert_same_circuit(jsc, to_port(_jax_twin(to_port(jsc))))
