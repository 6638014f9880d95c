"""The port's interop formats (``cirkit_tpu_torch.models.interop``: Juice
``.jpc``, SPFlow text equations, UAI networks) against the JAX package's,
on the CPU in float64.

Every case of ``tests/models/test_interop.py`` is mirrored. The circuits
come from ``tests/fixtures.py``'s builders, run once with the JAX package's
symbolic module and once with the port's (the same source with the
``cirkit_tpu.`` imports rewritten), from the same numpy seed. Then:

- ``save_jpc`` and ``save_spflow`` write, for the same store (the JAX
  store carried across by slot name), JAX's text: the same words, structure
  and integers, and floats equal to the last ulp or two (see
  ``assert_same_text``);
- circuits loaded by the port compile to JAX's forwards at rtol 1e-12, and
  to enumeration as the JAX tests hold them;
- the UAI loaders compile to the brute-force network polynomial, and their
  errors are JAX's.
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax.queries import IntegrateQuery as JaxIntegrateQuery
from cirkit_tpu.models import interop as JI
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch import IntegrateQuery
from cirkit_tpu_torch.models import (
    load_jpc,
    load_spflow,
    load_uai,
    load_uai_evidence,
    save_jpc,
    save_spflow,
)
from cirkit_tpu_torch.parallel import evaluate_ll, fit_em
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils import Scope
from tests import fixtures as JF
from tests.reference_eval import enumerate_worlds


def _port_fixtures() -> types.ModuleType:
    """``tests/fixtures.py`` building the port's symbolic circuits."""
    src = (Path(__file__).parent / "fixtures.py").read_text()
    src = re.sub(r"^(\s*(?:from|import) )cirkit_tpu\.", r"\1cirkit_tpu_torch.", src,
                 flags=re.MULTILINE)
    mod = types.ModuleType("port_fixtures")
    exec(compile(src, "port_fixtures", "exec"), mod.__dict__)
    return mod


PF = _port_fixtures()
RTOL = 1e-12


@pytest.fixture(autouse=True)
def float64_default():
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _ctx():
    return PipelineContext(semiring="lse-sum", fold=True, device="cpu")


def _log(sc, x):
    """The port's log-values of ``sc`` on ``x``, compiled in a fresh context."""
    ctx = _ctx()
    cc = ctx.compile(sc)
    with torch.inference_mode():
        return cc(torch.as_tensor(np.asarray(x))).numpy()[:, 0, 0]


def _jlog(sc, x):
    ctx = JaxPipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    store = {s: jnp.asarray(v, jnp.float64) for s, v in ctx.parameters.items()}
    return np.asarray(cc.evaluate(store, jnp.asarray(x)))[:, 0, 0]


def _dist(sc, x):
    return np.exp(_log(sc, x))


def _both_compiled(build, **kw):
    """``build`` run with both fixtures modules from one seed, each compiled;
    the JAX store in float64 and the port's context holding it."""
    jsc, sc = build(JF, **kw), build(PF, **kw)
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True)
    jctx.compile(jsc)
    jstore = {s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()}
    ctx = _ctx()
    ctx.compile(sc)
    ctx.load_parameters(jstore)
    return jsc, jctx, {s: jnp.asarray(v) for s, v in jstore.items()}, sc, ctx


def _bivariate(F, seed=7, **kw):
    return F.build_bivariate_categorical_pc(rng=np.random.default_rng(seed), **kw)


def _multivariate(F, seed, **kw):
    return F.build_multivariate_categorical_pc(rng=np.random.default_rng(seed), **kw)


JPC_TEXT = """c a tiny hand-written jpc: 0.3*(x1 & x2) + 0.7*(!x1 & Bern(x2; 0.2))
jpc 8
L 0 0 1
L 1 0 2
P 2 0 2 0 1
L 3 0 -1
L 4 0 -2
S 5 0 2 1 -1.6094379124341003 4 -0.2231435513142097
P 6 0 2 3 5
S 7 0 2 2 -1.2039728043259361 6 -0.35667494393873245
"""


def test_load_jpc_matches_hand_computation_and_jax(tmp_path):
    path = tmp_path / "tiny.jpc"
    path.write_text(JPC_TEXT)
    sc = load_jpc(str(path))
    worlds = enumerate_worlds(2, 2)
    got = _dist(sc, worlds)
    # worlds order: (0,0), (0,1), (1,0), (1,1)
    want = np.array([0.7 * 0.8, 0.7 * 0.2, 0.0, 0.3])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(_log(sc, worlds), _jlog(JI.load_jpc(str(path)), worlds),
                               rtol=RTOL)


_NUM = re.compile(r"-?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?")


def assert_same_text(text, want):
    """``text`` is ``want`` up to the last bits of its floats: the words,
    the structure and every integer equal, and each float within 4e-16
    relative (the leaves' probabilities are ``softmax(log p)``, whose
    float64 exp and log PyTorch and XLA may round an ulp apart; the
    sums' weights are read back unchanged and print identically)."""
    assert _NUM.sub("#", text) == _NUM.sub("#", want)
    got, ref = _NUM.findall(text), _NUM.findall(want)
    ints = [(a, b) for a, b in zip(got, ref) if not re.search(r"[.eE]", b)]
    assert all(a == b for a, b in ints)
    np.testing.assert_allclose(np.array(got, float), np.array(ref, float), rtol=4e-16)


def _jpc_texts(tmp_path, jsc, jctx, jstore, sc, ctx, store=None):
    """The files JAX's and the port's ``save_jpc`` write for one store."""
    JI.save_jpc(str(tmp_path / "jax.jpc"), jsc, jctx, store=jstore)
    save_jpc(str(tmp_path / "port.jpc"), sc, ctx, store=store)
    return (tmp_path / "jax.jpc").read_text(), (tmp_path / "port.jpc").read_text()


@pytest.mark.parametrize("product", ["hadamard", "kronecker"])
def test_jpc_round_trip_binary_pc(tmp_path, product):
    """save_jpc writes JAX's file; load_jpc of it preserves the
    distribution exactly, including the Kronecker digit unfolding."""
    jsc, jctx, jstore, sc, ctx = _both_compiled(_bivariate, num_categories=2, product=product)
    jtext, text = _jpc_texts(tmp_path, jsc, jctx, jstore, sc, ctx)
    assert_same_text(text, jtext)
    back = load_jpc(str(tmp_path / "port.jpc"))
    worlds = enumerate_worlds(2, 2)
    np.testing.assert_allclose(_dist(back, worlds), _dist(sc, worlds), rtol=1e-9)
    np.testing.assert_allclose(_log(back, worlds),
                               _jlog(JI.load_jpc(str(tmp_path / "jax.jpc")), worlds),
                               rtol=RTOL)


def test_jpc_round_trip_deep_pc(tmp_path):
    jsc, jctx, jstore, sc, ctx = _both_compiled(_multivariate, seed=11, num_variables=4,
                                                num_units=3, num_categories=2)
    jtext, text = _jpc_texts(tmp_path, jsc, jctx, jstore, sc, ctx)
    assert_same_text(text, jtext)
    back = load_jpc(str(tmp_path / "port.jpc"))
    worlds = enumerate_worlds(4, 2)
    np.testing.assert_allclose(_dist(back, worlds), _dist(sc, worlds), rtol=1e-9)


def test_jpc_save_rejects_nonbinary_and_gaussian(tmp_path):
    sc = PF.build_bivariate_categorical_pc(num_categories=3)
    ctx = _ctx()
    ctx.compile(sc)
    with pytest.raises(ValueError, match="binary"):
        save_jpc(str(tmp_path / "x.jpc"), sc, ctx)
    sc = PF.build_bivariate_gaussian_pc()
    ctx = _ctx()
    ctx.compile(sc)
    with pytest.raises(ValueError, match="Gaussian"):
        save_jpc(str(tmp_path / "y.jpc"), sc, ctx)


def test_jpc_save_requires_compiled_context(tmp_path):
    sc = PF.build_bivariate_categorical_pc(num_categories=2)
    with pytest.raises(ValueError, match="[Cc]ompile"):
        save_jpc(str(tmp_path / "x.jpc"), sc, _ctx())


def test_jpc_load_learnable_is_em_trainable(tmp_path):
    path = tmp_path / "tiny.jpc"
    path.write_text(JPC_TEXT)
    sc = load_jpc(str(path), learnable=True)
    assert sc.num_parameters > 0
    ctx = _ctx()
    cc = ctx.compile(sc)
    rng = np.random.default_rng(3)
    worlds = enumerate_worlds(2, 2)
    # stay inside the circuit's support: world (1,0) has structural prob 0
    data = worlds[rng.choice(4, p=[0.5, 0.2, 0.0, 0.3], size=256)].astype(np.int32)
    before = evaluate_ll(cc, data, store=dict(ctx.parameters))
    store, _ = fit_em(cc, data, store=dict(ctx.parameters), num_epochs=5, batch_size=128)
    after = evaluate_ll(cc, data, store=store)
    assert after > before + 1e-3


SPFLOW_EQ = (
    "(0.6*(Categorical(V0|p=[0.2, 0.5, 0.3]) * Bernoulli(V1|p=0.25))"
    " + 0.4*(Categorical(V0|p=[0.7, 0.1, 0.2]) * Bernoulli(V1|p=0.9)))"
)


def test_load_spflow_matches_hand_computation():
    sc = load_spflow(SPFLOW_EQ)
    p0 = np.array([[0.2, 0.5, 0.3], [0.7, 0.1, 0.2]])
    p1 = np.array([[0.75, 0.25], [0.1, 0.9]])
    w = np.array([0.6, 0.4])
    worlds = np.array([[x0, x1] for x0 in range(3) for x1 in range(2)])
    want = [float((w * p0[:, x0] * p1[:, x1]).sum()) for x0, x1 in worlds]
    np.testing.assert_allclose(_dist(sc, worlds), want, rtol=1e-6)
    np.testing.assert_allclose(_log(sc, worlds), _jlog(JI.load_spflow(SPFLOW_EQ), worlds),
                               rtol=RTOL)


def test_spflow_round_trip_categorical(tmp_path):
    jsc, jctx, jstore, sc, ctx = _both_compiled(_multivariate, seed=23, num_variables=3,
                                                num_units=2, num_categories=4)
    eq = save_spflow(sc, ctx, filename=str(tmp_path / "m.spn"))
    assert (tmp_path / "m.spn").read_text().strip() == eq
    assert_same_text(eq, JI.save_spflow(jsc, jctx, store=jstore))
    back = load_spflow(eq)
    worlds = enumerate_worlds(3, 4)
    np.testing.assert_allclose(_dist(back, worlds), _dist(sc, worlds), rtol=1e-9)
    np.testing.assert_allclose(_log(back, worlds), _jlog(JI.load_spflow(eq), worlds),
                               rtol=RTOL)


def test_spflow_round_trip_gaussian():
    jsc, jctx, jstore, sc, ctx = _both_compiled(lambda F: F.build_bivariate_gaussian_pc())
    eq = save_spflow(sc, ctx)
    assert "Gaussian(V0|mean=" in eq
    assert_same_text(eq, JI.save_spflow(jsc, jctx, store=jstore))
    back = load_spflow(eq)
    x = np.array([[-0.7, 0.3], [0.1, -1.2], [2.0, 0.5]])
    with torch.inference_mode():
        want = ctx[sc](torch.as_tensor(x)).numpy()[:, 0, 0]
    np.testing.assert_allclose(_log(back, x), want, rtol=1e-9)
    np.testing.assert_allclose(_log(back, x), _jlog(JI.load_spflow(eq), x), rtol=RTOL)


def test_spflow_negative_mean_and_whitespace():
    eq = "(0.5*Gaussian(V0|mean=-1.5;stdev=0.5) + 0.5*Gaussian(V0|mean=+2.0;stdev=1.0))"
    sc = load_spflow(eq)
    from scipy.stats import norm

    want = 0.5 * norm.pdf(-1.5, -1.5, 0.5) + 0.5 * norm.pdf(-1.5, 2.0, 1.0)
    np.testing.assert_allclose(_dist(sc, np.array([[-1.5]]))[0], want, rtol=1e-6)


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_spflow_parse_errors(mod):
    load = load_spflow if mod == "port" else JI.load_spflow
    with pytest.raises(ValueError, match="not supported"):
        load("Poisson(V0|mean=2.0)")
    with pytest.raises(ValueError, match="trailing"):
        load("(Categorical(V0|p=[0.5, 0.5]) * Categorical(V1|p=[0.5, 0.5])) junk")
    with pytest.raises(ValueError, match="expected"):
        load("(0.5*Categorical(V0|p=[0.5, 0.5]) + )")


def test_spflow_deep_nesting_reloads():
    """Chain-shaped circuits nest the equation ~linearly in sequence length;
    the iterative parser must not hit Python's recursion limit."""
    eq = "Bernoulli(V0|p=0.5)"
    for _ in range(1500):
        eq = f"(0.5*{eq} + 0.5*Bernoulli(V0|p=0.4))"
    got = _dist(load_spflow(eq), np.array([[1]]))[0]
    # the fixpoint of p -> 0.5 p + 0.2 is 0.4 + 0.1 * 0.5^1500
    np.testing.assert_allclose(got, 0.4, rtol=1e-9)


def test_save_store_override_exports_trained_values(tmp_path):
    """save_jpc/save_spflow(store=...) export the given trained store even
    when ctx.parameters was never updated; for the same trained store the
    port writes JAX's text."""
    from cirkit_tpu.parallel import fit_em as jax_fit_em

    jsc, jctx, jstore, sc, ctx = _both_compiled(_multivariate, seed=31, num_variables=3,
                                                num_units=2, num_categories=2)
    cc = ctx._compiler.get_compiled_circuit(sc)
    data = np.random.default_rng(5).integers(0, 2, (200, 3)).astype(np.int32)
    store, _ = fit_em(cc, data, store=dict(ctx.parameters), num_epochs=4, batch_size=100)
    ll_trained = float(evaluate_ll(cc, data, store=store))
    ll_init = float(evaluate_ll(cc, data, store=dict(ctx.parameters)))
    assert abs(ll_trained - ll_init) > 1e-3  # training moved the params

    jstore_t, _ = jax_fit_em(jctx._compiler.get_compiled_circuit(jsc), data, store=jstore,
                             num_epochs=4, batch_size=100)
    for s, v in store.items():  # the two EMs agree to float64 rounding
        np.testing.assert_allclose(v.numpy(), np.asarray(jstore_t[s]), rtol=1e-9, atol=1e-15)
    # the JAX-trained store carried across: the same text
    carried = {s: torch.from_numpy(np.array(v)) for s, v in jstore_t.items()}
    jtext, text = _jpc_texts(tmp_path, jsc, jctx, jstore_t, sc, ctx, store=carried)
    assert_same_text(text, jtext)
    assert_same_text(save_spflow(sc, ctx, store=carried), JI.save_spflow(jsc, jctx, store=jstore_t))

    # the port-trained store exported (ctx.parameters NOT updated)
    path = tmp_path / "trained.jpc"
    save_jpc(str(path), sc, ctx, store=store)
    bctx = _ctx()
    bll = float(evaluate_ll(bctx.compile(load_jpc(str(path))), data, store=bctx.parameters))
    np.testing.assert_allclose(bll, ll_trained, rtol=1e-9)
    bctx = _ctx()
    back = load_spflow(save_spflow(sc, ctx, store=store))
    bll = float(evaluate_ll(bctx.compile(back), data, store=bctx.parameters))
    np.testing.assert_allclose(bll, ll_trained, rtol=1e-9)


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_jpc_corrupt_product_child_count_raises(tmp_path, mod):
    path = tmp_path / "bad.jpc"
    path.write_text("jpc 3\nL 0 0 1\nL 1 0 2\nP 2 0 1 0 1\n")
    with pytest.raises(ValueError, match="children"):
        (load_jpc if mod == "port" else JI.load_jpc)(str(path))


def test_load_negative_sum_weights_raise():
    with pytest.raises(ValueError, match="monotone"):
        load_spflow("(1.5*Bernoulli(V0|p=0.5) + -0.5*Bernoulli(V0|p=0.4))")


def test_spflow_onehot_leaf_stays_learnable_but_jpc_literal_frozen(tmp_path):
    from cirkit_tpu_torch.symbolic.layers import CategoricalLayer
    from cirkit_tpu_torch.symbolic.parameters import TensorParameter

    def leaf_flags(sc):
        out = []
        for sl in sc.layers:
            if isinstance(sl, CategoricalLayer):
                (node,) = [n for n in sl.params["probs"].nodes
                           if isinstance(n, TensorParameter)]
                out.append(node.learnable)
        return out

    # SPFlow: a vertex-valued p is a genuine parameter -> learnable
    sc = load_spflow("(0.5*Categorical(V0|p=[0.0, 1.0]) + "
                     "0.5*Categorical(V0|p=[0.3, 0.7]))", learnable=True)
    assert all(leaf_flags(sc))
    # JPC: literal indicators are structure -> frozen
    path = tmp_path / "lit.jpc"
    path.write_text("jpc 3\nL 0 0 1\nL 1 0 -1\nS 2 0 2 0 -0.5 1 -0.9\n")
    sc = load_jpc(str(path), learnable=True)
    assert not any(leaf_flags(sc))


def test_num_parameters_through_operator_references():
    from cirkit_tpu_torch.symbolic import functional

    sc = PF.build_bivariate_categorical_pc(num_categories=2)
    prod = functional.multiply(sc, sc)
    assert sc.num_parameters > 0
    # both operands reference the SAME tensors -> deduped to sc's count
    assert prod.num_parameters == sc.num_parameters


def test_spflow_path_with_parenthesis(tmp_path):
    path = tmp_path / "model (copy).spn"
    path.write_text(SPFLOW_EQ)
    got = _dist(load_spflow(str(path)), np.array([[0, 0]]))[0]
    np.testing.assert_allclose(got, 0.6 * 0.2 * 0.75 + 0.4 * 0.7 * 0.1, rtol=1e-6)


def test_jpc_zero_weight_round_trips_exact(tmp_path):
    """Structural zeros survive the log round trip exactly (the -800
    sentinel underflows to 0.0)."""

    def build(F):
        S = F
        leaves = [
            S.CategoricalLayer(S.Scope([v]), 2, num_categories=2,
                               probs=S.const_param(np.array([[0.3, 0.7], [0.8, 0.2]])))
            for v in range(2)
        ]
        prod = S.HadamardLayer(2, arity=2)
        out = S.SumLayer(2, 1, weight=S.const_param(np.array([[0.0, 1.0]])))
        return S.Circuit(leaves + [prod, out], {prod: leaves, out: [prod]}, [out])

    jsc, jctx, jstore, sc, ctx = _both_compiled(build)
    jtext, text = _jpc_texts(tmp_path, jsc, jctx, jstore, sc, ctx)
    assert_same_text(text, jtext)
    back = load_jpc(str(tmp_path / "port.jpc"))
    from cirkit_tpu_torch.symbolic.layers import SumLayer
    from cirkit_tpu_torch.symbolic.parameters import TensorParameter

    weights = [
        n.initializer.value
        for sl in back.layers if isinstance(sl, SumLayer)
        for n in sl.params["weight"].nodes if isinstance(n, TensorParameter)
    ]
    assert any(np.any(w == 0.0) for w in weights)
    worlds = enumerate_worlds(2, 2)
    np.testing.assert_allclose(_dist(back, worlds), _dist(sc, worlds), rtol=1e-12)


# ---------------------------------------------------------------------------
# UAI networks
# ---------------------------------------------------------------------------


def _uai_text(net_type, cards, scopes, tables):
    parts = [net_type, str(len(cards)), " ".join(map(str, cards)), str(len(scopes))]
    parts += [f"{len(s)} " + " ".join(map(str, s)) for s in scopes]
    for t in tables:
        flat = np.asarray(t).reshape(-1)
        parts.append(str(flat.size))
        parts.append(" ".join(repr(float(x)) for x in flat))
    return "\n".join(parts) + "\n"


def _brute_force(cards, scopes, tables):
    """Unnormalized factor product over every world, UAI entry order."""
    worlds = np.array(list(np.ndindex(*cards)), dtype=np.int64)
    vals = np.ones(len(worlds))
    for scope, table in zip(scopes, tables):
        table = np.asarray(table).reshape([cards[v] for v in scope])
        for i, w in enumerate(worlds):
            vals[i] *= table[tuple(w[v] for v in scope)]
    return worlds, vals


def _uai_case(seed, n, max_card=3, m=None):
    rng = np.random.default_rng(seed)
    cards = list(rng.integers(2, max_card + 1, size=n))
    m = m if m is not None else n
    scopes = []
    for _ in range(m):
        k = int(rng.integers(1, min(3, n) + 1))
        scopes.append(tuple(rng.choice(n, size=k, replace=False)))
    tables = [rng.uniform(0.05, 2.0, size=[cards[v] for v in scope]) for scope in scopes]
    return cards, scopes, tables


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_uai_matches_brute_force_and_jax(tmp_path, seed):
    """The VE-compiled circuit IS the network polynomial: pointwise values
    equal the factor product, integration equals Z, and both equal JAX's."""
    cards, scopes, tables = _uai_case(seed, n=5)
    path = tmp_path / "net.uai"
    path.write_text(_uai_text("MARKOV", cards, scopes, tables))
    sc = load_uai(str(path))
    assert sc.is_smooth and sc.is_decomposable

    worlds, want = _brute_force(cards, scopes, tables)
    ctx = _ctx()
    cc = ctx.compile(sc)
    with torch.inference_mode():
        got = cc(torch.as_tensor(worlds)).numpy()[:, 0, 0]
    np.testing.assert_allclose(np.exp(got), want, rtol=1e-6)
    jsc = JI.load_uai(str(path))
    np.testing.assert_allclose(got, _jlog(jsc, worlds), rtol=RTOL)
    z = IntegrateQuery(cc)(worlds[:1], integrate_vars=np.ones(len(cards), bool))
    np.testing.assert_allclose(float(np.exp(z.numpy()[0, 0, 0])), want.sum(), rtol=1e-6)


def test_load_uai_bayes_normalized(tmp_path):
    """A BAYES network's CPT product has Z == 1; posterior marginals from
    IntegrateQuery match enumeration."""
    rng = np.random.default_rng(9)
    p0 = rng.dirichlet([1, 1])
    p10 = np.stack([rng.dirichlet([1, 1]) for _ in range(2)])  # (v0, v1)
    p21 = np.stack([rng.dirichlet([1, 1]) for _ in range(2)])  # (v1, v2)
    path = tmp_path / "net.uai"
    path.write_text(_uai_text("BAYES", [2, 2, 2], [(0,), (0, 1), (1, 2)], [p0, p10, p21]))
    sc = load_uai(str(path))
    worlds, want = _brute_force([2, 2, 2], [(0,), (0, 1), (1, 2)], [p0, p10, p21])
    np.testing.assert_allclose(want.sum(), 1.0, rtol=1e-12)
    ctx = _ctx()
    cc = ctx.compile(sc)
    np.testing.assert_allclose(_dist(sc, worlds), want, rtol=1e-6)
    # p(v2=1 | v0=0): integrate out v1 at evidence (v0=0, v2=1)
    q = IntegrateQuery(cc)
    ev = np.array([[0, 0, 1]], dtype=np.int64)
    num = float(np.exp(q(ev, integrate_vars=Scope([1])).numpy()[0, 0, 0]))
    den = float(np.exp(q(ev, integrate_vars=Scope([1, 2])).numpy()[0, 0, 0]))
    mask = worlds[:, 0] == 0
    np.testing.assert_allclose(
        num / den, want[mask & (worlds[:, 2] == 1)].sum() / want[mask].sum(), rtol=1e-6)


def test_load_uai_custom_order_and_free_variable(tmp_path):
    """A variable in no factor contributes card(v) to Z; a user-supplied
    elimination order gives the same distribution."""
    cards, scopes, tables = [2, 3, 2], [(0, 2)], [np.full((2, 2), 0.5)]
    path = tmp_path / "net.uai"
    path.write_text(_uai_text("MARKOV", cards, scopes, tables))
    worlds = np.array(list(np.ndindex(2, 3, 2)), dtype=np.int64)
    for order in (None, [2, 0, 1], [1, 2, 0]):
        sc = load_uai(str(path), elimination_order=order)
        np.testing.assert_allclose(_dist(sc, worlds), 0.5, rtol=1e-9)
        np.testing.assert_allclose(
            _log(sc, worlds),
            _jlog(JI.load_uai(str(path), elimination_order=order), worlds), rtol=RTOL)


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_load_uai_errors(tmp_path, mod):
    load = load_uai if mod == "port" else JI.load_uai
    path = tmp_path / "bad.uai"
    path.write_text("FACTORGRAPH\n1\n2\n0\n")
    with pytest.raises(ValueError, match="network type"):
        load(str(path))
    path.write_text(_uai_text("MARKOV", [2, 2], [(0, 1)], [np.ones((2, 2))])
                    .replace("4", "3", 1))
    with pytest.raises(ValueError, match="entries"):
        load(str(path))
    path.write_text(_uai_text("MARKOV", [2, 2], [(0, 1)], [np.ones((2, 2))]))
    with pytest.raises(ValueError, match="max_table_entries"):
        load(str(path), max_table_entries=2)
    with pytest.raises(ValueError, match="permutation"):
        load(str(path), elimination_order=[0])


def test_load_uai_evidence(tmp_path):
    """.evid files (with and without the leading sample-count line) drive
    IntegrateQuery to the exact evidence marginal, as JAX's."""
    cards, scopes, tables = _uai_case(4, n=4)
    net = tmp_path / "net.uai"
    net.write_text(_uai_text("MARKOV", cards, scopes, tables))
    sc = load_uai(str(net))
    ctx = _ctx()
    cc = ctx.compile(sc)
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True)
    jcc = jctx.compile(JI.load_uai(str(net)))
    jstore = {s: jnp.asarray(v, jnp.float64) for s, v in jctx.parameters.items()}

    for text in ("2 0 1 3 0\n", "1\n2 0 1 3 0\n"):
        ev = tmp_path / "e.evid"
        ev.write_text(text)
        x, observed = load_uai_evidence(str(ev), 4)
        jx, jobserved = JI.load_uai_evidence(str(ev), 4)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(observed, jobserved)
        assert list(observed) == [True, False, False, True]
        assert x[0, 0] == 1 and x[0, 3] == 0
        got = IntegrateQuery(cc)(x, integrate_vars=~observed).numpy()[0, 0, 0]
        worlds, vals = _brute_force(cards, scopes, tables)
        want = vals[(worlds[:, 0] == 1) & (worlds[:, 3] == 0)].sum()
        np.testing.assert_allclose(float(np.exp(got)), want, rtol=1e-6)
        jgot = JaxIntegrateQuery(jcc)(jnp.asarray(x), integrate_vars=~observed, store=jstore)
        np.testing.assert_allclose(got, np.asarray(jgot)[0, 0, 0], rtol=RTOL)

    ev = tmp_path / "bad.evid"
    ev.write_text("3 0 1\n")
    with pytest.raises(ValueError, match="pairs"):
        load_uai_evidence(str(ev), 4)
    ev.write_text("1 9 1\n")
    with pytest.raises(ValueError, match="out of range"):
        load_uai_evidence(str(ev), 4)


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_load_uai_input_validation(tmp_path, mod):
    load, load_ev = ((load_uai, load_uai_evidence) if mod == "port"
                     else (JI.load_uai, JI.load_uai_evidence))
    path = tmp_path / "bad.uai"
    # trailing tokens: factor count understated
    path.write_text("MARKOV\n2\n2 2\n1\n2 0 1\n4\n1 1 1 1\n4\n1 1 1 1\n")
    with pytest.raises(ValueError, match="trailing"):
        load(str(path))
    path.write_text("MARKOV\n1\n0\n0\n")
    with pytest.raises(ValueError, match="cardinalities"):
        load(str(path))
    path.write_text("MARKOV\n2\n2 2\n1\n2 0 0\n4\n1 1 1 1\n")
    with pytest.raises(ValueError, match="repeats"):
        load(str(path))
    ev = tmp_path / "e.evid"
    ev.write_text("1 0 5\n")
    with pytest.raises(ValueError, match="state"):
        load_ev(str(ev), 2, cards=[2, 2])
    ev.write_text("1 0 -1\n")
    with pytest.raises(ValueError, match="state"):
        load_ev(str(ev), 2)


def test_load_uai_24_variables_compiles_to_jax():
    """A seeded 24-variable Markov network (the size ``chip_smoke.py``
    loads): log Z and the log-values of 32 rows equal JAX's."""
    import tempfile

    cards, scopes, tables = _uai_case(24, n=24, max_card=2)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "net.uai"
        path.write_text(_uai_text("MARKOV", cards, scopes, tables))
        sc, jsc = load_uai(str(path)), JI.load_uai(str(path))
    x = np.random.default_rng(0).integers(0, 2, (32, 24))
    np.testing.assert_allclose(_log(sc, x), _jlog(jsc, x), rtol=RTOL)
    ctx = _ctx()
    cc = ctx.compile(sc)
    z = IntegrateQuery(cc)(x[:1], integrate_vars=Scope(cc.scope)).numpy()[0, 0, 0]
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True)
    jcc = jctx.compile(jsc)
    jstore = {s: jnp.asarray(v, jnp.float64) for s, v in jctx.parameters.items()}
    jz = JaxIntegrateQuery(jcc)(jnp.asarray(x[:1]), integrate_vars=jcc.scope, store=jstore)
    np.testing.assert_allclose(z, np.asarray(jz)[0, 0, 0], rtol=RTOL)
