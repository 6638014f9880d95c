"""The port's ``ExpectationQuery`` and ``mutual_information``
(``cirkit_tpu_torch.backend.torch.queries``) against the JAX package's, on
the CPU in float64.

The same circuit is built in both packages from one numpy seed and the JAX
store is carried into the port by slot name; one numpy batch and evidence
mask go through both. The circuits are those of ``tests/backend/test_cdf.py``
(the Gaussian mixture, the deep categorical circuit, the Binomial and
Embedding mixture), of ``tests/backend/test_queries.py:466-600`` (the
binary deep circuit) and a 4x4 ``image_data`` with ``cp`` and with
``tucker`` (optimized, so the Tucker and CP layers' forwards and dx-only
backwards run). Every mode is held to JAX at rtol 1e-9: the means, the
variances, the marginals (and their bfloat16 table to one bfloat16
rounding), the CDFs, the quantiles (plus 1e-12 absolute: the bisection's
last interval) and the covariances (plus 1e-14 absolute); the MI matrices at
rtol 1e-9 plus an absolute 1e-12 of the largest entry (the off-diagonal
entries are differences of nats-sized terms). The errors are the JAX
package's. The JAX side runs as its own tests run it: its lse-sum forward
routes to its XLA reference on the CPU, and the covariance rows trace that
path by construction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cirkit_tpu.symbolic as JS
import cirkit_tpu_torch.symbolic as TS
from cirkit_tpu.backend.jax import queries as JQ
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu.utils import Scope as JScope
from cirkit_tpu_torch.backend.torch import ExpectationQuery, mutual_information
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils import Scope

RTOL = 1e-9
JAX = (JS, JScope)
PORT = (TS, Scope)


# --------------------------------------------------------------------------- #
# Circuits, built alike in both packages: build(S, Sc, rng)
# --------------------------------------------------------------------------- #


def const(S, value):
    value = np.asarray(value, np.float64)
    return S.Parameter.from_input(S.TensorParameter(
        *value.shape, initializer=S.ConstantTensorInitializer(value), learnable=True))


def deep_pc(num_variables=4, k=3, c=2):
    """``tests/fixtures.py::build_multivariate_categorical_pc``: a balanced
    binary vtree of Hadamard products with dense (unnormalized) sums."""

    def build(S, Sc, rng):
        layers, in_layers = [], {}

        def rec(lo, hi):
            if hi - lo == 1:
                raw = rng.uniform(0.1, 1.0, (k, c))
                sl = S.CategoricalLayer(Sc([lo]), k, num_categories=c,
                                        probs=const(S, raw / raw.sum(axis=1, keepdims=True)))
                layers.append(sl)
                return sl
            mid = (lo + hi) // 2
            left, right = rec(lo, mid), rec(mid, hi)
            prod = S.HadamardLayer(k, arity=2)
            ko = 1 if (lo, hi) == (0, num_variables) else k
            s = S.SumLayer(k, ko, weight=const(S, rng.uniform(0.1, 1.0, (ko, k))))
            layers.extend([prod, s])
            in_layers[prod] = [left, right]
            in_layers[s] = [prod]
            return s

        return S.Circuit(layers, in_layers, [rec(0, num_variables)])

    return build


def gmm(S, Sc, rng):
    """``tests/backend/test_cdf.py``'s bivariate Gaussian mixture."""
    k = 3
    mus = rng.normal(scale=2.0, size=(2, k))
    sds = rng.uniform(0.5, 1.2, size=(2, k))
    leaves = [S.GaussianLayer(Sc([v]), k, mean=const(S, mus[v]), stddev=const(S, sds[v]))
              for v in range(2)]
    prod = S.HadamardLayer(k, arity=2)
    root = S.SumLayer(k, 1, weight=const(S, rng.dirichlet(np.ones(k))[None]))
    return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def binomial_embedding(S, Sc, rng):
    """``tests/backend/test_cdf.py``'s Binomial and (unnormalized) Embedding
    mixture."""
    k, n, s_emb = 3, 5, 4
    leaves = [
        S.BinomialLayer(Sc([0]), k, total_count=n, probs=const(S, rng.uniform(0.2, 0.8, k))),
        S.EmbeddingLayer(Sc([1]), k, num_states=s_emb,
                         weight=const(S, rng.uniform(0.1, 1.0, (k, s_emb)))),
    ]
    prod = S.HadamardLayer(k, arity=2)
    root = S.SumLayer(k, 1, weight=const(S, rng.dirichlet(np.ones(k))[None]))
    return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def pc_over(vars_, k=3, c=3):
    """``tests/fixtures.py::build_pc_over``: a mixture of products over
    arbitrary variable ids (a non-contiguous scope)."""

    def build(S, Sc, rng):
        leaves = []
        for v in vars_:
            raw = rng.uniform(0.1, 1.0, (k, c))
            leaves.append(S.CategoricalLayer(Sc([v]), k, num_categories=c,
                                             probs=const(S, raw / raw.sum(1, keepdims=True))))
        prod = S.HadamardLayer(k, arity=len(vars_))
        root = S.SumLayer(k, 1, weight=const(S, rng.uniform(0.1, 1.0, (1, k))))
        return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])

    return build


def zero_state_pc(S, Sc, rng):
    """Three 4-state categorical variables whose state 3 has probability 0
    in every unit: an MI anchor state of probability 0."""
    k = 2
    leaves = []
    for v in range(3):
        raw = rng.uniform(0.1, 1.0, (k, 4))
        raw[:, 3] = 0.0
        leaves.append(S.CategoricalLayer(Sc([v]), k, num_categories=4,
                                         probs=const(S, raw / raw.sum(1, keepdims=True))))
    prod = S.HadamardLayer(k, arity=3)
    root = S.SumLayer(k, 1, weight=const(S, rng.dirichlet(np.ones(k))[None]))
    return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def image(spl, k=4):
    def build(S, Sc, rng):
        make = jax_image_data if S is JS else image_data
        return make((1, 4, 4), "quad-tree-2", input_layer="categorical", num_input_units=k,
                    sum_product_layer=spl, num_sum_units=k)
    return build


def compile_both(build, seed=0, **flags):
    """Both packages' compiled circuit from ``build(S, Sc, rng)`` with the
    same seed, the JAX store in float64 and the port's context holding it."""
    flags = {"semiring": "lse-sum", "fold": True, **flags}
    jctx = JaxPipelineContext(**flags)
    jcc = jctx.compile(build(*JAX, np.random.default_rng(seed)))
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    cc = ctx.compile(build(*PORT, np.random.default_rng(seed)))
    arrays = {s: np.asarray(v) for s, v in jctx.parameters.items()}
    arrays = {s: a.astype(np.float64) if a.dtype.kind == "f" else a for s, a in arrays.items()}
    ctx.load_parameters(arrays)
    return jcc, {s: jnp.asarray(a) for s, a in arrays.items()}, ctx, cc


def assert_close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=got.dtype), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------- #
# ExpectationQuery
# --------------------------------------------------------------------------- #


def _batch(num_vars, n, seed, hi, gaussian=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.5, (n, num_vars)) if gaussian else rng.integers(0, hi, (n, num_vars))
    mask = rng.random((n, num_vars)) < 0.5
    mask[0] = False  # one row with no evidence
    return x, mask


# name -> (circuit, compile flags, (B, D) batch, continuous leaves)
CASES = {
    "gmm": (gmm, {}, _batch(2, 4, 1, 0, gaussian=True), True),
    "deep-cat": (deep_pc(4, 3, 3), {}, _batch(4, 5, 2, 3), False),
    "binomial-embedding": (binomial_embedding, {}, _batch(2, 5, 3, 4), False),
    "deep-binary": (deep_pc(4, 3, 2), {}, _batch(4, 5, 4, 2), False),
    "image-cp": (image("cp"), {"optimize": True}, _batch(16, 5, 5, 256), False),
    "image-tucker": (image("tucker"), {"optimize": True}, _batch(16, 5, 6, 256), False),
}
SEEDS = {"gmm": 70, "deep-cat": 71, "binomial-embedding": 73, "deep-binary": 90,
         "image-cp": 0, "image-tucker": 0}


def _case(name):
    build, flags, (x, mask), continuous = CASES[name]
    return (*compile_both(build, SEEDS[name], **flags), x, mask, continuous)


MODES = ["mean", "mean_var", "marginals", "marginals_bf16", "cdf", "quantile", "covariance"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_expectation_matches_jax(name, mode):
    jcc, jstore, ctx, cc, x, mask, continuous = _case(name)
    jq, q = JQ.ExpectationQuery(jcc), ExpectationQuery(cc)
    kw = dict(evidence_mask=mask)
    if mode == "mean":
        assert_close(q(x, **kw), jq(x, store=jstore, **kw))
    elif mode == "mean_var":
        (m, v), (jm, jv) = q(x, return_variance=True, **kw), jq(x, store=jstore,
                                                                 return_variance=True, **kw)
        assert_close(m, jm)
        assert_close(v, jv)
    elif mode.startswith("marginals"):
        if continuous:
            with pytest.raises(NotImplementedError, match="finite-support"):
                q.marginals(x, **kw)
            return
        if mode == "marginals":
            assert_close(q.marginals(x, **kw), jq.marginals(x, store=jstore, **kw))
        else:
            got = q.marginals(x, dtype=torch.bfloat16, **kw)
            want = jq.marginals(x, store=jstore, dtype=jnp.bfloat16, **kw)
            assert got.dtype == torch.bfloat16
            # both round the same float64 table to bfloat16
            assert_close(got.float(), np.asarray(want, np.float32), rtol=2.0**-8)
    elif mode == "cdf":
        ts = np.linspace(-1.5, 2.5, x.shape[1])[None] + np.arange(x.shape[0])[:, None] * 0.5
        if x.shape[1] == 16:
            ts = ts * 60.0
        for t in (ts, 1.0, 127.0):
            assert_close(q.cdf(x, t=t, **kw), jq.cdf(x, t=t, store=jstore, **kw))
    elif mode == "quantile":
        for target in (0.05, 0.5, np.linspace(0.1, 0.9, x.shape[1])):
            # the 60 bisections end on an interval of ~1e-17 at a step
            # CDF's jump, so a quantile at state 0 is only that close to 0
            assert_close(q.quantile(x, q=target, **kw),
                         jq.quantile(x, q=target, store=jstore, **kw), atol=1e-12)
    else:
        variables = [0, 1] if x.shape[1] == 2 else [1, 2, 3]
        assert_close(q.covariance(x, variables=variables, **kw),
                     jq.covariance(x, variables=variables, store=jstore, **kw), atol=1e-14)


def test_expectation_pads_and_selects_heads():
    """``pad_batch_to`` pads and slices back; ``output``/``unit`` pick the
    root head (a two-head circuit)."""

    def two_heads(S, Sc, rng):
        leaves = [S.CategoricalLayer(Sc([v]), 3, num_categories=3,
                                     probs=const(S, rng.dirichlet(np.ones(3), size=3)))
                  for v in range(3)]
        prod = S.HadamardLayer(3, arity=3)
        root = S.SumLayer(3, 2, weight=const(S, rng.dirichlet(np.ones(3), size=2)))
        return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])

    jcc, jstore, ctx, cc = compile_both(two_heads, 75)
    x, mask = _batch(3, 3, 8, 3)
    q, jq = ExpectationQuery(cc), JQ.ExpectationQuery(jcc)
    for unit in (0, 1):
        got = q(x, evidence_mask=mask, unit=unit, pad_batch_to=4)
        assert got.shape == (3, 3)
        assert_close(got, jq(x, evidence_mask=mask, unit=unit, store=jstore))


def test_expectation_errors():
    jcc, jstore, ctx, cc = compile_both(gmm, 70)
    q = ExpectationQuery(cc)
    x = np.zeros((1, 2))
    mask = np.zeros((1, 2), bool)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="strictly in"):
            q.quantile(x, q=bad, evidence_mask=mask)
    with pytest.raises(ValueError, match="variables"):
        q(np.zeros((2, 2)), evidence_mask=np.zeros((2, 5), bool))
    with pytest.raises(ValueError, match="out of range"):
        q.covariance(x, evidence_mask=mask, variables=[0, 2])
    with pytest.raises(NotImplementedError, match="continuous"):
        mutual_information(cc)
    sum_product = PipelineContext(semiring="sum-product", fold=True, device="cpu", seed=0)
    with pytest.raises(ValueError, match="lse-sum"):
        ExpectationQuery(sum_product.compile(gmm(*PORT, np.random.default_rng(0))))


# --------------------------------------------------------------------------- #
# mutual_information
# --------------------------------------------------------------------------- #


def _assert_mi(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert_close(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("variables", [None, (0, 2), (3, 1, 2)])
def test_mutual_information_matches_jax(variables):
    jcc, jstore, ctx, cc = compile_both(deep_pc(4, 3, 3), 71)
    got = mutual_information(cc, variables=variables)
    _assert_mi(got, JQ.mutual_information(jcc, store=jstore, variables=variables))


@pytest.mark.parametrize("spl", ["cp", "tucker"])
def test_mutual_information_image_matches_jax(spl):
    jcc, jstore, ctx, cc = compile_both(image(spl), 0, optimize=True)
    variables = (0, 5, 6, 15)
    _assert_mi(mutual_information(cc, variables=variables),
               JQ.mutual_information(jcc, store=jstore, variables=variables))


def test_conditional_mutual_information_matches_jax():
    jcc, jstore, ctx, cc = compile_both(deep_pc(4, 3, 3), 71)
    x = np.array([2, 0, 1, 0])
    mask = np.array([True, False, False, False])
    got = mutual_information(cc, x=x, evidence_mask=mask)
    _assert_mi(got, JQ.mutual_information(jcc, store=jstore, x=x, evidence_mask=mask))
    assert (got[0] == 0).all() and (got[:, 0] == 0).all()


def test_mutual_information_non_contiguous_scope():
    jcc, jstore, ctx, cc = compile_both(pc_over([0, 2, 5]), 3)
    got = mutual_information(cc)
    assert got.shape == (3, 3)
    _assert_mi(got, JQ.mutual_information(jcc, store=jstore))
    with pytest.raises(ValueError, match="outside the circuit scope"):
        mutual_information(cc, variables=[1])


def test_mutual_information_zero_probability_anchor_state():
    """State 3 has probability 0: its anchored rows are NaN before the
    mask and contribute nothing after it."""
    jcc, jstore, ctx, cc = compile_both(zero_state_pc, 12)
    got = mutual_information(cc)
    assert torch.isfinite(got).all()
    _assert_mi(got, JQ.mutual_information(jcc, store=jstore))


# --------------------------------------------------------------------------- #
# Second derivatives: the plain compositions' double backward
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("plain", [True, False])
@pytest.mark.parametrize("spl", ["cp", "tucker"])
def test_double_backward_matches_jax_hvp(spl, plain):
    """The Hessian-vector product of the summed root log-likelihood with
    respect to zero offsets on the input layers' log-outputs, by a double
    backward in the port (through the plain compositions with
    ``plain=True``, through the ops' ``autograd.Function``s, whose CPU
    backward is itself differentiable, without) against ``jax.jvp`` over
    ``jax.grad`` of the same function."""
    import jax

    from cirkit_tpu.backend.jax.layers import JaxInputLayer
    from cirkit_tpu_torch.backend.torch.layers import TorchInputLayer
    from cirkit_tpu_torch.backend.torch.queries import offset_module_fn

    jcc, jstore, ctx, cc = compile_both(image(spl), 0, optimize=True)
    x, mask = _batch(16, 3, 9, 256)
    rng = np.random.default_rng(10)
    jin = [l for l in jcc.layers if isinstance(l, JaxInputLayer)]
    tin = [l for l in cc.layers if isinstance(l, TorchInputLayer)]
    shapes = [(l.num_folds, x.shape[0], l.num_output_units) for l in tin]
    tangents = [rng.normal(size=s) for s in shapes]

    def jax_ll(offs):
        def layer_fn(layer, s, xin):
            out = layer(s, xin)
            for l, o in zip(jin, offs):
                if layer is l:
                    m = jnp.transpose(jnp.asarray(mask)[:, l.scope_idx[:, 0]])[:, :, None]
                    return jnp.where(m, out, l.integrate(s)[:, None, :]) + o
            return out
        return jcc.evaluate(jstore, jnp.asarray(x), module_fn=layer_fn)[:, 0, 0].sum()

    zeros = [jnp.zeros(s) for s in shapes]
    _, want = jax.jvp(jax.grad(jax_ll), (zeros,), ([jnp.asarray(t) for t in tangents],))

    offs = [torch.zeros(s, dtype=torch.float64, requires_grad=True) for s in shapes]
    module_fn = offset_module_fn({id(l): o for l, o in zip(tin, offs)},
                                 ~torch.as_tensor(mask))
    store = {k: v.detach() for k, v in ctx.parameters.items()}
    ll = cc.evaluate(store, torch.as_tensor(x), module_fn=module_fn, plain=plain)
    grads = torch.autograd.grad(ll[:, 0, 0].sum(), offs, create_graph=True)
    got = torch.autograd.grad(grads, offs, grad_outputs=[torch.as_tensor(t) for t in tangents])
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-14)
