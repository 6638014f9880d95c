"""The port's queries (``cirkit_tpu_torch.backend.torch.queries``) against
the JAX package's (``cirkit_tpu.backend.jax.queries``), on the CPU.

The same circuit is built in both packages and the JAX store is carried
into the port by slot name; one numpy batch and mask go through both:

- in float64 on ``image_data((1,4,4), "quad-tree-2", ..., "tucker", K=8)``
  (JAX's XLA path): ``IntegrateQuery`` and ``MAPQuery`` (plain, marginal,
  scope evidence, unconditional) values to rtol 1e-9 and assignments
  equal, and ``SamplingQuery.conditional``'s log-evidence to rtol 1e-9;
- in float32 at K=16 against JAX's Pallas kernels in interpret mode
  (``CIRKIT_TPU_FORCE_PALLAS=1``; M = 256, the smallest Tucker the JAX
  kernels take): the same values to rtol 1e-5 (the kernels sum in another
  order and JAX splits f32 into bf16 thirds).

Sampling cannot match ``jax.random``: unconditional and conditional draws
are held against exhaustive enumeration of small circuits, each world's
frequency within 5 standard errors plus 1e-3. MAP through sum-collapsed
weights is held against enumeration, and missing-data ``fit`` against
JAX's ``fit`` in float64.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cirkit_tpu.symbolic as JS
import cirkit_tpu_torch.symbolic as TS
from cirkit_tpu.backend.jax import queries as JQ
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.parallel import fit as jax_fit
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu.utils import Scope as JScope
from cirkit_tpu_torch.backend.torch import (
    IntegrateQuery,
    MAPQuery,
    SamplingQuery,
    masked_evaluate,
)
from cirkit_tpu_torch.backend.torch import queries as Q
from cirkit_tpu_torch.backend.torch.parameters import (
    TorchMatMulParameter,
    TorchParameter,
    TorchSoftmaxParameter,
    TorchTensorSlot,
)
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.parallel import data_parallel_step, fit
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils import Scope
from tests.reference_eval import enumerate_worlds, eval_circuit, mpe_by_enumeration

FLAGS = dict(semiring="lse-sum", fold=True, optimize=True)
JAX = (JS, JScope)
PORT = (TS, Scope)


def _carry(jctx, ctx, dtype):
    """The JAX store in ``dtype``, and the port's context holding it."""
    jstore = {s: jnp.asarray(v, dtype) for s, v in jctx.parameters.items()}
    ctx.load_parameters({s: np.asarray(v) for s, v in jstore.items()})
    return jstore


def _image(k=8, dtype=jnp.float64, spl="tucker"):
    kw = dict(input_layer="categorical", num_input_units=k, sum_product_layer=spl,
              num_sum_units=k)
    jctx = JaxPipelineContext(**FLAGS)
    jcc = jctx.compile(jax_image_data((1, 4, 4), "quad-tree-2", **kw))
    ctx = PipelineContext(**FLAGS, device="cpu", seed=0)
    cc = ctx.compile(image_data((1, 4, 4), "quad-tree-2", **kw))
    return jcc, _carry(jctx, ctx, dtype), cc


def _batch(n=5, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 16))
    obs = rng.random((n, 16)) < 0.5
    marg = (~obs) & (rng.random((n, 16)) < 0.4)
    return x, obs, marg


def _compile_both(build, seed, *, fold=True, optimize=False):
    """A hand-built circuit in both packages (the same numpy parameters) with
    its JAX symbolic circuit (the enumeration oracles take it)."""
    sc_j = build(*JAX, np.random.default_rng(seed))
    jctx = JaxPipelineContext(semiring="lse-sum", fold=fold, optimize=optimize)
    jcc = jctx.compile(sc_j)
    ctx = PipelineContext(semiring="lse-sum", fold=fold, optimize=optimize, device="cpu",
                          seed=0)
    cc = ctx.compile(build(*PORT, np.random.default_rng(seed)))
    return sc_j, jcc, _carry(jctx, ctx, jnp.float64), cc


def _const(S, value):
    value = np.asarray(value, np.float64)
    return S.Parameter.from_input(S.TensorParameter(
        *value.shape, initializer=S.ConstantTensorInitializer(value), learnable=True))


def _leaf(S, Sc, rng, v, k, c):
    raw = rng.uniform(0.1, 1.0, (k, c))
    return S.CategoricalLayer(Sc([v]), k, num_categories=c,
                              probs=_const(S, raw / raw.sum(axis=1, keepdims=True)))


def _deep_pc(S, Sc, rng, num_variables=4, k=3, c=2):
    """``tests/fixtures.py::build_multivariate_categorical_pc``: a balanced
    binary vtree of Hadamard products with dense sums between them."""
    layers, in_layers = [], {}

    def build(lo, hi):
        if hi - lo == 1:
            sl = _leaf(S, Sc, rng, lo, k, c)
            layers.append(sl)
            return sl
        mid = (lo + hi) // 2
        left, right = build(lo, mid), build(mid, hi)
        prod = S.HadamardLayer(k, arity=2)
        ko = 1 if (lo, hi) == (0, num_variables) else k
        s = S.SumLayer(k, ko, weight=_const(S, rng.uniform(0.1, 1.0, (ko, k))))
        layers.extend([prod, s])
        in_layers[prod] = [left, right]
        in_layers[s] = [prod]
        return s

    root = build(0, num_variables)
    return S.Circuit(layers, in_layers, [root])


def _mixture_pc(S, Sc, rng, product="hadamard"):
    """The normalized two-variable circuits of
    ``tests/backend/test_queries.py:89`` (Hadamard) and ``:132``
    (Kronecker, which the optimizer fuses into a Tucker layer)."""
    leaves = [_leaf(S, Sc, rng, v, 2, 2) for v in range(2)]
    if product == "hadamard":
        prod, width = S.HadamardLayer(2, arity=2), 2
    else:
        prod, width = S.KroneckerLayer(2, arity=2), 4
    w = rng.uniform(0.1, 1.0, (1, width))
    s = S.SumLayer(width, 1, weight=_const(S, w / w.sum()))
    return S.Circuit(leaves + [prod, s], {prod: leaves, s: [prod]}, [s])


def _collapsed_pc(S, Sc, rng):
    """``tests/backend/test_map.py::test_map_and_topk_through_collapsed_sums``:
    a dense root over a mixing sum, which sum-collapse fuses into one sum
    with a ``MatMul`` weight."""
    leaves, hads, in_layers = [], [], {}
    for _ in range(2):
        pair = [_leaf(S, Sc, rng, v, 2, 3) for v in range(2)]
        h = S.HadamardLayer(2, arity=2)
        in_layers[h] = pair
        leaves.extend(pair)
        hads.append(h)
    mix = S.SumLayer(2, 2, arity=2, weight=_const(S, rng.uniform(0.1, 1.0, (2, 4))))
    root = S.SumLayer(2, 1, weight=_const(S, rng.uniform(0.1, 1.0, (1, 2))))
    in_layers[mix] = hads
    in_layers[root] = [mix]
    return S.Circuit(leaves + hads + [mix, root], in_layers, [root])


def _frequencies_match(samples, worlds, probs, n):
    counts = collections.Counter(map(tuple, np.asarray(samples).astype(int).tolist()))
    freqs = np.array([counts.get(tuple(w), 0) / n for w in worlds.tolist()])
    tol = 5 * np.sqrt(probs * (1 - probs) / n) + 1e-3
    assert (np.abs(freqs - probs) <= tol).all(), (freqs, probs)


# --------------------------------------------------------------------------- #
# The slice against JAX in float64
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("spec", ["mask", "row-mask", "scope", "scopes"])
def test_integrate_query_matches_jax_float64(spec):
    jcc, jstore, cc = _image()
    x, obs, _ = _batch()
    masks = {
        "mask": (obs, obs),
        "row-mask": (obs[0], obs[0]),
        "scope": (JScope([0, 3, 7]), Scope([0, 3, 7])),
        "scopes": ([JScope(np.nonzero(r)[0].tolist()) for r in obs],
                   [Scope(np.nonzero(r)[0].tolist()) for r in obs]),
    }
    jspec, spec_ = masks[spec]
    want = JQ.IntegrateQuery(jcc)(jnp.asarray(x), integrate_vars=jspec, store=jstore)
    got = IntegrateQuery(cc)(x, integrate_vars=spec_)
    assert got.shape == (5, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    mask = IntegrateQuery(cc)._as_mask(spec_, 5, torch.device("cpu"))
    torch.testing.assert_close(got, masked_evaluate(cc, cc.default_store, torch.as_tensor(x),
                                                    mask))


def test_integrate_query_soft_evidence_matches_jax_float64():
    jcc, jstore, cc = _image()
    x, obs, _ = _batch()
    soft = (~obs) & (np.arange(16) % 3 == 0)
    w = np.random.default_rng(9).uniform(0.0, 1.0, (5, 16, 256))
    want = JQ.IntegrateQuery(jcc)(jnp.asarray(x), integrate_vars=obs, soft_vars=soft,
                                  soft_weights=w, store=jstore)
    got = IntegrateQuery(cc)(x, integrate_vars=obs, soft_vars=soft, soft_weights=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    with pytest.raises(ValueError, match="both marginalized and soft"):
        IntegrateQuery(cc)(x, integrate_vars=obs, soft_vars=obs, soft_weights=w)


@pytest.mark.parametrize("case", ["plain", "marginal", "scope", "unconditional"])
def test_map_query_matches_jax_float64(case):
    jcc, jstore, cc = _image()
    x, obs, marg = _batch()
    jq, q = JQ.MAPQuery(jcc), MAPQuery(cc)
    if case == "plain":
        want = jq(jnp.asarray(x), evidence_mask=obs, store=jstore)
        got = q(x, evidence_mask=obs)
    elif case == "marginal":
        want = jq(jnp.asarray(x), evidence_mask=obs, marginalize_vars=marg, store=jstore)
        got = q(x, evidence_mask=obs, marginalize_vars=marg)
        assert (got[0].numpy()[marg] == 0).all()
    elif case == "scope":
        want = jq(jnp.asarray(x), evidence_mask=JScope([1, 4, 9]), store=jstore)
        got = q(x, evidence_mask=Scope([1, 4, 9]))
    else:
        want = jq(store=jstore)
        got = q()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-9)
    if case != "unconditional":
        ev = obs if case != "scope" else np.isin(np.arange(16), [1, 4, 9])[None].repeat(5, 0)
        np.testing.assert_array_equal(got[0].numpy()[ev], x[ev])


def test_conditional_log_evidence_matches_jax_float64():
    jcc, jstore, cc = _image()
    x, obs, _ = _batch()
    _, want = JQ.SamplingQuery(jcc).conditional(jnp.asarray(x), evidence_mask=obs,
                                                key=jax.random.PRNGKey(0), store=jstore)
    gen = torch.Generator().manual_seed(0)
    samples, got = SamplingQuery(cc).conditional(x, evidence_mask=obs, generator=gen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    s = samples.numpy()
    np.testing.assert_array_equal(s[obs], x[obs])
    assert ((s >= 0) & (s <= 255) & (s == np.round(s))).all()
    again, _ = SamplingQuery(cc).conditional(x, evidence_mask=obs,
                                             generator=torch.Generator().manual_seed(0))
    other, _ = SamplingQuery(cc).conditional(x, evidence_mask=obs,
                                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(samples, again) and not torch.equal(samples, other)


def test_tucker_entries_go_through_the_routing_ops(monkeypatch):
    """MAP calls ``tropical_tucker2`` and ``route_tucker2`` once per arity-2
    Tucker entry; sampling calls ``route_tucker2`` once per entry and never
    the tropical op."""
    from cirkit_tpu_torch.backend.torch.optimized import TorchTuckerLayer

    _, _, cc = _image()
    n_tucker = sum(isinstance(l, TorchTuckerLayer) and l.arity == 2 for l in cc.layers)
    assert n_tucker > 0
    calls = collections.Counter()
    for name in ("tropical_tucker2", "route_tucker2"):
        fn = getattr(Q, name)
        monkeypatch.setattr(Q, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.update([_n]), _fn(*a, **k))[1])
    x, obs, _ = _batch()
    MAPQuery(cc)(x, evidence_mask=obs)
    assert calls == {"tropical_tucker2": n_tucker, "route_tucker2": n_tucker}
    calls.clear()
    SamplingQuery(cc)(3, generator=torch.Generator().manual_seed(0))
    assert calls == {"route_tucker2": n_tucker}


# --------------------------------------------------------------------------- #
# Against JAX's Pallas kernels in float32
# --------------------------------------------------------------------------- #


def test_queries_match_jax_pallas_float32(monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    jcc, jstore, cc = _image(k=16, dtype=jnp.float32)
    assert all(v.dtype == torch.float32 for v in cc.default_store.values())
    x, obs, marg = _batch()
    xj = jnp.asarray(x, jnp.int32)
    want = JQ.IntegrateQuery(jcc)(xj, integrate_vars=obs, store=jstore)
    got = IntegrateQuery(cc)(x, integrate_vars=obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for mg in (None, marg):
        ja, jv = JQ.MAPQuery(jcc)(xj, evidence_mask=obs, marginalize_vars=mg, store=jstore)
        a, v = MAPQuery(cc)(x, evidence_mask=obs, marginalize_vars=mg)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    _, jle = JQ.SamplingQuery(jcc).conditional(xj, evidence_mask=obs,
                                               key=jax.random.PRNGKey(0), store=jstore)
    _, le = SamplingQuery(cc).conditional(x, evidence_mask=obs,
                                          generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(le.numpy(), np.asarray(jle), rtol=1e-5)


# --------------------------------------------------------------------------- #
# Against enumeration
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("product,fold,optimize", [
    ("hadamard", False, False), ("hadamard", True, False), ("kronecker", True, True),
])
def test_sampling_frequencies_match_enumeration(product, fold, optimize):
    sc, _, _, cc = _compile_both(lambda S, Sc, rng: _mixture_pc(S, Sc, rng, product), 24,
                                 fold=fold, optimize=optimize)
    n = 20000
    samples, mixtures = SamplingQuery(cc)(n, generator=torch.Generator().manual_seed(0))
    assert samples.shape == (n, 2) and len(mixtures) >= 1
    worlds = enumerate_worlds(2, 2)
    probs = eval_circuit(sc, worlds)[:, 0, 0]
    _frequencies_match(samples, worlds, probs / probs.sum(), n)


def test_conditional_sampling_matches_posterior_frequencies():
    sc, _, _, cc = _compile_both(_deep_pc, 50)
    n = 6000
    x = np.zeros((n, 4), np.int64)
    x[:, 0] = 1
    mask = np.zeros(4, bool)
    mask[0] = True
    samples, log_ev = SamplingQuery(cc).conditional(
        x, evidence_mask=mask, generator=torch.Generator().manual_seed(0))
    samples = samples.numpy().astype(int)
    assert (samples[:, 0] == 1).all()
    worlds = enumerate_worlds(4, 2)
    joint = eval_circuit(sc, worlds)[:, 0, 0]
    keep = worlds[:, 0] == 1
    np.testing.assert_allclose(log_ev.numpy(), np.log(joint[keep].sum()), rtol=1e-9)
    _frequencies_match(samples[:, 1:], worlds[keep][:, 1:], joint[keep] / joint[keep].sum(), n)


@pytest.mark.parametrize("optimize", [False, True])
def test_map_through_collapsed_sums_matches_enumeration(optimize):
    sc, _, _, cc = _compile_both(_collapsed_pc, 7, optimize=optimize)
    if optimize:  # the collapse fired, or this test is vacuous
        assert any(isinstance(n, TorchMatMulParameter)
                   for e in cc._entries if hasattr(e.layer, "weight")
                   for n in e.layer.weight._ordering)
    want_asg, want_val = mpe_by_enumeration(sc, 3)
    asg, val = MAPQuery(cc)()
    np.testing.assert_allclose(float(val[0]), np.log(want_val), rtol=1e-9)
    np.testing.assert_array_equal(asg[0].numpy().astype(int), want_asg)


def test_map_conditional_matches_restricted_enumeration():
    sc, _, _, cc = _compile_both(_deep_pc, 32)
    x = np.zeros((2, 4), np.int64)
    x[:, 0] = [0, 1]
    mask = np.zeros((2, 4), bool)
    mask[:, 0] = True
    asg, val = MAPQuery(cc)(x, evidence_mask=mask)
    for b in range(2):
        want_asg, want_val = mpe_by_enumeration(sc, 2, observed=np.array([x[b, 0], -1, -1, -1]))
        np.testing.assert_array_equal(asg[b].numpy().astype(int), want_asg)
        np.testing.assert_allclose(float(val[b]), np.log(want_val), rtol=1e-9)


def test_max_weight_guards_non_matmul_consumers():
    rng = np.random.default_rng(7)
    j, i, o = 3, 4, 2
    w1v, w2v = rng.uniform(0.1, 1.0, (1, j, i)), rng.uniform(0.1, 1.0, (1, o, j))
    store = {"w1": torch.as_tensor(w1v), "w2": torch.as_tensor(w2v)}

    def slot(name, shape):
        return TorchTensorSlot(name, shape, dtype=torch.float64, learnable=True, inits=[None],
                               origins=[None])

    s1, s2 = slot("w1", (j, i)), slot("w2", (o, j))
    mm = TorchMatMulParameter((j, i), (o, j))
    plain = TorchParameter([s1, s2, mm], {mm: [s1, s2]}, [mm])
    want = (w2v[0][:, :, None] * w1v[0][None, :, :]).max(axis=1)
    np.testing.assert_allclose(Q._max_weight(plain, store)[0].numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(plain(store)[0].numpy(), w2v[0] @ w1v[0], rtol=1e-12)
    sm = TorchSoftmaxParameter((o, i), axis=-1)
    guarded = TorchParameter([s1, s2, mm, sm], {mm: [s1, s2], sm: [mm]}, [sm])
    with pytest.raises(NotImplementedError, match="MatMul feeds"):
        Q._max_weight(guarded, store)


# --------------------------------------------------------------------------- #
# Missing-data training against JAX
# --------------------------------------------------------------------------- #


def test_missing_data_fit_step_matches_jax_float64():
    kw = dict(input_layer="categorical", num_input_units=4, sum_product_layer="cp",
              num_sum_units=4)
    jctx = JaxPipelineContext(**FLAGS)
    jcc = jctx.compile(jax_image_data((1, 4, 4), "quad-graph", **kw))
    ctx = PipelineContext(**FLAGS, device="cpu", seed=0)
    cc = ctx.compile(image_data((1, 4, 4), "quad-graph", **kw))
    jstore = _carry(jctx, ctx, jnp.float64)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (32, 16))
    data[rng.random((32, 16)) < 0.3] = -1
    kw = dict(batch_size=32, shuffle=False, missing=-1)
    jnew, jlosses = jax_fit(jcc, data, store=jstore, optimizer=optax.adam(1e-2), **kw)
    new, losses = fit(cc, data, store=dict(ctx.parameters), **kw)
    assert len(losses) == len(jlosses) == 1
    np.testing.assert_allclose(losses, jlosses, rtol=1e-9)
    for s, v in new.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jnew[s]), rtol=1e-7, atol=1e-9,
                                   err_msg=s)
    # the marginal NLL: fewer observed entries, a smaller loss than complete data
    _, complete = fit(cc, np.where(data < 0, 0, data), store=dict(ctx.parameters),
                      batch_size=32, shuffle=False)
    assert losses[0] < complete[0]


def test_missing_data_step_and_fit_validate():
    _, _, cc = _image(k=4)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    step = data_parallel_step(cc, opt, marginalize_missing=True)
    with pytest.raises(TypeError, match="missing mask"):
        step({}, dict(cc.default_store), torch.zeros((2, 16), dtype=torch.int64))
    with pytest.raises(ValueError, match="default NLL"):
        data_parallel_step(cc, opt, marginalize_missing=True, loss_fn=torch.mean)
    with pytest.raises(ValueError, match="floating-point"):
        fit(cc, np.zeros((4, 16), np.int64), batch_size=4, missing="nan")
    nan = np.zeros((4, 16))
    nan[0, 3] = np.nan
    _, losses = fit(cc, nan, store=dict(cc.default_store), batch_size=4, missing=float("nan"))
    assert np.isfinite(losses).all()


# --------------------------------------------------------------------------- #
# Errors and what is left out
# --------------------------------------------------------------------------- #


def test_query_errors_and_left_out_options():
    _, _, cc = _image(k=4)
    q = MAPQuery(cc)
    with pytest.raises(ValueError, match="evidence_mask"):
        q(np.zeros((1, 16), np.int64))
    with pytest.raises(ValueError, match="boolean"):
        q(np.zeros((1, 16), np.int64), evidence_mask=np.zeros((1, 16), np.int64))
    with pytest.raises(ValueError, match="requires an input batch"):
        q(evidence_mask=np.zeros((1, 16), bool))
    with pytest.raises(ValueError, match="both observed"):
        q(np.zeros((1, 16), np.int64), evidence_mask=Scope([0]), marginalize_vars=Scope([0]))
    with pytest.raises(ValueError, match="root unit"):
        q(unit=1)
    with pytest.raises(ValueError, match="root output"):
        q(output=1)
    # top_k is supported (tests/test_torch_topk.py); its own errors remain
    with pytest.raises(ValueError, match="top_k"):
        q(top_k=0)
    with pytest.raises(NotImplementedError, match="marginalize_vars"):
        q(np.zeros((1, 16), np.int64), evidence_mask=Scope([0]), marginalize_vars=Scope([1]),
          top_k=2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        MAPQuery(cc, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        SamplingQuery(cc, mesh=object())
    with pytest.raises(ValueError, match="positive"):
        SamplingQuery(cc)(0)
    iq = IntegrateQuery(cc)
    x = np.zeros((2, 16), np.int64)
    with pytest.raises(ValueError, match="subset"):
        iq(x, integrate_vars=Scope([99]))
    with pytest.raises(ValueError, match="batch size"):
        iq(x, integrate_vars=[Scope([0])] * 3)
    with pytest.raises(ValueError, match="variables"):
        iq(x, integrate_vars=np.zeros((1, 7), bool))
    with pytest.raises(ValueError, match="together"):
        iq(x, integrate_vars=Scope([0]), soft_vars=Scope([1]))

    kw = dict(input_layer="categorical", num_input_units=4, sum_product_layer="tucker",
              num_sum_units=4)
    ctx = PipelineContext(semiring="sum-product", fold=True, optimize=True, device="cpu", seed=0)
    sp = ctx.compile(image_data((1, 4, 4), "quad-tree-2", **kw))
    with pytest.raises(ValueError, match="lse-sum"):
        MAPQuery(sp)
    # the dense sampler serves sum-product (tests/test_torch_sampling_dense.py)
    samples, mixtures = SamplingQuery(sp)(2, generator=torch.Generator().manual_seed(0))
    assert samples.shape == (2, 16) and len(mixtures) == sum(
        type(l).__name__ in ("TorchSumLayer", "TorchTuckerLayer") for l in sp.layers)
    with pytest.raises(ValueError, match="lse-sum"):
        SamplingQuery(sp).conditional(x, evidence_mask=Scope([0]))


def test_pad_batch_to_slices_back():
    _, _, cc = _image(k=4)
    x, obs, _ = _batch(n=5)
    a, v = MAPQuery(cc)(x, evidence_mask=obs)
    ap, vp = MAPQuery(cc)(x, evidence_mask=obs, pad_batch_to=4)
    assert ap.shape == (5, 16)
    torch.testing.assert_close(ap, a, rtol=0, atol=0)
    torch.testing.assert_close(vp, v, rtol=0, atol=0)
    got = IntegrateQuery(cc)(x, integrate_vars=obs, pad_batch_to=8)
    torch.testing.assert_close(got, IntegrateQuery(cc)(x, integrate_vars=obs))
