"""The port's ensemble learners (``cirkit_tpu_torch.models.ensembles``)
against the JAX package's (``cirkit_tpu.models.ensembles``), on the CPU in
float64.

The cases of ``tests/models/test_ensembles.py``, with both packages given
the same components: each stage's ``tabular_data`` circuit has every
parameter re-initialized to constants drawn from ``default_rng(t)``, so the
two packages start every stage from the same values. The stages train on
one batch (``batch_size >= len(data)``), so the shuffle order of the two
``fit``s (``torch.randperm`` here, ``jax.random`` there) does not enter
beyond rounding. Then:

- bagging's bootstrap counts equal JAX's for ``PRNGKey(seed)`` exactly;
- boosting accepts the same stages with the same ``weights``, exactly, and
  ``stage_lls`` (and bagging's) match at rtol 1e-8;
- the served circuit's per-row log-likelihood is the blend of the
  components' normalized ones, and its log Z is 0;
- the validation errors are JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from cirkit_tpu.models import bag_mixture as jax_bag
from cirkit_tpu.models import boost_mixture as jax_boost
from cirkit_tpu.models import tabular_data as jax_tabular_data
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch import IntegrateQuery
from cirkit_tpu.symbolic import ConstantTensorInitializer as JConst
from cirkit_tpu.symbolic.parameters import TensorParameter as JTensor
from cirkit_tpu_torch.models import BoostResult, bag_mixture, boost_mixture, tabular_data
from cirkit_tpu_torch.models.ensembles import _per_sample_ll
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.symbolic import ConstantTensorInitializer as TConst
from cirkit_tpu_torch.symbolic.parameters import TensorParameter as TTensor
from cirkit_tpu_torch.utils import Scope


@pytest.fixture(autouse=True)
def float64_default():
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _factory(port, units=2, cats=4, d=3, em_ready=False):
    """Fresh stage circuits whose parameters are constants from
    ``default_rng(t)``: positive rows that sum to 1 (plain weights for EM,
    logits under a softmax otherwise)."""
    make, tensor, const = ((tabular_data, TTensor, TConst) if port
                           else (jax_tabular_data, JTensor, JConst))

    def factory(t):
        sc = make(
            "random-binary-tree",
            num_features=d,
            input_layers={"name": "categorical", "args": {"num_categories": cats}},
            num_input_units=units,
            sum_product_layer="cp",
            num_sum_units=units,
            em_ready=em_ready,
        )
        rng = np.random.default_rng(t)
        for sl in sc.layers:
            for p in sl.params.values():
                for n in p.nodes:
                    if isinstance(n, tensor):
                        v = rng.uniform(0.1, 1.0, n.shape)
                        n.initializer = const(v / v.sum(axis=-1, keepdims=True))
        return sc

    return factory


def _bimodal_data(n=512, d=3, cats=4, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2, size=(n // 2, d))
    hi = rng.integers(cats - 2, cats, size=(n - n // 2, d))
    return np.concatenate([lo, hi])


def _ctx(seed=0):
    return PipelineContext(semiring="lse-sum", fold=True, device="cpu", seed=seed)


def _jctx():
    return JaxPipelineContext(semiring="lse-sum", fold=True)


def _assert_serves_blend(res: BoostResult, data):
    """The served circuit's log-likelihood is the blend of the components'
    normalized ones with the returned weights, and it is normalized."""
    per_comp = np.stack([_per_sample_ll(c, res.store, data[:64], 64) for c in res.components])
    want = np.log(np.exp(per_comp).T @ res.weights)
    if len(res.components) > 1:
        with torch.inference_mode():
            got = res.circuit(res.store, torch.as_tensor(data[:64])).reshape(64, -1)[:, 0]
        z = IntegrateQuery(res.circuit)(data[:1], integrate_vars=Scope(res.circuit.scope),
                                        store=res.store)
        np.testing.assert_allclose(float(z.reshape(-1)[0]), 0.0, atol=1e-12)
        got = got.numpy()
    else:
        got = _per_sample_ll(res.circuit, res.store, data[:64], 64)
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_bootstrap_generator_equals_jax_key_bits(seed):
    """``default_rng([0, seed])`` is the generator JAX seeds from
    ``PRNGKey(seed)``'s raw bits, so the bootstrap counts are JAX's."""
    key = jax.random.PRNGKey(seed)
    jrng = np.random.default_rng(np.asarray(jax.random.key_data(key)).astype(np.uint32).tolist())
    rng = np.random.default_rng([0, seed])
    for n in (7, 256):
        np.testing.assert_array_equal(rng.multinomial(n, np.full(n, 1.0 / n)),
                                      jrng.multinomial(n, np.full(n, 1.0 / n)))


@pytest.mark.parametrize("method", ["adam", "em"])
def test_boosting_matches_jax_and_serves_exact_blend(method):
    data = _bimodal_data(n=256)
    valid = _bimodal_data(n=128, seed=1)
    kw = dict(num_stages=3, method=method, num_epochs=6 if method == "adam" else 3,
              batch_size=256, valid_data=valid)
    em = method == "em"
    res = boost_mixture(_factory(True, em_ready=em), data, ctx=_ctx(), seed=4, **kw)
    jres = jax_boost(_factory(False, em_ready=em), data, ctx=_jctx(),
                     key=jax.random.PRNGKey(4), **kw)
    assert len(res.components) == len(jres.components) >= 2
    np.testing.assert_array_equal(res.weights, jres.weights)
    np.testing.assert_allclose(res.stage_lls, jres.stage_lls, rtol=1e-8)
    # accepted stages never decrease the eval LL
    assert all(b >= a - 1e-9 for a, b in zip(res.stage_lls, res.stage_lls[1:]))
    assert res.weights.sum() == pytest.approx(1.0)
    _assert_serves_blend(res, data)
    # the served circuit's log-likelihoods are JAX's
    with torch.inference_mode():
        got = res.circuit(res.store, torch.as_tensor(data[:32])).numpy().reshape(32, -1)[:, 0]
    want = np.asarray(jres.circuit(jres.store, data[:32])).reshape(32, -1)[:, 0]
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_boosting_early_stops_on_huge_tol():
    data = _bimodal_data(n=256)
    res = boost_mixture(_factory(True), data, ctx=_ctx(5), num_stages=4, num_epochs=4,
                        batch_size=256, tol=1e6)
    jres = jax_boost(_factory(False), data, ctx=_jctx(), num_stages=4, num_epochs=4,
                     batch_size=256, tol=1e6)
    assert len(res.components) == len(jres.components) == 1
    assert len(res.stage_lls) == 1
    np.testing.assert_allclose(res.stage_lls, jres.stage_lls, rtol=1e-8)
    # single-stage result is the bare component, still servable
    ll = _per_sample_ll(res.circuit, res.store, data[:16], 16)
    assert np.all(np.isfinite(ll))


@pytest.mark.parametrize("method", ["adam", "em"])
def test_bagging_matches_jax_and_serves_exact_uniform_blend(method):
    data = _bimodal_data(n=256)
    em = method == "em"
    kw = dict(num_components=3, method=method, num_epochs=4 if method == "adam" else 2,
              batch_size=256)
    res = bag_mixture(_factory(True, em_ready=em), data, ctx=_ctx(7), seed=9, **kw)
    jres = jax_bag(_factory(False, em_ready=em), data, ctx=_jctx(),
                   key=jax.random.PRNGKey(9), **kw)
    assert len(res.components) == 3
    np.testing.assert_allclose(res.weights, 1.0 / 3)
    np.testing.assert_array_equal(res.weights, jres.weights)
    np.testing.assert_allclose(res.stage_lls, jres.stage_lls, rtol=1e-8)
    _assert_serves_blend(res, data)
    # members see different bootstrap weights: identical starts, distinct fits
    a = _per_sample_ll(res.components[0], res.store, data[:64], 64)
    b = _per_sample_ll(res.components[1], res.store, data[:64], 64)
    assert not np.allclose(a, b)


def test_bagging_resamples_differ_with_identical_starts():
    """Members built from the same constants still train differently: the
    bootstrap weights differ between stages."""
    data = _bimodal_data(n=256)
    same = _factory(True)
    res = bag_mixture(lambda t: same(0), data, ctx=_ctx(13), num_components=2, num_epochs=6,
                      batch_size=256)
    a = _per_sample_ll(res.components[0], res.store, data[:64], 64)
    b = _per_sample_ll(res.components[1], res.store, data[:64], 64)
    assert not np.allclose(a, b), "bootstrap members trained identically"


def test_bagging_single_component_and_errors():
    data = _bimodal_data(n=128)
    res = bag_mixture(_factory(True), data, ctx=_ctx(9), num_components=1, num_epochs=2,
                      batch_size=64)
    assert len(res.components) == 1
    ll = _per_sample_ll(res.circuit, res.store, data[:16], 16)
    assert np.all(np.isfinite(ll))
    with pytest.raises(ValueError, match="num_components must be >= 1, found 0"):
        bag_mixture(_factory(True), data, num_components=0)
    with pytest.raises(ValueError, match="method must be 'adam' or 'em', found 'sgd'"):
        bag_mixture(_factory(True), data, method="sgd")


def test_ensembles_reject_aliased_components():
    """A factory that returns one symbolic circuit every stage shares its
    slots across stages: rejected, as in the JAX package."""
    data = _bimodal_data(n=64)
    sc = _factory(True)(0)
    with pytest.raises(ValueError, match="ensemble stage 1 shares parameter slots"):
        bag_mixture(lambda t: sc, data, ctx=_ctx(), num_components=2, num_epochs=1,
                    batch_size=64)
    jsc = _factory(False)(0)
    with pytest.raises(ValueError, match="ensemble stage 1 shares parameter slots"):
        jax_bag(lambda t: jsc, data, ctx=_jctx(), num_components=2, num_epochs=1,
                batch_size=64)


def test_boosting_validation_errors():
    data = _bimodal_data(n=64)
    with pytest.raises(ValueError, match="num_stages must be >= 1, found 0"):
        boost_mixture(_factory(True), data, num_stages=0)
    with pytest.raises(ValueError, match="method must be 'adam' or 'em', found 'sgd'"):
        boost_mixture(_factory(True), data, method="sgd")
    with pytest.raises(ValueError, match="alpha_grid entries must lie strictly inside"):
        boost_mixture(_factory(True), data, ctx=_ctx(), alpha_grid=np.array([0.0, 0.5]))


def test_normalized_mixture_weights_reject_out_of_range_log_z():
    from cirkit_tpu.models.ensembles import _normalized_mixture_weights as jnorm
    from cirkit_tpu_torch.models.ensembles import _normalized_mixture_weights as norm

    w = np.array([0.25, 0.75])
    np.testing.assert_array_equal(norm(w, np.array([1.0, -2.0])),
                                  jnorm(w, np.array([1.0, -2.0])))
    for fn in (norm, jnorm):
        with pytest.raises(ValueError, match="partition function is out of float range"):
            fn(w, np.array([0.0, 1e4]))


def test_default_context_is_the_card():
    """Without ``ctx``, the ensemble compiles on the CUDA card, as every
    entry point of the port: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        boost_mixture(_factory(True), _bimodal_data(n=64), num_stages=1)
