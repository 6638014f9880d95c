"""The port's structural pruning and growing, and the grow/prune loop
(``cirkit_tpu_torch.backend.torch.pruning``), against the JAX package's
(``cirkit_tpu.backend.jax.pruning``), on the CPU in float64.

Every case of ``tests/backend/test_pruning.py`` and ``test_growing.py`` is
mirrored. Each circuit is built once with the JAX package and carried into
the port by pickle (``load_circuit``'s class map), so both packages see the
same layer graph; the JAX store goes into the port by slot name in float64.
Then:

- the reports (``units_*``, ``per_layer``) are equal exactly, and the rebuilt
  circuits' constants at rtol 1e-9 (each is the trained values sliced at the
  kept or gathered units, whose rows differ by far more, so this pins the
  unit indices exactly);
- the rebuilt circuits, compiled afresh in each package, agree on their
  forwards at rtol 1e-9 (and, for the lossless cases, with the original);
- the data-aware scores (``_flow_importance``) agree at rtol 1e-9;
- a seeded ``noise > 0`` grow equals JAX's;
- the validation errors have JAX's types and messages;
- ``grow_prune_loop`` gives JAX's history (labels and units exactly, the
  log-likelihoods at rtol 1e-8), also resumed from a checkpoint directory
  the JAX package wrote.

The port's compiled constants take the ambient real dtype, so every test
here runs with float64 as the default (the JAX package runs under x64).
"""

import io
import json
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cirkit_tpu.parallel as jax_parallel
import cirkit_tpu_torch.parallel as port_parallel
from cirkit_tpu.backend.jax import pruning as JP
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.models import tabular_data as jax_tabular_data
from cirkit_tpu.parallel import fit_em as jax_fit_em
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch import pruning as TP
from cirkit_tpu_torch.parallel import fit_em
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils.checkpoint import _PortUnpickler
from tests.fixtures import (
    build_bivariate_categorical_pc,
    build_bivariate_gaussian_pc,
    build_multivariate_categorical_pc,
    const_param,
)
from tests.reference_eval import enumerate_worlds

RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(autouse=True)
def float64_default():
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


# --------------------------------------------------------------------------- #
# Helpers
# --------------------------------------------------------------------------- #


def to_port(sc):
    """A JAX symbolic circuit as the port's: the same graph, by pickle."""
    return _PortUnpickler(io.BytesIO(pickle.dumps(sc))).load()


def pair(jsc, *, seed=42, **flags):
    """The JAX circuit compiled in a JAX context and its port copy in a CPU
    port context holding the JAX store in float64:
    ``(jctx, jcc, psc, ctx, cc)``."""
    flags = {"semiring": "lse-sum", "fold": True, **flags}
    jctx = JaxPipelineContext(seed=seed, **flags)
    jcc = jctx.compile(jsc)
    psc = to_port(jsc)
    ctx = PipelineContext(device="cpu", **flags)
    cc = ctx.compile(psc)
    ctx.load_parameters({s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()})
    return jctx, jcc, psc, ctx, cc


def _values(p) -> list[np.ndarray]:
    """The constant values of a symbolic parameter's input nodes (random
    initializers have none: the stores carry those)."""
    out = []
    for node in p.nodes:
        init = getattr(node, "initializer", None)
        if hasattr(init, "value"):
            out.append(np.asarray(init.value))
        elif init is None and hasattr(node, "value"):
            out.append(np.asarray(node.value))
    return out


def assert_same_circuit(jsc, psc, rtol=RTOL):
    """The same layer types, widths, arities, scopes and wiring, and the
    same constants (at ``rtol``), layer by layer in topological order."""
    jt, pt = list(jsc.topological_ordering()), list(psc.topological_ordering())
    assert [type(a).__name__ for a in jt] == [type(b).__name__ for b in pt]
    jpos, ppos = {l: i for i, l in enumerate(jt)}, {l: i for i, l in enumerate(pt)}
    for a, b in zip(jt, pt):
        assert a.num_output_units == b.num_output_units
        assert getattr(a, "arity", None) == getattr(b, "arity", None)
        assert tuple(getattr(a, "scope", ())) == tuple(getattr(b, "scope", ()))
        assert [jpos[c] for c in jsc.layer_inputs(a)] == [ppos[c] for c in psc.layer_inputs(b)]
        assert sorted(a.params) == sorted(b.params)
        for name in a.params:
            for va, vb in zip(_values(a.params[name]), _values(b.params[name]), strict=True):
                assert va.shape == vb.shape
                np.testing.assert_allclose(vb, va, rtol=rtol, atol=ATOL)
    assert [jpos[o] for o in jsc.outputs] == [ppos[o] for o in psc.outputs]


def _dist(cc, store, x):
    if isinstance(cc, torch.nn.Module):
        with torch.no_grad():
            return cc(store, torch.as_tensor(x)).numpy()[:, 0, :]
    return np.asarray(cc.evaluate(store, jnp.asarray(x)))[:, 0, :]


def fresh_both(jsc, psc, x, **flags):
    """Each rebuilt circuit compiled in a fresh context of its package and
    evaluated on ``x``; the two held to each other at rtol 1e-9."""
    flags = {"semiring": "lse-sum", "fold": True, **flags}
    jctx = JaxPipelineContext(**flags)
    jcc = jctx.compile(jsc)
    ctx = PipelineContext(device="cpu", **flags)
    cc = ctx.compile(psc)
    want, got = _dist(jcc, jctx.parameters, x), _dist(cc, ctx.parameters, x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return got


def prune_both(jsc, jctx, psc, ctx, **kw):
    jp, jr = JP.prune_circuit(jsc, ctx=jctx, **kw)
    pp, pr = TP.prune_circuit(psc, ctx=ctx, **kw)
    assert pr == jr
    assert_same_circuit(jp, pp)
    return jp, pp, pr


def grow_both(jsc, jctx, psc, ctx, **kw):
    jg, jr = JP.grow_circuit(jsc, ctx=jctx, **kw)
    pg, pr = TP.grow_circuit(psc, ctx=ctx, **kw)
    assert pr == jr
    assert_same_circuit(jg, pg)
    return jg, pg, pr


# --------------------------------------------------------------------------- #
# Pruning (tests/backend/test_pruning.py)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("product", ["hadamard", "kronecker"])
def test_prune_threshold_zero_is_lossless(product):
    jsc = build_bivariate_categorical_pc(product=product, rng=np.random.default_rng(70))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    worlds = enumerate_worlds(2, 3)
    want = _dist(cc, ctx.parameters, worlds)
    jp, pp, rep = prune_both(jsc, jctx, psc, ctx, threshold=0.0)
    assert rep["units_after"] == rep["units_before"]
    np.testing.assert_allclose(fresh_both(jp, pp, worlds), want, rtol=RTOL, atol=ATOL)


def test_prune_threshold_zero_lossless_deep_and_gaussian():
    jsc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(71))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    worlds = enumerate_worlds(4, 2)
    want = _dist(cc, ctx.parameters, worlds)
    jp, pp, _ = prune_both(jsc, jctx, psc, ctx, threshold=0.0)
    np.testing.assert_allclose(fresh_both(jp, pp, worlds), want, rtol=RTOL, atol=ATOL)

    jscg = build_bivariate_gaussian_pc(num_units=3, rng=np.random.default_rng(72))
    jctx, jcc, psc, ctx, cc = pair(jscg)
    x = np.random.default_rng(0).normal(size=(7, 2))
    want = _dist(cc, ctx.parameters, x)
    jp, pp, _ = prune_both(jscg, jctx, psc, ctx, threshold=0.0)
    np.testing.assert_allclose(fresh_both(jp, pp, x), want, rtol=RTOL, atol=ATOL)


def _mixture_of_three(w, peaked=False, seed=73):
    """Two ternary leaves of 3 units, a Hadamard and a single-unit sum with
    weight ``w`` (``peaked``: unit c puts 0.98 on state c)."""
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, HadamardLayer, SumLayer
    from cirkit_tpu.utils import Scope

    rng = np.random.default_rng(seed)
    k = 3
    leaves = []
    for v in range(2):
        if peaked:
            p = np.full((k, 3), 0.01)
            for c in range(k):
                p[c, c] = 0.98
            p = p / p.sum(1, keepdims=True)
        else:
            p = rng.dirichlet(np.ones(3), size=k)
        leaves.append(CategoricalLayer(Scope([v]), k, num_categories=3, probs=const_param(p)))
    prod = HadamardLayer(k, arity=2)
    root = SumLayer(k, 1, weight=const_param(w))
    return Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def test_prune_drops_dead_units_distribution_unchanged():
    jsc = _mixture_of_three(np.array([[0.6, 1e-12, 0.4]]))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    worlds = enumerate_worlds(2, 3)
    want = _dist(cc, ctx.parameters, worlds)
    jp, pp, rep = prune_both(jsc, jctx, psc, ctx, threshold=1e-6)
    assert rep["units_after"] < rep["units_before"]
    np.testing.assert_allclose(fresh_both(jp, pp, worlds), want, rtol=RTOL)
    assert [(b, a) for name, b, a in rep["per_layer"] if name == "HadamardLayer"] == [(3, 2)]


def _image(spl="tucker", k=8, em_ready=False):
    return jax_image_data((1, 4, 4), "quad-tree-2", input_layer="categorical",
                          num_input_units=k, sum_product_layer=spl, num_sum_units=k,
                          em_ready=em_ready)


def test_prune_fraction_through_optimized_context():
    """``test_pruning.py``'s slow case: the readback from a context that
    compiled the circuit optimized (fused Tucker plans), and the kept sets of
    a K=8 Tucker template pruned by half, equal to JAX's."""
    jsc = _image()
    jctx, jcc, psc, ctx, cc = pair(jsc, seed=21, optimize=True)
    x = np.random.default_rng(1).integers(0, 256, size=(5, 16))
    base_ll = _dist(cc, ctx.parameters, x)[:, 0]
    jp, pp, rep = prune_both(jsc, jctx, psc, ctx, fraction=0.5)
    assert rep["units_after"] < rep["units_before"]
    ll = fresh_both(jp, pp, x, optimize=True)[:, 0]
    assert np.isfinite(ll).all() and np.all(ll <= base_ll + 1e-6)
    assert np.all(base_ll - ll < 40.0)


def test_pruned_circuit_is_em_trainable():
    """A threshold-0 prune trains identically to the original circuit, in the
    port as in JAX."""
    jsc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(74))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    data = np.random.default_rng(2).integers(0, 2, size=(64, 4))
    _, control = fit_em(cc, data, store=ctx.parameters, num_epochs=3, batch_size=32)
    _, jcontrol = jax_fit_em(jcc, data, store=jctx.parameters, num_epochs=3, batch_size=32)
    np.testing.assert_allclose(control, jcontrol, rtol=RTOL)

    jp, pp, _ = prune_both(jsc, jctx, psc, ctx, threshold=0.0)
    ctx2 = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    cc2 = ctx2.compile(pp)
    _, losses = fit_em(cc2, data, store=ctx2.parameters, num_epochs=3, batch_size=32)
    np.testing.assert_allclose(losses, control, rtol=RTOL)
    assert losses[2] <= losses[1] + 1e-9


def test_prune_requires_exactly_one_mode():
    jsc = build_bivariate_categorical_pc(rng=np.random.default_rng(75))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    for kw in ({}, {"threshold": 0.1, "fraction": 0.5}):
        with pytest.raises(ValueError) as want:
            JP.prune_circuit(jsc, ctx=jctx, **kw)
        with pytest.raises(ValueError) as got:
            TP.prune_circuit(psc, ctx=ctx, **kw)
        assert str(got.value) == str(want.value) and "Exactly one" in str(got.value)


def test_prune_requires_compiled_context():
    jsc = build_bivariate_categorical_pc(rng=np.random.default_rng(76))
    with pytest.raises(ValueError) as want:
        JP.prune_circuit(jsc, ctx=JaxPipelineContext(semiring="lse-sum", fold=True),
                         threshold=0.0)
    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    with pytest.raises(ValueError) as got:
        TP.prune_circuit(to_port(jsc), ctx=ctx, threshold=0.0)
    assert str(got.value) == str(want.value) and "Compile the circuit" in str(got.value)


def test_flow_importance_prunes_data_unused_branch():
    """``test_pruning.py``'s slow case: the usage flows equal JAX's, the
    data-unused branch is pruned although its weight is the largest, and
    the weight-based score keeps it."""
    jsc = _mixture_of_three(np.array([[0.2, 0.2, 0.6]]), peaked=True)
    jctx, jcc, psc, ctx, cc = pair(jsc)
    data = np.concatenate([np.zeros((40, 2)), np.ones((40, 2))]).astype(np.int64)
    want = JP._flow_importance(jsc, jctx, jctx.parameters, data, batch_size=64)
    got = TP._flow_importance(psc, ctx, ctx.parameters, data, batch_size=64)
    jt, pt = list(jsc.topological_ordering()), list(psc.topological_ordering())
    for a, b in zip(jt, pt):
        np.testing.assert_allclose(got[b], want[a], rtol=RTOL, atol=1e-15)
    s_prod = got[pt[-2]]
    assert s_prod[2] < 0.01 < min(s_prod[0], s_prod[1])
    np.testing.assert_allclose(s_prod.sum(), 1.0, rtol=1e-5)

    jp, pp, _ = prune_both(jsc, jctx, psc, ctx, fraction=1 / 3, data=data)
    ll_full = _dist(cc, ctx.parameters, data)[:, 0].mean()
    ll_pruned = fresh_both(jp, pp, data)[:, 0].mean()
    assert abs(ll_full - ll_pruned) < 0.05
    jw, pw, _ = prune_both(jsc, jctx, psc, ctx, fraction=1 / 3)
    assert ll_pruned > fresh_both(jw, pw, data)[:, 0].mean() + 0.1


@pytest.mark.parametrize("spl", ["tucker", "cp"])
def test_flow_importance_of_a_template_matches_jax(spl):
    """The usage flows of every layer of a softmax-weighted 4x4 template
    (Kronecker or Hadamard products, the kernels' dx-only backward on the
    dense entries), over batches with a ragged last one, and the prune by
    them: kept sets equal to JAX's."""
    jsc = _image(spl, k=4)
    jctx, jcc, psc, ctx, cc = pair(jsc, seed=3)
    data = np.random.default_rng(4).integers(0, 256, size=(45, 16))
    want = JP._flow_importance(jsc, jctx, jctx.parameters, data, batch_size=16)
    got = TP._flow_importance(psc, ctx, ctx.parameters, data, batch_size=16)
    jt, pt = list(jsc.topological_ordering()), list(psc.topological_ordering())
    assert len(got) == len(want)
    for a, b in zip(jt, pt):
        np.testing.assert_allclose(got[b], want[a], rtol=RTOL, atol=1e-15)
    prune_both(jsc, jctx, psc, ctx, fraction=0.5, data=data, batch_size=16)


def test_flow_importance_requires_lse_sum():
    jsc = build_bivariate_categorical_pc(rng=np.random.default_rng(77))
    jctx, jcc, psc, ctx, cc = pair(jsc, semiring="sum-product")
    data = np.zeros((4, 2), np.int64)
    with pytest.raises(NotImplementedError) as want:
        JP.prune_circuit(jsc, ctx=jctx, threshold=0.0, data=data)
    with pytest.raises(NotImplementedError) as got:
        TP.prune_circuit(psc, ctx=ctx, threshold=0.0, data=data)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# Growing (tests/backend/test_growing.py)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("product", ["hadamard", "kronecker"])
def test_grow_noise_zero_is_lossless(product):
    jsc = build_bivariate_categorical_pc(product=product, rng=np.random.default_rng(80))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    worlds = enumerate_worlds(2, 3)
    want = _dist(cc, ctx.parameters, worlds)
    jg, pg, rep = grow_both(jsc, jctx, psc, ctx, fraction=0.5, noise=0.0)
    assert rep["units_after"] > rep["units_before"]
    np.testing.assert_allclose(fresh_both(jg, pg, worlds), want, rtol=RTOL, atol=ATOL)


def test_grow_noise_zero_lossless_deep_and_gaussian():
    jsc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(81))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    worlds = enumerate_worlds(4, 2)
    want = _dist(cc, ctx.parameters, worlds)
    jg, pg, _ = grow_both(jsc, jctx, psc, ctx, fraction=1.0, noise=0.0)
    np.testing.assert_allclose(fresh_both(jg, pg, worlds), want, rtol=RTOL, atol=ATOL)

    jscg = build_bivariate_gaussian_pc(num_units=3, rng=np.random.default_rng(82))
    jctx, jcc, psc, ctx, cc = pair(jscg)
    x = np.random.default_rng(0).normal(size=(7, 2))
    want = _dist(cc, ctx.parameters, x)
    jg, pg, _ = grow_both(jscg, jctx, psc, ctx, fraction=0.5, noise=0.0)
    np.testing.assert_allclose(fresh_both(jg, pg, x), want, rtol=RTOL, atol=ATOL)


def test_grow_noise_perturbs_but_stays_close():
    """A seeded ``noise > 0`` grow draws JAX's jitter: the same constants."""
    jsc = build_bivariate_categorical_pc(product="hadamard", rng=np.random.default_rng(83))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    worlds = enumerate_worlds(2, 3)
    want = _dist(cc, ctx.parameters, worlds)
    jg, pg, _ = grow_both(jsc, jctx, psc, ctx, fraction=1.0, noise=0.02, seed=7)
    got = fresh_both(jg, pg, worlds)
    np.testing.assert_allclose(got, want, atol=0.15)
    assert not np.allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("noise", [0.0, 0.4])
def test_grow_leaf_families_match_jax(noise):
    """Gaussian, Binomial and Embedding leaves (their own jitter rules) and a
    Kronecker template, grown with and without noise."""
    from cirkit_tpu.symbolic import (
        BinomialLayer,
        Circuit,
        EmbeddingLayer,
        HadamardLayer,
        SumLayer,
    )
    from cirkit_tpu.utils import Scope

    rng = np.random.default_rng(88)
    k = 3
    leaves = [
        BinomialLayer(Scope([0]), k, total_count=5, probs=const_param(rng.uniform(0.2, 0.8, k))),
        EmbeddingLayer(Scope([1]), k, num_states=4,
                       weight=const_param(rng.uniform(0.1, 1.0, (k, 4)))),
    ]
    prod = HadamardLayer(k, arity=2)
    root = SumLayer(k, 1, weight=const_param(rng.dirichlet(np.ones(k))[None]))
    jsc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    jctx, jcc, psc, ctx, cc = pair(jsc)
    x = np.stack([np.arange(6) % 6, np.arange(6) % 4], axis=1)
    jg, pg, _ = grow_both(jsc, jctx, psc, ctx, fraction=0.7, noise=noise, seed=5)
    fresh_both(jg, pg, x)

    jscg = build_bivariate_gaussian_pc(num_units=3, rng=np.random.default_rng(89))
    jctx, jcc, psc, ctx, cc = pair(jscg)
    jg, pg, _ = grow_both(jscg, jctx, psc, ctx, fraction=0.5, noise=noise, seed=6)
    fresh_both(jg, pg, np.random.default_rng(0).normal(size=(5, 2)))

    jsc = _image("tucker", k=4)
    jctx, jcc, psc, ctx, cc = pair(jsc, seed=5, optimize=True)
    jg, pg, _ = grow_both(jsc, jctx, psc, ctx, fraction=0.5, noise=noise, seed=2)
    fresh_both(jg, pg, np.random.default_rng(2).integers(0, 256, (4, 16)), optimize=True)


def test_grow_then_em_recovers_capacity():
    """Grow a converged K=1 model and fine-tune by EM: the port's stores and
    losses are JAX's, and they beat the K=1 fit."""
    rng = np.random.default_rng(84)
    n = 400
    comp = rng.integers(0, 2, size=n)
    x = np.where(comp[:, None] == 0, 0, 2) + rng.integers(0, 1 + 1, size=(n, 2))
    x = np.clip(x, 0, 2).astype(np.int64)

    jsc = build_bivariate_categorical_pc(num_units=1, product="hadamard",
                                         rng=np.random.default_rng(85))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    jstore1, jlosses1 = jax_fit_em(jcc, x, store=jctx.parameters, num_epochs=15)
    store1, losses1 = fit_em(cc, x, store=ctx.parameters, num_epochs=15)
    np.testing.assert_allclose(losses1, jlosses1, rtol=RTOL)

    jg, jr = JP.grow_circuit(jsc, ctx=jctx, store=jstore1, fraction=1.0, noise=0.1, seed=3)
    pg, pr = TP.grow_circuit(psc, ctx=ctx, store=store1, fraction=1.0, noise=0.1, seed=3)
    assert pr == jr and pr["units_after"] > pr["units_before"]
    assert_same_circuit(jg, pg)
    jctx2 = JaxPipelineContext(semiring="lse-sum", fold=True)
    _, jlosses2 = jax_fit_em(jctx2.compile(jg), x, store=jctx2.parameters, num_epochs=25)
    ctx2 = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    _, losses2 = fit_em(ctx2.compile(pg), x, store=ctx2.parameters, num_epochs=25)
    np.testing.assert_allclose(losses2, jlosses2, rtol=RTOL)
    assert losses2[-1] < losses1[-1] - 0.05


def test_grow_prune_roundtrip_lossless():
    jsc = build_bivariate_categorical_pc(product="hadamard", rng=np.random.default_rng(86))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    worlds = enumerate_worlds(2, 3)
    want = _dist(cc, ctx.parameters, worlds)
    jg, pg, _ = grow_both(jsc, jctx, psc, ctx, fraction=0.5, noise=0.0)
    jctx2 = JaxPipelineContext(semiring="lse-sum", fold=True)
    jctx2.compile(jg)
    ctx2 = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    ctx2.compile(pg)
    jp, pp, _ = prune_both(jg, jctx2, pg, ctx2, threshold=0.0)
    np.testing.assert_allclose(fresh_both(jp, pp, worlds), want, rtol=RTOL, atol=ATOL)


def test_grow_validation():
    jsc = build_bivariate_categorical_pc(product="hadamard", rng=np.random.default_rng(87))
    psc = to_port(jsc)
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True)
    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu")

    def same_error(kw, match):
        with pytest.raises(ValueError) as want:
            JP.grow_circuit(jsc, ctx=jctx, **kw)
        with pytest.raises(ValueError) as got:
            TP.grow_circuit(psc, ctx=ctx, **kw)
        assert str(got.value) == str(want.value) and match in str(got.value)

    same_error({}, "Compile the circuit")
    jctx.compile(jsc)
    ctx.compile(psc)
    same_error({"fraction": 0.0}, "fraction")
    same_error({"noise": -1.0}, "noise")


def test_grow_with_data_scores_lossless_at_noise_zero():
    jsc = build_multivariate_categorical_pc(num_variables=3, rng=np.random.default_rng(85))
    jctx, jcc, psc, ctx, cc = pair(jsc)
    worlds = enumerate_worlds(3, 2)
    want = _dist(cc, ctx.parameters, worlds)
    data = worlds[np.random.default_rng(3).integers(0, len(worlds), size=64)]
    jg, pg, rep = grow_both(jsc, jctx, psc, ctx, fraction=0.34, noise=0.0, data=data)
    assert rep["units_after"] > rep["units_before"]
    np.testing.assert_allclose(fresh_both(jg, pg, worlds), want, rtol=RTOL, atol=ATOL)


def test_num_parameters_counts_learnable_tensors():
    for kw in ({"product": "hadamard"}, {"product": "kronecker"}, {"use_softmax": True}):
        jsc = build_bivariate_categorical_pc(**kw)
        assert to_port(jsc).num_parameters == jsc.num_parameters
    assert to_port(build_bivariate_categorical_pc(product="kronecker")).num_parameters == 16


def test_num_parameters_dedupes_shared_and_skips_frozen():
    from cirkit_tpu_torch.symbolic import CategoricalLayer, Circuit, HadamardLayer, SumLayer
    from cirkit_tpu_torch.utils import Scope
    from tests.test_torch_expectation import PORT, const

    S = PORT[0]
    p0 = const(S, np.full((2, 3), 1.0 / 3))
    leaf0 = CategoricalLayer(Scope([0]), 2, num_categories=3, probs=p0)
    leaf1 = CategoricalLayer(Scope([1]), 2, num_categories=3, probs=p0.ref())
    prod = HadamardLayer(2, arity=2)
    frozen = S.Parameter.from_input(S.TensorParameter(
        1, 2, initializer=S.ConstantTensorInitializer(np.full((1, 2), 0.5)), learnable=False))
    out = SumLayer(2, 1, weight=frozen)
    sc = Circuit([leaf0, leaf1, prod, out], {prod: [leaf0, leaf1], out: [prod]}, [out])
    assert sc.num_parameters == 2 * 3


@pytest.mark.parametrize("criterion", ["ll", "aic", "bic"])
def test_selection_score_matches_jax(criterion):
    for args in ((-1.5, 1000, 200), (-0.25, 7, 3), (2.0, 0, 1)):
        assert TP.selection_score(*args, criterion) == JP.selection_score(*args, criterion)
    assert TP.selection_score(-1.5, 1000, 200, "bic") < TP.selection_score(-1.5, 1000, 200, "aic")


def test_selection_score_rejects_unknown_criterion():
    with pytest.raises(ValueError) as want:
        JP.selection_score(0.0, 1, 10, "mdl")
    with pytest.raises(ValueError) as got:
        TP.selection_score(0.0, 1, 10, "mdl")
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# The grow/prune loop
# --------------------------------------------------------------------------- #


def _loop_case():
    """A deliberately small em_ready tabular template (2 units over 6
    four-state variables) and data from 3 latent modes."""
    rng = np.random.default_rng(87)
    protos = rng.integers(0, 4, size=(3, 6))
    lab = rng.integers(0, 3, size=300)
    data = protos[lab]
    data = np.where(rng.random(data.shape) < 0.15, rng.integers(0, 4, data.shape), data)
    jsc = jax_tabular_data(
        "random-binary-tree", num_features=6,
        input_layers={"name": "categorical", "args": {"num_categories": 4}},
        num_input_units=2, sum_product_layer="cp", num_sum_units=2, em_ready=True,
    )
    return jsc, data[:200].astype(np.int64), data[200:].astype(np.int64)


LOOP = dict(rounds=2, grow_fraction=1.0, prune_fraction=0.25, noise=0.6, em_epochs=3,
            batch_size=64, seed=1)


def _run_loops(jsc, train, val, **kw):
    kw = {**LOOP, **kw}
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True, seed=9)
    jctx.compile(jsc)
    psc = to_port(jsc)
    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu", seed=9)
    ctx.compile(psc)
    ctx.load_parameters({s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()})
    jout = JP.grow_prune_loop(jsc, train, ctx=jctx, val_data=val, **kw)
    out = TP.grow_prune_loop(psc, train, ctx=ctx, val_data=val, **kw)
    return jout, out


def _assert_history(got, want, rtol=1e-8):
    assert [h[:2] for h in got] == [tuple(h[:2]) for h in want]
    np.testing.assert_allclose([h[2] for h in got], [h[2] for h in want], rtol=rtol)


def test_grow_prune_loop_matches_jax():
    """``test_growing.py``'s slow loop case at fewer epochs: the history, the
    best circuit and its store equal JAX's, the search beats plain EM, and
    the best store evaluates to the best log-likelihood."""
    from cirkit_tpu_torch.parallel import evaluate_ll

    jsc, train, val = _loop_case()
    (jbest, jstore, jhist), (best, store, hist) = _run_loops(jsc, train, val)
    assert hist[0][0] == "init"
    _assert_history(hist, jhist)
    assert_same_circuit(jbest, best)
    for s, v in jstore.items():
        np.testing.assert_allclose(store[s].detach().numpy(), np.asarray(v), rtol=1e-8)
    lls = [h[2] for h in hist]
    assert max(lls[1:]) > lls[0] + 1e-3
    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    cc = ctx.compile(best)
    assert abs(evaluate_ll(cc, val, store=store) - max(lls)) < 1e-6


def test_grow_prune_loop_bic_rejects_marginal_growth(monkeypatch):
    """With epsilon-improving log-likelihoods (``evaluate_ll`` replaced in
    both packages), ``ll`` chases the growth and ``bic`` keeps the smaller
    init model, as in JAX."""
    data = np.random.default_rng(5).integers(0, 256, (48, 16), dtype=np.int64)
    kwargs = dict(rounds=1, grow_fraction=0.5, prune_fraction=0.0, noise=0.0, em_epochs=1,
                  batch_size=48, seed=0)

    def run(criterion):
        for mod in (jax_parallel, port_parallel):
            lls = iter(-10.0 + 1e-4 * np.arange(10.0))
            monkeypatch.setattr(mod, "evaluate_ll", lambda *a, _l=lls, **k: next(_l))
        jsc = jax_image_data((1, 4, 4), "quad-tree-4", input_layer="categorical",
                             num_input_units=4, sum_product_layer="cp", num_sum_units=4,
                             em_ready=True)
        jctx = JaxPipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=21)
        jctx.compile(jsc)
        psc = to_port(jsc)
        ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu")
        ctx.compile(psc)
        ctx.load_parameters({s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()})
        jbest, _, jhist = JP.grow_prune_loop(jsc, data, ctx=jctx, criterion=criterion, **kwargs)
        best, _, hist = TP.grow_prune_loop(psc, data, ctx=ctx, criterion=criterion, **kwargs)
        assert hist == [tuple(h) for h in jhist]
        assert_same_circuit(jbest, best)
        return best, hist

    units = lambda s: sum(sl.num_output_units for sl in s.topological_ordering())  # noqa: E731
    best_ll, hist_ll = run("ll")
    best_bic, hist_bic = run("bic")
    assert [u for _, u, _ in hist_ll] == [u for _, u, _ in hist_bic]
    assert units(best_ll) == hist_ll[-1][1]
    assert units(best_bic) == hist_bic[0][1]


def test_grow_prune_loop_resume_criterion_mismatch_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(port_parallel, "evaluate_ll", lambda *a, **k: -1.0)
    jsc = _image("cp", k=4, em_ready=True)
    data = np.random.default_rng(4).integers(0, 256, (32, 16), dtype=np.int64)
    kwargs = dict(rounds=1, grow_fraction=0.25, prune_fraction=0.0, noise=0.0, em_epochs=1,
                  batch_size=32, seed=0, checkpoint_dir=str(tmp_path / "loop"))

    def ctx_of():
        ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu", seed=3)
        psc = to_port(jsc)
        ctx.compile(psc)
        return psc, ctx

    psc, ctx = ctx_of()
    TP.grow_prune_loop(psc, data, ctx=ctx, criterion="bic", **kwargs)
    psc, ctx = ctx_of()
    with pytest.raises(ValueError, match="criterion mismatch"):
        TP.grow_prune_loop(psc, data, ctx=ctx, criterion="aic", resume=True, **kwargs)


def _stage2_then_resume(run, tmp_path, **kw):
    """A checkpoint directory of a loop stopped after its grow stage (the
    prune stage skipped writes no checkpoint, so LATEST is 2), and the
    resumed run with the prune stage back."""
    ckpt = str(tmp_path / "loop")
    run(checkpoint_dir=ckpt, **{**kw, "prune_fraction": 0.0})
    with open(f"{ckpt}/LATEST") as fh:
        assert fh.read() == "2"
    with open(f"{ckpt}/stage2/state.json") as fh:
        assert [h[0] for h in json.load(fh)["history"]] == ["init", "grow@0"]
    return ckpt


def test_port_loop_resumes_its_own_checkpoint_to_the_bit(tmp_path):
    """A resumed port run reproduces the uninterrupted one to the bit (one
    round: init, grow, then the prune stage after the resume)."""
    jsc, train, val = _loop_case()
    kw = {**LOOP, "rounds": 1}

    def run(**extra):
        ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu", seed=9)
        psc = to_port(jsc)
        ctx.compile(psc)
        return TP.grow_prune_loop(psc, train, ctx=ctx, val_data=val, **{**kw, **extra})

    _, full_store, full = run()
    ckpt = _stage2_then_resume(run, tmp_path, **kw)
    _, store, hist = run(checkpoint_dir=ckpt, resume=True)
    assert hist == full and len(hist) == 3
    assert all(torch.equal(store[s], full_store[s]) for s in full_store)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint directory that JAX's loop wrote (pickled ``cirkit_tpu``
    circuits, npz stores) resumes in the port to JAX's uninterrupted
    history."""
    jsc, train, val = _loop_case()
    kw = {**LOOP, "rounds": 1}

    def jax_run(**extra):
        jctx = JaxPipelineContext(semiring="lse-sum", fold=True, seed=9)
        jctx.compile(jsc)
        return JP.grow_prune_loop(jsc, train, ctx=jctx, val_data=val, **{**kw, **extra})

    jbest, _, jhist = jax_run()
    ckpt = _stage2_then_resume(jax_run, tmp_path, **kw)
    shutil.copytree(ckpt, tmp_path / "copy")
    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu", seed=9)
    best, _, hist = TP.grow_prune_loop(to_port(jsc), train, ctx=ctx, val_data=val,
                                       checkpoint_dir=str(tmp_path / "copy"), resume=True,
                                       **kw)
    _assert_history(hist, jhist)
    assert_same_circuit(jbest, best, rtol=1e-8)
