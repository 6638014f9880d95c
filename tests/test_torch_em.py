"""The port's EM (``cirkit_tpu_torch.parallel.em``) against the JAX
package's (``cirkit_tpu.parallel.em``), on the CPU in float64.

The same circuit is built in both packages and the JAX store is carried
into the port by slot name:

- ``em_programs``: one flow step's accumulators (the sum and categorical
  flows, the Gaussian and Binomial leaf gradients and offset counts) and
  its log-likelihood, with and without missing entries (rtol 1e-9);
- ``fit_em(shuffle=False)``: the losses and the store after the run (rtol
  1e-9) for full-batch, damped, online and Robbins-Monro EM, a zero-padded
  partial batch, sample weights, missing entries as NaN and as a sentinel
  (a fully missing variable among them), frozen slots, a collapsed sum
  chain, the 1-D GMM, the 3-variable Gaussian mixture, binomial mixtures
  (probs and logits) and the tabular mix of categorical, Gaussian and
  Binomial leaves of ``tests/parallel/test_em.py``;
- the same warnings and errors;
- a run interrupted by a checkpoint (or SIGTERM) and resumed equals the
  uninterrupted run to the bit.

The JAX package runs as its own tests run it on the CPU: the EM-ready
forward routes to its reference there and reaches no Pallas kernel.
"""

import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cirkit_tpu.symbolic as JS
import cirkit_tpu_torch.symbolic as TS
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.models import tabular_data as jax_tabular_data
from cirkit_tpu.models.utils import Parameterization as JParameterization
from cirkit_tpu.parallel import em as jem
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu.utils import Scope as JScope
from cirkit_tpu_torch.backend.torch.layers import TorchCategoricalLayer
from cirkit_tpu_torch.models import image_data, tabular_data
from cirkit_tpu_torch.models.utils import Parameterization
from cirkit_tpu_torch.parallel import Preempted, em, em_programs, em_slots, fit_em
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils import Scope

RTOL = 1e-9
JAX = (JS, JScope)
PORT = (TS, Scope)


def _const(sy, value, learnable=True):
    value = np.asarray(value, dtype=np.float64)
    return sy.Parameter.from_input(sy.TensorParameter(
        *value.shape, initializer=sy.ConstantTensorInitializer(value), learnable=learnable))


def _image(spl="cp", input_layer="categorical", em_ready=True, **kw):
    def build(sy):
        make = jax_image_data if sy is JAX else image_data
        return make((1, 4, 4), "quad-graph", input_layer=input_layer, num_input_units=4,
                    sum_product_layer=spl, num_sum_units=4, em_ready=em_ready, **kw)
    return build


def _gmm(num_vars, k, seed):
    """A K-component mixture of products of Gaussians with plain constant
    parameters (``tests/parallel/test_em.py``'s ``_gmm_circuit``)."""
    def build(sy):
        s, scope = sy
        rng = np.random.default_rng(seed)
        leaves = [s.GaussianLayer(scope([v]), k, mean=_const(s, rng.normal(size=(k,))),
                                  stddev=_const(s, rng.uniform(0.6, 1.4, size=(k,))))
                  for v in range(num_vars)]
        w = rng.uniform(0.1, 1.0, size=(1, k))
        root = s.SumLayer(k, 1, weight=_const(s, w / w.sum()))
        if num_vars == 1:
            return s.Circuit(leaves + [root], {root: leaves}, [root])
        prod = s.HadamardLayer(k, arity=num_vars)
        return s.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    return build


def _binomial(kind):
    def build(sy):
        s, scope = sy
        p0 = np.random.default_rng(25).uniform(0.2, 0.8, size=(2,))
        value = p0 if kind == "probs" else np.log(p0) - np.log1p(-p0)
        leaf = s.BinomialLayer(scope([0]), 2, total_count=10, **{kind: _const(s, value)})
        root = s.SumLayer(2, 1, weight=_const(s, [[0.4, 0.6]]))
        return s.Circuit([leaf, root], {root: [leaf]}, [root])
    return build


def _tabular(em_ready=True):
    def build(sy):
        make = jax_tabular_data if sy is JAX else tabular_data
        return make("random-binary-tree", num_features=3, input_layers=[
            {"name": "categorical", "args": {"num_categories": 5}},
            {"name": "gaussian", "args": {}},
            {"name": "binomial", "args": {"total_count": 6}},
        ], num_input_units=3, sum_product_layer="cp", num_sum_units=3, em_ready=em_ready)
    return build


def _collapsed_chain(sy):
    """Softmax categorical leaves under a sum of a sum: SumCollapse fuses the
    two into a MatMul(W1, W2) weight with optimize=True."""
    s, scope = sy
    rng = np.random.default_rng(50)
    k = 3
    leaves = []
    for v in range(2):
        raw = rng.uniform(0.1, 1.0, size=(k, 4))
        probs = s.Parameter.from_unary(
            s.SoftmaxParameter(raw.shape, axis=-1),
            s.TensorParameter(*raw.shape, initializer=s.ConstantTensorInitializer(np.log(raw))))
        leaves.append(s.CategoricalLayer(scope([v]), k, num_categories=4, probs=probs))
    prod = s.HadamardLayer(k, arity=2)
    mid = s.SumLayer(k, k, weight=_const(s, rng.dirichlet(np.ones(k), size=k)))
    root = s.SumLayer(k, 1, weight=_const(s, rng.dirichlet(np.ones(k), size=1)))
    return s.Circuit(leaves + [prod, mid, root], {prod: leaves, mid: [prod], root: [mid]},
                     [root])


def _frozen_leaves(sy):
    """Frozen (learnable=False) Gaussian and Binomial leaves, a frozen
    softmax-reparameterized inner sum and a learnable root
    (``test_fit_em_keeps_frozen_leaf_and_sum_slots_fixed``)."""
    s, scope = sy
    rng = np.random.default_rng(17)
    k = 3

    def frozen(v):
        return s.Parameter.from_input(s.ConstantParameter(*np.shape(v), value=np.asarray(v)))

    g = s.GaussianLayer(scope([0]), k, mean=frozen(rng.normal(size=k)),
                        stddev=frozen(rng.uniform(0.5, 1.0, size=k)))
    b = s.BinomialLayer(scope([1]), k, total_count=4, probs=frozen(rng.uniform(0.3, 0.7, size=k)))
    prod = s.HadamardLayer(k, arity=2)
    theta = s.Parameter.from_unary(s.SoftmaxParameter((k, k)),
                                   s.ConstantParameter(k, k, value=rng.normal(size=(k, k))))
    mid = s.SumLayer(k, k, weight=theta)
    root = s.SumLayer(k, 1, weight=_const(s, rng.dirichlet(np.ones(k))[None]))
    return s.Circuit([g, b, prod, mid, root], {prod: [g, b], mid: [prod], root: [mid]}, [root])


def _both(build, **flags):
    """Both packages' compiled circuit and the JAX store (float64), carried
    into the port by slot name."""
    flags = {"semiring": "lse-sum", "fold": True, **flags}
    jctx = JaxPipelineContext(**flags)
    jcc = jctx.compile(build(JAX))
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    cc = ctx.compile(build(PORT))
    arrays = {s: np.asarray(v) for s, v in jctx.parameters.items()}
    arrays = {s: a.astype(np.float64) if a.dtype.kind == "f" else a for s, a in arrays.items()}
    ctx.load_parameters(arrays)
    jstore = {s: jnp.asarray(a) for s, a in arrays.items()}
    return jcc, jstore, ctx, cc


def _image_data(n, seed=0, gaussian=False):
    rng = np.random.default_rng(seed)
    if gaussian:
        return rng.normal(0.5, 0.5, size=(n, 16))
    base = rng.integers(0, 256, size=(4, 16))
    return np.clip(base[rng.integers(0, 4, n)] + rng.integers(-8, 9, (n, 16)), 0, 255)


def _clustered(n, d, seed, scale=3.0, noise=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(3, d))
    return centers[rng.integers(0, 3, n)] + rng.normal(scale=noise, size=(n, d))


def _tabular_x(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 5, n).astype(float), rng.normal(1.0, 0.5, n),
                     rng.binomial(6, 0.7, n).astype(float)], axis=1)


def _assert_stores(store, jstore, rtol=RTOL):
    assert set(store) == set(jstore)
    for k, v in store.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jstore[k]), rtol=rtol,
                                   atol=1e-300, err_msg=k)


def _fully_missing(n):
    x = _image_data(n, seed=62).astype(np.int64)
    x[:, 5] = -1  # variable 5 missing in every row
    x[np.random.default_rng(63).random(x.shape) < 0.2] = -1
    return x


def _nan_gaussian(n):
    x = _image_data(n, seed=81, gaussian=True)
    x[np.random.default_rng(82).random(x.shape) < 0.3] = np.nan
    return x


# name -> (circuit, flags, data, fit_em keyword arguments)
CASES = {
    "full-batch-cp": (_image("cp"), {}, _image_data(64), dict(num_epochs=3, batch_size=64)),
    "full-batch-tucker": (_image("tucker"), {}, _image_data(64),
                          dict(num_epochs=3, batch_size=64)),
    "epochs-of-batches": (_image("tucker"), {}, _image_data(64),
                          dict(num_epochs=2, batch_size=32)),
    "damped": (_image("cp"), {}, _image_data(64),
               dict(num_epochs=2, batch_size=32, step_size=0.5)),
    "online": (_image("tucker"), {}, _image_data(64),
               dict(num_epochs=2, batch_size=16, update_every="batch", step_size=0.3)),
    "robbins-monro": (_image("cp"), {}, _image_data(64),
                      dict(num_epochs=2, batch_size=16, update_every="batch",
                           step_size="robbins-monro")),
    "partial-batch": (_image("cp"), {}, _image_data(50), dict(num_epochs=2, batch_size=32)),
    "sample-weight": (_image("tucker"), {}, _image_data(6),
                      dict(num_epochs=3, batch_size=6,
                           sample_weight=np.array([3, 1, 2, 1, 1, 2], np.float32))),
    "missing-sentinel": (_image("cp"), {}, _fully_missing(48),
                         dict(num_epochs=2, batch_size=48, missing=-1, pseudocount=0.0)),
    "missing-nan": (_image("tucker", "gaussian"), {}, _nan_gaussian(48),
                    dict(num_epochs=2, batch_size=24, missing="nan")),
    "gaussian-image": (_image("cp", "gaussian"), {}, _image_data(64, gaussian=True),
                       dict(num_epochs=3, batch_size=64)),
    "binomial-image": (_image("tucker", "binomial"), {}, _image_data(64),
                       dict(num_epochs=3, batch_size=32)),
    "gmm-1d": (_gmm(1, 2, 21), {}, np.random.default_rng(22).normal(size=(64, 1)) * 1.5,
               dict(num_epochs=3, batch_size=64, pseudocount=0.0)),
    "gmm-3var": (_gmm(3, 3, 23), {}, _clustered(256, 3, 24), dict(num_epochs=4, batch_size=256)),
    "gmm-missing-float-nan": (_gmm(2, 2, 63), {}, _nan_gaussian(32)[:, :2],
                              dict(num_epochs=2, batch_size=32, missing=np.nan)),
    "binomial-probs": (_binomial("probs"), {},
                       np.random.default_rng(25).integers(0, 11, size=(48, 1)),
                       dict(num_epochs=2, batch_size=48, pseudocount=0.0)),
    "binomial-logits": (_binomial("logits"), {},
                        np.random.default_rng(25).integers(0, 11, size=(48, 1)),
                        dict(num_epochs=2, batch_size=48, pseudocount=0.0)),
    "tabular": (_tabular(), {}, _tabular_x(200, 38), dict(num_epochs=4, batch_size=200)),
    "frozen": (_frozen_leaves, {}, np.stack([np.random.default_rng(17).normal(size=64),
                                             np.random.default_rng(18).integers(0, 5, 64)
                                             .astype(float)], axis=1),
               dict(num_epochs=2, batch_size=64)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fit_em_matches_jax(name):
    build, flags, data, kw = CASES[name]
    jcc, jstore, ctx, cc = _both(build, **flags)
    jnew, jlosses = jem.fit_em(jcc, data, store=jstore, **kw)
    new, losses = fit_em(cc, data, store=dict(ctx.parameters), **kw)
    assert len(losses) == len(jlosses) == kw["num_epochs"]
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    _assert_stores(new, jnew)
    if name == "frozen":  # the frozen slots kept, the learnable root trained
        moved = {k for k, v in new.items() if not torch.equal(v, ctx.parameters[k])}
        assert moved and moved <= set(cc.learnable_slots)


@pytest.mark.parametrize("optimize", [False, True])
def test_em_through_collapsed_sum_chain_matches_jax_and_unfused(optimize):
    """SumCollapse fuses the sum chain into one MatMul(W1, W2) weight; the
    per-slot flows stay exact, so fused EM equals unfused EM and JAX's."""
    out = {}
    data = np.random.default_rng(51).integers(0, 4, size=(64, 2))
    for opt in (False, True):
        jcc, jstore, ctx, cc = _both(_collapsed_chain, optimize=opt)
        kw = dict(num_epochs=3, batch_size=64, pseudocount=0.0)
        with pytest.warns(UserWarning, match="none are EM-updatable"):
            store, losses = fit_em(cc, data, store=dict(ctx.parameters), **kw)
        with pytest.warns(UserWarning, match="none are EM-updatable"):
            jnew, jlosses = jem.fit_em(jcc, data, store=jstore, **kw)
        np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
        _assert_stores(store, jnew)
        out[opt] = (store, losses, sorted(em_slots(cc)))
    assert out[True][2] == out[False][2]
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-12)
    for k in out[True][2]:
        np.testing.assert_allclose(out[True][0][k].numpy(), out[False][0][k].numpy(),
                                   rtol=1e-12, err_msg=k)


def _acc_arrays(acc, acc_ll):
    flows, acc_g, acc_o = acc
    return {**{f"f:{k}": v for k, v in flows.items()}, **{f"g:{k}": v for k, v in acc_g.items()},
            **{f"o:{k}": v for k, v in acc_o.items()}, "ll": acc_ll}


@pytest.mark.parametrize("name", ["full-batch-tucker", "missing-nan", "tabular",
                                  "binomial-logits"])
def test_flow_step_matches_jax(name):
    build, flags, data, kw = CASES[name]
    jcc, jstore, ctx, cc = _both(build, **flags)
    missing = kw.get("missing")
    miss = None
    if missing is not None:
        miss = np.isnan(data)
        data = np.nan_to_num(data)
    x, w = data[:24], np.linspace(0.5, 1.5, 24).astype(np.float32)
    jfs, jupd, jstate = jem.em_programs(jcc, jstore, missing=miss is not None)
    fs, upd, state = em_programs(cc, ctx.parameters, missing=miss is not None)
    assert list(state["em_params"]) == list(jstate["em_params"])
    assert set(state["gauss_params"]) == set(jstate["gauss_params"])
    jargs = [jnp.asarray(x), jnp.asarray(w)] + ([] if miss is None else [jnp.asarray(miss[:24])])
    targs = [torch.as_tensor(x), torch.as_tensor(w)] + (
        [] if miss is None else [torch.as_tensor(miss[:24])])
    jacc, jll = jfs(jstate["em_params"], jstate["gauss_params"], jstate["zero_acc"](),
                    jnp.zeros(()), *jargs)
    acc, ll = fs(state["em_params"], state["gauss_params"], state["zero_acc"](),
                 torch.zeros((), dtype=torch.float64), *targs)
    want = _acc_arrays(jacc, jll)
    got = _acc_arrays(acc, ll)
    assert set(got) == set(want)
    for k, v in got.items():
        ref = np.asarray(want[k])
        np.testing.assert_allclose(v.numpy(), ref, rtol=RTOL, atol=1e-12 * np.abs(ref).max(),
                                   err_msg=k)
    new_em, new_g = upd(state["em_params"], state["gauss_params"], acc, 0.7)
    jnew_em, jnew_g = jupd(jstate["em_params"], jstate["gauss_params"], jacc, 0.7)
    _assert_stores({**new_em, **new_g}, {**jnew_em, **jnew_g})


def test_em_slots_and_leaf_layers_match_jax():
    for build in (_image("cp"), _image("tucker", "gaussian"), _tabular(), _frozen_leaves):
        jcc, _, _, cc = _both(build)
        assert em_slots(cc) == jem.em_slots(jcc)
        for fn in ("gaussian_em_layers", "binomial_em_layers"):
            got = [(i, a, b) for i, _, a, b in getattr(em, fn)(cc)]
            assert got == [(i, a, b) for i, _, a, b in getattr(jem, fn)(jcc)]


def test_fit_em_binds_the_store_and_keeps_the_distributions():
    _, _, ctx, cc = _both(_image("tucker"))
    before = {s: v.detach().clone() for s, v in ctx.parameters.items()}
    store, losses = fit_em(cc, _image_data(64), num_epochs=3, batch_size=64)
    assert all(b <= a + 1e-9 * abs(a) for a, b in zip(losses, losses[1:])), losses
    assert all(torch.equal(ctx.parameters[s], v) for s, v in before.items())
    assert set(cc.default_store) == set(ctx.parameters)
    for slot in em_slots(cc):
        w = store[slot]
        assert bool((w >= 0).all())
        torch.testing.assert_close(w.sum(dim=-1), torch.ones_like(w.sum(dim=-1)))
        assert torch.equal(cc.default_store[slot], w)


def test_fully_missing_variable_keeps_its_leaf():
    _, _, ctx, cc = _both(_image("cp"))
    store0 = dict(ctx.parameters)
    data = _fully_missing(48)
    store, losses = fit_em(cc, data, store=store0, num_epochs=2, batch_size=48, missing=-1,
                           pseudocount=0.0)
    hit = 0
    for layer in cc.layers:
        if isinstance(layer, TorchCategoricalLayer) and layer.probs is not None:
            rows = np.where(layer.scope_idx[:, 0] == 5)[0]
            slot = em._flow_slot(layer.probs)
            if len(rows):
                torch.testing.assert_close(store[slot][rows], store0[slot][rows], rtol=0, atol=0)
                hit += 1
    assert hit and all(np.isfinite(losses))


def test_em_warnings_and_errors_match_jax():
    softmax = _image("cp", em_ready=False)
    jcc, jstore, ctx, cc = _both(softmax)
    with pytest.raises(ValueError, match="plain weight tensors"):
        jem.em_slots(jcc)
    with pytest.raises(ValueError, match="plain weight tensors"):
        em_slots(cc)
    # default (ScaledSigmoid stddev) Gaussian leaves with plain sum weights
    def plain_sums(sy):
        param = JParameterization if sy is JAX else Parameterization
        make = jax_image_data if sy is JAX else image_data
        return make((1, 2, 2), "quad-tree-2", input_layer="gaussian", num_input_units=2,
                    sum_product_layer="cp", num_sum_units=2,
                    sum_weight_param=param(activation="none", initialization="dirichlet"))

    jcc, jstore, ctx, cc = _both(plain_sums)
    x = np.random.default_rng(34).normal(size=(32, 4))
    for fit, c, st in ((jem.fit_em, jcc, jstore), (fit_em, cc, dict(ctx.parameters))):
        with pytest.warns(UserWarning, match="none are EM-updatable"):
            fit(c, x, store=st, num_epochs=1, batch_size=32)
        with pytest.raises(ValueError, match="none are EM-updatable"):
            fit(c, x, store=st, num_epochs=1, batch_size=32, strict=True)

    # nothing EM-updatable: every slot frozen
    def frozen_only(sy):
        s, scope = sy
        leaf = s.GaussianLayer(scope([0]), 2, mean=_const(s, [0.0, 1.0], learnable=False),
                               stddev=_const(s, [1.0, 2.0], learnable=False))
        root = s.SumLayer(2, 1, weight=_const(s, [[0.5, 0.5]], learnable=False))
        return s.Circuit([leaf, root], {root: [leaf]}, [root])

    jcc, _, _, cc = _both(frozen_only)
    for slots, c in ((jem.em_slots, jcc), (em_slots, cc)):
        with pytest.raises(ValueError, match="no EM-updatable parameters"):
            slots(c)


def test_shared_reparameterized_mixture_stays_fixed_with_a_warning():
    """A mixture of two softmax circuits with plain mixture weights: the
    components are pointer reads of reparameterized weights and stay fixed,
    with JAX's warning; the mixture weights train, as in JAX."""
    flags = dict(semiring="lse-sum", fold=True)
    build = _image("cp", em_ready=False)
    jctx, ctx = JaxPipelineContext(**flags), PipelineContext(**flags, device="cpu", seed=0)
    ja, jb = jctx.compile(build(JAX)), jctx.compile(build(JAX))
    ta, tb = ctx.compile(build(PORT)), ctx.compile(build(PORT))
    jm, tm = jctx.mixture(ja, jb, em_ready=True), ctx.mixture(ta, tb, em_ready=True)
    ctx.load_parameters({s: np.asarray(v) for s, v in jctx.parameters.items()})
    data = _image_data(32)
    with pytest.warns(UserWarning, match="stay fixed under EM"):
        jnew, jl = jem.fit_em(jm, data, store=dict(jctx.parameters), num_epochs=2, batch_size=32)
    with pytest.warns(UserWarning, match="stay fixed under EM"):
        new, tl = fit_em(tm, data, store=dict(ctx.parameters), num_epochs=2, batch_size=32)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    _assert_stores(new, jnew)


def test_fit_em_validates_its_arguments():
    _, _, ctx, cc = _both(_image("cp"))
    data = np.zeros((8, 16), np.int64)
    for kw, err, match in [
        (dict(sample_weight=np.ones(3)), ValueError, "entries for"),
        (dict(sample_weight=np.full(8, np.nan)), ValueError, "finite and >= 0"),
        (dict(update_every="sometimes"), ValueError, "update_every"),
        (dict(step_size="linear"), ValueError, "schedule"),
        (dict(resume=True), ValueError, "checkpoint_path"),
        (dict(checkpoint_every=0, checkpoint_path="x"), ValueError, ">= 1"),
        (dict(missing="nan"), ValueError, "floating-point"),
        (dict(mesh=object()), TypeError, "DeviceMesh"),
    ]:
        with pytest.raises(err, match=match):
            fit_em(cc, data, batch_size=8, **kw)
    cc.default_store = None
    with pytest.raises(ValueError, match="No parameter store bound"):
        fit_em(cc, data, batch_size=8)


@pytest.mark.parametrize("shuffle", [False, True])
def test_resume_equals_the_uninterrupted_run_to_the_bit(tmp_path, shuffle):
    _, _, ctx, cc = _both(_image("tucker"))
    data = _image_data(40)
    kw = dict(batch_size=16, shuffle=shuffle, seed=3, update_every="batch",
              step_size="robbins-monro", checkpoint_every=1,
              checkpoint_path=str(tmp_path / "em"))
    full, full_losses = fit_em(cc, data, store=dict(ctx.parameters), num_epochs=3,
                               **{**kw, "checkpoint_path": str(tmp_path / "full")})
    fit_em(cc, data, store=dict(ctx.parameters), num_epochs=1, **kw)
    resumed, losses = fit_em(cc, data, store=dict(ctx.parameters), num_epochs=3, resume=True,
                             **kw)
    assert losses == full_losses
    assert all(torch.equal(resumed[k], full[k]) for k in full)
    with pytest.raises(ValueError, match="different run"):
        fit_em(cc, data[:32], store=dict(ctx.parameters), num_epochs=3, resume=True, **kw)
    with pytest.raises(ValueError, match="beyond this run"):
        fit_em(cc, data, store=dict(ctx.parameters), num_epochs=2, resume=True, **kw)


def test_sigterm_writes_a_checkpoint_and_resume_completes(tmp_path, monkeypatch):
    _, _, ctx, cc = _both(_image("cp"))
    data = _image_data(32)
    kw = dict(batch_size=16, num_epochs=3, checkpoint_every=2,
              checkpoint_path=str(tmp_path / "em"))
    full, full_losses = fit_em(cc, data, store=dict(ctx.parameters),
                               **{**kw, "checkpoint_path": str(tmp_path / "full")})
    programs = em.em_programs

    def killing(*args, **kwargs):
        flow_step, update, state = programs(*args, **kwargs)
        sent = []

        def step(*a):
            if not sent:  # one signal: the guard defers it to the epoch's end
                sent.append(os.kill(os.getpid(), signal.SIGTERM))
            return flow_step(*a)

        return step, update, state

    monkeypatch.setattr(em, "em_programs", killing)
    with pytest.raises(Preempted, match="resume=True"):
        fit_em(cc, data, store=dict(ctx.parameters), **kw)
    monkeypatch.setattr(em, "em_programs", programs)
    resumed, losses = fit_em(cc, data, store=dict(ctx.parameters), resume=True, **kw)
    assert losses == full_losses
    assert all(torch.equal(resumed[k], full[k]) for k in full)
