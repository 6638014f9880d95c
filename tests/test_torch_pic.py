"""The port's quadrature PCs (``cirkit_tpu_torch.backend.torch.pic``)
against the JAX package's (``cirkit_tpu.backend.jax.pic``), on the CPU in
float64.

Every case of ``tests/backend/test_pic.py`` is mirrored. The same circuit is
built in both packages and the JAX store is carried into the port by slot
name; the JAX integral networks' parameters are carried into the port's
networks by slot and parameter name (``load_net_params``). Then:

- the quadrature nodes and weights equal JAX's exactly;
- ``PICInputNet``/``PICInnerNet`` outputs match at rtol 1e-12 in every
  sharing mode;
- the materialized stores and the QPC forwards match at rtol 1e-9, and log
  Z is within 1e-9 of 0;
- the gradients of the mean NLL with respect to every network parameter
  match at rtol 1e-8, plus 1e-12 of the largest gradient of any of them
  (the root's network gets gradients of 1e-9 and below, sums of terms that
  cancel, which differ by float64 rounding of those terms);
- 15 ``torch.optim.Adam`` steps follow 15 ``optax.adam`` steps, the losses
  at rtol 1e-7;
- the optimize x cp/tucker grid (folded) converts, stays normalized and
  trains;
- the original circuit is unchanged by the conversion;
- the errors are JAX's, in type and message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cirkit_tpu.symbolic as JS
import cirkit_tpu_torch.symbolic as TS
from cirkit_tpu.backend.jax import pic as JP
from cirkit_tpu.backend.jax.queries import IntegrateQuery as JaxIntegrateQuery
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu.utils import Scope as JScope
from cirkit_tpu_torch.backend.torch import IntegrateQuery
from cirkit_tpu_torch.backend.torch.pic import (
    PICInnerNet,
    PICInputNet,
    QuadratureParameterization,
    load_net_params,
    pc2qpc,
    zw_quadrature,
)
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils import Scope

RTOL = 1e-9


@pytest.fixture(autouse=True)
def float64_default():
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_net_params(jqp):
    return jax.tree_util.tree_map(np.asarray, jqp.net_params)


def _jax_run(jqpc, jqp, x, net_params=None):
    """JAX's materialized store and forward on ``x``, jitted (its eager
    dispatch is the bulk of these tests' time otherwise)."""

    @jax.jit
    def run(p, xx):
        st = jqp.materialize(p)
        return st, jqpc.evaluate(st, xx)

    return run(jqp.net_params if net_params is None else net_params, jnp.asarray(x))


def _load(net, params):
    """A JAX network's parameters into the port's module, by name."""
    assert {n for n, _ in net.named_parameters()} == set(params)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))


# --------------------------------------------------------------------------- #
# Quadrature rules
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", ["leggauss", "midpoint", "trapezoidal", "simpson",
                                    "hermgauss"])
@pytest.mark.parametrize("nip", [4, 65])
def test_quadrature_equals_jax(method, nip):
    if method == "simpson" and nip % 2 == 0:
        return
    for kw in ({}, {"return_log_weight": True}):
        z, w = zw_quadrature(method, nip, **kw)
        jz, jw = JP.zw_quadrature(method, nip, **kw)
        assert z.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(z, jz)
        np.testing.assert_array_equal(w, jw)
    if method != "hermgauss":
        z, w = zw_quadrature(method, nip, 0.0, 2.0)
        jz, jw = JP.zw_quadrature(method, nip, 0.0, 2.0)
        np.testing.assert_array_equal(z, jz)
        np.testing.assert_array_equal(w, jw)


@pytest.mark.parametrize("method", ["leggauss", "midpoint", "trapezoidal", "simpson"])
def test_quadrature_integrates_smooth_function(method):
    z, w = zw_quadrature(method, 65)
    got = float((np.exp(z) * w).sum())
    want = np.e - 1.0 / np.e  # int_{-1}^{1} e^z dz
    assert abs(got - want) < 1e-3
    # interval change
    z, w = zw_quadrature(method, 65, 0.0, 2.0)
    np.testing.assert_allclose((z**2 * w).sum(), 8.0 / 3.0, atol=1e-3)


def test_leggauss_exact_for_polynomials():
    z, w = zw_quadrature("leggauss", 4)  # exact up to degree 7
    np.testing.assert_allclose((z**6 * w).sum(), 2.0 / 7.0, rtol=1e-12)


def test_hermgauss_gaussian_moment():
    z, w = zw_quadrature("hermgauss", 32)
    # int e^{-z^2} z^2 dz = sqrt(pi)/2
    np.testing.assert_allclose((w * z**2).sum(), np.sqrt(np.pi) / 2, rtol=1e-10)


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_quadrature_errors(mod):
    fn = zw_quadrature if mod == "port" else JP.zw_quadrature
    with pytest.raises(ValueError, match="Simpson's rule requires an odd number of points"):
        fn("simpson", 4)
    with pytest.raises(ValueError, match="Unknown integration method 'nope'"):
        fn("nope", 8)


# --------------------------------------------------------------------------- #
# The integral networks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("sharing", ["none", "f", "c"])
def test_pic_input_net_matches_jax(sharing, bias):
    jnet = JP.PICInputNet(num_variables=5, num_param=3, sharing=sharing)
    jparams = jnet.init(jax.random.PRNGKey(0), net_dim=16, ff_dim=6, bias=bias,
                        dtype=jnp.float64)
    net = PICInputNet(5, 3, sharing, net_dim=16, ff_dim=6, bias=bias,
                      generator=torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in net.named_parameters()} == {
        n: tuple(v.shape) for n, v in jparams.items()}
    _load(net, jax.tree_util.tree_map(np.asarray, jparams))
    z = np.linspace(-1, 1, 7)
    out = net(torch.as_tensor(z))
    assert out.shape == (5, 7, 3)
    np.testing.assert_allclose(_np(out), np.asarray(jnet.apply(jparams, jnp.asarray(z))),
                               rtol=1e-12)
    # fully-shared and composite-at-init heads coincide; per-variable differ
    same = np.allclose(_np(out[0]), _np(out[1]))
    assert same == (sharing in ("f", "c"))


@pytest.mark.parametrize("sharing", ["none", "f", "c"])
def test_pic_inner_net_matches_jax_and_normalizes(sharing):
    jnet = JP.PICInnerNet(num_dim=3, num_funcs=4, norm_dim=(2, 3), sharing=sharing)
    jparams = jnet.init(jax.random.PRNGKey(1), net_dim=16, dtype=jnp.float64)
    net = PICInnerNet(3, 4, (2, 3), sharing, net_dim=16,
                      generator=torch.Generator().manual_seed(1))
    _load(net, jax.tree_util.tree_map(np.asarray, jparams))
    z, w = zw_quadrature("trapezoidal", 5)
    out = net(torch.as_tensor(z), torch.as_tensor(w))
    assert out.shape == (4, 5, 5, 5)
    assert bool((out >= 0).all())
    np.testing.assert_allclose(_np(out.sum(dim=(2, 3))), 1.0, rtol=1e-9)
    want = jnet.apply(jparams, jnp.asarray(z), jnp.asarray(w))
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-12)


def test_pic_inner_net_init_shapes_and_composite_heads():
    """The port draws its own initial values (a torch.Generator), in JAX's
    shapes: under "c" the heads start equal, each in its own storage."""
    jp = JP.PICInnerNet(num_dim=2, num_funcs=3, norm_dim=(2,), sharing="c").init(
        jax.random.PRNGKey(0), net_dim=8, dtype=jnp.float64)
    net = PICInnerNet(2, 3, (2,), "c", net_dim=8, generator=torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in net.named_parameters()} == {
        n: tuple(v.shape) for n, v in jp.items()}
    for name in ("w3", "b3"):
        head = getattr(net, name)
        assert bool((head == head[:1]).all())
        assert head.stride(0) > 0  # not an expanded view
    # reproducible from the generator's seed, different across seeds
    again = PICInnerNet(2, 3, (2,), "c", net_dim=8, generator=torch.Generator().manual_seed(0))
    other = PICInnerNet(2, 3, (2,), "c", net_dim=8, generator=torch.Generator().manual_seed(1))
    assert torch.equal(net.w1, again.w1) and not torch.equal(net.w1, other.w1)
    # an in-place step on one head moves that head only
    with torch.no_grad():
        net.w3[0] += 1.0
    assert not torch.equal(net.w3[0], net.w3[1])


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_pic_net_errors(mod):
    if mod == "port":
        def make_in(**kw):
            return PICInputNet(3, 2, **kw)

        def make_inner(**kw):
            return PICInnerNet(2, 3, (2,), **kw)
    else:
        def make_in(sharing="f", **kw):
            return JP.PICInputNet(3, 2, sharing=sharing).init(jax.random.PRNGKey(0), **kw)

        def make_inner(sharing="c", **kw):
            return JP.PICInnerNet(2, 3, (2,), sharing=sharing).init(jax.random.PRNGKey(0), **kw)
    for make in (make_in, make_inner):
        with pytest.raises(ValueError, match="Unknown sharing mode 'x'"):
            make(sharing="x")
        with pytest.raises(ValueError, match="The Fourier feature dimension must be even"):
            make(net_dim=8, ff_dim=5)


# --------------------------------------------------------------------------- #
# pc2qpc on compiled circuits
# --------------------------------------------------------------------------- #


def _image(make, spl, k, region_graph="quad-tree-2"):
    return make((1, 4, 4), region_graph, input_layer="categorical", num_input_units=k,
                sum_product_layer=spl, num_sum_units=k)


def _both(spl="tucker", k=4, region_graph="quad-tree-2", **flags):
    """Both packages' compiled circuit, the JAX store in float64 and the
    port's context holding it."""
    flags = {"semiring": "lse-sum", "fold": True, "optimize": True, **flags}
    jctx = JaxPipelineContext(**flags)
    jcc = jctx.compile(_image(jax_image_data, spl, k, region_graph))
    jstore = {s: jnp.asarray(v, jnp.float64) for s, v in jctx.parameters.items()}
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    cc = ctx.compile(_image(image_data, spl, k, region_graph))
    ctx.load_parameters({s: np.asarray(v) for s, v in jstore.items()})
    return jcc, jstore, ctx, cc


def _convert_both(method="trapezoidal", seed=42, net_dim=8, **build):
    jcc, jstore, ctx, cc = _both(**build)
    jqpc, jqp = JP.pc2qpc(jcc, jstore, integration_method=method,
                          key=jax.random.PRNGKey(seed), net_dim=net_dim)
    qpc, qp = pc2qpc(cc, ctx.parameters, integration_method=method, seed=seed,
                     net_dim=net_dim)
    load_net_params(qp, _jax_net_params(jqp))
    return jqpc, jqp, qpc, qp, ctx, cc


@pytest.fixture(scope="module")
def tucker_qpc():
    torch.set_default_dtype(torch.float64)
    try:
        return _convert_both()
    finally:
        torch.set_default_dtype(torch.float32)


def _log_z(qpc, store):
    z = IntegrateQuery(qpc)(np.zeros((1, qpc.num_variables), np.int64),
                            integrate_vars=Scope(qpc.scope), store=store)
    return float(z.reshape(-1)[0])


def _jax_log_z(jqpc, jstore):
    q = JaxIntegrateQuery(jqpc)
    z = q(jnp.zeros((1, jqpc.num_variables)), integrate_vars=jqpc.scope, store=jstore)
    return float(np.asarray(z).reshape(-1)[0])


def test_pc2qpc_materializes_jax_store_and_evaluates(tucker_qpc):
    jqpc, jqp, qpc, qp, _, _ = tucker_qpc
    assert isinstance(qp, QuadratureParameterization)
    assert {s: {n: tuple(p.shape) for n, p in d.items()} for s, d in qp.net_params.items()} == {
        s: {n: tuple(v.shape) for n, v in d.items()} for s, d in jqp.net_params.items()}
    x = np.random.default_rng(0).integers(0, 256, size=(8, 16))
    store, (jstore, jout) = qp.materialize(), _jax_run(jqpc, jqp, x)
    assert sorted(store) == sorted(jstore)
    for s in jstore:
        np.testing.assert_allclose(_np(store[s]), np.asarray(jstore[s]), rtol=RTOL, err_msg=s)
    out = qpc.evaluate(store, torch.as_tensor(x))
    assert out.shape == (8, 1, 1) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=RTOL)
    # the quadrature normalization makes the circuit exactly normalized
    log_z = _log_z(qpc, store)
    assert abs(log_z) < 1e-9
    np.testing.assert_allclose(log_z, _jax_log_z(jqpc, jstore), atol=1e-12)


def test_pc2qpc_generated_weights_are_plain_and_normalized(tucker_qpc):
    """Every generated weight is a bare non-learnable slot read by a layer
    without a softmax route; each (fold, output unit) sums to 1."""
    _, _, qpc, qp, _, _ = tucker_qpc
    store = qp.materialize()
    generated = [s for s in qp.nets if s.endswith("_qpc")]
    assert generated
    for layer in qpc.layers:
        weight = getattr(layer, "weight", None)
        if weight is None:
            continue
        (slot,) = weight.tensor_slots()
        assert slot.slot in generated and not slot.learnable
        assert layer._logits_slot is None
        w = store[slot.slot]
        assert bool((w >= 0).all())
        np.testing.assert_allclose(_np(w.sum(dim=-1)), 1.0, rtol=1e-12)


def test_qpc_materialize_with_net_params_matches_jax(tucker_qpc):
    """``materialize(net_params)`` evaluates the nets with the given
    tensors, as JAX's does with a changed pytree."""
    jqpc, jqp, qpc, qp, _, _ = tucker_qpc
    jparams = jax.tree_util.tree_map(lambda a: a * 0.5, jqp.net_params)
    params = {s: {n: torch.from_numpy(np.array(v)) for n, v in d.items()}
              for s, d in jparams.items()}
    store, jstore = qp.materialize(params), jax.jit(jqp.materialize)(jparams)
    for s in jstore:
        np.testing.assert_allclose(_np(store[s]), np.asarray(jstore[s]), rtol=RTOL, err_msg=s)
    # the module's own parameters are untouched
    own = qp.materialize()
    assert not np.allclose(_np(own[generated := next(iter(qp.nets))]), _np(store[generated]))


def test_qpc_gradients_match_jax(tucker_qpc):
    jqpc, jqp, qpc, qp, _, _ = tucker_qpc
    x = np.random.default_rng(1).integers(0, 256, size=(16, 16))

    def jax_loss(net_params):
        return -jnp.mean(jqpc.evaluate(jqp.materialize(net_params), jnp.asarray(x))[:, 0, 0])

    jl, jgrads = jax.jit(jax.value_and_grad(jax_loss))(jqp.net_params)
    qp.zero_grad()
    loss = -qpc.evaluate(qp.materialize(), torch.as_tensor(x))[:, 0, 0].mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-12)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(jgrads))
    for slot, net in qp.nets.items():
        for name, p in net.named_parameters():
            ref = np.asarray(jgrads[slot][name])
            np.testing.assert_allclose(_np(p.grad), ref, rtol=1e-8, atol=1e-12 * scale,
                                       err_msg=f"{slot}.{name}")


def test_qpc_training_follows_optax():
    """15 Adam steps: ``torch.optim.Adam(qp.parameters(), lr=5e-3)`` against
    ``optax.adam(5e-3)``, losses at rtol 1e-7, finite and decreasing."""
    jqpc, jqp, qpc, qp, _, _ = _convert_both()
    x = np.random.default_rng(1).integers(0, 256, size=(16, 16))
    xt = torch.as_tensor(x)
    opt = optax.adam(5e-3)
    params = jqp.net_params
    opt_state = opt.init(params)

    def loss_fn(net_params):
        return -jnp.mean(jqpc.evaluate(jqp.materialize(net_params), jnp.asarray(x))[:, 0, 0])

    step = jax.jit(jax.value_and_grad(loss_fn))
    topt = torch.optim.Adam(qp.parameters(), lr=5e-3)
    jlosses, losses = [], []
    for _ in range(15):
        loss, grads = step(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(loss))
        topt.zero_grad()
        tl = -qpc.evaluate(qp.materialize(), xt)[:, 0, 0].mean()
        tl.backward()
        topt.step()
        losses.append(float(tl.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-7)


def test_qpc_leggauss_generated_slots_finite():
    # generated sum weights keep the quadrature normalization by construction
    jqpc, jqp, qpc, qp, _, _ = _convert_both(method="leggauss")
    store = qp.materialize()
    jstore = jax.jit(jqp.materialize)(jqp.net_params)
    for name in qp.nets:
        v = _np(store[name])
        assert np.isfinite(v).all()
        np.testing.assert_allclose(v, np.asarray(jstore[name]), rtol=RTOL)
    assert abs(_log_z(qpc, store)) < 1e-9


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("sum_product", ["cp", "tucker"])
def test_qpc_grid_fold_optimize(optimize, sum_product):
    """pc2qpc across the fold/optimize/sum-product grid on a mid-size
    circuit (``tests/backend/test_pic.py::test_qpc_grid_fold_optimize``):
    the store and forward equal JAX's, the converted circuit stays exactly
    normalized, and one training step moves finitely."""
    jqpc, jqp, qpc, qp, _, _ = _convert_both(
        method="leggauss", seed=7, spl=sum_product, k=8, region_graph="quad-graph",
        optimize=optimize)
    x = np.random.default_rng(0).integers(0, 256, size=(8, 16))
    store, (jstore, jout) = qp.materialize(), _jax_run(jqpc, jqp, x)
    for s in jstore:
        np.testing.assert_allclose(_np(store[s]), np.asarray(jstore[s]), rtol=RTOL, err_msg=s)
    out = qpc.evaluate(store, torch.as_tensor(x))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=RTOL)
    assert abs(_log_z(qpc, store)) < 1e-9

    loss = -qpc.evaluate(qp.materialize(), torch.as_tensor(x))[:, 0, 0].mean()
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    grads = [p.grad for p in qp.parameters()]
    assert grads and all(g is not None and bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("input_sharing,inner_sharing", [("none", "none"), ("c", "f")])
def test_qpc_sharing_modes_match_jax(input_sharing, inner_sharing):
    jcc, jstore, ctx, cc = _both(k=2)
    kw = dict(integration_method="midpoint", net_dim=4, input_sharing=input_sharing,
              inner_sharing=inner_sharing, ff_dim=6, ff_sigma=0.5, bias=False)
    jqpc, jqp = JP.pc2qpc(jcc, jstore, key=jax.random.PRNGKey(3), **kw)
    qpc, qp = pc2qpc(cc, ctx.parameters, seed=3, **kw)
    load_net_params(qp, _jax_net_params(jqp))
    x = np.random.default_rng(2).integers(0, 256, size=(4, 16))
    store, (jstore_q, jout) = qp.materialize(), _jax_run(jqpc, jqp, x)
    for s in jstore_q:
        np.testing.assert_allclose(_np(store[s]), np.asarray(jstore_q[s]), rtol=RTOL)
    np.testing.assert_allclose(_np(qpc.evaluate(store, torch.as_tensor(x))), np.asarray(jout),
                               rtol=RTOL)


def test_pc2qpc_leaves_the_original_circuit_unchanged():
    _, _, ctx, cc = _both()
    x = torch.as_tensor(np.random.default_rng(3).integers(0, 256, size=(8, 16)))
    before = cc(x).clone()
    layers = list(cc.layers)
    weights = [getattr(l, "weight", None) for l in layers]
    logits = [getattr(l, "_logits_slot", None) for l in layers]
    store_before = {s: v.clone() for s, v in ctx.parameters.items()}
    qpc, qp = pc2qpc(cc, ctx.parameters, integration_method="leggauss", net_dim=4)
    qpc.evaluate(qp.materialize(), x).sum().backward()
    assert list(cc.layers) == layers
    assert [getattr(l, "weight", None) for l in layers] == weights
    assert [getattr(l, "_logits_slot", None) for l in layers] == logits
    assert all(torch.equal(ctx.parameters[s], v) for s, v in store_before.items())
    assert torch.equal(cc(x), before)
    # the converted circuit keeps the original's fold wiring and device
    assert qpc._fold_inputs == cc._fold_inputs and qpc._fold_outputs == cc._fold_outputs
    assert all(b.device.type == "cpu" for b in qpc.buffers())


def test_qpc_generators_live_on_the_store_dtype():
    """The networks and quadrature grids take the store's dtype: a float32
    store gives float32 networks and a float32 materialized store."""
    torch.set_default_dtype(torch.float32)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu", seed=0)
    cc = ctx.compile(_image(image_data, "tucker", 4))
    qpc, qp = pc2qpc(cc, ctx.parameters, integration_method="leggauss", net_dim=4)
    assert all(p.dtype == torch.float32 for p in qp.parameters())
    store = qp.materialize()
    assert all(v.dtype == torch.float32 for v in store.values())
    out = qpc(store, torch.zeros((2, 16), dtype=torch.long))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_load_net_params_errors(tucker_qpc):
    jqpc, jqp, qpc, qp, _, _ = tucker_qpc
    params = _jax_net_params(jqp)
    slot = next(iter(params))
    missing = {s: v for s, v in params.items() if s != slot}
    with pytest.raises(ValueError, match="slots"):
        load_net_params(qp, missing)
    with pytest.raises(ValueError, match="slots"):
        load_net_params(qp, {**params, "nope": {}})
    no_b1 = {**params, slot: {n: v for n, v in params[slot].items() if n != "b1"}}
    with pytest.raises(ValueError, match="names"):
        load_net_params(qp, no_b1)
    extra = {**params, slot: {**params[slot], "w9": np.zeros(1)}}
    with pytest.raises(ValueError, match="names"):
        load_net_params(qp, extra)
    bad = {**params, slot: {**params[slot], "w1": np.zeros((1, 2, 3))}}
    with pytest.raises(ValueError, match="shape"):
        load_net_params(qp, bad)
    # a failed load copies nothing
    np.testing.assert_array_equal(_np(qp.nets[slot].w1), params[slot]["w1"])


# --------------------------------------------------------------------------- #
# Errors, as the JAX package raises them
# --------------------------------------------------------------------------- #


def _composite_circuit(S, Sc):
    """One categorical leaf under a sum whose weight is the Hadamard product
    of two slots: a composite (non-simple) parameter graph."""

    def const(v):
        return S.Parameter.from_input(S.TensorParameter(
            *v.shape, initializer=S.ConstantTensorInitializer(v), learnable=True))

    leaf = S.CategoricalLayer(Sc([0]), 2, num_categories=3,
                              probs=const(np.full((2, 3), 1.0 / 3.0)))
    w = S.Parameter.from_binary(S.HadamardParameter((1, 2), (1, 2)),
                                const(np.ones((1, 2))), const(np.full((1, 2), 0.5)))
    root = S.SumLayer(2, 1, weight=w)
    return S.Circuit([leaf, root], {root: [leaf]}, [root])


def test_pc2qpc_composite_graph_raises_like_jax():
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True)
    jcc = jctx.compile(_composite_circuit(JS, JScope))
    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    cc = ctx.compile(_composite_circuit(TS, Scope))
    with pytest.raises(NotImplementedError, match="found a composite graph") as jerr:
        JP.pc2qpc(jcc, jctx.parameters, integration_method="leggauss",
                  key=jax.random.PRNGKey(0), net_dim=4)
    with pytest.raises(NotImplementedError, match="found a composite graph") as err:
        pc2qpc(cc, ctx.parameters, integration_method="leggauss", net_dim=4)
    assert str(err.value) == str(jerr.value)


def test_pc2qpc_unknown_method_and_layer_raise_like_jax():
    _, _, ctx, cc = _both(k=2)
    with pytest.raises(ValueError, match="Unknown integration method 'nope'"):
        pc2qpc(cc, ctx.parameters, integration_method="nope", net_dim=4)

    from cirkit_tpu_torch.backend.torch.optimized import TorchTensorDotLayer

    class Odd(TorchTensorDotLayer):
        def __init__(self):  # a layer kind pc2qpc does not convert
            torch.nn.Module.__init__(self)

    cc.layers.append(Odd())
    with pytest.raises(NotImplementedError,
                       match="pc2qpc does not handle layers of type Odd"):
        pc2qpc(cc, ctx.parameters, integration_method="leggauss", net_dim=4)


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_integral_dims_errors(mod):
    from cirkit_tpu.backend.jax.pic import _integral_dims as jdims
    from cirkit_tpu_torch.backend.torch.pic import _integral_dims as tdims

    fn = tdims if mod == "port" else jdims
    assert fn((4, 16), is_tucker=True) == (4, 3)
    assert fn((8, 8), is_tucker=False) == (8, 2)
    assert fn((1, 1), is_tucker=False) == (1, 1)
    with pytest.raises(ValueError, match=r"Weight shape \(4, 6\) is not a power of the "
                                         r"quadrature size 6"):
        fn((4, 6), is_tucker=False)
