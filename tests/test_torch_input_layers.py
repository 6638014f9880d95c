"""The port's Gaussian, Binomial, Embedding and Evidence layers and the
parameter nodes of their parameterizations, against the JAX package on the
CPU in float64.

- **Parameter nodes.** Sum, Hadamard, Exp, Square, Softplus, Sigmoid,
  ScaledSigmoid, Clamp, ReduceProduct and the three GaussianProduct nodes,
  each compiled from one symbolic graph by both compilers and evaluated on
  the same constant inputs (rtol 1e-10).
- **Layer hooks.** Each new input layer's forward, ``integrate``, ``mpe``
  and ``state_distribution`` on the layers of one folded circuit, the JAX
  store carried over by slot name (rtol 1e-10); ``sample_selected`` draws
  the same from the same seed, inside the support, with the selected unit's
  moments.
- **Circuits.** ``image_data`` with Gaussian, Binomial and Embedding leaves,
  ``tabular_data`` with mixed leaves, circuits built by
  ``functional.evidence`` and the product of two Gaussian circuits: the
  slots, the forward, ``IntegrateQuery`` and MAP against JAX (rtol 1e-10),
  and the conditional sampler's log-evidence against JAX's marginal (the
  Embedding layer, which JAX cannot sample either, raises).

Log-values are held to rtol 1e-10 with an absolute floor of 1e-12 for the
ones that are 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cirkit_tpu.symbolic as JS
import cirkit_tpu.symbolic.functional as JSF
import cirkit_tpu_torch.symbolic as TS
import cirkit_tpu_torch.symbolic.functional as TSF
from cirkit_tpu.backend.jax.compiler import JaxCompiler
from cirkit_tpu.backend.jax.queries import IntegrateQuery as JaxIntegrateQuery
from cirkit_tpu.backend.jax.queries import MAPQuery as JaxMAPQuery
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.models import tabular_data as jax_tabular_data
from cirkit_tpu.models.utils import Parameterization as JParameterization
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu.utils import Scope as JScope
from cirkit_tpu_torch.backend.torch import IntegrateQuery, MAPQuery, SamplingQuery
from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
from cirkit_tpu_torch.backend.torch.layers import (
    TorchBinomialLayer,
    TorchEmbeddingLayer,
    TorchEvidenceLayer,
    TorchGaussianLayer,
    TorchInputLayer,
)
from cirkit_tpu_torch.models import image_data, tabular_data
from cirkit_tpu_torch.models.utils import Parameterization
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils import Scope

RTOL, ATOL = 1e-10, 1e-12
JAX = (JS, JScope)
PORT = (TS, Scope)


def _close(got: torch.Tensor, want, rtol=RTOL):
    """rtol, and ATOL for the log-values that are 0 (a marginal over every
    variable)."""
    assert got.dtype in (torch.float64, torch.int64), got.dtype
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=ATOL)


# --------------------------------------------------------------------------- #
# Parameter nodes
# --------------------------------------------------------------------------- #


def _const(sy, value):
    value = np.asarray(value, dtype=np.float64)
    return sy.TensorParameter(
        *value.shape, initializer=sy.ConstantTensorInitializer(value)
    )


def _node_graph(sy, name: str, rng: np.random.Generator):
    """The symbolic parameter graph of case ``name`` in package ``sy``."""
    a, b = rng.normal(size=(3, 4)), rng.normal(size=(3, 4))
    unary = {
        "exp": sy.ExpParameter((3, 4)),
        "square": sy.SquareParameter((3, 4)),
        "softplus": sy.SoftplusParameter((3, 4)),
        "sigmoid": sy.SigmoidParameter((3, 4)),
        "scaled-sigmoid": sy.ScaledSigmoidParameter((3, 4), 0.5, 2.0),
        "clamp-min": sy.ClampParameter((3, 4), vmin=-0.3),
        "clamp-max": sy.ClampParameter((3, 4), vmax=0.2),
        "clamp-both": sy.ClampParameter((3, 4), vmin=-0.3, vmax=0.2),
        "reduce-product-0": sy.ReduceProductParameter((3, 4), axis=0),
        "reduce-product-1": sy.ReduceProductParameter((3, 4), axis=-1),
    }
    if name in unary:
        return sy.Parameter.from_unary(unary[name], _const(sy, a))
    if name in ("sum", "hadamard"):
        op = (sy.SumParameter if name == "sum" else sy.HadamardParameter)((3, 4), (3, 4))
        return sy.Parameter.from_binary(op, _const(sy, a), _const(sy, b))
    m1, m2 = rng.normal(size=3), rng.normal(size=4)
    s1, s2 = rng.uniform(0.5, 2.0, size=3), rng.uniform(0.5, 2.0, size=4)
    if name == "gaussian-product-stddev":
        return sy.Parameter.from_binary(
            sy.GaussianProductStddev((3,), (4,)), _const(sy, s1), _const(sy, s2)
        )
    op = {"gaussian-product-mean": sy.GaussianProductMean,
          "gaussian-product-log-partition": sy.GaussianProductLogPartition}[name]
    return sy.Parameter.from_nary(
        op((3,), (3,), (4,), (4,)), *(_const(sy, v) for v in (m1, s1, m2, s2))
    )


NODES = ["sum", "hadamard", "exp", "square", "softplus", "sigmoid", "scaled-sigmoid",
         "clamp-min", "clamp-max", "clamp-both", "reduce-product-0", "reduce-product-1",
         "gaussian-product-mean", "gaussian-product-stddev", "gaussian-product-log-partition"]


def _slot_store(param, wrap):
    """Each tensor slot of a compiled graph holding its constant (F=1)."""
    return {
        n.slot: wrap(np.asarray(n.origins[0].initializer.value)[None])
        for n in param.nodes if hasattr(n, "origins")
    }


@pytest.mark.parametrize("name", NODES)
def test_parameter_node_matches_jax(name):
    jp = JaxCompiler(semiring="lse-sum").compile_parameter(
        _node_graph(JS, name, np.random.default_rng(0)))
    tp = TorchCompiler(semiring="lse-sum", device="cpu").compile_parameter(
        _node_graph(TS, name, np.random.default_rng(0)))
    assert tp.shape == jp.shape
    want = jp(_slot_store(jp, jnp.asarray))
    got = tp(_slot_store(tp, torch.as_tensor))
    assert got.shape == (1, *tp.shape)
    _close(got, want)


# --------------------------------------------------------------------------- #
# Layer hooks
# --------------------------------------------------------------------------- #


def _leaf_circuit(sy, scope, kind: str, rng: np.random.Generator):
    """Three leaves of one kind over variables 0-2 (one folded layer), their
    product and a root sum: the layer whose hooks the tests read."""
    k = 3
    leaves = []
    for v in range(3):
        if kind == "gaussian":
            leaf = sy.GaussianLayer(
                scope([v]), k, mean=sy.Parameter.from_input(_const(sy, rng.normal(size=k))),
                stddev=sy.Parameter.from_input(_const(sy, rng.uniform(0.5, 1.5, size=k))))
        elif kind.startswith("binomial"):
            p = rng.uniform(0.2, 0.8, size=k)
            arg = ({"probs": p} if kind == "binomial-probs"
                   else {"logits": np.log(p) - np.log1p(-p)})
            (name, val), = arg.items()
            leaf = sy.BinomialLayer(scope([v]), k, total_count=6,
                                    **{name: sy.Parameter.from_input(_const(sy, val))})
        else:  # embedding
            leaf = sy.EmbeddingLayer(
                scope([v]), k, num_states=5,
                weight=sy.Parameter.from_input(_const(sy, rng.uniform(0.1, 1.0, size=(k, 5)))))
        leaves.append(leaf)
    prod = sy.HadamardLayer(k, arity=3)
    root = sy.SumLayer(k, 1, weight=sy.Parameter.from_input(
        _const(sy, rng.dirichlet(np.ones(k))[None])))
    return sy.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def _both(build, **flags):
    """Both packages' compiled circuit, the JAX store (float64) carried into
    the port by slot name."""
    flags = {"semiring": "lse-sum", "fold": True, **flags}
    jctx = JaxPipelineContext(**flags)
    jcc = jctx.compile(build(JAX))
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    cc = ctx.compile(build(PORT))
    assert set(ctx.parameters) == set(jctx.parameters)
    for s, v in jctx.parameters.items():
        assert tuple(ctx.parameters[s].shape) == np.shape(v), s
    ctx.load_parameters({s: np.asarray(v, np.float64) if np.issubdtype(np.asarray(v).dtype,
                                                                       np.floating)
                         else np.asarray(v) for s, v in jctx.parameters.items()})
    jstore = {s: jnp.asarray(v.detach().numpy()) for s, v in ctx.parameters.items()}
    return jcc, jstore, cc, dict(ctx.parameters)


LEAVES = ["gaussian", "binomial-probs", "binomial-logits", "embedding"]
LAYER_TYPES = {"gaussian": TorchGaussianLayer, "binomial-probs": TorchBinomialLayer,
               "binomial-logits": TorchBinomialLayer, "embedding": TorchEmbeddingLayer}


def _leaf_data(kind: str, rng, shape):
    if kind == "gaussian":
        return rng.normal(size=shape)
    return rng.integers(0, 7 if kind.startswith("binomial") else 5, size=shape)


@pytest.mark.parametrize("kind", LEAVES)
def test_layer_hooks_match_jax(kind):
    jcc, jstore, cc, store = _both(
        lambda sy: _leaf_circuit(sy[0], sy[1], kind, np.random.default_rng(1)))
    (jl,) = [l for l in jcc.layers if type(l).__name__.startswith("Jax") and l.num_folds == 3
             and hasattr(l, "scope_idx")]
    (tl,) = [l for l in cc.layers if isinstance(l, TorchInputLayer)]
    assert isinstance(tl, LAYER_TYPES[kind]) and tl.num_folds == 3
    x = _leaf_data(kind, np.random.default_rng(2), (3, 10, 1))
    _close(tl(store, torch.as_tensor(x)), jl.forward(jstore, jnp.asarray(x)))
    _close(tl.integrate(store), jl.integrate(jstore))
    val, arg = tl.mpe(store)
    jval, jarg = jl.mpe(jstore)
    _close(val, jval)
    _close(arg, jarg)
    if kind != "gaussian":
        _close(tl.state_distribution(store), jl.state_distribution(jstore))
    else:
        with pytest.raises(TypeError, match="State distributions"):
            tl.state_distribution(store)


@pytest.mark.parametrize("kind", ["gaussian", "binomial-probs", "binomial-logits"])
def test_sample_selected_is_seeded_and_has_the_units_law(kind):
    _, _, cc, store = _both(lambda sy: _leaf_circuit(sy[0], sy[1], kind,
                                                      np.random.default_rng(3)))
    (tl,) = [l for l in cc.layers if isinstance(l, TorchInputLayer)]
    n = 20000
    sel = torch.as_tensor(np.random.default_rng(4).integers(0, 3, size=(3, n)))
    draw = lambda seed: tl.sample_selected(store, torch.Generator().manual_seed(seed), sel)  # noqa: E731
    a = draw(5)
    assert a.shape == (3, n) and torch.equal(a, draw(5)) and not torch.equal(a, draw(6))
    if kind == "gaussian":
        mu = torch.gather(tl.mean(store), 1, sel)
        sd = torch.gather(tl.stddev(store), 1, sel)
        z = ((a - mu) / sd).detach()
        assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1.0) < 0.03
        return
    assert bool(((a >= 0) & (a <= 6) & (a == a.round())).all())
    p = torch.gather(torch.sigmoid(tl._logits(store)), 1, sel).detach()
    # the mean of Binomial(6, p) draws, within 5 standard errors
    err = float((a - 6 * p).mean().abs())
    assert err < 5 * float(torch.sqrt(6 * p * (1 - p)).mean()) / np.sqrt(3 * n)


# --------------------------------------------------------------------------- #
# Circuits
# --------------------------------------------------------------------------- #


def _image(kind, spl, em_ready):
    """image_data at (1, 4, 4), K=4, with ``kind`` leaves."""
    def build(sy):
        param = JParameterization if sy is JAX else Parameterization
        make = jax_image_data if sy is JAX else image_data
        extra = {}
        if kind == "embedding":  # positive weights: a log-likelihood under lse-sum
            extra["input_params"] = {"weight": param(activation="softplus",
                                                      initialization="normal")}
        return make((1, 4, 4), "quad-graph", input_layer=kind, num_input_units=4,
                    sum_product_layer=spl, num_sum_units=4, em_ready=em_ready, **extra)
    return build


def _tabular(em_ready):
    def build(sy):
        make = jax_tabular_data if sy is JAX else tabular_data
        return make("random-binary-tree", num_features=3, input_layers=[
            {"name": "categorical", "args": {"num_categories": 5}},
            {"name": "gaussian", "args": {}},
            {"name": "binomial", "args": {"total_count": 6}},
        ], num_input_units=3, sum_product_layer="cp", num_sum_units=3, em_ready=em_ready)
    return build


def _image_x(kind, rng, n):
    if kind == "gaussian":
        return rng.normal(0.5, 0.5, size=(n, 16))
    return rng.integers(0, 256, size=(n, 16))


def _tabular_x(rng, n):
    return np.stack([rng.integers(0, 5, n).astype(float), rng.normal(1.0, 0.5, n),
                     rng.binomial(6, 0.7, n).astype(float)], axis=1)


CIRCUITS = {
    **{f"image-{kind}-{spl}-em{int(em)}": (_image(kind, spl, em), kind)
       for kind in ("gaussian", "binomial") for spl in ("cp", "tucker") for em in (False, True)},
    "image-embedding-cp": (_image("embedding", "cp", False), "embedding"),
    "image-embedding-tucker": (_image("embedding", "tucker", False), "embedding"),
    "tabular": (_tabular(False), "tabular"),
    "tabular-em": (_tabular(True), "tabular"),
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuit_forward_marginals_and_map_match_jax(name):
    build, kind = CIRCUITS[name]
    jcc, jstore, cc, store = _both(build, optimize=True)
    rng = np.random.default_rng(7)
    x = _tabular_x(rng, 12) if kind == "tabular" else _image_x(kind, rng, 12)
    mask = rng.random(x.shape) < 0.5
    with torch.no_grad():
        _close(cc(store, torch.as_tensor(x)), jcc(jstore, jnp.asarray(x)))
    _close(IntegrateQuery(cc)(x, integrate_vars=mask, store=store),
           JaxIntegrateQuery(jcc)(jnp.asarray(x), integrate_vars=jnp.asarray(mask),
                                  store=jstore))
    asg, vals = MAPQuery(cc)(x, evidence_mask=mask, store=store)
    jasg, jvals = JaxMAPQuery(jcc)(jnp.asarray(x), evidence_mask=jnp.asarray(mask),
                                   store=jstore)
    _close(vals, jvals)
    np.testing.assert_allclose(asg.numpy(), np.asarray(jasg), rtol=RTOL)
    # the conditional sampler's log-evidence is JAX's marginal of the evidence
    sample = lambda: SamplingQuery(cc).conditional(  # noqa: E731
        x, evidence_mask=mask, generator=torch.Generator().manual_seed(0), store=store)
    if kind == "embedding":
        with pytest.raises(TypeError, match="Sampling is not supported"):
            sample()
        return
    samples, log_ev = sample()
    want = JaxIntegrateQuery(jcc)(jnp.asarray(x), integrate_vars=jnp.asarray(~mask),
                                  store=jstore)[:, 0, 0]
    _close(log_ev, want)
    assert torch.equal(samples[torch.as_tensor(mask)], torch.as_tensor(x[mask]).to(samples.dtype))
    assert bool(samples.isfinite().all())


def _categorical_pc(sy, scope):
    rng = np.random.default_rng(17)
    k = 2
    leaves = [sy.CategoricalLayer(scope([v]), k, num_categories=3, probs=sy.Parameter.from_input(
        _const(sy, rng.dirichlet(np.ones(3), size=k)))) for v in range(4)]
    prods = [sy.HadamardLayer(k, arity=2) for _ in range(2)]
    mids = [sy.SumLayer(k, k, weight=sy.Parameter.from_input(
        _const(sy, rng.dirichlet(np.ones(k), size=k)))) for _ in range(2)]
    top = sy.HadamardLayer(k, arity=2)
    root = sy.SumLayer(k, 1, weight=sy.Parameter.from_input(
        _const(sy, rng.dirichlet(np.ones(k))[None])))
    return sy.Circuit(
        leaves + prods + mids + [top, root],
        {prods[0]: leaves[:2], prods[1]: leaves[2:], mids[0]: [prods[0]],
         mids[1]: [prods[1]], top: mids, root: [top]}, [root])


def _evidence_base(kind: str):
    def build(sy):
        s, scope = sy
        if kind == "categorical":
            return _categorical_pc(s, scope)
        return _leaf_circuit(s, scope, kind, np.random.default_rng(9))
    return build


EVIDENCE = {"categorical": {0: 1, 1: 0, 2: 2}, "gaussian": {0: 0.3, 2: -1.2},
            "binomial-probs": {1: 4}, "embedding": {0: 3, 1: 1}}


@pytest.mark.parametrize("fold,optimize", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("kind", list(EVIDENCE))
def test_evidence_circuit_matches_jax(kind, fold, optimize):
    flags = dict(semiring="lse-sum", fold=fold, optimize=optimize)
    base = _evidence_base(kind)
    obs = EVIDENCE[kind]
    jctx = JaxPipelineContext(**flags)
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    jsc, tsc = base(JAX), base(PORT)
    jcc, cc = jctx.compile(jsc), ctx.compile(tsc)
    jecc, ecc = jctx.compile(JSF.evidence(jsc, obs)), ctx.compile(TSF.evidence(tsc, obs))
    assert set(ctx.parameters) == set(jctx.parameters)
    ctx.load_parameters({s: np.asarray(v) for s, v in jctx.parameters.items()})
    assert any(isinstance(l, TorchEvidenceLayer) for l in ecc.layers)
    # the wrapped leaves' slots are the circuit's too
    assert set(ecc.used_slots) == set(jecc.used_slots)
    nv = 4 if kind == "categorical" else 3
    x = np.zeros((5, nv)) if kind == "gaussian" else np.zeros((5, nv), np.int64)
    x[:, [v for v in range(nv) if v not in obs]] = (
        np.random.default_rng(3).normal(size=(5, nv - len(obs))) if kind == "gaussian"
        else np.random.default_rng(3).integers(0, 2, size=(5, nv - len(obs))))
    for v, val in obs.items():
        x[:, v] = val
    out = ecc(torch.as_tensor(x))
    _close(out, jecc(jnp.asarray(x)))
    # pinning the observed variables: the base circuit at the observation
    _close(out, cc(torch.as_tensor(x)).detach().numpy(), rtol=1e-9)
    # the free variables summed out: the marginal of the observation
    # a mask over the evidence circuit's variables, 0 to its largest one
    free_vars = [v for v in range(nv) if v not in obs]
    free = np.zeros((1, max(free_vars) + 1), bool)
    free[0, free_vars] = True
    _close(IntegrateQuery(ecc)(x, integrate_vars=free),
           JaxIntegrateQuery(jecc)(jnp.asarray(x), integrate_vars=jnp.asarray(free)))


@pytest.mark.parametrize("fold", [False, True])
def test_product_of_gaussian_circuits_matches_jax(fold):
    """multiply of two Gaussian circuits: Gaussian leaves with a log-partition
    over the three GaussianProduct nodes; its integral by the leaves'
    ``integrate``."""
    flags = dict(semiring="lse-sum", fold=fold, optimize=True)
    builds = [lambda sy, s=s: _leaf_circuit(sy[0], sy[1], "gaussian", np.random.default_rng(s))
              for s in (11, 12)]
    jctx = JaxPipelineContext(**flags)
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    j1, j2 = (jctx.compile(b(JAX)) for b in builds)
    c1, c2 = (ctx.compile(b(PORT)) for b in builds)
    jp, tp = jctx.multiply(j1, j2), ctx.multiply(c1, c2)
    jz, tz = jctx.integrate(jp), ctx.integrate(tp)
    ctx.load_parameters({s: np.asarray(v) for s, v in jctx.parameters.items()})
    assert any(isinstance(l, TorchGaussianLayer) and l.log_partition is not None
               for l in tp.layers)
    x = np.random.default_rng(13).normal(size=(6, 3))
    _close(tp(torch.as_tensor(x)), jp(jnp.asarray(x)))
    _close(tp(torch.as_tensor(x)), (c1(torch.as_tensor(x)) + c2(torch.as_tensor(x))).detach()
           .numpy(), rtol=1e-9)
    _close(tz(batch_size=1), jz(batch_size=1))
