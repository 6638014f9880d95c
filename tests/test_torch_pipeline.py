"""The port's slice end to end against the JAX package, on the CPU.

The same ``image_data`` circuit is built in both packages (``cirkit_tpu``
and its PyTorch port ``cirkit_tpu_torch``) over the fold x optimize grid.
The compiled stores must have the same slot names and shapes; the JAX
store is carried into the port by name (``store_from_numpy`` /
``load_parameters``) and one numpy batch goes through both:

- in float64 against the JAX XLA path, to rtol 1e-9;
- in float32 against the JAX Pallas kernels in interpret mode, to 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.ops import lse_einsum as T
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils.checkpoint import store_from_numpy


def _circuit_args(shape, spl, k, *, fold=True, optimize=True, em_ready=False,
                  semiring="lse-sum"):
    kw = dict(
        input_layer="categorical",
        num_input_units=k,
        sum_product_layer=spl,
        num_sum_units=k,
        em_ready=em_ready,
    )
    return kw, dict(semiring=semiring, fold=fold, optimize=optimize)


def _compile_port(shape, spl, k, **options):
    kw, flags = _circuit_args(shape, spl, k, **options)
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    return ctx, ctx.compile(image_data(shape, "quad-graph", **kw))


def _compile_both(shape, spl, k, **options):
    kw, flags = _circuit_args(shape, spl, k, **options)
    jctx = JaxPipelineContext(**flags)
    jcc = jctx.compile(jax_image_data(shape, "quad-graph", **kw))
    return (jctx, jcc, *_compile_port(shape, spl, k, **options))


def _batch(shape, n=16, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, int(np.prod(shape))))


def _jax_eval(jctx, jcc, x, dtype):
    store = {s: jax.numpy.asarray(v, dtype) for s, v in jctx.parameters.items()}
    return np.asarray(jax.jit(jcc.evaluate)(store, jax.numpy.asarray(x)))


@pytest.mark.parametrize(
    "shape,spl,k,fold,optimize,em_ready,semiring",
    [
        *[
            ((1, 4, 4), spl, 4, fold, opt, False, "lse-sum")
            for spl in ("cp", "tucker")
            for fold in (False, True)
            for opt in (False, True)
        ],
        ((1, 8, 8), "cp", 8, True, True, False, "lse-sum"),
        ((1, 8, 8), "tucker", 8, True, True, False, "lse-sum"),
        ((1, 4, 4), "tucker", 4, True, True, True, "lse-sum"),
        ((1, 4, 4), "cp", 4, True, True, False, "sum-product"),
        ((1, 4, 4), "tucker", 4, True, True, False, "sum-product"),
        # the flagship's structure at K=2: sum-collapse gives MatMul weights
        ((1, 28, 28), "cp", 2, True, True, False, "lse-sum"),
    ],
)
def test_slice_matches_jax_float64(shape, spl, k, fold, optimize, em_ready, semiring):
    jctx, jcc, ctx, cc = _compile_both(
        shape, spl, k, fold=fold, optimize=optimize, em_ready=em_ready, semiring=semiring
    )
    assert isinstance(cc, TorchCircuit)
    jax_shapes = {s: tuple(v.shape) for s, v in jctx.parameters.items()}
    assert {s: tuple(v.shape) for s, v in ctx.parameters.items()} == jax_shapes
    assert [type(l).__name__[5:] for l in cc.layers] == [
        type(l).__name__[3:] for l in jcc.layers
    ]

    ctx.load_parameters({s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()})
    x = _batch(shape)
    ref = _jax_eval(jctx, jcc, x, np.float64)
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0
    with torch.no_grad():
        out = cc(torch.as_tensor(x))
    assert out.dtype == torch.float64 and out.shape == (len(x), 1, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9)
    assert all(n == 0 for n in T.LAUNCHES.values())


@pytest.mark.parametrize("spl", ["cp", "tucker"])
def test_slice_matches_jax_kernels_float32(spl, monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    shape = (1, 4, 4)
    jctx, jcc, ctx, cc = _compile_both(shape, spl, 8)
    ctx.load_parameters({s: np.asarray(v, np.float32) for s, v in jctx.parameters.items()})
    x = _batch(shape, n=8, seed=1)
    ref = _jax_eval(jctx, jcc, x, np.float32)
    with torch.no_grad():
        out = cc(torch.as_tensor(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_store_from_numpy_checks_names_and_shapes():
    ctx, cc = _compile_port((1, 4, 4), "cp", 4)
    arrays = {s: v.detach().numpy() for s, v in ctx.parameters.items()}
    store = store_from_numpy(arrays, device="cpu", dtype=torch.float64, slots=cc.slots)
    assert all(t.dtype == torch.float64 for t in store.values())
    name = next(iter(arrays))
    with pytest.raises(KeyError, match="missing"):
        store_from_numpy({k: v for k, v in arrays.items() if k != name}, device="cpu",
                         slots=cc.slots)
    with pytest.raises(ValueError, match=name):
        store_from_numpy({**arrays, name: arrays[name][:1, :1]}, device="cpu", slots=cc.slots)


def test_reset_parameters_is_seeded():
    ctx, cc = _compile_port((1, 4, 4), "tucker", 4)
    x = torch.as_tensor(_batch((1, 4, 4)))
    with torch.no_grad():
        first = cc(x)
        ctx.reset_parameters(seed=0)
        again = cc(x)
        ctx.reset_parameters(seed=1)
        other = cc(x)
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    assert not torch.equal(first, other)
    assert all(p.requires_grad for p in ctx.parameters.values())


# --------------------------------------------------------------------------- #
# The reference's pipeline API: extensibility hooks, data-free evaluation,
# parameter counts and the symbolic placement
# --------------------------------------------------------------------------- #


def _rule_pc(S, Sc, rng):
    """``tests/backend/test_optimization.py:206``'s circuit: two categorical
    leaves, a Hadamard and a dense sum of two outputs."""
    from tests.test_torch_expectation import const

    probs = rng.uniform(0.1, 1.0, (2, 3, 2))
    ins = [S.CategoricalLayer(Sc([v]), 3, num_categories=2,
                              probs=const(S, probs[v] / probs[v].sum(1, keepdims=True)))
           for v in range(2)]
    h = S.HadamardLayer(3, arity=2)
    s = S.SumLayer(3, 2, weight=const(S, rng.uniform(0.1, 1.0, (2, 3))))
    return S.Circuit(ins + [h, s], {h: ins, s: [h]}, [s])


def _exp_log_pc(S, Sc, rng):
    """``test_optimization.py:250``'s circuit: a sum whose weight is
    ``exp(log(w))``."""
    from tests.test_torch_expectation import const

    w = rng.uniform(0.1, 1.0, (2, 3))
    leaf = S.TensorParameter(2, 3, initializer=S.ConstantTensorInitializer(w))
    weight = S.Parameter.from_unary(S.ExpParameter(leaf.shape),
                                    S.Parameter.from_unary(S.LogParameter(leaf.shape), leaf))
    probs = rng.uniform(0.1, 1.0, (3, 2))
    x0 = S.CategoricalLayer(Sc([0]), 3, num_categories=2,
                            probs=const(S, probs / probs.sum(1, keepdims=True)))
    s = S.SumLayer(3, 2, weight=weight)
    return S.Circuit([x0, s], {s: [x0]}, [s])


def _both_with_rules(build, register, seed):
    """``build`` compiled in both packages (sum-product, folded, optimized)
    after ``register(ctx, package)`` added the user rules; the JAX store
    carried over. Returns (JAX outputs, port outputs) on every world."""
    from tests.reference_eval import enumerate_worlds
    from tests.test_torch_expectation import JAX, PORT

    flags = dict(semiring="sum-product", fold=True, optimize=True)
    jctx = JaxPipelineContext(**flags)
    register(jctx, "jax")
    jcc = jctx.compile(build(*JAX, np.random.default_rng(seed)))
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    register(ctx, "torch")
    cc = ctx.compile(build(*PORT, np.random.default_rng(seed)))
    ctx.load_parameters({s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()})
    nv = max(cc.scope) + 1
    worlds = enumerate_worlds(nv, 2)
    return cc, np.asarray(jcc(worlds)), cc(torch.as_tensor(worlds)).detach().numpy()


def test_user_layer_optimization_rule_matches_jax():
    """A fusion rule registered through ``ctx.add_layer_optimization_rule``
    fires in place of the default one (a CP-T layer of a distinct type) and
    gives JAX's outputs; ``shatter=True`` files it with the shatter rules."""
    from cirkit_tpu.backend.jax import optimization as JO
    from cirkit_tpu.backend.jax.layers import JaxHadamardLayer, JaxSumLayer
    from cirkit_tpu.backend.jax.optimized import JaxCPTLayer
    from cirkit_tpu_torch.backend.torch import optimization as TO
    from cirkit_tpu_torch.backend.torch.layers import TorchHadamardLayer, TorchSumLayer
    from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer

    marked = {"jax": type("MarkedCPT", (JaxCPTLayer,), {}),
              "torch": type("MarkedCPT", (TorchCPTLayer,), {})}

    def register(ctx, pkg):
        O, sum_l, had_l = ((JO, JaxSumLayer, JaxHadamardLayer) if pkg == "jax"
                           else (TO, TorchSumLayer, TorchHadamardLayer))

        def apply(compiler, match):
            dense, hadamard = match.entries
            return (marked[pkg](hadamard.num_input_units, dense.num_output_units,
                                hadamard.arity, weight=dense.weight,
                                semiring=compiler.semiring),)

        pattern = O.LayerOptPattern(entries=(sum_l, had_l), configs=({"arity": 1}, {}))
        ctx.add_layer_optimization_rule(pattern, apply)

    cc, want, got = _both_with_rules(_rule_pc, register, 36)
    assert any(type(l) is marked["torch"] for l in cc.layers)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    ctx = PipelineContext(device="cpu")
    ctx.add_layer_optimization_rule("pattern", len, shatter=True)
    assert dict(ctx._compiler.layer_shatter_opt_rules.items())["pattern"] is len
    assert "pattern" not in dict(ctx._compiler.layer_fuse_opt_rules.items())


def test_user_parameter_optimization_rule_matches_jax():
    """A parameter rule collapsing ``exp(log(w))`` to ``w`` fires, and the
    outputs are JAX's under the same rule."""
    from cirkit_tpu.backend.jax import optimization as JO
    from cirkit_tpu.backend.jax import parameters as JP
    from cirkit_tpu_torch.backend.torch import optimization as TO
    from cirkit_tpu_torch.backend.torch import parameters as TP

    def register(ctx, pkg):
        O, P, exp_p, log_p, clamp_p = (
            (JO, JP, JP.JaxExpParameter, JP.JaxLogParameter, JP.JaxClampParameter)
            if pkg == "jax" else
            (TO, TP, TP.TorchExpParameter, TP.TorchLogParameter, TP.TorchClampParameter))

        def apply(compiler, match):
            return (clamp_p(match.entries[1].in_shapes[0], vmin=None, vmax=None),)

        ctx.add_parameter_optimization_rule(O.ParameterOptPattern(entries=(exp_p, log_p)),
                                            apply)

    cc, want, got = _both_with_rules(_exp_log_pc, register, 37)
    kinds = {type(n).__name__ for l in cc.layers for p in l.params.values() for n in p.nodes}
    assert "TorchExpParameter" not in kinds and "TorchLogParameter" not in kinds
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_pipeline_context_hooks_and_lookups():
    """``ctx[sc]``, ``is_compiled``, ``has_symbolic``, ``get_compiled_circuit``,
    the compilation-rule hooks and ``add_operator_rule`` as in JAX's
    ``pipeline.py:59-150``; the default context needs the card."""
    from cirkit_tpu_torch.symbolic.circuit import CircuitBlock
    from cirkit_tpu_torch.symbolic.layers import CategoricalLayer, LayerOperator
    from cirkit_tpu_torch.utils.scope import Scope
    from tests.test_torch_expectation import PORT

    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    sc = _rule_pc(*PORT, np.random.default_rng(0))
    assert not ctx.is_compiled(sc)
    cc = ctx.compile(sc)
    assert ctx.is_compiled(sc) and ctx.has_symbolic(cc)
    assert ctx[sc] is cc and ctx.get_compiled_circuit(sc) is cc
    assert ctx.get_symbolic_circuit(cc) is sc

    calls = []

    def integrate_rule(sl: CategoricalLayer, *, scope: Scope) -> CircuitBlock:
        calls.append(sl)
        raise RuntimeError("user integration rule")

    ctx.add_operator_rule(LayerOperator.INTEGRATION, integrate_rule)
    with pytest.raises(RuntimeError, match="user integration rule"):
        ctx.integrate(cc)
    assert calls
    for hook, registry in (("add_layer_compilation_rule", "_layer_registry"),
                           ("add_parameter_compilation_rule", "_parameter_registry"),
                           ("add_initializer_compilation_rule", "_initializer_registry")):
        assert hasattr(ctx, hook) and hasattr(ctx._compiler, registry)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelineContext.from_default_backend()


def test_integrated_circuit_evaluates_without_data():
    """``cc(batch_size=1)`` evaluates a circuit with no variables, as JAX's
    does (``tests/backend/test_compile_circuit.py:60``); ``evaluate_raw``
    with neither ``x`` nor ``batch_size`` needs a ``module_fn``, whose input
    layers then receive None."""
    from tests.test_torch_expectation import JAX, PORT

    flags = dict(semiring="lse-sum", fold=True)
    jctx = JaxPipelineContext(**flags)
    jicc = jctx.integrate(jctx.compile(_rule_pc(*JAX, np.random.default_rng(5))))
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    cc = ctx.compile(_rule_pc(*PORT, np.random.default_rng(5)))
    icc = ctx.integrate(cc)
    ctx.load_parameters({s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()})
    want = np.asarray(jicc(batch_size=1))
    got = icc(batch_size=1)
    assert got.shape == (1, 1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-9)
    assert icc(ctx.parameters, batch_size=3).shape == (3, 1, 2)
    assert icc.evaluate(dict(ctx.parameters), batch_size=2).shape == (2, 1, 2)
    with pytest.raises(ValueError, match="batch size"):
        icc()
    seen = []

    def module_fn(layer, st, xin):
        seen.append(xin)
        return layer(st, xin) if xin is not None else layer.integrate(st)[:, None, :]

    out = cc.evaluate_raw(ctx.parameters, None, module_fn=module_fn)
    assert seen[0] is None and out.shape == (1, 1, 2)


def test_num_parameters_takes_learnable_only():
    """``num_parameters(store=None, *, learnable_only=False)`` as JAX's:
    constant literal logits are not learnable."""
    from tests.test_torch_cross import logic_pc
    from tests.test_torch_expectation import JAX, PORT

    w = np.random.default_rng(0).uniform(0.1, 1.0, size=(3, 2))
    jcc = JaxPipelineContext(semiring="lse-sum", fold=True).compile(logic_pc(w)(*JAX, None))
    cc = PipelineContext(semiring="lse-sum", fold=True, device="cpu").compile(
        logic_pc(w)(*PORT, None))
    for kw in ({}, {"learnable_only": True}, {"learnable_only": False}):
        assert cc.num_parameters(**kw) == jcc.num_parameters(**kw)
    assert cc.num_parameters(learnable_only=True) < cc.num_parameters()
    assert cc.num_parameters(None, learnable_only=True) == jcc.num_parameters(None,
                                                                               learnable_only=True)


@pytest.mark.parametrize("fold,optimize", [(False, False), (True, False), (True, True)])
def test_symbolic_fold_placement_matches_jax(fold, optimize):
    """The symbolic layer -> (plan entry, fold) map of an unoptimized
    compile, entry for entry as JAX's (layers matched by their position in
    the symbolic topological order); None when optimized."""
    kw, flags = _circuit_args((1, 4, 4), "tucker", 2, fold=fold, optimize=optimize)
    jsc = jax_image_data((1, 4, 4), "quad-graph", **kw)
    sc = image_data((1, 4, 4), "quad-graph", **kw)
    jcc = JaxPipelineContext(**flags).compile(jsc)
    cc = PipelineContext(**flags, device="cpu").compile(sc)
    if optimize:
        assert cc._symbolic_fold is None and jcc._symbolic_fold is None
        return
    jpos = {l: i for i, l in enumerate(jsc.topological_ordering())}
    pos = {l: i for i, l in enumerate(sc.topological_ordering())}
    got = {pos[sl]: p for sl, p in cc._symbolic_fold.items()}
    want = {jpos[sl]: p for sl, p in jcc._symbolic_fold.items()}
    assert got == want and len(got) == len(pos)
