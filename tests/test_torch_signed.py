"""The port's signed semiring, squared circuits and circuit operators against
the JAX package, on the CPU.

- **Ops.** The plain versions of the signed log-einsum-exp ops
  (``cirkit_tpu_torch.ops.slse_einsum``) against JAX's: in float32 against
  the Pallas kernels in interpret mode (``slse_dispatch``, forced with
  ``CIRKIT_TPU_FORCE_PALLAS``; O >= 8, a ragged batch that spans two batch
  tiles) to 5e-4, and in float64 against ``SignedLSESemiring``'s XLA
  composition to 1e-9. A signed sum that nearly cancels has a log-magnitude
  no float32 computation gets to any bound, so values are compared in
  linear space scaled by the row's absolute mass: ``|s exp(a - A) - s'
  exp(a' - A)|`` with ``A`` the lse of the inputs against ``|w|``. The
  gradients of the log-magnitudes and of the weight against ``jax.vjp``, to
  5e-3 in float32 and 1e-10 in float64; an exact cancellation and a row
  that is all -inf.
- **Circuits.** The non-monotonic circuit of ``tests/backend/test_sos.py``,
  its square ``multiply(conjugate(cc), cc)`` and the square's integral over
  the fold x optimize grid, against enumeration and against JAX in float64
  (rtol 1e-9), the signed ``IntegrateQuery`` and the SoS NLL's gradients.
- **bench.py's SoS circuit** (``bench_sos``: CP on a quad tree, unconstrained
  normal sum weights) at 6x6, K=4: the same plan as JAX's, the JAX store
  loaded by slot name, and the square, its integral and the gradients of
  every slot against JAX in float64.
- **Any circuit under the signed semiring.** Tucker and CP QuadGraph
  circuits equal their lse-sum results, with every sign +1.
- **The operators** of ``PipelineContext`` (integrate, multiply, conjugate,
  mixture, concatenate) against JAX's, including the product grids of
  ``tests/symbolic/test_operators.py``, and the module-level functions.

On the CPU the ops run their plain versions and launch no kernel; the
kernels themselves are tested on the card (``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cirkit_tpu.symbolic as JS
import cirkit_tpu_torch.symbolic as TS
import cirkit_tpu_torch.symbolic.functional as TSF
from cirkit_tpu.backend.jax import queries as JQ
from cirkit_tpu.backend.jax.semiring import SignedLSESemiring as JSigned
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.models.utils import Parameterization as JParameterization
from cirkit_tpu.ops.lse_einsum import slse_dispatch
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu.utils import Scope as JScope
from cirkit_tpu_torch import pipeline as P
from cirkit_tpu_torch.backend.torch import IntegrateQuery
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.models.utils import Parameterization
from cirkit_tpu_torch.ops import lse_einsum as L
from cirkit_tpu_torch.ops import slse_einsum as S
from cirkit_tpu_torch.parallel import split_trainable
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils import Scope
from tests.reference_eval import enumerate_worlds, eval_circuit, partition_function

F, I, K1, K2 = 3, 32, 8, 16
OPS = ["slse_matmul", "slse_matmul_softmax", "slse_tucker2", "slse_tucker2_softmax"]
JAX = (JS, JScope)
PORT = (TS, Scope)


@pytest.fixture(autouse=True)
def _zero_launches():
    for op in L.LAUNCHES:
        L.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in L.LAUNCHES.values()), "a CPU test launched a kernel"


# --------------------------------------------------------------------------- #
# Ops
# --------------------------------------------------------------------------- #


def _inputs(op: str, b: int, o: int, dtype, seed: int = 0) -> list[np.ndarray]:
    """(log-magnitude, sign) inputs, some signs 0, and real weights of both
    signs (or softmax logits) for ``op``."""
    rng = np.random.default_rng(seed)

    def signed(*shape):
        a = (rng.normal(size=shape) * 3.0 - 2.0).astype(dtype)
        s = rng.choice([-1.0, 0.0, 1.0], size=shape, p=[0.45, 0.1, 0.45]).astype(dtype)
        return [a, s]

    tucker = "tucker" in op
    xs = [*signed(F, b, K1), *signed(F, b, K2)] if tucker else signed(F, b, I)
    w = rng.normal(size=(F, o, K1 * K2 if tucker else I)).astype(dtype)
    return [*xs, w]


def _jax_op(op: str, ins, *, pallas: bool):
    """JAX's signed op on ``ins``: the Pallas kernel (interpret mode) or the
    semiring's XLA composition."""
    *xs, w = ins
    softmax, tucker = "softmax" in op, "tucker" in op
    if pallas:
        out = slse_dispatch(tuple(xs), w, softmax=softmax, tucker=tucker, interpret=True)
        assert out is not None
        return out
    hook = {"slse_matmul": "matmul", "slse_matmul_softmax": "matmul_softmax",
            "slse_tucker2": "tucker2", "slse_tucker2_softmax": "tucker2_softmax"}[op]
    pairs = ((xs[0], xs[1]), (xs[2], xs[3])) if tucker else ((xs[0], xs[1]),)
    return getattr(JSigned, hook)(*pairs, w)


def _abs_mass(op: str, ins) -> np.ndarray:
    """The lse of the log-magnitudes against ``|w|``, the log of the row's
    absolute mass: the scale of the linear-space comparison."""
    t = [torch.as_tensor(np.asarray(x, np.float64)) for x in ins]
    w = torch.softmax(t[-1], dim=-1) if "softmax" in op else t[-1].abs()
    if "tucker" in op:
        return L.lse_tucker2_ref(t[0], t[2], w).numpy()
    return L.lse_matmul_ref(t[0], w).numpy()


def _assert_signed_close(op, ins, got, want, tol):
    """``|s exp(a - A) - s' exp(a' - A)| <= tol`` with A the absolute mass;
    signs equal wherever ``|y| / Y_abs`` exceeds ``tol``; -inf where the
    mass is 0."""
    (ga, gs), (wa, ws) = [tuple(np.asarray(v, np.float64) for v in p) for p in (got, want)]
    m = _abs_mass(op, ins)
    assert not np.isnan(ga).any() and not np.isnan(gs).any()
    empty = np.isneginf(m)
    assert np.isneginf(ga[empty]).all() and (gs[empty] == 0).all()
    with np.errstate(invalid="ignore"):
        lin_g = np.where(empty, 0.0, gs * np.exp(ga - m))
        lin_w = np.where(empty, 0.0, ws * np.exp(wa - m))
    np.testing.assert_allclose(lin_g, lin_w, rtol=0, atol=tol)
    big = np.abs(lin_w) > tol
    np.testing.assert_array_equal(gs[big], ws[big])


@pytest.mark.parametrize("o", [1, 16])
@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_jax_xla_float64(op, b, o):
    ins = _inputs(op, b, o, np.float64)
    want = _jax_op(op, [jnp.asarray(a) for a in ins], pallas=False)
    got = getattr(S, op)(*(torch.as_tensor(a) for a in ins))
    assert all(t.dtype == torch.float64 and t.shape == (F, b, o) for t in got)
    _assert_signed_close(op, ins, got, want, 1e-9)


@pytest.mark.parametrize("op", OPS)
def test_plain_matches_jax_pallas_interpret_float32(op, monkeypatch):
    """B = 264: two batch tiles of 256 rows for the JAX kernel, the second
    ragged (its padding: log-magnitudes -FLT_MAX, signs +1)."""
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    ins = _inputs(op, 264, 16, np.float32, seed=1)
    want = _jax_op(op, [jnp.asarray(a) for a in ins], pallas=True)
    got = getattr(S, op)(*(torch.as_tensor(a) for a in ins))
    assert all(t.dtype == torch.float32 for t in got)
    _assert_signed_close(op, ins, got, want, 5e-4)


def _grads_both(op, ins, *, pallas: bool):
    """The gradients of the log-magnitude inputs and of the weight, for a
    seeded cotangent of the log-magnitude output: JAX's (``jax.vjp``) and
    the port's (autograd through the op's backward)."""
    *xs, w = ins
    diff = [*xs[::2], w]  # log-magnitudes and the weight
    g = np.random.default_rng(5).normal(size=(F, xs[0].shape[1], w.shape[1])).astype(w.dtype)

    def jfun(*d):
        full = [d[0], xs[1], d[1], xs[3], d[2]] if len(d) == 3 else [d[0], xs[1], d[1]]
        return _jax_op(op, [jnp.asarray(a) for a in full], pallas=pallas)[0]

    _, vjp = jax.vjp(jfun, *(jnp.asarray(a) for a in diff))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    t = [torch.as_tensor(a).requires_grad_(k % 2 == 0 or k == len(ins) - 1)
         for k, a in enumerate(ins)]
    oa, os = getattr(S, op)(*t)
    assert not os.requires_grad
    got = torch.autograd.grad(oa, [x for x in t if x.requires_grad], torch.as_tensor(g))
    return [v.numpy() for v in got], want


@pytest.mark.parametrize("op", OPS)
def test_gradients_match_jax_float64(op):
    ins = _inputs(op, 13, 16, np.float64, seed=2)
    got, want = _grads_both(op, ins, pallas=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max())


@pytest.mark.parametrize("op", OPS)
def test_gradients_match_jax_pallas_interpret_float32(op, monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    ins = _inputs(op, 13, 16, np.float32, seed=3)
    got, want = _grads_both(op, ins, pallas=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3)


def test_exact_cancellation_gives_sign_zero_and_no_nan(monkeypatch):
    """``tests/ops/test_lse_einsum.py::test_slse_exact_cancellation_sign_zero_no_nan``:
    inputs of equal magnitude with alternating signs against equal weights
    sum to exactly 0, which is log -inf with sign 0, and zero gradients."""
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    a = np.zeros((1, 8, 16), np.float32)
    s = np.tile(np.array([1.0, -1.0], np.float32), 8)[None, None, :].repeat(8, 1)
    w = np.ones((1, 8, 16), np.float32)
    ja, js = slse_dispatch((jnp.asarray(a), jnp.asarray(s)), jnp.asarray(w), softmax=False,
                           tucker=False, interpret=True)
    ta, tw = torch.as_tensor(a).requires_grad_(), torch.as_tensor(w).requires_grad_()
    oa, os = S.slse_matmul(ta, torch.as_tensor(s), tw)
    assert torch.isneginf(oa).all() and (os == 0).all()
    assert np.isneginf(np.asarray(ja)).all() and (np.asarray(js) == 0).all()
    da, dw = torch.autograd.grad(oa, [ta, tw], torch.ones_like(oa))
    assert (da == 0).all() and (dw == 0).all()


@pytest.mark.parametrize("op", OPS)
def test_row_of_neg_inf_gives_neg_inf(op):
    ins = [torch.as_tensor(a).requires_grad_() for a in _inputs(op, 8, 16, np.float32)]
    with torch.no_grad():
        ins[0][1, 3] = float("-inf")
    oa, os = getattr(S, op)(*ins)
    assert torch.isneginf(oa[1, 3]).all() and (os[1, 3] == 0).all()
    assert not torch.isnan(oa).any()
    grads = torch.autograd.grad(oa, [ins[0], ins[-1]], torch.ones_like(oa))
    assert not any(torch.isnan(g).any() for g in grads)
    assert (grads[0][1, 3] == 0).all()


def test_sign_inputs_get_no_gradient():
    """The sign is piecewise constant: the op returns no gradient for the
    sign inputs (the JAX kernel's ds output never reaches a parameter)."""
    a, s, w = (torch.as_tensor(v).requires_grad_() for v in _inputs("slse_matmul", 8, 16,
                                                                  np.float64))
    oa, _ = S.slse_matmul(a, s, w)
    da, ds, dw = torch.autograd.grad(oa.sum(), [a, s, w], allow_unused=True)
    assert ds is None and da is not None and dw is not None


# --------------------------------------------------------------------------- #
# The non-monotonic circuit, its square and the square's integral
# --------------------------------------------------------------------------- #


def _const(Sy, value):
    value = np.asarray(value, np.float64)
    return Sy.Parameter.from_input(Sy.TensorParameter(
        *value.shape, initializer=Sy.ConstantTensorInitializer(value), learnable=True))


def _nonmonotonic_pc(Sy, Sc):
    """``tests/backend/test_sos.py::_nonmonotonic_pc``: a negative sum
    weight, so c(x) < 0 for some x."""
    p0 = np.array([[0.2, 0.5, 0.3], [0.6, 0.1, 0.3]])
    p1 = np.array([[0.4, 0.4, 0.2], [0.1, 0.8, 0.1]])
    l0 = Sy.CategoricalLayer(Sc([0]), 2, num_categories=3, probs=_const(Sy, p0))
    l1 = Sy.CategoricalLayer(Sc([1]), 2, num_categories=3, probs=_const(Sy, p1))
    h = Sy.HadamardLayer(2, arity=2)
    s = Sy.SumLayer(2, 1, weight=_const(Sy, [[0.9, -0.7]]))
    return Sy.Circuit([l0, l1, h, s], {h: [l0, l1], s: [h]}, [s])


def _squared_both(build, *, fold, optimize):
    """``cc``, ``sq = multiply(conjugate(cc), cc)`` and ``zc = integrate(sq)``
    in both packages under the signed semiring, the JAX store carried into
    the port by slot name (pointer and constant slots included)."""
    flags = dict(semiring="signed-lse-sum", fold=fold, optimize=optimize)
    out = []
    for Ctx, sy, kw in ((JaxPipelineContext, JAX, {}), (PipelineContext, PORT,
                                                         dict(device="cpu", seed=0))):
        ctx = Ctx(**flags, **kw)
        cc = ctx.compile(build(*sy))
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        out.append((ctx, cc, sq, ctx.integrate(sq)))
    (jctx, *_), (ctx, *_) = out
    ctx.load_parameters({k: np.asarray(v) for k, v in jctx.parameters.items()})
    return out


def _linear(pair) -> np.ndarray:
    a, s = (np.asarray(v.detach() if isinstance(v, torch.Tensor) else v) for v in pair)
    return s * np.exp(a)


GRID = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("which", ["cc", "sq", "zc"])
@pytest.mark.parametrize("fold,optimize", GRID)
def test_squared_circuit_matches_enumeration_and_jax(fold, optimize, which):
    (_, *jaxs), (_, *ports) = _squared_both(_nonmonotonic_pc, fold=fold, optimize=optimize)
    k = ["cc", "sq", "zc"].index(which)
    worlds = enumerate_worlds(2, 3)
    x = worlds[:1] if which == "zc" else worlds
    c = eval_circuit(_nonmonotonic_pc(*JAX), worlds)[:, 0, 0]
    want = {"cc": c, "sq": c**2, "zc": np.array([np.sum(c**2)])}[which]
    ja, js = jaxs[k](jnp.asarray(x))
    ta, ts = ports[k](torch.as_tensor(x))
    assert ta.dtype == torch.float64 and ta.shape == ts.shape == (len(x), 1, 1)
    np.testing.assert_allclose(_linear((ta, ts))[:, 0, 0], want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=1e-9)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if which != "cc":
        assert (ts == 1).all()


@pytest.mark.parametrize("pad", [None, 4])
def test_signed_integrate_query_matches_enumeration_and_jax(pad):
    """``tests/backend/test_signed.py::test_signed_integrate_query``, with
    the batch padded to a multiple of 4 and sliced back or not."""
    (_, _, jsq, _), (_, _, sq, _) = _squared_both(_nonmonotonic_pc, fold=True, optimize=False)
    worlds = enumerate_worlds(2, 3)
    ja, js = JQ.IntegrateQuery(jsq)(worlds, integrate_vars=JScope([1]))
    ta, ts = IntegrateQuery(sq)(torch.as_tensor(worlds), integrate_vars=Scope([1]),
                                pad_batch_to=pad)
    assert ta.shape == ts.shape == (9, 1, 1)
    want = (eval_circuit(_nonmonotonic_pc(*JAX), worlds)[:, 0, 0] ** 2).reshape(3, 3).sum(1)
    got = _linear((ta, ts))[:, 0, 0].reshape(3, 3)
    np.testing.assert_allclose(got, np.repeat(want[:, None], 3, axis=1), rtol=1e-9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _sos_loss_grads_both(jaxs, ports, x):
    """The gradients of ``-mean(log|c(x)|^2) + log Z`` with respect to the
    learnable slots of ``cc`` (the squared circuits read them through
    pointer slots), in both packages."""
    (jctx, jcc, jsq, jzc), (ctx, cc, sq, zc) = jaxs, ports
    store = dict(jctx.parameters)
    tr = {k: v for k, v in store.items() if k in jcc.learnable_slots}
    fr = {k: v for k, v in store.items() if k not in tr}

    def jloss(tr):
        st = {**tr, **fr}
        return -jnp.mean(jsq.evaluate(st, x)[0]) + jzc.evaluate(st, x[:1])[0][0, 0, 0]

    want = jax.jit(jax.grad(jloss))(tr)
    ttr, tfr = split_trainable(cc, ctx.parameters)
    st = {**ttr, **tfr}
    xt = torch.as_tensor(np.array(x))
    loss = -sq.evaluate(st, xt)[0].mean() + zc.evaluate(st, batch_size=1)[0][0, 0, 0]
    got = dict(zip(ttr, torch.autograd.grad(loss, list(ttr.values()))))
    assert set(got) == set(want) and got
    return got, want


@pytest.mark.parametrize("fold", [False, True])
def test_sos_nll_gradients_match_jax(fold):
    """The MLE gradients of ``tests/backend/test_signed.py:65`` (the SoS
    NLL), port against JAX in float64."""
    jaxs, ports = _squared_both(_nonmonotonic_pc, fold=fold, optimize=False)
    got, want = _sos_loss_grads_both(jaxs, ports, enumerate_worlds(2, 3))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


# --------------------------------------------------------------------------- #
# bench.py's SoS circuit at 6x6, K=4
# --------------------------------------------------------------------------- #


def _bench_sos(image, Param):
    """``bench.py:126-165``'s circuit at 6x6, K=4."""
    return image((1, 6, 6), "quad-tree-2", input_layer="categorical", num_input_units=4,
                 sum_product_layer="cp", num_sum_units=4,
                 sum_weight_param=Param(activation="none", initialization="normal"))


def _bench_sos_both():
    builds = {JAX: lambda: _bench_sos(jax_image_data, JParameterization),
              PORT: lambda: _bench_sos(image_data, Parameterization)}
    return _squared_both(lambda *sy: builds[sy](), fold=True, optimize=True)


def _plan(cc, prefix: int):
    return [(type(l).__name__[prefix:], l.num_folds) for l in cc.layers]


@pytest.mark.parametrize("which", ["cc", "sq", "zc"])
def test_bench_sos_plan_matches_jax(which):
    """The same layer types with the same fold counts: TensorDot entries
    from the shatter rules (two at each of the 7 sum depths of 6x6),
    constant-value leaves in the integral."""
    (jctx, *jaxs), (ctx, *ports) = _bench_sos_both()
    k = ["cc", "sq", "zc"].index(which)
    assert _plan(ports[k], len("Torch")) == _plan(jaxs[k], len("Jax"))
    assert {s: tuple(v.shape) for s, v in ctx.parameters.items()} == {
        s: tuple(v.shape) for s, v in jctx.parameters.items()}
    if which != "cc":
        assert sum(n == "TensorDotLayer" for n, _ in _plan(ports[k], 5)) == 14


def test_bench_sos_values_and_gradients_match_jax():
    jaxs, ports = _bench_sos_both()
    x = np.random.default_rng(0).integers(0, 256, (8, 36))
    for jc, tc, rows in ((jaxs[2], ports[2], x), (jaxs[3], ports[3], None)):
        # zc, an integral, takes no data
        ja, js = jc(batch_size=1) if rows is None else jc(jnp.asarray(rows))
        ta, ts = tc(batch_size=1) if rows is None else tc(torch.as_tensor(rows))
        np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), rtol=1e-9)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert (ts == 1).all()
    ca, _ = ports[1](torch.as_tensor(x))
    np.testing.assert_allclose(2 * ca.detach().numpy(),
                               ports[2](torch.as_tensor(x))[0].detach().numpy(), rtol=1e-9)
    got, want = _sos_loss_grads_both(jaxs, ports, jnp.asarray(x))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-10 * float(np.abs(want[k]).max()), err_msg=k)


# --------------------------------------------------------------------------- #
# Any circuit under the signed semiring
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("spl,em_ready", [("tucker", False), ("tucker", True), ("cp", False)])
def test_monotonic_circuit_under_signed_equals_lse_sum(spl, em_ready):
    """A 4x4 QuadGraph circuit, K=4: the signed compile's log-magnitudes and
    gradients equal the lse-sum compile's on the same store, every sign +1."""
    kw = dict(input_layer="categorical", num_input_units=4, sum_product_layer=spl,
              num_sum_units=4, em_ready=em_ready)
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (8, 16)))
    outs, store = {}, None
    for semiring in ("lse-sum", "signed-lse-sum"):
        ctx = PipelineContext(semiring=semiring, fold=True, optimize=True, device="cpu", seed=0)
        cc = ctx.compile(image_data((1, 4, 4), "quad-graph", **kw))
        if store is None:
            store = {k: v.detach().numpy() for k, v in ctx.parameters.items()}
        ctx.load_parameters(store, dtype=torch.float64)
        out = cc(x)
        a = out if semiring == "lse-sum" else out[0]
        grads = torch.autograd.grad(-a.mean(), list(ctx.parameters.values()))
        outs[semiring] = out, dict(zip(ctx.parameters.keys(), grads))
    (ref, ref_grads), ((a, s), grads) = outs["lse-sum"], outs["signed-lse-sum"]
    assert (s == 1).all()
    torch.testing.assert_close(a, ref, rtol=1e-12, atol=0)
    assert grads.keys() == ref_grads.keys()
    for k, g in grads.items():
        torch.testing.assert_close(g, ref_grads[k], rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------------------- #
# The circuit operators of compiled circuits
# --------------------------------------------------------------------------- #


def _leaf(Sy, Sc, rng, v, k, c=3):
    raw = rng.uniform(0.1, 1.0, (k, c))
    return Sy.CategoricalLayer(Sc([v]), k, num_categories=c,
                               probs=_const(Sy, raw / raw.sum(axis=1, keepdims=True)))


def _bivariate(Sy, Sc, seed, product="hadamard", k=2):
    """``tests/fixtures.py::build_bivariate_categorical_pc``."""
    rng = np.random.default_rng(seed)
    leaves = [_leaf(Sy, Sc, rng, v, k) for v in range(2)]
    prod = (Sy.HadamardLayer(k, arity=2) if product == "hadamard"
            else Sy.KroneckerLayer(k, arity=2))
    width = k if product == "hadamard" else k * k
    root = Sy.SumLayer(width, 1, weight=_const(Sy, rng.uniform(0.1, 1.0, (1, width))))
    return Sy.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def _ordered(Sy, Sc, seed, order, product):
    """``tests/symbolic/test_operators.py::test_multiply_kronecker_child_order``:
    a product layer that wires its children out of scope order."""
    rng = np.random.default_rng(seed)
    nv, k = len(order), 2
    leaves = [_leaf(Sy, Sc, rng, v, k) for v in range(nv)]
    prod = (Sy.KroneckerLayer(k, arity=nv) if product == "kronecker"
            else Sy.HadamardLayer(k, arity=nv))
    kin = k**nv if product == "kronecker" else k
    root = Sy.SumLayer(kin, 1, weight=_const(Sy, rng.uniform(0.1, 1.0, (1, kin))))
    return Sy.Circuit(leaves + [prod, root], {prod: [leaves[i] for i in order], root: [prod]},
                      [root])


def _mixing(Sy, Sc, seed, k, arity):
    """``tests/fixtures.py::build_mixing_categorical_pc``: an arity > 1
    mixing sum over parallel Hadamard products (its products need an index
    parameter to permute the Kronecker weight's columns)."""
    rng = np.random.default_rng(seed)
    leaves, hads, in_layers = [], [], {}
    for _ in range(arity):
        pair = [_leaf(Sy, Sc, rng, v, k) for v in range(2)]
        h = Sy.HadamardLayer(k, arity=2)
        in_layers[h] = pair
        leaves.extend(pair)
        hads.append(h)
    root = Sy.SumLayer(k, 1, arity=arity,
                       weight=_const(Sy, rng.uniform(0.1, 1.0, (1, arity * k))))
    in_layers[root] = hads
    return Sy.Circuit(leaves + hads + [root], in_layers, [root])


PRODUCTS = {
    **{f"pointwise-{p}": (lambda sy, p=p: _bivariate(*sy, 1, p),
                          lambda sy, p=p: _bivariate(*sy, 2, p), 2)
       for p in ("hadamard", "kronecker")},
    **{f"order-{p}-{o1}-{o2}": (lambda sy, p=p, o=o1: _ordered(*sy, 41, o, p),
                                lambda sy, p=p, o=o2: _ordered(*sy, 42, o, p), len(o1))
       for p in ("kronecker", "hadamard")
       for o1, o2 in [((1, 0), (0, 1)), ((1, 0), (1, 0)), ((1, 2, 0), (0, 1, 2)),
                      ((2, 0, 1), (1, 2, 0))]},
    **{f"mixing-{a1}-{a2}-{k1}-{k2}": (lambda sy, a=a1, k=k1: _mixing(*sy, 11, k, a),
                                       lambda sy, a=a2, k=k2: _mixing(*sy, 12, k, a), 2)
       for a1, a2, k1, k2 in [(2, 2, 2, 3), (1, 2, 2, 3), (3, 2, 2, 2), (2, 3, 3, 2),
                              (2, 2, 1, 3)]},
}


def _operands_both(builds, semiring="lse-sum"):
    """Each package's context and compiled operands, the JAX store carried
    into the port after ``apply`` adds the derived circuits."""
    flags = dict(semiring=semiring, fold=True, optimize=True)
    jctx = JaxPipelineContext(**flags)
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    jccs = [jctx.compile(b(JAX)) for b in builds]
    ccs = [ctx.compile(b(PORT)) for b in builds]
    return jctx, jccs, ctx, ccs


def _carry(jctx, ctx):
    ctx.load_parameters({k: np.asarray(v) for k, v in jctx.parameters.items()})


def _assert_same(jout, tout, rtol=1e-9):
    assert tout.dtype == torch.float64
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=rtol)


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_multiply_of_compiled_circuits_matches_jax_and_enumeration(name):
    b1, b2, nv = PRODUCTS[name]
    jctx, (j1, j2), ctx, (c1, c2) = _operands_both((b1, b2))
    jp, tp = jctx.multiply(j1, j2), ctx.multiply(c1, c2)
    jz, tz = jctx.integrate(jp), ctx.integrate(tp)
    _carry(jctx, ctx)
    worlds = enumerate_worlds(nv, 3)
    want = (eval_circuit(b1(JAX), worlds) * eval_circuit(b2(JAX), worlds))[:, 0, 0]
    out = tp(torch.as_tensor(worlds))
    _assert_same(jp(jnp.asarray(worlds)), out)
    np.testing.assert_allclose(np.exp(out.detach().numpy()[:, 0, 0]), want, rtol=1e-9)
    z = tz(batch_size=1)
    _assert_same(jz(jnp.asarray(worlds[:1])), z)
    np.testing.assert_allclose(np.exp(float(z.detach()[0, 0, 0])), want.sum(), rtol=1e-9)


@pytest.mark.parametrize("semiring", ["lse-sum", "sum-product", "signed-lse-sum"])
@pytest.mark.parametrize("op", ["integrate", "integrate-scope", "conjugate", "mixture",
                                "mixture-weights", "concatenate"])
def test_operators_of_compiled_circuits_match_jax(op, semiring):
    builds = (lambda sy: _bivariate(*sy, 5), lambda sy: _bivariate(*sy, 6))
    jctx, jccs, ctx, ccs = _operands_both(builds, semiring)
    worlds = enumerate_worlds(2, 3)
    v = [eval_circuit(b(JAX), worlds)[:, 0, 0] for b in builds]
    if op == "integrate":
        derived = [c.integrate(cs[0]) for c, cs in ((jctx, jccs), (ctx, ccs))]
        want, x = np.array([partition_function(builds[0](JAX), num_states=3)[0, 0]]), worlds[:1]
    elif op == "integrate-scope":
        derived = [jctx.integrate(jccs[0], scope=JScope([1])),
                   ctx.integrate(ccs[0], scope=Scope([1]))]
        want, x = np.repeat(v[0].reshape(3, 3).sum(axis=1), 3), worlds
    elif op == "conjugate":
        derived = [c.conjugate(cs[0]) for c, cs in ((jctx, jccs), (ctx, ccs))]
        want, x = v[0], worlds
    elif op.startswith("mixture"):
        kw = dict(weights=[0.3, 0.7]) if op == "mixture-weights" else {}
        derived = [c.mixture(*cs, **kw) for c, cs in ((jctx, jccs), (ctx, ccs))]
        want, x = None, worlds
        if kw:
            want = 0.3 * v[0] + 0.7 * v[1]
    else:
        derived = [c.concatenate(*cs) for c, cs in ((jctx, jccs), (ctx, ccs))]
        want, x = None, worlds
    _carry(jctx, ctx)
    jout, tout = derived[0](jnp.asarray(x)), derived[1](torch.as_tensor(x))
    if semiring == "signed-lse-sum":
        (ja, js), (ta, ts) = jout, tout
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert (ts == 1).all()
        jout, tout, lin = ja, ta, np.exp
    else:
        lin = np.exp if semiring == "lse-sum" else (lambda a: a)
    _assert_same(jout, tout)
    if op == "concatenate":
        assert tout.shape == (len(x), 2, 1)
        np.testing.assert_allclose(lin(tout.detach().numpy()[:, :, 0]), np.stack(v, 1),
                                   rtol=1e-9)
    elif want is not None:
        np.testing.assert_allclose(lin(tout.detach().numpy()[:, 0, 0]), want, rtol=1e-9)


def test_polynomial_layer_and_complex_semiring_are_not_ported():
    """Both are ported (the name dates from when neither was): the
    differential of a polynomial circuit compiles under the signed semiring
    and equals its derivative, the complex semiring builds a context, and a
    non-positive order still raises."""
    c = _const(TS, np.array([[1.0, 2.0, 1.0], [0.5, 0.0, 1.0]]))
    x0 = TS.PolynomialLayer(Scope([0]), 2, degree=2, coeff=c)
    x1 = TS.PolynomialLayer(Scope([1]), 2, degree=2, coeff=_const(TS, np.ones((2, 3))))
    h = TS.HadamardLayer(2, arity=2)
    s = TS.SumLayer(2, 1, weight=_const(TS, [[1.0, 0.5]]))
    sc = TS.Circuit([x0, x1, h, s], {h: [x0, x1], s: [h]}, [s])
    ctx = PipelineContext(semiring="signed-lse-sum", fold=True, device="cpu")
    dcc = ctx.compile(TSF.differentiate(sc))
    x = torch.tensor([[0.5, -1.0], [2.0, 0.25]], dtype=torch.float64)
    a, sg = dcc(x)
    # c(x) = p0(x0) q0(x1) + 0.5 p1(x0) q1(x1), q = 1 + t + t^2
    p = lambda t, k: [1 + 2 * t + t**2, 0.5 + t**2][k]  # noqa: E731
    dp = lambda t, k: [2 + 2 * t, 2 * t][k]  # noqa: E731
    q, dq = (lambda t: 1 + t + t**2), (lambda t: 1 + 2 * t)  # noqa: E731
    x0v, x1v = x[:, 0].numpy(), x[:, 1].numpy()
    want = np.stack([dp(x0v, 0) * q(x1v) + 0.5 * dp(x0v, 1) * q(x1v),
                     p(x0v, 0) * dq(x1v) + 0.5 * p(x0v, 1) * dq(x1v),
                     p(x0v, 0) * q(x1v) + 0.5 * p(x0v, 1) * q(x1v)], axis=1)
    # one output per variable, then the circuit itself
    np.testing.assert_allclose(_linear((a, sg))[:, :, 0], want, rtol=1e-6)
    cctx = PipelineContext(semiring="complex-lse-sum", device="cpu")
    out = cctx.compile(_nonmonotonic_pc(*PORT))(torch.as_tensor(enumerate_worlds(2, 3)))
    assert out.is_complex()
    with pytest.raises(ValueError, match="positive"):
        ctx.differentiate(ctx.compile(_nonmonotonic_pc(*PORT)), order=0)


def test_module_level_operators_use_the_ambient_context():
    """The module-level functions take ``ctx=``, else the entered context;
    importing the module opens no CUDA context and builds no default
    context (that needs a card, so it raises here)."""
    assert P._DEFAULT_CONTEXT is None and not torch.cuda.is_initialized()
    ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True, device="cpu")
    with ctx:
        cc = P.compile(_nonmonotonic_pc(*PORT))
        sq = P.multiply(P.conjugate(cc), cc)
    zc = P.integrate(sq, ctx=ctx)
    assert sq in ctx._circuits() and zc in ctx._circuits()
    worlds = torch.as_tensor(enumerate_worlds(2, 3))
    za = float(zc(batch_size=1)[0].detach()[0, 0, 0])
    np.testing.assert_allclose(za, float(torch.logsumexp(sq(worlds)[0].detach()[:, 0, 0], 0)),
                               rtol=1e-6)
    assert P._DEFAULT_CONTEXT is None and not torch.cuda.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.compile(_nonmonotonic_pc(*PORT))


def test_signed_semiring_refuses_complex_and_maps_both_ways():
    from cirkit_tpu_torch.backend.torch.semiring import (
        LSESumSemiring,
        SignedLSESemiring,
        SumProductSemiring,
    )

    with pytest.raises(ValueError, match="real parameters"):
        SignedLSESemiring.cast(torch.zeros(2, dtype=torch.complex64))
    v = torch.tensor([-2.0, 0.0, 3.0], dtype=torch.float64)
    a, s = SignedLSESemiring.map_from(v, SumProductSemiring)
    torch.testing.assert_close(s, torch.sign(v))
    torch.testing.assert_close(SumProductSemiring.map_from((a, s), SignedLSESemiring), v)
    la, ls = SignedLSESemiring.map_from(torch.log(v.abs()), LSESumSemiring)
    assert (ls == 1).all()
    torch.testing.assert_close(LSESumSemiring.map_from((la, ls), SignedLSESemiring), la)
