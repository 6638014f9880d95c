"""The port's complex log semiring, its ops and squared circuits with complex
parameters against the JAX package, on the CPU.

- **Ops.** The plain versions of the complex log-einsum-exp ops
  (``cirkit_tpu_torch.ops.clse_einsum``) against JAX's: in complex128 against
  ``ComplexLSESumSemiring.matmul`` / ``tucker2`` (XLA) to 1e-9, phases
  compared modulo 2 pi, and in complex64 against the Pallas kernels in
  interpret mode (``clse_matmul_parts`` plus the ``csafelog`` epilogue,
  forced with ``CIRKIT_TPU_FORCE_PALLAS``) to 5e-4. Gradients against
  ``jax.grad`` of a real loss of both output planes: JAX hands back
  ``dL/dRe - i dL/dIm`` and PyTorch ``dL/dRe + i dL/dIm``, so JAX's are
  conjugated; and against real calculus on the split planes. An exact
  cancellation, a row that is all -inf, real weights, O = 1.
- **csafelog**: the two pins of ``tests/backend/test_sos.py``.
- **The semiring**: ``sum``, ``add``, ``prod``, ``mul``, ``apply_reduce`` and
  the six morphisms against JAX's.
- **Circuits.** The non-monotonic circuit of ``tests/backend/test_sos.py``
  with real and with complex weights, its square and the square's integral
  over the fold x optimize grid, against JAX (store carried across by slot
  name, rtol 1e-9) and enumeration; the signed compile against the complex
  one, gradients included; ``bench.py``'s SoS circuit at 4x4, K=4 with real
  and complex sum weights; ``IntegrateQuery``; complex slots through the npz
  checkpoint; ``differentiate`` against finite differences and JAX.

On the CPU the ops run their plain versions and launch no kernel; the
kernels themselves are tested on the card (``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cirkit_tpu.symbolic as JS
import cirkit_tpu.symbolic.functional as JSF
import cirkit_tpu_torch.symbolic as TS
import cirkit_tpu_torch.symbolic.functional as TSF
from cirkit_tpu.backend.jax import queries as JQ
from cirkit_tpu.backend.jax import semiring as JSR
from cirkit_tpu.backend.jax.utils import csafelog as jax_csafelog
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.models.utils import Parameterization as JParameterization
from cirkit_tpu.ops.lse_einsum import clse_matmul_parts
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu.utils import Scope as JScope
from cirkit_tpu_torch.backend.torch import IntegrateQuery, MAPQuery, SamplingQuery
from cirkit_tpu_torch.backend.torch import semiring as TSR
from cirkit_tpu_torch.backend.torch.utils import csafelog
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.models.utils import Parameterization
from cirkit_tpu_torch.ops import clse_einsum as C
from cirkit_tpu_torch.ops import lse_einsum as L
from cirkit_tpu_torch.parallel import split_trainable
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils import Scope
from cirkit_tpu_torch.utils.checkpoint import load_store, save_store, store_from_numpy
from tests.reference_eval import enumerate_worlds, eval_circuit

F, I, K1, K2 = 3, 32, 8, 16
OPS = ["clse_matmul", "clse_tucker2"]
JAX = (JS, JScope)
PORT = (TS, Scope)
JComplex = JSR.ComplexLSESumSemiring
TComplex = TSR.ComplexLSESumSemiring


@pytest.fixture(autouse=True)
def _zero_launches():
    for op in L.LAUNCHES:
        L.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in L.LAUNCHES.values()), "a CPU test launched a kernel"


@pytest.fixture
def float64_default():
    """Compile the port's constants and parameters in float64 (the ambient
    real dtype), as the JAX package does under x64."""
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().resolve_conj() if isinstance(t, torch.Tensor) else t)


def _assert_clog_close(got, want, tol):
    """Complex log-space values: real parts to ``tol`` (relative and
    absolute), phases modulo 2 pi; -inf real parts in the same places."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    finite = np.isfinite(want.real)
    np.testing.assert_array_equal(np.isneginf(got.real), np.isneginf(want.real))
    np.testing.assert_allclose(got.real[finite], want.real[finite], rtol=tol, atol=tol)
    dphi = np.angle(np.exp(1j * (got.imag - want.imag)))
    assert np.abs(dphi[finite]).max(initial=0.0) <= tol


# --------------------------------------------------------------------------- #
# Ops
# --------------------------------------------------------------------------- #


def _inputs(op: str, b: int, o: int, dtype, *, real_w: bool = False, seed: int = 0):
    """Complex log-space inputs (phases uniform in (-pi, pi]) and normal
    weights, complex or real."""
    rng = np.random.default_rng(seed)
    real = np.float64 if dtype == np.complex128 else np.float32

    def value(*shape):
        return ((rng.normal(size=shape) * 3.0 - 2.0)
                + 1j * rng.uniform(-np.pi, np.pi, size=shape)).astype(dtype)

    tucker = "tucker" in op
    xs = [value(F, b, K1), value(F, b, K2)] if tucker else [value(F, b, I)]
    shape = (F, o, K1 * K2 if tucker else I)
    w = rng.normal(size=shape).astype(real)
    if not real_w:
        w = (w + 1j * rng.normal(size=shape)).astype(dtype)
    return [*xs, w]


def _jax_op(op: str, ins):
    hook = JComplex.tucker2 if "tucker" in op else JComplex.matmul
    return hook(*(jnp.asarray(a) for a in ins))


@pytest.mark.parametrize("real_w", [False, True], ids=["complex-w", "real-w"])
@pytest.mark.parametrize("o", [1, 16])
@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_jax_complex128(op, b, o, real_w):
    ins = _inputs(op, b, o, np.complex128, real_w=real_w)
    got = getattr(C, op)(*(torch.as_tensor(a) for a in ins))
    assert got.dtype == torch.complex128 and got.shape == (F, b, o)
    _assert_clog_close(got, _jax_op(op, ins), 1e-9)


def _pallas_matmul(x, w):
    """JAX's complex matmul through the Pallas kernel in interpret mode, with
    the epilogue its semiring adds."""
    parts = clse_matmul_parts(jnp.asarray(x), jnp.asarray(w), interpret=True)
    assert parts is not None
    yr, yi, m = parts
    return jax_csafelog(jax.lax.complex(yr, yi)) + m


@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_jax_pallas_interpret_complex64(op, b, monkeypatch):
    """(3, 8|13, 32) x (3, 16, 32), as ``tests/ops/test_lse_einsum.py``; the
    Tucker op through the log-space outer sum JAX's semiring feeds the dense
    kernel."""
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    ins = _inputs(op, b, 16, np.complex64, seed=1)
    if "tucker" in op:
        ins = [a[..., : (4 if k == 0 else 8) if k < 2 else 32] for k, a in enumerate(ins)]
        x12 = (ins[0][:, :, :, None] + ins[1][:, :, None, :]).reshape(F, b, 32)
        want = _pallas_matmul(x12, ins[2])
    else:
        want = _pallas_matmul(*ins)
    got = getattr(C, op)(*(torch.as_tensor(np.ascontiguousarray(a)) for a in ins))
    assert got.dtype == torch.complex64
    # in linear space scaled by the row's absolute mass, as on the card
    t = [torch.as_tensor(np.ascontiguousarray(a)) for a in ins]
    res = [x.real.double() for x in t[:-1]]
    mass = (L.lse_tucker2_ref if "tucker" in op else L.lse_matmul_ref)(*res, t[-1].abs().double())
    lin_k = np.exp(_np(got).astype(np.complex128) - mass.numpy())
    lin_p = np.exp(np.asarray(want).astype(np.complex128) - mass.numpy())
    assert np.abs(lin_k - lin_p).max() <= 5e-4


def _loss_planes(out_re, out_im, lib):
    return lib.sum(lib.sin(out_re) + 0.7 * lib.cos(out_im))


@pytest.mark.parametrize("real_w", [False, True], ids=["complex-w", "real-w"])
@pytest.mark.parametrize("op", OPS)
def test_gradients_match_jax_conjugated_and_real_calculus(op, real_w):
    """The loss of ``tests/ops/test_lse_einsum.py:410-419`` on both output
    planes. Against ``jax.grad`` (conjugated: the two packages' complex
    cotangents are each other's conjugates), against autograd through the
    plain composition, and against real calculus: the gradient with respect
    to the real and imaginary planes as separate real leaves."""
    ins = _inputs(op, 13, 16, np.complex128, real_w=real_w, seed=2)
    want = jax.grad(lambda *a: _loss_planes(_jax_op(op, a).real, _jax_op(op, a).imag, jnp),
                    argnums=tuple(range(len(ins))))(*(jnp.asarray(a) for a in ins))

    def port_grads(fn, leaves):
        out = fn(*leaves)
        return torch.autograd.grad(_loss_planes(out.real, out.imag, torch), leaves)

    t = [torch.as_tensor(a).requires_grad_() for a in ins]
    got = port_grads(getattr(C, op), t)
    ref = port_grads(getattr(C, f"{op}_ref"), [torch.as_tensor(a).requires_grad_() for a in ins])
    assert got[-1].dtype == t[-1].dtype  # a real weight gets a real gradient
    for g, w_, r in zip(got, want, ref):
        scale = 1e-10 * np.abs(np.asarray(w_)).max()
        np.testing.assert_allclose(_np(g), np.conj(np.asarray(w_)), rtol=1e-8, atol=scale)
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-8, atol=scale)

    # real calculus: every complex operand split into two real leaves
    planes = [(torch.as_tensor(a.real.copy()).requires_grad_(),
               torch.as_tensor(a.imag.copy()).requires_grad_()) if np.iscomplexobj(a)
              else (torch.as_tensor(a).requires_grad_(),) for a in ins]
    out = getattr(C, f"{op}_ref")(*(torch.complex(*p) if len(p) == 2 else p[0] for p in planes))
    flat = [leaf for p in planes for leaf in p]
    rc = iter(torch.autograd.grad(_loss_planes(out.real, out.imag, torch), flat))
    for g, p in zip(got, planes):
        np.testing.assert_allclose(_np(g).real, next(rc).numpy(), rtol=1e-8, atol=1e-12)
        if len(p) == 2:
            np.testing.assert_allclose(_np(g).imag, next(rc).numpy(), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("op", OPS)
def test_backward_plain_version_is_the_autograd_of_the_forward(op):
    """``*_bwd_ref`` (the backward kernel's math) against autograd through
    ``*_ref``, with ``needs`` honoured."""
    ins = [torch.as_tensor(a).requires_grad_() for a in _inputs(op, 13, 16, np.complex128, seed=3)]
    out = getattr(C, f"{op}_ref")(*ins)
    rng = np.random.default_rng(4)
    g = torch.as_tensor(rng.normal(size=out.shape) + 1j * rng.normal(size=out.shape))
    want = torch.autograd.grad(out, ins, g)
    got = getattr(C, f"{op}_bwd_ref")(*(t.detach() for t in ins), out.detach(), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-9, atol=1e-12)
    only_w = C.backward(op, tuple(t.detach() for t in ins), out.detach(), g,
                        (False,) * (len(ins) - 1) + (True,))
    assert all(v is None for v in only_w[:-1])
    np.testing.assert_allclose(_np(only_w[-1]), _np(want[-1]), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("op", OPS)
def test_exact_cancellation_and_neg_inf_row_give_neg_inf_and_zero_gradients(op):
    """Two terms of opposite sign sum to exactly 0, and a row whose real
    parts are all -inf has no mass: real part -inf, no NaN, zero gradients."""
    alt = np.tile([1.0, -1.0], 8).astype(np.complex128)
    if "tucker" in op:
        ins = [np.zeros((1, 8, 4), np.complex128), np.zeros((1, 8, 4), np.complex128)]
    else:
        ins = [np.zeros((1, 8, 16), np.complex128)]
    ins.append(np.broadcast_to(alt, (1, 8, 16)).copy())
    t = [torch.as_tensor(a).requires_grad_() for a in ins]
    out = getattr(C, op)(*t)
    assert torch.isneginf(out.real).all() and not torch.isnan(out.imag).any()
    for gr in torch.autograd.grad(out, t, torch.ones_like(out)):
        assert (gr == 0).all()
    _assert_clog_close(out, _jax_op(op, ins), 1e-12)

    ins = _inputs(op, 8, 16, np.complex128, seed=5)
    ins[0][0, 2] = complex(-np.inf, 0.5)
    t = [torch.as_tensor(a).requires_grad_() for a in ins]
    out = getattr(C, op)(*t)
    assert torch.isneginf(out.real[0, 2]).all() and not torch.isnan(out.real).any()
    grads = torch.autograd.grad(_loss_planes(out.real[1:], out.imag[1:], torch)
                                + out.real[0, :2].sum(), t)
    assert all(not torch.isnan(torch.view_as_real(g) if g.is_complex() else g).any()
               for g in grads)
    assert (grads[0][0, 2] == 0).all()


def test_ops_refuse_real_values_and_mismatched_shapes():
    x, w = (torch.as_tensor(a) for a in _inputs("clse_matmul", 8, 16, np.complex64))
    with pytest.raises(TypeError, match="complex"):
        C.clse_matmul(x.real, w)
    with pytest.raises(ValueError, match="Expected x"):
        C.clse_matmul(x, w[:, :, :5])
    out = C.clse_matmul(x.conj(), w)  # a lazily conjugated view is written out
    _assert_clog_close(out, C.clse_matmul_ref(x.conj().resolve_conj(), w), 1e-6)


# --------------------------------------------------------------------------- #
# csafelog
# --------------------------------------------------------------------------- #


def test_csafelog_gradient_no_nan_at_zero():
    """``tests/backend/test_sos.py::test_csafelog_gradient_no_nan_at_zero``."""
    for value, want in ((0.0, 0.0), (2.0, 0.5)):
        x = torch.tensor(value, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(csafelog(x * (1.0 + 0.0j)).real, x)
        assert torch.isfinite(g)
        np.testing.assert_allclose(float(g), want, rtol=1e-9)
    out = csafelog(torch.zeros(2, dtype=torch.complex128))
    assert torch.isneginf(out.real).all() and (out.imag == 0).all()


def test_csafelog_matches_real_calculus_and_jax_conjugated():
    """``tests/backend/test_sos.py::test_csafelog_matches_native_complex_log_gradient``:
    the gradients with respect to the real and imaginary parts equal real
    calculus, and equal JAX's (which are real leaves there too)."""
    rng = np.random.default_rng(41)
    y = rng.normal(size=6) + 1j * rng.normal(size=6)

    def jloss(yr, yi):
        o = jax_csafelog(jax.lax.complex(yr, yi))
        return _loss_planes(o.real, o.imag, jnp)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y.real), jnp.asarray(y.imag))
    yr = torch.as_tensor(y.real.copy()).requires_grad_()
    yi = torch.as_tensor(y.imag.copy()).requires_grad_()
    o = csafelog(torch.complex(yr, yi))
    got = torch.autograd.grad(_loss_planes(o.real, o.imag, torch), [yr, yi])
    rc = torch.autograd.grad(
        _loss_planes(0.5 * torch.log(yr**2 + yi**2), torch.atan2(yi, yr), torch), [yr, yi])
    for a, b, c in zip(got, want, rc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-12)
    # the complex leaf's gradient is dL/dRe + i dL/dIm
    z = torch.as_tensor(y).requires_grad_()
    o = csafelog(z)
    (gz,) = torch.autograd.grad(_loss_planes(o.real, o.imag, torch), z)
    np.testing.assert_allclose(gz.numpy(), got[0].numpy() + 1j * got[1].numpy(), rtol=1e-12)


# --------------------------------------------------------------------------- #
# The semiring
# --------------------------------------------------------------------------- #


def _cvalues(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 2.0 - 1.0) + 1j * rng.uniform(-np.pi, np.pi, size=shape)


@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("hook", ["sum", "prod"])
def test_semiring_reductions_match_jax(hook, keepdim):
    x = _cvalues(0, 3, 5, 4)
    x[1, 2] = complex(-np.inf, 0.0)  # a row with no mass
    got = getattr(TComplex, hook)(torch.as_tensor(x), 1, keepdim=keepdim)
    want = getattr(JComplex, hook)(jnp.asarray(x), 1, keepdim=keepdim)
    _assert_clog_close(got, want, 1e-12)


def test_semiring_add_mul_and_apply_reduce_match_jax():
    a, b, c = (_cvalues(k, 3, 5) for k in (1, 2, 3))
    t = [torch.as_tensor(v) for v in (a, b, c)]
    j = [jnp.asarray(v) for v in (a, b, c)]
    _assert_clog_close(TComplex.add(*t), JComplex.add(*j), 1e-12)
    _assert_clog_close(TComplex.mul(*t), JComplex.mul(*j), 1e-12)
    # a real operand is cast
    _assert_clog_close(TComplex.add(t[0], t[1].real), JComplex.add(j[0], j[1].real), 1e-12)
    w = np.random.default_rng(4).normal(size=(3, 2, 5))
    got = TComplex.apply_reduce(
        lambda e: torch.einsum("fi,foi->fo", e, torch.as_tensor(w).to(e.dtype)), t[0],
        dim=-1, keepdim=True)
    want = JComplex.apply_reduce(lambda e: jnp.einsum("fi,foi->fo", e, jnp.asarray(w)), j[0],
                                 dim=-1, keepdim=True)
    _assert_clog_close(got, want, 1e-12)
    assert TComplex.cast(torch.zeros(2)).dtype == torch.complex64
    assert TComplex.cast(torch.zeros(2, dtype=torch.float64)).dtype == torch.complex128
    assert TComplex.cast(torch.zeros(2, dtype=torch.int64)).dtype == torch.complex64


_MORPHISMS = [("complex-lse-sum", "sum-product"), ("complex-lse-sum", "lse-sum"),
              ("complex-lse-sum", "signed-lse-sum"), ("sum-product", "complex-lse-sum"),
              ("lse-sum", "complex-lse-sum"), ("signed-lse-sum", "complex-lse-sum")]


@pytest.mark.parametrize("target,source", _MORPHISMS)
def test_semiring_morphisms_match_jax(target, source):
    v = np.array([-2.0, 0.5, 3.0, -0.25])
    value = {"sum-product": v, "lse-sum": np.log(np.abs(v)),
             "signed-lse-sum": (np.log(np.abs(v)), np.sign(v)),
             "complex-lse-sum": np.log(v.astype(np.complex128))}[source]
    tmap = lambda f, x: tuple(f(a) for a in x) if isinstance(x, tuple) else f(x)  # noqa: E731
    got = TSR.SemiringImpl.from_name(target).map_from(
        tmap(torch.as_tensor, value), TSR.SemiringImpl.from_name(source))
    want = JSR.SemiringImpl.from_name(target).map_from(
        tmap(jnp.asarray, value), JSR.SemiringImpl.from_name(source))
    if target == "complex-lse-sum":
        _assert_clog_close(got, want, 1e-12)
    else:
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12)


def test_complex_semiring_softmax_hooks_normalize_then_contract():
    """``matmul_softmax`` and ``tucker2_softmax`` stay the base class's
    softmax-then-contract, as in JAX: real logits, real weights, no complex
    copy of the weight."""
    rng = np.random.default_rng(6)
    x1, x2 = _cvalues(7, 2, 5, 3), _cvalues(8, 2, 5, 4)
    theta = rng.normal(size=(2, 6, 12))
    got = TComplex.tucker2_softmax(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(theta))
    want = JComplex.tucker2_softmax(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(theta))
    _assert_clog_close(got, want, 1e-10)
    x = _cvalues(9, 2, 5, 12)
    got = TComplex.matmul_softmax(torch.as_tensor(x), torch.as_tensor(theta))
    want = JComplex.matmul_softmax(jnp.asarray(x), jnp.asarray(theta))
    _assert_clog_close(got, want, 1e-10)


# --------------------------------------------------------------------------- #
# The non-monotonic circuit, its square and the square's integral
# --------------------------------------------------------------------------- #


def _const(Sy, value):
    value = np.asarray(value)
    kw = {"dtype": Sy.DataType.COMPLEX} if np.iscomplexobj(value) else {}
    return Sy.Parameter.from_input(Sy.TensorParameter(
        *value.shape, initializer=Sy.ConstantTensorInitializer(value), learnable=True, **kw))


def _nonmonotonic_pc(Sy, Sc, weight=((0.9, -0.7),)):
    """``tests/backend/test_sos.py::_nonmonotonic_pc``, with a real (default)
    or complex sum weight."""
    p0 = np.array([[0.2, 0.5, 0.3], [0.6, 0.1, 0.3]])
    p1 = np.array([[0.4, 0.4, 0.2], [0.1, 0.8, 0.1]])
    l0 = Sy.CategoricalLayer(Sc([0]), 2, num_categories=3, probs=_const(Sy, p0))
    l1 = Sy.CategoricalLayer(Sc([1]), 2, num_categories=3, probs=_const(Sy, p1))
    h = Sy.HadamardLayer(2, arity=2)
    s = Sy.SumLayer(2, 1, weight=_const(Sy, np.asarray(weight)))
    return Sy.Circuit([l0, l1, h, s], {h: [l0, l1], s: [h]}, [s])


_COMPLEX_W = ((0.9 + 0.4j, -0.7 + 0.2j),)


def _complex_pc(Sy, Sc):
    return _nonmonotonic_pc(Sy, Sc, _COMPLEX_W)


def _squared_both(build, *, fold, optimize, semiring="complex-lse-sum"):
    """``cc``, ``sq = multiply(conjugate(cc), cc)`` and ``zc = integrate(sq)``
    in both packages, the JAX store carried into the port by slot name."""
    flags = dict(semiring=semiring, fold=fold, optimize=optimize)
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


GRID = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("which", ["cc", "sq", "zc"])
@pytest.mark.parametrize("weights", ["real", "complex"])
@pytest.mark.parametrize("fold,optimize", GRID)
def test_squared_circuit_matches_enumeration_and_jax(fold, optimize, weights, which):
    build = _nonmonotonic_pc if weights == "real" else _complex_pc
    (jctx, *jaxs), (ctx, *ports) = _squared_both(build, fold=fold, optimize=optimize)
    k = ["cc", "sq", "zc"].index(which)
    worlds = enumerate_worlds(2, 3)
    x = worlds[:1] if which == "zc" else worlds
    got = ports[k](torch.as_tensor(x))
    assert got.dtype == torch.complex128 and got.shape == (len(x), 1, 1)
    _assert_clog_close(got, jaxs[k](jnp.asarray(x)), 1e-9)
    # enumeration: c(x) = sum_k w_k p0_k(x0) p1_k(x1), linear in the weight
    w = np.asarray(_COMPLEX_W if weights == "complex" else ((0.9, -0.7),))[0]
    parts = [eval_circuit(_nonmonotonic_pc(*JAX, ((float(a == 0), float(a == 1)),)), worlds)[:, 0, 0]
             for a in range(2)]
    c = w[0] * parts[0] + w[1] * parts[1]
    want = {"cc": c, "sq": np.abs(c) ** 2, "zc": np.array([np.sum(np.abs(c) ** 2)])}[which]
    np.testing.assert_allclose(np.exp(_np(got))[:, 0, 0], want, rtol=1e-9, atol=1e-12)
    assert {s: v.dtype for s, v in ctx.parameters.items()} == {
        s: getattr(torch, str(v.dtype)) for s, v in jctx.parameters.items()}


@pytest.mark.parametrize("fold,optimize", GRID)
def test_signed_squared_circuit_matches_complex(fold, optimize, float64_default):
    """``tests/backend/test_signed.py::test_signed_squared_circuit_matches_complex``
    in the port: the same store under both semirings."""
    worlds = torch.as_tensor(enumerate_worlds(2, 3))
    lin = {}
    for semiring in ("signed-lse-sum", "complex-lse-sum"):
        ctx = PipelineContext(semiring=semiring, fold=fold, optimize=optimize, device="cpu")
        cc = ctx.compile(_nonmonotonic_pc(*PORT))
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        out, z = sq(worlds), ctx.integrate(sq)(batch_size=1)
        if semiring == "signed-lse-sum":
            lin[semiring] = (_np(out[1] * torch.exp(out[0])), _np(z[1] * torch.exp(z[0])))
        else:
            assert np.abs(np.exp(_np(out)).imag).max() < 1e-12
            lin[semiring] = (np.exp(_np(out)).real, np.exp(_np(z)).real)
    want = eval_circuit(_nonmonotonic_pc(*JAX), worlds.numpy())[:, 0, 0] ** 2
    for semiring, (got, z) in lin.items():
        np.testing.assert_allclose(got[:, 0, 0], want, rtol=1e-9, err_msg=semiring)
        np.testing.assert_allclose(z[0, 0, 0], want.sum(), rtol=1e-9, err_msg=semiring)


def _sos_loss_grads(ctx, cc, sq, zc, x):
    ttr, tfr = split_trainable(cc, ctx.parameters)
    st = {**ttr, **tfr}

    def value(out):
        return out.real if torch.is_tensor(out) else out[0]

    loss = -value(sq.evaluate(st, x)).mean() + value(zc.evaluate(st, batch_size=1))[0, 0, 0]
    return dict(zip(ttr, torch.autograd.grad(loss, list(ttr.values()))))


def test_signed_gradients_match_complex(float64_default):
    """``tests/backend/test_signed.py::test_signed_gradients_match_complex``:
    the SoS NLL's gradients under the signed semiring equal the complex
    semiring's (real slots get real gradients under both)."""
    worlds = torch.as_tensor(enumerate_worlds(2, 3))
    grads = {}
    for semiring in ("signed-lse-sum", "complex-lse-sum"):
        ctx = PipelineContext(semiring=semiring, fold=True, device="cpu")
        cc = ctx.compile(_nonmonotonic_pc(*PORT))
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        grads[semiring] = _sos_loss_grads(ctx, cc, sq, ctx.integrate(sq), worlds)
    gs, gc = grads["signed-lse-sum"], grads["complex-lse-sum"]
    assert set(gs) == set(gc) and gs
    for k in gs:
        assert not gc[k].is_complex()
        np.testing.assert_allclose(_np(gs[k]), _np(gc[k]), rtol=1e-8, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("weights", ["real", "complex"])
@pytest.mark.parametrize("fold", [False, True])
def test_sos_nll_gradients_match_jax_conjugated(fold, weights):
    build = _nonmonotonic_pc if weights == "real" else _complex_pc
    (jctx, jcc, jsq, jzc), (ctx, cc, sq, zc) = _squared_both(build, fold=fold, optimize=False)
    x = enumerate_worlds(2, 3)
    store = dict(jctx.parameters)
    tr = {k: v for k, v in store.items() if k in jcc.learnable_slots}
    fr = {k: v for k, v in store.items() if k not in tr}

    def jloss(tr):
        st = {**tr, **fr}
        return -jnp.mean(jsq.evaluate(st, x).real) + jzc.evaluate(st, x[:1]).real[0, 0, 0]

    want = jax.grad(jloss)(tr)
    got = _sos_loss_grads(ctx, cc, sq, zc, torch.as_tensor(x))
    assert set(got) == set(want) and got
    assert any(g.is_complex() for g in got.values()) == (weights == "complex")
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.conj(np.asarray(want[k])), rtol=1e-8,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("pad", [None, 4])
def test_complex_integrate_query_matches_enumeration_and_jax(pad):
    (_, _, jsq, _), (_, _, sq, _) = _squared_both(_complex_pc, fold=True, optimize=False)
    worlds = enumerate_worlds(2, 3)
    want = JQ.IntegrateQuery(jsq)(worlds, integrate_vars=JScope([1]))
    got = IntegrateQuery(sq)(torch.as_tensor(worlds), integrate_vars=Scope([1]), pad_batch_to=pad)
    assert got.shape == (9, 1, 1) and got.dtype == torch.complex128
    _assert_clog_close(got, want, 1e-9)
    full = np.exp(_np(sq(torch.as_tensor(worlds))))[:, 0, 0].real.reshape(3, 3).sum(1)
    np.testing.assert_allclose(np.exp(_np(got))[:, 0, 0].real.reshape(3, 3),
                               np.repeat(full[:, None], 3, axis=1), rtol=1e-9)


def test_sampling_and_map_queries_refuse_the_complex_semiring():
    ctx = PipelineContext(semiring="complex-lse-sum", fold=True, device="cpu")
    cc = ctx.compile(_nonmonotonic_pc(*PORT))
    with pytest.raises(ValueError, match="'lse-sum' semiring"):
        MAPQuery(cc)
    # the dense sampler reads the weights as probabilities: -0.7 is none
    with pytest.raises(ValueError, match="nonnegative"):
        SamplingQuery(cc)(num_samples=4)


# --------------------------------------------------------------------------- #
# bench.py's SoS circuit at 4x4, K=4, real and complex sum weights
# --------------------------------------------------------------------------- #


def _bench_sos(image, Param, dtype):
    kw = {"dtype": "complex"} if dtype == "complex" else {}
    return image((1, 4, 4), "quad-tree-2", input_layer="categorical", num_input_units=4,
                 sum_product_layer="cp", num_sum_units=4,
                 sum_weight_param=Param(activation="none", initialization="normal", **kw))


@pytest.mark.parametrize("dtype", ["real", "complex"])
def test_bench_sos_values_plan_and_gradients_match_jax(dtype):
    builds = {JAX: lambda: _bench_sos(jax_image_data, JParameterization, dtype),
              PORT: lambda: _bench_sos(image_data, Parameterization, dtype)}
    (jctx, *jaxs), (ctx, *ports) = _squared_both(lambda *sy: builds[sy](), fold=True,
                                                 optimize=True)
    for jc, tc in zip(jaxs, ports):
        assert [(type(l).__name__[len("Torch"):], l.num_folds) for l in tc.layers] == [
            (type(l).__name__[len("Jax"):], l.num_folds) for l in jc.layers]
    x = np.random.default_rng(0).integers(0, 256, (8, 16))
    for jc, tc, rows in zip(jaxs, ports, (x, x, None)):  # zc, an integral, takes no data
        if rows is None:
            _assert_clog_close(tc(batch_size=1), jc(batch_size=1), 1e-9)
        else:
            _assert_clog_close(tc(torch.as_tensor(rows)), jc(jnp.asarray(rows)), 1e-9)
    sq_out = _np(ports[1](torch.as_tensor(x)))
    np.testing.assert_allclose(sq_out.real, 2 * _np(ports[0](torch.as_tensor(x))).real, rtol=1e-9)
    assert np.abs(np.angle(np.exp(1j * sq_out.imag))).max() < 1e-9  # |c|^2 is real, positive
    jcc, jsq, jzc = jaxs
    store = dict(jctx.parameters)
    tr = {k: v for k, v in store.items() if k in jcc.learnable_slots}
    fr = {k: v for k, v in store.items() if k not in tr}
    xj = jnp.asarray(x)

    def jloss(tr):
        st = {**tr, **fr}
        return -jnp.mean(jsq.evaluate(st, xj).real) + jzc.evaluate(st, xj[:1]).real[0, 0, 0]

    want = jax.grad(jloss)(tr)
    got = _sos_loss_grads(ctx, *ports, torch.as_tensor(x))
    assert set(got) == set(want)
    assert {g.dtype for g in got.values()} == (
        {torch.float64, torch.complex128} if dtype == "complex" else {torch.float64})
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.conj(np.asarray(want[k])), rtol=1e-8,
                                   atol=1e-10 * float(np.abs(want[k]).max()), err_msg=k)


def test_complex_initializer_draws_both_parts_from_the_generator():
    ctxs = [PipelineContext(semiring="complex-lse-sum", fold=True, optimize=True, device="cpu",
                            seed=s) for s in (0, 0, 1)]
    stores = []
    for ctx in ctxs:
        ctx.compile(_bench_sos(image_data, Parameterization, "complex"))
        stores.append({k: v.detach() for k, v in ctx.parameters.items()})
    complex_slots = [k for k, v in stores[0].items() if v.is_complex()]
    assert complex_slots and all(stores[0][k].dtype == torch.complex64 for k in complex_slots)
    for k in complex_slots:
        assert torch.equal(stores[0][k], stores[1][k]) and not torch.equal(stores[0][k],
                                                                         stores[2][k])
        assert float(stores[0][k].imag.std()) > 0.1 and float(stores[0][k].real.std()) > 0.1


@pytest.mark.parametrize("spl", ["tucker", "cp"])
def test_monotonic_circuit_under_complex_equals_lse_sum(spl):
    """A 4x4 QuadGraph circuit, K=4: the complex compile's real parts and
    gradients equal the lse-sum compile's on the same store, phases 0; the
    softmaxed weights stay real."""
    kw = dict(input_layer="categorical", num_input_units=4, sum_product_layer=spl, num_sum_units=4)
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (8, 16)))
    outs, store = {}, None
    for semiring in ("lse-sum", "complex-lse-sum"):
        ctx = PipelineContext(semiring=semiring, fold=True, optimize=True, device="cpu", seed=0)
        cc = ctx.compile(image_data((1, 4, 4), "quad-graph", **kw))
        if store is None:
            store = {k: v.detach().numpy() for k, v in ctx.parameters.items()}
        ctx.load_parameters(store, dtype=torch.float64)
        out = cc(x)
        grads = torch.autograd.grad(-out.real.mean(), list(ctx.parameters.values()))
        outs[semiring] = out, dict(zip(ctx.parameters.keys(), grads))
    (ref, ref_grads), (out, grads) = outs["lse-sum"], outs["complex-lse-sum"]
    assert out.dtype == torch.complex128 and (out.imag == 0).all()
    torch.testing.assert_close(out.real, ref, rtol=1e-12, atol=0)
    for k, g in grads.items():
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, ref_grads[k], rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ctype", [np.complex64, np.complex128])
def test_complex_slots_through_store_from_numpy_and_the_npz_checkpoint(ctype, tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"p0": (rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3))).astype(ctype),
              "p1": rng.normal(size=(2, 3)).astype(np.float32)}
    kept = store_from_numpy(arrays, device="cpu")
    assert kept["p0"].dtype == getattr(torch, np.dtype(ctype).name)
    for real, want in ((torch.float64, torch.complex128), (torch.float32, torch.complex64)):
        cast = store_from_numpy(arrays, device="cpu", dtype=real)
        assert cast["p0"].dtype == want and cast["p1"].dtype == real
        np.testing.assert_allclose(cast["p0"].numpy(), arrays["p0"], rtol=1e-6)
    path = tmp_path / "store.npz"
    save_store(path, kept)
    plain = load_store(path)
    assert plain["p0"].dtype == ctype
    np.testing.assert_array_equal(plain["p0"], arrays["p0"])
    like = {"p0": torch.zeros(2, 3, dtype=torch.complex128), "p1": torch.zeros(2, 3)}
    back = load_store(path, like)
    assert back["p0"].dtype == torch.complex128 and back["p1"].dtype == torch.float32
    np.testing.assert_allclose(back["p0"].numpy(), arrays["p0"], rtol=1e-6)


def test_complex_circuit_store_round_trips_through_a_checkpoint(tmp_path):
    ctx = PipelineContext(semiring="complex-lse-sum", fold=True, optimize=True, device="cpu",
                          seed=0)
    cc = ctx.compile(_bench_sos(image_data, Parameterization, "complex"))
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (4, 16)))
    want = cc(x).detach()
    path = tmp_path / "cc.npz"
    save_store(path, dict(ctx.parameters))
    ctx2 = PipelineContext(semiring="complex-lse-sum", fold=True, optimize=True, device="cpu",
                           seed=1)
    cc2 = ctx2.compile(_bench_sos(image_data, Parameterization, "complex"))
    assert not torch.allclose(cc2(x).detach(), want)
    ctx2.load_parameters(load_store(path))
    assert torch.equal(cc2(x).detach(), want)


# --------------------------------------------------------------------------- #
# differentiate
# --------------------------------------------------------------------------- #


def _polynomial_pc(Sy, Sc, seed=44):
    rng = np.random.default_rng(seed)
    p0 = Sy.PolynomialLayer(Sc([0]), 2, degree=2, coeff=_const(Sy, rng.normal(size=(2, 3))))
    p1 = Sy.PolynomialLayer(Sc([1]), 2, degree=2, coeff=_const(Sy, rng.normal(size=(2, 3))))
    h = Sy.HadamardLayer(2, arity=2)
    s = Sy.SumLayer(2, 1, weight=_const(Sy, [[0.8, 0.4]]))
    return Sy.Circuit([p0, p1, h, s], {h: [p0, p1], s: [h]}, [s])


def _linear_value(out) -> np.ndarray:
    if isinstance(out, tuple):
        return _np(out[1]) * np.exp(_np(out[0]))
    out = _np(out)
    return np.exp(out).real if np.iscomplexobj(out) else out


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("semiring", ["signed-lse-sum", "complex-lse-sum", "sum-product"])
def test_differentiated_circuit_matches_finite_differences_and_jax(semiring, fold, order,
                                                                   float64_default):
    """``tests/backend/test_signed.py::test_signed_differentiated_circuit``:
    the differential of a circuit of polynomial inputs (Horner evaluation,
    the polynomial differential node) against central finite differences of
    the circuit itself and against JAX's compile of the same circuit."""
    x = np.random.default_rng(45).normal(size=(5, 2))
    ctx = PipelineContext(semiring=semiring, fold=fold, device="cpu")
    dcc = ctx.compile(TSF.differentiate(_polynomial_pc(*PORT), order=order))
    got = _linear_value(dcc(torch.as_tensor(x)))
    jctx = JaxPipelineContext(semiring=semiring, fold=fold)
    want = _linear_value(jctx.compile(JSF.differentiate(_polynomial_pc(*JAX), order=order))(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    sc = _polynomial_pc(*JAX)
    eps = 1e-4

    def f(xs):
        return eval_circuit(sc, xs)[:, 0, 0]

    for v in range(2):
        step = np.zeros(2)
        step[v] = eps
        fd = ((f(x + step) - f(x - step)) / (2 * eps) if order == 1
              else (f(x + step) - 2 * f(x) + f(x - step)) / eps**2)
        np.testing.assert_allclose(got[:, v, 0], fd, rtol=1e-5, atol=1e-6)


def test_context_differentiate_and_polynomial_product_match_jax(float64_default):
    """``PipelineContext.differentiate`` of a compiled circuit, and the square
    of a polynomial circuit (the FFT product of coefficient families) under
    the signed and the complex semiring."""
    x = np.random.default_rng(46).normal(size=(4, 2))
    for semiring in ("signed-lse-sum", "complex-lse-sum"):
        ctx = PipelineContext(semiring=semiring, fold=True, device="cpu")
        jctx = JaxPipelineContext(semiring=semiring, fold=True)
        cc, jcc = ctx.compile(_polynomial_pc(*PORT)), jctx.compile(_polynomial_pc(*JAX))
        for got, want in ((ctx.differentiate(cc), jctx.differentiate(jcc)),
                          (ctx.multiply(cc, cc), jctx.multiply(jcc, jcc))):
            np.testing.assert_allclose(_linear_value(got(torch.as_tensor(x))),
                                       _linear_value(want(x)), rtol=1e-9, atol=1e-12)
        sq = _linear_value(ctx.multiply(cc, cc)(torch.as_tensor(x)))[:, 0, 0]
        np.testing.assert_allclose(sq, eval_circuit(_polynomial_pc(*JAX), x)[:, 0, 0] ** 2,
                                   rtol=1e-9)
