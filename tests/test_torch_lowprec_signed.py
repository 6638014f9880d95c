"""The bf16-weight and ``CIRKIT_TPU_FAST`` configurations of the signed
kernels (6 and 7) and the fast modes of the complex kernels (10 and 11)
against the JAX package, on the CPU.

On CPU tensors the port runs its plain versions, which round at the port's
kernels' points (``ops/slse_einsum.py``, ``ops/clse_einsum.py``); the JAX
package runs ``slse_dispatch`` and ``clse_matmul_parts`` in interpret mode
in the mode ``_cfg_fast`` gives (``CIRKIT_TPU_FORCE_PALLAS``, as
``tests/test_torch_signed.py`` and ``tests/test_torch_complex.py`` do), the
complex Tucker op through the log-space outer sum its semiring feeds the
dense kernel. The two round at different points, so each is held against
float64 (complex128) within the JAX package's fast bounds (8e-3 forward, 4e-2
gradient, ``tests/ops/test_lse_einsum.py``'s ``_BOUNDS``) and against the
other within twice them. A signed or complex sum that nearly cancels has no
log-space bound, so values are compared in linear space scaled by each row's
absolute mass A (the lse of the inputs against ``|w|``), on the real and
imaginary parts of a complex one, and so are gradients: those of ``sum(g
y / Y)``, the linear output ``y`` scaled by the row's absolute mass ``Y =
exp(A)`` (the gradient of ``log|y|`` carries ``1 / y``, which no rounding
bounds where ``y`` nearly cancels). ``sr`` has no interpret-mode lowering in
JAX, which runs it as ``bf16``: the port's ``sr`` is held to the same bounds
and to itself, bit for bit. A bf16 weight's gradient comes back bf16, as
JAX's ``_sfused_p_bwd`` casts it; the f32-grade mode on a bf16 weight is
held to float32's bounds, and a bf16 weight in a fast mode gives the fast
mode's result on the widened weight, to the bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax.utils import csafelog as jax_csafelog
from cirkit_tpu.ops import lse_einsum as J
from cirkit_tpu.ops.lse_einsum import clse_matmul_parts, slse_dispatch
from cirkit_tpu_torch.ops import _build
from cirkit_tpu_torch.ops import clse_einsum as C
from cirkit_tpu_torch.ops import lse_einsum as L
from cirkit_tpu_torch.ops import slse_einsum as S

FWD_TOL, GRAD_TOL = 8e-3, 4e-2
MODES = {"bf16": "1", "sr": "sr"}  # mode -> CIRKIT_TPU_FAST
# a batch the JAX kernels' 8-row tiles leave ragged, O >= 8 (JAX's dispatch)
F, B, O, I, K1, K2 = 2, 13, 8, 32, 4, 8
SIGNED_OPS = ["slse_matmul", "slse_matmul_softmax", "slse_tucker2", "slse_tucker2_softmax"]
COMPLEX_OPS = ["clse_matmul", "clse_tucker2"]
# (B, I, O): edges of the narrow route that JAX's kernels take (O >= 8),
# from tests/test_torch_narrow_fwd.py's SHAPES
NARROW = [(33, 7, 32), (33, 33, 32), (1, 33, 33), (33, 32, 8)]


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("CIRKIT_TPU_FAST", raising=False)
    for op in L.LAUNCHES:
        L.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in L.LAUNCHES.values()), "a CPU test launched a kernel"


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (to nearest even) and widened back, exactly."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# --------------------------------------------------------------------------- #
# Kernels 6' and 7': the signed ops
# --------------------------------------------------------------------------- #


def _signed_inputs(op: str, w16: bool, *, b: int = B, i: int = I, o: int = O, seed: int = 40):
    """(log-magnitude, sign) inputs with some signs 0 and a row that is all
    -inf, normal weights of both signs (or logits), bf16-valued for ``w16``,
    and a cotangent of the log-magnitude output."""
    rng = np.random.default_rng(seed)

    def signed(*shape):
        a = (rng.normal(size=shape) * 3.0 - 2.0).astype(np.float32)
        s = rng.choice([-1.0, 0.0, 1.0], size=shape, p=[0.45, 0.1, 0.45]).astype(np.float32)
        return [a, s]

    tucker = "tucker" in op
    xs = [*signed(F, b, K1), *signed(F, b, K2)] if tucker else signed(F, b, i)
    xs[0][0, min(2, b - 1)] = -np.inf
    w = rng.normal(size=(F, o, K1 * K2 if tucker else i)).astype(np.float32)
    g = rng.normal(size=(F, b, o)).astype(np.float32)
    return [*xs, _bf16(w) if w16 else w], g


def _signed_port(op: str, ins, g, w16: bool):
    """The port's op on CPU tensors and the gradients of the log-magnitude
    inputs and of the weight for ``sum(g y / Y)`` (module docstring)."""
    t = [torch.as_tensor(a) for a in ins]
    if w16:
        t[-1] = t[-1].to(torch.bfloat16)
    for k in (*range(0, len(t) - 1, 2), len(t) - 1):
        t[k].requires_grad_()
    oa, os = getattr(S, op)(*t)
    lin = torch.as_tensor(g) * os * torch.exp(oa - torch.as_tensor(_abs_mass(op, ins)).float())
    grads = torch.autograd.grad(lin.sum(), [x for x in t if x.requires_grad])
    assert grads[-1].dtype == t[-1].dtype  # a bf16 weight's gradient comes back bf16
    return (oa.detach().numpy(), os.numpy()), [d.float().numpy() for d in grads]


@functools.lru_cache(maxsize=None)
def _signed_jax_fast(op: str, w16: bool):
    """:func:`_signed_jax` on :func:`_signed_inputs` in a fast mode, once for
    both: in interpret mode JAX runs ``sr`` as ``bf16``."""
    assert J._cfg_fast(True) == "bf16"
    return _signed_jax(op, *_signed_inputs(op, w16), w16)


def _signed_jax(op: str, ins, g, w16: bool):
    """``slse_dispatch`` in interpret mode and its VJP, in the mode
    ``_cfg_fast`` gives."""
    *xs, w = ins
    softmax, tucker = "softmax" in op, "tucker" in op
    wj = jnp.asarray(w).astype(jnp.bfloat16) if w16 else jnp.asarray(w)

    def fn(*d):
        full = [d[0], xs[1], d[1], xs[3]] if tucker else [d[0], xs[1]]
        out = slse_dispatch(tuple(jnp.asarray(a) for a in full), d[-1], softmax=softmax,
                            tucker=tucker, interpret=True)
        assert out is not None  # the Pallas kernel ran
        return out

    args = [jnp.asarray(a) for a in xs[::2]] + [wj]
    (oa, os), vjp = jax.vjp(fn, *args)
    mass = jnp.asarray(_abs_mass(op, ins), jnp.float32)
    grads = vjp((jnp.asarray(g) * os * jnp.exp(oa - mass), jnp.zeros_like(os)))
    assert grads[-1].dtype == wj.dtype
    return (np.asarray(oa), np.asarray(os)), [np.asarray(d.astype(jnp.float32)) for d in grads]


def _signed_f64(op: str, ins, g):
    """The float64 composition (the port's f32-grade plain versions) on the
    (bf16-valued) weight."""
    t = [torch.as_tensor(a, dtype=torch.float64) for a in ins]
    oa, os = S._ENTRIES[op][2](*t)
    lin = torch.as_tensor(g, dtype=torch.float64) * os * torch.exp(
        oa - torch.as_tensor(_abs_mass(op, ins)))
    grads = S._ENTRIES[op][3](*t, oa, os, lin)
    return (oa.numpy(), os.numpy()), [d.numpy() for d in grads if d is not None]


def _abs_mass(op: str, ins) -> np.ndarray:
    """The log of each output row's absolute mass: the lse of the
    log-magnitudes (complex: the real parts) against ``|w|`` (softmax
    weights for logits)."""
    t = [torch.as_tensor(np.asarray(x)) for x in ins]
    w = torch.softmax(t[-1].double(), dim=-1) if "softmax" in op else t[-1].abs().double()
    xs = [x.real.double() if x.is_complex() else x.double() for x in t[:-1]]
    if op.startswith("s"):
        xs = xs[::2]
    if "tucker" in op:
        return L.lse_tucker2_ref(xs[0], xs[1], w).numpy()
    return L.lse_matmul_ref(xs[0], w).numpy()


def _signed_held(label, op, ins, got, want, tol):
    """``|s exp(a - A) - s' exp(a' - A)| <= tol``, -inf with sign 0 where the
    mass is 0, no NaN; returns the error."""
    (ga, gs), (wa, ws) = [tuple(np.asarray(v, np.float64) for v in p) for p in (got, want)]
    m = _abs_mass(op, ins)
    assert not np.isnan(ga).any() and not np.isnan(gs).any(), f"{label}: NaN"
    empty = np.isneginf(m)
    assert np.isneginf(ga[empty]).all() and (gs[empty] == 0).all(), f"{label}: empty rows"
    with np.errstate(invalid="ignore"):
        lin_g = np.where(empty, 0.0, gs * np.exp(ga - m))
        lin_w = np.where(empty, 0.0, ws * np.exp(wa - m))
    err = float(np.abs(lin_g - lin_w).max())
    assert err <= tol, f"{label}: linear error {err:.3e} of the row's mass exceeds {tol}"
    return err


def _grads_held(label, got, want, tol):
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert not np.isnan(a).any(), f"{label} grad {k}: NaN"
        scale = max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, f"{label} grad {k}: error {err:.3e} (scale {scale:.3g})"


@pytest.mark.parametrize("w16", [False, True], ids=["f32-w", "bf16-w"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_fast_modes_against_float64_and_the_interpret_kernel(op, mode, w16,
                                                                   monkeypatch):
    """The fast signed forward and backward (kernels 6' and 7'): the port's
    and JAX's interpret-mode kernels', each within the fast bounds of
    float64 and of each other within twice them; a row that is all -inf
    gives (-inf, 0) and zero gradients, no NaN."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", MODES[mode])
    ins, g = _signed_inputs(op, w16)
    port = _signed_port(op, ins, g, w16)
    ref = _signed_f64(op, ins, g)
    jx = _signed_jax_fast(op, w16)
    _signed_held("port", op, ins, port[0], ref[0], FWD_TOL)
    _signed_held("jax", op, ins, jx[0], ref[0], FWD_TOL)
    _signed_held("port vs jax", op, ins, port[0], jx[0], 2 * FWD_TOL)
    _grads_held("port", port[1], ref[1], GRAD_TOL)
    _grads_held("jax", jx[1], ref[1], GRAD_TOL)
    _grads_held("port vs jax", port[1], jx[1], 2 * GRAD_TOL)
    assert np.isneginf(port[0][0][0, 2]).all() and (port[0][1][0, 2] == 0).all()
    assert (port[1][0][0, 2] == 0).all()


@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_f32_grade_on_a_bf16_weight(op):
    """The f32-grade mode on a bf16 weight (the ``_w16`` instances): the
    port's forward and gradients against float64 on the widened weight and
    against JAX's interpret-mode kernels on the bf16 one, within float32's
    bounds (those of ``tests/test_torch_signed.py``)."""
    ins, g = _signed_inputs(op, True, seed=41)
    port = _signed_port(op, ins, g, True)
    ref = _signed_f64(op, ins, g)
    jx = _signed_jax(op, ins, g, True)
    _signed_held("port", op, ins, port[0], ref[0], 1e-5)
    _signed_held("port vs jax", op, ins, port[0], jx[0], 5e-4)
    # dw comes back bf16: its rounding, 2^-8 relative, bounds the gradient
    _grads_held("port dx", port[1][:-1], ref[1][:-1], 1e-4)
    _grads_held("port dw", port[1][-1:], ref[1][-1:], 2 ** -8)
    _grads_held("port vs jax", port[1], jx[1], 2 ** -8 + 5e-3)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_bf16_weight_in_a_fast_mode_is_the_widened_run(op, mode, monkeypatch):
    """A bf16-valued operand is unchanged by both roundings: ``_w16_fast``
    and ``_w16_sr`` give ``_fast`` and ``_sr`` on the widened weight, to the
    bit, forward and backward (the weight's gradient before its cast)."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", MODES[mode])
    ins, g = _signed_inputs(op, True, seed=42)
    t = [torch.as_tensor(a) for a in ins]
    t16 = [*t[:-1], t[-1].to(torch.bfloat16)]
    got, want = S._ENTRIES[op][2](*t16, mode=mode), S._ENTRIES[op][2](*t, mode=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    gt = torch.as_tensor(g)
    got = S._ENTRIES[op][3](*t16, *want, gt, (True,) * len(t), mode)
    want = S._ENTRIES[op][3](*t, *want, gt, (True,) * len(t), mode)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))


@functools.lru_cache(maxsize=None)
def _narrow_jax(op: str, b: int, i: int, o: int):
    """JAX's interpret-mode signed forward on the narrow case's inputs, once
    for both fast modes (it runs ``sr`` as ``bf16``)."""
    assert J._cfg_fast(True) == "bf16"
    ins, _ = _signed_inputs(op, False, b=b, i=i, o=o, seed=43)
    out = slse_dispatch(tuple(jnp.asarray(a) for a in ins[:-1]), jnp.asarray(ins[-1]),
                        softmax="softmax" in op, tucker=False, interpret=True)
    return tuple(np.asarray(v) for v in out)


@pytest.mark.parametrize("b,i,o", NARROW)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("op", ["slse_matmul", "slse_matmul_softmax"])
def test_signed_fast_modes_at_the_narrow_edges(op, mode, b, i, o, monkeypatch):
    """The dense signed ops at the edges of the card's narrow route (I and O
    of 7, 32 and 33, B of 1 and 33): the fast forward within the fast bound
    of float64 and of JAX's interpret-mode kernel."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", MODES[mode])
    ins, _ = _signed_inputs(op, False, b=b, i=i, o=o, seed=43)
    got = getattr(S, op)(*(torch.as_tensor(a) for a in ins))
    want = S._ENTRIES[op][2](*(torch.as_tensor(a, dtype=torch.float64) for a in ins))
    jx = _narrow_jax(op, b, i, o)
    _signed_held("port", op, ins, got, want, FWD_TOL)
    _signed_held("port vs jax", op, ins, got, jx, 2 * FWD_TOL)


@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_sr_repeats_to_the_bit(op, monkeypatch):
    """``sr``'s bits are a stateless hash of each element's index and role:
    a call repeats bit for bit (at a size whose exponentials the CPU takes
    on one thread: threaded, ``torch.exp`` on the CPU was seen to differ in
    its last bit between calls, which a rounding to bf16 can carry)."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", "sr")
    ins, g = _signed_inputs(op, False, seed=44)
    first = _signed_port(op, ins, g, False)
    again = _signed_port(op, ins, g, False)
    assert all(np.array_equal(a, b) for a, b in zip(first[0], again[0]))
    assert all(np.array_equal(a, b) for a, b in zip(first[1], again[1]))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_exact_cancellation_in_the_fast_modes(op, mode, monkeypatch):
    """Equal magnitudes with alternating signs against equal weights sum to
    exactly 0 in every mode (the rounding of equal values is equal): log -inf
    with sign 0 and zero gradients, no NaN."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", MODES[mode])
    alt = np.tile(np.array([1.0, -1.0], np.float32), 8)
    if "tucker" in op:
        xs = [np.zeros((1, 8, 4), np.float32), np.broadcast_to(alt[:4], (1, 8, 4)).copy(),
              np.zeros((1, 8, 4), np.float32), np.ones((1, 8, 4), np.float32)]
    else:
        xs = [np.zeros((1, 8, 16), np.float32), np.broadcast_to(alt, (1, 8, 16)).copy()]
    w = (np.zeros if "softmax" in op else np.ones)((1, 8, 16), np.float32)
    t = [torch.as_tensor(a) for a in (*xs, w)]
    diff = [t[k] for k in (*range(0, len(t) - 1, 2), len(t) - 1)]
    for d in diff:
        d.requires_grad_()
    oa, os = getattr(S, op)(*t)
    assert torch.isneginf(oa).all() and (os == 0).all()
    for d in torch.autograd.grad(oa, diff, torch.ones_like(oa)):
        assert not torch.isnan(d).any() and (d == 0).all()


def test_signed_instances_have_entries_and_counts():
    """Every signed instance has its forward and backward entries in the
    library's signatures, with the float32 entries' arguments, and a
    ``LAUNCHES`` key each; the complex kernels have the fast ones alone."""
    for sfx in L.INSTANCES:
        for fwd, bwd in (("slse_fwd_dense", "slse_bwd_dense"),
                         ("slse_fwd_dense_softmax", "slse_bwd_dense_softmax"),
                         ("slse_fwd_tucker", "slse_bwd_tucker"),
                         ("slse_fwd_tucker_softmax", "slse_bwd_tucker_softmax")):
            assert _build._SIGNATURES[fwd + sfx] == _build._SIGNATURES[fwd]
            assert _build._SIGNATURES[bwd + sfx] == _build._SIGNATURES[bwd]
        assert {f"{op}{sfx}{t}" for op in SIGNED_OPS for t in ("", "_bwd")} <= set(L.LAUNCHES)
    assert C.INSTANCES == ("_fast", "_sr")
    for sfx in C.INSTANCES:
        assert _build._SIGNATURES[f"clse_fwd{sfx}"] == _build._SIGNATURES["clse_fwd"]
        assert _build._SIGNATURES[f"clse_bwd{sfx}"] == _build._SIGNATURES["clse_bwd"]
        assert {f"{op}{sfx}{t}" for op in COMPLEX_OPS for t in ("", "_bwd")} <= set(L.LAUNCHES)
    assert "clse_matmul_w16" not in L.LAUNCHES and "clse_fwd_w16" not in _build._SIGNATURES


def test_modes_follow_the_value_types(monkeypatch):
    """A mode applies to float32 and complex64 values: float64 and
    complex128 run f32-grade and widen a bf16 weight; the complex ops widen
    a bf16 real weight in every mode."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", "1")
    assert S._op_mode(torch.zeros(1)) == "bf16" and S._op_mode(torch.zeros(1).double()) == ""
    assert C._op_mode(torch.zeros(1, dtype=torch.complex64)) == "bf16"
    assert C._op_mode(torch.zeros(1, dtype=torch.complex128)) == ""
    w16 = torch.ones(1, 2, 3, dtype=torch.bfloat16)
    assert S._weight_for(torch.zeros(1, 2, 3), w16).dtype == torch.bfloat16
    assert S._weight_for(torch.zeros(1, 2, 3).double(), w16).dtype == torch.float64
    assert C._real_weight(w16, torch.zeros(1, dtype=torch.complex64)).dtype == torch.float32
    ins, _ = _signed_inputs("slse_matmul", True, seed=45)
    t64 = [torch.as_tensor(a, dtype=torch.float64) for a in ins]
    got = S.slse_matmul(*t64[:-1], t64[-1].to(torch.bfloat16))
    want = S.slse_matmul_ref(*t64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------------------- #
# Kernels 10' and 11': the complex ops
# --------------------------------------------------------------------------- #


def _complex_inputs(op: str, real_w: bool, seed: int = 50):
    """Complex log-space inputs (phases uniform in (-pi, pi]) with a row
    whose real parts are all -inf, and normal weights, complex64 or real."""
    rng = np.random.default_rng(seed)

    def value(*shape):
        return ((rng.normal(size=shape) * 3.0 - 2.0)
                + 1j * rng.uniform(-np.pi, np.pi, size=shape)).astype(np.complex64)

    tucker = "tucker" in op
    xs = [value(F, B, K1), value(F, B, K2)] if tucker else [value(F, B, I)]
    xs[0][0, 2] = complex(-np.inf, 0.5)
    shape = (F, O, K1 * K2 if tucker else I)
    w = rng.normal(size=shape).astype(np.float32)
    if not real_w:
        w = (w + 1j * rng.normal(size=shape)).astype(np.complex64)
    return [*xs, w]


def _loss_planes(op: str, ins, out, lib):
    """``sum(g y / Y)`` on both planes of the linear output (module
    docstring), with a seeded cotangent ``g``."""
    rng = np.random.default_rng(52)
    gr, gi = (rng.normal(size=out.shape) for _ in range(2))
    lin = lib.exp(out - lib.asarray(_abs_mass(op, ins)).astype(out.real.dtype)) \
        if lib is jnp else torch.exp(out - torch.as_tensor(_abs_mass(op, ins)).to(out.real.dtype))
    return (lib.asarray(gr) * lin.real + lib.asarray(gi) * lin.imag).sum() if lib is jnp else \
        (torch.as_tensor(gr) * lin.real + torch.as_tensor(gi) * lin.imag).sum()


def _complex_port(op: str, ins):
    """The port's op and the gradients of its loss (PyTorch's convention)."""
    t = [torch.as_tensor(a).requires_grad_() for a in ins]
    out = getattr(C, op)(*t)
    grads = torch.autograd.grad(_loss_planes(op, ins, out, torch), t)
    assert grads[-1].dtype == t[-1].dtype  # a real weight gets a real gradient
    return out.detach().numpy(), [g.numpy() for g in grads]


@functools.lru_cache(maxsize=None)
def _complex_jax_fast(op: str, real_w: bool):
    """:func:`_complex_jax` on :func:`_complex_inputs` in a fast mode, once
    for both (JAX runs ``sr`` as ``bf16`` in interpret mode)."""
    assert J._cfg_fast(True) == "bf16"
    return _complex_jax(op, _complex_inputs(op, real_w))


def _complex_jax(op: str, ins):
    """``clse_matmul_parts`` in interpret mode plus the ``csafelog`` epilogue
    (a real weight cast to complex64, as JAX's semiring casts it), the Tucker
    op through the log-space outer sum, and its gradients conjugated into
    PyTorch's convention (a real weight's: the real part)."""
    real_w = not np.iscomplexobj(ins[-1])

    def fn(*a):
        *xs, w = a
        x = (xs[0][:, :, :, None] + xs[1][:, :, None, :]).reshape(F, B, -1) if len(xs) == 2 \
            else xs[0]
        parts = clse_matmul_parts(x, w.astype(jnp.complex64), interpret=True)
        assert parts is not None  # the Pallas kernel ran
        yr, yi, m = parts
        return jax_csafelog(jax.lax.complex(yr, yi)) + m

    args = [jnp.asarray(a) for a in ins]
    out = fn(*args)
    grads = jax.grad(lambda *a: _loss_planes(op, ins, fn(*a), jnp),
                     argnums=tuple(range(len(ins))))(*args)
    grads = [np.conj(np.asarray(d)) for d in grads]
    if real_w:
        grads[-1] = grads[-1].real
    return np.asarray(out), grads


def _complex_held(label, op, ins, got, want, tol):
    """``|exp(z - A) - exp(z' - A)| <= tol`` on the real and imaginary parts,
    a real part of -inf where the mass is 0, no NaN."""
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    m = _abs_mass(op, ins)
    assert not np.isnan(got.real).any() and not np.isnan(got.imag).any(), f"{label}: NaN"
    empty = np.isneginf(m)
    assert np.isneginf(got.real[empty]).all(), f"{label}: empty rows"
    with np.errstate(invalid="ignore"):
        diff = np.where(empty, 0.0, np.exp(got - m) - np.exp(want - m))
    err = float(np.maximum(np.abs(diff.real), np.abs(diff.imag)).max())
    assert err <= tol, f"{label}: linear error {err:.3e} of the row's mass exceeds {tol}"


def _complex_grads_held(label, got, want, tol):
    for k, (a, b) in enumerate(zip(got, want)):
        for pa, pb, tag in ((a.real, b.real, "re"), (np.imag(a), np.imag(b), "im")):
            pa, pb = np.asarray(pa, np.float64), np.asarray(pb, np.float64)
            assert not np.isnan(pa).any(), f"{label} grad {k} {tag}: NaN"
            scale = max(1.0, float(np.abs(pb).max()))
            err = float(np.abs(pa - pb).max())
            assert err <= tol * scale, f"{label} grad {k} {tag}: {err:.3e} (scale {scale:.3g})"


@pytest.mark.parametrize("real_w", [False, True], ids=["complex-w", "real-w"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("op", COMPLEX_OPS)
def test_complex_fast_modes_against_complex128_and_the_interpret_kernel(op, mode, real_w,
                                                                       monkeypatch):
    """The fast complex forward and backward (kernels 10' and 11'): the
    port's and JAX's interpret-mode kernels', each within the fast bounds of
    complex128 on every plane and of each other within twice them; a row
    whose real parts are all -inf gives -inf, no NaN."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", MODES[mode])
    ins = _complex_inputs(op, real_w)
    port = _complex_port(op, ins)
    jx = _complex_jax_fast(op, real_w)
    # complex128 runs no fast mode: the f32-grade plain version in complex128
    ref = _complex_port(op, [a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)
                             for a in ins])
    _complex_held("port", op, ins, port[0], ref[0], FWD_TOL)
    _complex_held("jax", op, ins, jx[0], ref[0], FWD_TOL)
    _complex_held("port vs jax", op, ins, port[0], jx[0], 2 * FWD_TOL)
    _complex_grads_held("port", port[1], ref[1], GRAD_TOL)
    _complex_grads_held("jax", jx[1], ref[1], GRAD_TOL)
    _complex_grads_held("port vs jax", port[1], jx[1], 2 * GRAD_TOL)
    assert np.isneginf(port[0].real[0, 2]).all()


@pytest.mark.parametrize("op", COMPLEX_OPS)
def test_complex_sr_repeats_and_complex128_runs_no_fast_mode(op, monkeypatch):
    """``sr`` repeats to the bit; complex128 values under a fast mode run the
    f32-grade plain version; the planes are rounded at their indices in
    ``torch.view_as_real``'s layout."""
    ins = _complex_inputs(op, False, seed=51)
    monkeypatch.setenv("CIRKIT_TPU_FAST", "sr")
    first, again = _complex_port(op, ins), _complex_port(op, ins)
    assert np.array_equal(first[0], again[0], equal_nan=True)
    assert all(np.array_equal(a, b) for a, b in zip(first[1], again[1]))
    t128 = [torch.as_tensor(a.astype(np.complex128)) for a in ins]
    assert torch.equal(getattr(C, op)(*t128), C._ENTRIES[op][0](*t128))
    e = torch.as_tensor(ins[0])
    r = torch.view_as_real(C.round_planes(e, "sr", L.ROLE_E))
    want = L.round_bf16(torch.view_as_real(e).contiguous(), "sr", L.ROLE_E)
    assert torch.equal(r, want)
    idx = torch.arange(torch.view_as_real(e).numel()).view(*e.shape, 2)
    assert torch.equal(idx[..., 1], 2 * torch.arange(e.numel()).view(e.shape) + 1)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("op", COMPLEX_OPS)
def test_complex_exact_cancellation_in_the_fast_modes(op, mode, monkeypatch):
    """Equal magnitudes of phase 0 against weights +1 and -1 sum to exactly
    0 in every mode: a real part of -inf, no NaN, zero gradients."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", MODES[mode])
    n = 2 if "tucker" in op else 1
    xs = [np.zeros((1, 8, 4 if n == 2 else 16), np.complex64) for _ in range(n)]
    w = np.broadcast_to(np.tile(np.array([1.0, -1.0], np.complex64), 8), (1, 8, 16)).copy()
    t = [torch.as_tensor(a).requires_grad_() for a in (*xs, w)]
    out = getattr(C, op)(*t)
    assert torch.isneginf(out.real).all() and not torch.isnan(out.imag).any()
    for d in torch.autograd.grad(out, t, torch.ones_like(out)):
        assert (d == 0).all()


# --------------------------------------------------------------------------- #
# The signed and complex Tucker forwards on the tensor cores: the rounding
# points of their fast plain versions (the kernels' own: ``e2`` and the
# weight rounded, ``e1`` kept float32 and folded in after the products, the
# logits over each unit's running max of the tiles so far) and the entries
# the complex op picks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("op", ["slse_tucker2", "slse_tucker2_softmax"])
def test_signed_fast_tucker_forward_with_positive_signs_is_the_unsigned_one(op, mode):
    """With every sign +1 and weights > 0 (or logits) the signed fast Tucker
    forward's plain version is the unsigned one (``lse_tucker2[_softmax]_ref``,
    whose rounding points the unsigned kernels are held to on the card) to
    float32's rounding of the log (the two add the shifts in another order),
    with every sign +1: it rounds where the unsigned one does."""
    x1, x2, w, _ = _positive(op)
    ones1, ones2 = torch.ones_like(x1), torch.ones_like(x2)
    oa, os = S._ENTRIES[op][2](x1, ones1, x2, ones2, w, mode=mode)
    want = L._ENTRIES[op.removeprefix("s")][2](x1, x2, w, mode=mode)
    assert bool(((os == 1) | torch.isneginf(want)).all())
    assert torch.equal(torch.isneginf(oa), torch.isneginf(want))
    finite = torch.isfinite(want)
    torch.testing.assert_close(oa[finite], want[finite], rtol=1e-6, atol=1e-6)


def _signed_tiles_in_order(a1, s1, a2, s2, theta, mode):
    """The signed fast Tucker forward with logits tile by tile, as the
    kernels of ``csrc/tucker_bf16.cu`` run it (``tests/test_torch_fast_modes.py``'s
    ``_tiles_in_order`` with signs): chunks of ``_TUCKER_JC`` columns, a row
    ``i`` of a chunk a tile, each unit's running max raised by the tile's, its
    float64 sums and normalizer shrunk by ``exp(old - new)``; the tile's
    ``exp(theta - max)`` rounded at its flat index in ``theta``, ``e2 = s2
    exp(a2 - m2)`` rounded at its own, ``e1 = s1 exp(a1 - m1)`` not. Returns
    the linear ``y`` divided by the normalizer, shifted by ``exp(-shift)``."""
    f, b, k1 = a1.shape
    k2, o = a2.shape[2], theta.shape[1]
    e1 = (s1 * torch.exp(a1 - L._clamp_max(a1))).double()
    e2 = L.round_bf16(s2 * torch.exp(a2 - L._clamp_max(a2)), mode, L.ROLE_E).double()
    run = torch.full((f, o), -torch.inf)
    acc = torch.zeros((f, b, o), dtype=torch.float64)
    z = torch.zeros((f, o), dtype=torch.float64)
    th = theta.view(f, o, k1, k2)
    for j0 in range(0, k2, L._TUCKER_JC):
        cols = slice(j0, j0 + L._TUCKER_JC)
        for i in range(k1):
            seg = th[:, :, i, cols]
            new = torch.maximum(run, seg.amax(dim=-1))
            scl = torch.where(new == -torch.inf, 1.0, torch.exp(run - new)).double()
            ex = torch.exp(seg - torch.where(new == -torch.inf, 0.0, new)[..., None])
            run = new
            z = z * scl + ex.double().sum(dim=-1)
            staged = torch.zeros_like(th)
            staged[:, :, i, cols] = ex
            r = L.round_bf16(staged.view(f, o, k1 * k2), mode, L.ROLE_W).view(f, o, k1, k2)
            acc = acc * scl[:, None, :] + e1[:, :, i, None] * torch.einsum(
                "fbj,foj->fbo", e2[:, :, cols], r[:, :, i, cols].double())
    # z is the normalizer over the final max; acc is over the same max
    return acc / z[:, None, :]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k1,k2", [(4, 20), (3, 64), (3, 130)], ids=["k2-20", "k2-64", "k2-130"])
def test_signed_fast_tucker_logits_round_over_the_tiles_running_max(k1, k2, mode):
    """The signed fast Tucker forward with logits rounds what the kernels
    round: ``e2 = s2 exp(a2 - m2)`` and ``exp(theta - r)`` over each unit's
    running max of the tiles so far (K2 of one chunk, a whole one, and three
    with a ragged last), ``e1`` in float32; held to the tile-by-tile run in
    float64 sums, in linear space, to 1e-5 of the row's absolute mass (a
    rounding of e1 or of the product would move it by some 2^-9), with a
    unit whose first tile is all -inf and one whose max rises tile by
    tile."""
    rng = np.random.default_rng(63)

    def signed(*shape):
        a = torch.as_tensor((rng.normal(size=shape) * 3.0 - 2.0).astype(np.float32))
        sg = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32))
        return a, sg

    a1, s1 = signed(2, 5, k1)
    a2, s2 = signed(2, 5, k2)
    theta = torch.as_tensor(rng.normal(size=(2, 4, k1 * k2)).astype(np.float32))
    theta[0, 0, :k2] = -torch.inf
    theta[0, 1] += torch.linspace(-20.0, 20.0, k1 * k2)
    oa, os = S.slse_tucker2_softmax_ref(a1, s1, a2, s2, theta, mode)
    shift = (L._clamp_max(a1) + L._clamp_max(a2)).double()
    want = _signed_tiles_in_order(a1, s1, a2, s2, theta, mode)
    mass = L.lse_tucker2_ref(a1.double(), a2.double(), torch.softmax(theta.double(), dim=-1))
    got = torch.where(torch.isneginf(oa), 0.0, os.double() * torch.exp(oa.double() - mass))
    ref = want * torch.exp(shift - mass)
    assert not torch.isnan(oa).any()
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("mode", list(MODES))
def test_complex_fast_tucker_forward_rounds_e2_and_the_weight(mode):
    """The complex fast Tucker forward against a real weight rounds what the
    tensor-core kernels round: the planes of ``e2 = exp(x2 - m2)`` at their
    flat indices in ``torch.view_as_real``'s layout of x2 and the weight at
    its own, ``e1 = exp(x1 - m1)`` kept complex64 (held to that composition
    summed in complex128, in linear space scaled by the row's absolute mass,
    to 1e-5: a rounding of e1 or of the product would move it by some 2^-9);
    against a complex weight it keeps the CUDA-core kernel's points, the
    outer product rounded."""
    x1, x2, w = (torch.as_tensor(a) for a in _complex_inputs("clse_tucker2", True, seed=64))
    got = C.clse_tucker2_ref(x1, x2, w, mode)
    e1 = C._cis(torch.exp(x1.real - L._clamp_max(x1.real)), x1.imag).to(torch.complex128)
    e2 = C._cis(torch.exp(x2.real - L._clamp_max(x2.real)), x2.imag)
    r2 = torch.view_as_complex(L.round_bf16(torch.view_as_real(e2).contiguous(), mode,
                                            L.ROLE_E)).to(torch.complex128)
    rw = L.round_bf16(w, mode, L.ROLE_W).double().view(F, O, K1, K2)
    y = torch.einsum("fbi,fbj,foij->fbo", e1, r2, rw.to(torch.complex128))
    mass = torch.as_tensor(_abs_mass("clse_tucker2", [x1.numpy(), x2.numpy(), w.numpy()]))
    shift = (L._clamp_max(x1.real) + L._clamp_max(x2.real)).double()
    empty = torch.isneginf(mass)
    lin = torch.where(empty, 0.0, torch.exp(got.to(torch.complex128) - mass))
    ref = torch.where(empty, 0.0, y * torch.exp(shift - mass))
    assert float((lin - ref).abs().max()) <= 1e-5
    assert torch.isneginf(got.real[empty]).all()
    xc, _, wc = (torch.as_tensor(a) for a in _complex_inputs("clse_tucker2", False, seed=64))
    e = C._cis(torch.exp((x1.real - L._clamp_max(x1.real))[..., :, None]
                         + (x2.real - L._clamp_max(x2.real))[..., None, :]),
               x1.imag[..., :, None] + x2.imag[..., None, :]).reshape(F, B, K1 * K2)
    outer = C._from_linear(torch.bmm(C.round_planes(e, mode, L.ROLE_E),
                                     C.round_planes(wc, mode, L.ROLE_W).transpose(1, 2)),
                           L._clamp_max(x1.real) + L._clamp_max(x2.real))
    assert torch.equal(C.clse_tucker2_ref(x1, x2, wc, mode), outer)


@pytest.mark.parametrize("mode", ["", "bf16", "sr"])
def test_complex_forward_entry(mode):
    """Only the complex64 Tucker forward against a real weight takes the
    tensor-core entries ``clse_fwd_tucker_rw[_fast|_sr]`` (11 arguments: four
    operands, five sizes, the device and the stream); a complex weight,
    complex128 and the dense op keep ``clse_fwd``."""
    sfx = L.MODE_SUFFIX[mode]
    rw = C.fwd_entry("clse_tucker2", torch.complex64, torch.float32, mode)
    assert rw == "clse_fwd_tucker_rw" + sfx
    assert len(_build._SIGNATURES[rw][0]) == 11
    assert C.fwd_entry("clse_tucker2", torch.complex64, torch.complex64, mode) == "clse_fwd" + sfx
    assert C.fwd_entry("clse_matmul", torch.complex64, torch.float32, mode) == "clse_fwd" + sfx
    assert C.fwd_entry("clse_tucker2", torch.complex128, torch.float64, "") == "clse_fwd"
    assert f"clse_tucker2{sfx}" in L.LAUNCHES


# --------------------------------------------------------------------------- #
# The signed and complex Tucker backwards on the tensor cores: the host-side
# choices of their dispatch, their scratch, and the plain versions they are
# held to on the card
# --------------------------------------------------------------------------- #

_CSRC = _build._PKG / "csrc"


@pytest.mark.parametrize("w16", [False, True], ids=["f32-w", "bf16-w"])
@pytest.mark.parametrize("mode", ["", "bf16", "sr"])
@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_backward_route_and_entry(op, mode, w16):
    """The float32 signed Tucker backward runs the lse Tucker backward's
    routes (the tensor cores in the f32-grade mode, bf16 weight included;
    ``tucker_bwd_bf16`` in a fast mode), the dense ops and float64 the
    CUDA-core kernels; each under the entry of its op, weight type and mode,
    whose signature takes the route's scratch."""
    tucker = op.startswith("slse_tucker2")
    inst = ("_w16" if w16 else "") + L.MODE_SUFFIX[mode]
    assert S.bwd_route(op, "", mode) == (("bf16" if mode else "tc") if tucker else "fma")
    assert S.bwd_route(op, "_f64", "") == "fma"
    entry = S._ENTRIES[op][1] + inst
    assert entry == ("slse_bwd_tucker" if tucker else "slse_bwd_dense") + \
        ("_softmax" if "softmax" in op else "") + inst
    pointers = sum(t is _build._P for t in _build._SIGNATURES[entry][0])
    if tucker:  # inputs, weight, outputs, g, gradients, shifts, gy, ws, the stream
        assert pointers == 16
    assert f"{op}{inst}_bwd" in L.LAUNCHES


@pytest.mark.parametrize("mode", ["", "bf16", "sr"])
def test_complex_backward_entry(mode):
    """Only the complex64 Tucker backward against a real weight takes the
    tensor-core entries ``clse_bwd_tucker_rw[_fast|_sr]`` (18 arguments: five
    operands, three gradients, three scratch, five sizes, the device and the
    stream); a complex weight, complex128 and the dense op keep
    ``clse_bwd``."""
    sfx = L.MODE_SUFFIX[mode]
    rw = C.bwd_entry("clse_tucker2", torch.complex64, torch.float32, mode)
    assert rw == "clse_bwd_tucker_rw" + sfx
    assert len(_build._SIGNATURES[rw][0]) == 18
    assert C.bwd_entry("clse_tucker2", torch.complex64, torch.complex64, mode) == "clse_bwd" + sfx
    assert C.bwd_entry("clse_matmul", torch.complex64, torch.float32, mode) == "clse_bwd" + sfx
    assert C.bwd_entry("clse_tucker2", torch.complex128, torch.float64, "") == "clse_bwd"
    assert f"clse_tucker2{sfx}_bwd" in L.LAUNCHES


def _constant(src: str, pattern: str) -> int:
    import re

    found = re.search(pattern, (_CSRC / src).read_text())
    assert found, pattern
    return int(found.group(1))


def test_tucker_backward_tiles_match_the_kernels():
    """The tiles that size the tensor-core Tucker backward's partial dx
    sums are the kernels' (``tc_dx::BN``, ``tc_tucker::I_PER``), and the fast
    one's (``tbw::UG``, ``tbw::JC``)."""
    assert L._TC_TUCKER_TILE == (
        _constant("lse_einsum_bwd.cu", r"namespace tc_dx \{[^}]*?constexpr int BN = (\d+);"),
        _constant("lse_einsum_bwd.cu", r"namespace tc_tucker \{\s*constexpr int I_PER = (\d+);"))
    assert L._BWD_UNIT_GROUP == _constant("tucker_bf16_bwd.cu", r"constexpr int UG = (\d+);")
    assert L._TUCKER_JC == _constant("tucker_bf16_bwd.cu", r"constexpr int JC = (\d+);")


@pytest.mark.parametrize("case,want", [
    # (op, route, F, B, K1, K2, O) -> float32 values of ws
    (("slse_tucker2", "tc", 784, 128, 64, 64, 64), 784 * 128 * (64 + 4 * 64)),
    (("slse_tucker2_softmax", "tc", 2, 100, 6, 13, 20), 2 * 2 * 20 + 2 * 100 * (6 + 13)),
    (("slse_tucker2", "tc", 1, 70, 128, 128, 16), 70 * (2 * 128 + 8 * 128)),
    (("slse_tucker2", "bf16", 784, 128, 64, 64, 64), 784 * 128 * 128 + 784 * 128 * 64 // 2),
    (("slse_tucker2_softmax", "bf16", 2, 33, 8, 16, 200),
     2 * 24 * 40 + 2 * 33 * 200 // 2 + 2 * 2 * 200 + 2 * 2 * 33 * 8 + 2 * 2 * 33 * 16),
])
def test_signed_tucker_backward_scratch(case, want):
    """The scratch ``ws`` of each signed Tucker route, pinned at the K=64
    entry and at edges: the tensor cores' (lse_bwd_scratch's layout: the
    softmax statistics, then the dx1 partials, a plane per 64 columns j, and
    the dx2 partials, a plane per 16 rows i) and the fast kernel's
    (``_tucker_bf16_bwd_scratch``: e1 and e2 transposed at Bp, gy in bf16 at
    Op, the softmax statistics, the partials of two unit groups)."""
    op, route, *sizes = case
    assert S.bwd_scratch(op, route, *sizes) == want


@pytest.mark.parametrize("case,want", [
    # (fast, F, B, K1, K2, O) -> float32 values of ws
    ((False, 784, 128, 64, 64, 64), 784 * 256 * 192 + 2 * 784 * 128 * (64 + 4 * 64)),
    ((False, 2, 37, 8, 24, 16), 2 * 80 * 48 + 2 * 2 * 37 * (8 + 24)),
    ((True, 784, 128, 64, 64, 64), 784 * 128 * 256 + 784 * 256 * 64 // 2),
    ((True, 2, 33, 8, 16, 200),
     2 * 24 * 80 + 2 * 80 * 200 // 2 + 2 * 2 * 2 * 33 * 8 + 2 * 2 * 2 * 33 * 16),
])
def test_complex_tucker_backward_scratch(case, want):
    """The scratch of ``clse_bwd_tucker_rw`` (the planes of gy, e1 and e2 at
    the stacked rows, 2 Bp of them, then complex dx partials) and of its fast
    instances (e1 and e2 transposed at the stacked rows, gy in bf16, complex
    partials of two unit groups), pinned at the K=64 entry and at edges."""
    fast, *sizes = case
    assert (C._ctucker_bf16_scratch if fast else C._ctucker_tc_scratch)(*sizes) == want


def _positive(op: str, seed: int = 60):
    """Float32 Tucker inputs with every sign +1 and weights > 0 (or logits),
    so y > 0: the signed and unsigned ops see the same values."""
    rng = np.random.default_rng(seed)
    x1 = (rng.normal(size=(F, B, K1)) * 3.0 - 2.0).astype(np.float32)
    x2 = (rng.normal(size=(F, B, K2)) * 3.0 - 2.0).astype(np.float32)
    x1[0, 2] = -np.inf
    w = rng.normal(size=(F, O, K1 * K2)).astype(np.float32)
    if "softmax" not in op:
        w = np.abs(w) + 0.1
    g = rng.normal(size=(F, B, O)).astype(np.float32)
    g[1, 3] = 0.0
    return [torch.as_tensor(a) for a in (x1, x2, w, g)]


@pytest.mark.parametrize("mode", ["", "bf16", "sr"])
@pytest.mark.parametrize("op", ["slse_tucker2", "slse_tucker2_softmax"])
def test_signed_tucker_backward_with_positive_signs_is_the_unsigned_one(op, mode):
    """The claim the signed fast Tucker backward rests on: it rounds where
    the unsigned one does. With every sign +1 the signed plain backward
    equals the unsigned one (``lse_tucker2[_softmax]_bwd_ref``) to the bit in
    every mode, given the same forward output (the signed forward's: its sign
    +1 where y > 0)."""
    x1, x2, w, g = _positive(op)
    ones1, ones2 = torch.ones_like(x1), torch.ones_like(x2)
    unsigned = op.replace("slse", "lse")
    kw = {"mode": mode} if mode else {}
    oa, os = S._ENTRIES[op][2](x1, ones1, x2, ones2, w, **kw)
    assert bool(((os == 1) | torch.isneginf(oa)).all())
    got = S._ENTRIES[op][3](x1, ones1, x2, ones2, w, oa, os, g, (True,) * 5, **kw)
    want = L._ENTRIES[unsigned][3](x1, x2, w, oa, g, (True,) * 3, **kw)
    assert got[1] is None and got[3] is None
    for a, b in zip(got[::2], want):
        assert torch.equal(a, b)


def _tucker_jax_inputs(op: str, seed: int = 61):
    """Signed Tucker inputs (signs in {-1, 0, +1}, a row of -inf) whose batch
    is a whole number of the JAX kernel's 8-row tiles, the port's plain
    forward outputs on them and a cotangent."""
    rng = np.random.default_rng(seed)

    def signed(*shape):
        a = (rng.normal(size=shape) * 3.0 - 2.0).astype(np.float32)
        s = rng.choice([-1.0, 0.0, 1.0], size=shape, p=[0.45, 0.1, 0.45]).astype(np.float32)
        return [a, s]

    xs = [*signed(F, 16, K1), *signed(F, 16, K2)]
    xs[0][0, 2] = -np.inf
    w = rng.normal(size=(F, O, K1 * K2)).astype(np.float32)
    g = rng.normal(size=(F, 16, O)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (*xs, w)]
    oa, os = S._ENTRIES[op][2](*t)
    return t, oa, os, torch.as_tensor(g)


def _held_rel(got: torch.Tensor, want: np.ndarray, rel: float = 1e-4) -> None:
    want = torch.as_tensor(np.array(want))
    err = (got - want).abs()
    assert bool((err <= rel * (want.abs().max() + want.abs())).all()), float(err.max())


@pytest.mark.parametrize("op", ["slse_tucker2", "slse_tucker2_softmax"])
def test_signed_tucker_plain_backward_matches_the_interpret_kernel(op):
    """The signed plain Tucker backward that the tensor-core kernels are held
    to on the card against JAX's ``_s_call_bwd`` in interpret mode (its
    f32-grade bf16x3 passes) on the same forward outputs and cotangent, to
    1e-4 (max + |plain|)."""
    t, oa, os, g = _tucker_jax_inputs(op)
    cfg = J._Cfg(bt=8, nbt=2, interpret=True, fast="", softmax="softmax" in op, tucker=True)
    jx = J._s_call_bwd(cfg, tuple(jnp.asarray(a.numpy()) for a in t[:4]),
                       jnp.asarray(t[4].numpy()), jnp.asarray(oa.numpy()),
                       jnp.asarray(os.numpy()), jnp.asarray(g.numpy()))
    got = S._ENTRIES[op][3](*t, oa, os, g, (True,) * 5)
    for k in (0, 2, 4):
        _held_rel(got[k], jx[k])


def test_complex_tucker_plain_backward_matches_the_interpret_kernel():
    """The complex Tucker plain backward against a real weight, which the
    tensor-core kernels are held to on the card, against JAX's
    ``_c_call_bwd`` in interpret mode on the log-space outer sum (the
    Tucker op as JAX's semiring feeds its dense kernel), with the port's gy
    and row shift: dx1 and dx2 the sums of its dx over j and over i, dw its
    real plane, to 1e-4 (max + |plain|)."""
    rng = np.random.default_rng(62)

    def value(*shape):
        return ((rng.normal(size=shape) * 3.0 - 2.0)
                + 1j * rng.uniform(-np.pi, np.pi, size=shape)).astype(np.complex64)

    x1, x2 = value(F, 16, K1), value(F, 16, K2)
    x1[0, 2] = complex(-np.inf, 0.5)
    w = rng.normal(size=(F, O, K1 * K2)).astype(np.float32)
    g = (rng.normal(size=(F, 16, O)) + 1j * rng.normal(size=(F, 16, O))).astype(np.complex64)
    t1, t2, tw, tg = (torch.as_tensor(a) for a in (x1, x2, w, g))
    out = C.clse_tucker2_ref(t1, t2, tw)
    got = C.clse_tucker2_bwd_ref(t1, t2, tw, out, tg)
    shift = L._clamp_max(t1.real) + L._clamp_max(t2.real)
    gy = C._complex_gy(tg, out, shift)
    x = (x1[:, :, :, None] + x2[:, :, None, :]).reshape(F, 16, K1 * K2)
    cfg = J._Cfg(bt=8, nbt=2, interpret=True, fast="", softmax=False, tucker=False)
    dxr, dxi, dwr, _ = J._c_call_bwd(
        cfg, jnp.asarray(x.real), jnp.asarray(x.imag), jnp.asarray(w), jnp.zeros_like(w),
        jnp.asarray(shift.numpy()), jnp.asarray(gy.real.numpy()), jnp.asarray(gy.imag.numpy()))
    dx = (np.asarray(dxr) + 1j * np.asarray(dxi)).reshape(F, 16, K1, K2)
    for k, want in enumerate((dx.sum(axis=3), dx.sum(axis=2))):
        _held_rel(torch.view_as_real(got[k]), np.stack([want.real, want.imag], axis=-1))
    _held_rel(got[2], dwr)
