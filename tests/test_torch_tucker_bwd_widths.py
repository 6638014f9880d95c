"""The Tucker backwards at widths whose dx accumulators do not fit one block
of the card's shared memory, against the JAX package, on the CPU.

On the card these widths take the K1-split Tucker dx (the float64 lse
backward from K1 = K2 = 88, complex128 from 100, complex64 from 105, float32
signed from 202). The JAX package computes every width, so the port's plain
versions of the float64 lse, the signed and the complex Tucker backwards
(the math each CUDA backward computes, whatever its split) are held to the
JAX package's gradients there, in float64 (complex128), at K1 = K2 = 128 and
at K1 = 100, K2 = 120, with F = 1, B = 8, O = 4: to ``rtol 1e-9`` with an
absolute floor of 1e-9 of the gradient's largest value (sums of up to 16384
terms of both signs). JAX's complex gradients are conjugated before they are
compared (``tests/test_torch_complex.py`` says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax.semiring import ComplexLSESumSemiring as JComplex
from cirkit_tpu.backend.jax.semiring import SignedLSESemiring as JSigned
from cirkit_tpu.ops import lse_einsum as J
from cirkit_tpu_torch.ops import clse_einsum as C
from cirkit_tpu_torch.ops import lse_einsum as L
from cirkit_tpu_torch.ops import slse_einsum as S

F, B, O = 1, 8, 4
WIDTHS = [(128, 128), (100, 120)]
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _zero_launches():
    for op in L.LAUNCHES:
        L.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in L.LAUNCHES.values()), "a CPU test launched a kernel"


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def _rng_logx(rng, *shape):
    return rng.normal(size=shape) * 3.0 - 2.0


@pytest.mark.parametrize("k1,k2", WIDTHS)
@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
def test_float64_lse_tucker_backward_matches_jax(op, k1, k2):
    rng = np.random.default_rng(0)
    x1, x2 = _rng_logx(rng, F, B, k1), _rng_logx(rng, F, B, k2)
    w = (rng.normal(size=(F, O, k1 * k2)) if "softmax" in op
         else rng.uniform(0.01, 1.0, size=(F, O, k1 * k2)))
    g = rng.normal(size=(F, B, O))
    _, vjp = jax.vjp(getattr(J, op), *(jnp.asarray(a) for a in (x1, x2, w)))
    want = vjp(jnp.asarray(g))
    ts = [torch.as_tensor(a).requires_grad_() for a in (x1, x2, w)]
    got = torch.autograd.grad(getattr(L, op)(*ts), ts, torch.as_tensor(g))
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and not torch.isnan(a).any()
        _close(a.numpy(), b)


@pytest.mark.parametrize("k1,k2", WIDTHS)
@pytest.mark.parametrize("op", ["slse_tucker2", "slse_tucker2_softmax"])
def test_signed_tucker_backward_matches_jax(op, k1, k2):
    """The gradients of the log-magnitudes and of the weight (the sign
    inputs get none), for a cotangent of the log-magnitude output."""
    rng = np.random.default_rng(1)

    def signs(*shape):
        return rng.choice([-1.0, 0.0, 1.0], size=shape, p=[0.45, 0.1, 0.45])

    a1, s1 = _rng_logx(rng, F, B, k1), signs(F, B, k1)
    a2, s2 = _rng_logx(rng, F, B, k2), signs(F, B, k2)
    w = rng.normal(size=(F, O, k1 * k2))
    g = rng.normal(size=(F, B, O))
    hook = getattr(JSigned, op.removeprefix("slse_"))

    def jfun(a1_, a2_, w_):
        return hook((a1_, jnp.asarray(s1)), (a2_, jnp.asarray(s2)), w_)[0]

    _, vjp = jax.vjp(jfun, *(jnp.asarray(a) for a in (a1, a2, w)))
    want = vjp(jnp.asarray(g))
    ts = [torch.as_tensor(a).requires_grad_(n % 2 == 0 or n == 4)
          for n, a in enumerate((a1, s1, a2, s2, w))]
    oa, _ = getattr(S, op)(*ts)
    got = torch.autograd.grad(oa, [t for t in ts if t.requires_grad], torch.as_tensor(g))
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and not torch.isnan(a).any()
        _close(a.numpy(), b)


def _loss_planes(out_re, out_im, lib):
    return lib.sum(lib.sin(out_re) + 0.7 * lib.cos(out_im))


@pytest.mark.parametrize("real_w", [False, True], ids=["complex-w", "real-w"])
@pytest.mark.parametrize("k1,k2", WIDTHS)
def test_complex_tucker_backward_matches_jax_conjugated(k1, k2, real_w):
    rng = np.random.default_rng(2)

    def value(*shape):
        return _rng_logx(rng, *shape) + 1j * rng.uniform(-np.pi, np.pi, size=shape)

    x1, x2 = value(F, B, k1), value(F, B, k2)
    w = rng.normal(size=(F, O, k1 * k2))
    if not real_w:
        w = w + 1j * rng.normal(size=w.shape)
    ins = (x1, x2, w)
    want = jax.grad(lambda *a: _loss_planes(JComplex.tucker2(*a).real,
                                            JComplex.tucker2(*a).imag, jnp),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in ins))
    ts = [torch.as_tensor(a).requires_grad_() for a in ins]
    out = C.clse_tucker2(*ts)
    got = torch.autograd.grad(_loss_planes(out.real, out.imag, torch), ts)
    assert got[-1].dtype == ts[-1].dtype  # a real weight gets a real gradient
    for a, b in zip(got, want):
        assert not torch.isnan(torch.view_as_real(a) if a.is_complex() else a).any()
        _close(a.numpy(), np.conj(np.asarray(b)))
