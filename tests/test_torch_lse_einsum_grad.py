"""The backward of the port's log-einsum-exp ops against the JAX package's,
on the CPU.

The same inputs and cotangent, made from a seed with numpy, go through
``jax.vjp`` of the JAX op and through ``torch.autograd`` of the port's op
(on CPU tensors the op's ``autograd.Function`` runs the plain backward
``*_bwd_ref``, the math of the CUDA backward kernel):

- in float64 against the JAX XLA fallback, to 1e-10;
- in float32 against the JAX Pallas ``_bwd_kernel`` in interpret mode
  (forced with ``CIRKIT_TPU_FORCE_PALLAS``, which needs O >= 8), to the
  5e-3 of ``tests/ops/test_lse_einsum.py``'s gradient tests (the TPU
  kernel's bf16x3 dots), with a row that is all -inf, which must give zero
  gradients and no NaN in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.ops import lse_einsum as J
from cirkit_tpu_torch.ops import lse_einsum as T

F, I, K1, K2 = 2, 32, 8, 16


def _inputs(op: str, b: int, o: int, dtype, seed: int = 0) -> list[np.ndarray]:
    """Log-space inputs, linear weights (or softmax logits) and a cotangent."""
    rng = np.random.default_rng(seed)

    def logx(*shape):
        return (rng.normal(size=shape) * 3.0 - 2.0).astype(dtype)

    width = K1 * K2 if "tucker" in op else I
    xs = [logx(F, b, K1), logx(F, b, K2)] if "tucker" in op else [logx(F, b, I)]
    if "softmax" in op:
        w = rng.normal(size=(F, o, width)).astype(dtype)
    else:
        w = rng.uniform(0.01, 1.0, size=(F, o, width)).astype(dtype)
    g = rng.normal(size=(F, b, o)).astype(dtype)
    return [*xs, w, g]


def _jax_vjp(op: str, ins: list[np.ndarray], g: np.ndarray) -> list[np.ndarray]:
    _, vjp = jax.vjp(getattr(J, op), *(jnp.asarray(a) for a in ins))
    return [np.asarray(d) for d in vjp(jnp.asarray(g))]


def _port_vjp(op: str, ins: list[np.ndarray], g: np.ndarray) -> list[np.ndarray]:
    ts = [torch.as_tensor(a).requires_grad_() for a in ins]
    out = getattr(T, op)(*ts)
    return [d.numpy() for d in torch.autograd.grad(out, ts, torch.as_tensor(g))]


@pytest.fixture(autouse=True)
def _zero_launches():
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0


@pytest.mark.parametrize("o", [1, 16])
@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("op", T.OPS)
def test_backward_matches_jax_fallback_float64(op, b, o):
    *ins, g = _inputs(op, b, o, np.float64)
    ref = _jax_vjp(op, ins, g)
    got = _port_vjp(op, ins, g)
    for name, a, r in zip(("x", "x2", "w")[-len(ins):], got, ref):
        assert a.dtype == np.float64 and a.shape == r.shape
        np.testing.assert_allclose(a, r, rtol=1e-10, atol=1e-10, err_msg=name)
    assert all(n == 0 for n in T.LAUNCHES.values())


@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("op", T.OPS)
def test_backward_matches_jax_pallas_interpret_float32(op, b, monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    *ins, g = _inputs(op, b, 16, np.float32, seed=1)
    ins[0][1, 3] = -np.inf  # a row that is all -inf
    ref = _jax_vjp(op, ins, g)
    got = _port_vjp(op, ins, g)
    for a, r in zip(got, ref):
        assert a.dtype == np.float32 and not np.isnan(a).any() and not np.isnan(r).any()
        np.testing.assert_allclose(a, r, rtol=5e-3, atol=5e-3)
    for d in got[:-1] + ref[:-1]:
        assert (d[1, 3] == 0).all()  # the -inf row's input gradients are zero


@pytest.mark.parametrize("op", T.OPS)
def test_gradcheck_float64(op):
    rng = np.random.default_rng(2)
    tucker = "tucker" in op
    shapes = [(2, 3, 2), (2, 3, 3), (2, 2, 6)] if tucker else [(2, 3, 4), (2, 2, 4)]
    ts = [torch.as_tensor(rng.normal(size=s)) for s in shapes]
    if "softmax" not in op:
        ts[-1] = ts[-1].abs() + 0.1
    assert torch.autograd.gradcheck(getattr(T, op), [t.requires_grad_() for t in ts])


@pytest.mark.parametrize("op", T.OPS)
def test_backward_skips_gradients_not_needed(op):
    """A frozen weight gets no dw and an input that needs no gradient no dx;
    the ones computed equal the full backward's."""
    *ins, g = [torch.as_tensor(a) for a in _inputs(op, 8, 16, np.float64)]
    out = getattr(T, op)(*ins)
    bwd = getattr(T, f"{op}_bwd_ref")
    full = bwd(*ins, out, g)
    for k in range(len(ins)):
        needs = tuple(i == k for i in range(len(ins)))
        part = bwd(*ins, out, g, needs)
        assert all((p is None) == (not n) for p, n in zip(part, needs))
        torch.testing.assert_close(part[k], full[k], rtol=0, atol=0)
    w = ins[-1].clone().requires_grad_()
    (dw,) = torch.autograd.grad(getattr(T, op)(*ins[:-1], w), [w], g)
    torch.testing.assert_close(dw, full[-1], rtol=0, atol=0)


def test_zero_upstream_gradient_gives_zero_input_gradient():
    *ins, g = [torch.as_tensor(a) for a in _inputs("lse_tucker2_softmax", 8, 16, np.float64)]
    g[0, 2] = 0.0
    out = T.lse_tucker2_softmax(*ins)
    dx1, dx2, _ = T.lse_tucker2_softmax_bwd_ref(*ins, out, g)
    assert (dx1[0, 2] == 0).all() and (dx2[0, 2] == 0).all()
