"""The signed and complex dense forwards at the edges of the CUDA kernels'
narrow route, against the JAX package, on the CPU.

On the card a dense signed or complex layer with I and O at most 32 (the
squared circuits' TensorDot entries) takes a kernel of its own
(``slse_fwd_narrow``, ``clse_fwd_narrow``) and every other layer the tiled
one; ``tests/test_torch_cuda.py`` holds both against the plain versions
there. This file holds those plain versions (``slse_matmul_ref``,
``slse_matmul_softmax_ref``, ``clse_matmul_ref``) against JAX's at the same
edges: I and O of 1, 7, 32 and 33, B of 1, 33 and 4096, with a row that is
all -inf and rows that cancel exactly.

- float64 and complex128 against the semirings' XLA compositions
  (``SignedLSESemiring.matmul`` / ``matmul_softmax``,
  ``ComplexLSESumSemiring.matmul``), to 1e-12;
- float32 and complex64 against the Pallas kernels in interpret mode (the
  semirings' ops with ``CIRKIT_TPU_FORCE_PALLAS``: ``slse_dispatch``,
  ``clse_matmul_parts``, a real weight cast to complex64 as JAX casts it),
  to 5e-4 (the kernels' bf16x3 products); where the JAX dispatcher declines
  the shape (O < 8) JAX runs its XLA composition in float32, and so does
  this comparison.

Values are compared in linear space scaled by each row's absolute mass A
(the lse of the inputs against ``|w|``): ``|s exp(a - A) - s' exp(a' - A)|``
for the signed pairs and ``|exp(z - A) - exp(z' - A)|`` for the complex
values (so phases compare modulo 2 pi), with -inf where the mass is 0 and,
in the signed op, signs equal wherever the value exceeds the bound. A row
that cancels exactly is -inf (sign 0) on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax.semiring import ComplexLSESumSemiring as JComplex
from cirkit_tpu.backend.jax.semiring import SignedLSESemiring as JSigned
from cirkit_tpu.ops.lse_einsum import clse_matmul_parts, slse_dispatch
from cirkit_tpu_torch.ops import clse_einsum as C
from cirkit_tpu_torch.ops import lse_einsum as L
from cirkit_tpu_torch.ops import slse_einsum as S

F = 2
# (B, I, O): I and O of 1, 7 and 32 on the narrow route, 33 past it
SHAPES = [(1, 1, 1), (33, 7, 32), (4096, 32, 7), (4096, 32, 32), (33, 32, 1), (4096, 1, 32),
          (33, 33, 32), (4096, 32, 33), (1, 33, 33)]
# (op, dtype, real weight)
OPS = [("slse_matmul", np.float32, True), ("slse_matmul_softmax", np.float32, True),
       ("slse_matmul", np.float64, True), ("slse_matmul_softmax", np.float64, True),
       ("clse_matmul", np.complex64, False), ("clse_matmul", np.complex64, True),
       ("clse_matmul", np.complex128, False), ("clse_matmul", np.complex128, True)]
_TOL = {np.float32: 5e-4, np.complex64: 5e-4, np.float64: 1e-12, np.complex128: 1e-12}


@pytest.fixture(autouse=True)
def _zero_launches():
    for op in L.LAUNCHES:
        L.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in L.LAUNCHES.values()), "a CPU test launched a kernel"


def _inputs(op, b, i, o, dtype, real_w):
    """The op's inputs, made from a seed: fold 0's row 2 (the last row for
    B < 3) all -inf and, where B > 11 and I > 1, rows 9-11 of fold 0 summing
    to exactly 0 (equal magnitudes against weights of equal size and
    alternating sign over an even number of columns)."""
    rng = np.random.default_rng(b * 1000 + i * 10 + o)
    row, rows, even = min(2, b - 1), slice(9, 12), i - i % 2
    cancel = b > 11 and i > 1
    alt = np.resize([1.0, -1.0], even)
    if op.startswith("clse"):
        real = np.float64 if dtype == np.complex128 else np.float32
        x = (rng.normal(size=(F, b, i)) * 3.0 - 2.0
             + 1j * rng.uniform(-np.pi, np.pi, size=(F, b, i))).astype(dtype)
        w = rng.normal(size=(F, o, i))
        if not real_w:
            w = w + 1j * rng.normal(size=(F, o, i))
        x[0, row] = complex(-np.inf, 0.5)
        if cancel:
            x[0, rows] = 0.0
            w[0] = 0.0
            w[0, :, :even] = alt
        return [x, w.astype(real if real_w else dtype)]
    a = (rng.normal(size=(F, b, i)) * 3.0 - 2.0).astype(dtype)
    s = rng.choice([-1.0, 0.0, 1.0], size=(F, b, i), p=[0.45, 0.1, 0.45]).astype(dtype)
    w = rng.normal(size=(F, o, i)).astype(dtype)
    a[0, row] = -np.inf
    if cancel:
        a[0, rows] = 0.0
        s[0, rows] = 0.0
        s[0, rows, :even] = alt
        w[0] = 0.0 if "softmax" in op else 1.0
    return [a, s, w]


def _jax_op(op, ins):
    """JAX's op: in float32/complex64 the Pallas kernel in interpret mode
    where its dispatcher takes the shape, else the semiring's XLA
    composition."""
    j = [jnp.asarray(t) for t in ins]
    if op.startswith("clse"):
        return JComplex.matmul(*j)
    hook = JSigned.matmul_softmax if "softmax" in op else JSigned.matmul
    return hook((j[0], j[1]), j[2])


def _lin_close(op, ins, got, want, tol):
    """Linear-space agreement scaled by the row's absolute mass; -inf (sign 0)
    where the mass is 0; signs equal above the bound."""
    t = [torch.as_tensor(np.asarray(v)) for v in ins]
    if op.startswith("clse"):
        x, w = t
        mass = L.lse_matmul_ref(x.real.double(), w.abs().double()).numpy()
        got, want = (np.asarray(v, np.complex128) for v in (got, want))
        empty = np.isneginf(mass)
        assert not np.isnan(got).any() and np.isneginf(got.real[empty]).all()
        with np.errstate(invalid="ignore", over="ignore"):
            lin_g = np.where(empty, 0.0, np.exp(got - mass))
            lin_w = np.where(empty, 0.0, np.exp(want - mass))
        assert np.abs(lin_g - lin_w).max() <= tol
        return
    w = torch.softmax(t[2].double(), -1) if "softmax" in op else t[2].double().abs()
    mass = L.lse_matmul_ref(t[0].double(), w).numpy()
    (ga, gs), (wa, ws) = [tuple(np.asarray(v, np.float64) for v in p) for p in (got, want)]
    empty = np.isneginf(mass)
    assert not np.isnan(ga).any() and not np.isnan(gs).any()
    assert np.isneginf(ga[empty]).all() and (gs[empty] == 0).all()
    with np.errstate(invalid="ignore"):
        lin_g = np.where(empty, 0.0, gs * np.exp(ga - mass))
        lin_w = np.where(empty, 0.0, ws * np.exp(wa - mass))
    assert np.abs(lin_g - lin_w).max() <= tol
    big = np.abs(lin_w) > tol
    np.testing.assert_array_equal(gs[big], ws[big])


@pytest.mark.parametrize("opcase", OPS, ids=lambda c: f"{c[0]}-{np.dtype(c[1]).name}"
                         + ("-real-w" if c[0].startswith("clse") and c[2] else ""))
@pytest.mark.parametrize("b,i,o", SHAPES)
def test_plain_matches_jax_at_the_narrow_edges(b, i, o, opcase, monkeypatch):
    op, dtype, real_w = opcase
    ins = _inputs(op, b, i, o, dtype, real_w)
    single = dtype in (np.float32, np.complex64)
    if single:
        monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
        j = [jnp.asarray(t) for t in ins]
        if op.startswith("clse"):
            taken = clse_matmul_parts(j[0], JComplex.cast(j[1]), interpret=True) is not None
        else:
            taken = slse_dispatch((j[0], j[1]), j[2], softmax="softmax" in op, tucker=False,
                                  interpret=True) is not None
        assert taken == (o >= 8)  # the JAX dispatcher declines O < 8
    want = _jax_op(op, ins)
    got = getattr(C if op.startswith("clse") else S, op)(*(torch.as_tensor(t) for t in ins))
    if op.startswith("clse"):
        assert got.dtype == torch.as_tensor(ins[0]).dtype and got.shape == (F, b, o)
        assert np.isfinite(got.imag.numpy()).all()
    else:
        assert all(t.dtype == torch.as_tensor(ins[0]).dtype and t.shape == (F, b, o) for t in got)
    _lin_close(op, ins, got, want, _TOL[dtype])
    row = min(2, b - 1)
    out = got.real if op.startswith("clse") else got[0]
    assert torch.isneginf(out[0, row]).all()
    if b > 11 and i > 1:  # the exact cancellation
        assert torch.isneginf(out[0, 9:12]).all()
        if not op.startswith("clse"):
            assert (got[1][0, 9:12] == 0).all()
