"""The port's log-einsum-exp ops (``cirkit_tpu_torch.ops.lse_einsum``)
against the JAX package's (``cirkit_tpu.ops.lse_einsum``) on the CPU.

The same inputs, made from a seed with numpy, go through both:

- in float64 against the JAX XLA fallback, to 1e-10;
- in float32 against the JAX Pallas kernel in interpret mode (forced with
  ``CIRKIT_TPU_FORCE_PALLAS``, which needs O >= 8), to the 5e-4 of the
  kernel's bf16x3 dots (the tolerance of ``tests/ops/test_lse_einsum.py``).

On the CPU the port's wrappers run their plain versions and launch no
kernel; the kernel itself is tested on the card (``test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.ops import lse_einsum as J
from cirkit_tpu_torch.ops import lse_einsum as T

F, I, K1, K2 = 3, 32, 8, 16
OPS = ["lse_matmul", "lse_matmul_softmax", "lse_tucker2", "lse_tucker2_softmax"]


def _inputs(op: str, b: int, o: int, dtype, seed: int = 0) -> list[np.ndarray]:
    """Log-space inputs and linear weights (or softmax logits) for ``op``."""
    rng = np.random.default_rng(seed)

    def logx(*shape):
        return (rng.normal(size=shape) * 3.0 - 2.0).astype(dtype)

    width = K1 * K2 if "tucker" in op else I
    xs = [logx(F, b, K1), logx(F, b, K2)] if "tucker" in op else [logx(F, b, I)]
    if "softmax" in op:
        w = rng.normal(size=(F, o, width)).astype(dtype)
    else:
        w = rng.uniform(0.01, 1.0, size=(F, o, width)).astype(dtype)
    return [*xs, w]


@pytest.fixture(autouse=True)
def _zero_launches():
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0


@pytest.mark.parametrize("o", [1, 16])
@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_jax_fallback_float64(op, b, o):
    ins = _inputs(op, b, o, np.float64)
    ref = np.asarray(getattr(J, op)(*(jnp.asarray(a) for a in ins)))
    out = getattr(T, op)(*(torch.as_tensor(a) for a in ins))
    assert out.dtype == torch.float64 and out.shape == (F, b, o)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-10)
    assert all(n == 0 for n in T.LAUNCHES.values())


@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_jax_pallas_interpret_float32(op, b, monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    ins = _inputs(op, b, 16, np.float32, seed=1)
    ref = np.asarray(getattr(J, op)(*(jnp.asarray(a) for a in ins)))
    out = getattr(T, op)(*(torch.as_tensor(a) for a in ins))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("op", OPS)
def test_row_of_neg_inf_gives_neg_inf(op):
    ins = [torch.as_tensor(a) for a in _inputs(op, 8, 16, np.float32)]
    ins[0][1, 3] = float("-inf")
    out = getattr(T, op)(*ins)
    assert not torch.isnan(out).any()
    assert torch.isneginf(out[1, 3]).all()
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[1, :3]).all()


@pytest.mark.parametrize("op", OPS)
def test_tensor_off_the_cpu_never_takes_the_plain_version(op):
    """A tensor that is not on the CPU reaches the kernel path, which takes
    only CUDA tensors: a meta tensor raises instead of computing."""
    ins = [torch.as_tensor(a, device="meta") for a in _inputs(op, 8, 16, np.float32)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(T, op)(*ins)
    assert T.LAUNCHES[op] == 0


def test_shapes_are_checked():
    x = torch.zeros(F, 8, I)
    with pytest.raises(ValueError, match="Expected x"):
        T.lse_matmul(x, torch.ones(F, 16, I + 1))
    with pytest.raises(ValueError, match="Expected x1"):
        T.lse_tucker2(torch.zeros(F, 8, K1), torch.zeros(F, 8, K2), torch.ones(F, 16, K1))
