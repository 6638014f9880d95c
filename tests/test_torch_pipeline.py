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
