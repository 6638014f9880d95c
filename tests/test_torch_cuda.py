"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
one). This file imports no JAX, so it runs on a machine that has a card
and no JAX, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel entry is held against its plain PyTorch version on the same
CUDA tensors, to ``1e-4 + 1e-5 |plain|`` in log space (f32 FMAs sum in
another order than cuBLAS); a small circuit's forward through the kernels
is held against the same store evaluated in float64 on the CPU.
"""

import numpy as np
import pytest
import torch

from cirkit_tpu_torch.backend.torch.layers import TorchSumLayer
from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer, TorchTuckerLayer
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.ops import lse_einsum as T
from cirkit_tpu_torch.pipeline import PipelineContext

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0


def _inputs(op, f, b, o, k1=8, k2=16, i=32):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def logx(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 3.0 - 2.0

    width = k1 * k2 if "tucker" in op else i
    xs = [logx(f, b, k1), logx(f, b, k2)] if "tucker" in op else [logx(f, b, i)]
    if "softmax" in op:
        w = torch.randn((f, o, width), generator=gen, device="cuda")
    else:
        w = torch.rand((f, o, width), generator=gen, device="cuda") * 0.99 + 0.01
    return [*xs, w]


OPS = ["lse_matmul", "lse_matmul_softmax", "lse_tucker2", "lse_tucker2_softmax"]


@pytest.mark.parametrize("f,b,o", [(3, 8, 16), (3, 13, 1), (2, 130, 70)])
@pytest.mark.parametrize("op", OPS)
def test_kernel_matches_plain(op, f, b, o):
    ins = _inputs(op, f, b, o)
    ins[0][0, 2] = float("-inf")  # a row that is all -inf
    out = getattr(T, op)(*ins)
    ref = getattr(T, f"{op}_ref")(*ins)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1
    assert not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    assert torch.isneginf(out[0, 2]).all()
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs()
    assert bool((err <= 1e-4 + 1e-5 * ref[finite].abs()).all()), float(err.max())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w = _inputs("lse_matmul", 2, 8, 16)
    with pytest.raises(TypeError, match="float32"):
        T.lse_matmul(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        T.lse_matmul(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="operands on"):
        T.lse_matmul(x, w.cpu())
    with pytest.raises(NotImplementedError, match="backward kernel"):
        T.lse_matmul(x, w.requires_grad_())
    assert T.LAUNCHES["lse_matmul"] == 0


@pytest.mark.parametrize("spl", ["cp", "tucker"])
def test_small_circuit_through_the_kernels(spl):
    shape = (1, 8, 8)
    kw = dict(input_layer="categorical", num_input_units=8, sum_product_layer=spl,
              num_sum_units=8)
    flags = dict(semiring="lse-sum", fold=True, optimize=True, seed=0)
    ctx = PipelineContext(**flags, device="cuda")
    cc = ctx.compile(image_data(shape, "quad-graph", **kw))
    x = np.random.default_rng(0).integers(0, 256, (16, 64))
    with torch.inference_mode():
        out = cc(torch.as_tensor(x, device="cuda"))
    n_kernel = sum(isinstance(l, (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer))
                   for l in cc.layers)
    assert sum(T.LAUNCHES.values()) == n_kernel
    ctx_cpu = PipelineContext(**flags, device="cpu")
    cc_cpu = ctx_cpu.compile(image_data(shape, "quad-graph", **kw))
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    with torch.inference_mode():
        ref = cc_cpu(torch.as_tensor(x))
    np.testing.assert_allclose(out.double().cpu().numpy(), ref.numpy(), rtol=1e-5)
