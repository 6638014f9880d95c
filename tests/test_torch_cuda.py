"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
one). This file imports no JAX, so it runs on a machine that has a card
and no JAX, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each forward entry is held against its plain PyTorch version on the same
CUDA tensors, to ``1e-4 + 1e-5 |plain|`` in log space (f32 FMAs sum in
another order than cuBLAS); each backward entry against its plain version
(``*_bwd_ref``) to ``1e-4 max|plain| + 1e-4 |plain|`` per gradient (linear
sums of up to B or O*K2 terms). A small circuit's forward and its
gradients through the kernels are held against the same store evaluated
in float64 on the CPU.
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


def _close(got, ref, *, zeros=False):
    """The backward bound: ``|kernel - plain| <= 1e-4 max|plain| + 1e-4 |plain|``;
    with ``zeros``, 0 wherever the plain version gives 0 (the input
    gradients' rows of -inf inputs or of zero cotangent)."""
    assert got.shape == ref.shape and not torch.isnan(got).any()
    assert not zeros or bool((got[ref == 0] == 0).all())
    err = (got - ref).abs()
    bound = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("f,b,o", [(3, 8, 16), (3, 13, 1), (2, 130, 70)])
@pytest.mark.parametrize(
    "op,k1,k2",  # K2 = 64: the Tucker dx kernel's s tiles each lie in one K1 segment
    [(op, 8, 16) for op in OPS] + [(op, 4, 64) for op in OPS if "tucker" in op],
)
def test_backward_kernel_matches_plain(op, k1, k2, f, b, o):
    ins = _inputs(op, f, b, o, k1=k1, k2=k2)
    ins[0][0, 2] = float("-inf")  # a row that is all -inf
    ins = [t.requires_grad_() for t in ins]
    out = getattr(T, op)(*ins)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[1, 3:5] = 0.0  # rows whose upstream gradient is 0
    grads = torch.autograd.grad(out, ins, g)
    with torch.no_grad():
        refs = getattr(T, f"{op}_bwd_ref")(*ins, out, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, ref) in enumerate(zip(grads, refs)):
        _close(got, ref, zeros=k < len(ins) - 1)
    assert (grads[0][0, 2] == 0).all() and (grads[0][1, 3:5] == 0).all()


@pytest.mark.parametrize("op", ["lse_matmul_softmax", "lse_tucker2_softmax"])
def test_backward_skips_what_needs_no_gradient(op):
    ins = _inputs(op, 2, 8, 16)
    ins[-1].requires_grad_()  # the weight only: the inputs need no gradient
    out = getattr(T, op)(*ins)
    (dw,) = torch.autograd.grad(out.sum(), [ins[-1]])
    with torch.no_grad():
        ref = getattr(T, f"{op}_bwd_ref")(*ins, out, torch.ones_like(out))[-1]
    _close(dw, ref)
    assert T.LAUNCHES[f"{op}_bwd"] == 1


def test_backward_is_deterministic():
    ins = [t.requires_grad_() for t in _inputs("lse_tucker2_softmax", 3, 130, 70)]
    out = T.lse_tucker2_softmax(*ins)
    first = torch.autograd.grad(out.sum(), ins, retain_graph=True)
    again = torch.autograd.grad(out.sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w = _inputs("lse_matmul", 2, 8, 16)
    with pytest.raises(TypeError, match="float32"):
        T.lse_matmul(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        T.lse_matmul(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="operands on"):
        T.lse_matmul(x, w.cpu())
    assert T.LAUNCHES["lse_matmul"] == 0


def _flagship_like(spl, device, em_ready=False):
    kw = dict(input_layer="categorical", num_input_units=8, sum_product_layer=spl,
              num_sum_units=8, em_ready=em_ready)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=0, device=device)
    return ctx, ctx.compile(image_data((1, 8, 8), "quad-graph", **kw))


@pytest.mark.parametrize("spl,em_ready", [("cp", False), ("tucker", False), ("tucker", True)])
def test_small_circuit_train_step_through_the_kernels(spl, em_ready):
    """One Adam step of ``data_parallel_step`` on the card: the gradients of
    every learnable slot against the same store's float64 CPU gradients, to
    ``2e-3 max|slot| + 1e-5``: f32 log-values near the log-likelihood of
    -360 round at 3e-5, which becomes relative error of the gradients, and
    the softmax VJP leaves an absolute floor near the root (the plain f32
    composition on the CPU stays within a fifth of this bound)."""
    from cirkit_tpu_torch.parallel import data_parallel_step, split_trainable

    ctx, cc = _flagship_like(spl, "cuda", em_ready)
    x = np.random.default_rng(0).integers(0, 256, (16, 64))
    ctx_cpu, cc_cpu = _flagship_like(spl, "cpu", em_ready)
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    ref_loss = -cc_cpu(torch.as_tensor(x)).mean()
    ref_grads = dict(zip(ctx_cpu.parameters.keys(),
                         torch.autograd.grad(ref_loss, list(ctx_cpu.parameters.values()))))

    trainable, frozen = split_trainable(cc, ctx.parameters)
    trainable = {k: v.detach().clone().requires_grad_() for k, v in trainable.items()}
    opt = torch.optim.Adam(list(trainable.values()), lr=1e-2)
    step = data_parallel_step(cc, opt)
    loss = step(trainable, frozen, torch.as_tensor(x, device="cuda"))
    torch.cuda.synchronize()
    n_kernel = sum(isinstance(l, (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer))
                   for l in cc.layers)
    assert sum(n for op, n in T.LAUNCHES.items() if op.endswith("_bwd")) == n_kernel
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for k, p in trainable.items():
        ref = ref_grads[k].numpy()
        got = p.grad.double().cpu().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max() + 1e-5,
                                   err_msg=k)


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
