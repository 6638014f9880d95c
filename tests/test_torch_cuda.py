"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
one). This file imports no JAX, so it runs on a machine that has a card
and no JAX, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each forward entry is held against its plain PyTorch version on the same
CUDA tensors, to ``1e-4 + 1e-5 |plain|`` in log space (f32 FMAs sum in
another order than cuBLAS); each backward entry against its plain version
(``*_bwd_ref``) to ``1e-4 max|plain| + 1e-4 |plain|`` per gradient (linear
sums of up to B or O*K2 terms). The max-product Tucker kernel is held
against its plain version to ``1e-5 |plain| + 1e-5``, the routing choice
by the plain score of the index it picks, and the routing draws by their
frequencies against ``softmax(scores)``. The wide kernels (the K1-chunked
Tucker forward, the blocked dense forward and backward) are held against
their plain versions with the same bounds, at small widths with
``WIDE_WIDTH`` patched down and at the K=128 entry shapes, and so are their
bf16-weight and fast-mode instances (``INSTANCES``) in their modes, the
fast ones also against float64 at I = 16384 to 8e-3; the routing kernels on
a bf16 ``th`` equal their float32 instances on the widened ``th`` to the
bit. The signed
kernels are held against their plain versions in linear space scaled by
each row's absolute mass (a sum that nearly cancels has no accurate
log-magnitude in f32), at small widths and at the SoS TensorDot entry. The
complex kernels are held the same way on the real and imaginary parts, in
complex64 and complex128, and the float64 instances of the single-pass lse
and signed kernels to 1e-10 in log space (1e-12 of the row's mass) and
``1e-9 (max|plain| + |plain|)`` backward. The signed and complex forwards
are also held at the edges of their narrow route (I and O of 1, 7, 32 and
33, B of 1, 33 and 4096), where ``torch.profiler`` names the kernel that
runs, and their Tucker instances on the tensor cores (the float32 signed
ones, the complex64 ones against a real weight) at the K=64 entry, ragged
shapes and an unaligned weight, and against float64 and complex128 at the
K=64 entry (``WIDE_TOL``: 1e-5 of the row's mass, 3 u more in a fast mode). A
small circuit's forward, its gradients and its queries through the
kernels, and a small squared circuit's, are held against the same store
evaluated in float64 on the CPU.
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
    with pytest.raises(TypeError, match="float64"):  # one type for every operand
        T.lse_matmul(x.double(), w)
    with pytest.raises(TypeError, match="float32"):
        T.lse_matmul(x, w.double())
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


# --------------------------------------------------------------------------- #
# The routing kernels (csrc/tucker_route.cu) and the queries
# --------------------------------------------------------------------------- #


def _route_inputs(f, b, k1, k2, o, log_weights, seed=0, edges=True):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x1 = torch.randn((f, b, k1), generator=gen, device="cuda") * 3.0 - 2.0
    x2 = torch.randn((f, b, k2), generator=gen, device="cuda") * 3.0 - 2.0
    th = (torch.randn((f, o, k1 * k2), generator=gen, device="cuda") if log_weights
          else torch.rand((f, o, k1 * k2), generator=gen, device="cuda") * 0.99 + 0.01)
    if edges:
        x1[0, 1] = float("-inf")  # a row of -inf children
        if not log_weights:
            th[:, :, 3] = 0.0  # zero weights never win
    sel = torch.randint(-1, o, (f, b), generator=gen, device="cuda")
    return x1, x2, th, sel


ROUTE_SHAPES = [(3, 8, 16, 16, 16), (3, 13, 8, 16, 1), (2, 130, 16, 8, 70), (2, 5, 3, 5, 3)]


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
@pytest.mark.parametrize("f,b,k1,k2,o", ROUTE_SHAPES)
def test_tropical_kernel_matches_plain(f, b, k1, k2, o, log_weights):
    """``|kernel - plain| <= 1e-5 |plain| + 1e-5`` (the kernel subtracts the
    softmax normalizer after the max, the plain version before)."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, _ = _route_inputs(f, b, k1, k2, o, log_weights)
    out = R.tropical_tucker2(x1, x2, th, log_weights=log_weights)
    ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=log_weights)
    torch.cuda.synchronize()
    assert T.LAUNCHES["tropical_tucker2"] == 1
    assert not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    assert torch.isneginf(out[0, 1]).all()
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs()
    assert bool((err <= 1e-5 + 1e-5 * ref[finite].abs()).all()), float(err.max())


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
@pytest.mark.parametrize("f,b,k1,k2,o", ROUTE_SHAPES)
def test_route_kernel_matches_plain_by_score(f, b, k1, k2, o, log_weights):
    """The plain scores at the kernel's index lie within ``1e-5 |max| + 1e-5``
    of the plain maximum (f32 rounding may flip a near-tie)."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, sel = _route_inputs(f, b, k1, k2, o, log_weights)
    idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=log_weights)
    scores = R.route_scores(x1, x2, th, sel, log_weights=log_weights)
    torch.cuda.synchronize()
    assert T.LAUNCHES["route_tucker2"] == 1
    assert idx.dtype == torch.int64 and idx.shape == (f, b)
    best = scores.amax(dim=-1)
    at = torch.gather(scores, -1, idx[..., None])[..., 0]
    assert bool(((at >= best - (1e-5 * best.abs() + 1e-5)) | torch.isneginf(best)).all())
    if not log_weights:
        assert bool((idx != 3).all())


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_route_kernel_sample_frequencies(log_weights):
    """Gumbel draws over 65,536 identical rows against ``softmax(scores)``,
    each frequency within ``5 sqrt(p (1 - p) / N) + 1e-3``; one seed gives
    the same draws, another seed others."""
    from cirkit_tpu_torch.ops import routing as R

    n = 65536
    x1, x2, th, _ = _route_inputs(2, 1, 4, 4, 8, log_weights, seed=3, edges=False)
    sel = torch.tensor([[3], [6]], device="cuda")
    p = torch.softmax(R.route_scores(x1.double(), x2.double(), th.double(), sel,
                                     log_weights=log_weights)[:, 0], dim=-1)
    rows = [t.expand(-1, n, -1).contiguous() for t in (x1, x2)]
    sel_rows = sel.expand(-1, n).contiguous()
    idx = R.route_tucker2(*rows, th, sel_rows, kind="sample", log_weights=log_weights, seed=99)
    again = R.route_tucker2(*rows, th, sel_rows, kind="sample", log_weights=log_weights, seed=99)
    other = R.route_tucker2(*rows, th, sel_rows, kind="sample", log_weights=log_weights, seed=98)
    assert torch.equal(idx, again) and not torch.equal(idx, other)
    for ff in range(2):
        freq = torch.bincount(idx[ff], minlength=16).double() / n
        bound = 5 * torch.sqrt(p[ff] * (1 - p[ff]) / n) + 1e-3
        assert bool(((freq - p[ff]).abs() <= bound).all()), (freq, p[ff])


# (F) of the K=64 Tucker flagship's ten Tucker entries (B=128, K1=K2=O=64):
# the tropical kernel splits m below F=784, the route kernel gives few rows
# a team of warps
FLAGSHIP_F = [784, 392, 196, 98, 42, 22, 12, 8, 4, 2]


def _flagship_route_inputs(f, dtype, log_weights, seed=0):
    x1, x2, th, sel = _route_inputs(f, 128, 64, 64, 64, log_weights, seed=seed)
    x2[-1, 5, 1:] = float("-inf")  # a row of x2 -inf but one
    if log_weights:
        th[0, :, 7] = float("-inf")
        th[-1, 4, 20:] = float("-inf")  # a unit's logits -inf over most of m
    return [t.to(dtype) if t.is_floating_point() else t for t in (x1, x2, th, sel)]


def _tropical_close(out, ref, dtype):
    """f32: ``1e-5 |plain| + 1e-5``; f64: ``1e-12 (1 + |plain|)``; the same
    -inf pattern and no NaN."""
    assert out.dtype == dtype and not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    err = (out[fin] - ref[fin]).abs()
    rel, floor = (1e-12, 1e-12) if dtype == torch.float64 else (1e-5, 1e-5)
    assert bool((err <= floor + rel * ref[fin].abs()).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("f", FLAGSHIP_F)
def test_tropical_kernel_at_the_flagship_entries(f, dtype):
    """The tropical kernel (split below F=784 by ``_trop_splits``) against
    its plain version at each flagship entry, logits, with -inf children and
    logits."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, _ = _flagship_route_inputs(f, dtype, True)
    out = R.tropical_tucker2(x1, x2, th, log_weights=True)
    ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=True)
    torch.cuda.synchronize()
    assert T.LAUNCHES["tropical_tucker2"] == 1
    _tropical_close(out, ref, dtype)
    assert torch.isneginf(out[0, 1]).all()


# (F, B, K1, K2, O, splits): M = 104 is 6.5 float32 chunks (13 in float64),
# so the last range is ragged; O = 70 and B = 130 ragged tiles
SPLIT_CASES = [(3, 13, 8, 13, 70, 4), (2, 130, 16, 8, 5, 3), (1, 8, 64, 64, 64, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
@pytest.mark.parametrize("f,b,k1,k2,o,splits", SPLIT_CASES)
def test_tropical_kernel_forced_split(f, b, k1, k2, o, splits, log_weights, dtype):
    """A forced split with a ragged last range against the plain version and
    the plain split version; with linear weights equal to the unsplit kernel
    bit for bit."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, _ = (t.to(dtype) if t.is_floating_point() else t
                     for t in _route_inputs(f, b, k1, k2, o, log_weights))
    out = R.tropical_tucker2(x1, x2, th, log_weights=log_weights, splits=splits)
    whole = R.tropical_tucker2(x1, x2, th, log_weights=log_weights, splits=1)
    ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=log_weights)
    torch.cuda.synchronize()
    _tropical_close(out, ref, dtype)
    _tropical_close(out, R.tropical_tucker2_split_ref(x1, x2, th, log_weights=log_weights,
                                                      splits=splits), dtype)
    if not log_weights:
        assert torch.equal(out, whole)
    assert T.LAUNCHES["tropical_tucker2"] == 2


@pytest.mark.parametrize("splits", [1, 5])
def test_tropical_kernel_gives_minus_inf_for_a_unit_without_mass(splits):
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, _ = _route_inputs(2, 13, 8, 12, 6, True)
    th[1, 2] = float("-inf")
    out = R.tropical_tucker2(x1, x2, th, log_weights=True, splits=splits)
    torch.cuda.synchronize()
    assert torch.isneginf(out[1, :, 2]).all() and not torch.isnan(out).any()
    assert torch.isfinite(out[1, 2:, :2]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("f", FLAGSHIP_F)
def test_route_kernel_at_the_flagship_entries(f, dtype):
    """The max kind by the score of its choice (within ``1e-5 |max| + 1e-5``,
    1e-12 in float64) and the sample kind reproducible by seed, in range,
    never a zero weight, at each flagship entry (rows of few folds take a
    team of warps)."""
    from cirkit_tpu_torch.ops import routing as R

    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for lw in (True, False):
        x1, x2, th, sel = _flagship_route_inputs(f, dtype, lw, seed=1)
        idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=lw)
        scores = R.route_scores(x1, x2, th, sel, log_weights=lw)
        best = scores.amax(dim=-1)
        at = torch.gather(scores, -1, idx[..., None])[..., 0]
        assert bool(((at >= best - tol * (1 + best.abs())) | torch.isneginf(best)).all())
        draw = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=lw, seed=7)
        again = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=lw, seed=7)
        torch.cuda.synchronize()
        assert torch.equal(draw, again) and bool(((draw >= 0) & (draw < 4096)).all())
        drawn = torch.gather(scores, -1, draw[..., None])[..., 0]
        assert not bool((torch.isneginf(drawn) & ~torch.isneginf(best)).any())
        if not lw:
            assert bool((idx != 3).all()) and bool((draw != 3).all())
    assert T.LAUNCHES["route_tucker2"] == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("f,b", [(3, 13), (2, 128)])
def test_route_kernel_ties_and_lone_mass(f, b, dtype):
    """The max kind takes the lower index of two equal best scores; a row
    whose scores are all -inf but one draws that one; a row all -inf gives 0."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, sel = (t.to(dtype) if t.is_floating_point() else t
                       for t in _route_inputs(f, b, 64, 64, 8, True, edges=False))
    x1.zero_()
    x2.zero_()
    th.fill_(-5.0)
    th[..., 1234] = th[..., 777] = 2.0  # a tie at the maximum
    idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=True)
    assert bool((idx == 777).all())
    th.fill_(float("-inf"))
    th[..., 3001] = 0.5
    x1[0, 0] = float("-inf")  # a row all -inf
    for seed in (1, 2, 3):
        draw = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=True, seed=seed)
        assert draw[0, 0] == 0 and bool((draw.flatten()[1:] == 3001).all())
    idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=True)
    assert idx[0, 0] == 0 and bool((idx.flatten()[1:] == 3001).all())


def test_route_kernel_sample_frequencies_with_a_team_of_warps():
    """Few rows (a team of 8 warps a row) of 4096 columns: the draws of 256
    seeds over 64 identical rows against ``softmax(scores)``, each
    frequency within ``5 sqrt(p (1 - p) / N) + 1e-3``."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, _ = _route_inputs(1, 1, 64, 64, 4, True, seed=4, edges=False)
    th = th * 3.0
    sel = torch.tensor([[2]], device="cuda")
    p = torch.softmax(R.route_scores(x1.double(), x2.double(), th.double(), sel,
                                     log_weights=True)[0, 0], dim=-1)
    rows = [t.expand(-1, 64, -1).contiguous() for t in (x1, x2)]
    sel_rows = sel.expand(-1, 64).contiguous()
    idx = torch.cat([R.route_tucker2(*rows, th, sel_rows, kind="sample", log_weights=True,
                                     seed=s).flatten() for s in range(256)])
    n = idx.numel()
    freq = torch.bincount(idx, minlength=4096).double() / n
    bound = 5 * torch.sqrt(p * (1 - p) / n) + 1e-3
    assert bool(((freq - p).abs() <= bound).all())


def test_route_wrapper_refuses_what_the_kernel_does_not_take():
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, sel = _route_inputs(2, 8, 4, 4, 4, True)
    with pytest.raises(TypeError, match="int64"):
        R.route_tucker2(x1, x2, th, sel.int(), kind="max", log_weights=True)
    with pytest.raises(TypeError, match="float64"):  # one type for every operand
        R.tropical_tucker2(x1.double(), x2, th, log_weights=True)
    assert T.LAUNCHES["route_tucker2"] == T.LAUNCHES["tropical_tucker2"] == 0


def test_small_circuit_queries_through_the_kernels():
    """MAP, marginals and conditional sampling of a small Tucker circuit on
    the card against the same store in float64 on the CPU (rtol 1e-5), with
    one tropical and one route launch per Tucker entry for MAP."""
    from cirkit_tpu_torch.backend.torch import IntegrateQuery, MAPQuery, SamplingQuery

    ctx, cc = _flagship_like("tucker", "cuda")
    ctx_cpu, cc_cpu = _flagship_like("tucker", "cpu")
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    n_tucker = sum(isinstance(l, TorchTuckerLayer) and l.arity == 2 for l in cc.layers)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (16, 64))
    mask = rng.random((16, 64)) < 0.5
    xc, mc = torch.as_tensor(x, device="cuda"), torch.as_tensor(mask, device="cuda")
    asg, val = MAPQuery(cc)(xc, evidence_mask=mc)
    torch.cuda.synchronize()
    assert T.LAUNCHES["tropical_tucker2"] == T.LAUNCHES["route_tucker2"] == n_tucker
    want_asg, want_val = MAPQuery(cc_cpu)(x, evidence_mask=mask)
    np.testing.assert_allclose(val.double().cpu().numpy(), want_val.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(asg.cpu().numpy()[mask], x[mask])
    got = IntegrateQuery(cc)(xc, integrate_vars=mc)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               IntegrateQuery(cc_cpu)(x, integrate_vars=mask).numpy(), rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    samples, log_ev = SamplingQuery(cc).conditional(xc, evidence_mask=mc, generator=gen)
    _, want_ev = SamplingQuery(cc_cpu).conditional(x, evidence_mask=mask, generator=gen)
    np.testing.assert_allclose(log_ev.double().cpu().numpy(), want_ev.numpy(), rtol=1e-5)
    s = samples.cpu().numpy()
    np.testing.assert_array_equal(s[mask], x[mask])
    assert ((s >= 0) & (s <= 255)).all()
    assert T.LAUNCHES["route_tucker2"] == 2 * n_tucker


# --------------------------------------------------------------------------- #
# The wide kernels (csrc/lse_wide.cu)
# --------------------------------------------------------------------------- #


def _fwd_close(out, ref):
    """The forward bound, with the same -inf pattern and no NaN."""
    assert out.shape == ref.shape and not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs()
    assert bool((err <= 1e-4 + 1e-5 * ref[finite].abs()).all()), float(err.max())


# (F, B, K1, K2, O): one K1-chunk of 512 columns or several (K2=16: two of
# 32 rows; K2=24: 21 rows and a ragged 19; K2=600: one row a chunk)
CHUNKED_CASES = [(3, 8, 64, 16, 16), (3, 13, 9, 5, 1), (2, 130, 40, 24, 70), (1, 8, 3, 600, 9)]


@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
@pytest.mark.parametrize("f,b,k1,k2,o", CHUNKED_CASES)
def test_chunked_tucker_kernel_matches_plain(op, f, b, k1, k2, o, monkeypatch):
    """The K1-chunked Tucker forward against its plain version, with a row
    that is all -inf and a first chunk of logits that is all -inf (zero
    weights without softmax); the backward is the Tucker backward kernel,
    whose float32 dx kernel takes any K1 and K2 (K2=600: ten column tiles)."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    ins = _inputs(op, f, b, o, k1=k1, k2=k2)
    ins[0][0, 2] = float("-inf")
    chunk = max(1, 512 // k2) * k2
    if chunk < k1 * k2:  # not the whole row: its softmax would be NaN
        ins[-1][0, 0, :chunk] = float("-inf") if "softmax" in op else 0.0
    ins = [t.requires_grad_() for t in ins]
    out = getattr(T, op)(*ins)
    with torch.no_grad():
        ref = getattr(T, f"{op}_ref")(*ins)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}_chunked"] == 1 and T.LAUNCHES[op] == 0
    _fwd_close(out.detach(), ref)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    grads = torch.autograd.grad(out, ins, g)
    with torch.no_grad():
        refs = getattr(T, f"{op}_bwd_ref")(*ins, out, g)
    assert T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):
        _close(got, r, zeros=k < len(refs) - 1)


# (F, B, I, O): I a multiple of the 256-column chunk or not, ragged B, O=1
BLOCKED_CASES = [(3, 8, 1000, 16), (3, 13, 300, 1), (2, 130, 777, 70), (1, 5, 512, 64)]


@pytest.mark.parametrize("f,b,i,o", BLOCKED_CASES)
def test_blocked_kernels_match_plain(f, b, i, o, monkeypatch):
    """The blocked forward (out and its row max) and backward against their
    plain versions, with a row that is all -inf, a row whose first chunk is
    all -inf and a row whose cotangent is 0; the backward twice, equal."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    x, w = _inputs("lse_matmul", f, b, o, i=i)
    x[0, 2] = float("-inf")
    x[-1, 1, :256] = float("-inf")
    with torch.no_grad():
        ref, ref_m = T.lse_matmul_blocked_ref(x, w)
        got, got_m = T._launch_blocked_fwd(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got_m, ref_m)
    _fwd_close(got, ref)
    x, w = x.requires_grad_(), w.requires_grad_()
    out = T.lse_matmul(x, w)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[0, 1] = 0.0
    grads = torch.autograd.grad(out, [x, w], g, retain_graph=True)
    again = torch.autograd.grad(out, [x, w], g)
    with torch.no_grad():
        refs = T.lse_matmul_blocked_bwd_ref(x, w, out, ref_m, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES["lse_matmul_blocked"] == 2 and T.LAUNCHES["lse_matmul"] == 0
    assert T.LAUNCHES["lse_matmul_blocked_bwd"] == 2
    for k, (a, r) in enumerate(zip(grads, refs)):
        _close(a, r, zeros=k == 0)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    assert (grads[0][0, 2] == 0).all() and (grads[0][0, 1] == 0).all()


def test_wide_softmax_matmul_normalizes_then_takes_the_blocked_kernels(monkeypatch):
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    x, th = [t.requires_grad_() for t in _inputs("lse_matmul_softmax", 2, 8, 16, i=300)]
    out = T.lse_matmul_softmax(x, th)
    _fwd_close(out.detach(), T.lse_matmul_softmax_ref(x, th).detach())
    out.sum().backward()
    assert T.LAUNCHES["lse_matmul_blocked"] == T.LAUNCHES["lse_matmul_blocked_bwd"] == 1
    assert T.LAUNCHES["lse_matmul_softmax"] == T.LAUNCHES["lse_matmul_softmax_bwd"] == 0
    with torch.no_grad():
        ref = T.lse_matmul_softmax_bwd_ref(x, th, out, torch.ones_like(out))
    _close(x.grad, ref[0], zeros=True)
    _close(th.grad, ref[1])


@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax", "lse_matmul"])
def test_wide_kernels_at_the_k128_entry_shapes(op):
    """Once at the K=128 entries (F=784, B=128, K1=K2=O=128; dense I=16384),
    where WIDE_WIDTH routes them unpatched: the wide forward and its
    backward (the Tucker backward kernel, or the blocked one) against
    their plain versions."""
    f, b, k = 784, 128, 128
    ins = _inputs(op, f, b, k, k1=k, k2=k, i=k * k)
    out = getattr(T, op)(*ins)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    if op == "lse_matmul":
        ref, m = T.lse_matmul_blocked_ref(*ins)
        _fwd_close(out, ref)
        del ref
        grads = T._launch_blocked_bwd(*ins, out, m, g, (True, True))
        refs = T.lse_matmul_blocked_bwd_ref(*ins, out, m, g)
    else:
        _fwd_close(out, getattr(T, f"{op}_ref")(*ins))
        grads = T.backward(op, tuple(ins), out, g)
        refs = getattr(T, f"{op}_bwd_ref")(*ins, out, g)
    torch.cuda.synchronize()
    fwd_key = "lse_matmul_blocked" if op == "lse_matmul" else f"{op}_chunked"
    assert T.LAUNCHES[fwd_key] == 1 and T.LAUNCHES[op] == 0
    for a, r in zip(grads, refs):
        _close(a, r)


# --------------------------------------------------------------------------- #
# The signed kernels (the SIGNED instances of csrc/lse_einsum*.cu)
# --------------------------------------------------------------------------- #

SIGNED_OPS = ["slse_matmul", "slse_matmul_softmax", "slse_tucker2", "slse_tucker2_softmax"]


def _signed_inputs(op, f, b, o, k1=8, k2=16, i=32):
    """(log-magnitude, sign) inputs with signs in {-1, 0, +1} and weights of
    both signs (or logits)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = []
    for k in ((k1, k2) if "tucker" in op else (i,)):
        ins += [torch.randn((f, b, k), generator=gen, device="cuda") * 3.0 - 2.0,
                torch.randint(-1, 2, (f, b, k), generator=gen, device="cuda").float()]
    width = k1 * k2 if "tucker" in op else i
    ins.append(torch.randn((f, o, width), generator=gen, device="cuda"))
    return ins


def _signed_close(op, ins, got, ref, tol=1e-5):
    """The forward bound of chip_smoke's phase 3d: in linear space scaled by
    the row's absolute mass A, ``|s exp(a - A) - s' exp(a' - A)| <= tol``;
    signs equal above the bound; (-inf, 0) where the mass is 0."""
    (ga, gs), (pa, ps) = got, ref
    *xs, w = ins
    wabs = torch.softmax(w, dim=-1) if "softmax" in op else w.abs()
    mass = (T.lse_tucker2_ref(xs[0], xs[2], wabs) if "tucker" in op
            else T.lse_matmul_ref(xs[0], wabs))
    assert not torch.isnan(ga).any() and not torch.isnan(gs).any()
    empty = torch.isneginf(mass)
    assert torch.isneginf(ga[empty]).all() and (gs[empty] == 0).all()
    lin_k = torch.where(empty, 0.0, gs * torch.exp(ga - mass))
    lin_p = torch.where(empty, 0.0, ps * torch.exp(pa - mass))
    assert float((lin_k - lin_p).abs().max()) <= tol
    assert not bool(((gs != ps) & (lin_p.abs() > tol)).any())


@pytest.mark.parametrize("f,b,o,k1,k2", [(3, 8, 16, 8, 16), (3, 13, 1, 8, 16), (2, 130, 70, 8, 16),
                                         (144, 4096, 32, 8, 16), (784, 128, 64, 64, 64),
                                         (3, 37, 70, 7, 10)])
@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_kernels_match_plain(op, f, b, o, k1, k2):
    """Forward and backward of each signed entry against its plain versions,
    with a row that is all -inf and a cotangent that is 0 on some rows; the
    fourth shape is the SoS TensorDot entry (B*Kq = 4096, I = O = 32), the
    fifth the K=64 Tucker entry, the last a K2 that is no multiple of 4 (the
    dense ops take I = 32 throughout)."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    if "tucker" in op and f == 144:
        f, b, o = 8, 512, 64  # the Tucker configurations at a larger batch instead
    ins = _signed_inputs(op, f, b, o, k1=k1, k2=k2)
    ins[0][0, 2] = float("-inf")
    ins = [t.requires_grad_(k % 2 == 0 or k == len(ins) - 1) for k, t in enumerate(ins)]
    oa, os_ = getattr(S, op)(*ins)
    assert not os_.requires_grad
    with torch.no_grad():
        ref = getattr(S, f"{op}_ref")(*ins)
    _signed_close(op, [t.detach() for t in ins], (oa.detach(), os_), ref)
    assert torch.isneginf(oa[0, 2]).all() and (os_[0, 2] == 0).all()
    g = torch.randn(oa.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[1, :3] = 0.0
    diff = [t for t in ins if t.requires_grad]
    grads = torch.autograd.grad(oa, diff, g)
    with torch.no_grad():  # on the kernel's own outputs: g / y is ill-conditioned near y = 0
        refs = [r for r in getattr(S, f"{op}_bwd_ref")(*ins, oa.detach(), os_, g)
                if r is not None]
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1 and T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):
        _close(got, r, zeros=k < len(refs) - 1)
    assert (grads[0][0, 2] == 0).all()


@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_exact_cancellation(op):
    """Equal magnitudes with alternating signs against equal weights: y = 0
    exactly gives (-inf, sign 0) and zero gradients, never NaN."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    alt = torch.tensor([1.0, -1.0], device="cuda").repeat(8)
    if "tucker" in op:
        ins = [torch.zeros(1, 8, 4, device="cuda"), alt[:4].expand(1, 8, 4).contiguous(),
               torch.zeros(1, 8, 4, device="cuda"), torch.ones(1, 8, 4, device="cuda")]
    else:
        ins = [torch.zeros(1, 8, 16, device="cuda"), alt.expand(1, 8, 16).contiguous()]
    ins.append((torch.zeros if "softmax" in op else torch.ones)(1, 8, 16, device="cuda"))
    ins = [t.requires_grad_(k % 2 == 0 or k == len(ins) - 1) for k, t in enumerate(ins)]
    oa, os_ = getattr(S, op)(*ins)
    assert torch.isneginf(oa).all() and (os_ == 0).all()
    grads = torch.autograd.grad(oa, [t for t in ins if t.requires_grad], torch.ones_like(oa))
    assert all(bool((gr == 0).all()) for gr in grads)


def test_small_squared_circuit_through_the_kernels():
    """bench.py's SoS circuit at 6x6, K=8 on the card: one slse_matmul launch
    per TensorDot entry, and the forward of sq and zc against the same
    store in float64 on the CPU: zc to rtol 1e-5, sq to 1e-3 (its f32
    evaluation squares each sum's cancellation: the plain f32 composition
    on the CPU is off float64 by 1e-4 here; see chip_smoke's SOS_SQ_RTOL)."""
    from cirkit_tpu_torch.backend.torch.optimized import TorchTensorDotLayer
    from cirkit_tpu_torch.models.utils import Parameterization

    def build(device):
        sc = image_data((1, 6, 6), "quad-tree-2", input_layer="categorical", num_input_units=8,
                        sum_product_layer="cp", num_sum_units=8,
                        sum_weight_param=Parameterization(activation="none",
                                                          initialization="normal"))
        ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True, seed=0,
                              device=device)
        cc = ctx.compile(sc)
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        return ctx, sq, ctx.integrate(sq)

    ctx, sq, zc = build("cuda")
    ctx_cpu, sq_cpu, zc_cpu = build("cpu")
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    x = np.random.default_rng(0).integers(0, 256, (16, 36))
    for circuit, ref_circuit, rtol in ((sq, sq_cpu, 1e-3), (zc, zc_cpu, 1e-5)):
        for op in T.LAUNCHES:
            T.LAUNCHES[op] = 0
        with torch.inference_mode():
            a, s = circuit(torch.as_tensor(x, device="cuda"))
            ra, rs = ref_circuit(torch.as_tensor(x))
        assert T.LAUNCHES["slse_matmul"] == sum(isinstance(l, TorchTensorDotLayer)
                                                for l in circuit.layers)
        np.testing.assert_allclose(a.double().cpu().numpy(), ra.numpy(), rtol=rtol)
        assert (rs == 1).all() and (s != 0).all()


# --------------------------------------------------------------------------- #
# The complex kernels (csrc/clse_einsum.cu)
# --------------------------------------------------------------------------- #

COMPLEX_OPS = ["clse_matmul", "clse_tucker2"]
_COMPLEX_TOL = {torch.complex64: (1e-5, 1e-4), torch.complex128: (1e-12, 1e-9)}


def _complex_inputs(op, f, b, o, dtype, *, real_w=False, k1=8, k2=16, i=32):
    """Complex log-space inputs (real parts as the lse tests', phases uniform
    in (-pi, pi]) and normal weights, complex or real."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    real = torch.float64 if dtype == torch.complex128 else torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=real)

    def value(*shape):
        phase = (torch.rand(shape, generator=gen, device="cuda", dtype=real) * 2 - 1) * torch.pi
        return torch.complex(randn(*shape) * 3.0 - 2.0, phase)

    tucker = "tucker" in op
    xs = [value(f, b, k1), value(f, b, k2)] if tucker else [value(f, b, i)]
    width = k1 * k2 if tucker else i
    w = randn(f, o, width) if real_w else torch.complex(randn(f, o, width), randn(f, o, width))
    return [*xs, w]


def _complex_close(ins, got, ref, tol):
    """The forward bound of chip_smoke's phase 3e: in linear space scaled by
    the row's absolute mass A (the lse of the real parts against ``|w|``),
    ``|exp(out_k - A) - exp(out_p - A)| <= tol`` on the real and imaginary
    parts; real part -inf where the mass is 0; no NaN."""
    *xs, w = ins
    res = [x.real.contiguous() for x in xs]
    mass = (T.lse_tucker2_ref(*res, w.abs()) if len(xs) == 2 else T.lse_matmul_ref(*res, w.abs()))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert not torch.isnan(got.real).any() and not torch.isnan(got.imag).any()
    empty = torch.isneginf(mass)
    assert torch.isneginf(got.real[empty]).all()
    lin_k = torch.where(empty, 0.0, torch.exp(got - mass))
    lin_p = torch.where(empty, 0.0, torch.exp(ref - mass))
    assert float((lin_k - lin_p).abs().max()) <= tol


def _complex_bwd_close(got, ref, rel, *, zeros=False):
    """The backward bound on each plane: ``|kernel - plain| <= rel (max|plain|
    + |plain|)``."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    planes = [(got.real, ref.real), (got.imag, ref.imag)] if got.dtype.is_complex else [(got, ref)]
    scale = ref.abs().max()
    for k, p in planes:
        assert not torch.isnan(k).any()
        assert not zeros or bool((k[ref == 0] == 0).all())
        assert bool(((k - p).abs() <= rel * (scale + p.abs())).all()), float((k - p).abs().max())


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("real_w", [False, True], ids=["complex-w", "real-w"])
@pytest.mark.parametrize("f,b,o,k1,k2", [(3, 8, 16, 8, 16), (3, 13, 1, 8, 16), (2, 130, 70, 5, 9),
                                         (2, 70, 64, 4, 64), (144, 4096, 32, 8, 16),
                                         (784, 128, 64, 64, 64), (3, 37, 70, 7, 10)])
@pytest.mark.parametrize("op", COMPLEX_OPS)
def test_complex_kernels_match_plain(op, f, b, o, k1, k2, real_w, dtype):
    """Forward and backward of the complex ops against their plain versions,
    with a row that is all -inf and a cotangent that is 0 on some rows; the
    fifth shape is the SoS TensorDot entry (B*Kq = 4096, I = O = 32), the
    sixth the K=64 Tucker entry, the last a K2 that is no multiple of 4."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    if f == 144 and ("tucker" in op or dtype == torch.complex128):
        f, b, o = 8, 512, 64
    tol, rel = _COMPLEX_TOL[dtype]
    ins = _complex_inputs(op, f, b, o, dtype, real_w=real_w, k1=k1, k2=k2)
    ins[0][0, 2] = complex(float("-inf"), 0.5)
    ins = [t.requires_grad_() for t in ins]
    out = getattr(C, op)(*ins)
    with torch.no_grad():
        ref = getattr(C, f"{op}_ref")(*ins)
    _complex_close([t.detach() for t in ins], out.detach(), ref, tol)
    assert torch.isneginf(out.real[0, 2]).all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.complex(*(torch.randn(out.shape, generator=gen, device="cuda", dtype=out.real.dtype)
                        for _ in range(2)))
    g[1, :3] = 0.0
    grads = torch.autograd.grad(out, ins, g)
    with torch.no_grad():  # on the kernel's own output: g / conj(y) is ill-conditioned near 0
        refs = getattr(C, f"{op}_bwd_ref")(*ins, out.detach(), g)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1 and T.LAUNCHES[f"{op}_bwd"] == 1
    assert grads[-1].dtype == ins[-1].dtype
    for k, (got, r) in enumerate(zip(grads, refs)):
        _complex_bwd_close(got, r, rel, zeros=k < len(refs) - 1)
    assert (grads[0][0, 2] == 0).all() and (grads[0][1, :3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("op", COMPLEX_OPS)
def test_complex_exact_cancellation(op, dtype):
    """Equal magnitudes of opposite phase (0 and pi would round: the phases
    are 0 with weights +1 and -1) sum to exactly 0: real part -inf, zero
    gradients, never NaN."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    alt = torch.tensor([1.0, -1.0], device="cuda").repeat(8).to(dtype)
    if "tucker" in op:
        ins = [torch.zeros(1, 8, 4, device="cuda", dtype=dtype) for _ in range(2)]
    else:
        ins = [torch.zeros(1, 8, 16, device="cuda", dtype=dtype)]
    ins.append(alt.expand(1, 8, 16).contiguous())
    ins = [t.requires_grad_() for t in ins]
    out = getattr(C, op)(*ins)
    assert torch.isneginf(out.real).all() and not torch.isnan(out.imag).any()
    grads = torch.autograd.grad(out, ins, torch.ones_like(out))
    assert all(bool((gr == 0).all()) for gr in grads)


def test_complex_backward_skips_and_repeats():
    """Only the requested gradients are computed, and two backward calls give
    the same bits (every sum runs in a fixed order)."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    x1, x2, w = _complex_inputs("clse_tucker2", 3, 130, 70, torch.complex64)
    w.requires_grad_()
    out = C.clse_tucker2(x1, x2, w)
    (dw,) = torch.autograd.grad(out, [w], torch.ones_like(out), retain_graph=True)
    (again,) = torch.autograd.grad(out, [w], torch.ones_like(out))
    assert torch.equal(dw, again) and T.LAUNCHES["clse_tucker2_bwd"] == 2
    with torch.no_grad():
        ref = C.clse_tucker2_bwd_ref(x1, x2, w, out.detach(), torch.ones_like(out),
                                     (False, False, True))[-1]
    _complex_bwd_close(dw, ref, 1e-4)


def test_complex_wrapper_refuses_what_the_kernel_does_not_take():
    from cirkit_tpu_torch.ops import clse_einsum as C

    x, w = _complex_inputs("clse_matmul", 2, 8, 16, torch.complex64)
    with pytest.raises(TypeError, match="complex"):
        C.clse_matmul(x.real.contiguous(), w)
    with pytest.raises(TypeError, match="operands of"):
        C.clse_matmul(x, w.to(torch.complex128))
    with pytest.raises(ValueError, match="operands on"):
        C.clse_matmul(x, w.cpu())
    assert T.LAUNCHES["clse_matmul"] == 0


# --------------------------------------------------------------------------- #
# The float64 instances of the single-pass lse and signed kernels
# --------------------------------------------------------------------------- #


def _bwd_close_f64(got, ref, *, zeros=False):
    assert got.shape == ref.shape and got.dtype == torch.float64
    assert not torch.isnan(got).any()
    assert not zeros or bool((got[ref == 0] == 0).all())
    bound = 1e-9 * (ref.abs().max() + ref.abs())
    assert bool(((got - ref).abs() <= bound).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("f,b,o,k1,k2", [(3, 8, 16, 8, 16), (3, 13, 1, 8, 16), (2, 130, 70, 4, 64),
                                         (4, 128, 64, 64, 64)])
@pytest.mark.parametrize("op", OPS)
def test_float64_kernels_match_plain(op, f, b, o, k1, k2):
    """Forward (1e-10 relative in log space) and backward of the double
    instances of the lse kernels; the last shape is the K=64 Tucker entry's
    widths, whose dx accumulators fill most of a block's shared memory."""
    ins = [t.double() for t in _inputs(op, f, b, o, k1=k1, k2=k2)]
    ins[0][0, 2] = float("-inf")
    ins = [t.requires_grad_() for t in ins]
    out = getattr(T, op)(*ins)
    assert out.dtype == torch.float64
    with torch.no_grad():
        ref = getattr(T, f"{op}_ref")(*ins)
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    err = (out.detach()[finite] - ref[finite]).abs()
    assert bool((err <= 1e-10 * (1 + ref[finite].abs())).all()), float(err.max())
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    g[1, 3:5] = 0.0
    grads = torch.autograd.grad(out, ins, g)
    with torch.no_grad():
        refs = getattr(T, f"{op}_bwd_ref")(*ins, out.detach(), g)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1 and T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):
        _bwd_close_f64(got, r, zeros=k < len(ins) - 1)
    assert (grads[0][0, 2] == 0).all() and (grads[0][1, 3:5] == 0).all()


@pytest.mark.parametrize("f,b,o", [(3, 8, 16), (3, 13, 1), (2, 130, 70), (144, 4096, 32)])
@pytest.mark.parametrize("op", SIGNED_OPS)
def test_float64_signed_kernels_match_plain(op, f, b, o):
    from cirkit_tpu_torch.ops import slse_einsum as S

    if "tucker" in op and f == 144:
        f, b, o = 8, 512, 64
    ins = [t.double() for t in _signed_inputs(op, f, b, o)]
    ins[0][0, 2] = float("-inf")
    ins = [t.requires_grad_(k % 2 == 0 or k == len(ins) - 1) for k, t in enumerate(ins)]
    oa, os_ = getattr(S, op)(*ins)
    assert oa.dtype == os_.dtype == torch.float64
    with torch.no_grad():
        ref = getattr(S, f"{op}_ref")(*ins)
    _signed_close(op, [t.detach() for t in ins], (oa.detach(), os_), ref, tol=1e-12)
    g = torch.randn(oa.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    g[1, :3] = 0.0
    diff = [t for t in ins if t.requires_grad]
    grads = torch.autograd.grad(oa, diff, g)
    with torch.no_grad():
        refs = [r for r in getattr(S, f"{op}_bwd_ref")(*ins, oa.detach(), os_, g)
                if r is not None]
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1 and T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):
        _bwd_close_f64(got, r, zeros=k < len(refs) - 1)


def test_float64_refusals_name_the_shape():
    """The float64 Tucker backward at widths whose dx accumulators do not fit
    a block's shared memory (from K1 = K2 = 88): the K1-split dx kernel and
    its finish, against the plain float64 backward, at (90, 90), where the
    forward takes the single-pass kernel, and at (128, 128), where it takes
    the K1-chunked one. (Such widths raised until the split existed; the
    test keeps its name.)"""
    for k, fwd in ((90, "lse_tucker2"), (128, "lse_tucker2_chunked")):
        ins = [t.double() for t in _inputs("lse_tucker2", 2, 70, 5, k1=k, k2=k)]
        ins[0][0, 2] = float("-inf")
        ins = [t.requires_grad_() for t in ins]
        out = T.lse_tucker2(*ins)
        assert out.dtype == torch.float64 and T.LAUNCHES[fwd] == 1
        g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda", dtype=torch.float64)
        g[1, 3:5] = 0.0
        grads = torch.autograd.grad(out, ins, g)
        with torch.no_grad():
            refs = T.lse_tucker2_bwd_ref(*ins, out.detach(), g)
        torch.cuda.synchronize()
        for n, (got, r) in enumerate(zip(grads, refs)):
            _bwd_close_f64(got, r, zeros=n < 2)
        assert (grads[0][0, 2] == 0).all() and (grads[0][1, 3:5] == 0).all()
    assert T.LAUNCHES["lse_tucker2_bwd"] == 2


def _fwd_close_f64(out, ref):
    assert out.dtype == torch.float64 and out.shape == ref.shape and not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs()
    assert bool((err <= 1e-10 * (1 + ref[finite].abs())).all()), float(err.max())


@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
@pytest.mark.parametrize("f,b,k1,k2,o", CHUNKED_CASES)
def test_float64_chunked_tucker_kernel_matches_plain(op, f, b, k1, k2, o, monkeypatch):
    """The double instances of the K1-chunked Tucker forward (row 5) against
    the plain float64 version, with a row that is all -inf and a first chunk
    of logits that is all -inf; the backward through the float64 Tucker
    backward kernel where its dx accumulators fit (else dw only)."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    ins = [t.double() for t in _inputs(op, f, b, o, k1=k1, k2=k2)]
    ins[0][0, 2] = float("-inf")
    chunk = max(1, 512 // k2) * k2
    if chunk < k1 * k2:
        ins[-1][0, 0, :chunk] = float("-inf") if "softmax" in op else 0.0
    dx = k1 + k2 < 150
    ins = [t.requires_grad_(dx or k == 2) for k, t in enumerate(ins)]
    out = getattr(T, op)(*ins)
    with torch.no_grad():
        ref = getattr(T, f"{op}_ref")(*ins)
    assert T.LAUNCHES[f"{op}_chunked"] == 1 and T.LAUNCHES[op] == 0
    _fwd_close_f64(out.detach(), ref)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    grads = torch.autograd.grad(out, [t for t in ins if t.requires_grad], g)
    with torch.no_grad():
        refs = [r for r in getattr(T, f"{op}_bwd_ref")(*ins, out, g, (dx, dx, True))
                if r is not None]
    torch.cuda.synchronize()
    for k, (got, r) in enumerate(zip(grads, refs)):
        _bwd_close_f64(got, r, zeros=k < len(refs) - 1)


@pytest.mark.parametrize("f,b,i,o", BLOCKED_CASES)
def test_float64_blocked_kernels_match_plain(f, b, i, o, monkeypatch):
    """The double instances of the blocked dense forward and backward (rows
    3 and 4) against the plain float64 versions; the row max exactly."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    x, w = (t.double() for t in _inputs("lse_matmul", f, b, o, i=i))
    x[0, 2] = float("-inf")
    x[-1, 1, :256] = float("-inf")
    with torch.no_grad():
        ref, ref_m = T.lse_matmul_blocked_ref(x, w)
        got, got_m = T._launch_blocked_fwd(x, w)
    torch.cuda.synchronize()
    assert got_m.dtype == torch.float64 and torch.equal(got_m, ref_m)
    _fwd_close_f64(got, ref)
    x, w = x.requires_grad_(), w.requires_grad_()
    out = T.lse_matmul(x, w)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    g[0, 1] = 0.0
    grads = torch.autograd.grad(out, [x, w], g)
    with torch.no_grad():
        refs = T.lse_matmul_blocked_bwd_ref(x, w, out, ref_m, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES["lse_matmul_blocked"] == 2 and T.LAUNCHES["lse_matmul_blocked_bwd"] == 1
    for k, (a, r) in enumerate(zip(grads, refs)):
        _bwd_close_f64(a, r, zeros=k == 0)


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
@pytest.mark.parametrize("f,b,k1,k2,o", ROUTE_SHAPES)
def test_float64_routing_kernels_match_plain(f, b, k1, k2, o, log_weights):
    """The double instances of the tropical Tucker (row 9; 1e-12 (1 +
    |plain|)) and of the routing choice (row 8): the argmax by its score
    (within 1e-12 of the plain maximum), and the sample kind's draws
    reproducible by seed, in range, never a zero weight."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, sel = (t.double() if t.is_floating_point() else t
                       for t in _route_inputs(f, b, k1, k2, o, log_weights))
    out = R.tropical_tucker2(x1, x2, th, log_weights=log_weights)
    ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=log_weights)
    torch.cuda.synchronize()
    assert out.dtype == torch.float64 and torch.equal(torch.isneginf(out), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    assert bool(((out[finite] - ref[finite]).abs() <= 1e-12 * (1 + ref[finite].abs())).all())
    idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=log_weights)
    scores = R.route_scores(x1, x2, th, sel, log_weights=log_weights)
    best = scores.amax(dim=-1)
    at = torch.gather(scores, -1, idx[..., None])[..., 0]
    assert bool(((at >= best - 1e-12 * (1 + best.abs())) | torch.isneginf(best)).all())
    draw = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=log_weights, seed=7)
    again = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=log_weights, seed=7)
    assert torch.equal(draw, again) and bool(((draw >= 0) & (draw < k1 * k2)).all())
    if not log_weights:
        assert bool((idx != 3).all()) and bool((draw != 3).all())
    assert T.LAUNCHES["tropical_tucker2"] == 1 and T.LAUNCHES["route_tucker2"] == 3


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_float64_route_sample_frequencies(log_weights):
    """The double instance's Gumbel draws over 65,536 identical rows against
    ``softmax(scores)``, as for float32."""
    from cirkit_tpu_torch.ops import routing as R

    n = 65536
    x1, x2, th, _ = (t.double() for t in _route_inputs(2, 1, 4, 4, 8, log_weights, seed=3,
                                                       edges=False))
    sel = torch.tensor([[3], [6]], device="cuda")
    p = torch.softmax(R.route_scores(x1, x2, th, sel, log_weights=log_weights)[:, 0], dim=-1)
    rows = [t.expand(-1, n, -1).contiguous() for t in (x1, x2)]
    idx = R.route_tucker2(*rows, th, sel.expand(-1, n).contiguous(), kind="sample",
                          log_weights=log_weights, seed=99)
    for ff in range(2):
        freq = torch.bincount(idx[ff], minlength=16).double() / n
        bound = 5 * torch.sqrt(p[ff] * (1 - p[ff]) / n) + 1e-3
        assert bool(((freq - p[ff]).abs() <= bound).all()), (freq, p[ff])


# --------------------------------------------------------------------------- #
# The float32 backward on the tensor cores (csrc/lse_einsum_bwd.cu, section 6)
# --------------------------------------------------------------------------- #

# (F, B, O, K1, K2): O, B, K1 and K2 that no tile divides, K1 != K2; the
# dense ops take I = K1 * K2
RAGGED = [(3, 100, 33, 13, 21), (2, 100, 33, 21, 13), (1, 37, 70, 70, 130), (2, 130, 17, 3, 600)]


def _tc_case(op, f, b, o, k1, k2):
    ins = _inputs(op, f, b, o, k1=k1, k2=k2, i=k1 * k2)
    ins[0][0, 2] = float("-inf")  # a row that is all -inf
    g = torch.randn((f, b, o), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[-1, 3:5] = 0.0  # rows whose upstream gradient is 0
    return ins, g


@pytest.mark.parametrize("f,b,o,k1,k2", RAGGED)
@pytest.mark.parametrize("op", OPS)
def test_tensor_core_backward_ragged(op, f, b, o, k1, k2):
    """Every gradient of the tensor-core path against the plain version on
    ragged shapes, zero gradients at the -inf row and at rows of zero
    cotangent, and a second call equal to the bit."""
    ins, g = _tc_case(op, f, b, o, k1, k2)
    with torch.no_grad():
        out = getattr(T, f"{op}_ref")(*ins)
    grads = T.backward(op, tuple(ins), out, g)
    again = T.backward(op, tuple(ins), out, g)
    refs = getattr(T, f"{op}_bwd_ref")(*ins, out, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}_bwd"] == 2
    for k, (a, r) in enumerate(zip(grads, refs)):
        _close(a, r, zeros=k < len(ins) - 1)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    assert (grads[0][0, 2] == 0).all() and (grads[0][-1, 3:5] == 0).all()


@pytest.mark.parametrize("which", ["dx", "dw", "dx1", "dx2"])
@pytest.mark.parametrize("op", OPS)
def test_tensor_core_backward_skips(op, which):
    """A call that asks for some gradients only: each one equal to the bit
    to the full call's, the others None."""
    if which in ("dx1", "dx2") and "tucker" not in op:
        which = "dx"
    ins, g = _tc_case(op, 2, 100, 33, 13, 21)
    with torch.no_grad():
        out = getattr(T, f"{op}_ref")(*ins)
    full = T.backward(op, tuple(ins), out, g)
    names = ("dx1", "dx2", "dw") if "tucker" in op else ("dx", "dw")
    needs = tuple(n == which or (which == "dx" and n.startswith("dx")) for n in names)
    part = T.backward(op, tuple(ins), out, g, needs)
    torch.cuda.synchronize()
    for need, p_, f_ in zip(needs, part, full):
        assert (p_ is None) == (not need)
        assert p_ is None or torch.equal(p_, f_)


# --------------------------------------------------------------------------- #
# The float32 wide kernels on the tensor cores (csrc/lse_wide.cu: ct_fwd_tc,
# blocked_gy_tc + blocked_bwd_tc)
# --------------------------------------------------------------------------- #


def _offset(t):
    """``t`` copied into a buffer one float past an aligned start: contiguous,
    but its rows' 16-byte copies are off."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = buf[1:].view_as(t)
    out.copy_(t)
    return out


# (F, B, I, O): no tile of the kernel (64 strip columns, 128 batch rows, 64
# units) divides them; I odd (777) or past one strip row of 256 chunks (10000)
TC_BLOCKED = [(2, 130, 777, 70), (1, 13, 10000, 1), (3, 37, 1000, 33), (1, 257, 130, 128)]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,i,o", TC_BLOCKED)
def test_tensor_core_blocked_backward(f, b, i, o, offset):
    """The blocked backward against its plain version with a row of x that is
    all -inf, a strip of a row that is -inf and a row whose cotangent is 0;
    a second call equal to the bit, and dx-only and dw-only calls equal to
    the bit to the full call's."""
    x, w = _inputs("lse_matmul", f, b, o, i=i)
    x[0, 2] = float("-inf")
    x[-1, 1, 64:128] = float("-inf")
    if offset:
        x, w = _offset(x), _offset(w)
    with torch.no_grad():
        out, m = T.lse_matmul_blocked_ref(x, w)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[0, 1] = 0.0
    full = T._launch_blocked_bwd(x, w, out, m, g, (True, True))
    again = T._launch_blocked_bwd(x, w, out, m, g, (True, True))
    dx_only = T._launch_blocked_bwd(x, w, out, m, g, (True, False))
    dw_only = T._launch_blocked_bwd(x, w, out, m, g, (False, True))
    refs = T.lse_matmul_blocked_bwd_ref(x, w, out, m, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES["lse_matmul_blocked_bwd"] == 4
    _close(full[0], refs[0], zeros=True)
    _close(full[1], refs[1])
    assert all(torch.equal(a, b_) for a, b_ in zip(full, again))
    assert dx_only[1] is None and torch.equal(dx_only[0], full[0])
    assert dw_only[0] is None and torch.equal(dw_only[1], full[1])
    assert (full[0][0, 2] == 0).all() and (full[0][0, 1] == 0).all()


# (F, B, K1, K2, O): K1 != K2, K2 odd (no 16-byte copies) or past the
# 32-column chunk, O and B that no tile (128 units, 128 rows) divides
TC_CHUNKED = [(2, 130, 99, 600, 70), (3, 13, 40, 24, 1), (1, 37, 7, 129, 33),
              (1, 128, 128, 128, 128)]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,k1,k2,o", TC_CHUNKED)
@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
def test_tensor_core_chunked_tucker(op, f, b, k1, k2, o, offset):
    """The K1-chunked Tucker forward against its plain version, with rows of
    x1 and of x2 that are all -inf and a unit whose logits (weights) over
    one row i, and over a 32-column chunk of another, are -inf (0); a
    second call equal to the bit. The plain version runs on the inputs cast
    to float64: at I = 59400 its float32 composition is itself off float64
    by up to 1.9e-4 (cuBLAS's float32 sums), past the bound, where the
    kernel stays within 1e-5."""
    ins = _inputs(op, f, b, o, k1=k1, k2=k2)
    ins[0][0, 2] = float("-inf")
    ins[1][-1, 1] = float("-inf")
    zero = float("-inf") if "softmax" in op else 0.0
    ins[2][0, 0, :k2] = zero
    ins[2][-1, -1, k2 + 32:k2 + 64] = zero
    if offset:
        ins[2] = _offset(ins[2])
    key = f"{op}_chunked"
    got = T._launch_fwd(key, tuple(ins))
    again = T._launch_fwd(key, tuple(ins))
    ref = getattr(T, f"{op}_ref")(*(t.double() for t in ins))
    torch.cuda.synchronize()
    assert T.LAUNCHES[key] == 2
    _fwd_close(got.double(), ref)
    assert torch.equal(got, again)
    assert torch.isneginf(got[0, 2]).all() and torch.isneginf(got[-1, 1]).all()


# --------------------------------------------------------------------------- #
# The float32 forwards redesigned for the tensor cores: the blocked dense
# forward (csrc/lse_wide.cu blocked_fwd_tc) and the single-pass Tucker
# forward (csrc/lse_einsum.cu tucker_fwd_tc)
# --------------------------------------------------------------------------- #

# (F, B, I, O): ragged B, O = 1 and 129 (two unit tiles of 128), I = 8200
# (not a multiple of the 32-column chunk), I odd (4-byte copies)
TC_BLOCKED_FWD = [(2, 100, 8200, 1), (2, 100, 8200, 129), (3, 13, 777, 70), (1, 130, 1000, 128)]


def _blocked_fwd_edges(x):
    """A row of x that is all -inf, one whose max sits in the last chunk and
    one that rises along the row (every chunk raises its max, so the
    accumulators are rescaled on every chunk)."""
    i = x.shape[2]
    x[0, 2] = float("-inf")
    x[-1, 1, -3] = 40.0
    x[-1, 0] = torch.linspace(-30.0, 30.0, i, device=x.device) + x[-1, 0] * 0.1
    return x


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,i,o", TC_BLOCKED_FWD)
def test_tensor_core_blocked_fwd_edges(f, b, i, o, offset):
    """The blocked forward against its plain version at the edges, its row
    max equal to the clamped max of x, and a second call equal to the bit."""
    x, w = _inputs("lse_matmul", f, b, o, i=i)
    x = _blocked_fwd_edges(x)
    if offset:
        x, w = _offset(x), _offset(w)
    got, m = T._launch_blocked_fwd(x, w)
    again, m_again = T._launch_blocked_fwd(x, w)
    ref, ref_m = T.lse_matmul_blocked_ref(x, w)
    torch.cuda.synchronize()
    assert T.LAUNCHES["lse_matmul_blocked"] == 2
    _fwd_close(got, ref)
    assert torch.equal(m, ref_m)
    assert torch.equal(got, again) and torch.equal(m, m_again)
    assert torch.isneginf(got[0, 2]).all()


def test_tensor_core_blocked_fwd_row_max_is_the_clamped_max():
    """The row max the blocked forward writes is ``_clamp_max(x)`` to the bit
    (the blocked backward shifts by it), at I = 16384 with rows of -inf,
    rows whose max is in the last chunk and a rising row."""
    x, w = _inputs("lse_matmul", 8, 128, 128, i=128 * 128)
    x = _blocked_fwd_edges(x)
    x[3, 7, :100] = float("-inf")
    _, m = T._launch_blocked_fwd(x, w)
    torch.cuda.synchronize()
    assert torch.equal(m, T._clamp_max(x))


def test_tensor_core_blocked_fwd_against_float64_at_i16384():
    """The blocked forward at the dense K=128 entry's width (I = 16384, B = O
    = 128; 98 of the 784 folds) against the plain version run in float64."""
    x, w = _inputs("lse_matmul", 98, 128, 128, i=128 * 128)
    got, _ = T._launch_blocked_fwd(x, w)
    ref = T.lse_matmul_ref(x.double(), w.double())
    torch.cuda.synchronize()
    _fwd_close(got.double(), ref)


# (F, B, K1, K2, O): K1 != K2, K2 % 4 != 0 (4-byte loads), O = 1 and 65 (two
# unit tiles of 64), ragged B, K1 K2 = 8100 (just under WIDE_WIDTH), and the
# K=64 flagship's tile
TC_SINGLE = [(2, 100, 13, 21, 65), (3, 13, 8, 30, 1), (1, 130, 90, 90, 64), (2, 128, 64, 64, 64),
             (1, 37, 7, 129, 33)]


def _single_edges(op, ins):
    """Rows of x1 and of x2 that are all -inf; a unit whose logits are -inf
    over the first row i and over a 32-column chunk of another (weights 0),
    and, with logits, a unit whose logits are all -inf but the last one
    (its running max stays -inf to the last segment), without, a unit
    whose weights are all 0 (out -inf)."""
    k2 = ins[1].shape[2]
    ins[0][0, 2] = float("-inf")
    ins[1][-1, 1] = float("-inf")
    zero = float("-inf") if "softmax" in op else 0.0
    ins[2][0, 0, :k2] = zero
    ins[2][-1, -1, k2 + 32:k2 + 64] = zero
    ins[2][-1, 0, :-1 if "softmax" in op else None] = zero
    return ins


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,k1,k2,o", TC_SINGLE)
@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
def test_tensor_core_single_pass_tucker_edges(op, f, b, k1, k2, o, offset):
    """The single-pass Tucker forward against its plain version at the edges,
    -inf rows giving -inf and no NaN, and a second call equal to the bit."""
    ins = _single_edges(op, _inputs(op, f, b, o, k1=k1, k2=k2))
    if offset:
        ins[2] = _offset(ins[2])
    got = T._launch_fwd(op, tuple(ins))
    again = T._launch_fwd(op, tuple(ins))
    ref = getattr(T, f"{op}_ref")(*ins)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 2
    _fwd_close(got, ref)
    assert torch.equal(got, again)
    assert torch.isneginf(got[0, 2]).all() and torch.isneginf(got[-1, 1]).all()


@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
def test_tensor_core_single_pass_tucker_against_float64_at_k64(op):
    """The single-pass Tucker forward at the K=64 flagship's entry (F=784,
    B=128, K1=K2=O=64), through the public op, against the plain version
    run in float64."""
    ins = _inputs(op, 784, 128, 64, k1=64, k2=64)
    got = getattr(T, op)(*ins)
    ref = getattr(T, f"{op}_ref")(*(t.double() for t in ins))
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1
    _fwd_close(got.double(), ref)


# --------------------------------------------------------------------------- #
# Every Tucker backward at widths past one block, and the signed and complex
# backwards (kernels 7 and 11) at the SoS entry and its edges
# --------------------------------------------------------------------------- #

# (op, dtype, K1, K2): each width past the single-block Tucker dx kernel's
# shared memory for its type (float32 signed from 202, float64 from 88,
# complex64 from 105, complex128 from 100), K1 = K2 = 128 and K1 != K2, and
# float32 signed at 128 (one block) beside 208 (the split)
WIDE_TUCKER = [
    ("slse_tucker2", torch.float32, 128, 128),
    ("slse_tucker2", torch.float32, 208, 208),
    ("slse_tucker2_softmax", torch.float32, 100, 120),
    ("slse_tucker2", torch.float64, 128, 128),
    ("slse_tucker2_softmax", torch.float64, 100, 120),
    *(("clse_tucker2", dtype, k1, k2, real_w) for dtype in (torch.complex64, torch.complex128)
      for k1, k2 in ((128, 128), (100, 120)) for real_w in (False, True)),
]


def _grads_twice(out, diff, g):
    first = torch.autograd.grad(out, diff, g, retain_graph=True)
    again = torch.autograd.grad(out, diff, g)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), "two calls differ"
    return first


@pytest.mark.parametrize("case", WIDE_TUCKER, ids=lambda c: "-".join(map(str, c)).replace(
    "torch.", ""))
def test_tucker_backward_past_one_block_matches_plain(case):
    """The signed and complex Tucker backwards where their dx accumulators do
    not fit one block (and float32 signed at 128, where they do): F = 2, a
    ragged batch of 70, O = 5, a row that is all -inf and a cotangent that
    is 0 on some rows, against the plain version in the op's type; two
    calls give the same bits."""
    from cirkit_tpu_torch.ops import clse_einsum as C
    from cirkit_tpu_torch.ops import slse_einsum as S

    op, dtype, k1, k2 = case[:4]
    f, b, o = 2, 70, 5
    gen = torch.Generator(device="cuda").manual_seed(1)
    if op.startswith("clse"):
        tol, rel = _COMPLEX_TOL[dtype]
        ins = _complex_inputs(op, f, b, o, dtype, real_w=case[4], k1=k1, k2=k2)
        ins[0][0, 2] = complex(float("-inf"), 0.5)
        ins = [t.requires_grad_() for t in ins]
        out = C.clse_tucker2(*ins)
        real = out.real.dtype
        g = torch.complex(*(torch.randn(out.shape, generator=gen, device="cuda", dtype=real)
                            for _ in range(2)))
        g[1, :3] = 0.0
        grads = _grads_twice(out, ins, g)
        with torch.no_grad():
            refs = C.clse_tucker2_bwd_ref(*ins, out.detach(), g)
        torch.cuda.synchronize()
        for n, (got, r) in enumerate(zip(grads, refs)):
            _complex_bwd_close(got, r, rel, zeros=n < 2)
    else:
        ins = [t.to(dtype) for t in _signed_inputs(op, f, b, o, k1=k1, k2=k2)]
        ins[0][0, 2] = float("-inf")
        ins = [t.requires_grad_(n % 2 == 0 or n == 4) for n, t in enumerate(ins)]
        oa, os_ = getattr(S, op)(*ins)
        g = torch.randn(oa.shape, generator=gen, device="cuda", dtype=dtype)
        g[1, :3] = 0.0
        diff = [t for t in ins if t.requires_grad]
        grads = _grads_twice(oa, diff, g)
        with torch.no_grad():
            refs = [r for r in getattr(S, f"{op}_bwd_ref")(*ins, oa.detach(), os_, g)
                    if r is not None]
        torch.cuda.synchronize()
        for n, (got, r) in enumerate(zip(grads, refs)):
            if dtype == torch.float64:
                _bwd_close_f64(got, r, zeros=n < 2)
            else:
                _close(got, r, zeros=n < 2)
    assert (grads[0][0, 2] == 0).all() and (grads[0][1, :3] == 0).all()
    assert T.LAUNCHES[f"{op}_bwd"] == 2


# (f, B, I, O): the SoS entry, a ragged batch of 4000, O = 1, I = 33 (no
# 16-byte rows) and both at once
SOS_EDGES = [(144, 4096, 32, 32), (144, 4000, 32, 32), (16, 4096, 32, 1), (16, 4096, 33, 32),
             (16, 4000, 33, 33)]
SOS_OPS = [("slse_matmul", torch.float32), ("slse_matmul_softmax", torch.float32),
           ("slse_matmul", torch.float64), ("clse_matmul", torch.complex64, False),
           ("clse_matmul", torch.complex64, True), ("clse_matmul", torch.complex128, False),
           ("clse_matmul", torch.complex128, True)]


@pytest.mark.parametrize("opcase", SOS_OPS, ids=lambda c: "-".join(map(str, c)).replace(
    "torch.", ""))
@pytest.mark.parametrize("f,b,i,o", SOS_EDGES)
def test_sos_backward_edges_match_plain(f, b, i, o, opcase):
    """The dense signed and complex backwards (kernels 7 and 11: a dx tile
    that fits I, a dw split over the batch) against their plain versions at
    the SoS entry and its edges, with a row that is all -inf, rows of fold 0
    whose sum cancels exactly (gradient 0, no NaN) and a cotangent that is 0
    on some rows; two calls give the same bits."""
    from cirkit_tpu_torch.ops import clse_einsum as C
    from cirkit_tpu_torch.ops import slse_einsum as S

    op, dtype = opcase[:2]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = slice(9, 12)  # the rows of fold 0 that cancel
    if op.startswith("clse"):
        tol, rel = _COMPLEX_TOL[dtype]
        x, w = _complex_inputs(op, f, b, o, dtype, real_w=opcase[2], i=i)
        x[0, 2] = complex(float("-inf"), 0.5)
        # phase 0, magnitude 1 against weights +1, -1, ...: y = 0 exactly
        x[0, rows] = 0.0
        x[0, rows, 32:] = complex(float("-inf"), 0.0)
        w[0] = torch.tensor([1.0, -1.0], device="cuda").repeat(i)[:i].to(w.dtype)
        ins = [x.requires_grad_(), w.requires_grad_()]
        out = C.clse_matmul(*ins)
        real = out.real.dtype
        g = torch.complex(*(torch.randn(out.shape, generator=gen, device="cuda", dtype=real)
                            for _ in range(2)))
        g[1, :3] = 0.0
        assert torch.isneginf(out.real[0, rows]).all()
        grads = _grads_twice(out, ins, g)
        with torch.no_grad():
            refs = C.clse_matmul_bwd_ref(*ins, out.detach(), g)
        torch.cuda.synchronize()
        _complex_bwd_close(grads[0], refs[0], rel, zeros=True)
        _complex_bwd_close(grads[1], refs[1], rel)
    else:
        a, s, w = (t.to(dtype) for t in _signed_inputs(op, f, b, o, i=i))
        a[0, 2] = float("-inf")
        # equal magnitudes, alternating signs against equal weights: y = 0
        a[0, rows] = 0.0
        s[0, rows] = torch.tensor([1.0, -1.0], device="cuda").repeat(i)[:i].to(dtype)
        s[0, rows, 32:] = 0.0
        w[0] = 0.0 if "softmax" in op else 1.0
        ins = [a.requires_grad_(), s, w.requires_grad_()]
        oa, os_ = getattr(S, op)(*ins)
        assert torch.isneginf(oa[0, rows]).all() and (os_[0, rows] == 0).all()
        g = torch.randn(oa.shape, generator=gen, device="cuda", dtype=dtype)
        g[1, :3] = 0.0
        grads = _grads_twice(oa, [ins[0], ins[2]], g)
        with torch.no_grad():
            refs = [r for r in getattr(S, f"{op}_bwd_ref")(*ins, oa.detach(), os_, g)
                    if r is not None]
        torch.cuda.synchronize()
        close = _bwd_close_f64 if dtype == torch.float64 else _close
        close(grads[0], refs[0], zeros=True)
        close(grads[1], refs[1])
    assert (grads[0][0, 2] == 0).all() and (grads[0][0, rows] == 0).all()
    assert (grads[0][1, :3] == 0).all()
    assert T.LAUNCHES[f"{op}_bwd"] == 2


# (F, B, I, O): the narrow forwards' route edges. I and O of 1, 7 and 32 and
# B of 1, 33 and 4096 take slse_fwd_narrow / clse_fwd_narrow; I = 33 or
# O = 33 the tiled kernels (lse_fwd, clse_fwd_kernel)
NARROW_FWD = [(3, 1, 1, 1), (3, 33, 7, 32), (2, 4096, 32, 7), (144, 4096, 32, 32),
              (5, 33, 32, 1), (3, 4096, 1, 32), (2, 33, 33, 32), (2, 4096, 32, 33),
              (2, 1, 33, 33)]
NARROW_OPS = [("slse_matmul", torch.float32), ("slse_matmul_softmax", torch.float32),
              ("slse_matmul", torch.float64), ("slse_matmul_softmax", torch.float64),
              ("clse_matmul", torch.complex64, False), ("clse_matmul", torch.complex64, True),
              ("clse_matmul", torch.complex128, False), ("clse_matmul", torch.complex128, True)]


def _narrow_inputs(op, f, b, i, o, dtype, real_w):
    """The op's inputs with fold 0's row 2 (the last row, for B < 3) all -inf
    and, where B > 11 and I > 1, rows 9-11 of fold 0 summing to exactly 0:
    equal magnitudes against weights of equal size and alternating sign (the
    signs alternate in the signed op, the weights in the complex one), over
    an even number of columns."""
    rows, row, even = slice(9, 12), min(2, b - 1), i - i % 2
    cancel = b > 11 and i > 1
    if op.startswith("clse"):
        x, w = _complex_inputs(op, f, b, o, dtype, real_w=real_w, i=i)
        x[0, row] = complex(float("-inf"), 0.5)
        if cancel:
            x[0, rows] = 0.0
            w[0] = 0.0
            w[0, :, :even] = torch.tensor([1.0, -1.0], device="cuda").repeat(i)[:even].to(w.dtype)
        return [x, w], cancel
    a, s, w = (t.to(dtype) for t in _signed_inputs(op, f, b, o, i=i))
    a[0, row] = float("-inf")
    if cancel:
        a[0, rows] = 0.0
        s[0, rows] = 0.0
        s[0, rows, :even] = torch.tensor([1.0, -1.0], device="cuda", dtype=dtype).repeat(i)[:even]
        w[0] = 0.0 if "softmax" in op else 1.0
    return [a, s, w], cancel


def _fwd_kernel_names(fn):
    """The names of the CUDA kernels that ``fn`` launches (torch.profiler). A
    trace of a microsecond kernel has come back empty on the card (a
    profiler miss, as ``chip_smoke.py``'s ``_check_route`` notes): an empty
    trace is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if names:
            break
    return names


@pytest.mark.parametrize("opcase", NARROW_OPS, ids=lambda c: "-".join(map(str, c)).replace(
    "torch.", ""))
@pytest.mark.parametrize("f,b,i,o", NARROW_FWD)
def test_narrow_forward_edges_match_plain(f, b, i, o, opcase):
    """The signed and complex forwards (kernels 6 and 10) at the narrow route's
    edges against their plain versions, in linear space scaled by the row's
    absolute mass (1e-5 in float32 and complex64, 1e-12 in float64 and
    complex128): a row that is all -inf and an exact cancellation give
    -inf (with sign 0, or a finite phase); two calls give the same bits; the
    launch takes the narrow kernel exactly where I and O are at most 32."""
    from cirkit_tpu_torch.ops import clse_einsum as C
    from cirkit_tpu_torch.ops import slse_einsum as S

    op, dtype = opcase[:2]
    ins, cancel = _narrow_inputs(op, f, b, i, o, dtype, opcase[2] if len(opcase) > 2 else False)
    row = min(2, b - 1)
    if op.startswith("clse"):
        tol = _COMPLEX_TOL[dtype][0]
        out = C.clse_matmul(*ins)
        _complex_close(ins, out, C.clse_matmul_ref(*ins), tol)
        assert torch.isfinite(out.imag).all() and torch.isneginf(out.real[0, row]).all()
        if cancel:
            assert torch.isneginf(out.real[0, 9:12]).all()
        again = C.clse_matmul(*ins)
        assert torch.equal(out, again)
    else:
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        out = getattr(S, op)(*ins)
        _signed_close(op, ins, out, getattr(S, f"{op}_ref")(*ins), tol=tol)
        assert torch.isneginf(out[0][0, row]).all() and (out[1][0, row] == 0).all()
        if cancel:
            assert torch.isneginf(out[0][0, 9:12]).all() and (out[1][0, 9:12] == 0).all()
        again = getattr(S, op)(*ins)
        assert all(torch.equal(a, b_) for a, b_ in zip(out, again))
    assert T.LAUNCHES[op] == 2
    names = _fwd_kernel_names(lambda: C.clse_matmul(*ins) if op.startswith("clse")
                              else getattr(S, op)(*ins))
    narrow = [n for n in names if "fwd_narrow" in n]
    assert len(names) == 1 and bool(narrow) == (i <= 32 and o <= 32), names


# --------------------------------------------------------------------------- #
# Second derivatives, the dx-only backward and the expectation queries
# --------------------------------------------------------------------------- #


def _second_derivative_cases():
    from cirkit_tpu_torch.ops import clse_einsum as C
    from cirkit_tpu_torch.ops import slse_einsum as S

    def lse(op):
        return lambda: (getattr(T, op), _inputs(op, 2, 8, 16))

    def signed(op):
        def make():
            xs = _inputs(op.removeprefix("s"), 2, 8, 16)
            ins = [xs[0], torch.ones_like(xs[0])] + (
                [xs[1], torch.ones_like(xs[1])] if "tucker" in op else []) + [xs[-1]]
            return (lambda *a: getattr(S, op)(*a)[0]), ins
        return make

    def complex_(op):
        def make():
            xs = _inputs(op.removeprefix("c"), 2, 8, 16)
            return getattr(C, op), [x.to(torch.complex64) for x in xs[:-1]] + [xs[-1]]
        return make

    def blocked(monkeypatch_width=8):
        def make():
            return T.lse_matmul, _inputs("lse_matmul", 2, 8, 16, i=monkeypatch_width)
        return make

    return {**{op: lse(op) for op in OPS}, **{op: signed(op) for op in SIGNED_OPS},
            **{op: complex_(op) for op in COMPLEX_OPS}, "lse_matmul_blocked": blocked()}


@pytest.mark.parametrize("op", list(_second_derivative_cases()))
def test_second_derivative_through_a_kernel_raises(op, monkeypatch):
    """A graph of the backward (``create_graph=True``) through a CUDA kernel
    raises instead of returning a second derivative that lacks the kernel's
    terms; the first derivative still runs."""
    if op == "lse_matmul_blocked":
        monkeypatch.setattr(T, "WIDE_WIDTH", 8)
    fn, ins = _second_derivative_cases()[op]()
    x = ins[0].requires_grad_()
    out = fn(*ins)
    (g,) = torch.autograd.grad(out.real.sum(), [x], retain_graph=True)
    assert torch.isfinite(g).all()
    with pytest.raises(RuntimeError, match="not differentiable"):
        torch.autograd.grad(out.real.sum(), [x], create_graph=True)


# (op, F, B, K1, K2, O) or (op, F, B, I, O): the K=64 Tucker softmax entry,
# the K=128 one (F cut to 98: the plain version's (F, B, 16384) operands)
# and a dense mixing entry
DX_ONLY_CASES = [("lse_tucker2_softmax", 784, 128, 64, 64, 64),
                 ("lse_tucker2_softmax", 98, 128, 128, 128, 128),
                 ("lse_matmul_softmax", 1568, 128, 64, 64)]


@pytest.mark.parametrize("case", DX_ONLY_CASES, ids=["k64-tucker", "k128-tucker", "mixing"])
def test_dx_only_backward_matches_plain(case):
    """The backward with the weight not differentiated (the expectation
    queries' route): input gradients only, one backward launch, within the
    backward bound of the plain version with the same ``needs``, and a
    second call equal to the bit."""
    op, f, b, *rest = case
    gen = torch.Generator(device="cuda").manual_seed(3)
    if "tucker" in op:
        k1, k2, o = rest
        xs = [torch.randn((f, b, k), generator=gen, device="cuda") * 3 - 2 for k in (k1, k2)]
        theta = torch.randn((f, o, k1 * k2), generator=gen, device="cuda")
    else:
        i, o = rest
        xs = [torch.randn((f, b, i), generator=gen, device="cuda") * 3 - 2]
        theta = torch.randn((f, o, i), generator=gen, device="cuda")
    xs = [x.requires_grad_() for x in xs]
    out = getattr(T, op)(*xs, theta)
    g = torch.randn(out.shape, generator=gen, device="cuda")
    first = torch.autograd.grad(out, xs, g, retain_graph=True)
    again = torch.autograd.grad(out, xs, g)
    assert T.LAUNCHES[f"{op}_bwd"] == 2
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))
    needs = (True,) * len(xs) + (False,)
    with torch.no_grad():
        refs = getattr(T, f"{op}_bwd_ref")(*xs, theta, out, g, needs)
    assert refs[-1] is None
    for got, ref in zip(first, refs[:-1]):
        _close(got, ref, zeros=True)


def test_small_circuit_expectation_through_the_kernels():
    """``ExpectationQuery`` on a small Tucker circuit on the card: the means,
    variances and marginals against the same store in float64 on the CPU
    (to ``2e-3 max + 1e-4``, the gradient bound, since they are sums of
    responsibilities), one forward and one dx-only backward launch per
    kernel-bearing entry, and the covariance rows through the plain
    compositions on the card (no launch) against the CPU's."""
    from cirkit_tpu_torch.backend.torch import ExpectationQuery, mutual_information

    ctx, cc = _flagship_like("tucker", "cuda")
    ctx_cpu, cc_cpu = _flagship_like("tucker", "cpu")
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    n_kernel = sum(isinstance(l, (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer))
                   for l in cc.layers)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (16, 64))
    mask = rng.random((16, 64)) < 0.5
    q, q_cpu = ExpectationQuery(cc), ExpectationQuery(cc_cpu)

    def held(got, want):
        want = want.numpy()
        bound = 2e-3 * np.abs(want).max() + 1e-4
        assert np.abs(got.double().cpu().numpy() - want).max() <= bound

    mean, var = q(x, evidence_mask=mask, return_variance=True)
    torch.cuda.synchronize()
    fwd = sum(T.LAUNCHES[op] for op in OPS)
    bwd = sum(T.LAUNCHES[f"{op}_bwd"] for op in OPS)
    assert fwd == bwd == n_kernel
    want_mean, want_var = q_cpu(x, evidence_mask=mask, return_variance=True)
    held(mean, want_mean)
    held(var, want_var)
    held(q.marginals(x, evidence_mask=mask), q_cpu.marginals(x, evidence_mask=mask))
    before = dict(T.LAUNCHES)
    row = q._dispatch("cov_row", x, mask, None, 0, 0, extra=(5,))
    torch.cuda.synchronize()
    assert T.LAUNCHES == before  # the plain compositions
    held(row, q_cpu._dispatch("cov_row", x, mask, None, 0, 0, extra=(5,)))
    mi = mutual_information(cc, variables=(0, 9, 30))
    held(mi, mutual_information(cc_cpu, variables=(0, 9, 30)))


@pytest.mark.parametrize("rows,width", [(64, 16384), (4096, 16)])
def test_top_selection_on_the_card_is_the_stable_sort(rows, width):
    """``topk._top`` on CUDA picks what a stable descending sort on the CPU
    picks, to the bit, on float32 scores with many ties of both signs and
    rows of -inf, through ``torch.topk`` (wide rows) and a sort (narrow)."""
    from cirkit_tpu_torch.backend.torch.topk import _top

    g = torch.Generator().manual_seed(5)
    x = (torch.randint(0, 7, (rows, width), generator=g) - 3).float() * 0.5
    x[0] = -torch.inf
    x[1, ::3] = -torch.inf
    vals, idx = _top(x.cuda(), 4)
    want_vals, want_idx = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(vals.cpu(), want_vals[:, :4]) and torch.equal(idx.cpu(), want_idx[:, :4])


# The bf16-weight (``_w16``) and fast-mode (``_fast``, ``_sr``) instances of
# kernels 1, 2 and 5, each held against its plain version in the same mode
# (``*_ref(..., mode=)``, which rounds at the kernel's points with the same
# bits), to the float32 bounds above.
INSTANCES = [("_w16", ""), ("_fast", "bf16"), ("_sr", "sr"), ("_w16_fast", "bf16"),
             ("_w16_sr", "sr")]


def _instance_inputs(op, sfx, f, b, o, **kw):
    ins = _inputs(op, f, b, o, **kw)
    ins[0][0, 2] = float("-inf")  # a row that is all -inf
    if sfx.startswith("_w16"):
        ins[-1] = ins[-1].to(torch.bfloat16)
    return ins


@pytest.mark.parametrize("f,b,o,k1,k2", [(3, 8, 16, 8, 16), (3, 13, 1, 8, 16), (2, 130, 70, 4, 64),
                                         (2, 33, 64, 5, 30)])
@pytest.mark.parametrize("sfx,mode", INSTANCES, ids=[s for s, _ in INSTANCES])
@pytest.mark.parametrize("op", OPS)
def test_instance_kernels_match_plain(op, sfx, mode, f, b, o, k1, k2):
    ins = _instance_inputs(op, sfx, f, b, o, k1=k1, k2=k2, i=k1 * k2)
    out = T._launch_fwd(op, tuple(ins), mode)
    ref = T._ENTRIES[op][2](*ins, mode=mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op + sfx] == 1
    _fwd_close(out, ref)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[1, 3:5] = 0.0
    needs = (True,) * len(ins)
    grads = T._launch_bwd(op, tuple(ins), out, g, needs, mode)
    refs = T._ENTRIES[op][3](*ins, out, g, needs, mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}{sfx}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):  # the fast Tucker dW in the weight's type
        weight = k == len(ins) - 1 and "tucker" in op and bool(mode)
        assert got.dtype == (ins[-1].dtype if weight else torch.float32)
        _close_grad(got, r, zeros=k < len(ins) - 1)


@pytest.mark.parametrize("sfx,mode", INSTANCES, ids=[s for s, _ in INSTANCES])
@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
@pytest.mark.parametrize("f,b,k1,k2,o", CHUNKED_CASES)
def test_chunked_instance_kernels_match_plain(op, sfx, mode, f, b, k1, k2, o):
    ins = _instance_inputs(op, sfx, f, b, o, k1=k1, k2=k2)
    out = T._launch_fwd(f"{op}_chunked", tuple(ins), mode)
    ref = T._ENTRIES[op][2](*ins, mode=mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}_chunked{sfx}"] == 1
    _fwd_close(out, ref)


# The fast-mode instances of kernels 1 and 5 on the bf16 tensor cores
# (csrc/tucker_bf16.cu): (F, B, K1, K2, O) of the single-pass ones (the K=64
# entry; K2 of 20 and 7, ragged k16 steps; K2 = 100, two chunks of 64
# columns, the last ragged; ragged B and O; F = 1; past a batch of 128 the
# blocks of 256 rows: the serving batch 512, and 700, whose last block ends
# in its third warpgroup) and of the K1-chunked ones (the widest K=128 entry,
# I = 16384, on 8 of its 784 folds, at batch 128 and 512; K2 = 20).
BF16_TUCKER = {
    "lse_tucker2": [(784, 128, 64, 64, 64), (2, 130, 9, 20, 70), (1, 13, 5, 7, 1),
                    (1, 37, 3, 100, 65), (8, 512, 64, 64, 64), (3, 700, 7, 20, 70)],
    "lse_tucker2_chunked": [(8, 128, 128, 128, 128), (1, 130, 6, 20, 129),
                            (8, 512, 128, 128, 128)],
}
BF16_TUCKER_CASES = [(op.replace("lse_tucker2", f"lse_tucker2{sm}"), case)
                     for op, cases in BF16_TUCKER.items() for sm in ("", "_softmax")
                     for case in cases]
FAST_INSTANCES = [(sfx, mode) for sfx, mode in INSTANCES if mode]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("sfx,mode", FAST_INSTANCES, ids=[s for s, _ in FAST_INSTANCES])
@pytest.mark.parametrize("key,case", BF16_TUCKER_CASES,
                         ids=[f"{k}-" + "x".join(map(str, c)) for k, c in BF16_TUCKER_CASES])
def test_bf16_tucker_instances_match_plain(key, case, sfx, mode, offset):
    """Each fast-mode Tucker instance (linear and logits, float32 and bf16
    weights, kernels 1 and 5) against its plain version in its mode, to the
    forward bound, at the edges of ``_single_edges`` (rows of x1 and of x2
    that are all -inf give -inf and no NaN), on a weight 16-byte aligned (the
    ring of copies) and one element off (read element by element); a second
    call equal to the bit (``sr`` included), and the launch on the bf16
    kernel alone."""
    op = key.removesuffix("_chunked")
    f, b, k1, k2, o = case
    ins = _single_edges(op, _inputs(op, f, b, o, k1=k1, k2=k2))
    if sfx.startswith("_w16"):
        ins[2] = ins[2].to(torch.bfloat16)
    if offset:
        ins[2] = _offset(ins[2])
    got = T._launch_fwd(key, tuple(ins), mode)
    again = T._launch_fwd(key, tuple(ins), mode)
    ref = T._ENTRIES[key][2](*ins, mode=mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[key + sfx] == 2
    _fwd_close(got, ref)
    assert torch.equal(got, again)
    assert torch.isneginf(got[0, 2]).all() and torch.isneginf(got[-1, 1]).all()
    if f == 1:
        names = _fwd_kernel_names(lambda: T._launch_fwd(key, tuple(ins), mode))
        assert any("tucker_fwd_bf16" in n for n in names), names
        assert not any("_fwd_tc" in n for n in names), names


def _close_grad(got, ref, *, zeros=False):
    """``_close`` for a gradient in the weight's type: a bf16 one is the
    round-to-nearest of a float32 sum, so it may be off by that rounding,
    half a bf16 step, up to ``2**-8 |plain|``, on top of the float32 bound."""
    if got.dtype == torch.float32:
        _close(got, ref, zeros=zeros)
        return
    assert got.shape == ref.shape and not torch.isnan(got).any()
    err = (got.float() - ref).abs()
    bound = 1e-4 * ref.abs().max() + 1e-4 * ref.abs() + 2.0**-8 * ref.abs()
    assert bool((err <= bound).all()), float((err - bound).max())


# The fast-mode Tucker backward on the bf16 tensor cores
# (csrc/tucker_bf16_bwd.cu), (F, B, K1, K2, O): the K=64 entry, the K=128
# one on 8 of its folds, the TP shard's O=32 and the grown flagship's 96,
# batches past one tile of 128 rows (512; 700, which ends in a part tile),
# ragged B, O, K1 and K2 (20 and 7: ragged k16 steps; 100: two column
# chunks, the last ragged), and O=200: two unit groups; each in full, and
# the ragged ones also with dx alone (the EM flows' and expectation
# queries' calls), with dW alone, and on a weight one element off 16-byte
# alignment (read element by element).
BF16_TUCKER_BWD = [
    *(((784, 128, 64, 64, 64), "full", False), ((8, 128, 128, 128, 128), "full", False),
      ((16, 128, 64, 64, 32), "full", False), ((4, 128, 96, 96, 96), "full", False),
      ((8, 512, 64, 64, 64), "full", False)),
    *((case, needs, offset) for case in ((3, 700, 7, 20, 70), (2, 130, 9, 20, 70),
                                         (1, 13, 5, 7, 1), (1, 37, 3, 100, 65),
                                         (2, 33, 3, 100, 200))
      for needs, offset in (("full", False), ("full", True), ("dx", False), ("dw", False))),
]
_NEEDS = {"full": (True, True, True), "dx": (True, True, False), "dw": (False, False, True)}


@pytest.mark.parametrize("sfx,mode", FAST_INSTANCES, ids=[s for s, _ in FAST_INSTANCES])
@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
@pytest.mark.parametrize("case,needs,offset", BF16_TUCKER_BWD, ids=[
    "x".join(map(str, c)) + f"-{n}" + ("-offset" if off else "") for c, n, off in BF16_TUCKER_BWD])
def test_bf16_tucker_backward_matches_plain(case, needs, offset, op, sfx, mode):
    """Each fast-mode Tucker backward (linear and logits, float32 and bf16
    weights) against its plain version in its mode: the input gradients to
    the float32 bound and 0 at the rows of -inf inputs and of zero
    cotangent, the weight's gradient in the weight's type to the bound of
    ``_close_grad``; the gradients not asked for None; a second call equal
    to the bit (``sr`` too); one launch a call, of tucker_bwd_bf16 alone."""
    f, b, k1, k2, o = case
    ins = _single_edges(op, _inputs(op, f, b, o, k1=k1, k2=k2))
    if sfx.startswith("_w16"):
        ins[2] = ins[2].to(torch.bfloat16)
    if offset:
        ins[2] = _offset(ins[2])
    out = T._ENTRIES[op][2](*ins, mode=mode)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[-1, : min(3, b)] = 0.0
    want = _NEEDS[needs]
    got = T._launch_bwd(op, tuple(ins), out, g, want, mode)
    again = T._launch_bwd(op, tuple(ins), out, g, want, mode)
    refs = T._ENTRIES[op][3](*ins, out, g, want, mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}{sfx}_bwd"] == 2
    for k, (a, a2, r) in enumerate(zip(got, again, refs)):
        assert (a is None) == (not want[k]) and (r is None) == (not want[k])
        if a is None:
            continue
        assert a.dtype == (ins[2].dtype if k == 2 else torch.float32)
        assert torch.equal(a, a2)
        _close_grad(a, r, zeros=k < 2)
    if f == 1 and needs == "full" and not offset:
        names = _fwd_kernel_names(lambda: T._launch_bwd(op, tuple(ins), out, g, want, mode))
        assert any("tucker_bwd_bf16" in n for n in names), names
        assert not any("tc_dx_tucker" in n or "tc_dw_kernel" in n for n in names), names


def test_fast_mode_and_bf16_store_through_the_ops(monkeypatch):
    """The public ops read ``CIRKIT_TPU_FAST`` at each call and take a bf16
    weight as it is; the weight's gradient comes back bf16; ``sr`` repeats
    to the bit."""
    ins = _inputs("lse_tucker2_softmax", 3, 130, 64, k1=8, k2=16)
    ins[-1] = ins[-1].to(torch.bfloat16).requires_grad_()
    for env, sfx in (("", "_w16"), ("1", "_w16_fast"), ("sr", "_w16_sr")):
        monkeypatch.setenv("CIRKIT_TPU_FAST", env)
        out = T.lse_tucker2_softmax(*ins)
        (dw,) = torch.autograd.grad(out.sum(), [ins[-1]])
        again = T.lse_tucker2_softmax(*ins)
        torch.cuda.synchronize()
        assert dw.dtype == torch.bfloat16 and torch.equal(out, again)
        assert T.LAUNCHES[f"lse_tucker2_softmax{sfx}"] == 2
        assert T.LAUNCHES[f"lse_tucker2_softmax{sfx}_bwd"] == 1


def test_export_on_the_card_embeds_the_kernel_ops():
    """``export_circuit`` traced on CUDA with a bf16 store: the artifact
    holds the ``cirkit_tpu_torch::lse_fwd`` nodes, and its forward equals
    the eager one to the bit, launching the same kernels."""
    from cirkit_tpu_torch.backend.torch import bf16_weight_store, export_circuit, load_exported

    ctx, cc = _flagship_like("tucker", "cuda")
    store = bf16_weight_store(cc, cc.restrict_store(ctx.parameters))
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (16, 64)), device="cuda")
    with torch.no_grad():
        want = cc.evaluate(store, x)
    blob = export_circuit(cc, x, store=store, platforms=("cuda",))
    fn = load_exported(blob)
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0
    got = fn(store, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert T.LAUNCHES["lse_tucker2_softmax_w16"] > 0


# The bf16-weight and fast-mode instances of the blocked dense kernels (3'
# and 4', csrc/blocked_bf16.cu), held against their plain versions in the
# same mode as kernels 1, 2 and 5's are, at the float32 blocked forward's
# edges (and I = 260: I % 4 == 0 but not I % 8, so a bf16 weight is copied
# element by element), aligned and one element off (no TMA copies); at B
# past one batch tile of either kernel (128 rows forward, 64 backward), O
# past one launch's 128 units (the later launch adding its dx) and I % 8 =
# 3 (B=300, I=8195, O=200); and at an aligned B=200, O=72 (TMA, one unit
# tile and a partial second).
BLOCKED_INSTANCE_CASES = [*TC_BLOCKED_FWD, (2, 16, 260, 16), (2, 300, 8195, 200),
                          (1, 200, 8256, 72)]


def _close_blocked_grad(got, ref):
    """The backward bound on a gradient of the plain version's type, or on a
    bf16 one (the bf16-weight instances' weight gradient, the nearest to its
    f32 sum): against the plain gradient rounded to bf16, one bf16 ulp of it
    more (of the smallest bf16 normal at least, so an exact 0 gets none)."""
    if got.dtype != torch.bfloat16:
        return _close(got, ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    want = ref.to(torch.bfloat16).float()
    exp = torch.frexp(want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)).exponent
    ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    err = (got.float() - want).abs()
    bound = 1e-4 * ref.abs().max() + 1e-4 * ref.abs() + ulp
    assert not torch.isnan(got).any() and bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,i,o", BLOCKED_INSTANCE_CASES)
@pytest.mark.parametrize("sfx,mode", INSTANCES, ids=[s for s, _ in INSTANCES])
def test_blocked_instance_kernels_match_plain(sfx, mode, f, b, i, o, offset):
    x, w = _inputs("lse_matmul", f, b, o, i=i)
    x = _blocked_fwd_edges(x)
    if sfx.startswith("_w16"):
        w = w.to(torch.bfloat16)
    if offset:
        x, w = _offset(x), _offset(w)
    out, m = T._launch_blocked_fwd(x, w, mode)
    ref, ref_m = T.lse_matmul_blocked_ref(x, w, mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"lse_matmul_blocked{sfx}"] == 1
    _fwd_close(out, ref)
    assert torch.equal(m, ref_m) and torch.equal(m, T._clamp_max(x))
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[0, 3:5] = 0.0
    grads = T._launch_blocked_bwd(x, w, out, m, g, (True, True), mode)
    again = T._launch_blocked_bwd(x, w, out, m, g, (True, True), mode)
    dx_only = T._launch_blocked_bwd(x, w, out, m, g, (True, False), mode)
    dw_only = T._launch_blocked_bwd(x, w, out, m, g, (False, True), mode)
    refs = T.lse_matmul_blocked_bwd_ref(x, w, out, m, g, (True, True), mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"lse_matmul_blocked{sfx}_bwd"] == 4
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    assert dx_only[1] is None and dw_only[0] is None
    assert torch.equal(dx_only[0], grads[0]) and torch.equal(dw_only[1], grads[1])
    assert grads[0].dtype == torch.float32 and grads[1].dtype == w.dtype
    _close(grads[0], refs[0], zeros=not mode)  # bf16 operands may cancel to an exact 0
    _close_blocked_grad(grads[1], refs[1])
    structural = torch.isneginf(x) | (g == 0).all(dim=-1, keepdim=True)
    assert bool((grads[0][structural] == 0).all())


@pytest.mark.parametrize("sfx,mode", INSTANCES, ids=[s for s, _ in INSTANCES])
def test_blocked_instances_against_float64_at_i16384(sfx, mode):
    """Each blocked instance at the dense K=128 entry's width (I = 16384, B =
    O = 128; 8 of the 784 folds) against the plain version in float64 on the
    (bf16-valued) weight: the f32-grade bf16-weight instance to the float32
    bound, the fast ones to the JAX package's fast bound, 8e-3 in log space."""
    x, w = _inputs("lse_matmul", 8, 128, 128, i=128 * 128)
    if sfx.startswith("_w16"):
        w = w.to(torch.bfloat16)
    got, _ = T._launch_blocked_fwd(x, w, mode)
    ref = T.lse_matmul_ref(x.double(), w.double())
    torch.cuda.synchronize()
    if mode:
        assert float((got.double() - ref).abs().max()) < 8e-3
    else:
        _fwd_close(got.double(), ref)


def test_blocked_fast_mode_and_bf16_store_through_the_ops(monkeypatch):
    """The public ``lse_matmul`` at wide I reads ``CIRKIT_TPU_FAST`` at each
    call and takes a bf16 weight as it is; the weight's gradient comes back
    bf16; ``sr`` repeats to the bit; wide softmax normalizes a float32 weight
    first and so runs the float32-weight instances."""
    x, w = _inputs("lse_matmul", 2, 130, 70, i=T.WIDE_WIDTH)
    w16 = w.to(torch.bfloat16).requires_grad_()
    for env, sfx in (("", "_w16"), ("1", "_w16_fast"), ("sr", "_w16_sr")):
        monkeypatch.setenv("CIRKIT_TPU_FAST", env)
        out = T.lse_matmul(x, w16)
        (dw,) = torch.autograd.grad(out.sum(), [w16])
        again = T.lse_matmul(x, w16)
        torch.cuda.synchronize()
        assert dw.dtype == torch.bfloat16 and torch.equal(out, again)
        assert T.LAUNCHES[f"lse_matmul_blocked{sfx}"] == 2
        assert T.LAUNCHES[f"lse_matmul_blocked{sfx}_bwd"] == 1
        theta = torch.randn(w.shape, device="cuda")
        T.lse_matmul_softmax(x, theta.to(torch.bfloat16))
        assert T.LAUNCHES[f"lse_matmul_blocked{sfx.removeprefix('_w16')}"] == 1
        for op in T.LAUNCHES:
            T.LAUNCHES[op] = 0


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
@pytest.mark.parametrize("f,b,k1,k2,o", ROUTE_SHAPES)
def test_routing_bf16_th_equals_the_widened_run(f, b, k1, k2, o, log_weights, offset):
    """The ``_w16`` instances of the routing kernels (8' and 9'): on a bf16
    ``th`` (8-byte loads, or aligned to 2 bytes only) the max-plus Tucker,
    whole and split in 3 ranges, and both routing kinds equal the float32
    instances on the widened ``th`` taking the same loads (aligned, or
    element by element, which sums a row's softmax normalizer in another
    order) to the bit, and the max-plus its plain version to the bound
    above; float64 children widen a bf16 ``th``."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, sel = _route_inputs(f, b, k1, k2, o, log_weights)
    t16 = th.to(torch.bfloat16)
    t32 = t16.float()
    if offset:
        t16, t32 = _offset(t16), _offset(t32)
    for splits in (None, 3):
        got = R.tropical_tucker2(x1, x2, t16, log_weights=log_weights, splits=splits)
        want = R.tropical_tucker2(x1, x2, t32, log_weights=log_weights, splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    ref = R.tropical_tucker2_ref(x1, x2, t16, log_weights=log_weights)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    assert bool(((got - ref)[fin].abs() <= 1e-5 * ref[fin].abs() + 1e-5).all())
    for kind in R.KINDS:
        got = R.route_tucker2(x1, x2, t16, sel, kind=kind, log_weights=log_weights, seed=11)
        want = R.route_tucker2(x1, x2, t32, sel, kind=kind, log_weights=log_weights, seed=11)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert T.LAUNCHES["tropical_tucker2_w16"] == 2 and T.LAUNCHES["route_tucker2_w16"] == 2
    R.tropical_tucker2(x1.double(), x2.double(), t16, log_weights=log_weights)
    assert T.LAUNCHES["tropical_tucker2_w16"] == 2  # widened: the float64 instance


# The bf16-weight and fast-mode instances of the signed kernels (6' and 7')
# and the fast modes of the complex kernels (10' and 11'), each held against
# its plain version in the same mode (which rounds at the kernel's points
# with the same bits) to the float32 bounds above, at the edges of the
# narrow route (I and O of 7, 32 and 33), on the tiled and Tucker routes
# (the Tucker dx with K2 = 64 and not, and past one block: the K1 split),
# aligned and one element off (4-byte loads); the input gradients 0 where
# that is structural (a sign or a row of 0, a row of -inf, a row of zero
# cotangent).
# (F, B, I, O) of the dense ops, (F, B, K1, K2, O) of the Tucker ones
DENSE_INSTANCE_CASES = [(3, 33, 7, 32), (2, 4096, 32, 32), (2, 33, 33, 32), (2, 130, 64, 70)]
# the Tucker forwards on the tensor cores: the K=64 entry, the serving batch
# 512 (8 of its folds), ragged B, K1, K2 (10: no multiple of 4) and O, a
# batch of 700 (blocks of 256 rows, the last ragged), O = 1 and O > 128
TUCKER_INSTANCE_CASES = [(2, 13, 8, 16, 16), (2, 33, 4, 64, 64), (784, 128, 64, 64, 64),
                         (8, 512, 64, 64, 64), (3, 37, 7, 10, 70), (2, 700, 7, 10, 70),
                         (3, 200, 16, 16, 1), (2, 33, 8, 16, 200)]
SIGNED_INSTANCE_CASES = [(op, case) for op in SIGNED_OPS for case in (
    [*TUCKER_INSTANCE_CASES, (1, 8, 208, 208, 5)] if "tucker" in op else DENSE_INSTANCE_CASES)]


def _structural_zeros(a, s, g):
    """Where an input gradient of a signed op is 0 by structure."""
    return (s == 0) | torch.isneginf(a) | (g == 0).all(dim=-1, keepdim=True)


def _case_id(c):
    return f"{c[0]}-" + "x".join(map(str, c[1]))


SIGNED_MODES = [("", ""), *INSTANCES]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("sfx,mode", SIGNED_MODES, ids=[s or "f32" for s, _ in SIGNED_MODES])
@pytest.mark.parametrize("op,case", SIGNED_INSTANCE_CASES,
                         ids=[_case_id(c) for c in SIGNED_INSTANCE_CASES])
def test_signed_instance_kernels_match_plain(op, case, sfx, mode, offset):
    """Each float32 signed instance, forward and backward, against its plain
    version in its mode; the Tucker ones (on the tensor cores) with fold 0's
    row of -inf inputs and its row whose terms cancel exactly, both (-inf, 0);
    two calls equal to the bit (``sr`` included)."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    tucker = "tucker" in op
    f, b, *dims, o = case
    if tucker:
        ins = _signed_tucker_inputs(op, f, b, *dims, o)
    else:
        ins = _signed_inputs(op, f, b, o, i=dims[0])
        ins[0][0, min(2, b - 1)] = float("-inf")  # a row that is all -inf
    if sfx.startswith("_w16"):
        ins[-1] = ins[-1].to(torch.bfloat16)
    if offset:
        ins = [_offset(t) for t in ins]
    got = S._launch_fwd(op, tuple(ins), mode)
    again = S._launch_fwd(op, tuple(ins), mode)
    ref = S._ENTRIES[op][2](*ins, mode=mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op + sfx] == 2
    _signed_close(op, [*ins[:-1], ins[-1].float()], got, ref)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    for row in (_INF_ROW, _CANCEL_ROW) if tucker else ():
        assert bool(torch.isneginf(got[0][0, row]).all()) and bool((got[1][0, row] == 0).all())
    g = torch.randn(got[0].shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[-1, 3:5] = 0.0
    needs = (True,) * len(ins)
    grads = S._launch_bwd(op, tuple(ins), *ref, g, needs, mode)
    again = S._launch_bwd(op, tuple(ins), *ref, g, needs, mode)
    refs = S._ENTRIES[op][3](*ins, *ref, g, needs, mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}{sfx}_bwd"] == 2
    for k, (d, r) in enumerate(zip(grads, refs)):
        assert (d is None) == (r is None)
        if d is None:
            continue
        # the fast Tucker backward writes the weight's gradient in its type
        bf16_dw = k == len(ins) - 1 and tucker and mode
        assert d.dtype == (ins[-1].dtype if bf16_dw else torch.float32)
        assert torch.equal(d, again[k])
        _close_blocked_grad(d, r)
        if k < len(ins) - 1:
            assert bool((d[_structural_zeros(ins[k], ins[k + 1], g)] == 0).all())


@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_fast_mode_and_bf16_store_through_the_ops(op, monkeypatch):
    """The public signed ops read ``CIRKIT_TPU_FAST`` at each call and take a
    bf16 weight as it is (``_w16`` instances, no widened copy); the weight's
    gradient comes back bf16; ``sr`` repeats to the bit; a bf16 weight in a
    fast mode gives the fast mode's result on the widened weight, to the bit;
    float64 activations run the f32-grade float64 instance on a widened bf16
    weight."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    ins = _signed_inputs(op, 3, 130, 64, k1=8, k2=16, i=64)
    w16 = ins[-1].to(torch.bfloat16).requires_grad_()
    a = ins[0].requires_grad_()
    for env, sfx in (("", "_w16"), ("1", "_w16_fast"), ("sr", "_w16_sr")):
        monkeypatch.setenv("CIRKIT_TPU_FAST", env)
        oa, _ = getattr(S, op)(*ins[:-1], w16)
        da, dw = torch.autograd.grad(oa.sum(), [a, w16])
        again = getattr(S, op)(*ins[:-1], w16)[0]
        widened = getattr(S, op)(*ins[:-1], w16.detach().float())[0]
        torch.cuda.synchronize()
        assert dw.dtype == torch.bfloat16 and torch.equal(oa, again) and torch.equal(oa, widened)
        assert T.LAUNCHES[f"{op}{sfx}"] == 2 and T.LAUNCHES[f"{op}{sfx}_bwd"] == 1
        assert T.LAUNCHES[f"{op}{sfx.removeprefix('_w16')}"] == 1
        for key in T.LAUNCHES:
            T.LAUNCHES[key] = 0
    monkeypatch.setenv("CIRKIT_TPU_FAST", "1")
    x64 = [t.detach().double() for t in ins[:-1]]
    got = getattr(S, op)(*x64, w16.detach())
    want = S._ENTRIES[op][2](*x64, w16.detach().double())
    assert T.LAUNCHES[op] == 1 and all(n == 0 for k, n in T.LAUNCHES.items() if k != op)
    _signed_close(op, [*x64, w16.detach().double()], got, want, 1e-12)


COMPLEX_INSTANCE_CASES = [(op, case) for op in COMPLEX_OPS for case in (
    [*TUCKER_INSTANCE_CASES, (1, 8, 128, 128, 5)] if "tucker" in op else DENSE_INSTANCE_CASES)]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("real_w", [False, True], ids=["complex-w", "real-w"])
@pytest.mark.parametrize("mode", ["", "bf16", "sr"], ids=["f32", "bf16", "sr"])
@pytest.mark.parametrize("op,case", COMPLEX_INSTANCE_CASES,
                         ids=[_case_id(c) for c in COMPLEX_INSTANCE_CASES])
def test_complex_fast_instance_kernels_match_plain(op, case, mode, real_w, offset):
    """Each complex64 instance, forward and backward, against its plain
    version in its mode; the Tucker ones against a real weight (on the tensor
    cores, ``fwd_entry``: ``clse_fwd_tucker_rw`` and its fast instances) with
    fold 0's row of -inf inputs and its row that cancels exactly, both of
    real part -inf; two calls equal to the bit (``sr`` included)."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    tucker = "tucker" in op
    f, b, *dims, o = case
    kw = dict(k1=dims[0], k2=dims[1]) if tucker else dict(i=dims[0])
    rows = tucker and real_w
    if rows:
        ins = _complex_tucker_inputs(f, b, *dims, o)
    else:
        ins = _complex_inputs(op, f, b, o, torch.complex64, real_w=real_w, **kw)
        ins[0][0, min(2, b - 1)] = complex(float("-inf"), 0.5)
    if offset:
        ins = [_offset(t) for t in ins]
    sfx = T.MODE_SUFFIX[mode]
    if rows:
        assert C.fwd_entry(op, torch.complex64, torch.float32, mode) == "clse_fwd_tucker_rw" + sfx
    got = C._launch_fwd(op, tuple(ins), mode)
    again = C._launch_fwd(op, tuple(ins), mode)
    ref = C._ENTRIES[op][0](*ins, mode=mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op + sfx] == 2
    _complex_close(ins, got, ref, 1e-5)
    assert torch.equal(got, again)
    for row in (_INF_ROW, _CANCEL_ROW) if rows else ():
        assert bool(torch.isneginf(got.real[0, row]).all())
    g = torch.complex(*(torch.randn(got.shape, device="cuda",
                                    generator=torch.Generator(device="cuda").manual_seed(k))
                        for k in (1, 2)))
    g[-1, 3:5] = 0.0
    needs = (True,) * len(ins)
    grads = C._launch_bwd(op, tuple(ins), ref, g, needs, mode)
    again = C._launch_bwd(op, tuple(ins), ref, g, needs, mode)
    refs = C._ENTRIES[op][1](*ins, ref, g, needs, mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}{sfx}_bwd"] == 2
    for k, (d, r) in enumerate(zip(grads, refs)):
        assert torch.equal(d, again[k])
        _complex_bwd_close(d, r, 1e-4)
        if k < len(ins) - 1:
            zero = torch.isneginf(ins[k].real) | (g == 0).all(dim=-1, keepdim=True)
            assert bool((d[zero] == 0).all())


def test_complex_fast_modes_through_the_ops(monkeypatch):
    """The public complex ops read ``CIRKIT_TPU_FAST`` at each call on
    complex64 values, with complex and real weights, forward and backward;
    ``sr`` repeats to the bit; complex128 runs the f32-grade instances; a
    bf16 real weight is widened (there is no bf16 instance)."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    for op in COMPLEX_OPS:
        for real_w in (False, True):
            ins = [t.requires_grad_() for t in _complex_inputs(op, 3, 130, 64, torch.complex64,
                                                               real_w=real_w, i=64)]
            for env, sfx in (("1", "_fast"), ("sr", "_sr")):
                monkeypatch.setenv("CIRKIT_TPU_FAST", env)
                out = getattr(C, op)(*ins)
                torch.autograd.grad(out.real.sum(), ins)
                again = getattr(C, op)(*ins)
                torch.cuda.synchronize()
                assert torch.equal(out, again)
                assert T.LAUNCHES[op + sfx] == 2 and T.LAUNCHES[f"{op}{sfx}_bwd"] == 1
                for key in T.LAUNCHES:
                    T.LAUNCHES[key] = 0
            c128 = [t.detach().to(torch.complex128 if t.is_complex() else torch.float64)
                    for t in ins]
            getattr(C, op)(*c128)
            assert T.LAUNCHES[op] == 1
            T.LAUNCHES[op] = 0
    monkeypatch.setenv("CIRKIT_TPU_FAST", "1")
    x = _complex_inputs("clse_matmul", 2, 8, 16, torch.complex64, real_w=True)
    got = C.clse_matmul(x[0], x[1].to(torch.bfloat16))
    want = C.clse_matmul(x[0], x[1].to(torch.bfloat16).float())
    assert torch.equal(got, want) and T.LAUNCHES["clse_matmul_fast"] == 2


# --------------------------------------------------------------------------- #
# The signed and complex Tucker backwards on the tensor cores: the float32
# signed instances (the f32-grade ones, float32 and bf16 weights, on
# mma.sync in csrc/lse_einsum_bwd.cu; the fast ones on wgmma in
# csrc/tucker_bf16_bwd.cu) and the complex64 ones against a real weight
# (clse_bwd_tucker_rw, f32-grade and fast), (F, B, K1, K2, O): the K=64
# entry, K1 != K2, K2 not a multiple of 8, batches that are no multiple of
# 64 or 128, O = 1 and O > 128, K1 = K2 = 128 (past one block of the dx).
# Fold 0 has a row of -inf inputs and a row whose terms cancel exactly (y
# = 0: its sign 0, its gradients 0), on weights of few bits there.
# --------------------------------------------------------------------------- #

SOS_TUCKER_CASES = [(784, 128, 64, 64, 64), (2, 37, 8, 24, 16), (2, 100, 6, 13, 20),
                    (3, 200, 16, 16, 1), (2, 33, 8, 16, 200), (1, 70, 128, 128, 16)]
SIGNED_TUCKER_INSTANCES = [("", ""), ("_w16", ""), *FAST_INSTANCES]
_CANCEL_ROW, _INF_ROW = 1, 2


def _signed_tucker_inputs(op, f, b, k1, k2, o):
    """``_signed_inputs`` with fold 0's structured rows: row ``_INF_ROW`` all
    -inf; row ``_CANCEL_ROW`` with a = 0, s1 = +1 and s2 = +1, -1, +1, ...
    (0 at an odd K2's last column) against weights equal in pairs of
    columns (integers; logits all equal), so its terms cancel exactly."""
    a1, s1, a2, s2, w = _signed_inputs(op, f, b, o, k1=k1, k2=k2)
    a1[0, _INF_ROW] = float("-inf")
    a1[0, _CANCEL_ROW] = a2[0, _CANCEL_ROW] = 0.0
    s1[0, _CANCEL_ROW] = 1.0
    alt = torch.tensor([1.0, -1.0], device="cuda").repeat(k2)[:k2]
    if k2 % 2:
        alt[-1] = 0.0
    s2[0, _CANCEL_ROW] = alt
    if "softmax" in op:
        w[0] = 0.0
    else:
        pairs = torch.randint(-3, 4, (o, k1, (k2 + 1) // 2), device="cuda").float()
        w[0] = pairs.repeat_interleave(2, dim=-1)[..., :k2].reshape(o, k1 * k2)
    return [a1, s1, a2, s2, w]


def _tc_kernels(names):
    return {n for n in names if "tc_dx_tucker" in n or "tc_dw_kernel" in n
            or "tucker_bwd_bf16" in n}


@pytest.mark.parametrize("case", SOS_TUCKER_CASES, ids=["x".join(map(str, c)) for c in
                                                         SOS_TUCKER_CASES])
@pytest.mark.parametrize("sfx,mode", SIGNED_TUCKER_INSTANCES,
                         ids=[s or "f32" for s, _ in SIGNED_TUCKER_INSTANCES])
@pytest.mark.parametrize("op", ["slse_tucker2", "slse_tucker2_softmax"])
def test_signed_tucker_backward_on_the_tensor_cores(op, sfx, mode, case):
    """Each float32 signed Tucker backward against its plain version at its
    rounding points (the input gradients to ``_close``, the weight's to
    ``_close_blocked_grad``: a fast mode writes it in the weight's type), 0
    where that is structural (a sign of 0, a row of -inf, a row of zero
    cotangent, the cancelling row); dx alone and dw alone equal to the full
    call to the bit, a second call too (``sr`` included); one launch a call,
    of the tensor-core kernels alone (``tc_dx_tucker`` and ``tc_dw_kernel``
    in the f32-grade mode, ``tucker_bwd_bf16`` in a fast one)."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    f, b, k1, k2, o = case
    ins = _signed_tucker_inputs(op, f, b, k1, k2, o)
    if sfx.startswith("_w16"):
        ins[-1] = ins[-1].to(torch.bfloat16)
    oa, os_ = S._ENTRIES[op][2](*ins, mode=mode)
    assert bool(torch.isneginf(oa[0, _CANCEL_ROW]).all()) and bool((os_[0, _CANCEL_ROW] == 0).all())
    g = torch.randn(oa.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[-1, 3:5] = 0.0
    full = (True,) * 5
    grads = S._launch_bwd(op, tuple(ins), oa, os_, g, full, mode)
    again = S._launch_bwd(op, tuple(ins), oa, os_, g, full, mode)
    dx = S._launch_bwd(op, tuple(ins), oa, os_, g, (True, False, True, False, False), mode)
    dw = S._launch_bwd(op, tuple(ins), oa, os_, g, (False,) * 4 + (True,), mode)
    refs = S._ENTRIES[op][3](*ins, oa, os_, g, full, mode)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}{sfx}_bwd"] == 4
    assert S.bwd_route(op, "", mode) == ("bf16" if mode else "tc")
    if not mode:  # the scratch the op sizes is the kernels' (tc_scratch)
        from cirkit_tpu_torch.ops import _build

        assert S.bwd_scratch(op, "tc", f, b, k1, k2, o) == _build.library().lse_bwd_scratch(
            1, int("softmax" in op), f, b, k1, k2, o)
    assert dx[4] is None and dw[0] is None and dw[2] is None
    zero_rows = (g == 0).all(dim=-1, keepdim=True) | (os_ == 0).all(dim=-1, keepdim=True)
    for k, (d, r) in enumerate(zip(grads, refs)):
        assert (d is None) == (r is None) == (k % 2 == 1)
        if d is None:
            continue
        assert d.dtype == (ins[-1].dtype if k == 4 and mode else torch.float32)
        assert torch.equal(d, again[k]) and torch.equal(d, (dw if k == 4 else dx)[k])
        _close_blocked_grad(d, r)
        if k < 4:
            zeros = (ins[k + 1] == 0) | torch.isneginf(ins[k]) | zero_rows
            assert bool((d[zeros] == 0).all())
    if case == SOS_TUCKER_CASES[0]:
        names = _fwd_kernel_names(lambda: S._launch_bwd(op, tuple(ins), oa, os_, g, full, mode))
        want = {"tucker_bwd_bf16"} if mode else {"tc_dx_tucker", "tc_dw_kernel"}
        assert all(any(w in n for n in names) for w in want), names
        assert not any("dw_part" in n or "lse_bwd_dx" in n for n in names), names


@pytest.mark.parametrize("sfx", ["", "_w16"], ids=["f32", "_w16"])
@pytest.mark.parametrize("op", ["slse_tucker2", "slse_tucker2_softmax"])
def test_signed_tucker_backward_against_float64(op, sfx):
    """The f32-grade signed Tucker backward at the K=64 entry's widths (on 98
    of its folds) against the plain version in float64 on the same inputs
    (a bf16 weight widened), to ``_close``."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    ins = _signed_tucker_inputs(op, 98, 128, 64, 64, 64)
    if sfx:
        ins[-1] = ins[-1].to(torch.bfloat16)
    x64 = [t.double() for t in ins]
    oa, os_ = S._ENTRIES[op][2](*x64)
    g = torch.randn(oa.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    grads = S._launch_bwd(op, tuple(ins), oa.float(), os_.float(), g.float(), (True,) * 5)
    refs = S._ENTRIES[op][3](*x64, oa, os_, g, (True,) * 5)
    torch.cuda.synchronize()
    for d, r in zip(grads, refs):
        if d is not None:
            _close(d.double(), r)


def _complex_tucker_inputs(f, b, k1, k2, o):
    """``_complex_inputs`` (complex64, a real weight) with fold 0's
    structured rows: row ``_INF_ROW`` with real parts -inf; row
    ``_CANCEL_ROW`` of zeros (e = 1) against integer weights of opposite
    signs in pairs of columns (0 at an odd K2's last), so y = 0 exactly."""
    x1, x2, w = _complex_inputs("clse_tucker2", f, b, o, torch.complex64, real_w=True, k1=k1,
                                k2=k2)
    x1[0, _INF_ROW] = complex(float("-inf"), 0.5)
    x1[0, _CANCEL_ROW] = 0
    x2[0, _CANCEL_ROW] = 0
    pairs = torch.randint(-3, 4, (o, k1, (k2 + 1) // 2), device="cuda").float()
    signs = torch.tensor([1.0, -1.0], device="cuda").repeat((k2 + 1) // 2)
    alt = pairs.repeat_interleave(2, dim=-1) * signs
    alt[..., k2 - 1] *= 0.0 if k2 % 2 else 1.0
    w[0] = alt[..., :k2].reshape(o, k1 * k2)
    return [x1, x2, w]


@pytest.mark.parametrize("case", SOS_TUCKER_CASES, ids=["x".join(map(str, c)) for c in
                                                         SOS_TUCKER_CASES])
@pytest.mark.parametrize("mode", ["", "bf16", "sr"], ids=["f32", "fast", "sr"])
def test_complex_tucker_backward_on_the_tensor_cores(mode, case):
    """The complex64 Tucker backward against a real weight (``bwd_entry``:
    ``clse_bwd_tucker_rw`` and its fast instances) against its plain version
    in its mode, plane by plane to ``_complex_bwd_close``'s 1e-4, 0 at the
    rows of -inf inputs, of zero cotangent and of exact cancellation; dx
    alone and dw alone equal to the full call to the bit, and a second call;
    one launch a call, of the tensor-core kernels alone."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    f, b, k1, k2, o = case
    ins = _complex_tucker_inputs(f, b, k1, k2, o)
    sfx = T.MODE_SUFFIX[mode]
    out = C._ENTRIES["clse_tucker2"][0](*ins, mode=mode) if mode else \
        C._ENTRIES["clse_tucker2"][0](*ins)
    assert bool(torch.isneginf(out[0, _CANCEL_ROW].real).all())
    g = torch.complex(*(torch.randn(out.shape, device="cuda",
                                    generator=torch.Generator(device="cuda").manual_seed(k))
                        for k in (1, 2)))
    g[-1, 3:5] = 0.0
    full = (True,) * 3
    grads = C._launch_bwd("clse_tucker2", tuple(ins), out, g, full, mode)
    again = C._launch_bwd("clse_tucker2", tuple(ins), out, g, full, mode)
    dx = C._launch_bwd("clse_tucker2", tuple(ins), out, g, (True, True, False), mode)
    dw = C._launch_bwd("clse_tucker2", tuple(ins), out, g, (False, False, True), mode)
    plain = C._ENTRIES["clse_tucker2"][1]
    refs = plain(*ins, out, g, full, mode) if mode else plain(*ins, out, g, full)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"clse_tucker2{sfx}_bwd"] == 4
    assert C.bwd_entry("clse_tucker2", torch.complex64, torch.float32, mode) == \
        "clse_bwd_tucker_rw" + sfx
    zero_rows = (g == 0).all(dim=-1, keepdim=True) | torch.isneginf(out.real).all(
        dim=-1, keepdim=True)
    for k, (d, r) in enumerate(zip(grads, refs)):
        assert d.dtype == ins[k].dtype and torch.equal(d, again[k])
        assert torch.equal(d, (dw if k == 2 else dx)[k])
        _complex_bwd_close(d, r, 1e-4)
        if k < 2:
            zeros = torch.isneginf(ins[k].real) | zero_rows
            assert bool((d[zeros] == 0).all())
    if case == SOS_TUCKER_CASES[0]:
        names = _fwd_kernel_names(lambda: C._launch_bwd("clse_tucker2", tuple(ins), out, g,
                                                        full, mode))
        want = {"tucker_bwd_bf16"} if mode else {"tc_dx_tucker", "tc_dw_kernel"}
        assert all(any(w in n for n in names) for w in want), names
        assert not any("clse_bwd_dw_part" in n or "clse_bwd_dx" in n for n in names), names


def test_complex_tucker_backward_against_complex128():
    """The f32-grade complex64 Tucker backward against a real weight at the
    K=64 entry's widths (98 folds) against the plain version in complex128
    on the same inputs, plane by plane to 1e-4."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    ins = _complex_tucker_inputs(98, 128, 64, 64, 64)
    x128 = [t.to(torch.complex128 if t.is_complex() else torch.float64) for t in ins]
    out = C._ENTRIES["clse_tucker2"][0](*x128)
    g = torch.complex(*(torch.randn(out.shape, device="cuda", dtype=torch.float64,
                                    generator=torch.Generator(device="cuda").manual_seed(k))
                        for k in (1, 2)))
    grads = C._launch_bwd("clse_tucker2", tuple(ins), out.to(torch.complex64),
                          g.to(torch.complex64), (True,) * 3)
    refs = C._ENTRIES["clse_tucker2"][1](*x128, out, g)
    torch.cuda.synchronize()
    for d, r in zip(grads, refs):
        _complex_bwd_close(d.to(r.dtype), r, 1e-4)


# --------------------------------------------------------------------------- #
# The signed and complex Tucker forwards on the tensor cores (the float32
# signed instances, tucker_fwd_tc and tucker_fwd_bf16 with SIGNED; the
# complex64 ones against a real weight, with CPLX) against float64 and
# complex128 at the K=64 entry, the widest the paths launch; against their
# plain versions in test_signed_instance_kernels_match_plain and
# test_complex_fast_instance_kernels_match_plain.
# --------------------------------------------------------------------------- #

# against float64 (complex128), in linear space scaled by the row's absolute
# mass: float32's sums, and in a fast mode two roundings to bf16 a term (e2
# and the weight; a complex e2 one a plane, sqrt(2) u of it), each within u
# of its value (u = 2^-8 to the nearest, 2^-7 stochastic): 3 u
WIDE_TOL = {"": 1e-5, "bf16": 3 * 2.0**-8 + 1e-5, "sr": 3 * 2.0**-7 + 1e-5}


@pytest.mark.parametrize("sfx,mode", SIGNED_TUCKER_INSTANCES,
                         ids=[s or "f32" for s, _ in SIGNED_TUCKER_INSTANCES])
@pytest.mark.parametrize("op", ["slse_tucker2", "slse_tucker2_softmax"])
def test_signed_tucker_forward_against_float64(op, sfx, mode):
    """Each float32 signed Tucker forward at the K=64 entry (F=784, B=128,
    K1=K2=O=64), the widest the paths launch, against the plain version in
    float64 on the same inputs (a bf16 weight widened), in linear space
    scaled by the row's absolute mass, to ``WIDE_TOL``."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    ins = _signed_tucker_inputs(op, 784, 128, 64, 64, 64)
    if sfx.startswith("_w16"):
        ins[-1] = ins[-1].to(torch.bfloat16)
    got = S._launch_fwd(op, tuple(ins), mode)
    x64 = [t.double() for t in ins]
    ref = S._ENTRIES[op][2](*x64)
    torch.cuda.synchronize()
    _signed_close(op, x64, tuple(t.double() for t in got), ref, WIDE_TOL[mode])


@pytest.mark.parametrize("mode", ["", "bf16", "sr"], ids=["f32", "fast", "sr"])
def test_complex_tucker_forward_against_complex128(mode):
    """The complex64 Tucker forward against a real weight at the K=64 entry
    (F=784, B=128, K1=K2=O=64), the widest the paths launch, against the
    plain version in complex128 on the same inputs, on both planes in linear
    space scaled by the row's absolute mass, to ``WIDE_TOL``."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    ins = _complex_tucker_inputs(784, 128, 64, 64, 64)
    got = C._launch_fwd("clse_tucker2", tuple(ins), mode)
    x128 = [t.to(torch.complex128 if t.is_complex() else torch.float64) for t in ins]
    ref = C._ENTRIES["clse_tucker2"][0](*x128)
    torch.cuda.synchronize()
    _complex_close(x128, got.to(torch.complex128), ref, WIDE_TOL[mode])
